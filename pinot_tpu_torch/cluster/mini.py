"""MiniClusterServer: one server role in-process, over real TCP.

A trimmed copy of pinot_tpu/cluster/mini.py `MiniClusterServer` (:26; ref
pinot-integration-test-base ClusterTest.java:258 startServers): a data
manager, the server's query executor on the card and its TCP transport.
Segments go in through `data_manager.table(name).add_segment_from_dir`;
a broker reaches the server at `address` with
server/query_server.py `ServerConnection`. No multi-stage worker, no
segment cache and no broker yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from pinot_tpu_torch.server.data_manager import InstanceDataManager
from pinot_tpu_torch.server.query_server import (QueryServer,
                                                 ServerQueryExecutor)
from pinot_tpu_torch.utils.config import PinotConfiguration


class MiniClusterServer:
    def __init__(self, instance_id: str = "server_0", device=None,
                 value_dtype: torch.dtype = torch.float32,
                 config: Optional[PinotConfiguration] = None,
                 host: str = "127.0.0.1", port: int = 0, devices=None):
        """device, devices: as ServerQueryExecutor takes them. None for
        both means every card of the host, and raises RuntimeError when no
        CUDA device is present; "cpu" runs the plain PyTorch kernels;
        devices=[...] a segments-only mesh over those devices."""
        self.instance_id = instance_id
        self.data_manager = InstanceDataManager(instance_id)
        self.executor = ServerQueryExecutor(self.data_manager, device=device,
                                            value_dtype=value_dtype,
                                            config=config, devices=devices)
        self.transport = QueryServer(self.executor, host=host, port=port)

    def start(self) -> None:
        self.transport.start()

    def stop(self) -> None:
        self.transport.stop()
        self.data_manager.shutdown()

    @property
    def address(self) -> str:
        return f"{self.transport.host}:{self.transport.port}"
