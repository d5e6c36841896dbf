"""QueryExecutor: the port's entry point — SQL text to result rows.

Counterpart of pinot_tpu/query/executor.py (ref pinot-core
ServerQueryExecutorV1Impl.java:94 + BaseCombineOperator.java:54): parse,
run every segment through the device engine as ONE stacked launch, and
reduce. The device defaults to the card; the plain PyTorch kernels run only
when the caller asks for the CPU. There is no host executor yet, so a query
outside the device slice raises NotImplementedError naming what it needs.
Safe to call from many threads at once: concurrent queries meet in the
engine's dispatch ring (ops/dispatch.py), where equal plans coalesce into
one launch.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Mapping, Optional, Sequence, Union

import torch

from pinot_tpu_torch.ops.engine import TorchOperatorExecutor
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.reduce import BrokerResponse, reduce_results
from pinot_tpu_torch.segment.loader import ImmutableSegment
from pinot_tpu_torch.utils.config import PinotConfiguration


class QueryExecutor:
    """Executes queries over loaded segments (one 'server')."""

    def __init__(self, segments: Union[Sequence[ImmutableSegment],
                                       Mapping[str, Sequence[ImmutableSegment]]],
                 device=None, value_dtype: torch.dtype = torch.float32,
                 config: Optional[PinotConfiguration] = None, mesh=None):
        """segments: one table's segments, or {table name: segments} for a
        server holding several tables (a query reads the table its FROM
        names; equal plans over different tables coalesce in the ring).
        device: None means "cuda", and raises RuntimeError when no CUDA
        device is present; pass "cpu" for the plain PyTorch kernels.
        config: the engine's configuration (dispatch ring, star-tree,
        time-series keys); kept as `config`, which the time-series leaf
        reads its group cap from.
        mesh: a parallel.mesh.Mesh over (segments, docs): the engine
        shards each staged block over it and folds the partials (and,
        on more than one slot, merges the segment batch into one row);
        device then defaults to the mesh's lead device."""
        if device is None and mesh is not None:
            device = mesh.lead
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' for the plain PyTorch kernels")
        self.tables = None
        if isinstance(segments, Mapping):
            self.tables = {t: list(segs) for t, segs in segments.items()}
            segments = []
        self.segments = list(segments)
        self.config = config
        self.engine = TorchOperatorExecutor(dev, value_dtype, config=config,
                                            mesh=mesh)
        self._tls = threading.local()

    @property
    def last_stage_ms(self) -> Dict[str, float]:
        """Host-clock split (ms) of this thread's last execute: parse, the
        engine's stages (TorchOperatorExecutor.last_stage_ms), reduce."""
        return getattr(self._tls, "stage_ms", {})

    def execute(self, sql: str) -> BrokerResponse:
        """Parse, run every segment through the device engine, reduce.
        Raises NotImplementedError naming what the query needs beyond the
        device slice."""
        t0 = time.perf_counter()
        ctx = QueryContext.from_sql(sql)
        t1 = time.perf_counter()
        results = self.engine.execute(self.segments_of(ctx.table), ctx)
        t2 = time.perf_counter()
        resp = reduce_results(ctx, results)
        t3 = time.perf_counter()
        self._tls.stage_ms = {"parse": (t1 - t0) * 1e3,
                              **self.engine.last_stage_ms,
                              "reduce": (t3 - t2) * 1e3}
        resp.time_used_ms = (t3 - t0) * 1e3
        return resp

    def segments_of(self, table: str):
        """The segments a query over `table` reads."""
        if self.tables is None:
            return self.segments
        if table not in self.tables:
            raise ValueError(f"no table {table!r} on this server")
        return self.tables[table]
