"""MiniCluster: servers and brokers in one process, over real TCP.

A trimmed copy of pinot_tpu/cluster/mini.py (ref pinot-integration-test-base
ClusterTest.java:92, startBrokers:186, startServers:258): N port servers
(`MiniClusterServer`: a data manager, the server's executor on the card
and its TCP transport) behind M brokers (broker/request_handler.py) that
share one routing view and one connection pool a server, and, with
`start(with_http=True)`, the first broker's HTTP edge for the client
(client/connection.py). Segment assignment is direct: `add_table`
registers a route, `add_segment` loads a segment directory on its server
and replicas and registers it. Each server loads its own copy of the
directory, as a separate server process would, so stopping or removing a
segment on one server never takes it from another.

Not here: minions, cache servers, the multi-stage worker and dispatcher,
and the controller-lite state, rebalancer and repair.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from pinot_tpu_torch.broker.http_api import BrokerHttpServer
from pinot_tpu_torch.broker.request_handler import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import (
    BrokerRoutingManager, RoutingTable, SegmentInfo, TableRoute)
from pinot_tpu_torch.cache.broker_cache import BrokerResultCache
from pinot_tpu_torch.segment.loader import ImmutableSegment, load_segment
from pinot_tpu_torch.server.data_manager import InstanceDataManager
from pinot_tpu_torch.server.query_server import (QueryServer,
                                                 ServerConnection,
                                                 ServerQueryExecutor)
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.failpoints import FaultSchedule
from pinot_tpu_torch.utils.metrics import get_registry


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


class MiniCluster:
    def __init__(self, num_servers: int = 2, device=None,
                 value_dtype: torch.dtype = torch.float32,
                 result_cache: bool = False, num_brokers: int = 1,
                 config: Optional[PinotConfiguration] = None, chaos=None,
                 minions: int = 0, cache_server: bool = False,
                 cache_servers: int = 0):
        """device, value_dtype: every server's, as MiniClusterServer
        takes them (None: every CUDA device of the host, RuntimeError
        without one; "cpu": the plain PyTorch kernels, for the tests).
        result_cache: each broker gets its own tier-1 result cache.
        config: the servers' and brokers' PinotConfiguration. chaos: a
        FaultSchedule or a [(site, policy-kwargs), ...] list, armed at
        start() and disarmed at stop(). minions and cache_server(s) are
        the JAX harness's roles the port does not have: asking for one
        raises ValueError."""
        if minions:
            raise ValueError("minions: the port's cluster has no minion "
                             "role yet")
        if cache_server or cache_servers:
            raise ValueError("cache_server / cache_servers: the port's "
                             "cluster has no cache-server role yet")
        self.chaos: Optional[FaultSchedule] = None
        if chaos is not None:
            self.chaos = (chaos if isinstance(chaos, FaultSchedule)
                          else FaultSchedule(list(chaos)))
        self.config = config
        self.servers: List[MiniClusterServer] = [
            MiniClusterServer(f"server_{i}", device=device,
                              value_dtype=value_dtype, config=config)
            for i in range(num_servers)]
        self.routing = BrokerRoutingManager()
        self._connections: Dict[str, ServerConnection] = {}
        self.broker: Optional[BrokerRequestHandler] = None
        self.brokers: List[BrokerRequestHandler] = []
        self._num_brokers = max(1, int(num_brokers))
        self.http: Optional[BrokerHttpServer] = None
        self._routes: Dict[str, RoutingTable] = {}
        #: per-table partition-pruning metadata, stamped on every later
        #: add_segment's SegmentInfo
        self._table_meta: Dict[str, dict] = {}
        #: logical table -> tenant tag, replayed onto brokers at start()
        self._tenants: Dict[str, str] = {}
        self._result_cache_enabled = result_cache

    def _make_result_cache(self) -> Optional[BrokerResultCache]:
        if not self._result_cache_enabled:
            return None
        return BrokerResultCache.from_config(
            (self.config or PinotConfiguration()).with_overrides(
                {"pinot.broker.result.cache.enabled": True}),
            metrics=get_registry("broker"))

    def start(self, with_http: bool = False) -> None:
        if self.chaos is not None:
            self.chaos.arm()
        for s in self.servers:
            s.start()
            self._connections[s.instance_id] = ServerConnection(
                s.transport.host, s.transport.port)
        # N broker replicas over the same routing view and connections,
        # each with its own result cache
        self.brokers = [
            BrokerRequestHandler(self.routing, self._connections,
                                 result_cache=self._make_result_cache(),
                                 config=self.config)
            for _ in range(self._num_brokers)]
        self.broker = self.brokers[0]
        for table, tenant in self._tenants.items():
            for b in self.brokers:
                self._tag(b, table, tenant)
        if with_http:
            self.http = BrokerHttpServer(self.broker)
            self.http.start()

    def stop(self) -> None:
        if self.http is not None:
            self.http.stop()
            self.http = None
        for c in self._connections.values():
            c.close()
        for b in self.brokers:
            b.close()
        for s in self.servers:
            s.stop()
        if self.chaos is not None:
            self.chaos.disarm()

    # ------------------------------------------------------------------
    def add_table(self, table_name: str, table_type: str = "OFFLINE",
                  time_column: Optional[str] = None,
                  time_boundary: Optional[int] = None,
                  num_replica_groups: int = 0,
                  partition_column: Optional[str] = None,
                  num_partitions: int = 0,
                  tenant: Optional[str] = None) -> None:
        """num_replica_groups >= 2 routes the table by replica group
        (each add_segment's [server_idx, *replicas] order is the group
        order); partition_column / num_partitions stamp partition-pruning
        metadata on later add_segment calls that give a partition_id;
        time_boundary splits a hybrid table (offline serves time <= it);
        tenant tags the table's server requests."""
        rt = self._routes.get(table_name)
        if rt is None:
            rt = RoutingTable()
            self._routes[table_name] = rt
        route = TableRoute(f"{table_name}_{table_type}",
                           time_column=time_column,
                           num_replica_groups=num_replica_groups)
        if table_type == "OFFLINE":
            rt.offline = route
        else:
            rt.realtime = route
        if time_boundary is not None:
            rt.time_boundary = time_boundary
        self.routing.set_route(table_name, rt)
        self._table_meta[table_name] = {
            "partition_column": partition_column,
            "num_partitions": int(num_partitions or 0),
        }
        if tenant:
            for b in self.brokers:
                self._tag(b, table_name, tenant)
            self._tenants[table_name] = tenant

    @staticmethod
    def _tag(broker: BrokerRequestHandler, table: str, tenant: str) -> None:
        broker.tenants[table] = tenant
        if broker.quota_manager is not None:
            broker.quota_manager.set_table_tenant(table, tenant)

    def add_segment(self, table_name: str,
                    segment: Union[str, ImmutableSegment], server_idx: int,
                    table_type: str = "OFFLINE",
                    replicas: Sequence[int] = (),
                    partition_id: Optional[int] = None) -> None:
        """Load a segment directory (or a loaded segment's) on server_idx
        and its replicas, each server its own copy, and register it. For
        a replica-group table the [server_idx, *replicas] order is the
        group order (element g lives in group g)."""
        seg_dir = segment if isinstance(segment, str) else segment.dir.path
        physical = f"{table_name}_{table_type}"
        targets = [server_idx, *replicas]
        meta = None
        for idx in targets:
            copy = load_segment(seg_dir)
            meta = copy.metadata
            self.servers[idx].data_manager.table(physical).add_segment(copy)
        rt = self._routes[table_name]
        route = rt.offline if table_type == "OFFLINE" else rt.realtime
        tmeta = self._table_meta.get(table_name, {})
        route.segments[meta.segment_name] = SegmentInfo(
            name=meta.segment_name,
            servers=[self.servers[i].instance_id for i in targets],
            partition_id=partition_id,
            partition_column=(tmeta.get("partition_column")
                              if partition_id is not None else None),
            num_partitions=(tmeta.get("num_partitions", 0)
                            if partition_id is not None else 0),
            start_time=meta.start_time, end_time=meta.end_time,
            version=meta.crc)

    def remove_segment(self, table_name: str, segment_name: str,
                       table_type: str = "OFFLINE") -> None:
        """Unload from every server and drop from routing (the routing
        epoch moves, so result-cache entries go unaddressable; the
        brokers drop the table's negative-cache entries)."""
        physical = f"{table_name}_{table_type}"
        for s in self.servers:
            tdm = s.data_manager.table(physical, create=False)
            if tdm is not None:
                tdm.remove_segment(segment_name)
        rt = self._routes.get(table_name)
        route = None if rt is None else (
            rt.offline if table_type == "OFFLINE" else rt.realtime)
        if route is not None:
            route.segments.pop(segment_name, None)
        for b in self.brokers:
            b.on_segments_replaced(table_name)

    def kill_server(self, idx: int) -> None:
        """A killed process's state for one server: its transport dies
        (broker channels sever, new dials are refused) and its data
        manager is abandoned. Brokers find out by a connection error.
        Idempotent."""
        self.servers[idx].transport.stop()

    def kill_replica_group(self, table_name: str, group: int,
                           table_type: str = "OFFLINE") -> List[str]:
        """Kill every member of one replica group; their instance ids."""
        rt = self._routes[table_name]
        route = rt.offline if table_type == "OFFLINE" else rt.realtime
        members = {seg.servers[group] for seg in route.segments.values()
                   if group < len(seg.servers)}
        by_id = {s.instance_id: i for i, s in enumerate(self.servers)}
        for m in sorted(members):
            self.kill_server(by_id[m])
        return sorted(members)

    def query(self, sql: str):
        if self.broker is None:
            raise RuntimeError("cluster not started")
        return self.broker.handle(sql)
