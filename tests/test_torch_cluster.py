"""The port's cluster (broker, routing, scatter, reduce over servers, the
HTTP edge and the client) against the JAX package's.

Each case runs the same tables through the port's
`MiniCluster(num_servers=2, device="cpu")` (the plain PyTorch kernels, at
float64 or float32) and the JAX `MiniCluster(num_servers=2)` (its host
executor), both over real TCP, and compares rows, errorCodes,
`partialResult` and the server counts. Tables are built by the port's
creator (tests/torch_tables.py), which both loaders read; each server
loads its own copy of a segment directory.

- SQL three ways: every device and host shape of torch_tables.SHAPES
  but the upsert one (rows equal the JAX servers' replies reduced in
  plan order under test_torch_server.py's tolerances, and the JAX
  broker's flags; Q1 and the group-by equal numpy's truth; the port's
  answer does not move when replies arrive in another order, the JAX
  broker's does), the FLOAT-literal queries held to the JAX host oracle, a hybrid
  table split at its time boundary, a two-group replica table (one group
  queried) and a partitioned table (pruned by the broker).
- Failure paths, the same codes and flags as the JAX broker: an unknown
  table (190), a parse error and a join (150), a quota rejection (429),
  a deadline driven by the `broker.scatter.before` failpoint (250,
  partial), a killed server with no replica (427, partial) and with one
  (a full answer from the replica), a replica-group failover, a hedge
  past a delayed replica, an exhausted retry budget (the
  `broker.retry.budget` failpoint), a negative-cache hit on a
  pruned-to-zero query, a result-cache hit and its miss after
  `remove_segment`, trace=true returning each server's spans inside the
  broker's tree, the slow-query capture, and a server's QUERY_EXECUTION
  reply reaching the client, never retried.
- The wire both ways: the JAX broker over the port's servers, and the
  port's broker over JAX servers, with `tenant` and `traceContext` in
  every request.
- The client: `connect()` / `Cursor` over the port's HTTP edge return
  `cluster.query`'s rows and raise `PinotClientError` /
  `PinotTimeoutError` where the JAX client does.
- chip_smoke.py's phase 17 at a small size.
"""
import contextlib
import math
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax

from pinot_tpu.broker import routing as jax_routing
from pinot_tpu.broker.quota import QueryQuotaManager as JaxQuota
from pinot_tpu.broker.request_handler import \
    BrokerRequestHandler as JaxBroker
from pinot_tpu.client import connection as jax_client
from pinot_tpu.cluster.mini import MiniCluster as JaxCluster
from pinot_tpu.cluster.mini import MiniClusterServer as JaxServer
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.query.reduce import reduce_results as jax_reduce
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.server import datatable as jax_datatable
from pinot_tpu.server.query_server import ServerConnection as JaxConnection
from pinot_tpu.utils import failpoints as jax_fp
from pinot_tpu.utils.config import PinotConfiguration as JaxConfig
from pinot_tpu.utils.metrics import get_registry as jax_registry
from pinot_tpu_torch.broker import routing
from pinot_tpu_torch.broker.quota import QueryQuotaManager
from pinot_tpu_torch.broker.request_handler import BrokerRequestHandler
from pinot_tpu_torch.client import connection as client
from pinot_tpu_torch.cluster.mini import MiniCluster
from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType, Schema,
                                    TableConfig)
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.server.query_server import ServerConnection
from pinot_tpu_torch.utils import errorcodes, failpoints, trace_store
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.metrics import get_registry

from tests import torch_tables as tt

F64_REL, F32_REL, F32_MOMENTS = 1e-9, 1e-5, 4e-3
MOMENT_COLUMNS = ("variance", "stddev", "skewness", "kurtosis")
SHAPES = {k: v for k, v in tt.SHAPES.items() if v[0] != "ups"}
#: the shapes whose answer depends on the order a broker merges its
#: servers' replies (a t-digest's merge): the JAX broker merges in the
#: order replies arrive, the port's in plan order, so a comparison
#: against the JAX broker holds them to a plan-order reduce of the JAX
#: replies (Pair.jax_in_plan_order) or leaves them out
ORDER_SENSITIVE = ("sketches", "grouped_sketches")
WIRE_SHAPES = {k: v for k, v in SHAPES.items() if k not in ORDER_SENSITIVE}
Q1 = tt.SHAPES["q1"][1]


def _build(root: str, name: str, fields, parts) -> list:
    """Segment directories {root}/{name}_{i} of `parts` (column dicts)."""
    schema = Schema(name, [FieldSpec(f, t, k) for f, t, k in fields])
    dirs = []
    for i, cols in enumerate(parts):
        out = os.path.join(root, f"{name}_{i}")
        SegmentCreator(TableConfig(name), schema).build(cols, out,
                                                        f"{name}_{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cluster_tables"))
    ts = [("ts", DataType.LONG, FieldType.DIMENSION),
          ("val", DataType.INT, FieldType.METRIC)]
    part = [("p", DataType.INT, FieldType.DIMENSION),
            ("v", DataType.INT, FieldType.METRIC)]
    rng = np.random.default_rng(3)
    return {
        "srv": tt.build_table(root, "srv"),
        "st": tt.build_table(root, "st", star_tree=True),
        # offline ts 0..99, realtime ts 80..199: the boundary 99 drops
        # the overlap
        "hyb_off": _build(root, "hoff", ts, [
            {"ts": np.arange(0, 100, dtype=np.int64),
             "val": np.ones(100, np.int32)}]),
        "hyb_rt": _build(root, "hrt", ts, [
            {"ts": np.arange(80, 200, dtype=np.int64),
             "val": np.full(120, 2, np.int32)}]),
        # partitions 0, 1, 2 of 4 on p
        "part": _build(root, "part", part, [
            {"p": np.full(500, i, np.int32),
             "v": rng.integers(0, 1000, 500).astype(np.int32)}
            for i in range(3)]),
    }


def _load(c, dirs, jax_side: bool, tables=("srv", "st")):
    """The tables of the fixtures on cluster c (segment i on server
    i % 2): srv and st; `rep` (srv's segments on both servers); `rg` (a
    two-group replica table); `hyb` (hybrid, boundary 99); `part`."""
    seg = jax_load if jax_side else (lambda d: d)
    for t in tables:
        if t in ("srv", "st"):
            c.add_table(t, tenant="blue")
            for i, d in enumerate(dirs[t]):
                c.add_segment(t, seg(d), i % 2)
        elif t in ("rep", "rg"):
            c.add_table(t, num_replica_groups=2 if t == "rg" else 0)
            for d in dirs["srv"]:
                c.add_segment(t, seg(d), 0, replicas=[1])
        elif t == "hyb":
            c.add_table("hyb", "OFFLINE", time_column="ts")
            c.add_table("hyb", "REALTIME", time_column="ts",
                        time_boundary=99)
            c.add_segment("hyb", seg(dirs["hyb_off"][0]), 0, "OFFLINE")
            c.add_segment("hyb", seg(dirs["hyb_rt"][0]), 1, "REALTIME")
        elif t == "part":
            c.add_table("part", partition_column="p", num_partitions=4)
            for i, d in enumerate(dirs["part"]):
                c.add_segment("part", seg(d), i % 2, partition_id=i)


JAX_DEVICE_CONFIG = {
    # no tier-2 result cache and no admission control, as the port has
    # none (tests/test_torch_server.py's Pair)
    "pinot.server.segment.cache.enabled": False,
    "pinot.server.admission.enabled": False}


@contextlib.contextmanager
def posture(x64: bool):
    """JAX's precision for the requests in the scope: the JAX servers'
    worker threads read the global flag."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


@contextlib.contextmanager
def clusters(dirs, tables=("srv", "st"), x64: bool = True, config=None,
             http: bool = False, jax_device: bool = False,
             num_servers: int = 2, **kw):
    """(port cluster, JAX cluster) over the same directories, started.
    jax_device: the JAX servers run their device engine (each on one of
    the conftest's virtual devices, as test_torch_server.py's Pair does)
    in the posture x64, not their host executor."""
    port = MiniCluster(num_servers=num_servers, device="cpu",
                       value_dtype=torch.float64 if x64 else torch.float32,
                       config=None if config is None
                       else PinotConfiguration(config), **kw)
    jcfg = {**(config or {}), **(JAX_DEVICE_CONFIG if jax_device else {})}
    ref = JaxCluster(num_servers=num_servers, use_tpu=jax_device,
                     config=JaxConfig(overrides=jcfg) if jcfg else None,
                     **kw)
    if jax_device:
        for s in ref.servers:
            s.executor._engine = TpuOperatorExecutor(
                devices=jax.devices()[:1], config=JaxConfig(overrides=jcfg),
                metrics_labels={"instance": s.instance_id})
    for c in (port, ref):
        c.start(with_http=http)
    try:
        _load(port, dirs, False, tables)
        with posture(x64):
            _load(ref, dirs, True, tables)
        yield port, ref
    finally:
        port.stop()
        ref.stop()


class Pair:
    """A port cluster and a JAX cluster on its device engine, one
    posture; `jax(sql)` runs the JAX side in that posture."""

    def __init__(self, port, ref, x64: bool):
        self.port, self.ref, self.x64 = port, ref, x64

    def jax(self, sql: str):
        with posture(self.x64):
            return self.ref.query(sql)

    def jax_in_plan_order(self, sql: str):
        """The JAX package's answer, its servers' replies reduced in the
        plan's order, as the port's broker reduces them (the JAX broker
        reduces in the order replies arrive, and a t-digest's merge
        depends on it)."""
        ctx = JaxContext.from_sql(sql)
        results, stats = [], []
        with posture(self.x64):
            for server, table, names, extra in self.ref.routing.get_route(
                    ctx.table).route(ctx):
                res, exc, st = jax_datatable.deserialize_results(
                    self.ref._connections[server].request(
                        table, sql, names, 0, extra))
                assert not exc, exc
                results.extend(res)
                stats.append(st)
            resp = jax_reduce(ctx, results)
        for st in stats:
            if st is not None:
                resp.stats.merge(st)
        return resp


@pytest.fixture(scope="module")
def shared(dirs):
    """Module-wide clusters for the read-only cases, one pair a posture."""
    with contextlib.ExitStack() as stack:
        p64 = stack.enter_context(clusters(
            dirs, ("srv", "st", "rg", "hyb", "part"), jax_device=True))
        p32 = stack.enter_context(clusters(dirs, ("srv", "st"), x64=False,
                                           jax_device=True))
        yield {True: Pair(*p64, True), False: Pair(*p32, False)}


def _close(name: str, got, want, x64: bool) -> bool:
    if isinstance(want, (bool, str)) or want is None:
        return got == want
    fw, fg = float(want), float(got)
    if math.isnan(fw) or math.isinf(fw):
        return (math.isnan(fw) and math.isnan(fg)) or fw == fg
    if fw.is_integer() and (isinstance(want, int) or x64
                            or "percentile" not in name):
        return fg == fw
    if x64:
        return math.isclose(fg, fw, rel_tol=F64_REL, abs_tol=1e-12)
    if any(m in name for m in MOMENT_COLUMNS):
        return abs(fg - fw) <= F32_MOMENTS * max(1.0, abs(fw))
    return math.isclose(fg, fw, rel_tol=F32_REL, abs_tol=1e-12)


def _codes(resp) -> list:
    return sorted(e["errorCode"] for e in resp.exceptions)


def assert_same(got, want, x64: bool = True, what="", rows: bool = True,
                counts: bool = True):
    """The port's response against the JAX broker's: errorCodes,
    partialResult, (counts=True) the server counts and (rows=True)
    columns and rows."""
    assert _codes(got) == _codes(want), (what, got.exceptions,
                                         want.exceptions)
    if counts:
        assert (got.partial_result, got.num_servers_queried,
                got.num_servers_responded) == (
            want.partial_result, want.num_servers_queried,
            want.num_servers_responded), what
    if not rows:
        return
    assert (got.result_table is None) == (want.result_table is None), what
    if want.result_table is None:
        return
    cols = want.result_table.columns
    assert got.result_table.columns == cols, what
    assert len(got.rows) == len(want.rows), what
    for gr, wr in zip(got.rows, want.rows):
        for name, g, w in zip(cols, gr, wr):
            assert _close(name.lower(), g, w, x64), (what, name, g, w)


def _clean(resp, servers: int = 2):
    assert resp.exceptions == [] and not resp.partial_result
    assert resp.num_servers_queried == resp.num_servers_responded == servers


@pytest.fixture(scope="module")
def truth():
    cols = [tt.columns(i) for i in range(tt.N_SEGMENTS)]
    cat = {k: np.concatenate([c[k] for c in cols]) for k in cols[0]}
    m = ((cat["d_date"] >= 19940101) & (cat["d_date"] <= 19940131)
         & (cat["d_int"] >= 2) & (cat["d_int"] <= 4) & (cat["flag"] < 1))
    q1 = (float((cat["m_int"][m].astype(np.int64)
                 * cat["d_int"][m]).sum()), int(m.sum()))
    g = cat["d_int"] < 12
    gb = {s: (float(cat["m_int"][g & (cat["d_str"] == s)].sum()),
              int((g & (cat["d_str"] == s)).sum()))
          for s in sorted(set(cat["d_str"][g].tolist()))}
    return {"q1": q1, "groupby": gb}


# -- SQL three ways ----------------------------------------------------------

@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cluster_rows_match_jax_and_numpy(shared, truth, shape, x64):
    sql = SHAPES[shape][1]
    got = shared[x64].port.query(sql)
    _clean(got)
    assert_same(got, shared[x64].jax(sql), x64, shape, rows=False)
    want = shared[x64].jax_in_plan_order(sql)
    assert_same(got, want, x64, shape, counts=False)
    if shape == "q1":
        assert got.rows == [truth["q1"]]
    if shape == "groupby":
        assert [(r[0], float(r[1]), r[2]) for r in got.rows] == \
            [(s, *truth["groupby"][s]) for s in truth["groupby"]]


def test_reduce_in_plan_order_whatever_the_arrival(shared):
    """With server_0's scatter held back, server_1's reply arrives first:
    the JAX broker's p95 then moves (it merges in arrival order, ROADMAP
    §C), the port's does not (it merges in plan order)."""
    pair = shared[True]
    sql = SHAPES["sketches"][1]
    port_rows, jax_rows = pair.port.query(sql).rows, \
        pair.jax_in_plan_order(sql).rows
    assert port_rows == jax_rows
    with _both_fp("broker.scatter.before", delay=0.2,
                  where={"server": "server_0"}):
        held_port, held_jax = pair.port.query(sql), pair.jax(sql)
    assert held_port.rows == port_rows
    assert held_jax.rows[0][0] == port_rows[0][0]
    assert held_jax.rows[0][1] != port_rows[0][1], (held_jax.rows,
                                                    port_rows)


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(tt.FLOAT_SHAPES))
def test_float_literals_held_to_host_oracle(shared, dirs, shape, x64):
    sql = tt.FLOAT_SHAPES[shape]
    with jax.enable_x64(x64):
        oracle = JaxExecutor([jax_load(d) for d in dirs["srv"]],
                             use_tpu=False).execute(tt.float_oracle_sql(shape))
    got = shared[x64].port.query(sql)
    _clean(got)
    assert (got.result_table.columns, got.rows) == \
        (oracle.result_table.columns, oracle.rows)


@pytest.mark.parametrize("sql", [
    "SELECT COUNT(*), SUM(val) FROM hyb",
    "SELECT COUNT(*) FROM hyb WHERE ts > 90",
    "SELECT COUNT(*) FROM hyb_OFFLINE",
    "SELECT ts FROM hyb WHERE ts BETWEEN 97 AND 102 ORDER BY ts LIMIT 10"])
def test_hybrid_table_split_at_time_boundary(shared, sql):
    got, want = shared[True].port.query(sql), shared[True].jax(sql)
    assert_same(got, want, what=sql)
    if sql == "SELECT COUNT(*), SUM(val) FROM hyb":
        # offline serves ts <= 99 (100 docs of 1), realtime ts > 99
        # (100 docs of 2): the overlap is dropped
        assert got.rows == [(200, 300.0)]


def test_replica_group_table_queries_one_group(shared):
    for sql in (Q1, SHAPES["groupby"][1]):
        got = shared[True].port.query(sql.replace("FROM srv", "FROM rg"))
        want = shared[True].jax(sql.replace("FROM srv", "FROM rg"))
        _clean(got, servers=1)
        assert_same(got, want, what=sql)
        assert_same(got, shared[True].port.query(sql), what=sql,
                    counts=False)


@pytest.mark.parametrize("where,segments", [
    ("p = 1", 1), ("p IN (0, 2)", 2), ("p = 5", 1), ("v > 10", 3),
    ("p = 3", 0)])
def test_partitioned_table_pruned_by_the_broker(shared, where, segments):
    sql = f"SELECT COUNT(*), SUM(v) FROM part WHERE {where}"
    got, want = shared[True].port.query(sql), shared[True].jax(sql)
    assert_same(got, want, what=sql)
    # the segments the broker routed: each is processed or pruned by its
    # server (p = 5 is partition 1, whose segment's p range excludes 5)
    reached = got.stats.num_segments_processed + \
        got.stats.num_segments_pruned
    assert reached == segments
    assert (got.stats.num_segments_processed,
            got.stats.num_segments_pruned) == (
        want.stats.num_segments_processed, want.stats.num_segments_pruned)


# -- failure paths -----------------------------------------------------------

def _both_fp(site: str, **kw):
    """The same policy armed on both packages' failpoint registries."""
    stack = contextlib.ExitStack()
    stack.enter_context(failpoints.failpoints.armed(site, **kw))
    jkw = dict(kw)
    if isinstance(kw.get("error"), failpoints.FailpointError):
        jkw["error"] = jax_fp.FailpointError(str(kw["error"]))
    stack.enter_context(jax_fp.failpoints.armed(site, **jkw))
    return stack


def test_unknown_table_and_parse_errors(shared):
    for sql, code in (("SELECT COUNT(*) FROM nosuch",
                       errorcodes.TABLE_DOES_NOT_EXIST),
                      ("SELEC broken", errorcodes.SQL_PARSING),
                      ("SELECT COUNT(*) FROM srv WHERE", errorcodes.SQL_PARSING)):
        got, want = shared[True].port.query(sql), shared[True].jax(sql)
        assert _codes(got) == _codes(want) == [code], sql
        assert_same(got, want, what=sql, rows=False)
    # a join: the JAX broker's multi-stage engine would take it; the
    # port has none and answers as the JAX broker does without one
    join = "SELECT a.d_int FROM srv a JOIN st b ON a.d_int = b.d_int"
    assert _codes(shared[True].port.query(join)) == [errorcodes.SQL_PARSING]


def test_quota_rejection(shared):
    port, ref = shared[True].port, shared[True].ref
    try:
        for c, qm in ((port, QueryQuotaManager()), (ref, JaxQuota())):
            qm.set_quota("srv", 0.001)
            c.broker.quota_manager = qm
        for _ in range(2):
            got, want = port.query(Q1), ref.query(Q1)
            assert_same(got, want, what="quota")
        assert _codes(got) == [errorcodes.QUOTA_EXCEEDED]
        # the suffixed name draws from the same bucket
        assert _codes(port.query(Q1.replace("FROM srv", "FROM srv_OFFLINE"))
                      ) == [errorcodes.QUOTA_EXCEEDED]
    finally:
        port.broker.quota_manager = ref.broker.quota_manager = None


def test_deadline_is_a_typed_partial(dirs):
    """The `chaos` schedule of each package's cluster delays every
    scatter past the budget."""
    sql = "SET timeoutMs = 100; " + Q1
    with clusters(dirs, ("srv",), chaos=[("broker.scatter.before",
                                          {"delay": 0.4})]) as (port, ref):
        got, want = port.query(sql), ref.query(sql)
    assert not failpoints.failpoints._sites  # disarmed at stop()
    assert_same(got, want, what="deadline", rows=False)
    assert _codes(got) == [errorcodes.EXECUTION_TIMEOUT] * 2
    assert got.partial_result and got.num_servers_responded == 0


def test_killed_server_partial_and_replica_failover(dirs):
    with clusters(dirs, ("srv", "rep", "rg")) as (port, ref):
        for c in (port, ref):
            c.kill_server(1)
        got, want = port.query(Q1), ref.query(Q1)
        assert_same(got, want, what="no replica", rows=False)
        assert _codes(got) == [errorcodes.SERVER_ERROR] and \
            got.partial_result
        assert "segments lost" in got.exceptions[0]["message"]
        full = port.query(Q1.replace("FROM srv", "FROM rep"))
        assert_same(full, ref.query(Q1.replace("FROM srv", "FROM rep")),
                    what="replica")
        _clean(full, servers=1)
    with clusters(dirs, ("srv", "rep", "rg")) as (port, ref):
        # the first pick of a replica group is group 0 (server_0)
        assert port.kill_replica_group("rg", 0) == ["server_0"]
        ref.kill_replica_group("rg", 0)
        sql = Q1.replace("FROM srv", "FROM rg")
        got, want = port.query(sql), ref.query(sql)
        assert_same(got, want, what="group failover")
        assert got.exceptions == [] and not got.partial_result
        assert (got.num_servers_queried, got.num_servers_responded) == (2, 1)
        # the dead server is now known: the next query goes to group 1
        _clean(port.query(sql), servers=1)


def test_retry_budget_exhausted(dirs):
    with clusters(dirs, ("rep",)) as (port, ref):
        for c in (port, ref):
            c.kill_server(0)
        sql = Q1.replace("FROM srv", "FROM rep")
        with _both_fp("broker.retry.budget",
                      error=failpoints.FailpointError("chaos")):
            got, want = port.query(sql), ref.query(sql)
        assert_same(got, want, what="budget", rows=False)
        assert _codes(got) == [errorcodes.SERVER_ERROR]
        assert "retry budget exhausted" in got.exceptions[0]["message"]


def test_hedge_past_a_delayed_replica(dirs):
    cfg = {"pinot.broker.hedge.enabled": True,
           "pinot.broker.hedge.delay.min.ms": 20,
           "pinot.broker.hedge.delay.max.ms": 20}
    with clusters(dirs, ("rep",), config=cfg) as (port, ref):
        sql = Q1.replace("FROM srv", "FROM rep")
        won = (get_registry("broker").meter("hedge_won"),
               jax_registry("broker").meter("hedge_won"))
        # the first query's primary is server_0 for every segment, held
        # 2 s: the hedge to server_1 answers first (hedge_won, below)
        with _both_fp("broker.scatter.before", delay=2.0,
                      where={"server": "server_0"}):
            got, want = port.query(sql), ref.query(sql)
        assert_same(got, want, what="hedge")
        assert got.exceptions == []
        assert (got.num_servers_queried, got.num_servers_responded) == (2, 1)
        assert get_registry("broker").meter("hedge_won") - won[0] == 1
        assert jax_registry("broker").meter("hedge_won") - won[1] == 1


def test_split_hedge_over_a_partial_replica_layout(dirs):
    """server_0 holds every segment; each segment's one replica is
    server_1 or server_2, so no other server holds them all: past the
    delay the hedge splits into one child a replica, and the children
    together win the race against the held primary."""
    cfg = {"pinot.broker.hedge.enabled": True,
           "pinot.broker.hedge.delay.min.ms": 20,
           "pinot.broker.hedge.delay.max.ms": 20}
    with clusters(dirs, (), config=cfg, num_servers=3) as (port, ref):
        for c, seg in ((port, lambda d: d), (ref, jax_load)):
            c.add_table("pr")
            for i, d in enumerate(dirs["srv"]):
                c.add_segment("pr", seg(d), 0, replicas=[1 + i % 2])
            c.add_table("srv")
            for i, d in enumerate(dirs["srv"]):
                c.add_segment("srv", seg(d), i % 3)
        sql = Q1.replace("FROM srv", "FROM pr")
        meters = ("hedge_won", "hedge_split", "hedge_issued")
        before = ([get_registry("broker").meter(m) for m in meters],
                  [jax_registry("broker").meter(m) for m in meters])
        # the first query's primary is server_0 for every segment, held
        # 2 s: the split hedge to server_1 and server_2 answers first
        with _both_fp("broker.scatter.before", delay=2.0,
                      where={"server": "server_0"}):
            got, want = port.query(sql), ref.query(sql)
        assert_same(got, want, what="split hedge")
        assert got.exceptions == [] and not got.partial_result
        assert (got.num_servers_queried, got.num_servers_responded) == (3, 2)
        assert [get_registry("broker").meter(m) - b
                for m, b in zip(meters, before[0])] == [1, 1, 1]
        assert [jax_registry("broker").meter(m) - b
                for m, b in zip(meters, before[1])] == [1, 1, 1]
        # each segment merged once: the rows of the same data unreplicated
        assert_same(got, port.query(Q1), what="split hedge rows",
                    counts=False)


def test_hybrid_offline_partial_cache(dirs, tmp_path):
    """With the result cache on, a hybrid table caches its offline
    partial under the offline epoch: a repeat scatters to the realtime
    side alone, and removing an offline segment misses."""
    extra = _build(str(tmp_path), "hoff2", [
        ("ts", DataType.LONG, FieldType.DIMENSION),
        ("val", DataType.INT, FieldType.METRIC)],
        [{"ts": np.arange(0, 50, dtype=np.int64),
          "val": np.full(50, 3, np.int32)}])
    sql = "SELECT COUNT(*), SUM(val) FROM hyb"
    with clusters(dirs, (), result_cache=True) as (port, ref):
        for c, seg in ((port, lambda d: d), (ref, jax_load)):
            c.add_table("hyb", "OFFLINE", time_column="ts")
            c.add_table("hyb", "REALTIME", time_column="ts",
                        time_boundary=99)
            c.add_segment("hyb", seg(dirs["hyb_off"][0]), 0, "OFFLINE")
            c.add_segment("hyb", seg(extra[0]), 0, "OFFLINE")
            c.add_segment("hyb", seg(dirs["hyb_rt"][0]), 1, "REALTIME")
        runs = [(port.query(sql), ref.query(sql)) for _ in range(2)]
        for c in (port, ref):
            c.remove_segment("hyb", "hoff2_0", "OFFLINE")
        runs += [(port.query(sql), ref.query(sql)) for _ in range(2)]
        for got, want in runs:
            assert_same(got, want, what="offline partial")
            assert got.exceptions == [] and not got.cache_hit
        # offline ts <= 99: 100 docs of 1 and 50 of 3; realtime ts > 99:
        # 100 docs of 2. A hit queries the realtime server alone
        assert [(g.rows, g.num_servers_queried) for g, _w in runs] == [
            ([(250, 450.0)], 2), ([(250, 450.0)], 1),
            ([(200, 300.0)], 2), ([(200, 300.0)], 1)]


def test_negative_and_result_caches(dirs, shared):
    # partition 7 % 4 = 3 holds no segment (a query of its own: the
    # partition test's p = 3 has filled the cache already)
    sql = "SELECT COUNT(*), SUM(v) FROM part WHERE p = 7"
    first = shared[True].port.query(sql), shared[True].jax(sql)
    again = shared[True].port.query(sql), shared[True].jax(sql)
    assert [r.cache_hit for r in first + again] == [False, False, True, True]
    assert_same(*again, what="negative")
    with clusters(dirs, ("srv",), result_cache=True) as (port, ref):
        runs = [(port.query(Q1), ref.query(Q1)) for _ in range(2)]
        for c in (port, ref):
            c.remove_segment("srv", "srv_0")
        runs.append((port.query(Q1), ref.query(Q1)))
        assert [(g.cache_hit, w.cache_hit) for g, w in runs] == [
            (False, False), (True, True), (False, False)]
        for got, want in runs:
            assert_same(got, want, what="result cache")
        assert runs[2][0].rows != runs[0][0].rows


def test_trace_true_stitches_server_spans(shared):
    port, ref = shared[True].port, shared[True].ref
    sql = "SET trace = true; " + Q1
    got, want = port.query(sql), ref.query(sql)
    assert_same(got, want, what="trace")
    for resp in (got, want):
        scatters = [c for c in resp.trace["children"]
                    if c["operator"] == "ServerScatter"]
        assert sorted(s["server"] for s in scatters) == ["server_0",
                                                         "server_1"]
        for s in scatters:
            [srv] = s["children"]
            assert srv["operator"] == "ServerRequest"
            assert srv["instance"] == s["server"]
            assert srv["traceId"] == resp.trace["traceId"]
    # the port server's engine span sits inside the broker's tree
    dispatch = [c["operator"] for s in got.trace["children"]
                for c in s.get("children", [{}])[0].get("children", [])]
    assert "DeviceDispatch" in dispatch
    ops = [c["operator"] for c in got.trace["children"]]
    assert ops[:2] == ["BrokerParse", "BrokerRoute"] and \
        ops[-1] == "BrokerReduce"
    tid = got.trace["traceId"]
    assert trace_store.get_store("broker").get(tid)["trace"] == got.trace
    assert trace_store.get_store("server").get(f"{tid}@server_0")


def test_slow_query_capture(dirs, caplog):
    for threshold, kept in ((0.0, False), (0.001, True)):
        cfg = {"pinot.broker.slow.query.threshold.ms": threshold}
        with clusters(dirs, ("srv",), config=cfg) as (port, ref):
            slow0 = get_registry("broker").meter("slow_queries")
            with caplog.at_level("WARNING",
                                 logger="pinot_tpu_torch.slowquery"):
                caplog.clear()
                got, want = port.query(Q1), ref.query(Q1)
            assert_same(got, want, what="slow")
            tid = [r for r in caplog.records
                   if r.name == "pinot_tpu_torch.slowquery"]
            assert bool(tid) == kept
            assert (get_registry("broker").meter("slow_queries") - slow0
                    == 1) == kept
            if kept:
                entry = trace_store.get_store("broker").recent(1)[0]
                assert entry["slow"] and entry["sql"] == Q1


def test_query_execution_reply_reaches_the_client(shared, monkeypatch):
    """A failing kernel is a QUERY_EXECUTION exception of each server's
    reply: merged, never retried onto the host or another replica, and
    the server is not marked failed. The JAX broker answers a failing
    execution (an unknown column) with the same codes and flags."""
    port, ref = shared[True].port, shared[True].ref
    sql = "SELECT SUM(nosuch) FROM srv"
    assert_same(port.query(sql), ref.query(sql), what="bad column")

    def broken(*_a, **_k):
        raise RuntimeError("simulated launch failure")

    monkeypatch.setattr(kernels, "compute_slots", broken)
    retries = get_registry("broker").meter("broker_retries_issued")
    got = port.query(Q1.replace("BETWEEN 2 AND 4", "BETWEEN 2 AND 6"))
    assert _codes(got) == [errorcodes.QUERY_EXECUTION] * 2
    assert got.partial_result
    assert (got.num_servers_queried, got.num_servers_responded) == (2, 2)
    assert all("simulated launch failure" in e["message"]
               for e in got.exceptions)
    assert get_registry("broker").meter("broker_retries_issued") == retries
    assert port.broker.failure_detector.unhealthy_servers() == set()


# -- the wire both ways ------------------------------------------------------

def _spy(executor, seen: list):
    real = executor.execute

    def execute(*a, **kw):
        seen.append((kw.get("tenant"), kw.get("trace_ctx")))
        return real(*a, **kw)
    executor.execute = execute


def test_jax_broker_over_port_servers(shared):
    """The JAX broker, routing and connections over the port's two
    servers give the rows the port's own broker gives."""
    port = shared[True].port
    rmgr = jax_routing.BrokerRoutingManager()
    for t in ("srv", "st"):
        rt = jax_routing.RoutingTable(offline=jax_routing.TableRoute(
            f"{t}_OFFLINE"))
        for n, info in port.routing.get_route(t).offline.segments.items():
            rt.offline.segments[n] = jax_routing.SegmentInfo(
                n, list(info.servers), version=info.version)
        rmgr.set_route(t, rt)
    broker = JaxBroker(rmgr, {s.instance_id: JaxConnection(
        s.transport.host, s.transport.port) for s in port.servers})
    broker.tenants.update({"srv": "blue", "st": "blue"})
    seen = []
    for s in port.servers:
        _spy(s.executor, seen)
    try:
        for shape, (_t, sql) in WIRE_SHAPES.items():
            got = broker.handle(sql)
            _clean(got)
            assert_same(got, port.query(sql), what=shape)
    finally:
        for s in port.servers:
            del s.executor.execute
    assert seen and all(t == "blue" and tc and tc.get("traceId")
                        for t, tc in seen)


def test_port_broker_over_jax_servers(dirs):
    """The port's broker, routing and connections over two JAX servers
    give the rows the JAX broker gives over the same servers."""
    servers = [JaxServer(f"server_{i}") for i in range(2)]
    rmgr, jmgr = routing.BrokerRoutingManager(), \
        jax_routing.BrokerRoutingManager()
    for t in ("srv", "st"):
        rt = routing.RoutingTable(offline=routing.TableRoute(f"{t}_OFFLINE"))
        jrt = jax_routing.RoutingTable(offline=jax_routing.TableRoute(
            f"{t}_OFFLINE"))
        for i, d in enumerate(dirs[t]):
            seg = jax_load(d)
            servers[i % 2].data_manager.table(f"{t}_OFFLINE").add_segment(
                seg)
            rt.offline.segments[seg.name] = routing.SegmentInfo(
                seg.name, [f"server_{i % 2}"], version=seg.metadata.crc)
            jrt.offline.segments[seg.name] = jax_routing.SegmentInfo(
                seg.name, [f"server_{i % 2}"], version=seg.metadata.crc)
        rmgr.set_route(t, rt)
        jmgr.set_route(t, jrt)
    seen = []
    for s in servers:
        s.start()
        _spy(s.executor, seen)
    broker = BrokerRequestHandler(rmgr, {s.instance_id: ServerConnection(
        s.transport.host, s.transport.port) for s in servers})
    jbroker = JaxBroker(jmgr, {s.instance_id: JaxConnection(
        s.transport.host, s.transport.port) for s in servers})
    for b in (broker, jbroker):
        b.tenants.update({"srv": "blue", "st": "blue"})
    try:
        for shape, (_t, sql) in WIRE_SHAPES.items():
            got = broker.handle(sql)
            _clean(got)
            assert_same(got, jbroker.handle(sql), what=shape)
    finally:
        broker.close()
        for s in servers:
            s.stop()
    assert seen and all(t == "blue" and tc and tc.get("traceId")
                        for t, tc in seen)


# -- the client ----------------------------------------------------------------

def test_client_over_http(dirs):
    with clusters(dirs, ("srv",), http=True) as (port, ref):
        conn = client.connect(f"127.0.0.1:{port.http.port}")
        jconn = jax_client.connect(f"127.0.0.1:{ref.http.port}")
        cur = conn.cursor()
        for shape in ("q1", "groupby", "selection", "distinct"):
            sql = SHAPES[shape][1]
            rows = cur.execute(sql).fetchall()
            assert rows == [list(r) for r in port.query(sql).rows], shape
            assert [d[0] for d in cur.description] == \
                port.query(sql).result_table.columns
        assert cur.execute(Q1).fetchone() == list(port.query(Q1).rows[0])
        with pytest.raises(client.PinotClientError) as e:
            conn.execute("SELECT COUNT(*) FROM nosuch")
        with pytest.raises(jax_client.PinotClientError) as je:
            jconn.execute("SELECT COUNT(*) FROM nosuch")
        assert [x["errorCode"] for x in e.value.exceptions] == \
            [x["errorCode"] for x in je.value.exceptions] == \
            [errorcodes.TABLE_DOES_NOT_EXIST]
        with _both_fp("broker.scatter.before", delay=0.4):
            with pytest.raises(client.PinotTimeoutError) as e:
                conn.execute(Q1, timeout_ms=100)
            with pytest.raises(jax_client.PinotTimeoutError):
                jconn.execute(Q1, timeout_ms=100)
        assert e.value.result_set.partial_result
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port.http.port}/metrics") as r:
            text = r.read().decode()
        assert "pinot_tpu_broker_broker_queries" in text
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port.http.port}/debug/traces") as r:
            assert b'"role": "broker"' in r.read()


def test_cluster_refuses_the_roles_it_lacks():
    with pytest.raises(ValueError, match="minion"):
        MiniCluster(device="cpu", minions=1)
    with pytest.raises(ValueError, match="cache_server"):
        MiniCluster(device="cpu", cache_servers=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MiniCluster()


def test_chip_smoke_cluster_phase_on_cpu(tmp_path):
    """chip_smoke.py's phase 17 at 4 x 2^13 Q1 rows and 2 x 2^12 small
    rows on the plain PyTorch kernels: every answer through the client
    equal to its numpy truth in the broker's plan order, the traced
    split's spans, and the failover (the launch counts are held on the
    card only)."""
    import chip_smoke as cs
    root = str(tmp_path)
    _segs, truths = cs.build_segments(
        root, "ssb", cs.Q1_FIELDS, cs.Q1_NO_DICT, 4, 1 << 13,
        cs.ssb_q1_columns, cs.q1_leg_truth, 7, 1)
    os.makedirs(os.path.join(root, "server"))
    for i in range(cs.SMALL_SEGMENTS):
        cs.build_one_segment((os.path.join(root, "server"), "small",
                              cs.SMALL_FIELDS, cs.SMALL_NO_DICT, 1 << 12,
                              cs.small_columns, cs.all_columns,
                              7 + cs.SERVER_SEED + 1, i, None))
    got = cs.cluster_phase(root, 7, [os.path.join(root, f"ssb_{i}")
                                     for i in range(4)], truths, "cpu",
                           device="cpu", small_docs=1 << 12, iters=2)
    assert got == {}
