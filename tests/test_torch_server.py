"""The port's server against the JAX package's, over TCP.

Two servers on 127.0.0.1:0 per precision posture, loading the same
segment directories (tests/torch_tables.py, built by the port's creator):
the JAX `QueryServer(ServerQueryExecutor(dm, use_tpu=True))` on JAX's CPU,
its segment result cache and admission control off and its engine on one
of the conftest's virtual devices (as the port's engine is on one card),
and the port's `MiniClusterServer(device="cpu")` (plain PyTorch kernels)
at float64 (x64) or float32 (`jax_enable_x64` off for the JAX server's
requests). Each request goes through each package's own
`ServerConnection`; each side decodes its own
PDT1 bytes and reduces them with its own reduce.

Shapes (torch_tables.SHAPES): Q1-shaped, a group-by, DISTINCTCOUNTHLL +
PERCENTILETDIGEST, the moments and BOOL_AND / BOOL_OR, a top-N selection,
DISTINCT, a star-tree group-by, an upsert table, and the three shapes the
port's planner refuses by design (grouped sketches, two ORDER BY keys, a
group-by on a raw column), which its host executor answers, each counted
once on `host_fallback` (the device shapes never are). Rows are equal:
counts, integer sums, HLL values and group keys exactly (any value that is
integral on the reference side), other values within rel 1e-9 under x64
and within the existing float32 tests' bars with x64 off (rel 1e-5, as
tests/test_torch_query.py; the moments 2 * 2e-3 of max(1, |value|), as
tests/test_torch_moments.py's F32_JAX_ERR, their values being differences
of large raw-moment sums). The FLOAT-literal queries are held to the JAX
host oracle, as the reference's x64 device path compares a FLOAT column
in double (ROADMAP §C).

Also: each side decodes the other's bytes to the same rows; the error
replies (TABLE_DOES_NOT_EXIST, 250 on an expired deadline,
QUERY_EXECUTION) carry the reference's codes; a segment replace is
followed by the next query and uploads that segment's columns alone; a
segment added after a plan was logged is prestaged, so the first query
after the add uploads no column byte; a traced request's DeviceDispatch
span carries the JAX engine's transferBytes (a refused one's request
its reason); and a kernel that raises
fails the query with QUERY_EXECUTION without the host executor ever
running.
"""
import contextlib
import math
import os

import pytest
import torch

import jax

from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.query.reduce import reduce_results as jax_reduce
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.upsert import \
    PartitionUpsertMetadataManager as JaxManager
from pinot_tpu.server import datatable as jax_datatable
from pinot_tpu.server.data_manager import \
    InstanceDataManager as JaxDataManager
from pinot_tpu.server.query_server import QueryServer as JaxQueryServer
from pinot_tpu.server.query_server import \
    ServerConnection as JaxConnection
from pinot_tpu.server.query_server import \
    ServerQueryExecutor as JaxServerExecutor
from pinot_tpu.utils import errorcodes as jax_errorcodes
from pinot_tpu.utils.config import PinotConfiguration as JaxConfig
from pinot_tpu_torch.cluster.mini import MiniClusterServer
from pinot_tpu_torch.ops import kernels, residency
from pinot_tpu_torch.ops.engine import _batch_key, _pow2
from pinot_tpu_torch.query import executor_cpu
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.reduce import reduce_results
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.upsert import PartitionUpsertMetadataManager
from pinot_tpu_torch.server import datatable
from pinot_tpu_torch.server.query_server import ServerConnection
from pinot_tpu_torch.utils import errorcodes
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.metrics import get_registry

from tests import torch_tables as tt

F64_REL, F32_REL, F32_MOMENTS = 1e-9, 1e-5, 4e-3
MOMENT_COLUMNS = ("variance", "stddev", "skewness", "kurtosis")


@contextlib.contextmanager
def posture(x64: bool):
    """JAX's precision for the requests in the scope: the JAX server's
    worker threads read the global flag, not a thread's context."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


class Pair:
    """A JAX server and a port server over the same directories."""

    def __init__(self, dirs, x64: bool):
        self.x64 = x64
        jdm = JaxDataManager("jax_server")
        cfg = JaxConfig(overrides={
            "pinot.server.segment.cache.enabled": False,
            # no admission control, as the port has none: an expired
            # deadline is the executor's 250, not admission's 211
            "pinot.server.admission.enabled": False,
            "pinot.server.query.deadline.grace.ms": 0})
        self.jax_exec = JaxServerExecutor(jdm, use_tpu=True, config=cfg)
        # the server's engine on ONE of the conftest's virtual devices, as
        # the port's is on one card: both stage the same [S, D] blocks
        self.jax_exec._engine = TpuOperatorExecutor(
            devices=jax.devices()[:1], config=cfg,
            metrics_labels={"instance": "jax_server"})
        self.jax_server = JaxQueryServer(self.jax_exec)
        self.port = MiniClusterServer(
            f"port_{'f64' if x64 else 'f32'}", device="cpu",
            value_dtype=torch.float64 if x64 else torch.float32,
            config=PinotConfiguration(
                {"pinot.server.query.deadline.grace.ms": 0}))
        with posture(x64):
            for table, table_dirs in dirs.items():
                jsegs = [jax_load(d) for d in table_dirs]
                tsegs = [load_segment(d) for d in table_dirs]
                if table == "ups":
                    jm = JaxManager(["pk"], "ver")
                    tm = PartitionUpsertMetadataManager(["pk"], "ver")
                    for j, t in zip(jsegs, tsegs):
                        jm.add_segment(j, use_snapshot=False)
                        tm.add_segment(t, use_snapshot=False)
                for j in jsegs:
                    jdm.table(table).add_segment(j)
                for t in tsegs:
                    self.port.data_manager.table(table).add_segment(t)
        self.jax_server.start()
        self.port.start()
        self.jax_conn = JaxConnection("127.0.0.1", self.jax_server.port)
        self.port_conn = ServerConnection("127.0.0.1",
                                          self.port.transport.port)

    def jax_bytes(self, table, sql, **kw) -> bytes:
        with posture(self.x64):
            return self.jax_conn.request(table, sql, **kw)

    def port_bytes(self, table, sql, **kw) -> bytes:
        return self.port_conn.request(table, sql, **kw)

    def stop(self):
        self.jax_server.stop()
        self.port.stop()


def port_rows(buf: bytes, sql: str):
    results, exc, stats, _tree = datatable.deserialize_results_ex(buf)
    assert not exc, exc
    resp = reduce_results(QueryContext.from_sql(sql), results)
    return resp.result_table.columns, resp.rows


def jax_rows(buf: bytes, sql: str):
    results, exc, _stats, _tree = jax_datatable.deserialize_results_ex(buf)
    assert not exc, exc
    resp = jax_reduce(JaxContext.from_sql(sql), results)
    return resp.result_table.columns, resp.rows


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("server_tables"))
    return {"srv": tt.build_table(root, "srv"),
            "st": tt.build_table(root, "st", star_tree=True),
            "ups": tt.build_table(root, "ups")}


@pytest.fixture(scope="module")
def pairs(dirs):
    out = {x64: Pair(dirs, x64) for x64 in (True, False)}
    yield out
    for p in out.values():
        p.stop()


def _close(name: str, got, want, x64: bool) -> bool:
    if isinstance(want, bool) or isinstance(want, str) or want is None:
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


def assert_rows_match(got, want, x64: bool, what):
    (gcols, grows), (wcols, wrows) = got, want
    assert gcols == wcols, what
    assert len(grows) == len(wrows) > 0, what
    for gr, wr in zip(grows, wrows):
        for name, g, w in zip(wcols, gr, wr):
            assert _close(name.lower(), g, w, x64), (what, name, g, w)


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(tt.SHAPES))
def test_server_rows_match_jax(pairs, shape, x64):
    pair = pairs[x64]
    table, sql = tt.SHAPES[shape]
    reg = get_registry("server")
    fb0 = reg.meter_total("host_fallback")
    labelled = {"reason": tt.REFUSED.get(shape, "")}
    fl0 = reg.meter("host_fallback", labels=labelled)
    got = port_rows(pair.port_bytes(table, sql), sql)
    assert reg.meter_total("host_fallback") - fb0 == \
        reg.meter("host_fallback", labels=labelled) - fl0 == \
        (1 if shape in tt.REFUSED else 0), shape
    want = jax_rows(pair.jax_bytes(table, sql), sql)
    assert_rows_match(got, want, x64, shape)


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(tt.FLOAT_SHAPES))
def test_float_literal_held_to_host_oracle(pairs, dirs, shape, x64):
    sql = tt.FLOAT_SHAPES[shape]
    with posture(x64):
        oracle = JaxExecutor([jax_load(d) for d in dirs["srv"]],
                             use_tpu=False).execute(tt.float_oracle_sql(shape))
    got = port_rows(pairs[x64].port_bytes("srv", sql), sql)
    assert got == (oracle.result_table.columns, oracle.rows)


@pytest.mark.parametrize("shape", list(tt.SHAPES))
def test_wire_bytes_cross_decode(pairs, shape):
    """The port's bytes through JAX's decoder and reduce, and JAX's through
    the port's, give the rows each side's own decode gives."""
    pair = pairs[True]
    table, sql = tt.SHAPES[shape]
    port_buf, jax_buf = pair.port_bytes(table, sql), pair.jax_bytes(table,
                                                                    sql)
    assert jax_rows(port_buf, sql) == port_rows(port_buf, sql)
    assert port_rows(jax_buf, sql) == jax_rows(jax_buf, sql)


def _codes(buf: bytes, decode) -> list:
    return [e["errorCode"] for e in decode(buf)[1]]


@pytest.mark.parametrize("case", ["no_table", "deadline", "bad_sql",
                                  "no_column"])
def test_error_replies_match_jax(pairs, case):
    pair = pairs[True]
    table, sql, kw = {
        "no_table": ("nosuch", "SELECT COUNT(*) FROM nosuch", {}),
        "deadline": ("srv", tt.SHAPES["q1"][1],
                     {"timeout_ms": 1e-6, "query_id": "late"}),
        "bad_sql": ("srv", "SELEC COUNT(*) FROM srv", {}),
        "no_column": ("srv", "SELECT SUM(nosuch) FROM srv", {}),
    }[case]
    want = {"no_table": errorcodes.TABLE_DOES_NOT_EXIST,
            "deadline": errorcodes.EXECUTION_TIMEOUT}.get(
        case, errorcodes.QUERY_EXECUTION)
    port = _codes(pair.port_bytes(table, sql, **kw),
                  datatable.deserialize_results_ex)
    ref = _codes(pair.jax_bytes(table, sql, **kw),
                 jax_datatable.deserialize_results_ex)
    assert port == ref == [want], case
    assert (errorcodes.TABLE_DOES_NOT_EXIST, errorcodes.QUERY_EXECUTION,
            errorcodes.EXECUTION_TIMEOUT) == (
        jax_errorcodes.TABLE_DOES_NOT_EXIST, jax_errorcodes.QUERY_EXECUTION,
        jax_errorcodes.EXECUTION_TIMEOUT)


def _block_sizes(engine, segs) -> list:
    """The element size of each block the engine holds for the batch
    `segs`."""
    key = _batch_key(segs)
    sizes = [dev.element_size() for k, (_s, dev) in engine._blocks.items()
             if k[0] == key]
    assert sizes
    return sizes


def test_segment_replace_and_warmup(tmp_path):
    """On the port's server: Q1 over three segments; replacing one with
    other data, the next Q1 follows the new data and the replace plus that
    query upload the new segment's columns alone (the warm-up prestages it
    before the swap); a fourth segment added after Q1 was logged is
    prestaged, so the first Q1 after the add uploads no column byte."""
    root = str(tmp_path)
    dirs = tt.build_table(root, "rep")
    new0 = os.path.join(root, "new")
    os.makedirs(new0)
    other = tt.build_table(new0, "rep", seed=9)
    srv = MiniClusterServer("port_rep", device="cpu",
                            value_dtype=torch.float64)
    srv.start()
    try:
        tdm = srv.data_manager.table("rep")
        for d in dirs:
            tdm.add_segment_from_dir(d)
        conn = ServerConnection("127.0.0.1", srv.transport.port)
        sql = tt.SHAPES["q1"][1].replace("FROM srv", "FROM rep")

        def truth(ds):
            return JaxExecutor([jax_load(d) for d in ds],
                               use_tpu=False).execute(sql).rows

        assert port_rows(conn.request("rep", sql), sql)[1] == truth(dirs)
        c0 = residency.column_transfer_bytes()
        tdm.add_segment_from_dir(other[0])  # same name: a replace
        rows = port_rows(conn.request("rep", sql), sql)[1]
        moved = residency.column_transfer_bytes() - c0
        assert rows == truth([other[0], *dirs[1:]]) != truth(dirs)
        eng = srv.executor.engine
        live = [tdm.current_segment(n) for n in tdm.segment_names]
        assert moved == sum(_pow2(live[0].num_docs) * size
                            for size in _block_sizes(eng, live))
        # no block or row of the replaced object survives
        assert all(s is live[0] for segs, _d in eng._blocks.values()
                   for s in segs if s.name == "rep_0")
        c0 = residency.column_transfer_bytes()
        tdm.add_segment_from_dir(_renamed(other[1], root))
        assert srv.executor.warmup.segments_prestaged == 2
        prestaged = residency.column_transfer_bytes() - c0
        c1 = residency.column_transfer_bytes()
        rows = port_rows(conn.request("rep", sql), sql)[1]
        assert residency.column_transfer_bytes() == c1, "upload after add"
        assert prestaged > 0
        assert rows == truth([other[0], *dirs[1:],
                              os.path.join(root, "added", "rep_9")])
    finally:
        srv.stop()


def _renamed(seg_dir: str, root: str) -> str:
    """A copy of a segment directory under the name rep_9."""
    import json
    import shutil
    out = os.path.join(root, "added", "rep_9")
    shutil.copytree(seg_dir, out)
    meta = os.path.join(out, "metadata.json")
    with open(meta) as f:
        m = json.load(f)
    m["segmentName"] = "rep_9"
    with open(meta, "w") as f:
        json.dump(m, f)
    return out


def test_staging_span_matches_jax(pairs, dirs):
    """A traced request to a cold table: the port's DeviceDispatch span
    carries stagingMs, transferBytes, hbmBlockHits and hbmBlockMisses,
    its transferBytes equal to the JAX engine's span's. A traced refused
    shape names its reason on the request and runs in a HostExecutor
    span."""
    pair = pairs[True]
    for p_dm, j_dm in ((pair.port.data_manager, pair.jax_exec.data_manager),):
        for d in dirs["srv"]:
            p_dm.table("trc").add_segment(load_segment(d))
            j_dm.table("trc").add_segment(jax_load(d))
    sql = tt.SHAPES["q1"][1].replace("FROM srv", "FROM trc")
    ctx = {"traceId": "t1", "spanId": "s1", "sampled": True}

    def span(decode, buf):
        tree = decode(buf)[3]
        nodes, out = [tree], []
        while nodes:
            n = nodes.pop()
            out += [n] if n.get("operator") == "DeviceDispatch" else []
            nodes += n.get("children", [])
        assert len(out) == 1, tree
        return out[0]

    port = span(datatable.deserialize_results_ex,
                pair.port_bytes("trc", sql, trace_ctx=ctx))
    ref = span(jax_datatable.deserialize_results_ex,
               pair.jax_bytes("trc", sql, trace_ctx=ctx))
    for attr in ("stagingMs", "transferBytes", "hbmBlockHits",
                 "hbmBlockMisses"):
        assert attr in port, attr
    assert port["transferBytes"] == ref["transferBytes"] > 0, (port, ref)
    assert port["hbmBlockMisses"] > 0
    # a refused shape: the request carries the reason, and the host
    # executor's span follows the refused staging's
    sql = tt.SHAPES["raw_group_by"][1]
    tree = datatable.deserialize_results_ex(
        pair.port_bytes("srv", sql, trace_ctx=ctx))[3]
    assert tree["hostFallback"] == "rawGroupBy"
    assert tree["hostFallbackWhy"] == \
        "group-by on raw column r_small (no dictionary)"
    assert [c["operator"] for c in tree["children"]] == [
        "DeviceDispatch", "HostExecutor"]
    assert tree["children"][0]["outcome"] == "hostFallback"


def test_kernel_error_is_never_answered_by_the_host(pairs, monkeypatch):
    """A plain kernel that raises fails the query with QUERY_EXECUTION;
    the host executor is never called."""
    pair = pairs[True]

    def broken(*_a, **_k):
        raise RuntimeError("simulated launch failure")

    calls = []
    real = executor_cpu.execute_segment
    monkeypatch.setattr(kernels, "compute_slots", broken)
    monkeypatch.setattr(executor_cpu, "execute_segment",
                        lambda *a: calls.append(a) or real(*a))
    sql = tt.SHAPES["q1"][1].replace("d_int BETWEEN 2 AND 4",
                                     "d_int BETWEEN 2 AND 5")
    _r, exc, _s, _t = datatable.deserialize_results_ex(
        pair.port_bytes("srv", sql))
    assert [e["errorCode"] for e in exc] == [errorcodes.QUERY_EXECUTION]
    assert "simulated launch failure" in exc[0]["message"]
    assert calls == []


def test_chip_smoke_server_phase_on_cpu(tmp_path):
    """chip_smoke.py's phase 15 at 3 x 2^13 Q1 rows and 2 x 2^12 small
    rows on the plain PyTorch kernels: every answer equal to its numpy
    truth, host_fallback up by the refused shapes alone, the error codes,
    the replace's and the add's column bytes (the launch counts are held on
    the card only)."""
    import chip_smoke as cs
    dirs_, truths = [], []
    segs, truths = cs.build_segments(
        str(tmp_path), "ssb", cs.Q1_FIELDS, cs.Q1_NO_DICT, 3, 1 << 13,
        cs.ssb_q1_columns, cs.q1_leg_truth, 7, 1)
    dirs_ = [os.path.join(str(tmp_path), f"ssb_{i}") for i in range(3)]
    got = cs.server_phase(str(tmp_path), 7, dirs_, truths, "cpu",
                          device="cpu", docs=1 << 13, small_docs=1 << 12,
                          iters=2, build_workers=1)
    assert got == {}
