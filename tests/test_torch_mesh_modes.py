"""The modes a segments-only mesh serves per slot, and CLP on any mesh,
against the JAX package.

A segments-only mesh (doc axis 1) runs a selection's top-N (K4) and the
MSE leaf's doc ids (K4) per slot; a CLP leaf (K7, then K1 / K2 / K4) runs
on any mesh, sharded and merged (tests/test_torch_mesh_vector_startree.py
holds K8 and K5 per slot with the helpers here). The conftest gives JAX 8 virtual CPU devices; the port's meshes are
logical meshes of "cpu" slots, as in tests/test_torch_mesh.py, on 2x1 and
4x1, implicit (`devices=`) and explicit (`mesh=`, doc axis 1), and 4x2 for
CLP aggregations. Each shape goes through the JAX mesh engine of the same
geometry (`TpuOperatorExecutor(devices=...)` or `(mesh=...)`), the JAX
host executor, the port's mesh engine and the port's one-device engine,
in both postures: x64 (conftest) against value_dtype float64, and
`jax.enable_x64(False)` against float32. The JAX mesh engine runs every
shape here on its CPU devices, so no shape falls back to JAX's one-device
engine.

Tolerances, as tests/test_torch_mesh.py states them: doc ids, top-K
winners in order, counts and integer sums exact; floats within rel 1e-9
(float64) and 1e-5 (float32); vector ids exact outside the 2^-20 band of a
segment's cut (tests/test_torch_vector.py `_band`); a star-tree answer
equal to its own scan within rel 1e-6 (the other file). The port's mesh
and one-device
engines run the same per-segment kernels, so their rows are equal exactly.
"""
import numpy as np
import pytest
import torch

import jax

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.parallel.mesh import make_mesh as jax_mesh
from pinot_tpu.query.context import QueryContext as JContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.segment.bitmap import Bitmap as JBitmap
from pinot_tpu.segment.loader import load_segment as jload
from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType, Schema,
                                    TableConfig)
from pinot_tpu_torch.ops.engine import NotOffloadable
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.bitmap import Bitmap
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.metrics import get_registry
from tests.test_torch_vector import _json, _vectors

#: (slots, how the mesh is given): implicit devices= or explicit mesh=
GEOMS = [(2, "devices"), (2, "mesh"), (4, "devices"), (4, "mesh")]
GEOM_IDS = ["2x1-implicit", "2x1-explicit", "4x1-implicit", "4x1-explicit"]
POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
GEOMETRIES = pytest.mark.parametrize("n,how", GEOMS, ids=GEOM_IDS)


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _vdt(x64):
    return torch.float64 if x64 else torch.float32


def port_mesh(tsegs, n, how, x64, doc_axis=1, **cfg):
    """The port's executor on a logical CPU mesh of n slots."""
    kw = {"devices": ["cpu"] * n} if how == "devices" else \
        {"mesh": make_mesh(["cpu"] * n, doc_axis=doc_axis)}
    return QueryExecutor(tsegs, device="cpu", value_dtype=_vdt(x64),
                         config=PinotConfiguration(cfg) if cfg else None,
                         **kw)


def jax_engine(n, how, doc_axis=1):
    """The JAX engine of the same geometry on its virtual CPU devices."""
    devs = jax.devices()[:n]
    if how == "devices":
        return TpuOperatorExecutor(devices=devs)
    return TpuOperatorExecutor(mesh=jax_mesh(devs, doc_axis=doc_axis))


def _rows(resp):
    return [tuple(r) for r in resp.result_table.rows]


def _close(a, b, x64):
    """Rows equal, integers exactly and floats within rel 1e-9 / 1e-5."""
    rel = 1e-9 if x64 else 1e-5
    assert len(a) == len(b), (a, b)
    for x, y in zip(a, b):
        assert len(x) == len(y), (a, b)
        for u, v in zip(x, y):
            if isinstance(u, float) or isinstance(v, float):
                assert abs(float(u) - float(v)) <= \
                    rel * max(1.0, abs(float(v))), (a, b)
            else:
                assert u == v, (a, b)


def _no_refusal(engine):
    assert not any(k[0] == "mesh_refused" and v
                   for k, v in engine.meters.items()), engine.meters


#: answers that do not depend on the geometry, kept across the cases:
#: (id of the table's first segment, sql, x64) -> response
_HOST: dict = {}
_ONE: dict = {}


def host_response(jsegs, sql, x64):
    """The JAX host executor's response (the oracle)."""
    key = (id(jsegs[0]), sql, x64)
    if key not in _HOST:
        with jax.enable_x64(x64):
            _HOST[key] = JaxExecutor(jsegs, use_tpu=False).execute(sql)
        assert not _HOST[key].exceptions, sql
    return _HOST[key]


def one_device_rows(tsegs, sql, x64):
    """The port's one-device engine's rows."""
    key = (id(tsegs[0]), sql, x64)
    if key not in _ONE:
        _ONE[key] = _rows(QueryExecutor(
            tsegs, device="cpu", value_dtype=_vdt(x64)).execute(sql))
    return _ONE[key]


class FourWays:
    """The port's mesh executor of one geometry and posture, held against
    the JAX mesh engine of the same geometry, the JAX host executor and
    the port's one-device engine, query by query."""

    def __init__(self, segs, x64, n, how, doc_axis=1, **cfg):
        self.jsegs, self.tsegs = segs
        self.x64 = x64
        self.port = port_mesh(self.tsegs, n, how, x64, doc_axis, **cfg)
        self.jdev = JaxExecutor(self.jsegs, use_tpu=True,
                                engine=jax_engine(n, how, doc_axis))

    @property
    def engine(self):
        return self.port.engine

    def jax_response(self, sql):
        with jax.enable_x64(self.x64):
            resp = self.jdev.execute(sql)
        assert not resp.exceptions, sql
        return resp

    def check(self, sql, exact=True):
        """The port mesh's response, its rows equal to the one-device
        engine's exactly and to both JAX references (floats within the
        posture's tolerance unless exact), docs scanned equal."""
        got = self.port.execute(sql)
        assert _rows(got) == one_device_rows(self.tsegs, sql, self.x64), sql
        for ref in (self.jax_response(sql),
                    host_response(self.jsegs, sql, self.x64)):
            if exact:
                assert _rows(got) == _rows(ref), sql
            else:
                _close(_rows(got), _rows(ref), self.x64)
            assert got.stats.num_docs_scanned == \
                ref.stats.num_docs_scanned, sql
        _no_refusal(self.engine)
        return got


# ---------------------------------------------------------------------------
# selection (K4) and the MSE leaf's doc ids
# ---------------------------------------------------------------------------

#: ORDER BY one key without and with a filter (a raw value; dictionary
#: ids)
SELECTIONS = [
    "SELECT d, m FROM t ORDER BY m DESC LIMIT 7",
    "SELECT s, d FROM t WHERE m > 50000 ORDER BY s LIMIT 11",
]


@pytest.fixture(scope="module")
def sel_segs(tmp_path_factory):
    """tests/test_torch_selection.py's table at four segments of unequal
    sizes (the last below a slot's share), built by the port's creator and
    loaded by both loaders: (JAX segments, port segments)."""
    tmp = tmp_path_factory.mktemp("mesh_modes_sel")
    schema = Schema("t", [FieldSpec("d", DataType.INT, FieldType.DIMENSION),
                          FieldSpec("s", DataType.STRING,
                                    FieldType.DIMENSION),
                          FieldSpec("m", DataType.INT, FieldType.METRIC)])
    tc = TableConfig("t")
    tc.indexing.no_dictionary_columns = ["m"]
    rng = np.random.default_rng(21)
    dirs = []
    for i, n in enumerate((1500, 1200, 1700, 400)):
        out = str(tmp / f"t_{i}")
        SegmentCreator(tc, schema).build({
            "d": rng.integers(0, 20, n).astype(np.int32),
            "s": np.array([f"v{x}" for x in rng.integers(0, 6, n)], object),
            "m": rng.integers(0, 100000, n).astype(np.int32)}, out, f"t_{i}")
        dirs.append(out)
    return [jload(d) for d in dirs], [load_segment(d) for d in dirs]


@POSTURES
@GEOMETRIES
def test_selection_on_a_segments_only_mesh(sel_segs, x64, n, how):
    ways = FourWays(sel_segs, x64, n, how)
    for sql in SELECTIONS:
        ways.check(sql)
    assert ways.engine._blocks


@pytest.mark.parametrize("n,how", GEOMS[2:], ids=GEOM_IDS[2:])
@POSTURES
def test_selection_over_upsert_segments(sel_segs, n, how, x64):
    """The vmask block shards by segment with the other columns."""
    jsegs, tsegs = sel_segs
    rng = np.random.default_rng(77)
    try:
        for js, ts in zip(jsegs, tsegs):
            keep = np.nonzero(rng.random(js.num_docs) < 0.6)[0].tolist()
            js.valid_doc_ids = JBitmap.from_indices(js.num_docs, keep)
            ts.valid_doc_ids = Bitmap.from_indices(ts.num_docs, keep)
        ways = FourWays(sel_segs, x64, n, how)
        for sql in SELECTIONS[:2]:
            got = ways.port.execute(sql)
            assert _rows(got) == _rows(QueryExecutor(
                tsegs, device="cpu", value_dtype=_vdt(x64)).execute(sql))
            for ref in (ways.jax_response(sql), JaxExecutor(
                    jsegs, use_tpu=False).execute(sql)):
                assert _rows(got) == _rows(ref), sql
            _no_refusal(ways.engine)
    finally:
        for js, ts in zip(jsegs, tsegs):
            js.valid_doc_ids = None
            ts.valid_doc_ids = None


@POSTURES
@GEOMETRIES
def test_filtered_doc_ids_on_a_segments_only_mesh(sel_segs, x64, n, how):
    """The MSE leaf's doc ids: equal to the JAX mesh engine's and to the
    one-device engine's, segment by segment."""
    jsegs, tsegs = sel_segs
    port = port_mesh(tsegs, n, how, x64).engine
    one = QueryExecutor(tsegs, device="cpu", value_dtype=_vdt(x64)).engine
    for where in ("d = 7 AND m < 30000", "m > 99000"):
        sql = f"SELECT COUNT(*) FROM t WHERE {where}"
        with jax.enable_x64(x64):
            want = jax_engine(n, how).filtered_doc_ids(
                jsegs, JContext.from_sql(sql).filter)
        got = port.filtered_doc_ids(tsegs, QueryContext.from_sql(sql).filter)
        ref = one.filtered_doc_ids(tsegs, QueryContext.from_sql(sql).filter)
        for a, b, c in zip(got, want, ref):
            assert (a is None) == (b is None) == (c is None), where
            if a is not None:
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
    _no_refusal(port)


# ---------------------------------------------------------------------------
# CLP (K7, then K1 / K2 / K4) on any mesh
# ---------------------------------------------------------------------------

#: tests/test_torch_clp.py's corpus, cut
MESSAGES = [
    "INFO task 1234 started on host web-01 in 0.5s",
    "WARN task 9999 slow on host web-02 in 12.75s",
    "ERROR task 1234 failed on host web-01: code=500",
    "INFO user alice logged in from 10.0.0.1",
    "disk /dev/sda1 at 93% capacity",
    "GC pause 45 ms in region r7",
    "ERROR task 777 failed on host db-01: code=503",
    "retrying connection to 10.0.0.1 attempt 3",
]
CLP_AGGS = [
    "SELECT COUNT(*) FROM logs WHERE message LIKE '%failed%' AND ts < 500",
    "SELECT lvl, COUNT(*), SUM(ts) FROM logs WHERE message LIKE '%host%' "
    "GROUP BY lvl ORDER BY lvl LIMIT 10",
]
CLP_SELECTION = ("SELECT ts, message FROM logs WHERE message LIKE 'INFO%' "
                 "ORDER BY ts DESC LIMIT 12")


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Four CLP segments (rotated corpora, distinct doc counts) with a
    level dimension, built by the port's creator."""
    tmp = tmp_path_factory.mktemp("mesh_modes_logs")
    schema = Schema("logs", [
        FieldSpec("ts", DataType.LONG, FieldType.DATE_TIME),
        FieldSpec("lvl", DataType.INT, FieldType.DIMENSION),
        FieldSpec("message", DataType.STRING)])
    tc = TableConfig("logs")
    tc.indexing.clp_columns = ["message"]
    dirs = []
    for si in range(4):
        n = 200 + 37 * si
        msgs = [MESSAGES[(i * (si + 1)) % len(MESSAGES)] for i in range(n)]
        out = str(tmp / f"logs_{si}")
        SegmentCreator(tc, schema).build(
            {"ts": np.arange(n, dtype=np.int64) + 100 * si,
             "lvl": (np.arange(n) % 3).astype(np.int32),
             "message": msgs}, out, f"logs_{si}")
        dirs.append(out)
    return [jload(d) for d in dirs], [load_segment(d) for d in dirs]


@POSTURES
@GEOMETRIES
def test_clp_on_a_segments_only_mesh(logs, x64, n, how):
    """Aggregations (merged on an explicit mesh, per segment on an
    implicit one) and a log tail (K4 per slot)."""
    ways = FourWays(logs, x64, n, how)
    for sql in CLP_AGGS + [CLP_SELECTION]:
        ways.check(sql, exact=False)
    eng = ways.engine
    assert eng.meter("clp_served") == len(CLP_AGGS) + 1
    assert eng.meter("mesh_merge_served") == \
        (len(CLP_AGGS) if how == "mesh" else 0)


@POSTURES
@pytest.mark.parametrize("merge", [True, False], ids=["merged", "sharded"])
def test_clp_aggregation_on_a_doc_sharded_mesh(logs, x64, merge):
    """4x2: K7 on each [S_loc, D_loc] shard, K1 / K2, then K9 folds the
    doc slices (sharded) or the whole batch (merged); a CLP selection
    stays refused there, as every top-N across doc shards."""
    ways = FourWays(logs, x64, 8, "mesh", doc_axis=2,
                    **{"pinot.server.mesh.collective.merge": merge})
    for sql in CLP_AGGS:
        ways.check(sql, exact=False)
    eng = ways.engine
    assert eng.meter("mesh_merge_served") == (len(CLP_AGGS) if merge else 0)
    assert eng.meter("clp_served") == len(CLP_AGGS)
    with pytest.raises(NotOffloadable) as e:
        ways.port.execute(CLP_SELECTION)
    assert e.value.reason == "mesh"
    assert eng.meter("mesh_refused", "topn") == 1


# ---------------------------------------------------------------------------
# the refusals that stay, through the server's call
# ---------------------------------------------------------------------------

def test_refused_shapes_reach_the_host_with_their_reason(sel_segs, tmp_path):
    """On a doc-sharded mesh a top-N (reason 'mesh') and a vector search
    ('staging') stay refused, and an explicit mesh refuses the time
    bucket ('mesh'); `execute_context`, the server's call, hands each to
    the host executor and counts it on host_fallback{reason}. The top-N
    and the time bucket come back equal to the host oracle; the port's
    host executor has no vector_similarity yet, so the vector search
    fails there, naming it."""
    from pinot_tpu_torch.ops.engine import TorchOperatorExecutor
    reg = get_registry("server")
    jsegs, tsegs = sel_segs
    doc = TorchOperatorExecutor("cpu", torch.float64,
                                mesh=make_mesh(["cpu"] * 8, doc_axis=2))
    sql = SELECTIONS[1]
    before = reg.meter("host_fallback", labels={"reason": "mesh"})
    res, _stats = QueryExecutor(tsegs, engine=doc).execute_context(
        QueryContext.from_sql(sql))
    from pinot_tpu_torch.query.reduce import reduce_results
    got = reduce_results(QueryContext.from_sql(sql), res)
    assert _rows(got) == _rows(JaxExecutor(jsegs, use_tpu=False)
                               .execute(sql))
    assert reg.meter("host_fallback", labels={"reason": "mesh"}) \
        == before + 1
    assert doc.meter("mesh_refused", "topn") == 1
    where = QueryContext.from_sql(
        "SELECT COUNT(*) FROM t WHERE d = 7").filter
    with pytest.raises(NotOffloadable, match="doc-sharded"):
        doc.filtered_doc_ids(tsegs, where)
    assert doc.meter("mesh_refused", "doc_ids") == 1
    # the vector search, over one exact segment of the emb table
    v = _vectors(7, 300)
    etc = TableConfig("emb")
    etc.indexing.vector_index_columns = ["vec"]
    SegmentCreator(etc, Schema("emb", [
        FieldSpec("id", DataType.INT), FieldSpec("vec", DataType.STRING)])
    ).build({"id": np.arange(300, dtype=np.int32),
             "vec": np.array([_json(r) for r in v], object)},
            str(tmp_path / "emb"), "emb")
    tv = [load_segment(str(tmp_path / "emb"))]
    qv = v[3]
    vsql = (f"SELECT id FROM emb WHERE vector_similarity(vec, "
            f"'{_json(qv)}', 5) LIMIT 10")
    before = reg.meter("host_fallback", labels={"reason": "staging"})
    with pytest.raises(NotImplementedError, match="vector_similarity"):
        QueryExecutor(tv, engine=doc).execute_context(
            QueryContext.from_sql(vsql))
    assert reg.meter("host_fallback", labels={"reason": "staging"}) \
        == before + 1
    assert doc.meter("vector_fallback", "staging") == 1
    # the time bucket on an explicit segments-only mesh
    rng = np.random.default_rng(8)
    fields = [FieldSpec("ts", DataType.LONG, FieldType.DATE_TIME),
              FieldSpec("h", DataType.INT)]
    tdirs = []
    for i in range(2):
        out = str(tmp_path / f"tb{i}")
        SegmentCreator(TableConfig("tb"), Schema("tb", fields)).build(
            {"ts": np.sort(rng.integers(0, 1000, 300)).astype(np.int64),
             "h": rng.integers(0, 3, 300).astype(np.int32)}, out, f"tb{i}")
        tdirs.append(out)
    tsql = ("SELECT FLOOR((ts - 0) / 100), h, COUNT(*) FROM tb "
            "WHERE ts >= 0 AND ts < 1000 GROUP BY FLOOR((ts - 0) / 100), h "
            "ORDER BY FLOOR((ts - 0) / 100), h LIMIT 1000")
    explicit = TorchOperatorExecutor("cpu", torch.float64,
                                     mesh=make_mesh(["cpu"] * 2))
    res, _stats = QueryExecutor([load_segment(d) for d in tdirs],
                                engine=explicit).execute_context(
        QueryContext.from_sql(tsql))
    got = reduce_results(QueryContext.from_sql(tsql), res)
    want = JaxExecutor([jload(d) for d in tdirs],
                       use_tpu=False).execute(tsql)
    _close(_rows(got), _rows(want), True)
    assert explicit.meter("mesh_refused", "tbucket") == 1
