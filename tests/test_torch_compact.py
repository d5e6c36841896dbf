"""Compact group keys in the port against the JAX package.

A GROUP BY or DISTINCT whose dense key space exceeds MAX_DEVICE_GROUPS
(2^20) plans compact keys: per-segment codes over the key tuples present,
staged as an int32 'gkey' block, K2 grouping by them at the launch's G
(JAX kernels.py:488-491, engine.py:1688-1694, :2367-2447, :2987-2993,
:583-607, collective.py:68-73). On tests/test_compact_groupby.py's shape
(2 x 20,000 docs, three dimensions of about 1000 values each) the same
segments go through the port (`device="cpu"`, the plain kernels), the JAX
engine and the JAX host executor, in both postures: x64 (conftest) against
float64, and `jax.enable_x64(False)` against float32.

Tolerances (tests/torch_plans.py): counts, integer sums, min / max of
integer columns and keys exact; AVG and float sums within rel 1e-9 under
x64 and 1e-5 in float32; kernel slots as tests/test_torch_kernels.py
holds them (`assert_packed_equal`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.models import (DataType, FieldSpec, FieldType, Schema,
                              TableConfig, TableType)
from pinot_tpu.ops import collective as jc
from pinot_tpu.ops import kernels as jk
from pinot_tpu.ops import plan_ir as jir
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.parallel.mesh import make_mesh as jax_mesh
from pinot_tpu.query.context import QueryContext as JContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.segment.bitmap import Bitmap as JBitmap
from pinot_tpu.segment.creator import SegmentCreator
from pinot_tpu.segment.loader import load_segment as jax_load

from pinot_tpu_torch.ops import collective as tc
from pinot_tpu_torch.ops import engine as eng_mod
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops.engine import NotOffloadable
from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
from pinot_tpu_torch.parallel import make_mesh, shard_block
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.bitmap import Bitmap
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.utils.config import PinotConfiguration
from tests import torch_plans as tp
from tests.test_torch_dispatch import make_engine, run_concurrent
from tests.test_torch_kernels import run_program

POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])

SUM_SQL = ("SELECT a, b, c, SUM(m), COUNT(*) FROM t "
           "GROUP BY a, b, c ORDER BY a, b, c LIMIT 100000")
FILTER_SQL = ("SELECT a, b, c, MIN(m), MAX(m), AVG(m) FROM t "
              "WHERE c BETWEEN 100 AND 700 AND a < 900 "
              "GROUP BY a, b, c ORDER BY a, b, c LIMIT 100000")
DISTINCT_SQL = "SELECT DISTINCT a, b, c FROM t ORDER BY a, b, c LIMIT 100000"
TOP_SQL = ("SELECT a, b, c, COUNT(*), SUM(m) FROM t WHERE b < {} "
           "GROUP BY a, b, c ORDER BY COUNT(*) DESC, a, b, c LIMIT 20")
SQLS = {"sum": SUM_SQL, "filter": FILTER_SQL, "distinct": DISTINCT_SQL}


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """tests/test_compact_groupby.py's two segments (seed 31), built by the
    JAX creator and loaded by each package's loader: (JAX, port)."""
    tmp = tmp_path_factory.mktemp("torch_compact")
    schema = Schema("t", [
        FieldSpec("a", DataType.INT, FieldType.DIMENSION),
        FieldSpec("b", DataType.INT, FieldType.DIMENSION),
        FieldSpec("c", DataType.INT, FieldType.DIMENSION),
        FieldSpec("m", DataType.INT, FieldType.METRIC)])
    tcfg = TableConfig("t", TableType.OFFLINE)
    tcfg.indexing.no_dictionary_columns = ["m"]
    creator = SegmentCreator(tcfg, schema)
    rng = np.random.default_rng(31)
    jsegs, tsegs = [], []
    for i in range(2):
        n = 20000
        cols = {"a": rng.integers(0, 1000, n).astype(np.int32),
                "b": (rng.integers(0, 1000, n) * 7).astype(np.int32),
                "c": rng.integers(0, 900, n).astype(np.int32),
                "m": rng.integers(0, 1000, n).astype(np.int32)}
        d = str(tmp / f"seg_{i}")
        creator.build(cols, d, f"t_{i}")
        jsegs.append(jax_load(d))
        tsegs.append(load_segment(d))
    return jsegs, tsegs


def vdt_of(x64):
    return torch.float64 if x64 else torch.float32


def rows_close(a, b, rel):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y), (x, y)
        for u, v in zip(x, y):
            if isinstance(u, float) or isinstance(v, float):
                assert abs(float(u) - float(v)) <= rel * max(1.0,
                                                             abs(float(v)))
            else:
                assert u == v, (x, y)


def three_ways(jsegs, tsegs, sql, x64, port=None):
    """The port's rows against the JAX engine's and the host executor's;
    returns the port's response."""
    rel = 1e-9 if x64 else 1e-5
    port = port or QueryExecutor(tsegs, device="cpu",
                                 value_dtype=vdt_of(x64))
    with jax.enable_x64(x64):
        dev = JaxExecutor(jsegs, use_tpu=True,
                          engine=TpuOperatorExecutor()).execute(sql)
        host = JaxExecutor(jsegs, use_tpu=False).execute(sql)
    got = port.execute(sql)
    assert not dev.exceptions and not host.exceptions
    rows_close([tuple(r) for r in got.rows], [tuple(r) for r in dev.rows],
               rel)
    rows_close([tuple(r) for r in got.rows], [tuple(r) for r in host.rows],
               rel)
    return got


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sum", "filter", "distinct", "dense"])
def test_plan_fields_equal_jax(segs, name):
    """group_compact, num_groups, strides and the id planes kept or
    dropped equal the JAX planner's (a group-only column drops its ids; a
    filtered one keeps them; a narrow key space stays dense)."""
    jsegs, tsegs = segs
    sql = SQLS.get(name, "SELECT c, COUNT(*) FROM t GROUP BY c LIMIT 1000")
    jctx, ctx = JContext.from_sql(sql), QueryContext.from_sql(sql)
    if ctx.distinct:
        jctx = JContext.from_sql(sql.replace("DISTINCT a, b, c", "a, b, c, "
                                             "COUNT(*)").replace(
            " ORDER BY", " GROUP BY a, b, c ORDER BY"))
        ctx = eng_mod._distinct_context(ctx)
    jplan, _ = TpuOperatorExecutor()._plan(jsegs, jctx)
    plan, _ = eng_mod.TorchOperatorExecutor("cpu")._plan(tsegs, ctx)
    for field in ("group_compact", "num_groups", "group_strides",
                  "group_cols", "dict_cols", "raw_cols"):
        assert getattr(plan, field) == getattr(jplan, field), field
    assert plan.group_compact == (name != "dense")
    if name == "sum":
        assert "a" not in plan.dict_cols
    if name == "filter":
        assert {"a", "c"} <= set(plan.dict_cols)


def test_refusals_jax_declines_stay(segs, tmp_path):
    """A group-by on a raw column stays refused (the JAX planner sends it
    to its host), as does a time bucket over more than 2^20 keys."""
    _jsegs, tsegs = segs
    ex = QueryExecutor(tsegs, device="cpu")
    with pytest.raises(NotOffloadable, match="raw column m"):
        ex.execute("SELECT a, m, COUNT(*) FROM t GROUP BY a, m")
    with pytest.raises(NotOffloadable, match="time bucket"):
        ex.execute("SELECT FLOOR((m - 0) / 1), a, b, COUNT(*) FROM t "
                   "WHERE m >= 0 AND m < 999 "
                   "GROUP BY FLOOR((m - 0) / 1), a, b LIMIT 10")


# ---------------------------------------------------------------------------
# SQL three ways
# ---------------------------------------------------------------------------

@POSTURES
@pytest.mark.parametrize("name", list(SQLS))
def test_sql_three_ways(segs, name, x64):
    jsegs, tsegs = segs
    got = three_ways(jsegs, tsegs, SQLS[name], x64)
    assert len(got.rows) > 10000  # wide and sparse, as JAX's test asks


@pytest.fixture
def upsert_segs(segs):
    """The same segments with a third of each one's docs superseded."""
    jsegs, tsegs = segs
    rng = np.random.default_rng(77)
    for js, ts in zip(jsegs, tsegs):
        keep = np.nonzero(rng.random(js.num_docs) < 0.66)[0].tolist()
        js.valid_doc_ids = JBitmap.from_indices(js.num_docs, keep)
        ts.valid_doc_ids = Bitmap.from_indices(ts.num_docs, keep)
    yield jsegs, tsegs
    for js, ts in zip(jsegs, tsegs):
        js.valid_doc_ids = None
        ts.valid_doc_ids = None


@POSTURES
def test_upsert_three_ways(upsert_segs, x64):
    """The validity mask (vmask) with compact keys: the superseded docs
    reach no group and no DISTINCT key."""
    jsegs, tsegs = upsert_segs
    ex = QueryExecutor(tsegs, device="cpu", value_dtype=vdt_of(x64))
    for sql in (TOP_SQL.format(3000), DISTINCT_SQL.replace(
            " ORDER BY", " WHERE b < 700 ORDER BY")):
        three_ways(jsegs, tsegs, sql, x64, port=ex)
    plan, _ = ex.engine._plan(tsegs, QueryContext.from_sql(SUM_SQL))
    assert plan.group_compact and plan.valid_mask


# ---------------------------------------------------------------------------
# the kernel: the plain version against JAX's, the program mirror
# ---------------------------------------------------------------------------

S, D, G = 4, 512, 64


def jax_plan(spec):
    leaves = tuple(jir.DeviceLeaf(lf.kind, lf.column)
                   for lf in spec["leaves"])
    return jir.DevicePlan(**{**spec, "leaves": leaves})


@pytest.mark.parametrize("seed", range(4))
@POSTURES
def test_plain_kernel_matches_jax_compute_slots(seed, x64):
    """make_kernel's plain version at G against JAX make_kernel (its
    `_compute_slots` compact branch) on the same seeded gkey block."""
    spec = tp.compact_spec(seed)
    vdt = np.float64 if x64 else np.float32
    cols, params, nd = tp.random_inputs(seed, spec, S, D, vdt)
    cols["gkey"] = tp.compact_gkey(seed, S, D, G)
    with jax.enable_x64(x64):
        ref = np.asarray(jk.make_kernel(jax_plan(spec))(
            {k: jnp.asarray(v) for k, v in cols.items()},
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(nd), D=D, G=G))
    plan = DevicePlan(**spec)
    tcols, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    out = tk.make_kernel(plan, vdt_of(x64))(tcols, tpar, tnd, D, G).numpy()
    scale = {j: v.numpy() for j, v in tk.abs_contributions(
        plan, tcols, tpar, tnd, D, G).items()}
    assert out.shape == (S, G, len(plan.agg_ops))
    tp.assert_packed_equal(spec, ref, out, scale, x64, fma=True)


@pytest.mark.parametrize("seed", range(3))
def test_program_mirror_matches_plain(seed):
    """K2's program for a compact plan (the gkey block, one digit at
    stride 1) run by the interpreter's numpy mirror equals the plain
    version; the plan without G is refused."""
    spec = tp.compact_spec(seed)
    plan = DevicePlan(**spec)
    cols, params, nd = tp.random_inputs(seed, spec, S, D, np.float32)
    cols["gkey"] = tp.compact_gkey(seed, S, D, G)
    mirror = run_program(plan, cols, params, nd, D, np.float32, G)
    tcols, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    out = tk.make_kernel(plan, torch.float32)(tcols, tpar, tnd, D, G)
    scale = {j: v.numpy() for j, v in tk.abs_contributions(
        plan, tcols, tpar, tnd, D, G).items()}
    tp.assert_packed_equal(spec, mirror, out.numpy(), scale, x64=False)
    with pytest.raises(ValueError, match="group count G"):
        tk.make_kernel(plan, torch.float32)(tcols, tpar, tnd, D)


def test_batched_kernel_carries_G():
    """The batched kernel at G: each member equals its single launch."""
    spec = tp.compact_spec(5)
    plan = DevicePlan(**spec)
    sets, plist, ndl = [], [], []
    for m in range(3):
        cols, params, nd = tp.random_inputs(50 + m, spec, S, D, np.float32)
        cols["gkey"] = tp.compact_gkey(50 + m, S, D, G)
        tcols, tpar, tnd = tk.from_jax_staged(cols, params, nd)
        sets.append(tcols)
        plist.append(tpar)
        ndl.append(tnd)
    idx = [0, 1, 2, 1]
    plist.append(plist[1])
    out = tk.batched_kernel(plan, torch.float32)(sets, plist, ndl, idx, D,
                                                 G)
    single = tk.make_kernel(plan, torch.float32)
    for m, u in enumerate(idx):
        assert torch.equal(out[m], single(sets[u], plist[m], ndl[u], D, G))


# ---------------------------------------------------------------------------
# staging: the host cache, the caps
# ---------------------------------------------------------------------------

def test_repeat_query_factorizes_nothing(segs, monkeypatch):
    """The codes (the staged column's host row) and the decode table are
    cached per (segment, group columns) in the host rows: a repeat query
    (and another query over the same group columns) factorizes nothing;
    invalidate_segment and drop_caches drop them."""
    _jsegs, tsegs = segs
    calls = []
    real = eng_mod.factorize_keys

    def counted(seg, group_cols):
        calls.append((seg.name, tuple(group_cols)))
        return real(seg, group_cols)
    monkeypatch.setattr(eng_mod, "factorize_keys", counted)
    ex = QueryExecutor(tsegs, device="cpu")
    ex.execute(TOP_SQL.format(700))
    assert sorted(calls) == [("t_0", ("a", "b", "c")),
                             ("t_1", ("a", "b", "c"))]
    ex.execute(TOP_SQL.format(700))
    ex.execute(TOP_SQL.format(1400))
    assert len(calls) == 2
    eng = ex.engine
    for kind in ("gkey", "gkey_table"):
        assert sum(1 for k in eng._host_rows if k[1] == kind) == 2
    eng.invalidate_segment("t_0")
    for kind in ("gkey", "gkey_table"):
        assert sum(1 for k in eng._host_rows if k[1] == kind) == 1
    ex.execute(TOP_SQL.format(700))
    assert len(calls) == 3 and calls[-1][0] == "t_0"
    eng.drop_caches()
    assert not eng._host_rows and eng._host_bytes == 0


def test_group_cap_raises_with_a_reason(segs, monkeypatch):
    """A segment holding more key tuples than the device's cap raises
    NotOffloadable with reason 'groups' before any column upload (only
    the port's MAX_DEVICE_GROUPS is patched)."""
    _jsegs, tsegs = segs
    monkeypatch.setattr(eng_mod, "MAX_DEVICE_GROUPS", 1 << 12)
    ex = QueryExecutor(tsegs, device="cpu")
    with pytest.raises(NotOffloadable, match="compact group keys") as e:
        ex.execute(SUM_SQL)
    assert e.value.reason == "groups"
    assert not ex.engine._blocks


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def test_ring_coalesces_compact_queries_at_equal_G(segs):
    """n concurrent compact queries of one plan coalesce into one batch
    (their G in the coalesce key), and each equals its single answer."""
    _jsegs, tsegs = segs
    eng = make_engine()
    sqls = [TOP_SQL.format(v) for v in (3000, 4000, 5000, 6000)]
    jobs = [(tsegs, q) for q in sqls]
    singles = [eng.execute(tsegs, QueryContext.from_sql(q)) for q in sqls]
    before = eng.dispatcher.stats()
    with eng.dispatcher.active():
        got = run_concurrent(eng, jobs)
    after = eng.dispatcher.stats()
    assert after[("size", len(jobs))] == before[("size", len(jobs))] + 1
    for a, b in zip(got, singles):
        assert [r.groups for r in a] == [r.groups for r in b]
    plan, _ = eng._plan(tsegs, QueryContext.from_sql(sqls[0]))
    assert plan.group_compact


# ---------------------------------------------------------------------------
# the mesh: sharded and merged
# ---------------------------------------------------------------------------

MESH_SHAPES = [(4, 2), (8, 2)]
MESH_IDS = ["2x2", "4x2"]


@pytest.fixture(autouse=False)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


@POSTURES
@pytest.mark.parametrize("n,doc_axis", MESH_SHAPES, ids=MESH_IDS)
def test_mesh_sql_against_jax_and_one_device(segs, eight_devices, n,
                                             doc_axis, x64):
    """The merged mesh engine (the default on an explicit mesh) and the
    sharded one (the merge key off) against the JAX mesh engine and one
    device, for a group-by and a DISTINCT."""
    jsegs, tsegs = segs
    rel = 1e-9 if x64 else 1e-5
    mesh = make_mesh(["cpu"] * n, doc_axis=doc_axis)
    merged = QueryExecutor(tsegs, device="cpu", value_dtype=vdt_of(x64),
                           mesh=mesh)
    sharded = QueryExecutor(tsegs, device="cpu", value_dtype=vdt_of(x64),
                            mesh=mesh, config=PinotConfiguration(
                                {"pinot.server.mesh.collective.merge":
                                 False}))
    one = QueryExecutor(tsegs, device="cpu", value_dtype=vdt_of(x64))
    # filters that keep a tenth of the docs: G stays the tuples a segment
    # holds, the rows to reduce stay few
    distinct = DISTINCT_SQL.replace(" ORDER BY", " WHERE b < 700 ORDER BY")
    with jax.enable_x64(x64):
        jdev = JaxExecutor(jsegs, use_tpu=True, engine=TpuOperatorExecutor(
            mesh=jax_mesh(jax.devices()[:n], doc_axis=doc_axis)))
        for q in (TOP_SQL.format(700), distinct):
            want = [tuple(r) for r in jdev.execute(q).rows]
            for ex in (merged, sharded, one):
                rows_close([tuple(r) for r in ex.execute(q).rows], want, rel)
    assert merged.engine.meter("mesh_merge_served") == 1
    assert sharded.engine.meter("mesh_merge_fallback", "disabled") == 1


@POSTURES
def test_merged_kernel_matches_jax(segs, eight_devices, x64):
    """merged_kernel on the JAX mesh engine's own compact staging and its
    `gmap` params (the remap composed from them) against the JAX
    compiled_merged_kernel; and compose_remap of that gmap, read at each
    doc's code, equals JAX `_global_keys`."""
    jsegs, _tsegs = segs
    jmesh = jax_mesh(jax.devices()[:8], doc_axis=2)
    mesh = make_mesh(["cpu"] * 8, doc_axis=2)
    sql = TOP_SQL.format(700)
    with jax.enable_x64(x64):
        eng = TpuOperatorExecutor(mesh=jmesh)
        ctx = JContext.from_sql(sql)
        jplan, _ = eng._plan(jsegs, ctx)
        assert jplan.group_compact
        cols, params, nd, _s, D_, G_local = eng._stage(jsegs, ctx, jplan)
        S_ = int(nd.shape[0])
        gparams, G_m, _n, _d = eng._merged_group_params(jsegs, jplan, S_,
                                                        G_local)
        params = dict(params, **gparams)
        cols = {k: np.asarray(v) for k, v in cols.items()}
        params = {k: np.asarray(v) for k, v in params.items()}
        nd = np.asarray(nd)
        ref = np.asarray(jc.compiled_merged_kernel(jplan, jmesh)(
            {k: jnp.asarray(v) for k, v in cols.items()},
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(nd), D=D_, G=G_m))
        keys = np.asarray(jc._global_keys(
            jplan, {"gkey": jnp.asarray(cols["gkey"])},
            {"gmap": jnp.asarray(params["gmap"])}))
    names = DevicePlan.__dataclass_fields__
    plan = DevicePlan(**{k: getattr(jplan, k) for k in names
                         if hasattr(jplan, k) and k != "leaves"},
                      leaves=tuple(DeviceLeaf(lf.kind, lf.column)
                                   for lf in jplan.leaves))
    remap = tc.compose_remap(plan, {"gmap": params["gmap"]}, S_)
    real = np.arange(D_)[None, :] < nd[:, None]
    assert np.array_equal(np.take_along_axis(
        remap, cols["gkey"].astype(np.int64), axis=1)[real], keys[real])
    tcols, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    scs = {k: shard_block(mesh, v) for k, v in tcols.items()}
    got = tc.merged_kernel(plan, mesh, vdt_of(x64))(scs, tpar, tnd, D_,
                                                    G_m).numpy()
    assert got.shape == ref.shape
    n_slots = len(plan.agg_ops)
    assert np.array_equal(got[-S_:], ref[-S_:]), "matched tail"
    a = got[:G_m * n_slots].reshape(G_m, n_slots)
    b = ref[:G_m * n_slots].reshape(G_m, n_slots)
    for j, (op, _v, _f) in enumerate(plan.agg_ops):
        if op == "sum":
            assert np.allclose(a[:, j], b[:, j], rtol=1e-9 if x64 else 1e-5,
                               atol=0), op
        else:
            assert np.array_equal(a[:, j], b[:, j]), op


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 14 on the CPU, at a small scale
# ---------------------------------------------------------------------------

def test_chip_smoke_hits_leg_checks_hold_on_cpu(tmp_path, monkeypatch):
    """Phase 14's generator, truth fold and checks on 3 x 2^13 rows
    through the port on the CPU: every cb query plans compact keys and
    equals the numpy truth; a wrong count or a missing DISTINCT pair is
    caught."""
    import chip_smoke as cs
    monkeypatch.setattr(cs, "CB_SEGMENTS", 3)
    monkeypatch.setattr(cs, "CB_DOCS", 1 << 13)
    done = [cs.build_one_segment(job)
            for job in cs.hits_jobs(str(tmp_path), 7)]
    truth = cs.cb_merged([t for _o, t in done])
    ex = QueryExecutor([load_segment(o) for o, _t in done], device="cpu")
    for name, sql in cs.CB_QUERIES.items():
        rows = [tuple(r) for r in ex.execute(sql).rows]
        assert cs.cb_check(name, rows, truth) is None, name
        G, held = cs.cb_groups(ex, sql)
        assert G == tp._pow2(max(held), 8) and len(held) == 3
        if name == "cb.4":
            assert cs.cb_check(name, rows[1:], truth) is not None
        else:
            bad = rows[:-1] + [rows[-1][:-1] + (rows[-1][-1] + 1,)]
            assert cs.cb_check(name, bad, truth) is not None
            assert cs.cb_same(name, rows, rows)
