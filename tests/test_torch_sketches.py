"""The port's sketch path (DISTINCTCOUNTHLL, PERCENTILETDIGEST) against the
JAX package's.

Kernel level: the port's plain `fmix32` / `hash32_pair`, `hll_slot` and
`hist_slot` (pinot_tpu_torch/ops/kernels.py) against the JAX kernels'
`_fmix32`, `_hll_slot` and `_hist_slot` and the host sketch's
`hash32_pair`, on the same numpy inputs: hashes, registers and bucket
counts bit-identical, in both precision postures (x64 against float64,
`jax.enable_x64(False)` against float32). NaN, +-inf and the bounds are
among the histogram's values; the JAX kernel puts NaN in bucket 0 (XLA's
float to int32 conversion), pinned below.

Host sketches: the port's numpy copy (pinot_tpu_torch/query/sketches.py)
against the JAX package's: registers and cardinality equal, and
`from_histogram` -> `merge` -> `quantile` equal bit for bit.

Query level, three ways (the JAX host executor, the JAX engine on its
device path, and the port's `QueryExecutor(device="cpu")`) on two table
shapes: tests/test_device_sketches.py's (dictionary-encoded LONG trip_id,
FLOAT fare) and BASELINE config #4's (raw LONG trip_id, raw DOUBLE fare,
bench_extra.py's draws). The port must equal the JAX engine exactly in the
HLL value and the quantile, and the host executor exactly in the HLL value
and within rel 0.02 in the quantile (bench_extra.py:217-218's bound: the
device digest is built from histogram buckets). Other columns: counts
exact, sums within rel 1e-9 (x64) / 1e-5 (float32).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

import chip_smoke
from pinot_tpu.models import (DataType, FieldSpec, FieldType, Schema,
                              TableConfig)
from pinot_tpu.ops import kernels as jk
from pinot_tpu.query.aggregation import sketches as jsk
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.segment.creator import SegmentCreator

from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops.engine import NotOffloadable
from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
from pinot_tpu_torch.query import sketches as tsk
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.loader import load_segment

POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------

def _u32_edges(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF,
                      0x9E3779B9, 0x85EBCA77], dtype=np.uint32)
    return np.concatenate([edges, rng.integers(0, 1 << 32, n,
                                               dtype=np.uint32)])


def test_fmix32_and_hash_pair_match_jax_and_host():
    h = _u32_edges(5000, 1)
    lo = _u32_edges(5000, 2)
    with jax.enable_x64(False):
        want = np.asarray(jk._fmix32(jnp.asarray(h)))
    got = tk.fmix32(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    w1, w2 = jsk.hash32_pair(h, lo)
    g1, g2 = tk.hash32_pair(torch.from_numpy(h.view(np.int32)),
                            torch.from_numpy(lo.view(np.int32)))
    np.testing.assert_array_equal(g1.numpy(), w1.astype(np.int64))
    np.testing.assert_array_equal(g2.numpy(), w2.astype(np.int64))
    p1, p2 = tsk.hash32_pair(h, lo)
    np.testing.assert_array_equal(p1, w1)
    np.testing.assert_array_equal(p2, w2)


def _planes(S: int, D: int, seed: int):
    """(hi, lo) i32 split planes of longs below 2^55 (0, -1, 1 and the
    extremes among them) and a random mask."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-(1 << 55) + 1, 1 << 55, (S, D))
    v[:, :5] = [0, -1, 1, (1 << 55) - 1, -(1 << 55) + 1]
    mask = rng.random((S, D)) < 0.7
    mask[-1] = False      # an empty segment keeps all registers at 0
    return ((v >> 24).astype(np.int32), (v & 0xFFFFFF).astype(np.int32),
            mask, v)


@POSTURES
@pytest.mark.parametrize("log2m", [4, 12, 16])
def test_hll_slot_matches_jax(log2m, x64):
    hi, lo, mask, v = _planes(3, 6000, log2m)
    op = f"hll:{log2m}:t"
    with jax.enable_x64(x64):
        want = np.asarray(jk._hll_slot(
            op, {"valhi:t": jnp.asarray(hi), "vallo:t": jnp.asarray(lo)},
            jnp.asarray(mask)))
    vdt = torch.float64 if x64 else torch.float32
    got = tk.hll_slot(op, {"valhi:t": torch.from_numpy(hi),
                           "vallo:t": torch.from_numpy(lo)},
                      torch.from_numpy(mask), vdt).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # and the host sketch over the kept values gives the same registers
    host = tsk.HyperLogLog(log2m)
    host.add_array(v[0][mask[0]])
    np.testing.assert_array_equal(got[0].astype(np.uint8), host.registers)
    assert not got[-1].any()


def _hist_inputs(S: int, D: int, vdt, seed: int):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-30.0, 230.0, (S, D))
    lo = np.array([0.0, -5.5, 10.0, 0.0])[:S]
    span = np.array([200.0, 117.3, 50.0, 1e-30])[:S]
    scale = 8192 / span
    vals[:, :6] = np.stack([np.full(S, np.nan), np.full(S, np.inf),
                            np.full(S, -np.inf), lo, lo + span,
                            np.nextafter(lo, -np.inf)], 1)
    mask = rng.random((S, D)) < 0.8
    mask[:, :6] = True
    return (vals.astype(vdt), lo.astype(vdt), scale.astype(vdt), mask)


@POSTURES
def test_hist_slot_matches_jax(x64):
    vdt = np.float64 if x64 else np.float32
    vals, lo, scale, mask = _hist_inputs(4, 5000, vdt, 3)
    with jax.enable_x64(x64):
        want = np.asarray(jk._hist_slot(
            "hist:8192", 2, jnp.asarray(vals),
            {"slot2:hlo": jnp.asarray(lo), "slot2:hscale": jnp.asarray(scale)},
            jnp.asarray(mask)))
    got = tk.hist_slot("hist:8192", 2, torch.from_numpy(vals),
                       {"slot2:hlo": torch.from_numpy(lo),
                        "slot2:hscale": torch.from_numpy(scale)},
                       torch.from_numpy(mask),
                       torch.float64 if x64 else torch.float32).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.sum() == mask.sum()


@POSTURES
def test_hist_nan_and_inf_buckets_pinned(x64):
    """JAX puts NaN in bucket 0 (XLA converts NaN to int32 0), -inf in 0
    and +inf in B - 1; the port's plain version does the same explicitly."""
    vdt = np.float64 if x64 else np.float32
    vals = np.array([[np.nan, -np.inf, np.inf, 7.5]], dtype=vdt)
    mask = np.ones_like(vals, dtype=bool)
    params = {"slot0:hlo": np.zeros(1, vdt), "slot0:hscale": np.ones(1, vdt)}
    with jax.enable_x64(x64):
        want = np.asarray(jk._hist_slot(
            "hist:16", 0, jnp.asarray(vals),
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(mask)))
    assert want[0, 0] == 2 and want[0, 15] == 1 and want[0, 7] == 1
    got = tk.hist_slot("hist:16", 0, torch.from_numpy(vals),
                       {k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(mask),
                       torch.float64 if x64 else torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# host sketches
# ---------------------------------------------------------------------------

def test_host_sketches_match_jax():
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.integers(-(1 << 60), 1 << 60, 20_000),
                           np.array([k << 55 for k in range(1, 50)])])
    a, b = jsk.HyperLogLog(12), tsk.HyperLogLog(12)
    a.add_array(vals)
    b.add_array(vals)
    np.testing.assert_array_equal(a.registers, b.registers)
    assert a.cardinality() == b.cardinality()
    assert tsk.HyperLogLog.from_registers(a.registers.astype(np.float32)) \
        .cardinality() == a.cardinality()
    counts = [rng.integers(0, 50, 8192) * (rng.random(8192) < 0.3)
              for _ in range(5)]
    quantiles = []
    for mod in (jsk, tsk):
        d = mod.TDigest(100.0)
        for s, c in enumerate(counts):
            d = d.merge(mod.TDigest.from_histogram(-3.25 + s, 0.0125, c))
        quantiles.append([d.quantile(q) for q in (0.01, 0.5, 0.95, 0.999)])
    assert quantiles[0] == quantiles[1]


# ---------------------------------------------------------------------------
# query level
# ---------------------------------------------------------------------------

QUERIES = [
    "SELECT DISTINCTCOUNTHLL(trip_id), PERCENTILETDIGEST95(fare) FROM taxi",
    "SELECT DISTINCTCOUNTHLL(trip_id) FROM taxi WHERE fare > 25",
    "SELECT PERCENTILETDIGEST(fare, 50) FROM taxi WHERE fare > 10",
    "SELECT DISTINCTCOUNTHLL(trip_id) FILTER (WHERE vendor = 'a'), "
    "PERCENTILETDIGEST90(fare) FILTER (WHERE fare < 20), COUNT(*) FROM taxi",
    "SELECT DISTINCTCOUNTHLL(trip_id), COUNT(*), SUM(fare) FROM taxi",
    "SELECT DISTINCTCOUNTHLL(trip_id), PERCENTILETDIGEST95(fare) FROM taxi "
    "WHERE trip_id < 549755813888",
    "SELECT DISTINCTCOUNTHLL(trip_id, 10), PERCENTILERAWTDIGEST(fare, 99), "
    "MAX(fare) FROM taxi WHERE fare BETWEEN 10 AND 40 AND vendor != 'c'",
]


def _taxi(tmp, raw: bool):
    """Three segments: the tests/test_device_sketches.py fixture's shape
    (raw=False) or config #4's (raw=True: no dictionary on trip_id, fare
    DOUBLE with bench_extra.py's draws)."""
    schema = Schema("taxi", [
        FieldSpec("trip_id", DataType.LONG, FieldType.DIMENSION),
        FieldSpec("vendor", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("fare", DataType.DOUBLE if raw else DataType.FLOAT,
                  FieldType.METRIC)])
    tc = TableConfig(name="taxi")
    if raw:
        tc.indexing.no_dictionary_columns = ["trip_id", "fare"]
    rng = np.random.default_rng(7)
    jsegs, tsegs = [], []
    for i in range(3):
        n = 20_000
        if raw:
            cols = chip_smoke.taxi_columns(rng, n)
        else:
            cols = {"trip_id": rng.integers(0, 1 << 40, size=n),
                    "fare": rng.gamma(2.0, 10.0, size=n).astype(np.float32)}
        cols["vendor"] = rng.choice(["a", "b", "c"], size=n)
        out = str(tmp / f"s{i}")
        SegmentCreator(tc, schema).build(cols, out, f"s{i}")
        from pinot_tpu.segment.loader import load_segment as jload
        jsegs.append(jload(out))
        tsegs.append(load_segment(out))
    return jsegs, tsegs


@pytest.fixture(scope="module", params=["dict", "raw"])
def taxi(request, tmp_path_factory):
    return _taxi(tmp_path_factory.mktemp(f"taxi_{request.param}"),
                 raw=request.param == "raw")


def _cell_close(name: str, a, b, rel: float, digest_rel: float) -> bool:
    """name: the result column's ('filter_agg(percentiletdigest90(fare),
    ...)' for a FILTER aggregation)."""
    if "distinctcounthll" in name or "count(" in name:
        return a == b
    tol = digest_rel if "percentile" in name else rel
    if tol == 0.0:
        return float(a) == float(b)
    return math.isclose(float(a), float(b), rel_tol=tol, abs_tol=1e-12)


@POSTURES
@pytest.mark.parametrize("sql", QUERIES)
def test_sketch_queries_match_jax(taxi, sql, x64):
    jsegs, tsegs = taxi
    rel = 1e-9 if x64 else 1e-5
    with jax.enable_x64(x64):
        dev = JaxExecutor(jsegs, use_tpu=True).execute(sql)
        host = JaxExecutor(jsegs, use_tpu=False).execute(sql)
        port = QueryExecutor(
            tsegs, device="cpu",
            value_dtype=torch.float64 if x64 else torch.float32).execute(sql)
    names = port.result_table.columns
    assert names == dev.result_table.columns == host.result_table.columns
    assert port.result_table.column_types == dev.result_table.column_types
    (p,), (d,), (h,) = (port.rows, dev.rows, host.rows)
    for name, x, y, z in zip(names, p, d, h):
        assert _cell_close(name, x, y, rel, 0.0), (sql, name, x, y)
        assert _cell_close(name, x, z, rel, 0.02), (sql, name, x, z)
    assert port.stats.num_docs_scanned == dev.stats.num_docs_scanned


def test_port_plans_the_jax_engines_sketch_slots(taxi):
    """The port's plan holds the JAX engine's sketch slots, leaves and
    staging sets, and the JAX engine's staged inputs, carried across by
    `from_jax_staged` unchanged (`slot{j}:hlo/hscale` parameters and the
    HLL column's split planes included), give the JAX kernel's packed
    output through the port's plain version."""
    jsegs, tsegs = taxi
    sql = QUERIES[5]
    with jax.enable_x64(False):
        jex = JaxExecutor(jsegs, use_tpu=True)
        eng = jex.tpu_engine
        jctx = JaxContext.from_sql(sql)
        jplan, _ = eng._plan(jsegs, jctx)
        cols, params, nd, _s, D, _g = eng._stage(jsegs, jctx, jplan)
        cols = {k: np.asarray(v) for k, v in cols.items()}
        params = {k: np.asarray(v) for k, v in params.items()}
        nd = np.asarray(nd)
        want = np.asarray(jk.make_kernel(jplan)(
            {k: jnp.asarray(v) for k, v in cols.items()},
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(nd), D=D))
    tplan, _ = QueryExecutor(tsegs, device="cpu").engine._plan(
        tsegs, QueryContext.from_sql(sql))
    assert tplan.agg_ops == jplan.agg_ops
    assert [(lf.kind, lf.column) for lf in tplan.leaves] == \
        [(lf.kind, lf.column) for lf in jplan.leaves]
    assert (tplan.raw_cols, tplan.raw64_cols, tplan.dict_cols) == \
        (jplan.raw_cols, jplan.raw64_cols, jplan.dict_cols)
    assert {"slot1:hlo", "slot1:hscale"} <= set(params)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    assert tpar["slot1:hscale"].dtype == torch.float32
    assert tc["valhi:trip_id"].dtype == torch.int32
    got = tk.make_kernel(tplan, torch.float32)(tc, tpar, tnd, D).numpy()
    np.testing.assert_array_equal(got, want)


REFUSALS = [
    ("SELECT vendor, DISTINCTCOUNTHLL(trip_id) FROM taxi GROUP BY vendor",
     "grouped sketches"),
    ("SELECT vendor, PERCENTILETDIGEST95(fare) FROM taxi GROUP BY vendor",
     "grouped sketches"),
    ("SELECT DISTINCTCOUNTHLL(fare) FROM taxi", "not a single-value int"),
    ("SELECT DISTINCTCOUNTHLL(vendor) FROM taxi", "not a single-value int"),
    ("SELECT DISTINCTCOUNTHLL(trip_id, 20) FROM taxi", "log2m"),
    ("SELECT DISTINCTCOUNTHLL(trip_id), SUM(trip_id) FROM taxi",
     "no numeric device block"),
    ("SELECT PERCENTILETDIGEST(fare * 2, 50) FROM taxi",
     "sketches over expressions"),
]


@pytest.mark.parametrize("sql,feature", REFUSALS)
def test_refusals_name_the_feature(taxi, sql, feature):
    ex = QueryExecutor(taxi[1], device="cpu")
    with pytest.raises(NotOffloadable, match=feature):
        ex.execute(sql)


def test_huge_longs_refused(tmp_path):
    """|v| >= 2^55: the i32 hi plane would wrap where the host sketch folds
    the lost bits, so the port refuses, naming it (the JAX engine goes to
    its host executor)."""
    schema = Schema("h", [FieldSpec("x", DataType.LONG,
                                    FieldType.DIMENSION)])
    tc = TableConfig(name="h")
    tc.indexing.no_dictionary_columns = ["x"]
    xs = np.array([k << 55 for k in range(1, 100)], dtype=np.int64)
    SegmentCreator(tc, schema).build({"x": xs}, str(tmp_path / "s0"), "s0")
    ex = QueryExecutor([load_segment(str(tmp_path / "s0"))], device="cpu")
    with pytest.raises(NotOffloadable, match="huge longs"):
        ex.execute("SELECT DISTINCTCOUNTHLL(x) FROM h")


def test_chip_smoke_config4_truth_matches_port(tmp_path):
    """chip_smoke.py's config-#4 checks on a small table, through the
    port's plain kernels: the HLL value and the p95 it expects are the
    port's exactly, and the p95 is within rel 0.02 of the exact one."""
    segs, truths = chip_smoke.build_segments(
        str(tmp_path), "taxi", [("trip_id", "LONG", False),
                                ("fare", "DOUBLE", True)],
        ["trip_id", "fare"], 4, 25_000, chip_smoke.taxi_columns,
        chip_smoke.taxi_truth, 11)
    expected = chip_smoke.taxi_expected(truths, segs)
    ex = QueryExecutor(segs, device="cpu")
    for name, sql in chip_smoke.TAXI_QUERIES.items():
        card, p95, exact, kept = expected[name]
        got = ex.execute(sql)
        assert got.rows[0][0] == card and got.rows[0][1] == p95, name
        assert got.stats.num_docs_scanned == kept
        assert abs(p95 - exact) <= 0.02 * exact


def test_phase3_sketch_plan_layout():
    """chip_smoke.py's K3 plan (phase 3): log2m 12, log2m 16 and the
    histogram all in shared memory, HLL registers a byte each."""
    plan = DevicePlan(
        filter_ir=("or", ("and", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
        leaves=(DeviceLeaf("range", "a"), DeviceLeaf("lut", "b"),
                DeviceLeaf("vrange64", "t")),
        value_irs=(("col", "fare"),),
        agg_ops=(("hll:12:t", None, None), ("hll:16:t", None, None),
                 ("hist:8192", 0, None)),
        dict_cols=("a", "b"), raw_cols=("fare",), raw64_cols=("t",))
    from pinot_tpu_torch.ops import program
    prog = program.compile_plan(plan)
    assert prog.out_width == 1 + 4096 + 65536 + 8192
    assert prog.sketch_smem_bytes == 4096 + 65536 + 4 * 8192
