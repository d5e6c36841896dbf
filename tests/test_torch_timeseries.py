"""The port's time-series slice against the JAX package's: the fused time
bucket (pinot_tpu_torch/ops/timeseries_device.py and K2's bucket digit),
the engine's admission and decode, and the simpleql engine
(pinot_tpu_torch/timeseries/).

Three ways on the same segments (built by the JAX creator, loaded by each
package's own loader): the oracle is the JAX engine with
`pinot.server.timeseries.bucket.enabled=false` (it refuses the bucket and
its host executor evaluates the floor() expression), then the JAX fused
leg, then `QueryExecutor(device="cpu")` of the port (the plain bucket
math inside the plain K2). Both precision postures: x64 against float64
values, `jax.enable_x64(False)` against float32.

Tolerances: group keys (bucket and tags) and counts exactly; under x64
values within rel 1e-9 (abs 1e-9: sums of signed values in another
order); under float32 within rel 1e-3, abs 1e-3, the JAX f32 device
path's own bar against its host leaf (tests/test_timeseries_device.py
`_assert_blocks_equal`: f32 sums of signed values cancel). The plain
`bucket_ids` is bit-identical to JAX `compiled_bucket_ids`.
"""
from concurrent.futures import ThreadPoolExecutor

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
from pinot_tpu.ops import timeseries_device as jts
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.timeseries import gapfill as jgap
from pinot_tpu.timeseries.engine import _parse_simpleql as jparse
from pinot_tpu.timeseries.engine import query as jax_ts_query
from pinot_tpu.utils.config import PinotConfiguration as JaxConfig
from pinot_tpu_torch.ops import program
from pinot_tpu_torch.ops import timeseries_device as tts
from pinot_tpu_torch.ops.engine import NotOffloadable, TorchOperatorExecutor
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.timeseries import gapfill as tgap
from pinot_tpu_torch.timeseries.engine import _parse_simpleql as tparse
from pinot_tpu_torch.timeseries.engine import query as ts_query
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.failpoints import failpoints

from tests.queries.harness import build_segments

POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
#: tests/test_timeseries_device.py's grid
HOSTS = ["a(1)", "h1", "h2", "h3"]
T0, STEP, BUCKETS = 1000, 20, 6
T1 = T0 + BUCKETS * STEP
#: a TSBS-shaped table: epoch-millis timestamps from 2016-01-01 in a
#: no-dictionary LONG (above 2^24: the window runs on split planes)
E0, ESTEP = 1451606400000, 60_000


def _leaf_sql(start, end, step, tags="host", agg="sum(value)", where="",
              table="metrics", ts="ts"):
    b = f"floor(({ts} - {start}) / {step})"
    sel = ", ".join(x for x in (b, tags, agg) if x)
    grp = ", ".join(x for x in (b, tags) if x)
    extra = f" AND ({where})" if where else ""
    return (f"SELECT {sel} FROM {table} WHERE {ts} >= {start} AND "
            f"{ts} < {end}{extra} GROUP BY {grp} LIMIT 100000")


#: the leaf SQL shapes the simpleql engine emits, and SQL group-bys over
#: the bucket with each aggregation
SQLS = [
    _leaf_sql(T0, T1, STEP),
    _leaf_sql(T0, T1, STEP, where="host = 'a(1)'"),
    _leaf_sql(T0, T1, STEP, tags=""),
    _leaf_sql(T0, T1, STEP, agg="avg(value)"),
    _leaf_sql(T0, T1, STEP, agg="min(value)"),
    _leaf_sql(T0, T1, STEP, agg="max(value)"),
    _leaf_sql(T0, T1, STEP, agg="count(*)"),
    _leaf_sql(T0, T1, STEP, agg="sum(value), count(*), max(value)"),
    _leaf_sql(T0 + 2 * STEP, T1, STEP),
    _leaf_sql(T0, T1, 7),
    # a window that starts inside the first bucket
    _leaf_sql(T0, T1 - 5, STEP).replace(f"ts >= {T0}", f"ts >= {T0 + 5}"),
]
#: tests/test_timeseries_device.py's dashboards
TAILS = ["| groupby(host) | sum(host)", "| sum()", "| sum() | rate()",
         "| groupby(host) | avg(host) | gapfill(5)",
         "| groupby(host) | max(host) | interpolate()",
         "| groupby(host) | min(host) | keep_last_value()",
         "| groupby(host) | sum(host) | scale(2.5)",
         "| where(host = 'a(1)') | groupby(host) | sum(host)"]


def _dash(start=T0, tail="| groupby(host) | sum(host)"):
    return f"fetch(metrics, value, ts, {start}, {T1}, {STEP}) {tail}"


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """tests/test_timeseries_device.py's segments: (JAX, port)."""
    tmp = tmp_path_factory.mktemp("torch_ts")
    schema = Schema("metrics", [
        FieldSpec("ts", DataType.LONG, FieldType.DIMENSION),
        FieldSpec("host", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("value", DataType.DOUBLE, FieldType.METRIC)])
    data = []
    for i in range(2):
        rng = np.random.default_rng(900 + i)
        n = 2000
        data.append({"ts": rng.integers(T0, T1, n),
                     "host": np.array([HOSTS[v] for v in
                                       rng.integers(0, len(HOSTS), n)],
                                      object),
                     "value": rng.normal(size=n)})
    jsegs = build_segments(tmp, schema, TableConfig("metrics"), data)
    return jsegs, [load_segment(str(tmp / f"seg_{i}")) for i in range(2)]


@pytest.fixture(scope="module")
def raw_segs(tmp_path_factory):
    """TSBS-shaped rows: one per host every 10 s in time order, the
    timestamp a raw epoch-millis LONG, a DOUBLE metric."""
    tmp = tmp_path_factory.mktemp("torch_ts_raw")
    schema = Schema("cpu", [
        FieldSpec("ts", DataType.LONG, FieldType.DIMENSION),
        FieldSpec("hostname", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("region", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("usage_user", DataType.DOUBLE, FieldType.METRIC)])
    tc = TableConfig("cpu", TableType.OFFLINE)
    tc.indexing.no_dictionary_columns = ["ts", "usage_user"]
    hosts = 12
    data = []
    for i in range(3):
        rng = np.random.default_rng(77 + i)
        r = np.arange(i * 1800, (i + 1) * 1800)
        data.append({"ts": E0 + 10_000 * (r // hosts),
                     "hostname": np.array([f"host_{h}" for h in r % hosts],
                                          object),
                     "region": np.array([f"r{h % 3}" for h in r % hosts],
                                        object),
                     "usage_user": rng.uniform(0, 100, len(r))})
    jsegs = build_segments(tmp, schema, tc, data)
    return jsegs, [load_segment(str(tmp / f"seg_{i}")) for i in range(3)]


def _jax_engine(name, bucket=True):
    return TpuOperatorExecutor(
        config=JaxConfig(overrides={
            "pinot.server.timeseries.bucket.enabled": bucket}),
        metrics_labels={"torch_ts": name})


def _jax_meter(eng, name):
    return eng._metrics.meter(name, labels=dict(eng._labels))


def _port(tsegs, x64, **overrides):
    return QueryExecutor(tsegs, device="cpu",
                         value_dtype=torch.float64 if x64 else torch.float32,
                         config=PinotConfiguration(overrides=overrides))


def _tol(x64):
    return (1e-9, 1e-9) if x64 else (1e-3, 1e-3)


def _assert_rows_close(a, b, x64, sql):
    """Rows of two responses: the same keys (every non-float column and the
    bucket exactly), values within the posture's tolerance."""
    ra, rb = sorted(map(tuple, a.rows)), sorted(map(tuple, b.rows))
    assert len(ra) == len(rb), (sql, len(ra), len(rb))
    rtol, atol = _tol(x64)
    for x, y in zip(ra, rb):
        assert type(x[0]) is type(y[0]) and x[0] == y[0], (sql, x, y)
        for u, v in zip(x[1:], y[1:]):
            if isinstance(u, str) or isinstance(v, str):
                assert u == v, (sql, x, y)
            else:
                np.testing.assert_allclose(float(u), float(v), rtol=rtol,
                                           atol=atol, err_msg=sql)


def _sql_three_way(jsegs, tsegs, sql, x64, label):
    with jax.enable_x64(x64):
        oracle = JaxExecutor(jsegs, use_tpu=True,
                             engine=_jax_engine(label + "o", False)
                             ).execute(sql)
        jeng = _jax_engine(label)
        fused = JaxExecutor(jsegs, use_tpu=True, engine=jeng).execute(sql)
    port = _port(tsegs, x64)
    got = port.execute(sql)
    assert not oracle.exceptions and not fused.exceptions, sql
    assert _jax_meter(jeng, "timeseries_leaf_device") >= 1, sql
    assert port.engine.meter("timeseries_leaf_device") == 1, sql
    assert got.result_table.columns == oracle.result_table.columns
    for ref in (oracle, fused):
        _assert_rows_close(ref, got, x64, sql)
    return got


@POSTURES
@pytest.mark.parametrize("sql", SQLS)
def test_sql_group_bys_three_ways(segs, sql, x64):
    got = _sql_three_way(*segs, sql, x64, "sql")
    assert got.rows


@POSTURES
def test_raw_epoch_millis_timestamp(raw_segs, x64):
    """The TSBS shape: a no-dictionary epoch-millis timestamp, whose window
    runs as vrange64 leaves on the planes the bucket reads. Under x64 the
    JAX fused leg raises KeyError 'val:ts' on this shape (its window leaf
    reads a value block its bucket leg removed; ROADMAP section C), so
    there the port is held against the oracle alone."""
    jsegs, tsegs = raw_segs
    sql = _leaf_sql(E0 + ESTEP, E0 + 13 * ESTEP, ESTEP, tags="hostname",
                    agg="max(usage_user), avg(usage_user)", table="cpu",
                    where="region = 'r1'")
    if not x64:
        _sql_three_way(jsegs, tsegs, sql, x64, "raw")
        return
    with jax.enable_x64(True):
        oracle = JaxExecutor(jsegs, use_tpu=True,
                             engine=_jax_engine("rawo", False)).execute(sql)
    port = _port(tsegs, True)
    _assert_rows_close(oracle, port.execute(sql), True, sql)
    plan, _ = port.engine._plan(tsegs, QueryContext.from_sql(sql))
    assert [lf.kind for lf in plan.leaves if lf.column == "ts"] \
        == ["vrange64", "vrange64"]
    assert plan.tbucket == ("ts", 16) and "ts" in plan.raw64_cols


def _blocks_close(a, b, x64):
    da = {s.tag_key(): s.values for s in a.series}
    db = {s.tag_key(): s.values for s in b.series}
    assert set(da) == set(db)
    rtol, atol = _tol(x64)
    for key in da:
        np.testing.assert_allclose(da[key], db[key], rtol=rtol, atol=atol,
                                   equal_nan=True)


@POSTURES
@pytest.mark.parametrize("tail", TAILS)
def test_simpleql_dashboards_three_ways(segs, tail, x64):
    jsegs, tsegs = segs
    with jax.enable_x64(x64):
        oracle = jax_ts_query(_dash(tail=tail), JaxExecutor(
            jsegs, use_tpu=True, engine=_jax_engine("qo", False)))
        jeng = _jax_engine("q")
        fused = jax_ts_query(_dash(tail=tail),
                             JaxExecutor(jsegs, use_tpu=True, engine=jeng))
    port = _port(tsegs, x64)
    got = ts_query(_dash(tail=tail), port)
    assert _jax_meter(jeng, "timeseries_leaf_device") >= 1
    assert port.engine.meter("timeseries_leaf_device") == 1
    assert (got.buckets.start, got.buckets.step, got.buckets.count) == (
        oracle.buckets.start, oracle.buckets.step, oracle.buckets.count)
    _blocks_close(oracle, got, x64)
    _blocks_close(fused, got, x64)


#: admitted shapes and refused ones (no window, a window starting before
#: the bucket start, a non-floor shape, a zero step, a string column)
PLAN_SQLS = SQLS + [
    "SELECT floor((ts - 1000) / 20), COUNT(*) FROM metrics "
    "GROUP BY floor((ts - 1000) / 20)",
    "SELECT floor((ts - 1000) / 20), COUNT(*) FROM metrics "
    "WHERE ts >= 990 AND ts < 1100 GROUP BY floor((ts - 1000) / 20)",
    "SELECT floor((ts - 1000) / 20), COUNT(*) FROM metrics "
    "WHERE ts > 999 AND ts <= 1100 GROUP BY floor((ts - 1000) / 20)",
    "SELECT ceil((ts - 1000) / 20), COUNT(*) FROM metrics "
    "WHERE ts >= 1000 AND ts < 1100 GROUP BY ceil((ts - 1000) / 20)",
    "SELECT floor((ts - 1000) / 0), COUNT(*) FROM metrics "
    "WHERE ts >= 1000 AND ts < 1100 GROUP BY floor((ts - 1000) / 0)",
    "SELECT floor((host - 1000) / 20), COUNT(*) FROM metrics "
    "WHERE host >= 1000 AND host < 1100 GROUP BY floor((host - 1000) / 20)",
    "SELECT floor((ts - 1000.5) / 20), COUNT(*) FROM metrics "
    "WHERE ts >= 1000 AND ts < 1100 GROUP BY floor((ts - 1000.5) / 20)",
]


@pytest.mark.parametrize("sql", PLAN_SQLS)
def test_extract_and_plan_bucket_match_jax(segs, sql):
    jsegs, tsegs = segs
    jctx, tctx = JaxContext.from_sql(sql), QueryContext.from_sql(sql)
    jg, tg = jctx.group_by[0], tctx.group_by[0]
    assert jts.extract_bucket(jg) == tts.extract_bucket(tg)
    jb = jts.plan_bucket(jg, jctx.filter, jsegs)
    tb = tts.plan_bucket(tg, tctx.filter, tsegs)
    assert (jb is None) == (tb is None)
    if jb is not None:
        assert tuple(jb) == tuple(tb)
        S = 3
        assert {k: v.tolist() for k, v in jts.leaf_params(jb, S).items()} \
            == {k: v.tolist() for k, v in tts.leaf_params(tb, S).items()}


def _planes(v):
    v = np.asarray(v, np.int64)
    return (v >> 24).astype(np.int32), (v & 0xFFFFFF).astype(np.int32)


#: (start, step, count, count_pad) per segment of the bucket_ids cases
BUCKET_CASES = {
    "small": [(1000, 20, 6, 8), (1040, 20, 4, 8), (0, 1, 8, 8)],
    "epoch-millis": [(E0, ESTEP, 720, 1024), (E0 + 3_600_000, 3_600_000, 12,
                                              16),
                     (E0 + 7 * ESTEP, 300_000, 144, 256)],
    "one-bucket": [(E0, 1 << 30, 1, 8), (5, 3, 1, 8), (E0, 7, 1, 8)],
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_bucket_ids_bit_identical_to_jax(case):
    """Deltas inside the window, negative ones, both window edges, b past
    count (gated) and past count_pad (clipped), and far timestamps whose
    delta wraps in i32, per segment start."""
    rng = np.random.default_rng(31)
    specs = BUCKET_CASES[case]
    count_pad = max(c for *_r, c in specs)
    D = 256
    vals = []
    for start, step, count, _cp in specs:
        end = start + step * count
        v = np.concatenate([
            [start, start - 1, end - 1, end, end + step * count_pad,
             start + (1 << 31), start - (1 << 31), start + (1 << 40),
             max(start - (1 << 40), 0), 0, (1 << 55) - 1],
            rng.integers(max(start - 10 * step, 0), end + 10 * step, D // 2),
            rng.integers(0, 1 << 55, D - 11 - D // 2)])
        vals.append(v)
    vhi, vlo = _planes(np.stack(vals))
    start = np.array([s for s, *_r in specs], np.int64)
    shi, slo = _planes(start)
    step = np.array([s for _a, s, *_r in specs], np.int32)
    count = np.array([c for _a, _b, c, _d in specs], np.int32)
    jb, jg = jts.compiled_bucket_ids(
        jnp.asarray(vhi), jnp.asarray(vlo), jnp.asarray(shi),
        jnp.asarray(slo), jnp.asarray(step), jnp.asarray(count),
        count_pad=count_pad)
    tb, tg = tts.bucket_ids(*(torch.from_numpy(a) for a in
                              (vhi, vlo, shi, slo, step, count)), count_pad)
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
    # the cases reach every branch: gated in and out, clipped, wrapped
    assert tg.any() and (~tg).any()
    assert (tb == count_pad - 1).any() and (tb == 0).any()


def test_sliding_refresh_coalesces_without_codegen(segs):
    """Eight dashboards whose windows slide (only start moves) share the
    plan and the coalescing key: with the ring held on its first pop they
    form one broadcast batch of eight on K2's member axis, each member
    equal to its query alone, and nothing compiles."""
    _jsegs, tsegs = segs
    eng = TorchOperatorExecutor("cpu", torch.float32)
    sqls = [_leaf_sql(T0 + k, T0 + k + 4 * STEP, STEP) for k in range(8)]
    alone = [eng.execute(tsegs, QueryContext.from_sql(q)) for q in sqls]
    plans = {eng._plan(tsegs, QueryContext.from_sql(q))[0] for q in sqls}
    assert len(plans) == 1 and next(iter(plans)).tbucket == ("ts", 8)
    codegen = program.trace_count()
    retrace = eng.dispatcher._metrics.meter("kernel_retrace")
    before = eng.dispatcher.stats()
    with failpoints.armed("server.dispatch.before", delay=0.5, times=1), \
            eng.dispatcher.active(), ThreadPoolExecutor(len(sqls)) as pool:
        futs = [pool.submit(eng.execute, tsegs, QueryContext.from_sql(q))
                for q in sqls]
        got = [f.result(timeout=60) for f in futs]
    stats = eng.dispatcher.stats()
    stats.subtract(before)
    assert stats["broadcast"] == 1 and stats[("size", 8)] == 1, stats
    for a, b in zip(alone, got):
        assert [r.groups for r in a] == [r.groups for r in b]
    assert program.trace_count() == codegen
    assert eng.dispatcher._metrics.meter("kernel_retrace") == retrace
    assert eng.meter("timeseries_leaf_device") == 16


def test_refusals_name_the_cause(segs):
    _jsegs, tsegs = segs
    port = _port(tsegs, False)
    wide = ("SELECT floor((ts - 1000) / 1), COUNT(*) FROM metrics WHERE "
            "ts >= 1000 AND ts < 3000000 GROUP BY floor((ts - 1000) / 1)")
    with pytest.raises(NotOffloadable, match="never carry a time bucket"):
        port.execute(wide)
    with pytest.raises(NotOffloadable, match="no numeric device block"):
        port.execute(_leaf_sql(T0, T1, STEP, agg="max(ts)"))
    with pytest.raises(NotOffloadable, match="bounded window"):
        port.execute("SELECT floor((ts - 1000) / 20), COUNT(*) FROM metrics "
                     "GROUP BY floor((ts - 1000) / 20)")
    off = _port(tsegs, False,
                **{"pinot.server.timeseries.bucket.enabled": False})
    with pytest.raises(NotOffloadable, match="group-by on expression"):
        ts_query(_dash(), off)


def test_simpleql_parse_matches_jax():
    texts = [
        "fetch(m, value, ts, 0, 100, 10) | where(host = 'a(1)' AND "
        "floor(x / 2) > 1) | groupby(host) | sum(host)",
        "fetch(m, value, ts, 0, 100, 10) | where(mod(x, 3) = 1 AND host IN "
        "('a', 'b')) | sum()",
        "fetch(m, v, t, 5, 95, 7) | groupby(a, b) | avg(a) | gapfill(2.5) "
        "| scale(3) | rate() | interpolate() | keep_last_value()",
        "fetch(m, v, t, 0, 5, 10) | max()",
    ]
    for text in texts:
        j, t = jparse(text), tparse(text)
        chain_j, chain_t = [], []
        while True:
            chain_j.append((type(j).__name__, {k: v for k, v in
                                               vars(j).items()
                                               if k != "child"}))
            chain_t.append((type(t).__name__, {k: v for k, v in
                                               vars(t).items()
                                               if k != "child"}))
            if not hasattr(j, "child"):
                break
            j, t = j.child, t.child
        assert repr(chain_j) == repr(chain_t), text
    for bad in ["fetch(m, value, ts, 0, 100, 10) | where(floor(x > 1)",
                "fetch(m, value, ts, 0, 100, 10) | sum(",
                "fetch(m, value, ts, 0, 100) | sum()",
                "select(m) | sum()"]:
        with pytest.raises(ValueError):
            jparse(bad)
        with pytest.raises(ValueError):
            tparse(bad)


def test_gapfill_transforms_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(12, 9))
    a[rng.random(a.shape) < 0.35] = np.nan
    a[5] = np.nan
    for fn, args in [("keep_last_value", ()), ("gapfill", (7.5,)),
                     ("interpolate", ()), ("rate", (10,))]:
        np.testing.assert_array_equal(getattr(jgap, fn)(a.copy(), *args),
                                      getattr(tgap, fn)(a.copy(), *args))
    gids = rng.integers(0, 4, 12)
    for agg in ("sum", "avg", "min", "max"):
        with np.errstate(invalid="ignore"):
            np.testing.assert_array_equal(jgap.aggregate(a, gids, 4, agg),
                                          tgap.aggregate(a, gids, 4, agg))


def test_leaf_cap_overflow_raises_like_jax(segs, monkeypatch):
    """4 hosts x 6 buckets = 24 group rows above the cap of 1 x 6: both
    fail loud rather than truncate."""
    jsegs, tsegs = segs
    monkeypatch.setenv("PINOT_TPU_TIMESERIES_LEAF_MAX_GROUPS", "1")
    with pytest.raises(RuntimeError, match="cap"):
        jax_ts_query(_dash(), JaxExecutor(jsegs, use_tpu=False))
    capped = _port(tsegs, False, **{"pinot.timeseries.leaf.max.groups": 1})
    with pytest.raises(RuntimeError, match="cap"):
        ts_query(_dash(), capped)
    assert len(ts_query(_dash(), _port(tsegs, False)).series) == len(HOSTS)


def test_leaf_fetch_failpoint(segs):
    _jsegs, tsegs = segs
    port = _port(tsegs, False)
    with failpoints.armed("timeseries.leaf.fetch",
                          where={"table": "metrics"}) as fp:
        ts_query(_dash(), port)
        assert fp.fired == 1
    with failpoints.armed("timeseries.leaf.fetch",
                          where={"table": "other"}) as fp:
        ts_query(_dash(), port)
        assert fp.fired == 0
    with failpoints.armed("timeseries.leaf.fetch",
                          error=RuntimeError("leaf kill")):
        with pytest.raises(RuntimeError, match="leaf kill"):
            ts_query(_dash(), port)


def test_repeat_panel_uploads_nothing_and_a_slide_only_parameters(segs):
    """The params cache (JAX engine.py:2101-2117): a repeated panel
    resolves and uploads nothing; a slid window uploads its parameters
    alone, no column byte."""
    from pinot_tpu_torch.ops import residency
    _jsegs, tsegs = segs
    eng = TorchOperatorExecutor("cpu", torch.float32)
    sql = _leaf_sql(T0, T0 + 3 * STEP, STEP, where="host IN ('h1', 'h2')")
    first = eng.execute(tsegs, QueryContext.from_sql(sql))
    t0, c0 = residency.transfer_bytes(), residency.column_transfer_bytes()
    again = eng.execute(tsegs, QueryContext.from_sql(sql))
    assert [r.groups for r in first] == [r.groups for r in again]
    assert residency.transfer_bytes() == t0
    eng.execute(tsegs, QueryContext.from_sql(
        _leaf_sql(T0 + STEP, T0 + 4 * STEP, STEP,
                  where="host IN ('h1', 'h2')")))
    assert residency.transfer_bytes() > t0
    assert residency.column_transfer_bytes() == c0
    assert eng.meter("timeseries_leaf_device") == 3
