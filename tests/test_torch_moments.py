"""The moment aggregations (VARIANCE, VAR_SAMP, STDDEV, STDDEV_SAMP,
SKEWNESS, KURTOSIS) and the boolean folds (BOOL_AND, BOOL_OR) three ways:
the JAX package's numpy host executor, its device engine, and the port's
QueryExecutor(device="cpu"), ungrouped and grouped, in both precision
postures.

The data is tests/test_aggregations.py's: a float column x ~ N(50, 10), a
0/1 column `flag` and a group column `grp` of 7 values over two segments of
3,000 rows, plus an int column v in [0, 1000) (its SUM rides the exact isum
planes under float32, as on the JAX engine).

Tolerances. Under x64 every value within 1e-9 of max(1, |value|) (the
harness's rel 1e-9; kurtosis and skewness near 0 need the absolute floor).
Under float32 the moments come from differences of large raw-moment sums,
so the bar is the JAX package's own float32 path on this data:
F32_JAX_ERR is the largest |JAX float32 engine - host| / max(1, |host|)
over every value of QUERIES (kurtosis of a group; measured with the
reference's f32 path, `jax.enable_x64(False)`). The port must be within
F32_JAX_ERR of the host oracle (no less accurate than the reference's own
float32 path) and within 2 * F32_JAX_ERR of the JAX engine (both sides'
errors). Booleans are equal.
"""
import math

import numpy as np
import pytest
import torch

import jax

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.models import (DataType, FieldSpec, FieldType, Schema,
                              TableConfig, TableType)
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.loader import load_segment

from tests.queries.harness import build_segments

N = 3000
F64_TOL = 1e-9
#: the JAX float32 engine's largest error against its host executor over
#: QUERIES on this data (see the module docstring)
F32_JAX_ERR = 2e-3

MOMENTS = ("VARIANCE({c}), VAR_SAMP({c}), STDDEV({c}), STDDEV_SAMP({c}), "
           "SKEWNESS({c}), KURTOSIS({c})")
QUERIES = [
    f"SELECT {MOMENTS.format(c='x')} FROM testTable",
    f"SELECT {MOMENTS.format(c='v')} FROM testTable WHERE flag = 1",
    "SELECT VAR_POP(x) FILTER (WHERE flag = 1), STDDEV(v), COUNT(*) "
    "FROM testTable",
    "SELECT BOOL_AND(flag), BOOL_OR(flag) FROM testTable",
    "SELECT BOOL_AND(flag), BOOL_OR(flag) FROM testTable WHERE x > 1000",
    "SELECT BOOL_AND(flag), BOOL_OR(flag) FROM testTable WHERE flag = 1",
    f"SELECT grp, {MOMENTS.format(c='x')} FROM testTable GROUP BY grp "
    "ORDER BY grp LIMIT 10",
    "SELECT grp, VAR_SAMP(v), BOOL_AND(flag), BOOL_OR(flag) FROM testTable "
    "WHERE v < 400 GROUP BY grp ORDER BY grp LIMIT 10",
    "SELECT grp, BOOL_AND(flag), BOOL_OR(flag) FROM testTable "
    "WHERE flag = 0 GROUP BY grp ORDER BY grp LIMIT 10",
]


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_moments")
    schema = Schema("testTable", [
        FieldSpec("x", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("v", DataType.INT, FieldType.METRIC),
        FieldSpec("grp", DataType.INT, FieldType.DIMENSION),
        FieldSpec("flag", DataType.INT, FieldType.DIMENSION)])
    tc = TableConfig("testTable", TableType.OFFLINE)
    cols = []
    for i in range(2):
        rng = np.random.default_rng(100 + i)
        cols.append({"x": rng.normal(50, 10, N),
                     "v": rng.integers(0, 1000, N).astype(np.int32),
                     "grp": rng.integers(0, 7, N).astype(np.int32),
                     "flag": rng.integers(0, 2, N).astype(np.int32)})
    jsegs = build_segments(tmp, schema, tc, cols)
    return jsegs, [load_segment(str(tmp / f"seg_{i}")) for i in range(2)]


def run_three(segs, sql, x64):
    jsegs, tsegs = segs
    with jax.enable_x64(x64):
        host = JaxExecutor(jsegs, use_tpu=False).execute(sql)
        dev = JaxExecutor(jsegs, use_tpu=True).execute(sql)
        port = QueryExecutor(
            tsegs, device="cpu",
            value_dtype=torch.float64 if x64 else torch.float32).execute(sql)
    for r in (host, dev):
        assert not r.exceptions, (sql, r.exceptions)
    return host, dev, port


def errors(a, b):
    """|a - b| / max(1, |a|) per value of two responses' rows; booleans and
    group keys must be equal."""
    assert a.result_table.columns == b.result_table.columns
    assert len(a.rows) == len(b.rows)
    out = []
    for ra, rb in zip(a.rows, b.rows):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, bool) or isinstance(y, bool) \
                    or not isinstance(x, float):
                assert x == y and type(x) is type(y), (ra, rb)
                continue
            assert math.isfinite(x) and math.isfinite(y), (ra, rb)
            out.append(abs(x - y) / max(1.0, abs(x)))
    return out


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("sql", QUERIES)
def test_three_way(segs, sql, x64):
    host, dev, port = run_three(segs, sql, x64)
    to_host, to_jax = errors(host, port), errors(dev, port)
    if x64:
        assert max(to_host + to_jax, default=0.0) <= F64_TOL, sql
    else:
        assert max(to_host, default=0.0) <= F32_JAX_ERR, sql
        assert max(to_jax, default=0.0) <= 2 * F32_JAX_ERR, sql


def test_f32_tolerance_is_the_references_own_error(segs):
    """F32_JAX_ERR is no looser than the JAX float32 engine's own largest
    error on QUERIES, within a factor of 2 of it."""
    worst = max(max(errors(host, dev), default=0.0)
                for host, dev, _port in
                (run_three(segs, sql, False) for sql in QUERIES))
    assert F32_JAX_ERR / 2 <= worst <= F32_JAX_ERR


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_moments_match_numpy(segs, x64):
    """The port's float64 / float32 moments against numpy over the raw
    column (population and sample variance, skewness, excess kurtosis)."""
    jsegs, tsegs = segs
    x = np.concatenate([np.asarray(s.data_source("x").values())
                        for s in tsegs]).astype(np.float64)
    port = QueryExecutor(tsegs, device="cpu",
                         value_dtype=torch.float64 if x64
                         else torch.float32).execute(QUERIES[0]).rows[0]
    m = x.mean()
    m2 = ((x - m) ** 2).mean()
    want = [np.var(x), np.var(x, ddof=1), np.std(x), np.std(x, ddof=1),
            ((x - m) ** 3).mean() / m2 ** 1.5,
            ((x - m) ** 4).mean() / m2 ** 2 - 3]
    tol = F64_TOL if x64 else F32_JAX_ERR
    for got, w in zip(port, want):
        assert abs(got - w) <= tol * max(1.0, abs(w)), (got, w)


def test_moments_plan_device_slots(segs):
    """The functions reach K1 / K2 through the raw-moment slots, and
    COVAR_* stay refused (host-only in the JAX package too)."""
    ex = QueryExecutor(segs[1], device="cpu")
    plan, _ = ex.engine._plan(segs[1], QueryContext.from_sql(
        "SELECT KURTOSIS(x), BOOL_OR(flag) FROM testTable"))
    assert sorted(op for op, _v, _f in plan.agg_ops) == [
        "count", "max", "sum", "sum3", "sum4", "sumsq"]
    with pytest.raises(NotImplementedError, match="host-only"):
        ex.execute("SELECT COVAR_POP(x, v) FROM testTable")


@pytest.mark.parametrize("leg", ["q1", "groupby"])
def test_chip_smoke_moment_checks_hold_on_the_cpu_engine(tmp_path, leg):
    """chip_smoke.py's moment queries (MOM_QUERY on the Q1 leg's table,
    GB_MOM_QUERY on the group-by leg's) on small segments of the same
    columns through the port on the CPU: the script's exact numpy truth
    accepts the float32 answer, and rejects it with one moment moved by
    more than MOM_TOL or one boolean flipped."""
    import chip_smoke as cs
    if leg == "q1":
        fields = [("lo_orderdate", "INT", False),
                  ("lo_discount", "INT", False),
                  ("lo_quantity", "INT", False),
                  ("lo_extendedprice", "INT", True)]
        table, cols_fn, truth_fn, sql = ("ssb", cs.ssb_q1_columns,
                                         cs.q1_leg_truth, cs.MOM_QUERY)
    else:
        fields = [("lo_orderdate", "INT", False),
                  ("lo_discount", "INT", False),
                  ("lo_quantity", "INT", False), ("d_year", "INT", False),
                  ("p_category", "STRING", False),
                  ("s_region", "STRING", False), ("lo_revenue", "INT", True)]
        table, cols_fn, truth_fn, sql = ("ssbgb", cs.ssb_flat_columns,
                                         cs.groupby_leg_truth,
                                         cs.GB_MOM_QUERY)
    segs, truths = cs.build_segments(str(tmp_path), table, fields,
                                     [fields[-1][0]], 3, 20_000, cols_fn,
                                     truth_fn, 7)
    rows = QueryExecutor(segs, device="cpu").execute(sql).rows
    moms = [t["mom"] for t in truths]
    grouped = leg == "groupby"
    assert 0.0 <= cs.check_moments(rows, moms, grouped) <= cs.MOM_TOL
    assert {type(v) for r in rows for v in r[-2:]} == {bool}
    lead = 1 if grouped else 0
    for col, bump in ((lead, lambda v: v * (1 + 3 * cs.MOM_TOL) + 0.01),
                      (len(rows[0]) - 1, lambda v: not v)):
        bad = [list(r) for r in rows]
        bad[0][col] = bump(bad[0][col])
        with pytest.raises(SystemExit):
            cs.check_moments(bad, moms, grouped)
