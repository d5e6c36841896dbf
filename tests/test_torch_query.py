"""The port's QueryExecutor against the JAX package's, SQL to rows.

`pinot_tpu_torch.query.executor.QueryExecutor(device="cpu")` (plain
PyTorch kernels) against `pinot_tpu.query.executor.QueryExecutor` on its
device path (use_tpu=True) and on its numpy host executor (use_tpu=False),
on the same segments (built by the JAX creator, loaded by each package's
own loader), in the tests/queries/harness.py pattern. Covered: SSB Q1.1-Q1.3
and the config-#3 group-by on bench-shaped data (chip_smoke.py's
generators), and the aggregation / group-by queries of the tests/queries
corpus that this slice runs.

Tolerances: under x64 every value within rel 1e-9 (the harness's own);
with x64 off (float32 staging) integer results (counts, exact-sum isum
SUMs over int columns) must be identical and float results within rel
1e-5 (float32 sums taken in different orders). SSB Q1 SUM and COUNT equal
the numpy truth exactly in both postures.
"""
import math

import numpy as np
import pytest
import torch

import jax

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

import chip_smoke
from pinot_tpu.models import (DataType, FieldSpec, FieldType, Schema,
                              TableConfig)
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu_torch.ops.engine import NotOffloadable
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.loader import load_segment

from tests.queries.harness import (build_segments, synthetic_columns,
                                   synthetic_schema, synthetic_table_config)

CORPUS = [
    "SELECT COUNT(*) FROM testTable",
    "SELECT SUM(intCol) FROM testTable",
    "SELECT MIN(doubleCol), MAX(doubleCol), AVG(doubleCol) FROM testTable",
    "SELECT SUM(intCol) FROM testTable WHERE intCol BETWEEN 100 AND 500",
    "SELECT COUNT(*) FROM testTable WHERE stringCol = 's5'",
    "SELECT COUNT(*) FROM testTable WHERE stringCol IN ('s1', 's2', 's3')",
    "SELECT COUNT(*) FROM testTable WHERE stringCol NOT IN ('s1', 's2')",
    "SELECT COUNT(*) FROM testTable WHERE groupCol != 'g3'",
    "SELECT COUNT(*) FROM testTable WHERE (intCol < 200 OR intCol > 800) "
    "AND NOT groupCol = 'g1'",
    "SELECT COUNT(*), SUM(rawIntCol) FROM testTable WHERE rawIntCol >= 0",
    "SELECT SUM(intCol * rawIntCol) FROM testTable WHERE intCol < 500",
    "SELECT COUNT(*) FROM testTable WHERE stringCol LIKE 's1%'",
    "SELECT SUM(intCol), COUNT(*) FROM testTable WHERE intCol > 100000",
    "SELECT MINMAXRANGE(intCol) FROM testTable",
    "SELECT SUM(intCol) / COUNT(*) FROM testTable",
    "SELECT COUNT(*), SUM(floatCol), MAX(rawIntCol) FROM testTable "
    "WHERE floatCol > 50.5 AND longCol < 500000000000",
    "SELECT SUM(intCol) FILTER (WHERE intCol > 500), COUNT(*) FROM testTable",
    "SELECT groupCol, SUM(intCol) FROM testTable GROUP BY groupCol "
    "ORDER BY groupCol LIMIT 100",
    "SELECT groupCol, stringCol, COUNT(*) FROM testTable "
    "GROUP BY groupCol, stringCol ORDER BY groupCol, stringCol LIMIT 1000",
    "SELECT groupCol, COUNT(*) FROM testTable GROUP BY groupCol "
    "HAVING COUNT(*) > 100 ORDER BY groupCol LIMIT 100",
    "SELECT groupCol, AVG(doubleCol) FROM testTable WHERE intCol >= 250 "
    "GROUP BY groupCol ORDER BY groupCol LIMIT 100",
    "SELECT groupCol, SUM(intCol) FROM testTable GROUP BY groupCol "
    "ORDER BY SUM(intCol) DESC LIMIT 3",
    "SELECT groupCol, COUNT(*) FILTER (WHERE intCol < 100) FROM testTable "
    "GROUP BY groupCol ORDER BY groupCol LIMIT 100",
    # dense key spaces above 2^20: compact group keys
    "SELECT DISTINCT longCol, intCol, doubleCol FROM testTable "
    "ORDER BY longCol, intCol, doubleCol LIMIT 10000",
    "SELECT longCol, intCol, doubleCol, COUNT(*), SUM(intCol) "
    "FROM testTable WHERE intCol < 500 GROUP BY longCol, intCol, doubleCol "
    "ORDER BY longCol, intCol LIMIT 10000",
]

UNSUPPORTED = [
    ("SELECT intCol FROM testTable ORDER BY intCol, longCol LIMIT 10",
     "more than one ORDER BY key"),
    ("SELECT DISTINCTCOUNT(stringCol) FROM testTable", "sketches"),
    ("SELECT PERCENTILE95(doubleCol) FROM testTable", "sketches"),
    ("SELECT COVAR_POP(doubleCol, intCol) FROM testTable", "host-only"),
    ("SELECT COUNT(*) FROM testTable WHERE intCol + 0 > 500", "expression"),
    ("SELECT COUNT(*) FROM testTable GROUP BY intCol / 10", "group-by"),
    # a time bucket that is not the leading group-by is no time-series leaf
    ("SELECT COUNT(*) FROM testTable GROUP BY intCol, "
     "FLOOR((longCol - 5) / 60)", "group-by on expression"),
    ("SELECT COUNT(*) FROM testTable "
     "WHERE vector_similarity(doubleCol, '[0.1, 0.2]', 5)", "vector"),
]


@pytest.fixture(scope="module")
def corpus_segs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_corpus")
    data = [synthetic_columns(2000, seed=42 + i) for i in range(3)]
    jsegs = build_segments(tmp, synthetic_schema(), synthetic_table_config(),
                           data)
    return jsegs, [load_segment(str(tmp / f"seg_{i}")) for i in range(3)]


def _ssb(tmp, name, fields, no_dict, columns_fn, truth_fn, n_segs, docs):
    schema = Schema(name, [FieldSpec(f, getattr(DataType, t),
                                     FieldType.METRIC if m
                                     else FieldType.DIMENSION)
                           for f, t, m in fields])
    tc = TableConfig(name)
    tc.indexing.no_dictionary_columns = no_dict
    tc.indexing.compression = "PASS_THROUGH"
    cols = [columns_fn(np.random.default_rng([5, i]), docs)
            for i in range(n_segs)]
    jsegs = build_segments(tmp, schema, tc, cols)
    tsegs = [load_segment(str(tmp / f"seg_{i}")) for i in range(n_segs)]
    return jsegs, tsegs, [truth_fn(c) for c in cols]


@pytest.fixture(scope="module")
def q1_segs(tmp_path_factory):
    return _ssb(tmp_path_factory.mktemp("torch_q1"), "ssb",
                [("lo_orderdate", "INT", False), ("lo_discount", "INT", False),
                 ("lo_quantity", "INT", False),
                 ("lo_extendedprice", "INT", True)],
                ["lo_extendedprice"], chip_smoke.ssb_q1_columns,
                chip_smoke.q1_truth, 3, 40_000)


@pytest.fixture(scope="module")
def gb_segs(tmp_path_factory):
    return _ssb(tmp_path_factory.mktemp("torch_gb"), "ssbgb",
                [("lo_orderdate", "INT", False), ("lo_discount", "INT", False),
                 ("lo_quantity", "INT", False), ("d_year", "INT", False),
                 ("p_category", "STRING", False),
                 ("s_region", "STRING", False), ("lo_revenue", "INT", True)],
                ["lo_revenue"], chip_smoke.ssb_flat_columns,
                chip_smoke.groupby_truth, 3, 6000)


def _close(a, b, rel) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        if math.isnan(fa) and math.isnan(fb):
            return True
        if math.isinf(fa) or math.isinf(fb):
            return fa == fb
        return math.isclose(fa, fb, rel_tol=rel, abs_tol=1e-9)
    return a == b


def assert_rows_equal(a, b, sql, rel):
    ra, rb = a.result_table, b.result_table
    assert ra.columns == rb.columns, sql
    rows_a, rows_b = ra.rows, rb.rows
    if "order by" not in sql.lower():
        rows_a = sorted(rows_a, key=lambda r: tuple(map(str, r)))
        rows_b = sorted(rows_b, key=lambda r: tuple(map(str, r)))
    assert len(rows_a) == len(rows_b), sql
    for x, y in zip(rows_a, rows_b):
        assert len(x) == len(y), sql
        assert all(_close(u, v, rel) for u, v in zip(x, y)), (sql, x, y)


def _three_way(jsegs, tsegs, sql, x64):
    """Port vs JAX device path vs JAX host executor; returns the port's."""
    rel = 1e-9 if x64 else 1e-5
    with jax.enable_x64(x64):
        dev = JaxExecutor(jsegs, use_tpu=True).execute(sql)
        host = JaxExecutor(jsegs, use_tpu=False).execute(sql)
        port = QueryExecutor(
            tsegs, device="cpu",
            value_dtype=torch.float64 if x64 else torch.float32).execute(sql)
    assert_rows_equal(dev, port, sql, rel)
    assert_rows_equal(host, port, sql, rel)
    return port


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("sql", CORPUS)
def test_corpus_matches_jax(corpus_segs, sql, x64):
    _three_way(*corpus_segs, sql, x64)


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(chip_smoke.Q1_QUERIES))
def test_ssb_q1_exact(q1_segs, name, x64):
    jsegs, tsegs, truths = q1_segs
    port = _three_way(jsegs, tsegs, chip_smoke.Q1_QUERIES[name], x64)
    got = port.rows[0]
    assert int(got[1]) == sum(t[name][1] for t in truths) > 0
    assert float(got[0]) == float(sum(t[name][0] for t in truths))


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_ssb_groupby(gb_segs, x64):
    jsegs, tsegs, truths = gb_segs
    port = _three_way(jsegs, tsegs, chip_smoke.GB_QUERY, x64)
    want = {}
    for t in truths:
        for k, v in t.items():
            want[k] = want.get(k, 0) + v
    assert [tuple(r[:2]) for r in port.rows] == sorted(want)
    for r in port.rows:
        assert math.isclose(r[2], want[tuple(r[:2])], rel_tol=1e-6)


def test_f32_posture_plans_exact_sums(q1_segs):
    """float32 staging swaps SUM over an int product for the exact isum
    planes, as the JAX engine does with x64 off."""
    from pinot_tpu_torch.query.context import QueryContext
    _j, tsegs, _t = q1_segs
    ex = QueryExecutor(tsegs, device="cpu")
    plan, _ = ex.engine._plan(tsegs, QueryContext.from_sql(
        chip_smoke.Q1_QUERIES["q1.1"]))
    assert [op for op, _v, _f in plan.agg_ops] == ["isum:u4", "count"]


@pytest.mark.parametrize("sql,feature", UNSUPPORTED)
def test_unsupported_queries_name_the_feature(corpus_segs, sql, feature):
    ex = QueryExecutor(corpus_segs[1], device="cpu")
    from pinot_tpu_torch.query.context import QueryContext
    assert not ex.engine.supports(QueryContext.from_sql(sql))
    with pytest.raises(NotImplementedError, match=feature):
        ex.execute(sql)


#: shapes the capability check admits but the planner refuses on the
#: segments at hand (a DISTINCT over a column without a dictionary; a
#: time-series bucket with no bounded window to size its grid)
PLAN_TIME_REFUSALS = [
    ("SELECT DISTINCT rawIntCol, intCol FROM testTable", "raw column"),
    ("SELECT COUNT(*) FROM testTable GROUP BY FLOOR((longCol - 5) / 60)",
     "time bucket"),
]


@pytest.mark.parametrize("sql,feature", PLAN_TIME_REFUSALS)
def test_plan_time_refusals_name_the_feature(corpus_segs, sql, feature):
    ex = QueryExecutor(corpus_segs[1], device="cpu")
    with pytest.raises(NotImplementedError, match=feature):
        ex.execute(sql)


def test_engine_caps_raise(corpus_segs, monkeypatch):
    """Batches beyond the slice's caps raise instead of running on a host
    path the port does not have: a long column beyond 2^24 under float32
    values (the JAX engine's precision guard) and a segment holding more
    key tuples than MAX_DEVICE_GROUPS (patched down to 2^10 here: the
    corpus's segments hold 2000 tuples each)."""
    from pinot_tpu_torch.ops import engine as eng_mod
    ex = QueryExecutor(corpus_segs[1], device="cpu")
    with pytest.raises(NotOffloadable, match="2\\^24"):
        ex.execute("SELECT SUM(longCol) FROM testTable")
    monkeypatch.setattr(eng_mod, "MAX_DEVICE_GROUPS", 1 << 10)
    with pytest.raises(NotOffloadable, match="compact group keys"):
        ex.execute("SELECT longCol, intCol, doubleCol, COUNT(*) "
                   "FROM testTable GROUP BY longCol, intCol, doubleCol")


def test_chip_smoke_breakdown_runs_on_cpu(q1_segs):
    """chip_smoke.py's stage split of the timed runs comes from
    QueryExecutor.execute itself (here with the plain kernels)."""
    ex = QueryExecutor(q1_segs[1], device="cpu")
    resp, _cold, lats, split = chip_smoke.time_query(
        ex, chip_smoke.Q1_QUERIES["q1.1"], 2)
    assert len(lats) == 2 and resp.rows
    assert set(split) == {"parse", "plan", "stage", "kernel_fetch",
                          "assemble", "reduce"}
    assert all(v >= 0 for v in split.values())


def test_chip_smoke_bound_counts_kept_sectors():
    """chip_smoke.bytes_needed: filter columns for every real doc, other
    columns only in the 32-byte sectors that hold a kept doc."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
    S, D = 2, 256
    ids = torch.zeros((S, D), dtype=torch.int8)
    ids[0, 3] = ids[0, 200] = ids[1, 17] = 1   # kept docs
    ids[0, 250] = 1                            # past num_docs[0]
    cols = {"ids:k": ids, "val:v": torch.ones((S, D))}
    plan = DevicePlan(filter_ir=("leaf", 0),
                      leaves=(DeviceLeaf("range", "k"),),
                      value_irs=(("col", "v"),),
                      agg_ops=(("sum", 0, None),), dict_cols=("k",),
                      raw_cols=("v",))
    one = torch.ones(S, dtype=torch.int32)
    params = {"leaf0:lo": one, "leaf0:hi": one}
    num_docs = torch.tensor([240, 256], dtype=torch.int32)
    out = torch.zeros((S, 2))
    moved, kept = chip_smoke.bytes_needed(plan, cols, params, num_docs, D,
                                          out)
    assert kept == 3
    # 496 real i8 ids + 3 f32 sectors + 2 x [2] i32 params + [2] i32
    # num_docs + [2, 2] f32 output
    assert moved == 496 + 3 * 32 + 16 + 8 + 16
