"""The port's star-tree leg against the JAX package's, from the index bytes
to SQL rows.

Two tables, each built from the same seeded columns by the JAX creator and
by the port's creator: tests/test_startree_device.py's (tree [country,
browser, locale], max_leaf 10, `platform` outside the split order) and
BASELINE config #5's (bench_extra.py:224-234: chip_smoke.py's SSB-flat
columns, no raw columns, tree [d_year, p_category] with SUM__lo_revenue and
COUNT__*, max_leaf 1000). Every check runs in both precision postures:
conftest's x64 against the port's float64 values, and `jax.enable_x64(False)`
against float32.

(a) index: equal `metadata.star_tree` dicts and byte-equal STARTREE /
    STARTREE_DATA buffers, and each package loads the other's tree;
(b) traversal: `traverse` gives the same record indices for every query;
(c) plan: `plan_startree` gives an equal plan and traversal, or the same
    fallback reason;
(d) kernel: the plain `startree_kernel` against the JAX
    `make_startree_kernel` on the JAX engine's staged inputs carried across
    by `from_jax_staged` (also equal to the port engine's own staging) and
    on seeded random inputs, flat and grouped: counts, exact-sum planes and
    min / max equal, float sums within 2^-20 of the slot's sum of
    |contribution| (the JAX kernel adds in its value dtype, the port in
    float64);
(e) SQL: `QueryExecutor(device="cpu")` against the JAX device engine, the
    JAX host star-tree path and the JAX host scan of treeless segments:
    integers exact, floats within rel 1e-6 (the device-parity standard of
    test_startree_device.py); `num_docs_scanned` equal to the JAX device
    engine's and the query served from the tree;
(f) fallbacks: test_startree_device.py's TestFitFallback cases answer
    through the scan path with the JAX planner's reason counted.
"""
import numpy as np
import pytest
import torch

import jax

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

import chip_smoke
from pinot_tpu.models import (DataType, FieldSpec, FieldType, Schema,
                              StarTreeIndexConfig, TableConfig)
from pinot_tpu.ops import startree_device as jsd
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.query.startree_exec import _filter_id_sets as jax_id_sets
from pinot_tpu.segment.creator import SegmentCreator as JaxCreator
from pinot_tpu.segment.loader import load_segment as jax_load

from pinot_tpu_torch import models as tm
from pinot_tpu_torch.ops import _cuda
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import startree_device as tsd
from pinot_tpu_torch.ops.engine import TorchOperatorExecutor
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.query.startree_exec import _filter_id_sets
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.utils.config import PinotConfiguration

from tests import test_startree_device as jst
from tests import torch_plans as tp

POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
#: JAX kernel against the port's plain version: float sums (f32 adds there)
SUM_TOL = 2.0 ** -20
#: SQL rows: the device-parity standard of test_startree_device.py
ROW_TOL = 1e-6

CONFIG5_SQL = ("SELECT d_year, SUM(lo_revenue) FROM ssbst "
               "GROUP BY d_year ORDER BY d_year LIMIT 100")
#: table -> its SQL of check (e)
SQL = {"st": list(jst.QUERIES),
       "ssbst": [CONFIG5_SQL,
                 "SELECT SUM(lo_revenue), COUNT(*) FROM ssbst "
                 "WHERE p_category = 'MFGR#3'",
                 "SELECT p_category, AVG(lo_revenue) FROM ssbst "
                 "WHERE d_year BETWEEN 1993 AND 1995 GROUP BY p_category "
                 "ORDER BY p_category LIMIT 10"]}
CASES = [(t, q) for t, qs in SQL.items() for q in qs]
FALLBACKS = jst.TestFitFallback.CASES


ST_FIELDS = [("country", "STRING", False), ("browser", "STRING", False),
             ("locale", "STRING", False), ("platform", "STRING", False),
             ("impressions", "LONG", True), ("cost", "DOUBLE", True)]
#: table -> (fields, star-tree config fields, segments, docs per segment)
TABLES = {
    "st": (ST_FIELDS, dict(dimensions_split_order=["country", "browser",
                                                   "locale"],
                           function_column_pairs=["SUM__impressions",
                                                  "MAX__cost", "SUM__cost"],
                           max_leaf_records=10), 2, 3_000),
    "ssbst": ([("lo_orderdate", "INT", False), ("lo_discount", "INT", False),
               ("lo_quantity", "INT", False), ("d_year", "INT", False),
               ("p_category", "STRING", False), ("s_region", "STRING", False),
               ("lo_revenue", "INT", True)],
              dict(dimensions_split_order=["d_year", "p_category"],
                   function_column_pairs=["SUM__lo_revenue", "COUNT__*"],
                   max_leaf_records=1000), 2, 6_000),
}


def _columns(table: str, i: int, n: int) -> dict:
    if table == "ssbst":
        return chip_smoke.ssb_flat_columns(np.random.default_rng([5, i]), n)
    rng = np.random.default_rng(17 + i)  # test_startree_device.py's draws
    return {
        "country": [f"c{v}" for v in rng.integers(0, 12, n)],
        "browser": [f"b{v}" for v in rng.integers(0, 5, n)],
        "locale": [f"l{v}" for v in rng.integers(0, 8, n)],
        "platform": [f"p{v}" for v in rng.integers(0, 3, n)],
        "impressions": rng.integers(0, 1000, n).astype(np.int64),
        "cost": rng.random(n) * 100,
    }


def _build(pkg, tmp, table: str, tree: bool) -> list:
    """One table's segments, written by the JAX ("jax") or the port's
    ("port") creator, with or without its star-tree."""
    fields, st, n_segs, docs = TABLES[table]
    if pkg == "jax":
        F, FT, DT, Sch, TC, STC, Creator = (
            FieldSpec, FieldType, DataType, Schema, TableConfig,
            StarTreeIndexConfig, JaxCreator)
    else:
        F, FT, DT, Sch, TC, STC, Creator = (
            tm.FieldSpec, tm.FieldType, tm.DataType, tm.Schema, tm.TableConfig,
            tm.StarTreeIndexConfig, SegmentCreator)
    schema = Sch(table, [F(f, getattr(DT, t), FT.METRIC if m
                           else FT.DIMENSION) for f, t, m in fields])
    tc = TC(table)
    if tree:
        tc.indexing.star_tree_configs = [STC(**st)]
    dirs = []
    for i in range(n_segs):
        out = str(tmp / f"{pkg}_{table}_{int(tree)}_{i}")
        Creator(tc, schema).build(_columns(table, i, docs), out,
                                  f"{table}_{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """table -> dict of segment lists: 'jax' (JAX-built, JAX-loaded),
    'port' (port-built, port-loaded), 'jax_plain' (JAX-built, no tree),
    and the directories of both tree builds."""
    tmp = tmp_path_factory.mktemp("torch_startree")
    out = {}
    for table in TABLES:
        jdirs = _build("jax", tmp, table, tree=True)
        pdirs = _build("port", tmp, table, tree=True)
        out[table] = {
            "jax": [jax_load(d) for d in jdirs],
            "port": [load_segment(d) for d in pdirs],
            "jax_plain": [jax_load(d) for d in _build("jax", tmp, table,
                                                       tree=False)],
            "jax_dirs": jdirs, "port_dirs": pdirs}
    return out


def _tree_bytes(seg, ti=0):
    return (bytes(seg.dir.get_buffer(f"__startree_{ti}", "startree_index")),
            bytes(seg.dir.get_buffer(f"__startree_{ti}", "startree_data")))


# ---------------------------------------------------------------------------
# (a) index, (b) traversal, (c) plan
# ---------------------------------------------------------------------------

@POSTURES
@pytest.mark.parametrize("table", list(TABLES))
def test_index_bytes_equal_and_cross_load(tables, table, x64):
    t = tables[table]
    with jax.enable_x64(x64):
        for js, ps, jd, pd in zip(t["jax"], t["port"], t["jax_dirs"],
                                  t["port_dirs"]):
            assert js.metadata.star_tree == ps.metadata.star_tree
            assert _tree_bytes(js) == _tree_bytes(ps)
            # each package loads the other's tree
            other_j, other_p = jax_load(pd), load_segment(jd)
            jt, pt = other_j.star_tree.trees[0], other_p.star_tree.trees[0]
            np.testing.assert_array_equal(jt.nodes, pt.nodes)
            for d in pt.meta.dims:
                np.testing.assert_array_equal(jt.dim_codes[d],
                                              pt.dim_codes[d])
            for pair, v in pt.metrics.items():
                np.testing.assert_array_equal(jt.metrics[pair], v)


@POSTURES
@pytest.mark.parametrize("table,sql", CASES + [("st", q) for q, _r in
                                               FALLBACKS])
def test_traversal_matches_jax(tables, table, sql, x64):
    t = tables[table]
    ctx, jctx = QueryContext.from_sql(sql), JaxContext.from_sql(sql)
    group = {g.name for g in ctx.group_by}
    with jax.enable_x64(x64):
        for js, ps in zip(t["jax"], t["port"]):
            jt, pt = js.star_tree.trees[0], ps.star_tree.trees[0]
            want = jax_id_sets(js, jctx.filter, jt.meta.dims)
            got = _filter_id_sets(ps, ctx.filter, pt.meta.dims)
            assert (want is None) == (got is None), sql
            if got is None:
                continue
            np.testing.assert_array_equal(pt.traverse(got, group),
                                          jt.traverse(want, group))


@POSTURES
@pytest.mark.parametrize("table,sql", CASES + [("st", q) for q, _r in
                                               FALLBACKS])
def test_plan_matches_jax(tables, table, sql, x64):
    t = tables[table]
    with jax.enable_x64(x64):
        jplan, jneeded, jfits, jreason = jsd.plan_startree(
            t["jax"], JaxContext.from_sql(sql))
        plan, needed, fits, reason = tsd.plan_startree(
            t["port"], QueryContext.from_sql(sql))
    assert reason == jreason, sql
    if plan is None:
        return
    assert tuple(plan) == tuple(jplan) and needed == jneeded, sql
    for f, jf in zip(fits, jfits):
        assert f.ti == jf.ti
        np.testing.assert_array_equal(f.recs, jf.recs)


# ---------------------------------------------------------------------------
# (d) kernel
# ---------------------------------------------------------------------------

def _jax_kernel(fields, cols, params, nd, D, x64):
    import jax.numpy as jnp
    with jax.enable_x64(x64):
        kern = jsd.make_startree_kernel(jsd.StarTreePlan(**fields))
        out = kern({k: jnp.asarray(v) for k, v in cols.items()},
                   {k: jnp.asarray(v) for k, v in params.items()},
                   jnp.asarray(nd), D=D)
        return np.asarray(out)


@POSTURES
@pytest.mark.parametrize("table,sql", CASES)
def test_kernel_on_engine_staged_inputs_matches_jax(tables, table, sql, x64):
    """The JAX engine's staged blocks for the query, carried across
    unchanged: the plain K5 equals the JAX kernel, and the port engine
    stages the same blocks."""
    t = tables[table]
    vdt = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        prep = TpuOperatorExecutor()._prepare_startree(
            t["jax"], JaxContext.from_sql(sql))
        assert prep is not None, sql
        jplan, _n, _f, S_real, launch = prep
        cols = {k: np.asarray(v) for k, v in launch.cols.items()}
        params = {k: np.asarray(v) for k, v in launch.params.items()}
        nd, D = np.asarray(launch.num_docs), launch.D
    fields = jplan._asdict()
    want = _jax_kernel(fields, cols, params, nd, D, x64)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    kern = tsd.make_startree_kernel(tsd.StarTreePlan(**fields), vdt)
    got = kern(tc, tpar, tnd, D).numpy()
    tp.assert_startree_equal(
        fields, got, want,
        tp.startree_abs_sums(fields, cols, params, nd, D), SUM_TOL)
    # the port engine's own staging of the same query: the same blocks
    eng = TorchOperatorExecutor("cpu", vdt)
    ctx = QueryContext.from_sql(sql)
    plan, _needed, fits = eng._plan_startree(t["port"], ctx)
    pcols, pparams, pnd, pD = eng._stage_startree(t["port"], ctx, plan,
                                                  fits)
    assert pD == D and tuple(plan) == tuple(jplan)
    for k, v in pcols.items():
        np.testing.assert_array_equal(v.numpy(), cols[k][:S_real])
    np.testing.assert_array_equal(pparams["sel"].numpy(),
                                  params["sel"][:S_real])
    np.testing.assert_array_equal(pnd.numpy(), nd[:S_real])


@POSTURES
@pytest.mark.parametrize("group", list(tp.ST_GROUPS))
@pytest.mark.parametrize("seed", range(3))
def test_kernel_on_random_inputs_matches_jax(group, seed, x64):
    fields = tp.startree_spec(group)
    S, D = 4, 2048 + 256 * seed
    cols, params, nd = tp.startree_inputs(seed, fields, S, D,
                                          np.float64 if x64 else np.float32)
    want = _jax_kernel(fields, cols, params, nd, D, x64)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    got = tsd.startree_kernel(tsd.StarTreePlan(**fields), tc, tpar, tnd, D,
                              value_dtype=torch.float64 if x64
                              else torch.float32).numpy()
    tp.assert_startree_equal(
        fields, got, want,
        tp.startree_abs_sums(fields, cols, params, nd, D), SUM_TOL)


def test_kernel_wrapper_takes_cpu_or_card_tensors_only():
    """CPU tensors run the plain version; any other device reaches K5 (a
    CUDA tensor) or raises, never the plain version."""
    fields = tp.startree_spec("smem")
    cols, params, nd = tp.startree_inputs(0, fields, 2, 256, np.float32)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    kern = tsd.make_startree_kernel(tsd.StarTreePlan(**fields))
    before = _cuda.STARTREE_AGG.launches
    assert kern(tc, tpar, tnd, 256).shape == (2, 35, 1 + 16 + 3)
    meta = {k: v.to("meta") for k, v in tc.items()}
    with pytest.raises(ValueError, match="no kernel for device"):
        kern(meta, {"sel": tpar["sel"].to("meta")}, tnd.to("meta"), 256)
    with pytest.raises(ValueError, match="CUDA kernel given tensors"):
        _cuda.startree_agg(tsd.StarTreePlan(**fields), tc, tpar, tnd, 256,
                           torch.float32)
    assert _cuda.STARTREE_AGG.launches == before


# ---------------------------------------------------------------------------
# (e) SQL, (f) fallbacks
# ---------------------------------------------------------------------------

def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= ROW_TOL * max(1.0, abs(float(a)))
    return a == b


def _assert_rows(ref, port, sql):
    assert not ref.exceptions, sql
    assert ref.result_table.columns == port.result_table.columns, sql
    ra = [tuple(r) for r in ref.result_table.rows]
    rb = [tuple(r) for r in port.result_table.rows]
    if "order by" not in sql.lower():
        ra, rb = sorted(ra), sorted(rb)
    assert len(ra) == len(rb), (sql, ra, rb)
    for x, y in zip(ra, rb):
        assert len(x) == len(y) and all(_close(a, b) for a, b in zip(x, y)), \
            (sql, x, y)


@POSTURES
@pytest.mark.parametrize("table,sql", CASES)
def test_sql_matches_jax_three_ways(tables, table, sql, x64):
    t = tables[table]
    with jax.enable_x64(x64):
        dev = JaxExecutor(t["jax"], use_tpu=True,
                          engine=TpuOperatorExecutor()).execute(sql)
        host = JaxExecutor(t["jax"], use_tpu=False).execute(sql)
        scan = JaxExecutor(t["jax_plain"], use_tpu=False).execute(sql)
        ex = QueryExecutor(t["port"], device="cpu",
                           value_dtype=torch.float64 if x64
                           else torch.float32)
        port = ex.execute(sql)
    for ref in (dev, host, scan):
        _assert_rows(ref, port, sql)
    assert port.stats.num_docs_scanned == dev.stats.num_docs_scanned, sql
    assert port.stats.num_docs_scanned < scan.stats.num_docs_scanned, sql
    assert ex.engine.meter("startree_served") == 1, sql
    assert not any(k[0] == "startree_fallback" for k in ex.engine.meters)


@POSTURES
@pytest.mark.parametrize("sql,reason", FALLBACKS)
def test_fallbacks_answer_through_the_scan_path(tables, sql, reason, x64):
    t = tables["st"]
    with jax.enable_x64(x64):
        assert jsd.plan_startree(t["jax"], JaxContext.from_sql(sql))[3] \
            == reason
        scan = JaxExecutor(t["jax_plain"], use_tpu=False).execute(sql)
        ex = QueryExecutor(t["port"], device="cpu",
                           value_dtype=torch.float64 if x64
                           else torch.float32)
        port = ex.execute(sql)
    _assert_rows(scan, port, sql)
    assert port.stats.num_docs_scanned == scan.stats.num_docs_scanned, sql
    assert ex.engine.meter("startree_fallback", reason) == 1, sql
    assert ex.engine.meter("startree_served") == 0, sql
    assert ex.engine._blocks, "the scan path never staged a column"


@POSTURES
def test_engine_switch_disables_the_leg(tables, x64):
    """pinot.server.startree.enabled=false in the port's configuration, as
    in the JAX engine's: the same rows through the scan path, nothing
    served from the trees and no fallback counted."""
    t = tables["st"]
    sql = "SELECT SUM(impressions), COUNT(*) FROM st WHERE browser = 'b2'"
    vdt = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        scan = JaxExecutor(t["jax_plain"], use_tpu=False).execute(sql)
    ex = QueryExecutor(t["port"], device="cpu", value_dtype=vdt,
                       config=PinotConfiguration(overrides={
                           "pinot.server.startree.enabled": False}))
    port = ex.execute(sql)
    _assert_rows(scan, port, sql)
    assert port.stats.num_docs_scanned == scan.stats.num_docs_scanned
    assert not ex.engine.meters


def test_repeat_query_reuses_the_selection_mask(tables):
    """The params cache: a repeat query stages no new mask (and so runs no
    traversal); another filter does."""
    ex = QueryExecutor(tables["st"]["port"], device="cpu")
    sql = "SELECT SUM(impressions) FROM st WHERE country = 'c3'"
    first = ex.execute(sql).rows
    sel = next(iter(ex.engine._params_cache.values()))[1]["sel"]
    assert ex.execute(sql).rows == first
    assert len(ex.engine._params_cache) == 1
    assert next(iter(ex.engine._params_cache.values()))[1]["sel"] is sel
    ex.execute("SELECT SUM(impressions) FROM st WHERE country = 'c4'")
    assert len(ex.engine._params_cache) == 2
    assert ex.engine.meter("startree_served") == 3


def test_chip_smoke_checks_k5_on_the_engines_staged_inputs(tables):
    """chip_smoke.staged_startree hands K5's check the blocks the engine
    staged for a tree query on the main path (config #5's query: one
    record count per selected pre-agg record, D the power of two of the
    largest tree), and fails where the engine would not use the tree."""
    ex = QueryExecutor(tables["ssbst"]["port"], device="cpu")
    resp = ex.execute(CONFIG5_SQL)
    plan, cols, params, nd, D = chip_smoke.staged_startree(ex, CONFIG5_SQL)
    assert plan.group_dims == ("d_year",) and plan.num_groups == 7
    assert D == max(128, 1 << (int(nd.max()) - 1).bit_length())
    assert set(cols) == {"sthi:sum__lo_revenue", "stlo:sum__lo_revenue",
                         "stid:d_year"}
    out = tsd.startree_kernel(plan, cols, params, nd, D)
    assert int(out[..., 0].sum()) == resp.stats.num_docs_scanned
    with pytest.raises(SystemExit):
        chip_smoke.staged_startree(ex, CONFIG5_SQL
                                   + " OPTION(useStarTree=false)")
