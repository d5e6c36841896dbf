"""The port's host executor and pruner against the JAX package's.

`pinot_tpu_torch.query.executor_cpu.execute_segment` against
`pinot_tpu.query.executor_cpu.execute_segment`, segment by segment, for
every shape the server tests send (tests/torch_tables.py SHAPES: the
device shapes and the three the port's planner refuses by design), on the
same segment directories (built by the port's creator, loaded by each
package's loader; the upsert table under each package's upsert manager).
Both run numpy, so the results are equal: counts, keys, rows, HLL
registers and t-digest centroids exactly, float sums within rel 1e-12.

`prune_segments` against the JAX pruner: the same pruned set for every
filter below, except a FLOAT column against a literal that is not exact
in float32. There the port reads the literal as float32, as the host
filter does (and as the device bounds do since the FLOAT-literal repair),
and is held to the host oracle; the reference compares in double and
prunes a segment whose minimum is 0.1f for `= 0.1` (ROADMAP §C, a fault
of the reference).

The FLOAT-literal repair itself (ROADMAP §C): on the probe's three
segments `rf > 0.1` gives 3994 and `rf = 0.1` gives 693 from the port in
both postures, through the device path and the server's path, equal to
the JAX host oracle; the JAX x64 device path's 4687 / 0 is recorded.
"""
import math

import numpy as np
import pytest
import torch

import jax

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.query import executor_cpu as jax_cpu
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.query.pruner import prune_segments as jax_prune
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.upsert import \
    PartitionUpsertMetadataManager as JaxManager
from pinot_tpu_torch.query import executor_cpu
from pinot_tpu_torch.query.aggregation import UnsupportedAggregation
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.query.pruner import prune_segments
from pinot_tpu_torch.query.sketches import HyperLogLog, TDigest
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.upsert import PartitionUpsertMetadataManager

from tests import torch_tables as tt


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """{table: (JAX-loaded segments, port-loaded segments)} for srv, st
    and the upsert table ups."""
    root = str(tmp_path_factory.mktemp("host_exec"))
    out = {}
    for name, star in (("srv", False), ("st", True), ("ups", False)):
        dirs = tt.build_table(root, name, star_tree=star)
        out[name] = ([jax_load(d) for d in dirs], [load_segment(d)
                                                   for d in dirs])
    jm = JaxManager(["pk"], "ver")
    tm = PartitionUpsertMetadataManager(["pk"], "ver")
    for j, t in zip(*out["ups"]):
        jm.add_segment(j, use_snapshot=False)
        tm.add_segment(t, use_snapshot=False)
    return out


def _same(a, b) -> bool:
    """Intermediates / keys / rows of the two packages, structurally."""
    if isinstance(a, HyperLogLog):
        return a.log2m == b.log2m and np.array_equal(a.registers,
                                                     b.registers)
    if isinstance(a, TDigest):
        a._compress(force=True)
        b._compress(force=True)
        return a.total == b.total and np.array_equal(a.means, b.means) \
            and np.array_equal(a.weights, b.weights)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) \
            and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        if math.isnan(fa) or math.isinf(fa):
            return (math.isnan(fa) and math.isnan(fb)) or fa == fb
        return math.isclose(fa, fb, rel_tol=1e-12, abs_tol=1e-12)
    return type(a) is type(b) and a == b


def _stats(s) -> tuple:
    return (s.num_docs_scanned, s.num_entries_scanned_in_filter,
            s.num_entries_scanned_post_filter, s.num_segments_processed,
            s.num_segments_matched, s.total_docs)


def assert_same_result(port, ref, what):
    assert type(port).__name__ == type(ref).__name__, what
    assert _stats(port.stats) == _stats(ref.stats), what
    name = type(port).__name__
    if name == "AggregationResult":
        assert _same(port.intermediates, ref.intermediates), what
    elif name == "GroupByResult":
        assert sorted(port.groups, key=repr) == sorted(ref.groups, key=repr)
        for k, v in ref.groups.items():
            assert _same(port.groups[k], v), (what, k)
        assert port.num_groups_limit_reached == ref.num_groups_limit_reached
    elif name == "SelectionResult":
        assert port.columns == ref.columns, what
        assert _same(port.rows, ref.rows), what
        assert (port.order_values is None) == (ref.order_values is None)
        if ref.order_values is not None:
            assert _same(port.order_values, ref.order_values), what
    else:
        assert port.rows == ref.rows, what


@pytest.mark.parametrize("shape", list(tt.SHAPES) + list(tt.FLOAT_SHAPES))
def test_execute_segment_matches_jax(tables, shape):
    if shape in tt.SHAPES:
        table, sql = tt.SHAPES[shape]
        jsql = sql
    else:
        table, sql = "srv", tt.FLOAT_SHAPES[shape]
        jsql = tt.float_oracle_sql(shape)
    jsegs, tsegs = tables[table]
    ctx, jctx = QueryContext.from_sql(sql), JaxContext.from_sql(jsql)
    for jseg, tseg in zip(jsegs, tsegs):
        assert_same_result(executor_cpu.execute_segment(tseg, ctx),
                           jax_cpu.execute_segment(jseg, jctx),
                           (shape, tseg.name))


def test_star_tree_answers_the_host(tables):
    """The host executor answers the star-tree shape from the tree (its
    docs scanned are pre-aggregated records), as the reference's does."""
    _j, tsegs = tables["st"]
    ctx = QueryContext.from_sql(tt.SHAPES["startree"][1])
    res = executor_cpu.execute_segment(tsegs[0], ctx)
    assert 0 < res.stats.num_docs_scanned < tsegs[0].num_docs


def test_unsupported_aggregation_names_the_function(tables):
    _j, tsegs = tables["srv"]
    ctx = QueryContext.from_sql("SELECT DISTINCTCOUNT(d_int) FROM srv")
    assert isinstance(ctx.agg_functions[0], UnsupportedAggregation)
    with pytest.raises(NotImplementedError, match="DISTINCTCOUNT"):
        executor_cpu.execute_segment(tsegs[0], ctx)


PRUNE_FILTERS = [
    "d_int > 25", "d_int >= 19", "d_date < 19940101",
    "d_date BETWEEN 19940101 AND 19940102", "m_int = 600",
    "d_str = 'zzz'", "d_str = 's3'", "d_int IN (30, 40)", "d_int IN (3, 40)",
    "d_int > 5 OR m_int > 1000", "m_int > 1000 OR d_int > 30",
    "m_double > 1e6 AND d_int < 3", "m_float < -1", "m_float = 0.1",
    "m_float > 0.1", "m_float <= -0.5", "m_float IN (0.1, 0.2)",
    "m_float NOT IN (0.1, 0.2)", "m_float IN (-3, 7)", "NOT d_int > 100",
]


@pytest.mark.parametrize("flt", PRUNE_FILTERS)
def test_prune_segments_matches_jax(tables, flt):
    jsegs, tsegs = tables["srv"]
    sql = f"SELECT COUNT(*) FROM srv WHERE {flt}"
    got = [s.name for s in prune_segments(tsegs, QueryContext.from_sql(sql))]
    want = [s.name for s in jax_prune(jsegs, JaxContext.from_sql(sql))]
    assert got == want, flt


def test_float_literal_pruning_held_to_host_oracle(tmp_path):
    """A segment of 0.1f / 0.2f / 1.0f for `rf = 0.1`: the port keeps it
    and answers 2, as the host filter reads the literal; the JAX pruner
    drops it (0.1f > 0.1 in double) and its host executor answers 0."""
    d = tt.build_all_point_one(str(tmp_path))
    sql = "SELECT COUNT(*) FROM p WHERE rf = 0.1"
    ctx, jctx = QueryContext.from_sql(sql), JaxContext.from_sql(sql)
    tseg, jseg = load_segment(d), jax_load(d)
    assert prune_segments([tseg], ctx) == [tseg]
    assert jax_prune([jseg], jctx) == []
    oracle = jax_cpu.execute_segment(jseg, jctx).intermediates[0]
    assert oracle == 2
    assert JaxExecutor([jseg], use_tpu=False).execute(sql).rows == [(0,)]
    for vdt in (torch.float64, torch.float32):
        ex = QueryExecutor([tseg], device="cpu", value_dtype=vdt)
        results, stats = ex.execute_context(ctx)
        assert stats.num_segments_pruned == 0
        assert results[0].intermediates[0] == oracle


@pytest.fixture(scope="module")
def float_probe(tmp_path_factory):
    dirs = tt.build_float_probe(str(tmp_path_factory.mktemp("float")))
    return [jax_load(d) for d in dirs], [load_segment(d) for d in dirs]


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("sql,want,jax_x64_device", [
    ("SELECT COUNT(*) FROM f WHERE rf > 0.1", 3994, 4687),
    ("SELECT COUNT(*) FROM f WHERE rf = 0.1", 693, 0),
])
def test_float_literal_repair(float_probe, sql, want, jax_x64_device, x64):
    """One SQL, one answer: the port reads a FLOAT column's literal as
    float32 in both postures, on the device path (no NotOffloadable at
    float32) and through the server's path, equal to the host oracle."""
    jsegs, tsegs = float_probe
    with jax.enable_x64(x64):
        oracle = JaxExecutor(jsegs, use_tpu=False).execute(sql).rows
        dev = JaxExecutor(jsegs, use_tpu=True).execute(sql).rows
    assert oracle == [(want,)]
    # the reference's x64 device path compares in double (ROADMAP §C)
    assert dev == [(jax_x64_device if x64 else want,)]
    ex = QueryExecutor(tsegs, device="cpu",
                       value_dtype=torch.float64 if x64 else torch.float32)
    assert ex.execute(sql).rows == [(want,)]
    results, _stats = ex.execute_context(QueryContext.from_sql(sql))
    assert sum(r.intermediates[0] for r in results) == want


class _Proxy:
    """A segment the engine does not stage (not an ImmutableSegment): the
    server runs it on the host beside the device launch."""

    def __init__(self, seg):
        self._seg = seg

    def __getattr__(self, name):
        return getattr(self._seg, name)


@pytest.mark.parametrize("shape", ["q1", "groupby", "grouped_sketches"])
def test_execute_context_runs_host_only_segments_beside_the_device(
        tables, shape):
    """With a segment the engine never stages among the selected ones, the
    device batch goes through `execute_async` while that segment runs on
    the host; a refused shape sends the device batch to the host after
    it. The reduced rows equal those of the same segments run alone in
    that order (the device results, then the host-only segment's, then a
    refused batch's: a t-digest merge depends on its order)."""
    from pinot_tpu_torch.query.reduce import reduce_results
    from pinot_tpu_torch.utils.metrics import get_registry
    table, sql = tt.SHAPES[shape]
    _j, tsegs = tables[table]
    ctx = QueryContext.from_sql(sql)
    order = [tsegs[2], *tsegs[:2]] if shape in tt.REFUSED else tsegs
    ex = QueryExecutor(order, device="cpu", value_dtype=torch.float64)
    want = reduce_results(ctx, ex.execute_context(ctx)[0]).rows
    mixed = QueryExecutor([*tsegs[:2], _Proxy(tsegs[2])], engine=ex.engine)
    fb0 = get_registry("server").meter_total("host_fallback")
    results, _stats = mixed.execute_context(ctx)
    assert len(results) == 3
    assert reduce_results(ctx, results).rows == want
    assert get_registry("server").meter_total("host_fallback") - fb0 == \
        (1 if shape in tt.REFUSED else 0)
