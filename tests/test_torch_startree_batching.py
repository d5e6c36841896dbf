"""The batched star-tree: the port's plain batched K5
(pinot_tpu_torch/ops/startree_device.py `batched_kernel`) against the JAX
package's `make_batched_startree_kernel`, and star-tree queries coalescing
through the dispatch ring on the CPU.

Kernel: the JAX engine's staged inputs (`_prepare_startree`) for B queries
of one plan over tests/test_torch_startree.py's table (tree [country,
browser, locale], max_leaf 10), carried across unchanged. Broadcast: one
segment batch's blocks, each member its own filter's selection mask.
Stacked: each member over its own segment batch (its own blocks and record
counts). Flat and grouped plans, in both precision postures (x64 against
float64 values, `jax.enable_x64(False)` against float32). Each member
equals its own single plain launch bit for bit (the batched plain version is
a composition of single launches and adds nothing), and the JAX batched
kernel with test_torch_startree.py's tolerance: counts, exact-sum planes
and min / max equal, float sums within 2^-20 of the slot's sum of
|contribution| (the JAX kernel adds in its value dtype).

Ring: star-tree queries through `TorchOperatorExecutor("cpu")`, the ring
held on its first pop by a delay failpoint on server.dispatch.before (as
tests/test_torch_batching.py does), so a batch's composition is exact:
a broadcast batch (one table, other filters), a stacked batch across two
tables whose segment and record counts pad into one (S, D) bucket, and a
dedup batch; every answer bit-identical to the query alone.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.ops import startree_device as jsd
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import startree_device as tsd
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.utils.failpoints import failpoints

from tests import torch_plans as tp
from tests.test_torch_dispatch import make_engine, run_concurrent
from tests.test_torch_startree import SUM_TOL, TABLES, _columns

POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
#: one plan per shape, B filters (members) each
SHAPES = {
    "flat": "SELECT SUM(impressions), COUNT(*), MAX(cost) FROM st "
            "WHERE country = '{}'",
    "grouped": "SELECT browser, SUM(impressions), SUM(cost) FROM st "
               "WHERE country = '{}' GROUP BY browser",
}
COUNTRIES = ["c1", "c3", "c4", "c7"]
#: stacked members' segment batches (of one 4-segment table)
BATCHES = [(0, 1), (2, 3), (1, 2), (3, 0)]


def _build(tmp, name, n_segs, docs, seed):
    """`n_segs` segments of tests/test_torch_startree.py's "st" table
    (columns from seed + i), written by the port's creator: (port
    segments, JAX segments)."""
    from pinot_tpu_torch import models as tm
    from pinot_tpu_torch.segment.creator import SegmentCreator
    fields, st, _n, _d = TABLES["st"]
    schema = tm.Schema(name, [tm.FieldSpec(f, getattr(tm.DataType, t),
                                           tm.FieldType.METRIC if m
                                           else tm.FieldType.DIMENSION)
                              for f, t, m in fields])
    tc = tm.TableConfig(name)
    tc.indexing.star_tree_configs = [tm.StarTreeIndexConfig(**st)]
    dirs = []
    for i in range(n_segs):
        out = str(tmp / f"{name}_{i}")
        SegmentCreator(tc, schema).build(_columns("st", seed + i, docs), out,
                                         f"{name}_{i}")
        dirs.append(out)
    return [load_segment(d) for d in dirs], [jax_load(d) for d in dirs]


@pytest.fixture(scope="module")
def st4(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("stb4"), "st", 4, 3000, 0)


def jax_staged(jsegs, sql, x64):
    """The JAX engine's staged (plan fields, cols, params, num_docs, D) of
    a star-tree query, as numpy arrays."""
    with jax.enable_x64(x64):
        prep = TpuOperatorExecutor()._prepare_startree(
            jsegs, JaxContext.from_sql(sql))
        assert prep is not None, sql
        plan, _n, _f, _s, launch = prep
        return (plan._asdict(),
                {k: np.asarray(v) for k, v in launch.cols.items()},
                {k: np.asarray(v) for k, v in launch.params.items()},
                np.asarray(launch.num_docs), launch.D)


def _pad(arr, D):
    """A staged [S, d] block widened to [S, D] with zeros (records past
    num_docs, which every kernel reads as absent)."""
    return np.pad(arr, ((0, 0), (0, D - arr.shape[1])))


def members(jsegs, shape, form, x64):
    """(fields, column sets, params per member, num_docs per set, idx, D)
    from the JAX engine's staging, member m filtering COUNTRIES[m]:
    broadcast over segments 0-1; stacked over BATCHES[m]; dedup over
    BATCHES[m % 2] (two sets, each read by two members)."""
    batch_of = {"broadcast": [BATCHES[0]] * len(COUNTRIES),
                "stacked": BATCHES,
                "dedup": [BATCHES[m % 2] for m in range(len(COUNTRIES))]}[form]
    staged = [jax_staged([jsegs[i] for i in batch],
                         SHAPES[shape].format(country), x64)
              for batch, country in zip(batch_of, COUNTRIES)]
    fields = staged[0][0]
    assert all(s[0] == fields for s in staged)
    D = max(s[4] for s in staged)
    uniq = list(dict.fromkeys(batch_of))
    idx = [uniq.index(batch) for batch in batch_of]
    first = [idx.index(u) for u in range(len(uniq))]
    sets = [{k: _pad(v, D) for k, v in staged[m][1].items()} for m in first]
    for m, u in enumerate(idx):  # members of one batch staged its blocks
        assert all(np.array_equal(sets[u][k], _pad(v, D))
                   for k, v in staged[m][1].items())
    plist = [{k: _pad(v, D) for k, v in s[2].items()} for s in staged]
    nds = [staged[m][3] for m in first]
    return fields, sets, plist, nds, idx, D


def jax_batched(fields, sets, plist, nds, idx, D, form, x64):
    B = len(plist)
    with jax.enable_x64(x64):
        plan = jsd.StarTreePlan(**fields)
        jc = [{k: jnp.asarray(v) for k, v in c.items()} for c in sets]
        jp = tuple({k: jnp.asarray(v) for k, v in p.items()} for p in plist)
        jn = [jnp.asarray(n) for n in nds]
        if form == "broadcast":
            out = jsd.make_batched_startree_kernel(plan, B)(jc[0], jp, jn[0],
                                                            D=D)
        else:
            out = jsd.make_batched_startree_kernel(plan, B, True)(
                tuple(jc[u] for u in idx), jp, tuple(jn[u] for u in idx),
                D=D)
        return np.asarray(out)


@POSTURES
@pytest.mark.parametrize("form", ["broadcast", "stacked"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_batched_matches_single_and_jax(st4, shape, form, x64):
    _port, jsegs = st4
    fields, sets, plist, nds, idx, D = members(jsegs, shape, form, x64)
    vdt = torch.float64 if x64 else torch.float32
    plan = tsd.StarTreePlan(**fields)
    tsets = [tk.from_jax_staged(c, {}, n)[0] for c, n in zip(sets, nds)]
    tnds = [tk.from_jax_staged({}, {}, n)[2] for n in nds]
    tps = [tk.from_jax_staged({}, p, nds[0])[1] for p in plist]
    got = tsd.batched_kernel(plan, vdt)(tsets, tps, tnds, idx, D).numpy()
    want = jax_batched(fields, sets, plist, nds, idx, D, form, x64)
    assert got.shape == want.shape and got.shape[0] == len(plist)
    for m, u in enumerate(idx):
        one = tsd.make_startree_kernel(plan, vdt)(tsets[u], tps[m], tnds[u],
                                                  D).numpy()
        assert np.array_equal(got[m], one, equal_nan=True), m
        tp.assert_startree_equal(
            fields, got[m], want[m],
            tp.startree_abs_sums(fields, sets[u], plist[m], nds[u], D),
            SUM_TOL)


def test_dedup_map_is_a_composition_of_single_launches(st4):
    """The ring's member-to-set map (which JAX's star-tree batching does
    not have): each member equals its own single launch over its set."""
    _port, jsegs = st4
    fields, sets, plist, nds, idx, D = members(jsegs, "grouped", "dedup",
                                               False)
    assert idx == [0, 1, 0, 1]
    plan = tsd.StarTreePlan(**fields)
    tsets = [tk.from_jax_staged(c, {}, n)[0] for c, n in zip(sets, nds)]
    tnds = [tk.from_jax_staged({}, {}, n)[2] for n in nds]
    tps = [tk.from_jax_staged({}, p, nds[0])[1] for p in plist]
    got = tsd.batched_kernel(plan)(tsets, tps, tnds, idx, D)
    for m, u in enumerate(idx):
        assert torch.equal(got[m], tsd.startree_kernel(
            plan, tsets[u], tps[m], tnds[u], D))
    with pytest.raises(ValueError, match="members"):
        tsd.batched_kernel(plan)(tsets[:1], tps, tnds[:1], idx, D)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


@pytest.fixture(scope="module")
def two_tables(tmp_path_factory):
    """Two star-tree tables of one plan shape: 3 and 4 segments (both pad
    to S = 4) of records in one power-of-two bucket."""
    tmp = tmp_path_factory.mktemp("stb_ring")
    return {"a": _build(tmp, "sta", 3, 3000, 10)[0],
            "b": _build(tmp, "stb", 4, 2800, 20)[0]}


def agg_values(results):
    """A comparable value tuple per segment result (string group keys)."""
    out = []
    for r in results:
        if hasattr(r, "groups"):
            out.append(tuple(sorted((k, tuple(float(v) for v in inters))
                                    for k, inters in r.groups.items())))
        else:
            out.append(tuple(float(v) for v in r.intermediates))
    return tuple(out)


def singles_of(eng, jobs):
    return [agg_values(eng.execute(s, QueryContext.from_sql(q)))
            for s, q in jobs]


def _key(eng, segs, sql):
    ctx = QueryContext.from_sql(sql)
    with eng._engine_lock:
        launch, _assemble = eng._prepare_startree(segs, ctx, None)
    return launch.batch_key


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("variant", ["broadcast", "stacked", "dedup"])
def test_star_tree_queries_coalesce_through_the_ring(two_tables, variant,
                                                     x64):
    eng = make_engine(x64)
    a, b = two_tables["a"], two_tables["b"]
    sql = SHAPES["grouped"]
    jobs = {"broadcast": [(a, sql.format(c)) for c in COUNTRIES],
            "stacked": [(a, sql.format("c1")), (b, sql.format("c3")),
                        (a[::-1], sql.format("c4"))],
            "dedup": [(a, sql.format("c1")), (b, sql.format("c3")),
                      (a, sql.format("c4")), (b, sql.format("c7"))]}[variant]
    # the premise: every member shares one coalesce key
    assert len({_key(eng, s, q) for s, q in jobs}) == 1
    singles = singles_of(eng, jobs)
    v0 = eng.dispatcher.stats()
    with eng.dispatcher.active():  # keeps each job off the inline path
        got = run_concurrent(eng, jobs)
    stats = eng.dispatcher.stats()
    stats.subtract(v0)
    assert [agg_values(r) for r in got] == singles
    assert stats[variant] == 1 and stats[("size", len(jobs))] == 1
    assert eng.meter("startree_served") == 3 * len(jobs)


def test_star_tree_key_keeps_the_segment_batch_above_the_doc_bucket(
        two_tables, monkeypatch):
    """Above DOC_BUCKET_MAX a star-tree launch keys on its own segment
    batch, as a scan's does; batch.max 1 builds no key."""
    from pinot_tpu_torch.ops import engine as engine_mod
    a, b = two_tables["a"], two_tables["b"]
    sql = SHAPES["flat"].format("c1")
    eng = make_engine()
    assert _key(eng, a, sql) == _key(eng, b, sql)
    monkeypatch.setattr(engine_mod, "DOC_BUCKET_MAX", 128)
    assert _key(eng, a, sql) != _key(eng, b, sql)
    assert _key(eng, a, sql)[1] == engine_mod._batch_key(a)
    assert _key(make_engine(**{"pinot.server.dispatch.batch.max": 1}),
                a, sql) is None


def test_padded_star_tree_staging_reads_only_real_segments(two_tables):
    """Three segments pad to S = 4: the padded row selects nothing and
    holds no records; the answer equals the unpadded engine's (cross-table
    coalescing off keeps S = 3)."""
    a = two_tables["a"]
    eng = make_engine()
    ctx = QueryContext.from_sql(SHAPES["grouped"].format("c3"))
    plan, _needed, fits = eng._plan_startree(a, ctx)
    cols, params, nd, D = eng._stage_startree(a, ctx, plan, fits)
    assert nd.tolist()[3] == 0 and not params["sel"][3].any()
    assert all(v.shape == (4, D) and not v[3].any() for v in cols.values())
    plain = make_engine(**{"pinot.server.dispatch.batch.cross.table": False})
    assert plain._stage_startree(a, ctx, plan, fits)[2].shape == (3,)
    assert agg_values(eng.execute(a, ctx)) == agg_values(plain.execute(a,
                                                                       ctx))
