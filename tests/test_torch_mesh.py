"""The port's mesh (pinot_tpu_torch/parallel, ops/collective.py, the
sharded kernels of ops/kernels.py, K9 `mesh_fold`'s plain version and the
engine's mesh path) against the JAX package's.

The conftest gives JAX 8 virtual CPU devices; the port's meshes are
logical meshes of "cpu" slots (`make_mesh(["cpu"] * n, doc_axis)`), on the
geometries of tests/test_mesh_scaling.py: 1x1, 2x2 and 4x2. The same
seeded numpy inputs go through both packages, in both postures: x64
(conftest) against value_dtype float64, and `jax.enable_x64(False)`
against float32.

Tolerances (tests/torch_plans.py, as tests/test_torch_kernels.py and
test_torch_batching.py hold K1-K3): counts, exact-sum planes, HLL
registers, histogram buckets, group keys and matched tails are exact;
float sums within 1e-9 (float64) or 1e-5 (float32) of the larger of the
result and the slot's sum of |contribution| (JAX psums float32 partials in
float32, the port adds them in float64 and rounds once); min / max of an
expression where an add takes a product within 2^-20 in float32 (XLA on
the CPU fuses that pair into one FMA). SQL rows: integers exact, floats
within rel 1e-5, as tests/test_mesh_scaling.py holds its engine; the
t-digest percentile exact against the JAX mesh engine and within rel 0.02
of the host executor's digest.
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

from pinot_tpu.ops import collective as jc
from pinot_tpu.ops import kernels as jk
from pinot_tpu.ops import plan_ir as jir
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.parallel.distributed_query import \
    distributed_query_step as jax_step
from pinot_tpu.parallel.mesh import make_mesh as jax_mesh
from pinot_tpu.query.context import QueryContext as JContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor

from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType, Schema,
                                    StarTreeIndexConfig, TableConfig)
from pinot_tpu_torch.ops import collective as tc
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops.engine import NotOffloadable, TorchOperatorExecutor
from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
from pinot_tpu_torch.parallel import (distributed_query_step, make_mesh,
                                      shard_block)
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.utils.config import PinotConfiguration
from tests import torch_plans as tp
from tests.queries.harness import (build_segments, synthetic_columns,
                                   synthetic_schema, synthetic_table_config)

#: (devices, doc axis) -> 1x1, 2x2, 4x2 (segments x docs)
MESH_SHAPES = [(1, 1), (4, 2), (8, 2)]
MESH_IDS = ["1x1", "2x2", "4x2"]
S, D = 4, 1024
NUM_DOCS = 700  # not a multiple of a doc slice: padding must mask right
POSTURES = [True, False]
POSTURE_IDS = ["f64", "f32"]


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def meshes(n, doc_axis):
    """(the JAX mesh, the port's logical CPU mesh) of one geometry."""
    return (jax_mesh(jax.devices()[:n], doc_axis=doc_axis),
            make_mesh(["cpu"] * n, doc_axis=doc_axis))


def jax_plan(spec):
    leaves = tuple(jir.DeviceLeaf(lf.kind, lf.column)
                   for lf in spec["leaves"])
    return jir.DevicePlan(**{**spec, "leaves": leaves})


def port_plan(jplan) -> DevicePlan:
    """The port's DevicePlan of a JAX engine's dense plan."""
    names = DevicePlan.__dataclass_fields__
    fields = {k: getattr(jplan, k) for k in names if hasattr(jplan, k)}
    fields["leaves"] = tuple(DeviceLeaf(lf.kind, lf.column, tuple(lf.meta))
                             for lf in jplan.leaves)
    return DevicePlan(**fields)


def vdt_of(x64):
    return (np.float64, torch.float64) if x64 else (np.float32,
                                                    torch.float32)


def sharded(mesh, cols):
    return {k: shard_block(mesh, torch.from_numpy(
        np.require(v, requirements=["C", "W"]))) for k, v in cols.items()}


def jarrays(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def with_vmask(spec, cols, seed):
    rng = np.random.default_rng(seed + 17)
    cols = dict(cols, vmask=rng.random(cols["ids:a"].shape) < 0.7)
    return dict(spec, valid_mask=True), cols


def random_spec(seed, grouped, x64):
    """A random plan of the seed, or, in float32, of the first seed from it
    whose value expressions hold no add of a product: XLA's sharded
    compile fuses such a pair into one FMA (its single-device compile and
    the port round twice), and under cancellation that moves a float32
    value past any tolerance on its sum."""
    for _ in range(100):
        spec = tp.random_spec(seed, grouped)
        floats = {v for op, v, _f in spec["agg_ops"]
                  if v is not None and not op.startswith("isum")}
        if x64 or not any(tp.contractible(spec["value_irs"][v])
                          for v in floats):
            return spec
        seed += 1000
    raise AssertionError("no plan without a fused pair")


def case_inputs(case, x64, seed=3):
    """(spec, cols, params, num_docs) of one row-7 case."""
    npdt, _ = vdt_of(x64)
    if case == "sketch":
        spec = tp.random_sketch_spec(seed, log2ms=(8,), buckets=256)
        cols, params, nd = tp.sketch_inputs(seed, spec, S, D, npdt)
    else:
        grouped = case.startswith("grouped")
        spec = random_spec(seed + grouped, grouped, x64)
        cols, params, nd = tp.random_inputs(seed, spec, S, D, npdt)
        if case.endswith("vmask"):
            spec, cols = with_vmask(spec, cols, seed)
    nd[0] = NUM_DOCS
    return spec, cols, params, nd


def scale_of(plan, cols, params, nd):
    tcs, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    return {j: v.numpy() for j, v in
            tk.abs_contributions(plan, tcs, tpar, tnd, D).items()}


# ---------------------------------------------------------------------------
# K9's plain version against a numpy fold
# ---------------------------------------------------------------------------

def numpy_fold(parts, fold):
    """The fold's definition, element by element, in Python floats."""
    B = parts[0].shape[0]
    flat = [p.reshape(B, fold.rows_in, fold.win) for p in parts]
    out = np.zeros((B, fold.R * fold.W + fold.T))
    for b in range(B):
        for o in range(fold.R):
            for w in range(fold.W):
                op = int(fold.ops[w])
                acc = (0.0, math.inf, -math.inf)[op]
                for s in fold.src[fold.off[o]:fold.off[o + 1]]:
                    v = float(flat[s >> 32][b, s & 0xFFFFFFFF,
                                            fold.col0 + w])
                    if op == 0:
                        acc += v
                    elif op == 1:
                        acc = v if (v < acc or v != v) else acc
                    else:
                        acc = v if (v > acc or v != v) else acc
                out[b, o * fold.W + w] = acc
        for t in range(fold.T):
            acc = 0.0
            for s in fold.tsrc[fold.toff[t]:fold.toff[t + 1]]:
                acc += float(flat[s >> 32][b, s & 0xFFFFFFFF,
                                           fold.tail_col])
            out[b, fold.R * fold.W + t] = acc
    return out.astype(parts[0].dtype)


def _parts(seed, P, B, rows, win, dtype):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P):
        a = rng.normal(0, 100, (B, rows, win)).astype(dtype)
        a[rng.random(a.shape) < 0.02] = np.nan
        a[rng.random(a.shape) < 0.02] = np.inf
        a[rng.random(a.shape) < 0.02] = -np.inf
        out.append(a)
    return out


FOLD_CASES = ["doc", "merged", "merged-remap"]


@pytest.mark.parametrize("kind", FOLD_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_plain_mesh_fold_matches_numpy(kind, dtype):
    """Every op code, with and without the remap and the tail, NaN and
    infinities included: bit for bit with the numpy fold of the same
    lists in the same order."""
    mesh = make_mesh(["cpu"] * 4, doc_axis=2)
    s_loc, B = 3, 2
    if kind == "doc":
        fold = tk.doc_fold(2, 2, s_loc, 1, 5, (0, 1, 2, 0, 2))
        win = 5
    else:
        grouped = kind == "merged-remap"
        plan = DevicePlan(
            filter_ir=None, leaves=(), value_irs=(("col", "x"),),
            agg_ops=(("sum", 0, None), ("min", 0, None), ("max", 0, None),
                     ("count", None, None)),
            **(dict(group_cols=("a",), group_strides=(1,), num_groups=5)
               if grouped else {}))
        remap = None
        if grouped:
            rng = np.random.default_rng(4)
            remap = rng.integers(-1, 8, (2 * s_loc, 5))
        fold = tc.merged_plan(plan, mesh, 2 * s_loc, 8 if grouped else 0,
                              remap)
        win = fold.win
    rows = fold.rows_in
    parts = _parts(11, 4, B, rows, win, dtype)
    got = tk.mesh_fold_plain([torch.from_numpy(p) for p in parts], fold)
    want = numpy_fold(parts, fold)
    assert got.dtype == torch.from_numpy(want).dtype
    assert np.array_equal(got.numpy(), want, equal_nan=True)
    assert fold.T == (0 if kind == "doc" else 2 * s_loc)
    # the dispatching wrapper takes CPU partials to the plain version
    assert torch.equal(tk.mesh_fold([torch.from_numpy(p) for p in parts],
                                    fold).nan_to_num(7.0),
                       got.nan_to_num(7.0))


def test_doc_combine_table_is_the_jax_table():
    assert tk.DOC_COMBINE == jk._DOC_COMBINE


# ---------------------------------------------------------------------------
# row 7: the sharded kernel
# ---------------------------------------------------------------------------

#: (case, x64): the sketch slots in float32 only, K3's posture on the card
ROW7_CASES = [(case, x64) for case in ("ungrouped", "grouped",
                                       "ungrouped-vmask", "grouped-vmask")
              for x64 in POSTURES] + [("sketch", False)]


@pytest.mark.parametrize("case,x64", ROW7_CASES)
@pytest.mark.parametrize("n,doc_axis", MESH_SHAPES, ids=MESH_IDS)
def test_sharded_kernel_matches_jax(case, x64, n, doc_axis):
    spec, cols, params, nd = case_inputs(case, x64)
    jmesh, mesh = meshes(n, doc_axis)
    with jax.enable_x64(x64):
        ref = np.asarray(jk.compiled_sharded_kernel(jax_plan(spec), jmesh)(
            jarrays(cols), jarrays(params), jnp.asarray(nd), D=D))
    plan = DevicePlan(**spec)
    tcs, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    got = tk.sharded_kernel(plan, mesh, vdt_of(x64)[1])(
        sharded(mesh, tcs), tpar, tnd, D).numpy()
    tp.assert_packed_equal(spec, got, ref, scale_of(plan, cols, params, nd),
                           x64, fma=True)


@pytest.mark.parametrize("case", ["ungrouped", "grouped"])
def test_sharded_kernel_equals_the_single_device_kernel(case):
    """Under float64 the doc fold only regroups exact partials: the mesh
    gives the single launch's result (exact-sum planes summed, counts,
    min / max equal; float sums within 1e-9)."""
    spec, cols, params, nd = case_inputs(case, True)
    plan = DevicePlan(**spec)
    tcs, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    one = tk.make_kernel(plan, torch.float64)(tcs, tpar, tnd, D).numpy()
    mesh = make_mesh(["cpu"] * 8, doc_axis=4)
    got = tk.sharded_kernel(plan, mesh, torch.float64)(
        sharded(mesh, tcs), tpar, tnd, D).numpy()
    if not plan.num_groups:
        # exact-sum halves add per shard: compare the sums they rebuild
        spec = dict(spec, agg_ops=tuple(
            ("sum", v, f) if op.startswith("isum") else (op, v, f)
            for op, v, f in spec["agg_ops"]))
        got, one = _rebuilt(plan, got), _rebuilt(plan, one)
    scale = scale_of(plan, cols, params, nd)
    for j in range(len(spec["agg_ops"])):
        scale.setdefault(j, np.zeros(S))  # the rebuilt sums: exact
    tp.assert_packed_equal(spec, got, one, scale, True)


def _rebuilt(plan, packed):
    """Packed rows with each exact-sum slot's planes replaced by the sum
    they rebuild (in its first column, the rest zero)."""
    from pinot_tpu_torch.ops.engine import isum_u_value, isum_value
    out = packed.copy()
    col = 1
    for op, _v, _f in plan.agg_ops:
        w = tk.slot_width(op)
        if op.startswith("isum"):
            fn = isum_value if op == "isum" else isum_u_value
            for s in range(out.shape[0]):
                v = fn(packed[s, col:col + w])
                out[s, col:col + w] = 0
                out[s, col] = v
        col += w
    return out


# ---------------------------------------------------------------------------
# row 8c: the sharded kernel's query axis
# ---------------------------------------------------------------------------

BATCH_CASES = [(B, form, grouped) for B in (1, 3, 8)
               for form in ("broadcast", "stacked")
               for grouped in (False, True)]


@pytest.mark.parametrize("B,form,grouped", BATCH_CASES)
def test_batched_sharded_kernel_matches_jax_and_single(B, form, grouped):
    x64 = True
    _check_batched(B, form, grouped, x64)


@pytest.mark.parametrize("grouped", [False, True])
def test_batched_sharded_kernel_f32(grouped):
    _check_batched(3, "stacked", grouped, False)


def _check_batched(B, form, grouped, x64):
    npdt, vdt = vdt_of(x64)
    spec = random_spec(21 + grouped, grouped, x64)
    U = 1 if form == "broadcast" else B
    sets = [tp.random_inputs(31 + u, spec, S, D, npdt) for u in range(U)]
    for _c, _p, nd in sets:
        nd[0] = NUM_DOCS
    plist = [tp.random_inputs(41 + m, spec, S, D, npdt)[1]
             for m in range(B)]
    jmesh, mesh = meshes(8, 2)
    with jax.enable_x64(x64):
        fn = jk.compiled_batched_sharded_kernel(jax_plan(spec), jmesh, B,
                                                form == "stacked")
        jp = tuple(jarrays(p) for p in plist)
        if form == "stacked":
            ref = fn(tuple(jarrays(c) for c, _p, _n in sets), jp,
                     tuple(jnp.asarray(n) for _c, _p, n in sets), D=D)
        else:
            ref = fn(jarrays(sets[0][0]), jp, jnp.asarray(sets[0][2]), D=D)
        ref = np.asarray(ref)
    plan = DevicePlan(**spec)
    tsets = [tk.from_jax_staged(c, p, n) for c, p, n in sets]
    tps = [tk.from_jax_staged({}, p, sets[0][2])[1] for p in plist]
    col_sets = [sharded(mesh, {k: v.numpy() for k, v in t[0].items()})
                for t in tsets]
    idx = [0] * B if form == "broadcast" else list(range(B))
    got = tk.batched_sharded_kernel(plan, mesh, vdt)(
        col_sets, tps, [t[2] for t in tsets], idx, D).numpy()
    single = tk.sharded_kernel(plan, mesh, vdt)
    for m in range(B):
        u = idx[m]
        one = single(col_sets[u], tps[m], tsets[u][2], D).numpy()
        assert np.array_equal(got[m], one, equal_nan=True), m
        tp.assert_packed_equal(
            spec, got[m], ref[m],
            scale_of(plan, sets[u][0], plist[m], sets[u][2]), x64, fma=True)


def test_dedup_batches_equal_single_launches():
    """A member-to-set map that shares column sets: each member equals
    its single launch."""
    spec = tp.random_spec(5, False)
    sets = [tp.random_inputs(51 + u, spec, S, D, np.float64)
            for u in range(2)]
    plist = [tp.random_inputs(61 + m, spec, S, D, np.float64)[1]
             for m in range(4)]
    mesh = make_mesh(["cpu"] * 4, doc_axis=2)
    plan = DevicePlan(**spec)
    col_sets = [sharded(mesh, c) for c, _p, _n in sets]
    nds = [torch.from_numpy(n) for _c, _p, n in sets]
    tps = [tk.from_jax_staged({}, p, sets[0][2])[1] for p in plist]
    idx = [1, 0, 1, 0]
    got = tk.batched_sharded_kernel(plan, mesh, torch.float64)(
        col_sets, tps, nds, idx, D).numpy()
    single = tk.sharded_kernel(plan, mesh, torch.float64)
    for m, u in enumerate(idx):
        assert np.array_equal(got[m], single(col_sets[u], tps[m], nds[u],
                                             D).numpy(), equal_nan=True)


# ---------------------------------------------------------------------------
# row 9: the collective merge, on the JAX engine's own staging and remap
# ---------------------------------------------------------------------------

MERGE_SQLS = {
    "ungrouped": ("SELECT SUM(intCol), COUNT(*), MIN(intCol), MAX(rawIntCol)"
                  " FROM testTable WHERE intCol > {}", (250, 400, 600)),
    "grouped": ("SELECT stringCol, groupCol, COUNT(*), SUM(intCol), "
                "MIN(rawIntCol) FROM testTable WHERE intCol > {} "
                "GROUP BY stringCol, groupCol", (250, 400, 600)),
}


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """Six segments of 700 docs, built by the JAX creator and loaded by
    each package's loader (the JAX mesh tests' table)."""
    tmp = tmp_path_factory.mktemp("torch_mesh")
    data = [synthetic_columns(NUM_DOCS, seed=131 + i) for i in range(6)]
    jsegs = build_segments(tmp, synthetic_schema(), synthetic_table_config(),
                           data)
    return jsegs, [load_segment(str(tmp / f"seg_{i}")) for i in range(6)]


def _jax_merged_inputs(jsegs, jmesh, sqls):
    """The JAX mesh engine's plan, staging and merged group params of each
    query (one plan), as numpy: (plan, cols, [params], num_docs, D, G)."""
    eng = TpuOperatorExecutor(mesh=jmesh)
    plist = []
    for sql in sqls:
        ctx = JContext.from_sql(sql)
        plan, _ = eng._plan(jsegs, ctx)
        cols, params, num_docs, _s, D_, G = eng._stage(jsegs, ctx, plan)
        params = dict(params)
        if plan.group_cols:
            gparams, G_m, _n, _d = eng._merged_group_params(
                jsegs, plan, int(num_docs.shape[0]), G)
            params.update(gparams)
        else:
            G_m = 0
        plist.append({k: np.asarray(v) for k, v in params.items()})
    return (plan, {k: np.asarray(v) for k, v in cols.items()}, plist,
            np.asarray(num_docs), D_, G_m)


@pytest.mark.parametrize("kind", list(MERGE_SQLS))
@pytest.mark.parametrize("x64", POSTURES, ids=POSTURE_IDS)
@pytest.mark.parametrize("n,doc_axis", MESH_SHAPES[1:], ids=MESH_IDS[1:])
def test_merged_kernels_match_jax(segs, kind, x64, n, doc_axis):
    """merged_kernel and batched_merged_kernel (B = 3, broadcast) against
    the JAX engine's compiled_merged_kernel and
    compiled_batched_merged_kernel, the JAX engine's gmap params fed to
    both: group blocks, the matched tails exact (counts, min / max,
    integer sums), float sums within the posture's tolerance."""
    jsegs, _tsegs = segs
    jmesh, mesh = meshes(n, doc_axis)
    sql, lits = MERGE_SQLS[kind]
    with jax.enable_x64(x64):
        jplan, cols, plist, nd, D_, G = _jax_merged_inputs(
            jsegs, jmesh, [sql.format(v) for v in lits])
        ref = np.asarray(jc.compiled_merged_kernel(jplan, jmesh)(
            jarrays(cols), jarrays(plist[0]), jnp.asarray(nd), D=D_, G=G))
        bref = np.asarray(jc.compiled_batched_merged_kernel(
            jplan, jmesh, 3)(jarrays(cols), tuple(jarrays(p) for p in plist),
                             jnp.asarray(nd), D=D_, G=G))
    plan = port_plan(jplan)
    vdt = vdt_of(x64)[1]
    tcs, tp0, tnd = tk.from_jax_staged(cols, plist[0], nd)
    scs = sharded(mesh, cols)
    got = tc.merged_kernel(plan, mesh, vdt)(scs, tp0, tnd, D_, G).numpy()
    tps = [tk.from_jax_staged({}, p, nd)[1] for p in plist]
    bgot = tc.batched_merged_kernel(plan, mesh, vdt, G)(
        [scs], tps, [tnd], [0, 0, 0], D_).numpy()
    n_slots = len(plan.agg_ops)
    width = G * n_slots + len(nd) if G else \
        sum(tk.slot_width(op) for op, _v, _f in plan.agg_ops) + len(nd)
    assert got.shape == ref.shape == (width,)
    assert np.array_equal(bgot[0], got)
    for a, b in [(got, ref)] + list(zip(bgot, bref)):
        _merged_close(plan, a, b, len(nd), G, x64)


def _merged_close(plan, a, b, S_, G, x64):
    tol = 1e-9 if x64 else 1e-5
    assert np.array_equal(a[-S_:], b[-S_:]), "matched tail"
    if plan.group_cols:
        n = len(plan.agg_ops)
        a, b = a[:G * n].reshape(G, n), b[:G * n].reshape(G, n)
        for j, (op, _v, _f) in enumerate(plan.agg_ops):
            if op == "sum":
                assert np.allclose(a[:, j], b[:, j], rtol=tol, atol=0), op
            else:
                assert np.array_equal(a[:, j], b[:, j]), op
        return
    col = 0
    for op, _v, _f in plan.agg_ops:
        w = tk.slot_width(op)
        assert np.allclose(a[col:col + w], b[col:col + w], rtol=tol,
                           atol=0), op
        if not op.startswith("sum"):
            assert np.array_equal(a[col:col + w], b[col:col + w]), op
        col += w


# ---------------------------------------------------------------------------
# row 14: distributed_query_step
# ---------------------------------------------------------------------------

def _step_inputs(seed, G, S_=8, D_=512, gid_lo=0, gid_hi=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 100, (S_, D_)).astype(np.int32)
    vals = rng.uniform(-50, 50, (S_, D_)).astype(np.float32)
    gids = rng.integers(gid_lo, G if gid_hi is None else gid_hi,
                        (S_, D_)).astype(np.int32)
    lo = rng.integers(0, 40, S_).astype(np.int32)
    hi = (lo + rng.integers(10, 60, S_)).astype(np.int32)
    ndocs = rng.integers(D_ // 3, D_ + 1, S_).astype(np.int32)
    ndocs[0] = NUM_DOCS % D_
    doc_pos = np.arange(D_, dtype=np.int32)[None, :]
    return ids, vals, gids, lo, hi, ndocs, doc_pos


def _run_steps(args, G, n=8, doc_axis=2):
    jmesh, mesh = meshes(n, doc_axis)
    ref = [np.asarray(x) for x in jax_step(jmesh)(G)(
        *(jnp.asarray(a) for a in args))]
    got = [x.numpy() for x in distributed_query_step(mesh)(G)(
        *(torch.from_numpy(a) for a in args))]
    return got, ref


def _step_truth(args, G, wrap: bool):
    ids, vals, gids, lo, hi, ndocs, _p = args
    valid = np.arange(ids.shape[1])[None] < ndocs[:, None]
    mask = (ids >= lo[:, None]) & (ids <= hi[:, None]) & valid
    v = vals.astype(np.float64)
    groups = np.zeros(G)
    k = gids[mask]
    if wrap:
        k = np.where((k < 0) & (k >= -G), k + G, k)
    keep = (k >= 0) & (k < G)
    np.add.at(groups, k[keep], v[mask][keep])
    return (v * mask).sum(), int(mask.sum()), groups, \
        np.abs(v * mask).sum()


@pytest.mark.parametrize("n,doc_axis", MESH_SHAPES, ids=MESH_IDS)
def test_distributed_query_step_matches_jax(n, doc_axis):
    G = 16
    args = _step_inputs(7, G)
    got, ref = _run_steps(args, G, n, doc_axis)
    total, count, groups, scale = _step_truth(args, G, wrap=False)
    assert float(got[1]) == float(ref[1]) == count
    assert abs(float(got[0]) - float(ref[0])) <= tp.F32_SUM_TOL * scale
    assert abs(float(got[0]) - total) <= tp.F32_SUM_TOL * scale
    assert got[2].shape == ref[2].shape == (G,)
    assert np.allclose(got[2], ref[2], rtol=0, atol=tp.F32_SUM_TOL * scale)
    assert np.allclose(got[2], groups, rtol=0, atol=tp.F32_SUM_TOL * scale)


def test_distributed_query_step_out_of_range_gids():
    """A gid at or past num_groups leaves group_sums and stays in the
    totals, in both packages. A negative gid: JAX's indexing wraps it to
    gid + num_groups; the port drops it, as it drops every key outside
    [0, num_groups). Pinned both ways."""
    G = 8
    args = _step_inputs(9, G, gid_lo=0, gid_hi=G + 5)
    got, ref = _run_steps(args, G)
    total, count, groups, scale = _step_truth(args, G, wrap=False)
    assert float(got[1]) == float(ref[1]) == count
    assert np.allclose(got[2], ref[2], rtol=0, atol=tp.F32_SUM_TOL * scale)
    assert np.allclose(got[2], groups, rtol=0, atol=tp.F32_SUM_TOL * scale)
    assert abs(float(got[0]) - total) <= tp.F32_SUM_TOL * scale
    neg = _step_inputs(10, G, gid_lo=-3, gid_hi=G)
    got, ref = _run_steps(neg, G)
    _t, count, dropped, scale = _step_truth(neg, G, wrap=False)
    _t, _c, wrapped, _s = _step_truth(neg, G, wrap=True)
    assert float(got[1]) == float(ref[1]) == count
    assert np.allclose(got[2], dropped, rtol=0,
                       atol=tp.F32_SUM_TOL * scale)
    assert np.allclose(ref[2], wrapped, rtol=0,
                       atol=tp.F32_SUM_TOL * scale)
    assert not np.allclose(got[2][-3:], ref[2][-3:])


def test_distributed_query_step_takes_sharded_blocks_and_checks_doc_pos():
    G = 4
    args = _step_inputs(12, G)
    mesh = make_mesh(["cpu"] * 4, doc_axis=2)
    step = distributed_query_step(mesh)(G)
    t = [torch.from_numpy(a) for a in args]
    a = step(*t)
    blocks = [shard_block(mesh, x) for x in t[:3]]
    b = step(*blocks, *t[3:])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="doc_pos"):
        step(*t[:6], torch.flip(t[6], [1]))


# ---------------------------------------------------------------------------
# SQL three ways: the port's mesh engine, the JAX mesh engine, the host
# ---------------------------------------------------------------------------

PARITY_SQLS = [
    "SELECT SUM(intCol), COUNT(*), MIN(intCol), MAX(intCol) "
    "FROM testTable WHERE intCol > 250",
    "SELECT SUM(intCol * rawIntCol), AVG(intCol) FROM testTable "
    "WHERE stringCol IN ('s1', 's4', 's8') AND intCol < 800",
    "SELECT groupCol, COUNT(*), SUM(intCol), MIN(rawIntCol) "
    "FROM testTable GROUP BY groupCol ORDER BY groupCol LIMIT 50",
    "SELECT stringCol, groupCol, COUNT(*), MAX(intCol) FROM testTable "
    "GROUP BY stringCol, groupCol ORDER BY COUNT(*) DESC, stringCol, "
    "groupCol LIMIT 25",
    # tests/test_multichip.py's five
    "SELECT SUM(intCol), COUNT(*) FROM testTable "
    "WHERE intCol BETWEEN 100 AND 700",
    "SELECT groupCol, SUM(floatCol), COUNT(*) "
    "FROM testTable GROUP BY groupCol ORDER BY groupCol LIMIT 50",
    "SELECT MIN(intCol), MAX(intCol), AVG(intCol) "
    "FROM testTable WHERE intCol > 300",
    "SELECT COUNT(*), SUM(intCol) FROM testTable "
    "WHERE stringCol IN ('s1', 's3', 's7')",
    "SELECT SUM(intCol * floatCol) FROM testTable "
    "WHERE intCol < 900 AND rawIntCol > 10",
    "SELECT stringCol, COUNT(*) FROM testTable "
    "GROUP BY stringCol ORDER BY stringCol LIMIT 100",
]
SKETCH_SQL = ("SELECT DISTINCTCOUNTHLL(intCol), PERCENTILETDIGEST90(doubleCol)"
              ", COUNT(*) FROM testTable WHERE intCol > 100")


def _rows_close(a, b, digest_rel=None):
    assert len(a) == len(b), (a, b)
    for x, y in zip(a, b):
        assert len(x) == len(y), (a, b)
        for u, v in zip(x, y):
            if isinstance(u, float) or isinstance(v, float):
                rel = 1e-5 if digest_rel is None else digest_rel
                assert abs(float(u) - float(v)) <= \
                    rel * max(1.0, abs(float(v))), (a, b)
            else:
                assert u == v, (a, b)


def _port_exec(tsegs, n, doc_axis, x64, **cfg):
    return QueryExecutor(tsegs, device="cpu", value_dtype=vdt_of(x64)[1],
                         mesh=make_mesh(["cpu"] * n, doc_axis=doc_axis),
                         config=PinotConfiguration(cfg) if cfg else None)


@pytest.mark.parametrize("x64", POSTURES, ids=POSTURE_IDS)
@pytest.mark.parametrize("n,doc_axis", MESH_SHAPES, ids=MESH_IDS)
def test_sql_three_ways(segs, x64, n, doc_axis):
    jsegs, tsegs = segs
    port = _port_exec(tsegs, n, doc_axis, x64)
    with jax.enable_x64(x64):
        jdev = JaxExecutor(jsegs, use_tpu=True, engine=TpuOperatorExecutor(
            mesh=jax_mesh(jax.devices()[:n], doc_axis=doc_axis)))
        host = JaxExecutor(jsegs, use_tpu=False)
        for sql in PARITY_SQLS:
            got = port.execute(sql).rows
            jr, hr = jdev.execute(sql), host.execute(sql)
            assert not jr.exceptions and not hr.exceptions
            _rows_close(got, jr.rows)
            _rows_close(got, hr.rows)
        got = port.execute(SKETCH_SQL).rows
        _rows_close(got, jdev.execute(SKETCH_SQL).rows)
        _rows_close(got, host.execute(SKETCH_SQL).rows, digest_rel=0.02)
    eng = port.engine
    if n > 1:
        assert eng.meter("mesh_merge_served") == len(PARITY_SQLS) + 1
    else:
        assert eng.meter("mesh_merge_served") == 0


@pytest.mark.parametrize("n,doc_axis", MESH_SHAPES[1:], ids=MESH_IDS[1:])
def test_merge_off_counts_disabled_and_keeps_rows(segs, n, doc_axis):
    _jsegs, tsegs = segs
    on = _port_exec(tsegs, n, doc_axis, True)
    off = _port_exec(tsegs, n, doc_axis, True,
                     **{"pinot.server.mesh.collective.merge": False})
    for sql in PARITY_SQLS:
        assert on.execute(sql).rows == off.execute(sql).rows, sql
    assert off.engine.meter("mesh_merge_fallback", "disabled") == \
        len(PARITY_SQLS)
    assert off.engine.meter("mesh_merge_served") == 0


def test_merged_stats_equal_the_per_segment_stats(segs):
    _jsegs, tsegs = segs
    on = _port_exec(tsegs, 8, 2, True)
    off = _port_exec(tsegs, 8, 2, True,
                     **{"pinot.server.mesh.collective.merge": False})
    for sql in PARITY_SQLS[:4]:
        a, b = on.execute(sql), off.execute(sql)
        assert a.stats == b.stats, sql


def test_float32_precision_gate(segs, monkeypatch):
    """A float32 batch at or past 2^24 docs keeps the per-segment launch
    and the host fold, counted as reason 'precision'."""
    from pinot_tpu_torch.ops import engine as eng_mod
    _jsegs, tsegs = segs
    port = _port_exec(tsegs, 8, 2, False)
    monkeypatch.setattr(eng_mod, "MAX_DOCS_PER_SEGMENT", 6 * NUM_DOCS)
    rows = port.execute(PARITY_SQLS[0]).rows
    assert port.engine.meter("mesh_merge_fallback", "precision") == 1
    assert port.engine.meter("mesh_merge_served") == 0
    monkeypatch.undo()
    assert port.execute(PARITY_SQLS[0]).rows == rows
    assert port.engine.meter("mesh_merge_served") == 1


def test_group_cap_gate(segs, monkeypatch):
    _jsegs, tsegs = segs
    port = _port_exec(tsegs, 8, 2, True)
    monkeypatch.setattr(TorchOperatorExecutor, "GMAP_MAX_BYTES", 64)
    rows = port.execute(PARITY_SQLS[2]).rows
    assert port.engine.meter("mesh_merge_fallback", "groups") == 1
    monkeypatch.undo()
    assert port.execute(PARITY_SQLS[2]).rows == rows


def test_launches_coalesce_only_on_one_mesh_shape(segs):
    """The mesh signature rides the coalesce key: merged and unmerged,
    and two geometries, never share a key; equal engines' launches do."""
    _jsegs, tsegs = segs
    keys = {}
    for name, (n, da, merge) in {"a": (8, 2, True), "b": (8, 2, True),
                                 "c": (8, 2, False), "d": (4, 2, True),
                                 "e": (8, 4, True)}.items():
        ex = _port_exec(tsegs, n, da, True,
                        **{"pinot.server.mesh.collective.merge": merge})
        eng = ex.engine
        ctx = QueryContext.from_sql(PARITY_SQLS[0])
        with eng._engine_lock:
            launch, _assemble = eng._prepare_agg(tsegs, ctx, None)
        keys[name] = launch.batch_key
    assert keys["a"] == keys["b"]
    assert len({keys[k] for k in "acde"}) == 4


def _random_sql(rng):
    """tests/test_mesh_scaling.py:119's generator: a random aggregation /
    group-by / filter shape over the integer columns."""
    aggs = list(rng.choice(
        ["SUM(intCol)", "COUNT(*)", "MIN(intCol)", "MAX(rawIntCol)",
         "SUM(rawIntCol)", "AVG(intCol)", "SUM(intCol * rawIntCol)",
         "MIN(rawIntCol)", "MAX(intCol)"],
        size=rng.integers(1, 4), replace=False))
    filters = ["", " WHERE intCol > %d" % rng.integers(0, 900),
               " WHERE rawIntCol BETWEEN %d AND %d" % (
                   rng.integers(0, 40), rng.integers(50, 120)),
               " WHERE stringCol IN ('s1', 's5') AND intCol < %d"
               % rng.integers(200, 1000)]
    where = filters[rng.integers(0, len(filters))]
    group = ["", "groupCol", "stringCol", "stringCol, groupCol"][
        rng.integers(0, 4)]
    if group:
        return (f"SELECT {group}, {', '.join(aggs)} FROM testTable"
                f"{where} GROUP BY {group} ORDER BY {group} LIMIT 200")
    return f"SELECT {', '.join(aggs)} FROM testTable{where}"


def test_merged_rows_bit_identical_to_the_host_fold(segs):
    """25 seeded shapes: under float64 over integer columns every
    aggregate is exact, so the merged row and the merge-off per-segment
    launch with the host fold agree bit for bit."""
    _jsegs, tsegs = segs
    on = _port_exec(tsegs, 8, 2, True)
    off = _port_exec(tsegs, 8, 2, True,
                     **{"pinot.server.mesh.collective.merge": False})
    rng = np.random.default_rng(2024)
    for _ in range(25):
        sql = _random_sql(rng)
        assert on.execute(sql).rows == off.execute(sql).rows, sql
    assert on.engine.meter("mesh_merge_served") == 25


# ---------------------------------------------------------------------------
# the modes a mesh engine shards, refuses, or routes elsewhere
# ---------------------------------------------------------------------------

def _port_table(tmp, name, columns, fields, **indexing):
    tcfg = TableConfig(name)
    for k, v in indexing.items():
        setattr(tcfg.indexing, k, v)
    out = str(tmp / name)
    SegmentCreator(tcfg, Schema(name, fields)).build(columns, out, name)
    return load_segment(out)


@pytest.fixture(scope="module")
def upsert_segs(segs):
    """The synthetic table with a third of each segment's docs superseded:
    the validity mask shards like any column."""
    from pinot_tpu.segment.bitmap import Bitmap as JBitmap
    from pinot_tpu_torch.segment.bitmap import Bitmap
    jsegs, tsegs = segs
    rng = np.random.default_rng(77)
    for js, ts in zip(jsegs, tsegs):
        keep = np.nonzero(rng.random(js.num_docs) < 0.66)[0]
        js.valid_doc_ids = JBitmap.from_indices(js.num_docs, keep.tolist())
        ts.valid_doc_ids = Bitmap.from_indices(ts.num_docs, keep.tolist())
    yield jsegs, tsegs
    for js, ts in zip(jsegs, tsegs):
        js.valid_doc_ids = None
        ts.valid_doc_ids = None


@pytest.mark.parametrize("n,doc_axis", MESH_SHAPES[1:], ids=MESH_IDS[1:])
def test_upsert_table_on_a_mesh(upsert_segs, n, doc_axis):
    jsegs, tsegs = upsert_segs
    port = _port_exec(tsegs, n, doc_axis, True)
    host = JaxExecutor(jsegs, use_tpu=False)
    for sql in PARITY_SQLS[:4]:
        _rows_close(port.execute(sql).rows, host.execute(sql).rows)
    assert port.engine.meter("mesh_merge_served") == 4


def test_startree_fit_takes_the_scan_leg_on_a_doc_sharded_mesh(tmp_path):
    """A doc-sharded mesh answers a fitting star-tree query on the scan leg
    (JAX `_startree_candidate` :674); a segments-only mesh answers it from
    the trees, K5 per slot, equal to its own scan."""
    rng = np.random.default_rng(5)
    fields = [FieldSpec("a", DataType.INT),
              FieldSpec("m", DataType.INT, FieldType.METRIC)]
    segs_ = []
    for i in range(3):
        n = 300 + 50 * i
        cols = {"a": rng.integers(0, 7, n).astype(np.int32),
                "m": rng.integers(0, 100, n).astype(np.int32)}
        segs_.append((cols, _port_table(
            tmp_path, f"st{i}", cols, fields,
            star_tree_configs=[StarTreeIndexConfig(["a"], [], ["SUM__m"])])))
    segments = [s for _c, s in segs_]
    sql = "SELECT SUM(m) FROM st0 WHERE a = 3"
    want = float(sum(c["m"][c["a"] == 3].sum() for c, _s in segs_))
    doc = QueryExecutor(segments, device="cpu", value_dtype=torch.float64,
                        mesh=make_mesh(["cpu"] * 4, doc_axis=2))
    assert doc.execute(sql).rows == [(want,)]
    assert doc.engine.meter("startree_served") == 0
    assert doc.engine.meter("mesh_merge_served") == 1
    seg_only = QueryExecutor(segments, device="cpu",
                             value_dtype=torch.float64,
                             mesh=make_mesh(["cpu"] * 2, doc_axis=1))
    assert seg_only.execute(sql).rows == [(want,)]
    assert seg_only.engine.meter("startree_served") == 1
    assert seg_only.engine.meter("mesh_refused", "startree") == 0
    assert seg_only.execute(
        "SELECT SUM(m) FROM st0 WHERE a = 3 OPTION(useStarTree=false)"
    ).rows == [(want,)]


@pytest.mark.parametrize("sql,mode", [
    ("SELECT intCol FROM testTable ORDER BY intCol LIMIT 5", "topn"),
    ("SELECT intCol FROM testTable WHERE intCol > 5 LIMIT 5", "topn"),
])
@pytest.mark.parametrize("doc_axis", [1, 2])
def test_selection_is_refused_on_a_mesh(segs, sql, mode, doc_axis):
    """Refused, reason 'mesh', on a doc-sharded mesh (a top-N across doc
    shards is JAX's host path, :1446); served per slot on a segments-only
    mesh, equal row for row to the one-device engine."""
    _jsegs, tsegs = segs
    port = _port_exec(tsegs, 4, doc_axis, True)
    if doc_axis == 1:
        one = QueryExecutor(tsegs, device="cpu", value_dtype=torch.float64)
        assert port.execute(sql).rows == one.execute(sql).rows
        assert port.engine.meter("mesh_refused", mode) == 0
        return
    with pytest.raises(NotOffloadable) as e:
        port.execute(sql)
    assert e.value.reason == "mesh"
    assert "doc-sharded" in str(e.value)
    assert port.engine.meter("mesh_refused", mode) == 1


def test_distinct_runs_on_a_mesh(segs):
    """DISTINCT rides the sharded group-by (the JAX engine runs it as a
    grouped aggregation on a mesh), per segment, never merged."""
    jsegs, tsegs = segs
    sql = "SELECT DISTINCT stringCol, groupCol FROM testTable " \
          "ORDER BY stringCol, groupCol LIMIT 1000"
    port = _port_exec(tsegs, 8, 2, True)
    want = JaxExecutor(jsegs, use_tpu=False).execute(sql).rows
    assert [tuple(r) for r in port.execute(sql).rows] == \
        [tuple(r) for r in want]
    assert port.engine.meter("mesh_merge_served") == 0


def test_filtered_doc_ids_refused_on_a_mesh(segs):
    _jsegs, tsegs = segs
    port = _port_exec(tsegs, 4, 2, True)
    where = QueryContext.from_sql(
        "SELECT COUNT(*) FROM testTable WHERE intCol > 990").filter
    with pytest.raises(NotOffloadable, match="doc-sharded") as e:
        port.engine.filtered_doc_ids(tsegs, where)
    assert e.value.reason == "mesh"


def test_vector_search_refused_on_a_mesh(tmp_path):
    """JAX's 'staging' fallback on a doc-sharded mesh; K8 per slot on a
    segments-only mesh, equal to the one-device engine."""
    rng = np.random.default_rng(3)
    n = 200
    v = rng.normal(0, 1, (n, 8)).astype(np.float32)
    seg = _port_table(
        tmp_path, "emb", {"id": np.arange(n, dtype=np.int32),
                          "vec": np.array(["[" + ", ".join(
                              f"{x:.6f}" for x in r) + "]" for r in v],
                              object)},
        [FieldSpec("id", DataType.INT), FieldSpec("vec", DataType.STRING)],
        vector_index_columns=["vec"])
    q = "[" + ", ".join("0.1" for _ in range(8)) + "]"
    sql = f"SELECT id FROM emb WHERE vector_similarity(vec, '{q}', 5) LIMIT 5"
    doc = QueryExecutor([seg], device="cpu",
                        mesh=make_mesh(["cpu"] * 2, doc_axis=2))
    with pytest.raises(NotOffloadable) as e:
        doc.execute(sql)
    assert e.value.reason == "staging"
    assert doc.engine.meter("vector_fallback", "staging") == 1
    seg_only = QueryExecutor([seg], device="cpu",
                             mesh=make_mesh(["cpu"] * 2, doc_axis=1))
    one = QueryExecutor([seg], device="cpu")
    assert seg_only.execute(sql).rows == one.execute(sql).rows
    assert seg_only.engine.meter("vector_served") == 1
    assert seg_only.engine.meter("mesh_refused", "vector") == 0


def test_clp_leaf_refused_on_a_mesh(tmp_path):
    """A CLP leaf is served on any mesh (JAX evaluates it inside every
    kernel, kernels.py:180-183): K7 per slot on its shard, then K1, equal
    to the one-device engine; sharded (2x1) and merged (1x2)."""
    msgs = [f"task {i % 7} finished in {i} ms" for i in range(300)]
    seg = _port_table(
        tmp_path, "logs", {"ts": np.arange(300, dtype=np.int64),
                           "message": msgs},
        [FieldSpec("ts", DataType.LONG, FieldType.DATE_TIME),
         FieldSpec("message", DataType.STRING)], clp_columns=["message"])
    sql = "SELECT COUNT(*) FROM logs WHERE message LIKE 'task 3 %'"
    for doc_axis in (1, 2):
        ex = QueryExecutor([seg], device="cpu",
                           mesh=make_mesh(["cpu"] * 2, doc_axis=doc_axis))
        assert ex.execute(sql).rows == [(43,)]
        assert ex.engine.meter("clp_served") == 1
        assert ex.engine.meter("mesh_refused", "clp") == 0
    assert QueryExecutor([seg], device="cpu").execute(sql).rows == [(43,)]


def test_time_bucket_routing_is_pinned(tmp_path):
    """The fused time bucket follows the JAX routing: refused (reason
    'mesh') on an explicit mesh, whose JAX engine hands it to the host;
    served through the sharded K2 on a devices= segments-only mesh."""
    rng = np.random.default_rng(8)
    fields = [FieldSpec("ts", DataType.LONG, FieldType.DATE_TIME),
              FieldSpec("h", DataType.INT),
              FieldSpec("v", DataType.DOUBLE, FieldType.METRIC)]
    segments, frames = [], []
    for i in range(3):
        n = 400
        cols = {"ts": np.sort(rng.integers(0, 1000, n)).astype(np.int64),
                "h": rng.integers(0, 3, n).astype(np.int32),
                "v": rng.uniform(0, 10, n)}
        frames.append(cols)
        segments.append(_port_table(tmp_path, f"ts{i}", cols, fields))
    sql = ("SELECT FLOOR((ts - 0) / 100), h, SUM(v) FROM ts0 "
           "WHERE ts >= 0 AND ts < 1000 GROUP BY FLOOR((ts - 0) / 100), h "
           "ORDER BY FLOOR((ts - 0) / 100), h LIMIT 1000")
    one = QueryExecutor(segments, device="cpu", value_dtype=torch.float64)
    want = one.execute(sql).rows
    explicit = QueryExecutor(segments, device="cpu",
                             value_dtype=torch.float64,
                             mesh=make_mesh(["cpu"] * 2, doc_axis=1))
    with pytest.raises(NotOffloadable) as e:
        explicit.execute(sql)
    assert e.value.reason == "mesh"
    assert explicit.engine.meter("mesh_refused", "tbucket") == 1
    eng = TorchOperatorExecutor(value_dtype=torch.float64,
                                devices=["cpu"] * 3)
    got = eng.execute(segments, QueryContext.from_sql(sql))
    from pinot_tpu_torch.query.reduce import reduce_results
    rows = reduce_results(QueryContext.from_sql(sql), got).rows
    _rows_close(rows, want)
    assert eng.meter("timeseries_leaf_device") == 1
    assert eng.meter("mesh_merge_served") == 0


# ---------------------------------------------------------------------------
# device policy
# ---------------------------------------------------------------------------

def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchOperatorExecutor(devices=["cuda:0", "cuda:0"])


def test_mesh_device_policy():
    with pytest.raises(ValueError, match="mixes"):
        make_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(["cpu"] * 6, doc_axis=4)
    mesh = make_mesh(["cpu"] * 8, doc_axis=2)
    assert mesh.shape == (4, 2) and mesh.axis_names == ("segments", "docs")
    assert mesh == make_mesh(["cpu"] * 8, doc_axis=2) != \
        make_mesh(["cpu"] * 8, doc_axis=4)
    with pytest.raises(ValueError, match="lead device"):
        TorchOperatorExecutor(device="cuda", mesh=mesh)
    eng = TorchOperatorExecutor(mesh=mesh)
    assert eng.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not both"):
        TorchOperatorExecutor(mesh=mesh, devices=["cpu"])


def test_blocks_shard_per_slot_and_cache_the_shards(segs):
    _jsegs, tsegs = segs
    port = _port_exec(tsegs, 8, 2, True)
    port.execute(PARITY_SQLS[0])
    blocks = [b for _segs, b in port.engine._blocks.values()]
    assert blocks and all(len(b.shards) == 8 for b in blocks)
    S_, D_ = blocks[0].shape
    assert S_ % 4 == 0 and D_ % 2 == 0
    assert all(t.shape == (S_ // 4, D_ // 2) and t.is_contiguous()
               for b in blocks for t in b.shards)
    misses = port.engine._cached
    port.execute(PARITY_SQLS[0])
    assert port.engine._cached == misses


def test_mesh_fold_cuda_wrapper_refuses_cpu_tensors():
    fold = tk.doc_fold(1, 2, 1, 1, 2, (0, 1))
    from pinot_tpu_torch.ops import _cuda
    with pytest.raises(ValueError, match="CUDA kernel"):
        _cuda.mesh_fold([torch.zeros(1, 1, 2)] * 2, fold)
