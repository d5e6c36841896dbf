"""K1 scan_agg, K2 group_agg, K3 sketch_agg, K4 topn, K5 startree_agg, K6
row_assemble, K7 clp_match, K8 vector_topk and K9 mesh_fold on the card
against their plain PyTorch versions, over the seeded random plans and
inputs of tests/torch_plans.py; the query axis (B members over U column
sets) against the plain batched version and each member's own single
launch; 8 threads through one engine; the sharded and merged kernels,
a mesh engine and the sharded query step on a logical 4x2 mesh over
cuda:0 against the same calls on CPU tensors; K2 with compact keys (the
gkey block at the launch's G: in its warp tier, past it and at the 2^20
cap, B = 1 and 8, with the validity mask), K9 through a compact remap,
and wide GROUP BY / DISTINCT SQL on the card alone and on the mesh
against the CPU engine; and K2 at each table tier's edge, every doc on
one key and the bucket under the mask, counts and min / max bit for bit
(+-0.0 and NaN included), and K4's compacting select at ties across
blocks, filters keeping k, no or every doc, and B = 8 stacked; K1's
tiles at their edges (ragged, one-doc and empty segments, every id dtype
and LUT path, f32 / f64 and vrange64 leaves, the validity mask and K7's
mask leaf inside a tile, all and no docs kept, 16 members in groups, a
plan at program.py's limits together, which takes a narrower block; a
first launch in a fresh process between 48 KB less its static arrays
and 48 KB of shared memory) and
K7 at the edges of its logtype lookup (a logtype no group names, 64
groups on one logtype, padding groups, ids past cp and negative, Kd / Ke
at 0 and 16, dict-var ids past a table of 4 entries read through its
packed row), in full 16-byte tiles and scalar ones; K3 on config #4's
plan (its tile loaders and its kept lists, B = 8 members equal to their
single launches), log2m 16 on chip, several log2m-16 slots reaching the
global tier, every doc on one register; K5 at the star-tree leg's shapes
running one device kernel a call (counted in a torch.profiler trace).

These tests need an NVIDIA card and nvcc; elsewhere they skip. On the card
they run without the repo's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: counts, exact-sum planes, min/max, HLL registers and
histogram buckets bit-identical (both sides round every float operation
once, in the same order: the kernels are built with --fmad=false), K4's
whole [S, 1 + k] output bit-identical, K5's record counts, exact-sum
planes and min / max bit-identical; float32
sums within 1e-5 and float64 within 1e-9 of the slot's sum of
|contribution| (both add in double, in other orders). A batched member
equals its single launch bit for bit where the kernel reduces in a fixed
order (K1, K3, K4, K5 flat); K2's and grouped K5's float sums, which take
the atomics' order, within the same tolerance. K6's block is its plain
version's bit for bit (it copies bytes). K8's whole [S, 1 + 2 kk] output,
scores included, bit-identical to its plain version on the card and on
the CPU (the plain version adds in K8's order), and within
torch_plans.VEC_TOL of the float64 truth. K9's output bit-identical to
its plain version (both fold each list in double, in list order or, for
a tail past MeshFold.LONG_LIST entries, in the same lane order).
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pinot_tpu_torch.ops import _cuda, clp_device
from pinot_tpu_torch.ops import program as prog_mod
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import startree_device as tsd
from pinot_tpu_torch.ops import vector_device as tvd
from pinot_tpu_torch.ops.plan_ir import DevicePlan

# by path: on the card's machine another installed 'tests' package can
# shadow this repo's, and this file runs there without the repo's conftest
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
import chip_smoke as cs  # noqa: E402
import torch_plans as tp  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


CASES = [(seed, grouped) for seed in range(12) for grouped in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,grouped", CASES)
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_kernel_matches_plain_on_card(card, seed, grouped, x64):
    S, D = 6, 3000 + 37 * seed   # ragged D: partial blocks and tiles
    spec = tp.random_spec(seed, grouped)
    plan = DevicePlan(**spec)
    vdt = torch.float64 if x64 else torch.float32
    cols, params, nd = tp.random_inputs(seed, spec, S, D,
                                        np.float64 if x64 else np.float32,
                                        nan=seed % 4 == 0, pad_segments=2)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    launches = (_cuda.SCAN_AGG.launches, _cuda.GROUP_AGG.launches)
    out = tk.make_kernel(plan, vdt)(tc, tpar, tnd, D)
    ref = tk.plain_kernel(plan, vdt)(tc, tpar, tnd, D)
    torch.cuda.synchronize()
    after = (_cuda.SCAN_AGG.launches, _cuda.GROUP_AGG.launches)
    assert after[int(grouped)] == launches[int(grouped)] + 1
    scale = {j: v.cpu().numpy()
             for j, v in tk.abs_contributions(plan, tc, tpar, tnd, D).items()}
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(),
                           scale, x64)


@pytest.mark.cuda
def test_large_group_space_uses_global_table(card):
    """G x slots beyond the shared-memory table: K2's global-atomics path."""
    spec = tp.random_spec(3, grouped=True)
    spec.update(group_cols=("a", "c"), group_strides=(5000, 1),
                num_groups=500_000)
    plan = DevicePlan(**spec)
    cols, params, nd = tp.random_inputs(3, spec, 3, 20_000, np.float32)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    out = tk.make_kernel(plan, torch.float32)(tc, tpar, tnd, 20_000)
    ref = tk.plain_kernel(plan, torch.float32)(tc, tpar, tnd, 20_000)
    scale = {j: v.cpu().numpy()
             for j, v in tk.abs_contributions(plan, tc, tpar, tnd, 20_000).items()}
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(),
                           scale, x64=False)


def _sketch_case(card, spec, x64, S, D, seed):
    plan = DevicePlan(**spec)
    vdt = torch.float64 if x64 else torch.float32
    cols, params, nd = tp.sketch_inputs(seed, spec, S, D,
                                        np.float64 if x64 else np.float32,
                                        pad_segments=2)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    scalar = not all(tk.is_sketch(op) for op, _v, _f in spec["agg_ops"])
    before = (_cuda.SCAN_AGG.launches, _cuda.SKETCH_AGG.launches)
    out = tk.make_kernel(plan, vdt)(tc, tpar, tnd, D)
    ref = tk.plain_kernel(plan, vdt)(tc, tpar, tnd, D)
    torch.cuda.synchronize()
    after = (_cuda.SCAN_AGG.launches, _cuda.SKETCH_AGG.launches)
    assert after == (before[0] + int(scalar), before[1] + 1)
    scale = {j: v.cpu().numpy()
             for j, v in tk.abs_contributions(plan, tc, tpar, tnd, D).items()}
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(),
                           scale, x64)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_sketch_kernel_matches_plain_on_card(card, seed, x64):
    """K3 alone (odd seeds) and K1 + K3 into one output (even seeds)."""
    spec = tp.random_sketch_spec(seed, scalar=seed % 2 == 0)
    _sketch_case(card, spec, x64, 6, 3000 + 37 * seed, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_sketch_kernel_log2m16_beside_log2m12_on_chip(card, x64):
    """log2m 16 (64 KB of byte registers) beside log2m 12 and the
    histogram, all three tables in K3's shared memory."""
    spec = tp.random_sketch_spec(21, log2ms=(12, 16), scalar=False)
    assert all(tp.code_at(prog_mod.compile_plan(DevicePlan(**spec)).code,
                          prog_mod.H_SLOT, j, prog_mod.SLOT_W)[3] >= 0
               for j in range(len(spec["agg_ops"])))
    _sketch_case(card, spec, x64, 5, 70_000, 21)


@pytest.mark.cuda
@pytest.mark.parametrize("log2ms", [(16, 16), (16, 16, 16)],
                         ids=["two", "three"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_sketch_kernel_global_tier_several_log2m16(card, log2ms, x64):
    """Several log2m-16 HLLs do not fit K3's shared memory together: the
    first on chip, the others in the global table, read before raised."""
    spec = tp.random_sketch_spec(23, log2ms=log2ms, scalar=False)
    rows = [tp.code_at(prog_mod.compile_plan(DevicePlan(**spec)).code,
                       prog_mod.H_SLOT, j, prog_mod.SLOT_W)
            for j in range(len(spec["agg_ops"]))]
    assert [r[3] < 0 for r in rows if r[0] == prog_mod.S_HLL] \
        == [False] + [True] * (len(log2ms) - 1)
    _sketch_case(card, spec, x64, 5, 70_000, 23)


def _q4_spec(log2m: int = 12) -> dict:
    """Config #4's plan shape: DISTINCTCOUNTHLL and an 8192-bucket
    histogram, no filter."""
    return dict(filter_ir=None, leaves=(), value_irs=(("col", "x"),),
                agg_ops=((f"hll:{log2m}:t", None, None),
                         ("hist:8192", 0, None)),
                agg_filter_irs=(), raw64_cols=("t",))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1 << 16, 70_003, 1 << 20],
                         ids=["full tiles", "ragged", "many blocks"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_sketch_kernel_q4_plan_unfiltered_on_card(card, D, x64):
    """K3 on Q4's plan shape (log2m 12 and 8192 buckets, no filter): every
    doc kept, full tiles read through the tile loaders (float32), ragged
    ones and float64 values through the kept lists."""
    _sketch_case(card, _q4_spec(), x64, 4, D, 31)


@pytest.mark.cuda
@pytest.mark.parametrize("word", [False, True], ids=["one register",
                                                     "one word"])
@pytest.mark.parametrize("filtered", [False, True])
def test_sketch_kernel_every_doc_on_one_register(card, word, filtered):
    """A column whose every doc hashes to one register (or to the four
    registers of one 32-bit word), their ranks spread: every lane of a
    warp raising one register's cached byte and its global word at once,
    the worst case for K3's raises."""
    spec = _q4_spec(12) if not filtered else tp.random_sketch_spec(
        8, scalar=False)
    assert not filtered or spec["filter_ir"] is not None
    S, D = 4, 1 << 17
    cols, params, nd = tp.sketch_inputs(9, spec, S, D, np.float32)
    rng = np.random.default_rng(9)
    cand = rng.integers(-(1 << 54), 1 << 54, 1 << 22, dtype=np.int64)
    h1, _h2 = tk.hash32_pair(torch.from_numpy((cand >> 24).astype(np.int32)),
                             torch.from_numpy((cand & 0xFFFFFF).astype(
                                 np.int32)))
    want = 0xFFC if word else 0xFFF
    pick = cand[(h1.numpy() & want) == 0]
    assert len(pick) >= 64
    t = rng.choice(pick, (S, D))
    cols["valhi:t"] = (t >> 24).astype(np.int32)
    cols["vallo:t"] = (t & 0xFFFFFF).astype(np.int32)
    plan = DevicePlan(**spec)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    out = tk.make_kernel(plan, torch.float32)(tc, tpar, tnd, D)
    ref = tk.plain_kernel(plan, torch.float32)(tc, tpar, tnd, D)
    torch.cuda.synchronize()
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(), {},
                           False)
    regs = out[:, 1:1 + 4096].cpu().numpy()
    assert (regs[:, (4 if word else 1):] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1 << 16, 70_003], ids=["full", "ragged"])
def test_sketch_kernel_q4_batch_equals_single_launches(card, D):
    """B = 8 members of Q4's plan over one column set and over eight, each
    bit for bit its own single launch (counts, registers and buckets are
    integers: exact whatever the grid)."""
    spec = _q4_spec()
    plan = DevicePlan(**spec)
    S = 4
    sets = [tk.from_jax_staged(*tp.sketch_inputs(40 + u, spec, S, D,
                                                 np.float32), device=card)
            for u in range(8)]
    for idx in ([0] * 8, list(range(8))):
        U = max(idx) + 1
        cols = [c for c, _p, _n in sets[:U]]
        plist = [sets[m][1] for m in range(8)]
        nds = [n for _c, _p, n in sets[:U]]
        out = tk.batched_kernel(plan, torch.float32)(cols, plist, nds, idx,
                                                     D)
        for m, u in enumerate(idx):
            single = tk.make_kernel(plan, torch.float32)(cols[u], plist[m],
                                                         nds[u], D)
            assert torch.equal(out[m], single), (idx, m)


TOPN_CASES = [(seed, order, asc, k)
              for seed, (asc, k) in enumerate([(False, 10), (True, 1000),
                                               (True, 8192)])
              for order in tp.TOPN_ORDERS]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,order,asc,k", TOPN_CASES)
@pytest.mark.parametrize("D", [20_000, 100_003])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_topn_kernel_matches_plain_on_card(card, seed, order, asc, k, D,
                                           x64):
    """K4 at chip_smoke's phase-3 case shapes (k = 10, 1000, 8192; raw,
    ids, expression and no order value; ASC and DESC), D reduced: several
    blocks per segment, so tie ranks cross blocks; dense ties, NaN, +-inf
    and +-0.0 among the order values; two padded segments."""
    spec = tp.topn_spec(seed, order, asc, k)
    vdt = torch.float64 if x64 else torch.float32
    cols, params, nd = tp.topn_inputs(seed, spec, 5, D,
                                      np.float64 if x64 else np.float32,
                                      pad_segments=2)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    plan = DevicePlan(**spec)
    before = _cuda.TOPN.launches
    out = tk.make_topn_kernel(plan, vdt)(tc, tpar, tnd, D)
    ref = tk.topn_kernel(plan, tc, tpar, tnd, D, vdt)
    torch.cuda.synchronize()
    assert _cuda.TOPN.launches == before + 1
    assert out.shape == ref.shape == (5, 1 + k)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_topn_kernel_all_ties_no_filter(card, x64):
    """Every doc ties: the winners are the lowest docs, in doc order."""
    vdt = torch.float64 if x64 else torch.float32
    spec = tp.topn_spec(0, "col", False, 4096, filtered=False)
    S, D = 3, 50_000
    cols = {"val:x": torch.zeros((S, D), dtype=vdt, device=card)}
    nd = torch.tensor([D, 4000, 0], dtype=torch.int32, device=card)
    out = tk.make_topn_kernel(DevicePlan(**spec), vdt)(cols, {}, nd, D)
    ref = tk.topn_kernel(DevicePlan(**spec), cols, {}, nd, D, vdt)
    assert torch.equal(out, ref)
    assert out[0, 1:].tolist() == list(range(4096))
    assert out[1, 0] == 4000 and out[1, 4001] == -1


@pytest.mark.cuda
@pytest.mark.parametrize("group", list(tp.ST_GROUPS))
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_startree_kernel_matches_plain_on_card(card, group, seed, x64):
    """K5 flat, grouped with its table in shared memory (G = 35) and in
    global memory (G = 16384), over several blocks per segment, a ragged
    and a padded segment, and contiguous selected runs."""
    fields = tp.startree_spec(group)
    S, D = 5, 70_003 + 1000 * seed
    vdt = torch.float64 if x64 else torch.float32
    cols, params, nd = tp.startree_inputs(seed, fields, S, D,
                                          np.float64 if x64 else np.float32)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    plan = tsd.StarTreePlan(**fields)
    before = _cuda.STARTREE_AGG.launches
    out = tsd.make_startree_kernel(plan, vdt)(tc, tpar, tnd, D)
    ref = tsd.startree_kernel(plan, tc, tpar, tnd, D, value_dtype=vdt)
    torch.cuda.synchronize()
    assert _cuda.STARTREE_AGG.launches == before + 1
    tp.assert_startree_equal(fields, out.cpu().numpy(), ref.cpu().numpy(),
                             tp.startree_abs_sums(fields, cols, params, nd,
                                                  D),
                             tp.F64_TOL if x64 else tp.F32_SUM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,D", [((("a", 7),), 128), ((), 2048),
                                    ((("a", 6),), 2048),
                                    ((("a", 7), ("b", 5)), 128)],
                         ids=["G=7 D=128", "flat D=2048", "G=6 D=2048",
                              "G=35 D=128"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_startree_kernel_one_block_per_segment_on_card(card, dims, D, x64):
    """K5 at the star-tree leg's own shapes: S = 8 segments of at most
    D = 128 or 2048 pre-agg records, one block per segment and, at 128,
    fewer records than a block has threads (config #5's tree grouped by
    d_year, G = 7; bench.py's tree flat and grouped by browser, G = 6)."""
    fields = tp.startree_spec("flat", dims)
    S = 8
    vdt = torch.float64 if x64 else torch.float32
    cols, params, nd = tp.startree_inputs(D, fields, S, D,
                                          np.float64 if x64 else np.float32)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    plan = tsd.StarTreePlan(**fields)
    before = _cuda.STARTREE_AGG.launches
    out = tsd.make_startree_kernel(plan, vdt)(tc, tpar, tnd, D)
    ref = tsd.startree_kernel(plan, tc, tpar, tnd, D, value_dtype=vdt)
    torch.cuda.synchronize()
    assert _cuda.STARTREE_AGG.launches == before + 1
    tp.assert_startree_equal(fields, out.cpu().numpy(), ref.cpu().numpy(),
                             tp.startree_abs_sums(fields, cols, params, nd,
                                                  D),
                             tp.F64_TOL if x64 else tp.F32_SUM_TOL)


def _device_kernels(fn, n: int, tmp_path) -> list:
    """The names of the device kernels, copies and sets that n calls of fn
    ran, from a torch.profiler trace (taken once more where the profiler
    dropped every device event)."""
    import json
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        path = tmp_path / f"trace{attempt}.json"
        prof.export_chrome_trace(str(path))
        names = [e.get("name", "") for e in
                 json.loads(path.read_text()).get("traceEvents", [])
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if names:
            return names
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("dims,D", [((("a", 7),), 128), ((), 2048),
                                    ((("a", 6),), 2048),
                                    ((("a", 7), ("b", 5)), 128)],
                         ids=["G=7 D=128", "flat D=2048", "G=6 D=2048",
                              "G=35 D=128"])
@pytest.mark.parametrize("B", [1, 8])
def test_startree_one_device_kernel_per_call_on_card(card, dims, D, B,
                                                     tmp_path):
    """K5 at the star-tree leg's shapes (a block a segment, flat or its
    table in shared memory) runs one device kernel a call, no memset and
    no second pass, single and with B = 8 members; counted in a
    torch.profiler trace."""
    fields = tp.startree_spec("flat", dims)
    S = 8
    cols, params, nd = tp.startree_inputs(D, fields, S, D, np.float32)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    plan = tsd.StarTreePlan(**fields)
    if B == 1:
        kern = tsd.make_startree_kernel(plan, torch.float32)
        fn = lambda: kern(tc, tpar, tnd, D)  # noqa: E731
    else:
        run = tsd.batched_kernel(plan, torch.float32)
        fn = lambda: run([tc], [tpar] * B, [tnd], [0] * B, D)  # noqa: E731
    names = [n for _a, _b, n in cs.traced_calls(fn, 5, str(tmp_path))]
    assert len(names) == 5, names
    assert all(n.removeprefix("void ").startswith("startree_")
               for n in names), names


BATCH_KERNELS = {"scan": _cuda.SCAN_AGG, "group": _cuda.GROUP_AGG,
                 "sketch": _cuda.SKETCH_AGG, "topn": _cuda.TOPN}
BATCH_CASES = [(kind, B, form) for kind in BATCH_KERNELS for B in (2, 8)
               for form in ("broadcast", "stacked", "dedup")]


def _batch_inputs(card, kind, B, form, x64):
    """B members (each its own literal set) over U column sets (each its
    own data), two padded segments: (plan, spec, col_sets, plist, ndlist,
    idx, D, value dtype)."""
    seed = 5
    spec = {"scan": lambda: tp.random_spec(seed, False),
            "group": lambda: tp.random_spec(seed, True),
            "sketch": lambda: tp.random_sketch_spec(seed),
            "topn": lambda: tp.topn_spec(seed, "col", False, 100)}[kind]()
    inputs = {"sketch": tp.sketch_inputs,
              "topn": tp.topn_inputs}.get(kind, tp.random_inputs)
    U = {"broadcast": 1, "stacked": B, "dedup": max(2, B // 2 - 1)}[form]
    idx = [0] * B if form == "broadcast" else \
        list(range(B)) if form == "stacked" else \
        [(m + 1) % U for m in range(B)]
    S, D = 6, 5000 + 37 * B
    vnp = np.float64 if x64 else np.float32
    sets = [tk.from_jax_staged(*inputs(seed + 101 * u, spec, S, D, vnp,
                                       pad_segments=2), device=card)
            for u in range(U)]
    plist = [tk.from_jax_staged(*inputs(seed + 7 * m + 3, spec, S, D, vnp,
                                        pad_segments=2), device=card)[1]
             for m in range(B)]
    return (DevicePlan(**spec), spec, [c for c, _p, _n in sets], plist,
            [n for _c, _p, n in sets], idx, D,
            torch.float64 if x64 else torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,form", BATCH_CASES)
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_batched_kernel_matches_plain_and_single_on_card(card, kind, B,
                                                         form, x64):
    """One launch of K1-K4 with B members, broadcast (U = 1), stacked
    (U = B) or dedup (U < B): each member against the plain batched
    version and its own single launch, the launch counted as batched."""
    plan, spec, sets, plist, nds, idx, D, vdt = _batch_inputs(
        card, kind, B, form, x64)
    kern = BATCH_KERNELS[kind]
    before = (kern.launches, kern.batched_launches, kern.batched_members)
    out = tk.batched_kernel(plan, vdt)(sets, plist, nds, idx, D)
    ref = tk.plain_batched_kernel(plan, vdt)(sets, plist, nds, idx, D)
    torch.cuda.synchronize()
    assert (kern.launches, kern.batched_launches, kern.batched_members) \
        == (before[0], before[1] + 1, before[2] + B)
    assert out.shape == ref.shape and out.shape[0] == B
    single_of = tk.make_topn_kernel(plan, vdt) if kind == "topn" \
        else tk.make_kernel(plan, vdt)
    for m, u in enumerate(idx):
        single = single_of(sets[u], plist[m], nds[u], D)
        if kind == "topn":
            assert torch.equal(out[m], ref[m]), m
            assert torch.equal(out[m], single), m
            continue
        scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
            plan, sets[u], plist[m], nds[u], D).items()}
        got = out[m].cpu().numpy()
        tp.assert_packed_equal(spec, ref[m].cpu().numpy(), got, scale, x64)
        tp.assert_packed_equal(spec, single.cpu().numpy(), got, scale, x64)
        if kind != "group":
            assert np.array_equal(got, single.cpu().numpy(), equal_nan=True)


@pytest.mark.cuda
def test_first_scan_launch_in_a_process_on_card(card):
    """K1's first launch in a fresh process, B = 2 broadcast members of
    random_sketch_spec(5) in float32: its dynamic shared memory is past 48
    KB less the kernel's static arrays and within 48 KB, so it runs only
    where K1 raised its limit before the launch. Run as the first launch
    of its own process (in this file's run an earlier test has raised the
    limit already), and held to the plain version and its single
    launches as the batched test holds it."""
    import subprocess
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_cuda as t; "
            "t.test_batched_kernel_matches_plain_and_single_on_card("
            "torch.device('cuda'), 'sketch', 2, 'broadcast', False); "
            "print('K1 batched launches', t._cuda.SCAN_AGG.batched_launches)")
    r = subprocess.run([sys.executable, "-c", code, HERE], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1] == "K1 batched launches 1", \
        r.stdout


@pytest.mark.cuda
def test_eight_threads_through_one_engine_on_card(card, tmp_path):
    """8 threads through one engine: every answer equals the serial run's,
    and the launch counters sum exactly to the dispatches the ring made
    (single launches one each, batched ones exactly their members)."""
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, TableConfig)
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.segment.creator import SegmentCreator
    from pinot_tpu_torch.segment.loader import load_segment
    tc = TableConfig("t")
    tc.indexing.no_dictionary_columns = ["m"]
    creator = SegmentCreator(tc, Schema("t", [
        FieldSpec("d", DataType.INT),
        FieldSpec("m", DataType.INT, FieldType.METRIC)]))
    rng = np.random.default_rng(3)
    segs = []
    for i in range(4):
        out = str(tmp_path / f"s{i}")
        creator.build({"d": rng.integers(0, 10, 200_000).astype(np.int32),
                       "m": rng.integers(0, 100, 200_000).astype(np.int32)},
                      out, f"s{i}")
        segs.append(load_segment(out))
    ex = QueryExecutor(segs)
    agg = [f"SELECT SUM(m), COUNT(*), MAX(m) FROM t WHERE d < {k}"
           for k in range(1, 9)]
    top = [f"SELECT d, m FROM t WHERE d = {k} ORDER BY m DESC LIMIT 5"
           for k in range(8)]
    serial = {q: ex.execute(q).rows for q in agg + top}
    disp = ex.engine.dispatcher
    for queries, kern in ((agg, _cuda.SCAN_AGG), (top, _cuda.TOPN)):
        jobs = queries * 4
        stats0 = disp.stats()
        c0 = (kern.launches, kern.batched_launches, kern.batched_members)
        with ThreadPoolExecutor(8) as pool:
            rows = list(pool.map(lambda q: ex.execute(q).rows, jobs,
                                 timeout=300))
        assert rows == [serial[q] for q in jobs]
        stats = disp.stats()
        stats.subtract(stats0)
        sizes = {k[1]: v for k, v in stats.items()
                 if isinstance(k, tuple) and v}
        assert sum(n * c for n, c in sizes.items()) == len(jobs)
        singles = kern.launches - c0[0]
        assert singles == sizes.get(1, 0)
        assert kern.batched_launches - c0[1] == \
            sum(c for n, c in sizes.items() if n > 1)
        assert kern.batched_members - c0[2] == \
            sum(n * c for n, c in sizes.items() if n > 1)


@pytest.mark.cuda
def test_batched_wrapper_rejects_members_that_disagree(card):
    """Every member's tensors must share device, dtype and shape: a column
    set of another dtype or shape, or a parameter of another dtype,
    raises before anything launches."""
    plan, spec, sets, plist, nds, idx, D, vdt = _batch_inputs(
        card, "scan", 2, "stacked", False)
    before = _cuda.SCAN_AGG.batched_launches
    prog = prog_mod.compile_plan(plan)
    name = prog.cols[0]                                    # read by the plan
    key = next(k for k, _lit in prog.params if k)          # a [S] parameter
    for bad_sets, bad_params in (
            ([sets[0], {**sets[1], name: sets[1][name].double()}], plist),
            ([sets[0], {**sets[1], name: sets[1][name][:, :-1].contiguous()}],
             plist),
            (sets, [plist[0], {**plist[1], key: plist[1][key].double()}])):
        with pytest.raises(ValueError):
            _cuda.scan_agg_batched(plan, bad_sets, bad_params, nds, idx, D,
                                   vdt)
    assert _cuda.SCAN_AGG.batched_launches == before


ASSEMBLE_DTYPES = [torch.int8, torch.bool, torch.int32, torch.float32,
                   torch.float64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ASSEMBLE_DTYPES, ids=str)
@pytest.mark.parametrize("case", ["mixed", "full", "unaligned"])
def test_row_assemble_matches_plain_on_card(card, dtype, case):
    """K6 against its plain version, bit for bit: 13 rows of mixed
    power-of-two lengths into a block of 16 (three padded segments), every
    row full-length (the stack form), and rows whose start or length is
    not 16-byte aligned (the byte path)."""
    g = torch.Generator().manual_seed(7)
    S, D = 16, 4096
    if case == "mixed":
        lens = [4096, 128, 1024, 4096, 256, 2048, 128, 512, 4096, 1024,
                128, 256, 2048]
    elif case == "full":
        S, lens = 13, [D] * 13
    else:
        lens = [4093, 1, 130, 4096, 77]
    base = torch.randint(-100, 100, (sum(lens) + len(lens),),
                         generator=g).to(dtype).to(card)
    dev_rows, at = [], 0
    for n in lens:
        if case == "unaligned":  # an odd element offset: the byte path
            at += 1
            dev_rows.append(base[at:at + n])
        else:
            dev_rows.append(base[at:at + n].clone())
        at += n
    before = _cuda.ROW_ASSEMBLE.launches
    out = tk.assemble_rows(dev_rows, S, D)
    torch.cuda.synchronize()
    assert _cuda.ROW_ASSEMBLE.launches == before + 1
    ref = tk.row_assemble([r.cpu() for r in dev_rows], S, D)
    assert out.dtype == dtype and out.shape == (S, D)
    assert torch.equal(out.cpu().view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.cuda
def test_row_assemble_chunks_past_its_row_capacity(card):
    """More block rows than one launch carries: one launch per
    RA_MAX_ROWS rows, the same block."""
    S, D = _cuda.RA_MAX_ROWS + 5, 256
    rows = [torch.full((128 if s % 2 else 256,), s, dtype=torch.int32,
                       device=card) for s in range(S - 2)]
    before = _cuda.ROW_ASSEMBLE.launches
    out = tk.assemble_rows(rows, S, D)
    assert _cuda.ROW_ASSEMBLE.launches == before + 2
    assert torch.equal(out.cpu(), tk.row_assemble([r.cpu() for r in rows],
                                                   S, D))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["16-byte rows", "odd units",
                                  "wide odd units"])
def test_row_assemble_grid_edges_on_card(card, case):
    """K6's grid at its edges, bit for bit: 37 rows of 16 bytes (0-4
    float32 each, one thread's unit a row), and rows whose bytes are no
    multiple of a block's 4096 (256 threads x one 16-byte unit), so a
    row's last block is partly idle and rows end inside a unit's block: 7
    int32 rows of mixed lengths in a [9, 1000] block, and 5 float64 rows
    in a [6, 2^20 + 6] block."""
    g = torch.Generator().manual_seed(8)
    if case == "16-byte rows":
        S, D, dtype = 37, 4, torch.float32
        lens = [s % 5 for s in range(S)]
    elif case == "odd units":
        S, D, dtype = 9, 1000, torch.int32
        lens = [1000, 4, 996, 0, 1000, 512, 12]
    else:
        S, D, dtype = 6, (1 << 20) + 6, torch.float64
        lens = [D, 2, D - 2, 1 << 19, 1000]
    rows = [torch.randint(-1000, 1000, (n,), generator=g).to(dtype).to(card)
            for n in lens]
    out = tk.assemble_rows(rows, S, D)
    ref = tk.row_assemble([r.cpu() for r in rows], S, D)
    assert torch.equal(out.cpu().view(torch.uint8), ref.view(torch.uint8))


ST_BATCH_CASES = [(group, B, form) for group in tp.ST_GROUPS
                  for B in (2, 8) for form in ("broadcast", "stacked",
                                               "dedup")]


@pytest.mark.cuda
@pytest.mark.parametrize("group,B,form", ST_BATCH_CASES)
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_batched_startree_matches_plain_and_single_on_card(card, group, B,
                                                           form, x64):
    """K5 with B members over U column sets (broadcast U = 1, stacked
    U = B, dedup U < B), each member its own selection mask (a seeded
    subset of its set's traversal-shaped selection): each member
    against the plain batched version and its own single launch, the
    launch counted as batched."""
    fields = tp.startree_spec(group)
    plan = tsd.StarTreePlan(**fields)
    S, D = 5, 9000 + 37 * B
    vnp = np.float64 if x64 else np.float32
    vdt = torch.float64 if x64 else torch.float32
    U = {"broadcast": 1, "stacked": B, "dedup": max(2, B // 2 - 1)}[form]
    idx = [0] * B if form == "broadcast" else \
        list(range(B)) if form == "stacked" else [(m + 1) % U
                                                  for m in range(B)]
    raw = [tp.startree_inputs(11 + 101 * u, fields, S, D, vnp)
           for u in range(U)]
    sets = [tk.from_jax_staged(c, {}, n, device=card) for c, _p, n in raw]
    # each member selects its own subset of its set's selection (records
    # outside it may carry a star's -1 group code)
    rng = np.random.default_rng(5)
    masks = [{"sel": raw[u][1]["sel"] & (rng.random((S, D)) < 0.7)}
             for u in idx]
    plist = [tk.from_jax_staged({}, p, raw[0][2], device=card)[1]
             for p in masks]
    cols = [c for c, _p, _n in sets]
    nds = [n for _c, _p, n in sets]
    kern = _cuda.STARTREE_AGG
    before = (kern.launches, kern.batched_launches, kern.batched_members)
    out = tsd.batched_kernel(plan, vdt)(cols, plist, nds, idx, D)
    ref = tsd.plain_batched_kernel(plan, vdt)(cols, plist, nds, idx, D)
    torch.cuda.synchronize()
    assert (kern.launches, kern.batched_launches, kern.batched_members) \
        == (before[0], before[1] + 1, before[2] + B)
    assert out.shape == ref.shape and out.shape[0] == B
    tol = tp.F64_TOL if x64 else tp.F32_SUM_TOL
    for m, u in enumerate(idx):
        single = tsd.make_startree_kernel(plan, vdt)(cols[u], plist[m],
                                                     nds[u], D)
        scale = tp.startree_abs_sums(fields, raw[u][0], masks[m], raw[u][2],
                                     D)
        got = out[m].cpu().numpy()
        tp.assert_startree_equal(fields, got, ref[m].cpu().numpy(), scale,
                                 tol)
        tp.assert_startree_equal(fields, got, single.cpu().numpy(), scale,
                                 tol)
        if not fields["num_groups"]:
            assert np.array_equal(got, single.cpu().numpy(), equal_nan=True)


@pytest.mark.cuda
def test_batched_startree_rejects_members_that_disagree(card):
    """A member's mask of another shape, or a set's column of another
    dtype, raises before anything launches."""
    fields = tp.startree_spec("smem")
    plan = tsd.StarTreePlan(**fields)
    c, p, n = tk.from_jax_staged(*tp.startree_inputs(3, fields, 4, 2048,
                                                     np.float32),
                                 device=card)
    bad_sel = {"sel": p["sel"][:, :-1].contiguous()}
    bad_cols = {**c, "stval:sum__x": c["stval:sum__x"].double()}
    before = _cuda.STARTREE_AGG.batched_launches
    for sets, plist in (([c], [p, bad_sel]), ([c, bad_cols], [p, p])):
        with pytest.raises(ValueError):
            _cuda.startree_agg_batched(plan, sets, plist, [n] * len(sets),
                                       list(range(len(sets))) if
                                       len(sets) > 1 else [0, 0], 2048,
                                       torch.float32)
    assert _cuda.STARTREE_AGG.batched_launches == before


# ---------------------------------------------------------------------------
# the upsert validity mask in K1-K4, the time bucket digit in K2
# ---------------------------------------------------------------------------

MASK_KINDS = {"scan": (lambda s: tp.random_spec(s, False), tp.random_inputs),
              "group": (lambda s: tp.random_spec(s, True), tp.random_inputs),
              "sketch": (lambda s: tp.random_sketch_spec(s, scalar=True),
                         tp.sketch_inputs),
              "topn": (lambda s: tp.topn_spec(s, "col", False, 100),
                       tp.topn_inputs)}


def _with_mask(card, cols, seed, S, D):
    """A seeded [S, D] uint8 validity mask clearing about a third of docs."""
    rng = np.random.default_rng(seed)
    return dict(cols, vmask=torch.from_numpy(
        (rng.random((S, D)) >= 1 / 3).astype(np.uint8)).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(MASK_KINDS))
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_masked_kernels_match_plain_on_card(card, kind, seed, x64):
    """K1-K4 with a validity mask against their plain versions: superseded
    docs reach no slot and no top-N row."""
    spec_fn, inputs = MASK_KINDS[kind]
    spec = spec_fn(seed)
    S, D = 6, 4000 + 37 * seed
    vdt = torch.float64 if x64 else torch.float32
    cols, params, nd = inputs(seed, spec, S, D,
                              np.float64 if x64 else np.float32,
                              pad_segments=2)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    tc = _with_mask(card, tc, seed, S, D)
    plan = DevicePlan(**spec, valid_mask=True)
    if kind == "topn":
        out = tk.make_topn_kernel(plan, vdt)(tc, tpar, tnd, D)
        ref = tk.topn_kernel(plan, tc, tpar, tnd, D, vdt)
        assert torch.equal(out, ref)
        return
    out = tk.make_kernel(plan, vdt)(tc, tpar, tnd, D)
    ref = tk.plain_kernel(plan, vdt)(tc, tpar, tnd, D)
    unmasked = tk.plain_kernel(DevicePlan(**spec), vdt)(tc, tpar, tnd, D)
    scale = {j: v.cpu().numpy()
             for j, v in tk.abs_contributions(plan, tc, tpar, tnd, D).items()}
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(),
                           scale, x64)
    assert not torch.equal(ref, unmasked)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["broadcast", "stacked"])
def test_masked_batch_keeps_each_sets_mask_on_card(card, form):
    """K1's member axis: member m reads the mask of its own column set."""
    plan, spec, sets, plist, nds, idx, D, vdt = _batch_inputs(
        card, "scan", 4, form, False)
    S = nds[0].shape[0]
    sets = [_with_mask(card, c, 40 + u, S, D) for u, c in enumerate(sets)]
    plan = DevicePlan(**spec, valid_mask=True)
    out = tk.batched_kernel(plan, vdt)(sets, plist, nds, idx, D)
    for m, u in enumerate(idx):
        single = tk.plain_kernel(plan, vdt)(sets[u], plist[m], nds[u], D)
        scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
            plan, sets[u], plist[m], nds[u], D).items()}
        tp.assert_packed_equal(spec, single.cpu().numpy(),
                               out[m].cpu().numpy(), scale, False)


def _bucket_case(card, seed, S, D, hosts, count, step, x64, start0=None):
    """K2 inputs of a time-series leaf: a host id group column and a
    window filter on it, the timestamp's (hi, lo) planes with in-window
    docs, both window edges, negative and wrapping deltas, and per-segment
    starts (a sliding window per segment)."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    rng = np.random.default_rng(seed)
    pad = 8
    while pad < count:
        pad *= 2
    start0 = 1451606400000 if start0 is None else start0
    starts = start0 + step * np.arange(S, dtype=np.int64)
    t = starts[:, None] + rng.integers(-3 * step, (count + 3) * step, (S, D))
    edges = np.stack([starts, starts - 1, starts + step * count - 1,
                      starts + step * count, starts + (1 << 31),
                      starts - (1 << 31), starts + (1 << 40)], 1)
    t[:, :edges.shape[1]] = edges
    t = np.clip(t, 0, (1 << 55) - 1)
    vnp = np.float64 if x64 else np.float32
    cols = {"ids:h": torch.from_numpy(rng.integers(0, hosts, (S, D)).astype(
                np.int16 if hosts > 127 else np.int8)),
            "valhi:t": torch.from_numpy((t >> 24).astype(np.int32)),
            "vallo:t": torch.from_numpy((t & 0xFFFFFF).astype(np.int32)),
            "val:v": torch.from_numpy(rng.uniform(0, 100, (S, D)).astype(vnp))}
    params = {"leaf0:lo": torch.zeros(S, dtype=torch.int32),
              "leaf0:hi": torch.full((S,), max(hosts - 2, 0),
                                     dtype=torch.int32),
              "tb:shi": torch.from_numpy((starts >> 24).astype(np.int32)),
              "tb:slo": torch.from_numpy((starts & 0xFFFFFF).astype(np.int32)),
              "tb:step": torch.full((S,), step, dtype=torch.int32),
              "tb:count": torch.full((S,), count, dtype=torch.int32)}
    nd = torch.full((S,), D, dtype=torch.int32)
    nd[-1] = D - 999
    spec = dict(filter_ir=("leaf", 0), leaves=(DeviceLeaf("range", "h"),),
                value_irs=(("col", "v"),),
                agg_ops=(("max", 0, None), ("sum", 0, None),
                         ("count", None, None)),
                group_cols=("h",), group_strides=(pad,),
                num_groups=hosts * pad, dict_cols=("h",), raw_cols=("v",),
                raw64_cols=("t",), tbucket=("t", pad))
    move = {k: v.to(card) for k, v in cols.items()}
    return spec, move, {k: v.to(card) for k, v in params.items()}, nd.to(card)


BUCKET_CASES = [(8, 12, 3_600_000), (4000, 12, 3_600_000), (1, 720, 60_000),
                (50, 6, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("hosts,count,step", BUCKET_CASES)
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_time_bucket_kernel_matches_plain_on_card(card, hosts, count, step,
                                                  x64):
    """K2 with the fused bucket digit (its table in shared memory, and past
    it at 4000 hosts x 16) against the plain version: counts and max bit
    for bit, the same present keys, sums within the stated tolerance."""
    S, D = 5, 20_000
    vdt = torch.float64 if x64 else torch.float32
    start0 = 5 if step == 7 else None
    spec, cols, params, nd = _bucket_case(card, 7, S, D, hosts, count, step,
                                          x64, start0)
    plan = DevicePlan(**spec)
    before = _cuda.GROUP_AGG.launches
    out = tk.make_kernel(plan, vdt)(cols, params, nd, D)
    ref = tk.plain_kernel(plan, vdt)(cols, params, nd, D)
    torch.cuda.synchronize()
    assert _cuda.GROUP_AGG.launches == before + 1
    scale = {j: v.cpu().numpy()
             for j, v in tk.abs_contributions(plan, cols, params, nd, D).items()}
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(), scale,
                           x64)
    assert int(ref[..., 2].sum()) > 0


@pytest.mark.cuda
def test_time_bucket_batched_sliding_starts_on_card(card):
    """K2's member axis at B = 8 over one column set (broadcast), each
    member its own window start: against the plain batched version and its
    own single launch."""
    S, D, B = 4, 30_000, 8
    spec, cols, params, nd = _bucket_case(card, 9, S, D, 40, 12, 3_600_000,
                                          False)
    plan = DevicePlan(**spec)
    plist = []
    for m in range(B):
        p = dict(params)
        start = (params["tb:shi"].long() << 24) + params["tb:slo"].long() \
            + 60_000 * m
        p["tb:shi"] = (start >> 24).to(torch.int32)
        p["tb:slo"] = (start & 0xFFFFFF).to(torch.int32)
        plist.append(p)
    out = tk.batched_kernel(plan, torch.float32)([cols], plist, [nd],
                                                 [0] * B, D)
    ref = tk.plain_batched_kernel(plan, torch.float32)([cols], plist, [nd],
                                                       [0] * B, D)
    for m in range(B):
        single = tk.make_kernel(plan, torch.float32)(cols, plist[m], nd, D)
        scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
            plan, cols, plist[m], nd, D).items()}
        for other in (ref[m], single):
            tp.assert_packed_equal(spec, other.cpu().numpy(),
                                   out[m].cpu().numpy(), scale, False)


# ---------------------------------------------------------------------------
# K7 clp_match and the CLP mask leaf of K1 / K2 / K4
# ---------------------------------------------------------------------------

CLP_METAS = [("a", 2, 0), ("a", 0, 0), ("b", 2, 2), ("b", 0, 1),
             ("b", 3, 0), ("b", 1, 4)]


def _clp_case(card, seed, meta, S, D, i=0, **kw):
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    mode, kd, ke = meta
    cols, params = tp.clp_inputs(seed, mode, S, D, i=i, kd=kd, ke=ke, **kw)
    params.update(clp_device.pack_banks(params))  # as the engine stages them
    tc, tpar, _ = tk.from_jax_staged(cols, params, np.zeros(S, np.int32),
                                     device=card)
    return DeviceLeaf("clp", "m", meta), tc, tpar


@pytest.mark.cuda
@pytest.mark.parametrize("meta", CLP_METAS, ids=str)
@pytest.mark.parametrize("seed", range(3))
def test_clp_match_matches_plain_on_card(card, seed, meta):
    """K7 bit for bit against its plain version (ragged D: partial
    tiles), one launch counted."""
    S, D = 5, 3000 + 37 * seed
    leaf, cols, params = _clp_case(card, seed, meta, S, D)
    before = _cuda.CLP_MATCH.launches
    out = _cuda.clp_match([(0, leaf)], cols, params, D)
    torch.cuda.synchronize()
    assert _cuda.CLP_MATCH.launches == before + 1
    assert out.shape == (1, S, D) and out.dtype == torch.bool
    assert torch.equal(out[0], tk.clp_match(0, leaf, cols, params))


@pytest.mark.cuda
def test_clp_match_two_leaves_one_launch_on_card(card):
    """A mode 'a' and a mode 'b' leaf of one column in one launch, each
    against its plain version."""
    S, D = 4, 5000
    la, cols, pa = _clp_case(card, 1, ("a", 2, 0), S, D, i=0)
    lb, cols_b, pb = _clp_case(card, 2, ("b", 2, 2), S, D, i=3)
    cols = {**cols_b, **{k: v for k, v in cols.items() if "dv" not in k}}
    params = {**pa, **pb}
    before = _cuda.CLP_MATCH.launches
    out = _cuda.clp_match([(0, la), (3, lb)], cols, params, D)
    torch.cuda.synchronize()
    assert _cuda.CLP_MATCH.launches == before + 1
    assert torch.equal(out[0], tk.clp_match(0, la, cols, params))
    assert torch.equal(out[1], tk.clp_match(3, lb, cols, params))


@pytest.mark.cuda
def test_clp_match_batched_members_own_widths_on_card(card):
    """K7's member axis: 5 members over 2 column sets, each member's tables
    at its own widths (groups, conditions, banks, LUT width), against the
    plain version and each member's single launch."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    S, D = 4, 4096
    leaf = DeviceLeaf("clp", "m", ("b", 2, 2))
    sets = [tk.from_jax_staged(tp.clp_inputs(10 + u, "b", S, D, vp=256)[0],
                               {}, np.zeros(S, np.int32), device=card)[0]
            for u in range(2)]
    widths = [(8, 8, 4, 256), (4, 16, 2, 512), (64, 16, 8, 256),
              (1, 1, 1, 256), (16, 4, 4, 1024)]
    plist = []
    for m, (gp, ncp, nlp, vp) in enumerate(widths):
        p = tp.clp_inputs(20 + m, "b", S, 8, gp=gp, ncp=ncp, nlp=nlp,
                          vp=vp)[1]
        p.update(clp_device.pack_banks(p))
        plist.append(tk.from_jax_staged({}, p, np.zeros(S, np.int32),
                                        device=card)[1])
    idx = [0, 1, 1, 0, 1]
    before = _cuda.CLP_MATCH.batched_launches
    out = _cuda.clp_match_batched([(0, leaf)], sets, plist, idx, D)
    torch.cuda.synchronize()
    assert _cuda.CLP_MATCH.batched_launches == before + 1
    for m, u in enumerate(idx):
        ref = tk.clp_match(0, leaf, sets[u], plist[m])
        assert torch.equal(out[0, m], ref), m
        assert torch.equal(out[0, m], _cuda.clp_match([(0, leaf)], sets[u],
                                                      plist[m], D)[0]), m


def _clp_plan_case(card, kind, seed=5, S=5, D=3000):
    """A K1 / K2 / K4 plan whose filter ORs a CLP leaf with a NOT of a
    range leaf, over seeded columns."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    leaf, cols, params = _clp_case(card, seed, ("b", 2, 2), S, D)
    rng = np.random.default_rng(seed)
    cols["ids:a"] = torch.from_numpy(rng.integers(0, 7, (S, D)).astype(
        np.int8)).to(card)
    cols["val:x"] = torch.from_numpy(rng.uniform(-50, 50, (S, D)).astype(
        np.float32)).to(card)
    params["leaf1:lo"] = torch.full((S,), 2, dtype=torch.int32, device=card)
    params["leaf1:hi"] = torch.full((S,), 4, dtype=torch.int32, device=card)
    nd = torch.full((S,), D, dtype=torch.int32, device=card)
    nd[-1] = 0
    nd[0] = D - 123
    spec = dict(filter_ir=("or", ("leaf", 0), ("not", ("leaf", 1))),
                leaves=(leaf, DeviceLeaf("range", "a")),
                value_irs=(("col", "x"),), agg_ops=(
                    ("count", None, None), ("sum", 0, None),
                    ("max", 0, None)),
                dict_cols=("a",), raw_cols=("x",),
                clp_cols=(("m", 2, 2),))
    if kind == "group":
        spec.update(group_cols=("a",), group_strides=(1,), num_groups=7)
    if kind == "topn":
        spec.update(agg_ops=(), mode="topn", topn_k=50, topn_asc=False)
    return spec, cols, params, nd, D


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scan", "group", "topn"])
def test_clp_leaf_through_scan_group_topn_on_card(card, kind):
    """K7's mask read as a filter leaf by K1, K2 and K4 (one K7 launch
    each), against the plain versions, and at B = 3 members on the member
    axis (one K7 and one K1 / K2 / K4 batched launch)."""
    spec, cols, params, nd, D = _clp_plan_case(card, kind)
    plan = DevicePlan(**spec)
    vdt = torch.float32
    before = _cuda.CLP_MATCH.launches
    if kind == "topn":
        out = tk.make_topn_kernel(plan, vdt)(cols, params, nd, D)
        ref = tk.topn_kernel(plan, cols, params, nd, D, vdt)
        assert torch.equal(out, ref)
    else:
        out = tk.make_kernel(plan, vdt)(cols, params, nd, D)
        ref = tk.plain_kernel(plan, vdt)(cols, params, nd, D)
        scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
            plan, cols, params, nd, D).items()}
        tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(),
                               scale, False)
    assert _cuda.CLP_MATCH.launches == before + 1
    plist = [params] + [dict(params, **{
        k: v for k, v in _clp_case(card, 40 + m, ("b", 2, 2), nd.shape[0],
                                   D)[2].items()}) for m in range(2)]
    b0 = _cuda.CLP_MATCH.batched_launches
    out = tk.batched_kernel(plan, vdt)([cols], plist, [nd], [0, 0, 0], D)
    ref = tk.plain_batched_kernel(plan, vdt)([cols], plist, [nd], [0, 0, 0],
                                            D)
    assert _cuda.CLP_MATCH.batched_launches == b0 + 1
    if kind == "topn":
        assert torch.equal(out, ref)
        return
    for m in range(3):
        scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
            plan, cols, plist[m], nd, D).items()}
        tp.assert_packed_equal(spec, ref[m].cpu().numpy(),
                               out[m].cpu().numpy(), scale, False)


@pytest.mark.cuda
def test_clp_queries_on_card_equal_the_cpu_engine(card, tmp_path):
    """CLP SQL through QueryExecutor on the card against device='cpu' on
    the same segments (the port's creator and loader): counts, groups and
    selected rows equal."""
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, TableConfig)
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.segment.creator import SegmentCreator
    from pinot_tpu_torch.segment.loader import load_segment
    msgs = ["INFO task 1234 started on host web-01 in 0.5s",
            "ERROR task 1234 failed on host web-01: code=500",
            "ERROR task 777 failed on host db-01: code=503",
            "INFO user alice logged in from 10.0.0.1",
            "disk /dev/sda1 at 93% capacity", "GC pause 45 ms in region r7"]
    schema = Schema("logs", [FieldSpec("ts", DataType.LONG,
                                       FieldType.DATE_TIME),
                             FieldSpec("message", DataType.STRING)])
    tc = TableConfig("logs")
    tc.indexing.clp_columns = ["message"]
    tc.indexing.compression = "GZIP"
    segs = []
    for si in range(3):
        lines = [msgs[(i * 7 + si) % len(msgs)] for i in range(500 + 91 * si)]
        out = str(tmp_path / f"s{si}")
        SegmentCreator(tc, schema).build(
            {"ts": np.arange(len(lines), dtype=np.int64), "message": lines},
            out, f"s{si}")
        segs.append(load_segment(out))
    on_card = QueryExecutor(segs)
    on_cpu = QueryExecutor(segs, device="cpu")
    for sql in [
            "SELECT COUNT(*) FROM logs WHERE message LIKE '%failed%'",
            "SELECT COUNT(*) FROM logs WHERE message LIKE '%code=503'",
            "SELECT COUNT(*) FROM logs WHERE message LIKE 'ERROR%' OR "
            "message LIKE '%capacity' AND ts < 300",
            "SELECT ts, COUNT(*) FROM logs WHERE message LIKE '%web-01%' "
            "GROUP BY ts ORDER BY ts LIMIT 7",
            "SELECT ts, message FROM logs WHERE message LIKE '%user alice%' "
            "ORDER BY ts DESC LIMIT 9"]:
        assert on_card.execute(sql).rows == on_cpu.execute(sql).rows, sql


VEC_CASES = {"exact": {}, "ivf": {"ivf": True},
             "residual+vmask": {"resid": True, "vmask": True},
             "ivf+residual": {"ivf": True, "resid": True},
             "ties": {"special": "ties"},
             "signed zeros": {"special": "zeros", "dim": 8},
             "nan": {"special": "nan"},
             "d=96 k=100": {"dim": 96, "k": 100},
             "d=512 k=5": {"dim": 512, "k": 5},
             "d=8 k=3": {"dim": 8, "k": 3}}


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(VEC_CASES))
@pytest.mark.parametrize("D", [3000, 70_001])
def test_vector_topk_matches_plain_on_card(card, case, D):
    spec, cols, params, nd = tp.vector_case(7, S=5, D=D, **VEC_CASES[case])
    plan = tp.vector_plan(spec)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    n0 = _cuda.VECTOR_TOPK.launches
    out = tk.make_vector_kernel(plan)(tc, tpar, tnd, D)
    ref = tvd.vector_topk(plan, tc, tpar, tnd, D)
    torch.cuda.synchronize()
    assert _cuda.VECTOR_TOPK.launches == n0 + 1
    assert torch.equal(_bits(out), _bits(ref))
    cpu = tvd.vector_topk(plan, *tk.from_jax_staged(cols, params, nd), D)
    assert torch.equal(_bits(out), _bits(cpu))
    kk = min(spec["k_pad"], D)
    for s, truth in enumerate(tp.vector_truth(spec, cols, params, nd)):
        tp.check_vector_row(out[s].cpu().numpy(), *truth, kk)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["broadcast", "stacked"])
@pytest.mark.parametrize("case", ["exact", "ivf+residual"])
def test_vector_topk_batched_matches_plain_and_single_on_card(card, form,
                                                              case):
    B, D = 4, 5000
    members = [tp.vector_case(30 + m, S=5, D=D, **VEC_CASES[case])
               for m in range(B)]
    spec = members[0][0]
    plan = tp.vector_plan(spec)
    staged = [tk.from_jax_staged(c, p, nd, device=card)
              for _s, c, p, nd in members]
    if form == "broadcast":
        sets, ndl, idx = [staged[0][0]], [staged[0][2]], [0] * B
    else:
        sets, ndl, idx = [x[0] for x in staged], [x[2] for x in staged], \
            list(range(B))
    plist = [x[1] for x in staged]
    n0 = _cuda.VECTOR_TOPK.batched_launches
    out = tk.batched_kernel(plan)(sets, plist, ndl, idx, D)
    ref = tk.plain_batched_kernel(plan)(sets, plist, ndl, idx, D)
    torch.cuda.synchronize()
    assert _cuda.VECTOR_TOPK.batched_launches == n0 + 1
    assert torch.equal(_bits(out), _bits(ref))
    for m in range(B):
        single = tk.make_vector_kernel(plan)(sets[idx[m]], plist[m],
                                            ndl[idx[m]], D)
        assert torch.equal(_bits(out[m]), _bits(single))


def _with_bound(plan, cols, params, nd, D):
    """params plus 'vq:nc', each row's candidate count on the host (the
    engine's vector_device.candidate_counts), from the plain version's
    candidates."""
    nc = tvd.candidates(plan, cols, params, nd, D).sum(1).to(torch.int32)
    return dict(params, **{"vq:nc": nc.cpu()})


def _vector_both_ways(plan, cols, params, nd, D):
    """K8 with and without the host bound, each bit for bit against the
    plain version on the card; returns the bounded launch's output."""
    ref = tvd.vector_topk(plan, cols, params, nd, D)
    outs = []
    for p in (_with_bound(plan, cols, params, nd, D), params):
        n0 = _cuda.VECTOR_TOPK.launches
        outs.append(tk.make_vector_kernel(plan)(cols, p, nd, D))
        torch.cuda.synchronize()
        assert _cuda.VECTOR_TOPK.launches == n0 + 1
        assert torch.equal(_bits(outs[-1]), _bits(ref))
    return outs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["no candidate", "fewer than kk"])
@pytest.mark.parametrize("D", [3000, 70_001])
def test_vector_topk_empty_and_short_rows_on_card(card, edge, D):
    """Rows with no candidate (real segments probing no cell, and padded
    segments: count 0, -1 / -inf throughout) and rows with fewer
    candidates than kk (k = 100 over one probed cell of 30 docs), with and
    without the host's bound."""
    spec, cols, params, nd = tp.vector_case(
        11, S=5, D=D, ivf=True, n_cells=100 if edge == "fewer than kk"
        else 37, k=100 if edge == "fewer than kk" else 10, pad_segments=2)
    cells = np.zeros_like(params["vq:cells"])
    if edge == "fewer than kk":  # cell 5 holds each segment's first 30 docs
        cells[:, 5] = True
        cols["vcell:v"][:] = 6
        cols["vcell:v"][:, :30] = 5
    params["vq:cells"] = cells
    plan = tp.vector_plan(spec)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    out = _vector_both_ways(plan, tc, tpar, tnd, D)
    nc = _with_bound(plan, tc, tpar, tnd, D)["vq:nc"]
    kk = min(spec["k_pad"], D)
    if edge == "no candidate":
        assert not nc.any() and not out[:, 0].any()
    else:
        assert 0 < int(nc.max()) < kk
    for s in range(5):
        assert torch.equal(out[s, 1 + int(nc[s]):1 + kk].cpu(),
                           torch.full((kk - int(nc[s]),), -1.0))
        assert torch.isneginf(out[s, 1 + kk + int(nc[s]):]).all()
    assert not out[3:, 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("over", [0, 1])
def test_vector_topk_at_the_shared_memory_capacity_on_card(card, over):
    """Rows of exactly pt_vec_local_cap(kk) candidates (selected in one
    block's shared memory) and, with over = 1, a row one past it (K4's sift
    passes, in the same launch), beside a short and a padded row."""
    kk = 16
    cap = _cuda.vector_local_cap(kk)
    D = cap + 64
    spec, cols, params, nd = tp.vector_case(12, S=4, D=D, dim=8, k=10,
                                            pad_segments=1)
    nd[:3] = [cap, cap + over, 500]
    plan = tp.vector_plan(spec)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    assert int(_with_bound(plan, tc, tpar, tnd, D)["vq:nc"].max()) \
        == cap + over
    out = _vector_both_ways(plan, tc, tpar, tnd, D)
    for s, truth in enumerate(tp.vector_truth(spec, cols, params, nd)):
        tp.check_vector_row(out[s].cpu().numpy(), *truth, kk)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["shared memory", "sift"])
def test_vector_topk_bound_one_short_raises_on_card(card, path):
    """A host bound ('vq:nc') one below a row's true candidate count: K8
    marks that row (count -1) and its unpacking raises, while the other
    rows stay bit for bit the plain version's; in one block's shared
    memory and, past pt_vec_local_cap(kk), on the sift passes."""
    kk = 16
    local = _cuda.vector_local_cap(kk)
    D = 3000 if path == "shared memory" else local + 64
    spec, cols, params, nd = tp.vector_case(14, S=3, D=D, dim=8, k=10,
                                            pad_segments=1)
    nd[:2] = [D, 500]
    plan = tp.vector_plan(spec)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    p = _with_bound(plan, tc, tpar, tnd, D)
    p["vq:nc"][0] -= 1
    assert (_cuda.vector_cap([p], D) > local) == (path == "sift")
    out = tk.make_vector_kernel(plan)(tc, p, tnd, D).cpu()
    ref = tvd.vector_topk(plan, tc, tpar, tnd, D).cpu()
    assert out[0, 0] == -1
    assert torch.equal(_bits(out[1:]), _bits(ref[1:]))
    with pytest.raises(RuntimeError, match="outgrew"):
        tvd.unpack(out[0].numpy())
    with pytest.raises(RuntimeError, match="outgrew"):
        tvd.merge_top_k(out.numpy(), 2, 10)


@pytest.mark.cuda
def test_vector_topk_concurrent_bounds_on_card(card):
    """K8 launched from 8 host threads at once, half on a bound that sizes
    its select's shared memory near the top (one row of 20,000
    candidates), half near the bottom (rows of 400 and 300): every launch
    bit for bit the plain version's, as the serialized dispatch ring's
    clients launch inline on their own threads."""
    D = 20_000
    inputs = []
    for seed, rows in ((15, [D, 500]), (16, [400, 300])):
        spec, cols, params, nd = tp.vector_case(seed, S=3, D=D, dim=8, k=10,
                                                pad_segments=1)
        nd[:2] = rows
        plan = tp.vector_plan(spec)
        tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
        p = _with_bound(plan, tc, tpar, tnd, D)
        ref = _bits(tvd.vector_topk(plan, tc, tpar, tnd, D))
        inputs.append((tk.make_vector_kernel(plan), tc, p, tnd, ref))
    assert [int(x[2]["vq:nc"].max()) for x in inputs] == [D, 400]

    def run(i):
        kern, tc, p, tnd, ref = inputs[i % 2]
        for _ in range(25):
            out = kern(tc, p, tnd, D)
            torch.cuda.current_stream().synchronize()
            assert torch.equal(_bits(out), ref)
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(run, i) for i in range(8)]:
            f.result()


@pytest.mark.cuda
@pytest.mark.parametrize("special", ["ties", "zeros", "nan"])
@pytest.mark.parametrize("ivf", [False, True])
@pytest.mark.parametrize("D", [3000, 70_001])
def test_vector_topk_order_on_the_compacted_lists_on_card(card, special,
                                                          ivf, D):
    """Exact ties, +-0.0 scores and NaN rows through the compacted lists,
    with the host's bound (one block's select at D = 3000 and with IVF,
    the sift passes on exact search at D = 70,001): bit for bit."""
    spec, cols, params, nd = tp.vector_case(
        13, S=5, D=D, ivf=ivf, special=special,
        dim=8 if special == "zeros" else 16, k=100)
    plan = tp.vector_plan(spec)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    _vector_both_ways(plan, tc, tpar, tnd, D)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["broadcast", "stacked"])
def test_vector_topk_batch_bounds_on_both_sides_on_card(card, form):
    """B = 8 IVF members whose bounds fall on both sides of the
    shared-memory capacity: over 4 cells (doc d in cell d mod 4), odd
    members probe every cell of a full segment (cap + 1024 candidates),
    even ones three (about 3/4 of them, below cap). One launch, bit for
    bit against the plain batched version and each member's single
    launch."""
    B, kk = 8, 16
    cap = _cuda.vector_local_cap(kk)
    D = cap + 1024
    members = []
    for m in range(B):
        spec, cols, params, nd = tp.vector_case(40 + m, S=3, D=D, dim=8,
                                                k=10, ivf=True, n_cells=4,
                                                pad_segments=1)
        nd[:2] = [D, 300 + m]
        cols["vcell:v"][:] = np.arange(D, dtype=np.int32) % 4
        params["vq:cells"][:] = False
        params["vq:cells"][:, :4 if m % 2 else 3] = True
        members.append((spec, cols, params, nd))
    plan = tp.vector_plan(members[0][0])
    staged = [tk.from_jax_staged(c, p, nd, device=card)
              for _s, c, p, nd in members]
    if form == "broadcast":
        sets, ndl, idx = [staged[0][0]], [staged[0][2]], [0] * B
    else:
        sets, ndl, idx = [x[0] for x in staged], [x[2] for x in staged], \
            list(range(B))
    plist = [_with_bound(plan, sets[idx[m]], x[1], ndl[idx[m]], D)
             for m, x in enumerate(staged)]
    bounds = [int(p["vq:nc"].max()) for p in plist]
    assert max(bounds[1::2]) == D and max(bounds[::2]) <= cap
    n0 = _cuda.VECTOR_TOPK.batched_launches
    out = tk.batched_kernel(plan)(sets, plist, ndl, idx, D)
    ref = tk.plain_batched_kernel(plan)(sets, plist, ndl, idx, D)
    torch.cuda.synchronize()
    assert _cuda.VECTOR_TOPK.batched_launches == n0 + 1
    assert torch.equal(_bits(out), _bits(ref))
    for m in range(B):
        single = tk.make_vector_kernel(plan)(sets[idx[m]], plist[m],
                                            ndl[idx[m]], D)
        assert torch.equal(_bits(out[m]), _bits(single))


# ---------------------------------------------------------------------------
# K9 mesh_fold and the logical mesh (parallel/mesh.py, ops/collective.py)
# ---------------------------------------------------------------------------

def _fold_parts(seed, P, B, rows, win, dtype, device):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P):
        a = rng.normal(0, 1000, (B, rows, win)).astype(dtype)
        a[rng.random(a.shape) < 0.01] = np.nan
        a[rng.random(a.shape) < 0.01] = np.inf
        a[rng.random(a.shape) < 0.01] = -np.inf
        out.append(torch.from_numpy(a).to(device))
    return out


def _fold_case(kind):
    """(fold, P): the doc fold of K1/K3-shaped partials, the ungrouped
    merge, and the remapped merge of K2-shaped partials with its tail."""
    from pinot_tpu_torch.ops import collective as tco
    from pinot_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(["cpu"] * 8, doc_axis=2)
    agg = (("sum", 0, None), ("min", 0, None), ("max", 0, None),
           ("count", None, None))
    if kind == "doc":
        return tk.doc_fold(4, 2, 3, 1, 7, (0, 0, 1, 2, 2, 0, 1)), 8
    if kind == "merged":
        plan = DevicePlan(filter_ir=None, leaves=(),
                          value_irs=(("col", "x"),), agg_ops=agg)
        return tco.merged_plan(plan, mesh, 12), 8
    plan = DevicePlan(filter_ir=None, leaves=(), value_irs=(("col", "x"),),
                      agg_ops=agg, group_cols=("a",), group_strides=(1,),
                      num_groups=35)
    remap = np.random.default_rng(5).integers(-1, 64, (12, 35))
    return tco.merged_plan(plan, mesh, 12, 64, remap), 8


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["doc", "merged", "remap"])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_mesh_fold_matches_plain_on_card(card, kind, B, x64):
    """K9 bit for bit against mesh_fold_plain, every op code, with and
    without the remap and the tail, NaN and infinities included."""
    fold, P = _fold_case(kind)
    parts = _fold_parts(7, P, B, fold.rows_in, fold.win,
                        np.float64 if x64 else np.float32, card)
    before = (_cuda.MESH_FOLD.launches, _cuda.MESH_FOLD.batched_launches)
    out = tk.mesh_fold(parts, fold, batched=B > 1)
    ref = tk.mesh_fold_plain(parts, fold)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(out.nan_to_num(nan=7.0), ref.nan_to_num(nan=7.0))
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    after = (_cuda.MESH_FOLD.launches, _cuda.MESH_FOLD.batched_launches)
    assert after[int(B > 1)] == before[int(B > 1)] + 1
    cpu = tk.mesh_fold_plain([p.cpu() for p in parts], fold)
    assert torch.equal(cpu.nan_to_num(nan=7.0),
                       out.cpu().nan_to_num(nan=7.0))


def _mesh_inputs(seed, grouped, S, D):
    spec = tp.random_spec(seed, grouped)
    cols, params, nd = tp.random_inputs(seed, spec, S, D, np.float32,
                                        pad_segments=1)
    nd[0] = 700
    return spec, DevicePlan(**spec), cols, params, nd


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
def test_sharded_and_merged_on_a_logical_mesh_equal_the_cpu(card, grouped):
    """sharded_kernel and merged_kernel on a logical 4x2 mesh over cuda:0
    (K1-K3 per slot, then K9) equal the same calls on CPU tensors (the
    plain versions): counts, exact-sum planes, min / max and tails bit for
    bit, float sums within 1e-5 of the slot's sum of |contribution|."""
    from pinot_tpu_torch.ops import collective as tco
    from pinot_tpu_torch.parallel.mesh import make_mesh, shard_block
    S, D = 8, 4096
    spec, plan, cols, params, nd = _mesh_inputs(3, grouped, S, D)
    gmesh = make_mesh(["cuda:0"] * 8, doc_axis=2)
    cmesh = make_mesh(["cpu"] * 8, doc_axis=2)
    out = {}
    for name, mesh, dev in (("card", gmesh, card), ("cpu", cmesh, "cpu")):
        tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=dev)
        sc = {k: shard_block(mesh, v) for k, v in tc.items()}
        k1 = _cuda.SCAN_AGG.launches + _cuda.GROUP_AGG.launches
        k9 = _cuda.MESH_FOLD.launches
        sh = tk.sharded_kernel(plan, mesh, torch.float32)(sc, tpar, tnd, D)
        G = 64 if grouped else 0
        remap = np.tile(np.arange(plan.num_groups), (S, 1)) % 64 \
            if grouped else None
        fold = tco.merged_plan(plan, mesh, S, G, remap)
        mg = tco.merged_kernel(plan, mesh, torch.float32)(sc, tpar, tnd, D,
                                                          G, fold)
        if name == "card":
            torch.cuda.synchronize()
            assert _cuda.SCAN_AGG.launches + _cuda.GROUP_AGG.launches \
                == k1 + 16
            assert _cuda.MESH_FOLD.launches == k9 + 2
        out[name] = (sh.cpu().numpy(), mg.cpu().numpy())
        scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
            plan, *tk.from_jax_staged(cols, params, nd), D).items()}
    (sh_g, mg_g), (sh_c, mg_c) = out["card"], out["cpu"]
    tp.assert_packed_equal(spec, sh_g, sh_c, scale, False)
    assert np.array_equal(mg_g[-S:], mg_c[-S:])
    assert np.allclose(mg_g, mg_c, rtol=1e-5, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["topn", "topn B=3", "vector", "startree"])
def test_segments_sharded_topk_on_card(card, kind):
    """K4 (single and batched), K8 and K5 per slot of a logical 4x1 mesh
    over cuda:0: one launch a slot, the slots' rows in segment order equal
    to the one-card launch bit for bit and to the sharded plain version
    (K5's float sums within the star-tree tolerance)."""
    from pinot_tpu_torch.parallel.mesh import make_mesh, shard_block
    mesh = make_mesh(["cuda:0"] * 4, doc_axis=1)
    S, D = 4, 20_000
    if kind == "vector":
        spec, cols, params, nd = tp.vector_case(7, S=S, D=D, ivf=True,
                                                resid=True, pad_segments=1)
        plan = tp.vector_plan(spec)
        tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
        tpar = _with_bound(plan, tc, tpar, tnd, D)
        one = tk.make_vector_kernel(plan)
        run = tk.sharded_topn_kernel(plan, mesh)
        plain = tk.plain_sharded_topn_kernel(plan, mesh)
        kern = _cuda.VECTOR_TOPK
    elif kind == "startree":
        fields = tp.startree_spec("smem")
        cols, params, nd = tp.startree_inputs(1, fields, S, D, np.float32)
        plan = tsd.StarTreePlan(**fields)
        tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
        one = tsd.make_startree_kernel(plan, torch.float32)
        run = tsd.sharded_kernel(plan, mesh, torch.float32)
        plain = tsd.plain_sharded_kernel(plan, mesh, torch.float32)
        kern = _cuda.STARTREE_AGG
    else:
        spec = tp.topn_spec(2, "col", False, 100)
        cols, params, nd = tp.topn_inputs(2, spec, S, D, np.float32,
                                          pad_segments=1)
        plan = DevicePlan(**spec)
        tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
        one = tk.make_topn_kernel(plan, torch.float32)
        run = tk.sharded_topn_kernel(plan, mesh, torch.float32)
        plain = tk.plain_sharded_topn_kernel(plan, mesh, torch.float32)
        kern = _cuda.TOPN
    sc = {k: shard_block(mesh, v) for k, v in tc.items()}
    n0 = kern.launches + kern.batched_launches
    if kind == "topn B=3":
        plist = [tpar] * 3
        want = tk.batched_kernel(plan, torch.float32)([tc], plist, [tnd],
                                                       [0] * 3, D)
        got = tk.batched_sharded_topn_kernel(plan, mesh, torch.float32)(
            [sc], plist, [tnd], [0] * 3, D)
        ref = tk.plain_batched_sharded_topn_kernel(plan, mesh,
                                                   torch.float32)(
            [sc], plist, [tnd], [0] * 3, D)
    else:
        want = one(tc, tpar, tnd, D)
        got = run(sc, tpar, tnd, D)
        ref = plain(sc, tpar, tnd, D)
    torch.cuda.synchronize()
    # one launch for the one-card output, then one a slot
    assert kern.launches + kern.batched_launches == n0 + 1 + 4
    assert got.shape == want.shape == ref.shape
    if kind == "startree":
        assert torch.equal(_bits(got), _bits(want))
        tp.assert_startree_equal(fields, got.cpu().numpy(), ref.cpu().numpy(),
                                 tp.startree_abs_sums(fields, cols, params,
                                                      nd, D),
                                 tp.F32_SUM_TOL)
    elif got.is_floating_point():
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(got), _bits(ref))
    else:
        assert torch.equal(got, want) and torch.equal(got, ref)


@pytest.mark.cuda
def test_mesh_engine_on_card_equals_the_cpu_engine(card, tmp_path):
    """SQL through a logical 4x2 mesh engine on cuda:0 (merged and
    sharded) equals the CPU mesh engine's rows."""
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, TableConfig)
    from pinot_tpu_torch.parallel.mesh import make_mesh
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.segment.creator import SegmentCreator
    from pinot_tpu_torch.segment.loader import load_segment
    from pinot_tpu_torch.utils.config import PinotConfiguration
    rng = np.random.default_rng(2)
    segs = []
    for i in range(6):
        n = 3000 + 100 * i
        out = str(tmp_path / f"m{i}")
        SegmentCreator(TableConfig("t"), Schema("t", [
            FieldSpec("a", DataType.INT), FieldSpec("g", DataType.STRING),
            FieldSpec("m", DataType.INT, FieldType.METRIC)])).build(
                {"a": rng.integers(0, 50, n).astype(np.int32),
                 "g": np.array([f"g{k}" for k in rng.integers(0, 9, n)],
                               object),
                 "m": rng.integers(0, 1000, n).astype(np.int32)}, out, "s")
        segs.append(load_segment(out))
    sqls = ["SELECT SUM(m), COUNT(*), MIN(m), MAX(m) FROM t WHERE a > 10",
            "SELECT g, SUM(m), COUNT(*) FROM t WHERE a < 40 GROUP BY g "
            "ORDER BY g LIMIT 100",
            "SELECT DISTINCTCOUNTHLL(a), COUNT(*) FROM t"]
    for merge in (True, False):
        cfg = PinotConfiguration(
            {"pinot.server.mesh.collective.merge": merge})
        gpu = QueryExecutor(segs, config=cfg,
                            mesh=make_mesh(["cuda:0"] * 8, doc_axis=2))
        cpu = QueryExecutor(segs, device="cpu", config=cfg,
                            mesh=make_mesh(["cpu"] * 8, doc_axis=2))
        for sql in sqls:
            assert gpu.execute(sql).rows == cpu.execute(sql).rows, sql
        assert gpu.engine.meter("mesh_merge_served") == (3 if merge else 0)


@pytest.mark.cuda
def test_distributed_query_step_on_card_equals_the_cpu(card):
    from pinot_tpu_torch.parallel import distributed_query_step
    from pinot_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(4)
    S, D, G = 8, 4096, 16
    args = [rng.integers(0, 100, (S, D)).astype(np.int32),
            rng.integers(0, 1000, (S, D)).astype(np.float64),
            rng.integers(0, G + 3, (S, D)).astype(np.int32),
            rng.integers(0, 30, S).astype(np.int32),
            rng.integers(40, 90, S).astype(np.int32),
            rng.integers(1000, D, S).astype(np.int32),
            np.arange(D, dtype=np.int32)[None]]
    got = distributed_query_step(make_mesh(["cuda:0"] * 8, doc_axis=2))(G)(
        *(torch.from_numpy(a).to(card) for a in args))
    want = distributed_query_step(make_mesh(["cpu"] * 8, doc_axis=2))(G)(
        *(torch.from_numpy(a) for a in args))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)  # integer-valued float64: exact


# ---------------------------------------------------------------------------
# K2 with compact keys (the gkey block at the launch's G) and K9's compact
# remap
# ---------------------------------------------------------------------------

#: G in K2's warp tier, its global tier and at the cap for
#: tp.compact_spec's slots (`_cuda.group_tier`)
COMPACT_GS = [64, 8192, 1 << 20]


def _compact_case(card, seed, G, S, D, x64, mask=False):
    spec = tp.compact_spec(seed)
    vnp = np.float64 if x64 else np.float32
    cols, params, nd = tp.random_inputs(seed, spec, S, D, vnp,
                                        nan=seed % 3 == 0, pad_segments=1)
    cols["gkey"] = tp.compact_gkey(seed, S, D, G)
    if mask:
        cols["vmask"] = np.random.default_rng(seed + 3).random((S, D)) < 0.6
        spec = dict(spec, valid_mask=True)
    return spec, DevicePlan(**spec), tk.from_jax_staged(cols, params, nd,
                                                        device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("G", COMPACT_GS)
@pytest.mark.parametrize("mask", [False, True], ids=["plain", "vmask"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_compact_kernel_matches_plain_on_card(card, G, mask, x64):
    """K2 at compact G (shared table, global table, the cap), with and
    without the validity mask, against its plain version."""
    S, D = 5, 20_000
    spec, plan, (tc, tpar, tnd) = _compact_case(card, 4, G, S, D, x64, mask)
    vdt = torch.float64 if x64 else torch.float32
    before = _cuda.GROUP_AGG.launches
    out = tk.make_kernel(plan, vdt)(tc, tpar, tnd, D, G)
    ref = tk.plain_kernel(plan, vdt)(tc, tpar, tnd, D, G)
    torch.cuda.synchronize()
    assert _cuda.GROUP_AGG.launches == before + 1
    assert out.shape == (S, G, len(plan.agg_ops))
    scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
        plan, tc, tpar, tnd, D, G).items()}
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(),
                           scale, x64)


@pytest.mark.cuda
@pytest.mark.parametrize("G", COMPACT_GS)
@pytest.mark.parametrize("B", [1, 8])
def test_compact_batched_matches_plain_and_single_on_card(card, G, B):
    """K2's member axis at compact G, B members over one column set each
    with its own literals, under the validity mask: each member against
    the plain batched version and its single launch."""
    S, D = 4, 12_000
    spec, plan, (tc, tpar, tnd) = _compact_case(card, 6, G, S, D, False,
                                                mask=True)
    plist = [tk.from_jax_staged(*tp.random_inputs(40 + m, spec, S, D,
                                                  np.float32),
                                device=card)[1] for m in range(B)]
    idx = [0] * B
    before = (_cuda.GROUP_AGG.launches, _cuda.GROUP_AGG.batched_launches)
    out = tk.batched_kernel(plan, torch.float32)([tc], plist, [tnd], idx,
                                                 D, G)
    ref = tk.plain_batched_kernel(plan, torch.float32)([tc], plist, [tnd],
                                                       idx, D, G)
    torch.cuda.synchronize()
    assert (_cuda.GROUP_AGG.launches, _cuda.GROUP_AGG.batched_launches) \
        == (before[0], before[1] + 1)
    single = tk.make_kernel(plan, torch.float32)
    for m in range(B):
        scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
            plan, tc, plist[m], tnd, D, G).items()}
        got = out[m].cpu().numpy()
        tp.assert_packed_equal(spec, ref[m].cpu().numpy(), got, scale, False)
        tp.assert_packed_equal(spec, single(tc, plist[m], tnd, D,
                                            G).cpu().numpy(), got, scale,
                               False)


@pytest.mark.cuda
def test_compact_wrapper_checks_G_and_the_key_block(card):
    """group_agg refuses a compact plan without G, past its largest G,
    or with a key block that is not int32; scan_agg and sketch_agg refuse
    compact plans."""
    S, D, G = 3, 4096, 256
    _spec, plan, (tc, tpar, tnd) = _compact_case(card, 1, G, S, D, False)
    with pytest.raises(ValueError, match="group count"):
        _cuda.group_agg(plan, tc, tpar, tnd, D, torch.float32)
    with pytest.raises(ValueError, match="group count"):
        _cuda.group_agg(plan, tc, tpar, tnd, D, torch.float32,
                        G=_cuda.MAX_GROUPS + 1)
    bad = dict(tc, gkey=tc["gkey"].to(torch.int16))
    with pytest.raises(ValueError, match="gkey"):
        _cuda.group_agg(plan, bad, tpar, tnd, D, torch.float32, G=G)
    with pytest.raises(ValueError, match="ungrouped"):
        _cuda.scan_agg(plan, tc, tpar, tnd, D, torch.float32)
    with pytest.raises(ValueError, match="ungrouped"):
        _cuda.sketch_agg(plan, tc, tpar, tnd, D, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5])
def test_compact_remap_fold_matches_plain_on_card(card, B):
    """K9 through a compact remap (local code -> global index, -1 past a
    segment's tuples and for a padded segment), its tail over every local
    code, bit for bit against its plain version on the card and the CPU."""
    from pinot_tpu_torch.ops import collective as tco
    from pinot_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(["cpu"] * 8, doc_axis=2)
    S, G_local, G = 8, 4096, 8192
    plan = DevicePlan(filter_ir=None, leaves=(), value_irs=(("col", "x"),),
                      agg_ops=(("sum", 0, None), ("min", 0, None),
                               ("max", 0, None), ("count", None, None)),
                      group_cols=("a", "b"), group_compact=True)
    rng = np.random.default_rng(9)
    remap = np.full((S, G_local), -1, np.int64)
    for s in range(S - 1):
        held = int(rng.integers(G_local // 2, G_local + 1))
        remap[s, :held] = np.sort(rng.choice(G, held, replace=False))
    fold = tco.merged_plan(plan, mesh, S, G, remap)
    parts = _fold_parts(11, 8, B, fold.rows_in, fold.win, np.float32, card)
    out = tk.mesh_fold(parts, fold, batched=B > 1)
    ref = tk.mesh_fold_plain(parts, fold)
    torch.cuda.synchronize()
    assert out.shape == (B, G * 4 + S)
    assert torch.equal(out.nan_to_num(nan=7.0), ref.nan_to_num(nan=7.0))
    cpu = tk.mesh_fold_plain([p.cpu() for p in parts], fold)
    assert torch.equal(cpu.nan_to_num(nan=7.0),
                       out.cpu().nan_to_num(nan=7.0))


def _same_fold(out, ref):
    """Bit for bit, NaN where NaN (the kernel's NaN is the quiet NaN, the
    plain version's may carry an input's payload)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(torch.isnan(out), torch.isnan(ref.to(out.device)))
    a, b = out.cpu(), ref.cpu()
    keep = ~torch.isnan(a)
    assert torch.equal(a[keep], b[keep])
    assert torch.equal(torch.signbit(a[keep]), torch.signbit(b[keep]))


def _fold_on_card(parts, fold, batched):
    """K9 on the card, its launch counted once, against the plain version
    on the card and on the CPU."""
    kern = _cuda.MESH_FOLD
    before = (kern.launches, kern.batched_launches)
    out = tk.mesh_fold(parts, fold, batched=batched)
    ref = tk.mesh_fold_plain(parts, fold)
    torch.cuda.synchronize()
    after = (kern.launches, kern.batched_launches)
    assert after[int(batched)] == before[int(batched)] + 1
    assert after[1 - int(batched)] == before[1 - int(batched)]
    _same_fold(out, ref)
    _same_fold(out, tk.mesh_fold_plain([p.cpu() for p in parts], fold))
    return out


#: strided doc folds: (n_seg, n_doc, s_loc, per_seg, win); the last two
#: rows are not a multiple of 16 bytes long, so units straddle rows and
#: take the scalar path
STRIDED = [(1, 2, 4, 1, 73), (4, 2, 2, 64, 4), (2, 4, 3, 1, 7),
           (3, 2, 1, 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", STRIDED, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_strided_doc_fold_on_card(card, geom, B, x64):
    """The strided doc fold (no lists on the card) bit for bit against its
    plain version, which folds the same sources through host lists, and
    against the offset partials (not 16-byte aligned: the scalar path)."""
    n_seg, n_doc, s_loc, per_seg, win = geom
    ops = tuple(int(c) for c in np.random.default_rng(win).integers(
        0, 3, win))
    fold = tk.doc_fold(n_seg, n_doc, s_loc, per_seg, win, ops)
    assert fold.strided and fold.nbytes == win
    dt = np.float64 if x64 else np.float32
    parts = _fold_parts(3, n_seg * n_doc, B, fold.rows_in, win, dt, card)
    _fold_on_card(parts, fold, B > 1)
    # the same values one element into a larger buffer
    shifted = []
    for p in parts:
        buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=card)
        buf[1:] = p.reshape(-1)
        shifted.append(buf[1:].view(p.shape))
    _fold_on_card(shifted, fold, B > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("log2_local", [16, 18])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_compact_tail_fold_on_card(card, log2_local, x64):
    """Phase 14's compact merged fold at G_local = 2^16 and 2^18 (tails of
    2^17 and 2^19 entries, in the lane order), every column normal floats
    with NaN, +-inf and +-0.0, bit for bit against its plain version."""
    fold, parts = cs.compact_fold_case(
        1, log2_local, np.float64 if x64 else np.float32, card, floats=True)
    assert len(fold.ltail) == fold.T == 8
    assert (np.diff(fold.toff) == 2 << log2_local).all()
    _fold_on_card(parts, fold, False)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_fold_lists_at_the_threshold_on_card(card, B, x64):
    """Main rows of 0, LONG_LIST, LONG_LIST + 1 and many entries at each
    op code, all in list order; tails of 0, LONG_LIST (in list order),
    LONG_LIST + 1 and many entries (in the lane order over a block), bit
    for bit against the plain version."""
    thr, P, rows_in, win = tk.MeshFold.LONG_LIST, 4, 300, 5
    rng = np.random.default_rng(thr + B)
    lens = [0, thr, thr + 1, 3, 1000, thr - 1]
    off = np.concatenate([[0], np.cumsum(lens)])
    src = (rng.integers(0, P, off[-1]) << 32) | rng.integers(0, rows_in,
                                                            off[-1])
    tlens = [thr + 1, 0, thr, 5000, 1]
    toff = np.concatenate([[0], np.cumsum(tlens)])
    tsrc = (rng.integers(0, P, toff[-1]) << 32) | rng.integers(
        0, rows_in, toff[-1])
    fold = tk.MeshFold(len(lens), 3, 1, rows_in, win, (0, 1, 2), off, src,
                       4, toff, tsrc)
    assert fold.ltail.tolist() == [0, 3]
    parts = _fold_parts(5, P, B, rows_in, win,
                        np.float64 if x64 else np.float32, card)
    _fold_on_card(parts, fold, B > 1)


@pytest.mark.cuda
def test_compact_sql_on_card_equals_the_cpu(card, tmp_path):
    """A wide GROUP BY and DISTINCT (compact keys) through the engine on
    the card, alone, on a logical 4x2 mesh (merged and sharded), equal the
    CPU engine's rows."""
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, TableConfig)
    from pinot_tpu_torch.parallel.mesh import make_mesh
    from pinot_tpu_torch.query.context import QueryContext
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.segment.creator import SegmentCreator
    from pinot_tpu_torch.segment.loader import load_segment
    from pinot_tpu_torch.utils.config import PinotConfiguration
    rng = np.random.default_rng(8)
    segs = []
    for i in range(4):
        n = 20_000 + 500 * i
        out = str(tmp_path / f"c{i}")
        SegmentCreator(TableConfig("t"), Schema("t", [
            FieldSpec("a", DataType.INT), FieldSpec("b", DataType.LONG),
            FieldSpec("c", DataType.INT),
            FieldSpec("m", DataType.INT, FieldType.METRIC)])).build(
                {"a": rng.integers(0, 1000, n).astype(np.int32),
                 "b": rng.integers(0, 1 << 40, n).astype(np.int64) % 1500,
                 "c": rng.integers(0, 900, n).astype(np.int32),
                 "m": rng.integers(0, 1000, n).astype(np.int32)}, out, "s")
        segs.append(load_segment(out))
    sqls = ["SELECT a, b, c, COUNT(*), SUM(m), MIN(m) FROM t WHERE m < 700 "
            "GROUP BY a, b, c ORDER BY COUNT(*) DESC, a, b, c LIMIT 50",
            "SELECT DISTINCT a, b, c FROM t WHERE c < 90 "
            "ORDER BY a, b, c LIMIT 100000"]
    want = QueryExecutor(segs, device="cpu")
    runs = [QueryExecutor(segs)]
    for merge in (True, False):
        cfg = PinotConfiguration(
            {"pinot.server.mesh.collective.merge": merge})
        runs.append(QueryExecutor(segs, config=cfg, mesh=make_mesh(
            ["cuda:0"] * 8, doc_axis=2)))
    for sql in sqls:
        rows = want.execute(sql).rows
        for ex in runs:
            assert ex.execute(sql).rows == rows, sql
    plan, _ = runs[0].engine._plan(segs, QueryContext.from_sql(sqls[0]))
    assert plan.group_compact
    assert runs[1].engine.meter("mesh_merge_served") == 1


# ---------------------------------------------------------------------------
# K2's table tiers (warp, block, global: csrc/group_agg.cu) and
# K4's compacting select (csrc/topn.cu), bit for bit against the plain
# versions: counts, min / max (+-0.0 and NaN included) and top-N rows
# exact, sums within the tolerance above
# ---------------------------------------------------------------------------

TIER_OPS = ("sum", "min", "max", "count")


def _tier_last(t: int, f64: bool) -> int:
    """The largest G whose TIER_OPS table takes tier index t or below."""
    lo, hi = 1, _cuda.MAX_GROUPS
    while lo < hi:
        mid = (lo + hi + 1) // 2
        tier = _cuda.group_tier(list(TIER_OPS), mid, f64)
        if _cuda.GROUP_TIERS.index(tier) <= t:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _tier_edges(f64: bool) -> list:
    """G at each tier's edge: the largest warp and block tables, and one
    group past each."""
    out = []
    for t in range(2):
        g = _tier_last(t, f64)
        out += [g, g + 1]
    return out


def _word_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64
                               else torch.int32)


def _assert_group_exact(spec, ref, out, scale, x64):
    """Sums within the tolerance; counts and min / max bit for bit, the
    sign of a zero and a NaN's bits included."""
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(), scale,
                           x64)
    for j, (op, _v, _f) in enumerate(spec["agg_ops"]):
        if op in ("count", "min", "max"):
            assert torch.equal(_word_bits(out[..., j]),
                               _word_bits(ref[..., j])), (j, op)


def _tier_case(card, G, S, D, x64, seed, one_key=False):
    """A compact-key SUM / MIN / MAX / COUNT plan under a neq filter and the
    validity mask: values with a third at +-0.0 and some NaN, the keys
    skewed low (or every doc on the last key)."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    rng = np.random.default_rng(seed)
    vnp = np.float64 if x64 else np.float32
    x = rng.uniform(-50, 50, (S, D))
    zero = rng.random((S, D)) < 1 / 3
    x[zero] = rng.choice(np.array([0.0, -0.0]), int(zero.sum()))
    x[rng.random((S, D)) < 0.001] = np.nan
    gkey = np.full((S, D), G - 1, np.int32) if one_key else \
        tp.compact_gkey(seed, S, D, G)
    cols = {"gkey": gkey, "ids:f": rng.integers(0, 10, (S, D)).astype(
                np.int8), "val:x": x.astype(vnp),
            "vmask": rng.random((S, D)) < 0.8}
    nd = np.full(S, D, np.int32)
    nd[-1] = D - 777
    spec = dict(filter_ir=("leaf", 0), leaves=(DeviceLeaf("neq", "f"),),
                value_irs=(("col", "x"),),
                agg_ops=tuple((op, None if op == "count" else 0, None)
                              for op in TIER_OPS),
                group_cols=("a",), group_compact=True, dict_cols=("f",),
                raw_cols=("x",), valid_mask=True)
    params = {"leaf0:idx": np.full(S, 3, np.int32)}
    return spec, tk.from_jax_staged(cols, params, nd, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", range(4), ids=["warp", "warp+1", "block",
                                                 "block+1"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_group_agg_tier_edges_on_card(card, edge, B, x64):
    """K2 at each tier's edge (the largest warp and block tables and one
    group past each), B = 1 and 8 members over one column set, each its
    own neq literal: against the plain (batched) version and, at B = 8,
    each member's single launch."""
    G = _tier_edges(x64)[edge]
    want = ("warp", "block", "global")[(edge + 1) // 2]
    assert _cuda.group_tier(list(TIER_OPS), G, x64) == want
    S, D = 3, max(20_000, 3 * G)
    spec, (tc, tpar, tnd) = _tier_case(card, G, S, D, x64, 11 + edge)
    plan = DevicePlan(**spec)
    vdt = torch.float64 if x64 else torch.float32
    plist = [dict(tpar, **{"leaf0:idx": torch.full(
        (S,), m, dtype=torch.int32, device=card)}) for m in range(B)]
    out = tk.batched_kernel(plan, vdt)([tc], plist, [tnd], [0] * B, D, G)
    ref = tk.plain_batched_kernel(plan, vdt)([tc], plist, [tnd], [0] * B,
                                             D, G)
    torch.cuda.synchronize()
    single = tk.make_kernel(plan, vdt)
    for m in range(B):
        scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
            plan, tc, plist[m], tnd, D, G).items()}
        _assert_group_exact(spec, ref[m], out[m], scale, x64)
        if B > 1:
            _assert_group_exact(spec, single(tc, plist[m], tnd, D, G),
                                out[m], scale, x64)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [35, 1024, 65536, 1 << 20],
                         ids=["warp", "block", "global", "global-cap"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_group_agg_every_doc_on_one_key_on_card(card, G, x64):
    """Every doc on the last key: each warp's 32 lanes share it, so its
    leader folds the whole warp."""
    S, D = 3, 300_000
    spec, (tc, tpar, tnd) = _tier_case(card, G, S, D, x64, 5, one_key=True)
    plan = DevicePlan(**spec)
    vdt = torch.float64 if x64 else torch.float32
    out = tk.make_kernel(plan, vdt)(tc, tpar, tnd, D, G)
    ref = tk.plain_kernel(plan, vdt)(tc, tpar, tnd, D, G)
    scale = {j: v.cpu().numpy() for j, v in tk.abs_contributions(
        plan, tc, tpar, tnd, D, G).items()}
    _assert_group_exact(spec, ref, out, scale, x64)
    assert int(out[:, G - 1, 3].sum()) > 0 and int(out[:, :G - 1, 3].sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("hosts,count", [(4000, 12), (1, 720)],
                         ids=["ts.3-global", "ts.1-block"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_time_bucket_with_validity_mask_on_card(card, hosts, count, x64):
    """K2's fused bucket under the validity mask, in the global tier (4000
    hosts x 16 buckets) and the block tier (1 x 1024), max and count bit
    for bit."""
    S, D = 4, 60_000
    spec, cols, params, nd = _bucket_case(card, 3, S, D, hosts, count,
                                          3_600_000 if count == 12
                                          else 60_000, x64)
    cols = _with_mask(card, cols, 8, S, D)
    spec = dict(spec, valid_mask=True)
    plan = DevicePlan(**spec)
    vdt = torch.float64 if x64 else torch.float32
    out = tk.make_kernel(plan, vdt)(cols, params, nd, D)
    ref = tk.plain_kernel(plan, vdt)(cols, params, nd, D)
    scale = {j: v.cpu().numpy()
             for j, v in tk.abs_contributions(plan, cols, params, nd, D).items()}
    _assert_group_exact(spec, ref, out, scale, x64)


def _topn_check(card, spec, cols, params, nd, D, x64):
    vdt = torch.float64 if x64 else torch.float32
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    plan = DevicePlan(**spec)
    out = tk.make_topn_kernel(plan, vdt)(tc, tpar, tnd, D)
    ref = tk.topn_kernel(plan, tc, tpar, tnd, D, vdt)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    return out.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_topn_ties_at_the_threshold_across_blocks_on_card(card, x64):
    """Most docs tie at the k-th key, across many blocks of a segment:
    the winners are the docs above it and then the lowest tied docs, in
    doc order."""
    S, D, k = 3, 300_003, 1000
    spec = tp.topn_spec(0, "col", False, k, filtered=False)
    rng = np.random.default_rng(4)
    x = np.where(rng.random((S, D)) < 0.7, 5.0, 1.0)
    top = rng.random((S, D)) < 0.001  # about 300 above the tie
    x[top] = 6.0
    vnp = np.float64 if x64 else np.float32
    nd = np.array([D, D - 5, 0], np.int32)
    got = _topn_check(card, spec, {"val:x": x.astype(vnp)}, {}, nd, D, x64)
    for s in range(2):
        xs = x[s, :nd[s]]
        above = np.flatnonzero(xs == 6.0)
        tied = np.flatnonzero(xs == 5.0)[:k - len(above)]
        assert got[s, 0] == nd[s]
        assert list(got[s, 1:]) == list(above) + list(tied)
    assert got[2, 0] == 0 and (got[2, 1:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("keep", ["exactly-k", "none", "every"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_topn_filter_keeps_k_none_or_every_doc_on_card(card, keep, x64):
    """A range filter keeping exactly k docs, none or every doc: the
    matched count, the winners and the -1 past them."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    S, D, k = 3, 100_003, 1000
    rng = np.random.default_rng(9)
    ids = np.zeros((S, D), np.int8)
    for s in range(S):
        ids[s, rng.choice(D, k, replace=False)] = 1
    lo = {"exactly-k": 1, "none": 2, "every": 0}[keep]
    spec = dict(tp.topn_spec(0, "col", True, k, filtered=False),
                filter_ir=("leaf", 0), leaves=(DeviceLeaf("range", "a"),),
                dict_cols=("a",))
    vnp = np.float64 if x64 else np.float32
    cols = {"ids:a": ids, "val:x": rng.integers(-3, 4, (S, D)).astype(vnp)}
    params = {"leaf0:lo": np.full(S, lo, np.int32),
              "leaf0:hi": np.full(S, 1, np.int32)}
    got = _topn_check(card, spec, cols, params, np.full(S, D, np.int32), D,
                      x64)
    want = {"exactly-k": k, "none": 0, "every": D}[keep]
    assert (got[:, 0] == want).all()
    assert ((got[:, 1:] >= 0).sum(1) == min(want, k)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_topn_stacked_eight_members_on_card(card, x64):
    """K4's member axis at B = 8 stacked (each member its own column set)
    over many blocks a segment: each member against the plain batched
    version and its single launch."""
    B, S, D = 8, 4, 120_001
    spec = tp.topn_spec(1, "col", True, 1000)
    vnp = np.float64 if x64 else np.float32
    vdt = torch.float64 if x64 else torch.float32
    sets = [tk.from_jax_staged(*tp.topn_inputs(20 + u, spec, S, D, vnp),
                               device=card) for u in range(B)]
    plan = DevicePlan(**spec)
    cols = [c for c, _p, _n in sets]
    plist = [p for _c, p, _n in sets]
    nds = [n for _c, _p, n in sets]
    out = tk.batched_kernel(plan, vdt)(cols, plist, nds, list(range(B)), D)
    ref = tk.plain_batched_kernel(plan, vdt)(cols, plist, nds,
                                             list(range(B)), D)
    assert torch.equal(out, ref)
    single = tk.make_topn_kernel(plan, vdt)
    for m in range(B):
        assert torch.equal(out[m], single(cols[m], plist[m], nds[m], D))


# ---------------------------------------------------------------------------
# K1's tile evaluator and K7's per-logtype lookup at their edges
# ---------------------------------------------------------------------------

#: K1 tile cases: D a multiple of PT_TILE (full tiles take 16-byte loads)
#: or not (every doc a scalar load), one block a segment or several
TILE_DS = [4096, 4099, 196_608]


def _tile_case(card, D, kept, x64, mask, seed=3):
    """A K1 plan whose leaves read every staged dtype through each path of
    the tile evaluator: an i8 range, an i16 neq, an i32 LUT of 64 entries
    (a bit set), an i8 LUT of 128 (a row in shared memory), an i16 LUT of
    8192 (global memory), a float vrange (f32 or f64) and a vrange64 over
    i32 planes, under a filter three levels deep; value, exact-sum, COUNT
    and agg FILTER slots. Segments hold D - 5, 1, 0, D, 17 and D // 2 + 3
    docs (ragged tails, a one-doc and an empty segment). `kept`: 'some',
    'all' (a range holding every id) or 'none' (an empty range) for the
    main filter."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    rng = np.random.default_rng(seed)
    S = 6
    vnp = np.float64 if x64 else np.float32
    nd = np.array([D - 5, 1, 0, D, 17, D // 2 + 3], np.int32)
    t = rng.integers(-(1 << 40), 1 << 40, (S, D)).astype(np.int64)
    cols = {"ids:a": rng.integers(0, 128, (S, D)).astype(np.int8),
            "ids:b": rng.integers(0, 8192, (S, D)).astype(np.int16),
            "ids:d": rng.integers(0, 64, (S, D)).astype(np.int32),
            "val:x": (rng.uniform(-100, 100, (S, D))).astype(vnp),
            "val:u": rng.integers(0, 100_000, (S, D)).astype(vnp),
            "val:i": rng.integers(-5000, 5000, (S, D)).astype(vnp),
            "valhi:t": (t >> 24).astype(np.int32),
            "vallo:t": (t & 0xFFFFFF).astype(np.int32)}
    leaves = (DeviceLeaf("range", "a"), DeviceLeaf("neq", "b"),
              DeviceLeaf("lut", "d"), DeviceLeaf("lut", "a"),
              DeviceLeaf("lut", "b"), DeviceLeaf("vrange", "x"),
              DeviceLeaf("vrange64", "t"))
    lo = rng.integers(-10, 60, S)
    a = rng.integers(-(1 << 40), 0, S)
    b = a + rng.integers(0, 1 << 41, S)
    params = {"leaf0:lo": lo.astype(np.int32),
              "leaf0:hi": (lo + 50).astype(np.int32),
              "leaf1:idx": rng.integers(0, 8192, S).astype(np.int32),
              "leaf2:lut": rng.random((S, 64)) < 0.6,
              "leaf3:lut": rng.random((S, 128)) < 0.6,
              "leaf4:lut": rng.random((S, 8192)) < 0.6,
              "leaf5:lo": rng.uniform(-100, 0, S).astype(vnp),
              "leaf5:hi": rng.uniform(0, 100, S).astype(vnp),
              "leaf6:lohi": (a >> 24).astype(np.int32),
              "leaf6:lolo": (a & 0xFFFFFF).astype(np.int32),
              "leaf6:hihi": (b >> 24).astype(np.int32),
              "leaf6:hilo": (b & 0xFFFFFF).astype(np.int32)}
    params["leaf1:idx"][0] = 1 << 20  # no i16 id equals it: all kept
    some = ("and", ("or", ("leaf", 0), ("not", ("leaf", 2))),
            ("or", ("leaf", 1), ("leaf", 3), ("leaf", 4)),
            ("not", ("and", ("leaf", 5), ("leaf", 6))))
    if kept != "some":  # clamped to the i8 column: [-128, 127] or empty
        params["leaf0:lo"][:] = -(2**31) if kept == "all" else 5
        params["leaf0:hi"][:] = 2**31 - 1 if kept == "all" else 4
    spec = dict(
        filter_ir=some if kept == "some" else ("leaf", 0), leaves=leaves,
        agg_filter_irs=(("or", ("leaf", 2), ("leaf", 6)),),
        value_irs=(("col", "x"),
                   ("add", ("mul", ("col", "u"), ("lit", 3.0)),
                    ("lit", 7.0)),
                   ("mul", ("sub", ("col", "i"), ("col", "u")),
                    ("lit", 2.0)),
                   ("mul", ("col", "x"), ("neg", ("col", "x")))),
        agg_ops=(("count", None, None), ("sum", 0, None), ("min", 0, None),
                 ("max", 3, None), ("isum:u3", 1, None), ("isum", 2, 0),
                 ("count", None, 0), ("sum", 3, 0), ("sumsq", 0, None)))
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    if mask:
        tc = _with_mask(card, tc, seed, S, D)
    return spec, tc, tpar, tnd


def _assert_scan_exact(spec, plan, cols, params, nd, D, vdt, out, x64):
    ref = tk.plain_kernel(plan, vdt)(cols, params, nd, D)
    scale = {j: v.cpu().numpy()
             for j, v in tk.abs_contributions(plan, cols, params, nd,
                                              D).items()}
    tp.assert_packed_equal(spec, ref.cpu().numpy(), out.cpu().numpy(),
                           scale, x64)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("D", TILE_DS)
@pytest.mark.parametrize("kept", ["some", "all", "none"])
@pytest.mark.parametrize("mask", [False, True], ids=["plain", "vmask"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_scan_tile_edges_on_card(card, D, kept, mask, x64):
    """K1's tiles against its plain version: ragged, one-doc and empty
    segments, every id dtype and LUT path, f32 / f64 and vrange64 leaves,
    the validity mask inside a tile, all docs kept and none; counts,
    exact-sum planes and min / max bit for bit."""
    spec, cols, params, nd = _tile_case(card, D, kept, x64, mask)
    plan = DevicePlan(**spec, valid_mask=mask)
    vdt = torch.float64 if x64 else torch.float32
    before = _cuda.SCAN_AGG.launches
    out = tk.make_kernel(plan, vdt)(cols, params, nd, D)
    torch.cuda.synchronize()
    assert _cuda.SCAN_AGG.launches == before + 1
    ref = _assert_scan_exact(spec, plan, cols, params, nd, D, vdt, out, x64)
    valid = tk.doc_validity(plan, cols, nd, D).sum(1)
    if kept == "all":
        assert torch.equal(ref[:, 0].double(), valid.double().to(card))
    if kept == "none":
        assert not ref[:, 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["broadcast", "stacked", "dedup"])
def test_scan_sixteen_members_in_groups_on_card(card, form):
    """K1's member axis at B = 16 on a plan of 21 accumulator words, so
    a block holds fewer members than share a column set: each member bit
    for bit against its own single launch and within tolerance of the
    plain version."""
    B, D = 16, 196_608
    U = {"broadcast": 1, "stacked": B, "dedup": 3}[form]
    idx = [0] * B if form == "broadcast" else \
        list(range(B)) if form == "stacked" else [m % U for m in range(B)]
    cases = [_tile_case(card, D, "some", False, False, seed=30 + u)
             for u in range(U)]
    spec = cases[0][0]
    plan = DevicePlan(**spec)
    sets = [c[1] for c in cases]
    nds = [c[3] for c in cases]
    plist = [_tile_case(card, D, "some", False, False, seed=60 + m)[2]
             for m in range(B)]
    before = _cuda.SCAN_AGG.batched_launches
    out = tk.batched_kernel(plan, torch.float32)(sets, plist, nds, idx, D)
    torch.cuda.synchronize()
    assert _cuda.SCAN_AGG.batched_launches == before + 1
    single = tk.make_kernel(plan, torch.float32)
    for m, u in enumerate(idx):
        one = single(sets[u], plist[m], nds[u], D)
        assert torch.equal(_bits(out[m]), _bits(one)), m
        _assert_scan_exact(spec, plan, sets[u], plist[m], nds[u], D,
                           torch.float32, out[m], False)


def _widest_case(card, D, seed):
    """A K1 plan at program.py's limits together: 64 accumulator words
    (9 exact-sum slots of 6 planes, sum / min / max / sumsq, 5 counts),
    32 filter trees with the main one MAX_FILTER_DEPTH deep and a value
    MAX_VALUE_DEPTH deep, over an i8 range, an i32 LUT and an f32 vrange.
    At 256 threads a block one member's accumulators, lists and stacks
    would need more shared memory than an H100 has; K1 takes a narrower
    block."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    rng = np.random.default_rng(seed)
    S = 4
    nd = np.array([D, D - 7, 1, D // 2], np.int32)
    cols = {"ids:a": rng.integers(0, 128, (S, D)).astype(np.int8),
            "ids:d": rng.integers(0, 64, (S, D)).astype(np.int32),
            "val:x": rng.uniform(-100, 100, (S, D)).astype(np.float32),
            "val:u": rng.integers(0, 1000, (S, D)).astype(np.float32),
            "val:i": rng.integers(-500, 500, (S, D)).astype(np.float32)}
    params = {"leaf0:lo": rng.integers(0, 40, S).astype(np.int32),
              "leaf0:hi": rng.integers(60, 128, S).astype(np.int32),
              "leaf1:lut": rng.random((S, 64)) < 0.7,
              "leaf2:lo": rng.uniform(-100, -50, S).astype(np.float32),
              "leaf2:hi": rng.uniform(50, 100, S).astype(np.float32)}
    deep = ("leaf", 0)
    for k in range(prog_mod.MAX_FILTER_DEPTH - 1):
        deep = ("or" if k % 2 else "and", ("leaf", (k + 1) % 3), deep)
    value = ("col", "u")
    for k in range(prog_mod.MAX_VALUE_DEPTH - 1):
        value = ("sub" if k % 2 else "add", ("col", "i" if k % 2 else "u"),
                 value)
    aggf = tuple(("leaf", k % 3) if k % 2 else ("not", ("leaf", k % 3))
                 for k in range(prog_mod.MAX_FILTERS - 1))
    ops = [("isum", 0, f) for f in range(9)]
    ops += [(op, 1, 9 + k) for k, op in enumerate(("sum", "min", "max",
                                                   "sumsq"))]
    ops += [("count", None, 13 + k) for k in range(5)]
    spec = dict(filter_ir=deep, leaves=(DeviceLeaf("range", "a"),
                                        DeviceLeaf("lut", "d"),
                                        DeviceLeaf("vrange", "x")),
                agg_filter_irs=aggf, value_irs=(value, ("col", "x")),
                agg_ops=tuple(ops))
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd, device=card)
    return spec, tc, tpar, tnd


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4096, 4099])
def test_scan_widest_plan_on_card(card, D):
    """K1 at program.py's limits together (64 words, 32 filters, the
    deepest filter and value programs), where 256 threads a block do not
    fit the card's shared memory: against its plain version, and at B = 3
    broadcast each member bit for bit against its single launch."""
    spec, cols, params, nd = _widest_case(card, D, 9)
    plan = DevicePlan(**spec)
    prog = prog_mod.compile_plan(plan)
    assert prog.n_acc == prog_mod.MAX_ACC
    vdt = torch.float32
    single = tk.make_kernel(plan, vdt)
    out = single(cols, params, nd, D)
    torch.cuda.synchronize()
    _assert_scan_exact(spec, plan, cols, params, nd, D, vdt, out, False)
    plist = [params] + [_widest_case(card, D, 10 + m)[2] for m in range(2)]
    got = tk.batched_kernel(plan, vdt)([cols], plist, [nd], [0] * 3, D)
    torch.cuda.synchronize()
    for m, p in enumerate(plist):
        assert torch.equal(_bits(got[m]), _bits(single(cols, p, nd, D))), m


@pytest.mark.cuda
def test_shared_memory_limits_under_concurrent_launches_on_card(card):
    """K1 and K4 launched from 8 host threads at once, each at two dynamic
    shared-memory sizes: K1 on the widest plan and on the same plan with
    4 of its 9 exact-sum slots (both past 48 KB, at different block
    widths and sizes), K4 at k = 8192 (a 64 KB sort) and k = 10. A
    kernel's shared-memory limit is the function's, shared by the
    threads, as the dispatch ring's clients launch inline on their own:
    every launch equals the plain version bit for bit."""
    D = 4096
    spec, cols, params, nd = _widest_case(card, D, 9)
    jobs = []
    for ops in (spec["agg_ops"], spec["agg_ops"][5:]):
        s = dict(spec, agg_ops=ops)
        plan = DevicePlan(**s)
        kern = tk.make_kernel(plan, torch.float32)
        out = kern(cols, params, nd, D)
        torch.cuda.synchronize()
        _assert_scan_exact(s, plan, cols, params, nd, D, torch.float32, out,
                           False)
        jobs.append((kern, (cols, params, nd, D), _bits(out)))
    for seed, k in ((0, 10), (2, 8192)):
        s = tp.topn_spec(seed, "col", seed == 2, k)
        c, p, n = tp.topn_inputs(seed, s, 5, 20_000, np.float32,
                                 pad_segments=2)
        tc, tpar, tnd = tk.from_jax_staged(c, p, n, device=card)
        plan = DevicePlan(**s)
        ref = tk.topn_kernel(plan, tc, tpar, tnd, 20_000, torch.float32)
        jobs.append((tk.make_topn_kernel(plan, torch.float32),
                     (tc, tpar, tnd, 20_000), _bits(ref)))

    def run(i):
        kern, args, ref = jobs[i % len(jobs)]
        for _ in range(25):
            out = kern(*args)
            torch.cuda.current_stream().synchronize()
            assert torch.equal(_bits(out), ref), i
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(run, i) for i in range(8)]:
            f.result()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4096, 4099])
def test_clp_mask_leaf_and_vmask_in_tiles_on_card(card, D):
    """K7's mask read by K1 as a leaf beside the validity mask, in full
    16-byte tiles (D = 4096) and scalar ones (4099)."""
    spec, cols, params, nd, _D = _clp_plan_case(card, "scan", D=D)
    plan = DevicePlan(**spec, valid_mask=True)
    cols = _with_mask(card, cols, 7, nd.shape[0], D)
    vdt = torch.float32
    out = tk.make_kernel(plan, vdt)(cols, params, nd, D)
    _assert_scan_exact(spec, plan, cols, params, nd, D, vdt, out, False)


#: K7 edges: (mode, Kd, Ke) and how the tables are bent
CLP_EDGES = {"no group names the logtype": ("b", 2, 2),
             "64 groups on one logtype": ("b", 2, 2),
             "padding groups": ("b", 2, 2),
             "ids past cp and negative": ("b", 2, 2),
             "Kd = Ke = 0": ("b", 0, 0),
             "Kd = Ke = 16": ("b", 16, 16),
             "mode a, Kd = 16": ("a", 16, 0),
             "mode a, Kd = 0": ("a", 0, 0),
             "dict-var ids past vp = 4": ("b", 2, 2),
             "mode a, dict-var ids past vp = 4": ("a", 2, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(CLP_EDGES))
@pytest.mark.parametrize("D", [4096, 4099])
def test_clp_match_edges_on_card(card, edge, D):
    """K7 bit for bit against its plain version at the edges of its
    logtype lookup and slot counts, 64 groups over 16 conditions, in full
    tiles (D = 4096) and scalar ones (4099); mode 'a' docs at the dict-var
    sentinel (clp_inputs puts a quarter there); dict-var ids past a bool
    table of 4 entries (any of them true) and negative, which K7 reads
    through the packed row's 8 bits, clipped."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    mode, kd, ke = CLP_EDGES[edge]
    S, cp = 5, 8
    vp = 4 if "past vp" in edge else 64
    cols, params = tp.clp_inputs(17, mode, S, D, kd=kd, ke=ke, cp=cp,
                                 gp=64, ncp=16, nlp=4, vp=vp)
    if "past vp" in edge:
        rng = np.random.default_rng(5)
        for key in ("leaf0:dvlut", "leaf0:dlut"):
            if key in params:
                params[key][:] = rng.random(params[key].shape) < 0.5
        for j in range(kd):
            cols[f"clpdv{j}:m"] = rng.integers(-2, vp + 6, (S, D)).astype(
                np.int32)
    if mode == "b":
        glt = params["leaf0:glt"]
        if edge == "no group names the logtype":
            glt[glt >= 0] %= 3  # logtypes 3-7 name no group
            params["leaf0:alut"][:, 3:] = False
        elif edge == "64 groups on one logtype":
            glt[:S - 1] = 3
            params["leaf0:alut"][:] = False
        elif edge == "padding groups":
            glt[:, 40:] = -1
    if edge == "ids past cp and negative":
        rng = np.random.default_rng(4)
        ids = cols["clpid:m"]
        ids[rng.random(ids.shape) < 0.2] = cp + 3
        ids[rng.random(ids.shape) < 0.1] = -2
        params["leaf0:glt"][:, :4] = cp + 3
    leaf = DeviceLeaf("clp", "m", (mode, kd, ke))
    params.update(clp_device.pack_banks(params))
    tc, tpar, _ = tk.from_jax_staged(cols, params, np.zeros(S, np.int32),
                                     device=card)
    out = _cuda.clp_match([(0, leaf)], tc, tpar, D)
    ref = tk.clp_match(0, leaf, tc, tpar)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref)
    assert bool(ref.any())


def _raw_segment(path, name: str, dtype, values):
    """One segment of one raw column `name`, written by the port's
    creator."""
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, TableConfig)
    from pinot_tpu_torch.segment.creator import SegmentCreator
    from pinot_tpu_torch.segment.loader import load_segment
    tc = TableConfig("t")
    tc.indexing.no_dictionary_columns = [name]
    out = str(path / name)
    SegmentCreator(tc, Schema("t", [FieldSpec(name, getattr(DataType, dtype),
                                              FieldType.METRIC)])).build(
        {name: np.asarray(values)}, out, f"t_{name}")
    return load_segment(out)


@pytest.mark.cuda
@pytest.mark.parametrize("vdt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_scan_at_the_denormal_bound_on_card(card, tmp_path, vdt):
    """K1 at the bound nextafter(0, -inf) (the staged form of `rd < 0`)
    and nextafter(0, inf) (`rd > 0`), with both zeros among the docs: the
    card keeps denormals (no -ftz), so +0.0 and -0.0 match neither, as on
    the host: 2 and 1 over [0.0, -0.0, -1.0, 2.0, -3.5], and equal to the
    plain version on the CPU."""
    from pinot_tpu_torch.query.executor import QueryExecutor
    seg = _raw_segment(tmp_path, "rd", "DOUBLE",
                       np.array([0.0, -0.0, -1.0, 2.0, -3.5]))
    ex = QueryExecutor([seg], device=card, value_dtype=vdt)
    plain = QueryExecutor([seg], device="cpu", value_dtype=vdt)
    for sql, want in (("SELECT COUNT(*) FROM t WHERE rd < 0", 2),
                      ("SELECT COUNT(*) FROM t WHERE rd > 0", 1),
                      ("SELECT COUNT(*) FROM t WHERE rd <= 0", 4),
                      ("SELECT COUNT(*) FROM t WHERE rd >= 0", 3)):
        before = _cuda.SCAN_AGG.launches
        assert ex.execute(sql).rows == [(want,)], (sql, vdt)
        assert _cuda.SCAN_AGG.launches == before + 1
        assert plain.execute(sql).rows == [(want,)], (sql, vdt)


@pytest.mark.cuda
@pytest.mark.parametrize("vdt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_float_literal_read_as_float32_on_card(card, tmp_path, vdt):
    """A FLOAT column against 0.1, which float32 cannot hold: K1 compares
    with 0.1f in either value dtype, as the host filter does."""
    from pinot_tpu_torch.query.executor import QueryExecutor
    vals = np.array([0.1, 0.2, 0.1, -1.0, 0.05, 1.0], dtype=np.float32)
    seg = _raw_segment(tmp_path, "rf", "FLOAT", vals)
    ex = QueryExecutor([seg], device=card, value_dtype=vdt)
    for sql, want in (("SELECT COUNT(*) FROM t WHERE rf > 0.1", 2),
                      ("SELECT COUNT(*) FROM t WHERE rf = 0.1", 2),
                      ("SELECT COUNT(*) FROM t WHERE rf < 0.1", 2)):
        assert ex.execute(sql).rows == [(want,)], (sql, vdt)


@pytest.mark.cuda
def test_cluster_on_card_answers_as_cpu(card, tmp_path):
    """A two-server cluster on the card (MiniCluster() takes every CUDA
    device) answers every srv shape of torch_tables.SHAPES through its
    broker as a device="cpu" cluster does: integral values equal, floats
    within rel 1e-5 (float32 both), and the device shapes launch K1."""
    import math

    import torch_tables as tt
    from pinot_tpu_torch.cluster.mini import MiniCluster
    dirs = tt.build_table(str(tmp_path), "srv")
    clusters = [MiniCluster(num_servers=2), MiniCluster(num_servers=2,
                                                        device="cpu")]
    try:
        for c in clusters:
            c.start()
            c.add_table("srv")
            for i, d in enumerate(dirs):
                c.add_segment("srv", d, i % 2)
        k1 = _cuda.SCAN_AGG.launches
        for shape, (table, sql) in tt.SHAPES.items():
            if table != "srv":
                continue
            got, want = (c.query(sql) for c in clusters)
            assert got.exceptions == [] and not got.partial_result, shape
            assert got.num_servers_responded == 2, shape
            assert got.result_table.columns == want.result_table.columns
            assert len(got.rows) == len(want.rows), shape
            for gr, wr in zip(got.rows, want.rows):
                for g, w in zip(gr, wr):
                    if isinstance(w, (str, bool)) or w is None:
                        assert g == w, shape
                    else:
                        assert math.isclose(float(g), float(w),
                                            rel_tol=1e-5, abs_tol=1e-9), (
                            shape, g, w)
        assert _cuda.SCAN_AGG.launches > k1
    finally:
        for c in clusters:
            c.stop()
