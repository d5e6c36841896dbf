"""K1 scan_agg, K2 group_agg, K3 sketch_agg, K4 topn and K5 startree_agg on
the card against their plain PyTorch versions on the card, over the seeded
random plans of tests/torch_plans.py.

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
|contribution| (both add in double, in other orders).
"""
import os
import sys

import numpy as np
import pytest
import torch

from pinot_tpu_torch.ops import _cuda
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import startree_device as tsd
from pinot_tpu_torch.ops.plan_ir import DevicePlan

# by path: on the card's machine another installed 'tests' package can
# shadow this repo's, and this file runs there without the repo's conftest
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
def test_sketch_kernel_global_atomics_path(card, x64):
    """log2m 16 does not fit beside the others in shared memory: K3
    updates that slot's global table with atomics."""
    spec = tp.random_sketch_spec(21, log2ms=(12, 16), scalar=False)
    _sketch_case(card, spec, x64, 5, 70_000, 21)


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
