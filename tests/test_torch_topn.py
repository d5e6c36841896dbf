"""The port's top-N kernel (plain version) against the JAX package's.

`pinot_tpu_torch.ops.kernels.topn_kernel` and
`pinot_tpu.ops.kernels.make_topn_kernel(plan)` run on the same seeded numpy
inputs (tests/torch_plans.py: random filters of every leaf kind, order
values from a small integer range so ties are dense, with -0.0, +0.0, NaN
and +-inf among them) and must agree EXACTLY on the [S, 1 + k] int32
output, under x64 (float64 scores) and with x64 off (float32 scores). No
tolerance: the output is doc ids and counts.

A numpy mirror of K4 (csrc/topn.cu) runs the program `compile_plan` emits
for a top-N plan, with K4's unsigned key encoding, and is held to the
plain version: the program encoding and the key order are checked here,
on the CPU, where the kernel cannot run.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.ops import kernels as jk
from pinot_tpu.ops import plan_ir as jir

from pinot_tpu_torch.ops import _cuda
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import program as pg
from pinot_tpu_torch.ops.plan_ir import DevicePlan
from tests import torch_plans as tp

S, D = 4, 512


def jax_topn(spec, cols, params, num_docs, D, x64):
    leaves = tuple(jir.DeviceLeaf(lf.kind, lf.column)
                   for lf in spec["leaves"])
    plan = jir.DevicePlan(**{**spec, "leaves": leaves})
    with jax.enable_x64(x64):
        fn = jk.make_topn_kernel(plan)
        out = fn({k: jnp.asarray(v) for k, v in cols.items()},
                 {k: jnp.asarray(v) for k, v in params.items()},
                 jnp.asarray(num_docs), D)
        return np.asarray(out)


def port_topn(spec, cols, params, num_docs, D, x64):
    tc, tpar, tnd = tk.from_jax_staged(cols, params, num_docs)
    out = tk.make_topn_kernel(
        DevicePlan(**spec), torch.float64 if x64 else torch.float32)(
            tc, tpar, tnd, D)
    assert out.dtype == torch.int32
    return out.numpy()


def both(spec, cols, params, nd, D, x64):
    ref = jax_topn(spec, cols, params, nd, D, x64)
    out = port_topn(spec, cols, params, nd, D, x64)
    assert ref.shape == out.shape == (len(nd), 1 + min(spec["topn_k"], D))
    assert np.array_equal(ref, out)
    return out


KS = (1, 37, 300)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("order", list(tp.TOPN_ORDERS))
@pytest.mark.parametrize("asc", [False, True], ids=["desc", "asc"])
@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_topn_matches_jax(seed, order, asc, x64):
    spec = tp.topn_spec(seed, order, asc, KS[seed])
    cols, params, nd = tp.topn_inputs(seed, spec, S, D,
                                      np.float64 if x64 else np.float32)
    out = both(spec, cols, params, nd, D, x64)
    assert out[-1, 0] == 0 and (out[-1, 1:] == -1).all()  # padded segment


@pytest.mark.parametrize("order", list(tp.TOPN_ORDERS))
@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_topn_without_filter(order, x64):
    spec = tp.topn_spec(11, order, False, 64, filtered=False)
    cols, params, nd = tp.topn_inputs(11, spec, S, D,
                                      np.float64 if x64 else np.float32)
    out = both(spec, cols, params, nd, D, x64)
    assert (out[:-1, 0] == nd[:-1]).all()


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_topn_k_beyond_matches_and_block(x64):
    """k > D gives k = D columns; segments with fewer matches than k
    fill the rest with -1."""
    spec = tp.topn_spec(5, "col", False, 3 * D)
    cols, params, nd = tp.topn_inputs(5, spec, S, D,
                                      np.float64 if x64 else np.float32)
    out = both(spec, cols, params, nd, D, x64)
    found = (out[:, 1:] >= 0).sum(1)
    assert (found == out[:, 0]).all()


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_topn_signed_zero_ranks_above_negative_zero(x64):
    """lax.top_k ranks +0.0 above -0.0 (the total order of the float's
    bits), and a matched -inf above every unmatched doc; a stable sort of
    the float scores would hold the zeros equal."""
    vdt = np.float64 if x64 else np.float32
    x = np.array([[-0.0, 0.0, -0.0, 0.0, 1.0, -np.inf, 1.0, 0.0]], vdt)
    spec = dict(filter_ir=None, leaves=(), value_irs=(("col", "x"),),
                agg_ops=(), mode="topn", topn_k=7, topn_asc=False)
    nd = np.array([7], np.int32)
    out = both(spec, {"val:x": x}, {}, nd, 8, x64)
    assert out.tolist() == [[7, 4, 6, 1, 3, 0, 2, 5]]
    # ascending negates: -inf becomes the top score, -0.0 the +0.0 that
    # ranks above +0.0 turned -0.0
    spec["topn_asc"] = True
    out = both(spec, {"val:x": x}, {}, nd, 8, x64)
    assert out.tolist() == [[7, 5, 0, 2, 1, 3, 4, 6]]


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_topn_ties_break_toward_lower_doc(x64):
    vdt = np.float64 if x64 else np.float32
    x = np.array([[2.0, 5.0, 2.0, 5.0, np.nan, 2.0, 5.0, 1.0],
                  [3.0] * 8], vdt)
    ids = np.array([[1, 1, 1, 1, 1, 0, 1, 1], [1, 0, 1, 0, 1, 0, 1, 0]],
                   np.int8)
    spec = dict(filter_ir=("leaf", 0),
                leaves=(tp.DeviceLeaf("range", "a"),),
                value_irs=(("col", "x"),), agg_ops=(), mode="topn",
                topn_k=6, topn_asc=False)
    params = {"leaf0:lo": np.array([1, 1], np.int32),
              "leaf0:hi": np.array([1, 1], np.int32)}
    nd = np.array([8, 7], np.int32)
    out = both(spec, {"val:x": x, "ids:a": ids}, params, nd, 8, x64)
    # NaN ranks last among matched docs; doc 5 is filtered out
    assert out.tolist() == [[7, 1, 3, 6, 0, 2, 7], [4, 0, 2, 4, 6, -1, -1]]


# ---------------------------------------------------------------------------
# numpy mirror of K4 over the compiled program
# ---------------------------------------------------------------------------

def k4_key(score: np.ndarray) -> np.ndarray:
    """csrc/topn.cu KeyOf<T>::of: the float's bits, sign bit set for
    non-negative values and all bits flipped for negative ones, as
    unsigned integers."""
    if score.dtype == np.float32:
        b = score.view(np.uint32)
        return np.where(b >> 31, ~b, b | np.uint32(1 << 31))
    b = score.view(np.uint64)
    return np.where(b >> np.uint64(63), ~b, b | np.uint64(1 << 63))


def run_topn_program(plan, cols, params, num_docs, D, vdt):
    """What K4 computes, per the program `compile_plan` emits: keys from
    the main filter and value 0, the top k by (key desc, doc asc), -1 where
    the key is that of -inf."""
    pm = tp.ProgramMirror(plan, cols, params, num_docs, D)
    code = pm.code
    T = np.dtype(vdt).type
    fin = np.finfo(vdt)
    k = min(plan.topn_k, D)
    unmatched = k4_key(np.array([-np.inf], vdt))[0]
    out = np.zeros((len(num_docs), 1 + k), np.int32)
    for s in range(len(num_docs)):
        n = pm.segment(s)
        m = pm.filt(code[pg.H_MAIN]) if code[pg.H_MAIN] >= 0 \
            else np.ones(n, bool)
        if code[pg.H_NVAL]:
            v = pm.value(0, T)
            score = -v if plan.topn_asc else v
        else:
            score = -np.arange(n, dtype=vdt)
        score = np.where(np.isnan(score), fin.min, score)
        score = np.clip(score, fin.min, fin.max).astype(vdt)
        score = np.where(m, score, -np.inf).astype(vdt)
        score = np.concatenate([score, np.full(D - n, -np.inf, vdt)])
        key = k4_key(score)
        docs = np.arange(D)
        order = np.lexsort((docs, ~key))[:k]   # ~key: descending
        out[s, 0] = m.sum()
        out[s, 1:] = np.where(key[order] == unmatched, -1, order)
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("order", list(tp.TOPN_ORDERS))
@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_topn_program_mirror_matches_plain(seed, order, x64):
    vdt = np.float64 if x64 else np.float32
    spec = tp.topn_spec(seed + 20, order, seed % 2 == 0, KS[seed])
    cols, params, nd = tp.topn_inputs(seed + 20, spec, S, D, vdt)
    mirror = run_topn_program(DevicePlan(**spec), cols, params, nd, D, vdt)
    assert np.array_equal(mirror, port_topn(spec, cols, params, nd, D, x64))


def test_topn_program_encoding():
    """A top-N plan compiles to a program with no slots, its filter tree
    and one value expression; an `ids` order value reads the staged id
    block through V_IDS."""
    spec = tp.topn_spec(1, "ids", True, 10)
    prog = pg.compile_plan(DevicePlan(**spec))
    code = prog.code
    assert code[pg.H_NSLOT] == 0 and code[pg.H_NVAL] == 1
    assert code[pg.H_MAIN] == 0 and prog.out_width == 1
    start, n = tp.code_at(code, pg.H_VAL, 0, 2)
    assert n == 1 and code[start] == pg.V_IDS
    assert prog.cols[code[start + 1]] == "ids:b"
    unordered = pg.compile_plan(DevicePlan(**tp.topn_spec(1, "none", True,
                                                          10)))
    assert unordered.code[pg.H_NVAL] == 0


def test_topn_plan_shapes_are_checked():
    spec = tp.topn_spec(2, "col", False, 10)
    with pytest.raises(ValueError, match="top-N plan"):
        pg.compile_plan(DevicePlan(**{**spec,
                                      "agg_ops": (("count", None, None),)}))
    with pytest.raises(ValueError, match="top-N plan"):
        pg.compile_plan(DevicePlan(**{**spec, "topn_k": 0}))
    with pytest.raises(ValueError, match="aggregation plans"):
        tk.make_kernel(DevicePlan(**spec))
    with pytest.raises(ValueError, match="top-N plans"):
        tk.make_topn_kernel(DevicePlan(**{**spec, "mode": "agg"}))


def test_topn_cuda_wrapper_refuses_cpu_tensors():
    spec = tp.topn_spec(3, "col", False, 10)
    cols, params, nd = tp.topn_inputs(3, spec, S, D, np.float32)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    with pytest.raises(ValueError, match="CUDA kernel given tensors"):
        _cuda.topn(DevicePlan(**spec), tc, tpar, tnd, D, torch.float32)
    with pytest.raises(ValueError, match="outside"):
        _cuda.topn(DevicePlan(**{**spec, "topn_k": 9000}), tc, tpar, tnd,
                   1 << 14, torch.float32)
    assert _cuda.TOPN.launches == 0
