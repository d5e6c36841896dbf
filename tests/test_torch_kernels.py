"""The port's scan-aggregate / group-by kernels against the JAX package's.

Seeded random plans (every leaf kind, and/or/not, every value op, every
slot op on the ungrouped and grouped paths, exact-sum planes) run through
`pinot_tpu.ops.kernels.make_kernel` and the port's plain PyTorch version on
the same numpy inputs, under both precision postures:

  x64 (tests/conftest.py turns it on): float64 against float64, every
      float within rel 1e-9 of the larger of the result and the slot's
      sum of |contribution|.
  jax.enable_x64(False): float32 against float32 — counts, exact-sum
      planes and min/max bit-identical; float sums within 1e-5 of the
      slot's sum of |contribution| (the JAX kernel adds the float32 values
      in float32, the port in float64 with one rounding at the end); min/max
      of an expression where an add takes a product within 2^-20
      relative, because XLA on the CPU fuses that pair into one FMA (one
      rounding) while PyTorch rounds the product and the sum apart.

A numpy mirror of the CUDA interpreter (csrc/interp.cuh, scan_agg.cu,
group_agg.cu, sketch_agg.cu) runs the compiled program (ops/program.py) on
the same inputs and is held to the port's plain version with the same
tolerances (HLL registers and histogram buckets bit-identical): the program
encoding is checked here, on the CPU, where the kernels cannot run.
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

from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import program as pg
from pinot_tpu_torch.ops.plan_ir import DevicePlan
from pinot_tpu_torch.query.sketches import hash32_pair
from tests import torch_plans as tp

S, D = 4, 512


def jax_plan(spec):
    leaves = tuple(jir.DeviceLeaf(lf.kind, lf.column)
                   for lf in spec["leaves"])
    return jir.DevicePlan(**{**spec, "leaves": leaves})


def run_jax(spec, cols, params, num_docs, x64):
    with jax.enable_x64(x64):
        fn = jk.make_kernel(jax_plan(spec))
        out = fn({k: jnp.asarray(v) for k, v in cols.items()},
                 {k: jnp.asarray(v) for k, v in params.items()},
                 jnp.asarray(num_docs), D=cols["ids:a"].shape[1])
        return np.asarray(out)


def run_port(spec, cols, params, num_docs, vdt):
    plan = DevicePlan(**spec)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, num_docs)
    out = tk.make_kernel(plan, vdt)(tc, tpar, tnd, cols["ids:a"].shape[1])
    scale = tk.abs_contributions(plan, tc, tpar, tnd, cols["ids:a"].shape[1])
    return out.numpy(), {j: v.numpy() for j, v in scale.items()}


CASES = [(seed, grouped) for seed in range(8) for grouped in (False, True)]


@pytest.mark.parametrize("seed,grouped", CASES)
@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_random_plans_match_jax(seed, grouped, x64):
    spec = tp.random_spec(seed, grouped)
    vdt = np.float64 if x64 else np.float32
    cols, params, nd = tp.random_inputs(seed, spec, S, D, vdt,
                                        nan=seed % 3 == 0)
    ref = run_jax(spec, cols, params, nd, x64)
    out, scale = run_port(spec, cols, params, nd,
                          torch.float64 if x64 else torch.float32)
    tp.assert_packed_equal(spec, ref, out, scale, x64, fma=True)


def test_grouped_one_hot_path_matches_jax():
    """D >= 4096 and G <= 1024: the JAX kernel takes its one-hot matmul
    branch (kernels.py:296); the port's scatter-sum must agree."""
    spec = tp.random_spec(101, grouped=True)
    spec.update(group_cols=("a",), group_strides=(1,), num_groups=100)
    cols, params, nd = tp.random_inputs(101, spec, 2, 4096, np.float32)
    with jax.enable_x64(False):
        fn = jk.make_kernel(jax_plan(spec))
        ref = np.asarray(fn({k: jnp.asarray(v) for k, v in cols.items()},
                            {k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(nd), D=4096))
    out, scale = run_port(spec, cols, params, nd, torch.float32)
    tp.assert_packed_equal(spec, ref, out, scale, x64=False, fma=True)


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_narrow_ids_sentinel_bounds(x64):
    """int32 bounds clamp into i8/i16 ids: hi = 2^31-1 matches everything,
    [0, -1] nothing, neq -1 everything; padded segments count nothing."""
    leaves = tuple(tp.DeviceLeaf(k, c) for k, c in
                   [("range", "a"), ("range", "b"), ("neq", "a")])
    spec = dict(filter_ir=("and", ("leaf", 0), ("not", ("leaf", 1)),
                           ("leaf", 2)),
                leaves=leaves, value_irs=(("col", "x"),),
                agg_ops=(("count", None, None), ("sum", 0, None),
                         ("min", 0, None), ("max", 0, None)))
    vdt = np.float64 if x64 else np.float32
    cols, _p, nd = tp.random_inputs(5, spec, S, D, vdt, pad_segments=2)
    params = {"leaf0:lo": np.array([0, 5, 0, 0], np.int32),
              "leaf0:hi": np.array([2**31 - 1, 2**31 - 1, -1, 2**31 - 1],
                                   np.int32),
              "leaf1:lo": np.array([0, 0, 0, 0], np.int32),
              "leaf1:hi": np.array([-1, 200, -1, -1], np.int32),
              "leaf2:idx": np.array([-1, 3, -1, -1], np.int32)}
    ref = run_jax(spec, cols, params, nd, x64)
    out, scale = run_port(spec, cols, params, nd,
                          torch.float64 if x64 else torch.float32)
    tp.assert_packed_equal(spec, ref, out, scale, x64, fma=True)
    assert out[0, 0] == nd[0]                    # everything matched
    assert out[2, 0] == 0 and out[3, 0] == 0     # none / padded segment
    assert out[3, 3] == np.inf and out[3, 4] == -np.inf


def test_nan_propagates_through_min_max():
    spec = dict(filter_ir=None, leaves=(), value_irs=(("col", "x"),),
                agg_ops=(("min", 0, None), ("max", 0, None),
                         ("sum", 0, None)))
    cols, params, nd = tp.random_inputs(9, spec, S, D, np.float32,
                                        pad_segments=0)
    cols["val:x"][1, 7] = np.nan
    nd[1] = max(nd[1], 8)
    ref = run_jax(spec, cols, params, nd, x64=False)
    out, scale = run_port(spec, cols, params, nd, torch.float32)
    tp.assert_packed_equal(spec, ref, out, scale, x64=False, fma=True)
    assert np.isnan(out[1, 1:]).all() and not np.isnan(out[0, 1:]).any()


# ---------------------------------------------------------------------------
# numpy mirror of the CUDA interpreter, driven by the compiled program
# ---------------------------------------------------------------------------

def run_program(plan, cols, params, num_docs, D, vdt, G=0):
    """What K1 / K2 / K3 compute, per the program `compile_plan` emits (G:
    a compact-key plan's group count)."""
    pm = tp.ProgramMirror(plan, cols, params, num_docs, D)
    code, colarr = pm.code, pm.colarr
    Sn = len(num_docs)
    T = np.dtype(vdt).type
    G = plan.num_groups or G
    if G:
        out = np.zeros((Sn, G, code[pg.H_OUTW]), np.float64)
    else:
        out = np.zeros((Sn, code[pg.H_OUTW]), np.float64)
    for s in range(Sn):
        n = pm.segment(s)
        prm, col, filt, value = pm.prm, pm.col, pm.filt, pm.value

        main = code[pg.H_MAIN]
        m0 = filt(main) if main >= 0 else np.ones(n, bool)
        if G:
            key = np.zeros(n, np.int64)
            for g in range(code[pg.H_NGCOL]):
                c, stride = tp.code_at(code, pg.H_GCOL, g, 2)
                key += col(c).astype(np.int64) * stride
            m0 &= (key >= 0) & (key < G)
        acc = {}
        for j in range(code[pg.H_NSLOT]):
            op, v, f, w, planes, oc, c0, c1 = tp.code_at(code, pg.H_SLOT, j,
                                                       pg.SLOT_W)
            m = m0 & filt(f) if f >= 0 else m0
            if op == pg.S_HLL:
                h1, h2 = hash32_pair(
                    colarr[c0][s, :n][m].astype(np.uint32),
                    colarr[c1][s, :n][m].astype(np.uint32))
                reg = (h1 & np.uint32((1 << planes) - 1)).astype(np.int64)
                e = np.frexp(h2.astype(np.float64))[1]
                tab = np.zeros(1 << planes)
                np.maximum.at(tab, reg, np.where(h2 != 0, 33 - e, 33))
                out[s, oc:oc + (1 << planes)] = tab
                continue
            if op == pg.S_HIST:
                with np.errstate(all="ignore"):
                    t = ((value(v, T) - T(prm[c0])) * T(prm[c1])).astype(T)
                t = np.where(np.isnan(t), 0, np.clip(t, 0, planes - 1))
                out[s, oc:oc + planes] = np.bincount(
                    t[m].astype(np.int64), minlength=planes)
                continue
            if op in (pg.S_ISUM, pg.S_ISUM_U):
                vi = value(v, np.int32)[m]
                bits, mask_ = (6, 63) if op == pg.S_ISUM else (7, 127)
                for k in range(planes):
                    p = (vi >> bits * k) & mask_
                    if op == pg.S_ISUM and k == planes - 1:
                        p = vi >> 30
                    acc[w + k] = float(p.astype(np.int64).sum())
                continue
            if op == pg.S_COUNT:
                x = np.ones(n)
            else:
                t = value(v, T)
                with np.errstate(all="ignore"):
                    pw = {pg.S_SUMSQ: 2, pg.S_SUM3: 3, pg.S_SUM4: 4}.get(op)
                    if pw == 2:
                        t = (t * t).astype(T)
                    elif pw == 3:
                        t = (t * t * t).astype(T)
                    elif pw == 4:
                        t2 = (t * t).astype(T)
                        t = (t2 * t2).astype(T)
                x = t.astype(np.float64)
            if G:
                init = {pg.S_MIN: np.inf, pg.S_MAX: -np.inf}.get(op, 0.0)
                tab = np.full(G, init)
                ufunc = {pg.S_MIN: np.minimum, pg.S_MAX: np.maximum}.get(
                    op, np.add)
                ufunc.at(tab, key[m], x[m])
                out[s, :, j] = tab.astype(T)
            elif op == pg.S_MIN:
                acc[w] = np.min(x[m], initial=np.inf)
            elif op == pg.S_MAX:
                acc[w] = np.max(x[m], initial=-np.inf)
            else:
                acc[w] = x[m].sum()
        if G:
            continue
        acc[0] = float(m0.sum())
        for w in range(code[pg.H_NACC]):
            _red, kind, oc = tp.code_at(code, pg.H_ACC, w, pg.ACC_W)
            if kind == pg.O_SCALAR:
                out[s, oc] = T(acc.get(w, 0.0))
            else:
                iv = int(acc.get(w, 0.0))
                out[s, oc], out[s, oc + 1] = iv >> 12, iv & 4095
    return out.astype(vdt)


@pytest.mark.parametrize("seed,grouped", CASES)
def test_program_interpreter_matches_plain(seed, grouped):
    """The compiled program, run by a mirror of the CUDA interpreter,
    gives the plain PyTorch version's packed output (float32 posture)."""
    spec = tp.random_spec(seed, grouped)
    plan = DevicePlan(**spec)
    cols, params, nd = tp.random_inputs(seed, spec, S, D, np.float32,
                                        nan=seed % 3 == 0)
    mirror = run_program(plan, cols, params, nd, D, np.float32)
    out, scale = run_port(spec, cols, params, nd, torch.float32)
    tp.assert_packed_equal(spec, mirror, out, scale, x64=False)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_program_interpreter_matches_plain_sketches(seed, x64):
    """The mirror on sketch plans: K3's HLL and histogram slots beside K1's
    scalar slots (even seeds), with NaN, +-inf and bound values."""
    spec = tp.random_sketch_spec(seed, scalar=seed % 2 == 0,
                                 log2ms=(4, 12) if seed % 3 else (16,))
    vdt = np.float64 if x64 else np.float32
    cols, params, nd = tp.sketch_inputs(seed, spec, S, D, vdt)
    mirror = run_program(DevicePlan(**spec), cols, params, nd, D, vdt)
    out, scale = run_port(spec, cols, params, nd,
                          torch.float64 if x64 else torch.float32)
    tp.assert_packed_equal(spec, mirror, out, scale, x64)


def test_sketch_tables_fit_shared_memory():
    """program.py places each sketch table in K3's shared memory while the
    tables before it leave room, back to back at 16-byte boundaries, a
    byte an HLL register and a word a histogram bucket, else in global
    memory."""
    spec = tp.random_sketch_spec(0, log2ms=(12, 16, 4), scalar=True)
    prog = pg.compile_plan(DevicePlan(**spec))
    rows = [tp.code_at(prog.code, pg.H_SLOT, j, pg.SLOT_W)
            for j in range(len(spec["agg_ops"]))]
    placed = [(r[3], r[4]) for r in rows if r[0] in pg.SKETCH_OPS]
    # hll:12 at 0, hll:16 after it, hll:4 after that, hist:8192 last
    assert placed == [(0, 12), (4096, 16), (69632, 4), (69648, 8192)]
    assert prog.sketch_smem_bytes == 69648 + 4 * 8192 \
        <= pg.SKETCH_SMEM_BYTES
    assert prog.out_width == 1 + 4096 + 65536 + 16 + 8192 + 2


@pytest.mark.parametrize("log2ms,buckets,placed,tab", [
    # config #4's phase-3 plan: every table on chip (100 KB)
    ((12, 16), 8192, [(0, 12), (4096, 16), (69632, 8192)], 102400),
    # two log2m-16 HLLs: the second, and the histogram past it, global
    ((16, 16), 8192, [(0, 16), (-1, 16), (65536, 8192)], 98304),
    ((16, 16, 16), 64, [(0, 16), (-1, 16), (-1, 16), (65536, 64)], 65792),
    # a 2^16-bucket histogram (256 KB) never fits; a small HLL after it
    ((4,), 1 << 16, [(0, 4), (-1, 1 << 16)], 16),
], ids=["phase3", "two-16", "three-16", "wide-hist"])
def test_sketch_table_byte_offsets(log2ms, buckets, placed, tab):
    """K3's on-chip placement in bytes: each sketch slot's byte offset
    (-1: its global uint32 table) and the block's table bytes, which the
    card's wrapper checks the kernel's own layout against."""
    spec = tp.random_sketch_spec(1, log2ms=log2ms, scalar=False,
                                 buckets=buckets)
    prog = pg.compile_plan(DevicePlan(**spec))
    rows = [tp.code_at(prog.code, pg.H_SLOT, j, pg.SLOT_W)
            for j in range(len(spec["agg_ops"]))]
    assert [(r[3], r[4]) for r in rows if r[0] in pg.SKETCH_OPS] == placed
    assert prog.sketch_smem_bytes == tab <= pg.SKETCH_SMEM_BYTES
    assert all(r[3] % 16 == 0 for r in rows if r[3] >= 0)


def test_program_limits_raise():
    leaves = tuple(tp.DeviceLeaf("range", "a") for _ in range(40))
    tree = ("and", *(("leaf", i) for i in range(40)))
    plan = DevicePlan(filter_ir=tree, leaves=leaves, value_irs=(),
                         agg_ops=(("count", None, None),))
    with pytest.raises(ValueError, match="leaf bounds"):
        pg.compile_plan(plan)


def test_cuda_wrapper_refuses_cpu_tensors():
    from pinot_tpu_torch.ops import _cuda
    spec = tp.random_spec(3, grouped=False)
    cols, params, nd = tp.random_inputs(3, spec, S, D, np.float32)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    with pytest.raises(ValueError, match="CUDA kernel given tensors"):
        _cuda.scan_agg(DevicePlan(**spec), tc, tpar, tnd, D, torch.float32)
    assert _cuda.SCAN_AGG.launches == 0
