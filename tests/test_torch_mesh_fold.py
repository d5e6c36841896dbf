"""K9 `mesh_fold`'s fold shapes and orders, on the CPU (the plain version,
ops/kernels.py `mesh_fold_plain`; the kernel itself runs in
tests/test_torch_cuda.py on the card):

- the strided doc fold (`doc_fold`: no source lists on the device) equals
  the same fold through explicit lists bit for bit, in float32 and
  float64, NaN, +-inf and +-0.0 included;
- a tail longer than `MeshFold.LONG_LIST` entries adds in the lane order:
  lane l of `MeshFold.LANES` adds entries l, l + LANES, ... in order from
  +0.0, then adjacent lanes join up a binary tree. The plain version's
  tails (`_add_lists`) equal a Python reference of that order, and on
  integer-valued tails the sequential sum exactly; main rows
  (`_fold_lists`) fold in list order at any length;
- lists at the threshold, one past it and empty, at the kernel's own
  constants (csrc/mesh_fold.cu MF_LONG_LIST, MF_LIST_THREADS);
- `collective.merged_plan`'s tails hold n_doc x G_local entries, and the
  long tails (`MeshFold.ltail`) are exactly those past the threshold.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from pinot_tpu_torch.ops import collective as tc
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops.plan_ir import DevicePlan
from pinot_tpu_torch.parallel.mesh import make_mesh


def _values(rng, shape, dtype):
    """Normal floats with NaN, +-inf and +-0.0 sprinkled in."""
    a = rng.normal(0, 1e3, shape)
    for v, share in ((np.nan, 0.02), (np.inf, 0.02), (-np.inf, 0.02),
                     (-0.0, 0.05), (0.0, 0.05)):
        a[rng.random(shape) < share] = v
    return a.astype(dtype)


def _same(a, b):
    """Bit for bit: NaN where NaN, the sign of every zero."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    keep = ~np.isnan(a)
    assert np.array_equal(a[keep], b[keep])
    assert np.array_equal(np.signbit(a[keep]), np.signbit(b[keep]))


def lane_fold(vals, op, lanes):
    """The lane order in Python floats: lane l folds entries l, l + lanes,
    ... in order from the identity, then adjacent lanes join."""
    def comb(a, v):
        if op == 0:
            return a + v
        if a != a or v != v:
            return math.nan
        key = (lambda x: (x, math.copysign(1.0, x)))
        pick = key(v) < key(a) if op == 1 else key(v) > key(a)
        return v if pick else a
    acc = [(0.0, math.inf, -math.inf)[op]] * lanes
    for i, v in enumerate(vals):
        acc[i % lanes] = comb(acc[i % lanes], float(v))
    while len(acc) > 1:
        acc = [comb(acc[2 * k], acc[2 * k + 1]) for k in range(len(acc) // 2)]
    return acc[0]


def seq_fold(vals, op):
    return lane_fold(vals, op, 1)


# ---------------------------------------------------------------------------
# the strided doc fold
# ---------------------------------------------------------------------------

GEOMS = [(1, 2, 4, 1, 7), (4, 2, 2, 8, 4), (2, 4, 3, 1, 5), (3, 1, 2, 2, 3)]


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_strided_doc_fold_equals_the_listed_form(geom, B, dtype):
    n_seg, n_doc, s_loc, per_seg, win = geom
    rng = np.random.default_rng(sum(geom) + B)
    ops = tuple(int(c) for c in rng.integers(0, 3, win))
    fold = tk.doc_fold(n_seg, n_doc, s_loc, per_seg, win, ops)
    assert fold.strided and fold.parts == n_seg * n_doc
    # the device reads the op codes alone; the lists exist on the host
    assert fold.nbytes == win
    assert all(a is None for a in fold.on(torch.device("cpu"))[1:])
    listed = tk.MeshFold(fold.R, win, 0, fold.rows_in, win, ops, fold.off,
                         fold.src)
    assert not listed.strided and listed.nbytes > fold.nbytes
    assert np.array_equal(fold.off, np.arange(fold.R + 1) * n_doc)
    parts = [torch.from_numpy(_values(rng, (B, fold.rows_in, win), dtype))
             for _ in range(fold.parts)]
    got = tk.mesh_fold_plain(parts, fold)
    assert got.dtype == parts[0].dtype
    assert got.shape == (B, n_seg * fold.rows_in * win)
    _same(got, tk.mesh_fold_plain(parts, listed))
    # and the definition: output row (i, r) folds row r of slots i * n_doc
    # .. i * n_doc + n_doc - 1 in that order
    x = np.stack([p.numpy() for p in parts]).astype(np.float64)
    want = np.empty((B, n_seg, fold.rows_in, win))
    for b in range(B):
        for i in range(n_seg):
            for r in range(fold.rows_in):
                for c in range(win):
                    want[b, i, r, c] = seq_fold(
                        x[i * n_doc:(i + 1) * n_doc, b, r, c], ops[c])
    _same(got, want.reshape(B, -1).astype(dtype))


def test_strided_fold_refuses_lists_and_tails():
    with pytest.raises(ValueError):
        tk.MeshFold(4, 2, 0, 2, 2, (0, 0), np.arange(5), np.arange(4),
                    n_doc=2)
    with pytest.raises(ValueError):
        tk.MeshFold(4, 1, 0, 2, 2, (0,), n_doc=2)


@pytest.mark.parametrize("name,const", [("MF_LONG_LIST", "LONG_LIST"),
                                        ("MF_LIST_THREADS", "LANES")])
def test_the_threshold_and_lanes_are_the_kernels(name, const):
    """MeshFold's LONG_LIST and LANES are K9's compile-time constants, so
    the plain version takes K9's order."""
    with open(os.path.join(os.path.dirname(tk.__file__), "csrc",
                           "mesh_fold.cu")) as f:
        src = f.read()
    got = re.search(rf"^#define {name} (\d+)$", src, re.M)
    assert got and int(got.group(1)) == getattr(tk.MeshFold, const)


# ---------------------------------------------------------------------------
# the lane order of long tails
# ---------------------------------------------------------------------------

THR, LANES = tk.MeshFold.LONG_LIST, tk.MeshFold.LANES


def tail_fold(vals):
    """A tail as K9 adds it: in order up to THR entries, else in the lane
    order over LANES lanes."""
    return lane_fold(vals, 0, LANES) if len(vals) > THR else seq_fold(vals, 0)


@pytest.mark.parametrize("n", [1, 31, 33, THR, THR + 1, 1000, LANES,
                               LANES + 1, 9000])
def test_tail_sum_is_in_order_or_the_lane_order(n):
    """_add_lists on normal floats with NaN and +-inf: tails of n, 0 and
    2n entries, in order up to LONG_LIST entries and in the lane order
    past it."""
    rng = np.random.default_rng(n)
    vals = _values(rng, (2, 3 * n), np.float64)
    off = np.array([0, n, n, 3 * n])
    got = tk._add_lists(torch.from_numpy(vals), off)
    for b in range(2):
        for t in range(3):
            _same(got[b, t], tail_fold(vals[b, off[t]:off[t + 1]]))


@pytest.mark.parametrize("n", [THR + 1, 4096, 1 << 17])
def test_integer_tails_equal_the_sequential_sum(n):
    """Counts (integer-valued floats) summing up to 2^24: the lane order
    equals the sequential order exactly, as on a grouped merge's tail."""
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 256, (1, 2 * n)).astype(np.float64)
    vals[0, :n] = (1 << 24) // n  # the first list sums to 2^24 at 2^17
    off = np.array([0, n, 2 * n])
    got = tk._add_lists(torch.from_numpy(vals), off)
    if n == 1 << 17:
        assert got[0, 0] == 1 << 24
    assert np.array_equal(got[0], [seq_fold(vals[0, :n], 0),
                                   seq_fold(vals[0, n:], 0)])


@pytest.mark.parametrize("op", [0, 1, 2], ids=["sum", "min", "max"])
def test_long_main_rows_fold_in_list_order(op):
    """_fold_lists: a main row folds in list order however long it is
    (2000 entries, far past LONG_LIST), each column by its op, +-0.0 and
    NaN included."""
    rng = np.random.default_rng(op)
    vals = _values(rng, (2, 3000, 3), np.float64)
    off = np.array([0, 2000, 2000, 2010])
    rows = torch.from_numpy(rng.permutation(3000)[:2010])
    ops = torch.tensor([op, (op + 1) % 3, (op + 2) % 3])
    got = tk._fold_lists(torch.from_numpy(vals), off, rows, ops).numpy()
    r = rows.numpy()
    for b in range(2):
        for o in range(3):
            for w in range(3):
                _same(got[b, o, w], seq_fold(vals[b, r[off[o]:off[o + 1]], w],
                                             int(ops[w])))


# ---------------------------------------------------------------------------
# the threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_lists_at_past_and_under_the_threshold(dtype):
    """Main rows of 0, LONG_LIST, LONG_LIST + 1, 2 and 300 entries fold in
    list order; tails of LONG_LIST + 1 and 700 entries add in the lane
    order and are K9's long tails (`ltail`), tails of LONG_LIST and 0 in
    order; an empty list gives the identity."""
    rng = np.random.default_rng(THR)
    P, rows_in, win = 3, 50, 4
    lens = [0, THR, THR + 1, 2, 300]
    tlens = [THR + 1, THR, 0, 700]
    off = np.concatenate([[0], np.cumsum(lens)])
    toff = np.concatenate([[0], np.cumsum(tlens)])

    def lists(n):
        return (rng.integers(0, P, n) << 32) | rng.integers(0, rows_in, n)
    fold = tk.MeshFold(len(lens), 2, 1, rows_in, win, (0, 2), off,
                       lists(off[-1]), 3, toff, lists(toff[-1]))
    assert fold.ltail.tolist() == [0, 3]
    parts = [torch.from_numpy(_values(rng, (2, rows_in, win), dtype))
             for _ in range(P)]
    got = tk.mesh_fold_plain(parts, fold).numpy()
    assert got.dtype == dtype
    x = np.stack([p.numpy() for p in parts], 1).reshape(
        2, -1, win).astype(np.float64)

    def rows(src):
        return (src >> 32) * rows_in + (src & 0xFFFFFFFF)
    R, W = fold.R, fold.W
    for b in range(2):
        for o in range(R):
            r = rows(fold.src[fold.off[o]:fold.off[o + 1]])
            for w in range(W):
                _same(got[b, o * W + w], np.array(seq_fold(
                    x[b, r, fold.col0 + w], int(fold.ops[w]))).astype(dtype))
        for t in range(fold.T):
            r = rows(fold.tsrc[fold.toff[t]:fold.toff[t + 1]])
            _same(got[b, R * W + t],
                  np.array(tail_fold(x[b, r, fold.tail_col])).astype(dtype))
    assert got[0, 0] == 0.0 and got[0, 1] == -np.inf  # empty: identities
    assert got[0, R * W + 2] == 0.0


def test_a_strided_fold_has_no_long_tail():
    """The doc fold reads no list, so K9 gets no long tails either."""
    fold = tk.doc_fold(4, 2, 4, 1, 7, (0,) * 7)
    assert not len(fold.ltail) and fold.on(torch.device("cpu"))[5] is None
    # and a grouped merge's tail at phase 14's G_local passes the threshold
    assert 2 * (1 << 16) > THR


# ---------------------------------------------------------------------------
# merged_plan's tails
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_seg,n_doc", [(4, 2), (2, 4), (8, 1)])
@pytest.mark.parametrize("G_local", [5, 64, 300])
def test_merged_plan_tails_hold_n_doc_by_g_local(n_seg, n_doc, G_local):
    mesh = make_mesh(["cpu"] * (n_seg * n_doc), doc_axis=n_doc)
    S = 2 * n_seg
    plan = DevicePlan(
        filter_ir=None, leaves=(), value_irs=(("col", "x"),),
        agg_ops=(("sum", 0, None), ("count", None, None)),
        group_cols=("a",), group_compact=True)
    rng = np.random.default_rng(G_local)
    remap = np.full((S, G_local), -1, dtype=np.int64)
    for s in range(S):
        k = int(rng.integers(1, G_local + 1))
        remap[s, :k] = np.sort(rng.choice(4 * G_local, k, replace=False))
    fold = tc.merged_plan(plan, mesh, S, 4 * G_local, remap)
    assert fold.T == S and not fold.strided
    assert (np.diff(fold.toff) == n_doc * G_local).all()
    # each main row names at most one local key a segment and slot
    assert np.diff(fold.off).max() <= S // n_seg * n_seg * n_doc
    long = np.nonzero(np.diff(fold.toff) > tk.MeshFold.LONG_LIST)[0]
    assert fold.ltail.tolist() == long.tolist()
    # the tail counts every doc slice and local key of its segment
    parts = [torch.ones(1, fold.rows_in, fold.win, dtype=torch.float64)
             for _ in range(mesh.size)]
    out = tk.mesh_fold_plain(parts, fold)
    assert (out[0, fold.R * fold.W:] == n_doc * G_local).all()
    # ungrouped: a tail of n_doc entries
    flat = DevicePlan(filter_ir=None, leaves=(), value_irs=(("col", "x"),),
                      agg_ops=(("sum", 0, None),))
    assert (np.diff(tc.merged_plan(flat, mesh, S).toff) == n_doc).all()
