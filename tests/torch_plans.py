"""Seeded random kernel plans and inputs for the port's kernel tests.

One spec drives both packages: `DevicePlan(**spec)` is the port's plan,
and tests/test_torch_kernels.py builds the JAX package's from the same
fields. Inputs are numpy arrays made from the seed, so the JAX kernel, the
port's plain PyTorch version and (on the card) the CUDA kernels all read
the same bytes. Imports neither JAX nor pinot_tpu, so the CUDA test file can
use it on a machine without JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from pinot_tpu_torch.ops import program as pg
from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
from pinot_tpu_torch.ops.program import slot_width

#: tolerances of the kernel comparisons (reasons in test_torch_kernels.py):
#: float32 sums within 1e-5 of the slot's sum of |contribution|; float64
#: everything within 1e-9; float32 min/max of an FMA-contractible
#: expression within 2^-20 when one side is XLA on the CPU
F32_SUM_TOL = 1e-5
F64_TOL = 1e-9
FMA_TOL = 2.0 ** -20

#: dictionary id columns: name -> (numpy dtype, cardinality)
ID_COLS = {"a": (np.int8, 100), "b": (np.int16, 1000), "c": (np.int32, 5000)}
#: float value columns (values in +-[0.5, 100], a few NaN when asked)
VAL_COLS = ("x", "y")
#: int-valued value columns for exact-sum slots: name -> (lo, hi)
INT_COLS = {"u": (0, 100_000), "i": (-5000, 5000)}
SLOT_OPS = ("count", "sum", "sumsq", "sum3", "sum4", "min", "max")
VALUE_OPS = ("add", "sub", "mul", "div")


def _filter_tree(rng, leaves, depth=0):
    r = rng.random()
    if depth >= 3 or r < 0.35:
        kind = rng.choice(["range", "neq", "lut", "vrange", "vrange64"])
        col = {"vrange": "x", "vrange64": "t"}.get(
            kind, rng.choice(list(ID_COLS)))
        leaves.append(DeviceLeaf(str(kind), str(col)))
        return ("leaf", len(leaves) - 1)
    if r < 0.5:
        return ("not", _filter_tree(rng, leaves, depth + 1))
    op = "and" if rng.random() < 0.5 else "or"
    n = int(rng.integers(2, 4))
    return (op, *(_filter_tree(rng, leaves, depth + 1) for _ in range(n)))


def _value_ir(rng, depth=0):
    if depth >= 3 or rng.random() < 0.4:
        if rng.random() < 0.25:
            return ("lit", float(np.round(rng.uniform(-4, 4), 2) or 1.5))
        return ("col", str(rng.choice(VAL_COLS)))
    if rng.random() < 0.15:
        return ("neg", _value_ir(rng, depth + 1))
    return (str(rng.choice(VALUE_OPS)), _value_ir(rng, depth + 1),
            _value_ir(rng, depth + 1))


def random_spec(seed: int, grouped: bool, isum: bool = True) -> dict:
    """Plan fields for one random plan (shared by both packages)."""
    rng = np.random.default_rng(seed)
    leaves: list = []
    filter_ir = _filter_tree(rng, leaves) if rng.random() < 0.85 else None
    agg_filter_irs = tuple(_filter_tree(rng, leaves)
                           for _ in range(int(rng.integers(0, 3))))
    value_irs = [_value_ir(rng) for _ in range(int(rng.integers(1, 4)))]
    agg_ops = []
    for _ in range(int(rng.integers(2, 7))):
        op = str(rng.choice(SLOT_OPS))
        vidx = None if op == "count" else int(rng.integers(len(value_irs)))
        fidx = None if not agg_filter_irs or rng.random() < 0.5 \
            else int(rng.integers(len(agg_filter_irs)))
        agg_ops.append((op, vidx, fidx))
    if isum and not grouped:
        # exact int sums: unsigned planes over u*3+7 (< 2^19 -> 3 planes),
        # signed planes over (i - u) * 2 (|v| < 2^18)
        value_irs.append(("add", ("mul", ("col", "u"), ("lit", 3.0)),
                          ("lit", 7.0)))
        agg_ops.append(("isum:u3", len(value_irs) - 1, None))
        value_irs.append(("mul", ("sub", ("col", "i"), ("col", "u")),
                          ("lit", 2.0)))
        agg_ops.append(("isum", len(value_irs) - 1,
                        0 if agg_filter_irs else None))
    spec = dict(filter_ir=filter_ir, leaves=tuple(leaves),
                value_irs=tuple(value_irs), agg_ops=tuple(agg_ops),
                agg_filter_irs=agg_filter_irs)
    if grouped:
        gcols = [str(c) for c in rng.permutation(["a", "b"])[
            :int(rng.integers(1, 3))]]
        cards = [ID_COLS[c][1] for c in gcols]
        G = int(np.prod(cards))
        strides, stride = [], G
        for c in cards:
            stride //= c
            strides.append(stride)
        agg_ops.append(("count", None, None))
        spec.update(agg_ops=tuple(agg_ops), group_cols=tuple(gcols),
                    group_strides=tuple(strides), num_groups=G)
    return spec


def compact_spec(seed: int) -> dict:
    """A random group-by plan with compact keys: `random_spec`'s grouped
    plan whose keys come from a 'gkey' block (num_groups 0, no
    strides)."""
    spec = random_spec(seed, grouped=True)
    spec.update(group_compact=True, num_groups=0, group_strides=())
    return spec


def compact_gkey(seed: int, S: int, D: int, G: int) -> np.ndarray:
    """A seeded int32 [S, D] block of compact codes in [0, G): each
    segment holds a prefix of the codes (its own tuple count), skewed
    toward the low ones."""
    rng = np.random.default_rng(seed + 104729)
    held = rng.integers(G // 2, G + 1, S)
    u = rng.random((S, D)) ** 2
    return np.minimum((u * held[:, None]).astype(np.int64),
                      held[:, None] - 1).astype(np.int32)


def random_inputs(seed: int, spec: dict, S: int, D: int, value_dtype,
                  nan: bool = False, pad_segments: int = 1
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                             np.ndarray]:
    """Staged cols / params / num_docs in the JAX engine's layout. The last
    `pad_segments` segments carry num_docs = 0 (padded segments); others
    fill a random part of the D-wide block."""
    rng = np.random.default_rng(seed + 7919)
    vdt = np.dtype(value_dtype)
    num_docs = rng.integers(D // 2, D + 1, S).astype(np.int32)
    num_docs[S - pad_segments:] = 0
    cols: Dict[str, np.ndarray] = {}
    for c, (dt, card) in ID_COLS.items():
        cols["ids:" + c] = rng.integers(0, card, (S, D)).astype(dt)
    for c in VAL_COLS:
        v = rng.uniform(0.5, 100, (S, D)) * rng.choice([-1, 1], (S, D))
        if nan:
            v[rng.random((S, D)) < 0.002] = np.nan
        cols["val:" + c] = v.astype(vdt)
    for c, (lo, hi) in INT_COLS.items():
        cols["val:" + c] = rng.integers(lo, hi, (S, D)).astype(vdt)
    t = rng.integers(-(1 << 40), 1 << 40, (S, D)).astype(np.int64)
    cols["valhi:t"] = (t >> 24).astype(np.int32)
    cols["vallo:t"] = (t & 0xFFFFFF).astype(np.int32)
    params: Dict[str, np.ndarray] = {}
    for i, leaf in enumerate(spec["leaves"]):
        if leaf.kind in ("range", "neq", "lut"):
            card = ID_COLS[leaf.column][1]
        if leaf.kind == "range":
            lo = rng.integers(0, card, S)
            hi = lo + rng.integers(0, card // 2 + 1, S)
            # sentinels the engine stages: 'all' = [0, 2^31-1], 'none' =
            # [0, -1]
            hi[rng.random(S) < 0.25] = 2**31 - 1
            sel = rng.random(S) < 0.15
            lo[sel], hi[sel] = 0, -1
            params[f"leaf{i}:lo"] = lo.astype(np.int32)
            params[f"leaf{i}:hi"] = hi.astype(np.int32)
        elif leaf.kind == "neq":
            idx = rng.integers(-1, card, S)
            params[f"leaf{i}:idx"] = idx.astype(np.int32)
        elif leaf.kind == "lut":
            C = 1 << int(np.ceil(np.log2(max(card, 8))))
            params[f"leaf{i}:lut"] = rng.random((S, C)) < 0.5
        elif leaf.kind == "vrange":
            lo = rng.uniform(-100, 50, S)
            params[f"leaf{i}:lo"] = lo.astype(vdt)
            params[f"leaf{i}:hi"] = (lo + rng.uniform(0, 150, S)).astype(vdt)
        else:
            a = rng.integers(-(1 << 40), 1 << 39, S)
            b = a + rng.integers(0, 1 << 40, S)
            params[f"leaf{i}:lohi"] = (a >> 24).astype(np.int32)
            params[f"leaf{i}:lolo"] = (a & 0xFFFFFF).astype(np.int32)
            params[f"leaf{i}:hihi"] = (b >> 24).astype(np.int32)
            params[f"leaf{i}:hilo"] = (b & 0xFFFFFF).astype(np.int32)
    return cols, params, num_docs


def random_sketch_spec(seed: int, log2ms=(12,), scalar: bool = True,
                       buckets: int = 8192) -> dict:
    """Plan fields with sketch slots: one HLL slot over the split-plane
    column 't' per log2m, a histogram slot over 'x', a random main filter
    and agg FILTER trees, and (scalar=True) count and sum slots beside
    them, so the plan runs K1 and K3 into one output on the card."""
    rng = np.random.default_rng(seed)
    leaves: list = []
    filter_ir = _filter_tree(rng, leaves) if rng.random() < 0.7 else None
    agg_filter_irs = tuple(_filter_tree(rng, leaves)
                           for _ in range(int(rng.integers(0, 2))))

    def fidx():
        return None if not agg_filter_irs or rng.random() < 0.5 else 0

    agg_ops = [(f"hll:{m}:t", None, fidx()) for m in log2ms]
    agg_ops.append((f"hist:{buckets}", 0, fidx()))
    if scalar:
        agg_ops.insert(seed % (len(agg_ops) + 1),
                       ("count", None, fidx()))
        agg_ops.append(("sum", 0, None))
    return dict(filter_ir=filter_ir, leaves=tuple(leaves),
                value_irs=(("col", "x"),), agg_ops=tuple(agg_ops),
                agg_filter_irs=agg_filter_irs, raw64_cols=("t",))


def hist_params(seed: int, spec: dict, S: int, value_dtype,
                ) -> Dict[str, np.ndarray]:
    """`slot{j}:hlo` / `slot{j}:hscale` for each histogram slot: bounds
    around 'x''s range, narrower on some segments so values clip at both
    ends; B / span taken in double and rounded once, as the engine
    stages them."""
    rng = np.random.default_rng(seed + 104729)
    vdt = np.dtype(value_dtype)
    out = {}
    for j, (op, _v, _f) in enumerate(spec["agg_ops"]):
        if op.startswith("hist:"):
            B = slot_width(op)
            lo = rng.choice([-100.0, -20.0, 0.0], S)
            span = rng.choice([200.0, 50.0, 117.3], S)
            out[f"slot{j}:hlo"] = lo.astype(vdt)
            out[f"slot{j}:hscale"] = (B / span).astype(vdt)
    return out


def sketch_inputs(seed: int, spec: dict, S: int, D: int, value_dtype,
                  pad_segments: int = 1):
    """random_inputs plus the histogram parameters, with NaN, +-inf and
    values at each segment's bounds in 'x', and the planes of 0, -1 and
    the largest admissible longs (|v| < 2^55) in 't'."""
    cols, params, nd = random_inputs(seed, spec, S, D, value_dtype,
                                     nan=True, pad_segments=pad_segments)
    params.update(hist_params(seed, spec, S, value_dtype))
    x = cols["val:x"]
    x[:, 1], x[:, 2], x[:, 3] = np.inf, -np.inf, np.nan
    for j, (op, _v, _f) in enumerate(spec["agg_ops"]):
        if op.startswith("hist:"):
            lo = params[f"slot{j}:hlo"].astype(np.float64)
            hi = lo + slot_width(op) / params[f"slot{j}:hscale"]
            x[:, 4], x[:, 5] = lo, hi
    t = np.array([0, -1, (1 << 55) - 1, -(1 << 55) + 1, 1 << 24, -(1 << 24)],
                 dtype=np.int64)
    cols["valhi:t"][:, 6:12] = (t >> 24).astype(np.int32)
    cols["vallo:t"][:, 6:12] = (t & 0xFFFFFF).astype(np.int32)
    return cols, params, nd


#: top-N order values by kind (None: unordered, the first docs)
TOPN_ORDERS = {"col": ("col", "x"), "ids": ("ids", "b"),
               "expr": ("mul", ("col", "x"), ("col", "y")), "none": None}


def topn_spec(seed: int, order: str, asc: bool, k: int,
              filtered: bool = True) -> dict:
    """Plan fields of a top-N plan: a random main filter (or none) and the
    order value TOPN_ORDERS[order]."""
    rng = np.random.default_rng(seed)
    leaves: list = []
    filter_ir = _filter_tree(rng, leaves) if filtered else None
    ir = TOPN_ORDERS[order]
    return dict(filter_ir=filter_ir, leaves=tuple(leaves),
                value_irs=() if ir is None else (ir,), agg_ops=(),
                raw64_cols=("t",), mode="topn", topn_k=k, topn_asc=asc)


def topn_inputs(seed: int, spec: dict, S: int, D: int, value_dtype,
                pad_segments: int = 1):
    """random_inputs with tie-dense order values: 'x' and 'y' small
    integers in [-3, 3], a tenth of them -0.0, +0.0, NaN, +inf or -inf."""
    cols, params, nd = random_inputs(seed, spec, S, D, value_dtype,
                                     pad_segments=pad_segments)
    rng = np.random.default_rng(seed + 15485863)
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf])
    for c in VAL_COLS:
        v = rng.integers(-3, 4, (S, D)).astype(np.float64)
        pick = rng.random((S, D)) < 0.1
        v[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
        cols["val:" + c] = v.astype(value_dtype)
    return cols, params, nd


#: star-tree group dims per key-space size: name -> ((dim, card), ...);
#: "smem" fits K5's shared-memory table (G = 35), "global" does not
ST_GROUPS = {"flat": (), "smem": (("a", 7), ("b", 5)),
             "global": (("a", 128), ("b", 128))}


def startree_spec(group: str, dims=None) -> dict:
    """StarTreePlan fields: a usum, a float sum, a min and a max slot over
    K5's staged pre-agg columns, grouped by ST_GROUPS[group] or, where
    given, by `dims` ((name, card), ...)."""
    dims = ST_GROUPS[group] if dims is None else dims
    cards = [c for _d, c in dims]
    strides = [int(np.prod(cards[i + 1:], dtype=np.int64))
               for i in range(len(cards))]
    return dict(slots=(("usum", "sum__u"), ("sum", "sum__x"),
                       ("min", "min__x"), ("max", "max__y")),
                group_dims=tuple(d for d, _c in dims),
                group_cards=tuple(cards), group_strides=tuple(strides),
                num_groups=int(np.prod(cards, dtype=np.int64)) if dims
                else 0)


def startree_inputs(seed: int, spec: dict, S: int, D: int, value_dtype):
    """Seeded K5 inputs as numpy arrays: exact-sum digit rows in
    [0, 2^24), float values in +-[0, 1e4), group codes in [0, card) (-1, a
    star, on some unselected records), a selection of contiguous record
    runs (as traversal yields [start, end) slices) keeping about a tenth,
    and record counts D, ragged, and 0 (a padding segment)."""
    rng = np.random.default_rng(seed)
    pos = np.arange(D)
    run = 53
    starts = rng.integers(0, 512 - run, (S, (D + 511) // 512))
    off = starts[:, pos // 512]
    sel = (pos % 512 >= off) & (pos % 512 < off + run)
    sel |= rng.random((S, D)) < 0.01
    cols = {}
    for op, name in spec["slots"]:
        if op == "usum":
            cols["sthi:" + name] = rng.integers(0, 1 << 24, (S, D),
                                                dtype=np.int32)
            cols["stlo:" + name] = rng.integers(0, 1 << 24, (S, D),
                                                dtype=np.int32)
        else:
            cols["stval:" + name] = ((rng.random((S, D)) - 0.3) * 1e4
                                     ).astype(value_dtype)
    for dim, card in zip(spec["group_dims"], spec["group_cards"]):
        ids = rng.integers(0, card, (S, D)).astype(np.int32)
        ids[~sel & (rng.random((S, D)) < 0.2)] = -1
        cols["stid:" + dim] = ids
    nd = np.full(S, D, dtype=np.int32)
    nd[S // 2] = max(1, D - 4321)
    nd[-1] = 0
    return cols, {"sel": sel}, nd


def startree_abs_sums(spec: dict, cols, params, nd,
                      D) -> Dict[str, np.ndarray]:
    """Per float-sum slot, the sum of |contribution| per segment [S] or
    per group [S, G] (float64): the yardstick of the sum tolerances."""
    S = len(nd)
    m = params["sel"] & (np.arange(D)[None, :] < nd[:, None])
    out = {}
    for op, name in spec["slots"]:
        if op != "sum":
            continue
        c = np.where(m, np.abs(cols["stval:" + name].astype(np.float64)), 0)
        if not spec["num_groups"]:
            out[name] = c.sum(1)
            continue
        keys = np.zeros((S, D), dtype=np.int64)
        for dim, stride in zip(spec["group_dims"], spec["group_strides"]):
            keys += cols["stid:" + dim].astype(np.int64) * stride
        g = np.zeros((S, spec["num_groups"]))
        for s in range(S):
            np.add.at(g[s], keys[s][m[s]], c[s][m[s]])
        out[name] = g
    return out


def assert_startree_equal(spec: dict, a, b, scale, sum_tol: float):
    """Two packed K5 outputs of one plan (numpy): record counts, exact-sum
    planes, min and max equal bit for bit; float sums within sum_tol of
    the slot's sum of |contribution|."""
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    assert np.array_equal(a[..., 0], b[..., 0]), "record counts"
    col = 1
    for op, name in spec["slots"]:
        w = 16 if op == "usum" else 1
        x, y = a[..., col:col + w], b[..., col:col + w]
        col += w
        if op == "sum":
            sc = scale[name][..., None]
            err = np.abs(x.astype(np.float64) - y.astype(np.float64))
            assert (err <= sum_tol * sc + 1e-300).all(), \
                (name, float(err.max()))
        else:
            assert np.array_equal(x, y), (op, name)


def code_at(code, table, i, width):
    off = code[table] + i * width
    return code[off:off + width]


class ProgramMirror:
    """numpy mirror of csrc/interp.cuh: runs the program `compile_plan`
    emits for `plan` over one segment at a time (`segment(s)`), with the
    same per-segment parameter clamping, leaves, filter trees and value
    expressions (one rounding per operation in the value type)."""

    def __init__(self, plan, cols, params, num_docs, D):
        prog = pg.compile_plan(plan)
        self.prog = prog
        self.code = prog.for_launch([str(cols[n].dtype) for n in prog.cols],
                                    [params[k].shape[1] for k in prog.luts])
        self.num_docs, self.D = num_docs, D
        Sn = len(num_docs)
        self.colarr = [cols[n] for n in prog.cols]
        self.luts = [params[k] for k in prog.luts]
        self.pmat = np.stack([params[k].astype(np.float64) if k is not None
                              else np.full(Sn, lit)
                              for k, lit in prog.params]
                             or [np.zeros(Sn)], 1)

    def segment(self, s: int) -> int:
        """Select segment s; returns its real doc count n."""
        code = self.code
        prm = self.pmat[s].copy()
        for li in range(code[pg.H_NLEAVES]):
            kind, a, _b, p, _l = code_at(code, pg.H_LEAF, li, pg.LEAF_W)
            dt = code[code[pg.H_COLDT] + a]
            if kind in (pg.L_RANGE, pg.L_NEQ) and dt <= 1:
                lim = (128.0, 127.0) if dt == 0 else (32768.0, 32767.0)
                n_p = 2 if kind == pg.L_RANGE else 1
                prm[p:p + n_p] = np.clip(prm[p:p + n_p], -lim[0], lim[1])
        self.s, self.prm = s, prm
        self.n = max(0, min(int(self.num_docs[s]), self.D))
        return self.n

    def col(self, c):
        return self.colarr[c][self.s, :self.n].astype(np.float64)

    def leaf(self, li):
        kind, a, b, p, lut = code_at(self.code, pg.H_LEAF, li, pg.LEAF_W)
        prm, v = self.prm, self.col(a)
        if kind == pg.L_RANGE:
            return (v >= prm[p]) & (v <= prm[p + 1])
        if kind == pg.L_NEQ:
            return v != prm[p]
        if kind == pg.L_LUT:
            return self.luts[lut][self.s][v.astype(np.int64)]
        if kind == pg.L_VRANGE:
            return (v >= prm[p]) & (v <= prm[p + 1])
        lo = self.col(b)
        ge = (v > prm[p]) | ((v == prm[p]) & (lo >= prm[p + 1]))
        le = (v < prm[p + 2]) | ((v == prm[p + 2]) & (lo <= prm[p + 3]))
        return ge & le

    def _run(self, table, i, push, unary, binary):
        start, cnt = code_at(self.code, table, i, 2)
        st = []
        for k in range(cnt):
            op, arg = self.code[start + 2 * k], self.code[start + 2 * k + 1]
            r = push(op, arg)
            if r is not None:
                st.append(r)
            elif unary(op):
                st[-1] = unary(op)(st[-1])
            else:
                y = st.pop()
                st[-1] = binary(op, st[-1], y)
        return st[0]

    def filt(self, f):
        return self._run(
            pg.H_FILT, f,
            lambda op, arg: self.leaf(arg) if op == pg.F_LEAF else None,
            lambda op: (lambda x: ~x) if op == pg.F_NOT else None,
            lambda op, x, y: x & y if op == pg.F_AND else x | y)

    def value(self, v, ty):
        bins = {pg.V_ADD: np.add, pg.V_SUB: np.subtract,
                pg.V_MUL: np.multiply, pg.V_DIV: np.divide}

        def push(op, arg):
            if op in (pg.V_COL, pg.V_IDS):
                return self.col(arg).astype(ty)
            if op == pg.V_LIT:
                return np.full(self.n, self.prm[arg]).astype(ty)
            return None
        with np.errstate(all="ignore"):
            return self._run(pg.H_VAL, v, push,
                             lambda op: np.negative if op == pg.V_NEG
                             else None,
                             lambda op, x, y: bins[op](x, y).astype(ty))


def contractible(ir) -> bool:
    """True when an add/sub takes a product directly: XLA on the CPU fuses
    such pairs into one FMA (one rounding instead of two), so a min/max of
    that expression may differ from the two-rounding result in the last
    bit. Plain PyTorch and the CUDA kernels (built with --fmad=false) both
    round twice."""
    if ir is None or ir[0] in ("col", "lit"):
        return False
    kids = [c for c in ir[1:] if isinstance(c, tuple)]
    if ir[0] in ("add", "sub") and any(k[0] == "mul" for k in kids):
        return True
    return any(contractible(k) for k in kids)


def _close(a, b, tol, scale=None):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    same = (a == b) | both_nan
    ref = np.maximum(np.abs(a), np.abs(b))
    if scale is not None:
        ref = np.maximum(ref, scale)
    with np.errstate(invalid="ignore"):
        ok = same | (np.abs(a - b) <= tol * ref + 1e-300)
    return bool(ok.all())


def assert_packed_equal(spec, a, b, scale, x64: bool, fma: bool = False):
    """a, b: packed outputs of one plan (numpy); scale: its kernels.abs_contributions.
    x64: float64 posture (everything within F64_TOL). fma: one side is the
    JAX kernel on the CPU, whose min/max of a contractible expression may
    differ in the last bits (see `contractible`)."""
    grouped = bool(spec.get("num_groups") or spec.get("group_compact"))
    assert a.shape == b.shape
    col = 0 if grouped else 1
    if not grouped:
        assert np.array_equal(a[:, 0], b[:, 0]), "matched count"
    for j, (op, vidx, _f) in enumerate(spec["agg_ops"]):
        w = slot_width(op)
        x = a[..., j] if grouped else a[:, col:col + w]
        y = b[..., j] if grouped else b[:, col:col + w]
        col += w
        what = f"slot {j} {op}"
        if op == "count" or op.startswith(("isum", "hll:", "hist:")):
            assert np.array_equal(x, y), what
        elif op in ("min", "max"):
            if x64:
                assert _close(x, y, F64_TOL), what
            elif fma and contractible(spec["value_irs"][vidx]):
                assert _close(x, y, FMA_TOL), what
            else:
                assert np.array_equal(x, y, equal_nan=True), what
        else:
            sc = scale[j] if grouped else scale[j][:, None]
            assert _close(x, y, F64_TOL if x64 else F32_SUM_TOL, sc), what


def clp_inputs(seed: int, mode: str, S: int, D: int, i: int = 0,
               kd: int = 2, ke: int = 2, col: str = "m", cp: int = 8,
               vp: int = 64, gp: int = 8, ncp: int = 8, nlp: int = 4,
               pad_segments: int = 1) -> Tuple[Dict[str, np.ndarray],
                                               Dict[str, np.ndarray]]:
    """Seeded inputs of one 'clp' leaf i over column `col` (ops/clp_device.py
    layouts): logtype ids below cp, dict-var ids up to each segment's
    var-dictionary cardinality (the sentinel, about a quarter of the
    slots), encoded (hi, lo) pairs from a few values so equal and unequal
    pairs both occur (negative lows included); the tables' last
    conditions and groups padding (ck 0, glt -1) and the last
    `pad_segments` rows never-match padding, as leaf_params pads them.
    Mode 'a' reads Kd slots and takes no encoded slot (ke is ignored)."""
    rng = np.random.default_rng(seed)
    ke = 0 if mode == "a" else ke
    card = rng.integers(vp // 2, vp - 1, S)
    cols = {f"clpid:{col}": rng.integers(0, cp, (S, D)).astype(np.int32)}
    for j in range(kd):
        v = rng.integers(0, card[:, None] + 1, (S, D))
        cols[f"clpdv{j}:{col}"] = np.where(
            rng.random((S, D)) < 0.25, card[:, None], v).astype(np.int32)
    for j in range(ke):
        cols[f"clpehi{j}:{col}"] = rng.integers(-2, 2, (S, D)).astype(
            np.int32)
        cols[f"clpelo{j}:{col}"] = rng.integers(-3, 3, (S, D)).astype(
            np.int32)
    live = np.arange(vp)[None, :] < card[:, None]
    params = {f"leaf{i}:alut": rng.random((S, cp)) < 0.1}
    if mode == "a":
        if kd:
            params[f"leaf{i}:dvlut"] = (rng.random((S, vp)) < 0.2) & live
    else:
        ck = rng.integers(0, 3, (S, ncp)).astype(np.int8)
        ck[:, ncp - max(1, ncp // 5):] = 0
        glt = rng.integers(0, cp, (S, gp)).astype(np.int32)
        glt[:, gp - max(1, gp // 8):] = -1
        params.update({
            f"leaf{i}:glt": glt,
            f"leaf{i}:gmem": rng.random((S, gp, ncp)) < 0.2,
            f"leaf{i}:ck": ck,
            f"leaf{i}:cs": rng.integers(0, max(kd, ke, 1), (S, ncp)).astype(
                np.int32),
            f"leaf{i}:chi": rng.integers(-2, 2, (S, ncp)).astype(np.int32),
            f"leaf{i}:clo": rng.integers(-3, 3, (S, ncp)).astype(np.int32),
            f"leaf{i}:cl": rng.integers(0, nlp, (S, ncp)).astype(np.int32)})
        if kd:
            params[f"leaf{i}:dlut"] = (rng.random((S, nlp, vp)) < 0.5) \
                & live[:, None]
    for k, v in params.items():
        if pad_segments:
            v[S - pad_segments:] = -1 if k.endswith(":glt") else 0
    return cols, params


# ---------------------------------------------------------------------------
# the vector leg (K8 vector_topk, JAX vector_device.make_vector_kernel)
# ---------------------------------------------------------------------------

#: K8's scores against a sum in another order (XLA's einsum, numpy's BLAS,
#: float64): cosines of unit vectors, so an absolute bound
VEC_TOL = 2.0 ** -20


def _pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def vector_case(seed: int, S: int = 5, D: int = 1024, dim: int = 16,
                k: int = 10, ivf: bool = False, n_cells: int = 37,
                resid: bool = False, vmask: bool = False,
                special: str = "", pad_segments: int = 1):
    """(spec, cols, params, num_docs) of one vector top-K launch, numpy
    arrays as the engine stages them: `spec` holds the plan fields both
    packages' plans take (`vec_col` 'v'); cols 'vec:v' [S, D * dim_pad]
    float32 (unit rows, zero padding), with IVF 'vcell:v' [S, D] int32
    (some ids outside [0, n_cells), which the kernel clips), with `resid`
    'ids:a' int8 under a range leaf, with `vmask` a bool 'vmask'; params
    'vq:q' [S, dim_pad] (a query per segment), 'vq:k' (one segment's K
    three below the others), 'vq:cells' with IVF, the leaf bounds.
    special: 'ties' copies rows so scores tie exactly; 'zeros' (dim 8 =
    dim_pad) gives docs scores of exactly +0.0 and -0.0 above every other;
    'nan' puts NaN rows among the docs. The last pad_segments segments are
    empty."""
    rng = np.random.default_rng(seed)
    dim_pad = _pow2(dim, 8)
    nd = rng.integers(D // 2, D + 1, S).astype(np.int32)
    nd[0] = D
    if pad_segments:
        nd[-pad_segments:] = 0
    v = rng.normal(size=(S, D, dim))
    q = rng.normal(size=(S, dim))
    if special == "zeros":
        if dim != 8:
            raise ValueError("the signed-zero case needs dim = dim_pad = 8")
        q[:, :4] = 0.5
        q[:, 4:] = 0.0
        v[:, :, :4] = -np.abs(v[:, :, :4])  # every other score < 0
        zero = rng.random((S, D)) < 0.3
        neg = rng.random((S, D)) < 0.5
        v[zero] = 0.0
        v[zero & neg, :4] = -0.0
        v[zero & neg, 4:] = -0.5
        v[zero & ~neg, 4:] = 0.5
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = v.astype(np.float32)
    if special == "ties":
        for s in range(S):
            src = rng.integers(0, D, 40)
            dst = rng.integers(0, D, 40)
            v[s, dst] = v[s, src]
    if special == "nan":
        v[rng.random((S, D)) < 0.001] = np.nan
    vp = np.zeros((S, D, dim_pad), np.float32)
    vp[:, :, :dim] = v
    qp = np.zeros((S, dim_pad), np.float32)
    qp[:, :dim] = q
    kq = np.full(S, k, np.int32)
    kq[min(1, S - 1)] = max(1, k - 3)
    cols = {"vec:v": vp.reshape(S, D * dim_pad)}
    params = {"vq:q": qp, "vq:k": kq}
    cells_pad = 0
    if ivf:
        cells_pad = _pow2(n_cells, 8)
        cols["vcell:v"] = rng.integers(-1, n_cells + 2, (S, D)).astype(
            np.int32)
        params["vq:cells"] = rng.random((S, cells_pad)) < 0.3
    spec = dict(vec_col="v", dim_pad=dim_pad, k_pad=_pow2(k, 8), ivf=ivf,
                cells_pad=cells_pad, filter_ir=None, leaves=(),
                dict_cols=(), valid_mask=vmask)
    if resid:
        cols["ids:a"] = rng.integers(0, 100, (S, D)).astype(np.int8)
        params["leaf0:lo"] = rng.integers(0, 40, S).astype(np.int32)
        params["leaf0:hi"] = (params["leaf0:lo"] + 50).astype(np.int32)
        spec.update(filter_ir=("leaf", 0), leaves=(("range", "a"),),
                    dict_cols=("a",))
    if vmask:
        cols["vmask"] = rng.random((S, D)) < 0.7
    return spec, cols, params, nd


def vector_plan(spec: dict) -> DevicePlan:
    """The port's vector plan of a vector_case spec."""
    return DevicePlan(
        filter_ir=spec["filter_ir"],
        leaves=tuple(DeviceLeaf(*lf) for lf in spec["leaves"]),
        value_irs=(), agg_ops=(), dict_cols=spec["dict_cols"],
        mode="vector", valid_mask=spec["valid_mask"],
        vec_col=spec["vec_col"], dim_pad=spec["dim_pad"],
        k_pad=spec["k_pad"], ivf=spec["ivf"], cells_pad=spec["cells_pad"])


def vector_truth(spec: dict, cols, params, nd):
    """Per segment (exact float64 scores [D], candidate mask [D], residual
    mask [D], K) of a vector_case: the yardstick that a packed row is
    checked against with `check_vector_row`."""
    S = len(nd)
    dp = spec["dim_pad"]
    D = cols["vec:v"].shape[1] // dp
    V = cols["vec:v"].reshape(S, D, dp).astype(np.float64)
    out = []
    for s in range(S):
        exact = V[s] @ params["vq:q"][s].astype(np.float64)
        real = np.arange(D) < nd[s]
        cand = real.copy()
        if spec["ivf"]:
            c = np.clip(cols["vcell:v"][s], 0, spec["cells_pad"] - 1)
            cand &= params["vq:cells"][s][c]
        resid = real.copy()
        if spec["valid_mask"]:
            resid &= cols["vmask"][s].astype(bool)
        if spec["filter_ir"] is not None:
            a = cols["ids:a"][s]
            resid &= (a >= params["leaf0:lo"][s]) \
                & (a <= params["leaf0:hi"][s])
        out.append((exact, cand, resid, int(params["vq:k"][s])))
    return out


def check_vector_row(row, exact, cand, resid, k: int, kk: int,
                     tol: float = VEC_TOL) -> list:
    """The kept (doc, score) pairs of packed row `row` [1 + 2 kk], after
    checking it against the float64 truth: each kept doc a candidate that
    passes the residual filter, its score within tol of the exact one,
    the kept docs in score order (equal scores toward the lower doc), and
    the winner set right up to tol: every doc whose exact score is more
    than tol above the K-th best candidate's and passes the filter kept,
    none kept more than tol below it. A NaN score is above every score
    (K8's and XLA's order) and never kept."""
    ids = np.asarray(row[1:1 + kk], np.float64)
    sc = np.asarray(row[1 + kk:1 + 2 * kk], np.float32)
    kept = ids >= 0
    g_ids = ids[kept].astype(np.int64)
    g_sc = sc[kept]
    assert int(row[0]) == len(g_ids)
    assert np.all(np.isneginf(sc[~kept]))
    assert np.all(cand[g_ids]) and np.all(resid[g_ids])
    assert np.all(np.abs(g_sc.astype(np.float64) - exact[g_ids]) <= tol)
    for i in range(len(g_ids) - 1):
        assert exact[g_ids[i]] >= exact[g_ids[i + 1]] - 2 * tol
        if g_sc[i] == g_sc[i + 1]:
            a, b = np.signbit(g_sc[i]), np.signbit(g_sc[i + 1])
            # +0.0 ranks above -0.0; otherwise ties go to the lower doc
            assert a <= b and (a != b or g_ids[i] < g_ids[i + 1])
    pool = np.nonzero(cand)[0]
    key = np.where(np.isnan(exact[pool]), np.inf, exact[pool])
    order = pool[np.lexsort((pool, -key))]
    n_win = min(k, kk, len(order))
    if n_win:
        t = exact[order[n_win - 1]]
        t = np.inf if np.isnan(t) else t
        sure = pool[(exact[pool] > t + 2 * tol) & resid[pool]]
        assert set(sure.tolist()) <= set(g_ids.tolist())
        assert np.all(exact[g_ids] >= t - 2 * tol)
    return list(zip(g_ids.tolist(), g_sc.tolist()))


def near_ties(exact, cand, k: int, kk: int, tol: float = VEC_TOL) -> bool:
    """True when two of the first min(k, kk) + 1 candidates by exact score
    lie within 2 tol of each other (a band where sums in other orders may
    rank them either way, or swap them across the cut)."""
    pool = np.nonzero(cand & ~np.isnan(exact))[0]
    top = np.sort(exact[pool])[::-1][:min(k, kk) + 1]
    return bool(np.any(np.abs(np.diff(top)) <= 2 * tol))


def same_vector_rows(a, b, truth, kk: int, tol: float = VEC_TOL) -> None:
    """Packed rows a and b (one launch each, [S, 1 + 2 kk]) both right by
    `check_vector_row`; where no band of near-tied scores reaches the cut,
    the same docs in the same order, scores within tol."""
    for s, (exact, cand, resid, k) in enumerate(truth):
        ga = check_vector_row(a[s], exact, cand, resid, k, kk, tol)
        gb = check_vector_row(b[s], exact, cand, resid, k, kk, tol)
        if not near_ties(exact, cand, k, kk, tol):
            assert [d for d, _ in ga] == [d for d, _ in gb]
            assert np.allclose([x for _, x in ga], [x for _, x in gb],
                               atol=tol, rtol=0)
