"""The scan-aggregate, group-by, sketch and top-N kernels: plain PyTorch
versions, and the wrappers that hand CUDA tensors to the hand-written
kernels.

Counterpart of pinot_tpu/ops/kernels.py, whose jit'd `make_kernel`
(kernels.py:537) computes, for stacked segment blocks [S, D]:

  mask  = filter tree over dictId compares / LUT gathers / value ranges
  vals  = value-expression arithmetic over staged value blocks
  out   = masked reductions (count / sum / sumsq / sum3 / sum4 / min / max,
          exact integer sums as 6- or 7-bit planes), sketch slots (HLL
          registers over a column's i32 split planes, `_hll_slot` :429;
          fixed-bucket histograms, `_hist_slot` :451), or per-group
          partials

and whose `make_topn_kernel` (kernels.py:583) picks, per segment, the top-K
doc ids by an order value (or the first K matched docs) as `[S, 1 + K]`
int32.

The functions below are the same arithmetic in PyTorch, in the same packed
layouts: `[S, 1 + sum(w)]` ungrouped (column 0 = matched count),
`[S, G, n_slots]` grouped and `[S, 1 + K]` top-N. They run on any device;
`make_kernel` and `make_topn_kernel` use them only for CPU tensors. A CUDA
tensor goes to the kernels in
`ops/csrc/` (K1 `scan_agg`, K2 `group_agg`, K3 `sketch_agg`, K4 `topn`,
wrapped by `ops/_cuda.py`) or raises — there is no fallback between the two.
K5 `startree_agg`'s plain version and wrapper live in ops/startree_device.py.
`assemble_rows` (JAX `compiled_row_assembler`, kernels.py:100) builds a
staged [S, D] block from per-segment device rows: K6 `row_assemble` on the
card, `row_assemble` (zeros plus one slice copy per row) on the CPU.

`batched_kernel` (JAX's batched factories, kernels.py:793, :823, :858)
runs B coalesced queries of one plan as one launch of the same kernels
with a member axis: CUDA inputs launch K1-K4 once for all members
(ops/_cuda.py `*_batched`), CPU inputs loop over the members through the
plain versions (`plain_batched_kernel`). The output carries a leading [B]
axis.

A CLP leaf (LIKE / REGEXP_LIKE over a CLP log column, ops/clp_device.py)
is matched per doc by `clp_match`, the counterpart of JAX
clp_device.py:700 `eval_leaf`, over the column's logtype and variable-slot
pseudo-columns. On the card K7 (`ops/csrc/clp_match.cu`) computes every
CLP leaf's mask of a launch first (`clp_masks`: one launch of K7 per CLP
column and launch, over all members of a batch, giving each leaf's [B, S,
D] masks), and K1 / K2 / K4 read each mask as the leaf's value (the LUT
`leaf<i>:mask`, passed to their wrappers already stacked).

A vector plan (mode 'vector', ops/vector_device.py) is the similarity
top-K of JAX vector_device.py:104 `make_vector_kernel`: `make_vector_kernel`
hands CUDA tensors to K8 `vector_topk` (ops/csrc/vector_topk.cu; K7 first
for CLP leaves in its residual filter) and CPU tensors to its plain version
`vector_device.vector_topk`; `batched_kernel` takes vector plans too.

A plan over upsert segments (`plan.valid_mask`) ANDs the staged `vmask`
block into the doc validity (JAX kernels.py:565, :604), in every plain
version here and in K1-K4. A group-by plan with a fused time bucket
(`plan.tbucket`) adds `timeseries_device.bucket_ids` as the key's lowest
digit and ANDs its gate into the match (JAX kernels.py:496-506); K2 does
the same per doc. A compact-key plan (`plan.group_compact`) reads each
doc's key from the staged int32 `gkey` block of per-segment codes (JAX
kernels.py:488-491), K2 as one load per doc; its num_groups is 0, so every
grouped kernel here takes the group count G as its launch argument (JAX's
static G), and a dense plan's G is its num_groups.

The value dtype (float32, the card's default, or float64) is an explicit
argument, where the JAX package reads `jax_enable_x64`. Values and their
products are computed in the value dtype, as in the JAX kernel; sums
accumulate in float64 and round once to the value dtype (the JAX kernel
adds in the value dtype), in these plain versions and in the kernels alike.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinot_tpu_torch.ops import _cuda, timeseries_device
from pinot_tpu_torch.ops.plan_ir import DevicePlan, is_grouped
from pinot_tpu_torch.ops.program import (ISUM_PLANES, ISUM_U_BITS,
                                         is_sketch, plan_fingerprint,
                                         slot_width, trace_count,
                                         trace_count_by_plan)
from pinot_tpu_torch.parallel.mesh import (Mesh, ShardedBlock, local_shape,
                                           shard_segments)

__all__ = ["make_kernel", "plain_kernel", "make_topn_kernel", "topn_kernel",
           "make_vector_kernel",
           "plain_batched_kernel", "batched_kernel", "row_assemble",
           "assemble_rows", "clp_match", "clp_masks",
           "order_keys", "from_order_keys", "minmax_combine",
           "from_jax_staged", "slot_width", "is_sketch",
           "DOC_COMBINE", "MeshFold", "doc_fold", "mesh_fold",
           "mesh_fold_plain", "sharded_kernel", "batched_sharded_kernel",
           "plain_sharded_kernel", "plain_batched_sharded_kernel",
           "trace_count", "trace_count_by_plan", "plan_fingerprint",
           "ISUM_PLANES", "ISUM_U_BITS"]

Tensors = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# filter and value IR (kernels.py:128 `_eval_filter`, :197 `_eval_value`)
# ---------------------------------------------------------------------------

def eval_filter(node, plan: DevicePlan, cols: Tensors,
                params: Tensors) -> torch.Tensor:
    op = node[0]
    if op in ("and", "or"):
        out = eval_filter(node[1], plan, cols, params)
        for child in node[2:]:
            rhs = eval_filter(child, plan, cols, params)
            out = out & rhs if op == "and" else out | rhs
        return out
    if op == "not":
        return ~eval_filter(node[1], plan, cols, params)
    if op != "leaf":
        raise ValueError(f"unknown filter op {op!r}")
    i = node[1]
    leaf = plan.leaves[i]
    if leaf.kind == "range":
        ids = cols["ids:" + leaf.column]
        lo = clamp_to(params[f"leaf{i}:lo"], ids.dtype)[:, None]
        hi = clamp_to(params[f"leaf{i}:hi"], ids.dtype)[:, None]
        return (ids >= lo) & (ids <= hi)
    if leaf.kind == "neq":
        ids = cols["ids:" + leaf.column]
        return ids != clamp_to(params[f"leaf{i}:idx"], ids.dtype)[:, None]
    if leaf.kind == "lut":
        ids = cols["ids:" + leaf.column]
        return torch.gather(params[f"leaf{i}:lut"], 1, ids.long())
    if leaf.kind == "vrange":
        vals = cols["val:" + leaf.column]
        lo = params[f"leaf{i}:lo"][:, None]
        hi = params[f"leaf{i}:hi"][:, None]
        return (vals >= lo) & (vals <= hi)
    if leaf.kind == "vrange64":
        # exact closed-interval compare on (hi, lo) i32 split planes:
        # lexicographic (hi strictly dominates; lo always in [0, 2^24))
        vhi = cols["valhi:" + leaf.column]
        vlo = cols["vallo:" + leaf.column]
        a_hi = params[f"leaf{i}:lohi"][:, None]
        a_lo = params[f"leaf{i}:lolo"][:, None]
        b_hi = params[f"leaf{i}:hihi"][:, None]
        b_lo = params[f"leaf{i}:hilo"][:, None]
        ge = (vhi > a_hi) | ((vhi == a_hi) & (vlo >= a_lo))
        le = (vhi < b_hi) | ((vhi == b_hi) & (vlo <= b_lo))
        return ge & le
    if leaf.kind == "clp":
        return clp_match(i, leaf, cols, params)
    raise ValueError(f"unknown leaf kind {leaf.kind}")


# ---------------------------------------------------------------------------
# CLP leaves (JAX clp_device.py:700 `eval_leaf`, :757 `make_match_kernel`)
# ---------------------------------------------------------------------------

def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[s, idx[s, d]] per segment row, idx clipped into the row (a
    staged index is always inside it; K7 clips alike)."""
    return torch.gather(table, 1, idx.long().clamp(0, table.shape[1] - 1))


def clp_match(i: int, leaf, cols: Tensors, params: Tensors) -> torch.Tensor:
    """The plain version of K7: the [S, D] bool match of CLP leaf i.
    Padded docs give whatever their zero rows give (as in the JAX kernel):
    the doc validity clips them.

    Mode 'a': the logtype LUT at the doc's logtype id, OR the dict-var LUT
    at each of its Kd dict-var slots. Mode 'b': each of the segment's
    conditions is evaluated once into a bit of `ok` (padding, ck = 0,
    holds; ck = 1 an encoded-var equality on the (hi, lo) pair of slot
    cs; ck = 2 the dict-var bank LUT cl at the dict-var of slot cs), and
    the doc matches when its logtype is a candidate or some group g has
    glt[g] == its logtype and every member condition of g holds (gmem[g]
    a subset of ok: the JAX f32 einsum counts the failures, exactly, at
    these sizes)."""
    mode, kd, ke = leaf.meta
    col = leaf.column
    ids = cols[f"clpid:{col}"]
    match = _take(params[f"leaf{i}:alut"], ids)
    if mode == "a":
        for j in range(kd):
            match = match | _take(params[f"leaf{i}:dvlut"],
                                  cols[f"clpdv{j}:{col}"])
        return match
    glt = params[f"leaf{i}:glt"]
    gmem = params[f"leaf{i}:gmem"]
    ck = params[f"leaf{i}:ck"]
    cs = params[f"leaf{i}:cs"]
    S, NC = ck.shape
    rows = torch.arange(S, device=ids.device)
    if ke:
        ehi = torch.stack([cols[f"clpehi{j}:{col}"] for j in range(ke)], 1)
        elo = torch.stack([cols[f"clpelo{j}:{col}"] for j in range(ke)], 1)
    if kd:
        dv = torch.stack([cols[f"clpdv{j}:{col}"] for j in range(kd)], 1)
        dlut = params[f"leaf{i}:dlut"]
    ok = torch.zeros(ids.shape, dtype=torch.int64, device=ids.device)
    for c in range(NC):
        k = ck[:, c, None]
        hold = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        if ke:
            j = cs[:, c].long().clamp(0, ke - 1)
            enc = (ehi[rows, j] == params[f"leaf{i}:chi"][:, c, None]) \
                & (elo[rows, j] == params[f"leaf{i}:clo"][:, c, None])
            hold = torch.where(k == 1, enc, hold)
        if kd:
            j = cs[:, c].long().clamp(0, kd - 1)
            bank = dlut[rows, params[f"leaf{i}:cl"][:, c].long().clamp(
                0, dlut.shape[1] - 1)]
            hold = torch.where(k == 2, _take(bank, dv[rows, j]), hold)
        ok |= hold.long() << c
    need = (gmem.long() << torch.arange(NC, device=ids.device)).sum(-1)
    grp = torch.zeros_like(match)
    for g in range(glt.shape[1]):
        lt = glt[:, g, None]
        grp |= (lt >= 0) & (ids == lt) \
            & ((ok & need[:, g, None]) == need[:, g, None])
    return match | grp


def clp_leaves(plan: DevicePlan) -> Dict[str, List[Tuple[int, object]]]:
    """The plan's CLP leaves by column: column -> [(leaf index, leaf)]."""
    out: Dict[str, List[Tuple[int, object]]] = {}
    for i, leaf in enumerate(plan.leaves):
        if leaf.kind == "clp":
            out.setdefault(leaf.column, []).append((i, leaf))
    return out


def clp_masks(plan: DevicePlan, col_sets: Sequence[Tensors],
              plist: Sequence[Tensors], idx: Sequence[int], D: int,
              batched: bool) -> Tensors:
    """Every CLP leaf's match masks over the members, `leaf<i>:mask` ->
    [B, S, D] bool, from launches of K7 on the card: one per CLP column,
    over all members and up to `_cuda.CLP_MAX_LEAVES` leaves of that
    column. K1-K4's wrappers take them as stacked LUTs (`luts=`). CUDA
    tensors only."""
    out: Tensors = {}
    for leaves in clp_leaves(plan).values():
        for c0 in range(0, len(leaves), _cuda.CLP_MAX_LEAVES):
            chunk = leaves[c0:c0 + _cuda.CLP_MAX_LEAVES]
            masks = _cuda.clp_match_batched(chunk, col_sets, plist, idx, D,
                                            batched=batched)
            for l, (i, _leaf) in enumerate(chunk):
                out[f"leaf{i}:mask"] = masks[l]
    return out


def clamp_to(arr: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Compare-bound params clamp into a narrow id dtype (an out-of-range
    sentinel like 2^31-1 clamps to 'matches everything')."""
    if arr.dtype == dtype:
        return arr
    info = torch.iinfo(dtype)
    return arr.clamp(info.min, info.max).to(dtype)


def eval_value(ir, cols: Tensors, value_dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    op = ir[0]
    if op == "col":
        return cols["val:" + ir[1]]
    if op == "ids":
        return cols["ids:" + ir[1]].to(value_dtype)
    if op == "lit":
        return torch.tensor(ir[1], dtype=value_dtype, device=device)
    a = eval_value(ir[1], cols, value_dtype, device)
    if op == "neg":
        return -a
    b = eval_value(ir[2], cols, value_dtype, device)
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return a / b
    raise ValueError(f"unknown value ir op {op!r}")


def eval_value_int(ir, cols: Tensors, device: torch.device) -> torch.Tensor:
    """A value IR in exact int32 arithmetic (kernels.py:354): the engine
    admits only IRs whose every node fits i32, over int-exact columns."""
    op = ir[0]
    if op == "col":
        return cols["val:" + ir[1]].to(torch.int32)
    if op == "lit":
        return torch.tensor(int(ir[1]), dtype=torch.int32, device=device)
    a = eval_value_int(ir[1], cols, device)
    if op == "neg":
        return -a
    b = eval_value_int(ir[2], cols, device)
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    raise ValueError(f"non-exact int ir op {op!r}")


# ---------------------------------------------------------------------------
# reductions (kernels.py:228 `_masked_reduce`, :252 `_grouped_reduce`,
# :377 `_isum_slot`, :404 `_isum_u_slot`)
# ---------------------------------------------------------------------------

def _full(vals: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A literal value IR is 0-d: broadcast it to the block."""
    return vals.expand(m.shape) if vals.dim() == 0 else vals


def _powered(op: str, v: torch.Tensor) -> torch.Tensor:
    if op == "sumsq":
        return v * v
    if op == "sum3":
        return v * v * v
    if op == "sum4":
        v2 = v * v
        return v2 * v2
    return v


def masked_reduce(op: str, vals: Optional[torch.Tensor], mask: torch.Tensor,
                  valid: torch.Tensor,
                  value_dtype: torch.dtype) -> torch.Tensor:
    """[S, D] -> [S] masked reduction; `valid` excludes padding docs."""
    m = mask & valid
    if op == "count":
        return m.sum(1).to(value_dtype)
    v = _full(vals, m)
    if op in ("sum", "sumsq", "sum3", "sum4"):
        return torch.where(m, _powered(op, v), 0).sum(
            1, dtype=torch.float64).to(value_dtype)
    if op in ("min", "max"):
        fill = float("inf") if op == "min" else float("-inf")
        x = torch.where(m, v, fill)
        k = order_keys(x)
        k = k.amin(1) if op == "min" else k.amax(1)
        return _nan_where(torch.isnan(x).any(1), from_order_keys(k))
    raise ValueError(f"unknown reduction {op!r}")


def grouped_reduce(op: str, vals: Optional[torch.Tensor], keys: torch.Tensor,
                   mask: torch.Tensor, valid: torch.Tensor, num_groups: int,
                   value_dtype: torch.dtype) -> torch.Tensor:
    """[S, D] + keys [S, D] -> [S, G] per-group partials; a key outside
    [0, G) is dropped, as K2 and XLA's scatters drop it."""
    m = mask & valid & (keys >= 0) & (keys < num_groups)
    S = m.shape[0]
    safe_keys = torch.where(m, keys, 0).long()
    init = torch.zeros((S, num_groups), dtype=torch.float64, device=m.device)
    if op == "count":
        return init.scatter_add_(1, safe_keys, m.double()).to(value_dtype)
    v = _full(vals, m)
    if op in ("sum", "sumsq", "sum3", "sum4"):
        contrib = torch.where(m, _powered(op, v), 0).double()
        return init.scatter_add_(1, safe_keys, contrib).to(value_dtype)
    if op in ("min", "max"):
        fill = float("inf") if op == "min" else float("-inf")
        x = torch.where(m, v, fill)
        init = order_keys(torch.full((S, num_groups), fill, dtype=x.dtype,
                                     device=m.device))
        k = init.scatter_reduce_(1, safe_keys, order_keys(x), "a" + op,
                                 include_self=True)
        nan = torch.zeros((S, num_groups), dtype=torch.int32,
                          device=m.device).scatter_add_(
            1, safe_keys, torch.isnan(x).int())
        return _nan_where(nan > 0, from_order_keys(k))
    raise ValueError(f"unknown grouped reduction {op!r}")


def _nan_where(nan: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x with the quiet NaN of its dtype wherever `nan` holds: a min / max
    over a NaN is NaN, as XLA's is (the kernels write the same bits)."""
    return torch.where(nan, torch.tensor(float("nan"), dtype=x.dtype,
                                         device=x.device), x)


def minmax_combine(op: str, acc: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """One step of a min / max fold, element by element: NaN sticks and
    -0.0 ranks below +0.0, whatever the order of the operands, as XLA's
    min / max and its scatter-min / -max rank them."""
    ka, kv = order_keys(acc), order_keys(v)
    pick = kv < ka if op == "min" else kv > ka
    return _nan_where(torch.isnan(acc) | torch.isnan(v),
                      torch.where(pick, v, acc))


def isum_slot(vi: torch.Tensor, mv: torch.Tensor,
              value_dtype: torch.dtype) -> torch.Tensor:
    """Bit-exact SUM of an i32-evaluated value: six signed 6-bit planes
    (the top one arithmetic-shifted), each summed in int32 and split into
    f32-exact (hi, lo) 12-bit halves. The host rebuilds
    sum = sum_k (hi_k * 4096 + lo_k) << 6k (engine `_isum_value`)."""
    vi = torch.where(mv, vi, 0)
    parts = []
    for k in range(ISUM_PLANES):
        p = (vi >> 6 * k) & 63 if k < ISUM_PLANES - 1 else vi >> 30
        parts += _halves(p.sum(1, dtype=torch.int32), value_dtype)
    return torch.stack(parts, 1)


def isum_u_slot(op: str, vi: torch.Tensor, mv: torch.Tensor,
                value_dtype: torch.dtype) -> torch.Tensor:
    """Non-negative exact SUM: ceil(bits/7) unsigned 7-bit planes."""
    planes = int(op.split(":")[1][1:])
    vi = torch.where(mv, vi, 0)
    parts = []
    for k in range(planes):
        p = (vi >> ISUM_U_BITS * k) & 127
        parts += _halves(p.sum(1, dtype=torch.int32), value_dtype)
    return torch.stack(parts, 1)


def _halves(s: torch.Tensor, value_dtype: torch.dtype) -> List[torch.Tensor]:
    return [(s >> 12).to(value_dtype), (s & 4095).to(value_dtype)]


# ---------------------------------------------------------------------------
# sketch slots (kernels.py:419 `_fmix32`, :429 `_hll_slot`, :451
# `_hist_slot`)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for h in [0, 2^32) held in int64: PyTorch has no
    uint32 shifts on the CPU, and a full 32 x 32-bit product would leave
    int64, so the product is taken in 16-bit halves (each below 2^48)."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash32_pair(hi: torch.Tensor, lo: torch.Tensor):
    """The HLL hash pair over (hi, lo) i32 split planes, as uint32 values
    in int64; the host sketch's `hash32_pair` bit for bit."""
    hi = hi.long() & _U32
    lo = lo.long() & _U32
    h1 = fmix32(fmix32(lo ^ 0x9E3779B9) ^ hi)
    h2 = fmix32(fmix32(hi ^ 0x85EBCA77) ^ lo)
    return h1, h2


def hll_slot(op: str, cols: Tensors, mask: torch.Tensor,
             value_dtype: torch.dtype) -> torch.Tensor:
    """HLL registers [S, 2^log2m] of op 'hll:<log2m>:<col>': bucket = the
    low log2m bits of h1, rank = clz(h2) + 1 (33 when h2 is 0) taken
    exactly from frexp, max-scattered; ranks in the value dtype."""
    _, log2m, col = op.split(":", 2)
    m = 1 << int(log2m)
    h1, h2 = hash32_pair(cols["valhi:" + col], cols["vallo:" + col])
    _frac, e = torch.frexp(h2.double())
    rank = torch.where(h2 == 0, 33, 33 - e.long())
    rank = torch.where(mask, rank, 0).to(value_dtype)  # 0 = empty register
    bucket = torch.where(mask, h1 & (m - 1), 0)
    regs = torch.zeros((mask.shape[0], m), dtype=value_dtype,
                       device=mask.device)
    return regs.scatter_reduce_(1, bucket, rank, "amax", include_self=True)


def hist_slot(op: str, j: int, vals: torch.Tensor, params: Tensors,
              mask: torch.Tensor, value_dtype: torch.dtype) -> torch.Tensor:
    """Histogram counts [S, B] of op 'hist:<B>' (slot j), bounds from the
    per-segment `slot{j}:hlo` / `slot{j}:hscale` parameters: bucket =
    clip((v - lo) * scale, 0, B - 1) in the value dtype, truncated. NaN
    lands in bucket 0, where XLA's float to int32 conversion puts it (a C
    cast or Tensor.to leaves it undefined); -inf clips to 0, +inf to B - 1."""
    B = int(op.split(":")[1])
    lo = params[f"slot{j}:hlo"][:, None]
    scale = params[f"slot{j}:hscale"][:, None]
    t = ((_full(vals, mask) - lo) * scale).clamp(0, B - 1)
    bucket = torch.where(mask & ~torch.isnan(t), t, 0).long()
    counts = torch.zeros((mask.shape[0], B), dtype=torch.int64,
                         device=mask.device)
    return counts.scatter_add_(1, bucket, mask.long()).to(value_dtype)


def pack_flat(matched: torch.Tensor,
              slots: List[Tuple[str, torch.Tensor]]) -> torch.Tensor:
    """[S]-scalar and [S, w] slots -> one [S, 1 + sum(w)] array."""
    parts = [matched[:, None]]
    for _op, s in slots:
        parts.append(s[:, None] if s.dim() == 1 else s)
    return torch.cat(parts, 1)


# ---------------------------------------------------------------------------
# kernel assembly (kernels.py:468 `_compute_slots`, :537 `make_kernel`)
# ---------------------------------------------------------------------------

def doc_validity(plan: DevicePlan, cols: Tensors, num_docs: torch.Tensor,
                 D: int) -> torch.Tensor:
    """[S, D] bool: the real docs (below num_docs), and of those the valid
    ones where the plan carries the upsert validity mask."""
    valid = torch.arange(D, dtype=torch.int32,
                         device=num_docs.device)[None, :] < num_docs[:, None]
    if plan.valid_mask:
        valid = valid & cols["vmask"].bool()
    return valid


def group_keys(plan: DevicePlan, cols: Tensors, params: Tensors,
               shape) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The key [S, D] int32 of a group-by plan and the time bucket's gate
    (None without a bucket): the compact codes of the `gkey` block, or
    the dense mixed-radix key, the bucket id its lowest digit."""
    if plan.group_compact:
        return cols["gkey"].to(torch.int32), None
    device = params["tb:step"].device if plan.tbucket else None
    keys = None
    for col, stride in zip(plan.group_cols, plan.group_strides):
        k = cols["ids:" + col].to(torch.int32) * stride
        keys = k if keys is None else keys + k
        device = k.device
    if keys is None:
        keys = torch.zeros(shape, dtype=torch.int32, device=device)
    if not plan.tbucket:
        return keys, None
    tcol, count_pad = plan.tbucket
    b, gate = timeseries_device.bucket_ids(
        cols["valhi:" + tcol], cols["vallo:" + tcol], params["tb:shi"],
        params["tb:slo"], params["tb:step"], params["tb:count"], count_pad)
    return keys + b, gate


def group_count(plan: DevicePlan, G: int = 0) -> int:
    """A grouped plan's G: its dense key space, else the launch's G (JAX
    `plan.num_groups or G`); 0 for an ungrouped plan."""
    n = plan.num_groups or (G if plan.group_compact else 0)
    if plan.group_compact and n < 1:
        raise ValueError("a compact-key plan needs its group count G")
    return n


def compute_slots(plan: DevicePlan, cols: Tensors, params: Tensors,
                  valid: torch.Tensor, value_dtype: torch.dtype, G: int = 0):
    """Filter + values + per-slot reductions over an [S, D] block (G: the
    group count of a compact-key plan). Returns ([(op, [S]- or [S,
    G]-tensor)], matched [S] or None)."""
    device = valid.device
    if plan.filter_ir is not None:
        mask = eval_filter(plan.filter_ir, plan, cols, params)
    else:
        mask = torch.ones_like(valid)
    agg_masks = [eval_filter(ir, plan, cols, params)
                 for ir in plan.agg_filter_irs]
    values = [eval_value(ir, cols, value_dtype, device)
              for ir in plan.value_irs]
    slots = []
    num_groups = group_count(plan, G)
    if num_groups:
        keys, gate = group_keys(plan, cols, params, valid.shape)
        if gate is not None:
            mask = mask & gate
        for op, vidx, fidx in plan.agg_ops:
            m = mask if fidx is None else mask & agg_masks[fidx]
            vals = None if vidx is None else values[vidx]
            slots.append((op, grouped_reduce(op, vals, keys, m, valid,
                                             num_groups, value_dtype)))
        return slots, None
    matched = (mask & valid).sum(1).to(value_dtype)
    for j, (op, vidx, fidx) in enumerate(plan.agg_ops):
        m = mask if fidx is None else mask & agg_masks[fidx]
        if op.startswith("hll:"):
            slots.append((op, hll_slot(op, cols, m & valid, value_dtype)))
            continue
        if op.startswith("hist:"):
            slots.append((op, hist_slot(op, j, values[vidx], params,
                                        m & valid, value_dtype)))
            continue
        if op == "isum" or op.startswith("isum:u"):
            vi = eval_value_int(plan.value_irs[vidx], cols, device)
            slot = isum_slot(vi, m & valid, value_dtype) if op == "isum" \
                else isum_u_slot(op, vi, m & valid, value_dtype)
            slots.append((op, slot))
            continue
        vals = None if vidx is None else values[vidx]
        slots.append((op, masked_reduce(op, vals, m, valid, value_dtype)))
    return slots, matched


def plain_kernel(plan: DevicePlan, value_dtype: torch.dtype = torch.float32):
    """The plain PyTorch version: fn(cols, params, num_docs, D, G=0) ->
    packed tensor, on whatever device its inputs lie."""
    def kernel(cols: Tensors, params: Tensors, num_docs: torch.Tensor,
               D: int, G: int = 0) -> torch.Tensor:
        valid = doc_validity(plan, cols, num_docs, D)
        slots, matched = compute_slots(plan, cols, params, valid,
                                       value_dtype, G)
        if is_grouped(plan):
            return torch.stack([s for _, s in slots], -1)
        return pack_flat(matched, slots)

    return kernel


def make_kernel(plan: DevicePlan, value_dtype: torch.dtype = torch.float32):
    """fn(cols, params, num_docs, D, G=0) -> packed tensor, in the JAX
    kernel's layouts. CUDA inputs launch K1 (`scan_agg`) for scalar slots,
    K3 (`sketch_agg`) for sketch slots — both, on the current stream and
    into one output, when the plan holds both — or, for a group-by plan,
    K2 (`group_agg`); CPU inputs run the plain version.

    cols:     'ids:<col>' i8/i16/i32 [S, D] / 'val:<col>' float [S, D] /
              'valhi:'/'vallo:<col>' i32 [S, D]
    params:   per-leaf arrays ('leaf<i>:lo/hi/idx/lut/...')
    num_docs: int32 [S] real docs per segment (padding mask)
    G:        the group count of a compact-key plan ('gkey' int32 [S, D]
              codes in [0, G)); a dense plan's is its num_groups
    """
    if value_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"value dtype {value_dtype} is not float32/64")
    if plan.mode != "agg":
        raise ValueError("make_kernel takes aggregation plans")
    plain = plain_kernel(plan, value_dtype)
    sketch = [is_sketch(op) for op, _v, _f in plan.agg_ops]

    def kernel(cols: Tensors, params: Tensors, num_docs: torch.Tensor,
               D: int, G: int = 0) -> torch.Tensor:
        G = group_count(plan, G)
        if num_docs.device.type == "cuda":
            args = (plan, cols, params, num_docs, D, value_dtype)
            luts = clp_masks(plan, [cols], [params], [0], D, batched=False)
            if G:
                return _cuda.group_agg(*args, luts=luts, G=G)
            if not any(sketch):
                return _cuda.scan_agg(*args, luts=luts)
            out = None if all(sketch) else _cuda.scan_agg(*args, luts=luts)
            return _cuda.sketch_agg(*args, out=out, luts=luts)
        if num_docs.device.type != "cpu":
            raise ValueError(f"no kernel for device {num_docs.device}")
        return plain(cols, params, num_docs, D, G)

    return kernel


# ---------------------------------------------------------------------------
# top-N (kernels.py:583 `make_topn_kernel`)
# ---------------------------------------------------------------------------

def order_keys(score: torch.Tensor) -> torch.Tensor:
    """Float scores as signed integers in the total order of their bits
    (int32 for float32, int64 for float64): -inf < ... < -0.0 < +0.0 < ...
    < +inf, the order XLA's top_k ranks floats in. A float compare (and so
    torch.sort or torch.topk on the scores) holds -0.0 and +0.0 equal."""
    if score.dtype == torch.float32:
        b = score.contiguous().view(torch.int32)
        return b ^ ((b >> 31) & 0x7FFFFFFF)
    if score.dtype == torch.float64:
        b = score.contiguous().view(torch.int64)
        return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
    raise ValueError(f"score dtype {score.dtype} is not float32/64")


def from_order_keys(keys: torch.Tensor) -> torch.Tensor:
    """The floats of `order_keys` (the map is its own inverse on the
    bits): int32 keys give float32, int64 keys float64."""
    if keys.dtype == torch.int32:
        return (keys ^ ((keys >> 31) & 0x7FFFFFFF)).view(torch.float32)
    if keys.dtype == torch.int64:
        return (keys ^ ((keys >> 63) & 0x7FFFFFFFFFFFFFFF)).view(
            torch.float64)
    raise ValueError(f"key dtype {keys.dtype} is not int32/64")


def topn_scores(plan: DevicePlan, cols: Tensors, params: Tensors,
                num_docs: torch.Tensor, D: int, value_dtype: torch.dtype):
    """(mask, score) of a top-N plan over [S, D]: mask = valid (real docs,
    and upsert-valid ones under a validity mask) & filter;
    score = the order value (negated for ASC) or -doc when unordered, NaN
    as the finite minimum, matched scores clipped to the finite range and
    unmatched ones -inf."""
    device = num_docs.device
    valid = doc_validity(plan, cols, num_docs, D)
    mask = valid if plan.filter_ir is None else \
        valid & eval_filter(plan.filter_ir, plan, cols, params)
    if plan.value_irs:
        v = _full(eval_value(plan.value_irs[0], cols, value_dtype, device),
                  mask)
        score = -v if plan.topn_asc else v
    else:
        score = -torch.arange(D, dtype=value_dtype,
                              device=device)[None, :].expand(mask.shape)
    fin = torch.finfo(value_dtype)
    score = torch.where(torch.isnan(score), fin.min, score)
    score = torch.where(mask, score.clamp(fin.min, fin.max), float("-inf"))
    return mask, score


def topn_kernel(plan: DevicePlan, cols: Tensors, params: Tensors,
                num_docs: torch.Tensor, D: int,
                value_dtype: torch.dtype) -> torch.Tensor:
    """The plain top-N: [S, 1 + k] int32, k = min(topn_k, D): the matched
    count, then the winners' doc ids, score descending under the total
    order of the float's bits and ties toward the lower doc (lax.top_k's
    order), -1 where the winner is unmatched."""
    mask, score = topn_scores(plan, cols, params, num_docs, D, value_dtype)
    k = min(plan.topn_k, D)
    idx = torch.sort(order_keys(score), dim=1, descending=True,
                     stable=True).indices[:, :k]
    found = mask.gather(1, idx)
    top = torch.where(found, idx, -1).to(torch.int32)
    matched = mask.sum(1, dtype=torch.int32)
    return torch.cat([matched[:, None], top], 1)


def make_topn_kernel(plan: DevicePlan,
                     value_dtype: torch.dtype = torch.float32):
    """fn(cols, params, num_docs, D) -> [S, 1 + k] int32: CUDA inputs
    launch K4 (`topn`), CPU inputs run the plain version."""
    if value_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"value dtype {value_dtype} is not float32/64")
    if plan.mode != "topn":
        raise ValueError("make_topn_kernel takes top-N plans")

    def kernel(cols: Tensors, params: Tensors, num_docs: torch.Tensor,
               D: int) -> torch.Tensor:
        if num_docs.device.type == "cuda":
            luts = clp_masks(plan, [cols], [params], [0], D, batched=False)
            return _cuda.topn(plan, cols, params, num_docs, D, value_dtype,
                              luts=luts)
        if num_docs.device.type != "cpu":
            raise ValueError(f"no kernel for device {num_docs.device}")
        return topn_kernel(plan, cols, params, num_docs, D, value_dtype)

    return kernel


def make_vector_kernel(plan: DevicePlan):
    """fn(cols, params, num_docs, D) -> [S, 1 + 2 kk] float32 similarity
    top-K of a vector plan (JAX vector_device.py:104): CUDA inputs launch
    K8 (`vector_topk`), CPU inputs run the plain version."""
    if plan.mode != "vector":
        raise ValueError("make_vector_kernel takes vector plans")
    from pinot_tpu_torch.ops import vector_device

    def kernel(cols: Tensors, params: Tensors, num_docs: torch.Tensor,
               D: int) -> torch.Tensor:
        if num_docs.device.type == "cuda":
            luts = clp_masks(plan, [cols], [params], [0], D, batched=False)
            return _cuda.vector_topk(plan, cols, params, num_docs, D,
                                     luts=luts)
        if num_docs.device.type != "cpu":
            raise ValueError(f"no kernel for device {num_docs.device}")
        return vector_device.vector_topk(plan, cols, params, num_docs, D)

    return kernel


# ---------------------------------------------------------------------------
# batched kernels (kernels.py:793 `make_batched_kernel`, :823
# `make_batched_dedup_kernel`, :858 `make_batched_topn_kernel`)
# ---------------------------------------------------------------------------

def plain_batched_kernel(plan: DevicePlan,
                         value_dtype: torch.dtype = torch.float32):
    """The plain batched version: fn(col_sets, plist, ndlist, idx, D,
    G=0) -> [B, ...], each member's plain launch (`plain_kernel`,
    `topn_kernel` or `vector_device.vector_topk`) over column set idx[m],
    stacked; on whatever device its inputs lie."""
    if plan.mode == "agg":
        single = plain_kernel(plan, value_dtype)
    elif plan.mode == "vector":
        from pinot_tpu_torch.ops import vector_device

        def single(cols, params, num_docs, D, G=0):
            return vector_device.vector_topk(plan, cols, params, num_docs, D)
    else:
        def single(cols, params, num_docs, D, G=0):
            return topn_kernel(plan, cols, params, num_docs, D, value_dtype)

    def kernel(col_sets: Sequence[Tensors], plist: Sequence[Tensors],
               ndlist: Sequence[torch.Tensor], idx: Sequence[int],
               D: int, G: int = 0) -> torch.Tensor:
        return torch.stack([single(col_sets[u], params, ndlist[u], D, G)
                            for params, u in zip(plist, idx)])

    return kernel


def batched_kernel(plan: DevicePlan,
                   value_dtype: torch.dtype = torch.float32):
    """fn(col_sets, plist, ndlist, idx, D, G=0) -> [B, ...]: B = len(plist)
    members over U = len(col_sets) column sets (ndlist: num_docs per set),
    member m over set idx[m], G a compact-key plan's group count (the
    members share it: it rides the coalesce key). One function serves
    JAX's three batched factories (kernels.py:793 `make_batched_kernel`, :823
    `make_batched_dedup_kernel`, :858 `make_batched_topn_kernel`):
    broadcast is U = 1, stacked idx = 0..B-1, dedup a member-to-set map.
    CUDA inputs launch the plan's kernels once for all members (K7 first
    for a plan with CLP leaves, then K1 / K3 / both, K2, K4 or K8 with the
    member axis), CPU inputs run the plain version. The kernels take B at
    run time, so nothing is built per member count. JAX's
    `make_batched_vector_kernel` (vector_device.py:163) is the vector
    plan's broadcast and stacked forms."""
    if value_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"value dtype {value_dtype} is not float32/64")
    plain = plain_batched_kernel(plan, value_dtype)
    sketch = [is_sketch(op) for op, _v, _f in plan.agg_ops]

    def run(col_sets, plist, ndlist, idx, D, G=0):
        if len(ndlist) != len(col_sets) or len(idx) != len(plist) \
                or not all(0 <= u < len(col_sets) for u in idx):
            raise ValueError(
                f"{len(plist)} members with {len(idx)} set indexes over "
                f"{len(col_sets)} column sets and {len(ndlist)} num_docs")
        G = group_count(plan, G)
        device = ndlist[0].device
        if device.type == "cpu":
            return plain(col_sets, plist, ndlist, idx, D, G)
        if device.type != "cuda":
            raise ValueError(f"no kernel for device {device}")
        luts = clp_masks(plan, col_sets, plist, idx, D, batched=True)
        args = (plan, col_sets, plist, ndlist, idx, D, value_dtype)
        if plan.mode == "topn":
            return _cuda.topn_batched(*args, luts=luts)
        if plan.mode == "vector":
            return _cuda.vector_topk_batched(*args[:6], luts=luts)
        if G:
            return _cuda.group_agg_batched(*args, luts=luts, G=G)
        if not any(sketch):
            return _cuda.scan_agg_batched(*args, luts=luts)
        out = None if all(sketch) else _cuda.scan_agg_batched(*args,
                                                               luts=luts)
        return _cuda.sketch_agg_batched(*args, out=out, luts=luts)

    return run


# ---------------------------------------------------------------------------
# the mesh (kernels.py:656 `_DOC_COMBINE`, :668 `_shard_one`, :685
# `_shard_combine_pack`, :710 `make_sharded_kernel`, :893
# `make_batched_sharded_kernel`)
# ---------------------------------------------------------------------------

#: how a slot's partials combine across doc shards, segments and slots
DOC_COMBINE = {"sum": "psum", "count": "psum", "sumsq": "psum",
               "sum3": "psum", "sum4": "psum",
               "min": "pmin", "max": "pmax",
               "hll": "pmax",   # register maxima merge across shards
               "hist": "psum",  # bucket counts add across shards
               "isum": "psum"}  # exact-sum planes add (halves stay small)
#: K9's op codes (csrc/mesh_fold.cu)
FOLD_CODES = {"psum": 0, "pmin": 1, "pmax": 2}


def doc_combine(op: str) -> str:
    return DOC_COMBINE[op.split(":")[0]]


def slot_fold_codes(plan: DevicePlan) -> Tuple[int, ...]:
    """K9's op code of each column of a slot's packed partial: one per
    column of the slot's width."""
    out: List[int] = []
    for op, _v, _f in plan.agg_ops:
        out += [FOLD_CODES[doc_combine(op)]] * slot_width(op)
    return tuple(out)


def packed_fold_codes(plan: DevicePlan) -> Tuple[int, ...]:
    """K9's op code of each column of K1-K3's packed output: [S, 1 +
    sum(w)] ungrouped (the matched count adds), [S, G, n_slots] grouped
    (one per slot)."""
    if is_grouped(plan):
        return tuple(FOLD_CODES[doc_combine(op)] for op, _v, _f in
                     plan.agg_ops)
    return (FOLD_CODES["psum"],) + slot_fold_codes(plan)


class MeshFold:
    """The lists of one K9 fold (csrc/mesh_fold.cu), built on the host:
    output row o of width W folds column col0 + w of the partial rows
    src[off[o]:off[o + 1]] (each (slot << 32) | row, rows of `win`
    values, `rows_in` rows per member and slot) by ops[w]; T tail
    elements add column tail_col of their rows tsrc[toff[t]:toff[t +
    1]]. Device copies are made once per device."""

    def __init__(self, R: int, W: int, col0: int, rows_in: int, win: int,
                 ops, off: np.ndarray, src: np.ndarray, tail_col: int = 0,
                 toff: Optional[np.ndarray] = None,
                 tsrc: Optional[np.ndarray] = None):
        self.R, self.W, self.col0 = R, W, col0
        self.rows_in, self.win, self.tail_col = rows_in, win, tail_col
        self.ops = np.asarray(ops, dtype=np.int8)
        self.off = np.ascontiguousarray(off, dtype=np.int64)
        self.src = np.ascontiguousarray(src, dtype=np.int64)
        self.toff = None if toff is None else \
            np.ascontiguousarray(toff, dtype=np.int64)
        self.tsrc = None if tsrc is None else \
            np.ascontiguousarray(tsrc, dtype=np.int64)
        self.T = 0 if toff is None else len(toff) - 1
        if len(self.ops) != W or len(self.off) != R + 1 \
                or col0 + W > win:
            raise ValueError("fold lists out of shape")
        srcs = [self.src] + ([self.tsrc] if self.T else [])
        self.parts = max((int(s.max() >> 32) + 1 for s in srcs if len(s)),
                         default=1)
        self._dev: Dict[str, tuple] = {}

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in (self.ops, self.off, self.src,
                                      self.toff, self.tsrc) if a is not None)

    def on(self, device: torch.device) -> tuple:
        """(ops, off, src, toff, tsrc) on `device` (toff and tsrc None
        without a tail)."""
        key = str(device)
        hit = self._dev.get(key)
        if hit is None:
            hit = tuple(None if a is None else torch.from_numpy(a).to(device)
                        for a in (self.ops, self.off, self.src, self.toff,
                                  self.tsrc))
            self._dev[key] = hit
        return hit


def _fold_lists(vals: torch.Tensor, off: np.ndarray, rows: torch.Tensor,
                ops: torch.Tensor) -> torch.Tensor:
    """[B, R, W] float64: row o of the fold of vals[:, rows[off[o]:off[o +
    1]], :] (vals [B, N, W] float64) by ops[w], element by element in list
    order, from the identities (min / max: `minmax_combine`)."""
    B, _N, W = vals.shape
    R = len(off) - 1
    lens = off[1:] - off[:-1]
    acc = torch.where(ops == 0, 0.0, torch.where(ops == 1, float("inf"),
                                                 float("-inf")))
    acc = acc.to(vals.device, torch.float64).expand(B, R, W).clone()
    for k in range(int(lens.max(initial=0))):
        o = np.nonzero(lens > k)[0]
        v = vals[:, rows[torch.from_numpy(off[o] + k)]]
        a = acc[:, torch.from_numpy(o)]
        acc[:, torch.from_numpy(o)] = torch.where(
            ops == 0, a + v, torch.where(
                ops == 1, minmax_combine("min", a, v),
                minmax_combine("max", a, v)))
    return acc


def mesh_fold_plain(parts: Sequence[torch.Tensor],
                    fold: MeshFold) -> torch.Tensor:
    """The plain version of K9: [B, R * W + T] in the partials' dtype,
    each output element folded in float64 over its list in order and
    rounded once, as K9 folds it; on whatever device the partials lie."""
    B = parts[0].shape[0]
    x = torch.stack([p.reshape(B, fold.rows_in, fold.win) for p in parts])
    flat = x.transpose(0, 1).reshape(B, -1, fold.win).double()
    ops = torch.from_numpy(fold.ops.astype(np.int64)).to(flat.device)

    def rows(src: np.ndarray) -> torch.Tensor:
        return torch.from_numpy((src >> 32) * fold.rows_in
                                + (src & 0xFFFFFFFF)).to(flat.device)

    main = _fold_lists(flat[:, :, fold.col0:fold.col0 + fold.W], fold.off,
                       rows(fold.src), ops[:fold.W])
    out = [main.reshape(B, fold.R * fold.W)]
    if fold.T:
        tail = _add_lists(flat[:, rows(fold.tsrc), fold.tail_col],
                          fold.toff)
        out.append(torch.from_numpy(tail).to(flat.device))
    return torch.cat(out, 1).to(parts[0].dtype)


def _add_lists(vals: torch.Tensor, off: np.ndarray) -> np.ndarray:
    """[B, T] float64: element t the sum of vals[:, off[t]:off[t + 1]]
    (vals [B, N] float64), added in order from 0.0, as K9 adds a tail. A
    grouped tail's list holds every local key of its segment (thousands
    of entries at compact G), so the lists are padded with zeros, which
    leave a sum started at +0.0 unchanged, into one [B, T, L] array whose
    running sums numpy takes in order."""
    x = vals.cpu().numpy()
    B, T = x.shape[0], len(off) - 1
    lens = np.diff(off)
    L = int(lens.max(initial=0))
    if not L:
        return np.zeros((B, T))
    pos = np.arange(L)
    held = pos[None, :] < lens[:, None]
    grid = np.zeros((B, T, L))
    grid[:, held] = x[:, (off[:-1, None] + pos[None, :])[held]]
    with np.errstate(invalid="ignore"):  # inf + -inf is NaN, as in K9
        return np.add.accumulate(grid, axis=2)[:, :, -1]


def mesh_fold(parts: Sequence[torch.Tensor], fold: MeshFold,
              batched: bool = False) -> torch.Tensor:
    """[B, R * W + T]: CUDA partials launch K9 (`mesh_fold`), CPU ones run
    the plain version."""
    device = parts[0].device
    if device.type == "cuda":
        return _cuda.mesh_fold(list(parts), fold, batched=batched)
    if device.type != "cpu":
        raise ValueError(f"no kernel for device {device}")
    return mesh_fold_plain(parts, fold)


@functools.lru_cache(maxsize=256)
def doc_fold(n_seg: int, n_doc: int, s_loc: int, per_seg: int, win: int,
             ops: Tuple[int, ...]) -> MeshFold:
    """The fold over the `docs` axis of per-slot partials [B, s_loc,
    (per_seg,) win]: output row (i, r, g) of segment slice i, local
    segment r (and group g) from the same row of slots (i, 0..n_doc - 1),
    in that order. The output is [B, S (x per_seg) x win]."""
    rows_in = s_loc * per_seg
    o = np.arange(n_seg * rows_in, dtype=np.int64)
    i, r = o // rows_in, o % rows_in
    src = ((i[:, None] * n_doc + np.arange(n_doc)) << 32) | r[:, None]
    off = np.arange(len(o) + 1, dtype=np.int64) * n_doc
    return MeshFold(len(o), win, 0, rows_in, win, ops, off, src.ravel())


def packed_width(plan: DevicePlan) -> int:
    """Columns of K1-K3's packed output row: n_slots grouped, 1 + sum(w)
    ungrouped."""
    if is_grouped(plan):
        return len(plan.agg_ops)
    return 1 + sum(slot_width(op) for op, _v, _f in plan.agg_ops)


def mesh_shards(mesh: Mesh, col_sets: Sequence[Dict[str, ShardedBlock]],
                plist: Sequence[Tensors], ndlist: Sequence[torch.Tensor],
                D: int):
    """Per mesh slot, its members' inputs: (column sets, parameters, doc
    counts) of its [S_loc, D_loc] shard on its device, with (S_loc,
    D_loc). A slot's doc counts are clamp(num_docs - doc0, 0, D_loc), doc0
    its doc slice's first global doc: K1-K3 mask docs from 0 up to them,
    as the JAX kernel masks global doc positions (`_shard_one`)."""
    n_doc = mesh.shape[1]
    s_loc, d_loc = local_shape(mesh, ndlist[0].shape[0], D)
    pslices = [{k: shard_segments(mesh, v) for k, v in pr.items()}
               for pr in plist]
    nslices = [shard_segments(mesh, nd) for nd in ndlist]
    out = []
    for p in range(mesh.size):
        doc0 = (p % n_doc) * d_loc
        out.append(([{k: v.shards[p] for k, v in cs.items()}
                     for cs in col_sets],
                    [{k: s[p] for k, s in ps.items()} for ps in pslices],
                    [(ns[p] - doc0).clamp_(0, d_loc) for ns in nslices]))
    return out, s_loc, d_loc


def sharded_kernel(plan: DevicePlan, mesh: Mesh,
                   value_dtype: torch.dtype = torch.float32):
    """fn(cols, params, num_docs, D, G=0) -> the packed [S, ...] result of
    `plan` over a mesh (JAX `make_sharded_kernel`, kernels.py:710), in the
    single-device kernel's layout. cols: 'name' -> ShardedBlock of the
    global [S, D] block; params and num_docs: the global [S, ...] arrays
    on the lead device. Each slot runs `make_kernel` on its shard (K1, K3
    or K2 on a card, the plain version on the CPU), its partial moves to
    the lead device, and one K9 folds the doc slices (`DOC_COMBINE`). G:
    a compact-key plan's group count, as `make_kernel` takes it; the
    'gkey' block shards with the other columns."""
    return _sharded(plan, mesh, make_kernel(plan, value_dtype), mesh_fold)


def plain_sharded_kernel(plan: DevicePlan, mesh: Mesh,
                         value_dtype: torch.dtype = torch.float32):
    """The plain version of `sharded_kernel`, on whatever device its
    inputs lie: `plain_kernel` per slot, `mesh_fold_plain` for the fold."""
    return _sharded(plan, mesh, plain_kernel(plan, value_dtype),
                    lambda parts, fold, batched=False:
                    mesh_fold_plain(parts, fold))


def _sharded(plan, mesh, single, fold_fn):
    codes = packed_fold_codes(plan)

    def kernel(cols: Dict[str, ShardedBlock], params: Tensors,
               num_docs: torch.Tensor, D: int, G: int = 0) -> torch.Tensor:
        G = group_count(plan, G)
        shards, s_loc, d_loc = mesh_shards(mesh, [cols], [params],
                                           [num_docs], D)
        parts = [single(cs[0], ps[0], ns[0], d_loc, G).to(
            mesh.lead, non_blocking=True)[None] for cs, ps, ns in shards]
        return _doc_folded(plan, mesh, parts, s_loc, codes, False,
                           fold_fn, G)[0]

    return kernel


def _doc_folded(plan, mesh, parts, s_loc, codes, batched, fold_fn, G):
    """[B, S, ...] from the slots' [B, S_loc, ...] partials (G groups, 0
    ungrouped): one K9 over the doc slices."""
    win = packed_width(plan)
    fold = doc_fold(mesh.shape[0], mesh.shape[1], s_loc, G or 1, win, codes)
    out = fold_fn(parts, fold, batched=batched)
    B, S = out.shape[0], mesh.shape[0] * s_loc
    return out.view(B, S, G, win) if G else out.view(B, S, win)


def batched_sharded_kernel(plan: DevicePlan, mesh: Mesh,
                           value_dtype: torch.dtype = torch.float32):
    """fn(col_sets, plist, ndlist, idx, D, G=0) -> [B, S, ...]: B coalesced
    queries of one plan over a mesh (JAX `make_batched_sharded_kernel`,
    kernels.py:893). Each slot launches its kernels once for all members
    (`batched_kernel`'s member axis over the members' column sets: one,
    broadcast; one per member, stacked; or a member-to-set map), then one
    K9 folds the doc slices of every member. The kernels take B at run
    time, as `batched_kernel`'s do."""
    return _batched_sharded(plan, mesh, batched_kernel(plan, value_dtype),
                            mesh_fold)


def plain_batched_sharded_kernel(plan: DevicePlan, mesh: Mesh,
                                 value_dtype: torch.dtype = torch.float32):
    """The plain version of `batched_sharded_kernel`, on whatever device
    its inputs lie."""
    return _batched_sharded(plan, mesh,
                            plain_batched_kernel(plan, value_dtype),
                            lambda parts, fold, batched=False:
                            mesh_fold_plain(parts, fold))


def _batched_sharded(plan, mesh, members, fold_fn):
    codes = packed_fold_codes(plan)

    def run(col_sets, plist, ndlist, idx, D, G=0):
        G = group_count(plan, G)
        shards, s_loc, d_loc = mesh_shards(mesh, col_sets, plist, ndlist, D)
        parts = [members(cs, ps, ns, idx, d_loc, G).to(mesh.lead,
                                                       non_blocking=True)
                 for cs, ps, ns in shards]
        return _doc_folded(plan, mesh, parts, s_loc, codes, True, fold_fn,
                           G)

    return run


# ---------------------------------------------------------------------------
# row assembly (kernels.py:100 `compiled_row_assembler`)
# ---------------------------------------------------------------------------

def row_assemble(rows: Sequence[torch.Tensor], S: int,
                 D: int) -> torch.Tensor:
    """The plain version of K6: an [S, D] block of zeros, row s overwritten
    by rows[s] (each 1-D, at most D long); rows past len(rows) stay zero.
    CPU tensors only."""
    if not rows or len(rows) > S:
        raise ValueError(f"{len(rows)} rows for a block of {S}")
    if any(r.device.type != "cpu" for r in rows):
        raise ValueError("the plain row assembler takes CPU tensors")
    out = torch.zeros((S, D), dtype=rows[0].dtype)
    for s, r in enumerate(rows):
        out[s, :r.shape[0]] = r
    return out


def assemble_rows(rows: Sequence[torch.Tensor], S: int,
                  D: int) -> torch.Tensor:
    """The staged [S, D] block of per-segment device rows: CUDA rows
    launch K6 (`row_assemble`), CPU rows run the plain version."""
    device = rows[0].device
    if device.type == "cuda":
        return _cuda.row_assemble(list(rows), S, D)
    if device.type != "cpu":
        raise ValueError(f"no kernel for device {device}")
    return row_assemble(rows, S, D)


def abs_contributions(plan: DevicePlan, cols: Tensors, params: Tensors,
                      num_docs: torch.Tensor, D: int,
                      G: int = 0) -> Dict[int, torch.Tensor]:
    """For each sum-family slot j of `plan`, the float64 sum of
    |contribution| per segment ([S]) or per group ([S, G]; G as
    `make_kernel` takes it): the yardstick that float-sum tolerances are
    stated against (kernel against plain version, port against the JAX
    package)."""
    G = group_count(plan, G)
    f64 = {k: (v.double() if k.startswith("val:") else v)
           for k, v in cols.items()}
    valid = doc_validity(plan, cols, num_docs, D)
    mask = valid if plan.filter_ir is None else \
        valid & eval_filter(plan.filter_ir, plan, f64, params)
    keys = None
    if G:
        keys, gate = group_keys(plan, cols, params, valid.shape)
        keys = keys.long()
        if gate is not None:
            mask = mask & gate
    out = {}
    for j, (op, vidx, fidx) in enumerate(plan.agg_ops):
        if op not in ("sum", "sumsq", "sum3", "sum4"):
            continue
        m = mask if fidx is None else mask & eval_filter(
            plan.agg_filter_irs[fidx], plan, f64, params)
        v = eval_value(plan.value_irs[vidx], f64, torch.float64,
                       valid.device).expand(m.shape)
        c = torch.where(m, _powered(op, v.abs()), 0).nan_to_num(0.0)
        if keys is None:
            out[j] = c.sum(1)
        else:
            g = torch.zeros((m.shape[0], G), dtype=torch.float64,
                            device=m.device)
            ok = m & (keys >= 0) & (keys < G)
            out[j] = g.scatter_add_(1, torch.where(ok, keys, 0),
                                    torch.where(ok, c, 0.0))
    return out


def from_jax_staged(cols: Dict[str, np.ndarray], params: Dict[str, np.ndarray],
                    num_docs: np.ndarray, device="cpu"):
    """The JAX engine's staged `cols` / `params` / `num_docs` (as numpy
    arrays, read-only ones included) as the port's tensors, keys and dtypes
    unchanged: id blocks, value blocks, `valhi:`/`vallo:` split planes,
    leaf parameters and `slot{j}:hlo/hscale` histogram bounds alike, the
    star-tree leg's `stid:`/`sthi:`/`stlo:`/`stval:` blocks and `sel`
    mask, and a CLP leaf's `clpid:` / `clpdv<j>:` / `clpehi<j>:` /
    `clpelo<j>:` pseudo-columns and `leaf<i>:alut/dvlut/glt/gmem/ck/cs/
    chi/clo/cl/dlut` parameters (bool LUTs stay bool, `ck` int8)."""
    def t(a):
        return torch.from_numpy(np.require(a, requirements=["C", "W"])
                                ).to(device)
    return ({k: t(v) for k, v in cols.items()},
            {k: t(v) for k, v in params.items()}, t(num_docs))
