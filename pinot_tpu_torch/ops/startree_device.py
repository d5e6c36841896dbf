"""Star-tree pre-aggregation on the card: the fit check and traversal on the
host, the residual aggregation over the selected pre-agg records in K5
`startree_agg`, one query per launch or B coalesced ones (`batched_kernel`,
K5's member axis), on one device or per slot of a segments-only mesh
(`sharded_kernel`, `batched_sharded_kernel`).

Counterpart of pinot_tpu/ops/startree_device.py (ref
StarTreeFilterOperator + StarTreeAggregationExecutor /
StarTreeGroupByExecutor). The host keeps the fit check and the recursive
tree traversal (pointer chasing over the int32 node array); the card does
the residual aggregation over the matched pre-agg records. Traversal yields
record indices into the pre-agg table (the DFS layout makes every node a
contiguous [start, end) slice); those become a bool selection mask `sel`,
the only per-query input, while the pre-agg metric / dim-code columns are
staged once as `__startree__<ti>/<col>` pseudo-columns through the engine's
staged-block cache and reused across queries.

Exactness: integral sum / count pairs ride exact unsigned int planes (two
24-bit digits, each through 4 planes of 7 bits summed in int32; 127 * 2^24
< 2^31), so int sums and counts are exact for any value below 2^48. Float
pairs and min / max use the engine's value dtype. Plan admission
(`plan_startree`) proves the bounds from the trees' metric columns and
falls back by reason otherwise.

The traversal runs lazily (`STFit.recs`): the engine builds the selection
mask from it only when its params cache has no mask for the (segment batch,
plan, filter), so a repeat query runs the fit check but not the traversal.
"""
from __future__ import annotations

from typing import (Dict, FrozenSet, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from pinot_tpu_torch.ops import _cuda, kernels
from pinot_tpu_torch.query.expressions import Identifier
from pinot_tpu_torch.query.results import (AggregationResult, ExecutionStats,
                                           GroupByResult)
from pinot_tpu_torch.query.startree_exec import (_agg_pairs_needed,
                                                 _filter_id_sets)
from pinot_tpu_torch.segment.startree import DimFilter, parse_pair

#: unsigned planes per 24-bit digit of an exact-sum slot: 4 * 7 bits
#: covers the digit, per-plane i32 sums stay exact (127 * 2^24 < 2^31)
USUM_PLANES = _cuda.USUM_PLANES
#: slot width: (hi, lo) digits x USUM_PLANES planes x (hi, lo) halves
USUM_WIDTH = 2 * 2 * USUM_PLANES
#: largest integral value an exact slot can carry (two 24-bit digits)
USUM_MAX = float(1 << 48)
#: f32 represents integers exactly up to 2^24: the min/max admission bound
_F32_EXACT_INT = float(1 << 24)
#: mixed-radix group-key space cap (the engine's MAX_DEVICE_GROUPS)
_MAX_GROUPS = 1 << 20

Tensors = Dict[str, torch.Tensor]


class StarTreePlan(NamedTuple):
    """Device plan of one star-tree aggregation shape: slot forms and group
    radix only, never filter literals or segment identity."""
    slots: Tuple[Tuple[str, str], ...]        # (op, "func__col") per pair
    group_dims: Tuple[str, ...] = ()
    group_cards: Tuple[int, ...] = ()
    group_strides: Tuple[int, ...] = ()
    num_groups: int = 0


class STFit(NamedTuple):
    """One segment's fitted tree and what its traversal reads."""
    ti: int                                   # tree index in the reader
    tree: object                              # segment.startree.StarTreeV2
    id_sets: Dict[str, Optional[DimFilter]]   # dim -> filter (None: any)
    group_dims: FrozenSet[str]

    @property
    def recs(self) -> np.ndarray:
        """The selected pre-agg record indices (the tree traversal)."""
        return self.tree.traverse(self.id_sets, set(self.group_dims))


def slot_width(op: str) -> int:
    return USUM_WIDTH if op == "usum" else 1


# ---------------------------------------------------------------------------
# the plain version of K5 (startree_device.py:99 `make_startree_kernel`,
# :81 `_grouped_usum`)
# ---------------------------------------------------------------------------

def _grouped_usum(vi: torch.Tensor, safe_keys: torch.Tensor,
                  m: torch.Tensor, G: int,
                  value_dtype: torch.dtype) -> List[torch.Tensor]:
    """Exact per-group sum of one 24-bit digit column: per-plane int32
    scatter-adds, each plane as (s >> 12, s & 4095) halves."""
    vi = torch.where(m, vi, 0)
    parts = []
    for k in range(USUM_PLANES):
        p = (vi >> kernels.ISUM_U_BITS * k) & 127
        s = torch.zeros((vi.shape[0], G), dtype=torch.int32,
                        device=vi.device).scatter_add_(1, safe_keys, p)
        parts += [(s >> 12).to(value_dtype), (s & 4095).to(value_dtype)]
    return parts


def startree_kernel(plan: StarTreePlan, cols: Tensors, params: Tensors,
                    num_docs: torch.Tensor, D: int, G: int = 0,
                    value_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version: [S, D] pre-agg residual aggregation.

    cols:     "stid:<dim>" int32 group codes, "stval:<pair>" metrics in the
              value dtype, "sthi:/stlo:<pair>" int32 exact-sum digit rows
    params:   "sel" bool [S, D], the traversal's selection mask
    num_docs: int32 [S], each segment's pre-agg record count
    G:        accepted for the JAX signature; the group count is
              plan.num_groups

    Flat output [S, 1 + sum(w)] with the selected-record count first;
    grouped [S, G, 1 + sum(w)] with the per-group record count at index 0.
    """
    if G and G != plan.num_groups:
        raise ValueError(f"group count {G} != plan's {plan.num_groups}")
    valid = torch.arange(D, dtype=torch.int32,
                         device=num_docs.device)[None, :] < num_docs[:, None]
    sel = params["sel"]
    m = sel & valid
    if plan.group_dims:
        G = plan.num_groups
        keys = torch.zeros(valid.shape, dtype=torch.int32,
                           device=valid.device)
        for dim, stride in zip(plan.group_dims, plan.group_strides):
            keys = keys + cols["stid:" + dim] * stride
        safe_keys = torch.where(m, keys, 0).long()
        outs = [kernels.grouped_reduce("count", None, keys, sel, valid, G,
                                       value_dtype)]
        for op, name in plan.slots:
            if op == "usum":
                outs += _grouped_usum(cols["sthi:" + name], safe_keys, m, G,
                                      value_dtype)
                outs += _grouped_usum(cols["stlo:" + name], safe_keys, m, G,
                                      value_dtype)
            else:
                outs.append(kernels.grouped_reduce(
                    op, cols["stval:" + name], keys, sel, valid, G,
                    value_dtype))
        return torch.stack(outs, -1)
    parts = [m.sum(1).to(value_dtype)[:, None]]
    for op, name in plan.slots:
        if op == "usum":
            parts.append(kernels.isum_u_slot(
                f"isum:u{USUM_PLANES}", cols["sthi:" + name], m, value_dtype))
            parts.append(kernels.isum_u_slot(
                f"isum:u{USUM_PLANES}", cols["stlo:" + name], m, value_dtype))
        else:
            parts.append(kernels.masked_reduce(
                op, cols["stval:" + name], sel, valid, value_dtype)[:, None])
    return torch.cat(parts, 1)


def make_startree_kernel(plan: StarTreePlan,
                         value_dtype: torch.dtype = torch.float32):
    """fn(cols, params, num_docs, D, G=0) -> packed tensor: CUDA inputs
    launch K5 (`startree_agg`), CPU inputs run the plain version."""
    if value_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"value dtype {value_dtype} is not float32/64")

    def kernel(cols: Tensors, params: Tensors, num_docs: torch.Tensor,
               D: int, G: int = 0) -> torch.Tensor:
        if num_docs.device.type == "cuda":
            if G and G != plan.num_groups:
                raise ValueError(
                    f"group count {G} != plan's {plan.num_groups}")
            return _cuda.startree_agg(plan, cols, params, num_docs, D,
                                      value_dtype)
        if num_docs.device.type != "cpu":
            raise ValueError(f"no kernel for device {num_docs.device}")
        return startree_kernel(plan, cols, params, num_docs, D, G,
                               value_dtype)

    return kernel


def plain_batched_kernel(plan: StarTreePlan,
                         value_dtype: torch.dtype = torch.float32):
    """The plain batched version: fn(col_sets, plist, ndlist, idx, D) ->
    [B, ...], each member's plain launch over column set idx[m], stacked;
    on whatever device its inputs lie."""
    def kernel(col_sets: Sequence[Tensors], plist: Sequence[Tensors],
               ndlist: Sequence[torch.Tensor], idx: Sequence[int],
               D: int) -> torch.Tensor:
        return torch.stack([startree_kernel(plan, col_sets[u], params,
                                            ndlist[u], D,
                                            value_dtype=value_dtype)
                            for params, u in zip(plist, idx)])

    return kernel


def batched_kernel(plan: StarTreePlan,
                   value_dtype: torch.dtype = torch.float32):
    """fn(col_sets, plist, ndlist, idx, D) -> [B, ...]: B = len(plist)
    coalesced star-tree queries of one plan over U = len(col_sets) column
    sets (ndlist: record counts per set), member m over set idx[m] with its
    own selection mask plist[m]["sel"]. One function serves the JAX
    package's broadcast and stacked forms
    (startree_device.py:152 `make_batched_startree_kernel`: broadcast is
    U = 1, stacked idx = 0..B-1) and the dedup map the ring builds. CUDA
    inputs launch K5 once for all members, CPU inputs run the plain
    version."""
    if value_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"value dtype {value_dtype} is not float32/64")
    plain = plain_batched_kernel(plan, value_dtype)

    def run(col_sets, plist, ndlist, idx, D):
        if len(ndlist) != len(col_sets) or len(idx) != len(plist) \
                or not all(0 <= u < len(col_sets) for u in idx):
            raise ValueError(
                f"{len(plist)} members with {len(idx)} set indexes over "
                f"{len(col_sets)} column sets and {len(ndlist)} num_docs")
        device = ndlist[0].device
        if device.type == "cpu":
            return plain(col_sets, plist, ndlist, idx, D)
        if device.type != "cuda":
            raise ValueError(f"no kernel for device {device}")
        return _cuda.startree_agg_batched(plan, list(col_sets), list(plist),
                                          list(ndlist), list(idx), D,
                                          value_dtype)

    return run


def sharded_kernel(plan: StarTreePlan, mesh,
                   value_dtype: torch.dtype = torch.float32):
    """fn(cols, params, num_docs, D, G=0) -> [S, ...]: K5 per slot of a
    segments-only mesh over its segments' pre-agg record blocks and
    selection mask, each segment's row on the lead device in segment
    order (the JAX engine's GSPMD partition of `make_startree_kernel`
    over its implicit mesh)."""
    return kernels.segments_sharded(
        mesh, make_startree_kernel(plan, value_dtype))


def plain_sharded_kernel(plan: StarTreePlan, mesh,
                         value_dtype: torch.dtype = torch.float32):
    """The plain version of `sharded_kernel`."""
    return kernels.segments_sharded(
        mesh, lambda cols, params, num_docs, D, G=0: startree_kernel(
            plan, cols, params, num_docs, D, G, value_dtype))


def batched_sharded_kernel(plan: StarTreePlan, mesh,
                           value_dtype: torch.dtype = torch.float32):
    """fn(col_sets, plist, ndlist, idx, D) -> [B, S, ...]: B coalesced
    star-tree queries, K5's member axis once per slot (JAX row 8d over
    its implicit mesh)."""
    return kernels.segments_batched_sharded(
        mesh, batched_kernel(plan, value_dtype))


def plain_batched_sharded_kernel(plan: StarTreePlan, mesh,
                                 value_dtype: torch.dtype = torch.float32):
    """The plain version of `batched_sharded_kernel`."""
    return kernels.segments_batched_sharded(
        mesh, plain_batched_kernel(plan, value_dtype))


# ---------------------------------------------------------------------------
# host-side planning (fit check + slot admission)
# ---------------------------------------------------------------------------

def plan_startree(segments, ctx):
    """Fit + plan the star-tree leg for one segment batch.

    Returns (plan, needed, fits, None) when every segment has a fitting
    tree and every pair admits a device slot; (None, None, None, reason)
    otherwise, reason being the `startree_fallback` meter's label
    (disabled | aggregation | groupBy | noTree | fit | filter | precision |
    groups); the caller then falls through to the scan path."""
    if ctx.options.get("useStarTree", "true").lower() == "false":
        return None, None, None, "disabled"
    if ctx.distinct or not ctx.aggregations:
        return None, None, None, "aggregation"
    needed = _agg_pairs_needed(ctx)
    if needed is None:
        return None, None, None, "aggregation"
    group_cols: List[str] = []
    for g in ctx.group_by:
        if not isinstance(g, Identifier):
            return None, None, None, "groupBy"
        group_cols.append(g.name)
    pairs_needed = {p for pairs in needed for p in pairs}

    fits: List[STFit] = []
    filter_missed = False
    for seg in segments:
        reader = getattr(seg, "star_tree", None)
        if reader is None or not reader.trees:
            return None, None, None, "noTree"
        fit = None
        for ti, tree in enumerate(reader.trees):
            tree_pairs = {parse_pair(p) for p in tree.meta.pairs}
            if not pairs_needed <= tree_pairs:
                continue
            if not all(c in tree.meta.dims for c in group_cols):
                continue
            id_sets = _filter_id_sets(seg, ctx.filter, tree.meta.dims)
            if id_sets is None:
                filter_missed = True
                continue
            fit = STFit(ti, tree, id_sets, frozenset(group_cols))
            break
        if fit is None:
            return None, None, None, "filter" if filter_missed else "fit"
        fits.append(fit)

    # slot admission per pair: exact int planes when every fitted tree's
    # bounds prove the values fit, the value dtype for float pairs; int
    # pairs whose bounds overflow a slot fall back (the scan is exact there)
    slots: List[Tuple[str, str]] = []
    for func, col in sorted(pairs_needed):
        lo, hi, integral = 0.0, 0.0, True
        for f in fits:
            b = f.tree.pair_bounds((func, col))
            lo, hi = min(lo, b[0]), max(hi, b[1])
            integral = integral and b[2]
        name = f"{func}__{col}"
        if func in ("sum", "count"):
            if integral and 0.0 <= lo and hi < USUM_MAX:
                slots.append(("usum", name))
            elif integral:
                return None, None, None, "precision"
            else:
                slots.append(("sum", name))
        else:  # min / max: f32 is exact for ints within +-2^24, and
            # within float tolerance for genuinely-float metrics
            if integral and not (-_F32_EXACT_INT <= lo
                                 and hi <= _F32_EXACT_INT):
                return None, None, None, "precision"
            slots.append((func, name))

    cards: List[int] = []
    strides: List[int] = []
    num_groups = 0
    if group_cols:
        cards = [max(int(seg.data_source(c).metadata.cardinality)
                     for seg in segments) for c in group_cols]
        num_groups = 1
        for c in cards:
            num_groups *= c
        if num_groups > _MAX_GROUPS:
            return None, None, None, "groups"
        strides = [int(np.prod(cards[i + 1:], dtype=np.int64))
                   for i in range(len(cards))]

    plan = StarTreePlan(slots=tuple(slots), group_dims=tuple(group_cols),
                        group_cards=tuple(cards),
                        group_strides=tuple(strides), num_groups=num_groups)
    return plan, needed, fits, None


def staged_columns(plan: StarTreePlan, value_dtype):
    """[(kernel col key, fetch form, np dtype)] the engine stages as
    pseudo-column blocks; `fetch_row` materializes one segment's row."""
    out = []
    for op, name in plan.slots:
        if op == "usum":
            out.append(("sthi:" + name, ("hi", name), np.int32))
            out.append(("stlo:" + name, ("lo", name), np.int32))
        else:
            out.append(("stval:" + name, ("val", name), value_dtype))
    for d in plan.group_dims:
        out.append(("stid:" + d, ("id", d), np.int32))
    return out


def fetch_row(tree, form, value_dtype) -> np.ndarray:
    """One tree's raw pre-agg row for a staged-column form; exact-sum
    values are cast to int64 before the 24-bit digit split."""
    kind, name = form
    if kind == "id":
        return np.ascontiguousarray(tree.dim_codes[name], dtype=np.int32)
    v = tree.metrics[tuple(name.split("__", 1))]
    if kind == "val":
        return v.astype(value_dtype)
    vi = v.astype(np.int64)
    if kind == "hi":
        return (vi >> 24).astype(np.int32)
    return (vi & 0xFFFFFF).astype(np.int32)


def selection_mask(fits: List[STFit], S: int, D: int) -> np.ndarray:
    """[S, D] bool params block from per-segment traversal results."""
    sel = np.zeros((S, D), dtype=bool)
    for i, f in enumerate(fits):
        sel[i, f.recs] = True
    return sel


# ---------------------------------------------------------------------------
# host-side assembly (startree_device.py:317-415)
# ---------------------------------------------------------------------------

def _slot_layout(plan: StarTreePlan) -> Dict[str, Tuple[int, str]]:
    offs: Dict[str, Tuple[int, str]] = {}
    off = 1  # index 0 is the matched/record-count column
    for op, name in plan.slots:
        offs[name] = (off, op)
        off += slot_width(op)
    return offs


def _usum_value(planes) -> int:
    """The exact integer sum from a usum slot's 16 plane halves (hi digit
    planes then lo digit planes), in Python ints."""
    def digit(p):
        total = 0
        for k in range(USUM_PLANES):
            s = int(round(float(p[2 * k]))) * 4096 \
                + int(round(float(p[2 * k + 1])))
            total += s << (kernels.ISUM_U_BITS * k)
        return total
    half = 2 * USUM_PLANES
    return (digit(planes[:half]) << 24) + digit(planes[half:])


def assemble(segments, ctx, plan: StarTreePlan, needed, fits, packed):
    """Per-segment results from the packed kernel output, types as the
    host star-tree executor gives them: count int, sum/min/max float, AVG
    as (float, int)."""
    packed = np.asarray(packed)
    layout = _slot_layout(plan)
    results = []
    for s, seg in enumerate(segments):
        row = np.asarray(packed[s], dtype=np.float64)
        if plan.group_dims:
            results.append(_assemble_group(seg, ctx, plan, needed, layout,
                                           row))
        else:
            results.append(_assemble_flat(seg, ctx, needed, layout, row))
    return results


def _agg_value(fn_name: str, pairs, get):
    """One aggregation's intermediate from slot values."""
    if fn_name == "count":
        return int(get(("count", "*")))
    if fn_name == "avg":
        return (float(get(pairs[0])), int(get(("count", "*"))))
    return float(get(pairs[0]))  # sum / min / max


def _slot_get(layout, row, pair):
    off, op = layout[f"{pair[0]}__{pair[1]}"]
    if op == "usum":
        return _usum_value(row[off:off + USUM_WIDTH])
    return float(row[off])


def _stats(seg, matched: int) -> ExecutionStats:
    """num_docs_scanned counts the selected pre-agg records."""
    return ExecutionStats(
        num_docs_scanned=matched, num_segments_processed=1,
        num_segments_matched=1 if matched else 0, total_docs=seg.num_docs)


def _assemble_flat(seg, ctx, needed, layout, row):
    inters = [_agg_value(fn.name, needed[i],
                         lambda pair: _slot_get(layout, row, pair))
              for i, fn in enumerate(ctx.aggregations)]
    return AggregationResult(inters, _stats(seg, int(round(float(row[0])))))


def _assemble_group(seg, ctx, plan, needed, layout, arr):
    cnt = arr[:, 0]
    present = np.nonzero(cnt > 0.5)[0]
    dicts = [seg.data_source(c).dictionary for c in plan.group_dims]
    cards = [int(seg.data_source(c).metadata.cardinality)
             for c in plan.group_dims]
    groups: Dict[tuple, list] = {}
    for g in present:
        rem = int(g)
        ids = []
        for stride in plan.group_strides:
            ids.append(rem // stride)
            rem = rem % stride
        if any(i >= c for i, c in zip(ids, cards)):
            continue  # radix-padding key outside this segment's dict
        key = tuple(_py(d.get_value(ids[j])) for j, d in enumerate(dicts))
        row = arr[g]
        groups[key] = [_agg_value(fn.name, needed[i],
                                  lambda pair: _slot_get(layout, row, pair))
                       for i, fn in enumerate(ctx.aggregations)]
    return GroupByResult(groups, _stats(seg, int(round(float(cnt.sum())))))


def _py(v):
    return v.item() if isinstance(v, np.generic) else v
