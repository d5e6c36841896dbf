"""Collective merge: the fold of a segment batch's partials into one row,
on the mesh's lead device.

Counterpart of pinot_tpu/ops/collective.py (`_merged_plan` :56,
`_global_keys` :68, `_member_fn` :84, `_collect_pack` :131,
`_find_count_slot` :158, `_matched_tail` :167, `make_merged_kernel` :187,
`make_batched_merged_kernel` :234). Where the JAX engine ships [S, ...]
per-segment partials to the host IndexedTable fold, a mesh engine folds
them where they are: each slot reduces its [S_loc, D_loc] shard with
K1-K3 (the single-device kernels, unchanged), and one K9 `mesh_fold`
folds every slot's partials, segment by segment, into one row.

Layout contract (engine `_assemble_merged` is its only reader), the JAX
module's:

  no group-by: [sum(slot widths) + S]: the merged slots at the offsets
               `_assemble` uses (no leading matched column), then the
               per-segment matched counts as an [S] tail (the exact
               ExecutionStats the host fold would have summed).
  group-by:    [G * n_slots + S]: the merged [G, n_slots] group block
               flattened row-major, then the same [S] tail, taken from
               the unfiltered count slot (`find_count_slot`).
  batched:     [B, L], the batch axis leading, the same L per member.

Group keys are global: dictIds and compact codes are segment-local, so
the host factorizes a global key space once (engine
`_merged_group_params`): dense keys over the union of the segments'
dictionary values, compact keys over the sorted union of the key tuples
the segments hold. The JAX kernel remaps every doc's key before its
group-by, through per-column tables (`gmap<i>`, `gstride`) or, compact,
one [S, G_local] code -> global index table (`gmap`, `_global_keys`
:68-73); here K2 groups by the local key (dense, or the compact code) as
on one device, and K9 remaps its [S_loc, G_local, n_slots] partials:
`merged_plan` turns the [S, G_local] map (local key -> global index, -1
for none: a dense key past a segment's cardinalities, a compact code past
its table, a padded segment) into inverse lists, and each global group
folds its (slot, segment, local key) partials in that order. Sum, min and
max are associative and the remap is a function of the local key, so the
algebra is the JAX kernel's; a local key no doc holds keeps identities,
so it adds nothing. The cost is S * G_local reads of partials in place of
a gather per doc and group column.

Each slot's combine rides `kernels.DOC_COMBINE`, as across doc shards:
sums, counts, moments, exact-sum planes and histogram buckets add; min
takes the minimum; max and HLL registers the maximum.
"""
from __future__ import annotations

from typing import Dict, Optional

import functools

import numpy as np
import torch

from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.plan_ir import DevicePlan
from pinot_tpu_torch.parallel.mesh import Mesh

Tensors = Dict[str, torch.Tensor]


def find_count_slot(plan: DevicePlan) -> Optional[int]:
    """The unfiltered count slot of a grouped plan (every matched doc
    lands in exactly one key, so it sums to a segment's matched count);
    None ungrouped."""
    if not plan.group_cols:
        return None
    for j, (op, _v, fidx) in enumerate(plan.agg_ops):
        if op == "count" and fidx is None:
            return j
    raise ValueError("grouped plan without an unfiltered count slot")


def compose_remap(plan: DevicePlan, gparams: Dict[str, np.ndarray],
                  S: int) -> np.ndarray:
    """The [S, G_local] int64 map, local key -> global index, from the JAX
    engine's remap parameters. Compact keys: `gmap` [S, G_local] (local
    code -> global index), where the JAX engine leaves 0 at the codes
    past a segment's table; a segment's codes number its tuples in sorted
    order, as the global indexes number the union's, so its real codes
    map strictly increasing, and a 0 past code 0 marks a code no doc
    holds: -1 here, so K9 reads no list entry for it. Dense keys: per
    group column i `gmap<i>` [S, C] (local dictId -> index into the
    union of the column's values) and `gstride` [S, k] (the global
    mixed-radix strides), the local key's digits from the plan's
    strides."""
    if plan.group_compact:
        gmap = np.asarray(gparams["gmap"], dtype=np.int64)
        if gmap.ndim != 2 or gmap.shape[0] != S:
            raise ValueError(f"compact gmap of shape {gmap.shape} for {S} "
                             "segments")
        pad = (gmap == 0) & (np.arange(gmap.shape[1]) > 0)
        return np.where(pad, -1, gmap)
    G_local = plan.num_groups
    key = np.arange(G_local, dtype=np.int64)
    out = np.zeros((S, G_local), dtype=np.int64)
    stride = np.asarray(gparams["gstride"], dtype=np.int64)
    rem = key
    for ci, st in enumerate(plan.group_strides):
        ids = rem // st
        rem = rem % st
        gm = np.asarray(gparams[f"gmap{ci}"], dtype=np.int64)
        out += gm[:, np.minimum(ids, gm.shape[1] - 1)] * stride[:, ci:ci + 1]
    return out


def merged_plan(plan: DevicePlan, mesh: Mesh, S: int, G: int = 0,
                remap: Optional[np.ndarray] = None,
                tail: bool = True) -> kernels.MeshFold:
    """The K9 fold of a merged launch (in place of the JAX module's plan
    variant `_merged_plan`: here the slots' plan is the plan itself).
    Ungrouped: one output row, sum(w) columns read from column 1 of every
    slot's [S_loc, 1 + sum(w)] partial, slot by slot, segment by segment.
    Grouped: G output rows of n_slots columns, row g folding the (slot,
    segment, local key) partials whose remap[segment, key] is g, in that
    order; remap -1 folds nowhere. G_local is the remap's width: the
    plan's num_groups for dense keys, the launch's G for compact ones. The
    [S] tail adds each segment's matched count over its doc slices (and
    its local keys); tail=False leaves it out."""
    n_seg, n_doc = mesh.shape
    s_loc = S // n_seg
    P = mesh.size
    slot = np.arange(P, dtype=np.int64)
    seg_slice = slot // n_doc
    if not plan.group_cols:
        W = sum(kernels.slot_width(op) for op, _v, _f in plan.agg_ops)
        src = ((slot[:, None] << 32) | np.arange(s_loc)).ravel()
        t = np.arange(S, dtype=np.int64)
        tsrc = (((t // s_loc)[:, None] * n_doc + np.arange(n_doc)) << 32) \
            | (t % s_loc)[:, None]
        return kernels.MeshFold(
            1, W, 1, s_loc, 1 + W, kernels.slot_fold_codes(plan),
            np.array([0, P * s_loc]), src, 0,
            *((np.arange(S + 1, dtype=np.int64) * n_doc, tsrc.ravel())
              if tail else ()))
    n = len(plan.agg_ops)
    remap = np.asarray(remap, dtype=np.int64)
    G_local = remap.shape[-1] if plan.group_compact else plan.num_groups
    if remap.shape != (S, G_local) or not G_local:
        raise ValueError(f"remap of shape {remap.shape}, expected "
                         f"{(S, G_local)}")
    if remap.size and remap.max() >= G:
        raise ValueError(f"remap reaches group {remap.max()} of {G}")
    rows = np.arange(s_loc * G_local, dtype=np.int64)
    g = np.concatenate([remap[i * s_loc:(i + 1) * s_loc].ravel()
                        for i in seg_slice])
    src = np.concatenate([(p << 32) | rows for p in slot])
    keep = g >= 0
    g, src = g[keep], src[keep]
    order = np.argsort(g, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(g, minlength=G))])
    t = np.arange(S, dtype=np.int64)
    r = (t % s_loc)[:, None, None] * G_local + np.arange(G_local)
    tslot = (t // s_loc)[:, None, None] * n_doc \
        + np.arange(n_doc)[None, :, None]
    tsrc = ((tslot << 32) | r).reshape(S, -1)
    if not tail:
        return kernels.MeshFold(G, n, 0, s_loc * G_local, n,
                                kernels.packed_fold_codes(plan), off,
                                src[order])
    return kernels.MeshFold(
        G, n, 0, s_loc * G_local, n, kernels.packed_fold_codes(plan), off,
        src[order], find_count_slot(plan),
        np.arange(S + 1, dtype=np.int64) * tsrc.shape[1], tsrc.ravel())


def _fold_of(plan: DevicePlan, mesh: Mesh, S: int, G: int, fold, plist):
    """The launch's fold: `fold` as given; else, ungrouped, the batch
    geometry's; grouped, the one the members' `gmap` (compact) or
    `gmap<i>` / `gstride` (dense) parameters compose, which they must
    share."""
    if fold is not None:
        return fold
    if not plan.group_cols:
        return ungrouped_plan(plan, mesh, S)
    names = ["gmap"] if plan.group_compact else \
        [f"gmap{ci}" for ci in range(len(plan.group_cols))] + ["gstride"]
    maps = [compose_remap(plan, {k: p[k].cpu().numpy() for k in names}, S)
            for p in plist]
    if any(not np.array_equal(m, maps[0]) for m in maps[1:]):
        raise ValueError("the members of a grouped merged launch share "
                         "one remap")
    return merged_plan(plan, mesh, S, G, maps[0])


@functools.lru_cache(maxsize=256)
def ungrouped_plan(plan: DevicePlan, mesh: Mesh, S: int) -> kernels.MeshFold:
    """`merged_plan` of an ungrouped plan, which depends on the geometry
    alone: built, and its lists uploaded, once per (plan, mesh, S)."""
    return merged_plan(plan, mesh, S)


def merged_kernel(plan: DevicePlan, mesh: Mesh,
                  value_dtype: torch.dtype = torch.float32):
    """fn(cols, params, num_docs, D, G=0, fold=None) -> the merged [L] row
    of `plan` over the segment batch (JAX `make_merged_kernel`). cols,
    params and num_docs as `kernels.sharded_kernel` takes them; G: the
    global group pad (0 ungrouped); fold: the launch's `merged_plan`,
    else built here (grouped: from the `gmap<i>` / `gstride` params)."""
    return _merged(plan, mesh, kernels.make_kernel(plan, value_dtype),
                   kernels.mesh_fold)


def plain_merged_kernel(plan: DevicePlan, mesh: Mesh,
                        value_dtype: torch.dtype = torch.float32):
    """The plain version of `merged_kernel`, on whatever device its inputs
    lie: `plain_kernel` per slot, `mesh_fold_plain` for the fold."""
    return _merged(plan, mesh, kernels.plain_kernel(plan, value_dtype),
                   lambda parts, fold: kernels.mesh_fold_plain(parts, fold))


def _local_groups(plan: DevicePlan, fold: kernels.MeshFold,
                  s_loc: int) -> int:
    """The slots' group count: the fold reads [s_loc, G_local] partial
    rows per slot (0 ungrouped)."""
    return fold.rows_in // s_loc if plan.group_cols else 0


def _merged(plan, mesh, single, fold_fn):
    def kernel(cols, params: Tensors, num_docs: torch.Tensor, D: int,
               G: int = 0, fold: Optional[kernels.MeshFold] = None):
        S = num_docs.shape[0]
        f = _fold_of(plan, mesh, S, G, fold, [params])
        shards, s_loc, d_loc = kernels.mesh_shards(
            mesh, [cols], [params], [num_docs], D)
        g_local = _local_groups(plan, f, s_loc)
        parts = [single(cs[0], ps[0], ns[0], d_loc, g_local).to(
            mesh.lead, non_blocking=True)[None] for cs, ps, ns in shards]
        return fold_fn(parts, f)[0]

    return kernel


def batched_merged_kernel(plan: DevicePlan, mesh: Mesh,
                          value_dtype: torch.dtype = torch.float32,
                          G: int = 0,
                          fold: Optional[kernels.MeshFold] = None):
    """fn(col_sets, plist, ndlist, idx, D) -> [B, L]: B coalesced queries
    merged in one pass (JAX `make_batched_merged_kernel`): each slot
    launches its kernels once for all members, then one K9 folds every
    member's partials into its row."""
    members = kernels.batched_kernel(plan, value_dtype)

    def run(col_sets, plist, ndlist, idx, D):
        S = ndlist[0].shape[0]
        f = _fold_of(plan, mesh, S, G, fold, plist)
        shards, s_loc, d_loc = kernels.mesh_shards(mesh, col_sets, plist,
                                                   ndlist, D)
        g_local = _local_groups(plan, f, s_loc)
        parts = [members(cs, ps, ns, idx, d_loc, g_local).to(
            mesh.lead, non_blocking=True) for cs, ps, ns in shards]
        return kernels.mesh_fold(parts, f, batched=True)

    return run

