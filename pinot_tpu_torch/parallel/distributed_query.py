"""The fixed-shape sharded query step, on the mesh's kernels.

Counterpart of pinot_tpu/parallel/distributed_query.py:30
`distributed_query_step`: a range filter on one id column, SUM and COUNT
of a measure, and the measure's per-group SUM by a group-id column, over
[S, D] blocks sharded on (segments, docs). The JAX step computes each
shard's masked partials, then psums over `docs` (per-segment results)
and over `segments` (the totals), all results replicated. Here each mesh
slot runs K1 (`scan_agg`: sum and count) and K2 (`group_agg`: the sum by
group id) on its shard, through the same per-slot path as the engine's
merged launches (ops/collective.py), and K9 (`mesh_fold`) folds each
kind of partial over every slot and segment in one pass: twice a step.
The results are tensors on the mesh's lead device.

A group id at or past num_groups is dropped from group_sums and still
counts in the totals, as JAX's `.at[k].add` drops it; a negative one,
which JAX's indexing wraps to gid + num_groups, is dropped alike (K2
keeps keys in [0, G): group ids are dictIds, never negative).
"""
from __future__ import annotations

from typing import Tuple

import functools

import numpy as np
import torch

from pinot_tpu_torch.ops import collective, kernels
from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
from pinot_tpu_torch.parallel.mesh import Mesh, ShardedBlock, shard_block

_FILTER = dict(filter_ir=("leaf", 0), leaves=(DeviceLeaf("range", "ids"),),
               value_irs=(("col", "vals"),))
#: the totals: K1's (matched, sum, count) per segment
TOTALS_PLAN = DevicePlan(agg_ops=(("sum", 0, None), ("count", None, None)),
                         **_FILTER)


def groups_plan(num_groups: int) -> DevicePlan:
    """K2's plan: the measure's sum per group id."""
    return DevicePlan(agg_ops=(("sum", 0, None),), group_cols=("gids",),
                      group_strides=(1,), num_groups=num_groups, **_FILTER)


def distributed_query_step(mesh: Mesh):
    """make(num_groups, D_shard=0) -> step(ids, vals, gids, lo, hi, ndocs,
    doc_pos) -> (total_sum [], total_count [], group_sums [num_groups]),
    the signature of the JAX function (D_shard is kept for it and unused).

      ids, gids  [S, D] int32 dictIds; vals [S, D] float32 or float64
                 (the value dtype): global tensors, sharded here, or
                 ShardedBlocks of `mesh` (parallel.mesh.shard_block)
      lo, hi     [S] int32 per-segment dictId bounds
      ndocs      [S] int32 real docs per segment
      doc_pos    [1, D] global doc positions: arange(D), the layout the
                 JAX step's callers build (checked once per tensor)
    """
    return _make_step(mesh, kernels.make_kernel, kernels.mesh_fold)


def plain_distributed_query_step(mesh: Mesh):
    """The plain version of `distributed_query_step`, on whatever device
    its inputs lie: `plain_kernel` per slot, `mesh_fold_plain` for the
    folds."""
    return _make_step(mesh, kernels.plain_kernel,
                    lambda parts, fold: kernels.mesh_fold_plain(parts, fold))


def _make_step(mesh, kernel_of, fold_fn):
    def make(num_groups: int, D_shard: int = 0):
        tplan, gplan = TOTALS_PLAN, groups_plan(num_groups)
        checked = set()

        def step(ids, vals, gids, lo, hi, ndocs, doc_pos
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
            vdt = vals.dtype
            blocks = [b if isinstance(b, ShardedBlock) else
                      shard_block(mesh, b) for b in (ids, vals, gids)]
            S, D = blocks[0].shape
            _check_doc_pos(doc_pos, D, checked)
            cols = dict(zip(("ids:ids", "val:vals", "ids:gids"), blocks))
            lead = mesh.lead
            params = {"leaf0:lo": lo.to(lead), "leaf0:hi": hi.to(lead)}
            shards, _s_loc, d_loc = kernels.mesh_shards(
                mesh, [cols], [params], [ndocs.to(lead)], D)
            tot, grp = kernel_of(tplan, vdt), kernel_of(gplan, vdt)
            tparts, gparts = [], []
            for cs, ps, ns in shards:
                tparts.append(tot(cs[0], ps[0], ns[0], d_loc).to(
                    lead, non_blocking=True)[None])
                gparts.append(grp(cs[0], ps[0], ns[0], d_loc).to(
                    lead, non_blocking=True)[None])
            totals = fold_fn(tparts, _folds(tplan, mesh, S, 0))[0]
            groups = fold_fn(gparts, _folds(gplan, mesh, S, num_groups))[0]
            return totals[0], totals[1], groups

        return step

    return make


@functools.lru_cache(maxsize=64)
def _folds(plan: DevicePlan, mesh: Mesh, S: int, G: int):
    """The step's K9 fold of `plan`'s partials over every slot and
    segment (no matched tail), built and uploaded once per geometry."""
    remap = np.tile(np.arange(G, dtype=np.int64), (S, 1)) if G else None
    return collective.merged_plan(plan, mesh, S, G, remap, tail=False)


def _check_doc_pos(doc_pos, D: int, checked: set) -> None:
    """doc_pos must be the global positions 0..D-1 (K1-K3 mask each
    shard's docs from its doc slice's first position)."""
    if doc_pos is None:
        return
    key = (doc_pos.data_ptr(), doc_pos.numel(), str(doc_pos.device))
    if key in checked:
        return
    want = torch.arange(D, device=doc_pos.device)
    if doc_pos.numel() != D or not torch.equal(
            doc_pos.reshape(-1).to(want.dtype), want):
        raise ValueError("doc_pos must hold the global doc positions "
                         f"arange({D})")
    checked.add(key)
