"""Star-tree query execution on the host, and the fit check the device
leg shares.

Counterpart of pinot_tpu/query/startree_exec.py (ref pinot-core
core/startree/: StarTreeUtils' fit check, where the aggregations must map
to the tree's function-column pairs and the filter must be an AND of
predicates on split-order dims; StarTreeFilterOperator.java:90's
traversal; StarTreeAggregationExecutor / StarTreeGroupByExecutor over the
matched pre-agg records). The device leg (ops/startree_device.py) plans
from `_agg_pairs_needed` and `_filter_id_sets`; the host executor
(query/executor_cpu.py) answers a fitting segment with `execute_star_tree`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import Expression, Function, Identifier
from pinot_tpu_torch.query.predicate import resolve_predicate
from pinot_tpu_torch.query.results import (
    AggregationResult, ExecutionStats, GroupByResult)
from pinot_tpu_torch.segment.startree import DimFilter


def _agg_pairs_needed(ctx: QueryContext) -> Optional[List[List[Tuple[str, str]]]]:
    """Per aggregation: list of (func, col) pre-agg pairs it needs, or None
    when some aggregation can't be served from a star-tree."""
    out = []
    for node, filt in zip(ctx.aggregations, ctx.agg_filters):
        if filt is not None:
            return None  # FILTER aggs bypass the tree (ref StarTreeUtils)
        name = node.name
        if name == "count":
            out.append([("count", "*")])
            continue
        if not node.args or not isinstance(node.args[0], Identifier):
            return None
        col = node.args[0].name
        if name in ("sum", "min", "max"):
            out.append([(name, col)])
        elif name == "avg":
            out.append([("sum", col), ("count", "*")])
        else:
            return None
    return out


def _filter_id_sets(seg, expr: Optional[Expression], dims: List[str]
                    ) -> Optional[Dict[str, Optional[DimFilter]]]:
    """AND-only filter tree -> per-dim matching DimFilters, or None when
    the filter doesn't fit (non-AND composition, non-tree dim, unsupported
    predicate). Range predicates stay as [lo, hi] intervals end to end —
    never materialized into dictId arrays — so arbitrarily wide ranges
    fit the tree path."""
    sets: Dict[str, Optional[DimFilter]] = {d: None for d in dims}
    if expr is None:
        return sets

    def add(pred_col: str, f: DimFilter) -> bool:
        cur = sets.get(pred_col)
        sets[pred_col] = f if cur is None else cur.intersect(f)
        return True

    def walk(e: Expression) -> bool:
        if not isinstance(e, Function):
            return False
        if e.name == "and":
            return all(walk(a) for a in e.args)
        if not e.args or not isinstance(e.args[0], Identifier):
            return False
        col = e.args[0].name
        if col not in sets:
            return False  # predicate on a non-tree dim
        p = resolve_predicate(seg, e)
        if p is None:
            return False
        if p.kind == "all":
            return True
        if p.kind == "none":
            return add(col, DimFilter.from_ids(np.empty(0, dtype=np.int32)))
        if p.kind == "range":
            return add(col, DimFilter.from_range(p.lo, p.hi))
        if p.kind == "set":
            return add(col, DimFilter.from_ids(p.ids))
        return False  # notset / null kinds -> scan path

    if not walk(expr):
        return None
    return sets


def execute_star_tree(seg, ctx: QueryContext):
    """AggregationResult / GroupByResult from the first tree that fits, or
    None when none does (or the query sets useStarTree=false)."""
    if ctx.options.get("useStarTree", "true").lower() == "false":
        return None
    reader = getattr(seg, "star_tree", None)
    if reader is None or not reader.trees:
        return None
    if not ctx.aggregations or ctx.distinct:
        return None
    needed = _agg_pairs_needed(ctx)
    if needed is None:
        return None
    group_cols: List[str] = []
    for g in ctx.group_by:
        if not isinstance(g, Identifier):
            return None
        group_cols.append(g.name)
    for tree in reader.trees:
        dims = tree.meta.dims
        if not all(pair in tree.metrics for pairs in needed
                   for pair in pairs):
            continue
        if not all(c in dims for c in group_cols):
            continue
        id_sets = _filter_id_sets(seg, ctx.filter, dims)
        if id_sets is None:
            continue
        return _execute_on_tree(seg, tree, ctx, needed, group_cols, id_sets)
    return None


def _execute_on_tree(seg, tree, ctx: QueryContext, needed, group_cols,
                     id_sets):
    recs = tree.traverse(id_sets, set(group_cols))
    stats = ExecutionStats(
        num_docs_scanned=len(recs),   # pre-agg records scanned
        num_segments_processed=1,
        num_segments_matched=1 if len(recs) else 0,
        total_docs=seg.num_docs)

    def pair_values(pair):
        return tree.metrics[pair][recs]

    if not group_cols:
        return AggregationResult(
            [_whole(node.name, needed[i], pair_values)
             for i, node in enumerate(ctx.aggregations)], stats)
    # group keys: the records' dim codes through the dictionaries
    dicts = [seg.data_source(c).dictionary for c in group_cols]
    stacked = np.stack([tree.dim_codes[c][recs] for c in group_cols], axis=1)
    uniq, inverse = np.unique(stacked, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    n_groups = len(uniq)
    per_fn = [_grouped(node.name, needed[i], pair_values, inverse, n_groups)
              for i, node in enumerate(ctx.aggregations)]
    groups = {tuple(d.get_value(int(uniq[g, j]))
                    for j, d in enumerate(dicts)):
              [per_fn[i][g] for i in range(len(per_fn))]
              for g in range(n_groups)}
    return GroupByResult(groups, stats)


def _whole(name: str, pairs, pair_values):
    if name == "count":
        return int(pair_values(("count", "*")).sum())
    if name == "sum":
        return float(pair_values(pairs[0]).sum())
    if name == "min":
        v = pair_values(pairs[0])
        return float(v.min()) if len(v) else float("inf")
    if name == "max":
        v = pair_values(pairs[0])
        return float(v.max()) if len(v) else float("-inf")
    # avg
    return (float(pair_values(pairs[0]).sum()),
            int(pair_values(("count", "*")).sum()))


def _grouped(name: str, pairs, pair_values, inverse, n_groups):
    def bsum(pair):
        return np.bincount(inverse, weights=pair_values(pair),
                           minlength=n_groups)
    if name == "count":
        return bsum(("count", "*")).astype(np.int64).tolist()
    if name == "sum":
        return bsum(pairs[0]).tolist()
    if name == "avg":
        return list(zip(bsum(pairs[0]).tolist(),
                        bsum(("count", "*")).astype(np.int64).tolist()))
    v = pair_values(pairs[0])
    out = np.full(n_groups, np.inf if name == "min" else -np.inf)
    (np.minimum if name == "min" else np.maximum).at(out, inverse, v)
    return out.tolist()
