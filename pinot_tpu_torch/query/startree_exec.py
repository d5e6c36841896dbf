"""Star-tree fit check: which pre-agg pairs a query needs and which dictId
sets its filter selects on a tree's dimensions.

Counterpart of the fit-check half of pinot_tpu/query/startree_exec.py (ref
pinot-core StarTreeUtils: aggregations must map to the tree's
function-column pairs, the filter must be an AND of predicates on
split-order dims). The device leg (ops/startree_device.py) plans from these;
the port has no host star-tree executor.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import Expression, Function, Identifier
from pinot_tpu_torch.query.predicate import resolve_predicate
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
