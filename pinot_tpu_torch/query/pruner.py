"""Segment pruning before execution, on each segment's min / max.

A trimmed copy of pinot_tpu/query/pruner.py (ref pinot-core
query/pruner/ColumnValueSegmentPruner.java): a segment whose column range
proves an EQ / IN / range leaf false is dropped; AND prunes when any child
does, OR when all do. The port's creator writes no bloom filter and its
loader reads none (segment/loader.py), so there is no bloom probe.

One difference from the reference, on purpose: a FLOAT column's min / max
meet the literal rounded to float32, as the host filter and the device
bounds read it (ops/engine.py `_vrange_bounds`). The reference compares
in double (pinot_tpu/query/pruner.py:55-88), so it prunes a segment whose
FLOAT values are all 0.1f for `col = 0.1` (0.1f > 0.1), which its own
host filter would match.
"""
from __future__ import annotations

from typing import List

import numpy as np

from pinot_tpu_torch.models.field_spec import DataType
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    Expression, Function, Identifier, Literal)
from pinot_tpu_torch.segment.loader import ImmutableSegment

_RANGE_LEAVES = ("equals", "between", "greater_than",
                 "greater_than_or_equal", "less_than", "less_than_or_equal",
                 "in")


def prune_segments(segments: List[ImmutableSegment],
                   ctx: QueryContext) -> List[ImmutableSegment]:
    if ctx.filter is None:
        return list(segments)
    return [s for s in segments if not _can_prune(s, ctx.filter)]


def _can_prune(seg: ImmutableSegment, expr: Expression) -> bool:
    """True when the filter provably matches nothing in this segment."""
    if not isinstance(expr, Function):
        return False
    name = expr.name
    if name == "and":
        return any(_can_prune(seg, a) for a in expr.args)
    if name == "or":
        return all(_can_prune(seg, a) for a in expr.args)
    if name not in _RANGE_LEAVES:
        return False
    if not expr.args or not isinstance(expr.args[0], Identifier):
        return False
    meta = seg.metadata.columns.get(expr.args[0].name)
    if meta is None or meta.min_value is None or meta.max_value is None:
        return False
    lo, hi = meta.min_value, meta.max_value
    as_float32 = meta.data_type is DataType.FLOAT

    def lit(i: int):
        a = expr.args[i]
        if not isinstance(a, Literal):
            return None
        v = a.value
        if as_float32 and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            with np.errstate(over="ignore"):
                v = float(np.float32(v))
        return v

    try:
        if name == "equals":
            v = lit(1)
            return v is not None and (_lt(v, lo) or _lt(hi, v))
        if name == "in":
            vals = [lit(i) for i in range(1, len(expr.args))]
            vals = [v for v in vals if v is not None]
            return bool(vals) and all(_lt(v, lo) or _lt(hi, v)
                                      for v in vals)
        if name == "between":
            a, b = lit(1), lit(2)
            return a is not None and b is not None \
                and (_lt(hi, a) or _lt(b, lo))
        v = lit(1)
        if v is None:
            return False
        if name == "greater_than":
            return not _lt(v, hi)
        if name == "greater_than_or_equal":
            return _lt(hi, v)
        if name == "less_than":
            return not _lt(lo, v)
        return _lt(v, lo)  # less_than_or_equal
    except (TypeError, ValueError):
        return False


def _lt(a, b) -> bool:
    if isinstance(a, str) != isinstance(b, str):
        a, b = float(a), float(b)
    return a < b
