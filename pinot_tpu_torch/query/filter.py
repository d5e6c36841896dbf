"""Filter evaluation on the host: a filter tree to a boolean doc mask.

A trimmed copy of pinot_tpu/query/filter.py (ref pinot-core
operator/filter/: predicates resolve against each segment's sorted
dictionary into dictId ranges and sets, PredicateEvaluator.java:26, then
a dictId scan; ExpressionFilterOperator for the rest). Leaf resolution is
the port's own query/predicate.py, which the device planner reads too. The
port's segments carry no sorted, inverted, null-value, JSON, text or geo
index (segment/loader.py), so a resolved leaf is a dictId scan, IS NULL is
a NaN test, and `json_match` / `text_match` / `st_within_distance` /
`vector_similarity` are not ported to the host.

`SegmentColumnProvider` is the column provider the host executor and
transform.py read: over all of a segment's docs, or over the docs `doc_idx`
a selection picked (a CLP column then decodes only those docs).
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np

from pinot_tpu_torch.query import transform
from pinot_tpu_torch.query.expressions import (
    COMPARISON_KINDS, Expression, Function, Literal)
from pinot_tpu_torch.query.predicate import (
    ResolvedPredicate, like_to_regex, resolve_predicate)
from pinot_tpu_torch.segment.loader import ImmutableSegment

#: filter functions whose indexes the port's segments lack
_NOT_PORTED = ("json_match", "text_match", "st_within_distance",
               "geo_within_distance", "vector_similarity")


def predicate_mask(seg: ImmutableSegment,
                   pred: ResolvedPredicate) -> np.ndarray:
    """Boolean doc mask of a resolved predicate, by a dictId scan (ref
    ScanBasedFilterOperator)."""
    n = seg.num_docs
    if pred.kind == "all":
        return np.ones(n, dtype=bool)
    if pred.kind == "none":
        return np.zeros(n, dtype=bool)
    dict_ids = seg.data_source(pred.column).dict_ids()
    if pred.kind == "range":
        return (dict_ids >= pred.lo) & (dict_ids <= pred.hi)
    member = np.isin(dict_ids, pred.ids)
    return member if pred.kind == "set" else ~member


def evaluate_filter(seg: ImmutableSegment, expr: Optional[Expression],
                    provider=None) -> np.ndarray:
    """A filter tree as a boolean mask over the segment's docs."""
    n = seg.num_docs
    if expr is None:
        return np.ones(n, dtype=bool)
    if isinstance(expr, Function):
        if expr.name == "and":
            mask = evaluate_filter(seg, expr.args[0], provider)
            for a in expr.args[1:]:
                if not mask.any():
                    break
                mask &= evaluate_filter(seg, a, provider)
            return mask
        if expr.name == "or":
            mask = evaluate_filter(seg, expr.args[0], provider)
            for a in expr.args[1:]:
                if mask.all():
                    break
                mask |= evaluate_filter(seg, a, provider)
            return mask
        if expr.name == "not":
            return ~evaluate_filter(seg, expr.args[0], provider)
        if expr.name in _NOT_PORTED:
            raise NotImplementedError(
                f"filter {expr.name} is not in this port's host executor "
                "yet")
        pred = resolve_predicate(seg, expr)
        if pred is not None:
            return predicate_mask(seg, pred)
        return _value_space_mask(seg, expr, provider)
    if isinstance(expr, Literal):
        return np.full(n, bool(expr.value), dtype=bool)
    raise ValueError(f"invalid filter expression: {expr}")


def _value_space_mask(seg: ImmutableSegment, fn: Function,
                      provider) -> np.ndarray:
    """The predicate over materialized values (ref
    ExpressionFilterOperator). A raw FLOAT column meets a literal in
    float32, as numpy compares a float32 array with a Python scalar."""
    if provider is None:
        provider = SegmentColumnProvider(seg)
    name = fn.name
    if name in COMPARISON_KINDS:
        out = transform.evaluate(fn, provider)
        # a copy: broadcast views are read-only, and AND / OR combine in
        # place
        return np.broadcast_to(
            np.asarray(out, dtype=bool), (seg.num_docs,)).copy()
    lhs = np.asarray(transform.evaluate(fn.args[0], provider))
    if name == "between":
        lo = transform.evaluate(fn.args[1], provider)
        hi = transform.evaluate(fn.args[2], provider)
        return (lhs >= lo) & (lhs <= hi)
    if name in ("in", "not_in"):
        vals = [a.value for a in fn.args[1:] if isinstance(a, Literal)]
        if lhs.dtype.kind == "f":
            # in the column's float type, as `=` reads a literal (a FLOAT
            # column's list in float32, as the pruner reads it)
            with np.errstate(over="ignore"):
                vals = np.array([float(v) for v in vals], dtype=lhs.dtype)
        elif lhs.dtype.kind in "iu":
            vals = np.array([float(v) for v in vals])
        else:
            vals = np.array([str(v) for v in vals])
        member = np.isin(lhs, vals)
        return member if name == "in" else ~member
    if name in ("like", "regexp_like"):
        pattern = fn.args[1].value  # type: ignore[union-attr]
        rx = re.compile(like_to_regex(pattern) if name == "like"
                        else pattern)
        return np.array([bool(rx.search(str(v))) for v in lhs.tolist()],
                        dtype=bool)
    if name == "is_null":
        return np.isnan(lhs) if lhs.dtype.kind == "f" \
            else np.zeros(seg.num_docs, bool)
    if name == "is_not_null":
        return ~np.isnan(lhs) if lhs.dtype.kind == "f" \
            else np.ones(seg.num_docs, bool)
    raise ValueError(f"unsupported filter function: {name}")


class SegmentColumnProvider:
    """Column provider over one segment: all its docs, or the docs
    `doc_idx` in their order."""

    def __init__(self, seg: ImmutableSegment,
                 doc_idx: Optional[np.ndarray] = None):
        self._seg = seg
        self._doc_idx = doc_idx

    def column(self, name: str) -> np.ndarray:
        ds = self._seg.data_source(name)
        if self._doc_idx is None:
            return ds.values()
        reader = ds.clp_reader
        if reader is None:
            return ds.values()[self._doc_idx]
        # a CLP column decodes only the docs asked for, through its
        # reader's random access (ref CLPForwardIndexReaderV2.getString)
        out = np.empty(len(self._doc_idx), dtype=object)
        out[:] = [reader.get(int(d)) for d in self._doc_idx]
        return out

    @property
    def num_docs(self) -> int:
        return self._seg.num_docs if self._doc_idx is None \
            else len(self._doc_idx)
