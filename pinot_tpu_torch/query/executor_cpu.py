"""Host pieces of the selection path: row projection and the LIMIT-only
scan.

Counterpart of the selection parts of pinot_tpu/query/executor_cpu.py
(`_project_rows` :229, `expand_star` :243, the unordered early exit of
`_select` :254-261) and of pinot_tpu/query/transform.py
`evaluate` (:73), trimmed to identifiers, literals and the four arithmetic
functions. The port has no host executor: the device engine calls these to
project the rows its top-N kernel picked, and to answer a selection with
neither a filter nor an ORDER BY from the first docs of each segment, as
the JAX engine leaves that shape to its host executor (ref
SelectionOnlyOperator's early exit), skipping docs an upsert superseded.
A CLP log column projects only the docs asked for, through its reader's
random access: `values()` would decode the whole column (JAX loader.py
:85-90), and the rows are the same either way.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np

from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    Expression, Function, Identifier, Literal)
from pinot_tpu_torch.query.results import ExecutionStats, SelectionResult
from pinot_tpu_torch.segment.loader import ImmutableSegment

_BINARY_NUMERIC = {
    "plus": np.add,
    "minus": np.subtract,
    "times": np.multiply,
    "divide": lambda a, b: np.divide(np.asarray(a, dtype=np.float64), b),
}


def evaluate(expr: Expression, seg: ImmutableSegment,
             doc_idx: np.ndarray) -> Any:
    """expr over the docs `doc_idx` of `seg`: a numpy array, or a scalar
    for a literal-only tree. The functions are elementwise, so evaluating
    over the gathered docs equals gathering the whole-column result."""
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, Identifier):
        return _column_values(seg, expr.name, doc_idx)
    if isinstance(expr, Function) and expr.name in _BINARY_NUMERIC \
            and len(expr.args) == 2:
        with np.errstate(all="ignore"):
            return _BINARY_NUMERIC[expr.name](
                evaluate(expr.args[0], seg, doc_idx),
                evaluate(expr.args[1], seg, doc_idx))
    raise NotImplementedError(f"transform {expr} is not in this port yet")


def _column_values(seg: ImmutableSegment, name: str,
                   doc_idx: np.ndarray) -> np.ndarray:
    """Column `name` at the docs `doc_idx`; a CLP column decodes only
    those docs (ref CLPForwardIndexReaderV2.getString)."""
    ds = seg.data_source(name)
    reader = ds.clp_reader
    if reader is None:
        return ds.values()[doc_idx]
    out = np.empty(len(doc_idx), dtype=object)
    out[:] = [reader.get(int(d)) for d in doc_idx]
    return out


def _project_rows(seg: ImmutableSegment, exprs: List[Expression],
                  doc_idx: np.ndarray) -> List[tuple]:
    """One tuple per doc of `doc_idx`, in its order: each expression's
    value ('*' expands to every column of the segment), as the Python
    scalars `tolist` gives (what the JAX executor's `_scalar` gives)."""
    cols = []
    for e in exprs:
        if isinstance(e, Identifier) and e.name == "*":
            for name in seg.column_names:
                cols.append(_column_values(seg, name, doc_idx))
            continue
        vals = np.asarray(evaluate(e, seg, doc_idx))
        if vals.ndim == 0:
            vals = np.broadcast_to(vals, (len(doc_idx),))
        cols.append(vals)
    return list(zip(*(c.tolist() for c in cols)))


def expand_star(seg: ImmutableSegment, ctx: QueryContext) -> List[str]:
    names = []
    result_names = ctx.result_column_names()
    for i, e in enumerate(ctx.select):
        if isinstance(e, Identifier) and e.name == "*":
            names.extend(seg.column_names)
        else:
            names.append(ctx.aliases[i] or result_names[i])
    return names


def select_first(seg: ImmutableSegment, ctx: QueryContext) -> SelectionResult:
    """Selection with neither a filter nor an ORDER BY: the first
    limit + offset valid docs of the segment, projected on the host. An
    upsert segment's superseded docs are not valid (the JAX executor's
    `mask &= valid.to_mask()`, executor_cpu.py:71-77; docs past the
    bitmap are not upsert-accounted yet)."""
    fetch = ctx.limit + ctx.offset
    valid = getattr(seg, "valid_doc_ids", None)
    if valid is None:
        doc_idx = np.arange(min(seg.num_docs, fetch))
        scanned = seg.num_docs
    else:
        # docs past num_docs are never set (the bitmap holds num_docs bits)
        doc_idx = valid.first_set(fetch)
        doc_idx = doc_idx[doc_idx < seg.num_docs]
        scanned = valid.cardinality() if valid.num_docs <= seg.num_docs \
            else int(valid.to_mask()[:seg.num_docs].sum())
    stats = ExecutionStats(
        num_docs_scanned=scanned,
        num_entries_scanned_post_filter=len(doc_idx) * max(len(ctx.select),
                                                           1),
        num_segments_processed=1,
        num_segments_matched=1 if scanned else 0,
        total_docs=seg.num_docs)
    return SelectionResult(_project_rows(seg, ctx.select, doc_idx),
                           columns=expand_star(seg, ctx), stats=stats)

