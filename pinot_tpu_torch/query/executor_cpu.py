"""The host executor: one segment through numpy, and the host pieces of
the device selection path.

Counterpart of pinot_tpu/query/executor_cpu.py (ref pinot-core
AggregationOperator.java:64, GroupByOperator :101 with
DictionaryBasedGroupKeyGenerator, the Selection and Distinct operators),
whole-column numpy execution. `execute_segment` answers a segment of a
batch the device engine refused by design (ops/engine.py raises
NotOffloadable; the server's query/executor.py `execute_context` hands
that batch here, as the JAX executor hands its engine's fallback
segments to its host), through the star-tree where one fits
(query/startree_exec.py) and otherwise through the filter mask
(query/filter.py), with an upsert segment's superseded docs masked out.

The device engine calls `_project_rows` / `expand_star` to project the
rows its top-N kernel picked, and `select_first` to answer a selection
with neither a filter nor an ORDER BY from the first docs of each segment,
as the JAX engine leaves that shape to its host (ref
SelectionOnlyOperator's early exit). A CLP log column projects only the
docs asked for, through its reader's random access: `values()` would
decode the whole column (JAX loader.py :85-90), and the rows are the same
either way.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from pinot_tpu_torch.query import transform
from pinot_tpu_torch.query.aggregation import UnsupportedAggregation
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import Expression, Function, Identifier
from pinot_tpu_torch.query.filter import SegmentColumnProvider, evaluate_filter
from pinot_tpu_torch.query.results import (
    AggregationResult, DistinctResult, ExecutionStats, GroupByResult,
    SelectionResult)
from pinot_tpu_torch.query.startree_exec import execute_star_tree
from pinot_tpu_torch.segment.loader import ImmutableSegment

# ref plan/maker/InstancePlanMakerImplV2.java DEFAULT_NUM_GROUPS_LIMIT
DEFAULT_NUM_GROUPS_LIMIT = 100_000


def execute_segment(seg: ImmutableSegment, ctx: QueryContext):
    """One segment's AggregationResult / GroupByResult / SelectionResult /
    DistinctResult. Raises NotImplementedError naming an aggregation,
    transform or filter the port does not run yet."""
    for fn in ctx.agg_functions:
        if isinstance(fn, UnsupportedAggregation):
            raise NotImplementedError(
                f"aggregation {fn.names[0].upper()} is not in this port "
                f"yet ({fn.missing_feature})")
    valid = getattr(seg, "valid_doc_ids", None)
    # pre-aggregated records count superseded rows: an upsert bitmap with
    # cleared bits rules the tree out (an all-set one masks nothing)
    if ctx.aggregations and seg.metadata.star_tree \
            and (valid is None or valid.is_full()):
        result = execute_star_tree(seg, ctx)
        if result is not None:
            return result
    provider = SegmentColumnProvider(seg)
    mask = evaluate_filter(seg, ctx.filter, provider)
    if valid is not None:
        # upsert: only the latest row per primary key is visible
        vmask = valid.to_mask()
        if len(vmask) < seg.num_docs:
            vmask = np.concatenate(
                [vmask, np.zeros(seg.num_docs - len(vmask), bool)])
        mask &= vmask[:seg.num_docs]
    stats = ExecutionStats(
        num_docs_scanned=int(np.count_nonzero(mask)),
        num_entries_scanned_in_filter=(
            seg.num_docs * len(set(ctx.filter_columns()))
            if ctx.filter is not None else 0),
        num_segments_processed=1,
        num_segments_matched=1 if mask.any() else 0,
        total_docs=seg.num_docs)
    if ctx.is_group_by_query:
        return _group_by(seg, ctx, provider, mask, stats)
    if ctx.is_aggregation_query:
        return _aggregate(seg, ctx, provider, mask, stats)
    if ctx.is_distinct_query:
        return DistinctResult(
            set(_project_rows(seg, ctx.select, np.nonzero(mask)[0])),
            stats=stats)
    return _select(seg, ctx, provider, mask, stats)


def _agg_input(seg: ImmutableSegment, node: Function,
               provider) -> Optional[np.ndarray]:
    """The aggregation's argument column (None for COUNT(*))."""
    if not node.args:
        return None
    arg = node.args[0]
    if isinstance(arg, Identifier) and arg.name == "*":
        return None
    out = np.asarray(transform.evaluate(arg, provider))
    if out.ndim == 0:
        out = np.broadcast_to(out, (seg.num_docs,))
    return out


def _agg_mask(seg, ctx: QueryContext, provider, mask, i):
    """The query's mask AND the i-th aggregation's own FILTER (WHERE ...)
    clause (ref FilteredAggregationOperator)."""
    cond = ctx.agg_filters[i]
    if cond is None:
        return mask
    return mask & evaluate_filter(seg, cond, provider)


def _aggregate(seg, ctx: QueryContext, provider, mask,
               stats) -> AggregationResult:
    inters = []
    for i, (node, fn) in enumerate(zip(ctx.aggregations,
                                       ctx.agg_functions)):
        values = _agg_input(seg, node, provider)
        inters.append(fn.aggregate(values,
                                   _agg_mask(seg, ctx, provider, mask, i)))
        if values is not None:
            stats.num_entries_scanned_post_filter += stats.num_docs_scanned
    return AggregationResult(inters, stats)


def _group_by(seg, ctx: QueryContext, provider, mask,
              stats) -> GroupByResult:
    """Each group-by expression factorized over the matched docs, the
    codes combined in a mixed radix (ref DictionaryBasedGroupKeyGenerator),
    then each function's grouped pass."""
    limit = int(ctx.options.get("numGroupsLimit", DEFAULT_NUM_GROUPS_LIMIT))
    if not mask.any():
        return GroupByResult({}, stats)
    codes_list, uniques_list = [], []
    for e in ctx.group_by:
        vals = np.asarray(transform.evaluate(e, provider))
        if vals.ndim == 0:
            vals = np.broadcast_to(vals, (seg.num_docs,))
        uniques, codes = np.unique(vals[mask], return_inverse=True)
        codes_list.append(codes.reshape(-1))
        uniques_list.append(uniques)
    cards = [len(u) for u in uniques_list]
    combined = codes_list[0].astype(np.int64)
    for c, card in zip(codes_list[1:], cards[1:]):
        combined = combined * card + c
    present, combined_codes = np.unique(combined, return_inverse=True)
    combined_codes = combined_codes.reshape(-1)
    limit_reached = len(present) > limit
    if limit_reached:
        present = present[:limit]
    num_groups = len(present)
    # present combined keys back to value tuples
    key_cols = []
    rem = present.copy()
    for card, uniques in zip(reversed(cards), reversed(uniques_list)):
        key_cols.append(uniques[(rem % card).astype(np.int64)])
        rem //= card
    key_cols.reverse()
    keys = list(zip(*(col.tolist() for col in key_cols)))
    doc_idx = np.nonzero(mask)[0]
    full_keys = np.zeros(seg.num_docs, dtype=np.int64)
    full_keys[doc_idx] = combined_codes
    gmask = mask.copy()
    if limit_reached:
        gmask[doc_idx[combined_codes >= num_groups]] = False
    per_fn: List[list] = []
    for i, (node, fn) in enumerate(zip(ctx.aggregations,
                                       ctx.agg_functions)):
        values = _agg_input(seg, node, provider)
        per_fn.append(fn.aggregate_grouped(
            values, full_keys, num_groups,
            _agg_mask(seg, ctx, provider, gmask, i)))
        if values is not None:
            stats.num_entries_scanned_post_filter += stats.num_docs_scanned
    groups = {keys[g]: [per_fn[f][g] for f in range(len(per_fn))]
              for g in range(num_groups)}
    return GroupByResult(groups, stats,
                         num_groups_limit_reached=limit_reached)


def _select(seg, ctx: QueryContext, provider, mask,
            stats) -> SelectionResult:
    doc_idx = np.nonzero(mask)[0]
    fetch = ctx.limit + ctx.offset
    if not ctx.order_by:
        doc_idx = doc_idx[:fetch]  # ref SelectionOnlyOperator early exit
        stats.num_entries_scanned_post_filter = \
            len(doc_idx) * max(len(ctx.select), 1)
        return SelectionResult(_project_rows(seg, ctx.select, doc_idx),
                               columns=expand_star(seg, ctx), stats=stats)
    # ORDER BY: sort keys over the matched docs, the first `fetch` rows
    # (ref SelectionOrderByOperator)
    sort_cols = []
    for e, asc in ctx.order_by:
        vals = np.asarray(transform.evaluate(e, provider))
        if vals.ndim == 0:
            vals = np.broadcast_to(vals, (seg.num_docs,))
        sort_cols.append((vals[doc_idx], asc))
    doc_idx = doc_idx[_lexsort(sort_cols)][:fetch]
    stats.num_entries_scanned_post_filter = \
        len(doc_idx) * max(len(ctx.select), 1)
    return SelectionResult(
        _project_rows(seg, ctx.select, doc_idx),
        order_values=_project_rows(seg, [e for e, _ in ctx.order_by],
                                   doc_idx),
        columns=expand_star(seg, ctx), stats=stats)


def _lexsort(sort_cols) -> np.ndarray:
    """Stable multi-key argsort honoring each key's direction."""
    keys = []
    for vals, asc in reversed(sort_cols):
        if not asc:
            if vals.dtype.kind in "iuf":
                vals = -vals.astype(np.float64)
            else:
                # descending strings: invert their ranks
                _uniques, codes = np.unique(vals, return_inverse=True)
                vals = -codes.reshape(-1)
        keys.append(vals)
    return np.lexsort(keys)


def _project_rows(seg: ImmutableSegment, exprs: List[Expression],
                  doc_idx: np.ndarray) -> List[tuple]:
    """One tuple per doc of `doc_idx`, in its order: each expression's
    value ('*' expands to every column of the segment), as the Python
    scalars `tolist` gives (what the JAX executor's `_scalar` gives). The
    expressions are elementwise, so evaluating over the gathered docs
    equals gathering the whole-column result."""
    provider = SegmentColumnProvider(seg, doc_idx)
    cols = []
    for e in exprs:
        if isinstance(e, Identifier) and e.name == "*":
            cols.extend(provider.column(name) for name in seg.column_names)
            continue
        vals = np.asarray(transform.evaluate(e, provider))
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
