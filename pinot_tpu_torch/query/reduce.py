"""Broker-side reduce of the device slice: aggregation, group-by,
selection and DISTINCT.

Counterpart of pinot_tpu/query/reduce.py (ref pinot-core
query/reduce/BrokerReduceService.java:61, AggregationDataTableReducer,
GroupByDataTableReducer with IndexedTable merge + HavingFilterHandler +
PostAggregationHandler, SelectionDataTableReducer and
DistinctDataTableReducer), trimmed to the query shapes the port runs.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from pinot_tpu_torch.query.aggregation import get_aggregation, is_aggregation
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    Expression, Function, Identifier, Literal)
from pinot_tpu_torch.query.results import (
    AggregationResult, DistinctResult, ExecutionStats, GroupByResult,
    SelectionResult)


@dataclass
class ResultTable:
    columns: List[str]
    column_types: List[str]
    rows: List[Tuple]

    def to_dict(self) -> dict:
        return {"dataSchema": {"columnNames": self.columns,
                               "columnDataTypes": self.column_types},
                "rows": [list(r) for r in self.rows]}


@dataclass
class BrokerResponse:
    """Ref BrokerResponseNative (pinot-common response/broker/)."""
    result_table: Optional[ResultTable] = None
    exceptions: List[dict] = field(default_factory=list)
    stats: ExecutionStats = field(default_factory=ExecutionStats)
    time_used_ms: float = 0.0
    num_servers_queried: int = 0
    num_servers_responded: int = 0
    num_groups_limit_reached: bool = False
    #: the stitched span tree of a trace=true query
    trace: Optional[dict] = None
    #: served from the broker's result cache (or its negative cache)
    cache_hit: bool = False
    #: known incomplete (a server timed out, died mid-query, answered
    #: with an error, or segments had no surviving replica); the
    #: exceptions say why
    partial_result: bool = False
    #: served past its TTL (the brownout's stale serving, not in the
    #: port: always False)
    stale_result: bool = False

    def to_dict(self) -> dict:
        d = {
            "resultTable": (self.result_table.to_dict()
                            if self.result_table else None),
            "exceptions": self.exceptions,
            "numServersQueried": self.num_servers_queried,
            "numServersResponded": self.num_servers_responded,
            "numDocsScanned": self.stats.num_docs_scanned,
            "numEntriesScannedInFilter":
                self.stats.num_entries_scanned_in_filter,
            "numEntriesScannedPostFilter":
                self.stats.num_entries_scanned_post_filter,
            "numSegmentsProcessed": self.stats.num_segments_processed,
            "numSegmentsMatched": self.stats.num_segments_matched,
            "numSegmentsPrunedByServer": self.stats.num_segments_pruned,
            "totalDocs": self.stats.total_docs,
            "numGroupsLimitReached": self.num_groups_limit_reached,
            "timeUsedMs": self.time_used_ms,
            "cacheHit": self.cache_hit,
            "partialResult": self.partial_result,
            "staleResult": self.stale_result,
        }
        if self.trace is not None:
            d["traceInfo"] = self.trace
        return d

    @property
    def rows(self) -> List[Tuple]:
        return self.result_table.rows if self.result_table else []


_SCALAR_FUNCS = {
    "plus": lambda a, b: a + b,
    "minus": lambda a, b: a - b,
    "times": lambda a, b: a * b,
    "divide": lambda a, b: a / b if b else float("inf") if a > 0
    else float("-inf") if a < 0 else float("nan"),
    "mod": lambda a, b: a % b,
    "abs": abs,
    "sqrt": math.sqrt,
    "ln": math.log, "log": math.log, "log10": math.log10, "log2": math.log2,
    "exp": math.exp,
    "ceil": math.ceil, "floor": math.floor,
    "equals": lambda a, b: a == b,
    "not_equals": lambda a, b: a != b,
    "greater_than": lambda a, b: a > b,
    "greater_than_or_equal": lambda a, b: a >= b,
    "less_than": lambda a, b: a < b,
    "less_than_or_equal": lambda a, b: a <= b,
    "and": lambda *xs: all(xs),
    "or": lambda *xs: any(xs),
    "not": lambda a: not a,
}


def eval_scalar(expr: Expression, bindings: Dict[Expression, Any]) -> Any:
    """Evaluate an expression over scalar bindings (ref
    PostAggregationHandler / HavingFilterHandler)."""
    if expr in bindings:
        return bindings[expr]
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, Function):
        if expr.name == "between":
            v = eval_scalar(expr.args[0], bindings)
            return (eval_scalar(expr.args[1], bindings) <= v
                    <= eval_scalar(expr.args[2], bindings))
        if expr.name == "in":
            v = eval_scalar(expr.args[0], bindings)
            return any(v == eval_scalar(a, bindings) for a in expr.args[1:])
        fn = _SCALAR_FUNCS.get(expr.name)
        if fn is None:
            raise ValueError(
                f"unsupported post-aggregation function: {expr.name}")
        return fn(*(eval_scalar(a, bindings) for a in expr.args))
    raise ValueError(f"unbound expression in post-aggregation: {expr}")


def reduce_results(ctx: QueryContext, results: Sequence[Any]
                   ) -> BrokerResponse:
    """Merge per-segment results into the final BrokerResponse (ref
    BrokerReduceService.reduceOnDataTable)."""
    resp = BrokerResponse()
    for r in results:
        resp.stats.merge(r.stats)
    if ctx.is_group_by_query:
        resp.num_groups_limit_reached = any(
            r.num_groups_limit_reached for r in results)
        resp.result_table = _reduce_group_by(ctx, results)
    elif ctx.is_aggregation_query:
        resp.result_table = _reduce_aggregation(ctx, results)
    elif ctx.is_distinct_query:
        resp.result_table = _reduce_distinct(ctx, results)
    else:
        resp.result_table = _reduce_selection(ctx, results)
    return resp


def _reduce_aggregation(ctx: QueryContext,
                        results: Sequence[AggregationResult]) -> ResultTable:
    merged = [fn.identity() for fn in ctx.agg_functions]
    for r in results:
        for i, fn in enumerate(ctx.agg_functions):
            merged[i] = fn.merge(merged[i], r.intermediates[i])
    finals = [fn.extract_final(m) for fn, m in zip(ctx.agg_functions, merged)]
    bindings: Dict[Expression, Any] = dict(zip(ctx.agg_keys, finals))
    row = tuple(eval_scalar(e, bindings) for e in ctx.select)
    return ResultTable(ctx.result_column_names(),
                       [_result_type(e) for e in ctx.select], [row])


def _reduce_group_by(ctx: QueryContext,
                     results: Sequence[GroupByResult]) -> ResultTable:
    # IndexedTable-style merge (ref GroupByDataTableReducer)
    merged: Dict[Tuple, List[Any]] = {}
    for r in results:
        for key, inters in r.groups.items():
            cur = merged.get(key)
            if cur is None:
                merged[key] = list(inters)
            else:
                for i, fn in enumerate(ctx.agg_functions):
                    cur[i] = fn.merge(cur[i], inters[i])
    rows = []
    for key, inters in merged.items():
        finals = [fn.extract_final(m)
                  for fn, m in zip(ctx.agg_functions, inters)]
        bindings: Dict[Expression, Any] = dict(zip(ctx.group_by, key))
        bindings.update(zip(ctx.agg_keys, finals))
        if ctx.having is not None and not eval_scalar(ctx.having, bindings):
            continue
        # the output row evaluates against CLEAN bindings first (an alias
        # may shadow a column its own expression reads); aliases then bind
        # to the COMPUTED values for ORDER BY
        out_row = tuple(eval_scalar(e, bindings) for e in ctx.select)
        for val, alias in zip(out_row, ctx.aliases):
            if alias is not None:
                bindings[Identifier(alias)] = val
        sort_key = tuple(eval_scalar(e, bindings) for e, _ in ctx.order_by)
        rows.append((sort_key, out_row))
    if ctx.order_by:
        rows = _sorted_by_keys(rows, [asc for _, asc in ctx.order_by])
    out = [r for _, r in rows][ctx.offset:ctx.offset + ctx.limit]
    return ResultTable(ctx.result_column_names(),
                       [_result_type(e) for e in ctx.select], out)


def _reduce_selection(ctx: QueryContext,
                      results: Sequence[SelectionResult]) -> ResultTable:
    names = list(ctx.result_column_names())
    for r in results:
        if r.columns:
            names = list(r.columns)
            break
    if not ctx.order_by:
        rows: List[Tuple] = []
        for r in results:
            rows.extend(r.rows)
        rows = rows[ctx.offset:ctx.offset + ctx.limit]
        return ResultTable(names, ["UNKNOWN"] * len(names), rows)
    # ordered results come from the engine's _assemble_topn, which always
    # projects the order values beside the rows
    paired = []
    for r in results:
        paired.extend(zip(r.order_values, r.rows))
    # a stable sort: rows that tie across segments keep segment order
    paired = _sorted_by_keys(paired, [asc for _, asc in ctx.order_by])
    rows = [row for _, row in paired][ctx.offset:ctx.offset + ctx.limit]
    return ResultTable(names, ["UNKNOWN"] * len(names), rows)


def _reduce_distinct(ctx: QueryContext,
                     results: Sequence[DistinctResult]) -> ResultTable:
    seen = set()
    for r in results:
        seen |= r.rows
    rows = list(seen)
    if ctx.order_by:
        # order-by exprs must be in the select list for distinct
        idx = {e: i for i, e in enumerate(ctx.select)}
        paired = [(tuple(row[idx[e]] for e, _ in ctx.order_by), row)
                  for row in rows]
        paired = _sorted_by_keys(paired, [asc for _, asc in ctx.order_by])
        rows = [row for _, row in paired]
    rows = rows[ctx.offset:ctx.offset + ctx.limit]
    names = list(ctx.result_column_names())
    return ResultTable(names, ["UNKNOWN"] * len(names), rows)


def _sorted_by_keys(rows, ascs: List[bool]):
    """Sort (sort_key, row) pairs honoring per-key direction (stable)."""
    def cmp(a, b):
        for i, asc in enumerate(ascs):
            ka, kb = a[0][i], b[0][i]
            if ka == kb:
                continue
            lt = _lt(ka, kb)
            return (-1 if lt else 1) if asc else (1 if lt else -1)
        return 0

    return sorted(rows, key=functools.cmp_to_key(cmp))


def _lt(a, b) -> bool:
    try:
        return a < b
    except TypeError:
        return str(a) < str(b)


def _result_type(e: Expression) -> str:
    if isinstance(e, Function) and is_aggregation(e.name):
        return get_aggregation(e.name, e.args).final_dtype
    if isinstance(e, Function):
        return "DOUBLE"
    return "UNKNOWN"
