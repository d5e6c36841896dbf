"""QueryContext: executable view of a parsed query.

Counterpart of pinot_tpu/query/context.py (ref
org.apache.pinot.common.request.context.QueryContext): pre-extracts the
aggregation list, per-aggregation FILTER conditions, group-by, having,
order-by and options, and classifies the query shape.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.query.aggregation import (
    AggregationFunction, get_aggregation, is_aggregation)
from pinot_tpu_torch.query.expressions import (
    Expression, Function, Identifier)
from pinot_tpu_torch.query.parser import PinotQuery, parse_sql


@dataclass
class QueryContext:
    table: str
    select: List[Expression]                 # post-alias-strip select exprs
    aliases: List[Optional[str]]             # per select expr
    distinct: bool
    filter: Optional[Expression]
    group_by: List[Expression]
    having: Optional[Expression]
    order_by: List[Tuple[Expression, bool]]
    limit: int
    offset: int
    options: Dict[str, str]

    # derived
    aggregations: List[Function] = field(default_factory=list)
    #: binding keys as they appear in select/having/order-by — equals
    #: aggregations[i] except for FILTER aggs where it's the filter_agg node
    agg_keys: List[Function] = field(default_factory=list)
    agg_functions: List[AggregationFunction] = field(default_factory=list)
    #: per-aggregation FILTER (WHERE ...) condition, or None
    agg_filters: List[Optional[Expression]] = field(default_factory=list)

    @classmethod
    def from_query(cls, q: PinotQuery) -> "QueryContext":
        select, aliases = [], []
        for e in q.select_list:
            if isinstance(e, Function) and e.name == "as":
                select.append(e.args[0])
                aliases.append(e.args[1].value)  # type: ignore[union-attr]
            else:
                select.append(e)
                aliases.append(None)
        ctx = cls(table=q.table, select=select, aliases=aliases,
                  distinct=q.distinct, filter=q.filter,
                  group_by=list(q.group_by), having=q.having,
                  order_by=list(q.order_by), limit=q.limit, offset=q.offset,
                  options=dict(q.options))
        ctx._extract_aggregations()
        return ctx

    @classmethod
    def from_sql(cls, sql: str) -> "QueryContext":
        return cls.from_query(parse_sql(sql))

    def _extract_aggregations(self) -> None:
        seen: Dict[Function, int] = {}
        out: List[Function] = []          # outer nodes (binding keys)
        inner: List[Function] = []        # the agg function node itself
        filters: List[Optional[Expression]] = []

        def walk(e: Expression) -> None:
            if not isinstance(e, Function):
                return
            if e.name == "filter_agg":
                if e not in seen:
                    seen[e] = len(out)
                    out.append(e)
                    inner.append(e.args[0])  # type: ignore[arg-type]
                    filters.append(e.args[1])
                return  # don't descend: inner agg is owned by this node
            if is_aggregation(e.name):
                if e not in seen:
                    seen[e] = len(out)
                    out.append(e)
                    inner.append(e)
                    filters.append(None)
                return
            for a in e.args:
                walk(a)

        sources = list(self.select) + [e for e, _ in self.order_by]
        if self.having is not None:
            sources.append(self.having)
        for e in sources:
            walk(e)
        self.aggregations = inner
        self.agg_keys = out
        self.agg_filters = filters
        self.agg_functions = [get_aggregation(f.name, f.args) for f in inner]

    @property
    def is_aggregation_query(self) -> bool:
        return bool(self.aggregations) and not self.group_by

    @property
    def is_group_by_query(self) -> bool:
        return bool(self.aggregations) and bool(self.group_by)

    @property
    def is_distinct_query(self) -> bool:
        return self.distinct

    def filter_columns(self) -> List[str]:
        return self.filter.columns() if self.filter is not None else []

    def result_column_names(self) -> List[str]:
        """One name per select expression: its alias, the column, the
        aggregation's result name, or the expression's text ('*' for a
        star, which the selection path expands per segment)."""
        return [alias if alias is not None else _column_name(e)
                for e, alias in zip(self.select, self.aliases)]


def _column_name(e: Expression) -> str:
    if isinstance(e, Identifier):
        return e.name
    if isinstance(e, Function) and is_aggregation(e.name):
        return get_aggregation(e.name, e.args).result_name
    return str(e)
