"""QueryContext: executable view of a parsed query.

Counterpart of pinot_tpu/query/context.py (ref
org.apache.pinot.common.request.context.QueryContext): pre-extracts the
aggregation list, per-aggregation FILTER conditions, group-by, having,
order-by and options, and classifies the query shape. `fingerprint` is the
digest the server's warm-up log keys plans on; `merge_extra_filter` ANDs a
broker's extra filter into the tree.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.query.aggregation import (
    AggregationFunction, get_aggregation, is_aggregation)
from pinot_tpu_torch.query.expressions import (
    Expression, Function, Identifier, func)
from pinot_tpu_torch.query.parser import PinotQuery, _Parser, parse_sql, \
    tokenize


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
    #: EXPLAIN PLAN FOR: the broker never caches it
    explain: bool = False

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
                  options=dict(q.options), explain=q.explain)
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

    #: options that steer caching and observability, not the result
    _FINGERPRINT_OPT_DENYLIST = frozenset(
        {"skipcache", "usecache", "trace", "timeoutms"})

    def fingerprint(self) -> str:
        """Digest of everything that decides the result (JAX
        context.py:133): table, select list and aliases, DISTINCT, the
        filter / group-by / having / order-by trees, limit, offset and the
        result-affecting options. Expression nodes print deterministically,
        so the digest is the same in every process."""
        memo = self.__dict__.get("_fp_memo")
        if memo is not None:
            return memo
        opts = sorted(
            (k.lower(), str(v)) for k, v in self.options.items()
            if k.lower() not in self._FINGERPRINT_OPT_DENYLIST)
        parts = [
            "tbl:" + self.table,
            "sel:" + "|".join(str(e) for e in self.select),
            "als:" + "|".join(a or "" for a in self.aliases),
            "dst:" + str(self.distinct),
            "flt:" + (str(self.filter) if self.filter is not None else ""),
            "gby:" + "|".join(str(e) for e in self.group_by),
            "hav:" + (str(self.having) if self.having is not None else ""),
            "oby:" + "|".join(f"{e}/{'asc' if asc else 'desc'}"
                              for e, asc in self.order_by),
            "lim:" + str(self.limit),
            "off:" + str(self.offset),
            "opt:" + "|".join(f"{k}={v}" for k, v in opts),
        ]
        fp = hashlib.sha256("\n".join(parts).encode()).hexdigest()
        self._fp_memo = fp
        return fp

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


def merge_extra_filter(ctx: QueryContext,
                       extra_filter: Optional[str]) -> None:
    """AND an expression string (a hybrid table's time-boundary predicate)
    into ctx.filter, in place (JAX context.py:193): the server's execute
    and the warm-up replay both merge here, so a replayed plan has the
    logged fingerprint."""
    if not extra_filter:
        return
    extra = _Parser(tokenize(extra_filter)).expr()
    ctx.filter = extra if ctx.filter is None \
        else func("and", ctx.filter, extra)
    ctx.__dict__.pop("_fp_memo", None)
