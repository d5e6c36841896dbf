"""Time-series plan execution + the builtin 'simpleql' pipe language.

A copy of pinot_tpu/timeseries/engine.py (ref pinot-timeseries-planner
executing the SPI plan tree over the leaf engine, and
pinot-plugins/pinot-timeseries-lang/pinot-timeseries-m3ql's pipe syntax).
The builtin language:

    fetch(table, metric, time_col, start, end, step)
      [ | where(<sql predicate>) ]
      [ | groupby(tag1, tag2) ]
      [ | sum() | avg() | min() | max() ]        # cross-series, drop tags
      [ | sum(tag) ... ]                          # cross-series, keep tags
      [ | keep_last_value() | scale(x) | rate() ] # per-series transforms
      [ | gapfill(c) | interpolate() ]            # NaN-bucket fills

Leaf fetches ride the port's query engine: a SQL GROUP BY over the time
bucket and the tags, whose bucket the engine fuses into K2's key
(ops/timeseries_device.py). The port has no host executor, so a leaf the
engine refuses raises its NotOffloadable; it is not answered another way.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.timeseries import gapfill
from pinot_tpu_torch.timeseries.spi import (BaseTimeSeriesPlanNode,
                                            LeafTimeSeriesPlanNode,
                                            TimeBuckets, TimeSeries,
                                            TimeSeriesAggregationNode,
                                            TimeSeriesBlock,
                                            TimeSeriesTransformNode,
                                            register_language)
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.failpoints import fire


def execute_plan(node: BaseTimeSeriesPlanNode, executor) -> TimeSeriesBlock:
    """executor: a query executor with .execute(sql) (QueryExecutor or a
    broker handler) — the leaf bridge (ref LeafTimeSeriesPlanNode)."""
    if isinstance(node, LeafTimeSeriesPlanNode):
        return _execute_leaf(node, executor)
    if isinstance(node, TimeSeriesAggregationNode):
        return _aggregate(execute_plan(node.child, executor), node)
    if isinstance(node, TimeSeriesTransformNode):
        return _transform(execute_plan(node.child, executor), node)
    raise ValueError(f"unknown plan node {type(node).__name__}")


def _leaf_group_cap(executor) -> int:
    """The `pinot.timeseries.leaf.max.groups` knob: per-bucket group-row
    ceiling on one leaf fetch, from the executor's config when it carries
    one, else the catalog default."""
    cfg = getattr(executor, "config", None) or PinotConfiguration()
    return cfg.get_int("pinot.timeseries.leaf.max.groups")


def _execute_leaf(node: LeafTimeSeriesPlanNode, executor) -> TimeSeriesBlock:
    fire("timeseries.leaf.fetch", table=node.table)
    b = node.buckets
    bucket_expr = (f"floor(({node.time_column} - {b.start}) / {b.step})")
    tags = list(node.group_by_tags)
    select = [bucket_expr] + tags + [
        f"{node.value_agg}({node.metric_column})"]
    where = (f"{node.time_column} >= {b.start} AND "
             f"{node.time_column} < {b.end}")
    if node.filter_sql:
        where += f" AND ({node.filter_sql})"
    group = ", ".join([bucket_expr] + tags)
    limit = b.count * _leaf_group_cap(executor)
    # fetch limit+1 so exactly-limit results are distinguishable from
    # truncation
    sql = (f"SELECT {', '.join(select)} FROM {node.table} "
           f"WHERE {where} GROUP BY {group} "
           f"LIMIT {limit + 1}")
    resp = executor.execute(sql)
    if getattr(resp, "exceptions", None):
        raise RuntimeError(f"leaf query failed: {resp.exceptions}")
    rows = resp.result_table.rows if hasattr(resp, "result_table") and \
        resp.result_table is not None else resp.rows
    if len(rows) > limit:
        # silent truncation would make downstream sums wrong — fail loud
        raise RuntimeError(
            f"leaf fetch hit the {limit}-group cap (too many tag "
            f"combinations); narrow the filter or group by fewer tags")
    series: Dict[Tuple, TimeSeries] = {}
    for row in rows:
        bucket = int(row[0])
        if not 0 <= bucket < b.count:
            continue
        tag_vals = row[1:1 + len(tags)]
        val = float(row[1 + len(tags)])
        key = tuple(tag_vals)
        s = series.get(key)
        if s is None:
            s = series[key] = TimeSeries(
                tags=dict(zip(tags, tag_vals)),
                values=np.full(b.count, np.nan))
        s.values[bucket] = val
    return TimeSeriesBlock(b, list(series.values()))


def _aggregate(block: TimeSeriesBlock,
               node: TimeSeriesAggregationNode) -> TimeSeriesBlock:
    if not block.series:
        return TimeSeriesBlock(block.buckets, [])
    # one scatter-accumulate over the whole [series, buckets] stack
    # (timeseries/gapfill.py) instead of a vstack per group
    uniq: Dict[Tuple, int] = {}
    gids = np.empty(len(block.series), np.int64)
    for i, s in enumerate(block.series):
        key = tuple((t, s.tags.get(t)) for t in node.by_tags)
        gids[i] = uniq.setdefault(key, len(uniq))
    stacked = np.vstack([s.values for s in block.series])
    vals = gapfill.aggregate(stacked, gids, len(uniq), node.agg)
    out = [TimeSeries(tags=dict(key), values=vals[g])
           for key, g in uniq.items()]
    return TimeSeriesBlock(block.buckets, out)


def _transform(block: TimeSeriesBlock,
               node: TimeSeriesTransformNode) -> TimeSeriesBlock:
    if not block.series:
        return TimeSeriesBlock(block.buckets, [])
    # every transform is one vectorized pass over the stacked grid
    stacked = np.vstack([s.values for s in block.series])
    if node.fn == "keep_last_value":
        stacked = gapfill.keep_last_value(stacked)
    elif node.fn == "gapfill":
        stacked = gapfill.gapfill(
            stacked, node.arg if node.arg is not None else 0.0)
    elif node.fn == "interpolate":
        stacked = gapfill.interpolate(stacked)
    elif node.fn == "scale":
        stacked = stacked * (node.arg if node.arg is not None else 1.0)
    elif node.fn == "rate":
        # per-unit first derivative over the bucket step
        stacked = gapfill.rate(stacked, block.buckets.step)
    else:
        raise ValueError(f"unknown transform {node.fn!r}")
    out = [TimeSeries(tags=dict(s.tags), values=stacked[i])
           for i, s in enumerate(block.series)]
    return TimeSeriesBlock(block.buckets, out)


# ---------------------------------------------------------------------------
# builtin 'simpleql' pipe language (the m3ql-plugin analog)
# ---------------------------------------------------------------------------

_STAGE_NAME_RX = re.compile(r"(\w+)\s*\(")


def _split_top(text: str, sep: str) -> List[str]:
    """Split on `sep` only at paren depth 0 — a where() predicate like
    `host = 'a(1)' AND floor(x / 2) > 1` must stay one stage, and its
    function-call commas one argument (the old `[^)]*` regex stopped at
    the FIRST close paren and broke both)."""
    parts: List[str] = []
    depth = 0
    cur: List[str] = []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _parse_stage(raw: str) -> Tuple[str, str]:
    """(name, argstr) from `name( ... )` with balanced parens."""
    s = raw.strip()
    m = _STAGE_NAME_RX.match(s)
    if m is None or not s.endswith(")"):
        raise ValueError(f"bad simpleql stage {raw!r}")
    inner = s[m.end():-1]
    depth = 0
    for ch in inner:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                break
    if depth != 0:
        raise ValueError(f"unbalanced parens in simpleql stage {raw!r}")
    return m.group(1), inner


def _parse_simpleql(text: str, _ctx=None) -> BaseTimeSeriesPlanNode:
    stages = [s.strip() for s in _split_top(text, "|")]
    name, argstr = _parse_stage(stages[0])
    if name != "fetch":
        raise ValueError("simpleql must start with fetch(table, metric, "
                         "time_col, start, end, step)")
    args = [a.strip() for a in _split_top(argstr, ",")]
    if len(args) != 6:
        raise ValueError("fetch needs 6 arguments")
    table, metric, time_col = args[0], args[1], args[2]
    start, end, step = int(args[3]), int(args[4]), int(args[5])
    count = max((end - start) // step, 1)
    buckets = TimeBuckets(start, step, count)
    group_tags: Tuple[str, ...] = ()
    filter_sql: Optional[str] = None
    plan_stages = []
    for raw in stages[1:]:
        name, argstr = _parse_stage(raw)
        args = [a.strip() for a in _split_top(argstr, ",") if a.strip()]
        if name == "where":
            # the predicate rides verbatim into the leaf SQL — commas
            # and parens inside it are the SQL's business, not ours
            filter_sql = argstr.strip()
        elif name == "groupby":
            group_tags = tuple(args)
        else:
            plan_stages.append((name, args))
    node: BaseTimeSeriesPlanNode = LeafTimeSeriesPlanNode(
        table=table, metric_column=metric, time_column=time_col,
        buckets=buckets, group_by_tags=group_tags, filter_sql=filter_sql)
    for name, args in plan_stages:
        if name in ("sum", "avg", "min", "max"):
            node = TimeSeriesAggregationNode(node, agg=name,
                                             by_tags=tuple(args))
        elif name in ("keep_last_value", "rate", "interpolate"):
            node = TimeSeriesTransformNode(node, fn=name)
        elif name == "scale":
            node = TimeSeriesTransformNode(
                node, fn="scale", arg=float(args[0]) if args else 1.0)
        elif name == "gapfill":
            node = TimeSeriesTransformNode(
                node, fn="gapfill", arg=float(args[0]) if args else 0.0)
        else:
            raise ValueError(f"unknown simpleql stage {name!r}")
    return node


register_language("simpleql", _parse_simpleql)


def query(text: str, executor, language: str = "simpleql"
          ) -> TimeSeriesBlock:
    """Parse + execute a time-series query (the TSDB entry point, ref
    the time-series broker request handler)."""
    from pinot_tpu_torch.timeseries.spi import get_language
    planner = get_language(language)
    return execute_plan(planner(text, None), executor)
