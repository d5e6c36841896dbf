"""Time-series SPI: buckets, blocks, plan nodes, language registry.

A copy of pinot_tpu/timeseries/spi.py (ref pinot-timeseries-spi tsdb/spi/:
TimeBuckets, TimeSeries / TimeSeriesBlock, the BaseTimeSeriesPlanNode tree,
and TimeSeriesLogicalPlanner, one per query language resolved by name). The
port has no plugin registry: languages register in a module-level table.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TimeBuckets:
    """Aligned bucket grid [start, start+step, ...) (ref TimeBuckets)."""
    start: int          # inclusive, seconds (or any integral unit)
    step: int           # bucket width
    count: int

    @property
    def end(self) -> int:
        return self.start + self.step * self.count


@dataclass
class TimeSeries:
    """One tag combination's values over the buckets (NaN = no data)."""
    tags: Dict[str, Any]
    values: np.ndarray  # float64 [buckets.count]

    def tag_key(self) -> Tuple:
        return tuple(sorted(self.tags.items()))


@dataclass
class TimeSeriesBlock:
    """Ref TimeSeriesBlock: buckets + the series that survived the plan."""
    buckets: TimeBuckets
    series: List[TimeSeries] = field(default_factory=list)


# ---------------------------------------------------------------------------
# plan nodes (ref BaseTimeSeriesPlanNode subclasses)
# ---------------------------------------------------------------------------

class BaseTimeSeriesPlanNode:
    children: Sequence["BaseTimeSeriesPlanNode"] = ()


@dataclass
class LeafTimeSeriesPlanNode(BaseTimeSeriesPlanNode):
    """Fetch: table scan -> bucketized series per tag combination (ref
    LeafTimeSeriesPlanNode bridging to the leaf query engine)."""
    table: str
    metric_column: str
    time_column: str
    buckets: TimeBuckets
    #: per-bucket accumulation within one series: sum|avg|min|max|count
    value_agg: str = "sum"
    group_by_tags: Tuple[str, ...] = ()
    filter_sql: Optional[str] = None
    children = ()


@dataclass
class TimeSeriesAggregationNode(BaseTimeSeriesPlanNode):
    """Cross-series aggregation, keeping only `by_tags` (ref m3ql's
    sum/avg by): sum|avg|min|max over series sharing the kept tags."""
    child: BaseTimeSeriesPlanNode
    agg: str = "sum"
    by_tags: Tuple[str, ...] = ()

    @property
    def children(self):
        return (self.child,)


@dataclass
class TimeSeriesTransformNode(BaseTimeSeriesPlanNode):
    """Per-series value transform (keepLastValue, scale, rate...)."""
    child: BaseTimeSeriesPlanNode
    fn: str = "keep_last_value"
    arg: Optional[float] = None

    @property
    def children(self):
        return (self.child,)


# ---------------------------------------------------------------------------
# language registry (ref TimeSeriesLogicalPlanner per language)
# ---------------------------------------------------------------------------

_LANGUAGES: Dict[str, Callable[[str, Any], BaseTimeSeriesPlanNode]] = {}


def register_language(name: str,
                      planner: Callable[[str, Any], BaseTimeSeriesPlanNode]
                      ) -> None:
    """planner(query_text, context) -> plan tree."""
    _LANGUAGES[name] = planner


def get_language(name: str):
    planner = _LANGUAGES.get(name)
    if planner is None:
        raise KeyError(f"no time-series language {name!r}")
    return planner
