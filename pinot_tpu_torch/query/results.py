"""Per-segment intermediate result containers of the device slice.

Counterpart of pinot_tpu/query/results.py (ref pinot-core operator result
blocks AggregationResultsBlock / GroupByResultsBlock /
SelectionResultsBlock / DistinctResultsBlock).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ExecutionStats:
    """Ref core/operator/ExecutionStatistics.java + DataTable metadata."""
    num_docs_scanned: int = 0
    num_entries_scanned_in_filter: int = 0
    num_entries_scanned_post_filter: int = 0
    num_segments_processed: int = 0
    num_segments_matched: int = 0
    total_docs: int = 0
    #: segments the server's pruner dropped (query/pruner.py)
    num_segments_pruned: int = 0

    def merge(self, o: "ExecutionStats") -> None:
        self.num_docs_scanned += o.num_docs_scanned
        self.num_entries_scanned_in_filter += o.num_entries_scanned_in_filter
        self.num_entries_scanned_post_filter += \
            o.num_entries_scanned_post_filter
        self.num_segments_processed += o.num_segments_processed
        self.num_segments_matched += o.num_segments_matched
        self.total_docs += o.total_docs
        self.num_segments_pruned += o.num_segments_pruned


@dataclass
class AggregationResult:
    """One intermediate per aggregation function."""
    intermediates: List[Any]
    stats: ExecutionStats = field(default_factory=ExecutionStats)


@dataclass
class GroupByResult:
    """group-key tuple (raw values) -> list of intermediates."""
    groups: Dict[Tuple, List[Any]]
    stats: ExecutionStats = field(default_factory=ExecutionStats)
    #: the host executor stopped at numGroupsLimit groups
    num_groups_limit_reached: bool = False


@dataclass
class SelectionResult:
    """Projected rows; order_values present when pre-sorted server-side."""
    rows: List[Tuple]
    order_values: Optional[List[Tuple]] = None
    columns: Optional[List[str]] = None  # star-expanded column names
    stats: ExecutionStats = field(default_factory=ExecutionStats)


@dataclass
class DistinctResult:
    rows: set
    stats: ExecutionStats = field(default_factory=ExecutionStats)
