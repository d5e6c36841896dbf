"""Segment warm-up: replay a table's recent plans on a fresh segment.

A trimmed copy of pinot_tpu/cache/warmup.py. The server logs each
aggregation or DISTINCT plan it runs, per table (`FingerprintLog`, in
memory, no journal). When a segment is added, `SegmentWarmup.warm` replays
the table's most recent plans against that segment alone as
`engine.prestage([segment], ctx)` under `engine.residency_seeding()`,
before the segment is published to queries: its columns enter the card's
resident rows with the warm-up's seed, and the first routed query pays the
kernel, not the upload. This is the branch the reference takes when its
result cache is off (:219-226); the tier-2 result cache is not ported.

Warm-up is best effort: a plan that fails is skipped (the segment only
starts cold for it), and the pass is bounded by `MAX_PLANS`.
"""
from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.query.context import QueryContext, merge_extra_filter

log = logging.getLogger(__name__)


def is_cacheable_shape(ctx: QueryContext) -> bool:
    """Aggregation, group-by and DISTINCT plans (JAX
    cache/segment_cache.py:63): selections are LIMIT-dependent per segment
    and not replayed."""
    return bool(ctx.aggregations) or ctx.distinct


#: plans logged per table, and the most replayed on one segment
MAX_PLANS_PER_TABLE = 64
MAX_PLANS = 32


class FingerprintLog:
    """Per-table bounded recency log: plan fingerprint -> (SQL, extra
    filter). Recording a logged fingerprint again refreshes its recency,
    so the replay set follows the current query mix."""

    def __init__(self):
        self._tables: Dict[str, "OrderedDict[str, tuple]"] = {}
        self._lock = threading.Lock()

    def record(self, table: str, fingerprint: str, sql: str,
               extra_filter: Optional[str] = None) -> None:
        with self._lock:
            plans = self._tables.setdefault(table, OrderedDict())
            if fingerprint in plans:
                plans.move_to_end(fingerprint)
            plans[fingerprint] = (sql, extra_filter)
            while len(plans) > MAX_PLANS_PER_TABLE:
                plans.popitem(last=False)

    def plans(self, table: str) -> List[Tuple[str, str, Optional[str]]]:
        """[(fingerprint, sql, extra_filter)], most recent last."""
        with self._lock:
            return [(fp, sql, extra) for fp, (sql, extra)
                    in self._tables.get(table, OrderedDict()).items()]


class SegmentWarmup:
    """The warm-up pass: a table's logged plans, prestaged on one
    segment."""

    def __init__(self, fingerprint_log: FingerprintLog, engine_fn):
        """engine_fn: zero-arg callable returning the server's shared
        engine, resolved at each warm-up."""
        self.log = fingerprint_log
        self._engine_fn = engine_fn
        #: segments that had at least one plan prestaged
        self.segments_prestaged = 0

    def warm(self, table: str, segment: Any) -> int:
        """Prestage the logged plans on `segment`; returns how many
        staged. Never raises."""
        plans = self.log.plans(table)
        if not plans:
            return 0
        engine = self._engine_fn()
        staged = 0
        # the most recent plans first: when the budget cuts, the mix the
        # dashboards refresh now is kept
        for fingerprint, sql, extra_filter in reversed(
                plans[-MAX_PLANS:]):
            try:
                ctx = QueryContext.from_sql(sql)
                merge_extra_filter(ctx, extra_filter)
                if not is_cacheable_shape(ctx):
                    continue
                with engine.residency_seeding():
                    if engine.prestage([segment], ctx):
                        staged += 1
            except Exception:  # noqa: BLE001 — warm-up never blocks a load
                log.debug("warm-up plan %s failed on %s", fingerprint,
                          getattr(segment, "name", "?"), exc_info=True)
        if staged:
            self.segments_prestaged += 1
        return staged
