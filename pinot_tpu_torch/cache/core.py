"""Shared cache mechanics: LRU + TTL + byte budget over byte payloads.

A copy of pinot_tpu/cache/core.py's local tier. Entries are encoded
payloads, never live objects: reduce mutates result containers in place,
so a shared object would let one query's merge corrupt the next query's
cached answer, and an encoded payload gives an honest byte count. The
port encodes with the typed DataTable codec (server/datatable.py), the
JAX package's wire helpers, not pickle: decoding never runs
payload-controlled code and an undecodable entry is a miss.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Hashable, Optional, Tuple

from pinot_tpu_torch.utils import errorcodes


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    expirations: int = 0
    invalidations: int = 0


class LruTtlCache:
    """Thread-safe LRU over byte payloads with a TTL and a byte budget.

    Keys are arbitrary hashables; values are bytes. Eviction order is
    least-recently-USED (get refreshes recency). A payload larger than
    the whole budget is refused rather than evicting everything else.
    """

    def __init__(self, max_bytes: int, ttl_seconds: float,
                 metrics=None, metric_prefix: str = "cache",
                 labels: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_bytes = int(max_bytes)
        self.ttl_seconds = float(ttl_seconds)
        self.stats = CacheStats()
        self._entries: "OrderedDict[Hashable, Tuple[float, bytes]]" = \
            OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._clock = clock
        #: optional MetricsRegistry; hit/miss/eviction meters + byte gauge
        self._metrics = metrics
        self._metric_prefix = metric_prefix
        self._labels = labels

    def _meter(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics.add_meter(f"{self._metric_prefix}_{name}",
                                    labels=self._labels)

    def _gauge_bytes(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge(f"{self._metric_prefix}_bytes",
                                    self._bytes, labels=self._labels)
            self._metrics.set_gauge(f"{self._metric_prefix}_entries",
                                    len(self._entries), labels=self._labels)

    def get(self, key: Hashable) -> Optional[bytes]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                self._meter("misses")
                return None
            expires_at, payload = entry
            if self._clock() >= expires_at:
                del self._entries[key]
                self._bytes -= len(payload)
                self.stats.expirations += 1
                self.stats.misses += 1
                self._meter("misses")
                self._gauge_bytes()
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            self._meter("hits")
            return payload

    def put(self, key: Hashable, payload: bytes) -> bool:
        n = len(payload)
        if n > self.max_bytes:
            return False  # would evict the entire cache for one entry
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[1])
            self._entries[key] = (self._clock() + self.ttl_seconds, payload)
            self._bytes += n
            self.stats.puts += 1
            while self._bytes > self.max_bytes:
                _, (_, evicted) = self._entries.popitem(last=False)
                self._bytes -= len(evicted)
                self.stats.evictions += 1
                self._meter("evictions")
            self._gauge_bytes()
        return True

    def invalidate(self, predicate: Callable[[Hashable], bool]) -> int:
        """Drop every entry whose key matches; returns the count."""
        with self._lock:
            doomed = [k for k in self._entries if predicate(k)]
            for k in doomed:
                _, payload = self._entries.pop(k)
                self._bytes -= len(payload)
            self.stats.invalidations += len(doomed)
            self._gauge_bytes()
            return len(doomed)

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: query options that steer the cache itself (never part of the result)
OPT_SKIP_CACHE = "skipcache"
OPT_USE_CACHE = "usecache"


def cache_bypassed(options: dict) -> bool:
    """True when the query opts out via skipCache=true / useCache=false."""
    opts = {k.lower(): str(v).lower() for k, v in options.items()}
    return (opts.get(OPT_SKIP_CACHE) == "true"
            or opts.get(OPT_USE_CACHE) == "false")


# -- the typed codec (JAX cache/core.py:243-320) ----------------------------

#: payload discriminator tags (first byte of a payload)
_WIRE_RESULTS = b"R"   # list of shape-tagged segment/partial results
_WIRE_RESPONSE = b"B"  # one whole BrokerResponse


def wire_dumps_results(results: list, extra_stats=None) -> Optional[bytes]:
    """A list of per-segment results (and server-level stats beside
    them); None when an element has no tag (the caller skips caching)."""
    from pinot_tpu_torch.server import datatable
    try:
        return _WIRE_RESULTS + datatable.serialize_results(
            list(results), extra_stats=extra_stats)
    except Exception:  # noqa: BLE001 — "don't cache", never "fail query"
        return None


def wire_loads_results_stats(payload: bytes) -> Optional[tuple]:
    """(results, extra ExecutionStats or None), None on any failure."""
    from pinot_tpu_torch.server import datatable
    try:
        if not payload or payload[:1] != _WIRE_RESULTS:
            return None
        results, exceptions, stats, _tree = \
            datatable.deserialize_results_ex(payload[1:])
        if exceptions:
            return None
        return results, stats
    except Exception:  # noqa: BLE001 — undecodable entry == miss
        return None


def wire_dumps_response(resp: Any) -> Optional[bytes]:
    """A complete, trace-less BrokerResponse (the cache refuses any
    other before calling this)."""
    from pinot_tpu_torch.server import datatable
    try:
        rt = resp.result_table
        table = (None if rt is None
                 else (list(rt.columns), list(rt.column_types),
                       [tuple(r) for r in rt.rows]))
        blob = (
            table,
            [(int(e.get("errorCode", errorcodes.QUERY_EXECUTION)),
              str(e.get("message", "")))
             for e in resp.exceptions],
            datatable._stats_tuple(resp.stats),
            int(resp.num_servers_queried),
            int(resp.num_servers_responded),
            bool(resp.num_groups_limit_reached),
        )
        return _WIRE_RESPONSE + datatable.serialize_value(blob)
    except Exception:  # noqa: BLE001
        return None


def wire_loads_response(payload: bytes) -> Optional[Any]:
    from pinot_tpu_torch.query.reduce import BrokerResponse, ResultTable
    from pinot_tpu_torch.query.results import ExecutionStats
    from pinot_tpu_torch.server import datatable
    try:
        if not payload or payload[:1] != _WIRE_RESPONSE:
            return None
        table, exc, stats, queried, responded, groups_limit = \
            datatable.deserialize_value(payload[1:])
        resp = BrokerResponse()
        if table is not None:
            cols, types, rows = table
            resp.result_table = ResultTable(list(cols), list(types),
                                            [tuple(r) for r in rows])
        resp.exceptions = [{"errorCode": c, "message": m} for c, m in exc]
        resp.stats = ExecutionStats(*stats)
        resp.num_servers_queried = queried
        resp.num_servers_responded = responded
        resp.num_groups_limit_reached = groups_limit
        return resp
    except Exception:  # noqa: BLE001 — undecodable entry == miss
        return None
