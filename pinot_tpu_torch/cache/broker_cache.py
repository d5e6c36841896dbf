"""Tier 1: the broker's whole-result cache, and its negative cache.

A copy of pinot_tpu/cache/broker_cache.py with the local backend only
(ref Druid's `useResultLevelCache`): the final merged response keyed by
(query fingerprint, logical table, routing epoch). The epoch hashes the
route's segment set and versions (broker/routing.py `RoutingTable.epoch`),
so a segment add, replace or remove, or a moved time boundary, changes
the key and old entries stop being addressable. A table with a realtime
side is not cached whole (consuming segments grow without a routing
change); its offline partial is. The `tiered` (remote) backend and the
brownout's stale serving wait for the cache fabric and the health plane;
asking for the former raises.
"""
from __future__ import annotations

import itertools
from typing import Optional

from pinot_tpu_torch.cache.core import (LruTtlCache, wire_dumps_response,
                                        wire_dumps_results,
                                        wire_loads_response,
                                        wire_loads_results_stats)
from pinot_tpu_torch.models import base_table_name
from pinot_tpu_torch.query.reduce import BrokerResponse

#: default per-instance metric label: several brokers in one process
#: share the 'broker' registry
_broker_ids = itertools.count(0)


class NegativeResultCache:
    """Memoized EMPTY answers of pruned-to-zero plans.

    A dashboard misfire whose partition pruning selects no segment has an
    empty answer by construction; its entries are sentinel bytes keyed by
    (fingerprint, table, routing epoch), so a plan that stops pruning to
    zero stops hitting. Always on and independent of the result cache:
    an empty memo can never serve stale data."""

    _SENTINEL = b"0"

    def __init__(self, max_bytes: int = 1 << 20, ttl_seconds: float = 60.0,
                 metrics=None, labels: Optional[dict] = None):
        self._cache = LruTtlCache(max_bytes, ttl_seconds, metrics=metrics,
                                  metric_prefix="negative_cache",
                                  labels=labels)

    @classmethod
    def from_config(cls, config, metrics=None,
                    labels: Optional[dict] = None) -> "NegativeResultCache":
        return cls(
            max_bytes=config.get_int("pinot.broker.negative.cache.bytes"),
            ttl_seconds=config.get_float(
                "pinot.broker.negative.cache.ttl.seconds"),
            metrics=metrics, labels=labels)

    def hit(self, fingerprint: str, table: str, epoch: str) -> bool:
        return self._cache.get((fingerprint, table, epoch)) is not None

    def put(self, fingerprint: str, table: str, epoch: str) -> bool:
        return self._cache.put((fingerprint, table, epoch), self._SENTINEL)

    def drop_table(self, table: str) -> int:
        """Drop every entry of `table` (logical or physical name)."""
        base = base_table_name(table)
        return self._cache.invalidate(
            lambda k: base_table_name(k[1]) == base)


class BrokerResultCache:
    """Whole BrokerResponses keyed by (fingerprint, table, routing
    epoch), and a hybrid table's offline partial keyed by the OFFLINE
    epoch (the query then re-scatters only to the realtime side)."""

    def __init__(self, max_bytes: int = 64 << 20, ttl_seconds: float = 60.0,
                 enabled: bool = True, metrics=None,
                 labels: Optional[dict] = None):
        """labels: metric labels ({'broker': id} by default when metrics
        are given): brokers in one process share the 'broker' registry."""
        self.enabled = enabled
        if metrics is not None and labels is None:
            labels = {"broker": f"b{next(_broker_ids)}"}
        #: shared with this broker's negative cache
        self.labels = labels
        self._cache = LruTtlCache(max_bytes, ttl_seconds, metrics=metrics,
                                  metric_prefix="result_cache",
                                  labels=labels)

    @classmethod
    def from_config(cls, config, metrics=None,
                    labels: Optional[dict] = None) -> "BrokerResultCache":
        backend = config.get_str("pinot.broker.result.cache.backend")
        if backend != "local":
            raise ValueError(
                f"pinot.broker.result.cache.backend={backend!r}: the port "
                "has the 'local' backend only; 'tiered' waits for the "
                "cache fabric")
        return cls(
            max_bytes=config.get_int("pinot.broker.result.cache.bytes"),
            ttl_seconds=config.get_float(
                "pinot.broker.result.cache.ttl.seconds"),
            enabled=config.get_bool("pinot.broker.result.cache.enabled"),
            metrics=metrics, labels=labels)

    def get(self, fingerprint: str, table: str,
            epoch: str) -> Optional[BrokerResponse]:
        if not self.enabled:
            return None
        payload = self._cache.get((fingerprint, table, epoch))
        return None if payload is None else wire_loads_response(payload)

    def put(self, fingerprint: str, table: str, epoch: str,
            resp: BrokerResponse) -> bool:
        """Only COMPLETE, clean responses: a partial answer must
        re-execute next time, not be replayed for a TTL."""
        if not self.enabled or resp.exceptions or resp.trace is not None \
                or resp.partial_result \
                or resp.num_servers_responded != resp.num_servers_queried:
            return False
        payload = wire_dumps_response(resp)
        if payload is None:
            return False
        return self._cache.put((fingerprint, table, epoch), payload)

    def get_offline_partial(self, fingerprint: str, table: str,
                            offline_epoch: str) -> Optional[tuple]:
        """(results, server-level ExecutionStats or None) of a hybrid
        query's offline side: realtime appends do not move its key."""
        if not self.enabled:
            return None
        payload = self._cache.get(("off", fingerprint, table, offline_epoch))
        return None if payload is None else wire_loads_results_stats(payload)

    def put_offline_partial(self, fingerprint: str, table: str,
                            offline_epoch: str, results: list,
                            stats=None) -> bool:
        if not self.enabled or not results:
            return False
        payload = wire_dumps_results(results, extra_stats=stats)
        if payload is None:
            return False
        return self._cache.put(("off", fingerprint, table, offline_epoch),
                               payload)
