"""Instance configuration: catalog defaults under explicit overrides.

A trimmed copy of pinot_tpu/utils/config.py's `PinotConfiguration`
holding only the keys the port reads, with the reference's names and
defaults (pinot_tpu/utils/config.py:28-86). An override passed to
the constructor wins over the catalog default (KEYS below).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

#: every key the port reads, with its default
KEYS: Dict[str, Any] = {
    # concurrent-query dispatch (ops/dispatch.py): 'pipelined' = the
    # dispatch ring + micro-batching + staging/compute overlap;
    # 'serialized' = inline dispatch on the caller's thread (the A/B
    # baseline)
    "pinot.server.dispatch.mode": "pipelined",
    # coalescing: fingerprint-equal concurrent queries merge into one
    # launch, at most batch.max members
    "pinot.server.dispatch.batch.max": 16,
    # shape-bucket coalescing across tables: launches coalesce on (plan,
    # padded S, D, G, staged-array signature); off = the same segment
    # batch only
    "pinot.server.dispatch.batch.cross.table": True,
    # star-tree leg (ops/startree_device.py): fitted aggregations answer
    # from pre-aggregated records; .hbm.resident admits the pre-agg
    # pseudo-columns into the resident-row tier
    "pinot.server.startree.enabled": True,
    "pinot.server.startree.hbm.resident": True,
    # vector-similarity leg (ops/vector_device.py): vector_similarity
    # selections on K8; .hbm.resident admits the __vec__ pseudo-columns
    # into the resident-row tier
    "pinot.server.vector.enabled": True,
    "pinot.server.vector.hbm.resident": True,
    # the per-(segment, column) resident-row tier (ops/residency.py): its
    # switch, its byte budget, TinyLFU admission and its sample window
    "pinot.server.hbm.resident.enabled": True,
    "pinot.server.hbm.resident.bytes": 6 << 30,
    "pinot.server.hbm.admission.enabled": True,
    "pinot.server.hbm.admission.sample": 4096,
    # collective merge on a mesh engine (ops/collective.py): fold a segment
    # batch's partials into one row on the device; off = the per-segment
    # sharded launch and the host fold
    "pinot.server.mesh.collective.merge": True,
    # time-series device leg (ops/timeseries_device.py): fuse
    # floor((t-start)/step) into the group-by kernel's key
    "pinot.server.timeseries.bucket.enabled": True,
    # the server (server/query_server.py): grace added to a broker's
    # remaining budget before the local deadline cancels the query
    "pinot.server.query.deadline.grace.ms": 50,
    # the broker (broker/request_handler.py): the end-to-end budget
    # (OPTION(timeoutMs=...) > pinot.broker.timeout.ms.<table> > this);
    # servers get what remains at send time
    "pinot.broker.timeout.ms": 60000,
    # hedged scatter: past delay.min (capped at delay.max), a pending plan
    # entry goes to another healthy replica too and the first clean
    # answer wins
    "pinot.broker.hedge.enabled": False,
    "pinot.broker.hedge.delay.min.ms": 25,
    "pinot.broker.hedge.delay.max.ms": 1000,
    # the per-table retry budget (broker/adaptive.py RetryBudget): a
    # clean primary answer deposits .ratio, a retry or hedge spends one
    "pinot.broker.retry.budget.ratio": 0.2,
    "pinot.broker.retry.budget.min": 3.0,
    "pinot.broker.retry.budget.cap": 10.0,
    # the negative cache: pruned-to-zero plans, keyed by the epoch
    "pinot.broker.negative.cache.bytes": 1 << 20,
    "pinot.broker.negative.cache.ttl.seconds": 60.0,
    # the tier-1 whole-result cache (opt-in; with it, a hybrid table's
    # offline partial too); .backend 'local' is the only one the port has
    "pinot.broker.result.cache.enabled": False,
    "pinot.broker.result.cache.bytes": 64 << 20,
    "pinot.broker.result.cache.ttl.seconds": 60.0,
    "pinot.broker.result.cache.backend": "local",
    # tracing (utils/tracing.py, utils/trace_store.py): the store's
    # capacity a role; a query at or over a threshold keeps its tree and
    # logs a slow-query line (0 = off)
    "pinot.trace.store.capacity": 256,
    "pinot.broker.slow.query.threshold.ms": 10000.0,
    "pinot.server.slow.query.threshold.ms": 0.0,
    # time-series leaf fetch cap: a leaf SQL may return at most
    # count * this many group rows before the engine fails loud
    # (silent truncation would corrupt downstream sums)
    "pinot.timeseries.leaf.max.groups": 10_000,
}


class PinotConfiguration:
    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._overrides = dict(overrides or {})

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._overrides:
            return self._overrides[key]
        return KEYS.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self.get(key, default))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def get_str(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))

    def with_overrides(self, extra: Dict[str, Any]) -> "PinotConfiguration":
        """A derived configuration, `extra` winning over these overrides."""
        return PinotConfiguration({**self._overrides, **extra})
