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

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def get_str(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))
