"""Per-role trace retention, the in-flight query registry, the slow-query
log and the /debug payloads.

A copy of pinot_tpu/utils/trace_store.py without the health routes and
the standalone debug HTTP server (the port has no health plane):

* `TraceStore`: a bounded ring of finished trace trees per role.
  `trace=true` traces and tail-captured slow queries land here;
  `/debug/traces` lists them, `/debug/traces/<id>` returns one.
* `InflightRegistry`: the queries executing now on a role, with elapsed
  time, phase (parse / route / scatter / gather / reduce on the broker,
  execute on a server), tenant and remaining deadline; `/debug/queries`.
* `log_slow_query`: one JSON log line per query over the threshold, its
  trace id included.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

slow_log = logging.getLogger("pinot_tpu_torch.slowquery")

DEFAULT_CAPACITY = 256


class TraceStore:
    """Bounded FIFO of finished traces for one role (newest kept)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def record(self, trace_id: str, tree: dict, *, sql: str = "",
               duration_ms: float = 0.0, slow: bool = False,
               extra: Optional[dict] = None) -> None:
        entry = {"traceId": trace_id, "sql": sql,
                 "durationMs": round(float(duration_ms), 3),
                 "slow": bool(slow), "storedAt": time.time(),
                 "trace": tree}
        if extra:
            entry.update(extra)
        with self._lock:
            # a re-record replaces, never duplicates
            self._traces[trace_id] = entry
            self._traces.move_to_end(trace_id)
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            hit = self._traces.get(trace_id)
            if hit is not None:
                return hit
            # servers sharing a process store under "<traceId>@<instance>"
            # so they do not overwrite each other: scan the recorded id
            for e in reversed(self._traces.values()):
                if e.get("traceId") == trace_id:
                    return e
            return None

    def recent(self, limit: int = 50) -> List[dict]:
        """Newest first, without the trees (fetch one by id for it)."""
        with self._lock:
            items = list(self._traces.values())[-max(1, int(limit)):]
        return [{k: v for k, v in e.items() if k != "trace"}
                for e in reversed(items)]


class InflightRegistry:
    """Queries executing now on one role, with their current phase."""

    def __init__(self):
        self._entries: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def begin(self, key: str, *, sql: str = "", trace_id: str = "",
              detail: str = "", tenant: Optional[str] = None,
              deadline: Optional[float] = None) -> None:
        """deadline: absolute, in the time.time() domain."""
        with self._lock:
            self._entries[key] = {
                "queryId": key, "sql": sql, "traceId": trace_id,
                "startedAt": time.time(), "phase": "started",
                "detail": detail, "tenant": tenant, "deadline": deadline}

    def phase(self, key: str, phase: str, detail: str = "") -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e["phase"] = phase
                if detail:
                    e["detail"] = detail

    def annotate(self, key: str, *, tenant: Optional[str] = None,
                 deadline: Optional[float] = None) -> None:
        """The broker learns tenant and deadline after parse and route."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if tenant is not None:
                    e["tenant"] = tenant
                if deadline is not None:
                    e["deadline"] = deadline

    def end(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def snapshot(self) -> List[dict]:
        now = time.time()
        with self._lock:
            entries = [dict(e) for e in self._entries.values()]
        for e in entries:
            e["elapsedMs"] = round((now - e.pop("startedAt")) * 1000.0, 3)
            deadline = e.pop("deadline", None)
            e["remainingDeadlineMs"] = (
                round((deadline - now) * 1000.0, 3)
                if deadline is not None else None)
        entries.sort(key=lambda e: -e["elapsedMs"])
        return entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_stores: Dict[str, TraceStore] = {}
_inflight: Dict[str, InflightRegistry] = {}
_lock = threading.Lock()


def get_store(role: str = "server",
              capacity: Optional[int] = None) -> TraceStore:
    with _lock:
        s = _stores.get(role)
        if s is None:
            s = _stores[role] = TraceStore(capacity or DEFAULT_CAPACITY)
        elif capacity is not None:
            s.capacity = max(1, int(capacity))
        return s


def get_inflight(role: str = "server") -> InflightRegistry:
    with _lock:
        r = _inflight.get(role)
        if r is None:
            r = _inflight[role] = InflightRegistry()
        return r


def log_slow_query(role: str, trace_id: str, sql: str, duration_ms: float,
                   threshold_ms: float, **extra) -> None:
    """One JSON line per slow query, its trace id linking to the tree."""
    payload = {"role": role, "traceId": trace_id, "sql": sql,
               "durationMs": round(float(duration_ms), 3),
               "thresholdMs": round(float(threshold_ms), 3), **extra}
    slow_log.warning("SLOW_QUERY %s", json.dumps(payload, default=str))


def debug_payload(role: str, path: str) -> Optional[Any]:
    """The JSON payload of a /debug route, or None for another path."""
    if path == "/debug/traces":
        return {"role": role, "traces": get_store(role).recent()}
    if path.startswith("/debug/traces/"):
        tid = path[len("/debug/traces/"):]
        entry = get_store(role).get(tid)
        return entry if entry is not None \
            else {"error": f"no trace {tid}", "role": role}
    if path == "/debug/queries":
        return {"role": role, "queries": get_inflight(role).snapshot()}
    return None
