"""Broker-side server failure detection with exponential-backoff retry.

A copy of pinot_tpu/broker/failure_detector.py.

Reference parity: pinot-broker
failuredetector/ConnectionFailureDetector.java (+ BaseExponentialBackoff
RetryFailureDetector) — servers that fail a query connection are marked
unhealthy and routing skips them; after an exponentially growing backoff
the server re-enters routing as a probe, and one success clears it.

Three evidence classes, in decreasing severity:

* **failures** (connection refused/reset) — the server may be dead:
  full exponential escalation up to ``max_backoff_s``.
* **timeouts** (deadline miss) — the server is slow, not dead: capped
  exponential with jitter, so repeated misses cool the replica
  progressively but a single miss costs one base interval, and
  same-instant marks from N gather threads don't re-probe in lockstep.
* **overloads** (typed 211 admission rejection) — the server is ALIVE
  and explicitly asking for less load: the lightest weight (half a
  timeout per mark, backoff ceiling a quarter of the timeout ceiling,
  the server's own retryAfterMs hint respected when longer), so a
  briefly-saturated replica re-enters routing long before a dead one.
  Overload marks additionally record an ``overloaded-until`` horizon
  the request handler reads to auto-disable hedging fleet-wide.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional, Set


class _Entry:
    __slots__ = ("failures", "retry_at", "slow", "overload_until")

    def __init__(self):
        self.failures = 0
        self.retry_at = 0.0
        #: slowness evidence: +1.0 per deadline miss, +0.5 per overload
        #: rejection — the exponent of the capped-exponential backoff
        self.slow = 0.0
        #: horizon until which this server is considered overloaded
        #: (hedging auto-disables while any server is past now here)
        self.overload_until = 0.0


class ConnectionFailureDetector:
    def __init__(self, base_backoff_s: float = 1.0,
                 max_backoff_s: float = 60.0,
                 jitter_seed: Optional[int] = None):
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        #: private PRNG: backoff jitter must not perturb (or depend on)
        #: the global random state; seedable so tests are exact
        self._rng = random.Random(jitter_seed)

    # ------------------------------------------------------------------
    def _entry_locked(self, server: str) -> _Entry:
        e = self._entries.get(server)
        if e is None:
            e = self._entries[server] = _Entry()
        return e

    def mark_failure(self, server: str) -> None:
        with self._lock:
            e = self._entry_locked(server)
            e.failures += 1
            backoff = min(self.base_backoff_s * (2 ** (e.failures - 1)),
                          self.max_backoff_s)
            e.retry_at = time.time() + backoff

    def mark_timeout(self, server: str) -> None:
        """A deadline miss is evidence of SLOWNESS, not death: capped
        exponential with jitter — one miss costs about one base
        interval, repeated misses escalate toward the ceiling, and the
        jitter factor (uniform [0.5, 1.0]) staggers re-probes so N
        queries that all expired on the same slow replica don't hammer
        it again in the same instant. No failure-count growth: a
        recovered server is one clean response from full health."""
        with self._lock:
            e = self._entry_locked(server)
            e.slow += 1.0
            backoff = min(self.base_backoff_s * (2 ** (e.slow - 1)),
                          self.max_backoff_s)
            backoff *= 0.5 + 0.5 * self._rng.random()
            e.retry_at = max(e.retry_at, time.time() + backoff)

    def mark_overload(self, server: str,
                      retry_after_s: Optional[float] = None) -> None:
        """A typed 211 admission rejection: the server is alive and
        shedding. Half the evidence weight of a timeout and a quarter
        of its backoff ceiling, so a briefly-saturated replica is never
        exiled as long as a dead one; the server's own retryAfterMs
        hint wins when it asks for longer."""
        with self._lock:
            e = self._entry_locked(server)
            e.slow += 0.5
            backoff = min(self.base_backoff_s * (2 ** (e.slow - 1)),
                          self.max_backoff_s / 4.0)
            backoff *= 0.5 + 0.5 * self._rng.random()
            if retry_after_s is not None:
                backoff = max(backoff, min(float(retry_after_s),
                                           self.max_backoff_s / 4.0))
            now = time.time()
            e.retry_at = max(e.retry_at, now + backoff)
            e.overload_until = max(e.overload_until, now + backoff)

    def mark_success(self, server: str) -> None:
        with self._lock:
            self._entries.pop(server, None)

    # ------------------------------------------------------------------
    def is_healthy(self, server: str, now: Optional[float] = None) -> bool:
        """True when routable: never failed, or its backoff expired (the
        next request is the re-probe; a failure re-doubles the backoff)."""
        now = time.time() if now is None else now
        with self._lock:
            e = self._entries.get(server)
            return e is None or now >= e.retry_at

    def unhealthy_servers(self, now: Optional[float] = None) -> Set[str]:
        now = time.time() if now is None else now
        with self._lock:
            return {s for s, e in self._entries.items() if now < e.retry_at}

    def overloaded_servers(self, now: Optional[float] = None) -> Set[str]:
        now = time.time() if now is None else now
        with self._lock:
            return {s for s, e in self._entries.items()
                    if now < e.overload_until}

    def any_overloaded(self, now: Optional[float] = None) -> bool:
        """True while any server's overload horizon is in the future —
        the hedging auto-disable signal: speculative duplicate load is
        exactly the wrong medicine for a fleet already shedding."""
        now = time.time() if now is None else now
        with self._lock:
            return any(now < e.overload_until
                       for e in self._entries.values())

    def failure_count(self, server: str) -> int:
        with self._lock:
            e = self._entries.get(server)
            return 0 if e is None else e.failures
