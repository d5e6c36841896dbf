"""Deterministic failpoint (chaos) registry.

A trimmed copy of pinot_tpu/utils/failpoints.py: named sites compiled into
the code as ``fire("site.name", **ctx)``; an unarmed site costs one dict
lookup. A policy is armed per site with seeded, replayable behaviour:

  failpoints.arm("server.dispatch.before", delay=0.25, times=2)
  failpoints.arm(site, error=FailpointError("chaos"), probability=0.5,
                 seed=7)
  failpoints.arm(site, delay=0.1, where={"table": "t1"})
  failpoints.arm(site, delay=10.0,
                 until=lambda: metrics.gauge("dispatch_queue_depth") >= 7)

A delay with `until` is a bounded hold (not in the reference's
registry): it ends as soon as the predicate holds, at the latest after
`delay`. Every matched hit appends (fired, delay) to the policy's
``decisions``, so two runs with the same seed can be asserted
identical.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: how often a bounded hold polls its predicate
HOLD_POLL_S = 1e-3

#: the sites the port fires, with the reference catalog's contracts
SITES: Dict[str, str] = {
    "broker.scatter.before":
        "before the broker fans a plan entry out (ctx: server, table)",
    "broker.group.scatter":
        "before a scatter to a replica-group member (ctx: server, "
        "table, group index — arm with where={'group': 0} to kill one "
        "fault domain)",
    "broker.retry.budget":
        "broker-side, at every retry/hedge budget withdrawal (ctx: "
        "table) — arm with error=FailpointError() to force seeded "
        "budget exhaustion",
    "server.dispatch.before":
        "kernel dispatch (ring + inline paths)",
    "server.dispatch.batch":
        "per MEMBER inside the coalesced-batch path (ctx: table, mode, "
        "batch_size) — an erroring member fails only its own future; "
        "peers stay batched and complete",
    "server.mesh.collective":
        "server-side, before the collective-merge path stages a query "
        "(ctx: table, mode) — an armed error falls back to the host "
        "fold with mesh_merge_fallback{reason=chaos}",
    "timeseries.leaf.fetch":
        "time-series engine, before a leaf plan node issues its "
        "GROUP-BY SQL (ctx: table) — an armed error fails that panel's "
        "fetch whole, never a half-filled bucket grid",
}


class FailpointError(RuntimeError):
    """Default error of an armed policy."""


class Failpoint:
    """One armed policy: action, trigger discipline, decision log."""

    def __init__(self, site: str, delay: float = 0.0,
                 error: Optional[BaseException] = None,
                 times: Optional[int] = None, probability: float = 1.0,
                 seed: int = 0, where: Optional[Dict[str, Any]] = None,
                 until: Optional[Callable[[], bool]] = None):
        self.site = site
        self.delay = float(delay)
        self.until = until
        self.error = error
        self.times = times
        self.probability = float(probability)
        self.where = dict(where or {})
        # private seeded PRNG: decision N depends only on (seed, N)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.decisions: List[Tuple[bool, float]] = []
        self.hits = 0
        self.fired = 0

    def apply(self, ctx: Dict[str, Any]) -> None:
        with self._lock:
            if not all(ctx.get(k) == v for k, v in self.where.items()):
                return
            self.hits += 1
            if self.times is not None and self.fired >= self.times:
                self.decisions.append((False, 0.0))
                return
            # the PRNG advances once per matched hit, fired or not
            if self._rng.random() >= self.probability:
                self.decisions.append((False, 0.0))
                return
            self.fired += 1
            wait = self.delay
            self.decisions.append((True, wait))
        if wait and self.until is None:
            time.sleep(wait)
        elif wait:
            deadline = time.monotonic() + wait
            while not self.until() and time.monotonic() < deadline:
                time.sleep(HOLD_POLL_S)
        if self.error is not None:
            raise self.error


class FailpointRegistry:
    """Process-wide site registry: a site fires wherever the code runs."""

    def __init__(self):
        self._sites: Dict[str, List[Failpoint]] = {}
        self._lock = threading.Lock()

    def arm(self, site: str, **kwargs) -> Failpoint:
        fp = Failpoint(site, **kwargs)
        with self._lock:
            self._sites.setdefault(site, []).append(fp)
        return fp

    def disarm(self, site: str) -> None:
        with self._lock:
            self._sites.pop(site, None)

    def clear(self) -> None:
        with self._lock:
            self._sites.clear()

    def armed(self, site: str, **kwargs) -> "_Armed":
        """``with failpoints.armed(site, delay=1): ...``"""
        return _Armed(self, site, kwargs)

    def hit(self, site: str, **ctx) -> None:
        # unarmed cost: one dict lookup; arm/disarm replace the list
        # under the lock and the copy below tolerates a concurrent disarm
        fps = self._sites.get(site)
        if not fps:
            return
        for fp in list(fps):
            fp.apply(ctx)


class _Armed:
    def __init__(self, registry: FailpointRegistry, site: str, kwargs: dict):
        self._registry = registry
        self._site = site
        self._kwargs = kwargs
        self.failpoint: Optional[Failpoint] = None

    def __enter__(self) -> Failpoint:
        self.failpoint = self._registry.arm(self._site, **self._kwargs)
        return self.failpoint

    def __exit__(self, *exc) -> None:
        with self._registry._lock:
            fps = self._registry._sites.get(self._site)
            if fps and self.failpoint in fps:
                fps.remove(self.failpoint)
                if not fps:
                    del self._registry._sites[self._site]


class FaultSchedule:
    """(site, policy-kwargs) entries armed and disarmed together: the
    `MiniCluster(chaos=...)` payload."""

    def __init__(self, entries: List[Tuple[str, Dict[str, Any]]]):
        self.entries = list(entries)
        self.failpoints: List[Failpoint] = []

    def arm(self) -> None:
        self.failpoints = [failpoints.arm(site, **kwargs)
                           for site, kwargs in self.entries]

    def disarm(self) -> None:
        with failpoints._lock:
            for fp in self.failpoints:
                fps = failpoints._sites.get(fp.site)
                if fps and fp in fps:
                    fps.remove(fp)
                    if not fps:
                        del failpoints._sites[fp.site]
        self.failpoints = []


failpoints = FailpointRegistry()
fire = failpoints.hit
