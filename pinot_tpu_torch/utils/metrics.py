"""Meters, gauges and timers with labels: a trimmed copy of
pinot_tpu/utils/metrics.py's `MetricsRegistry`, with its exemplars (a
timer's last trace id) and its Prometheus text exposition, which the
broker's `/metrics` serves.

The dispatch ring writes `dispatch_batch_size` (a timer whose values are
batch sizes: its `max_ms` is the largest batch), the meters
`dispatch_batch_cross_table`, `dispatch_batch_dedup`, `kernel_retrace`
and `kernel_retrace_by_plan`, the timer `staging_overlap_ms` and the
gauge `dispatch_queue_depth`. The engine's staging levels write the meters
`hbm_block_hit` / `hbm_block_miss` (assembled blocks; a miss is one K6
launch), `host_row_hit` / `host_row_miss`, `hbm_transfer_bytes` (column
bytes uploaded), and the resident tier `hbm_resident_hit` /
`hbm_resident_miss`, `hbm_admission_rejected` and `hbm_evicted`, and
the gauges `hbm_cache_bytes` (assembled blocks and resident rows on the
card) and `host_row_cache_bytes` (host rows). The server's executor
writes the meter `host_fallback{reason}`: batches the engine refused and
the host executor answered. The broker writes the meters
`broker_queries`, `broker_query_errors`, `broker_error_code_250`,
`broker_retries_issued`, `hedge_issued` / `hedge_won` / `hedge_wasted`,
`deadline_expired`, `slow_queries` and the cache tiers' hits and misses,
and the timer `broker_query_ms` with the trace id as its exemplar.
"""
from __future__ import annotations

import math
import random
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Optional[Dict[str, str]]) -> _Key:
    return (name, tuple(sorted((labels or {}).items())))


class Timer:
    """count / sum / max, and a fixed-size reservoir of samples
    (Vitter's algorithm R)."""

    RESERVOIR_SIZE = 256

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self._reservoir: List[float] = []
        self._rng = random.Random(0x5EED)

    def update(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)
        if len(self._reservoir) < self.RESERVOIR_SIZE:
            self._reservoir.append(ms)
        else:
            j = self._rng.randrange(self.count)
            if j < self.RESERVOIR_SIZE:
                self._reservoir[j] = ms

    def snapshot(self) -> "Timer":
        t = Timer()
        t.count, t.total_ms, t.max_ms = self.count, self.total_ms, \
            self.max_ms
        t._reservoir = list(self._reservoir)
        return t

    def quantile(self, q: float) -> float:
        """The reservoir's empirical quantile (0 before any sample)."""
        if not self._reservoir:
            return 0.0
        s = sorted(self._reservoir)
        return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


class MetricsRegistry:
    """Thread-safe meters (counters), gauges and timers."""

    def __init__(self, role: str = "server"):
        self.role = role
        self._meters: Dict[_Key, float] = defaultdict(float)
        self._gauges: Dict[_Key, float] = {}
        self._timers: Dict[_Key, Timer] = defaultdict(Timer)
        #: a timer's last trace id: links a /metrics tail to the trace
        #: kept at /debug/traces/<id>
        self._exemplars: Dict[_Key, str] = {}
        self._lock = threading.Lock()

    def add_meter(self, name: str, value: float = 1,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._meters[_key(name, labels)] += value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def add_timing(self, name: str, ms: float,
                   labels: Optional[Dict[str, str]] = None,
                   exemplar: Optional[str] = None) -> None:
        with self._lock:
            k = _key(name, labels)
            self._timers[k].update(ms)
            if exemplar:
                self._exemplars[k] = exemplar

    def set_exemplar(self, name: str,
                     labels: Optional[Dict[str, str]] = None,
                     trace_id: str = "") -> None:
        """Stamp a timer's exemplar where the timing is written apart."""
        if trace_id:
            with self._lock:
                self._exemplars[_key(name, labels)] = trace_id

    def exemplar(self, name: str,
                 labels: Optional[Dict[str, str]] = None) -> Optional[str]:
        with self._lock:
            return self._exemplars.get(_key(name, labels))

    def meter(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._meters.get(_key(name, labels), 0.0)

    def meter_total(self, name: str) -> float:
        """A meter summed over all its label sets."""
        with self._lock:
            return sum(v for (n, _l), v in self._meters.items() if n == name)

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def timer(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Timer:
        """A detached copy of the timer (empty if never written)."""
        with self._lock:
            t = self._timers.get(_key(name, labels))
            return t.snapshot() if t is not None else Timer()

    def prometheus_text(self) -> str:
        """The Prometheus exposition: one `# TYPE` line a family, a
        timer as p50 / p95 / p99 with _count, _sum_ms and _max_ms, its
        exemplar as a comment line."""
        out: List[str] = []
        prefix = f"pinot_tpu_{self.role}_"
        typed: set = set()

        def type_line(base: str, kind: str) -> None:
            if base not in typed:
                typed.add(base)
                out.append(f"# TYPE {base} {kind}")

        with self._lock:
            for (name, labels), v in sorted(self._meters.items()):
                type_line(prefix + name, "counter")
                out.append(f"{prefix}{name}{_fmt(labels)} {v:g}")
            for (name, labels), v in sorted(self._gauges.items()):
                type_line(prefix + name, "gauge")
                out.append(f"{prefix}{name}{_fmt(labels)} {v:g}")
            for (name, labels), t in sorted(self._timers.items()):
                base = prefix + name
                type_line(base, "summary")
                for q in (0.5, 0.95, 0.99):
                    ql = labels + (("quantile", f"{q:g}"),)
                    out.append(f"{base}{_fmt(ql)} {t.quantile(q):g}")
                out.append(f"{base}_count{_fmt(labels)} {t.count}")
                out.append(f"{base}_sum_ms{_fmt(labels)} {t.total_ms:g}")
                out.append(f"{base}_max_ms{_fmt(labels)} {t.max_ms:g}")
                ex = self._exemplars.get((name, labels))
                if ex:
                    out.append(f"# EXEMPLAR {base}{_fmt(labels)} "
                               f'trace_id="{_escape(ex)}"')
        return "\n".join(out) + "\n"


def _escape(v: str) -> str:
    """A label value escaped as the exposition format wants."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in labels) + "}"


_registries: Dict[str, MetricsRegistry] = {}
_registries_lock = threading.Lock()


def get_registry(role: str = "server") -> MetricsRegistry:
    """The process's registry of a role: one server's meters are read
    across its engines, as the reference's role registries are."""
    with _registries_lock:
        reg = _registries.get(role)
        if reg is None:
            reg = _registries[role] = MetricsRegistry(role)
        return reg
