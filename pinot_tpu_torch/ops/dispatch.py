"""KernelDispatcher: the engine's pipelined device-launch stage.

Port of pinot_tpu/ops/dispatch.py (`KernelDispatcher` :311, `Launch` :247,
`wait_result` :157, `split_packed` :197, `split_charge` :220):

  * dispatch ring: a dispatch thread and a bounded queue. Callers enqueue
    STAGED launches (blocks on the card, parameters resolved) and get
    futures. A lone query (no other caller active, nothing queued or in
    flight) dispatches inline on its own thread and pays no ring latency;
    `serialized` mode always does (the A/B baseline).
  * micro-batching: launches coalesce on their `batch_key` (plan, padded
    S, D, G, staged-array signature: the shape bucket, not the segment
    batch, so a dashboard fleet batches across tables). One launch of the
    plan's kernels with a member axis (ops/kernels.py `batched_kernel`,
    K1-K4, K7 first for a plan with CLP leaves, K8 for a vector plan, whose
    members differ in their query vectors; ops/startree_device.py
    `batched_kernel`, K5) carries exactly the batch's members, in one of
    three
    variants: broadcast (every member staged the same column blocks),
    stacked (one column set per member) or dedup (one per distinct staged
    batch, and a member-to-set map). The kernels take the member count at
    run time, so a batch is not padded to a power of two (the JAX ring
    pads to bound its retraces); results split back per caller as views
    of one host array.
  * overlap: the device-to-host fetch runs on a fetch pool off the ring,
    and `execute_async` stages on a staging pool, so one query's host work
    overlaps another's kernel (`staging_overlap_ms` measures it).

GPU form: where the JAX ring calls `jax.block_until_ready` (:713), the
port enqueues the launch, starts one non-blocking copy of the packed
[B, S, ...] result into pinned host memory and records a CUDA event behind
it; the fetch pool waits on the event. Every launch, staging copy and
fetch goes to the device's default stream, so the caching allocator's
stream-ordered reuse already covers a staged block that the block cache
evicts while a queued kernel still reads it.

A launch's `cancel_check` is polled while it waits: what it raises fails
that launch's future, and the launch leaves its batch before the kernel
runs. Chaos tests hook the ring with the `server.dispatch.before`
failpoint (every dispatch, ring and inline) and the per-member
`server.dispatch.batch` failpoint (an erroring member fails only its own
future). A mesh engine's launches carry its batched sharded or merged
kernels (ops/kernels.py `batched_sharded_kernel`, ops/collective.py
`batched_merged_kernel`: a launch per slot with the member axis, then one
K9) and the mesh's shape in their key, so they coalesce only with
launches of the same mesh and merge (JAX :497-514). Not
ported: the CPU collective lock, a deadlock guard for XLA collectives on
host devices (the port runs no collectives), and spans (no tracing layer
yet).

Knobs (utils/config.py): pinot.server.dispatch.mode and .batch.max (at
most the kernels' 16 members); the engine reads .batch.cross.table.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from pinot_tpu_torch.ops import _cuda, kernels
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.failpoints import fire
from pinot_tpu_torch.utils.metrics import MetricsRegistry, get_registry

#: shared worker pools: launch and fetch work is engine-agnostic, and
#: per-engine pools would leak threads across short-lived engines
_LAUNCH_THREADS = 8
_FETCH_THREADS = 4
_STAGING_THREADS = 4
_pools_lock = threading.Lock()
_pools: Dict[str, ThreadPoolExecutor] = {}


def _pool(name: str, workers: int) -> ThreadPoolExecutor:
    with _pools_lock:
        pool = _pools.get(name)
        if pool is None:
            pool = _pools[name] = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=name)
        return pool


def launch_pool() -> ThreadPoolExecutor:
    return _pool("kernel-launch", _LAUNCH_THREADS)


def fetch_pool() -> ThreadPoolExecutor:
    return _pool("kernel-fetch", _FETCH_THREADS)


def staging_pool() -> ThreadPoolExecutor:
    return _pool("kernel-staging", _STAGING_THREADS)


#: launches the ring holds before a submit blocks for space
RING_SIZE = 64
#: how long a leader waits for peers to join its batch, and only while
#: more callers are active than the batch holds (JAX's default
#: pinot.server.dispatch.batch.window.ms)
BATCH_WINDOW_S = 2e-3


#: chunk of a bounded future wait: short enough that a deadline trips
#: promptly
_RESULT_POLL_S = 0.25
#: hard backstop on a wait_result call without a budget
DEFAULT_WAIT_CAP_S = 600.0


def wait_result(future: Future, cancel_check=None,
                max_wait_s: Optional[float] = DEFAULT_WAIT_CAP_S,
                poll_s: float = _RESULT_POLL_S):
    """Deadline-bounded ``future.result()``: polls in chunks, running
    `cancel_check` (which raises past the query's deadline or on
    cancellation) each poll; `max_wait_s` bounds a caller without a
    budget."""
    deadline = None if max_wait_s is None else time.monotonic() + max_wait_s
    while True:
        try:
            return future.result(timeout=poll_s)
        except (_FutureTimeout, TimeoutError):
            if future.done():
                # the work itself raised a timeout, or the value landed
                # just after the poll expired: a zero-timeout result()
                # returns the value or re-raises the work's own error
                return future.result(timeout=0)
            if cancel_check is not None:
                cancel_check()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"device launch incomplete after {max_wait_s}s "
                    f"(dispatcher wedged?)") from None


def split_packed(arr: np.ndarray, n: int) -> List[np.ndarray]:
    """The first n members of a batched fetch, as VIEWS into the one
    packed host array (basic indexing on the leading query axis): the
    fetch copies a launch's bytes once whatever the batch size."""
    members = [arr[i] for i in range(n)]
    if not all(m.base is not None and np.shares_memory(m, arr)
               for m in members):
        raise AssertionError("batched split must return views")
    return members


def split_charge(live: List["Launch"], kernel_ms: float) -> None:
    """Charge one launch's kernel ms across its members by doc share,
    through each member's `slip` (an object with `add(device_kernel_ms=)`;
    members without one count in the denominator, unrecorded)."""
    if kernel_ms is None or kernel_ms <= 0:
        return
    total_docs = sum(max(0, it.docs) for it in live)
    n = len(live)
    for it in live:
        if it.slip is None:
            continue
        share = (kernel_ms * (max(0, it.docs) / total_docs)
                 if total_docs > 0 else kernel_ms / n)
        try:
            it.slip.add(device_kernel_ms=share)
        except Exception:  # noqa: BLE001 — accounting never fails a result
            pass


class Launch:
    """One staged device launch waiting in the ring.

    `call` runs the single-query kernel. The batching fields (cols,
    params, num_docs, D) are read only when `batch_key` is set and the
    ring coalesces this launch with equal-keyed peers. `cols_key` is the
    staged batch's identity: equal keys share one column set (broadcast,
    or one dedup entry). `batched(col_sets, plist, ndlist, idx, D)` runs
    the plan's batched kernel (ops/kernels.py `batched_kernel`) over any
    member count. `cancel_check` is polled while queued."""

    __slots__ = ("call", "cols", "params", "num_docs", "D", "batch_key",
                 "cols_key", "batched", "cancel_check", "site_ctx",
                 "future", "enq_ts", "slip", "docs")

    def __init__(self, call: Callable[[], Any], cols=None,
                 params=None, num_docs=None, D: int = 0,
                 batch_key: Optional[tuple] = None,
                 cols_key: Optional[tuple] = None,
                 batched: Optional[Callable[..., Any]] = None,
                 cancel_check: Optional[Callable[[], None]] = None,
                 site_ctx: Optional[Dict[str, Any]] = None,
                 slip=None, docs: int = 0):
        self.call = call
        self.cols = cols
        self.params = params
        self.num_docs = num_docs
        self.D = D
        self.batch_key = batch_key
        self.cols_key = cols_key
        self.batched = batched
        self.cancel_check = cancel_check
        self.site_ctx = site_ctx or {}
        self.future: Future = Future()
        self.slip = slip
        self.docs = int(docs)
        self.enq_ts = 0.0


def _start_fetch(out: torch.Tensor):
    """Begin the one device-to-host copy of a launch's packed result: a
    CUDA tensor copies into pinned host memory without blocking, an event
    behind the copy; a CPU tensor is already there."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(out.device))
    return host, ev


class KernelDispatcher:
    """Owns device launches for one engine: ring, batching, overlap."""

    #: the ring thread exits after this much idle time (a submit respawns
    #: it), so short-lived engines leave no thread behind
    IDLE_EXIT_S = 5.0

    def __init__(self, config: Optional[PinotConfiguration] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 labels: Optional[Dict[str, str]] = None):
        cfg = config or PinotConfiguration()
        self.mode = cfg.get_str("pinot.server.dispatch.mode") or "pipelined"
        if self.mode not in ("pipelined", "serialized"):
            raise ValueError(f"dispatch mode {self.mode!r} is not "
                             "pipelined or serialized")
        # the kernels carry at most MAX_MEMBERS members per launch
        self.batch_max = max(1, min(
            _cuda.MAX_MEMBERS,
            cfg.get_int("pinot.server.dispatch.batch.max")))
        self._metrics = metrics if metrics is not None \
            else get_registry("server")
        self._labels = labels
        self._cv = threading.Condition()
        self._pending: List[Launch] = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        #: callers inside an engine execute: the window is waited only
        #: while more are active than the batch holds
        self._active = 0
        # device-busy clock: wall time with at least one launch in flight
        self._busy_lock = threading.Lock()
        self._inflight = 0
        self._busy_accum = 0.0
        self._busy_since = 0.0
        self._trace_meter_lock = threading.Lock()
        self._trace_seen = kernels.trace_count()
        self._trace_seen_by_plan = kernels.trace_count_by_plan()
        #: launches by variant ('inline', 'single', 'broadcast', 'stacked',
        #: 'dedup') and batch sizes (('size', n)), for benchmarks
        self._stats: Counter = Counter()
        self._stats_lock = threading.Lock()

    # -- caller accounting --------------------------------------------
    @contextlib.contextmanager
    def active(self):
        self.enter_active()
        try:
            yield
        finally:
            self.exit_active()

    def enter_active(self) -> None:
        with self._cv:
            self._active += 1
            self._cv.notify_all()

    def exit_active(self) -> None:
        with self._cv:
            self._active = max(0, self._active - 1)
            self._cv.notify_all()

    # -- device-busy clock --------------------------------------------
    def _busy_begin(self) -> None:
        with self._busy_lock:
            if self._inflight == 0:
                self._busy_since = time.monotonic()
            self._inflight += 1

    def _busy_end(self) -> None:
        with self._busy_lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._busy_accum += time.monotonic() - self._busy_since

    def _idle_device(self) -> bool:
        with self._busy_lock:
            return self._inflight == 0

    def busy_ms(self) -> float:
        """Cumulative wall ms during which a launch was in flight."""
        with self._busy_lock:
            total = self._busy_accum
            if self._inflight > 0:
                total += time.monotonic() - self._busy_since
        return total * 1e3

    # -- metrics --------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        self._metrics.add_timing(name, value, labels=self._labels)

    def _note(self, variant: str, size: int) -> None:
        with self._stats_lock:
            self._stats[variant] += 1
            self._stats[("size", size)] += 1

    def stats(self) -> Counter:
        """Launches by variant and batch size so far (a snapshot)."""
        with self._stats_lock:
            return Counter(self._stats)

    def _set_depth_locked(self) -> None:
        self._metrics.set_gauge("dispatch_queue_depth", len(self._pending),
                                labels=self._labels)

    def _meter_traces(self) -> None:
        # read-modify-write under a lock: finishes land concurrently on
        # caller, launch and fetch threads
        with self._trace_meter_lock:
            now = kernels.trace_count()
            delta = now - self._trace_seen
            if delta <= 0:
                return
            self._trace_seen = now
            by_plan = kernels.trace_count_by_plan()
            plan_deltas = {fp: n - self._trace_seen_by_plan.get(fp, 0)
                           for fp, n in by_plan.items()
                           if n > self._trace_seen_by_plan.get(fp, 0)}
            self._trace_seen_by_plan = by_plan
        self._metrics.add_meter("kernel_retrace", delta, labels=self._labels)
        # attribution rides a separate series, so the total stays summable
        for fp, d in plan_deltas.items():
            labels = dict(self._labels or {})
            labels["plan"] = fp
            self._metrics.add_meter("kernel_retrace_by_plan", d,
                                    labels=labels)

    # -- submission ----------------------------------------------------
    def submit(self, launch: Launch) -> Future:
        """Enqueue a staged launch; returns its future (the packed result
        as a numpy array, or the launch's error). Blocks for ring space,
        polling the launch's cancel check."""
        launch.enq_ts = time.monotonic()
        if self.mode == "serialized":
            return self._submit_serialized(launch)
        with self._cv:
            idle = self._active <= 1 and not self._pending
        if idle and self._idle_device():
            # lone-query fast path: nothing to coalesce or overlap, so
            # dispatch inline and pay no ring latency
            return self._submit_serialized(launch)
        with self._cv:
            while len(self._pending) >= RING_SIZE and not self._closed:
                if launch.cancel_check is not None:
                    try:
                        launch.cancel_check()
                    except BaseException as e:  # noqa: BLE001
                        launch.future.set_exception(e)
                        return launch.future
                self._cv.wait(0.05)
            if self._closed:
                launch.future.set_exception(
                    RuntimeError("dispatcher closed"))
                return launch.future
            self._pending.append(launch)
            self._set_depth_locked()
            self._ensure_thread_locked()
            self._cv.notify_all()
        return launch.future

    def _submit_serialized(self, launch: Launch) -> Future:
        """Dispatch and fetch inline on the caller's thread: `serialized`
        mode and the pipelined lone-query fast path. The dispatch
        failpoint fires here too."""
        try:
            fire("server.dispatch.before", **launch.site_ctx)
            if launch.cancel_check is not None:
                launch.cancel_check()
            self._busy_begin()
            t0 = time.monotonic()
            try:
                packed = launch.call().cpu().numpy()
            finally:
                self._busy_end()
                self._meter_traces()
            self._note("inline", 1)
            split_charge([launch], (time.monotonic() - t0) * 1e3)
            launch.future.set_result(packed)
        except BaseException as e:  # noqa: BLE001 — the future carries it
            launch.future.set_exception(e)
        return launch.future

    def close(self) -> None:
        with self._cv:
            self._closed = True
            for it in self._pending:
                it.future.set_exception(RuntimeError("dispatcher closed"))
            self._pending.clear()
            self._cv.notify_all()

    # -- ring thread ---------------------------------------------------
    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="kernel-dispatch")
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                end = time.monotonic() + self.IDLE_EXIT_S
                while not self._pending:
                    left = end - time.monotonic()
                    if self._closed or left <= 0:
                        self._thread = None
                        return
                    self._cv.wait(left)
                leader = self._pending.pop(0)
                self._set_depth_locked()
                self._cv.notify_all()
            self._dispatch_one(leader)

    def _dispatch_one(self, leader: Launch) -> None:
        """Every exit path completes every popped launch's future."""
        batch = [leader]
        try:
            # chaos hook: a delay here also widens the coalescing window
            fire("server.dispatch.before", **leader.site_ctx)
            batch = self._coalesce(leader)
            self._dispatch_batch(batch)
        except BaseException as e:  # noqa: BLE001 — the futures carry it
            for it in batch:
                if not it.future.done():
                    it.future.set_exception(e)

    def _dispatch_batch(self, batch: List[Launch]) -> None:
        # cancel checks run while queued, and the per-member failpoint
        # inside a coalesced batch: an erroring member fails only its own
        # future, its peers stay in the batch
        coalesced = len(batch) > 1
        live: List[Launch] = []
        for it in batch:
            try:
                if it.cancel_check is not None:
                    it.cancel_check()
                if coalesced:
                    fire("server.dispatch.batch", batch_size=len(batch),
                         **it.site_ctx)
                live.append(it)
            except BaseException as e:  # noqa: BLE001
                it.future.set_exception(e)
        if not live:
            return
        self.observe("dispatch_batch_size", float(len(live)))
        batched = len(live) > 1
        if not batched:
            self._note("single", 1)
            launch_pool().submit(self._run_and_finish, live, live[0].call,
                                 False)
            return
        # one column set per distinct staged batch: broadcast when every
        # member staged the same column blocks (one set), stacked when
        # each member comes from its own segment batch of one shape
        # bucket, dedup when some of those share a staged batch
        uniq_pos: Dict[tuple, int] = {}
        sets: List[Launch] = []
        for it in live:
            if it.cols_key not in uniq_pos:
                uniq_pos[it.cols_key] = len(sets)
                sets.append(it)
        variant = "broadcast" if len(sets) == 1 else \
            "stacked" if len(sets) == len(live) else "dedup"
        if variant != "broadcast":
            self._metrics.add_meter("dispatch_batch_cross_table", len(live),
                                    labels=self._labels)
        if variant == "dedup":
            self._metrics.add_meter("dispatch_batch_dedup",
                                    len(live) - len(sets),
                                    labels=self._labels)
        lead = live[0]
        clist = [it.cols for it in sets]
        ndlist = [it.num_docs for it in sets]
        plist = [it.params for it in live]
        idx = [uniq_pos[it.cols_key] for it in live]
        call = lambda: lead.batched(clist, plist, ndlist,  # noqa: E731
                                    idx, lead.D)
        self._note(variant, len(live))
        launch_pool().submit(self._run_and_finish, live, call, True)

    def _coalesce(self, leader: Launch) -> List[Launch]:
        """Collect equal-keyed launches behind the leader, waiting up to
        the window, but only while the engine has more callers active
        than the batch holds (a lone query never waits)."""
        batch = [leader]
        if leader.batch_key is None or self.batch_max <= 1:
            return batch
        deadline = time.monotonic() + BATCH_WINDOW_S
        with self._cv:
            while True:
                i = 0
                while i < len(self._pending) and len(batch) < self.batch_max:
                    if self._pending[i].batch_key == leader.batch_key:
                        batch.append(self._pending.pop(i))
                        self._cv.notify_all()
                    else:
                        i += 1
                target = min(self.batch_max, max(1, self._active))
                if len(batch) >= target:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            self._set_depth_locked()
        return batch

    def _run_and_finish(self, live: List[Launch], call, batched: bool
                        ) -> None:
        self._busy_begin()
        t0 = time.monotonic()
        try:
            fetch = _start_fetch(call())
        except BaseException as e:  # noqa: BLE001
            self._busy_end()
            for it in live:
                it.future.set_exception(e)
            self._meter_traces()
            return
        fetch_pool().submit(self._finish, live, fetch, batched,
                            (time.monotonic() - t0) * 1e3)

    def _finish(self, live: List[Launch], fetch, batched: bool,
                kernel_ms: float) -> None:
        """Wait for the fetch and split it per caller, off the ring. The
        busy interval closes before the futures resolve: a caller woken by
        its result must see an idle dispatcher, or its next lone query
        would take the ring instead of the inline fast path."""
        host, ev = fetch
        try:
            if ev is not None:
                ev.synchronize()
            arr = host.numpy()
        except BaseException as e:  # noqa: BLE001
            self._busy_end()
            self._meter_traces()
            for it in live:
                if not it.future.done():
                    it.future.set_exception(e)
            return
        self._busy_end()
        self._meter_traces()
        split_charge(live, kernel_ms)
        try:
            if batched:
                for member, it in zip(split_packed(arr, len(live)), live):
                    it.future.set_result(member)
            else:
                live[0].future.set_result(arr)
        except BaseException as e:  # noqa: BLE001
            for it in live:
                if not it.future.done():
                    it.future.set_exception(e)
