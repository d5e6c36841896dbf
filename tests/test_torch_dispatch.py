"""The port's dispatch ring (pinot_tpu_torch/ops/dispatch.py) through its
engine on the CPU: tests/test_dispatch.py and
tests/test_concurrent_dispatch.py ported to `TorchOperatorExecutor`.

Pinned here:
  * micro-batching: concurrent queries of one plan coalesce into ONE
    launch of the batched kernel and split back per caller, bit-identical
    to each query run alone (scalar, group-by, and a property over random
    literal sets), and equal to the JAX engine's answers on the same
    segments in both precision postures (every value here is an integer:
    exact, within the harness's rel 1e-9);
  * serialized mode answers as pipelined mode does;
  * a cancelled member leaves its batch before launch, a deadline that
    expires while queued fails its query, a failing dispatch fails only
    its own query, and seeded chaos replays exactly;
  * split_packed hands out views; wait_result's five cases;
  * steady state builds nothing (kernels.trace_count, the kernel_retrace
    meter);
  * launches overlap across threads, and 8 threads get correct answers.

Determinism: a bounded hold on server.dispatch.before (times=2: a racing
thread's inline fast path may take the first) holds the ring on its first
pop until every other job has staged and enqueued (the hold's firings plus
the ring's depth reach the job count; HOLD_S caps it), so the batch's
composition is exact however slowly the threads stage.
"""
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.models import (DataType, FieldSpec, FieldType, Schema,
                              TableConfig, TableType)
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.segment.creator import SegmentCreator
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu_torch.ops import dispatch, kernels
from pinot_tpu_torch.ops.engine import TorchOperatorExecutor
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.utils.accounting import (BrokerTimeoutError,
                                              QueryCancelledError)
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.failpoints import FailpointError, failpoints

HOLD_S = 30.0  # cap on a ring hold, which ends once every job is queued
POSTURES = pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])


def build_table(tmp_path, name, num_segments, docs, seed):
    """One table's segments, built by the JAX creator and loaded by each
    package's loader: (port segments, JAX segments, columns)."""
    schema = Schema(name, [
        FieldSpec("d", DataType.INT, FieldType.DIMENSION),
        FieldSpec("m", DataType.INT, FieldType.METRIC)])
    tc = TableConfig(name, TableType.OFFLINE)
    tc.indexing.no_dictionary_columns = ["m"]
    creator = SegmentCreator(tc, schema)
    rng = np.random.default_rng(seed)
    port, jaxs, data = [], [], []
    for i in range(num_segments):
        cols = {"d": rng.integers(0, 10, docs).astype(np.int32),
                "m": rng.integers(0, 100, docs).astype(np.int32)}
        p = str(tmp_path / f"{name}_{i}")
        creator.build(cols, p, f"{name}_{i}")
        port.append(load_segment(p))
        jaxs.append(jax_load(p))
        data.append(cols)
    return port, jaxs, data


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    return build_table(tmp_path_factory.mktemp("tdisp"), "t", 3, 4000, 11)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


def make_engine(x64=False, **overrides):
    return TorchOperatorExecutor(
        "cpu", torch.float64 if x64 else torch.float32,
        config=PinotConfiguration(overrides=overrides))


def agg_values(results):
    """A comparable value tuple per segment result."""
    out = []
    for r in results:
        if hasattr(r, "groups"):
            out.append(tuple(sorted(
                (tuple(int(x) for x in k),
                 tuple(float(v) for v in inters))
                for k, inters in r.groups.items())))
        else:
            out.append(tuple(float(v) for v in r.intermediates))
    return tuple(out)


def jax_values(jsegs, sqls, x64):
    """The JAX engine's answers to `sqls` on the same segments, in the
    same precision posture."""
    with jax.enable_x64(x64):
        eng = TpuOperatorExecutor()
        out = []
        for sql in sqls:
            res, rem = eng.execute(jsegs, JaxContext.from_sql(sql))
            assert not rem
            out.append(agg_values(res))
    return out


def queue_depth(disp) -> int:
    """The ring's pending launches: its `dispatch_queue_depth` gauge."""
    return int(disp._metrics.gauge("dispatch_queue_depth",
                                   labels=disp._labels) or 0)


def hold_until_queued(eng, n, cap=HOLD_S):
    """Arm a hold of the dispatch site (times=2: the ring's first pop,
    and an inline fast path that may fire first) that ends once all `n`
    launches reached it or the ring (its firings plus the ring's depth),
    at the latest after `cap` s. The condition latches: once one holder
    sees it, the ring drains and the other holder must still let go."""
    seen = []

    def queued() -> bool:
        if not seen and fp.fired + queue_depth(eng.dispatcher) >= n:
            seen.append(True)
        return bool(seen)
    fp = failpoints.arm("server.dispatch.before", delay=cap, times=2,
                        until=queued)
    return fp


def run_concurrent(eng, jobs, hold=HOLD_S):
    """jobs: [(segments, sql), ...] run concurrently with the ring held on
    its first pop until every job is enqueued (`hold` caps the wait)."""
    hold_until_queued(eng, len(jobs), hold)
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            futs = [pool.submit(eng.execute, s, QueryContext.from_sql(q))
                    for s, q in jobs]
            return [f.result(timeout=60) for f in futs]
    finally:
        failpoints.disarm("server.dispatch.before")


def singles_of(eng, jobs):
    return [agg_values(eng.execute(s, QueryContext.from_sql(q)))
            for s, q in jobs]


def batch_max(eng):
    return eng.dispatcher._metrics.timer("dispatch_batch_size").max_ms


class TestMicroBatching:
    @POSTURES
    def test_coalesce_and_split_matches_per_query(self, table, x64):
        port, jsegs, _ = table
        eng = make_engine(x64)
        sqls = [f"SELECT SUM(m), COUNT(*), MIN(m) FROM t WHERE d < {k}"
                for k in range(1, 7)]
        jobs = [(port, q) for q in sqls]
        singles = singles_of(eng, jobs)
        before = eng.dispatcher.stats()
        got = run_concurrent(eng, jobs)
        assert [agg_values(r) for r in got] == singles
        # a batch formed: not six serialized singles
        assert eng.dispatcher.stats()["broadcast"] > before["broadcast"]
        assert batch_max(eng) >= 2
        assert singles == jax_values(jsegs, sqls, x64)

    @POSTURES
    def test_group_by_batched_matches_per_query(self, table, x64):
        port, jsegs, _ = table
        eng = make_engine(x64)
        sqls = [f"SELECT d, SUM(m) FROM t WHERE m BETWEEN {a} AND {a + 40} "
                "GROUP BY d" for a in (0, 10, 20, 30)]
        jobs = [(port, q) for q in sqls]
        singles = singles_of(eng, jobs)
        got = run_concurrent(eng, jobs)
        assert [agg_values(r) for r in got] == singles
        assert singles == jax_values(jsegs, sqls, x64)

    @POSTURES
    def test_bit_identical_property_over_random_literal_sets(self, table,
                                                             x64):
        """For any set of equal-plan queries, batched equals alone."""
        port, jsegs, _ = table
        eng = make_engine(x64)
        rng = np.random.default_rng(23)
        for _trial in range(3):
            k = int(rng.integers(2, 9))
            bounds = rng.integers(0, 100, size=(k, 2))
            sqls = ["SELECT SUM(m), COUNT(*), MAX(m) FROM t "
                    f"WHERE m BETWEEN {min(a, b)} AND {max(a, b)} AND d < 8"
                    for a, b in bounds]
            jobs = [(port, q) for q in sqls]
            singles = singles_of(eng, jobs)
            got = run_concurrent(eng, jobs)
            assert [agg_values(r) for r in got] == singles
            assert singles == jax_values(jsegs, sqls, x64)

    def test_serialized_mode_matches_pipelined(self, table):
        port, _, _ = table
        pipe = make_engine()
        ser = make_engine(**{"pinot.server.dispatch.mode": "serialized"})
        for sql in ("SELECT SUM(m), COUNT(*) FROM t WHERE d < 5",
                    "SELECT d, COUNT(*) FROM t GROUP BY d"):
            ctx = QueryContext.from_sql(sql)
            assert agg_values(pipe.execute(port, ctx)) == \
                agg_values(ser.execute(port, ctx))
        # serialized mode never pads the segment axis nor takes the ring
        assert not ser._cross_table
        assert set(ser.dispatcher.stats()) <= {"inline", ("size", 1)}

    def test_selection_and_distinct_batch_through_the_ring(self, table):
        """Top-N (K4's batched form) and DISTINCT (K2's) coalesce too."""
        port, _, data = table
        eng = make_engine()
        jobs = [(port, f"SELECT d, m FROM t WHERE d = {k} "
                       "ORDER BY m DESC LIMIT 5") for k in range(4)]
        jobs += [(port, f"SELECT DISTINCT d FROM t WHERE m < {k * 20} "
                        "ORDER BY d LIMIT 100") for k in range(1, 4)]
        ctxs = [QueryContext.from_sql(q) for _s, q in jobs]
        singles = [eng.execute(s, c) for (s, _q), c in zip(jobs, ctxs)]
        got = run_concurrent(eng, jobs)
        for a, b in zip(got, singles):
            for ra, rb in zip(a, b):
                assert getattr(ra, "rows") == getattr(rb, "rows")
        # the top-5 of segment 0 under d = 0 is numpy's
        d, m = data[0]["d"], data[0]["m"]
        docs = np.nonzero(d == 0)[0]
        top = docs[np.lexsort((docs, -m[docs]))][:5]
        assert [r[1] for r in got[0][0].rows] == m[top].tolist()


class TestCancelAndDeadline:
    def test_cancelled_query_leaves_batch_before_launch(self, table):
        port, _, _ = table
        eng = make_engine()
        sqls = [f"SELECT SUM(m), COUNT(*) FROM t WHERE d < {k}"
                for k in range(1, 5)]
        singles = singles_of(eng, [(port, q) for q in sqls])

        def cancelled():
            raise QueryCancelledError("cancelled by test")

        hold_until_queued(eng, len(sqls))
        try:
            with ThreadPoolExecutor(4) as pool:
                futs = [pool.submit(eng.execute, port,
                                    QueryContext.from_sql(q),
                                    cancelled if i == 1 else None)
                        for i, q in enumerate(sqls)]
                with pytest.raises(QueryCancelledError):
                    futs[1].result(timeout=60)
                for i in (0, 2, 3):
                    assert agg_values(futs[i].result(timeout=60)) == \
                        singles[i]
        finally:
            failpoints.disarm("server.dispatch.before")

    def test_deadline_honored_while_queued(self, table):
        port, _, _ = table
        eng = make_engine()
        ctx = QueryContext.from_sql("SELECT SUM(m) FROM t WHERE d < 5")
        eng.execute(port, ctx)  # warm: staging off the timed path
        deadline = time.monotonic() + 0.02

        def checker():
            if time.monotonic() > deadline:
                raise BrokerTimeoutError("query deadline expired")

        # hold the ring so the query sits queued past its whole budget
        failpoints.arm("server.dispatch.before", delay=0.2, times=1)
        try:
            with ThreadPoolExecutor(2) as pool:
                blocker = pool.submit(eng.execute, port, ctx)
                time.sleep(0.05)  # budget expired
                with pytest.raises(BrokerTimeoutError):
                    eng.execute(port, ctx, checker)
                blocker.result(timeout=60)
        finally:
            failpoints.disarm("server.dispatch.before")


class TestRetraceGuard:
    def test_steady_state_zero_codegen_and_zero_new_blocks(self, table):
        """Repeated singles and coalesced batches over seen plans compile
        no program (the codegen odometer) and stage no new block."""
        port, _, _ = table
        eng = make_engine()
        jobs = [(port, f"SELECT SUM(m), COUNT(*), MIN(m) FROM t "
                       f"WHERE d < {k}") for k in range(1, 9)]
        singles_of(eng, jobs)
        run_concurrent(eng, jobs)
        t0 = kernels.trace_count()
        blocks = len(eng._blocks)
        singles_of(eng, jobs)
        run_concurrent(eng, jobs)
        assert kernels.trace_count() == t0, \
            "steady-state traffic built a kernel"
        assert len(eng._blocks) == blocks

    def test_steady_state_zero_retrace_meter(self, table):
        port, _, _ = table
        eng = make_engine()

        def round_of(base):
            run_concurrent(eng, [(port, "SELECT SUM(m), COUNT(*) FROM t "
                                        f"WHERE d < {base + k}")
                                 for k in range(8)])

        one = (port, "SELECT SUM(m), COUNT(*) FROM t WHERE d < 1")
        singles_of(eng, [one])
        round_of(0)
        before = kernels.trace_count()
        meter0 = eng.dispatcher._metrics.meter("kernel_retrace")
        round_of(1)                  # same shapes, fresh literals
        round_of(2)
        singles_of(eng, [one])
        assert kernels.trace_count() == before
        assert eng.dispatcher._metrics.meter("kernel_retrace") == meter0


    def test_any_batch_size_launches_its_members_and_builds_nothing(
            self, table, monkeypatch):
        """Once a plan ran alone, batches of any size build nothing, and
        each launches the batched kernel with exactly its members: the
        kernels take B at run time, so no batch pads to a power of two."""
        port, _, _ = table
        eng = make_engine(**{"pinot.server.dispatch.batch.max": 8})
        sql = "SELECT SUM(m), MIN(m), COUNT(*) FROM t WHERE d > {}"
        singles_of(eng, [(port, sql.format(0))])
        members = []
        real = kernels.batched_kernel

        def spy(plan, value_dtype):
            run = real(plan, value_dtype)

            def counted(col_sets, plist, ndlist, idx, D):
                members.append(len(plist))
                return run(col_sets, plist, ndlist, idx, D)
            return counted

        monkeypatch.setattr(kernels, "batched_kernel", spy)
        before = kernels.trace_count()
        for n in (2, 3, 5, 8):
            start = len(members)
            # an extra active caller keeps every job off the inline fast
            # path, so the batch is exactly the n jobs
            with eng.dispatcher.active():
                run_concurrent(eng, [(port, sql.format(k))
                                     for k in range(n)])
            assert members[start:] == [n]
        assert kernels.trace_count() == before


class TestDispatchChaos:
    def test_seeded_chaos_replays_exactly(self, table):
        port, _, _ = table
        eng = make_engine()
        ctx = QueryContext.from_sql("SELECT SUM(m), COUNT(*) FROM t "
                                    "WHERE d < 4")
        eng.execute(port, ctx)

        def run_round():
            fp = failpoints.arm("server.dispatch.before",
                                error=FailpointError("dispatch chaos"),
                                probability=0.5, seed=1234)
            outcomes = []
            try:
                for _ in range(10):
                    try:
                        assert eng.execute(port, ctx)
                        outcomes.append("ok")
                    except FailpointError:
                        outcomes.append("chaos")
            finally:
                failpoints.disarm("server.dispatch.before")
            return outcomes, list(fp.decisions)

        o1, d1 = run_round()
        o2, d2 = run_round()
        assert o1 == o2 and d1 == d2
        assert "chaos" in o1 and "ok" in o1

    def test_dispatch_error_fails_only_that_query(self, table):
        port, _, _ = table
        eng = make_engine()
        ctx = QueryContext.from_sql("SELECT COUNT(*) FROM t WHERE d < 3")
        want = agg_values(eng.execute(port, ctx))
        failpoints.arm("server.dispatch.before",
                       error=FailpointError("one-shot"), times=1)
        try:
            with pytest.raises(FailpointError):
                eng.execute(port, ctx)
        finally:
            failpoints.disarm("server.dispatch.before")
        assert agg_values(eng.execute(port, ctx)) == want


class TestZeroCopySplit:
    def test_split_packed_returns_views(self):
        arr = np.arange(24.0).reshape(4, 6)
        members = dispatch.split_packed(arr, 3)
        assert len(members) == 3
        for i, m in enumerate(members):
            assert m.base is not None and np.shares_memory(m, arr)
            assert np.array_equal(m, arr[i])

    def test_batched_fetch_split_is_zero_copy_end_to_end(self, table,
                                                         monkeypatch):
        port, _, _ = table
        eng = make_engine()
        jobs = [(port, f"SELECT SUM(m), COUNT(*) FROM t WHERE d < {k}")
                for k in range(1, 6)]
        singles = singles_of(eng, jobs)
        calls = []
        orig = dispatch.split_packed

        def spy(arr, n):
            members = orig(arr, n)
            calls.append((arr, members))
            return members

        monkeypatch.setattr(dispatch, "split_packed", spy)
        got = run_concurrent(eng, jobs)
        assert [agg_values(r) for r in got] == singles
        assert calls, "no batch formed"
        for arr, members in calls:
            for m in members:
                assert m.base is not None and np.shares_memory(m, arr)


class TestPipelineMetrics:
    def test_dispatch_metrics_populated(self, table):
        port, _, _ = table
        eng = make_engine()
        reg = eng.dispatcher._metrics
        c0 = reg.timer("dispatch_batch_size").count
        jobs = [(port, f"SELECT SUM(m), COUNT(*) FROM t WHERE d < {k}")
                for k in range(1, 5)]
        singles_of(eng, jobs)
        run_concurrent(eng, jobs)
        t = reg.timer("dispatch_batch_size")
        assert t.count > c0
        assert t.max_ms >= 2
        assert reg.gauge("dispatch_queue_depth") is not None

    def test_execute_async_overlaps_caller(self, table):
        port, _, _ = table
        eng = make_engine()
        ctx = QueryContext.from_sql("SELECT SUM(m), COUNT(*) FROM t "
                                    "WHERE d < 6")
        want = agg_values(eng.execute(port, ctx))
        failpoints.arm("server.dispatch.before", delay=0.2, times=1)
        try:
            t0 = time.perf_counter()
            fut = eng.execute_async(port, ctx)
            submitted_in = time.perf_counter() - t0
            res = fut.result(timeout=10)
        finally:
            failpoints.disarm("server.dispatch.before")
        assert submitted_in < 0.15, "execute_async blocked the caller"
        assert agg_values(res) == want

    def test_execute_async_runs_selections_inline(self, table):
        port, _, _ = table
        eng = make_engine()
        ctx = QueryContext.from_sql("SELECT d FROM t WHERE d = 3 "
                                    "ORDER BY m LIMIT 3")
        fut = eng.execute_async(port, ctx)
        assert fut.done()
        assert [r.rows for r in fut.result(timeout=0)] == \
            [r.rows for r in eng.execute(port, ctx)]


class TestWaitResult:
    def test_returns_value(self):
        f = Future()
        f.set_result(41)
        assert dispatch.wait_result(f) == 41

    def test_completion_in_poll_expiry_race_window_returns_value(self):
        class RacyFuture(Future):
            def __init__(self):
                super().__init__()
                self._polled = False

            def result(self, timeout=None):
                if not self._polled:
                    self._polled = True
                    self.set_result(17)   # lands during the poll
                    raise TimeoutError()  # which already expired
                return super().result(timeout)

        assert dispatch.wait_result(RacyFuture(), poll_s=0.01) == 17

    def test_work_raised_timeout_propagates(self):
        f = Future()
        f.set_exception(TimeoutError("work deadline"))
        with pytest.raises(TimeoutError, match="work deadline"):
            dispatch.wait_result(f, poll_s=0.01)

    def test_cancel_check_runs_each_poll(self):
        calls = []

        def checker():
            calls.append(1)
            if len(calls) >= 3:
                raise RuntimeError("query cancelled")

        with pytest.raises(RuntimeError, match="query cancelled"):
            dispatch.wait_result(Future(), cancel_check=checker,
                                 poll_s=0.005)
        assert len(calls) == 3

    def test_hard_cap_bounds_budgetless_wait(self):
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="dispatcher wedged"):
            dispatch.wait_result(Future(), max_wait_s=0.05, poll_s=0.01)
        assert time.perf_counter() - t0 < 2.0


class TestSplitCharge:
    def test_charges_split_by_doc_share_and_sum_to_the_launch(self):
        """A launch's kernel ms charged across its members by doc share:
        the charges of members with a slip plus the unrecorded shares of
        members without one sum to the launch's ms."""
        class Slip:
            ms = 0.0

            def add(self, device_kernel_ms):
                self.ms += device_kernel_ms

        live = [dispatch.Launch(call=None, slip=Slip(), docs=d)
                for d in (100, 300, 0)]
        live.append(dispatch.Launch(call=None, docs=600))
        dispatch.split_charge(live, 10.0)
        assert [it.slip.ms for it in live[:3]] == [1.0, 3.0, 0.0]
        empty = [dispatch.Launch(call=None, slip=Slip()) for _ in range(4)]
        dispatch.split_charge(empty, 2.0)
        assert [it.slip.ms for it in empty] == [0.5] * 4


KERNEL_S = 0.15


class TestConcurrentEngine:
    def test_dispatch_overlaps_across_threads(self, table, monkeypatch):
        """A slow kernel: held by the engine lock, 8 threads would take
        8 x KERNEL_S; on the ring's launch pool they overlap (batch.max=1:
        no coalescing, every launch its own)."""
        port, _, _ = table
        calls = []

        def slow_make_kernel(plan, value_dtype=torch.float32):
            def kernel(cols, params, num_docs, D, G=0):
                calls.append(time.perf_counter())
                time.sleep(KERNEL_S)
                return torch.zeros((num_docs.shape[0],
                                    1 + len(plan.agg_ops)))
            return kernel

        monkeypatch.setattr(kernels, "make_kernel", slow_make_kernel)
        eng = make_engine(**{"pinot.server.dispatch.batch.max": 1})
        ctx = QueryContext.from_sql("SELECT SUM(m) FROM t WHERE d < 5")
        eng.execute(port, ctx)
        n = 8
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n) as pool:
            res = [f.result(timeout=60) for f in
                   [pool.submit(eng.execute, port, ctx) for _ in range(n)]]
        wall = time.perf_counter() - t0
        assert all(len(r) == len(port) for r in res)
        assert wall < n * KERNEL_S / 2, \
            f"8 concurrent dispatches took {wall:.2f}s: serialized?"
        starts = sorted(calls[-n:])
        assert starts[1] - starts[0] < KERNEL_S / 2

    @POSTURES
    def test_results_stay_correct_under_concurrency(self, table, x64):
        port, _, data = table
        eng = make_engine(x64)
        sqls = [f"SELECT SUM(m), COUNT(*) FROM t WHERE d < {k}"
                for k in range(1, 9)]
        want = {}
        for k in range(1, 9):
            keep = [c["d"] < k for c in data]
            want[k] = (float(sum(int(c["m"][w].sum())
                                 for c, w in zip(data, keep))),
                       float(sum(int(w.sum()) for w in keep)))

        def one(i):
            k = i % 8 + 1
            res = eng.execute(port, QueryContext.from_sql(sqls[k - 1]))
            got = (sum(float(r.intermediates[0]) for r in res),
                   sum(float(r.intermediates[1]) for r in res))
            assert got == want[k]
            return True

        with ThreadPoolExecutor(8) as pool:
            assert all(pool.map(one, range(32), timeout=120))
