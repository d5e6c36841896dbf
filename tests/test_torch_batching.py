"""The port's batched kernel (pinot_tpu_torch/ops/kernels.py
`batched_kernel`, the counterpart of the JAX package's
`make_batched_kernel`, `make_batched_dedup_kernel` and
`make_batched_topn_kernel`) and cross-table coalescing through its engine.

Batched kernel: seeded random plans (tests/torch_plans.py) over B members
with their own literal sets, in the three forms the dispatcher builds
(broadcast: one column set; stacked: one per member; dedup: U sets and a
member-to-set map), with B and U at powers of two and between them (the
dispatcher launches exactly a batch's members) and padded segments
(num_docs 0). Each member's output is held bit for bit against its own
single plain launch, and against the JAX package's batched kernels on the
same numpy inputs with tests/test_torch_kernels.py's tolerances, in both
precision postures.

Engine: tests/test_kernel_factory.py's cross-table cases (three tables of
one plan shape whose segment and doc counts pad into one (S, D) bucket)
through `TorchOperatorExecutor` on the CPU: coalesced answers bit-identical
to each query alone, the `dispatch_batch_cross_table` and
`dispatch_batch_dedup` meters, the cross-table switch, member fault
isolation, seeded batch chaos, codegen attribution and steady state.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.ops import kernels as jk
from pinot_tpu.ops import plan_ir as jir
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import program
from pinot_tpu_torch.ops.plan_ir import DevicePlan
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.utils.failpoints import FailpointError, failpoints
from tests import torch_plans as tp
from tests.test_torch_dispatch import (agg_values, build_table, jax_values,
                                       make_engine, run_concurrent,
                                       singles_of)

S, D = 4, 384
#: form -> (B, U, member-to-set map): powers of two and the sizes between
FORMS = {
    "broadcast-2": (2, 1, [0, 0]),
    "broadcast-3": (3, 1, [0, 0, 0]),
    "stacked-4": (4, 4, [0, 1, 2, 3]),
    "stacked-3": (3, 3, [0, 1, 2]),
    "dedup-5-over-3": (5, 3, [0, 1, 0, 2, 1]),
    "dedup-4-over-2": (4, 2, [1, 0, 1, 0]),
}


def jax_plan(spec):
    leaves = tuple(jir.DeviceLeaf(lf.kind, lf.column)
                   for lf in spec["leaves"])
    return jir.DevicePlan(**{**spec, "leaves": leaves})


def member_inputs(seed, spec, form, vdt, inputs=tp.random_inputs):
    """(column sets, params per member, num_docs per set, idx) in numpy:
    each set and each member's literals drawn from its own seed. The last
    segment is padding."""
    B, U, idx = FORMS[form]
    sets = [inputs(seed + 101 * u, spec, S, D, vdt) for u in range(U)]
    plist = [inputs(seed + 7 * m + 3, spec, S, D, vdt)[1]
             for m in range(B)]
    return ([c for c, _p, _n in sets], plist, [n for _c, _p, n in sets],
            idx)


def torch_of(arrays):
    return {k: torch.from_numpy(np.require(v, requirements=["C", "W"]))
            for k, v in arrays.items()}


def run_port_batched(plan, cols, plist, nds, idx, vdt):
    tcols = [torch_of(c) for c in cols]
    tps = [torch_of(p) for p in plist]
    tnds = [torch.from_numpy(n) for n in nds]
    return tk.batched_kernel(plan, vdt)(tcols, tps, tnds, idx, D).numpy()


def run_jax_batched(spec, form, cols, plist, nds, idx, x64):
    B, U, _ = FORMS[form]
    jplan = jax_plan(spec)
    with jax.enable_x64(x64):
        jc = [{k: jnp.asarray(v) for k, v in c.items()} for c in cols]
        jp = tuple({k: jnp.asarray(v) for k, v in p.items()} for p in plist)
        jn = [jnp.asarray(n) for n in nds]
        if spec.get("mode") == "topn":
            if form.startswith("broadcast"):
                out = jk.make_batched_topn_kernel(jplan, B)(
                    jc[0], jp, jn[0], D=D)
            else:
                out = jk.make_batched_topn_kernel(jplan, B, True)(
                    tuple(jc[u] for u in idx), jp,
                    tuple(jn[u] for u in idx), D=D)
        elif form.startswith("broadcast"):
            out = jk.make_batched_kernel(jplan, B)(jc[0], jp, jn[0], D=D)
        elif form.startswith("stacked"):
            out = jk.make_batched_kernel(jplan, B, True)(
                tuple(jc[u] for u in idx), jp, tuple(jn[u] for u in idx),
                D=D)
        else:
            out = jk.make_batched_dedup_kernel(jplan, B, U)(
                tuple(jc), jp, tuple(jn), jnp.asarray(idx, jnp.int32), D=D)
        return np.asarray(out)


def check_members(spec, plan, form, cols, plist, nds, idx, vdt, x64, got):
    """Each member bit for bit against its own single plain launch."""
    B = FORMS[form][0]
    assert got.shape[0] == B
    for m in range(B):
        u = idx[m]
        tc, tpar, tnd = tk.from_jax_staged(cols[u], plist[m], nds[u])
        if plan.mode == "topn":
            one = tk.topn_kernel(plan, tc, tpar, tnd, D, vdt).numpy()
        else:
            one = tk.plain_kernel(plan, vdt)(tc, tpar, tnd, D).numpy()
        assert np.array_equal(got[m], one, equal_nan=True), (form, m)


def scales_of(plan, cols, plist, nds, idx):
    out = []
    for m, u in enumerate(idx):
        tc, tpar, tnd = tk.from_jax_staged(cols[u], plist[m], nds[u])
        out.append({j: v.numpy() for j, v in
                    tk.abs_contributions(plan, tc, tpar, tnd, D).items()})
    return out


AGG_CASES = [(seed, grouped, form) for seed in range(2)
             for grouped in (False, True)
             for form in ("broadcast-3", "stacked-3", "dedup-5-over-3")]


@pytest.mark.parametrize("seed,grouped,form", AGG_CASES)
@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_batched_agg_matches_single_and_jax(seed, grouped, form, x64):
    spec = tp.random_spec(seed, grouped)
    plan = DevicePlan(**spec)
    vdt = torch.float64 if x64 else torch.float32
    cols, plist, nds, idx = member_inputs(
        seed, spec, form, np.float64 if x64 else np.float32)
    got = run_port_batched(plan, cols, plist, nds, idx, vdt)
    check_members(spec, plan, form, cols, plist, nds, idx, vdt, x64, got)
    ref = run_jax_batched(spec, form, cols, plist, nds, idx, x64)
    scales = scales_of(plan, cols, plist, nds, idx)
    for m in range(got.shape[0]):
        tp.assert_packed_equal(spec, got[m], ref[m], scales[m], x64,
                               fma=True)


@pytest.mark.parametrize("form", ["broadcast-2", "stacked-4",
                                  "dedup-4-over-2"])
def test_batched_sketches_match_single_and_jax(form):
    """K3's slots (HLL registers, histogram buckets) beside K1's, batched:
    registers and buckets bit-identical to JAX's batched kernel."""
    spec = tp.random_sketch_spec(5, log2ms=(8,), buckets=256)
    plan = DevicePlan(**spec)
    cols, plist, nds, idx = member_inputs(5, spec, form, np.float32,
                                          inputs=tp.sketch_inputs)
    got = run_port_batched(plan, cols, plist, nds, idx, torch.float32)
    check_members(spec, plan, form, cols, plist, nds, idx, torch.float32,
                  False, got)
    ref = run_jax_batched(spec, form, cols, plist, nds, idx, False)
    scales = scales_of(plan, cols, plist, nds, idx)
    for m in range(got.shape[0]):
        tp.assert_packed_equal(spec, got[m], ref[m], scales[m], False,
                               fma=True)


TOPN_CASES = [(order, asc, form) for order, asc in
              (("col", False), ("ids", True), ("expr", False),
               ("none", True))
              for form in ("broadcast-3", "stacked-4")]


@pytest.mark.parametrize("order,asc,form", TOPN_CASES)
@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_batched_topn_matches_single_and_jax(order, asc, form, x64):
    """K4's batched form: the whole [B, S, 1 + k] output bit-identical to
    each member's single launch and to JAX's batched top-N."""
    spec = tp.topn_spec(9, order, asc, k=17)
    plan = DevicePlan(**spec)
    vdt = torch.float64 if x64 else torch.float32
    cols, plist, nds, idx = member_inputs(
        9, spec, form, np.float64 if x64 else np.float32,
        inputs=tp.topn_inputs)
    got = run_port_batched(plan, cols, plist, nds, idx, vdt)
    check_members(spec, plan, form, cols, plist, nds, idx, vdt, x64, got)
    ref = run_jax_batched(spec, form, cols, plist, nds, idx, x64)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("sets,n_nds,idx", [
    (1, 1, [0, 0]),        # a set index per member: 3 members, 2 indexes
    (2, 1, [0, 1, 1]),     # num_docs per column set
    (2, 2, [0, 2, 1]),     # an index past the sets
])
def test_batched_kernel_rejects_member_lists_that_disagree(sets, n_nds,
                                                           idx):
    """The batched kernel takes any member count, but its lists must
    agree: one set index per member's parameters, one num_docs per column
    set, every index naming a set. Building it compiles nothing."""
    spec = tp.random_spec(41, False)
    plan = DevicePlan(**spec)
    cols, params, nd = tp.random_inputs(41, spec, S, D, np.float32)
    tc, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    t0 = program.trace_count()
    run = tk.batched_kernel(plan)
    assert program.trace_count() == t0
    with pytest.raises(ValueError, match="members"):
        run([tc] * sets, [tpar] * 3, [tnd] * n_nds, idx, D)


# ---------------------------------------------------------------------------
# cross-table coalescing through the engine (tests/test_kernel_factory.py)
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Three tables of one plan shape, doc counts in one pow2 doc bucket
    (4096) and segment counts padding into one S bucket (4)."""
    tmp = tmp_path_factory.mktemp("txtab")
    return {"t1": build_table(tmp, "t1", 3, 3000, 1),
            "t2": build_table(tmp, "t2", 4, 2500, 2),
            "t3": build_table(tmp, "t3", 3, 3900, 3)}


def meter(eng, name):
    return eng.dispatcher._metrics.meter(name)


class TestCrossTableBatching:
    @pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
    def test_cross_table_coalesce_bit_identical(self, tables, x64):
        eng = make_engine(x64)
        names = ["t1", "t2", "t3", "t1", "t2", "t3"]
        sqls = [f"SELECT SUM(m), COUNT(*), MIN(m) FROM {tn} "
                f"WHERE d < {i + 2}" for i, tn in enumerate(names)]
        jobs = [(tables[tn][0], q) for tn, q in zip(names, sqls)]
        singles = singles_of(eng, jobs)
        m0 = meter(eng, "dispatch_batch_cross_table")
        got = run_concurrent(eng, jobs)
        assert [agg_values(r) for r in got] == singles
        assert meter(eng, "dispatch_batch_cross_table") > m0
        assert singles == [jax_values(tables[tn][1], [q], x64)[0]
                           for tn, q in zip(names, sqls)]

    def test_stacked_and_dedup_meters(self, tables):
        """Four distinct segment batches stack (no dedup); three members
        over two batches dedup one set. An extra active caller keeps every
        job off the inline fast path, so the batch is exactly the jobs."""
        eng = make_engine()
        sql = "SELECT SUM(m), COUNT(*) FROM x WHERE d < {}"
        stacked = [(tables["t1"][0], sql.format(3)),
                   (tables["t2"][0], sql.format(4)),
                   (tables["t3"][0], sql.format(5)),
                   (tables["t1"][0][::-1], sql.format(6))]
        dedup = [(tables["t1"][0], sql.format(3)),
                 (tables["t2"][0], sql.format(4)),
                 (tables["t1"][0], sql.format(5))]
        for jobs, variant, cross, dups in ((stacked, "stacked", 4, 0),
                                           (dedup, "dedup", 3, 1)):
            singles = singles_of(eng, jobs)
            c0 = meter(eng, "dispatch_batch_cross_table")
            d0 = meter(eng, "dispatch_batch_dedup")
            v0 = eng.dispatcher.stats()[variant]
            with eng.dispatcher.active():
                got = run_concurrent(eng, jobs)
            assert [agg_values(r) for r in got] == singles
            assert eng.dispatcher.stats()[variant] == v0 + 1
            assert meter(eng, "dispatch_batch_cross_table") == c0 + cross
            assert meter(eng, "dispatch_batch_dedup") == d0 + dups

    def test_bit_identical_property_random_tables_and_literals(self, tables):
        eng = make_engine()
        rng = np.random.default_rng(31)
        names = list(tables)
        for _trial in range(3):
            k = int(rng.integers(3, 8))
            picks = [names[j] for j in rng.integers(0, len(names), k)]
            bounds = rng.integers(0, 100, size=(k, 2))
            jobs = [(tables[tn][0],
                     "SELECT SUM(m), COUNT(*), MAX(m) FROM x "
                     f"WHERE m BETWEEN {min(a, b)} AND {max(a, b)} "
                     "AND d < 8") for tn, (a, b) in zip(picks, bounds)]
            singles = singles_of(eng, jobs)
            got = run_concurrent(eng, jobs)
            assert [agg_values(r) for r in got] == singles

    def test_group_by_cross_table_bit_identical(self, tables):
        eng = make_engine()
        jobs = [(tables[tn][0],
                 f"SELECT d, SUM(m) FROM x WHERE m BETWEEN {a} AND {a + 40} "
                 "GROUP BY d")
                for tn, a in (("t1", 0), ("t3", 10), ("t1", 20), ("t3", 30))]
        singles = singles_of(eng, jobs)
        got = run_concurrent(eng, jobs)
        assert [agg_values(r) for r in got] == singles

    def test_cross_table_disabled_keeps_same_batch_key(self, tables):
        eng = make_engine(**{
            "pinot.server.dispatch.batch.cross.table": False})
        jobs = [(tables[tn][0],
                 f"SELECT SUM(m), COUNT(*) FROM x WHERE d < {i + 2}")
                for i, tn in enumerate(["t1", "t2", "t1", "t2"])]
        singles = singles_of(eng, jobs)
        m0 = meter(eng, "dispatch_batch_cross_table")
        got = run_concurrent(eng, jobs)
        assert [agg_values(r) for r in got] == singles
        assert meter(eng, "dispatch_batch_cross_table") == m0

    def test_steady_state_cross_table_zero_codegen(self, tables):
        eng = make_engine()

        def round_of(base):
            run_concurrent(eng, [
                (tables[tn][0],
                 f"SELECT SUM(m), COUNT(*) FROM x WHERE d < {base + i}")
                for i, tn in enumerate(
                    ["t1", "t2", "t3", "t1", "t2", "t3", "t1", "t2"])])

        for tn in tables:
            singles_of(eng, [(tables[tn][0], "SELECT SUM(m), COUNT(*) "
                                             "FROM x WHERE d < 1")])
        round_of(0)
        round_of(1)
        before = program.trace_count()
        round_of(2)
        round_of(3)
        assert program.trace_count() == before


class TestBatchChaos:
    def test_one_erroring_member_fails_only_its_future(self, tables):
        eng = make_engine()
        jobs = [(tables[tn][0],
                 f"SELECT SUM(m), COUNT(*) FROM x WHERE d < {i + 2}")
                for i, tn in enumerate(["t1", "t2", "t1", "t2"])]
        singles = singles_of(eng, jobs)
        failpoints.arm("server.dispatch.batch",
                       error=FailpointError("member chaos"), times=1)
        outcomes = []
        try:
            failpoints.arm("server.dispatch.before", delay=0.3, times=2)
            with eng.dispatcher.active(), \
                    ThreadPoolExecutor(len(jobs)) as pool:
                futs = [pool.submit(eng.execute, s, QueryContext.from_sql(q))
                        for s, q in jobs]
                for i, f in enumerate(futs):
                    try:
                        assert agg_values(f.result(timeout=60)) == singles[i]
                        outcomes.append("ok")
                    except FailpointError:
                        outcomes.append("chaos")
        finally:
            failpoints.disarm("server.dispatch.before")
            failpoints.disarm("server.dispatch.batch")
        assert outcomes.count("chaos") == 1, outcomes
        assert singles_of(eng, jobs) == singles

    def test_seeded_batch_chaos_replays_exactly(self, tables):
        eng = make_engine()
        jobs = [(tables[tn][0],
                 f"SELECT SUM(m), COUNT(*) FROM x WHERE d < {i + 2}")
                for i, tn in enumerate(["t1", "t2", "t3", "t1"])]
        singles = singles_of(eng, jobs)
        run_concurrent(eng, jobs, hold=0.5)

        def run_round():
            fp = failpoints.arm("server.dispatch.batch",
                                error=FailpointError("batch chaos"),
                                probability=0.5, seed=4242)
            failed = 0
            try:
                for _ in range(3):
                    failpoints.arm("server.dispatch.before", delay=0.5,
                                   times=2)
                    try:
                        # an extra active caller keeps every job off the
                        # inline fast path: the same batch each round
                        with eng.dispatcher.active(), \
                                ThreadPoolExecutor(len(jobs)) as pool:
                            futs = [pool.submit(eng.execute, s,
                                                QueryContext.from_sql(q))
                                    for s, q in jobs]
                            for i, f in enumerate(futs):
                                try:
                                    assert agg_values(f.result(timeout=60)) \
                                        == singles[i]
                                except FailpointError:
                                    failed += 1
                    finally:
                        failpoints.disarm("server.dispatch.before")
            finally:
                failpoints.disarm("server.dispatch.batch")
            return failed, list(fp.decisions)

        f1, d1 = run_round()
        f2, d2 = run_round()
        assert d1 == d2, "same-seed batch chaos journals diverged"
        assert f1 == f2 and f1 > 0


class TestCodegenObservability:
    def test_kernel_retrace_meter_has_plan_label(self, tables):
        eng = make_engine()
        sql = "SELECT SUM(m), MIN(m), MAX(m) FROM t3 WHERE m < {} AND d < 9"
        run_concurrent(eng, [(tables["t3"][0], sql.format(k))
                             for k in (42, 43, 44)])
        plan, _slots = eng._plan(tables["t3"][0],
                                 QueryContext.from_sql(sql.format(42)))
        fp = tk.plan_fingerprint(plan)
        reg = eng.dispatcher._metrics
        assert reg.meter("kernel_retrace_by_plan", labels={"plan": fp}) > 0
        assert reg.meter("kernel_retrace") > 0
        assert tk.trace_count_by_plan().get(fp, 0) > 0
