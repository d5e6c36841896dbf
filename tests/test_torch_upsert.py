"""The port's upsert validity mask against the JAX package's: the Bitmap
(pinot_tpu_torch/segment/bitmap.py), the FULL-upsert manager
(segment/upsert.py), the engine's version-stamped `vmask` block through the
staging levels, its coalescing identity, and the masked plain K1-K4.

Three ways on the same segments (built by the JAX creator, loaded by each
package's own loader; each package's own Bitmap attached to its own
segment objects): the JAX host executor (use_tpu=False, the oracle), the
JAX engine (use_tpu=True) and `QueryExecutor(device="cpu")` of the port,
after interleaved clear()s and `PartitionUpsertMetadataManager.add_row`
upserts that leave both packages' managers with the same bitmaps. Both
precision postures. Rows equal under tests/queries/harness.py
`assert_responses_equal` (rel 1e-9, exact for ints and strings), and
`num_docs_scanned` equal.
"""
from concurrent.futures import ThreadPoolExecutor

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
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.segment.bitmap import Bitmap as JaxBitmap
from pinot_tpu.segment.upsert import \
    PartitionUpsertMetadataManager as JaxManager
from pinot_tpu_torch.ops import kernels, residency
from pinot_tpu_torch.ops.engine import TorchOperatorExecutor
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.bitmap import Bitmap
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.upsert import PartitionUpsertMetadataManager
from pinot_tpu_torch.utils.failpoints import failpoints

from tests.queries.harness import assert_responses_equal, build_segments

POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
#: tests/test_upsert_device.py's five queries and a LIMIT-only selection
SQLS = [
    "SELECT COUNT(*), SUM(m), MIN(m), MAX(m) FROM t WHERE d < 12 LIMIT 10",
    "SELECT COUNT(*) FROM t LIMIT 10",
    "SELECT s, COUNT(*), SUM(m) FROM t GROUP BY s ORDER BY s LIMIT 20",
    "SELECT d, m FROM t WHERE m > 5000 ORDER BY m DESC LIMIT 25",
    "SELECT DISTINCT s FROM t LIMIT 20",
    "SELECT d, s, m FROM t LIMIT 700",
]
N = 3000


def _columns(i):
    rng = np.random.default_rng([11, i])
    return {"d": rng.integers(0, 20, N).astype(np.int32),
            "s": np.array([f"v{x}" for x in rng.integers(0, 6, N)], object),
            "m": rng.integers(0, 10000, N).astype(np.int32),
            # a primary key with repeats inside and across segments, and a
            # comparison column whose ties go to the later row
            "pk": rng.integers(0, 2500, N).astype(np.int32),
            "ver": rng.integers(0, 50, N).astype(np.int32)}


@pytest.fixture()
def segs(tmp_path):
    """tests/test_upsert_device.py's table, with a primary key: (JAX
    segments, port segments, columns)."""
    schema = Schema("t", [
        FieldSpec("d", DataType.INT, FieldType.DIMENSION),
        FieldSpec("s", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("m", DataType.INT, FieldType.METRIC),
        FieldSpec("pk", DataType.INT, FieldType.DIMENSION),
        FieldSpec("ver", DataType.INT, FieldType.METRIC)])
    tc = TableConfig("t", TableType.OFFLINE)
    tc.indexing.no_dictionary_columns = ["m", "ver"]
    data = [_columns(i) for i in range(3)]
    jsegs = build_segments(tmp_path, schema, tc, data)
    return jsegs, [load_segment(str(tmp_path / f"seg_{i}"))
                   for i in range(3)], data


def _upsert_both(jsegs, tsegs, data):
    """Both managers over segments 0 and 1 (segment 2 stays append-only),
    then interleaved realtime rows: add_row upserts re-using docs of
    segment 1 as newer versions of segment 0's keys, and direct clear()s.
    Returns the two managers."""
    jm, tm = JaxManager(["pk"], "ver"), PartitionUpsertMetadataManager(
        ["pk"], "ver")
    for j, t in zip(jsegs[:2], tsegs[:2]):
        jm.add_segment(j, use_snapshot=False)
        tm.add_segment(t, use_snapshot=False)
    rng = np.random.default_rng(5)
    for step in range(60):
        doc = int(rng.integers(0, N))
        if step % 3 == 0:
            jsegs[0].valid_doc_ids.clear(doc)
            tsegs[0].valid_doc_ids.clear(doc)
            continue
        rec = {"pk": int(data[0]["pk"][doc]), "ver": 100 + step}
        jm.add_row(jsegs[1], doc, rec)
        tm.add_row(tsegs[1], doc, rec)
    return jm, tm


def _three_way(jsegs, tsegs, sql, x64, engine=None):
    with jax.enable_x64(x64):
        host = JaxExecutor(jsegs, use_tpu=False).execute(sql)
        dev = JaxExecutor(jsegs, use_tpu=True,
                          engine=TpuOperatorExecutor()).execute(sql)
    port = QueryExecutor(tsegs, device="cpu",
                         value_dtype=torch.float64 if x64 else torch.float32)
    if engine is not None:
        port.engine = engine
    got = port.execute(sql)
    for ref in (host, dev):
        assert not ref.exceptions, (sql, ref.exceptions)
        assert_responses_equal(ref, got, sql)
        assert ref.stats.num_docs_scanned == got.stats.num_docs_scanned, sql
    return got


def test_managers_leave_the_same_bitmaps(segs):
    jsegs, tsegs, data = segs
    jm, tm = _upsert_both(jsegs, tsegs, data)
    assert jm.num_primary_keys == tm.num_primary_keys
    for j, t in zip(jsegs[:2], tsegs[:2]):
        assert j.valid_doc_ids.to_bytes() == t.valid_doc_ids.to_bytes()
        assert j.valid_doc_ids.version == t.valid_doc_ids.version
        assert 0 < t.valid_doc_ids.cardinality() < N
    pk = (int(data[0]["pk"][0]),)
    jl, tl = jm.lookup(pk), tm.lookup(pk)
    assert (jl[0].name, jl[1]) == (tl[0].name, tl[1])
    assert getattr(tsegs[2], "valid_doc_ids", None) is None


@POSTURES
@pytest.mark.parametrize("sql", SQLS)
def test_queries_three_ways_after_upserts(segs, sql, x64):
    jsegs, tsegs, data = segs
    _upsert_both(jsegs, tsegs, data)
    got = _three_way(jsegs, tsegs, sql, x64)
    assert got.rows


@POSTURES
def test_interleaved_upserts_between_queries(segs, x64):
    """One engine across rounds: each round's clear()s show in its next
    answer, three ways."""
    jsegs, tsegs, data = segs
    _upsert_both(jsegs, tsegs, data)
    eng = TorchOperatorExecutor(
        "cpu", torch.float64 if x64 else torch.float32)
    for rnd in range(3):
        for sql in SQLS:
            _three_way(jsegs, tsegs, sql, x64, engine=eng)
        for seg in (jsegs[rnd % 2], tsegs[rnd % 2]):
            v = seg.valid_doc_ids
            for doc in [d for d in range(N) if v.contains(d)][:150]:
                v.clear(doc)


def test_fully_masked_segment(segs):
    jsegs, tsegs, data = segs
    _upsert_both(jsegs, tsegs, data)
    for seg in (jsegs[0], tsegs[0]):
        for d in range(N):
            if seg.valid_doc_ids.contains(d):
                seg.valid_doc_ids.clear(d)
    for sql in SQLS:
        _three_way(jsegs, tsegs, sql, False)


def test_stale_mask_restages_one_row(segs):
    """An in-place clear() changes the next answer; the re-staging uploads
    exactly that segment's one mask row (one byte per doc of its
    power-of-two bucket), a repeat nothing, and the superseded row leaves
    the resident tier and the host rows."""
    _jsegs, tsegs, data = segs
    for seg in tsegs[:2]:
        seg.valid_doc_ids = Bitmap.all_set(N)
    eng = TorchOperatorExecutor("cpu", torch.float32)
    ctx = QueryContext.from_sql(SQLS[0])

    def count():
        return int(sum(float(r.intermediates[0])
                       for r in eng.execute(tsegs, ctx)))
    first = count()
    assert first == sum(int((c["d"] < 12).sum()) for c in data)
    b0 = residency.column_transfer_bytes()
    assert count() == first
    assert residency.column_transfer_bytes() == b0
    victims = np.flatnonzero(data[1]["d"] < 12)[:7]
    for d in victims:
        tsegs[1].valid_doc_ids.clear(int(d))
    assert count() == first - len(victims)
    assert residency.column_transfer_bytes() - b0 == 4096  # pow2(3000) x 1
    kinds = {k[2] for k in eng.residency._entries if k[1] == tsegs[1].name
             and k[3] == "__valid__"}
    assert kinds == {f"vmask:{tsegs[1].valid_doc_ids.version}"}
    assert sum(1 for k in eng._blocks if k[1] == "vmask") == 1
    assert sum(1 for k in eng._host_rows if k[0] == id(tsegs[1])
               and k[1].startswith("vmask:")) == 1
    b1 = residency.column_transfer_bytes()
    count()
    assert residency.column_transfer_bytes() == b1


def test_members_with_other_stamps_keep_their_own_set(segs):
    """Two coalesced launches over one segment batch whose bitmap moved
    between their stagings: each keeps its own column set (a stacked
    batch, not a broadcast of one member's mask), and each answers as its
    own staging's snapshot."""
    _jsegs, tsegs, data = segs
    for seg in tsegs[:2]:
        seg.valid_doc_ids = Bitmap.all_set(N)
    eng = TorchOperatorExecutor("cpu", torch.float32)
    ctx = QueryContext.from_sql(SQLS[1])
    want_a = sum(c["d"].size for c in data)
    eng.execute(tsegs, ctx)  # compile and stage outside the batch
    before = eng.dispatcher.stats()
    with eng.dispatcher.active(), eng.dispatcher.active():
        with eng._engine_lock:
            launch_a, asm_a = eng._prepare(tsegs, ctx, None)
            tsegs[0].valid_doc_ids.clear(0)
            launch_b, asm_b = eng._prepare(tsegs, ctx, None)
        assert launch_a.batch_key == launch_b.batch_key
        assert launch_a.cols_key != launch_b.cols_key
        with failpoints.armed("server.dispatch.before", delay=0.5, times=1):
            fa = eng.dispatcher.submit(launch_a)
            fb = eng.dispatcher.submit(launch_b)
            got_a = asm_a(fa.result(timeout=60))
            got_b = asm_b(fb.result(timeout=60))
    stats = eng.dispatcher.stats()
    stats.subtract(before)
    assert stats["stacked"] == 1 and stats["broadcast"] == 0, stats
    assert sum(int(r.intermediates[0]) for r in got_a) == want_a
    assert sum(int(r.intermediates[0]) for r in got_b) == want_a - 1
    # each launch's column-set identity carries the stamps it staged
    assert launch_b.cols_key[1] == tuple(
        s.valid_doc_ids.version if getattr(s, "valid_doc_ids", None)
        is not None else -1 for s in tsegs)
    assert launch_a.cols_key[1][0] == launch_b.cols_key[1][0] - 1


def test_equal_stamps_still_broadcast(segs):
    _jsegs, tsegs, _data = segs
    for seg in tsegs[:2]:
        seg.valid_doc_ids = Bitmap.all_set(N)
        seg.valid_doc_ids.clear(3)
    eng = TorchOperatorExecutor("cpu", torch.float32)
    sqls = [f"SELECT COUNT(*), SUM(m) FROM t WHERE d < {k}"
            for k in (5, 9, 13, 17)]
    alone = [eng.execute(tsegs, QueryContext.from_sql(q)) for q in sqls]
    before = eng.dispatcher.stats()
    with failpoints.armed("server.dispatch.before", delay=0.5, times=1), \
            eng.dispatcher.active(), ThreadPoolExecutor(len(sqls)) as pool:
        got = [f.result(timeout=60) for f in [
            pool.submit(eng.execute, tsegs, QueryContext.from_sql(q))
            for q in sqls]]
    stats = eng.dispatcher.stats()
    stats.subtract(before)
    assert stats["broadcast"] == 1 and stats[("size", 4)] == 1, stats
    for a, b in zip(alone, got):
        assert [list(map(float, r.intermediates)) for r in a] == \
            [list(map(float, r.intermediates)) for r in b]


def test_star_tree_guard_keeps_partial_bitmaps_on_the_scan(tmp_path):
    from pinot_tpu_torch.models import DataType as TD
    from pinot_tpu_torch.models import FieldSpec as TF
    from pinot_tpu_torch.models import FieldType as TT
    from pinot_tpu_torch.models import Schema as TS
    from pinot_tpu_torch.models import StarTreeIndexConfig
    from pinot_tpu_torch.models import TableConfig as TC
    from pinot_tpu_torch.segment.creator import SegmentCreator
    tc = TC("st")
    tc.indexing.star_tree_configs = [StarTreeIndexConfig(
        ["d"], [], ["SUM__m", "COUNT__*"])]
    rng = np.random.default_rng(5)
    d, m = rng.integers(0, 8, 2000).astype(np.int32), \
        rng.integers(0, 100, 2000).astype(np.int32)
    SegmentCreator(tc, TS("st", [TF("d", TD.INT),
                                 TF("m", TD.INT, TT.METRIC)])).build(
        {"d": d, "m": m}, str(tmp_path / "s"), "st_0")
    seg = load_segment(str(tmp_path / "s"))
    ex = QueryExecutor([seg], device="cpu")
    sql = "SELECT SUM(m), COUNT(*) FROM st WHERE d < 4"
    seg.valid_doc_ids = Bitmap.all_set(2000)
    assert ex.execute(sql).rows == [(float(m[d < 4].sum()),
                                     int((d < 4).sum()))]
    assert ex.engine.meter("startree_served") == 1
    victim = int(np.flatnonzero(d < 4)[0])
    seg.valid_doc_ids.clear(victim)
    assert ex.execute(sql).rows == [(float(m[d < 4].sum() - m[victim]),
                                     int((d < 4).sum()) - 1)]
    assert ex.engine.meter("startree_served") == 1


OPS = [("clear", 5), ("set", 5), ("clear", 0), ("clear", 12), ("set", 40),
       ("resize", 47), ("set", 46), ("clear", 46), ("clear", 0)]


@pytest.mark.parametrize("n", [1, 8, 13, 41])
def test_bitmap_matches_jax(n):
    """Version counter, is_full, cardinality, bytes and masks after the
    same mutations; from_mask / from_bytes / from_indices round trips."""
    j, t = JaxBitmap.all_set(n), Bitmap.all_set(n)
    assert j.to_bytes() == t.to_bytes() and t.is_full() and j.is_full()
    for op, doc in OPS:
        if op == "resize":
            if doc <= n:
                continue
            j.resize(doc)
            t.resize(doc)
        elif doc < j.num_docs:
            getattr(j, op)(doc)
            getattr(t, op)(doc)
        assert j.version == t.version
        assert j.to_bytes() == t.to_bytes()
        assert j.is_full() == t.is_full()
        assert j.cardinality() == t.cardinality()
        np.testing.assert_array_equal(j.to_mask(), t.to_mask())
        for k in (0, 1, 3, 50):  # the LIMIT-only scan's prefix read
            np.testing.assert_array_equal(
                t.first_set(k), np.flatnonzero(j.to_mask())[:k])
    assert t.version > 0
    mask = np.random.default_rng(n).random(n) < 0.5
    assert JaxBitmap.from_mask(mask).to_bytes() == \
        Bitmap.from_mask(mask).to_bytes()
    assert Bitmap.from_bytes(t.num_docs, t.to_bytes()) == t
    idx = np.flatnonzero(mask)
    assert JaxBitmap.from_indices(n, idx).to_bytes() == \
        Bitmap.from_indices(n, idx).to_bytes()


def test_masked_plain_kernels_drop_invalid_docs():
    """The plain K1-K4 with a validity mask equal the same plan without one
    over the docs the mask keeps (the mask as one more filter conjunct)."""
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
    g = torch.Generator().manual_seed(3)
    S, D = 3, 512
    cols = {"ids:a": torch.randint(0, 9, (S, D), generator=g,
                                   dtype=torch.int8),
            "val:v": torch.randint(0, 1000, (S, D), generator=g
                                   ).to(torch.float32)}
    vmask = (torch.rand((S, D), generator=g) < 0.6).to(torch.uint8)
    nd = torch.tensor([512, 300, 0], dtype=torch.int32)
    params = {"leaf0:lo": torch.tensor([1, 0, 0], dtype=torch.int32),
              "leaf0:hi": torch.tensor([7, 8, 8], dtype=torch.int32)}
    base = dict(filter_ir=("leaf", 0), leaves=(DeviceLeaf("range", "a"),),
                dict_cols=("a",), raw_cols=("v",))
    plans = [
        DevicePlan(value_irs=(("col", "v"),), agg_ops=(
            ("count", None, None), ("sum", 0, None), ("max", 0, None)),
            **base),
        DevicePlan(value_irs=(("col", "v"),), agg_ops=(
            ("sum", 0, None), ("count", None, None)), group_cols=("a",),
            group_strides=(1,), num_groups=9, **base),
        DevicePlan(value_irs=(("col", "v"),), agg_ops=(), mode="topn",
                   topn_k=20, topn_asc=False, **base),
    ]
    for plan in plans:
        masked = DevicePlan(**{**plan.__dict__, "valid_mask": True})
        run = kernels.make_topn_kernel if plan.mode == "topn" \
            else kernels.make_kernel
        got = run(masked, torch.float32)({**cols, "vmask": vmask}, params,
                                         nd, D)
        # the same plan with the mask folded into the ids as a miss
        folded = dict(cols, **{"ids:a": torch.where(
            vmask.bool(), cols["ids:a"], torch.tensor(-1, dtype=torch.int8))})
        want = run(plan, torch.float32)(folded, params, nd, D)
        assert torch.equal(got, want), plan.mode
