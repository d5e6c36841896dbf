"""The port's staging levels (pinot_tpu_torch/ops/residency.py and the
engine's host rows, resident rows and assembled blocks) on the CPU, against
the JAX package's (tests/test_residency.py's behaviours that need no
server).

  * admission: ResidencyManager's TinyLFU policy (a cold scan cannot flush
    the hot set, repeated traffic earns admission, seeded accesses bypass
    the duel, frequency ages out, invalidation spares the live object);
  * cross-batch residency: a recomposed batch uploads exactly the rows the
    device has never seen, in exact transfer-odometer bytes (equal to the
    JAX engine's own odometer on the same scenario), and a repeat uploads
    no column byte; answers bit-identical to a fresh engine's;
  * invalidation: `invalidate_segment` spares the live object and drops
    every level, the params cache included; a same-name new object never
    serves stale rows;
  * warm-up: `prestage` then the query uploads no column byte, on the scan
    path and the star-tree leg; `residency_seeding` seeds admissions;
    `drop_caches(host=True)` empties every level;
  * the row assembler: the plain version (the CPU side of K6) against the
    JAX `compiled_row_assembler` bit for bit, in its stack form (every row
    full) and its zeros-plus-slices form, at every staged element size.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.ops import kernels as jk
from pinot_tpu.ops import residency as jres
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import residency
from pinot_tpu_torch.ops.residency import ResidencyManager
from pinot_tpu_torch.query.context import QueryContext

from tests.test_torch_dispatch import agg_values, build_table, make_engine

SQL = "SELECT SUM(m), COUNT(*) FROM t WHERE d < 5"


def _seg(name):
    return SimpleNamespace(name=name)


class TestAdmissionPolicy:
    def test_cold_scan_cannot_flush_hot_set(self):
        rm = ResidencyManager(300, admission=True, sample_window=10_000)
        hot = [_seg(f"h{i}") for i in range(3)]
        for s in hot:
            assert rm.get(s, "ids", "c", "i1") is None
            assert rm.admit(s, "ids", "c", "i1", object(), 100)
        for _ in range(5):
            for s in hot:
                assert rm.get(s, "ids", "c", "i1") is not None
        for i in range(5):
            c = _seg(f"cold{i}")
            rm.get(c, "ids", "c", "i1")
            assert not rm.admit(c, "ids", "c", "i1", object(), 100)
        assert rm.rejected == 5
        for s in hot:
            assert rm.get(s, "ids", "c", "i1") is not None

    def test_repeated_traffic_earns_admission(self):
        rm = ResidencyManager(200, admission=True, sample_window=10_000)
        a, b = _seg("a"), _seg("b")
        for s in (a, b):
            rm.get(s, "ids", "c", "i1")
            assert rm.admit(s, "ids", "c", "i1", object(), 100)
        new = _seg("new")
        for _ in range(4):  # misses count toward admission credit
            rm.get(new, "ids", "c", "i1")
        assert rm.admit(new, "ids", "c", "i1", object(), 100)
        assert rm.evicted == 1 and rm.bytes == 200

    def test_seeded_admission_bypasses_duel(self):
        rm = ResidencyManager(200, admission=True, sample_window=10_000)
        for name in ("a", "b"):
            s = _seg(name)
            for _ in range(10):
                rm.get(s, "ids", "c", "i1")
            rm.admit(s, "ids", "c", "i1", object(), 100)
        warm = _seg("warm")
        with rm.seeding():
            rm.get(warm, "ids", "c", "i1")
            assert rm.admit(warm, "ids", "c", "i1", object(), 100)
        assert rm.get(warm, "ids", "c", "i1") is not None
        assert rm.frequency("warm", "ids", "c") == 1 + rm.SEED_BOOST + 1

    def test_frequency_ages_out(self):
        rm = ResidencyManager(1000, admission=True, sample_window=64)
        s = _seg("s")
        for _ in range(40):
            rm.get(s, "ids", "c", "i1")
        peak = rm.frequency("s", "ids", "c")
        for i in range(40):
            rm.get(_seg(f"o{i}"), "ids", "c", "i1")
        assert rm.frequency("s", "ids", "c") < peak

    def test_invalidate_spares_live_object(self):
        rm = ResidencyManager(1000)
        old, new = _seg("x"), _seg("x")
        rm.admit(old, "ids", "c", "i1", object(), 10)
        rm.admit(new, "ids", "c", "i1", object(), 10)
        assert rm.invalidate_segment("x", keep=new) == 1
        assert rm.get(new, "ids", "c", "i1") is not None
        assert rm.get(old, "ids", "c", "i1") is None

    def test_invalidate_superseded_kind_keeps_the_current_stamp(self):
        rm = ResidencyManager(1000)
        s = _seg("x")
        for kind in ("vmask:1", "vmask:2", "vmask:3"):
            rm.admit(s, kind, "__valid__", "|b1", object(), 10)
        assert rm.invalidate_superseded_kind(s, "vmask:", "vmask:3",
                                             "__valid__") == 2
        assert len(rm) == 1 and rm.bytes == 10
        assert rm.get(s, "vmask:3", "__valid__", "|b1") is not None

    @pytest.mark.parametrize("admission", [True, False])
    def test_policy_matches_jax_on_a_seeded_trace(self, admission):
        """One seeded access trace through both managers: the same
        admissions, refusals, evictions and resident set."""
        rng = np.random.default_rng(7)
        segs = [_seg(f"s{i}") for i in range(12)]
        ours = ResidencyManager(500, admission=admission, sample_window=64)
        ref = jres.ResidencyManager(500, admission=admission,
                                    sample_window=64)
        for step in range(400):
            s = segs[int(min(rng.zipf(1.5), 12)) - 1]
            col = str(rng.choice(["a", "b"]))
            seeded = step % 50 == 0
            for rm in (ours, ref):
                if seeded:
                    with rm.seeding():
                        hit = rm.get(s, "ids", col, "i1")
                        if hit is None:
                            rm.admit(s, "ids", col, "i1", object(), 100)
                else:
                    hit = rm.get(s, "ids", col, "i1")
                    if hit is None:
                        rm.admit(s, "ids", col, "i1", object(), 100)
        for attr in ("hits", "misses", "admitted", "rejected", "evicted",
                     "bytes"):
            assert getattr(ours, attr) == getattr(ref, attr), attr
        assert list(ours._entries) == list(ref._entries)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    return build_table(tmp_path_factory.mktemp("tres"), "t", 3, 4000, 11)


def _rows_bytes(segs, eng):
    """The bytes of the rows SQL stages for `segs`: ids:d as int8 and val:m
    in the value dtype, each padded to the segment's power-of-two bucket."""
    item = 1 + np.dtype(eng._vdt).itemsize
    return sum(max(128, 1 << (s.num_docs - 1).bit_length()) * item
               for s in segs)


class TestCrossBatchResidency:
    @pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
    def test_changed_batch_ships_only_new_rows(self, table, x64):
        segs, jsegs, _data = table
        eng = make_engine(x64)
        ctx = QueryContext.from_sql(SQL)
        c0 = residency.column_transfer_bytes()
        eng.execute(segs[:2], ctx)
        assert residency.column_transfer_bytes() - c0 \
            == _rows_bytes(segs[:2], eng)
        # a subset of resident segments: nothing crosses
        c1 = residency.column_transfer_bytes()
        sub = eng.execute(segs[1:2], ctx)
        assert residency.column_transfer_bytes() == c1
        # a new segment joins: exactly its rows
        m0 = eng.residency.misses
        res = eng.execute(segs, ctx)
        new_bytes = residency.column_transfer_bytes() - c1
        assert new_bytes == _rows_bytes(segs[2:], eng)
        assert eng.residency.misses - m0 == 2
        # a repeat: the assembled block, no column byte
        c2 = residency.column_transfer_bytes()
        assert agg_values(eng.execute(segs, ctx)) == agg_values(res)
        assert residency.column_transfer_bytes() == c2
        # bit-identical to a fresh engine, and the JAX engine's odometer
        # counts the same bytes for the same recomposition
        assert agg_values(res) == agg_values(make_engine(x64).execute(
            segs, ctx))
        assert agg_values(sub) == agg_values(make_engine(x64).execute(
            segs[1:2], ctx))
        with jax.enable_x64(x64):
            jeng = TpuOperatorExecutor()
            jctx = JaxContext.from_sql(SQL)
            jeng.execute(jsegs[:2], jctx)
            j1 = jres.column_transfer_bytes()
            jeng.execute(jsegs, jctx)
            assert jres.column_transfer_bytes() - j1 == new_bytes

    def test_group_by_blocks_ride_residency(self, table):
        segs, _j, _d = table
        eng = make_engine()
        ctx = QueryContext.from_sql("SELECT d, SUM(m) FROM t GROUP BY d")
        eng.execute(segs, ctx)
        c0 = residency.column_transfer_bytes()
        res = eng.execute(segs[:2], ctx)
        assert residency.column_transfer_bytes() == c0
        assert agg_values(res) == agg_values(make_engine().execute(
            segs[:2], ctx))

    def test_tier_off_uploads_whole_blocks(self, table):
        """pinot.server.hbm.resident.enabled=false: each block miss uploads
        every row of the block (no resident row to reuse), in exact row
        bytes, keeps none of them resident, and answers the same."""
        segs, _j, _d = table
        eng = make_engine(**{"pinot.server.hbm.resident.enabled": False})
        ctx = QueryContext.from_sql(SQL)
        c0 = residency.column_transfer_bytes()
        res = eng.execute(segs, ctx)
        assert residency.column_transfer_bytes() - c0 == _rows_bytes(segs,
                                                                     eng)
        assert len(eng.residency) == 0
        # another batch of the same segments ships its rows again
        c1 = residency.column_transfer_bytes()
        eng.execute(segs[:2], ctx)
        assert residency.column_transfer_bytes() - c1 == _rows_bytes(
            segs[:2], eng)
        assert len(eng.residency) == 0
        assert agg_values(res) == agg_values(make_engine().execute(segs,
                                                                   ctx))

    def test_cold_scan_keeps_the_hot_rows_through_the_engine(self, table):
        """A budget that holds one batch's rows: a second table's one-pass
        scan is refused retention, the hot rows stay resident."""
        segs, _j, _d = table
        eng = make_engine(**{"pinot.server.hbm.resident.bytes":
                             _rows_bytes(segs[:2], make_engine())})
        ctx = QueryContext.from_sql(SQL)
        for _ in range(3):  # the block cache would answer without a row
            eng._blocks.clear()  # lookup, so each round reads the rows
            eng.execute(segs[:2], ctx)
        hot = {s.name: eng.residency.resident_for(s.name) for s in segs[:2]}
        eng.execute(segs[2:], ctx)
        assert eng.residency.rejected > 0
        assert {s.name: eng.residency.resident_for(s.name)
                for s in segs[:2]} == hot == {segs[0].name: 2,
                                              segs[1].name: 2}


class TestInvalidation:
    def test_same_name_new_object_never_serves_stale(self, tmp_path):
        from tests.test_torch_dispatch import build_table as bt
        eng = make_engine()
        ctx = QueryContext.from_sql("SELECT SUM(m), COUNT(*) FROM t")
        v1 = bt(tmp_path / "v1", "t", 1, 500, 1)[0][0]
        v2 = bt(tmp_path / "v2", "t", 1, 500, 2)[0][0]
        assert v1.name == v2.name
        want1 = agg_values(make_engine().execute([v1], ctx))
        want2 = agg_values(make_engine().execute([v2], ctx))
        assert want1 != want2
        assert agg_values(eng.execute([v1], ctx)) == want1
        assert agg_values(eng.execute([v2], ctx)) == want2
        assert agg_values(eng.execute([v1], ctx)) == want1

    def test_invalidate_segment_drops_every_level(self, table, tmp_path):
        segs, _j, _d = table
        eng = make_engine()
        ctx = QueryContext.from_sql(SQL)
        eng.execute(segs, ctx)
        name = segs[0].name
        live = build_table(tmp_path, "t", 1, 4000, 99)[0][0]
        assert live.name == name
        eng.execute([live], ctx)
        assert eng.residency.resident_for(name) == 4
        eng.invalidate_segment(name, keep=live)
        # the live object's rows and blocks stay; the old object's went
        assert eng.residency.resident_for(name) == 2
        assert all(e[0] is live for k, e in eng.residency._entries.items()
                   if k[1] == name)
        assert not any(any(s is segs[0] for s in e[0])
                       for e in eng._blocks.values())
        assert any(e[0] == (live,) for e in eng._blocks.values())
        assert not any(v[0] is segs[0] for v in eng._host_rows.values())
        eng.invalidate_segment(name)
        assert eng.residency.resident_for(name) == 0
        assert not any(v[0].name == name for v in eng._host_rows.values())
        assert agg_values(eng.execute(segs, ctx)) == agg_values(
            make_engine().execute(segs, ctx))


@pytest.fixture(scope="module")
def st_table(tmp_path_factory):
    from tests.test_torch_startree import _build
    from pinot_tpu_torch.segment.loader import load_segment
    tmp = tmp_path_factory.mktemp("tres_st")
    return [load_segment(d) for d in _build("port", tmp, "st", True)]


ST_SQL = "SELECT SUM(impressions), COUNT(*) FROM st WHERE country = 'c3'"


class TestWarmup:
    @pytest.mark.parametrize("sql", [SQL, "SELECT d, MAX(m) FROM t "
                                          "GROUP BY d",
                                     "SELECT d, m FROM t WHERE d = 3 "
                                     "ORDER BY m DESC LIMIT 5",
                                     "SELECT DISTINCT d FROM t WHERE m < 9"])
    def test_prestage_then_query_uploads_no_column_byte(self, table, sql):
        segs, _j, _d = table
        eng = make_engine()
        ctx = QueryContext.from_sql(sql)
        assert eng.prestage(segs, ctx)
        c0 = residency.column_transfer_bytes()
        eng.execute(segs, ctx)
        assert residency.column_transfer_bytes() == c0

    def test_prestage_warms_the_star_tree_leg(self, st_table):
        eng = make_engine()
        ctx = QueryContext.from_sql(ST_SQL)
        assert eng.prestage(st_table, ctx)
        assert eng._params_cache and all(k[1] == "startree"
                                         for k in eng._blocks)
        t0 = residency.transfer_bytes()
        res = eng.execute(st_table, ctx)
        assert residency.transfer_bytes() == t0  # no column, no params
        assert eng.meter("startree_served") == 1
        assert agg_values(res) == agg_values(make_engine().execute(
            st_table, ctx))
        # sum__impressions and count__* as exact-sum digit rows (hi, lo)
        assert all(eng.residency.resident_for(s.name) == 4 for s in st_table)

    def test_star_tree_rows_stay_out_of_the_tier_when_asked(self, st_table):
        eng = make_engine(**{"pinot.server.startree.hbm.resident": False})
        ctx = QueryContext.from_sql(ST_SQL)
        res = eng.execute(st_table, ctx)
        assert len(eng.residency) == 0 and eng._blocks
        assert agg_values(res) == agg_values(make_engine().execute(
            st_table, ctx))

    def test_prestage_refuses_what_the_engine_refuses(self, table):
        segs, _j, _d = table
        eng = make_engine()
        assert not eng.prestage(segs, QueryContext.from_sql(
            "SELECT COVAR_POP(m, d) FROM t"))
        assert not eng.prestage(segs, QueryContext.from_sql(
            "SELECT d FROM t LIMIT 5"))     # first docs: nothing staged
        assert not eng.prestage([], QueryContext.from_sql(SQL))
        assert not eng._blocks

    def test_seeding_and_drop_caches(self, table):
        segs, _j, _d = table
        eng = make_engine()
        ctx = QueryContext.from_sql(SQL)
        with eng.residency_seeding():
            assert eng.prestage(segs[:1], ctx)
        name = segs[0].name
        assert eng.residency.frequency(name, "val", "m") \
            == 1 + eng.residency.SEED_BOOST
        assert eng.residency.resident_for(name) == 2
        eng.drop_caches(host=False)
        assert not eng._blocks and len(eng.residency) == 0
        assert eng._host_rows
        eng.drop_caches()
        assert not eng._host_rows and not eng._params_cache


ASSEMBLER_DTYPES = ["int8", "int16", "int32", "float32", "float64", "bool"]


@pytest.mark.parametrize("dtype", ASSEMBLER_DTYPES)
@pytest.mark.parametrize("form", ["stack", "slices"])
def test_plain_assembler_matches_jax_bit_for_bit(dtype, form):
    """K6's plain version against `compiled_row_assembler`: the stack form
    (every row D long, S rows) and the zeros-plus-slices form (mixed row
    lengths, padded segments)."""
    rng = np.random.default_rng(3)
    S, D = (5, 256) if form == "stack" else (8, 512)
    lens = [D] * S if form == "stack" else [512, 128, 256, 512, 128]
    if dtype == "bool":
        rows = [rng.random(n) < 0.5 for n in lens]
    elif dtype.startswith("float"):
        rows = [rng.standard_normal(n).astype(dtype) for n in lens]
        rows[0][:3] = [np.nan, -0.0, np.inf]
    else:
        info = np.iinfo(dtype)
        rows = [rng.integers(info.min, info.max, n, dtype=dtype,
                             endpoint=True) for n in lens]
    got = tk.row_assemble([torch.from_numpy(r) for r in rows], S, D).numpy()
    with jax.enable_x64(dtype == "float64"):
        fn = jk.compiled_row_assembler(S, D, tuple(lens),
                                       np.dtype(dtype).str)
        want = np.asarray(fn(tuple(jnp.asarray(r) for r in rows)))
    assert got.dtype == want.dtype and got.shape == want.shape == (S, D)
    assert got.tobytes() == want.tobytes()


def test_assembler_wrapper_takes_cpu_or_card_rows_only():
    rows = [torch.arange(4, dtype=torch.int32)]
    assert tk.assemble_rows(rows, 2, 8).tolist() == [[0, 1, 2, 3, 0, 0, 0, 0],
                                                      [0] * 8]
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.assemble_rows([r.to("meta") for r in rows], 2, 8)
    with pytest.raises(ValueError, match="rows for a block"):
        tk.row_assemble(rows * 3, 2, 8)
