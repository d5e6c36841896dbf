"""The port's vector similarity slice against the JAX package's: the vector
index (pinot_tpu_torch/segment/vector_index.py) and its creator and loader
wiring, the vector leg's host half and the plain K8
(pinot_tpu_torch/ops/vector_device.py), `vector_similarity` SQL from the
port's QueryExecutor(device="cpu"), and the MSE leaf's `filtered_doc_ids`.

  * index: VectorIndex bytes equal JAX's for exact and IVF indexes, the
    round trip, typed corruption on torn payloads; the creator's and the
    loader's index equal JAX's; a block-fed vector column (json_rows)
    writes the segment the same strings write, and its strings parse back
    to the block bit for bit
  * kernel: the plain K8 against `compiled_vector_kernel` and
    `make_batched_vector_kernel` (broadcast and stacked) on seeded inputs
    (exact, IVF, a residual filter, the validity mask, K not a power of
    two, exact ties, +-0.0 scores, NaN rows) and on the JAX engine's own
    staging; the JAX kernel adds in XLA's order, so scores agree within
    torch_plans.VEC_TOL (2^-20: cosines of unit vectors) and ids in order
    wherever neighbouring scores differ by more than that, as sets inside
    such a band (torch_plans.same_vector_rows)
  * SQL three ways (the JAX engine, the JAX host path, the port), both
    precision postures: exact tables against VectorIndex.top_k, IVF
    tables, the residual filter chosen after K (K before filter),
    LIMIT / OFFSET and upserts; rows equal, or equal outside a band of
    near-tied scores at a segment's cut
  * every fallback reason, with its meter count
  * 8 query vectors in one held batch: one launch, no codegen
  * filtered_doc_ids against the JAX engine's
  * chip_smoke.py's vector generator and writer at a small size
"""
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.models import DataType as JDataType
from pinot_tpu.models import FieldSpec as JFieldSpec
from pinot_tpu.models import FieldType as JFieldType
from pinot_tpu.models import Schema as JSchema
from pinot_tpu.models import TableConfig as JTableConfig
from pinot_tpu.ops import vector_device as jvd
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.ops.plan_ir import DeviceLeaf as JLeaf
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.segment.bitmap import Bitmap as JaxBitmap
from pinot_tpu.segment.creator import SegmentCreator as JCreator
from pinot_tpu.segment.loader import load_segment as jload
from pinot_tpu.segment.vector_index import VectorIndex as JIndex
from pinot_tpu.utils.config import PinotConfiguration as JaxConfig
from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType, Schema,
                                    TableConfig)
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import program
from pinot_tpu_torch.ops import vector_device as tvd
from pinot_tpu_torch.ops.engine import NotOffloadable, TorchOperatorExecutor
from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment import index_types as it
from pinot_tpu_torch.segment.bitmap import Bitmap
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.vector_index import (VectorIndex,
                                                  VectorIndexCorruption,
                                                  json_rows)
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.failpoints import failpoints

from tests import torch_plans as tp

POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
DIM, K = 8, 5


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


def _vectors(seed, n, d=DIM):
    """tests/test_vector_device.py's clustered embeddings."""
    centers = np.random.default_rng(100).normal(size=(8, d)) * 2.0
    rng = np.random.default_rng(seed)
    which = rng.integers(0, len(centers), n)
    return (centers[which] + 0.3 * rng.normal(size=(n, d))
            ).astype(np.float32)


def _json(row):
    return json.dumps([float(x) for x in row])


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cells", [(300, None), (5000, None), (600, 7)])
def test_index_bytes_equal_jax(n, cells):
    v = _vectors(n, n)
    ours, theirs = VectorIndex.build(v, n_cells=cells), \
        JIndex.build(v, n_cells=cells)
    assert ours.to_bytes() == theirs.to_bytes()
    assert (ours.centroids is None) == (n < VectorIndex.IVF_THRESHOLD
                                        and cells is None)
    back = VectorIndex.from_bytes(theirs.to_bytes())
    assert back.to_bytes() == ours.to_bytes() and back.metric == "cosine"
    q = _vectors(n + 1, 3)
    for qv in q:
        assert np.array_equal(ours.top_k(qv, 10), theirs.top_k(qv, 10))
        a, b = ours.probe_cells(qv), theirs.probe_cells(qv)
        assert (a is None and b is None) or np.array_equal(a, b)


def test_torn_payloads_raise_typed_corruption():
    buf = VectorIndex.build(_vectors(1, 5000)).to_bytes()
    for cut in (0, 5, 17, len(buf) // 2, len(buf) - 1):
        with pytest.raises(VectorIndexCorruption):
            VectorIndex.from_bytes(buf[:cut])
    assert issubclass(VectorIndexCorruption, ValueError)
    l2 = VectorIndex.build(_vectors(2, 50), metric="l2")
    assert VectorIndex.from_bytes(l2.to_bytes()).metric == "l2"


def test_json_rows_parse_back_bit_for_bit():
    rng = np.random.default_rng(3)
    v = (rng.normal(size=(3000, 13)) * np.exp(rng.normal(size=(3000, 13))
                                                * 8)).astype(np.float32)
    v[0, :6] = [0.0, -0.0, 1.4e-45, -3.4028235e38, 1e-40, 9.999999e-5]
    rows = json_rows(v)
    back = np.asarray([json.loads(r) for r in rows], np.float32)
    assert np.array_equal(back.view(np.uint32), v.view(np.uint32))
    assert len({len(r) for r in rows}) == 1
    with pytest.raises(ValueError):
        json_rows(np.array([[np.nan]], np.float32))


def _schema(cls_schema, cls_spec, cls_dt, cls_ft):
    return cls_schema("emb", [
        cls_spec("id", cls_dt.INT, cls_ft.DIMENSION),
        cls_spec("cat", cls_dt.INT, cls_ft.DIMENSION),
        cls_spec("vec", cls_dt.STRING, cls_ft.DIMENSION)])


def _build(tmp, name, i, n, creator="jax", block=False, no_dict=False):
    """Segment i of the emb table: id, a category of 4 values, and the
    vectors as JSON strings (or, block=True, as the float32 block)."""
    v = _vectors(7 + i, n)
    cols = {"id": np.arange(n, dtype=np.int32) + i * 100_000,
            "cat": np.random.default_rng(i).integers(0, 4, n).astype(
                np.int32),
            "vec": v if block else np.array([_json(r) for r in v], object)}
    out = str(tmp / name)
    if creator == "jax":
        tc = JTableConfig("emb")
        tc.indexing.vector_index_columns = ["vec"]
        JCreator(tc, _schema(JSchema, JFieldSpec, JDataType,
                             JFieldType)).build(cols, out, name)
    else:
        tc = TableConfig("emb")
        tc.indexing.vector_index_columns = ["vec"]
        if no_dict:
            tc.indexing.no_dictionary_columns = ["vec"]
            tc.indexing.compression = "PASS_THROUGH"
        SegmentCreator(tc, _schema(Schema, FieldSpec, DataType,
                                   FieldType)).build(cols, out, name)
    return out


@pytest.mark.parametrize("n", [300, 4200])
def test_creators_and_loaders_write_and_read_the_same_index(tmp_path, n):
    a = _build(tmp_path, "a", 0, n, "port")
    b = _build(tmp_path, "b", 0, n, "jax")
    ta, tb = load_segment(a), load_segment(b)
    assert bytes(ta.dir.get_buffer("vec", it.VECTOR)) == \
        bytes(tb.dir.get_buffer("vec", it.VECTOR))
    assert ta.metadata.columns["vec"].indexes[-1] == it.VECTOR
    assert jload(a).metadata.columns["vec"].indexes[-1] == it.VECTOR
    for path, seg in ((a, ta), (b, tb)):
        ours = seg.data_source("vec").vector_index
        theirs = jload(path).data_source("vec").vector_index
        assert ours.to_bytes() == theirs.to_bytes()
        assert (ours.centroids is None) == (n < VectorIndex.IVF_THRESHOLD)
    assert ta.data_source("id").vector_index is None


def test_block_column_writes_the_segment_its_strings_write(tmp_path):
    """The creator's block path (chip_smoke.py's writer) renders
    json_rows and writes the bytes of the same column given as those
    strings; the JAX creator indexes those strings to the same index."""
    v = _vectors(11, 4500)
    tc = TableConfig("emb")
    tc.indexing.vector_index_columns = ["vec"]
    tc.indexing.no_dictionary_columns = ["vec"]
    tc.indexing.compression = "PASS_THROUGH"
    schema = _schema(Schema, FieldSpec, DataType, FieldType)
    base = {"id": np.arange(4500, dtype=np.int32),
            "cat": np.zeros(4500, np.int32)}
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    SegmentCreator(tc, schema).build({**base, "vec": v}, a, "s")
    strings = json_rows(v)
    SegmentCreator(tc, schema).build({**base, "vec": strings}, b, "s")
    sa, sb = load_segment(a), load_segment(b)
    for key in (it.FORWARD, it.VECTOR):
        assert bytes(sa.dir.get_buffer("vec", key)) == \
            bytes(sb.dir.get_buffer("vec", key))
    ma, mb = sa.metadata.columns["vec"], sb.metadata.columns["vec"]
    assert (ma.min_value, ma.max_value, ma.indexes) == \
        (mb.min_value, mb.max_value, mb.indexes)
    assert list(sa.data_source("vec").values()) == strings
    jt = JTableConfig("emb")
    jt.indexing.vector_index_columns = ["vec"]
    jt.indexing.no_dictionary_columns = ["vec"]
    jt.indexing.compression = "PASS_THROUGH"
    c = str(tmp_path / "c")
    JCreator(jt, _schema(JSchema, JFieldSpec, JDataType, JFieldType)).build(
        {**base, "vec": np.array(strings, object)}, c, "s")
    assert bytes(jload(c).dir.get_buffer("vec", it.VECTOR)) == \
        bytes(sa.dir.get_buffer("vec", it.VECTOR))
    assert bytes(jload(c).dir.get_buffer("vec", it.FORWARD)) == \
        bytes(sa.dir.get_buffer("vec", it.FORWARD))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _jax_plan(spec):
    return jvd.VectorPlan(
        col=spec["vec_col"], dim_pad=spec["dim_pad"], k_pad=spec["k_pad"],
        ivf=spec["ivf"], cells_pad=spec["cells_pad"],
        filter_ir=spec["filter_ir"],
        leaves=tuple(JLeaf(*lf) for lf in spec["leaves"]),
        dict_cols=spec["dict_cols"], valid_mask=spec["valid_mask"])


KERNEL_CASES = {"exact": {}, "ivf": {"ivf": True},
                "residual": {"resid": True},
                "vmask": {"vmask": True},
                "ivf+residual+vmask": {"ivf": True, "resid": True,
                                       "vmask": True},
                "k=37": {"k": 37}, "k=1": {"k": 1},
                "ties": {"special": "ties"},
                "signed zeros": {"special": "zeros", "dim": 8, "k": 40},
                "nan": {"special": "nan"},
                "d=96": {"dim": 96, "k": 100}}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
@pytest.mark.parametrize("seed", range(2))
def test_plain_kernel_matches_jax(case, seed):
    D = 700
    spec, cols, params, nd = tp.vector_case(seed, S=4, D=D,
                                            **KERNEL_CASES[case])
    ref = np.asarray(jvd.compiled_vector_kernel(_jax_plan(spec))(
        {k: jnp.asarray(v) for k, v in cols.items()},
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(nd),
        D=D))
    got = tk.make_vector_kernel(tp.vector_plan(spec))(
        *tk.from_jax_staged(cols, params, nd), D).numpy()
    assert got.shape == ref.shape == (4, 1 + 2 * min(spec["k_pad"], D))
    tp.same_vector_rows(ref, got, tp.vector_truth(spec, cols, params, nd),
                        min(spec["k_pad"], D))


def test_signed_zero_and_tie_order_is_xla_order():
    """+0.0 above -0.0, equal scores toward the lower doc, a NaN row above
    every score and never kept: the ids in order, exactly as lax.top_k."""
    for special, dim in (("zeros", 8), ("ties", 16), ("nan", 16)):
        spec, cols, params, nd = tp.vector_case(5, S=3, D=400, dim=dim,
                                                k=128, special=special)
        ref = np.asarray(jvd.compiled_vector_kernel(_jax_plan(spec))(
            {k: jnp.asarray(v) for k, v in cols.items()},
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(nd), D=400))
        got = tk.make_vector_kernel(tp.vector_plan(spec))(
            *tk.from_jax_staged(cols, params, nd), 400).numpy()
        kk = spec["k_pad"]
        truth = tp.vector_truth(spec, cols, params, nd)
        for s, (exact, cand, _r, k) in enumerate(truth):
            if special != "nan" and tp.near_ties(exact, cand, k, kk):
                continue  # only ties that are exact, or far apart
            assert np.array_equal(got[s, :1 + kk], ref[s, :1 + kk]), special
        if special == "zeros":
            sc = got[0, 1 + kk:1 + 2 * kk]
            signs = np.signbit(sc[sc == 0])
            # every +0.0 ahead of every -0.0, both present
            assert signs.any() and not signs.all() \
                and np.all(np.diff(signs.astype(int)) >= 0)
        if special == "nan":
            assert any(int(got[s, 0]) < min(128, int(nd[s]))
                       for s in range(len(nd)) if nd[s])


@pytest.mark.parametrize("stacked", [False, True], ids=["broadcast",
                                                        "stacked"])
def test_plain_batched_matches_jax_batched(stacked):
    D, B = 600, 4
    members = [tp.vector_case(20 + m, S=3, D=D, ivf=True, resid=True)
               for m in range(B)]
    spec = members[0][0]
    kk = min(spec["k_pad"], D)
    jfn = jvd.make_batched_vector_kernel(_jax_plan(spec), B, stacked)
    jp = [{k: jnp.asarray(v) for k, v in p.items()}
          for _s, _c, p, _n in members]
    staged = [tk.from_jax_staged(c, p, nd) for _s, c, p, nd in members]
    if stacked:
        ref = jfn([{k: jnp.asarray(v) for k, v in c.items()}
                   for _s, c, _p, _n in members], jp,
                  [jnp.asarray(nd) for *_x, nd in members], D=D)
        sets, ndl, idx = [x[0] for x in staged], [x[2] for x in staged], \
            list(range(B))
    else:
        ref = jfn({k: jnp.asarray(v) for k, v in members[0][1].items()}, jp,
                  jnp.asarray(members[0][3]), D=D)
        sets, ndl, idx = [staged[0][0]], [staged[0][2]], [0] * B
    got = tk.batched_kernel(tp.vector_plan(spec))(
        sets, [x[1] for x in staged], ndl, idx, D).numpy()
    ref = np.asarray(ref)
    for m in range(B):
        src = members[m] if stacked else (spec, members[0][1],
                                          members[m][2], members[0][3])
        tp.same_vector_rows(ref[m], got[m], tp.vector_truth(*src), kk)
        single = tk.make_vector_kernel(tp.vector_plan(spec))(
            sets[idx[m]], staged[m][1], ndl[idx[m]], D).numpy()
        assert np.array_equal(single.view(np.int32), got[m].view(np.int32))


def test_dot_order_is_the_kernels_lanes():
    """dot_scores adds chunk by chunk onto -0.0 and then down a lane tree:
    the same float32 additions K8 makes, so every sum of -0.0 products
    stays -0.0 and a sum over padding equals the unpadded one."""
    rng = np.random.default_rng(0)
    for dp in (8, 16, 64, 128, 256):
        v = torch.from_numpy(rng.normal(size=(50, dp)).astype(np.float32))
        q = torch.from_numpy(rng.normal(size=dp).astype(np.float32))
        got = tvd.dot_scores(v, q)
        p = (v * q).numpy()
        nch, L = dp // 4, min(32, dp // 4)
        want = np.full((50, L), -0.0, np.float32)
        for j in range(nch // L):
            for e in range(4):
                want = want + p[:, 4 * (j * L + np.arange(L)) + e]
        while L > 1:
            L //= 2
            want = want[:, :L] + want[:, L:2 * L]
        assert np.array_equal(got.numpy().view(np.uint32),
                              want[:, 0].view(np.uint32))
    neg = torch.tensor([[-0.0] * 4 + [-0.5] * 4])
    assert str(float(tvd.dot_scores(neg, torch.tensor(
        [0.5] * 4 + [0.0] * 4))[0])) == "-0.0"


# ---------------------------------------------------------------------------
# SQL three ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """Two tables built by the JAX creator, loaded by each package's
    loader: `emb` (400 and 4200 docs: an exact and an IVF segment) and
    `embx` (two exact segments)."""
    tmp = tmp_path_factory.mktemp("torch_vec")
    out = {}
    for table, sizes in (("emb", (400, 4200)), ("embx", (300, 350))):
        dirs = [_build(tmp, f"{table}{i}", i, n)
                for i, n in enumerate(sizes)]
        out[table] = ([load_segment(d) for d in dirs],
                      [jload(d) for d in dirs])
    return out


def _sql(qv, k=K, table="emb", where="", limit=100, offset=0):
    tail = f" LIMIT {limit}" + (f" OFFSET {offset}" if offset else "")
    return (f"SELECT id FROM {table} WHERE vector_similarity(vec, "
            f"'{_json(qv)}', {k}){where}{tail}")


def _jax_rows(jsegs, sql, x64):
    with jax.enable_x64(x64):
        dev = JaxExecutor(jsegs, use_tpu=True,
                          engine=TpuOperatorExecutor(config=JaxConfig()))
        host = JaxExecutor(jsegs, use_tpu=False)
        a, b = dev.execute(sql), host.execute(sql)
    assert not a.exceptions and not b.exceptions, (a.exceptions,
                                                   b.exceptions)
    return [tuple(r) for r in a.rows], [tuple(r) for r in b.rows], a


def _port(tsegs, x64, **kw):
    return QueryExecutor(tsegs, device="cpu",
                         value_dtype=torch.float64 if x64 else torch.float32,
                         **kw)


def _band(tsegs, qv, k):
    """The ids within 2 VEC_TOL of a segment's K-th candidate score (its
    probe cells' docs with IVF), where sums in other orders may cross the
    cut."""
    q = (qv / max(float(np.linalg.norm(qv)), 1e-30)).astype(np.float32)
    band = set()
    for seg in tsegs:
        ix = seg.data_source("vec").vector_index
        probe = ix.probe_cells(q)
        cand = np.arange(len(ix.vectors)) if probe is None \
            else np.nonzero(np.isin(ix.assignments, probe))[0]
        exact = ix.vectors[cand].astype(np.float64) @ q.astype(np.float64)
        if len(cand) > k:
            t = np.sort(exact)[::-1][k - 1]
            near = cand[np.abs(exact - t) <= 2 * tp.VEC_TOL]
            if len(near) > 1:
                ids = seg.data_source("id").values()
                band |= set(ids[near].tolist())
    return band


def _agree(got, want, band, limit=100):
    if not band:
        assert got == want
        return
    g = [r for r in got if r[0] not in band]
    w = [r for r in want if r[0] not in band]
    if len(got) < limit and len(want) < limit:
        assert g == w
    else:
        m = max(0, min(len(g), len(w)) - len(band))
        assert g[:m] == w[:m]


def _queries(tsegs, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ix = tsegs[int(rng.integers(0, len(tsegs)))].data_source(
            "vec").vector_index
        base = ix.vectors[int(rng.integers(0, len(ix.vectors)))]
        out.append((base + 0.05 * rng.normal(size=DIM)).astype(np.float32))
    return out


@POSTURES
@pytest.mark.parametrize("table", ["emb", "embx"])
def test_vector_sql_three_ways(segs, x64, table):
    tsegs, jsegs = segs[table]
    ex = _port(tsegs, x64)
    for i, qv in enumerate(_queries(tsegs, 6, 40 + x64)):
        k = (K, 17, 1)[i % 3]
        sql = _sql(qv, k, table)
        dev, host, jresp = _jax_rows(jsegs, sql, x64)
        resp = ex.execute(sql)
        got = [tuple(r) for r in resp.rows]
        band = _band(tsegs, qv, k)
        _agree(got, dev, band)
        _agree(got, host, band)
        # every segment's winners: VectorIndex.top_k's, in doc order
        want = []
        for seg in tsegs:
            ix = seg.data_source("vec").vector_index
            ids = seg.data_source("id").values()
            want += [(int(ids[d]),) for d in np.sort(ix.top_k(qv, k))]
        _agree(got, want, band)
        if not band:
            assert resp.stats.num_docs_scanned == \
                jresp.stats.num_docs_scanned
            assert resp.stats.num_entries_scanned_in_filter == \
                jresp.stats.num_entries_scanned_in_filter
    assert ex.engine.meter("vector_served") == 6


@POSTURES
def test_residual_filter_applies_after_k(segs, x64):
    """K before filter: the residual conjunct drops winners and never
    promotes a loser, on all three paths."""
    tsegs, jsegs = segs["emb"]
    ex = _port(tsegs, x64)
    for i, qv in enumerate(_queries(tsegs, 4, 60 + x64)):
        where = (" AND cat = 1", " AND cat BETWEEN 1 AND 2",
                 " AND id > 100", " AND cat <> 3")[i]
        sql = _sql(qv, 20, where=where)
        dev, host, _ = _jax_rows(jsegs, sql, x64)
        got = [tuple(r) for r in ex.execute(sql).rows]
        band = _band(tsegs, qv, 20)
        _agree(got, dev, band)
        _agree(got, host, band)
        plain = [tuple(r) for r in ex.execute(_sql(qv, 20)).rows]
        assert set(got) <= set(plain)


@POSTURES
def test_limit_and_offset(segs, x64):
    tsegs, jsegs = segs["emb"]
    ex = _port(tsegs, x64)
    (qv,) = _queries(tsegs, 1, 70)
    band = _band(tsegs, qv, 30)
    for limit, offset in ((7, 0), (10, 25), (100, 3), (5, 58)):
        sql = _sql(qv, 30, limit=limit, offset=offset)
        dev, host, _ = _jax_rows(jsegs, sql, x64)
        got = [tuple(r) for r in ex.execute(sql).rows]
        _agree(got, dev, band, limit)
        _agree(got, host, band, limit)


@POSTURES
def test_upserted_segments_three_ways(segs, x64, tmp_path):
    """Superseded docs leave the winners after selection (the validity
    mask is a residual), in both packages' own bitmaps."""
    tsegs = [load_segment(_build(tmp_path, f"u{i}", i, n))
             for i, n in enumerate((400, 4200))]
    jsegs = [jload(str(tmp_path / f"u{i}")) for i in range(2)]
    rng = np.random.default_rng(8)
    for t, j in zip(tsegs, jsegs):
        t.valid_doc_ids = Bitmap.all_set(t.num_docs)
        j.valid_doc_ids = JaxBitmap.all_set(j.num_docs)
        for d in rng.choice(t.num_docs, t.num_docs // 3, replace=False):
            t.valid_doc_ids.clear(int(d))
            j.valid_doc_ids.clear(int(d))
    ex = _port(tsegs, x64)
    for qv in _queries(tsegs, 3, 80 + x64):
        sql = _sql(qv, 25)
        dev, host, _ = _jax_rows(jsegs, sql, x64)
        got = [tuple(r) for r in ex.execute(sql).rows]
        band = _band(tsegs, qv, 25)
        _agree(got, dev, band)
        _agree(got, host, band)


def test_host_half_matches_jax(segs):
    """split_filter, parse_args, admit, query_params, unpack and
    merge_top_k against the JAX package's on the same segments and SQL."""
    tsegs, jsegs = segs["emb"]
    (qv,) = _queries(tsegs, 1, 93)
    vs = f"vector_similarity(vec, '{_json(qv)}', 9)"
    for where in (vs, f"{vs} AND cat = 2", f"cat = 2 AND {vs} AND id > 3",
                  f"{vs} OR cat = 2", f"NOT {vs}", f"{vs} AND {vs}",
                  "cat = 2"):
        sql = f"SELECT id FROM emb WHERE {where} LIMIT 5"
        ours = tvd.split_filter(QueryContext.from_sql(sql).filter)
        theirs = jvd.split_filter(JaxContext.from_sql(sql).filter)
        assert [x is None for x in ours] == [x is None for x in theirs]
        assert str(ours[1]) == str(theirs[1]) and ours[2] == theirs[2]
        if ours[0] is not None:
            a, b = tvd.parse_args(ours[0]), jvd.parse_args(theirs[0])
            assert a[0] == b[0] and a[2] == b[2] and np.array_equal(a[1],
                                                                  b[1])
    for args in (("vec", qv, 9, 8192), ("vec", qv, 0, 8192),
                 ("vec", qv[:5], 9, 8192), ("id", qv, 9, 8192),
                 ("vec", qv, 9000, 8192)):
        assert tvd.admit(tsegs, *args) == jvd.admit(jsegs, *args)
    (dim_pad, ivf, cells_pad), _ = tvd.admit(tsegs, "vec", qv, 9, 8192)
    jplan = jvd.VectorPlan(col="vec", dim_pad=dim_pad, k_pad=16, ivf=ivf,
                           cells_pad=cells_pad)
    plan = DevicePlan(filter_ir=None, leaves=(), value_irs=(), agg_ops=(),
                      mode="vector", vec_col="vec", dim_pad=dim_pad,
                      k_pad=16, ivf=ivf, cells_pad=cells_pad)
    ours = tvd.query_params(tsegs, plan, qv, 9, 4)
    theirs = jvd.query_params(jsegs, jplan, qv, 9, 4)
    assert ours.keys() == theirs.keys() == {"vq:q", "vq:k", "vq:cells"}
    for key in ours:
        assert np.array_equal(ours[key], theirs[key]), key
    for seg, jseg in zip(tsegs, jsegs):
        assert np.array_equal(tvd.vector_row(seg, "vec", 8, 8192),
                              jvd.vector_row(jseg, "vec", 8, 8192))
        assert np.array_equal(tvd.cell_row(seg, "vec", 8192),
                              jvd.cell_row(jseg, "vec", 8192))
    rng = np.random.default_rng(4)
    packed = np.full((3, 1 + 2 * 8), -1.0, np.float32)
    packed[:, 9:] = -np.inf
    for s_ in range(3):
        n = int(rng.integers(0, 9))
        packed[s_, 0] = n
        packed[s_, 1:1 + n] = rng.choice(100, n, replace=False)
        packed[s_, 9:9 + n] = np.sort(rng.integers(0, 4, n) / 4)[::-1]
    for s_ in range(3):
        for a, b in zip(tvd.unpack(packed[s_]), jvd.unpack(packed[s_])):
            assert np.array_equal(a, b)
    for k in (1, 5, 30):
        assert tvd.merge_top_k(packed, 3, k) == jvd.merge_top_k(packed, 3, k)


@pytest.mark.parametrize("table,probe", [
    ("emb", "staged"), ("emb", "every cell"), ("emb", "no cell"),
    ("embx", "staged")])
def test_candidate_bound_equals_the_plain_candidates(segs, table, probe):
    """K8's host-side bound ('vq:nc', vector_device.candidate_counts) is
    each row's candidate count as the plain version finds it: the probed
    cells' docs on the IVF segment, every doc on the exact one and under
    the every-cell fall-back, none on padded rows."""
    tsegs, _j = segs[table]
    (qv,) = _queries(tsegs, 1, 94)
    eng = TorchOperatorExecutor("cpu", torch.float32)
    with eng._engine_lock:
        plan, (fn, q, k), rctx = eng._plan_vector(
            tsegs, QueryContext.from_sql(_sql(qv, table=table)))
        cols, params, nd, D = eng._stage_vector(tsegs, rctx, plan, fn, q, k,
                                                None)
    S = int(nd.shape[0])
    assert params["vq:nc"].device.type == "cpu"
    ivf = [s.data_source("vec").vector_index.centroids is not None
           for s in tsegs]
    assert plan.ivf == any(ivf)
    if probe != "staged":
        # the IVF segment's row: every cell (the fall-back) or none
        cells = params["vq:cells"].clone()
        for s, has in enumerate(ivf):
            if has:
                cells[s] = probe == "every cell"
        params = dict(params, **{"vq:cells": cells})
    cells = params["vq:cells"].numpy() if plan.ivf else None
    got = tvd.candidate_counts(tsegs, plan, cells, S)
    want = tvd.candidates(plan, cols, params, nd, D).sum(1).numpy()
    assert got.dtype == np.int32 and got.shape == (S,)
    assert np.array_equal(got, want)
    if probe == "staged":
        assert np.array_equal(params["vq:nc"].numpy(), want)
    assert not got[len(tsegs):].any()
    if probe == "every cell":
        assert list(got[:len(tsegs)]) == [s.num_docs for s in tsegs]
    if probe == "no cell":
        assert list(got[:len(tsegs)]) == [0 if has else s.num_docs
                                          for s, has in zip(tsegs, ivf)]


class _StubSeg:
    """A segment reduced to what `candidate_counts` reads: num_docs and a
    vector index with cells."""

    def __init__(self, num_docs, assignments, n_cells):
        a = np.asarray(assignments, np.int32)
        counts = np.bincount(a, minlength=n_cells)
        self.num_docs = num_docs
        self.index = type("Ix", (), dict(
            centroids=np.zeros((n_cells, 2), np.float32), assignments=a,
            cell_doc_counts=lambda _self: counts))()

    def data_source(self, col):
        return type("Ds", (), {"vector_index": self.index})()


def test_candidate_bound_never_undercounts():
    """Where an index's cells could miss a candidate the plain version
    counts, the bound is num_docs: an assignment row shorter than its
    segment (`cell_row` stages the other docs in cell 0) and cell ids past
    the probe mask's width (clipped into its last cell); otherwise the
    probed cells' counts, equal to the plain count."""
    D, cells_pad = 16, 8
    segs = [_StubSeg(12, np.arange(12) % 4, 4),
            _StubSeg(12, np.arange(8) % 4, 4),
            _StubSeg(12, np.arange(12) % 10, 10)]
    plan = DevicePlan(filter_ir=None, leaves=(), value_irs=(), agg_ops=(),
                      dict_cols=(), mode="vector", valid_mask=False,
                      vec_col="vec", dim_pad=8, k_pad=8, ivf=True,
                      cells_pad=cells_pad)
    cells = np.zeros((4, cells_pad), bool)
    cells[:3, [0, 7]] = True
    got = tvd.candidate_counts(segs, plan, cells, 4)
    vcell = np.stack([tvd.cell_row(s, "vec", D) for s in segs]
                     + [np.zeros(D, np.int32)])
    nd = torch.tensor([12, 12, 12, 0], dtype=torch.int32)
    want = tvd.candidates(plan, {"vcell:vec": torch.from_numpy(vcell)},
                          {"vq:cells": torch.from_numpy(cells)}, nd,
                          D).sum(1).numpy()
    assert list(want) == [3, 6, 5, 0]
    assert list(got) == [3, 12, 12, 0]


@pytest.mark.parametrize("reader", ["unpack", "merge_top_k"])
def test_an_overflowed_row_raises(reader):
    """A packed row whose count is -1 (K8's mark of a list that outgrew
    its bound) raises where the host reads it, never passing as a row
    with no winners."""
    kk = 4
    good = np.array([1, 3, -1, -1, -1, 0.5, -np.inf, -np.inf, -np.inf],
                    np.float32)
    bad = np.array([-1] * (1 + kk) + [-np.inf] * kk, np.float32)
    with pytest.raises(RuntimeError, match="outgrew"):
        if reader == "unpack":
            tvd.unpack(bad)
        else:
            tvd.merge_top_k(np.stack([good, bad]), 2, 3)
    assert tvd.merge_top_k(good[None], 1, 3) == [(0, 3, 0.5)]


def test_vector_cap_takes_the_largest_member_bound():
    """The wrapper's list size (ops/_cuda.py `vector_cap`), computed on the
    host: the largest 'vq:nc' over the members, clipped to [1, D]; D
    where a member carries none."""
    from pinot_tpu_torch.ops import _cuda
    nc = [torch.tensor(v, dtype=torch.int32)
          for v in ([5, 900, 0], [7, 3, 0], [0, 0, 0])]
    assert _cuda.vector_cap([{"vq:nc": nc[0]}, {"vq:nc": nc[1]}], 4096) == 900
    assert _cuda.vector_cap([{"vq:nc": nc[0]}], 512) == 512
    assert _cuda.vector_cap([{"vq:nc": nc[2]}], 512) == 1
    assert _cuda.vector_cap([{"vq:nc": nc[0]}, {}], 4096) == 4096


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_fallback_reasons_and_meters(segs, tmp_path):
    tsegs, _j = segs["emb"]
    (qv,) = _queries(tsegs, 1, 90)
    ex = _port(tsegs, False)
    lit = _json(qv)
    vs = f"vector_similarity(vec, '{lit}', 5)"
    cases = [
        (f"SELECT id FROM emb WHERE {vs} OR cat = 1 LIMIT 10", "hybrid"),
        (f"SELECT id FROM emb WHERE NOT {vs} LIMIT 10", "hybrid"),
        (f"SELECT id FROM emb WHERE {vs} ORDER BY id LIMIT 10", "hybrid"),
        (f"SELECT id FROM emb WHERE {vs} AND {vs} LIMIT 10", "hybrid"),
        (f"SELECT id FROM emb WHERE vector_similarity(id, '{lit}', 5) "
         "LIMIT 10", "noIndex"),
        (f"SELECT id FROM emb WHERE vector_similarity(vec, '[1.0, 2.0]', "
         "5) LIMIT 10", "precision"),
        (f"SELECT id FROM emb WHERE vector_similarity(vec, '{lit}', 9000) "
         "LIMIT 10", "precision"),
    ]
    for sql, reason in cases:
        with pytest.raises(NotOffloadable) as e:
            ex.execute(sql)
        assert e.value.reason == reason, sql
    meters = {r: ex.engine.meter("vector_fallback", r)
              for r in tvd.FALLBACK_REASONS}
    assert meters == {"disabled": 0, "noIndex": 1, "metric": 0,
                      "hybrid": 4, "staging": 0, "precision": 2}
    assert ex.engine.meter("vector_served") == 0
    off = _port(tsegs, False, config=PinotConfiguration(
        overrides={"pinot.server.vector.enabled": False}))
    with pytest.raises(NotOffloadable) as e:
        off.execute(_sql(qv))
    assert e.value.reason == "disabled"
    assert off.engine.meter("vector_fallback", "disabled") == 1
    # a non-cosine index
    l2 = tmp_path / "l2"
    _build(tmp_path, "l2", 0, 300, "port")
    seg = load_segment(str(l2))
    seg.data_source("vec")._vector = VectorIndex.build(_vectors(7, 300),
                                                      metric="l2")
    ex2 = _port([seg], False)
    with pytest.raises(NotOffloadable) as e:
        ex2.execute(_sql(qv))
    assert e.value.reason == "metric"
    assert ex2.engine.meter("vector_fallback", "metric") == 1
    # outside a selection's filter: the slice's plain refusal
    with pytest.raises(NotOffloadable):
        ex.execute(f"SELECT COUNT(*) FROM emb WHERE {vs}")


def test_jax_reasons_match(segs):
    """The JAX engine meters the same reason for each refused shape."""
    tsegs, jsegs = segs["emb"]
    (qv,) = _queries(tsegs, 1, 91)
    vs = f"vector_similarity(vec, '{_json(qv)}', 5)"
    for where, order in ((f"{vs} OR cat = 1", ""), (vs, " ORDER BY id")):
        sql = f"SELECT id FROM emb WHERE {where}{order} LIMIT 10"
        jeng = TpuOperatorExecutor(config=JaxConfig(),
                                   metrics_labels={"vt": where[:5] + order})
        plan, reason, _ = jeng._plan_vector(jsegs,
                                            JaxContext.from_sql(sql))
        assert plan is None and reason == "hybrid"
        with pytest.raises(NotOffloadable) as e:
            _port(tsegs, False).execute(sql)
        assert e.value.reason == reason


# ---------------------------------------------------------------------------
# staging, coalescing, the MSE leaf
# ---------------------------------------------------------------------------

def test_plain_kernel_matches_jax_on_jax_staging(segs):
    """The JAX engine's own staging of a hybrid IVF query: its kernel and
    the port's plain K8 on the same arrays."""
    tsegs, jsegs = segs["emb"]
    (qv,) = _queries(tsegs, 1, 95)
    sql = _sql(qv, 12, where=" AND cat BETWEEN 1 AND 2")
    with jax.enable_x64(False):
        jeng = TpuOperatorExecutor(config=JaxConfig())
        ctx = JaxContext.from_sql(sql)
        with jeng._engine_lock:
            jplan, (fn, q, k), rctx = jeng._plan_vector(jsegs, ctx)
            cols, params, nd, _S, D = jeng._stage_vector_locked(
                jsegs, rctx, jplan, fn, q, k)
        ref = np.asarray(jvd.compiled_vector_kernel(jplan)(cols, params, nd,
                                                          D=D))
    cols = {k: np.asarray(v) for k, v in cols.items()}
    params = {k: np.asarray(v) for k, v in params.items()}
    plan = DevicePlan(
        filter_ir=jplan.filter_ir,
        leaves=tuple(DeviceLeaf(lf.kind, lf.column) for lf in jplan.leaves),
        value_irs=(),
        agg_ops=(), dict_cols=jplan.dict_cols, raw_cols=jplan.raw_cols,
        mode="vector", valid_mask=jplan.valid_mask, vec_col=jplan.col,
        dim_pad=jplan.dim_pad, k_pad=jplan.k_pad, ivf=jplan.ivf,
        cells_pad=jplan.cells_pad)
    got = tk.make_vector_kernel(plan)(*tk.from_jax_staged(
        cols, params, np.asarray(nd)), D).numpy()
    kk = min(plan.k_pad, D)
    for s in range(len(jsegs)):
        ix = tsegs[s].data_source("vec").vector_index
        g = tvd.unpack(got[s])
        r = tvd.unpack(ref[s])
        assert np.allclose(g[1], ix.vectors[g[0]] @ params["vq:q"][s][
            :DIM], atol=tp.VEC_TOL, rtol=0)
        if not _band(tsegs[s:s + 1], qv, 12):
            assert np.array_equal(g[0], r[0])
        assert got[s].shape == (1 + 2 * kk,)
    # the port's own staging: the same blocks and parameters
    eng = TorchOperatorExecutor("cpu", torch.float32)
    tctx = QueryContext.from_sql(sql)
    with eng._engine_lock:
        tplan, (tfn, tq, tk_), trctx = eng._plan_vector(tsegs, tctx)
        tcols, tparams, tnd, tD = eng._stage_vector(tsegs, trctx, tplan,
                                                    tfn, tq, tk_, None)
    assert tD == D and tplan.k_pad == plan.k_pad \
        and tplan.cells_pad == plan.cells_pad
    for key in ("vec:vec", "vcell:vec"):
        assert np.array_equal(tcols[key].numpy()[:len(jsegs)],
                              cols[key][:len(jsegs)])
    for key in ("vq:q", "vq:k", "vq:cells"):
        assert np.array_equal(tparams[key].numpy()[:len(jsegs)],
                              params[key][:len(jsegs)])


def test_eight_query_vectors_coalesce_in_one_held_batch(segs):
    """Fingerprint-equal queries with other vectors: one broadcast launch
    of 8 members, each answer bit-identical to the query alone, no
    program compiled by the batch, and no block re-staged."""
    tsegs, _j = segs["emb"]
    eng = TorchOperatorExecutor("cpu", torch.float32)
    sqls = [_sql(qv, 7) for qv in _queries(tsegs, 8, 99)]
    alone = [[r.rows for r in eng.execute(tsegs, QueryContext.from_sql(q))]
             for q in sqls]
    before = eng.dispatcher.stats()
    compiled = program.trace_count()
    with eng.dispatcher.active():
        failpoints.arm("server.dispatch.before", delay=0.3, times=2)
        try:
            with ThreadPoolExecutor(len(sqls)) as pool:
                futs = [pool.submit(eng.execute, tsegs,
                                    QueryContext.from_sql(q)) for q in sqls]
                got = [f.result(timeout=60) for f in futs]
        finally:
            failpoints.disarm("server.dispatch.before")
    assert [[r.rows for r in g] for g in got] == alone
    stats = eng.dispatcher.stats()
    stats.subtract(before)
    assert stats["broadcast"] == 1 and stats[("size", 8)] == 1
    assert program.trace_count() == compiled


def test_filtered_doc_ids_match_jax(segs):
    tsegs, jsegs = segs["emb"]
    eng = TorchOperatorExecutor("cpu", torch.float32)
    jeng = TpuOperatorExecutor(config=JaxConfig())
    for where in ("cat = 1", "cat = 1 AND id < 100050", "id > 1",
                  "cat IN (0, 3) OR id < 20"):
        sql = f"SELECT id FROM emb WHERE {where}"
        got = eng.filtered_doc_ids(tsegs, QueryContext.from_sql(sql).filter)
        with jax.enable_x64(False):
            want = jeng.filtered_doc_ids(jsegs,
                                         JaxContext.from_sql(sql).filter)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert np.array_equal(g, w) and g.dtype == np.int64
    assert eng.filtered_doc_ids(tsegs, None) == [None, None]
    vs = f"vector_similarity(vec, '{_json(_vectors(1, 1)[0])}', 5)"
    assert eng.filtered_doc_ids(tsegs, QueryContext.from_sql(
        f"SELECT id FROM emb WHERE {vs}").filter) == [None, None]


def test_filtered_doc_ids_overflow_gives_none(segs, monkeypatch):
    """More matches than K in a segment: None for that segment (the JAX
    engine's overflow rule), the others still served."""
    import pinot_tpu_torch.ops.engine as teng
    tsegs, _j = segs["emb"]
    monkeypatch.setattr(teng, "TOPN_MAX_K", 500)
    eng = TorchOperatorExecutor("cpu", torch.float32)
    got = eng.filtered_doc_ids(tsegs, QueryContext.from_sql(
        "SELECT id FROM emb WHERE cat = 1").filter)
    ids = [s.data_source("cat").values() for s in tsegs]
    assert np.array_equal(got[0], np.nonzero(ids[0] == 1)[0])
    assert (ids[1] == 1).sum() > 500 and got[1] is None


# ---------------------------------------------------------------------------
# chip_smoke.py's vector leg at a small size
# ---------------------------------------------------------------------------

def test_chip_smoke_vector_leg_on_the_cpu_engine(tmp_path, monkeypatch):
    """The vector leg's generator and writer (IVF and exact segments),
    vec.1-vec.4 through the port on the CPU equal to the smoke's host
    truth, the recall helper, and the MSE leaf's truth."""
    import chip_smoke as cs
    monkeypatch.setattr(cs, "VEC_DIM", 24)
    done = [cs.build_vector_segment(j) for j in
            cs.vector_jobs(str(tmp_path), 3, "vec", 2, 4500)]
    segs, indexes = cs.load_vector_segments(done)
    xsegs, xindexes = cs.load_vector_segments(
        [cs.build_vector_segment(j) for j in cs.vector_jobs(
            str(tmp_path), 3, "vecx", 2, 700, 100)])
    assert all(ix.centroids is not None for ix in indexes)
    assert all(ix.centroids is None for ix in xindexes)
    assert segs[1].data_source("id").values()[0] == 4500
    ex = QueryExecutor({"vec": segs, "vecx": xsegs}, device="cpu")
    for name, (sql, (want, band), limit) in cs.vector_queries(
            segs, indexes, xsegs, xindexes, 3).items():
        got = [tuple(r) for r in ex.execute(sql).rows]
        assert cs.vec_rows_agree(got, want, band, limit), name
        assert got, name
    assert 0.5 < cs.vec_recall(ex, segs, indexes,
                               cs.vec_query_vectors(indexes, 3, 4, 50)) <= 1
    # the block path's strings parse back to the generator's vectors
    cols = cs.vector_columns(3, 0, 4500, 0)
    back = json.loads(segs[0].data_source("vec").values()[17])
    assert np.array_equal(np.asarray(back, np.float32), cols["vec"][17])
    t = cs.mse_truth({"lo_orderdate": np.array([19940101, 19940101, 1]),
                      "lo_discount": np.array([5, 5, 5]),
                      "lo_quantity": np.array([10, 9, 10])})
    assert t["docs"].tolist() == [0] and t["wide"] == 3
