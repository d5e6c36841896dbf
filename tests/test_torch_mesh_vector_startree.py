"""A vector search (K8) and a star-tree query (K5) per slot of a
segments-only mesh, against the JAX package.

tests/test_torch_mesh_modes.py's geometries, postures and helpers: logical
"cpu" meshes of 2x1 and 4x1, implicit (`devices=`) and explicit (`mesh=`,
doc axis 1), each shape through the JAX mesh engine of the same geometry,
the JAX host executor, the port's mesh engine and its one-device engine,
in both postures. The JAX mesh engine runs both shapes on its CPU
devices. Tolerances: vector ids exact outside the 2^-20 band of a
segment's cut (tests/test_torch_vector.py `_band`); star-tree counts and
integer sums exact, and a star-tree answer equal to its own scan
(`OPTION(useStarTree=false)`) within rel 1e-6.
"""
import numpy as np
import pytest

import jax

from pinot_tpu.segment.loader import load_segment as jload
from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType, Schema,
                                    StarTreeIndexConfig, TableConfig)
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import load_segment
from tests.test_torch_mesh_modes import (GEOMETRIES, POSTURES, FourWays,
                                         _close, _no_refusal, _rows,
                                         host_response, one_device_rows)
from tests.test_torch_vector import _agree, _band, _json, _vectors


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


# ---------------------------------------------------------------------------
# vector search (K8)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emb(tmp_path_factory):
    """Four segments of the emb table (tests/test_torch_vector.py's
    schema): two exact (400, 300 docs) and two IVF (4200, 4300)."""
    tmp = tmp_path_factory.mktemp("mesh_modes_emb")
    schema = Schema("emb", [FieldSpec("id", DataType.INT),
                            FieldSpec("cat", DataType.INT),
                            FieldSpec("vec", DataType.STRING)])
    tc = TableConfig("emb")
    tc.indexing.vector_index_columns = ["vec"]
    dirs = []
    for i, n in enumerate((400, 4200, 300, 4300)):
        v = _vectors(7 + i, n)
        out = str(tmp / f"emb_{i}")
        SegmentCreator(tc, schema).build(
            {"id": np.arange(n, dtype=np.int32) + i * 100_000,
             "cat": np.random.default_rng(i).integers(0, 4, n).astype(
                 np.int32),
             "vec": np.array([_json(r) for r in v], object)}, out, f"emb_{i}")
        dirs.append(out)
    return [jload(d) for d in dirs], [load_segment(d) for d in dirs]


@POSTURES
@GEOMETRIES
def test_vector_search_on_a_segments_only_mesh(emb, x64, n, how):
    """Exact and IVF segments, k = 5 and k = 100, with a residual filter:
    ids equal outside the band of near-tied scores at a segment's cut."""
    ways = FourWays(emb, x64, n, how)
    tsegs = ways.tsegs
    rng = np.random.default_rng(40 + n)
    for k, where in ((5, ""), (100, " AND cat = 1")):
        ix = tsegs[1].data_source("vec").vector_index
        qv = (ix.vectors[int(rng.integers(0, len(ix.vectors)))]
              + 0.05 * rng.normal(size=ix.vectors.shape[1])).astype(
                  np.float32)
        sql = (f"SELECT id FROM emb WHERE vector_similarity(vec, "
               f"'{_json(qv)}', {k}){where} LIMIT 100")
        got = _rows(ways.port.execute(sql))
        assert got == one_device_rows(tsegs, sql, x64)
        band = _band(tsegs, qv, k)
        _agree(got, _rows(ways.jax_response(sql)), band)
        _agree(got, _rows(host_response(ways.jsegs, sql, x64)), band)
    assert ways.engine.meter("vector_served") == 2
    _no_refusal(ways.engine)


# ---------------------------------------------------------------------------
# star-tree (K5)
# ---------------------------------------------------------------------------

STARTREE = [
    "SELECT SUM(m), COUNT(*) FROM st WHERE a < 5",
    "SELECT b, SUM(m) FROM st WHERE a BETWEEN 2 AND 6 "
    "GROUP BY b ORDER BY b LIMIT 20",
]


@pytest.fixture(scope="module")
def st_segs(tmp_path_factory):
    """Three segments with a star-tree on (a, b) holding SUM__m (m >= 0,
    so the tree's exact planes serve it) and COUNT__*."""
    tmp = tmp_path_factory.mktemp("mesh_modes_st")
    schema = Schema("st", [FieldSpec("a", DataType.INT),
                           FieldSpec("b", DataType.STRING),
                           FieldSpec("m", DataType.INT, FieldType.METRIC)])
    tc = TableConfig("st")
    tc.indexing.star_tree_configs = [StarTreeIndexConfig(
        ["a", "b"], [], ["SUM__m", "COUNT__*"])]
    rng = np.random.default_rng(5)
    dirs = []
    for i, n in enumerate((600, 450, 700)):
        out = str(tmp / f"st_{i}")
        SegmentCreator(tc, schema).build(
            {"a": rng.integers(0, 9, n).astype(np.int32),
             "b": np.array([f"b{x}" for x in rng.integers(0, 5, n)], object),
             "m": rng.integers(0, 1000, n).astype(np.int32)}, out, f"st_{i}")
        dirs.append(out)
    return [jload(d) for d in dirs], [load_segment(d) for d in dirs]


@POSTURES
@GEOMETRIES
def test_startree_on_a_segments_only_mesh(st_segs, x64, n, how):
    """Served from the trees (K5 per slot, merged into one row nowhere: a
    star-tree launch keeps per-segment rows), equal to its own scan."""
    ways = FourWays(st_segs, x64, n, how)
    for sql in STARTREE:
        got = ways.check(sql)
        scan = ways.port.execute(sql + " OPTION(useStarTree=false)")
        _close(_rows(got), _rows(scan), True)
    assert ways.engine.meter("startree_served") == len(STARTREE)
    _no_refusal(ways.engine)
