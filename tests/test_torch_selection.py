"""The port's selection (top-N) and DISTINCT paths against the JAX
package's, SQL to rows.

Three ways on the same segments (built by the JAX creator, loaded by each
package's own loader): the JAX host executor (use_tpu=False, the oracle),
the JAX device engine (use_tpu=True), and
`pinot_tpu_torch.query.executor.QueryExecutor(device="cpu")` (the plain
PyTorch top-N and group-by kernels), under x64 (float64 values) and with
x64 off (float32 values). Rows must be equal exactly and in order (DISTINCT
without ORDER BY compares as a set), and `num_docs_scanned` equal. Covered:
the queries of tests/test_device_selection.py on its segments, the
selection leg of chip_smoke.py at a small size (also against its numpy
truth helpers), and the LIMIT-only host path.
"""
import numpy as np
import pytest
import torch

import jax

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

import chip_smoke
from pinot_tpu.models import (DataType, FieldSpec, FieldType, Schema,
                              TableConfig, TableType)
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu_torch.ops.engine import NotOffloadable
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.loader import load_segment

from tests.queries.harness import build_segments

#: tests/test_device_selection.py:85-165
DEVICE_SELECTION = [
    "SELECT d, m FROM t ORDER BY m DESC LIMIT 7",
    "SELECT d, m FROM t WHERE d IN (1, 3, 5) ORDER BY m LIMIT 9",
    "SELECT s, d FROM t WHERE m > 50000 ORDER BY s LIMIT 11",
    "SELECT d, m FROM t ORDER BY m * 2 DESC LIMIT 5",
    "SELECT d FROM t WHERE d = 7 LIMIT 2000",
    "SELECT m FROM t ORDER BY m LIMIT 5 OFFSET 3",
    "SELECT * FROM t ORDER BY m DESC LIMIT 4",
    "SELECT d, m FROM t WHERE d = 3 AND m < 2000 ORDER BY m LIMIT 500",
    "SELECT DISTINCT d FROM t ORDER BY d LIMIT 100",
    "SELECT DISTINCT d, s FROM t ORDER BY d, s LIMIT 500",
    "SELECT DISTINCT s FROM t WHERE d BETWEEN 5 AND 8 ORDER BY s LIMIT 100",
    "SELECT DISTINCT d FROM t WHERE d > 1000",
    "SELECT DISTINCT s FROM t WHERE d IN (0, 19) AND m < 0 ORDER BY s "
    "LIMIT 10",
]
LIMIT_ONLY = [
    "SELECT d, m FROM t LIMIT 5",
    "SELECT * FROM t LIMIT 10 OFFSET 4998",
    "SELECT s, m * 2, m / 4 FROM t LIMIT 3",
]


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """tests/test_device_selection.py's segments."""
    tmp = tmp_path_factory.mktemp("torch_devsel")
    schema = Schema("t", [
        FieldSpec("d", DataType.INT, FieldType.DIMENSION),
        FieldSpec("s", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("m", DataType.INT, FieldType.METRIC),
    ])
    tc = TableConfig("t", TableType.OFFLINE)
    tc.indexing.no_dictionary_columns = ["m"]
    rng = np.random.default_rng(21)
    data = []
    for _ in range(3):
        n = 5000
        data.append({
            "d": rng.integers(0, 20, n).astype(np.int32),
            "s": np.array([f"v{x}" for x in rng.integers(0, 6, n)], object),
            "m": rng.integers(0, 100000, n).astype(np.int32),
        })
    jsegs = build_segments(tmp, schema, tc, data)
    return jsegs, [load_segment(str(tmp / f"seg_{i}")) for i in range(3)]


@pytest.fixture(scope="module")
def q1_segs(tmp_path_factory):
    """chip_smoke.py's Q1 leg data at 3 x 20,000 rows, with its truth."""
    tmp = tmp_path_factory.mktemp("torch_sel_q1")
    schema = Schema("ssb", [FieldSpec(c, DataType.INT,
                                      FieldType.METRIC
                                      if c == "lo_extendedprice"
                                      else FieldType.DIMENSION)
                            for c in chip_smoke.SSB_COLS])
    tc = TableConfig("ssb")
    tc.indexing.no_dictionary_columns = ["lo_extendedprice"]
    tc.indexing.compression = "PASS_THROUGH"
    cols = [chip_smoke.ssb_q1_columns(np.random.default_rng([9, i]), 20_000)
            for i in range(3)]
    jsegs = build_segments(tmp, schema, tc, cols)
    tsegs = [load_segment(str(tmp / f"seg_{i}")) for i in range(3)]
    return jsegs, tsegs, [chip_smoke.selection_truth(c) for c in cols]


def _rows(resp, sql):
    rows = [tuple(r) for r in resp.result_table.rows]
    if "order by" not in sql.lower() and "distinct" in sql.lower():
        rows = sorted(rows)
    return rows


def three_way(jsegs, tsegs, sql, x64):
    """Port vs JAX device engine vs JAX host executor; returns the port's
    response and its engine."""
    with jax.enable_x64(x64):
        host = JaxExecutor(jsegs, use_tpu=False).execute(sql)
        dev = JaxExecutor(jsegs, use_tpu=True,
                          engine=TpuOperatorExecutor()).execute(sql)
        ex = QueryExecutor(
            tsegs, device="cpu",
            value_dtype=torch.float64 if x64 else torch.float32)
        port = ex.execute(sql)
    assert not host.exceptions and not dev.exceptions, sql
    for ref in (host, dev):
        assert ref.result_table.columns == port.result_table.columns, sql
        assert _rows(ref, sql) == _rows(port, sql), sql
        assert ref.stats.num_docs_scanned == port.stats.num_docs_scanned, \
            sql
    return port, ex.engine


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("sql", DEVICE_SELECTION)
def test_device_selection_queries_match_jax(segs, sql, x64):
    _port, engine = three_way(*segs, sql, x64)
    assert engine._blocks, f"the device path never engaged for {sql!r}"


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("sql", LIMIT_ONLY)
def test_limit_only_selection_is_a_host_scan(segs, sql, x64):
    """Neither a filter nor an ORDER BY: the first limit + offset docs of
    each segment, projected on the host, staging nothing and launching no
    kernel (the JAX engine leaves this shape to its host executor)."""
    port, engine = three_way(*segs, sql, x64)
    assert not engine._blocks
    assert engine.last_stage_ms["kernel_fetch"] == 0.0
    assert port.rows


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_matched_rows_outrank_unmatched_at_the_float_limits(tmp_path, x64):
    """tests/test_device_selection.py's sentinel case: values beyond
    float32 stage as +inf, their ASC score clips to the finite minimum and
    still outranks every unmatched doc."""
    schema = Schema("t", [
        FieldSpec("d", DataType.INT, FieldType.DIMENSION),
        FieldSpec("x", DataType.DOUBLE, FieldType.METRIC)])
    tc = TableConfig("t", TableType.OFFLINE)
    tc.indexing.no_dictionary_columns = ["x"]
    x = np.full(1000, 1.0)
    dd = np.zeros(1000, np.int32)
    x[::100] = 1e300
    dd[::100] = 1
    jsegs = build_segments(tmp_path, schema, tc, [{"d": dd, "x": x}])
    tsegs = [load_segment(str(tmp_path / "seg_0"))]
    port, _e = three_way(jsegs, tsegs,
                         "SELECT d, x FROM t WHERE d = 1 ORDER BY x LIMIT 20",
                         x64)
    assert port.rows == [(1, 1e300)] * 10


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(chip_smoke.SEL_QUERIES))
def test_selection_leg_matches_jax_and_truth(q1_segs, name, x64):
    jsegs, tsegs, truths = q1_segs
    port, _e = three_way(jsegs, tsegs, chip_smoke.SEL_QUERIES[name][0], x64)
    want, matched = chip_smoke.selection_expected(
        truths, name, port.result_table.columns)
    assert port.rows == want and len(want) > 0
    assert port.stats.num_docs_scanned == matched


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_selection_leg_distinct_matches_jax_and_truth(q1_segs, x64):
    jsegs, tsegs, truths = q1_segs
    port, _e = three_way(jsegs, tsegs, chip_smoke.DIST_QUERY, x64)
    assert port.rows == sorted(set().union(*(t["dist.1"] for t in truths)))


def test_selection_truth_orders_like_the_kernel():
    """chip_smoke.selection_truth ranks by (score desc, doc asc) and
    selection_expected merges segments stably by the exact order value."""
    cols = {"lo_orderdate": np.array([19940105, 19940110, 19940105,
                                      19920101], np.int32),
            "lo_discount": np.array([5, 4, 6, 5], np.int32),
            "lo_quantity": np.array([3, 30, 24, 1], np.int32),
            "lo_extendedprice": np.array([500, 700, 500, 900], np.int32)}
    t = chip_smoke.selection_truth(cols)
    assert t["sel.1"] == (3, [(700, (19940110, 4, 30, 700)),
                              (500, (19940105, 5, 3, 500)),
                              (500, (19940105, 6, 24, 500))])
    assert [r[0] for r in t["sel.2"][1]] == [19920101, 19940105, 19940105]
    assert t["dist.1"] == {(5, 3), (4, 30), (6, 24)}
    rows, matched = chip_smoke.selection_expected(
        [t, t], "sel.1", ["lo_extendedprice", "lo_discount"])
    assert matched == 6
    assert rows == [(700, 4), (700, 4), (500, 5), (500, 6), (500, 5),
                    (500, 6)]


def test_plan_time_refusals(tmp_path):
    """What the JAX engine hands its host executor, the port refuses,
    naming it: an ORDER BY on a raw long staged as split planes (float32
    values), and more rows than the top-N kernel sorts."""
    schema = Schema("big", [
        FieldSpec("d", DataType.INT, FieldType.DIMENSION),
        FieldSpec("k", DataType.LONG, FieldType.METRIC)])
    tc = TableConfig("big", TableType.OFFLINE)
    tc.indexing.no_dictionary_columns = ["k"]
    rng = np.random.default_rng(3)
    build_segments(tmp_path, schema, tc, [{
        "d": rng.integers(0, 9, 500).astype(np.int32),
        "k": rng.integers(0, 1 << 40, 500).astype(np.int64)}])
    ex = QueryExecutor([load_segment(str(tmp_path / "seg_0"))],
                       device="cpu")
    with pytest.raises(NotOffloadable, match="raw64"):
        ex.execute("SELECT d FROM big WHERE k > 5 ORDER BY k LIMIT 5")
    with pytest.raises(NotOffloadable, match="top-N above 8192"):
        ex.execute("SELECT d FROM big WHERE d > 2 LIMIT 9000")
