"""MIN / MAX over signed zeros and NaN: the port's plain versions against
the JAX package's, bit for bit in the sign.

XLA ranks -0.0 below +0.0 in jnp.min / jnp.max and in its scatter-min /
-max, whatever the order of the docs, and a NaN among the inputs makes
the result NaN. A float compare holds the two zeros equal, so a fold that
keeps whichever zero it saw first gives +0.0 where XLA gives -0.0. Each
case below holds the port to XLA's answer:

  * `masked_reduce` / `grouped_reduce` (ops/kernels.py) against
    `_masked_reduce` / `_grouped_reduce` (pinot_tpu/ops/kernels.py) on
    rows and groups of +-0.0 in both orders, NaN among them, all-NaN and
    empty rows / groups, masked-out NaN and zeros;
  * the plain star-tree kernel (ops/startree_device.py) against
    `make_startree_kernel` with its min / max columns made of +-0.0 and
    NaN;
  * the mesh fold (`merged_kernel` on logical 2x2 and 4x2 meshes of CPU
    slots) against `compiled_merged_kernel`, flat and with compact group
    keys, so the zeros meet across segments and doc shards: sign for sign
    against JAX's kernel on one device, in value against its kernel on
    the same geometry (see the test);
  * SQL MIN / MAX over a DOUBLE column of signed zeros three ways: the
    JAX host executor (values), its device engine and the port (values
    and the sign of every zero).

Both precisions: the conftest's x64 against value_dtype float64, and
`jax.enable_x64(False)` against float32. NaN compares as NaN (the bits of
a NaN are not compared: XLA keeps the input's, the port writes the quiet
NaN).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if not hasattr(jax, "enable_x64"):
    from jax.experimental import enable_x64 as _enable_x64
    jax.enable_x64 = _enable_x64

from pinot_tpu.models import (DataType, FieldSpec, FieldType, Schema,
                              TableConfig, TableType)
from pinot_tpu.models.table_config import IndexingConfig
from pinot_tpu.ops import collective as jc
from pinot_tpu.ops import kernels as jk
from pinot_tpu.ops import plan_ir as jir
from pinot_tpu.ops import startree_device as jsd
from pinot_tpu.parallel.mesh import make_mesh as jax_mesh
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor

from pinot_tpu_torch.ops import collective as tc
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import startree_device as tsd
from pinot_tpu_torch.ops.plan_ir import DevicePlan
from pinot_tpu_torch.parallel import make_mesh, shard_block
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.loader import load_segment
from tests import torch_plans as tp
from tests.queries.harness import build_segments, values_equal

NAN, INF = float("nan"), float("inf")
#: the docs of one row (ungrouped) or one group, in doc order
PATTERNS = [
    [0.0, -0.0], [-0.0, 0.0], [0.0, -0.0, 0.0, -0.0], [-0.0, 0.0, -0.0],
    [-0.0, -0.0], [0.0, 0.0], [NAN, -0.0], [-0.0, NAN, 0.0], [0.0, NAN],
    [NAN, NAN], [], [1.5, -0.0, 0.0, -2.0], [-INF, -0.0], [INF, 0.0],
    [0.0], [-0.0],
]
POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
OPS = pytest.mark.parametrize("op", ["min", "max"])


def dtypes(x64):
    return (np.float64, torch.float64) if x64 else (np.float32,
                                                    torch.float32)


def assert_signed_equal(got, want, what=""):
    """Equal values, the same sign on every zero, NaN where NaN."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), (what, got, want)
    assert np.array_equal(got[~nan], want[~nan]), (what, got, want)
    assert np.array_equal(np.signbit(got[~nan]), np.signbit(want[~nan])), \
        (what, got, want)


def row_block(dt):
    """[S, D] values, mask and validity: row s holds PATTERNS[s] in its
    first docs; the docs after it are masked out (NaN and zeros the mask
    must hide), and the last doc is padding."""
    S, D = len(PATTERNS), max(map(len, PATTERNS)) + 3
    vals = np.tile(np.array([NAN, -0.0, 0.0] * D)[:D], (S, 1))
    mask = np.zeros((S, D), bool)
    for s, p in enumerate(PATTERNS):
        vals[s, :len(p)] = p
        mask[s, :len(p)] = True
    valid = np.ones((S, D), bool)
    valid[:, -1] = False
    mask[:, -1] = True  # past num_docs: `valid` must hide it
    return vals.astype(dt), mask, valid


def group_block(dt, seed=0):
    """Two segments holding every pattern as a group, the groups' docs
    interleaved: segment 0 in a seeded shuffle that keeps each group's
    doc order, segment 1 in reverse (each group's order reversed); then
    five masked-out NaN docs."""
    G = len(PATTERNS)
    docs = [(g, v) for g, p in enumerate(PATTERNS) for v in p]
    perm = np.random.default_rng(seed).permutation(len(docs))
    left = {g: list(p) for g, p in enumerate(PATTERNS)}
    seg0 = [(docs[i][0], left[docs[i][0]].pop(0)) for i in perm]
    rows = [seg0, docs[::-1]]
    rows = [r + [(g, NAN) for g in range(5)] for r in rows]
    D = len(rows[0])
    vals = np.array([[v for _g, v in r] for r in rows], np.float64)
    keys = np.array([[g for g, _v in r] for r in rows], np.int32)
    mask = np.ones((2, D), bool)
    mask[:, -5:] = False
    return vals.astype(dt), keys, mask, np.ones((2, D), bool), G


@OPS
@POSTURES
def test_masked_reduce_matches_jax(op, x64):
    ndt, vdt = dtypes(x64)
    vals, mask, valid = row_block(ndt)
    with jax.enable_x64(x64):
        want = np.asarray(jk._masked_reduce(op, jnp.asarray(vals),
                                            jnp.asarray(mask),
                                            jnp.asarray(valid)))
    got = tk.masked_reduce(op, torch.from_numpy(vals),
                           torch.from_numpy(mask), torch.from_numpy(valid),
                           vdt)
    assert got.dtype == vdt
    assert_signed_equal(got.numpy(), want, op)
    # the cases the issue names: min of [0.0, -0.0] is -0.0, max of
    # [-0.0, 0.0] is +0.0
    assert np.signbit(got[0 if op == "min" else 1].item()) == (op == "min")


@OPS
@POSTURES
@pytest.mark.parametrize("seed", range(3))
def test_grouped_reduce_matches_jax(op, x64, seed):
    ndt, vdt = dtypes(x64)
    vals, keys, mask, valid, G = group_block(ndt, seed)
    with jax.enable_x64(x64):
        want = np.asarray(jk._grouped_reduce(
            op, jnp.asarray(vals), jnp.asarray(keys), jnp.asarray(mask),
            jnp.asarray(valid), G + 2))  # two groups no doc holds
    got = tk.grouped_reduce(op, torch.from_numpy(vals),
                            torch.from_numpy(keys), torch.from_numpy(mask),
                            torch.from_numpy(valid), G + 2, vdt)
    assert_signed_equal(got.numpy(), want, op)


def test_grouped_reduce_the_issue_case():
    """_grouped_reduce("min", [[0.0, -0.0, 5.0, 0.0, -0.0]], keys [[0, 0,
    1, 2, 2]], G = 3) is [-0.0, 5.0, -0.0]."""
    v = torch.tensor([[0.0, -0.0, 5.0, 0.0, -0.0]], dtype=torch.float64)
    k = torch.tensor([[0, 0, 1, 2, 2]], dtype=torch.int32)
    one = torch.ones_like(k, dtype=torch.bool)
    got = tk.grouped_reduce("min", v, k, one, one, 3, torch.float64)
    assert_signed_equal(got.numpy(), np.array([[-0.0, 5.0, -0.0]]))


@OPS
@POSTURES
def test_minmax_combine_is_xla_min_max(op, x64):
    """Every ordered pair of +-0.0, +-1, +-inf and NaN."""
    ndt, _vdt = dtypes(x64)
    vals = np.array([0.0, -0.0, 1.0, -1.0, INF, -INF, NAN], ndt)
    a, b = np.meshgrid(vals, vals)
    with jax.enable_x64(x64):
        fn = jnp.minimum if op == "min" else jnp.maximum
        want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
    got = tk.minmax_combine(op, torch.from_numpy(a), torch.from_numpy(b))
    assert_signed_equal(got.numpy(), want, op)


def _zeros_and_nan(rng, shape, dt, nan_share):
    v = rng.choice(np.array([0.0, -0.0]), shape)
    v[rng.random(shape) < nan_share] = NAN
    return v.astype(dt)


@POSTURES
@pytest.mark.parametrize("group", list(tp.ST_GROUPS))
@pytest.mark.parametrize("nan_share", [0.0, 0.001])
def test_startree_plain_kernel_matches_jax(group, x64, nan_share):
    """The star-tree min / max slots (the last two columns) over records
    of +-0.0 and some NaN: the plain K5 against make_startree_kernel."""
    ndt, vdt = dtypes(x64)
    fields = tp.startree_spec(group)
    S, D = 4, 2048
    cols, params, nd = tp.startree_inputs(1, fields, S, D, ndt)
    rng = np.random.default_rng(5)
    for name in ("stval:min__x", "stval:max__y"):
        cols[name] = _zeros_and_nan(rng, (S, D), ndt, nan_share)
    with jax.enable_x64(x64):
        kern = jsd.make_startree_kernel(jsd.StarTreePlan(**fields))
        want = np.asarray(kern({k: jnp.asarray(v) for k, v in cols.items()},
                               {k: jnp.asarray(v)
                                for k, v in params.items()},
                               jnp.asarray(nd), D=D))
    tcols, tpar, tnd = tk.from_jax_staged(cols, params, nd)
    got = tsd.startree_kernel(tsd.StarTreePlan(**fields), tcols, tpar, tnd,
                              D, value_dtype=vdt).numpy()
    assert got.shape == want.shape
    assert_signed_equal(got[..., -2:], want[..., -2:], group)
    # both zeros really met in some output
    assert np.signbit(got[..., -2:][got[..., -2:] == 0]).any()


MERGE_S, MERGE_D, MERGE_G = 8, 64, 8


def _merge_case(x64, grouped, seed):
    """A MIN / MAX / COUNT plan over a [8, 64] block of +-0.0 (a few NaN
    where seed is odd), flat or compactly grouped into 8 groups (gmap the
    identity on every segment)."""
    ndt, _vdt = dtypes(x64)
    rng = np.random.default_rng(seed)
    cols = {"val:x": _zeros_and_nan(rng, (MERGE_S, MERGE_D), ndt,
                                    0.002 * (seed % 2))}
    spec = dict(filter_ir=None, leaves=(), value_irs=(("col", "x"),),
                agg_ops=(("min", 0, None), ("max", 0, None),
                         ("count", None, None)), raw_cols=("x",))
    params = {}
    if grouped:
        spec.update(group_cols=("g",), group_compact=True)
        cols["gkey"] = rng.integers(0, MERGE_G, (MERGE_S, MERGE_D)
                                    ).astype(np.int32)
        params["gmap"] = np.tile(np.arange(MERGE_G, dtype=np.int32),
                                 (MERGE_S, 1))
    nd = rng.integers(MERGE_D // 2, MERGE_D + 1, MERGE_S).astype(np.int32)
    return spec, cols, params, nd


def _jax_merged(spec, cols, params, nd, G, x64, n, doc_axis):
    with jax.enable_x64(x64):
        return np.asarray(jc.compiled_merged_kernel(
            jir.DevicePlan(**spec),
            jax_mesh(jax.devices()[:n], doc_axis=doc_axis))(
            {k: jnp.asarray(v) for k, v in cols.items()},
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(nd), D=MERGE_D, G=G))


@POSTURES
@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n,doc_axis", [(4, 2), (8, 2)], ids=["2x2", "4x2"])
def test_mesh_fold_matches_jax_merged_kernel(x64, grouped, seed, n,
                                             doc_axis):
    """The port's merged row on a 2x2 / 4x2 mesh, where the zeros meet
    across segments and doc shards in K9's plain fold, against the JAX
    merged kernel on one device (its pmin / pmax are then identities, so
    its min / max are jnp's), sign for sign; and, where no NaN is among
    the inputs, against the JAX kernel on the same geometry in value.
    (JAX's pmin / pmax across CPU devices keep whichever zero the
    all-reduce meets first, and can drop a NaN: on a 4x2 mesh a group
    holding both zeros can come out -0.0 where jnp.max, and JAX's own 1x1,
    2x2 and 4x1 meshes, give +0.0.)"""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    spec, cols, params, nd = _merge_case(x64, grouped, seed)
    G = MERGE_G if grouped else 0
    want = _jax_merged(spec, cols, params, nd, G, x64, 1, 1)
    same_mesh = _jax_merged(spec, cols, params, nd, G, x64, n, doc_axis)
    mesh = make_mesh(["cpu"] * n, doc_axis=doc_axis)
    scols = {k: shard_block(mesh, torch.from_numpy(np.ascontiguousarray(v)))
             for k, v in cols.items()}
    _c, tpar, tnd = tk.from_jax_staged({}, params, nd)
    got = tc.merged_kernel(DevicePlan(**spec), mesh, dtypes(x64)[1])(
        scols, tpar, tnd, MERGE_D, G).numpy()
    assert got.shape == want.shape == same_mesh.shape
    assert_signed_equal(got, want, "merged row")
    if seed % 2 == 0:  # no NaN: the same values as JAX's own geometry
        assert np.array_equal(got, same_mesh)


SQL_N = 400


@pytest.fixture(scope="module")
def zero_segs(tmp_path_factory):
    """Three segments of a raw DOUBLE column of +-0.0 (and 1.0 / -1.0 in
    a few groups), grouped by grp in 6 values: per group and segment the
    zeros come in either order; group 3 holds +0.0 in segments 0 and 2
    and -0.0 in segment 1, so the zeros meet in the host's merge."""
    tmp = tmp_path_factory.mktemp("minmax_order")
    schema = Schema("testTable", [
        FieldSpec("x", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("grp", DataType.INT, FieldType.DIMENSION)])
    # raw: a dictionary would hold one zero for both
    tc_ = TableConfig("testTable", TableType.OFFLINE,
                      indexing=IndexingConfig(no_dictionary_columns=["x"]))
    data = []
    for i in range(3):
        rng = np.random.default_rng(40 + i)
        grp = rng.integers(0, 6, SQL_N).astype(np.int32)
        x = rng.choice(np.array([0.0, -0.0]), SQL_N)
        x[(grp == 4) & (rng.random(SQL_N) < 0.1)] = 1.0
        x[(grp == 5) & (rng.random(SQL_N) < 0.1)] = -1.0
        x[grp == 3] = -0.0 if i % 2 else 0.0
        data.append({"x": x, "grp": grp})
    jsegs = build_segments(tmp, schema, tc_, data)
    return jsegs, [load_segment(str(tmp / f"seg_{i}")) for i in range(3)]


SQLS = [
    "SELECT MIN(x), MAX(x) FROM testTable",
    "SELECT MIN(x), MAX(x) FROM testTable WHERE grp = 3",
    "SELECT grp, MIN(x), MAX(x), COUNT(*) FROM testTable GROUP BY grp "
    "ORDER BY grp LIMIT 10",
]


@POSTURES
@pytest.mark.parametrize("sql", SQLS)
def test_sql_min_max_three_ways(zero_segs, sql, x64):
    jsegs, tsegs = zero_segs
    with jax.enable_x64(x64):
        host = JaxExecutor(jsegs, use_tpu=False).execute(sql)
        dev = JaxExecutor(jsegs, use_tpu=True).execute(sql)
    port = QueryExecutor(tsegs, device="cpu",
                         value_dtype=dtypes(x64)[1]).execute(sql)
    for r in (host, dev):
        assert not r.exceptions, (sql, r.exceptions)
    assert host.rows and len(host.rows) == len(dev.rows) == len(port.rows)
    for h, d, p in zip(host.rows, dev.rows, port.rows):
        assert all(values_equal(a, b) for a, b in zip(h, d)), (h, d)
        assert all(values_equal(a, b) for a, b in zip(d, p)), (d, p)
        fl = [(a, b) for a, b in zip(d, p) if isinstance(a, float)]
        assert [np.signbit(a) for a, _b in fl] == \
            [np.signbit(b) for _a, b in fl], (sql, d, p)
