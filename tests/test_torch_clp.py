"""The port's CLP log-search slice against the JAX package's: the CLP
codec and forward index (pinot_tpu_torch/segment/clp.py), the pattern
planner and staging (pinot_tpu_torch/ops/clp_device.py), the plain match
(`kernels.clp_match`, K7's plain version) and LIKE / REGEXP_LIKE over a
CLP column from SQL to rows through the port's engine on the CPU.

  * codec: encode / decode and the column bytes equal JAX's on the
    reference's MESSAGES and on seeded random messages; the parts writer
    equals the message writer, tables in any order; the segment's CLP
    buffer equals the JAX creator's
  * planning: compile_pattern, plan_leaf and the exact fallback reasons
    equal JAX's over the PUSHED / FALLBACKS matrices
    (tests/test_clp_device.py); leaf_params and the row fetchers equal
  * kernel: the plain clp_match bit-identical to `compiled_match_kernel`
    on JAX-staged inputs carried across by `from_jax_staged`, and on
    seeded random tables (padding, sentinels, both modes)
  * SQL three ways: the port's QueryExecutor(device="cpu") against the
    JAX engine and the JAX host executor, both precision postures (x64
    against float64 values, x64 off against float32): counts exactly,
    groups and rows in order
  * refusals raise NotOffloadable carrying the JAX reason, counted in
    `clp_fallback`
  * coalescing: 8 constant-different patterns in one held batch, each
    answer bit-identical to the query alone, one program compiled
  * chip_smoke.py's log generator at a small size: parts equal to the
    rendered lines' encoding, truths equal to the engine's answers
"""
import re
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
from pinot_tpu.ops import clp_device as jcd
from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.ops.plan_ir import DeviceLeaf as JLeaf
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.executor import QueryExecutor as JaxExecutor
from pinot_tpu.segment import clp as jclp
from pinot_tpu.segment.creator import SegmentCreator as JCreator
from pinot_tpu.segment.loader import load_segment as jload
from pinot_tpu.utils.config import PinotConfiguration as JaxConfig
from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType, Schema,
                                    TableConfig)
from pinot_tpu_torch.ops import clp_device as tcd
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.ops import program
from pinot_tpu_torch.ops.engine import NotOffloadable, TorchOperatorExecutor
from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment import clp as tclp
from pinot_tpu_torch.segment import index_types as it
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.utils.failpoints import failpoints

from tests import torch_plans as tp

POSTURES = pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])

#: tests/test_clp_device.py:49
MESSAGES = [
    "INFO task 1234 started on host web-01 in 0.5s",
    "WARN task 9999 slow on host web-02 in 12.75s",
    "ERROR task 1234 failed on host web-01: code=500",
    "INFO user alice logged in from 10.0.0.1",
    "INFO user bob42 logged in from 10.0.0.2",
    "disk /dev/sda1 at 93% capacity",
    "disk /dev/sdb2 at 17% capacity",
    "GC pause 45 ms in region r7",
    "GC pause 450 ms in region r12",
    "",
    "ERROR task 777 failed on host db-01: code=503",
    "checkpoint written to /data/ckpt/000123 bytes=4096",
    "retrying connection to 10.0.0.1 attempt 3",
    "negative value -17 seen at offset -3.5",
    "unicode héllo wörld 42 done",
]

#: tests/test_clp_device.py:179-196
PUSHED = [
    "%failed%", "%web-01%", "INFO%", "%capacity", "%task 1234 failed%",
    "%10.0.0.1%", "%héllo%", "%code=500", "%", "%user alice%",
    "%pause 45 ms%", "%pause 450 ms%", "%in 0.5s%", "%attempt 3",
    "GC pause 45 ms in region r7",
]
FALLBACKS = [
    ("%task 12%", True, "wildcard"),
    ("%e%", True, "wildcard"),
    ("%-17%", True, "wildcard"),
    ("%ali%ce%", True, "partial"),
    ("%task%failed%code=500", True, "partial"),
    ("task 12_4", True, "charWildcard"),
    ("user (alice|bob)", False, "regex"),
]
#: regex patterns the planner pushes (literals, .* runs, edge anchors)
REGEX_PUSHED = ["^INFO", "capacity$", "^GC pause 45 ms", "user alice",
                "failed"]

_WORDS = ["alpha", "beta", "état", "GET", "host", "wörld", "retry", "x",
          "[queue]", "a=b"]


def _rand_msg(rng):
    """tests/test_clp_device.py's random message generator."""
    parts = []
    for _ in range(int(rng.integers(0, 9))):
        kind = int(rng.integers(0, 7))
        if kind == 0:
            parts.append(str(_WORDS[int(rng.integers(0, len(_WORDS)))]))
        elif kind == 1:
            parts.append(str(int(rng.integers(-10**12, 10**12))))
        elif kind == 2:
            parts.append(repr(round(float(rng.random()) * 100, 3)))
        elif kind == 3:
            parts.append("0" + str(int(rng.integers(0, 999))))
        elif kind == 4:
            parts.append(".".join(str(int(v))
                                  for v in rng.integers(0, 256, 4)))
        elif kind == 5:
            parts.append(str(int(rng.integers(1, 9)) * 10**20))
        else:
            parts.append(f"req-{int(rng.integers(0, 10**6))}")
    seps = [" ", "  ", "=", ": ", ", "]
    out = ""
    for p in parts:
        out += p + seps[int(rng.integers(0, len(seps)))]
    return out


_RNG = np.random.default_rng(1717)
RANDOM = [_rand_msg(_RNG) for _ in range(300)] + \
    ["", "   ", "===", "no digits at all", "\t tab \t lead"]
CORPORA = {"messages": MESSAGES, "random": RANDOM}


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corpus", list(CORPORA))
def test_codec_and_column_bytes_equal_jax(corpus):
    msgs = CORPORA[corpus]
    for m in msgs:
        parts = tclp.encode_message(m)
        assert parts == jclp.encode_message(m)
        assert tclp.decode_message(*parts) == m
    buf = tclp.write_clp_column(msgs)
    assert buf == jclp.write_clp_column(msgs)
    for codec in ("PASS_THROUGH", "GZIP"):
        assert tclp.pack_compressed(buf, codec) == \
            jclp.pack_compressed(buf, codec)
        assert tclp.unpack_compressed(jclp.pack_compressed(buf, codec)) == buf
    r, j = tclp.CLPForwardIndexReader(buf), jclp.CLPForwardIndexReader(buf)
    assert list(r.decode_all()) == list(msgs)
    assert r.logtypes == j.logtypes and r.var_dictionary == j.var_dictionary
    assert (r.max_dict_vars, r.max_encoded_vars) == \
        (j.max_dict_vars, j.max_encoded_vars)
    assert r.var_index == j.var_index
    order = np.random.default_rng(3).permutation(len(msgs))
    assert [r.get(int(d)) for d in order] == [msgs[int(d)] for d in order]


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_parts_writer_equals_the_message_writer(corpus):
    """Parts whose tables are permuted, padded with unused entries and
    hold one token under two codes write the message writer's bytes."""
    msgs = CORPORA[corpus] * 2
    p = tclp.encode(msgs)
    assert tclp.write_clp_parts(p) == jclp.write_clp_column(msgs)
    assert tclp.parts_cardinality(p) == len(set(msgs))
    rng = np.random.default_rng(5)
    perm = rng.permutation(len(p.logtypes) + 3)
    logtypes = ["unused"] * len(perm)
    for old, new in enumerate(perm[:len(p.logtypes)]):
        logtypes[new] = p.logtypes[old]
    # every code doubled, odd codes' tokens repeating the even ones'
    tokens = {}
    for c, t in enumerate(p.dv_tokens):
        tokens[2 * c] = tokens[2 * c + 1] = t
    codes = 2 * p.dv_codes + rng.integers(0, 2, len(p.dv_codes))
    q = tclp.ClpParts(logtypes, perm[p.lt_ids].astype(np.int32), p.dv_counts,
                      codes, tokens, p.ev_counts, p.ev)
    assert tclp.write_clp_parts(q) == jclp.write_clp_column(msgs)
    assert tclp.parts_cardinality(q) == len(set(msgs))


def _schema(cls_schema, cls_spec, cls_dt, cls_ft):
    return cls_schema("logs", [cls_spec("ts", cls_dt.LONG, cls_ft.DATE_TIME),
                               cls_spec("message", cls_dt.STRING)])


def _build(tmp, name, msgs, creator="port", codec="GZIP"):
    """One CLP segment of `msgs` (ts = 0..n-1, a dictionary LONG), built by
    either package's creator."""
    out = str(tmp / name)
    cols = {"ts": np.arange(len(msgs), dtype=np.int64),
            "message": list(msgs)}
    if creator == "port":
        tc = TableConfig("logs")
        tc.indexing.clp_columns = ["message"]
        tc.indexing.compression = codec
        SegmentCreator(tc, _schema(Schema, FieldSpec, DataType,
                                   FieldType)).build(cols, out, name)
    else:
        tc = JTableConfig("logs")
        tc.indexing.clp_columns = ["message"]
        tc.indexing.compression = codec
        JCreator(tc, _schema(JSchema, JFieldSpec, JDataType,
                             JFieldType)).build(cols, out, name)
    return out


def test_creators_write_the_same_clp_column(tmp_path):
    a = _build(tmp_path, "a", MESSAGES * 3, "port")
    b = _build(tmp_path, "b", MESSAGES * 3, "jax")
    ta, tb = load_segment(a), load_segment(b)
    assert bytes(ta.dir.get_buffer("message", it.CLP)) == \
        bytes(tb.dir.get_buffer("message", it.CLP))
    ma, mb = (s.metadata.columns["message"] for s in (ta, tb))
    assert (ma.cardinality, ma.has_dictionary, ma.indexes) == \
        (mb.cardinality, mb.has_dictionary, mb.indexes)
    # either loader reads either segment
    assert list(ta.data_source("message").values()) == MESSAGES * 3
    assert list(jload(a).data_source("message").values()) == MESSAGES * 3


def test_parts_column_builds_the_same_segment(tmp_path):
    """A CLP column given as its parts writes the bytes and the metadata
    of the same column given as messages."""
    msgs = RANDOM
    a = _build(tmp_path, "a", msgs, "port")
    tc = TableConfig("logs")
    tc.indexing.clp_columns = ["message"]
    tc.indexing.compression = "GZIP"
    out = str(tmp_path / "b")
    SegmentCreator(tc, _schema(Schema, FieldSpec, DataType, FieldType)).build(
        {"ts": np.arange(len(msgs), dtype=np.int64),
         "message": tclp.encode(msgs)}, out, "b")
    sa, sb = load_segment(a), load_segment(out)
    assert bytes(sa.dir.get_buffer("message", it.CLP)) == \
        bytes(sb.dir.get_buffer("message", it.CLP))
    assert sa.metadata.columns["message"].cardinality == \
        sb.metadata.columns["message"].cardinality == len(set(msgs))


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """tests/test_clp_device.py's three segments (rotated corpora, distinct
    doc counts), built by the port's creator: (port segments, JAX
    segments, all messages)."""
    tmp = tmp_path_factory.mktemp("torch_clp")
    port, jaxs, allm = [], [], []
    for si in range(3):
        msgs = [MESSAGES[(i + si) % len(MESSAGES)]
                for i in range(100 + si * 7)]
        out = _build(tmp, f"seg{si}", msgs)
        port.append(load_segment(out))
        jaxs.append(jload(out))
        allm.extend(msgs)
    return port, jaxs, allm


def _compiled(c):
    if c is None:
        return None
    return (c.key, c.anchor_start, c.anchor_end, c.needle, c.always,
            c.empty_exact, tuple((t.regex.pattern, t.binds, t.lead_partial,
                                  t.trail_partial) for t in c.templates))


PATTERNS = [(p, True) for p in PUSHED] + [(p, l) for p, l, _r in FALLBACKS] \
    + [(p, False) for p in REGEX_PUSHED]


@pytest.mark.parametrize("pattern,is_like", PATTERNS)
def test_plans_and_reasons_equal_jax(segs, pattern, is_like):
    port, jaxs, _ = segs
    tc, treason = tcd.compile_pattern(pattern, is_like)
    jc, jreason = jcd.compile_pattern(pattern, is_like)
    assert _compiled(tc) == _compiled(jc) and treason == jreason
    tmeta, treason = tcd.plan_leaf(port, "message", pattern, is_like)
    jmeta, jreason = jcd.plan_leaf(jaxs, "message", pattern, is_like)
    assert (tmeta, treason) == (jmeta, jreason)
    want = next((r for p, l, r in FALLBACKS if (p, l) == (pattern, is_like)),
                None)
    assert treason == want and (tmeta is None) == (want is not None)
    if tmeta is None:
        return
    for S in (3, 4):
        tpar = tcd.leaf_params(2, DeviceLeaf("clp", "message", tmeta), port,
                               pattern, is_like, S)
        jpar = jcd.leaf_params(2, JLeaf("clp", "message", jmeta), jaxs,
                               pattern, is_like, S)
        assert sorted(tpar) == sorted(jpar)
        for k in tpar:
            assert tpar[k].dtype == jpar[k].dtype, k
            np.testing.assert_array_equal(tpar[k], jpar[k], err_msg=k)
    leaves = [DeviceLeaf("clp", "message", tmeta),
              DeviceLeaf("lut", "ts"), DeviceLeaf("clp", "message",
                                                  ("b", 4, 1))]
    assert tcd.staged_cols(leaves) == (("message", max(4, tmeta[1]),
                                        max(1, tmeta[2])),)


def test_row_fetchers_equal_jax(segs):
    port, jaxs, _ = segs
    for ts_, js in zip(port, jaxs):
        r = ts_.data_source("message").clp_reader
        j = js.data_source("message").clp_reader
        np.testing.assert_array_equal(tcd.row_ids(r), jcd.row_ids(j))
        for k in range(3):
            for fn in ("row_dict_slot", "row_enc_hi", "row_enc_lo"):
                a, b = getattr(tcd, fn)(r, k), getattr(jcd, fn)(j, k)
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b, err_msg=fn)
    assert tcd.FALLBACK_REASONS == jcd.FALLBACK_REASONS
    assert (tcd.KD_MAX, tcd.KE_MAX, tcd.GROUPS_MAX, tcd.CONDS_MAX,
            tcd.LUTS_MAX, tcd._SEG_PLANS_MAX) == \
        (jcd.KD_MAX, jcd.KE_MAX, jcd.GROUPS_MAX, jcd.CONDS_MAX,
         jcd.LUTS_MAX, jcd._SEG_PLANS_MAX)


# ---------------------------------------------------------------------------
# the plain match against the JAX kernel
# ---------------------------------------------------------------------------

KERNEL_PATTERNS = ["%failed%", "%web-01%", "INFO%", "%code=500",
                   "%pause 45 ms%", "%in 0.5s%", "%10.0.0.1%", "%capacity"]


@pytest.mark.parametrize("pattern", KERNEL_PATTERNS)
def test_plain_match_equals_jax_kernel_on_jax_staging(segs, pattern):
    """The JAX engine's staged pseudo-columns and leaf tables, carried
    across by from_jax_staged, through the port's plain clp_match: the JAX
    match kernel's mask bit for bit; and the port's own staging of the
    same query gives the same arrays."""
    port, jaxs, _ = segs
    sql = f"SELECT COUNT(*) FROM logs WHERE message LIKE '{pattern}'"
    with jax.enable_x64(False):
        eng = TpuOperatorExecutor(config=JaxConfig())
        jctx = JaxContext.from_sql(sql)
        jplan, _ = eng._plan(jaxs, jctx)
        cols, params, nd, _s, D, _g = eng._stage(jaxs, jctx, jplan)
        cols = {k: np.asarray(v) for k, v in cols.items()}
        params = {k: np.asarray(v) for k, v in params.items()}
        (jleaf,) = [lf for lf in jplan.leaves if lf.kind == "clp"]
        want = np.asarray(jcd.compiled_match_kernel(0, jleaf)(
            {k: jnp.asarray(v) for k, v in cols.items()},
            {k: jnp.asarray(v) for k, v in params.items()}))
    tc, tpar, _tnd = tk.from_jax_staged(cols, params, np.asarray(nd))
    leaf = DeviceLeaf("clp", jleaf.column, tuple(jleaf.meta))
    got = tk.clp_match(0, leaf, tc, tpar).numpy()
    np.testing.assert_array_equal(got, want)
    # the port's engine plans and stages the same leaf
    teng = TorchOperatorExecutor("cpu", torch.float32)
    ctx = QueryContext.from_sql(sql)
    tplan, _ = teng._plan(port, ctx)
    assert tplan.leaves == (leaf,) and tplan.clp_cols == jplan.clp_cols
    pc, pp, _pn, pD = teng._stage(port, ctx, tplan)
    S = pp["leaf0:alut"].shape[0]
    assert pD == D
    for k, v in tc.items():
        assert torch.equal(pc[k][:, :D], v[:S]), k
    for k, v in tpar.items():
        assert torch.equal(pp[k], v[:S]), k


@pytest.mark.parametrize("pattern", KERNEL_PATTERNS)
def test_packed_banks_hold_the_jax_tables_bits(segs, pattern):
    """K7's packed dict-var LUTs: the port's staging on the CPU holds the
    JAX engine's bool tables (leaf<i>:dvlut / dlut) and no packed ones;
    `pack_banks` of them, as an engine on the card stages them, replaces
    each by its packed bytes (entry x = bit x % 8 of byte x // 8, numpy's
    packbits in little bit order), which unpack to the JAX tables, and
    keeps every other table as it is."""
    port, jaxs, _ = segs
    sql = f"SELECT COUNT(*) FROM logs WHERE message LIKE '{pattern}'"
    with jax.enable_x64(False):
        eng = TpuOperatorExecutor(config=JaxConfig())
        jctx = JaxContext.from_sql(sql)
        jplan, _ = eng._plan(jaxs, jctx)
        _c, params, _nd, _s, _D, _g = eng._stage(jaxs, jctx, jplan)
        params = {k: np.asarray(v) for k, v in params.items()}
    teng = TorchOperatorExecutor("cpu", torch.float32)
    ctx = QueryContext.from_sql(sql)
    tplan, _ = teng._plan(port, ctx)
    _pc, pp, _pn, _pD = teng._stage(port, ctx, tplan)
    S = pp["leaf0:alut"].shape[0]
    banks = [k for k in params if k.split(":")[1] in tcd.PACKED_BANKS]
    assert banks == [k for k in pp if k.split(":")[1] in tcd.PACKED_BANKS]
    assert not [k for k in pp
                if k.split(":")[1] in tcd.PACKED_BANKS.values()]
    host = {k: v.numpy() for k, v in pp.items() if k.startswith("leaf")}
    packed = tcd.pack_banks(host)
    assert sorted(packed) == sorted(
        k if k not in banks
        else f"{k.split(':')[0]}:{tcd.PACKED_BANKS[k.split(':')[1]]}"
        for k in host)
    for key in host:
        if key not in banks:
            assert packed[key] is host[key]
            continue
        leaf, name = key.split(":")
        got = packed[f"{leaf}:{tcd.PACKED_BANKS[name]}"]
        n = params[key].shape[-1]
        assert got.dtype == np.uint8 and got.shape[-1] == (n + 7) // 8
        bits = np.unpackbits(got, axis=-1, count=n,
                             bitorder="little").astype(bool)
        np.testing.assert_array_equal(bits, params[key][:S])


@pytest.mark.parametrize("shape", [(3, 2), (3, 4), (2, 8), (2, 5, 1024),
                                   (4, 3, 13)], ids=str)
def test_pack_banks_pad_with_the_rows_last_entry(shape):
    """pack_banks at every width a staged table takes (vp a power of two
    >= 2, or any width): ceil(vp / 8) bytes a row, each entry's bit where
    K7 reads it, and the bits past vp repeating entry vp - 1, so that K7's
    clip into the packed row's bits reads at every index, negative ones
    and ones past vp included, what the plain version's clip into [0, vp)
    reads."""
    rng = np.random.default_rng(sum(shape))
    b = rng.random(shape) < 0.5
    b[..., -1] = rng.random(shape[:-1]) < 0.5  # the edge: true in some rows
    key = "leaf0:dvlut" if len(shape) == 2 else "leaf2:dlut"
    name = key.split(":")[0] + ":" + tcd.PACKED_BANKS[key.split(":")[1]]
    pn = tcd.pack_banks({key: b})
    assert list(pn) == [name]
    vp, nb = shape[-1], (shape[-1] + 7) // 8
    assert pn[name].shape == shape[:-1] + (nb,)
    x = np.arange(-3, 8 * nb + 5)
    kx = np.clip(x, 0, 8 * nb - 1)  # K7's clip into the packed row
    got = (pn[name].reshape(-1, nb)[:, kx >> 3] >> (kx & 7)) & 1
    rows = torch.from_numpy(b.reshape(-1, vp))
    plain = tk._take(rows, torch.from_numpy(x).expand(rows.shape[0], -1))
    np.testing.assert_array_equal(got.astype(bool), plain.numpy())
    np.testing.assert_array_equal(got[:, 3:3 + vp].astype(bool),
                                  b.reshape(-1, vp))


@pytest.mark.parametrize("meta", [("a", 2, 0), ("a", 0, 0), ("b", 2, 2),
                                  ("b", 0, 1), ("b", 4, 0), ("b", 1, 4)],
                         ids=str)
@pytest.mark.parametrize("seed", range(3))
def test_plain_match_equals_jax_kernel_on_random_tables(seed, meta):
    """Seeded tables with padded conditions and groups, sentinel dict-var
    slots, equal and unequal encoded pairs and padded segments."""
    cols, params = tp.clp_inputs(seed, meta[0], 5, 700, i=1, kd=meta[1],
                                 ke=meta[2])
    want = np.asarray(jcd.compiled_match_kernel(1, JLeaf("clp", "m", meta))(
        {k: jnp.asarray(v) for k, v in cols.items()},
        {k: jnp.asarray(v) for k, v in params.items()}))
    tc, tpar, _ = tk.from_jax_staged(cols, params, np.zeros(5, np.int32))
    got = tk.clp_match(1, DeviceLeaf("clp", "m", meta), tc, tpar)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_mask_leaf_program(segs):
    """A CLP leaf compiles to the mask leaf kind: a LUT `leaf<i>:mask`
    read at the doc's own index, no staged column."""
    port, _j, _ = segs
    eng = TorchOperatorExecutor("cpu", torch.float32)
    plan, _ = eng._plan(port, QueryContext.from_sql(
        "SELECT COUNT(*) FROM logs WHERE message LIKE '%failed%' AND "
        "ts < 50"))
    prog = program.compile_plan(plan)
    assert prog.luts == ("leaf0:mask",)
    assert not any(c.startswith("clp") for c in prog.cols)
    assert prog.code[prog.code[program.H_LEAF]] == program.L_MASK


# ---------------------------------------------------------------------------
# SQL three ways
# ---------------------------------------------------------------------------

def _jax(jaxs, sql, x64):
    with jax.enable_x64(x64):
        dev = JaxExecutor(jaxs, use_tpu=True,
                          engine=TpuOperatorExecutor(config=JaxConfig()))
        host = JaxExecutor(jaxs, use_tpu=False)
        a, b = dev.execute(sql), host.execute(sql)
    assert not a.exceptions and not b.exceptions, sql
    return a.result_table.rows, b.result_table.rows


def _port(port, x64):
    return QueryExecutor(port, device="cpu",
                         value_dtype=torch.float64 if x64 else torch.float32)


def _norm(rows):
    return [tuple(float(v) if isinstance(v, (int, float)) else v for v in r)
            for r in rows]


@POSTURES
def test_like_matrix_three_ways(segs, x64):
    port, jaxs, allm = segs
    ex = _port(port, x64)
    for pat in PUSHED:
        sql = f"SELECT COUNT(*) FROM logs WHERE message LIKE '{pat}'"
        dev, host = _jax(jaxs, sql, x64)
        got = ex.execute(sql).rows
        assert _norm(got) == _norm(dev) == _norm(host), pat
        regex = "^" + ".*".join(re.escape(p) for p in pat.split("%")) + "$"
        assert got[0][0] == sum(1 for m in allm
                                if re.match(regex, m, re.S)), pat
    for pat in REGEX_PUSHED:
        sql = f"SELECT COUNT(*) FROM logs WHERE REGEXP_LIKE(message, '{pat}')"
        dev, host = _jax(jaxs, sql, x64)
        got = ex.execute(sql).rows
        assert _norm(got) == _norm(dev) == _norm(host), pat
    assert ex.engine.meter("clp_served") == len(PUSHED) + len(REGEX_PUSHED)


#: tests/test_clp_device.py:231-248's mixed shapes, the tail top-N and
#: the bucketed histogram
MIXED = [
    "SELECT COUNT(*) FROM logs WHERE message LIKE '%failed%' AND ts < 50",
    "SELECT COUNT(*) FROM logs WHERE message LIKE '%failed%' "
    "OR message LIKE 'INFO%'",
    "SELECT ts, COUNT(*) FROM logs WHERE message LIKE '%failed%' "
    "GROUP BY ts ORDER BY ts LIMIT 5",
    "SELECT COUNT(*) FROM logs WHERE NOT message LIKE '%web-0%' AND "
    "(message LIKE '%capacity' OR ts >= 90)",
    "SELECT SUM(ts), MAX(ts) FROM logs WHERE message LIKE '%code=503'",
    "SELECT ts, message FROM logs WHERE message LIKE '%code=503' "
    "ORDER BY ts DESC LIMIT 7",
    "SELECT ts, message FROM logs WHERE message LIKE 'INFO%' "
    "ORDER BY ts DESC LIMIT 12",
    "SELECT message FROM logs WHERE message LIKE '%capacity' "
    "ORDER BY ts LIMIT 4 OFFSET 2",
    "SELECT floor((ts - 10) / 20), COUNT(*) FROM logs WHERE message LIKE "
    "'ERROR%' AND ts >= 10 AND ts < 90 GROUP BY floor((ts - 10) / 20) "
    "LIMIT 100",
    "SELECT floor((ts - 0) / 25), COUNT(*) FROM logs WHERE "
    "message LIKE '%user alice%' AND ts >= 0 AND ts < 100 GROUP BY "
    "floor((ts - 0) / 25) LIMIT 100",
]


@POSTURES
@pytest.mark.parametrize("sql", MIXED)
def test_mixed_shapes_three_ways(segs, sql, x64):
    port, jaxs, _ = segs
    dev, host = _jax(jaxs, sql, x64)
    got = _port(port, x64).execute(sql).rows
    ordered = "ORDER BY" in sql
    if not ordered:
        got, dev, host = (sorted(_norm(r)) for r in (got, dev, host))
    assert _norm(got) == _norm(dev) == _norm(host), sql


def test_bucketed_histogram_runs_the_fused_bucket(segs):
    port, _j, _ = segs
    ex = _port(port, True)
    ex.execute(MIXED[8])
    assert ex.engine.meter("timeseries_leaf_device") == 1
    assert ex.engine.meter("clp_served") == 1


@pytest.mark.parametrize("pattern,is_like,reason", FALLBACKS)
def test_fallbacks_raise_with_their_reason(segs, pattern, is_like, reason):
    port, _j, _ = segs
    ex = _port(port, False)
    sql = (f"SELECT COUNT(*) FROM logs WHERE message LIKE '{pattern}'"
           if is_like else
           f"SELECT COUNT(*) FROM logs WHERE REGEXP_LIKE(message, "
           f"'{pattern}')")
    with pytest.raises(NotOffloadable) as e:
        ex.execute(sql)
    assert e.value.reason == reason
    assert ex.engine.meter("clp_fallback", reason) == 1
    assert ex.engine.meter("clp_served") == 0


def test_non_like_predicate_on_a_clp_column_is_refused(segs):
    port, _j, _ = segs
    ex = _port(port, False)
    with pytest.raises(NotOffloadable) as e:
        ex.execute("SELECT COUNT(*) FROM logs WHERE message = 'GC pause 45 "
                   "ms in region r7'")
    assert e.value.reason == "predicate"
    assert ex.engine.meter("clp_fallback", "predicate") == 1


def test_repeat_pattern_stages_nothing(segs):
    """The params cache: a repeated pattern resolves and uploads nothing;
    another pattern of one plan compiles nothing."""
    from pinot_tpu_torch.ops import residency
    port, _j, _ = segs
    ex = _port(port, False)
    sql = "SELECT COUNT(*) FROM logs WHERE message LIKE '%web-01%'"
    first = ex.execute(sql).rows
    t0 = residency.transfer_bytes()
    before = program.trace_count()
    assert ex.execute(sql).rows == first
    assert residency.transfer_bytes() == t0
    ex.execute("SELECT COUNT(*) FROM logs WHERE message LIKE '%db-01%'")
    assert program.trace_count() == before


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------

def test_eight_patterns_coalesce_in_one_held_batch(segs):
    """bench.py:3531's coalesce pool shape: 8 constant-different LIKE
    queries of one plan, the ring held on its first pop until all 8 are
    queued (at most 30 s; a fixed delay let a loaded host split the
    batch): one broadcast batch of 8, each answer bit-identical to the
    query alone, and the batch compiles no program beyond the plan's
    one."""
    port, _j, allm = segs
    eng = TorchOperatorExecutor("cpu", torch.float32)
    hosts = ["web-01", "web-02", "db-01", "alice", "bob42", "10.0.0.1",
             "capacity", "region"]
    sqls = [f"SELECT COUNT(*) FROM logs WHERE message LIKE '%{h}%'"
            for h in hosts]
    codegen0 = program.trace_count()
    alone = [eng.execute(port, QueryContext.from_sql(q))[0].intermediates
             for q in sqls]
    assert program.trace_count() - codegen0 <= 1
    before = eng.dispatcher.stats()
    compiled = program.trace_count()
    disp = eng.dispatcher
    seen = []

    def queued() -> bool:  # latched: the ring's holders all let go
        depth = int(disp._metrics.gauge("dispatch_queue_depth",
                                        labels=disp._labels) or 0)
        if not seen and fp.fired + depth >= len(sqls):
            seen.append(True)
        return bool(seen)
    with eng.dispatcher.active():
        fp = failpoints.arm("server.dispatch.before", delay=30.0, times=2,
                            until=queued)
        try:
            with ThreadPoolExecutor(len(sqls)) as pool:
                futs = [pool.submit(eng.execute, port,
                                    QueryContext.from_sql(q)) for q in sqls]
                got = [f.result(timeout=60) for f in futs]
        finally:
            failpoints.disarm("server.dispatch.before")
    assert [g[0].intermediates for g in got] == alone
    stats = eng.dispatcher.stats()
    stats.subtract(before)
    assert stats["broadcast"] == 1 and stats[("size", 8)] == 1
    assert program.trace_count() == compiled
    for h, g in zip(hosts, got):
        assert sum(r.intermediates[0] for r in g) == \
            sum(1 for m in allm if h in m)


# ---------------------------------------------------------------------------
# chip_smoke.py's log generator at a small size
# ---------------------------------------------------------------------------

def test_chip_smoke_log_leg_on_the_cpu_engine(tmp_path, monkeypatch):
    """The log leg's generator through the parts writer (each segment's
    sample rendered, encoded into its parts and read back), its queries
    through the port on the CPU equal to its numpy truth, the wildcard
    pattern refused, and the 9h pool's truth."""
    import chip_smoke as cs
    monkeypatch.setattr(cs, "LOG_T4", cs.LOG_T0 + 60_000)
    monkeypatch.setattr(cs, "LOG_SAMPLE", 300)
    segs, truths = cs.build_log_segments(str(tmp_path), 3, 3, 30_000)
    ex = QueryExecutor(segs, device="cpu", value_dtype=torch.float64)
    for name, (sql, _k) in cs.log_queries().items():
        got = cs.log_rows(name, ex.execute(sql))
        assert got == cs.log_expected(truths, name), name
        assert got and got[0][-1], name
    with pytest.raises(NotOffloadable) as e:
        ex.execute(cs.LOG_WILDCARD)
    assert e.value.reason == "wildcard"
    for i, sql in enumerate(cs.LOG_POOL):
        assert ex.execute(sql).rows[0][0] == \
            sum(t["pool"][i] for t in truths)
    cols, lines = cs.log_columns(3, 0, 30_000)
    rendered = [cs.log_message(cols, d) for d in range(0, 30_000, 997)]
    assert [segs[0].data_source("message").clp_reader.get(d)
            for d in range(0, 30_000, 997)] == rendered


@pytest.mark.parametrize("mode", ["a", "b"])
def test_chip_smoke_k7_bound_counts_only_readable_table_bytes(mode):
    """chip_smoke.py's K7 bound counts, per member, the logtype LUT and the
    condition and group rows whole, and of each var LUT row (mode 'b': each
    dict bank that a dict condition of a live group names) only the bytes
    of its packed row (one bit per entry, what K7 reads) up to the
    segment's largest dict-var id, against a count doc by doc."""
    import chip_smoke as cs
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    rng = np.random.default_rng(11)
    S, D, vp, nlp, ncp, gp, kd = 3, 50, 64, 8, 16, 10, 2
    cols = {f"clpdv{j}:m": torch.from_numpy(
        rng.integers(0, 40, (S, D)).astype(np.int32)) for j in range(kd)}
    params = {"leaf0:alut": torch.zeros((S, 8), dtype=torch.bool)}
    reach = [max(int(cols[f"clpdv{j}:m"][s].max()) for j in range(kd)) + 1
             for s in range(S)]
    want = S * 8
    if mode == "a":
        params["leaf0:dvlut"] = torch.zeros((S, vp), dtype=torch.bool)
        want += sum((r + 7) // 8 for r in reach)
    else:
        glt = rng.integers(-1, 6, (S, gp)).astype(np.int32)
        gmem = rng.random((S, gp, ncp)) < 0.2
        ck = rng.integers(0, 3, (S, ncp)).astype(np.int8)
        cl = rng.integers(-1, 10, (S, ncp)).astype(np.int32)
        params.update({
            "leaf0:glt": torch.from_numpy(glt),
            "leaf0:gmem": torch.from_numpy(gmem),
            "leaf0:ck": torch.from_numpy(ck), "leaf0:cl": torch.from_numpy(cl),
            **{f"leaf0:{k}": torch.zeros((S, ncp), dtype=torch.int32)
               for k in ("cs", "chi", "clo")},
            "leaf0:dlut": torch.zeros((S, nlp, vp), dtype=torch.bool)})
        want += S * gp * 4 + S * gp * ncp + S * ncp + 4 * S * ncp * 4
        for s in range(S):
            banks = {min(max(int(cl[s, c]), 0), nlp - 1)
                     for c in range(ncp) if ck[s, c] == 2
                     and any(glt[s, g] >= 0 and gmem[s, g, c]
                             for g in range(gp))}
            want += len(banks) * ((reach[s] + 7) // 8)
    leaf = DeviceLeaf("clp", "m", (mode, kd, 0 if mode == "a" else 2))
    assert cs.clp_table_bytes(0, leaf, cols, params) == want
