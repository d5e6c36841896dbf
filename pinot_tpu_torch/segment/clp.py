"""CLP-style log compression: logtype templates plus variable columns.

Counterpart of pinot_tpu/segment/clp.py (the y-scope fork's
CLPForwardIndexCreatorV1/V2 and CLPForwardIndexReaderV1/V2): each message
splits into a logtype (the template, variables replaced by placeholder
bytes), dictionary variables (tokens that only round-trip as strings) and
encoded variables (ints and floats packed into int64). The byte format is
the JAX package's, so either package reads the other's columns.

The writer is split in two: `encode` turns messages into `ClpParts`, and
`write_clp_parts` packs parts into the column. A generator that already
holds the parts (a template id and variables per line) writes a large
column through `write_clp_parts` without rendering a string per line;
`write_clp_column(messages)` is `write_clp_parts(encode(messages))`. Both
give the JAX writer's exact bytes, the logtype dictionary and the variable
dictionary in first-appearance order included.

Placeholders (outside printable ASCII):
  \\x11 int variable (rendered str(int))
  \\x12 dictionary variable (string token)
  \\x13 float variable (IEEE bits in int64, rendered repr-roundtrip)
"""
from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.segment import codec

INT_PH = "\x11"
DICT_PH = "\x12"
FLOAT_PH = "\x13"

# token = run of non-delimiter chars; delimiters stay in the logtype
_TOKEN_RE = re.compile(r"[^\s=:,\[\]\(\)\"']+")
_HAS_DIGIT = re.compile(r"\d")


def encode_token(tok: str) -> Tuple[str, Any]:
    """Classify one token as `encode_message` does: ("static", tok) |
    ("int", int64 value) | ("float", IEEE bits as int64) | ("dict", tok).
    The pattern planner (ops/clp_device.py) classifies pattern tokens
    through this function too."""
    if not _HAS_DIGIT.search(tok):
        return "static", tok
    try:
        v = int(tok)
        if str(v) == tok and -(2**63) <= v < 2**63:
            return "int", v
    except ValueError:
        pass
    try:
        f = float(tok)
        if repr(f) == tok:
            return "float", struct.unpack("<q", struct.pack("<d", f))[0]
    except ValueError:
        pass
    return "dict", tok


def encode_message(msg: str) -> Tuple[str, List[str], List[int]]:
    """message -> (logtype, dict_vars, encoded_vars)."""
    dict_vars: List[str] = []
    encoded: List[int] = []

    def repl(m: re.Match) -> str:
        kind, val = encode_token(m.group())
        if kind == "static":
            return val
        if kind == "dict":
            dict_vars.append(val)
            return DICT_PH
        encoded.append(val)
        return INT_PH if kind == "int" else FLOAT_PH

    logtype = _TOKEN_RE.sub(repl, msg)
    return logtype, dict_vars, encoded


def decode_message(logtype: str, dict_vars: Sequence[str],
                   encoded_vars: Sequence[int]) -> str:
    out: List[str] = []
    di = ei = 0
    for ch in logtype:
        if ch == INT_PH:
            out.append(str(encoded_vars[ei]))
            ei += 1
        elif ch == FLOAT_PH:
            out.append(repr(struct.unpack(
                "<d", struct.pack("<q", encoded_vars[ei]))[0]))
            ei += 1
        elif ch == DICT_PH:
            out.append(dict_vars[di])
            di += 1
        else:
            out.append(ch)
    return "".join(out)


# ---------------------------------------------------------------------------
# Forward index (one packed buffer per CLP column)
# ---------------------------------------------------------------------------
# layout:
#   u32 num_docs, u32 num_logtypes, u32 lt_blob_len
#   logtype dictionary: i32 offsets[num_logtypes+1] + utf8 blob
#   i32 logtype_id per doc
#   dictvars: u32 num_unique, u32 uniq_len, str_section(uniques),
#             i32 var_offsets[num_docs+1], i32 var_ids[num_vars]
#   encodedvars: i32 enc_offsets[num_docs+1], i64 flat[num_enc]

_U32 = struct.Struct("<I")


@dataclass
class ClpParts:
    """A CLP column before packing. Per doc: `lt_ids[d]` indexes
    `logtypes`; its `dv_counts[d]` dictionary variables are the next codes
    of `dv_codes`, each indexing `dv_tokens` (any sequence indexable by a
    code: a list, or an object computing the token); its `ev_counts[d]`
    encoded variables the next values of `ev`. `logtypes` are distinct;
    the tables need not be in first-appearance order, nor free of unused
    entries: the writer reorders them as the JAX writer orders them."""
    logtypes: Sequence[str]
    lt_ids: np.ndarray
    dv_counts: np.ndarray
    dv_codes: np.ndarray
    dv_tokens: Any
    ev_counts: np.ndarray
    ev: np.ndarray

    @property
    def num_docs(self) -> int:
        return len(self.lt_ids)

    def __len__(self) -> int:
        return self.num_docs


def encode(messages: Sequence[Any]) -> ClpParts:
    """Messages (None reads as "") -> their parts, tables in
    first-appearance order."""
    n = len(messages)
    lt_index: dict = {}
    lt_ids = np.empty(n, dtype=np.int32)
    tok_index: dict = {}
    codes: List[int] = []
    dv_counts = np.empty(n, dtype=np.int32)
    enc: List[int] = []
    ev_counts = np.empty(n, dtype=np.int32)
    for i, m in enumerate(messages):
        lt, dv, ev = encode_message("" if m is None else str(m))
        lt_ids[i] = lt_index.setdefault(lt, len(lt_index))
        codes.extend(tok_index.setdefault(t, len(tok_index)) for t in dv)
        dv_counts[i] = len(dv)
        enc.extend(ev)
        ev_counts[i] = len(ev)
    return ClpParts(list(lt_index), lt_ids, dv_counts,
                    np.asarray(codes, dtype=np.int64), list(tok_index),
                    ev_counts, np.asarray(enc, dtype=np.int64))


def _first_appearance(codes: np.ndarray):
    """(the distinct codes in first-appearance order, each code's rank in
    that order) for int codes."""
    if not len(codes):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    uniq, first, inv = np.unique(codes, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    return uniq[order], rank[inv.reshape(-1)]


def _str_section(strings: Sequence[str]) -> bytes:
    blobs = [s.encode() for s in strings]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int32)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return offsets.tobytes() + b"".join(blobs)


def _prefix(counts: np.ndarray) -> np.ndarray:
    out = np.zeros(len(counts) + 1, dtype=np.int32)
    np.cumsum(counts, out=out[1:])
    return out


def _var_ids(parts: ClpParts):
    """(the variable dictionary: the distinct tokens in first-appearance
    order, each dict-var occurrence's id in it); a token that several
    codes render is one entry."""
    used, rank = _first_appearance(np.asarray(parts.dv_codes,
                                              dtype=np.int64))
    uniq: List[str] = []
    var_of: dict = {}
    remap = np.empty(len(used), dtype=np.int32)
    for r, c in enumerate(used):
        tok = parts.dv_tokens[int(c)]
        remap[r] = var_of.setdefault(tok, len(uniq))
        if remap[r] == len(uniq):
            uniq.append(tok)
    return uniq, remap[rank] if len(rank) else np.zeros(0, dtype=np.int32)


def write_clp_parts(parts: ClpParts) -> bytes:
    """Pack parts into the column's bytes (JAX `write_clp_column`'s
    layout): logtypes and variable tokens renumbered by first appearance
    in doc order."""
    lt_order, lt_ids = _first_appearance(np.asarray(parts.lt_ids,
                                                    dtype=np.int64))
    logtypes = [parts.logtypes[int(c)] for c in lt_order]
    uniq_vars, var_ids = _var_ids(parts)
    lt_section = _str_section(logtypes)
    uniq_section = _str_section(uniq_vars)
    return b"".join([
        _U32.pack(parts.num_docs), _U32.pack(len(logtypes)),
        _U32.pack(len(lt_section)), lt_section,
        lt_ids.astype(np.int32).tobytes(),
        _U32.pack(len(uniq_vars)), _U32.pack(len(uniq_section)),
        uniq_section,
        _prefix(parts.dv_counts).tobytes(),
        var_ids.astype(np.int32).tobytes(),
        _prefix(parts.ev_counts).tobytes(),
        np.asarray(parts.ev, dtype=np.int64).tobytes(),
    ])


def write_clp_column(messages: Sequence[Any]) -> bytes:
    return write_clp_parts(encode(messages))


def parts_cardinality(parts: ClpParts) -> int:
    """The number of distinct messages the parts render: a logtype fixes
    its docs' variable counts, so distinct messages are the distinct
    (logtype, variable tokens) rows of each logtype's docs."""
    n = parts.num_docs
    if not n:
        return 0
    lt = np.asarray(parts.lt_ids, dtype=np.int64)
    dv = _var_ids(parts)[1].astype(np.int64)
    dvo, evo = _prefix(parts.dv_counts), _prefix(parts.ev_counts)
    ev = np.asarray(parts.ev, dtype=np.int64)
    total = 0
    for t in np.unique(lt):
        docs = np.nonzero(lt == t)[0]
        kd = int(parts.dv_counts[docs[0]])
        ke = int(parts.ev_counts[docs[0]])
        # the row's variables as one exact int64 key: each column's dense
        # rank folded in by mixed radix, re-ranked before it could overflow
        key = np.zeros(len(docs), np.int64)
        span = 1
        for col in [dv[dvo[docs] + j] for j in range(kd)] \
                + [ev[evo[docs] + j] for j in range(ke)]:
            _u, rank = np.unique(col, return_inverse=True)
            n = int(rank.max()) + 1
            if span * n >= 1 << 62:
                _u, key = np.unique(key, return_inverse=True)
                span = int(key.max()) + 1
            key = key * n + rank.reshape(-1)
            span *= n
        total += len(np.unique(key))
    return total


def pack_compressed(buf: bytes, compression: str = "LZ4") -> bytes:
    """Envelope: u32 codec_id, u32 raw_len, compressed payload (the chunk
    compression the reference applies on top of CLP sections; LZ4 writes
    as GZIP here, segment/codec.py)."""
    cid, comp = codec.compress(buf, codec.codec_id(compression))
    return _U32.pack(cid) + _U32.pack(len(buf)) + comp


def unpack_compressed(buf) -> bytes:
    buf = bytes(buf)
    cid = _U32.unpack_from(buf, 0)[0]
    raw_len = _U32.unpack_from(buf, 4)[0]
    return codec.decompress(buf[8:], cid, raw_len)


class CLPForwardIndexReader:
    """Ref CLPForwardIndexReaderV2: decodes on demand; the logtype ids and
    dictionaries are directly accessible for template-level predicates."""

    def __init__(self, buf: bytes):
        buf = bytes(buf)
        self.num_docs = _U32.unpack_from(buf, 0)[0]
        num_lt = _U32.unpack_from(buf, 4)[0]
        lt_len = _U32.unpack_from(buf, 8)[0]
        pos = 12
        self.logtypes = self._read_strs(buf, pos, num_lt)
        pos += lt_len
        self.logtype_ids = np.frombuffer(buf, np.int32, self.num_docs, pos)
        pos += 4 * self.num_docs
        num_uniq = _U32.unpack_from(buf, pos)[0]
        uniq_len = _U32.unpack_from(buf, pos + 4)[0]
        pos += 8
        self.var_dictionary = self._read_strs(buf, pos, num_uniq)
        pos += uniq_len
        self.dv_offsets = np.frombuffer(buf, np.int32, self.num_docs + 1, pos)
        pos += 4 * (self.num_docs + 1)
        num_dv = int(self.dv_offsets[-1])
        self.var_ids = np.frombuffer(buf, np.int32, num_dv, pos)
        pos += 4 * num_dv
        self.enc_offsets = np.frombuffer(buf, np.int32, self.num_docs + 1, pos)
        pos += 4 * (self.num_docs + 1)
        num_enc = int(self.enc_offsets[-1])
        self.encoded_vars = np.frombuffer(buf, np.int64, num_enc, pos)
        self._max_dv = self._max_ev = self._var_index = None

    @staticmethod
    def _read_strs(buf: bytes, pos: int, count: int) -> List[str]:
        offsets = np.frombuffer(buf, np.int32, count + 1, pos).tolist()
        start = pos + 4 * (count + 1)
        return [buf[start + offsets[i]:start + offsets[i + 1]].decode()
                for i in range(count)]

    def get(self, doc_id: int) -> str:
        """One doc from the prefix-offset indexes, never a whole-column
        decode (ref CLPForwardIndexReaderV2.getString)."""
        lt = self.logtypes[self.logtype_ids[doc_id]]
        a, b = self.dv_offsets[doc_id], self.dv_offsets[doc_id + 1]
        dv = [self.var_dictionary[i] for i in self.var_ids[a:b]]
        a, b = self.enc_offsets[doc_id], self.enc_offsets[doc_id + 1]
        ev = self.encoded_vars[a:b]
        return decode_message(lt, dv, ev.tolist())

    def decode_all(self) -> np.ndarray:
        """Whole-column decode into one object array."""
        out = np.empty(self.num_docs, dtype=object)
        lts, vd = self.logtypes, self.var_dictionary
        lt_ids = self.logtype_ids.tolist()
        var_ids = self.var_ids.tolist()
        dvo, eco = self.dv_offsets.tolist(), self.enc_offsets.tolist()
        enc = self.encoded_vars.tolist()
        for d in range(self.num_docs):
            dv = [vd[i] for i in var_ids[dvo[d]:dvo[d + 1]]]
            out[d] = decode_message(lts[lt_ids[d]], dv, enc[eco[d]:eco[d + 1]])
        return out

    @property
    def max_dict_vars(self) -> int:
        """Widest per-doc dictionary-variable count (device slot sizing)."""
        if self._max_dv is None:
            self._max_dv = int(np.diff(self.dv_offsets).max()) \
                if self.num_docs else 0
        return self._max_dv

    @property
    def max_encoded_vars(self) -> int:
        """Widest per-doc encoded-variable count (device slot sizing)."""
        if self._max_ev is None:
            self._max_ev = int(np.diff(self.enc_offsets).max()) \
                if self.num_docs else 0
        return self._max_ev

    @property
    def var_index(self) -> dict:
        """token -> var-dictionary id (planner-side condition LUTs)."""
        if self._var_index is None:
            self._var_index = {v: i for i, v in
                               enumerate(self.var_dictionary)}
        return self._var_index
