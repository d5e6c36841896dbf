"""LIKE / REGEXP_LIKE over CLP log columns: the host half of the device
path (pattern compilation, per-segment match plans, staging).

Counterpart of pinot_tpu/ops/clp_device.py :1-694 (the y-scope fork's
ClpRewriter + CLPForwardIndexReaderV2 query path): a LIKE or regex over a
CLP column never decodes the column. The host compiles the pattern against
each segment's logtype dictionary into a match plan, and the per-doc
evaluation runs on the card as K7 `clp_match` (ops/csrc/clp_match.cu; its
plain version `kernels.clp_match`) over fixed-width pseudo-columns staged
from the CLP forward index:

    clpid:<col>         [S, D] int32  logtype id per doc
    clpdv<j>:<col>      [S, D] int32  j-th dict-var id (sentinel = card)
    clpehi<j>:<col>     [S, D] int32  j-th encoded var, v >> 32
    clpelo<j>:<col>     [S, D] int32  j-th encoded var, low 32 bits

K1 / K2 / K4 then read K7's [S, D] match mask as a filter leaf.

Soundness rests on the codec's tokenization invariants (segment/clp.py):
variables are maximal non-delimiter runs containing a digit, so in the
logtype every placeholder is delimiter-bounded; a digitless,
delimiterless needle can never span a static/variable boundary; a full
digitless token is never a variable; and int/float variable renderings
use only ``[0-9.+-e]``, so digitless text overlaps encoded-variable text
only when it consists entirely of ``+-.e`` (those patterns stay on the
host).

Two modes, picked per pattern (leaf.meta = (mode, Kd, Ke)):

mode 'a' (bare substring, the grep case): a single unanchored piece that
is digitless and delimiterless. match = needle-in-logtype LUT over the
logtype id, OR needle-in-variable LUT over every dict-var slot.

mode 'b' (generic): the pattern splits on wildcards into pieces; each
piece compiles to a regex over the LOGTYPE string with variable tokens
classified exactly as the encoder classifies them (clp.encode_token).
Per logtype, ordered non-overlapping piece placements enumerate the
candidate alignments; each alignment yields a condition set over
variable slots (encoded-var equality as an exact (hi, lo) i32 pair,
dict-var membership as a var-dictionary LUT). A doc matches when its
logtype is a candidate (the logtype LUT) or some group (logtype, set of
conditions) has its logtype and every condition holds.

The pattern never enters the leaf: its constants resolve at staging
(`leaf_params`), so queries whose constants differ share one program.
K7 reads the dict-var LUTs packed, one bit per entry (`pack_banks`: an
engine on the card packs them once, in place of the bool tables, when it
stages the leaf's parameters into its params cache); the plain version,
which an engine on the CPU runs, reads the bool tables.
Patterns the planner cannot push raise NotOffloadable in the engine, the
reason metered as ``clp_fallback{reason=}``:

    disabled     pushdown knob off (the port has no such knob: unused)
    predicate    not a LIKE/regexp_like over a literal pattern
    charWildcard LIKE ``_`` or regex ``.`` (single-char wildcards)
    regex        regex features beyond literals + ``.*`` + anchors
    wildcard     a wildcard cuts a variable-like token mid-token
    partial      facing partial tokens could co-occupy one variable
    slots        per-doc variable slots / conditions above the device cap
    alignments   candidate alignment count above the device cap
    staging      a batch segment has no loadable CLP reader
"""
from __future__ import annotations

import functools
import re
import threading
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from pinot_tpu_torch.segment import index_types as it
from pinot_tpu_torch.segment.clp import (
    DICT_PH, FLOAT_PH, INT_PH, _HAS_DIGIT, _TOKEN_RE, encode_token)

#: documented fallback-reason vocabulary (README "Log analytics")
FALLBACK_REASONS = ("disabled", "predicate", "charWildcard", "regex",
                    "wildcard", "partial", "slots", "alignments", "staging")

#: device caps — beyond these the host path is cheaper than the staging
KD_MAX = 16      # dict-var slots staged per column
KE_MAX = 16      # encoded-var slots staged per column
GROUPS_MAX = 64  # (logtype, conditions) groups per segment
CONDS_MAX = 16   # distinct conditions per segment
LUTS_MAX = 8     # distinct var-dictionary LUTs per segment
_OCCS_MAX = 64   # piece occurrences per logtype
_COMBOS_MAX = 256  # raw alignments per logtype

_DELIM_RE = re.compile(r"[\s=:,\[\]\(\)\"']")
_PLACEHOLDERS = (INT_PH, DICT_PH, FLOAT_PH)
#: chars an int/float variable rendering can consist of
_FLOAT_CHARS = frozenset("0123456789+-.e")
_INT_SUB = re.compile(r"-?[0-9]+")


def _num_possible(tok: str) -> bool:
    """Could `tok` appear as a substring of an int or float variable's
    rendered text? If so, a wildcard-adjacent occurrence of tok cannot
    be decided by dict-var LUTs alone (numeric prefix/suffix predicates
    are not device-expressible) and the pattern falls back. str(int) is
    digits with an optional leading '-'; repr(float) draws from
    ``[0-9+-.e]`` with at most one each of '.', 'e', '+'."""
    if _INT_SUB.fullmatch(tok):
        return True
    return (set(tok) <= _FLOAT_CHARS and tok.count(".") <= 1
            and tok.count("e") <= 1 and tok.count("+") <= 1)


def _pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def _split64(v: int) -> Tuple[int, int]:
    """int64 -> exact (hi, lo) int32 pair (hi = v >> 32, lo = low word
    reinterpreted signed) — matches the staged split planes bit-for-bit."""
    hi = v >> 32
    lo = v & 0xFFFFFFFF
    if lo >= 1 << 31:
        lo -= 1 << 32
    return int(hi), int(lo)


# ---------------------------------------------------------------------------
# pattern compilation (segment-independent, cached per pattern)
# ---------------------------------------------------------------------------

class _Template(NamedTuple):
    """One wildcard-free pattern piece compiled against logtype text.

    regex: the piece with variable-class tokens replaced by placeholder
    captures, wrapped in ``(?=(...))`` so finditer enumerates every
    (overlapping) occurrence start; group 1 spans the occurrence, groups
    2.. align with `binds`.
    binds: per capture group, the condition the occurrence imposes when
    that group matched a placeholder:
      ("enc", hi, lo)          encoded-var equality at the slot
      ("dicteq", tok)          dict-var == tok
      ("dictsub", mode, tok)   dict-var startswith/endswith/contains tok
    """
    regex: Any
    binds: Tuple[Tuple, ...]
    lead_partial: bool
    trail_partial: bool


class CompiledPattern(NamedTuple):
    key: Tuple[str, bool]
    templates: Tuple[_Template, ...]
    anchor_start: bool
    anchor_end: bool
    needle: Optional[str]   # mode 'a': bare substring
    always: bool            # matches every message ('%', '.*')
    empty_exact: bool       # matches only the empty message ('')


def _piece_template(piece: str, bound_left: bool, bound_right: bool):
    """Compile one piece -> (_Template, None) or (None, reason)."""
    parts: List[str] = ["(?=("]
    binds: List[Tuple] = []
    pos = 0
    lead_partial = trail_partial = False
    for m in _TOKEN_RE.finditer(piece):
        a, b = m.span()
        if a > pos:
            parts.append(re.escape(piece[pos:a]))
        tok = m.group()
        # a token edge is "bounded" when the message provably cannot
        # continue the token past it: an adjacent in-piece delimiter, or
        # a pattern anchor pinning the message edge
        left_b = a > 0 or bound_left
        right_b = b < len(piece) or bound_right
        kind, val = encode_token(tok)
        if not (left_b and right_b):
            # partial token: the containing message token may extend
            # past the wildcard edge
            if _num_possible(tok):
                # the extended token could be an int/float variable —
                # numeric prefix/suffix predicates don't push down
                return None, "wildcard"
            mode = ("contains" if not (left_b or right_b)
                    else "endswith" if not left_b else "startswith")
            lead_partial = lead_partial or not left_b
            trail_partial = trail_partial or not right_b
            if _HAS_DIGIT.search(tok):
                # digit-bearing: the containing message token is always
                # a variable, and numeric classes were excluded above —
                # it can only be a dict var
                parts.append("(%s)" % DICT_PH)
            else:
                # either verbatim static text, or inside a dict var
                parts.append("(?:%s|(%s))" % (re.escape(tok), DICT_PH))
            binds.append(("dictsub", mode, tok))
        elif kind == "static":
            # full digitless tokens are never variables: literal
            parts.append(re.escape(tok))
        elif kind == "dict":
            parts.append("(%s)" % DICT_PH)
            binds.append(("dicteq", val))
        else:
            ph = INT_PH if kind == "int" else FLOAT_PH
            parts.append("(%s)" % ph)
            binds.append(("enc",) + _split64(val))
        pos = b
    if pos < len(piece):
        parts.append(re.escape(piece[pos:]))
    parts.append("))")
    return _Template(re.compile("".join(parts)), tuple(binds),
                     lead_partial, trail_partial), None


def _compile_pieces(pieces: List[str], anchor_start: bool, anchor_end: bool,
                    key: Tuple[str, bool]):
    empty = CompiledPattern(key, (), anchor_start, anchor_end, None,
                            False, False)
    if any(ph in p for p in pieces for ph in _PLACEHOLDERS):
        return None, "regex"  # placeholder bytes in the pattern itself
    if not pieces:
        if anchor_start and anchor_end:
            return empty._replace(empty_exact=True), None
        return empty._replace(always=True), None
    if (len(pieces) == 1 and not anchor_start and not anchor_end
            and not _DELIM_RE.search(pieces[0])
            and not _num_possible(pieces[0])):
        # bare substring: logtype-text LUT + any-dict-var LUT suffice (a
        # digit-bearing needle never appears in static text — logtypes
        # are digit-free — so its alut is simply all-False)
        return empty._replace(needle=pieces[0]), None
    templates: List[_Template] = []
    for pi, p in enumerate(pieces):
        t, reason = _piece_template(
            p, pi == 0 and anchor_start,
            pi == len(pieces) - 1 and anchor_end)
        if t is None:
            return None, reason
        templates.append(t)
    # adjacent facing partial tokens could co-occupy ONE variable in the
    # message with no logtype-level witness — not representable
    for t1, t2 in zip(templates, templates[1:]):
        if t1.trail_partial and t2.lead_partial:
            return None, "partial"
    return empty._replace(templates=tuple(templates)), None


@functools.lru_cache(maxsize=512)
def compile_pattern(pattern: str, is_like: bool):
    """Pattern -> (CompiledPattern, None) or (None, fallback reason).

    LIKE: ``%`` splits pieces, ``_`` is unsupported. Regex: the host
    evaluates ``re.search`` (unanchored unless ``^``/``$``), so only
    literals + ``.*`` runs + edge anchors push down; everything else
    falls back."""
    key = (pattern, is_like)
    if is_like:
        if "_" in pattern:
            return None, "charWildcard"
        raw = pattern.split("%")
        return _compile_pieces([p for p in raw if p],
                               not pattern.startswith("%"),
                               not pattern.endswith("%"), key)
    anchor_start = pattern.startswith("^")
    i = 1 if anchor_start else 0
    anchor_end = pattern.endswith("$") and not pattern.endswith("\\$")
    end = len(pattern) - 1 if anchor_end else len(pattern)
    pieces: List[str] = [""]
    while i < end:
        c = pattern[i]
        if c == ".":
            if i + 1 < end and pattern[i + 1] == "*":
                pieces.append("")
                i += 2
                continue
            return None, "charWildcard"
        if c == "\\":
            if i + 1 >= end:
                return None, "regex"
            nxt = pattern[i + 1]
            if nxt.isalnum():
                return None, "regex"  # character classes (\d, \w, ...)
            pieces[-1] += nxt
            i += 2
            continue
        if c in "[]{}()|+?*^$":
            return None, "regex"
        pieces[-1] += c
        i += 1
    # leading/trailing .* runs void the adjacent anchor
    if len(pieces) > 1 and pieces[0] == "":
        anchor_start = False
    if len(pieces) > 1 and pieces[-1] == "":
        anchor_end = False
    return _compile_pieces([p for p in pieces if p],
                           anchor_start, anchor_end, key)


# ---------------------------------------------------------------------------
# per-segment match plan (cached per (segment, column, pattern))
# ---------------------------------------------------------------------------

class SegPlan:
    """One segment's compiled match plan (host-side numpy)."""
    __slots__ = ("always", "glt", "gmem", "ckind", "cslot", "chi", "clo",
                 "clut", "luts", "card", "kd_need", "ke_need")

    def __init__(self, always: np.ndarray, card: int):
        self.always = always
        self.card = card
        self.glt = np.zeros(0, np.int32)
        self.gmem = np.zeros((0, 0), bool)
        self.ckind = np.zeros(0, np.int8)
        self.cslot = np.zeros(0, np.int32)
        self.chi = np.zeros(0, np.int32)
        self.clo = np.zeros(0, np.int32)
        self.clut = np.zeros(0, np.int32)
        self.luts = np.zeros((0, card), bool)
        self.kd_need = 0
        self.ke_need = 0


def _occurrences(tmpl: _Template, lt: str, enc_pref: List[int],
                 dict_pref: List[int]):
    """Every (overlapping) occurrence of a piece in a logtype ->
    [(start, end, conds)], or None past the cap. Slot index = count of
    same-family placeholders before the matched position."""
    out = []
    for m in tmpl.regex.finditer(lt):
        conds: List[Tuple] = []
        for g, bind in enumerate(tmpl.binds, start=2):
            p = m.start(g)
            if p < 0:
                continue  # static alternative matched; no condition
            if bind[0] == "enc":
                conds.append(("enc", enc_pref[p], bind[1], bind[2]))
            elif bind[0] == "dicteq":
                conds.append(("dict", dict_pref[p], ("eq", bind[1])))
            else:  # dictsub
                conds.append(("dict", dict_pref[p], (bind[1], bind[2])))
        out.append((m.start(1), m.end(1), tuple(conds)))
        if len(out) > _OCCS_MAX:
            return None
    return out


def _combine(occs: List[list], lt_len: int, a_start: bool, a_end: bool):
    """Ordered non-overlapping placements of all pieces -> list of
    condition tuples (one per alignment), or None past the cap."""
    results: List[Tuple] = []
    n = len(occs)

    def dfs(pi: int, min_s: int, acc: List[Tuple]) -> bool:
        if len(results) > _COMBOS_MAX:
            return False
        if pi == n:
            results.append(tuple(acc))
            return True
        for s, e, conds in occs[pi]:
            if s < min_s:
                continue
            if pi == 0 and a_start and s != 0:
                continue
            if pi == n - 1 and a_end and e != lt_len:
                continue
            if not dfs(pi + 1, e, acc + list(conds)):
                return False
        return True

    if not dfs(0, 0, []):
        return None
    return results


def _lut_row(spec: Tuple[str, str], reader) -> Optional[np.ndarray]:
    """Var-dictionary LUT for one dict condition; None = unsatisfiable."""
    mode, tok = spec
    vd = reader.var_dictionary
    if mode == "eq":
        vid = reader.var_index.get(tok)
        if vid is None:
            return None
        row = np.zeros(len(vd), bool)
        row[vid] = True
        return row
    if mode == "startswith":
        row = np.fromiter((v.startswith(tok) for v in vd), bool, len(vd))
    elif mode == "endswith":
        row = np.fromiter((v.endswith(tok) for v in vd), bool, len(vd))
    else:
        row = np.fromiter((tok in v for v in vd), bool, len(vd))
    return row if row.any() else None


def _plan_segment(reader, compiled: CompiledPattern):
    """-> (SegPlan, None) or (None, reason)."""
    logtypes = reader.logtypes
    card = len(reader.var_dictionary)
    always = np.zeros(len(logtypes), bool)
    sp = SegPlan(always, card)
    if compiled.always:
        always[:] = True
        return sp, None
    if compiled.empty_exact:
        for i, lt in enumerate(logtypes):
            always[i] = lt == ""
        return sp, None
    if compiled.needle is not None:
        needle = compiled.needle
        for i, lt in enumerate(logtypes):
            always[i] = needle in lt
        kd = reader.max_dict_vars
        if kd > KD_MAX:
            return None, "slots"
        if kd:
            vd = reader.var_dictionary
            sp.luts = np.fromiter((needle in v for v in vd),
                                  bool, card).reshape(1, card)
            sp.kd_need = kd
        return sp, None

    # mode 'b': enumerate alignments per logtype
    lut_rows: Dict[Tuple, Optional[int]] = {}  # spec -> lut row (None=dead)
    luts: List[np.ndarray] = []
    cond_ix: Dict[Tuple, int] = {}  # resolved cond key -> index
    ckind: List[int] = []
    cslot: List[int] = []
    chi: List[int] = []
    clo: List[int] = []
    clut: List[int] = []
    groups: set = set()
    for ltid, lt in enumerate(logtypes):
        enc_pref = [0] * (len(lt) + 1)
        dict_pref = [0] * (len(lt) + 1)
        for p, ch in enumerate(lt):
            enc_pref[p + 1] = enc_pref[p] + (ch == INT_PH or ch == FLOAT_PH)
            dict_pref[p + 1] = dict_pref[p] + (ch == DICT_PH)
        occs = []
        feasible = True
        for tmpl in compiled.templates:
            o = _occurrences(tmpl, lt, enc_pref, dict_pref)
            if o is None:
                return None, "alignments"
            if not o:
                feasible = False
                break
            occs.append(o)
        if not feasible:
            continue
        combos = _combine(occs, len(lt), compiled.anchor_start,
                          compiled.anchor_end)
        if combos is None:
            return None, "alignments"
        for conds in combos:
            idxs = set()
            dead = False
            for cond in conds:
                if cond[0] == "dict":
                    spec = cond[2]
                    if spec not in lut_rows:
                        row = _lut_row(spec, reader)
                        if row is None:
                            lut_rows[spec] = None
                        else:
                            lut_rows[spec] = len(luts)
                            luts.append(row)
                    li = lut_rows[spec]
                    if li is None:
                        dead = True
                        break
                    key = ("dict", cond[1], li)
                    if key not in cond_ix:
                        cond_ix[key] = len(ckind)
                        ckind.append(2)
                        cslot.append(cond[1])
                        chi.append(0)
                        clo.append(0)
                        clut.append(li)
                else:
                    key = cond
                    if key not in cond_ix:
                        cond_ix[key] = len(ckind)
                        ckind.append(1)
                        cslot.append(cond[1])
                        chi.append(cond[2])
                        clo.append(cond[3])
                        clut.append(0)
                idxs.add(cond_ix[key])
            if dead:
                continue
            if not idxs:
                always[ltid] = True  # unconditional alignment wins
                break
            groups.add((ltid, tuple(sorted(idxs))))
    live = sorted((ltid, ix) for ltid, ix in groups if not always[ltid])
    if len(live) > GROUPS_MAX:
        return None, "alignments"
    if len(ckind) > CONDS_MAX:
        return None, "slots"
    if len(luts) > LUTS_MAX:
        return None, "slots"
    sp.glt = np.array([g[0] for g in live], np.int32)
    sp.gmem = np.zeros((len(live), len(ckind)), bool)
    for gi, (_, ix) in enumerate(live):
        for ci in ix:
            sp.gmem[gi, ci] = True
    sp.ckind = np.array(ckind, np.int8)
    sp.cslot = np.array(cslot, np.int32)
    sp.chi = np.array(chi, np.int32)
    sp.clo = np.array(clo, np.int32)
    sp.clut = np.array(clut, np.int32)
    if luts:
        sp.luts = np.stack(luts)
    for k, s in zip(ckind, cslot):
        if k == 2:
            sp.kd_need = max(sp.kd_need, s + 1)
        else:
            sp.ke_need = max(sp.ke_need, s + 1)
    return sp, None


#: bounded per-(segment, column, pattern) plan cache; strong segment ref
#: with identity verification (the engine's host-row-cache discipline)
_SEG_PLANS: "OrderedDict[tuple, tuple]" = OrderedDict()
_SEG_PLANS_MAX = 256
_plan_lock = threading.Lock()


def _reader(seg, col):
    try:
        return seg.data_source(col).clp_reader
    except (KeyError, ValueError, AttributeError):
        return None


def seg_plan(seg, col: str, compiled: CompiledPattern):
    key = (id(seg), col, compiled.key)
    with _plan_lock:
        hit = _SEG_PLANS.get(key)
        if hit is not None and hit[0] is seg:
            _SEG_PLANS.move_to_end(key)
            return hit[1], hit[2]
    reader = _reader(seg, col)
    if reader is None:
        return None, "staging"
    sp, reason = _plan_segment(reader, compiled)
    with _plan_lock:
        _SEG_PLANS[key] = (seg, sp, reason)
        while len(_SEG_PLANS) > _SEG_PLANS_MAX:
            _SEG_PLANS.popitem(last=False)
    return sp, reason


def is_clp_column(seg, col: str) -> bool:
    meta = getattr(seg, "metadata", None)
    columns = getattr(meta, "columns", None)
    if not columns:
        return False
    cm = columns.get(col)
    return cm is not None and it.CLP in getattr(cm, "indexes", ())


def plan_leaf(segments, col: str, pattern: str, is_like: bool):
    """Batch-level leaf planning -> ((mode, Kd, Ke), None) or
    (None, reason). Kd/Ke are pow2 slot-bucket counts folded into the
    DeviceLeaf meta (and so into the plan fingerprint)."""
    compiled, reason = compile_pattern(pattern, is_like)
    if compiled is None:
        return None, reason
    mode = "b" if compiled.templates else "a"
    kd = ke = 0
    for seg in segments:
        if not is_clp_column(seg, col):
            return None, "staging"
        sp, sreason = seg_plan(seg, col, compiled)
        if sp is None:
            return None, sreason
        kd = max(kd, sp.kd_need)
        ke = max(ke, sp.ke_need)
    if kd > KD_MAX or ke > KE_MAX:
        return None, "slots"
    return (mode, _pow2(kd) if kd else 0, _pow2(ke) if ke else 0), None


def staged_cols(leaves) -> Tuple[Tuple[str, int, int], ...]:
    """Union the clp leaves into the DevicePlan.clp_cols staging spec."""
    agg: Dict[str, Tuple[int, int]] = {}
    for lf in leaves:
        if lf.kind != "clp":
            continue
        _, kd, ke = lf.meta
        cur = agg.get(lf.column, (0, 0))
        agg[lf.column] = (max(cur[0], kd), max(cur[1], ke))
    return tuple(sorted((c, kd, ke) for c, (kd, ke) in agg.items()))


# ---------------------------------------------------------------------------
# staging: pseudo-column row fetchers (host-side, per segment)
# ---------------------------------------------------------------------------

def row_ids(reader) -> np.ndarray:
    return np.asarray(reader.logtype_ids, np.int32)


def row_dict_slot(reader, j: int) -> np.ndarray:
    """j-th dict-var id per doc; sentinel = dictionary cardinality (every
    LUT is padded past the cardinality with False, so absent slots never
    match)."""
    out = np.full(reader.num_docs, len(reader.var_dictionary), np.int32)
    starts = reader.dv_offsets[:-1] + j
    have = starts < reader.dv_offsets[1:]
    out[have] = reader.var_ids[starts[have]]
    return out


def _enc_slot(reader, j: int) -> np.ndarray:
    out = np.zeros(reader.num_docs, np.int64)
    starts = reader.enc_offsets[:-1] + j
    have = starts < reader.enc_offsets[1:]
    out[have] = reader.encoded_vars[starts[have]]
    return out


def row_enc_hi(reader, j: int) -> np.ndarray:
    return (_enc_slot(reader, j) >> 32).astype(np.int32)


def row_enc_lo(reader, j: int) -> np.ndarray:
    return (_enc_slot(reader, j) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# parameter staging (padded across the batch)
# ---------------------------------------------------------------------------

def leaf_params(i: int, leaf, segments, pattern: str, is_like: bool,
                S: int) -> Dict[str, np.ndarray]:
    """Padded [S, ...] parameter arrays for one clp leaf. S is the
    engine's PADDED segment count; rows past len(segments) stay at their
    never-match defaults (alut False, glt -1)."""
    compiled, _ = compile_pattern(pattern, is_like)
    sps = []
    for seg in segments:
        sp, _ = seg_plan(seg, col=leaf.column, compiled=compiled)
        if sp is None:  # validated at plan time; cache loss re-plans
            raise ValueError(f"clp plan lost for {leaf.column!r}")
        sps.append(sp)
    mode, kd, _ke = leaf.meta
    cp = _pow2(max((len(sp.always) for sp in sps), default=1), floor=8)
    alut = np.zeros((S, cp), bool)
    for s, sp in enumerate(sps):
        alut[s, :len(sp.always)] = sp.always
    out = {f"leaf{i}:alut": alut}
    vp = _pow2(max((sp.card for sp in sps), default=0) + 1, floor=2)
    if mode == "a":
        if kd:
            dvlut = np.zeros((S, vp), bool)
            for s, sp in enumerate(sps):
                if len(sp.luts):
                    dvlut[s, :sp.card] = sp.luts[0]
            out[f"leaf{i}:dvlut"] = dvlut
        return out
    gp = _pow2(max((len(sp.glt) for sp in sps), default=0), floor=1)
    ncp = _pow2(max((len(sp.ckind) for sp in sps), default=0), floor=1)
    nlp = _pow2(max((len(sp.luts) for sp in sps), default=0), floor=1)
    glt = np.full((S, gp), -1, np.int32)
    gmem = np.zeros((S, gp, ncp), bool)
    ckind = np.zeros((S, ncp), np.int8)
    cslot = np.zeros((S, ncp), np.int32)
    chi = np.zeros((S, ncp), np.int32)
    clo = np.zeros((S, ncp), np.int32)
    clut = np.zeros((S, ncp), np.int32)
    for s, sp in enumerate(sps):
        g, nc = len(sp.glt), len(sp.ckind)
        glt[s, :g] = sp.glt
        gmem[s, :g, :nc] = sp.gmem
        ckind[s, :nc] = sp.ckind
        cslot[s, :nc] = sp.cslot
        chi[s, :nc] = sp.chi
        clo[s, :nc] = sp.clo
        clut[s, :nc] = sp.clut
    out.update({f"leaf{i}:glt": glt, f"leaf{i}:gmem": gmem,
                f"leaf{i}:ck": ckind, f"leaf{i}:cs": cslot,
                f"leaf{i}:chi": chi, f"leaf{i}:clo": clo,
                f"leaf{i}:cl": clut})
    if kd:
        dlut = np.zeros((S, nlp, vp), bool)
        for s, sp in enumerate(sps):
            if len(sp.luts):
                dlut[s, :len(sp.luts), :sp.card] = sp.luts
        out[f"leaf{i}:dlut"] = dlut
    return out


#: the dict-var LUTs K7 reads packed: the bool table's key suffix -> the
#: packed table's
PACKED_BANKS = {"dvlut": "dvlutp", "dlut": "dlutp"}


def pack_banks(params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`params` with each CLP leaf's dict-var LUT packed as K7 reads it: a
    `leaf<i>:dvlut` [S, vp] / `leaf<i>:dlut` [S, nlp, vp] bool table becomes
    `leaf<i>:dvlutp` / `leaf<i>:dlutp`, uint8 of width ceil(vp / 8), entry x
    as bit x % 8 of byte x // 8 (numpy's packbits in little bit order). The
    bits past vp repeat entry vp - 1, so K7, which clips an index into the
    packed row's bits, reads what the plain version's clip into [0, vp)
    reads."""
    out: Dict[str, np.ndarray] = {}
    for key, t in params.items():
        leaf, _, name = key.partition(":")
        if not leaf.startswith("leaf") or name not in PACKED_BANKS:
            out[key] = t
            continue
        pad = [(0, 0)] * (t.ndim - 1) + [(0, (-t.shape[-1]) % 8)]
        out[f"{leaf}:{PACKED_BANKS[name]}"] = np.packbits(
            np.pad(t, pad, mode="edge"), axis=-1, bitorder="little")
    return out
