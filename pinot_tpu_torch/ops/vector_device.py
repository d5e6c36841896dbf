"""Vector similarity search on the card: the host half of the vector leg
and the plain version of K8 `vector_topk`.

Counterpart of pinot_tpu/ops/vector_device.py (ref
core/operator/filter/VectorSimilarityFilterOperator over the HNSW reader;
here the exact / IVF design of segment/vector_index.py). The host keeps
index admission, query-vector parsing and IVF probe selection (an argsort
over each segment's centroid scores); the card computes `scores = V @ q`
over every candidate doc and keeps the top K. A segment's [n, d] block and
its IVF cell assignments stage as `__vec__/<col>/block` and
`__vec__/<col>/cells` pseudo-columns through the engine's staging levels,
flattened to one [S, D * dim_pad] float32 block:

    vec:<col>    [S, D * dim_pad] float32   each doc's row, zero-padded
    vcell:<col>  [S, D] int32               each doc's cell (IVF only)

The query vector, K and the probe-cell mask ride per-query parameters,
never the plan (a DevicePlan of mode 'vector': column, pow2 buckets of the
dimensionality and of K, IVF and its cell bucket, plus the residual filter
in the fields every plan has):

    vq:q      [S, dim_pad] float32  the normalized, zero-padded query
    vq:k      [S] int32             K
    vq:cells  [S, cells_pad] bool   the probed cells (IVF only)

so queries that differ only in the vector coalesce into one launch of K8
with a member axis.

Host contract (JAX query/filter._vector_similarity_mask): the K winners are
chosen over every doc, masked only by padding and the IVF probe cells,
never by the residual predicate; the residual `WHERE ... AND
vector_similarity(...)` conjuncts and the upsert validity mask apply AFTER
selection, so a dropped winner is never replaced. The order is lax.top_k's
(score descending under the total order of the float's bits, ties toward
the lower doc), so exact-search ids match VectorIndex.top_k's lexsort
wherever neighbouring scores differ by more than the two sums' rounding.

A refusal is one of FALLBACK_REASONS, which the engine raises as
NotOffloadable and counts as `vector_fallback`:
  disabled  - pinot.server.vector.enabled=false
  noIndex   - a batch segment has no vector index on the column
  metric    - a non-cosine index
  hybrid    - OR / NOT around the vector function, a residual conjunct
              the device cannot stage, or an ORDER BY
  staging   - staging failed (a segment above the doc cap, a row above
              MAX_VEC_ROW_BYTES)
  precision - K or the dimensionality outside the device envelope
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.plan_ir import DevicePlan
from pinot_tpu_torch.query.expressions import Function, Identifier, Literal
from pinot_tpu_torch.query.results import ExecutionStats, SelectionResult

FALLBACK_REASONS = ("disabled", "noIndex", "metric", "hybrid",
                    "staging", "precision")

#: IVF probe width (VectorIndex.top_k's default nprobe)
NPROBE = 8

#: per-segment staged vector row cap (float32 bytes of dim_pad)
MAX_VEC_ROW_BYTES = 512 << 20

#: K8 adds a row's products on at most this many lanes (a warp)
LANES = 32

Tensors = Dict[str, torch.Tensor]


def _pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# planning: filter decomposition and admission
# ---------------------------------------------------------------------------

def contains_vector(e) -> bool:
    """True when a vector_similarity call appears anywhere in a filter
    tree: the engine's routing test for the vector leg."""
    if not isinstance(e, Function):
        return False
    if e.name == "vector_similarity":
        return True
    return any(contains_vector(a) for a in e.args)


def split_filter(e):
    """(vector fn, residual expr or None, None) when the filter is the bare
    vector_similarity call or a top-level AND with exactly one vector
    conjunct; (None, None, 'hybrid') otherwise: OR / NOT around the vector
    function asks for something no top-K computes."""
    if not isinstance(e, Function):
        return None, None, "hybrid"
    if e.name == "vector_similarity":
        return e, None, None
    if e.name != "and":
        return None, None, "hybrid"
    vec = [a for a in e.args if isinstance(a, Function)
           and a.name == "vector_similarity"]
    rest = [a for a in e.args if not (isinstance(a, Function)
                                      and a.name == "vector_similarity")]
    if len(vec) != 1 or any(contains_vector(a) for a in rest):
        return None, None, "hybrid"
    if not rest:
        return vec[0], None, None
    residual = rest[0] if len(rest) == 1 else Function("and", tuple(rest))
    return vec[0], residual, None


def parse_args(fn: Function):
    """(column, query vector float32, K): the host mask's argument contract,
    K defaulting to 10."""
    if not fn.args or not isinstance(fn.args[0], Identifier):
        raise ValueError("vector_similarity needs a column")
    if len(fn.args) < 2 or not isinstance(fn.args[1], Literal):
        raise ValueError("vector_similarity needs a query vector")
    k = int(fn.args[2].value) if len(fn.args) > 2 \
        and isinstance(fn.args[2], Literal) else 10
    q = np.asarray(json.loads(str(fn.args[1].value)), np.float32).ravel()
    return fn.args[0].name, q, k


def _index_of(seg, col: str):
    try:
        ds = seg.data_source(col)
    except (KeyError, ValueError):
        return None
    return getattr(ds, "vector_index", None)


def admit(segments, col: str, qvec: np.ndarray, k: int, max_k: int):
    """((dim_pad, ivf, cells_pad), None) when every segment's index admits
    the device path; (None, reason) otherwise."""
    if k <= 0 or k > max_k:
        return None, "precision"
    dim = 0
    ivf = False
    max_cells = 0
    for seg in segments:
        index = _index_of(seg, col)
        if index is None:
            return None, "noIndex"
        if index.metric != "cosine":
            return None, "metric"
        d = int(index.vectors.shape[1]) if index.vectors.ndim == 2 else 0
        if d == 0 or (dim and d != dim):
            return None, "precision"
        dim = d
        if index.centroids is not None:
            ivf = True
            max_cells = max(max_cells, len(index.centroids))
    if dim != len(qvec):
        return None, "precision"
    dim_pad = _pow2(dim)
    if dim_pad * 4 > MAX_VEC_ROW_BYTES:
        return None, "staging"
    return (dim_pad, ivf, _pow2(max_cells) if ivf else 0), None


# ---------------------------------------------------------------------------
# staged rows and per-query parameters
# ---------------------------------------------------------------------------

def vector_row(seg, col: str, dim_pad: int, pad_docs: int) -> np.ndarray:
    """One segment's flattened float32 vector row: [pad_docs, dim_pad],
    zero-padded, raveled, so the row is a prefix of any wider block of the
    same dim_pad."""
    index = _index_of(seg, col)
    out = np.zeros((pad_docs, dim_pad), np.float32)
    v = index.vectors
    out[:v.shape[0], :v.shape[1]] = v
    return out.reshape(-1)


def cell_row(seg, col: str, pad_docs: int) -> np.ndarray:
    """One segment's int32 IVF cell row (zeros for an exact-only segment,
    whose probe mask stages all True)."""
    index = _index_of(seg, col)
    out = np.zeros(pad_docs, np.int32)
    a = index.assignments
    if a is not None:
        out[:len(a)] = a
    return out


def query_params(segments, plan: DevicePlan, qvec: np.ndarray, k: int,
                 S: int, nprobe: int = NPROBE) -> Dict[str, np.ndarray]:
    """The per-query parameters: the cosine-normalized zero-padded query,
    K, and with IVF the probe-cell mask from VectorIndex.probe_cells (its
    fall-back-to-every-cell rule included), for S rows (padded segments
    probe no cell)."""
    n = float(np.linalg.norm(qvec))
    qn = (qvec / max(n, 1e-30)).astype(np.float32)
    q = np.zeros(plan.dim_pad, np.float32)
    q[:len(qn)] = qn
    out = {"vq:q": np.tile(q, (S, 1)),
           "vq:k": np.full(S, k, np.int32)}
    if plan.ivf:
        cells = np.zeros((S, plan.cells_pad), dtype=bool)
        for s, seg in enumerate(segments):
            index = _index_of(seg, plan.vec_col)
            if index is None or index.centroids is None:
                cells[s, :] = True
                continue
            probe = index.probe_cells(qn, nprobe)
            if probe is None:
                cells[s, :] = True
            else:
                cells[s, probe] = True
        out["vq:cells"] = cells
    return out


def candidate_counts(segments, plan: DevicePlan, cells: Optional[np.ndarray],
                     S: int) -> np.ndarray:
    """Each row's candidate count ([S] int32), known on the host at
    planning: with IVF the doc counts of the probed cells of `cells` (the
    query's 'vq:cells' mask; every cell where a segment has no coarse
    layer or its probe fell back to every cell, so num_docs), num_docs
    without; 0 for padded rows. K8 sizes its candidate lists by the
    largest (ops/_cuda.py `vector_cap`), so a launch never reads the card
    to learn it. Where the cells' counts could miss a candidate (an
    assignment row shorter than the segment, whose other docs `cell_row`
    puts in cell 0, or more cells than the probe mask's width, which the
    kernel clips into its last) the row's bound is num_docs."""
    out = np.zeros(S, np.int32)
    for s, seg in enumerate(segments):
        index = _index_of(seg, plan.vec_col) if plan.ivf else None
        out[s] = seg.num_docs
        if index is not None and index.centroids is not None:
            counts = index.cell_doc_counts()
            if (len(index.assignments) == seg.num_docs
                    and len(counts) <= cells.shape[1]):
                out[s] = int(counts[cells[s, :len(counts)]].sum())
    return out


# ---------------------------------------------------------------------------
# the plain version of K8 (JAX make_vector_kernel :104, batched :163)
# ---------------------------------------------------------------------------

def dot_scores(V: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[n] float32 dot products of V [n, dim_pad] with q [dim_pad] in K8's
    fixed order (csrc/vector_topk.cu): with L = min(32, dim_pad / 4) lanes,
    lane l adds the products of its 4-float chunks l, l + L, ... in order
    onto -0.0, then a tree adds lane i + L/2, ..., i + 1 onto lane i. Each
    product and sum rounds once, as on the card."""
    n, dp = V.shape
    nch = dp // 4
    lanes = min(LANES, nch)
    p = (V * q).view(n, nch // lanes, lanes, 4)
    acc = torch.full((n, lanes), -0.0, dtype=torch.float32, device=V.device)
    for j in range(nch // lanes):
        for e in range(4):
            acc = acc + p[:, j, :, e]
    while lanes > 1:
        lanes //= 2
        acc = acc[:, :lanes] + acc[:, lanes:2 * lanes]
    return acc[:, 0]


def score_keys(score: torch.Tensor) -> torch.Tensor:
    """kernels.order_keys of float32 scores, every NaN at the key of the
    canonical positive NaN (above +inf), as K8 keys them."""
    return torch.where(torch.isnan(score),
                       torch.iinfo(torch.int32).max, kernels.order_keys(score))


def candidates(plan: DevicePlan, cols: Tensors, params: Tensors,
               num_docs: torch.Tensor, D: int) -> torch.Tensor:
    """[S, D] bool: the docs that compete, the real docs (d < num_docs) and,
    with IVF, those whose cell (clipped into [0, cells_pad)) is probed."""
    cand = torch.arange(D, dtype=torch.int32, device=num_docs.device
                        )[None, :] < num_docs[:, None]
    if plan.ivf:
        cell = cols["vcell:" + plan.vec_col].long().clamp(0,
                                                          plan.cells_pad - 1)
        cand = cand & torch.gather(params["vq:cells"], 1, cell)
    return cand


def vector_topk(plan: DevicePlan, cols: Tensors, params: Tensors,
                num_docs: torch.Tensor, D: int) -> torch.Tensor:
    """The plain K8: [S, 1 + 2 kk] float32, kk = min(k_pad, D): the kept
    winners' count, their doc ids (-1 where not kept) and scores (-inf
    there), on whatever device its inputs lie. Scores are computed for the
    real docs of each segment only (the others never compete)."""
    S = int(num_docs.shape[0])
    dp = plan.dim_pad
    kk = min(plan.k_pad, D)
    device = num_docs.device
    V = cols["vec:" + plan.vec_col].view(S, D, dp)
    q = params["vq:q"]
    cand = candidates(plan, cols, params, num_docs, D)
    score = torch.full((S, D), float("-inf"), dtype=torch.float32,
                       device=device)
    for s, n in enumerate(num_docs.clamp(0, D).tolist()):
        if n:
            score[s, :n] = dot_scores(V[s, :n], q[s])
    score = torch.where(cand, score, float("-inf"))
    idx = torch.sort(score_keys(score), dim=1, descending=True,
                     stable=True).indices[:, :kk]
    top = score.gather(1, idx)
    resid = kernels.doc_validity(plan, cols, num_docs, D)
    if plan.filter_ir is not None:
        resid = resid & kernels.eval_filter(plan.filter_ir, plan, cols,
                                            params)
    keep = (resid & cand).gather(1, idx)
    keep = keep & (torch.arange(kk, device=device)[None, :]
                   < params["vq:k"][:, None]) & (top > float("-inf"))
    ids = torch.where(keep, idx, -1).to(torch.float32)
    top = torch.where(keep, top, float("-inf"))
    matched = keep.sum(1).to(torch.float32)
    return torch.cat([matched[:, None], ids, top], 1)


# ---------------------------------------------------------------------------
# assembly and the broker-side merge
# ---------------------------------------------------------------------------

def unpack(packed_row: np.ndarray):
    """(doc ids int64 score descending, scores float32) of one segment's
    packed row: the kept winners before doc-order materialization. A
    count below 0 is K8's mark of a row whose candidates outgrew the
    host's bound ('vq:nc'), whose winners it could not select: an error,
    never an empty row."""
    if packed_row[0] < 0:
        raise RuntimeError("vector_topk: a row's candidates outgrew the "
                           "bound that sized its list ('vq:nc')")
    kk = (len(packed_row) - 1) // 2
    ids = np.asarray(packed_row[1:1 + kk], np.float64)
    scores = np.asarray(packed_row[1 + kk:1 + 2 * kk], np.float32)
    good = ids >= 0
    return ids[good].astype(np.int64), scores[good]


def assemble(segments, ctx, plan: DevicePlan, packed: np.ndarray,
             S_real: int) -> List[SelectionResult]:
    """packed [S, 1 + 2 kk] -> SelectionResults: the kept winners in doc
    order, cut to LIMIT + OFFSET, as the host selection walks the K-hot
    filter mask (JAX :353-384, its ExecutionStats included)."""
    from pinot_tpu_torch.query.executor_cpu import _project_rows, expand_star
    packed = np.asarray(packed)
    fetch = ctx.limit + ctx.offset
    filter_cols = len(set(ctx.filter_columns()))
    results = []
    for s, seg in enumerate(segments[:S_real]):
        ids, _scores = unpack(packed[s])
        ids = ids[ids < seg.num_docs]
        matched = int(round(float(packed[s, 0])))
        idx = np.sort(ids)[:fetch]
        rows = _project_rows(seg, ctx.select, idx)
        stats = ExecutionStats(
            num_docs_scanned=matched,
            num_entries_scanned_in_filter=seg.num_docs * filter_cols,
            num_entries_scanned_post_filter=len(idx) * max(
                len(ctx.select), 1),
            num_segments_processed=1,
            num_segments_matched=1 if matched else 0,
            total_docs=seg.num_docs)
        results.append(SelectionResult(
            rows, columns=expand_star(seg, ctx), stats=stats))
    return results


def merge_top_k(packed: np.ndarray, S_real: int,
                k: int) -> List[Tuple[int, int, float]]:
    """The global K best (segment, doc, score) over the packed launch
    output, score descending, ties toward the lower segment, then the lower
    doc: the same whatever order the segments arrive in."""
    entries = []
    packed = np.asarray(packed)
    for s in range(min(S_real, packed.shape[0])):
        ids, scores = unpack(packed[s])
        for d, sc in zip(ids, scores):
            entries.append((-float(sc), s, int(d)))
    entries.sort()
    return [(s, d, -neg) for neg, s, d in entries[:k]]
