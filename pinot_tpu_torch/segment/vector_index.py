"""Vector similarity index: a dense [n, d] float32 block plus IVF-style
coarse cells.

Counterpart of pinot_tpu/segment/vector_index.py (ref pinot-segment-local
HnswVectorIndexCreator and readers/vector/, the VECTOR_SIMILARITY filter of
VectorSimilarityFilterOperator): vectors store as one block, unit-normalized
for cosine; search is `scores = V @ q` with top-k, exact below
IVF_THRESHOLD rows, and over the nprobe coarse cells nearest the query
above it (k-means-lite cells: a seeded sample of rows, four Lloyd
iterations). The serialized bytes are the JAX package's, so either package
reads the other's index.

`json_rows` renders a block as the JSON-array strings the vector column's
forward index holds, without a Python float repr per value: the creator
takes a block for a vector column and writes the same segment as from
those strings.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

_HDR = struct.Struct("<IIIf")  # n, dim, n_cells, pad


class VectorIndexCorruption(ValueError):
    """A serialized vector index whose declared sizes disagree with the
    payload present (a torn write, a truncated download)."""


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1e-30)


class VectorIndex:
    """[n, d] float32 block + optional coarse cells."""

    #: build a coarse layer from this row count up
    IVF_THRESHOLD = 4096

    def __init__(self, vectors: np.ndarray,
                 centroids: Optional[np.ndarray] = None,
                 assignments: Optional[np.ndarray] = None,
                 metric: str = "cosine"):
        self.vectors = vectors  # unit-normalized when metric == cosine
        self.centroids = centroids
        self.assignments = assignments
        self.metric = metric
        self._cell_docs: Optional[np.ndarray] = None

    @classmethod
    def build(cls, vectors, metric: str = "cosine",
              n_cells: Optional[int] = None) -> "VectorIndex":
        v = np.asarray(vectors, dtype=np.float32)
        if v.ndim != 2:
            raise ValueError("vector index needs [n, d] input")
        if metric == "cosine":
            v = _normalize(v).astype(np.float32)
        n = len(v)
        if n_cells is None:
            n_cells = int(np.sqrt(n)) if n >= cls.IVF_THRESHOLD else 0
        centroids = assignments = None
        if n_cells >= 2:
            centroids, assignments = cls._kmeans_lite(v, n_cells)
        return cls(v, centroids, assignments, metric)

    @staticmethod
    def _kmeans_lite(v: np.ndarray, k: int,
                     iters: int = 4) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(0)  # deterministic builds
        centroids = v[rng.choice(len(v), size=k, replace=False)]
        assign = np.zeros(len(v), np.int32)
        for _ in range(iters):
            # cosine and L2 on normalized vectors share the argmax
            sims = v @ centroids.T
            assign = np.argmax(sims, axis=1).astype(np.int32)
            for c in range(k):
                members = v[assign == c]
                if len(members):
                    m = members.mean(axis=0)
                    centroids[c] = m / max(np.linalg.norm(m), 1e-30)
        return centroids.astype(np.float32), assign

    def top_k(self, query, k: int, nprobe: int = 8) -> np.ndarray:
        """Doc ids of the K most similar vectors (exact without a coarse
        layer, nprobe cells with one), score descending, ties toward the
        lower doc id."""
        if k <= 0 or len(self.vectors) == 0:
            return np.empty(0, np.int32)
        q = np.asarray(query, dtype=np.float32).ravel()
        if self.metric == "cosine":
            q = _normalize(q[None, :])[0].astype(np.float32)
        if self.centroids is None:
            scores = self.vectors @ q
            cand = np.arange(len(scores))
        else:
            probe = self.probe_cells(q, nprobe)
            if probe is None:
                cand = np.arange(len(self.vectors))
            else:
                cand = np.nonzero(np.isin(self.assignments, probe))[0]
            scores = self.vectors[cand] @ q
        k = min(k, len(cand))
        order = np.lexsort((cand, -scores))
        return cand[order[:k]].astype(np.int32)

    def probe_cells(self, query, nprobe: int = 8) -> Optional[np.ndarray]:
        """The coarse cells an IVF search scans for this query (the
        centroid scores argsorted, descending), or None where no doc lies
        in them and the search scans every cell. The device leg stages the
        same cells, so probe selection agrees with top_k by construction."""
        if self.centroids is None:
            return None
        q = np.asarray(query, dtype=np.float32).ravel()
        cell_scores = self.centroids @ q
        probe = np.argsort(cell_scores)[::-1][:nprobe]
        # any doc in the probed cells (JAX: np.isin over every doc's cell),
        # from the cells' doc counts
        if not self.cell_doc_counts()[probe].any():
            return None
        return probe

    def cell_doc_counts(self) -> np.ndarray:
        """The docs in each coarse cell (int64 [n_cells]), counted once per
        index; requires the coarse layer."""
        if self._cell_docs is None:
            self._cell_docs = np.bincount(
                self.assignments, minlength=len(self.centroids))
        return self._cell_docs

    def to_bytes(self) -> bytes:
        n, d = self.vectors.shape
        ncells = 0 if self.centroids is None else len(self.centroids)
        out = [_HDR.pack(n, d, ncells, 0.0),
               (b"C" if self.metric == "cosine" else b"L"),
               self.vectors.astype("<f4").tobytes()]
        if ncells:
            out.append(self.centroids.astype("<f4").tobytes())
            out.append(self.assignments.astype("<i4").tobytes())
        return b"".join(out)

    @classmethod
    def from_bytes(cls, buf) -> "VectorIndex":
        buf = bytes(buf)
        if len(buf) < _HDR.size + 1:
            raise VectorIndexCorruption(
                f"vector index payload truncated: {len(buf)} bytes is "
                f"shorter than the {_HDR.size + 1}-byte header")
        n, d, ncells, _ = _HDR.unpack_from(buf, 0)
        # the header declares sizes: check them against the bytes present
        # before any frombuffer reads past the end
        need = _HDR.size + 1 + 4 * n * d
        if ncells:
            need += 4 * ncells * d + 4 * n
        if len(buf) < need:
            raise VectorIndexCorruption(
                f"vector index payload truncated: header declares "
                f"n={n} d={d} n_cells={ncells} ({need} bytes), got "
                f"{len(buf)}")
        pos = _HDR.size
        metric = "cosine" if buf[pos:pos + 1] == b"C" else "l2"
        pos += 1
        vecs = np.frombuffer(buf, "<f4", n * d, pos).reshape(n, d).copy()
        pos += 4 * n * d
        centroids = assignments = None
        if ncells:
            centroids = np.frombuffer(buf, "<f4", ncells * d, pos) \
                .reshape(ncells, d).copy()
            pos += 4 * ncells * d
            assignments = np.frombuffer(buf, "<i4", n, pos).copy()
        return cls(vecs, centroids, assignments, metric)


#: digits of a rendered value's mantissa: nine significant digits bring
#: every float32 back exactly through a float64 parse
_DIGITS = 9
_ROWS_PER_PASS = 1 << 15


def json_rows(block: np.ndarray) -> List[str]:
    """Each row of a finite [n, d] float32 block as a JSON array string of
    fixed width, each value in scientific notation with nine significant
    digits behind a sign or a space ("[ 1.25000000e-01, -3.33333343e-01] "):
    json.loads of a row, cast to float32, gives the row back bit for bit,
    -0.0 included. Rendered with numpy integer arithmetic, a pass per 2^15
    rows."""
    v = np.asarray(block)
    if v.ndim != 2 or v.dtype != np.float32:
        raise ValueError("json_rows takes an [n, d] float32 block")
    if not np.isfinite(v).all():
        raise ValueError("json_rows renders finite values only")
    n, d = v.shape
    w = 1 + d * _FIELD
    out: List[str] = []
    for r0 in range(0, n, _ROWS_PER_PASS):
        text = _render(v[r0:r0 + _ROWS_PER_PASS]).decode("ascii")
        out += [text[i:i + w] for i in range(0, len(text), w)]
    return out


#: a value's field: sign or space, d.dddddddd, e, the exponent's sign and
#: two digits (|exponent| <= 45 for a float32), then ", " (the row's last
#: value "] ")
_FIELD = 1 + 1 + 1 + (_DIGITS - 1) + 1 + 1 + 2 + 2


#: powers of ten, exact up to 1e22 and correctly rounded above: a
#: float32's decimal exponent lies in [-45, 38]
_POW10 = np.array([10.0 ** k for k in range(47)])
#: the four ASCII digits of 0..9999
_DIGITS4 = np.array([list(f"{i:04d}".encode()) for i in range(10_000)],
                    np.uint8)


def _render(v: np.ndarray) -> bytes:
    """The rows' text, each 1 + d * _FIELD bytes."""
    n, d = v.shape
    x = v.astype(np.float64).ravel()
    a = np.abs(x)
    nz = a > 0
    e10 = np.zeros(x.shape, np.int64)
    e10[nz] = np.floor(np.log10(a[nz])).astype(np.int64)

    def scaled(e, a):
        # one rounding each way (a power of ten up to 1e22 is exact)
        return a / _POW10[np.maximum(e, 0)] * _POW10[np.maximum(-e, 0)]

    m = scaled(e10, a)
    # log10 may land a power of ten on the wrong side: rescale those
    off = nz & ((m < 1.0) | (m >= 10.0))
    if off.any():
        e10[off] += np.where(m[off] < 1.0, -1, 1)
        m[off] = scaled(e10[off], a[off])
    digits = np.rint(m * 10.0 ** (_DIGITS - 1)).astype(np.int64)
    carry = digits >= 10 ** _DIGITS
    digits[carry] = 10 ** (_DIGITS - 1)
    e10[carry] += 1
    f = np.empty((n * d, _FIELD), np.uint8)
    f[:, 0] = np.where(np.signbit(x), ord("-"), ord(" "))
    hi, lo = np.divmod(digits, 10_000)
    d0, h4 = np.divmod(hi, 10_000)
    f[:, 1] = ord("0") + d0
    f[:, 2] = ord(".")
    f[:, 3:7] = _DIGITS4[h4]
    f[:, 7:11] = _DIGITS4[lo]
    f[:, 11] = ord("e")
    f[:, 12] = np.where(e10 < 0, ord("-"), ord("+"))
    f[:, 13:15] = _DIGITS4[np.abs(e10)][:, 2:]
    f[:, 15] = ord(",")
    f[:, 16] = ord(" ")
    f = f.reshape(n, d, _FIELD)
    f[:, -1, 15] = ord("]")
    rows = np.empty((n, 1 + d * _FIELD), np.uint8)
    rows[:, 0] = ord("[")
    rows[:, 1:] = f.reshape(n, d * _FIELD)
    return rows.tobytes()
