"""Host-side cardinality and quantile sketches of the device sketch path.

Counterpart of pinot_tpu/query/aggregation/sketches.py (`HyperLogLog`,
`_split_planes`, `_fmix32`, `hash32_pair`, `TDigest`), numpy only and
numerically identical line for line: the device HLL registers the port's
kernels produce are bit-identical to `HyperLogLog.add_array`, and a digest
built by `TDigest.from_histogram` then merged gives the JAX package's
quantile bit for bit. Theta and KLL sketches come with later slices.

Reference parity: the reference uses library sketches (com.clearspring
HyperLogLog, com.tdunning TDigest) — pinot-core
query/aggregation/function/DistinctCountHLLAggregationFunction,
PercentileTDigestAggregationFunction.
"""
from __future__ import annotations

import numpy as np


class HyperLogLog:
    """Classic HLL with 2^log2m registers and linear-counting small-range
    correction.

    The hash is a 32-bit pair (bucket from h1, rank from clz(h2)+1) over
    the value's (hi = v >> 24, lo = v & 0xFFFFFF) i32 split planes — the
    same planes the device engine stages for big-int columns, so the
    sketch kernel produces bit-identical registers.
    """

    def __init__(self, log2m: int = 12):
        self.log2m = log2m
        self.m = 1 << log2m
        self.registers = np.zeros(self.m, dtype=np.uint8)

    @classmethod
    def from_registers(cls, registers: np.ndarray,
                       log2m: int = 12) -> "HyperLogLog":
        out = cls(log2m)
        np.maximum(out.registers, registers.astype(np.uint8),
                   out=out.registers)
        return out

    def add_array(self, values: np.ndarray) -> None:
        if len(values) == 0:
            return
        hi, lo = _split_planes(values)
        h1, h2 = hash32_pair(hi, lo)
        idx = (h1 & np.uint32(self.m - 1)).astype(np.int64)
        # rank = leading zeros of h2 + 1 (h2 == 0 -> 33); frexp is exact:
        # h2 = frac * 2^e with frac in [0.5, 1) -> clz = 32 - e
        _frac, e = np.frexp(h2.astype(np.float64))
        rank = np.where(h2 != 0, 33 - e, 33).astype(np.uint8)
        np.maximum.at(self.registers, idx, rank)

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        assert self.log2m == other.log2m
        out = HyperLogLog(self.log2m)
        out.registers = np.maximum(self.registers, other.registers)
        return out

    def cardinality(self) -> int:
        m = float(self.m)
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / float(
            np.sum(2.0 ** -self.registers.astype(np.float64)))
        if est <= 2.5 * m:
            zeros = int(np.count_nonzero(self.registers == 0))
            if zeros:
                est = m * np.log(m / zeros)
        elif est > (1 << 32) / 30.0:
            # large-range correction for the 32-bit rank hash
            est = -(2.0 ** 32) * np.log(1.0 - est / 2.0 ** 32)
        return int(round(est))


def _split_planes(values: np.ndarray):
    """Value array -> (hi, lo) uint32 planes matching the device engine's
    big-int staging (hi = v >> 24 as i32, lo = v & 0xFFFFFF)."""
    if values.dtype.kind in "iu":
        v = values.astype(np.int64)
        hi64 = v >> 24
        wrapped = hi64.astype(np.int32)
        # fold bits the i32 wrap loses (nonzero only for |v| >= 2^55) so
        # huge longs differing in the top byte don't collide; the fold is
        # identity for device-admissible ranges, keeping hash parity
        excess = ((hi64 - wrapped.astype(np.int64)) >> 32).astype(np.int32)
        hi = (wrapped ^ excess).astype(np.uint32)
        lo = (v & 0xFFFFFF).astype(np.int32).astype(np.uint32)
        return hi, lo
    if values.dtype.kind == "f":
        x = values.astype(np.float64).view(np.uint64)
    else:
        x = np.array([hash(v) & 0xFFFFFFFFFFFFFFFF for v in values.tolist()],
                     dtype=np.uint64)
    # fold the top bits (sign + high exponent) into hi so +x/-x and
    # exponent-distant values don't collide
    hi = (((x >> np.uint64(24)) ^ (x >> np.uint64(56)))
          & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFF)).astype(np.uint32)
    return hi, lo


def _fmix32(h: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer (wrapping uint32 arithmetic)."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def hash32_pair(hi: np.ndarray, lo: np.ndarray):
    """Two decorrelated 32-bit avalanche hashes over (hi, lo) planes.
    Mirrored exactly by the plain and CUDA sketch kernels
    (ops/kernels.py `hash32_pair`, ops/csrc/sketch_agg.cu) — keep all
    three in lockstep."""
    with np.errstate(over="ignore"):
        h1 = _fmix32(_fmix32(lo ^ np.uint32(0x9E3779B9)) ^ hi)
        h2 = _fmix32(_fmix32(hi ^ np.uint32(0x85EBCA77)) ^ lo)
    return h1, h2


class TDigest:
    """Size-capped merging t-digest (Dunning & Ertl).

    Centroids are kept sorted; when the buffer exceeds a threshold the
    digest re-clusters under the scale-function size bound
    k1(q) = compression / (2*pi) * asin(2q-1).
    """

    def __init__(self, compression: float = 100.0):
        self.compression = compression
        self.means = np.empty(0, dtype=np.float64)
        self.weights = np.empty(0, dtype=np.float64)
        self._buf_means: list = []
        self._buf_weights: list = []
        self.total = 0.0

    #: buffered points before a re-cluster
    BUFFER = 1 << 16

    def add_array(self, values: np.ndarray) -> None:
        if len(values) == 0:
            return
        self._buf_means.append(np.asarray(values, dtype=np.float64).ravel())
        self.total += float(len(values))
        if sum(len(b) for b in self._buf_means) > self.BUFFER:
            self._compress()

    @classmethod
    def from_histogram(cls, lo: float, width: float, counts: np.ndarray,
                       compression: float = 100.0) -> "TDigest":
        """Digest from fixed-bucket histogram partials (the device sketch
        path): each non-empty bucket becomes a centroid at its center with
        weight = count. Quantile error is bounded by one bucket width on
        top of the digest's own error."""
        out = cls(compression)
        counts = np.asarray(counts, dtype=np.float64)
        nz = np.nonzero(counts > 0)[0]
        out.means = lo + (nz.astype(np.float64) + 0.5) * width
        out.weights = counts[nz]
        out.total = float(counts.sum())
        out._compress(force=True)
        return out

    def merge(self, other: "TDigest") -> "TDigest":
        out = TDigest(self.compression)
        self._compress()
        other._compress()
        out.means = np.concatenate([self.means, other.means])
        out.weights = np.concatenate([self.weights, other.weights])
        out.total = self.total + other.total
        out._compress(force=True)
        return out

    def _k(self, q: np.ndarray) -> np.ndarray:
        q = np.clip(q, 1e-12, 1 - 1e-12)
        return self.compression * (np.arcsin(2 * q - 1) / np.pi + 0.5)

    def _compress(self, force: bool = False) -> None:
        """Vectorized merging pass: sort all points, assign each to the
        integer cluster floor(k(q_mid)) of its cumulative-weight midpoint
        quantile, and merge clusters with reduceat."""
        if not self._buf_means and not force:
            return
        parts = [self.means] + self._buf_means
        wparts = [self.weights] + [np.ones(len(b)) for b in self._buf_means]
        means = np.concatenate(parts)
        weights = np.concatenate(wparts)
        self._buf_means, self._buf_weights = [], []
        if len(means) == 0:
            return
        order = np.argsort(means, kind="stable")
        means, weights = means[order], weights[order]
        total = weights.sum()
        q_mid = (np.cumsum(weights) - weights / 2.0) / total
        cluster = np.floor(self._k(q_mid)).astype(np.int64)
        _uniq, idx = np.unique(cluster, return_index=True)
        wsum = np.add.reduceat(weights, idx)
        msum = np.add.reduceat(means * weights, idx)
        self.means = msum / wsum
        self.weights = wsum

    def quantile(self, q: float) -> float:
        self._compress(force=True)
        if len(self.means) == 0:
            return float("-inf")
        if len(self.means) == 1:
            return float(self.means[0])
        cum = np.cumsum(self.weights) - self.weights / 2.0
        target = q * self.total
        return float(np.interp(target, cum, self.means))
