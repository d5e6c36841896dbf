"""Doc-id bitmaps: the upsert validity currency.

A copy of pinot_tpu/segment/bitmap.py (ref RoaringBitmap usage for upsert
validDocIds): a dense bitset over the segment's doc-id space, packed
MSB-first as numpy's packbits packs it, so `to_bytes` of the two packages
agree byte for byte. The device engine stages `to_mask()` as a one-byte-
per-doc `vmask` row (ops/engine.py `_stage_vmask`), keyed by `version`.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np


class Bitmap:
    """Fixed-size dense bitset over [0, num_docs).

    ``version`` is a mutation counter bumped AFTER every in-place change
    (set / clear / resize): upsert validDocIds mutate in place without the
    owning segment changing, so whatever stages this bitmap's contents keys
    on the version. Bump-after-mutate means a reader that snapshots
    (version, mask) can pair an old stamp only with equal-or-newer
    contents, never with contents older than its stamp.
    """

    __slots__ = ("num_docs", "_bytes", "version", "_full_memo")

    def __init__(self, num_docs: int, buf: Optional[np.ndarray] = None):
        self.num_docs = num_docs
        self.version = 0
        self._full_memo: Optional[tuple] = None
        nbytes = (num_docs + 7) // 8
        if buf is None:
            self._bytes = np.zeros(nbytes, dtype=np.uint8)
        elif isinstance(buf, (bytes, bytearray, memoryview)):
            self._bytes = np.frombuffer(buf, dtype=np.uint8,
                                        count=nbytes).copy()
        else:
            self._bytes = np.array(buf, dtype=np.uint8)

    @classmethod
    def from_indices(cls, num_docs: int, indices: Iterable[int]) -> "Bitmap":
        mask = np.zeros(num_docs, dtype=bool)
        mask[np.asarray(list(indices) if not isinstance(indices, np.ndarray)
                        else indices, dtype=np.int64)] = True
        return cls.from_mask(mask)

    @classmethod
    def from_mask(cls, mask: np.ndarray) -> "Bitmap":
        mask = np.asarray(mask, dtype=bool)
        bm = cls(len(mask))
        bm._bytes = np.packbits(mask)
        return bm

    @classmethod
    def all_set(cls, num_docs: int) -> "Bitmap":
        bm = cls(num_docs)
        bm._bytes[:] = 0xFF
        extra = (8 - num_docs % 8) % 8
        if extra:  # the last byte's bits past num_docs stay 0
            bm._bytes[-1] &= np.uint8(0xFF & (0xFF << extra))
        return bm

    def cardinality(self) -> int:
        return int(np.bitwise_count(self._bytes).sum())

    def is_full(self) -> bool:
        """True when every doc in [0, num_docs) is set: a no-op mask.
        Memoized per version (the star-tree gate asks it per query)."""
        memo = self._full_memo
        if memo is not None and memo[0] == self.version:
            return memo[1]
        full = self.cardinality() == self.num_docs
        self._full_memo = (self.version, full)
        return full

    def contains(self, doc_id: int) -> bool:
        return bool((self._bytes[doc_id >> 3] >> (7 - (doc_id & 7))) & 1)

    def clear(self, doc_id: int) -> None:
        self._bytes[doc_id >> 3] &= np.uint8(0xFF ^ (0x80 >> (doc_id & 7)))
        self.version += 1

    def set(self, doc_id: int) -> None:
        self._bytes[doc_id >> 3] |= np.uint8(1 << (7 - (doc_id & 7)))
        self.version += 1

    def resize(self, num_docs: int) -> None:
        """Grow in place (realtime rows; new bits are 0)."""
        nbytes = (num_docs + 7) // 8
        if nbytes > len(self._bytes):
            self._bytes = np.concatenate(
                [self._bytes, np.zeros(nbytes - len(self._bytes), np.uint8)])
        self.num_docs = num_docs
        self.version += 1

    def to_mask(self) -> np.ndarray:
        """Dense bool mask of length num_docs."""
        return np.unpackbits(self._bytes, count=self.num_docs).astype(bool)

    def first_set(self, k: int) -> np.ndarray:
        """The first k set doc ids in order (fewer when fewer are set),
        unpacking only as many leading bytes as they need."""
        n = min(len(self._bytes), max(1, (k + 7) // 8))
        while True:
            ids = np.flatnonzero(np.unpackbits(self._bytes[:n]))
            if len(ids) >= k or n == len(self._bytes):
                return ids[ids < self.num_docs][:k]
            n = min(len(self._bytes), 4 * n)

    def to_bytes(self) -> bytes:
        return self._bytes.tobytes()

    @classmethod
    def from_bytes(cls, num_docs: int, data: bytes) -> "Bitmap":
        return cls(num_docs, data)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Bitmap) and self.num_docs == other.num_docs
                and np.array_equal(self._bytes, other._bytes))

    def __repr__(self) -> str:
        return (f"Bitmap(num_docs={self.num_docs}, "
                f"cardinality={self.cardinality()})")
