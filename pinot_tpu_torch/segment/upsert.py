"""Upsert metadata: per-partition primary keys and per-segment validDocIds.

A trimmed copy of pinot_tpu/segment/upsert.py:26-134, :172-216 (ref
pinot-segment-local upsert/ConcurrentMapPartitionUpsertMetadataManager.java
:48, Pinot's FULL upsert mode): a primary-key map to (segment, docId,
comparison value); later (or equal, last-wins) comparison values replace
earlier rows, and the loser's bit is cleared in its segment's
`valid_doc_ids` Bitmap. Queries AND that bitmap into their match: the
device engine stages it as a `vmask` block (ops/engine.py), the LIMIT-only
host scan reads it directly (query/executor_cpu.py `select_first`).

Left for a later slice: dedup (`PartitionDedupMetadataManager`) and the
validDocIds snapshot files, so `add_segment` always starts from
`Bitmap.all_set` (use_snapshot is accepted and has nothing to read).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.segment.bitmap import Bitmap


@dataclass
class _RecordLocation:
    segment: Any          # an object with .name and .valid_doc_ids
    doc_id: int
    comparison_value: Any


def _pk_of(record_or_row, pk_columns: Sequence[str]) -> tuple:
    return tuple(record_or_row[c] for c in pk_columns)


class PartitionUpsertMetadataManager:
    """One stream partition's upsert state (ref :48)."""

    def __init__(self, pk_columns: Sequence[str], comparison_column: str,
                 partial_merger: Optional[Callable[[dict, dict], dict]] = None):
        self.pk_columns = list(pk_columns)
        self.comparison_column = comparison_column
        self.partial_merger = partial_merger
        self._map: Dict[tuple, _RecordLocation] = {}
        self._lock = threading.Lock()

    def add_segment(self, segment, use_snapshot: bool = True) -> None:
        """Register a segment's rows: later comparison values win, losers
        are cleared in their owning segment's bitmap. The port persists no
        snapshot, so every segment starts from all-set (use_snapshot has
        nothing to read)."""
        n = segment.num_docs
        valid = Bitmap.all_set(n)
        segment.valid_doc_ids = valid
        pk_cols = [np.asarray(segment.data_source(c).values())
                   for c in self.pk_columns]
        cmp_col = np.asarray(
            segment.data_source(self.comparison_column).values())
        with self._lock:
            for doc_id in range(n):
                pk = tuple(_py(col[doc_id]) for col in pk_cols)
                self._upsert_locked(segment, doc_id, _py(cmp_col[doc_id]), pk,
                                    valid)

    def add_row(self, segment, doc_id: int, record: Dict[str, Any]) -> None:
        """Realtime path: account one newly indexed row (ref addRecord)."""
        if getattr(segment, "valid_doc_ids", None) is None:
            segment.valid_doc_ids = Bitmap(0)
        valid = segment.valid_doc_ids
        if valid.num_docs <= doc_id:
            valid.resize(doc_id + 1)
        valid.set(doc_id)
        pk = _pk_of(record, self.pk_columns)
        cmp_value = record[self.comparison_column]
        with self._lock:
            self._upsert_locked(segment, doc_id, cmp_value, pk, valid)

    def _upsert_locked(self, segment, doc_id, cmp_value, pk, valid) -> None:
        cur = self._map.get(pk)
        if cur is not None:
            if _cmp_ge(cmp_value, cur.comparison_value):
                cur.segment.valid_doc_ids.clear(cur.doc_id)
                self._map[pk] = _RecordLocation(segment, doc_id, cmp_value)
            else:
                valid.clear(doc_id)
        else:
            self._map[pk] = _RecordLocation(segment, doc_id, cmp_value)

    def merge_record(self, previous: Optional[dict], record: dict) -> dict:
        """Partial-upsert merge (ref upsert/merger/): with no merger the new
        record replaces the old (FULL mode)."""
        if self.partial_merger is None or previous is None:
            return record
        return self.partial_merger(previous, record)

    def remove_segment(self, segment) -> None:
        """Ref removeSegment: drop map entries still pointing at it."""
        with self._lock:
            for pk in [pk for pk, loc in self._map.items()
                       if loc.segment is segment]:
                del self._map[pk]

    def replace_segment(self, old, new) -> None:
        """Seal handoff: `new` is a row-for-row rebuild of `old`, so it
        shares old's bitmap and the map entries move to it in place."""
        new.valid_doc_ids = getattr(old, "valid_doc_ids", None)
        with self._lock:
            for loc in self._map.values():
                if loc.segment is old:
                    loc.segment = new

    def lookup(self, pk: tuple) -> Optional[Tuple[Any, int]]:
        with self._lock:
            loc = self._map.get(pk)
            return (loc.segment, loc.doc_id) if loc else None

    @property
    def num_primary_keys(self) -> int:
        with self._lock:
            return len(self._map)


# partial-upsert merge strategies (ref upsert/merger/)
def overwrite_merger(previous: dict, record: dict) -> dict:
    return record


def ignore_nulls_merger(previous: dict, record: dict) -> dict:
    """OVERWRITE per column, keeping the previous value where the new one
    is null."""
    out = dict(previous)
    for k, v in record.items():
        if v is not None:
            out[k] = v
    return out


def increment_merger(columns: Sequence[str]):
    """INCREMENT for the listed columns, overwrite otherwise."""
    cols = set(columns)

    def merge(previous: dict, record: dict) -> dict:
        out = dict(record)
        for c in cols:
            if previous.get(c) is not None and record.get(c) is not None:
                out[c] = previous[c] + record[c]
        return out
    return merge


def _cmp_ge(a, b) -> bool:
    try:
        return a >= b
    except TypeError:
        return str(a) >= str(b)


def _py(v):
    return v.item() if isinstance(v, np.generic) else v
