"""The device-resident row tier: one padded device row per (segment,
column), kept on the card across queries and segment batches.

Copy of pinot_tpu/ops/residency.py (`ResidencyManager` :83, the transfer
odometer :49-80). The engine's assembled-block cache keys a
whole [S, D] block by its exact segment batch, so a batch that pruning
recomposed, or that a newly sealed segment joined, would miss it and
upload every column again. The unit that survives recomposition is the
row: the engine assembles blocks on the card from resident rows (K6
`row_assemble`, ops/kernels.py `assemble_rows`), so a new composition
uploads only the rows the card has never seen.

Policy (the tier must stay inside its budget, and one cold scan must not
flush the hot working set):

  * recency: entries are LRU-ordered; hits refresh.
  * frequency admission (TinyLFU): every access, hit or miss, bumps a
    counter per (segment name, kind, column) in a sample window; the
    counters halve when the window fills, so popularity is recent. When
    the tier is full a candidate is admitted only if its frequency beats
    the LRU victim's: a cold scan's rows lose to the dashboard's working
    set and are not kept (the query still ran).
  * seeding: accesses inside `seeding()` (warm-up replay) bypass the duel
    and carry SEED_BOOST extra credit.
  * eviction drops the reference only: a kernel queued on the stream
    still reads the row, and the caching allocator reuses its memory only
    after that kernel ran (every copy and launch is on one stream).

  * per-chip shares (JAX :99-135, `admit` :197-241): on an engine whose
    mesh spans more than one device (`devices=`, their labels) a resident
    row lives whole on one chip, so the budget splits evenly into
    per-chip shares; an admission labelled with its chip (`device=`)
    charges that chip's share and evicts on that chip first, and
    `pressure` is the most-loaded chip's fill of its share. A logical
    mesh on one card is one chip: one label, the whole budget.

The module also owns the host-to-device transfer odometer: every byte the
engine uploads is counted process-wide, column rows apart from per-query
parameters, so tests and chip_smoke.py can hold a repeat query to zero
column bytes.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

_transfer_lock = threading.Lock()
_transfer_bytes = 0
_column_bytes = 0


def note_transfer(nbytes: int, column: bool = False) -> None:
    """Count one upload of `nbytes`; column=True marks a column payload
    (one segment's row of a column) as opposed to per-query
    parameters."""
    global _transfer_bytes, _column_bytes
    with _transfer_lock:
        _transfer_bytes += int(nbytes)
        if column:
            _column_bytes += int(nbytes)


def transfer_bytes() -> int:
    with _transfer_lock:
        return _transfer_bytes


def column_transfer_bytes() -> int:
    with _transfer_lock:
        return _column_bytes


class ResidencyManager:
    """Budgeted per-(segment, column) device-row tier: TinyLFU admission
    over LRU recency.

    Keys carry (id(segment), segment name, kind, column, dtype) and entries
    pin the segment object, checked by identity on every hit: a segment
    replaced by a new object of the same name never serves a stale row (id()
    is not recycled while the entry pins the old object). Frequency counters
    key on the name, so a replacement inherits its column traffic."""

    #: admission credit of a warm-up-seeded access beyond the access itself
    SEED_BOOST = 3

    def __init__(self, budget_bytes: int, admission: bool = True,
                 sample_window: int = 4096, metrics=None,
                 labels: Optional[Dict[str, str]] = None, devices=None):
        """devices: the chips' labels (or devices) of a mesh engine; more
        than one splits the budget into equal per-chip shares."""
        self.budget_bytes = max(0, int(budget_bytes))
        self.enabled = self.budget_bytes > 0
        self.admission = bool(admission)
        self.sample_window = max(64, int(sample_window))
        self.devices = list(devices) if devices else []
        n = len(self.devices)
        self.device_budget_bytes = \
            self.budget_bytes // n if n > 1 else self.budget_bytes
        self._metrics = metrics
        self._labels = labels
        self._lock = threading.RLock()
        #: key -> (segment, device row, nbytes, chip label or ""); LRU order
        self._entries: "OrderedDict[tuple, Tuple[Any, Any, int, str]]" = \
            OrderedDict()
        self._bytes = 0
        #: chip label -> resident bytes (labelled admissions only)
        self._dev_bytes: Dict[str, int] = {}
        #: (segment name, kind, col) -> access count (exact, bounded by the
        #: halving pass)
        self._freq: Dict[tuple, int] = {}
        self._obs = 0
        self._seeding = threading.local()
        self.hits = 0
        self.misses = 0
        self.admitted = 0
        self.rejected = 0
        self.evicted = 0

    @staticmethod
    def _key(seg, kind: str, col: str, dtype_str: str) -> tuple:
        return (id(seg), seg.name, kind, col, dtype_str)

    @staticmethod
    def _fkey(seg, kind: str, col: str) -> tuple:
        return (seg.name, kind, col)

    @contextlib.contextmanager
    def seeding(self):
        """Accesses inside this context are warm-up-seeded: admissions
        bypass the frequency duel and carry SEED_BOOST extra credit."""
        depth = getattr(self._seeding, "depth", 0)
        self._seeding.depth = depth + 1
        try:
            yield
        finally:
            self._seeding.depth = depth

    @property
    def seeding_active(self) -> bool:
        return getattr(self._seeding, "depth", 0) > 0

    def _meter(self, name: str, value: float = 1) -> None:
        if self._metrics is not None:
            self._metrics.add_meter(name, value, labels=self._labels)

    def _touch(self, fkey: tuple, n: int = 1) -> None:
        self._freq[fkey] = self._freq.get(fkey, 0) + n
        self._obs += n
        if self._obs >= self.sample_window:
            # ageing: halve every count (zeroed keys drop out)
            self._freq = {k: v // 2 for k, v in self._freq.items()
                          if v // 2 > 0}
            self._obs //= 2

    def get(self, seg, kind: str, col: str, dtype_str: str):
        """The resident device row for (seg, kind, col), or None. Every
        call counts toward the column's admission frequency."""
        if not self.enabled:
            return None
        key = self._key(seg, kind, col, dtype_str)
        with self._lock:
            boost = self.SEED_BOOST if self.seeding_active else 0
            self._touch(self._fkey(seg, kind, col), 1 + boost)
            entry = self._entries.get(key)
            if entry is not None and entry[0] is seg:
                self._entries.move_to_end(key)
                self.hits += 1
                self._meter("hbm_resident_hit")
                return entry[1]
            self.misses += 1
            self._meter("hbm_resident_miss")
            return None

    def admit(self, seg, kind: str, col: str, dtype_str: str, dev_row,
              nbytes: int, device: Optional[str] = None) -> bool:
        """Offer an uploaded row for retention; True if it is now
        resident. A refusal never fails the query: the caller keeps its
        own reference for this launch. device: the label of the chip
        holding the row, whose share the row then charges: that chip
        evicts (or declines) first, while the others stay warm."""
        if not self.enabled or nbytes > self.budget_bytes:
            return False
        dlabel = device or ""
        if dlabel and nbytes > self.device_budget_bytes:
            return False
        key = self._key(seg, kind, col, dtype_str)
        fkey = self._fkey(seg, kind, col)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._uncharge(old)
            seeded = self.seeding_active
            cand = self._freq.get(fkey, 0)
            # the candidate's own chip first: a row never spans chips, so
            # its chip's share binds before the pooled budget
            while dlabel and self._dev_bytes.get(dlabel, 0) + nbytes \
                    > self.device_budget_bytes:
                vkey = next((k for k, e in self._entries.items()
                             if e[3] == dlabel), None)
                if vkey is None:
                    break
                if not self._evict_one_locked(vkey, cand, seeded):
                    return False
            while self._bytes + nbytes > self.budget_bytes and self._entries:
                if not self._evict_one_locked(next(iter(self._entries)),
                                              cand, seeded):
                    return False
            self._entries[key] = (seg, dev_row, int(nbytes), dlabel)
            self._bytes += int(nbytes)
            if dlabel:
                self._dev_bytes[dlabel] = \
                    self._dev_bytes.get(dlabel, 0) + int(nbytes)
            self.admitted += 1
            return True

    def _uncharge(self, entry) -> None:
        """Take a popped entry's bytes off the pool and its chip."""
        self._bytes -= entry[2]
        if entry[3]:
            self._dev_bytes[entry[3]] -= entry[2]

    def _evict_one_locked(self, vkey, cand: int, seeded: bool) -> bool:
        """The TinyLFU duel for one victim: False (refuse the candidate)
        when the victim is at least as hot, which is what keeps a cold
        scan from flushing the working set."""
        vfreq = self._freq.get((vkey[1], vkey[2], vkey[3]), 0)
        if self.admission and not seeded and cand <= vfreq:
            self.rejected += 1
            self._meter("hbm_admission_rejected")
            return False
        self._uncharge(self._entries.pop(vkey))
        self.evicted += 1
        self._meter("hbm_evicted")
        return True

    def _drop_locked(self, keys) -> int:
        for k in keys:
            self._uncharge(self._entries.pop(k))
            self.evicted += 1
            self._meter("hbm_evicted")
        return len(keys)

    def invalidate_segment(self, name: str, keep=None) -> int:
        """Drop the resident rows of a replaced or removed segment NAME,
        sparing those pinned to `keep` (the live object); returns how many
        went. Frequency counters stay: the replacement inherits them."""
        with self._lock:
            return self._drop_locked(
                [k for k, e in self._entries.items()
                 if k[1] == name and (keep is None or e[0] is not keep)])

    def invalidate_superseded_kind(self, seg, kind_prefix: str,
                                   keep_kind: str, col: str) -> int:
        """Drop this segment's rows of column `col` whose kind starts with
        `kind_prefix` but is not `keep_kind` (version-stamped kinds, whose
        older stamps no query can reach again)."""
        with self._lock:
            return self._drop_locked(
                [k for k, e in self._entries.items()
                 if e[0] is seg and k[3] == col
                 and k[2].startswith(kind_prefix) and k[2] != keep_kind])

    def drop_all(self) -> None:
        """Release every resident row (references only)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._dev_bytes.clear()

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def bytes_by_device(self) -> Dict[str, int]:
        """Resident bytes per chip label (labelled admissions only)."""
        with self._lock:
            return dict(self._dev_bytes)

    def max_device_bytes(self) -> int:
        """The most-loaded chip's resident bytes; the pooled bytes where
        no admission was labelled."""
        with self._lock:
            return max(self._dev_bytes.values()) if self._dev_bytes \
                else self._bytes

    def pressure(self) -> float:
        """The budget fraction admission control reads: the most-loaded
        chip's fill of its share where admissions are labelled (one hot
        chip runs out alone), else the pooled fill; 0.0 unbudgeted."""
        with self._lock:
            if not self.enabled:
                return 0.0
            if self._dev_bytes and self.device_budget_bytes:
                return max(self._dev_bytes.values()) \
                    / self.device_budget_bytes
            return self._bytes / self.budget_bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def resident_for(self, name: str) -> int:
        """Resident rows of a segment name."""
        with self._lock:
            return sum(1 for k in self._entries if k[1] == name)

    def frequency(self, name: str, kind: str, col: str) -> int:
        with self._lock:
            return self._freq.get((name, kind, col), 0)
