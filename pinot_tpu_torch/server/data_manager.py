"""Segment data managers: a server's table and segment lifecycle.

A copy of pinot_tpu/server/data_manager.py (ref pinot-core data/manager/ —
InstanceDataManager -> TableDataManager -> SegmentDataManager with
acquire / release reference counting, BaseTableDataManager.acquireSegments
/ releaseSegment), so a segment is never destroyed under a running query.
Every add, replace and remove bumps the table's version and fires the
segment listeners after it commits (the server drops a replaced segment's
staged rows there); the warm-up hook runs before a segment is published
to queries (cache/warmup.py prestages it there).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from pinot_tpu_torch.segment.loader import ImmutableSegment, load_segment


class SegmentDataManager:
    def __init__(self, segment: ImmutableSegment):
        self.segment = segment
        self._refs = 1  # the manager's own reference
        self._lock = threading.Lock()
        self._destroyed = False

    @property
    def name(self) -> str:
        return self.segment.name

    def acquire(self) -> bool:
        with self._lock:
            if self._destroyed:
                return False
            self._refs += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            destroy = self._refs == 0 and self._destroyed
        if destroy:
            self.segment.destroy()

    def offload(self) -> None:
        """Drop the manager's own reference; destroys once queries drain."""
        destroy = False
        with self._lock:
            if not self._destroyed:
                self._destroyed = True
                self._refs -= 1
                destroy = self._refs == 0
        if destroy:
            self.segment.destroy()


class TableDataManager:
    """Ref BaseTableDataManager: one per table on a server."""

    def __init__(self, table_name: str, listener=None, warmup=None):
        """listener: callback(event, table_name, segment_name) fired after
        a mutation commits, event 'add' | 'replace' | 'remove'. warmup:
        callback(table_name, segment) run before a segment is published to
        queries; it must never fail the load, and a failure only costs a
        cold start."""
        self.table_name = table_name
        self._segments: Dict[str, SegmentDataManager] = {}
        self._lock = threading.Lock()
        self._version = 0
        self._listener = listener
        self._warmup = warmup

    @property
    def version(self) -> int:
        """The segment set's version, bumped on every add / replace /
        remove."""
        with self._lock:
            return self._version

    def _notify(self, event: str, segment_name: str) -> None:
        if self._listener is not None:
            self._listener(event, self.table_name, segment_name)

    def add_segment(self, segment: ImmutableSegment) -> None:
        if self._warmup is not None:
            try:
                self._warmup(self.table_name, segment)
            except Exception:  # noqa: BLE001 — warm-up must not block load
                pass
        sdm = SegmentDataManager(segment)
        with self._lock:
            old = self._segments.get(segment.name)
            self._segments[segment.name] = sdm
            self._version += 1
        if old is not None:
            old.offload()
        self._notify("replace" if old is not None else "add", segment.name)

    def add_segment_from_dir(self, seg_dir: str) -> None:
        self.add_segment(load_segment(seg_dir))

    def remove_segment(self, name: str) -> None:
        with self._lock:
            sdm = self._segments.pop(name, None)
            if sdm is not None:
                self._version += 1
        if sdm is not None:
            sdm.offload()
            self._notify("remove", name)

    def current_segment(self, name: str) -> Optional[ImmutableSegment]:
        """The live segment of a name (or None): a peek under the lock,
        no reference taken, for identity comparisons only."""
        with self._lock:
            sdm = self._segments.get(name)
            return sdm.segment if sdm is not None else None

    def acquire_segments(self, names: Optional[Sequence[str]] = None
                         ) -> List[SegmentDataManager]:
        """Acquire the named segments (or all); the caller must
        release_all. Missing names are skipped."""
        out = []
        with self._lock:
            targets = (self._segments.values() if names is None else
                       [self._segments[n] for n in names
                        if n in self._segments])
            for sdm in list(targets):
                if sdm.acquire():
                    out.append(sdm)
        return out

    @staticmethod
    def release_all(sdms: List[SegmentDataManager]) -> None:
        for sdm in sdms:
            sdm.release()

    @property
    def segment_names(self) -> List[str]:
        with self._lock:
            return list(self._segments.keys())

    def shutdown(self) -> None:
        with self._lock:
            sdms = list(self._segments.values())
            self._segments.clear()
            self._version += 1
        for sdm in sdms:
            sdm.offload()
            self._notify("remove", sdm.name)


class InstanceDataManager:
    """Ref InstanceDataManager: all tables on one server instance."""

    def __init__(self, instance_id: str = "server_0"):
        self.instance_id = instance_id
        self._tables: Dict[str, TableDataManager] = {}
        self._lock = threading.Lock()
        self._segment_listeners: List = []
        self._warmup_hook = None

    def add_segment_listener(self, fn) -> None:
        """callback(event, table_name, segment_name) on every table's
        segment add / replace / remove, tables created later included."""
        with self._lock:
            self._segment_listeners.append(fn)

    def set_warmup_hook(self, fn) -> None:
        """callback(table_name, segment) run before each segment add on
        every table, existing and future."""
        with self._lock:
            self._warmup_hook = fn

    def _dispatch_warmup(self, table_name: str, segment) -> None:
        with self._lock:
            fn = self._warmup_hook
        if fn is not None:
            fn(table_name, segment)

    def _dispatch_segment_event(self, event: str, table_name: str,
                                segment_name: str) -> None:
        with self._lock:
            listeners = list(self._segment_listeners)
        for fn in listeners:
            fn(event, table_name, segment_name)

    def table(self, table_name: str,
              create: bool = True) -> Optional[TableDataManager]:
        with self._lock:
            tdm = self._tables.get(table_name)
            if tdm is None and create:
                tdm = TableDataManager(table_name,
                                       listener=self._dispatch_segment_event,
                                       warmup=self._dispatch_warmup)
                self._tables[table_name] = tdm
            return tdm

    @property
    def table_names(self) -> List[str]:
        with self._lock:
            return list(self._tables.keys())

    def shutdown(self) -> None:
        with self._lock:
            tables = list(self._tables.values())
            self._tables.clear()
        for t in tables:
            t.shutdown()
