"""Per-query deadlines and cancels.

A trimmed copy of pinot_tpu/utils/accounting.py (ref pinot-spi
accounting/ThreadResourceUsageAccountant): `QueryCancelledError` and
`BrokerTimeoutError`, which a query's cancel check raises, and
`ResourceAccountant`, the server's registry of running queries with
`begin_query` / `checker` / `finish_query` / `cancel`. The dispatch ring
polls a launch's `cancel_check` while it waits, and what it raises fails
that launch's future; the server's executor polls it before each batch
(cooperative cancellation, as the reference's hot loops sample). There is
no charge slip and no workload rollup.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from pinot_tpu_torch.utils import errorcodes


class QueryCancelledError(RuntimeError):
    pass


class BrokerTimeoutError(RuntimeError):
    """A query exceeded its end-to-end deadline (errorCode 250, ref
    QueryException.EXECUTION_TIMEOUT_ERROR_CODE)."""

    ERROR_CODE = errorcodes.EXECUTION_TIMEOUT


@dataclass
class QueryUsage:
    query_id: str
    start_time: float = field(default_factory=time.time)
    cancelled: bool = False
    #: absolute wall-clock deadline (time.time() domain); None = no budget
    deadline: Optional[float] = None


class ResourceAccountant:
    """The running queries of one server, by query id."""

    #: cancel tombstones older than this are swept (a cancel whose query
    #: never arrives must not accumulate forever)
    TOMBSTONE_TTL_S = 300.0

    def __init__(self):
        self._queries: Dict[str, QueryUsage] = {}
        self._lock = threading.Lock()

    def begin_query(self, query_id: str,
                    timeout_s: Optional[float] = None) -> QueryUsage:
        """Register a query with an optional remaining-time budget (a
        budget already spent gives a deadline in the past: the first
        check raises)."""
        with self._lock:
            u = self._queries.get(query_id)
            if u is None:
                u = self._queries[query_id] = QueryUsage(query_id)
            if timeout_s is not None:
                u.deadline = time.time() + timeout_s
            return u

    def check_query(self, query_id: str) -> None:
        """Raise when the query is cancelled or past its deadline."""
        with self._lock:
            u = self._queries.get(query_id)
        if u is None:
            return
        if u.cancelled:
            raise QueryCancelledError(f"query {query_id} cancelled")
        if u.deadline is not None and time.time() > u.deadline:
            u.cancelled = True
            raise BrokerTimeoutError(
                f"query {query_id} exceeded its deadline")

    def checker(self, query_id: str):
        """Zero-arg closure for the executor and the ring: raises when
        the query is cancelled or past its deadline, else returns None."""
        return lambda: self.check_query(query_id)

    def cancel(self, query_id: str) -> bool:
        """Sticky: cancelling an id that has not begun yet leaves a
        cancelled tombstone, so the request dies at its first check;
        finish_query reaps it, and stale tombstones are swept by age."""
        with self._lock:
            u = self._queries.get(query_id)
            if u is None:
                now = time.time()
                for qid in [qid for qid, e in self._queries.items()
                            if e.cancelled
                            and now - e.start_time > self.TOMBSTONE_TTL_S]:
                    del self._queries[qid]
                u = self._queries[query_id] = QueryUsage(query_id)
            u.cancelled = True
            return True

    def finish_query(self, query_id: str) -> Optional[QueryUsage]:
        with self._lock:
            return self._queries.pop(query_id, None)
