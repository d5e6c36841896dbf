"""Broker HTTP client: Connection / ResultSet / DB-API-style Cursor.

A copy of pinot_tpu/client/connection.py. Reference parity:
pinot-clients/pinot-java-client
(Connection.execute -> ResultSetGroup over broker REST) and
pinot-clients/pinot-jdbc-client (statement/cursor surface). Transport is
the broker's POST /query/sql JSON edge (broker/http_api.py); no external
dependencies.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from pinot_tpu_torch.utils import errorcodes


class PinotClientError(Exception):
    """Query rejected or failed broker-side (carries the exceptions)."""

    def __init__(self, message: str, exceptions: Optional[list] = None):
        super().__init__(message)
        self.exceptions = exceptions or []


class PinotTimeoutError(PinotClientError):
    """The query exceeded its end-to-end deadline (broker errorCode 250).
    `result_set` carries whatever partial answer the broker assembled
    before the budget ran out (partialResult=true)."""

    def __init__(self, message: str, exceptions: Optional[list] = None,
                 result_set: Optional["ResultSet"] = None):
        super().__init__(message, exceptions)
        self.result_set = result_set


class PinotOverloadError(PinotClientError):
    """The fleet REFUSED the query at admission (errorCode 211,
    server-side overload protection) rather than running it into a
    deadline miss. ``retry_after_ms`` carries the server's drain hint
    (None when absent) — back off at least that long before retrying;
    ``result_set`` carries whatever partial answer other replicas
    assembled (partialResult=true)."""

    def __init__(self, message: str, exceptions: Optional[list] = None,
                 result_set: Optional["ResultSet"] = None):
        super().__init__(message, exceptions)
        self.result_set = result_set
        self.retry_after_ms: Optional[float] = None
        for x in self.exceptions:
            hint = errorcodes.parse_retry_after(x.get("message", ""))
            if hint is not None and (self.retry_after_ms is None
                                     or hint > self.retry_after_ms):
                self.retry_after_ms = hint


_TIMEOUT_ERROR_CODE = errorcodes.EXECUTION_TIMEOUT
_OVERLOAD_ERROR_CODE = errorcodes.SERVER_OVERLOADED


class ResultSet:
    def __init__(self, payload: dict):
        table = payload.get("resultTable") or {}
        schema = table.get("dataSchema") or {}
        self.columns: List[str] = schema.get("columnNames", [])
        self.column_types: List[str] = schema.get("columnDataTypes", [])
        self.rows: List[list] = table.get("rows", [])
        self.exceptions: List[dict] = payload.get("exceptions", [])
        #: broker-declared incompleteness: a server timed out or died and
        #: the rows above are only part of the answer
        self.partial_result: bool = bool(payload.get("partialResult"))
        self.stats: Dict[str, Any] = {
            k: v for k, v in payload.items()
            if k not in ("resultTable", "exceptions")}

    def __iter__(self):
        return iter(self.rows)

    def __len__(self) -> int:
        return len(self.rows)


class Connection:
    def __init__(self, broker: str, timeout: float = 60.0,
                 scheme: str = "http"):
        if "://" in broker:
            scheme, _, broker = broker.partition("://")
        self.base = f"{scheme}://{broker}"
        self.timeout = timeout

    # ------------------------------------------------------------------
    def execute(self, sql: str,
                params: Optional[Dict[str, Any]] = None,
                timeout_ms: Optional[float] = None) -> ResultSet:
        """Run SQL (with optional %(name)s parameter substitution — values
        are SQL-escaped client-side) and raise on broker exceptions.
        timeout_ms: per-query end-to-end budget, shipped as the broker's
        `SET timeoutMs` option AND used (plus grace) as the HTTP read
        timeout; a deadline miss raises PinotTimeoutError carrying the
        broker's partial result."""
        if params:
            # token-targeted replacement, NOT the % operator: a literal %
            # in the SQL (LIKE '%x%', modulo) must never be interpreted
            # as a format spec
            import re as _re
            quoted = {k: _quote(v) for k, v in params.items()}

            def _sub(m):
                key = m.group(1)
                if key not in quoted:
                    raise PinotClientError(f"missing parameter {key!r}")
                return quoted[key]

            sql = _re.sub(r"%\((\w+)\)s", _sub, sql)
        http_timeout = self.timeout
        if timeout_ms is not None:
            # leading SET statements are the option channel the broker
            # parser already speaks — no URL/body schema change needed
            sql = f"SET timeoutMs = {int(timeout_ms)}; {sql}"
            http_timeout = timeout_ms / 1000.0 + 5.0
        req = urllib.request.Request(
            f"{self.base}/query/sql",
            data=json.dumps({"sql": sql}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=http_timeout) as r:
                payload = json.loads(r.read())
        except urllib.error.URLError as e:
            raise PinotClientError(f"broker unreachable: {e}") from e
        rs = ResultSet(payload)
        if rs.exceptions:
            message = "; ".join(str(x.get("message", x))
                                for x in rs.exceptions)
            if any(x.get("errorCode") == _TIMEOUT_ERROR_CODE
                   for x in rs.exceptions):
                # typed miss: the partial rides along instead of vanishing
                raise PinotTimeoutError(message, rs.exceptions,
                                        result_set=rs)
            if any(x.get("errorCode") == _OVERLOAD_ERROR_CODE
                   for x in rs.exceptions):
                # typed shed: retry-after hint + partial ride along
                raise PinotOverloadError(message, rs.exceptions,
                                         result_set=rs)
            raise PinotClientError(message, rs.exceptions)
        return rs

    def cursor(self) -> "Cursor":
        return Cursor(self)

    def close(self) -> None:  # stateless HTTP; for DB-API symmetry
        pass

    # context manager
    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Cursor:
    """Minimal DB-API 2.0 cursor over Connection (ref jdbc-client)."""

    def __init__(self, conn: Connection):
        self._conn = conn
        self._rs: Optional[ResultSet] = None
        self._pos = 0

    @property
    def description(self) -> Optional[List[Tuple]]:
        if self._rs is None:
            return None
        return [(name, dtype, None, None, None, None, None)
                for name, dtype in zip(self._rs.columns,
                                       self._rs.column_types)]

    @property
    def rowcount(self) -> int:
        return -1 if self._rs is None else len(self._rs)

    @property
    def result_set(self) -> Optional[ResultSet]:
        """The last query's ResultSet: its stats carry the broker's
        server counts and partialResult (not in the JAX client)."""
        return self._rs

    def execute(self, sql: str,
                params: Optional[Dict[str, Any]] = None) -> "Cursor":
        self._rs = self._conn.execute(sql, params)
        self._pos = 0
        return self

    def fetchone(self) -> Optional[Sequence]:
        if self._rs is None or self._pos >= len(self._rs):
            return None
        row = self._rs.rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: int = 1) -> List[Sequence]:
        out = []
        for _ in range(size):
            row = self.fetchone()
            if row is None:
                break
            out.append(row)
        return out

    def fetchall(self) -> List[Sequence]:
        if self._rs is None:
            return []
        out = self._rs.rows[self._pos:]
        self._pos = len(self._rs)
        return out

    def close(self) -> None:
        self._rs = None


def _quote(v: Any) -> str:
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    return str(v)


def connect(broker: str, timeout: float = 60.0) -> Connection:
    """pinot-java-client ConnectionFactory.fromHostList analog."""
    return Connection(broker, timeout=timeout)
