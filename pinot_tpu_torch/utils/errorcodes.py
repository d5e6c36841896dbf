"""The query errorCodes the port's server and broker answer with.

A trimmed copy of pinot_tpu/utils/errorcodes.py (ref pinot-common
QueryException / QueryErrorCode): the same integers, so a broker or
client of either package reads the port's exceptions the same way, and
the same in-band retryAfterMs contract of a 211 message.
"""
from __future__ import annotations

import re
from typing import Optional

#: the SQL failed to parse (ref QueryException.SQL_PARSING_ERROR_CODE)
SQL_PARSING = 150

#: the queried table is on no route of the broker and not on this server
#: (ref QueryException.TABLE_DOES_NOT_EXIST_ERROR_CODE)
TABLE_DOES_NOT_EXIST = 190

#: server-side execution raised: the catch-all failure
#: (ref QueryException.QUERY_EXECUTION_ERROR_CODE)
QUERY_EXECUTION = 200

#: the server refused the query at admission; the message carries a
#: `retryAfterMs=` hint (ref SERVER_OUT_OF_CAPACITY_ERROR_CODE)
SERVER_OVERLOADED = 211

#: the query exceeded its deadline or was cancelled
#: (ref QueryException.EXECUTION_TIMEOUT_ERROR_CODE)
EXECUTION_TIMEOUT = 250

#: a server was unreachable or hard-failed and no surviving replica
#: covered its segments (ref SERVER_NOT_RESPONDING_ERROR_CODE)
SERVER_ERROR = 427

#: a table or tenant QPS quota rejected the query
#: (ref QueryException.TOO_MANY_REQUESTS_ERROR_CODE)
QUOTA_EXCEEDED = 429

_RETRY_AFTER_RE = re.compile(r"retryAfterMs=(\d+(?:\.\d+)?)")


def parse_retry_after(message: str) -> Optional[float]:
    """The hint parsed back out of a 211 message; None when absent."""
    m = _RETRY_AFTER_RE.search(str(message))
    return float(m.group(1)) if m else None
