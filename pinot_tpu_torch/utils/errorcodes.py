"""The query errorCodes the port's server replies with.

A trimmed copy of pinot_tpu/utils/errorcodes.py (ref pinot-common
QueryException / QueryErrorCode): the same integers, so a broker of either
package reads a port server's exceptions the same way.
"""
from __future__ import annotations

#: the queried table is not on this server
#: (ref QueryException.TABLE_DOES_NOT_EXIST_ERROR_CODE)
TABLE_DOES_NOT_EXIST = 190

#: server-side execution raised: the catch-all failure
#: (ref QueryException.QUERY_EXECUTION_ERROR_CODE)
QUERY_EXECUTION = 200

#: the query exceeded its deadline or was cancelled
#: (ref QueryException.EXECUTION_TIMEOUT_ERROR_CODE)
EXECUTION_TIMEOUT = 250
