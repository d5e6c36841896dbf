"""The errors a query's cancel check raises (pinot_tpu/utils/accounting.py
`QueryCancelledError`, `BrokerTimeoutError`): the dispatch ring polls a
launch's `cancel_check` while it waits, and what it raises fails that
launch's future."""


class QueryCancelledError(RuntimeError):
    pass


class BrokerTimeoutError(RuntimeError):
    """A query exceeded its end-to-end deadline (errorCode 250, ref
    QueryException.EXECUTION_TIMEOUT_ERROR_CODE)."""

    ERROR_CODE = 250
