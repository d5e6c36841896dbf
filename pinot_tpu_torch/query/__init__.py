"""SQL front-end, query context, aggregation functions, reduce and the
port's entry point, `QueryExecutor`, with the host half the server needs:
the pruner, the transform and filter evaluators and the host executor.

Counterpart of pinot_tpu/query, trimmed to what the port runs.
"""
