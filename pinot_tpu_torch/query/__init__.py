"""SQL front-end, query context, aggregation functions, reduce and the
port's entry point, `QueryExecutor`.

Counterpart of pinot_tpu/query, trimmed to what the device slices run,
with the star-tree fit check (startree_exec.py).
"""
