"""The port's server: segment data managers, the PDT1 wire format and the
TCP query server (counterpart of pinot_tpu/server, trimmed to the query
path)."""
