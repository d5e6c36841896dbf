"""Server utilities the port's dispatch ring reads and writes: the
configuration keys it takes, the failpoint registry its chaos tests arm,
the meters and timers it writes, and the errors a query's cancel check
raises.

Counterpart of pinot_tpu/utils, trimmed to those four.
"""
