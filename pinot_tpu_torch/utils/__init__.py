"""Server utilities: the configuration keys the port reads, the failpoint
registry its chaos tests arm, its meters, gauges and timers, the query
errorCodes and the deadline / cancel registry its server replies with, and
per-query span trees.

Counterpart of pinot_tpu/utils, trimmed to those.
"""
