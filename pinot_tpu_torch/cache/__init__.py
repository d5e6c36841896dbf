"""Segment warm-up (counterpart of pinot_tpu/cache, trimmed to the
prestage half of the warm-up; no result cache)."""
