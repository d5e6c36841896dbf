"""Caches (counterpart of pinot_tpu/cache): the segment warm-up's prestage
half and the broker's tier-1 result and negative caches (local backend);
no tier-2 segment result cache yet."""
