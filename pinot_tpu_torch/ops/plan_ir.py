"""Device plan IR: the hashable structure a kernel program is compiled from.

Counterpart of pinot_tpu/ops/plan_ir.py: the scan-aggregate, group-by
(dense or compact keys) and top-N plans of the port, with the upsert
validity mask, the fused time bucket and CLP leaves, and the vector leg's
plan (mode 'vector', JAX ops/vector_device.py `VectorPlan`):
its residual filter in the fields every plan has, so staging and the
program compiler read it as they read a top-N plan's filter.

Filter IR nodes (nested tuples, hashable):
    ('and', n1, n2, ...) / ('or', ...) / ('not', n)
    ('leaf', i)        -- i-th entry of DevicePlan.leaves

Leaf kinds (resolved per-segment into parameter arrays, see ops/engine.py):
    'range' : lo[S], hi[S] int32     -- lo <= dictId <= hi  (equals folds here)
    'neq'   : idx[S] int32           -- dictId != idx (idx=-1 matches all)
    'lut'   : table[S, C] bool       -- table[s, dictId] (in/not-in/like/regex)
    'vrange': lo[S], hi[S] float     -- lo <= value <= hi (raw numeric columns)
    'vrange64': lohi/lolo/hihi/hilo[S] int32 -- exact closed-interval compare
              on big-int columns staged as (hi, lo) i32 split planes
              (hi = v >> 24, lo = v & 0xFFFFFF)
    'clp'   : LIKE/regex over a CLP log column, matched per doc against
              the column's logtype / variable-slot pseudo-columns
              (ops/clp_device.py compiles the pattern to per-segment match
              plans; meta = (mode, Kd, Ke)). K7 computes the [S, D] match
              mask, which K1 / K2 / K4 read as the leaf's value.

Value IR (aggregation inputs, top-N order values):
    ('col', name)       -- staged value block of a column
    ('ids', name)       -- staged dictId block of a dictionary column, as
                           a top-N order value (dictionaries are sorted,
                           so dictId order is value order)
    ('lit', v)
    ('add'|'sub'|'mul'|'div', a, b)
    ('neg', a)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DeviceLeaf:
    kind: str         # 'range' | 'neq' | 'lut' | 'vrange' | 'vrange64' | 'clp'
    column: str
    #: kind-specific structure ('clp': (mode, Kd, Ke), ops/clp_device.py)
    meta: tuple = ()


@dataclass(frozen=True)
class DevicePlan:
    """Hashable kernel-structure signature."""
    filter_ir: Optional[tuple]            # nested tuple tree or None
    leaves: Tuple[DeviceLeaf, ...]
    value_irs: Tuple[Optional[tuple], ...]  # one per agg slot input
    #: (op, value_ir index or None, agg-filter index or None) — the third
    #: element selects an entry of agg_filter_irs to AND into the main mask
    #: for this slot (ref FilteredAggregationOperator)
    agg_ops: Tuple[Tuple[str, Optional[int], Optional[int]], ...]
    #: per-aggregation FILTER (WHERE ...) trees (same leaf space as filter_ir)
    agg_filter_irs: Tuple[tuple, ...] = ()
    group_cols: Tuple[str, ...] = ()
    group_strides: Tuple[int, ...] = ()   # mixed-radix strides over cards
    num_groups: int = 0                   # combined-key space (0 = no group-by)
    #: True: the dense mixed-radix key space exceeds MAX_DEVICE_GROUPS, so
    #: each doc's key is read from a staged int32 [S, D] 'gkey' block of
    #: per-segment compact codes over the key tuples present (the host
    #: factorizes them once per (segment, group columns) and caches the
    #: codes and their decode table; ref DictionaryBasedGroupKeyGenerator's
    #: map modes). num_groups is then 0 and the group count G, which
    #: depends on the data, is a launch argument (JAX plan_ir :65-71)
    group_compact: bool = False
    #: columns staged as dictIds with a dictionary value table
    dict_cols: Tuple[str, ...] = ()
    #: columns staged as raw numeric value blocks
    raw_cols: Tuple[str, ...] = ()
    #: big-int columns staged as (hi, lo) i32 split planes, filter-only
    raw64_cols: Tuple[str, ...] = ()
    #: 'agg' (scan-aggregate / group-by), 'topn' (selection: per segment
    #: the top topn_k doc ids by value_irs[0], or the first topn_k matched
    #: docs when value_irs is empty; ascending negates the value) or
    #: 'vector' (similarity top-K over vec_col, then the filter)
    mode: str = "agg"
    topn_k: int = 0
    topn_asc: bool = True
    #: True: the batch holds a segment with a validDocIds bitmap (upsert):
    #: the engine stages a one-byte-per-doc [S, D] 'vmask' block, keyed by
    #: the bitmaps' version stamps, and every kernel ANDs it into the doc
    #: validity, so superseded rows reach no slot (JAX plan_ir :94)
    valid_mask: bool = False
    #: the fused time bucket (ops/timeseries_device.py): (timestamp column,
    #: count_pad). floor((t - start) / step) is the group key's LOWEST
    #: digit, count_pad its width; start / step / count ride the 'tb:*'
    #: parameter cells, so a sliding window keeps the plan (JAX :102)
    tbucket: Tuple = ()
    #: CLP log columns staged as (name, Kd, Ke) pseudo-column families:
    #: the logtype-id block, Kd dict-var slot blocks and Ke encoded-var
    #: (hi, lo) i32 split slot blocks (ops/clp_device.py), filter-only
    #: (JAX plan_ir :81)
    clp_cols: Tuple[Tuple[str, int, int], ...] = ()
    #: the vector leg (mode 'vector', ops/vector_device.py): the vector
    #: column, the power-of-two buckets (floor 8) of its dimensionality
    #: and of topK, and with IVF cells the bucket of the largest cell
    #: count. The query vector, K and the probed cells ride parameters, so
    #: queries that differ only in them share a plan (JAX VectorPlan)
    vec_col: str = ""
    dim_pad: int = 0
    k_pad: int = 0
    ivf: bool = False
    cells_pad: int = 0


def is_grouped(plan) -> bool:
    """A group-by plan: dense keys (num_groups > 0) or compact keys, whose
    num_groups is 0 and whose G comes with the launch."""
    return bool(plan.num_groups or plan.group_compact)
