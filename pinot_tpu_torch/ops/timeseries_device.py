"""The fused time bucket of a time-series leaf: host planning and the plain
bucket math.

Counterpart of pinot_tpu/ops/timeseries_device.py. The leaf SQL of the
time-series engine groups by `floor((t - start) / step)` over a
`t >= lo AND t < hi` window. The engine admits that exact shape here
(`plan_bucket`) and fuses the bucket id into K2's group key as its LOWEST
digit: the timestamp stages as the (hi, lo) i32 planes of the raw64
staging (v >> 24, v & 0xFFFFFF; exact below 2^55), and K2 computes the
bucket per doc from them (csrc/interp.cuh `ts_bucket`). start, step and
the live bucket count are per-segment parameters (`leaf_params`, the
`tb:*` cells); only `count_pad`, the power of two of the count, is in the
plan, so a dashboard whose window slides (only `start` moves) keeps its
plan and its program.

`bucket_ids` is the plain version of that device function (JAX
`bucket_ids` :166): the CPU path and the reference K2 is held against.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.query.expressions import Function, Identifier, Literal

#: timestamps stage as (v >> 24, v & 0xFFFFFF) i32 planes: exact while the
#: hi plane fits i32
MAX_TS = 1 << 55

#: widest admissible window in timestamp units: delta must fit i32 with a
#: 2^24 margin (the hi-plane product can overshoot the true delta by up to
#: one lo-plane carry before the lo difference corrects it)
MAX_WINDOW = (1 << 31) - (1 << 24)

_SHIFT = 1 << 24


class BucketSpec(NamedTuple):
    """Host-side admission result of one leaf query's bucket leg."""
    col: str
    start: int
    step: int
    count: int      # buckets the window addresses
    count_pad: int  # its power of two: the plan's bucket digit width


def _pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _int_lit(e) -> Optional[int]:
    if not isinstance(e, Literal):
        return None
    try:
        v = float(e.value)
    except (TypeError, ValueError):
        return None
    return int(v) if v.is_integer() else None


def extract_bucket(e) -> Optional[Tuple[str, int, int]]:
    """(col, start, step) when `e` is exactly floor((Identifier - int) /
    int) with a positive step, the shape the leaf SQL emits; else None."""
    if not (isinstance(e, Function) and e.name == "floor"
            and len(e.args) == 1):
        return None
    div = e.args[0]
    if not (isinstance(div, Function) and div.name == "divide"
            and len(div.args) == 2):
        return None
    sub, step_e = div.args
    if not (isinstance(sub, Function) and sub.name == "minus"
            and len(sub.args) == 2 and isinstance(sub.args[0], Identifier)):
        return None
    start = _int_lit(sub.args[1])
    step = _int_lit(step_e)
    if start is None or step is None or step <= 0:
        return None
    return sub.args[0].name, start, step


def extract_window(flt, col: str) -> Optional[Tuple[int, int]]:
    """(lo, hi_excl) from top-level `col >= lo AND col < hi` conjuncts;
    None when either bound is missing (an unbounded scan cannot size the
    bucket grid)."""
    conjuncts = list(flt.args) if isinstance(flt, Function) \
        and flt.name == "and" else [flt] if flt is not None else []
    lo = hi = None
    for c in conjuncts:
        if not (isinstance(c, Function) and len(c.args) == 2
                and isinstance(c.args[0], Identifier)
                and c.args[0].name == col):
            continue
        v = _int_lit(c.args[1])
        if v is None:
            continue
        if c.name == "greater_than_or_equal":
            lo = v if lo is None else max(lo, v)
        elif c.name == "greater_than":
            lo = v + 1 if lo is None else max(lo, v + 1)
        elif c.name == "less_than":
            hi = v if hi is None else min(hi, v)
        elif c.name == "less_than_or_equal":
            hi = v + 1 if hi is None else min(hi, v + 1)
    if lo is None or hi is None or hi <= lo:
        return None
    return lo, hi


def plan_bucket(group_expr, flt, segments) -> Optional[BucketSpec]:
    """Admit the first group-by expression as a fused time bucket, or None:
    the floor shape, an int timestamp column within [0, 2^55) on every
    segment, a window that starts at or after `start` (so no kept doc has a
    negative delta) and fits the exact-i32 envelope."""
    shape = extract_bucket(group_expr)
    if shape is None:
        return None
    col, start, step = shape
    win = extract_window(flt, col)
    if win is None or win[0] < start:
        return None
    for seg in segments:
        m = seg.metadata.columns.get(col)
        if m is None or m.data_type.np_dtype.kind not in "iu" \
                or m.min_value is None or m.max_value is None:
            return None
        if int(m.min_value) < 0 or int(m.max_value) >= MAX_TS:
            return None
    window = win[1] - 1 - start
    if window >= MAX_WINDOW:
        return None
    count = window // step + 1
    return BucketSpec(col, start, step, count, _pow2(count))


def leaf_params(spec: BucketSpec, S: int) -> Dict[str, np.ndarray]:
    """The four per-segment i32 parameter cells K2 reads: start's (hi, lo)
    planes, the step and the live bucket count."""
    return {
        "tb:shi": np.full(S, spec.start >> 24, np.int32),
        "tb:slo": np.full(S, spec.start & 0xFFFFFF, np.int32),
        "tb:step": np.full(S, spec.step, np.int32),
        "tb:count": np.full(S, spec.count, np.int32),
    }


def bucket_ids(vhi: torch.Tensor, vlo: torch.Tensor, shi: torch.Tensor,
               slo: torch.Tensor, step: torch.Tensor, count: torch.Tensor,
               count_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bucket ids clipped to [0, count_pad) as int32, in-window gate) from
    [S, D] i32 timestamp planes and [S] i32 cells, as XLA computes them:
    delta = (vhi - shi) * 2^24 + (vlo - slo) wrapping in i32, b = floor
    division by step, gate = delta >= 0 & b < count. The wrap is taken
    explicitly (int64 arithmetic folded to 32 bits): a row outside the
    window may wrap, and its gate must then read as XLA's does."""
    d = (vhi.long() - shi.long()[:, None]) * _SHIFT \
        + (vlo.long() - slo.long()[:, None])
    delta = ((d + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    b = torch.div(delta, step.long()[:, None], rounding_mode="floor")
    gate = (delta >= 0) & (b < count.long()[:, None])
    return b.clamp(0, count_pad - 1).to(torch.int32), gate
