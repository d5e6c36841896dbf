"""Vectorized series math on the stacked [series, buckets] grid.

A copy of pinot_tpu/timeseries/gapfill.py (ref pinot-timeseries post-leaf
operators: keepLastValue / interpolate / gapfill in the m3ql-style pipe
stages). Every transform runs once over the whole block stacked as one
float64 [series, buckets] array, so a dashboard with thousands of series
costs a handful of numpy passes, not a Python loop per cell.

NaN is the "no data in this bucket" marker throughout (matching
TimeSeries.values); every helper preserves that contract — all-NaN
stays NaN unless a fill explicitly replaces it.
"""
from __future__ import annotations

import numpy as np


def keep_last_value(arr: np.ndarray) -> np.ndarray:
    """Forward-fill NaN buckets per row from the last seen value;
    leading NaNs (nothing seen yet) stay NaN. The cummax-of-indices
    trick: each cell remembers the column of the latest valid value at
    or before it, then one gather fills the row."""
    a = np.array(arr, dtype=np.float64, copy=True)
    if a.size == 0:
        return a
    valid = ~np.isnan(a)
    col = np.arange(a.shape[1])[None, :]
    last = np.maximum.accumulate(np.where(valid, col, -1), axis=1)
    filled = np.take_along_axis(a, np.clip(last, 0, None), axis=1)
    return np.where(last >= 0, filled, np.nan)


def gapfill(arr: np.ndarray, value: float = 0.0) -> np.ndarray:
    """Replace every NaN bucket with a constant (m3ql gapfill/zero-fill
    — the 'treat missing as 0 before summing' dashboard idiom)."""
    a = np.array(arr, dtype=np.float64, copy=True)
    a[np.isnan(a)] = value
    return a


def interpolate(arr: np.ndarray) -> np.ndarray:
    """Linear interpolation across interior NaN runs per row; leading
    and trailing NaNs (no bracketing samples) stay NaN. prev/next valid
    indices come from a forward cummax and a reversed cummin — no
    Python loop over cells."""
    a = np.array(arr, dtype=np.float64, copy=True)
    if a.size == 0:
        return a
    B = a.shape[1]
    valid = ~np.isnan(a)
    col = np.arange(B)[None, :]
    prev = np.maximum.accumulate(np.where(valid, col, -1), axis=1)
    nxt = np.minimum.accumulate(
        np.where(valid, col, B)[:, ::-1], axis=1)[:, ::-1]
    interior = (~valid) & (prev >= 0) & (nxt < B)
    p = np.clip(prev, 0, B - 1)
    n = np.clip(nxt, 0, B - 1)
    pv = np.take_along_axis(a, p, axis=1)
    nv = np.take_along_axis(a, n, axis=1)
    frac = (col - p) / np.maximum(n - p, 1)
    return np.where(interior, pv + (nv - pv) * frac, a)


def rate(arr: np.ndarray, step: float) -> np.ndarray:
    """Per-unit first derivative over the bucket step (first bucket has
    no predecessor -> NaN), whole stack at once."""
    a = np.asarray(arr, dtype=np.float64)
    return np.diff(a, axis=1, prepend=np.nan) / step


def aggregate(stacked: np.ndarray, group_ids: np.ndarray,
              num_groups: int, agg: str) -> np.ndarray:
    """Cross-series aggregation: scatter-accumulate the [series,
    buckets] stack into [num_groups, buckets] planes in one pass
    (np.add.at / minimum.at / maximum.at), NaN-aware — a (group,
    bucket) cell with no data in ANY member series comes back NaN,
    matching the old per-group nansum/nanmean/nanmin/nanmax semantics
    exactly."""
    a = np.asarray(stacked, dtype=np.float64)
    valid = ~np.isnan(a)
    B = a.shape[1]
    cnt = np.zeros((num_groups, B))
    np.add.at(cnt, group_ids, valid.astype(np.float64))
    if agg in ("sum", "avg"):
        tot = np.zeros((num_groups, B))
        np.add.at(tot, group_ids, np.where(valid, a, 0.0))
        with np.errstate(invalid="ignore"):
            vals = tot / cnt if agg == "avg" else tot
        return np.where(cnt > 0, vals, np.nan)
    if agg == "min":
        acc = np.full((num_groups, B), np.inf)
        np.minimum.at(acc, group_ids, np.where(valid, a, np.inf))
        return np.where(cnt > 0, acc, np.nan)
    if agg == "max":
        acc = np.full((num_groups, B), -np.inf)
        np.maximum.at(acc, group_ids, np.where(valid, a, -np.inf))
        return np.where(cnt > 0, acc, np.nan)
    raise ValueError(f"unknown series agg {agg!r}")
