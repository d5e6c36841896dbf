"""Aggregation functions of the device slice: registry + base contract.

Counterpart of pinot_tpu/query/aggregation/base.py, the COUNT / SUM /
MIN / MAX / AVG / MINMAXRANGE, DISTINCTCOUNTHLL and PERCENTILETDIGEST
classes of functions.py and the VARIANCE / STDDEV / SKEWNESS / KURTOSIS and
BOOL_AND / BOOL_OR classes of functions_stats.py, with the
`percentiletdigestNN` suffix resolution
(`resolve_percentile_suffix`) (ref pinot-core
query/aggregation/function/AggregationFunction.java:42). A function carries
its device slots (`device_spec`) and `from_device_slots` for the device
path, its host `aggregate(values, mask)` and `aggregate_grouped(values,
keys, num_groups, mask)` for the host executor (query/executor_cpu.py,
JAX base.py:40,48), and `merge`, `identity` and `extract_final` for the
reduce.

Every other aggregation name the JAX package knows resolves to
`UnsupportedAggregation`, which names the missing feature: the engine
refuses the query with it, and the host executor raises it.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Type

import numpy as np

from pinot_tpu_torch.query.expressions import Identifier, Literal
from pinot_tpu_torch.query.sketches import HyperLogLog, TDigest


@dataclass(frozen=True)
class DeviceAggSpec:
    """The masked reductions ('count' | 'sum' | 'sumsq' | 'sum3' | 'sum4' |
    'min' | 'max') or sketch
    slots ('hll:<log2m>' | 'hist:<buckets>') the device kernels compute
    for one function."""
    ops: tuple


class AggregationFunction:
    """One aggregation instance bound to its argument expressions."""

    names: Sequence[str] = ()
    device_spec: Optional[DeviceAggSpec] = None
    #: why the port cannot run this function (None: it can)
    missing_feature: Optional[str] = None

    def __init__(self, args: tuple):
        self.args = args

    def aggregate(self, values: Optional[np.ndarray],
                  mask: np.ndarray) -> Any:
        """The intermediate over the docs `mask` keeps. values: the
        materialized argument column (None for COUNT(*))."""
        raise NotImplementedError

    def aggregate_grouped(self, values: Optional[np.ndarray],
                          keys: np.ndarray, num_groups: int,
                          mask: np.ndarray) -> list:
        """One intermediate per group key in [0, num_groups): keys is a
        doc's group key where mask holds. This default loops over the
        groups; the scalar functions override it with bincount-style
        passes."""
        return [self.aggregate(values, mask & (keys == g))
                for g in range(num_groups)]

    def merge(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def identity(self) -> Any:
        raise NotImplementedError

    def extract_final(self, intermediate: Any) -> Any:
        return intermediate

    def from_device_slots(self, slots: Dict[str, Any]) -> Any:
        raise NotImplementedError

    @property
    def result_name(self) -> str:
        a = ",".join(str(x) for x in self.args)
        return f"{self.names[0]}({a})"

    @property
    def final_dtype(self) -> str:
        return "DOUBLE"


def _masked(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    return values if mask is None else values[mask]


def _grouped_bincount(keys, num_groups, mask, weights=None):
    w = None if weights is None else weights[mask]
    return np.bincount(keys[mask], weights=w, minlength=num_groups)


REGISTRY: Dict[str, Type[AggregationFunction]] = {}


def register(cls: Type[AggregationFunction]) -> Type[AggregationFunction]:
    for name in cls.names:
        REGISTRY[name] = cls
    return cls


@register
class CountAggregation(AggregationFunction):
    names = ("count",)
    device_spec = DeviceAggSpec(("count",))

    def aggregate(self, values, mask):
        return int(np.count_nonzero(mask))

    def aggregate_grouped(self, values, keys, num_groups, mask):
        return _grouped_bincount(keys, num_groups, mask).astype(
            np.int64).tolist()

    def merge(self, a, b):
        return a + b

    def identity(self):
        return 0

    def from_device_slots(self, slots):
        # device counts arrive in the value dtype (single packed output)
        return int(round(float(slots["count"])))

    @property
    def result_name(self):
        return "count(*)" if not self.args or str(self.args[0]) == "*" \
            else super().result_name

    @property
    def final_dtype(self):
        return "LONG"


@register
class SumAggregation(AggregationFunction):
    names = ("sum",)
    device_spec = DeviceAggSpec(("sum",))

    def aggregate(self, values, mask):
        return float(np.sum(_masked(values, mask), dtype=np.float64))

    def aggregate_grouped(self, values, keys, num_groups, mask):
        return _grouped_bincount(keys, num_groups, mask,
                                 values.astype(np.float64)).tolist()

    def merge(self, a, b):
        return a + b

    def identity(self):
        return 0.0

    def from_device_slots(self, slots):
        return float(slots["sum"])


@register
class MinAggregation(AggregationFunction):
    names = ("min",)
    device_spec = DeviceAggSpec(("min",))

    def aggregate(self, values, mask):
        v = _masked(values, mask)
        return float(np.min(v)) if len(v) else float("inf")

    def aggregate_grouped(self, values, keys, num_groups, mask):
        out = np.full(num_groups, np.inf)
        np.minimum.at(out, keys[mask], values[mask].astype(np.float64))
        return out.tolist()

    def merge(self, a, b):
        return min(a, b)

    def identity(self):
        return float("inf")

    def from_device_slots(self, slots):
        return float(slots["min"])


@register
class MaxAggregation(AggregationFunction):
    names = ("max",)
    device_spec = DeviceAggSpec(("max",))

    def aggregate(self, values, mask):
        v = _masked(values, mask)
        return float(np.max(v)) if len(v) else float("-inf")

    def aggregate_grouped(self, values, keys, num_groups, mask):
        out = np.full(num_groups, -np.inf)
        np.maximum.at(out, keys[mask], values[mask].astype(np.float64))
        return out.tolist()

    def merge(self, a, b):
        return max(a, b)

    def identity(self):
        return float("-inf")

    def from_device_slots(self, slots):
        return float(slots["max"])


@register
class AvgAggregation(AggregationFunction):
    """Intermediate is (sum, count) (ref AvgAggregationFunction AvgPair)."""
    names = ("avg",)
    device_spec = DeviceAggSpec(("sum", "count"))

    def aggregate(self, values, mask):
        v = _masked(values, mask)
        return (float(np.sum(v, dtype=np.float64)), len(v))

    def aggregate_grouped(self, values, keys, num_groups, mask):
        s = _grouped_bincount(keys, num_groups, mask,
                              values.astype(np.float64))
        c = _grouped_bincount(keys, num_groups, mask)
        return list(zip(s.tolist(), c.astype(np.int64).tolist()))

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def identity(self):
        return (0.0, 0)

    def extract_final(self, intermediate):
        s, c = intermediate
        return s / c if c else float("-inf")  # ref returns NEGATIVE_INFINITY

    def from_device_slots(self, slots):
        return (float(slots["sum"]), int(round(float(slots["count"]))))


@register
class MinMaxRangeAggregation(AggregationFunction):
    """Intermediate is (min, max) (ref MinMaxRangeAggregationFunction)."""
    names = ("minmaxrange",)
    device_spec = DeviceAggSpec(("min", "max"))

    def aggregate(self, values, mask):
        v = _masked(values, mask)
        if not len(v):
            return (float("inf"), float("-inf"))
        return (float(np.min(v)), float(np.max(v)))

    def merge(self, a, b):
        return (min(a[0], b[0]), max(a[1], b[1]))

    def identity(self):
        return (float("inf"), float("-inf"))

    def extract_final(self, intermediate):
        return intermediate[1] - intermediate[0]

    def from_device_slots(self, slots):
        return (float(slots["min"]), float(slots["max"]))


def _plain_column_arg(args: tuple) -> bool:
    """The device sketch slots read one staged column: the first argument
    must name it."""
    return bool(args) and isinstance(args[0], Identifier) \
        and args[0].name != "*"


def _sketch_input_missing(fn: str, args: tuple) -> str:
    what = str(args[0]) if args else "no argument"
    return f"{fn} over {what} (sketches over expressions)"


@register
class DistinctCountHLLAggregation(AggregationFunction):
    """Approximate distinct count via HyperLogLog
    (ref DistinctCountHLLAggregationFunction, log2m default 12)."""
    names = ("distinctcounthll", "distinctcounthllplus", "distinctcountull",
             "distinctcountcpcsketch")

    def _log2m(self) -> int:
        if len(self.args) > 1 and isinstance(self.args[1], Literal):
            return int(self.args[1].value)
        return 12

    @property
    def device_spec(self) -> Optional[DeviceAggSpec]:
        """Registers from the sketch kernel's hash -> bucket -> max over
        the column's i32 split planes, bit-identical to the host sketch.
        Plain-column arguments only."""
        if _plain_column_arg(self.args):
            return DeviceAggSpec((f"hll:{self._log2m()}",))
        return None

    @property
    def missing_feature(self) -> Optional[str]:
        if self.device_spec is None:
            return _sketch_input_missing("DISTINCTCOUNTHLL", self.args)
        return None

    def aggregate(self, values, mask):
        hll = HyperLogLog(self._log2m())
        hll.add_array(_masked(values, mask))
        return hll

    def merge(self, a, b):
        return a.merge(b)

    def identity(self):
        return HyperLogLog(self._log2m())

    def extract_final(self, intermediate):
        return intermediate.cardinality()

    def from_device_slots(self, slots):
        return HyperLogLog.from_registers(
            slots[f"hll:{self._log2m()}"], self._log2m())

    @property
    def final_dtype(self):
        return "LONG"


@register
class PercentileTDigestAggregation(AggregationFunction):
    """Approximate percentile via t-digest
    (ref PercentileTDigestAggregationFunction, compression 100)."""
    names = ("percentiletdigest", "percentilerawtdigest")

    #: device histogram resolution (quantile error <= one bucket width of
    #: the column's [min, max] range on top of the digest's own error)
    DEVICE_BUCKETS = 8192

    def __init__(self, args, percent: Optional[float] = None):
        super().__init__(args)
        self._pct = percent if percent is not None else (
            float(args[1].value)
            if len(args) > 1 and isinstance(args[1], Literal) else 50.0)
        self._compression = (
            float(args[2].value)
            if len(args) > 2 and isinstance(args[2], Literal) else 100.0)

    @property
    def device_spec(self) -> Optional[DeviceAggSpec]:
        """Fixed-bucket histogram partials over the column's value block
        (bounds from segment metadata), turned into centroids host-side.
        Plain-column arguments only."""
        if _plain_column_arg(self.args):
            return DeviceAggSpec((f"hist:{self.DEVICE_BUCKETS}",))
        return None

    @property
    def missing_feature(self) -> Optional[str]:
        if self.device_spec is None:
            return _sketch_input_missing("PERCENTILETDIGEST", self.args)
        return None

    def aggregate(self, values, mask):
        td = TDigest(self._compression)
        td.add_array(_masked(values, mask))
        return td

    def merge(self, a, b):
        return a.merge(b)

    def identity(self):
        return TDigest(self._compression)

    def extract_final(self, intermediate):
        return intermediate.quantile(self._pct / 100.0)

    def from_device_slots(self, slots):
        return TDigest.from_histogram(
            slots["hist_lo"], slots["hist_width"],
            slots[f"hist:{self.DEVICE_BUCKETS}"], self._compression)


# ---------------------------------------------------------------------------
# moments and boolean folds (pinot_tpu/query/aggregation/functions_stats.py
# :33-143, :329-375): the device computes the raw moments and min / max;
# the host takes the central moments from them
# ---------------------------------------------------------------------------

class _MomentsAggregation(AggregationFunction):
    """Intermediate = (count, sum, sumsq[, sum3, sum4]) raw moments:
    merged by addition, exactly the slots K1 / K2 compute."""
    order = 2

    def aggregate(self, values, mask):
        v = _masked(values, mask).astype(np.float64)
        out = [float(len(v)), float(v.sum()), float((v * v).sum())]
        if self.order >= 4:
            out.append(float((v ** 3).sum()))
            out.append(float((v ** 4).sum()))
        return tuple(out)

    def aggregate_grouped(self, values, keys, num_groups, mask):
        k = keys[mask]
        v = values[mask].astype(np.float64)
        cols = [np.bincount(k, minlength=num_groups).astype(np.float64),
                np.bincount(k, weights=v, minlength=num_groups),
                np.bincount(k, weights=v * v, minlength=num_groups)]
        if self.order >= 4:
            cols.append(np.bincount(k, weights=v ** 3, minlength=num_groups))
            cols.append(np.bincount(k, weights=v ** 4, minlength=num_groups))
        return [tuple(float(c[g]) for c in cols) for g in range(num_groups)]

    def merge(self, a, b):
        return tuple(x + y for x, y in zip(a, b))

    def identity(self):
        return (0.0,) * (3 if self.order < 4 else 5)

    def from_device_slots(self, slots):
        out = [slots["count"], slots["sum"], slots["sumsq"]]
        if self.order >= 4:
            out.append(slots["sum3"])
            out.append(slots["sum4"])
        return tuple(float(x) for x in out)


def _central_moments(inter):
    """(n, mean, m2, m3, m4) from raw moments; m3 and m4 None below order
    4."""
    n, s1, s2 = inter[0], inter[1], inter[2]
    if n == 0:
        return 0.0, 0.0, 0.0, None, None
    mean = s1 / n
    m2 = s2 / n - mean * mean
    if len(inter) < 5:
        return n, mean, m2, None, None
    s3, s4 = inter[3], inter[4]
    m3 = s3 / n - 3 * mean * s2 / n + 2 * mean ** 3
    m4 = s4 / n - 4 * mean * s3 / n + 6 * mean * mean * s2 / n - 3 * mean ** 4
    return n, mean, m2, m3, m4


@register
class VariancePopAggregation(_MomentsAggregation):
    names = ("variance", "var_pop", "varpop")
    device_spec = DeviceAggSpec(("sum", "sumsq", "count"))

    def extract_final(self, inter):
        n, _mean, m2, _, _ = _central_moments(inter)
        return max(m2, 0.0) if n else 0.0


@register
class VarianceSampAggregation(_MomentsAggregation):
    names = ("var_samp", "varsamp", "variancesamp")
    device_spec = DeviceAggSpec(("sum", "sumsq", "count"))

    def extract_final(self, inter):
        n, _mean, m2, _, _ = _central_moments(inter)
        if n < 2:
            return 0.0
        return max(m2 * n / (n - 1), 0.0)


@register
class StdDevPopAggregation(VariancePopAggregation):
    names = ("stddev", "stddev_pop", "stddevpop")

    def extract_final(self, inter):
        return math.sqrt(super().extract_final(inter))


@register
class StdDevSampAggregation(VarianceSampAggregation):
    names = ("stddev_samp", "stddevsamp")

    def extract_final(self, inter):
        return math.sqrt(super().extract_final(inter))


@register
class SkewnessAggregation(_MomentsAggregation):
    """ref SkewnessAggregationFunction (FourthMoment based)."""
    names = ("skewness",)
    order = 4
    device_spec = DeviceAggSpec(("sum", "sumsq", "sum3", "sum4", "count"))

    def extract_final(self, inter):
        n, _mean, m2, m3, _ = _central_moments(inter)
        if not n or m2 <= 0:
            return 0.0
        return float(m3 / m2 ** 1.5)


@register
class KurtosisAggregation(_MomentsAggregation):
    """Excess kurtosis (ref KurtosisAggregationFunction)."""
    names = ("kurtosis",)
    order = 4
    device_spec = DeviceAggSpec(("sum", "sumsq", "sum3", "sum4", "count"))

    def extract_final(self, inter):
        n, _mean, m2, _m3, m4 = _central_moments(inter)
        if not n or m2 <= 0:
            return 0.0
        return float(m4 / (m2 * m2) - 3.0)


@register
class BoolAndAggregation(AggregationFunction):
    """TRUE when every matched value is at least 0.5 (the device's min
    over the column), or nothing matched."""
    names = ("bool_and", "booland")
    device_spec = DeviceAggSpec(("min", "count"))

    def aggregate(self, values, mask):
        v = _masked(values, mask)
        return bool(np.all(v.astype(bool))) if len(v) else True

    def merge(self, a, b):
        return a and b

    def identity(self):
        return True

    def from_device_slots(self, slots):
        return bool(slots["count"] == 0 or slots["min"] >= 0.5)

    @property
    def final_dtype(self):
        return "BOOLEAN"


@register
class BoolOrAggregation(AggregationFunction):
    """TRUE when some matched value is at least 0.5 (the device's max)."""
    names = ("bool_or", "boolor")
    device_spec = DeviceAggSpec(("max", "count"))

    def aggregate(self, values, mask):
        v = _masked(values, mask)
        return bool(np.any(v.astype(bool))) if len(v) else False

    def merge(self, a, b):
        return a or b

    def identity(self):
        return False

    def from_device_slots(self, slots):
        return bool(slots["count"] > 0 and slots["max"] >= 0.5)

    @property
    def final_dtype(self):
        return "BOOLEAN"


#: aggregation names of the JAX package that later slices of the port bring
#: over, by the feature that carries them
_LATER = {
    "sketches": (
        "distinctcount", "distinctcountbitmap",
        "segmentpartitioneddistinctcount",
        "percentile", "percentileest", "percentilerawest", "percentilekll",
        "percentilerawkll", "distinctcountthetasketch",
        "distinctcountrawthetasketch", "distinctcounttuplesketch",
        "distinctcountrawintegersumtuplesketch", "histogram", "mode"),
    "multi-value aggregations": (
        "countmv", "summv", "minmv", "maxmv", "avgmv", "minmaxrangemv",
        "distinctcountmv"),
    "host-only aggregations": (
        "covar_pop", "covarpop", "covar_samp", "covarsamp",
        "sumprecision", "firstwithtime", "lastwithtime", "distinctsum",
        "distinctavg", "funnelcount", "funnel_count", "funnelcompletecount",
        "arrayagg", "array_agg", "listagg"),
}
_FEATURE_OF = {n: f for f, names in _LATER.items() for n in names}
_PERCENTILE_SUFFIX = re.compile(
    r"(percentile(?:est|kll|tdigest|rawest|rawtdigest)?)(\d{1,3})")


class UnsupportedAggregation(AggregationFunction):
    """An aggregation the JAX package runs and this port does not yet:
    the engine refuses it and the host executor raises."""

    def __init__(self, name: str, args: tuple):
        super().__init__(args)
        self.names = (name,)
        self.missing_feature = f"{_FEATURE_OF.get(name, 'sketches')} ({name})"

    def aggregate(self, values, mask):
        raise NotImplementedError(
            f"aggregation {self.names[0].upper()} is not in this port yet")


def is_aggregation(name: str) -> bool:
    n = name.lower()
    return n in REGISTRY or n in _FEATURE_OF \
        or _PERCENTILE_SUFFIX.fullmatch(n) is not None


def resolve_percentile_suffix(name: str, args: tuple
                              ) -> Optional[AggregationFunction]:
    """percentiletdigest95(col) style names -> a configured instance; None
    when the name carries no percent suffix. Suffixed names of the other
    percentile families are still to port."""
    m = _PERCENTILE_SUFFIX.fullmatch(name.lower())
    if m is None:
        return None
    base, pct = m.group(1), float(m.group(2))
    if "tdigest" in base:
        return PercentileTDigestAggregation(args, percent=pct)
    return UnsupportedAggregation(name.lower(), args)


def get_aggregation(name: str, args: tuple) -> AggregationFunction:
    n = name.lower()
    cls = REGISTRY.get(n)
    if cls is not None:
        return cls(args)
    if n in _FEATURE_OF:
        return UnsupportedAggregation(n, args)
    inst = resolve_percentile_suffix(n, args)
    if inst is None:
        raise ValueError(f"unknown aggregation function: {name}")
    return inst
