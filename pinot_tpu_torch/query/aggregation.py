"""Aggregation functions of the device slice: registry + base contract.

Counterpart of pinot_tpu/query/aggregation/base.py and the COUNT / SUM /
MIN / MAX / AVG / MINMAXRANGE, DISTINCTCOUNTHLL and PERCENTILETDIGEST
classes of functions.py, with its `percentiletdigestNN` suffix resolution
(`resolve_percentile_suffix`) (ref pinot-core
query/aggregation/function/AggregationFunction.java:42). The port has no
host executor, so a function here carries only what the device path and the
reduce need: its device slots (`device_spec`), `from_device_slots`, `merge`,
`identity` and `extract_final`.

Every other aggregation name the JAX package knows resolves to
`UnsupportedAggregation`, which names the missing feature so the engine can
refuse the query with it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Type

from pinot_tpu_torch.query.expressions import Identifier, Literal
from pinot_tpu_torch.query.sketches import HyperLogLog, TDigest


@dataclass(frozen=True)
class DeviceAggSpec:
    """The masked reductions ('count' | 'sum' | 'min' | 'max') or sketch
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


REGISTRY: Dict[str, Type[AggregationFunction]] = {}


def register(cls: Type[AggregationFunction]) -> Type[AggregationFunction]:
    for name in cls.names:
        REGISTRY[name] = cls
    return cls


@register
class CountAggregation(AggregationFunction):
    names = ("count",)
    device_spec = DeviceAggSpec(("count",))

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
    "moment aggregations": (
        "variance", "var_pop", "varpop", "var_samp", "varsamp",
        "variancesamp", "stddev", "stddev_pop", "stddevpop", "stddev_samp",
        "stddevsamp", "skewness", "kurtosis", "covar_pop", "covarpop",
        "covar_samp", "covarsamp"),
    "multi-value aggregations": (
        "countmv", "summv", "minmv", "maxmv", "avgmv", "minmaxrangemv",
        "distinctcountmv"),
    "host-only aggregations": (
        "sumprecision", "firstwithtime", "lastwithtime", "bool_and",
        "booland", "bool_or", "boolor", "distinctsum", "distinctavg",
        "funnelcount", "funnel_count", "funnelcompletecount", "arrayagg",
        "array_agg", "listagg"),
}
_FEATURE_OF = {n: f for f, names in _LATER.items() for n in names}
_PERCENTILE_SUFFIX = re.compile(
    r"(percentile(?:est|kll|tdigest|rawest|rawtdigest)?)(\d{1,3})")


class UnsupportedAggregation(AggregationFunction):
    """An aggregation the JAX package runs and this port does not yet."""

    def __init__(self, name: str, args: tuple):
        super().__init__(args)
        self.names = (name,)
        self.missing_feature = f"{_FEATURE_OF.get(name, 'sketches')} ({name})"


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
