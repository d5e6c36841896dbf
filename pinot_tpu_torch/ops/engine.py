"""TorchOperatorExecutor: stages segment columns on the card and runs the
fused scan-aggregate / group-by / top-N / star-tree kernels across segments.

Counterpart of the aggregation, selection and DISTINCT paths of
pinot_tpu/ops/engine.py (`TpuOperatorExecutor`: supports :259,
`_supports_distinct` :302, `_supports_selection` :315, `_execute_distinct`
:1360, `_execute_topn` :1442, `_plan` :1487, `_plan_topn` :1791,
`_assemble_topn` :1849, `_build_filter_ir` :1883, `_stage` :1991,
`_assemble` :2913, `_isum_value` :3119; the star-tree leg
`_startree_candidate` :662, `_prepare_startree` :981, `_stage_startree` :1062,
`_st_block` :1112, routed at :1240-1267), which replaces the reference's
per-segment operator chain + combine fan-out
(pinot-core combine/BaseCombineOperator.java:54) with ONE device program
over stacked [num_segments, padded_docs] blocks.

Launches ride the dispatch ring (ops/dispatch.py, JAX `execute` :1221,
`execute_async` :1273): plan and stage run under the engine lock (they
mutate the block and parameter caches), then the staged `Launch` goes to
the `KernelDispatcher`, which coalesces concurrent launches of one plan and
shape bucket into one launch of K1-K4 with a member axis and splits the
result back per caller (`_prepare_agg` / `_prepare_topn` / `_prepare_startree`
as JAX :390, :1396, :981; the pow2 segment bucket `_padded_S` :1963;
`_batch_id` :3147, `_shape_sig` :3153; `_cols_key` :2261 in `_launch`);
star-tree launches coalesce on the same kind of key into one launch of K5
with a member axis (JAX :1034-1058).

Staging keeps three levels (JAX `_stacked` :2448-2600): host rows per
(segment, column), each padded to the segment's own power-of-two bucket
under a host budget; resident device rows per (segment, column)
(ops/residency.py: TinyLFU admission under
`pinot.server.hbm.resident.bytes`); and assembled [S, D] blocks per
(segment batch, column). A block miss builds and uploads only the rows the
card does not hold, through pinned memory on the default stream, counts
their bytes in the transfer odometer and offers them to the resident tier;
K6 `row_assemble` then assembles the block on the card. Star-tree pre-agg
pseudo-columns ride the same levels (admitted to the resident tier only
under `pinot.server.startree.hbm.resident`). `invalidate_segment`,
`drop_caches`, `prestage` and `residency_seeding` are the server's and
warm-up's calls on these levels (JAX :2692-2790). A scan's per-query
parameters (resolved leaf bounds and LUTs, histogram bounds, the time
bucket's cells, num_docs) are cached per (segment batch, plan, filter), so
a repeat query resolves and uploads nothing (JAX :2101-2117).

Upsert segments (a `valid_doc_ids` Bitmap, segment/upsert.py) put a
validity mask in the plan: the engine stages it as a one-byte-per-doc
[S, D] `vmask` block through the same three levels, its rows keyed
`vmask:<bitmap version>` so an in-place clear() addresses fresh keys and
the superseded rows are purged (JAX `_stage_vmask` :2272), and K1-K4 AND
it into the doc validity. A time-series leaf (`GROUP BY floor((t - start)
/ step), tags` over a `t` window, JAX :282-292, :1650-1690) fuses the
bucket id into K2's dense key as its lowest digit
(ops/timeseries_device.py), its start / step / count in per-segment
`tb:*` parameter cells beside the timestamp's split planes. A LIKE or
REGEXP_LIKE over a CLP log column (JAX `_clp_leaf` :704,
`_build_filter_ir` :1905-1911, staging :2038-2071 and :2199-2207) plans
as a 'clp' leaf: the pattern compiles on the host against each segment's
logtype dictionary (ops/clp_device.py), the column stages as its
logtype-id and variable-slot pseudo-columns through the three levels,
the leaf's tables through the params cache, and K7 `clp_match` computes
the leaf's per-doc mask ahead of K1 / K2 / K4; a pattern the planner
cannot push raises NotOffloadable with its reason, counted as
`clp_fallback`. A selection filtered by `vector_similarity(col, '<json
vector>', K)` (JAX routing :320-327 and :1444, `_plan_vector` :737,
`_stage_vector_locked` :787, `_vec_block_locked` :828, `_prepare_vector`
:892, `_execute_vector` :957) plans as a vector plan whose residual
conjuncts are its filter (ops/vector_device.py); the vector block and the
IVF cells stage as `__vec__/<col>/block` and `__vec__/<col>/cells` rows
through the three levels (each row padded to the segment's own doc bucket
times dim_pad), the query vector, K and probe cells through the params
cache under the vector function's own key, and K8 `vector_topk` picks the
K winners per segment before the residual filter and the validity mask
apply; a refusal raises NotOffloadable with the JAX reason, counted as
`vector_fallback`. `filtered_doc_ids` (JAX :1749) gives the MSE leaf's
filtered doc ids per segment from K4.

A mesh engine (`mesh=`, a parallel.mesh.Mesh over (segments, docs); or
`devices=`, a segments-only mesh; with neither, and no `device=`, every
CUDA device: one card alone, several as a segments-only mesh; JAX :74-105)
pads S to the mesh's segment multiple and D to its doc multiple (JAX
`_padded_S` :1963, `_padded_D` :1979), assembles each block on the lead
device and keeps its [S_loc, D_loc] shards in the block cache, one per slot
(JAX `_reshard_block` :2611). An aggregation launches
`kernels.sharded_kernel`: K1-K3 per slot (K7 first for a CLP leaf, its
tables split by segment with the other parameters), then K9 `mesh_fold`
over the doc slices. On an explicit mesh of more than one slot an
aggregation merges instead (JAX :455-496, ops/collective.py): one K9 folds
every slot's partials into one row for the batch, through the host-built
remap of dense group keys (`_merged_group_params`, cached per segment
batch); the float32 precision gate, the group caps, the config key
`pinot.server.mesh.collective.merge` and the `server.mesh.collective`
failpoint keep the sharded launch and the host fold, counted as
`mesh_merge_fallback{reason}`, a merge as `mesh_merge_served`. On a
segments-only mesh (doc axis 1, implicit or explicit; JAX routes on the
doc axis) a selection's top-N and the MSE leaf's doc ids run K4 per slot,
a vector search K8 and a star-tree query K5
(`kernels.sharded_topn_kernel`, `startree_device.sharded_kernel`), each
slot's rows concatenated in segment order on the lead, with no fold. The
mesh's shape and the merge ride the coalesce key. A top-N and the doc ids
on a doc-sharded mesh raise NotOffloadable with reason 'mesh' (JAX's host
path, :1446-1447, :1758), a time bucket on an explicit mesh too (JAX
:282-292), each counted as `mesh_refused{mode}`; a vector search on a
doc-sharded mesh is JAX's 'staging' fallback; a star-tree query there
takes the scan leg (JAX :674). Resident rows spread round-robin over the
mesh's distinct devices and charge their chip's share of the resident
budget (JAX `_put_row` :2585, ops/residency.py); K6 assembles a block on
the lead from them, and a mesh engine reports `hbm_cache_bytes{device=}`
and `hbm_resident_bytes{device=}` per chip. A logical mesh, every slot on
one device, is one chip.

A GROUP BY or DISTINCT over dictionary columns whose dense key space
exceeds MAX_DEVICE_GROUPS plans compact keys (JAX :1688-1694): each
segment's key tuples present are factorized once on the host
(`factorize_keys`, cached in the host rows per (segment, group columns)),
their int32 codes stage as the `gkey` column through the three levels,
K2 groups by them at G, the power of two of the most tuples a segment
holds (a launch argument, in the coalesce key), and assembly decodes the
codes through each segment's table; a merge remaps them through the
sorted union of the batch's tuples (`_merged_group_params`). A G past
MAX_DEVICE_GROUPS or the group-result cap raises NotOffloadable, reason
'groups', where JAX goes to its host. The rules it keeps from the JAX
engine:
cardinality-aware i8/i16/i32 id staging, power-of-two doc padding masked by
`num_docs`, the per-segment doc cap, the group-count and group-result-size
caps, the float32 precision guard, the exact-int-sum (isum) admission, the
ungrouped sketch slots (HLL registers over split planes of int columns
below 2^55, histogram buckets between the batch's metadata min and max),
selection as a per-segment top-K over one order value (k <= TOPN_MAX_K)
whose winners alone are projected on the host, and DISTINCT as a
presence-only group-by. An aggregation over segments that all carry a
star-tree is answered from the fitted trees' pre-aggregated records first
(ops/startree_device.py, K5); any fallback reason, counted in `meters`,
drops it through to the scan path (K1/K2). A selection with neither a
filter nor an ORDER BY is answered on the host from the first docs of each
segment, as the JAX engine leaves it to its host executor. A query or
segment batch the engine refuses raises NotOffloadable naming the missing
feature; the server's call (query/executor.py `execute_context`) hands it,
and only it, to the host executor.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import Counter, OrderedDict
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.models.field_spec import DataType
from pinot_tpu_torch.ops import dispatch as dispatch_mod
from pinot_tpu_torch.ops import (clp_device, collective, kernels, program,
                                 startree_device, timeseries_device,
                                 vector_device)
from pinot_tpu_torch.ops import residency as residency_mod
#: most rows a selection fetches per segment (limit + offset)
from pinot_tpu_torch.ops._cuda import TOPN_MAX_K
from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan, is_grouped
from pinot_tpu_torch.parallel.mesh import (Mesh, default_devices,
                                           device_label, distinct_devices,
                                           segments_mesh, shard_block)
from pinot_tpu_torch.query import executor_cpu
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    Expression, Function, Identifier, Literal)
from pinot_tpu_torch.query.predicate import resolve_predicate
from pinot_tpu_torch.query.results import (
    AggregationResult, DistinctResult, ExecutionStats, GroupByResult,
    SelectionResult)
from pinot_tpu_torch.segment.loader import ImmutableSegment
from pinot_tpu_torch.utils import tracing
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.failpoints import fire
from pinot_tpu_torch.utils.metrics import get_registry

MAX_DEVICE_GROUPS = 1 << 20
#: cap on the [S, G, slots] group-by result buffer
MAX_GROUP_RESULT_BYTES = 1 << 31
#: doc-padding cap: counts are packed in float32, exact only below 2^24
MAX_DOCS_PER_SEGMENT = 1 << 24
#: the largest doc bucket that takes the cross-table coalesce key (JAX's
#: default pinot.server.dispatch.doc.bucket.max); a larger D keeps the
#: same-batch key
DOC_BUCKET_MAX = 1 << 20
_LEAF_RANGE_FUNCS = {
    "equals", "between", "greater_than", "greater_than_or_equal",
    "less_than", "less_than_or_equal",
}
_LEAF_LUT_FUNCS = {"in", "not_in", "like", "regexp_like"}
#: filter functions that later slices bring to the device, by feature
_LATER_FILTERS = {"text_match": "text index", "json_match": "JSON index",
                  "is_null": "null handling", "is_not_null": "null handling"}


def _pow2(n: int, floor: int = 128) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


class NotOffloadable(NotImplementedError):
    """The query or segment batch needs a feature this slice lacks.
    `reason`: one fixed word naming the refusal (the JAX engine's fallback
    reason where it meters one, e.g. a CLP pattern's,
    ops/clp_device.FALLBACK_REASONS); the message names the query's parts
    and may hold its literals."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


class TorchOperatorExecutor:
    """Plans, stages and runs queries on one device or a mesh of them;
    safe to call from many threads at once.

    value_dtype: float32 (the card's default: f32 value blocks, exact int
    sums through isum planes) or float64 (f64 blocks, no isum).
    device: the engine's device, or the mesh's lead device on a mesh engine
    (which must be the lead device if given). With none of device, devices
    and mesh the engine takes every CUDA device
    (`parallel.mesh.default_devices`, JAX's `jax.devices()` default): one
    card alone, several as a segments-only mesh; RuntimeError without a
    CUDA device. device="cpu" runs the plain PyTorch versions.
    mesh: a parallel.mesh.Mesh over (segments, docs); devices: a list of
    devices for a segments-only mesh (one: that device), not both.
    config: a utils.config.PinotConfiguration; the engine reads the
    `pinot.server.dispatch.*` keys (its dispatch ring),
    `pinot.server.startree.enabled` (answer aggregations from fitted
    star-trees; a query opts out with OPTION(useStarTree=false)), the
    `pinot.server.hbm.*` keys (the resident-row tier),
    `pinot.server.startree.hbm.resident`,
    `pinot.server.timeseries.bucket.enabled` (fuse a leading
    floor((t - start) / step) group-by into K2's key; off, such a query is
    refused), `pinot.server.vector.enabled` (vector_similarity on K8; off,
    such a query is refused with reason 'disabled') and
    `pinot.server.vector.hbm.resident` and
    `pinot.server.mesh.collective.merge` (merge a segment batch's partials
    on an explicit mesh; off, the sharded launch and the host fold).
    metrics_labels: labels of the engine's and dispatcher's meters and
    timers.
    """

    #: budget of the assembled-block cache, which keeps each (segment batch,
    #: column) block on the device across queries, LRU-evicted
    CACHE_BYTES = 16 << 30
    #: budget of the host rows (JAX pinot.server.host.row.cache.bytes'
    #: default), LRU-evicted
    HOST_ROW_BYTES = 16 << 30
    #: per-query parameters kept per (segment batch, plan, filter, ...):
    #: a scan's leaf, histogram and time-bucket cells with its num_docs, a
    #: star-tree's selection mask and record counts
    PARAMS_CACHE_ENTRIES = 4096
    #: hard backstop on one wait for a launch's result
    LAUNCH_WAIT_CAP_S = dispatch_mod.DEFAULT_WAIT_CAP_S

    #: cap on the host-built remap lists of a merged group-by per (segment
    #: batch, plan): past this the lists would rival the partials they
    #: fold, and the per-segment launch and the host fold serve it (JAX
    #: `GMAP_MAX_BYTES` :533)
    GMAP_MAX_BYTES = 1 << 26
    GMAP_CACHE_ENTRIES = 64

    def __init__(self, device=None, value_dtype=torch.float32,
                 config: Optional[PinotConfiguration] = None,
                 metrics_labels: Optional[Dict[str, str]] = None,
                 mesh: Optional[Mesh] = None, devices=None):
        if mesh is not None and devices is not None:
            raise ValueError("pass a mesh or devices, not both")
        #: the collective merge engages only on an explicit mesh (JAX
        #: :87-91); devices= spans a segments-only mesh whose launches keep
        #: per-segment partials
        self._explicit_mesh = mesh is not None
        if mesh is None and devices is None and device is None:
            devices = default_devices()
        if mesh is None and devices is not None:
            devices = list(devices)
            mesh = segments_mesh(devices)
            if mesh is None and device is None:
                device = devices[0]
        self._mesh = mesh
        self._doc_axis = mesh.shape[1] if mesh is not None else 1
        if device is None:
            device = mesh.lead
        self.device = torch.device(device)
        if mesh is not None and not _same_device(self.device, mesh.lead):
            raise ValueError(f"engine device {self.device} is not the "
                             f"mesh's lead device {mesh.lead}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card; "
                               "pass device='cpu' for the plain PyTorch "
                               "kernels")
        #: the chips: the mesh's distinct devices (a logical mesh on one
        #: card is one chip), or the engine's device. Resident rows spread
        #: over them round-robin and charge their chip's share of the
        #: resident budget (JAX `_put_row` :2585)
        self._chips = distinct_devices(mesh) if mesh is not None \
            else [self.device]
        self._row_rr = itertools.count()
        if value_dtype not in (torch.float32, torch.float64):
            raise ValueError(f"value dtype {value_dtype} is not float32/64")
        self.value_dtype = value_dtype
        cfg = config or PinotConfiguration()
        self._startree_enabled = cfg.get_bool(
            "pinot.server.startree.enabled", True)
        self._st_resident = cfg.get_bool(
            "pinot.server.startree.hbm.resident", True)
        self._ts_bucket_enabled = cfg.get_bool(
            "pinot.server.timeseries.bucket.enabled", True)
        self._vector_enabled = cfg.get_bool("pinot.server.vector.enabled",
                                            True)
        self._vector_resident = cfg.get_bool(
            "pinot.server.vector.hbm.resident", True)
        self._collective_merge = cfg.get_bool(
            "pinot.server.mesh.collective.merge", True)
        #: (segment batch, plan, S) -> the merged group-by's fold, its group
        #: pad, real group count and key decode (JAX `_gmap_cache` :228)
        self._gmap_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._metrics = get_registry("server")
        self._labels = metrics_labels
        resident_bytes = cfg.get_int("pinot.server.hbm.resident.bytes")
        if not cfg.get_bool("pinot.server.hbm.resident.enabled", True):
            resident_bytes = 0
        self._residency = residency_mod.ResidencyManager(
            resident_bytes,
            admission=cfg.get_bool("pinot.server.hbm.admission.enabled",
                                   True),
            sample_window=cfg.get_int("pinot.server.hbm.admission.sample"),
            metrics=self._metrics, labels=metrics_labels,
            devices=[device_label(d) for d in self._chips])
        #: plan and stage mutate the block and parameter caches and the
        #: meters, so they run under this lock; launches and fetches run
        #: outside it, on the dispatcher
        self._engine_lock = threading.RLock()
        self._blocks: "OrderedDict[tuple, Tuple[tuple, torch.Tensor]]" = \
            OrderedDict()
        self._cached = 0
        #: (id(segment), kind, column, row length, dtype) -> (segment, row);
        #: (id(segment), "gkey_table", group columns) -> (segment, table)
        self._host_rows: "OrderedDict[tuple, Tuple[Any, np.ndarray]]" = \
            OrderedDict()
        self._host_bytes = 0
        self._params_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        #: the JAX engine's meters, keyed (name, reason):
        #: ("startree_served", None), ("startree_fallback", <reason>),
        #: ("timeseries_leaf_device", None), ("clp_served", None),
        #: ("clp_fallback", <reason>), ("vector_served", None),
        #: ("vector_fallback", <reason>), ("mesh_merge_served", None),
        #: ("mesh_merge_fallback", <reason>) and ("mesh_refused", <mode>)
        self.meters: Counter = Counter()
        self._dispatcher = dispatch_mod.KernelDispatcher(
            config=cfg, labels=metrics_labels)
        #: shape-bucket coalescing across tables: the segment axis pads to
        #: a power of two so equal plans over other tables share a key;
        #: only where a batch can form at all, and for doc buckets up to
        #: DOC_BUCKET_MAX
        self._cross_table = (
            cfg.get_bool("pinot.server.dispatch.batch.cross.table", True)
            and self._dispatcher.mode != "serialized"
            and self._dispatcher.batch_max > 1)
        self._tls = threading.local()

    @property
    def last_stage_ms(self) -> Dict[str, float]:
        """Host-clock split (ms) of this thread's last execute: plan
        (capability check, lock wait and plan), stage (block cache and
        leaf parameters), kernel_fetch (submit to the result on the host,
        the ring's queue wait included), assemble."""
        return getattr(self._tls, "stage_ms", {})

    @property
    def dispatcher(self) -> dispatch_mod.KernelDispatcher:
        return self._dispatcher

    @property
    def _vdt(self):
        return np.float64 if self.value_dtype == torch.float64 \
            else np.float32

    # ------------------------------------------------------------------
    # capability check (structural)
    # ------------------------------------------------------------------
    def missing_feature(self, ctx: QueryContext) -> Optional[str]:
        """None when this slice runs the query's shape, else the feature
        it lacks."""
        missing = self._missing(ctx)
        return None if missing is None else missing[1]

    def _missing(self, ctx: QueryContext) -> Optional[Tuple[str, str]]:
        """None, or (reason, message) of the shape this slice lacks: the
        reason is one fixed word, the message names the query's parts."""
        if ctx.distinct:
            return self._distinct_missing(ctx)
        if not ctx.aggregations:
            return self._selection_missing(ctx)
        return self._aggregation_missing(ctx)

    def _refuse_shape(self, ctx: QueryContext) -> None:
        missing = self._missing(ctx)
        if missing is not None:
            raise NotOffloadable(missing[1], reason=missing[0])

    def supports(self, ctx: QueryContext) -> bool:
        return self.missing_feature(ctx) is None

    def meter(self, name: str, reason: Optional[str] = None) -> int:
        """A meter's count: `startree_served`, `timeseries_leaf_device`
        (time-series leaves staged with the fused bucket), `clp_served`
        (stagings of a plan with a CLP leaf), `vector_served` (vector
        queries staged for K8), or `startree_fallback` / `clp_fallback` /
        `vector_fallback` with its reason; on a mesh, `mesh_merge_served`
        (merged launches staged), `mesh_merge_fallback` with its reason
        ('disabled', 'chaos', 'precision', 'groups') and `mesh_refused`
        with the refused mode ('topn' and 'doc_ids' on a doc-sharded mesh,
        'tbucket' on an explicit one)."""
        return self.meters[(name, reason)]

    def _aggregation_missing(self, ctx: QueryContext
                             ) -> Optional[Tuple[str, str]]:
        for fn in ctx.agg_functions:
            if fn.missing_feature is not None:
                return "aggregation", fn.missing_feature
        if ctx.group_by and any(kernels.is_sketch(op)
                                for fn in ctx.agg_functions
                                for op in fn.device_spec.ops):
            # sketch slots are vector-valued; the grouped layout is
            # scalar per slot (the JAX engine runs these on its host)
            return "groupedSketch", "grouped sketches"
        for f in list(ctx.agg_filters) + [ctx.filter]:
            if f is not None:
                why = self._filter_missing(f)
                if why is not None:
                    return why
        for node in ctx.aggregations:
            if node.args and not (isinstance(node.args[0], Identifier)
                                  and node.args[0].name == "*"):
                if self._value_ir_shape(node.args[0]) is None:
                    return ("aggregationInput",
                            f"aggregation over expression {node.args[0]}")
        for i, g in enumerate(ctx.group_by):
            if isinstance(g, Identifier):
                continue
            if i == 0 and self._ts_bucket_enabled \
                    and timeseries_device.extract_bucket(g) is not None:
                # the time-series leaf: the leading floor((t - start) /
                # step) fuses into K2's key (its window and metadata are
                # admitted in _plan)
                continue
            return "groupByExpression", f"group-by on expression {g}"
        return None

    def _distinct_missing(self, ctx: QueryContext
                          ) -> Optional[Tuple[str, str]]:
        """DISTINCT over columns rides the group-by kernel (a presence-only
        group-by; JAX `_supports_distinct`)."""
        if not ctx.select or ctx.aggregations:
            return "distinct", "DISTINCT with aggregations"
        for e in ctx.select:
            if not isinstance(e, Identifier) or e.name == "*":
                return "distinct", f"DISTINCT over {e} (expressions)"
        if ctx.filter is not None:
            return self._filter_missing(ctx.filter)
        return None

    def _selection_missing(self, ctx: QueryContext
                           ) -> Optional[Tuple[str, str]]:
        """Selection with at most one ORDER BY key runs as a device top-K
        over the order value (JAX `_supports_selection`); neither a filter
        nor an ORDER BY is the host's first-docs scan. A vector_similarity
        filter routes to the vector leg, whose planner refuses with the
        JAX fallback reasons."""
        if vector_device.contains_vector(ctx.filter):
            return None if ctx.limit + ctx.offset > 0 \
                else ("limit", "selection with LIMIT 0")
        if ctx.filter is not None:
            why = self._filter_missing(ctx.filter)
            if why is not None:
                return why
        if len(ctx.order_by) > 1:
            return "orderBy", "selection with more than one ORDER BY key"
        if ctx.filter is None and not ctx.order_by:
            return None
        k = ctx.limit + ctx.offset
        if k <= 0:
            return "limit", "selection with LIMIT 0"
        if k > TOPN_MAX_K:
            return "limit", f"selection of {k} rows per segment (top-N " \
                            f"above {TOPN_MAX_K})"
        if ctx.order_by:
            e, _asc = ctx.order_by[0]
            if not isinstance(e, (Identifier, Function)) \
                    or self._value_ir_shape(e) is None:
                return "orderBy", f"ORDER BY {e} (expressions)"
        return None

    def _filter_missing(self, e: Expression) -> Optional[Tuple[str, str]]:
        if isinstance(e, Function):
            if e.name in ("and", "or", "not"):
                for a in e.args:
                    why = self._filter_missing(a)
                    if why is not None:
                        return why
                return None
            if e.name in _LATER_FILTERS:
                return "filterIndex", _LATER_FILTERS[e.name]
            if e.name == "vector_similarity":
                return ("filterExpression",
                        "vector similarity outside a selection's filter")
            if e.name in _LEAF_RANGE_FUNCS | _LEAF_LUT_FUNCS \
                    | {"not_equals"} and e.args \
                    and isinstance(e.args[0], Identifier) \
                    and all(isinstance(a, Literal) for a in e.args[1:]):
                return None
        return "filterExpression", f"filter {e} (expression predicates)"

    def _value_ir_shape(self, e: Expression) -> Optional[tuple]:
        """Structural value IR (column stagability checked at execute)."""
        if isinstance(e, Identifier):
            return ("col", e.name)
        if isinstance(e, Literal):
            if isinstance(e.value, (int, float)) \
                    and not isinstance(e.value, bool):
                return ("lit", float(e.value))
            return None
        if isinstance(e, Function):
            ops = {"plus": "add", "minus": "sub", "times": "mul",
                   "divide": "div"}
            if e.name in ops and len(e.args) == 2:
                a = self._value_ir_shape(e.args[0])
                b = self._value_ir_shape(e.args[1])
                if a is not None and b is not None:
                    return (ops[e.name], a, b)
        return None

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute(self, segments: List[ImmutableSegment], ctx: QueryContext,
                cancel_check=None) -> List[Any]:
        """Per-segment AggregationResult / GroupByResult / SelectionResult
        / DistinctResult, in segment order. Raises NotOffloadable (a
        NotImplementedError) naming what the query or the batch needs
        beyond this slice. cancel_check: polled while the launch waits in
        the ring; what it raises (BrokerTimeoutError, QueryCancelledError)
        fails the query before its kernel runs."""
        t0 = time.perf_counter()
        self._refuse_shape(ctx)
        if not segments:
            self._tls.stage_ms = {}
            return []
        if _first_docs(ctx):
            t1 = time.perf_counter()
            out = [executor_cpu.select_first(seg, ctx) for seg in segments]
            self._tls.stage_ms = {"plan": (t1 - t0) * 1e3, "stage": 0.0,
                                  "kernel_fetch": 0.0,
                                  "assemble": (time.perf_counter() - t1)
                                  * 1e3}
            return out
        with self._dispatcher.active():
            launch, assemble = self._prepare(segments, ctx, cancel_check)
            t2 = time.perf_counter()
            packed = dispatch_mod.wait_result(
                self._dispatcher.submit(launch), launch.cancel_check,
                max_wait_s=self.LAUNCH_WAIT_CAP_S)
        t3 = time.perf_counter()
        out = assemble(packed)
        t1 = self._tls.planned
        self._tls.stage_ms = {"plan": (t1 - t0) * 1e3,
                              "stage": (t2 - t1) * 1e3,
                              "kernel_fetch": (t3 - t2) * 1e3,
                              "assemble": (time.perf_counter() - t3) * 1e3}
        return out

    def execute_async(self, segments: List[ImmutableSegment],
                      ctx: QueryContext, cancel_check=None) -> Future:
        """Future of execute's results: an aggregation stages on the
        dispatch staging pool and its launch rides the ring, so the caller
        runs on while query N+1 stages beside query N's kernel. Other
        shapes (top-N, DISTINCT, first docs) and serialized mode run
        inline on the caller, as execute does (JAX :1273)."""
        if ctx.distinct or not ctx.aggregations \
                or self._dispatcher.mode == "serialized":
            fut: Future = Future()
            try:
                fut.set_result(self.execute(segments, ctx, cancel_check))
            except BaseException as e:  # noqa: BLE001 — the future carries it
                fut.set_exception(e)
            return fut
        out: Future = Future()
        self._dispatcher.enter_active()
        out.add_done_callback(lambda _f: self._dispatcher.exit_active())
        # the staging pool's thread does not see the caller's current span
        parent_span = tracing.capture()

        def stage_and_enqueue():
            try:
                self._refuse_shape(ctx)
                if not segments:
                    out.set_result([])
                    return
                launch, assemble = self._prepare(segments, ctx, cancel_check,
                                                 parent_span)

                def finish(f):
                    try:
                        # a done-callback: f is resolved
                        out.set_result(assemble(f.result(timeout=0)))
                    except BaseException as e:  # noqa: BLE001
                        out.set_exception(e)

                self._dispatcher.submit(launch).add_done_callback(finish)
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)

        dispatch_mod.staging_pool().submit(stage_and_enqueue)
        return out

    def _prepare(self, segments, ctx: QueryContext, cancel_check,
                 parent_span: Optional[tracing.SpanHandle] = None):
        """Plan and stage under the engine lock: (the Launch, the function
        that assembles its packed result). Records the clock after
        planning in `self._tls.planned`, and how much of this staging ran
        while another launch was in flight (`staging_overlap_ms`). When
        the request is traced (the current span, or `parent_span` for a
        caller off the request thread) a `DeviceDispatch` child span
        carries the staging's ms, its host-to-device bytes and its block
        hits and misses (JAX `_staging_attrs` :1205): exact per query,
        as staging holds the engine lock."""
        if parent_span is None:
            parent_span = tracing.capture()
        dsp = None if parent_span is None else parent_span.child(
            "DeviceDispatch", table=ctx.table,
            mode="distinct" if ctx.distinct else
            "agg" if ctx.aggregations else "topn")
        busy0 = self._dispatcher.busy_ms()
        with self._engine_lock:
            snap = self._staging_snapshot(dsp)
            try:
                prepared = self._prepare_locked(segments, ctx, cancel_check)
            except Exception as e:
                if dsp is not None:
                    dsp.end(outcome="hostFallback" if isinstance(
                        e, NotOffloadable) else "error")
                raise
            self._staging_attrs(dsp, snap, prepared[0])
            self._refresh_tier_gauges()
        overlap = self._dispatcher.busy_ms() - busy0
        if overlap > 0:
            self._dispatcher.observe("staging_overlap_ms", overlap)
        return prepared

    def _staging_snapshot(self, dsp):
        """The counters a traced staging diffs (None: no span, no cost)."""
        if dsp is None:
            return None
        return (time.perf_counter(), residency_mod.transfer_bytes(),
                self._metrics.meter("hbm_block_hit", labels=self._labels),
                self._metrics.meter("hbm_block_miss", labels=self._labels))

    def _staging_attrs(self, dsp, snap, launch) -> None:
        if dsp is None:
            return
        t0, xfer0, hits0, misses0 = snap
        dsp.end(stagingMs=round((time.perf_counter() - t0) * 1e3, 3),
                transferBytes=int(residency_mod.transfer_bytes() - xfer0),
                hbmBlockHits=int(self._metrics.meter(
                    "hbm_block_hit", labels=self._labels) - hits0),
                hbmBlockMisses=int(self._metrics.meter(
                    "hbm_block_miss", labels=self._labels) - misses0),
                S=int(launch.num_docs.shape[0]), D=int(launch.D))

    def _refresh_tier_gauges(self) -> None:
        """The staging levels' bytes (JAX `_refresh_tier_gauges` :2625):
        `hbm_cache_bytes`, the assembled blocks and the resident rows on
        the device; `host_row_cache_bytes`, the host rows. A mesh engine
        adds `hbm_cache_bytes{device=}` and `hbm_resident_bytes{device=}`
        per chip: a block's shards are equal, so a chip holds the blocks'
        share of the slots it fills, and its resident rows exactly."""
        self._metrics.set_gauge("hbm_cache_bytes",
                                self._cached + self._residency.bytes,
                                labels=self._labels)
        self._metrics.set_gauge("host_row_cache_bytes", self._host_bytes,
                                labels=self._labels)
        if self._mesh is None:
            return
        by_dev = self._residency.bytes_by_device()
        for chip in self._chips:
            lab = device_label(chip)
            slots = sum(1 for d in self._mesh.flat if d == chip)
            labels = dict(self._labels or {}, device=lab)
            self._metrics.set_gauge(
                "hbm_cache_bytes", self._cached * slots // self._mesh.size
                + by_dev.get(lab, 0), labels=labels)
            self._metrics.set_gauge("hbm_resident_bytes",
                                    by_dev.get(lab, 0), labels=labels)

    def _prepare_locked(self, segments, ctx: QueryContext, cancel_check):
        """_prepare's plan and stage; caller holds the engine lock."""
        if ctx.distinct:
            return self._prepare_agg(segments, ctx, cancel_check,
                                     distinct=True)
        if not ctx.aggregations:
            if self._doc_axis > 1:
                raise self._selection_refusal(ctx)
            return self._prepare_vector(segments, ctx, cancel_check) \
                if _is_vector(ctx) else \
                self._prepare_topn(segments, ctx, cancel_check)
        # the star-tree leg first: any fallback reason drops through to
        # the scan path
        return self._prepare_startree(segments, ctx, cancel_check) \
            or self._prepare_agg(segments, ctx, cancel_check)

    def _prepare_agg(self, segments, ctx: QueryContext, cancel_check,
                     distinct: bool = False):
        """An aggregation, or a DISTINCT as a presence-only group-by (ref
        DistinctOperator; JAX `_execute_distinct`), on K1-K3; caller
        holds the engine lock."""
        if distinct:
            ctx = _distinct_context(ctx)
        plan, slots_of_fn = self._plan(segments, ctx)
        self._tls.planned = time.perf_counter()
        minfo, why = self._merge_gate(segments, plan, ctx.table) \
            if self._mesh is not None and not distinct else (None, None)
        launch = self._launch(
            segments, ctx, plan, kernels.make_kernel(plan, self.value_dtype),
            cancel_check, "distinct" if distinct else "agg", minfo)
        if minfo is not None:
            self.meters[("mesh_merge_served", None)] += 1
        elif why is not None:
            self.meters[("mesh_merge_fallback", why)] += 1
        if distinct:
            return launch, lambda packed: self._assemble_distinct(
                segments, ctx, plan, packed)
        if minfo is not None:
            return launch, lambda packed: self._assemble_merged(
                segments, ctx, plan, packed, slots_of_fn, minfo)
        return launch, lambda packed: self._assemble(
            segments, ctx, plan, packed, slots_of_fn)

    def _prepare_topn(self, segments, ctx: QueryContext, cancel_check):
        """A selection as a per-segment top-K on K4 (JAX `_prepare_topn`);
        caller holds the engine lock."""
        plan = self._plan_topn(segments, ctx)
        self._tls.planned = time.perf_counter()
        launch = self._launch(
            segments, ctx, plan,
            kernels.make_topn_kernel(plan, self.value_dtype),
            cancel_check, "topn")
        return launch, lambda packed: self._assemble_topn(segments, ctx,
                                                          packed)

    def _prepare_startree(self, segments, ctx: QueryContext, cancel_check):
        """The star-tree leg on K5, or None with the fallback reason
        counted; caller holds the engine lock. Its launch coalesces as a
        scan's does (JAX :1034-1058): on (plan, padded S, D, 0, staged-array
        signature) where D is within DOC_BUCKET_MAX, else on the same
        segment batch; its column-set identity carries the fitted trees, so
        members that fit different trees of one segment stack rather than
        share a block."""
        st = self._plan_startree(segments, ctx)
        if st is None:
            return None
        plan, needed, fits = st
        self._tls.planned = time.perf_counter()
        vdt = self.value_dtype
        cols, params, num_docs, D = self._stage_startree(segments, ctx, plan,
                                                         fits)
        if self._mesh is None:
            kernel = startree_device.make_startree_kernel(plan, vdt)
            batched = startree_device.batched_kernel(plan, vdt)
        else:
            # a segments-only mesh (a doc-sharded one takes the scan leg,
            # `_startree_candidate`): K5 per slot over its segments' trees
            kernel = startree_device.sharded_kernel(plan, self._mesh, vdt)
            batched = startree_device.batched_sharded_kernel(plan,
                                                             self._mesh, vdt)
        batch_key = None
        if self._dispatcher.batch_max > 1:
            if self._cross_table and D <= DOC_BUCKET_MAX:
                batch_key = (plan, int(num_docs.shape[0]), D, 0,
                             _shape_sig(cols, params)) + self._mesh_sig()
            else:
                batch_key = (plan, _batch_key(segments), D, 0) \
                    + self._mesh_sig()
        launch = dispatch_mod.Launch(
            call=lambda: kernel(cols, params, num_docs, D),
            cols=cols, params=params, num_docs=num_docs, D=D,
            batch_key=batch_key, cols_key=(_batch_key(segments),
                                           tuple(f.ti for f in fits)),
            batched=batched, cancel_check=cancel_check,
            site_ctx={"table": ctx.table, "mode": "startree"},
            docs=sum(s.num_docs for s in segments))
        return launch, lambda packed: startree_device.assemble(
            segments, ctx, plan, needed, fits, packed)

    def _launch(self, segments, ctx: QueryContext, plan: DevicePlan, kernel,
                cancel_check, mode: str,
                minfo: Optional[dict] = None) -> dispatch_mod.Launch:
        """Stage a K1-K4 plan and wrap it for the ring, with its coalesce
        key: (plan, padded S, D, G, staged-array signature) for doc
        buckets up to DOC_BUCKET_MAX, so equal plans over other tables
        share it; the same segment batch only above (JAX :500-527). The
        plan's device program compiles here once per plan (cached), on the
        CPU too: a plan K1-K4 cannot run fails alike on either device, and
        the codegen odometer (`kernel_retrace`) counts each new plan. On a
        mesh the launch is the sharded kernel, or the merged one where
        `minfo` (`_merge_gate`) says the merge engages, and the mesh's
        shape, the merge and a grouped merge's remap ride the key (JAX
        :497-514 `mesh_sig`): launches never pair across differently
        sharded engines, merged with unmerged, or over two remaps."""
        program.compile_plan(plan)
        # the bitmaps' versions, read once: the mask block is staged under
        # them and the launch's column-set identity carries them (JAX
        # `_cols_key` :2261), so two coalesced members whose bitmaps moved
        # between their stagings keep a column set each instead of sharing
        # one member's mask
        stamps = _mask_stamps(segments) if plan.valid_mask else None
        cols, params, num_docs, D = self._stage(segments, ctx, plan, stamps)
        cols_key = _batch_key(segments) if stamps is None \
            else (_batch_key(segments), stamps)
        # a compact-key plan's G comes from its staging (the cached tables)
        # and rides the launch, the batched kernel and the coalesce key:
        # members coalesce only at equal G (JAX :500-527)
        G = self._compact_groups(segments, plan, int(num_docs.shape[0])) \
            if plan.group_compact else plan.num_groups
        gkw = {"G": G} if plan.group_compact else {}
        batched = kernels.batched_kernel(plan, self.value_dtype)
        mesh_sig: tuple = ()
        if self._mesh is not None:
            vdt, mesh = self.value_dtype, self._mesh
            if plan.mode == "topn":
                # a segments-only mesh: K4 per slot, the winners in
                # segment order (a top-K is per segment: no fold)
                kernel = kernels.sharded_topn_kernel(plan, mesh, vdt)
                batched = kernels.batched_sharded_topn_kernel(plan, mesh,
                                                              vdt)
            elif minfo is None:
                kernel = kernels.sharded_kernel(plan, mesh, vdt)
                batched = kernels.batched_sharded_kernel(plan, mesh, vdt)
            else:
                gkw = {}
                G, fold = minfo["G"], minfo["fold"]
                merged = collective.merged_kernel(plan, mesh, vdt)
                kernel = (lambda c, p, nd, d, _m=merged, _g=G, _f=fold:
                          _m(c, p, nd, d, _g, _f))
                batched = collective.batched_merged_kernel(plan, mesh, vdt,
                                                           G, fold)
            mesh_sig = self._mesh_sig(minfo is not None,
                                      id(minfo["fold"]) if minfo
                                      and plan.group_cols else None)
        if gkw:
            batched = functools.partial(batched, **gkw)
        batch_key = None
        if self._dispatcher.batch_max > 1:
            if self._cross_table and D <= DOC_BUCKET_MAX:
                batch_key = (plan, int(num_docs.shape[0]), D, G,
                             _shape_sig(cols, params)) + mesh_sig
            else:
                batch_key = (plan, _batch_key(segments), D, G) + mesh_sig
        return dispatch_mod.Launch(
            call=lambda: kernel(cols, params, num_docs, D, **gkw),
            cols=cols, params=params, num_docs=num_docs, D=D,
            batch_key=batch_key, cols_key=cols_key, batched=batched,
            cancel_check=cancel_check,
            site_ctx={"table": ctx.table, "mode": mode},
            docs=sum(s.num_docs for s in segments))

    # ------------------------------------------------------------------
    # collective merge (ops/collective.py; JAX :455-496, :529-656)
    # ------------------------------------------------------------------
    def _mesh_sig(self, merged: bool = False, remap=None) -> tuple:
        """The mesh's part of a coalesce key (JAX :497-514 `mesh_sig`): its
        shape and devices, the merge and a grouped merge's remap, so
        launches never pair across differently sharded engines, merged
        with unmerged, or over two remaps; () on one device."""
        if self._mesh is None:
            return ()
        return (("mesh", self._mesh.key, merged, remap),)

    def _merge_gate(self, segments, plan: DevicePlan, table: str):
        """(minfo, None) where the merge engages: an explicit mesh of more
        than one slot, the config key on, the `server.mesh.collective`
        failpoint unarmed (armed: reason 'chaos', JAX :461-471) and the
        gates of `_merged_prepare` passed; else (None, the reason an
        eligible launch keeps the per-segment sharded kernel and the host
        fold, JAX :536), or (None, None) where no merge is eligible. The
        caller counts it once the launch is staged: `mesh_merge_served`,
        or `mesh_merge_fallback{reason}`. Caller holds the engine lock."""
        if not self._explicit_mesh or self._mesh.size < 2:
            return None, None
        if not self._collective_merge:
            return None, "disabled"
        try:
            fire("server.mesh.collective", table=table, mode="agg")
        except Exception:  # noqa: BLE001 — armed chaos: the host fold
            return None, "chaos"
        S = self._padded_S(len(segments), self._padded_D(segments))
        try:
            return self._merged_prepare(segments, plan, S), None
        except _MergeFallback as e:
            return None, e.reason

    def _merged_prepare(self, segments, plan: DevicePlan, S: int) -> dict:
        """Gates and group keys of the merge (JAX `_merged_prepare` :545):
        {S, G, fold} ungrouped, and n_real and decode grouped; raises
        _MergeFallback(reason)."""
        if self.value_dtype == torch.float32:
            # merged counts and exact-sum halves add across segments: exact
            # in float32 only while the batch holds < 2^24 docs and < 4096
            # segments (the per-segment path needs it per segment)
            total = sum(int(seg.num_docs) for seg in segments)
            if total >= MAX_DOCS_PER_SEGMENT or len(segments) >= 4096:
                raise _MergeFallback("precision")
        if not plan.group_cols:
            return {"S": S, "G": 0,
                    "fold": collective.ungrouped_plan(plan, self._mesh, S)}
        fold, G_m, n_real, decode = self._merged_group_params(
            segments, plan, S)
        return {"S": S, "G": G_m, "fold": fold, "n_real": n_real,
                "decode": decode}

    def _merged_group_params(self, segments, plan: DevicePlan, S: int):
        """A global key space over the batch (JAX `_merged_group_params`
        :566): per group column the union of the segments' dictionary
        values, the mixed-radix strides over the union cardinalities, and
        the [S, G_local] map from each segment's local key to its global
        index (-1 for none: a dense key past the segment's cardinalities,
        a compact code past its table, a padded segment), turned into K9's
        lists (`collective.merged_plan`). Dense keys: the global key is the
        mixed-radix key itself. Compact keys (JAX :583-607): the sorted
        union of the key tuples the segments hold, numbered in order; each
        segment's table maps its codes to dictIds, its dictionary those to
        union indexes, whose mixed-radix keys sort as the value tuples do.
        Cached per (segment batch, plan, S); returns (fold, G pad, real
        group count, decode): (strides, cards, unions), plus the union's
        sorted keys for compact plans."""
        key = (_batch_key(segments), plan, S)
        ent = self._gmap_cache.get(key)
        if ent is not None and all(a is b for a, b in zip(ent[0], segments)):
            self._gmap_cache.move_to_end(key)
            return ent[1]
        G_local = self._compact_groups(segments, plan, S) \
            if plan.group_compact else plan.num_groups
        n_slots = max(len(plan.agg_ops), 1)
        if 16 * self._doc_axis * S * G_local > self.GMAP_MAX_BYTES:
            raise _MergeFallback("groups")
        unions, per_col = [], []
        for col in plan.group_cols:
            vals = []
            for seg in segments:
                card = max(int(seg.metadata.columns[col].cardinality), 1)
                vals.append(np.asarray(seg.data_source(col).dictionary
                                       .get_values(np.arange(card))))
            per_col.append(vals)
            unions.append(np.unique(np.concatenate(vals)))
        cards = [max(len(u), 1) for u in unions]
        prod = int(np.prod(cards, dtype=object))
        if prod > (MAX_DEVICE_GROUPS if not plan.group_compact
                   else 1 << 62):  # dense: G; compact: int64 keys
            raise _MergeFallback("groups")
        strides, st = [], prod
        for c in cards:
            st //= c
            strides.append(st)
        remap = np.full((S, G_local), -1, dtype=np.int64)
        decode: tuple = (tuple(strides), tuple(cards), tuple(unions))
        if plan.group_compact:
            seg_keys = []
            for s, seg in enumerate(segments):
                table = self._gkey_table(seg, plan)
                k = np.zeros(table.shape[0], dtype=np.int64)
                for ci, stride in enumerate(strides):
                    index = np.searchsorted(unions[ci], per_col[ci][s])
                    k += index[table[:, ci]].astype(np.int64) * stride
                seg_keys.append(k)
            ukeys = np.unique(np.concatenate(seg_keys))
            for s, k in enumerate(seg_keys):
                remap[s, :len(k)] = np.searchsorted(ukeys, k)
            n_real = len(ukeys)
            decode += (ukeys,)
        else:
            local = np.arange(G_local, dtype=np.int64)
            for s in range(len(segments)):
                g = np.zeros(G_local, dtype=np.int64)
                ok = np.ones(G_local, dtype=bool)
                rem = local
                for ci, lst in enumerate(plan.group_strides):
                    ids = rem // lst
                    rem = rem % lst
                    index = np.searchsorted(unions[ci], per_col[ci][s])
                    ok &= ids < len(index)
                    g += index[np.minimum(ids, len(index) - 1)] \
                        * strides[ci]
                remap[s] = np.where(ok, g, -1)
            n_real = prod
        G_m = _pow2(max(n_real, 1), floor=8)
        if G_m > MAX_DEVICE_GROUPS \
                or S * G_m * n_slots * 8 > MAX_GROUP_RESULT_BYTES:
            raise _MergeFallback("groups")
        fold = collective.merged_plan(plan, self._mesh, S, G_m, remap)
        out = (fold, G_m, n_real, decode)
        self._gmap_cache[key] = (tuple(segments), out)
        while len(self._gmap_cache) > self.GMAP_CACHE_ENTRIES:
            self._gmap_cache.popitem(last=False)
        return out

    # ------------------------------------------------------------------
    # vector-similarity leg (ops/vector_device.py)
    # ------------------------------------------------------------------
    def _mesh_refusal(self, mode: str, what: str) -> NotOffloadable:
        """Count a mode this slice does not shard (`mesh_refused{mode}`)
        and return the NotOffloadable, reason 'mesh', that refuses it."""
        self.meters[("mesh_refused", mode)] += 1
        where = "a doc-sharded mesh" if self._doc_axis > 1 \
            else "a segments-only mesh"
        return NotOffloadable(f"{what} on {where} (mesh)", reason="mesh")

    def _selection_refusal(self, ctx: QueryContext) -> NotOffloadable:
        """A selection on a doc-sharded mesh (a segments-only one runs it
        per slot): a vector search is JAX's 'staging' fallback (:963),
        counted as `vector_fallback`; a top-N across doc shards is JAX's
        host path (:1446), a mesh refusal."""
        if _is_vector(ctx):
            return self._vector_refusal(
                "staging", "vector blocks on a doc-sharded mesh")
        return self._mesh_refusal("topn", "a selection (top-N)")

    def _vector_refusal(self, reason: str, what: str,
                        meter: bool = True) -> NotOffloadable:
        """Count a vector query's fallback reason (JAX `_vector_fallback`
        :727) and return the NotOffloadable that carries it."""
        if meter:
            self.meters[("vector_fallback", reason)] += 1
        return NotOffloadable(f"vector similarity: {what} ({reason})",
                              reason=reason)

    def _plan_vector(self, segments, ctx: QueryContext, meter: bool = True):
        """(vector plan, (vector fn, query vector, K), residual context) of
        a vector_similarity selection (JAX `_plan_vector` :737); raises
        NotOffloadable with the JAX fallback reason. The residual context
        carries the non-vector conjuncts only: staging walks the leaves of
        exactly the tree the plan's leaves were built from."""
        def refuse(reason, what):
            return self._vector_refusal(reason, what, meter)
        if not self._vector_enabled:
            raise refuse("disabled", "pinot.server.vector.enabled is off")
        fn, residual, reason = vector_device.split_filter(ctx.filter)
        if fn is None:
            raise refuse(reason, f"filter {ctx.filter}")
        if ctx.order_by:
            # score order is the kernel's; an ORDER BY on top would need a
            # second sort the leg does not do
            raise refuse("hybrid", "ORDER BY")
        try:
            col, qvec, k = vector_device.parse_args(fn)
        except (ValueError, TypeError):
            raise refuse("hybrid", f"arguments of {fn}") from None
        shape, reason = vector_device.admit(segments, col, qvec, k,
                                            TOPN_MAX_K)
        if shape is None:
            raise refuse(reason, f"column {col}, K {k}")
        dim_pad, ivf, cells_pad = shape
        classify, dict_cols, raw_cols = self._make_classifier(segments[0])
        leaves: List[DeviceLeaf] = []
        filter_ir = None
        if residual is not None:
            try:
                if self._filter_missing(residual) is not None:
                    raise NotOffloadable(str(residual),
                                         reason="filterExpression")
                filter_ir = self._build_filter_ir(residual, segments, leaves,
                                                  classify)
            except NotOffloadable:
                raise refuse("hybrid", f"residual {residual}") from None
        raw64 = {lf.column for lf in leaves if lf.kind == "vrange64"}
        plan = DevicePlan(
            filter_ir=filter_ir, leaves=tuple(leaves), value_irs=(),
            agg_ops=(), dict_cols=tuple(sorted(dict_cols)),
            raw_cols=tuple(sorted(raw_cols - raw64)),
            raw64_cols=tuple(sorted(raw64)), mode="vector",
            valid_mask=_needs_valid_mask(segments),
            clp_cols=clp_device.staged_cols(leaves), vec_col=col,
            dim_pad=dim_pad, k_pad=vector_device._pow2(k), ivf=ivf,
            cells_pad=cells_pad)
        rctx = QueryContext(
            table=ctx.table, select=ctx.select, aliases=ctx.aliases,
            distinct=False, filter=residual, group_by=[], having=None,
            order_by=[], limit=ctx.limit, offset=ctx.offset,
            options=ctx.options)
        return plan, (fn, qvec, k), rctx

    def _stage_vector(self, segments, rctx: QueryContext, plan: DevicePlan,
                      fn, qvec, k, stamps: Optional[tuple]):
        """The residual filter's blocks and parameters through `_stage`,
        the vector block and IVF cells as `__vec__/<col>/block` and
        `__vec__/<col>/cells` rows through the staging levels (JAX
        `_vec_block_locked` :828: each row padded to its segment's own
        doc bucket, times dim_pad for the block, so every batch
        composition shares the rows; K6 assembles a block on a miss;
        resident rows under pinot.server.vector.hbm.resident), and the
        query vector, K and probe cells through the params cache under the
        vector function's own key (JAX :811), so two queries sharing a
        residual but not a vector never alias; beside them, on the host,
        each row's candidate count ('vq:nc', which sizes K8's lists)."""
        cols, params, num_docs, D = self._stage(segments, rctx, plan, stamps)
        S = int(num_docs.shape[0])
        dp, col, n = plan.dim_pad, plan.vec_col, len(segments)
        cols["vec:" + col] = self._cached_block(
            segments, S, D * dp, "vector", (col, "block"),
            [f"__vec__/{col}/block"] * n,
            [lambda seg: vector_device.vector_row(seg, col, dp,
                                                  _pow2(seg.num_docs))] * n,
            np.float32, resident=self._vector_resident,
            pads=[_pow2(seg.num_docs) * dp for seg in segments])
        if plan.ivf:
            cols["vcell:" + col] = self._cached_block(
                segments, S, D, "vector", (col, "cells"),
                [f"__vec__/{col}/cells"] * n,
                [lambda seg: vector_device.cell_row(
                    seg, col, _pow2(seg.num_docs))] * n,
                np.int32, resident=self._vector_resident)
        pkey = (_batch_key(segments), plan, fn, "__vec__", S)
        hit = self._params_cache.get(pkey)
        if hit is not None and all(a is b for a, b in zip(hit[0], segments)):
            self._params_cache.move_to_end(pkey)
            params.update(hit[1])
            return cols, params, num_docs, D
        host = vector_device.query_params(segments, plan, qvec, k, S)
        vparams = {key: self._upload(arr) for key, arr in host.items()}
        # K8's bound on a row's candidates stays on the host
        vparams["vq:nc"] = torch.from_numpy(vector_device.candidate_counts(
            segments, plan, host.get("vq:cells"), S))
        params.update(vparams)
        self._params_cache[pkey] = (tuple(segments), vparams, num_docs)
        while len(self._params_cache) > self.PARAMS_CACHE_ENTRIES:
            self._params_cache.popitem(last=False)
        return cols, params, num_docs, D

    def _prepare_vector(self, segments, ctx: QueryContext, cancel_check):
        """A vector_similarity selection on K8 (JAX `_prepare_vector`
        :892); caller holds the engine lock. The launch coalesces on JAX's
        key (:934-942): (plan, padded S, D, 0, staged-array signature)
        for doc buckets up to DOC_BUCKET_MAX, else the same segment batch,
        so concurrent queries of one plan with other vectors make one
        launch on K8's member axis."""
        plan, (fn, qvec, k), rctx = self._plan_vector(segments, ctx)
        self._tls.planned = time.perf_counter()
        program.compile_plan(plan)
        stamps = _mask_stamps(segments) if plan.valid_mask else None
        try:
            cols, params, num_docs, D = self._stage_vector(
                segments, rctx, plan, fn, qvec, k, stamps)
        except NotOffloadable as e:
            raise self._vector_refusal("staging", str(e)) from None
        self.meters[("vector_served", None)] += 1
        if self._mesh is None:
            kernel = kernels.make_vector_kernel(plan)
            batched = kernels.batched_kernel(plan)
        else:
            # a segments-only mesh: K8 per slot, the winners in segment
            # order on the lead
            kernel = kernels.sharded_topn_kernel(plan, self._mesh)
            batched = kernels.batched_sharded_topn_kernel(plan, self._mesh)
        batch_key = None
        if self._dispatcher.batch_max > 1:
            if self._cross_table and D <= DOC_BUCKET_MAX:
                batch_key = (plan, int(num_docs.shape[0]), D, 0,
                             _shape_sig(cols, params)) + self._mesh_sig()
            else:
                batch_key = (plan, _batch_key(segments), D, 0) \
                    + self._mesh_sig()
        launch = dispatch_mod.Launch(
            call=lambda: kernel(cols, params, num_docs, D),
            cols=cols, params=params, num_docs=num_docs, D=D,
            batch_key=batch_key,
            cols_key=_batch_key(segments) if stamps is None
            else (_batch_key(segments), stamps),
            batched=batched, cancel_check=cancel_check,
            site_ctx={"table": ctx.table, "mode": "vector"},
            docs=sum(s.num_docs for s in segments))
        return launch, lambda packed: vector_device.assemble(
            segments, ctx, plan, packed, len(segments))

    def filtered_doc_ids(self, segments, filter_expr
                         ) -> List[Optional[np.ndarray]]:
        """The doc ids a filter keeps, per segment, for the MSE leaf's
        scans (JAX `filtered_doc_ids` :1749, ref QueryRunner.java:258): K4
        with the filter and k = TOPN_MAX_K gives the first TOPN_MAX_K
        matching docs of each segment, sorted int64; None for a segment
        with more matches, and for every segment where the engine refuses
        the filter. The launch rides the ring with K4's coalesce key, so
        concurrent leaf scans of one plan make one batched K4 launch. On a
        segments-only mesh K4 runs per slot (a segment's doc ids are its
        own on every slot); a doc-sharded mesh raises NotOffloadable,
        reason 'mesh', where JAX returns no ids (:1758)."""
        nothing: List[Optional[np.ndarray]] = [None] * len(segments)
        if self._doc_axis > 1:
            raise self._mesh_refusal("doc_ids", "the MSE leaf's doc ids")
        if not segments or filter_expr is None \
                or self._filter_missing(filter_expr) is not None:
            return nothing
        ctx = QueryContext(
            table="", select=[], aliases=[], distinct=False,
            filter=filter_expr, group_by=[], having=None, order_by=[],
            limit=TOPN_MAX_K, offset=0, options={})
        with self._dispatcher.active():
            try:
                with self._engine_lock:
                    plan = self._plan_topn(segments, ctx)
                    launch = self._launch(
                        segments, ctx, plan,
                        kernels.make_topn_kernel(plan, self.value_dtype),
                        None, "doc_ids")
                    self._refresh_tier_gauges()
            except NotOffloadable:
                return nothing
            packed = dispatch_mod.wait_result(
                self._dispatcher.submit(launch),
                max_wait_s=self.LAUNCH_WAIT_CAP_S)
        out: List[Optional[np.ndarray]] = []
        for s, seg in enumerate(segments):
            if int(packed[s, 0]) > plan.topn_k:
                out.append(None)  # more matches than K
                continue
            idx = packed[s, 1:]
            out.append(np.sort(idx[(idx >= 0) & (idx < seg.num_docs)]
                               .astype(np.int64)))
        return out

    @staticmethod
    def _make_classifier(seg0):
        """Column stagability test; records dict/raw membership as a side
        effect (ids serve filters / group-by whatever the value type; value
        math additionally needs numeric values)."""
        dict_cols: set = set()
        raw_cols: set = set()

        def classify(col: str) -> bool:
            if not seg0.has_column(col):
                return False
            m = seg0.metadata.columns[col]
            if not m.single_value:
                return False
            if m.has_dictionary:
                dict_cols.add(col)
                return True
            if m.data_type.np_dtype.kind in "iuf":
                raw_cols.add(col)
                return True
            return False

        return classify, dict_cols, raw_cols

    def _plan(self, segments, ctx: QueryContext):
        """Build the DevicePlan from the query + first segment's schema."""
        seg0 = segments[0]
        classify, dict_cols, raw_cols = self._make_classifier(seg0)
        value_irs: List[tuple] = []
        ir_index: Dict[tuple, int] = {}

        def intern_ir(ir: Optional[tuple]) -> Optional[int]:
            if ir is None:
                return None
            if ir not in ir_index:
                ir_index[ir] = len(value_irs)
                value_irs.append(ir)
            return ir_index[ir]

        def check_value_cols(ir) -> bool:
            if ir[0] == "col":
                col = ir[1]
                if col in raw64 or not classify(col):
                    return False  # split-plane columns have no value block
                m = seg0.metadata.columns[col]
                return m.data_type.np_dtype.kind in "iuf"
            if ir[0] == "lit":
                return True
            return all(check_value_cols(c) for c in ir[1:]
                       if isinstance(c, tuple))

        hll_cols = self._hll_columns(segments, ctx)
        # the fused time bucket: a leading floor((t - start) / step) over a
        # bounded t window (missing_feature admitted the shape). Its
        # timestamp stages only as split planes, so its raw range leaves
        # are vrange64 in either value dtype (exact below 2^55)
        tb_spec = None
        if ctx.group_by and not isinstance(ctx.group_by[0], Identifier):
            if self._explicit_mesh:
                # the JAX engine serves the fused bucket on its implicit
                # segments-only mesh, not on an explicit one (:282-292)
                raise self._mesh_refusal("tbucket", "a time bucket")
            tb_spec = timeseries_device.plan_bucket(ctx.group_by[0],
                                                    ctx.filter, segments)
            if tb_spec is None:
                raise NotOffloadable(
                    f"time bucket {ctx.group_by[0]} without a bounded "
                    "window at or after its start on an int timestamp "
                    "below 2^55", reason="timeBucket")
        force64 = hll_cols | ({tb_spec.col} if tb_spec else set())
        # filter IR first: leaves fill in build order, so the main filter's
        # leaves precede agg-filter leaves (staging resolves in this order)
        leaves: List[DeviceLeaf] = []
        filter_ir = None
        if ctx.filter is not None:
            filter_ir = self._build_filter_ir(ctx.filter, segments, leaves,
                                              classify, force64)
        agg_filter_irs: List[tuple] = []
        fidx_of_filter: Dict[Expression, int] = {}
        agg_fidx: List[Optional[int]] = []
        for f in ctx.agg_filters:
            if f is None:
                agg_fidx.append(None)
                continue
            if f not in fidx_of_filter:
                fidx_of_filter[f] = len(agg_filter_irs)
                agg_filter_irs.append(self._build_filter_ir(
                    f, segments, leaves, classify, force64))
            agg_fidx.append(fidx_of_filter[f])
        # split-plane columns: big-int filter columns, HLL inputs and the
        # time bucket's timestamp; they carry no 'val:' block, so no value
        # IR can read them
        raw64 = {lf.column for lf in leaves
                 if lf.kind == "vrange64"} | force64

        agg_ops: List[Tuple[str, Optional[int], Optional[int]]] = []
        slot_index: Dict[Tuple[str, Optional[int], Optional[int]], int] = {}
        slots_of_fn: List[Dict[str, int]] = []

        def slot(key) -> int:
            if key not in slot_index:
                slot_index[key] = len(agg_ops)
                agg_ops.append(key)
            return slot_index[key]

        for i, (node, fn) in enumerate(zip(ctx.aggregations,
                                           ctx.agg_functions)):
            is_hll = any(op.startswith("hll:") for op in fn.device_spec.ops)
            arg_ir = None
            if not is_hll and node.args \
                    and not (isinstance(node.args[0], Identifier)
                             and node.args[0].name == "*"):
                arg_ir = self._value_ir_shape(node.args[0])
                if arg_ir is None or not check_value_cols(arg_ir):
                    raise NotOffloadable(
                        f"aggregation input {node.args[0]} has no numeric "
                        "device block", reason="aggregationInput")
            vidx = intern_ir(arg_ir)
            fidx = agg_fidx[i]
            # bit-exact SUM for int inputs under f32 staging: the slot
            # becomes 'isum' (6-bit signed planes) or 'isum:uN' (7-bit
            # unsigned planes); _assemble rebuilds the scalar. Grouped sums
            # stay in the value dtype, as on the JAX engine.
            int_bounds = None
            if not ctx.group_by and arg_ir is not None \
                    and self.value_dtype == torch.float32:
                int_bounds = self._int_ir_bounds(segments, arg_ir)
            mapping = {}
            for op in fn.device_spec.ops:
                if op == "sum" and int_bounds is not None:
                    lo_b, hi_b = int_bounds
                    if lo_b >= 0:
                        planes = max(1, (max(hi_b, 1).bit_length() + 6) // 7)
                        op_key = f"isum:u{planes}"
                    else:
                        op_key = "isum"
                    mapping[op] = slot((op_key, vidx, fidx))
                elif op.startswith("hll:"):
                    # the column rides in the op key: K3 reads its split
                    # planes directly, through no value IR
                    mapping[op] = slot((f"{op}:{node.args[0].name}", None,
                                        fidx))
                elif op == "count":
                    mapping[op] = slot(("count", None, fidx))
                else:
                    if vidx is None:
                        raise NotOffloadable(f"{op} over COUNT(*) input",
                                             reason="aggregationInput")
                    mapping[op] = slot((op, vidx, fidx))
            slots_of_fn.append(mapping)

        group_cols: List[str] = []
        group_strides: List[int] = []
        num_groups = 0
        group_compact = False
        tbucket: Tuple = ()
        if ctx.group_by:
            gb = list(ctx.group_by)
            if tb_spec is not None:
                tbucket = (tb_spec.col, tb_spec.count_pad)
                gb = gb[1:]
            card_pads = []
            for g in gb:
                col = g.name  # Identifier, checked in missing_feature
                if not classify(col) or \
                        not seg0.metadata.columns[col].has_dictionary:
                    # the JAX planner sends it to its host executor (:1672)
                    raise NotOffloadable(
                        f"group-by on raw column {col} (no dictionary)",
                        reason="rawGroupBy")
                card = max(seg.metadata.columns[col].cardinality
                           for seg in segments)
                group_cols.append(col)
                card_pads.append(max(card, 1))
            # the bucket is the key's lowest digit: count_pad seeds the
            # mixed radix ahead of the tag cardinalities
            num_groups = int(np.prod(card_pads, dtype=object)) \
                * (tb_spec.count_pad if tb_spec else 1)
            if tb_spec is not None and num_groups > MAX_DEVICE_GROUPS:
                # compact keys cannot carry the fused bucket digit: the
                # JAX planner sends such a panel to its host (:1684-1687)
                raise NotOffloadable(
                    f"{num_groups} dense group keys (above "
                    f"{MAX_DEVICE_GROUPS}; compact keys never carry a time "
                    "bucket)", reason="groups")
            if num_groups > MAX_DEVICE_GROUPS:
                # a sparse key space: per-segment codes over the key
                # tuples present replace the dense product (JAX
                # :1688-1694); their count G is resolved at staging
                group_compact = True
                num_groups = 0
            else:
                n_slots = len(agg_ops) + 1  # +1 guaranteed count slot
                if len(segments) * num_groups * n_slots * 8 \
                        > MAX_GROUP_RESULT_BYTES:
                    raise NotOffloadable(
                        "group-by result above the device cap",
                        reason="groups")
                stride = num_groups
                for c in card_pads:
                    stride //= c
                    group_strides.append(stride)
            # group-by always needs an unfiltered count slot to detect
            # present groups
            slot(("count", None, None))
        if group_compact:
            # the gkey block replaces the id blocks of the columns only
            # the group-by reads (JAX :1723-1729)
            needed = {lf.column for lf in leaves}
            for ir in value_irs:
                needed |= _ir_cols(ir)
            dict_cols -= set(group_cols) - needed

        plan = DevicePlan(
            filter_ir=filter_ir,
            leaves=tuple(leaves),
            value_irs=tuple(value_irs),
            agg_ops=tuple(agg_ops),
            agg_filter_irs=tuple(agg_filter_irs),
            group_cols=tuple(group_cols),
            group_strides=tuple(group_strides),
            num_groups=num_groups,
            group_compact=group_compact,
            dict_cols=tuple(sorted(dict_cols)),
            raw_cols=tuple(sorted(raw_cols - raw64)),
            raw64_cols=tuple(sorted(raw64)),
            valid_mask=_needs_valid_mask(segments),
            tbucket=tbucket,
            clp_cols=clp_device.staged_cols(leaves),
        )
        return plan, slots_of_fn

    def _plan_topn(self, segments, ctx: QueryContext) -> DevicePlan:
        """DevicePlan for selection / single-key order-by top-K (JAX
        `_plan_topn`); raises NotOffloadable where the JAX engine would
        hand the query to its host executor."""
        seg0 = segments[0]
        classify, dict_cols, raw_cols = self._make_classifier(seg0)
        leaves: List[DeviceLeaf] = []
        filter_ir = None
        if ctx.filter is not None:
            filter_ir = self._build_filter_ir(ctx.filter, segments, leaves,
                                              classify)
        raw64 = {lf.column for lf in leaves if lf.kind == "vrange64"}

        value_irs: Tuple[tuple, ...] = ()
        topn_asc = True
        if ctx.order_by:
            e, topn_asc = ctx.order_by[0]
            if isinstance(e, Identifier):
                if not classify(e.name):
                    raise NotOffloadable(f"ORDER BY {e.name} with no "
                                         "device block", reason="orderBy")
                if seg0.metadata.columns[e.name].has_dictionary:
                    # dictionaries are value-sorted: dictId order IS value
                    # order, and ids stay exact in f32 below 2^24
                    if max(s.metadata.columns[e.name].cardinality
                           for s in segments) >= (1 << 24):
                        raise NotOffloadable(
                            f"ORDER BY {e.name} with 2^24 or more "
                            "dictionary ids", reason="orderBy")
                    ir = ("ids", e.name)
                elif e.name in raw64:
                    raise NotOffloadable(f"ORDER BY {e.name}, a raw64 "
                                         "split-plane column",
                                         reason="orderBy")
                else:
                    ir = ("col", e.name)
            else:
                ir = self._value_ir_shape(e)
                if ir is None:
                    raise NotOffloadable(f"ORDER BY {e} (expressions)",
                                         reason="orderBy")
                for col in _ir_cols(ir):
                    if col in raw64 or not classify(col) \
                            or seg0.metadata.columns[col].data_type \
                            .np_dtype.kind not in "iuf":
                        raise NotOffloadable(
                            f"ORDER BY {e}: {col} has no numeric device "
                            "block", reason="orderBy")
            value_irs = (ir,)

        return DevicePlan(
            filter_ir=filter_ir,
            leaves=tuple(leaves),
            value_irs=value_irs,
            agg_ops=(),
            dict_cols=tuple(sorted(dict_cols)),
            raw_cols=tuple(sorted(raw_cols - raw64)),
            raw64_cols=tuple(sorted(raw64)),
            mode="topn", topn_k=ctx.limit + ctx.offset,
            topn_asc=bool(topn_asc), valid_mask=_needs_valid_mask(segments),
            clp_cols=clp_device.staged_cols(leaves))

    @staticmethod
    def _hll_columns(segments, ctx: QueryContext) -> set:
        """The columns DISTINCTCOUNTHLL hashes on the device: single-value
        int columns with |min|, |max| < 2^55 in every segment, staged as
        (hi, lo) i32 split planes (the hi plane would wrap beyond, where
        the host sketch folds the lost bits in). Raises NotOffloadable
        naming what a column lacks."""
        out = set()
        for node, fn in zip(ctx.aggregations, ctx.agg_functions):
            ops = [op for op in fn.device_spec.ops if op.startswith("hll:")]
            if not ops:
                continue
            lo_m, hi_m = program.HLL_LOG2M_RANGE
            log2m = int(ops[0].split(":")[1])
            if not lo_m <= log2m <= hi_m:
                raise NotOffloadable(f"DISTINCTCOUNTHLL log2m {log2m} "
                                     f"outside [{lo_m}, {hi_m}]", reason="hll")
            col = node.args[0].name
            for seg in segments:
                m = seg.metadata.columns.get(col)
                if m is None or not m.single_value \
                        or m.data_type.np_dtype.kind not in "iu":
                    raise NotOffloadable(
                        f"DISTINCTCOUNTHLL over {col}, not a single-value "
                        "int column (device HLL hashes int split planes)",
                        reason="hll")
                if m.min_value is None or m.max_value is None:
                    raise NotOffloadable(
                        f"DISTINCTCOUNTHLL over {col} without min/max",
                        reason="hll")
                if max(abs(int(m.min_value)),
                       abs(int(m.max_value))) >= (1 << 55):
                    raise NotOffloadable(
                        f"DISTINCTCOUNTHLL over {col} with huge longs "
                        "(|v| >= 2^55)", reason="hll")
            out.add(col)
        return out

    def _build_filter_ir(self, e: Function, segments, leaves, classify,
                         force64: set = frozenset()):
        """force64: raw int columns staged only as split planes (HLL
        inputs), whose range leaves must be vrange64."""
        if e.name in ("and", "or"):
            return (e.name, *(self._build_filter_ir(a, segments, leaves,
                                                    classify, force64)
                              for a in e.args))
        if e.name == "not":
            return ("not", self._build_filter_ir(e.args[0], segments,
                                                 leaves, classify, force64))
        col = e.args[0].name
        if clp_device.is_clp_column(segments[0], col):
            # a CLP log column has no id or value block: LIKE / regex push
            # down through their own leaf kind, against its pseudo-columns
            leaves.append(self._clp_leaf(e, segments, col))
            return ("leaf", len(leaves) - 1)
        if not classify(col):
            raise NotOffloadable(f"filter on column {col} with no device "
                                 "block", reason="filterColumn")
        m = segments[0].metadata.columns[col]
        if m.has_dictionary:
            if e.name in _LEAF_RANGE_FUNCS:
                kind = "range"
            elif e.name == "not_equals":
                kind = "neq"
            else:
                kind = "lut"
        else:
            if e.name not in _LEAF_RANGE_FUNCS:
                raise NotOffloadable(f"{e.name} on raw column {col}",
                                     reason="rawFilter")
            if col in force64:
                kind = "vrange64"
            elif m.data_type.np_dtype.kind in "iu" \
                    and self.value_dtype == torch.float32:
                kind = self._int_filter_kind(segments, col)
            else:
                kind = "vrange"
        leaves.append(DeviceLeaf(kind, col))
        return ("leaf", len(leaves) - 1)

    def _clp_fallback(self, reason: str, what: str):
        """Count a CLP pattern's fallback reason (JAX `_clp_fallback` :694)
        and return the NotOffloadable that carries it."""
        self.meters[("clp_fallback", reason)] += 1
        return NotOffloadable(f"{what} over a CLP column ({reason})",
                              reason=reason)

    def _clp_leaf(self, e: Function, segments, col: str) -> DeviceLeaf:
        """The 'clp' DeviceLeaf of a LIKE / REGEXP_LIKE over CLP column
        `col` (JAX `_clp_leaf` :704). The pattern stays out of the leaf:
        its constants resolve at staging, so queries whose patterns differ
        share one program."""
        if e.name not in ("like", "regexp_like") or len(e.args) != 2 \
                or not isinstance(e.args[1], Literal):
            raise self._clp_fallback("predicate", f"filter {e}")
        pattern = str(e.args[1].value)
        meta, reason = clp_device.plan_leaf(segments, col, pattern,
                                            e.name == "like")
        if meta is None:
            raise self._clp_fallback(reason, f"{e.name} {pattern!r}")
        return DeviceLeaf("clp", col, meta)

    @staticmethod
    def _int_filter_kind(segments, col: str) -> str:
        """Staging for a raw int filter column under float32 values:
        'vrange' for |v| <= 2^24 (exact in f32), 'vrange64' for |v| < 2^55
        (exact via (hi, lo) i32 split planes)."""
        big = False
        for seg in segments:
            m = seg.metadata.columns.get(col)
            if m is None or m.min_value is None or m.max_value is None:
                raise NotOffloadable(f"raw column {col} without min/max",
                                     reason="rawRange")
            peak = max(abs(int(m.min_value)), abs(int(m.max_value)))
            if peak >= (1 << 55):
                raise NotOffloadable(f"raw column {col} beyond 2^55",
                                     reason="rawRange")
            if peak > (1 << 24):
                big = True
        return "vrange64" if big else "vrange"

    @staticmethod
    def _int_ir_bounds(segments, ir) -> Optional[Tuple[int, int]]:
        """Interval bounds of an int-valued value IR over the batch's
        metadata, or None when any column is non-int / unbounded or any
        node (incl. intermediates) can overflow i32 — the admission test
        for the exact isum slots."""
        LIM = (1 << 31) - 1

        def clamp(bounds):
            return bounds if -LIM <= bounds[0] and bounds[1] <= LIM else None

        def rec(node) -> Optional[Tuple[int, int]]:
            op = node[0]
            if op == "col":
                lo = hi = None
                for seg in segments:
                    m = seg.metadata.columns.get(node[1])
                    if m is None or m.data_type.np_dtype.kind not in "iu" \
                            or m.min_value is None or m.max_value is None:
                        return None
                    lo = int(m.min_value) if lo is None \
                        else min(lo, int(m.min_value))
                    hi = int(m.max_value) if hi is None \
                        else max(hi, int(m.max_value))
                return (lo, hi) if lo is not None else None
            if op == "lit":
                v = float(node[1])
                return clamp((int(v), int(v))) if v.is_integer() else None
            if op == "neg":
                a = rec(node[1])
                return None if a is None else clamp((-a[1], -a[0]))
            if op not in ("add", "sub", "mul"):
                return None
            a, b = rec(node[1]), rec(node[2])
            if a is None or b is None:
                return None
            if op == "add":
                return clamp((a[0] + b[0], a[1] + b[1]))
            if op == "sub":
                return clamp((a[0] - b[1], a[1] - b[0]))
            corners = [x * y for x in a for y in b]
            return clamp((min(corners), max(corners)))

        return rec(ir)

    # ------------------------------------------------------------------
    # staging
    # ------------------------------------------------------------------
    def _padded_S(self, S_real: int, D: int) -> int:
        """The segment axis: a power of two where cross-table coalescing
        is on and D is within DOC_BUCKET_MAX, so equal plans over other
        tables land in one shape bucket (padded segments carry num_docs 0
        and zero rows, which every kernel reads as empty); else S_real.
        Then rounded up to the mesh's segment multiple (JAX `_padded_S`
        :1963)."""
        S = _pow2(S_real, floor=1) \
            if self._cross_table and D <= DOC_BUCKET_MAX else S_real
        if self._mesh is not None:
            n = self._mesh.shape[0]
            S = -(-S // n) * n
        return S

    def _padded_D(self, segments) -> int:
        """The doc bucket: the power of two of the largest segment, rounded
        up so the doc slices of a mesh tile it evenly (JAX `_padded_D`
        :1979)."""
        D = _pow2(max(s.num_docs for s in segments))
        return -(-D // self._doc_axis) * self._doc_axis

    def _stage(self, segments, ctx: QueryContext, plan: DevicePlan,
               stamps: Optional[tuple] = None):
        """The launch's column blocks, parameters, num_docs and D. stamps:
        the versions of the batch's validity bitmaps to stage the mask
        under (read here when not given)."""
        if max(s.num_docs for s in segments) > MAX_DOCS_PER_SEGMENT:
            raise NotOffloadable(
                f"segment above {MAX_DOCS_PER_SEGMENT} docs",
                reason="segmentSize")
        D = self._padded_D(segments)
        S = self._padded_S(len(segments), D)
        vdt = self._vdt
        cols: Dict[str, torch.Tensor] = {}
        if plan.group_compact:
            # the key codes first: G's caps raise before any upload (JAX
            # :2378-2382), and the codes ride the three levels as a column
            # (a host-row miss factorizes)
            self._compact_groups(segments, plan, S)
            sig = ",".join(plan.group_cols)
            cols["gkey"] = self._cached_block(
                segments, S, D, "gkey", sig, [sig] * len(segments),
                [lambda seg: factorize_keys(seg, plan.group_cols)[0]]
                * len(segments), np.int32)
        for col in plan.dict_cols:
            # cardinality-aware id width: bytes read are the bound, so an
            # 11-value dictionary column reads 4x fewer bytes as i8
            card = max(s.metadata.columns[col].cardinality for s in segments)
            idt = np.int8 if card <= 127 else \
                np.int16 if card <= 32767 else np.int32
            cols["ids:" + col] = self._block(
                segments, S, D, col, "ids",
                lambda ds, _t=idt: ds.dict_ids().astype(_t), idt)
        for col in plan.raw_cols:
            self._check_value_precision(segments, col)
            cols["val:" + col] = self._block(
                segments, S, D, col, "val",
                lambda ds: ds.values().astype(vdt), vdt)
        for col in plan.raw64_cols:
            cols["valhi:" + col] = self._block(
                segments, S, D, col, "valhi",
                lambda ds: (ds.values().astype(np.int64) >> 24
                            ).astype(np.int32), np.int32)
            cols["vallo:" + col] = self._block(
                segments, S, D, col, "vallo",
                lambda ds: (ds.values().astype(np.int64) & 0xFFFFFF
                            ).astype(np.int32), np.int32)
        # value columns of dictionary columns stage MATERIALIZED values
        # (the dictionary take happens on the host, once per block)
        value_cols = set()
        for ir in plan.value_irs:
            value_cols |= _ir_cols(ir)
        for col in sorted(value_cols & set(plan.dict_cols)):
            self._check_value_precision(segments, col)

            def fetch_values(ds):
                vals = ds.values()
                if vals.dtype.kind not in "iuf":
                    raise NotOffloadable(f"non-numeric values of {col}",
                                         reason="values")
                return vals.astype(vdt)
            cols["val:" + col] = self._block(segments, S, D, col, "val",
                                             fetch_values, vdt)
        for col, kd, ke in plan.clp_cols:
            # a CLP column's pseudo-columns (JAX :2038-2071): the logtype
            # id, kd dict-var slot ids, ke encoded-var (hi, lo) planes
            fetches = [("clpid", clp_device.row_ids)]
            fetches += [(f"clpdv{j}", lambda r, _j=j:
                         clp_device.row_dict_slot(r, _j)) for j in range(kd)]
            for j in range(ke):
                fetches += [(f"clpehi{j}", lambda r, _j=j:
                             clp_device.row_enc_hi(r, _j)),
                            (f"clpelo{j}", lambda r, _j=j:
                             clp_device.row_enc_lo(r, _j))]
            for kind, fn in fetches:
                cols[f"{kind}:{col}"] = self._block(
                    segments, S, D, col, kind,
                    lambda ds, _fn=fn: _fn(self._clp_reader(ds)), np.int32)
        if plan.valid_mask:
            cols["vmask"] = self._stage_vmask(
                segments, S, D, stamps or _mask_stamps(segments))
        if plan.tbucket:
            self.meters[("timeseries_leaf_device", None)] += 1
        if plan.clp_cols:
            self.meters[("clp_served", None)] += 1
        # the per-query parameters through the params cache (JAX :2101-2117;
        # filters are frozen expression trees, so they key the resolved
        # literals exactly): a repeat query resolves and uploads nothing.
        # The group-by joins the key where it carries the bucket: the same
        # filter under another bucket expression must not alias
        pkey = (_batch_key(segments), plan, ctx.filter,
                tuple(ctx.agg_filters), S,
                tuple(ctx.group_by) if plan.tbucket else None)
        hit = self._params_cache.get(pkey)
        if hit is not None and all(a is b for a, b in zip(hit[0], segments)):
            self._params_cache.move_to_end(pkey)
            return cols, dict(hit[1]), hit[2], D
        params = self._leaf_params(segments, ctx, plan, S)
        if plan.tbucket:
            # the fused bucket's cells: the only thing a sliding window
            # changes (start moves; count_pad stays the plan's)
            spec = timeseries_device.plan_bucket(ctx.group_by[0], ctx.filter,
                                                 segments)
            if spec is None or spec.count_pad != plan.tbucket[1]:
                raise NotOffloadable(f"time bucket {ctx.group_by[0]}",
                                     reason="timeBucket")
            for key, arr in timeseries_device.leaf_params(spec, S).items():
                params[key] = self._upload(arr)
        # histogram slots: bucket bounds from the batch's metadata; B / span
        # in Python double, rounded once to the value dtype
        for j, (op, vidx, _f) in enumerate(plan.agg_ops):
            if op.startswith("hist:"):
                lo, span = self._hist_bounds(segments,
                                             plan.value_irs[vidx][1])
                B = kernels.slot_width(op)
                params[f"slot{j}:hlo"] = self._upload(
                    np.full(S, lo, dtype=vdt))
                params[f"slot{j}:hscale"] = self._upload(
                    np.full(S, B / span, dtype=vdt))
        num_docs = self._upload(np.array(
            [s.num_docs for s in segments] + [0] * (S - len(segments)),
            dtype=np.int32))
        self._params_cache[pkey] = (tuple(segments), dict(params), num_docs)
        while len(self._params_cache) > self.PARAMS_CACHE_ENTRIES:
            self._params_cache.popitem(last=False)
        return cols, params, num_docs, D

    def _clp_reader(self, ds):
        reader = ds.clp_reader
        if reader is None:
            raise self._clp_fallback("staging", f"column {ds.metadata.name}")
        return reader

    @staticmethod
    def _hist_bounds(segments, col: str) -> Tuple[float, float]:
        """(lo, span) of a histogram slot: the batch's metadata min and
        max; span clamped positive so the scale stays finite."""
        lo, hi = np.inf, -np.inf
        for seg in segments:
            m = seg.metadata.columns.get(col)
            if m is None or m.min_value is None or m.max_value is None:
                raise NotOffloadable(
                    f"PERCENTILETDIGEST over {col} without min/max",
                    reason="tdigest")
            lo = min(lo, float(m.min_value))
            hi = max(hi, float(m.max_value))
        return lo, max(hi - lo, 1e-30)

    def _leaf_params(self, segments, ctx: QueryContext, plan: DevicePlan,
                     S_pad: int) -> Dict[str, torch.Tensor]:
        """Per-leaf kernel parameters, resolved per segment against its
        dictionary (leaves in _plan's order: main filter, then each
        distinct agg FILTER tree), zero rows for the S_pad - S padded
        segments."""
        S = len(segments)
        vdt = self._vdt
        leaf_exprs: List[Function] = []
        if ctx.filter is not None:
            leaf_exprs += _leaf_exprs(ctx.filter)
        seen = set()
        for f in ctx.agg_filters:
            if f is not None and f not in seen:
                seen.add(f)
                leaf_exprs += _leaf_exprs(f)
        out: Dict[str, np.ndarray] = {}
        padded: Dict[str, np.ndarray] = {}
        for i, (leaf, expr) in enumerate(zip(plan.leaves, leaf_exprs)):
            if leaf.kind == "clp":
                # the pattern's tables, padded to S_pad with never-match
                # rows (JAX :2199-2207)
                try:
                    tables = clp_device.leaf_params(
                        i, leaf, segments, str(expr.args[1].value),
                        expr.name == "like", S_pad)
                except ValueError:
                    raise self._clp_fallback("staging", str(expr)) from None
                if self.device.type == "cuda":
                    # K7 reads the dict-var LUTs packed: packed once,
                    # cached with the rest
                    tables = clp_device.pack_banks(tables)
                padded.update(tables)
            elif leaf.kind == "vrange":
                lo, hi = _vrange_bounds(
                    expr, vdt, segments[0].metadata.columns[
                        leaf.column].data_type is DataType.FLOAT)
                out[f"leaf{i}:lo"] = np.full(S, lo, dtype=vdt)
                out[f"leaf{i}:hi"] = np.full(S, hi, dtype=vdt)
            elif leaf.kind == "vrange64":
                a, b = _vrange_int_bounds(expr)
                out[f"leaf{i}:lohi"] = np.full(S, a >> 24, dtype=np.int32)
                out[f"leaf{i}:lolo"] = np.full(S, a & 0xFFFFFF,
                                               dtype=np.int32)
                out[f"leaf{i}:hihi"] = np.full(S, b >> 24, dtype=np.int32)
                out[f"leaf{i}:hilo"] = np.full(S, b & 0xFFFFFF,
                                               dtype=np.int32)
            elif leaf.kind == "range":
                lo = np.zeros(S, dtype=np.int32)
                hi = np.full(S, -1, dtype=np.int32)
                for s, seg in enumerate(segments):
                    p = _resolve(seg, expr)
                    if p.kind == "range":
                        lo[s], hi[s] = p.lo, p.hi
                    elif p.kind == "all":
                        lo[s], hi[s] = 0, 2**31 - 1
                    elif p.kind == "set" and len(p.ids) == 1:
                        lo[s] = hi[s] = int(p.ids[0])
                    elif p.kind != "none":
                        raise NotOffloadable(f"predicate {expr}",
                                             reason="predicate")
                out[f"leaf{i}:lo"], out[f"leaf{i}:hi"] = lo, hi
            elif leaf.kind == "neq":
                idx = np.full(S, -1, dtype=np.int32)
                for s, seg in enumerate(segments):
                    p = _resolve(seg, expr)
                    if p.kind == "notset" and len(p.ids) == 1:
                        idx[s] = int(p.ids[0])
                    elif p.kind != "all":
                        raise NotOffloadable(f"predicate {expr}",
                                             reason="predicate")
                out[f"leaf{i}:idx"] = idx
            else:  # lut
                C = _pow2(max(s.metadata.columns[leaf.column].cardinality
                              for s in segments), floor=8)
                table = np.zeros((S, C), dtype=bool)
                for s, seg in enumerate(segments):
                    p = _resolve(seg, expr)
                    card = seg.metadata.columns[leaf.column].cardinality
                    if p.kind == "all":
                        table[s, :card] = True
                    elif p.kind == "range":
                        table[s, p.lo:p.hi + 1] = True
                    elif p.kind == "set":
                        table[s, p.ids] = True
                    elif p.kind == "notset":
                        table[s, :card] = True
                        table[s, p.ids] = False
                out[f"leaf{i}:lut"] = table
        pad = S_pad - S
        out = {k: (np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                               v.dtype)]) if pad else v)
               for k, v in out.items()}
        return {k: self._upload(v) for k, v in {**out, **padded}.items()}

    def _upload(self, arr: np.ndarray, column: bool = False) -> torch.Tensor:
        """A host array on the device, its bytes counted in the transfer
        odometer (column=True: a column row or block; else per-query
        parameters). To the card it goes through pinned memory without
        blocking, on the default stream: a pageable copy would wait for
        every launch queued on the stream, so staging could not overlap
        another query's kernel."""
        residency_mod.note_transfer(arr.nbytes, column=column)
        if column:
            self._meter("hbm_transfer_bytes", arr.nbytes)
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        dev = self.device
        if column and len(self._chips) > 1:
            # a mesh of several cards: column rows round-robin over them,
            # so resident bytes spread instead of piling onto the lead
            dev = self._chips[next(self._row_rr) % len(self._chips)]
        return t.pin_memory().to(dev, non_blocking=True)

    def _meter(self, name: str, value: float = 1) -> None:
        self._metrics.add_meter(name, value, labels=self._labels)

    def _check_value_precision(self, segments, col: str) -> None:
        """float32 staging is exact only for integers with |v| <= 2^24;
        larger int/long columns (e.g. epoch millis) would silently round.
        Float columns stay f32: they are approximate either way."""
        if self.value_dtype == torch.float64:
            return
        for seg in segments:
            m = seg.metadata.columns.get(col)
            if m is None or m.data_type.np_dtype.kind not in "iu":
                continue
            lo, hi = m.min_value, m.max_value
            if lo is None or hi is None or \
                    max(abs(int(lo)), abs(int(hi))) > (1 << 24):
                raise NotOffloadable(
                    f"int column {col} beyond 2^24 under float32 values "
                    "(host executor)", reason="intRange")

    def _stage_vmask(self, segments, S, D, stamps: tuple) -> torch.Tensor:
        """The uint8 [S, D] upsert validity block (1 = valid) of a batch
        holding upsert segments, through the three staging levels (JAX
        `_stage_vmask` :2272). Each row is keyed by its bitmap's version in
        `stamps` (`vmask:<version>`; -1, an all-ones row, for a segment
        with no bitmap): a bitmap mutates in place without its segment
        changing, so an in-place clear() addresses fresh keys, and the
        next staging uploads that segment's row alone. On a block miss the
        rows and blocks of superseded versions are purged from the block
        cache, the host rows and the resident tier: no query reaches them
        again. A row read after its stamp was taken holds that version's
        contents or newer (Bitmap bumps its version after each change); an
        upsert that lands meanwhile shows in the next staging."""
        kinds = [f"vmask:{st}" for st in stamps]
        batch = _batch_key(segments)
        col = ("__valid__", stamps)
        hit = self._blocks.get((batch, "vmask", col, S, D,
                                np.dtype(np.uint8).str))
        if hit is None or not all(a is b for a, b in zip(hit[0], segments)):
            for k in [k for k in self._blocks
                      if k[0] == batch and k[1] == "vmask" and k[2] != col]:
                _segs, gone = self._blocks.pop(k)
                self._cached -= gone.numel() * gone.element_size()
            for seg, kind in zip(segments, kinds):
                self._residency.invalidate_superseded_kind(
                    seg, "vmask:", kind, "__valid__")
                for k in [k for k, v in self._host_rows.items()
                          if v[0] is seg and k[1].startswith("vmask:")
                          and k[1] != kind]:
                    self._host_bytes -= self._host_rows.pop(k)[1].nbytes

        def fetch_row(seg):
            valid = getattr(seg, "valid_doc_ids", None)
            if valid is None:
                return np.ones(seg.num_docs, dtype=np.uint8)
            m = valid.to_mask()[:seg.num_docs].astype(np.uint8)
            # docs past the bitmap are not upsert-accounted yet: invalid
            return np.concatenate(
                [m, np.zeros(seg.num_docs - len(m), np.uint8)])

        return self._cached_block(segments, S, D, "vmask", col,
                                  ["__valid__"] * len(segments),
                                  [fetch_row] * len(segments), np.uint8,
                                  kinds=kinds)

    def _block(self, segments, S, D, col, kind, fetch,
               dtype) -> torch.Tensor:
        """The [S, D] device block of one column (see _cached_block)."""
        def row(seg):
            if not seg.has_column(col):
                raise NotOffloadable(f"column {col} missing in {seg.name}",
                                     reason="column")
            return fetch(seg.data_source(col))
        return self._cached_block(segments, S, D, kind, col,
                                  [col] * len(segments),
                                  [row] * len(segments), dtype)

    def _cached_block(self, segments, S, D, kind, col, names, fetchers,
                      dtype, resident: bool = True,
                      pads: Optional[List[int]] = None,
                      kinds: Optional[List[str]] = None) -> torch.Tensor:
        """The zero-padded [S, D] device block `(kind, col)` of a segment
        batch, row s from fetchers[s](segments[s]) under the row name
        names[s] (rows past the segments are zero), through the three
        levels: the assembled block when this exact batch staged it before;
        else the resident rows the card holds, and the missing ones built
        on the host (each padded to pads[s], the segment's own power of two
        by default), uploaded, counted and offered to the resident tier,
        assembled on the card by K6. resident=False keeps the rows out of
        the tier (each block miss uploads them all), as does the tier off.
        kinds[s]: row s's kind in the resident tier and the host rows
        (`kind` by default; the validity mask's carry its version).
        Hits are confirmed by object identity at every level. Eviction only
        drops a reference: every launch, copy and fetch is on one stream,
        so the allocator reuses the memory only after a queued kernel read
        it."""
        dtype_str = np.dtype(dtype).str
        key = (_batch_key(segments), kind, col, S, D, dtype_str)
        hit = self._blocks.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], segments)):
            self._blocks.move_to_end(key)
            self._meter("hbm_block_hit")
            return hit[1]
        self._meter("hbm_block_miss")
        kinds = kinds or [kind] * len(segments)
        rows = [self._residency.get(seg, k, name, dtype_str)
                if resident else None
                for seg, k, name in zip(segments, kinds, names)]
        missing = [i for i, r in enumerate(rows) if r is None]
        # every host row first: a NotOffloadable surfaces before any upload
        # churns the resident tier
        host = [self._host_row(segments[i], kinds[i], names[i], fetchers[i],
                               dtype, None if pads is None else pads[i])
                for i in missing]
        for i, arr in zip(missing, host):
            rows[i] = self._upload(arr, column=True)
            if resident:
                self._residency.admit(segments[i], kinds[i], names[i],
                                      dtype_str, rows[i], arr.nbytes,
                                      device=device_label(rows[i].device))
        if len(self._chips) > 1:
            # rows live on their chips; K6 assembles on the lead (JAX
            # anchors the stack on device 0, :2548-2552)
            rows = [r.to(self.device, non_blocking=True) for r in rows]
        dev = kernels.assemble_rows(rows, S, D)
        if self._mesh is not None:
            # the block assembles on the lead device, then its [S_loc,
            # D_loc] shards move to their slots and the cache keeps them
            # (JAX `_reshard_block` :2611)
            dev = shard_block(self._mesh, dev)
        nbytes = dev.numel() * dev.element_size()
        old = self._blocks.pop(key, None)
        if old is not None:
            self._cached -= old[1].numel() * old[1].element_size()
        if nbytes <= self.CACHE_BYTES:
            while self._blocks and self._cached + nbytes > self.CACHE_BYTES:
                _k, (_segs, gone) = self._blocks.popitem(last=False)
                self._cached -= gone.numel() * gone.element_size()
            self._blocks[key] = (tuple(segments), dev)
            self._cached += nbytes
        return dev

    def _host_row(self, seg, kind, name, fetch, dtype,
                  pad_to: Optional[int] = None) -> np.ndarray:
        """One (segment, column) row on the host, zero-padded to pad_to
        (the segment's own power-of-two doc bucket by default; a star-tree
        row's, its tree's record bucket): independent of the batch, so
        every batch composition shares it. From the host-row cache (JAX
        `_host_row` :2557)."""
        Dr = pad_to if pad_to is not None else _pow2(seg.num_docs)
        rkey = (id(seg), kind, name, Dr, np.dtype(dtype).str)
        hit = self._host_rows.get(rkey)
        if hit is not None and hit[0] is seg:
            self._host_rows.move_to_end(rkey)
            self._meter("host_row_hit")
            return hit[1]
        self._meter("host_row_miss")
        raw = fetch(seg)
        arr = np.zeros(Dr, dtype=dtype)
        arr[:len(raw)] = raw
        self._keep_host_row(rkey, seg, arr)
        return arr

    def _keep_host_row(self, rkey, seg, arr: np.ndarray) -> None:
        """Cache a host row and evict the oldest past HOST_ROW_BYTES."""
        self._host_rows[rkey] = (seg, arr)
        self._host_bytes += arr.nbytes
        while self._host_bytes > self.HOST_ROW_BYTES \
                and len(self._host_rows) > 1:
            _k, (_s, gone) = self._host_rows.popitem(last=False)
            self._host_bytes -= gone.nbytes

    def _compact_groups(self, segments, plan: DevicePlan, S: int) -> int:
        """A compact-key plan's G over a batch of S (padded) segments: the
        power of two (floor 8) of the most key tuples a segment holds.
        Raises NotOffloadable, reason 'groups', past MAX_DEVICE_GROUPS or
        the group-result cap (JAX sends such a batch to its host)."""
        n = max(self._gkey_table(seg, plan).shape[0] for seg in segments)
        G = _pow2(n, floor=8)
        if G > MAX_DEVICE_GROUPS \
                or S * G * len(plan.agg_ops) * 8 > MAX_GROUP_RESULT_BYTES:
            raise NotOffloadable(
                f"{n} key tuples in a segment: compact group keys past the "
                f"device's {MAX_DEVICE_GROUPS} or its group-result cap",
                reason="groups")
        return G

    def _gkey_table(self, seg, plan: DevicePlan) -> np.ndarray:
        """The decode table [G_s, k] int32 dictIds of one segment's compact
        group keys (JAX `_segment_gkey` :2389), cached in the host rows per
        (segment, group columns). A miss factorizes and keeps the codes as
        the segment's `gkey` host row too (the staged column's), so a
        repeat query factorizes nothing; factorizing is deterministic, so
        a row rebuilt after an eviction equals it. Takes the engine lock:
        assembly calls it outside."""
        with self._engine_lock:
            sig = ",".join(plan.group_cols)
            rkey = (id(seg), "gkey_table", sig)
            hit = self._host_rows.get(rkey)
            if hit is not None and hit[0] is seg:
                self._host_rows.move_to_end(rkey)
                self._meter("host_row_hit")
                return hit[1]
            self._meter("host_row_miss")
            codes, table = factorize_keys(seg, plan.group_cols)
            self._host_row(seg, "gkey", sig, lambda _s: codes, np.int32)
            self._keep_host_row(rkey, seg, table)
            return table

    # ------------------------------------------------------------------
    # star-tree leg (ops/startree_device.py)
    # ------------------------------------------------------------------
    def _startree_candidate(self, segments) -> bool:
        """Structural gate before the star-tree planner runs: only batches
        where EVERY segment carries a tree reach it, so treeless tables pay
        one getattr per segment and the fallback meter counts only batches
        a tree could serve. A partially valid upsert bitmap keeps the scan
        path: pre-agg records include retracted rows, which no selection
        over the pre-agg table can subtract. A doc-sharded mesh takes the
        scan leg (JAX :674)."""
        if not self._startree_enabled or self._doc_axis > 1:
            return False
        for s in segments:
            reader = getattr(s, "star_tree", None)
            if reader is None or not reader.trees:
                return False
            vd = getattr(s, "valid_doc_ids", None)
            if vd is not None and not vd.is_full():
                return False
        return True

    def _plan_startree(self, segments, ctx: QueryContext,
                       meter: bool = True):
        """(plan, needed, fits) when the fitted trees answer the
        aggregation, else None; meter=True counts the served query or the
        fallback reason (prestage routes without counting)."""
        if not self._startree_candidate(segments):
            return None
        plan, needed, fits, reason = startree_device.plan_startree(segments,
                                                                   ctx)
        if plan is not None and max(int(f.tree.meta.num_records)
                                    for f in fits) > MAX_DOCS_PER_SEGMENT:
            plan, reason = None, "staging"
        if meter:
            self.meters[("startree_served", None) if plan is not None
                        else ("startree_fallback", reason)] += 1
        return None if plan is None else (plan, needed, fits)

    def _stage_startree(self, segments, ctx: QueryContext, plan, fits):
        """Stage the fitted trees' pre-agg rows as `__startree__<ti>/<col>`
        pseudo-columns through the staging levels (each row padded to its
        tree's own power-of-two record bucket), and the [S, D] selection
        mask and record counts through the params cache, so a repeat query
        (same batch, plan and filter) runs no traversal and uploads
        nothing. D is the power of two of the largest fitted tree's record
        count (star records make num_records exceed num_docs, so the scan
        path's D does not hold here); S pads as the scan path's does, the
        padded segments selecting no record (JAX `_stage_startree_locked`
        :1062)."""
        D = _pow2(max(int(f.tree.meta.num_records) for f in fits))
        S = self._padded_S(len(segments), D)
        tis = tuple(f.ti for f in fits)
        pads = [_pow2(int(f.tree.meta.num_records)) for f in fits]
        cols: Dict[str, torch.Tensor] = {}
        for ckey, form, dtype in startree_device.staged_columns(plan,
                                                                self._vdt):
            cols[ckey] = self._cached_block(
                segments, S, D, "startree", (ckey, tis),
                [f"__startree__{f.ti}/{ckey}" for f in fits],
                [lambda _seg, _t=f.tree, _form=form, _dt=dtype:
                 startree_device.fetch_row(_t, _form, _dt) for f in fits],
                dtype, resident=self._st_resident, pads=pads)
        pkey = (_batch_key(segments), plan, ctx.filter, tis, S, D)
        hit = self._params_cache.get(pkey)
        if hit is not None and all(a is b for a, b in zip(hit[0], segments)):
            self._params_cache.move_to_end(pkey)
            return cols, dict(hit[1]), hit[2], D
        sel = startree_device.selection_mask(fits, S, D)
        params = {"sel": self._upload(sel)}
        records = np.zeros(S, dtype=np.int32)
        records[:len(fits)] = [int(f.tree.meta.num_records) for f in fits]
        num_docs = self._upload(records)
        self._params_cache[pkey] = (tuple(segments), dict(params), num_docs)
        while len(self._params_cache) > self.PARAMS_CACHE_ENTRIES:
            self._params_cache.popitem(last=False)
        return cols, params, num_docs, D

    # ------------------------------------------------------------------
    # the staging levels' lifecycle (JAX :2692-2790)
    # ------------------------------------------------------------------
    @property
    def residency(self) -> residency_mod.ResidencyManager:
        return self._residency

    def residency_seeding(self):
        """Context manager marking staging as warm-up-driven: resident-row
        admissions bypass the frequency duel and carry the seed boost."""
        return self._residency.seeding()

    def invalidate_segment(self, name: str, keep=None) -> None:
        """Drop every level's entries of a replaced or removed segment NAME
        (assembled blocks holding it, its host rows, the params holding it,
        its resident rows), sparing those pinned to `keep` (the live
        object). Identity keying already makes them unreachable; this
        returns their memory now."""
        with self._engine_lock:
            def stale(seg) -> bool:
                return seg.name == name and (keep is None or seg is not keep)

            for k in [k for k, (segs, _d) in self._blocks.items()
                      if any(stale(x) for x in segs)]:
                _segs, gone = self._blocks.pop(k)
                self._cached -= gone.numel() * gone.element_size()
            for k in [k for k, v in self._host_rows.items() if stale(v[0])]:
                self._host_bytes -= self._host_rows.pop(k)[1].nbytes
            for cache in (self._params_cache, self._gmap_cache):
                for k in [k for k, v in cache.items()
                          if any(stale(x) for x in v[0])]:
                    del cache[k]
            self._residency.invalidate_segment(name, keep=keep)
            self._refresh_tier_gauges()

    def drop_caches(self, host: bool = True) -> None:
        """Release the device levels (assembled blocks, params, resident
        rows); host=True also drops the host rows: the cold server."""
        with self._engine_lock:
            self._blocks.clear()
            self._cached = 0
            self._params_cache.clear()
            self._residency.drop_all()
            if host:
                self._gmap_cache.clear()
                self._host_rows.clear()
                self._host_bytes = 0
            self._refresh_tier_gauges()

    def prestage(self, segments, ctx: QueryContext) -> bool:
        """Stage a query's columns into the device levels without launching
        a kernel (segment warm-up: the first routed query then pays compute,
        not the upload). The star-tree leg first, as execute routes it: a
        query the trees serve warms their pre-agg blocks and selection
        mask, not the scan columns. False when there is nothing to stage
        or the engine would refuse the query."""
        if not segments or not self.supports(ctx) or _first_docs(ctx):
            return False
        with self._engine_lock:
            try:
                st = None
                if self._doc_axis > 1 and not ctx.aggregations \
                        and not ctx.distinct:
                    return False  # refused on a doc-sharded mesh
                if ctx.aggregations and not ctx.distinct:
                    st = self._plan_startree(segments, ctx, meter=False)
                if st is not None:
                    plan, _needed, fits = st
                    self._stage_startree(segments, ctx, plan, fits)
                    return True
                if _is_vector(ctx):
                    plan, (fn, qvec, k), rctx = self._plan_vector(
                        segments, ctx, meter=False)
                    self._stage_vector(segments, rctx, plan, fn, qvec, k,
                                       None)
                    return True
                if ctx.distinct:
                    ctx = _distinct_context(ctx)
                if ctx.aggregations:
                    plan, _ = self._plan(segments, ctx)
                else:
                    plan = self._plan_topn(segments, ctx)
                self._stage(segments, ctx, plan)
            except NotOffloadable:
                return False
            finally:
                self._refresh_tier_gauges()
        return True

    # ------------------------------------------------------------------
    # assembly
    # ------------------------------------------------------------------
    def _assemble(self, segments, ctx: QueryContext, plan: DevicePlan,
                  packed: np.ndarray,
                  mappings: List[Dict[str, int]]) -> List[Any]:
        # COUNT(*) materializes no column, so it doesn't contribute to
        # entries-scanned-post-filter
        n_valued_aggs = sum(
            1 for node in ctx.aggregations
            if node.args and not (isinstance(node.args[0], Identifier)
                                  and node.args[0].name == "*"))
        widths = [kernels.slot_width(op) for op, _v, _f in plan.agg_ops]
        offsets = np.concatenate([[0], np.cumsum(widths)]).astype(int)
        count_j = None
        grouped = is_grouped(plan)
        if grouped:
            count_j = plan.agg_ops.index(("count", None, None))
        # histogram bounds are batch-global: once per slot
        hist_bounds = {j: self._hist_bounds(segments, plan.value_irs[v][1])
                       for j, (op, v, _f) in enumerate(plan.agg_ops)
                       if op.startswith("hist:")}
        results = []
        for s, seg in enumerate(segments):
            if grouped:
                matched = int(round(float(packed[s, :, count_j].sum())))
            else:
                matched = int(round(float(packed[s, 0])))
            stats = _segment_stats(seg, ctx, matched,
                                   matched * n_valued_aggs)
            if grouped:
                results.append(self._assemble_group(
                    seg, s, ctx, plan, packed, count_j, mappings, stats))
                continue
            inters = []
            for fn, mapping in zip(ctx.agg_functions, mappings):
                slots = {}
                for op, j in mapping.items():
                    off = 1 + offsets[j]
                    planes = packed[s, off:off + widths[j]]
                    plan_op = plan.agg_ops[j][0]
                    if plan_op == "isum":
                        slots[op] = isum_value(planes)
                    elif plan_op.startswith("isum:u"):
                        slots[op] = isum_u_value(planes)
                    elif widths[j] > 1:   # sketch registers / buckets
                        slots[op] = planes
                        if op.startswith("hist:"):
                            lo, span = hist_bounds[j]
                            slots["hist_lo"] = lo
                            slots["hist_width"] = span / widths[j]
                    else:
                        slots[op] = packed[s, off]
                inters.append(fn.from_device_slots(slots))
            results.append(AggregationResult(inters, stats))
        return results

    def _decode_table(self, seg, plan: DevicePlan) -> Optional[np.ndarray]:
        """A compact-key plan's decode table of the segment (code ->
        dictIds), else None."""
        return self._gkey_table(seg, plan) if plan.group_compact else None

    def _assemble_group(self, seg, s, ctx, plan, packed, count_j, mappings,
                        stats) -> GroupByResult:
        present, keys = _group_keys(seg, plan, packed[s, :, count_j],
                                    self._decode_table(seg, plan))
        groups: Dict[tuple, list] = {}
        for key, g in zip(keys, present):
            groups[key] = [
                fn.from_device_slots({op: packed[s, g, j]
                                      for op, j in mapping.items()})
                for fn, mapping in zip(ctx.agg_functions, mappings)]
        return GroupByResult(groups, stats)

    def _assemble_distinct(self, segments, gctx: QueryContext,
                           plan: DevicePlan,
                           packed: np.ndarray) -> List[DistinctResult]:
        """The present group keys of a DISTINCT's group-by, as
        DistinctResults (no per-group intermediates)."""
        count_j = plan.agg_ops.index(("count", None, None))
        results = []
        for s, seg in enumerate(segments):
            counts = packed[s, :, count_j]
            _present, keys = _group_keys(seg, plan, counts,
                                         self._decode_table(seg, plan))
            matched = int(round(float(counts.sum())))
            results.append(DistinctResult(
                set(keys), _segment_stats(seg, gctx, matched, 0)))
        return results

    def _assemble_merged(self, segments, ctx: QueryContext, plan: DevicePlan,
                         packed: np.ndarray, mappings: List[Dict[str, int]],
                         minfo: dict) -> List[Any]:
        """ONE result for the whole segment batch from the merged row
        (layout in ops/collective.py; JAX `_assemble_merged` :3029). The
        [S] matched tail carries the per-segment counts the host fold
        would have summed, so the ExecutionStats equal the folded
        per-segment stats."""
        S_real = len(segments)
        matched_i = [int(round(float(m)))
                     for m in np.asarray(packed[-minfo["S"]:][:S_real])]
        total = sum(matched_i)
        n_valued_aggs = sum(
            1 for node in ctx.aggregations
            if node.args and not (isinstance(node.args[0], Identifier)
                                  and node.args[0].name == "*"))
        docs = sum(seg.num_docs for seg in segments)
        stats = ExecutionStats(
            num_docs_scanned=total,
            num_entries_scanned_in_filter=(
                docs * len(set(ctx.filter_columns()))
                if ctx.filter is not None else 0),
            num_entries_scanned_post_filter=total * n_valued_aggs,
            num_segments_processed=S_real,
            num_segments_matched=sum(1 for m in matched_i if m),
            total_docs=docs)
        if plan.group_cols:
            return [self._assemble_merged_group(ctx, plan, packed, mappings,
                                                minfo, stats)]
        widths = [kernels.slot_width(op) for op, _v, _f in plan.agg_ops]
        offsets = np.concatenate([[0], np.cumsum(widths)]).astype(int)
        hist_bounds = {j: self._hist_bounds(segments, plan.value_irs[v][1])
                       for j, (op, v, _f) in enumerate(plan.agg_ops)
                       if op.startswith("hist:")}
        inters = []
        for fn, mapping in zip(ctx.agg_functions, mappings):
            slots = {}
            for op, j in mapping.items():
                off, w = int(offsets[j]), widths[j]
                planes = packed[off:off + w]
                plan_op = plan.agg_ops[j][0]
                if plan_op == "isum":
                    slots[op] = isum_value(planes)
                elif plan_op.startswith("isum:u"):
                    slots[op] = isum_u_value(planes)
                elif w > 1:
                    slots[op] = planes
                    if op.startswith("hist:"):
                        lo, span = hist_bounds[j]
                        slots["hist_lo"] = lo
                        slots["hist_width"] = span / w
                else:
                    slots[op] = packed[off]
            inters.append(fn.from_device_slots(slots))
        return [AggregationResult(inters, stats)]

    @staticmethod
    def _assemble_merged_group(ctx, plan: DevicePlan, packed, mappings,
                               minfo: dict, stats) -> GroupByResult:
        """The merged [G, n_slots] block's present global keys, decoded by
        the union strides, a compact key through the union's mixed-radix
        keys first (JAX `_assemble_merged_group` :3088)."""
        G, n_slots = minfo["G"], len(plan.agg_ops)
        gp = np.asarray(packed[:G * n_slots]).reshape(G, n_slots)
        count_j = collective.find_count_slot(plan)
        present = np.nonzero(gp[:, count_j] > 0)[0]
        present = present[present < minfo["n_real"]]
        strides, cards, unions = minfo["decode"][:3]
        # compact: global index -> the union's mixed-radix key (JAX
        # :3102-3104 decodes through the tuple union)
        keys = minfo["decode"][3][present] if plan.group_compact else present
        cols = [unions[ci][(keys // strides[ci]) % cards[ci]].tolist()
                for ci in range(len(plan.group_cols))]
        groups: Dict[tuple, list] = {}
        for key, g in zip(zip(*cols), present):
            groups[key] = [
                fn.from_device_slots({op: gp[g, j]
                                      for op, j in mapping.items()})
                for fn, mapping in zip(ctx.agg_functions, mappings)]
        return GroupByResult(groups, stats)

    @staticmethod
    def _assemble_topn(segments, ctx: QueryContext,
                       packed: np.ndarray) -> List[SelectionResult]:
        """packed [S, 1 + k] int32 -> SelectionResults: project ONLY the
        winning docs on the host (incl. '*' and string columns)."""
        order_exprs = [e for e, _ in ctx.order_by]
        results = []
        for s, seg in enumerate(segments):
            idx = packed[s, 1:]
            idx = idx[(idx >= 0) & (idx < seg.num_docs)].astype(np.int64)
            rows = executor_cpu._project_rows(seg, ctx.select, idx)
            order_values = executor_cpu._project_rows(
                seg, order_exprs, idx) if order_exprs else None
            stats = _segment_stats(seg, ctx, int(packed[s, 0]),
                                   len(idx) * max(len(ctx.select), 1))
            results.append(SelectionResult(
                rows, order_values=order_values,
                columns=executor_cpu.expand_star(seg, ctx), stats=stats))
        return results


def _same_device(a: torch.device, b: torch.device) -> bool:
    """One device, "cuda" naming card 0."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class _MergeFallback(Exception):
    """A collective-merge gate tripped; the launch keeps the per-segment
    sharded kernel and the host fold (its reason feeds
    mesh_merge_fallback)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _batch_key(segments) -> tuple:
    """A segment batch's identity in the block and params caches (hits are
    confirmed by object identity; JAX `_batch_id` :3147)."""
    return tuple((id(s), s.name) for s in segments)


def _mask_stamps(segments) -> tuple:
    """The version of each segment's validDocIds bitmap; -1 where it has
    none (an all-ones row that never goes stale; JAX `_mask_stamp`
    :2251)."""
    return tuple(-1 if getattr(s, "valid_doc_ids", None) is None
                 else s.valid_doc_ids.version for s in segments)


def _needs_valid_mask(segments) -> bool:
    """A batch holding an upsert segment stages the validity mask (JAX
    :2257)."""
    return any(getattr(s, "valid_doc_ids", None) is not None
               for s in segments)


def _shape_sig(cols: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor]) -> tuple:
    """The part of the coalesce key that plan, S, D and G leave open
    across tables (JAX `_shape_sig` :3153): LUT widths pad to each table's
    cardinality and id blocks stage at cardinality-chosen widths, so equal
    plans can still stage different shapes or dtypes. Equal signatures
    guarantee the members' tensors agree leaf for leaf, the LUT width C
    included."""
    return (tuple(sorted((k, tuple(v.shape), str(v.dtype))
                         for k, v in cols.items())),
            tuple(sorted((k, tuple(v.shape), str(v.dtype))
                         for k, v in params.items())))


def _is_vector(ctx: QueryContext) -> bool:
    """A selection filtered by vector_similarity: the vector leg."""
    return not ctx.aggregations and not ctx.distinct \
        and vector_device.contains_vector(ctx.filter)


def _first_docs(ctx: QueryContext) -> bool:
    """A selection with neither a filter nor an ORDER BY: the host's
    first-docs scan, no device launch."""
    return not ctx.aggregations and not ctx.distinct \
        and ctx.filter is None and not ctx.order_by


def _segment_stats(seg, ctx: QueryContext, matched: int,
                   post_filter: int) -> ExecutionStats:
    return ExecutionStats(
        num_docs_scanned=matched,
        num_entries_scanned_in_filter=(
            seg.num_docs * len(set(ctx.filter_columns()))
            if ctx.filter is not None else 0),
        num_entries_scanned_post_filter=post_filter,
        num_segments_processed=1,
        num_segments_matched=1 if matched else 0,
        total_docs=seg.num_docs)


def _group_keys(seg, plan: DevicePlan, counts: np.ndarray,
                table: Optional[np.ndarray] = None):
    """The keys with a nonzero count, and their group-key tuples (raw
    values). Compact keys: each code's dictIds from the segment's decode
    `table`, codes at or past its length dropped (JAX :2987-2993). Dense
    keys: combined keys decoded by mixed radix into dictIds, keys beyond
    this segment's cardinalities dropped; with a fused time bucket the
    remainder after the tag strides is the bucket, the key's first value,
    a float as the host's floor() over a double division gives it (JAX
    `_assemble_group` :3002-3018)."""
    present = np.nonzero(counts > 0)[0]
    if plan.group_compact:
        present = present[present < table.shape[0]]
        key_cols = [seg.data_source(c).dictionary.get_values(
            table[present, j]).tolist()
            for j, c in enumerate(plan.group_cols)]
        return present, list(zip(*key_cols))
    cards = [seg.metadata.columns[c].cardinality for c in plan.group_cols]
    rem = present.copy()
    ids_per_col = []
    for stride in plan.group_strides:
        ids_per_col.append(rem // stride)
        rem = rem % stride
    valid = np.ones(len(present), dtype=bool)
    for ids, card in zip(ids_per_col, cards):
        valid &= ids < card
    key_cols = [seg.data_source(c).dictionary.get_values(ids[valid]).tolist()
                for c, ids in zip(plan.group_cols, ids_per_col)]
    if plan.tbucket:
        key_cols.insert(0, rem[valid].astype(np.float64).tolist())
    return present[valid], list(zip(*key_cols))


def factorize_keys(seg, group_cols) -> Tuple[np.ndarray, np.ndarray]:
    """One segment's compact group keys (JAX `_segment_gkey_locked`
    :2400): each doc's code among the key tuples the segment holds, in
    [0, G_s), as int32 [num_docs], and the decode table int32 [G_s, k] of
    their per-column dictIds, codes in mixed-radix order of the dictIds.
    A dense remap where the key space is small beside the docs, else a
    sort (np.unique)."""
    cards, prod = [], 1
    for col in group_cols:
        if not seg.has_column(col):
            raise NotOffloadable(f"column {col} missing in {seg.name}",
                                 reason="column")
        card = max(int(seg.metadata.columns[col].cardinality), 1)
        cards.append(card)
        prod *= card
    if prod > (1 << 62):
        raise NotOffloadable(f"group keys over {list(group_cols)} overflow "
                             "a 64-bit mixed radix", reason="groups")
    combined = np.zeros(seg.num_docs, np.int64)
    for col, card in zip(group_cols, cards):
        combined = combined * card \
            + seg.data_source(col).dict_ids().astype(np.int64)
    if prod <= (1 << 26) and prod <= 16 * max(seg.num_docs, 1):
        # O(docs + key space) for a first query over a small key space
        present = np.zeros(prod, dtype=bool)
        present[combined] = True
        uniq = np.flatnonzero(present).astype(np.int64)
        remap = np.empty(prod, dtype=np.int32)  # only hit entries read
        remap[uniq] = np.arange(len(uniq), dtype=np.int32)
        inv = remap[combined]
    else:
        uniq, inv = np.unique(combined, return_inverse=True)
    table = np.empty((len(uniq), len(group_cols)), np.int32)
    rem = uniq.copy()
    for j in range(len(group_cols) - 1, -1, -1):
        table[:, j] = rem % cards[j]
        rem //= cards[j]
    return inv.reshape(-1).astype(np.int32), table


def isum_value(planes: np.ndarray) -> float:
    """Rebuild the exact int sum from the isum slot's packed planes: pairs
    of f32-exact signed (hi, lo) halves per 6-bit digit, the top digit
    carrying the sign."""
    total = 0
    for k in range(kernels.ISUM_PLANES):
        s = int(planes[2 * k]) * 4096 + int(planes[2 * k + 1])
        total += s << (6 * k)
    return float(total)


def isum_u_value(planes: np.ndarray) -> float:
    """Rebuild the exact non-negative int sum from unsigned 7-bit plane
    halves."""
    total = 0
    for k in range(len(planes) // 2):
        s = int(planes[2 * k]) * 4096 + int(planes[2 * k + 1])
        total += s << (kernels.ISUM_U_BITS * k)
    return float(total)


def _resolve(seg, expr: Function):
    p = resolve_predicate(seg, expr)
    if p is None:
        raise NotOffloadable(f"predicate {expr}", reason="predicate")
    return p


def _distinct_context(ctx: QueryContext) -> QueryContext:
    """The GROUP BY <select list> + COUNT(*) context a DISTINCT runs as
    (JAX `_execute_distinct`), its limit carried."""
    sel = list(ctx.select)
    gctx = QueryContext(
        table=ctx.table, select=sel + [Function("count", (Identifier("*"),))],
        aliases=[None] * (len(sel) + 1), distinct=False, filter=ctx.filter,
        group_by=sel, having=None, order_by=[], limit=ctx.limit, offset=0,
        options=dict(ctx.options))
    gctx._extract_aggregations()
    return gctx


def _ir_cols(ir) -> set:
    if ir is None:
        return set()
    if ir[0] == "col":
        return {ir[1]}
    out = set()
    for c in ir[1:]:
        if isinstance(c, tuple):
            out |= _ir_cols(c)
    return out


def _leaf_exprs(e: Expression) -> List[Function]:
    """Leaf expressions in the order _build_filter_ir numbered them
    (depth-first, left-to-right)."""
    if e.name in ("and", "or"):
        return [x for a in e.args for x in _leaf_exprs(a)]
    if e.name == "not":
        return _leaf_exprs(e.args[0])
    return [e]


def _vrange_bounds(e: Function, vdt,
                   float_col: bool = False) -> Tuple[float, float]:
    """Closed [lo, hi] bounds for a raw-value comparison, computed in the
    staging dtype vdt (nextafter in float64 would collapse back to the
    literal once cast to float32, turning x > 5 into x >= 5).
    float_col: the column is FLOAT, so the literal is first rounded to
    float32, as the host filter reads it (numpy compares a float32 column
    with a Python literal in float32) and as the pruner does: `rf > 0.1`
    then means `rf > 0.1f` in either value dtype."""
    def lv(i):
        raw = e.args[i].value  # type: ignore[union-attr]
        try:
            if isinstance(raw, str):
                raw = int(raw) if raw.lstrip("+-").isdigit() else float(raw)
            if float_col:
                with np.errstate(over="ignore"):
                    raw = float(np.float32(raw))
            v = vdt(raw)
            # a literal not exactly representable in the staging dtype would
            # alias to a neighbour and match rows the exact answer would not
            exact = (int(v) if isinstance(raw, int) and float(v).is_integer()
                     else float(v))
            if exact != raw:
                raise NotOffloadable(f"literal {raw} not exact in {vdt}",
                                     reason="literal")
        except (OverflowError, ValueError, TypeError):
            raise NotOffloadable(f"literal in {e}", reason="literal") from None
        return v
    if e.name == "equals":
        return lv(1), lv(1)
    if e.name == "between":
        return lv(1), lv(2)
    if e.name == "greater_than":
        return np.nextafter(lv(1), vdt(np.inf)), vdt(np.inf)
    if e.name == "greater_than_or_equal":
        return lv(1), vdt(np.inf)
    if e.name == "less_than":
        return vdt(-np.inf), np.nextafter(lv(1), vdt(-np.inf))
    return vdt(-np.inf), lv(1)  # less_than_or_equal


_INT_BOUND_CLAMP = 1 << 54  # split planes stay exact below 2^55


def _vrange_int_bounds(e: Function) -> Tuple[int, int]:
    """Closed [lo, hi] integer bounds for a comparison on an int column
    (vrange64 leaves), in exact Python integer arithmetic."""
    import math

    def lv(i):
        raw = e.args[i].value  # type: ignore[union-attr]
        try:
            if isinstance(raw, str):
                raw = int(raw) if raw.lstrip("+-").isdigit() else float(raw)
            if isinstance(raw, bool) or raw is None or (
                    isinstance(raw, float) and not math.isfinite(raw)):
                raise NotOffloadable(f"literal in {e}", reason="literal")
            return raw
        except (ValueError, TypeError, OverflowError):
            raise NotOffloadable(f"literal in {e}", reason="literal") from None

    def clamp(v: int) -> int:
        return max(-_INT_BOUND_CLAMP, min(_INT_BOUND_CLAMP, v))

    if e.name == "equals":
        v = lv(1)
        if isinstance(v, float):
            if not v.is_integer():
                return 1, 0  # empty interval
            v = int(v)
        return clamp(v), clamp(v)
    if e.name == "between":
        return clamp(math.ceil(lv(1))), clamp(math.floor(lv(2)))
    if e.name == "greater_than":
        return clamp(math.floor(lv(1)) + 1), _INT_BOUND_CLAMP
    if e.name == "greater_than_or_equal":
        return clamp(math.ceil(lv(1))), _INT_BOUND_CLAMP
    if e.name == "less_than":
        return -_INT_BOUND_CLAMP, clamp(math.ceil(lv(1)) - 1)
    return -_INT_BOUND_CLAMP, clamp(math.floor(lv(1)))  # less_than_or_equal

