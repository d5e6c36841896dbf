"""QueryExecutor: the port's entry point, SQL text or a QueryContext to
result rows.

Counterpart of pinot_tpu/query/executor.py (ref pinot-core
ServerQueryExecutorV1Impl.java:94 + BaseCombineOperator.java:54). Two
calls:

- `execute(sql)`: parse, run every segment through the device engine as
  ONE stacked launch, reduce. A shape the engine refuses raises
  NotOffloadable, naming what it needs: this is the device path alone.
- `execute_context(ctx)`: the server's call (JAX :63-185). It prunes on
  min / max (query/pruner.py), runs the device engine (or
  `execute_async` while segments the engine never stages run on the host
  beside it), and hands a batch the engine refused by design
  (NotOffloadable, and only that) to the host executor
  (query/executor_cpu.py), counted as `host_fallback{reason}`. Any other
  exception, a CUDA error or a failed build or launch, propagates: a
  query the device path supports never reaches the host.

The devices default to every card of the host (one card alone, several
as a segments-only mesh); the plain PyTorch kernels run only when the
caller asks for the CPU. Safe to call from many threads at once:
concurrent queries meet in the engine's dispatch ring (ops/dispatch.py),
where equal plans coalesce into one launch. Neither the engine nor the ring
is imported with this module.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from pinot_tpu_torch.query import executor_cpu
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.pruner import prune_segments
from pinot_tpu_torch.query.reduce import BrokerResponse, reduce_results
from pinot_tpu_torch.query.results import ExecutionStats
from pinot_tpu_torch.segment.loader import ImmutableSegment
from pinot_tpu_torch.utils import tracing
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.metrics import get_registry


class QueryExecutor:
    """Executes queries over loaded segments (one 'server')."""

    #: threads a refused batch's segments run on in the host executor
    HOST_THREADS = 8

    def __init__(self, segments: Union[Sequence[ImmutableSegment],
                                       Mapping[str, Sequence[ImmutableSegment]]],
                 device=None, value_dtype: torch.dtype = torch.float32,
                 config: Optional[PinotConfiguration] = None, mesh=None,
                 engine=None, cancel_check=None, devices=None):
        """segments: one table's segments, or {table name: segments} for a
        server holding several tables (a query reads the table its FROM
        names; equal plans over different tables coalesce in the ring).
        device, devices, mesh: as TorchOperatorExecutor takes them. With
        none of them the engine spans every CUDA device (one card alone,
        several as a segments-only mesh), and raises RuntimeError when no
        CUDA device is present; device="cpu" runs the plain PyTorch
        kernels; devices=[...] is a segments-only mesh over those devices
        (a logical one where they repeat).
        config: the engine's configuration (dispatch ring, star-tree,
        time-series keys); kept as `config`, which the time-series leaf
        reads its group cap from.
        mesh: a parallel.mesh.Mesh over (segments, docs): the engine
        shards each staged block over it and folds the partials (and,
        on more than one slot, merges the segment batch into one row);
        device then defaults to the mesh's lead device.
        engine: a shared TorchOperatorExecutor (the server's, which owns
        the staging levels across requests); device, devices, value_dtype
        and mesh are then the engine's.
        cancel_check: zero-arg callable polled before the device launch,
        while it waits in the ring, and before each host segment; raises
        when the query is cancelled or past its deadline."""
        if engine is None:
            from pinot_tpu_torch.ops.engine import TorchOperatorExecutor
            engine = TorchOperatorExecutor(device, value_dtype, config=config,
                                           mesh=mesh, devices=devices)
        self.tables = None
        if isinstance(segments, Mapping):
            self.tables = {t: list(segs) for t, segs in segments.items()}
            segments = []
        self.segments = list(segments)
        self.config = config
        self.engine = engine
        self._cancel_check = cancel_check
        self._tls = threading.local()

    @property
    def last_stage_ms(self) -> Dict[str, float]:
        """Host-clock split (ms) of this thread's last execute: parse, the
        engine's stages (TorchOperatorExecutor.last_stage_ms), reduce."""
        return getattr(self._tls, "stage_ms", {})

    def execute(self, sql: str) -> BrokerResponse:
        """Parse, run every segment through the device engine, reduce.
        Raises NotOffloadable (a NotImplementedError) naming what the query
        needs beyond the device path."""
        t0 = time.perf_counter()
        ctx = QueryContext.from_sql(sql)
        t1 = time.perf_counter()
        results = self.engine.execute(self.segments_of(ctx.table), ctx)
        t2 = time.perf_counter()
        resp = reduce_results(ctx, results)
        t3 = time.perf_counter()
        self._tls.stage_ms = {"parse": (t1 - t0) * 1e3,
                              **self.engine.last_stage_ms,
                              "reduce": (t3 - t2) * 1e3}
        resp.time_used_ms = (t3 - t0) * 1e3
        return resp

    def execute_context(self, ctx: QueryContext
                        ) -> Tuple[List, ExecutionStats]:
        """The per-segment results of a query, and the pruner's stats."""
        from pinot_tpu_torch.ops import dispatch as dispatch_mod
        from pinot_tpu_torch.ops.engine import NotOffloadable
        segments = self.segments_of(ctx.table)
        selected = prune_segments(segments, ctx)
        kept = set(map(id, selected))
        prune_stats = ExecutionStats()
        for seg in segments:
            if id(seg) not in kept:
                prune_stats.num_segments_pruned += 1
                prune_stats.total_docs += seg.num_docs
        # the engine stages immutable segments; anything else (a duck-typed
        # segment) runs on the host beside the device launch
        device_segs = [s for s in selected if isinstance(s, ImmutableSegment)]
        host_only = [s for s in selected
                     if not isinstance(s, ImmutableSegment)]
        device_results: List = []
        refused: List = []
        fut = None
        if device_segs:
            if self._cancel_check is not None:
                self._cancel_check()
            if host_only:
                fut = self.engine.execute_async(device_segs, ctx,
                                                self._cancel_check)
            else:
                try:
                    device_results = self.engine.execute(
                        device_segs, ctx, self._cancel_check)
                except NotOffloadable as e:
                    refused = self._refused(device_segs, e)
        host_results = self._run_host(host_only, ctx)
        if fut is not None:
            try:
                device_results = dispatch_mod.wait_result(
                    fut, self._cancel_check)
            except NotOffloadable as e:
                refused = self._refused(device_segs, e)
        return (device_results + host_results
                + self._run_host(refused, ctx)), prune_stats

    @staticmethod
    def _refused(segments, e) -> list:
        """Count a refused batch on `host_fallback{reason}` (the refusal's
        fixed reason, so the label set stays bounded) and mark the traced
        request with the reason and the message."""
        get_registry("server").add_meter("host_fallback",
                                         labels={"reason": e.reason})
        tracing.annotate(hostFallback=e.reason, hostFallbackWhy=str(e))
        return segments

    def _run_host(self, segments, ctx: QueryContext) -> list:
        if not segments:
            return []

        def run_one(seg):
            if self._cancel_check is not None:
                self._cancel_check()
            return executor_cpu.execute_segment(seg, ctx)
        with tracing.Scope("HostExecutor", segments=len(segments)):
            if len(segments) == 1:
                return [run_one(segments[0])]
            with ThreadPoolExecutor(max_workers=min(
                    len(segments), self.HOST_THREADS)) as pool:
                return list(pool.map(run_one, segments))

    def segments_of(self, table: str):
        """The segments a query over `table` reads."""
        if self.tables is None:
            return self.segments
        if table not in self.tables:
            raise ValueError(f"no table {table!r} on this server")
        return self.tables[table]
