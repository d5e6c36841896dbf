"""Broker request handling: parse -> route -> scatter -> gather -> reduce.

A copy of pinot_tpu/broker/request_handler.py's single-stage path (ref
pinot-broker requesthandler/BaseSingleStageBrokerRequestHandler.java:280
(compile, authorize, route, submit) + core/transport/QueryRouter.java:90
(scatter) + core/query/reduce/BrokerReduceService.java:61 (gather/merge))
over the port's servers. The broker is host code; the servers under it
run the card. It retries and hedges only on connection errors,
deadlines and overload replies, onto another replica of the same
segments: a server's QUERY_EXECUTION reply (a kernel that failed to
build or launch) reaches the client as an exception of the response.

Not here: the multi-stage delegation (a join is a 150, as the JAX broker
answers with no dispatcher), the streaming handler, and the brownout's
stale serving and hedge switch (the port has no health plane).
"""
from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as _fut_wait
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.broker.adaptive import RetryBudget
from pinot_tpu_torch.broker.failure_detector import \
    ConnectionFailureDetector
from pinot_tpu_torch.broker.routing import BrokerRoutingManager
from pinot_tpu_torch.cache.broker_cache import (BrokerResultCache,
                                                NegativeResultCache,
                                                _broker_ids)
from pinot_tpu_torch.cache.core import cache_bypassed
from pinot_tpu_torch.models import base_table_name
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.parser import SqlParseError, parse_sql
from pinot_tpu_torch.query.reduce import BrokerResponse, reduce_results
from pinot_tpu_torch.query.results import ExecutionStats
from pinot_tpu_torch.server import datatable
from pinot_tpu_torch.server.query_server import ServerConnection
from pinot_tpu_torch.utils import errorcodes, trace_store, tracing
from pinot_tpu_torch.utils.accounting import BrokerTimeoutError
from pinot_tpu_torch.utils.failpoints import FailpointError, fire
from pinot_tpu_torch.utils.metrics import get_registry

#: threads of a broker's fan-out pool (the JAX broker's default)
_FANOUT_THREADS = 16


def _overload_entry(server_exc) -> Optional[dict]:
    """The typed 211 admission rejection, when that is ALL the server
    said (a payload carrying real results or other errors is handled by
    the normal merge/fallback machinery, not the overload path)."""
    if not server_exc:
        return None
    entries = [e for e in server_exc if isinstance(e, dict)
               and e.get("errorCode") == errorcodes.SERVER_OVERLOADED]
    if len(entries) == len(server_exc):
        return entries[0]
    return None


def _retry_after_s(entry: dict) -> Optional[float]:
    """The in-band retryAfterMs hint from a 211 message, in seconds
    (format/parse single-sourced in utils/errorcodes.py)."""
    ms = errorcodes.parse_retry_after(entry.get("message", ""))
    return ms / 1000.0 if ms is not None else None


class _ScatterUnit:
    """One plan entry's lifecycle through scatter/gather: a primary
    attempt, at most one hedge — whole-set on a single replica when one
    holds everything, else SPLIT into per-replica child units covering
    disjoint segment subsets (partially-replicated layouts) — and, on
    hard failure, a one-shot retry that spawns fresh units covering only
    the still-unanswered segments. Dedup is per SEGMENT: a response
    merges iff none of its segments has already been answered by a clean
    twin (`answered` tracks the names), so overlapping partials can
    never double-count; `done` flips exactly once, when the whole set is
    answered or abandoned."""

    __slots__ = ("server", "table", "names", "extra", "retried",
                 "done", "hedge_tried", "hedged", "live", "fallback",
                 "answered", "parent", "children")

    def __init__(self, server: str, table: str, names: List[str],
                 extra: Optional[str], retried: bool = False,
                 parent: Optional["_ScatterUnit"] = None):
        self.server = server          # primary replica (hedges exclude it)
        self.table = table
        self.names = names
        self.extra = extra
        self.retried = retried        # retry units never hedge or re-retry
        self.done = False
        self.hedge_tried = False      # placement attempted (once only)
        self.hedged = False           # a hedge request is actually in flight
        self.live = 0                 # in-flight attempts
        #: an ERRORED payload received while a twin was still racing —
        #: held back so a clean twin can win, merged only if none does
        self.fallback = None
        #: segment names a clean response already covered (split hedges:
        #: first clean answer per segment wins, overlap discards)
        self.answered: set = set()
        #: set on split-hedge children; dedup/retry run on the parent
        self.parent = parent
        self.children: List["_ScatterUnit"] = []

    @property
    def logical(self) -> "_ScatterUnit":
        """The unit dedup/retry accounting lives on (self, or the parent
        for split-hedge children)."""
        return self.parent if self.parent is not None else self

    def pending_names(self) -> List[str]:
        return [n for n in self.names if n not in self.answered]

    def family_live(self) -> int:
        """In-flight attempts across the primary and every child."""
        return self.live + sum(c.live for c in self.children)


class BrokerRequestHandler:
    def __init__(self, routing: BrokerRoutingManager,
                 connections: Dict[str, ServerConnection],
                 config=None, result_cache=None):
        self.routing = routing
        self.connections = connections
        self.config = config
        #: tier-1 whole-result cache (cache/broker_cache.py). Off unless a
        #: config enables pinot.broker.result.cache.enabled or a built
        #: cache is injected — failover semantics (a repeated query must
        #: re-exercise dead servers) are opt-out, not silently cached away.
        if result_cache is None and config is not None:
            result_cache = BrokerResultCache.from_config(
                config, metrics=get_registry("broker"))
        self.result_cache = result_cache
        self._metrics = get_registry("broker")
        #: pruned-to-zero memo (cache/broker_cache.py NegativeResultCache)
        #: — independent of the whole-result cache and always on.
        #: It shares THIS broker's metric label with the result cache so
        #: the two caches' series correlate; a fresh label when no result
        #: cache exists to borrow from
        neg_labels = getattr(self.result_cache, "labels", None) or \
            {"broker": f"b{next(_broker_ids)}"}
        if config is not None:
            self._negative_cache = NegativeResultCache.from_config(
                config, metrics=self._metrics, labels=neg_labels)
            self._hedge_enabled = config.get_bool(
                "pinot.broker.hedge.enabled")
            self._hedge_min_s = config.get_int(
                "pinot.broker.hedge.delay.min.ms") / 1000.0
            self._hedge_max_s = config.get_int(
                "pinot.broker.hedge.delay.max.ms") / 1000.0
            self._default_timeout_ms = float(
                config.get_int("pinot.broker.timeout.ms"))
            self._slow_threshold_ms = config.get_float(
                "pinot.broker.slow.query.threshold.ms")
            self._trace_capacity = config.get_int(
                "pinot.trace.store.capacity")
        else:
            self._negative_cache = NegativeResultCache(
                metrics=self._metrics, labels=neg_labels)
            self._hedge_enabled = False
            self._hedge_min_s, self._hedge_max_s = 0.025, 1.0
            self._default_timeout_ms = 60000.0
            self._slow_threshold_ms = 10000.0
            self._trace_capacity = None
        #: query ids must be unique ACROSS brokers — two brokers' counters
        #: both start at 1, and the server's accountant keys cancels by id
        self._broker_nonce = uuid.uuid4().hex[:6]
        #: per-table QPS limits (ref queryquota/; None = no quotas), a
        #: QueryQuotaManager the caller attaches
        self.quota_manager = None
        #: logical table -> tenant tag (TableConfig tenants.server):
        #: shipped with every server request so the scheduler charges
        #: the right weighted-fair group (cluster wiring populates it)
        self.tenants: Dict[str, str] = {}
        #: per-table retry/hedge budget (broker/adaptive.py RetryBudget):
        #: clean primary responses refill it, every retry/hedge spends
        #: from it — failures cannot amplify into retry storms
        self._retry_budget = RetryBudget.from_config(
            config, metrics=self._metrics)
        self.failure_detector = ConnectionFailureDetector()
        self._pool = ThreadPoolExecutor(max_workers=_FANOUT_THREADS)
        #: cancels get their OWN tiny pool: at deadline expiry the
        #: fan-out pool's threads are blocked on the very reads being
        #: cancelled, so a cancel queued there would fire only after the
        #: abandoned read drained — defeating its purpose
        self._cancel_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="broker-cancel")
        self._request_id = 0
        self._lock = threading.Lock()

    def close(self) -> None:
        """Release the fan-out and cancel pools; in-flight reads are
        abandoned, as a deadline abandons them."""
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._cancel_pool.shutdown(wait=False, cancel_futures=True)

    def _next_id(self) -> int:
        with self._lock:
            self._request_id += 1
            return self._request_id

    def on_segments_replaced(self, table: str) -> None:
        """Cache-coherence hook for a segment removal or swap: the
        routing epoch already moved, making result-cache entries
        unaddressable; negative entries for the table are additionally
        DROPPED — a "prunes to zero" memo recorded against the old segment
        set must not linger in budget either."""
        self._negative_cache.drop_table(table)

    def _check_quota(self, table: str) -> Optional[str]:
        """QPS quota on the LOGICAL name — quotas register unsuffixed, so
        a _OFFLINE/_REALTIME-suffixed query must hit the same bucket
        (ref HelixExternalViewBasedQueryQuotaManager: over-quota queries
        are rejected, not queued). Returns the rejection reason (naming
        the over-budget scope — table or tenant) or None when admitted."""
        if self.quota_manager is None:
            return None
        return self.quota_manager.check(base_table_name(table))

    def _tenant_of(self, table: str) -> Optional[str]:
        """The tenant tag shipped with every server request (weighted-
        fair scheduling group server-side); from the handler's own map
        first, the quota manager's table->tenant map as fallback."""
        base = base_table_name(table)
        tenant = self.tenants.get(base)
        if tenant is None and self.quota_manager is not None:
            tenant = self.quota_manager.tenant_of(base)
        return tenant

    def _timeout_ms(self, ctx: QueryContext) -> float:
        """End-to-end budget for one query, highest precedence first:
        OPTION(timeoutMs=...) / SET timeoutMs, a per-table config
        override (`pinot.broker.timeout.ms.<logicalTable>`), then
        `pinot.broker.timeout.ms`."""
        opt = ctx.options.get("timeoutMs")
        if opt:
            try:
                return max(1.0, float(opt))
            except ValueError:
                pass
        if self.config is not None:
            per_table = self.config.get(
                f"pinot.broker.timeout.ms.{ctx.table}")
            if per_table is not None:
                return max(1.0, float(per_table))
        return self._default_timeout_ms

    def _hedge_delay_s(self) -> Optional[float]:
        """The hedge trigger: the configured floor, capped by the
        ceiling (the JAX broker clamps its selector's pooled p95 into
        [floor, ceiling]; with no selector, as in its MiniCluster, that
        p95 is 0). None when hedging is off — including AUTO-disabled:
        while any server's overload horizon is open, speculative
        duplicate load is exactly the wrong medicine for a fleet already
        shedding (maybe_hedge re-checks per tick, so the gate is live
        mid-gather too)."""
        if not self._hedge_enabled or \
                self.failure_detector.any_overloaded():
            return None
        return min(self._hedge_min_s, self._hedge_max_s)

    def _spend_retry(self, table: str) -> bool:
        """One retry/hedge attempt's budget withdrawal. The
        `broker.retry.budget` failpoint fires on every withdrawal —
        seeded chaos forces exhaustion deterministically (armed with
        error=FailpointError), and its decision journal replays
        byte-identical."""
        try:
            fire("broker.retry.budget", table=table)
        except FailpointError:
            self._metrics.add_meter("broker_retry_budget_exhausted")
            return False
        return self._retry_budget.try_withdraw(table)

    @staticmethod
    def _phase(phase: str, detail: str = "") -> None:
        """Update the in-flight registry for the CURRENT query's trace
        (no-op when tracing is off) — /debug/queries reads it."""
        req = tracing.current_request()
        if req is not None:
            trace_store.get_inflight("broker").phase(
                req.trace_id, phase, detail)

    def handle(self, sql: str) -> BrokerResponse:
        """Traced entry point: every query runs under a shadow span tree
        (tracing.RequestTrace). trace=true queries return the stitched
        cross-process tree as traceInfo; queries at/over
        pinot.broker.slow.query.threshold.ms retain their tree in the
        broker trace store (tail-based capture) and emit a structured
        slow-query log line even with trace=false."""
        rt = tracing.RequestTrace(sampled=False)
        inflight = trace_store.get_inflight("broker")
        inflight.begin(rt.trace_id, sql=sql, trace_id=rt.trace_id)
        try:
            with rt:
                resp = self._handle_inner(sql)
        finally:
            inflight.end(rt.trace_id)
        self._meter_response(resp)
        dur = rt.root.duration_ms
        self._metrics.add_timing("broker_query_ms", dur,
                                 exemplar=rt.trace_id)
        slow = (self._slow_threshold_ms > 0
                and dur >= self._slow_threshold_ms)
        if rt.sampled:
            resp.trace = rt.to_dict()
        if rt.sampled or slow:
            trace_store.get_store("broker", self._trace_capacity).record(
                rt.trace_id, rt.to_dict(), sql=sql, duration_ms=dur,
                slow=slow,
                extra={"partialResult": bool(resp.partial_result)})
            if slow:
                trace_store.log_slow_query(
                    "broker", rt.trace_id, sql, dur,
                    self._slow_threshold_ms,
                    partialResult=bool(resp.partial_result),
                    exceptions=len(resp.exceptions or []))
                self._metrics.add_meter("slow_queries")
        return resp

    def _meter_response(self, resp) -> None:
        """Per-response counters: total queries, responses carrying any
        exception, responses carrying an errorCode-250 (deadline) entry,
        and overload rejections no replica absorbed."""
        self._metrics.add_meter("broker_queries")
        excs = [e for e in (resp.exceptions or []) if isinstance(e, dict)]
        if excs:
            self._metrics.add_meter("broker_query_errors")
        if any(e.get("errorCode") == errorcodes.EXECUTION_TIMEOUT
               for e in excs):
            self._metrics.add_meter("broker_error_code_250")
        if any(e.get("errorCode") == errorcodes.SERVER_OVERLOADED
               for e in excs):
            self._metrics.add_meter("broker_overload_partials")

    def _timed_request(self, conn, server, physical_table, sql,
                       segment_names, request_id, extra_filter,
                       deadline=None, query_id=None, tenant=None,
                       group=None, trace_wire=None):
        """conn.request with the failpoint sites. The remaining budget
        is computed HERE, on the pool thread at
        send time — computing it at submit time would inflate the
        shipped budget by however long the task sat in the fan-out
        queue. group: the replica-group index this scatter targets —
        the `broker.group.scatter` chaos site fires with it, so a
        schedule can kill exactly one fault domain (`where={"group": 0}`)
        and the failure rides the normal connection-error path."""
        fire("broker.scatter.before", server=server, table=physical_table)
        if group is not None:
            fire("broker.group.scatter", server=server,
                 table=physical_table, group=group)
        timeout_ms = (max(1.0, (deadline - time.time()) * 1000.0)
                      if deadline is not None else None)
        return conn.request(physical_table, sql, segment_names,
                            request_id, extra_filter,
                            timeout_ms=timeout_ms, query_id=query_id,
                            tenant=tenant, trace_ctx=trace_wire)

    def _handle_inner(self, sql: str) -> BrokerResponse:
        start = time.time()
        req_trace = tracing.current_request()
        root_h = tracing.capture()
        self._phase("parse")
        try:
            # the parse and the plan are spans of their own (not in the
            # JAX tree): a trace splits the broker's own time
            with tracing.Scope("BrokerParse"):
                ctx = QueryContext.from_query(parse_sql(sql))
        except (SqlParseError, ValueError) as e:
            return _error_response(errorcodes.SQL_PARSING,
                                   f"SQLParsingError: {e}", start)
        if req_trace is not None:
            # the client's trace=true upgrades the shadow trace to a
            # sampled one: the stitched tree returns as traceInfo
            if ctx.options.get("trace", "").lower() == "true":
                req_trace.sampled = True
            root_h.set(table=ctx.table)
        quota_reason = self._check_quota(ctx.table)
        if quota_reason:
            return _error_response(
                errorcodes.QUOTA_EXCEEDED,
                f"QuotaExceededError: {quota_reason}", start)
        self._phase("route", ctx.table)
        route = self.routing.get_route(ctx.table)
        if route is None:
            return _error_response(
                errorcodes.TABLE_DOES_NOT_EXIST,
                f"TableDoesNotExistError: {ctx.table}", start)

        # -- tier-1 whole-result cache ---------------------------------
        # keyed by (query fingerprint, table, routing epoch): the epoch
        # hashes the segment set + versions, so segment add/replace/remove
        # invalidates by construction. Tables with consuming segments are
        # skipped — appends don't move the epoch.
        cache_key = None
        offline_key = None  # hybrid offline-partial cache key
        cacheable = False
        if self.result_cache is not None and self.result_cache.enabled \
                and not ctx.explain \
                and ctx.options.get("trace", "").lower() != "true":
            cacheable = not cache_bypassed(ctx.options)
            if cacheable and not route.has_realtime:
                epoch = route.epoch()
                if not epoch.startswith("<torn:"):
                    # a torn epoch never repeats: a get can't hit and a
                    # put would leak an unaddressable entry — skip both
                    cache_key = (ctx.fingerprint(), ctx.table, epoch)
                    hit = self.result_cache.get(*cache_key)
                    if hit is not None:
                        hit.cache_hit = True
                        hit.time_used_ms = (time.time() - start) * 1000.0
                        return hit

        # -- negative cache: pruned-to-zero plans ----------------------
        # independent of (and cheaper than) the whole-result cache: a
        # dashboard misfire whose pruning selects NO segment has an empty
        # answer by construction — memoize the emptiness, epoch-keyed,
        # and skip routing + scatter + reduce on repeats
        neg_key = None
        if not ctx.explain \
                and ctx.options.get("trace", "").lower() != "true":
            if not cache_bypassed(ctx.options):
                neg_epoch = route.epoch()
                if not neg_epoch.startswith("<torn:"):
                    neg_key = (ctx.fingerprint(), ctx.table, neg_epoch)
                    if self._negative_cache.hit(*neg_key):
                        resp = reduce_results(ctx, [])
                        resp.cache_hit = True
                        resp.time_used_ms = (time.time() - start) * 1000.0
                        return resp

        with tracing.Scope("BrokerRoute"):
            plan = route.route(ctx, unhealthy=self.failure_detector
                               .unhealthy_servers())
        if neg_key is not None and not plan and route.prunes_to_zero(ctx):
            self._negative_cache.put(*neg_key)
        request_id = self._next_id()
        #: unique across brokers — the server accountant keys cancels on it
        query_id = f"{self._broker_nonce}-{request_id}"
        #: end-to-end budget: servers get the REMAINING slice at send
        #: time, waits below derive from it, and expiry cancels leftovers
        timeout_ms = self._timeout_ms(ctx)
        deadline = start + timeout_ms / 1000.0
        hedge_delay_s = self._hedge_delay_s()
        hedge_at = None if hedge_delay_s is None else start + hedge_delay_s
        results, exceptions, server_stats = [], [], []
        responded = 0
        attempted: set = set()
        failed_servers: set = set()

        # -- hybrid-table offline-partial cache ------------------------
        # when the whole result is uncacheable because of a consuming
        # side, the OFFLINE side's merged partial still is: keyed by the
        # offline epoch, so only the realtime entries re-scatter. The
        # partial is the raw per-server result list — reduce merges it
        # with the realtime side's fresh results exactly as if the
        # offline servers had answered.
        offline_results: list = []
        offline_stats: list = []
        offline_failed = [False]
        if cacheable and cache_key is None \
                and route.offline is not None and route.has_realtime:
            off_epoch = route.offline_epoch()
            if not off_epoch.startswith("<torn:"):
                key = (ctx.fingerprint(), ctx.table, off_epoch)
                # READ whenever the epoch is clean: stored partials are
                # complete by construction (see the PUT gate), so during
                # an offline-server outage the cache is strictly better
                # than the degraded scatter routing would attempt
                cached = self.result_cache.get_offline_partial(*key)
                if cached is not None:
                    cached_results, cached_stats = cached
                    results.extend(cached_results)
                    if cached_stats is not None:
                        server_stats.append(cached_stats)
                    plan = [e for e in plan
                            if not e[1].endswith("_OFFLINE")]
                else:
                    # PUT only when the plan covers every unpruned
                    # offline segment: a segment with no placeable
                    # replica is silently dropped from the plan (routing
                    # tolerates it; the query degrades), but the epoch
                    # hashes the segment SET, not placement — a partial
                    # missing those rows would be served as complete
                    # until TTL
                    planned_off = {n for _srv, tbl, names, _ef in plan
                                   if tbl.endswith("_OFFLINE")
                                   for n in names}
                    if planned_off == route.offline_segments_for(ctx):
                        offline_key = key

        units: List[_ScatterUnit] = []
        #: live future -> (unit, server, is_hedge, attempt id, span)
        fut_map: Dict = {}
        attempt_seq = [0]
        tenant = self._tenant_of(ctx.table)
        if req_trace is not None:
            # /debug/queries actionability: the in-flight entry carries
            # WHOSE query this is and how much budget remains
            trace_store.get_inflight("broker").annotate(
                req_trace.trace_id, tenant=tenant, deadline=deadline)

        #: per-query memo for (table, server) -> group index: the
        #: derivation scans every segment's replica list, which is too
        #: expensive to repeat per scatter ATTEMPT on large tables
        #: (non-grouped tables short-circuit to None without scanning)
        group_idx_memo: Dict[tuple, Optional[int]] = {}

        def group_of(table: str, server: str) -> Optional[int]:
            key = (table, server)
            if key not in group_idx_memo:
                group_idx_memo[key] = route.group_index_of(table, server)
            return group_idx_memo[key]

        def group_exclude(table: str, servers) -> set:
            """Whole-group demotion: for replica-group tables the fault
            domain of every failed server is excluded, so a retry/hedge
            re-scatters onto a SURVIVING group instead of splitting the
            query across a half-dead one."""
            out: set = set()
            for s in servers:
                out |= route.group_peers(table, s)
            return out

        def launch(unit: _ScatterUnit, server: str,
                   is_hedge: bool = False) -> bool:
            conn = self.connections.get(server)
            if conn is None:
                if is_hedge:
                    # a hedge that can't launch is simply no hedge — the
                    # primary is still racing and may return the whole
                    # answer; an exception here would poison it
                    return False
                attempted.add(server)
                # a silently skipped server would return a clean-looking
                # partial aggregate; surface it as a server error
                exceptions.append(
                    {"errorCode": errorcodes.SERVER_ERROR,
                     "message": f"ServerNotConnected: {server}"})
                if unit.table.endswith("_OFFLINE"):
                    offline_failed[0] = True
                return False
            attempted.add(server)
            # per-ATTEMPT id: server-side registration and cancels key on
            # it, so cancelling a hedge loser can never tombstone a later
            # retry of this query that lands on the same server
            attempt_seq[0] += 1
            aid = f"{query_id}.{attempt_seq[0]}"
            # one span per scatter ATTEMPT: hedge/retry attempts appear
            # as siblings; the server's own tree grafts under it when
            # the response lands (process). The wire context carries a
            # fresh parent span id per attempt.
            sp = trace_wire = None
            if root_h is not None:
                sp = root_h.child(
                    "ServerScatter", server=server, table=unit.table,
                    segments=len(unit.names or ()), attempt=aid,
                    **({"hedge": True} if is_hedge else {}),
                    **({"retry": True} if unit.retried else {}))
                trace_wire = req_trace.wire_context()
            # the time-boundary predicate travels as a separate field,
            # ANDed into the filter TREE server-side — splicing SQL
            # text is unsound (keywords inside identifiers/literals).
            # The server receives the REMAINING budget, not the original:
            # queue time and earlier rounds already spent part of it
            # (_timed_request derives it from the deadline at send time).
            fut = self._pool.submit(
                self._timed_request, conn, server, unit.table, sql,
                unit.names, request_id, unit.extra, deadline, aid,
                tenant, group_of(unit.table, server), trace_wire)
            fut_map[fut] = (unit, server, is_hedge, aid, sp)
            unit.live += 1
            return True

        def cancel_attempt(server: str, aid: str) -> None:
            conn = self.connections.get(server)
            if conn is not None:
                self._cancel_pool.submit(conn.cancel, aid)

        def cancel_family(unit: _ScatterUnit) -> None:
            """The race resolved: stop every losing attempt of this
            logical unit (primary, whole-set hedge, split-hedge children)
            server-side so abandoned work frees its scheduler thread.
            Attempt-scoped, so nothing else of this query is touched."""
            for _f, (u, server, _h, aid, _sp) in list(fut_map.items()):
                if u is unit or u.parent is unit:
                    cancel_attempt(server, aid)

        #: (the unit's place in `units`, its results): the reduce merges
        #: them in plan order, not in the order replies arrive, so an
        #: order-sensitive merge (a t-digest, a float sum) is the same
        #: every run. The JAX broker merges in arrival order.
        unit_results: List[tuple] = []

        def merge(unit: _ScatterUnit, server_results, server_exc,
                  stats_extra) -> None:
            nonlocal responded
            unit_results.append((units.index(unit), server_results))
            if unit.table.endswith("_OFFLINE"):
                if server_exc:
                    offline_failed[0] = True
                else:
                    offline_results.extend(server_results)
                    if stats_extra is not None:
                        offline_stats.append(stats_extra)
            exceptions.extend(server_exc)
            if stats_extra is not None:
                server_stats.append(stats_extra)
            responded += 1

        def typed_failure(error, overload: Optional[dict],
                          suffix: str = "") -> dict:
            """The exception entry a dead logical unit surfaces: an
            overload rejection stays a typed 211 (its retryAfterMs hint
            intact) — NEVER a raw 427, which would read as a dead
            server and double-penalize a merely saturated one."""
            if overload is not None:
                return {"errorCode": errorcodes.SERVER_OVERLOADED,
                        "message": str(overload.get("message", error))
                        + suffix}
            return {"errorCode": errorcodes.SERVER_ERROR,
                    "message": f"ServerError: {error}{suffix}"}

        def resolve_failed(L: _ScatterUnit, error,
                           overload: Optional[dict] = None) -> None:
            """Every attempt of logical unit L is dead: salvage held-back
            errored payloads for still-unanswered segment sets, then
            retry ONLY the unanswered remainder on surviving replicas —
            sharing, not resetting, the original deadline budget, and
            PAYING for the retry from the per-table budget (exhausted
            budget = typed partial, not re-offered load). For grouped
            tables the exclusion demotes each failed server's whole
            group, so the re-scatter lands on a surviving group.
            overload: the typed 211 entry when the unit died of
            admission rejection — retried on at most one other replica
            (retry units never re-retry) and surfaced typed."""
            L.done = True
            for c in L.children:
                c.done = True
            if L.table.endswith("_OFFLINE"):
                offline_failed[0] = True
            for cand in (L, *L.children):
                if cand.fallback is not None \
                        and not (set(cand.names) & L.answered):
                    # a server DID answer (with errors) and no clean twin
                    # covered these segments: better its partial than
                    # re-failing
                    merge(cand, *cand.fallback)
                    L.answered.update(cand.names)
            pending = L.pending_names()
            if not pending:
                return
            if L.retried:
                exceptions.append(typed_failure(error, overload))
                return
            if not self._spend_retry(L.table):
                # budget dry: surface typed instead of amplifying —
                # a fleet-wide failure under load must converge offered
                # load toward the organic rate, not multiply it
                exceptions.append(typed_failure(
                    error, overload, suffix=" (retry budget exhausted)"))
                return
            # exclude everything known-bad: this round's failures, the
            # detector's unhealthy set, AND every failed server's whole
            # replica group — or the single retry can land on another
            # dead server (or split across a half-dead fault domain)
            # while a healthy group exists
            exclude = failed_servers | \
                self.failure_detector.unhealthy_servers() | \
                group_exclude(L.table, failed_servers)
            rerouted, unplaced = route.reroute_segments(
                L.table, pending, exclude=exclude,
                extra_filter=L.extra)
            if unplaced:
                # segments with no surviving replica: surface the
                # loss instead of a clean-looking partial answer
                exceptions.append(typed_failure(
                    error, overload, suffix=f" (segments lost: {unplaced})"))
            for rserver, rtable, rnames, rextra in rerouted:
                child = _ScatterUnit(rserver, rtable, rnames, rextra,
                                     retried=True)
                units.append(child)
                if launch(child, rserver):
                    self._metrics.add_meter("broker_retries_issued")
                else:
                    child.done = True

        def process(fut) -> None:
            unit, server, is_hedge, _aid, sp = fut_map.pop(fut)
            unit.live -= 1
            L = unit.logical
            try:
                # process() only sees completed futures today (the
                # gather loop waits FIRST_COMPLETED), but the wait is
                # bounded by the query's remaining budget anyway so a
                # future that lies about being done can never park the
                # broker thread past the deadline
                payload = fut.result(
                    timeout=max(0.0, deadline - time.time()) + 1.0)
                server_results, server_exc, stats_extra, server_trace = \
                    datatable.deserialize_results_ex(payload)
            except Exception as e:  # noqa: BLE001 — partial results
                if sp is not None:
                    sp.end(error=f"{type(e).__name__}: {e}",
                           outcome="failed")
                # connection-level failure: mark unhealthy (routing skips
                # it until the backoff expires, ref
                # ConnectionFailureDetector — and for grouped tables the
                # selector stops picking the whole group next query)
                self.failure_detector.mark_failure(server)
                failed_servers.add(server)
                if unit.parent is not None:
                    unit.done = True
                if L.done or L.family_live() > 0:
                    # a twin already merged (or is still racing): this
                    # failure loses/defers — it must NOT poison the
                    # offline-partial cache, the data is (or may yet be)
                    # complete from the twin(s)
                    return
                resolve_failed(L, e)
                return
            overload = _overload_entry(server_exc)
            if overload is not None:
                # typed 211 admission rejection: the server is alive and
                # shedding — cool it lightly (NOT a failure mark), stop
                # hedging into the saturation, and retry the unit on at
                # most one other replica if the budget allows; otherwise
                # the rejection surfaces as a typed partial, never a 427
                self._metrics.add_meter("broker_overload_rejections")
                self.failure_detector.mark_overload(
                    server, retry_after_s=_retry_after_s(overload))
                if sp is not None:
                    sp.graft(server_trace)
                    sp.end(outcome="overloaded")
                if unit.parent is not None:
                    unit.done = True
                if L.done or L.family_live() > 0:
                    # a twin already merged (or is still racing): this
                    # rejection loses/defers
                    return
                resolve_failed(L, overload.get("message", "overloaded"),
                               overload=overload)
                return
            self.failure_detector.mark_success(server)
            if unit.parent is None and not unit.retried and not is_hedge:
                # a clean-channel primary response refills the table's
                # retry budget (errored payloads still count: the
                # SERVER answered — amplification risk is about load,
                # not correctness)
                self._retry_budget.deposit(unit.table)
            if sp is not None:
                # the server's own span tree stitches under this
                # attempt's scatter span — ONE cross-process tree
                sp.graft(server_trace)
                sp.end()
            if L.done:
                # hedge race loser — drop, never double-merge
                if sp is not None:
                    sp.set(outcome="loser")
                return
            if unit.parent is None:
                # primary / whole-set hedge attempt: covers ALL of L's
                # segments, so it can merge only while NO child answered
                # (a merged overlap would double-count those segments)
                if L.answered:
                    if L.family_live() == 0:
                        # children died after partially answering and
                        # this full payload can't be split: re-scatter
                        # the unanswered remainder
                        resolve_failed(L, "overlapping partial discarded")
                    return
                if server_exc and L.family_live() > 0:
                    # an ERRORED payload while a twin still races: hold
                    # it back — first CLEAN response wins; this merges
                    # only if no twin delivers a clean answer
                    unit.fallback = (server_results, server_exc,
                                     stats_extra)
                    return
                L.done = True
                for c in L.children:
                    c.done = True
                if L.hedged:
                    self._metrics.add_meter(
                        "hedge_won" if is_hedge else "hedge_wasted")
                    cancel_family(L)
                    if sp is not None:
                        sp.set(outcome="winner")
                merge(unit, server_results, server_exc, stats_extra)
                return
            # split-hedge child: per-segment dedup — merge iff none of
            # its (disjoint-by-construction) segments was answered yet
            if set(unit.names) & L.answered:
                if sp is not None:
                    sp.set(outcome="loser")
                return
            if server_exc and (unit.live > 0 or L.live > 0):
                unit.fallback = (server_results, server_exc, stats_extra)
                return
            unit.done = True
            if sp is not None and is_hedge:
                sp.set(outcome="winner")
            merge(unit, server_results, server_exc, stats_extra)
            L.answered.update(unit.names)
            if not L.pending_names():
                # the child set covered everything: the split hedge won
                L.done = True
                for c in L.children:
                    c.done = True
                self._metrics.add_meter("hedge_won")
                cancel_family(L)

        def maybe_hedge() -> None:
            """Past the hedge delay, duplicate each still-pending
            primary onto different healthy replica(s) ("The Tail at
            Scale"): first clean response wins per segment, losers are
            cancelled. One hedge round per unit — whole-set on a single
            replica when one holds everything, else SPLIT into disjoint
            child units (partially-replicated layouts, where replica
            groups make partial overlap the norm)."""
            if hedge_at is None or time.time() < hedge_at:
                return
            if self._hedge_delay_s() is None:
                # live auto-disable: a server reported overload AFTER
                # this query started —
                # speculative duplicate load must stop immediately, not
                # at the next query
                return
            for unit in list(units):
                if unit.done or unit.live == 0 or unit.hedge_tried \
                        or unit.retried or unit.parent is not None:
                    continue
                unit.hedge_tried = True
                exclude = ({unit.server} | failed_servers
                           | self.failure_detector.unhealthy_servers()
                           | group_exclude(unit.table, [unit.server]))
                entries, unplaced = route.reroute_segments(
                    unit.table, unit.names, exclude=exclude,
                    extra_filter=unit.extra)
                if unplaced or not entries:
                    continue  # some segment has no other healthy replica
                if (deadline - time.time()) * 1000.0 < 1.0:
                    continue  # no budget left to hedge into
                if not self._spend_retry(unit.table):
                    continue  # hedges are retries too: budget governs both
                if len(entries) == 1:
                    if launch(unit, entries[0][0], is_hedge=True):
                        unit.hedged = True
                        self._metrics.add_meter("hedge_issued")
                    continue
                # split hedge: one child per replica, disjoint segment
                # subsets that together cover the whole pending set
                launched = False
                for hserver, htable, hnames, hextra in entries:
                    child = _ScatterUnit(hserver, htable, hnames, hextra,
                                         parent=unit)
                    child.hedge_tried = True
                    if launch(child, hserver, is_hedge=True):
                        unit.children.append(child)
                        units.append(child)
                        launched = True
                    else:
                        child.done = True
                if launched:
                    unit.hedged = True
                    self._metrics.add_meter("hedge_issued")
                    self._metrics.add_meter("hedge_split")

        self._phase("scatter", ctx.table)
        for server, physical_table, segment_names, extra_filter in plan:
            unit = _ScatterUnit(server, physical_table, segment_names,
                                extra_filter)
            units.append(unit)
            if not launch(unit, server):
                unit.done = True

        self._phase("gather", ctx.table)
        # -- gather: deadline-derived waits, no per-future magic numbers.
        # Exit as soon as every UNIT resolved — a hedge race's losing
        # future may stay in flight long after its unit completed, and
        # waiting for it would forfeit the hedge's entire latency win.
        while fut_map and not all(u.done for u in units):
            now = time.time()
            if now >= deadline:
                break
            wait_until = deadline
            if hedge_at is not None and any(
                    not u.done and not u.hedge_tried and not u.retried
                    for u in units):
                wait_until = min(wait_until, hedge_at)
            done, _pending = _fut_wait(list(fut_map),
                                       timeout=max(0.0, wait_until - now),
                                       return_when=FIRST_COMPLETED)
            for fut in done:
                process(fut)
            maybe_hedge()

        abandoned: Dict[int, Tuple[_ScatterUnit, List[str]]] = {}
        for fut, (unit, server, _h, aid, sp) in fut_map.items():
            if not unit.done:
                abandoned.setdefault(id(unit), (unit, []))[1].append(server)
                cancel_attempt(server, aid)
                if sp is not None:
                    sp.end(outcome="abandoned")
            elif sp is not None:
                # hedge-race loser whose future is still in flight when
                # the gather exits (process() will never run for it):
                # close its span honestly — duration = time until the
                # race resolved against it, no server tree
                sp.end(outcome="loser")
        if abandoned:
            # deadline expired with work outstanding: surface a typed
            # 250 partial per abandoned unit, cancel the server-side
            # work (attempt-scoped), and cool the slow servers so the
            # next queries prefer other replicas
            for unit, servers in abandoned.values():
                unit.done = True
                if unit.fallback is not None \
                        and not (set(unit.names) & unit.logical.answered):
                    # better an errored answer a server actually gave
                    # than nothing (overlap-guarded: segments a clean
                    # split-hedge twin already answered must not merge
                    # twice) — the 250 below still records that the
                    # clean twin never arrived
                    merge(unit, *unit.fallback)
                    unit.logical.answered.update(unit.names)
                if unit.table.endswith("_OFFLINE"):
                    offline_failed[0] = True
                for server in servers:
                    self.failure_detector.mark_timeout(server)
                exceptions.append({
                    "errorCode": BrokerTimeoutError.ERROR_CODE,
                    "message": (
                        f"BrokerTimeoutError: server(s) {sorted(servers)} "
                        f"did not respond within {int(timeout_ms)}ms "
                        f"({len(unit.names or [])} segments abandoned)")})
            self._metrics.add_meter("deadline_expired")
        fut_map.clear()

        if offline_key is not None and offline_results \
                and not offline_failed[0]:
            # complete, clean offline side: reusable until the offline
            # epoch moves (a retry-salvaged round is conservatively NOT
            # cached — offline_failed stays set once any entry failed).
            # Server-level stats ride along so a cache-served response
            # reports the same pruning counts as an uncached run.
            merged_stats = None
            if offline_stats:
                merged_stats = ExecutionStats()
                for s in offline_stats:
                    merged_stats.merge(s)
            self.result_cache.put_offline_partial(*offline_key,
                                                  offline_results,
                                                  stats=merged_stats)

        self._phase("reduce", ctx.table)
        for _i, server_results in sorted(unit_results, key=lambda u: u[0]):
            results.extend(server_results)
        with tracing.Scope("BrokerReduce", servers=responded):
            resp = reduce_results(ctx, results)
        for extra in server_stats:
            resp.stats.merge(extra)
        resp.exceptions = exceptions
        # any exception here means data went missing (timeout, dead
        # server, lost segments) or a server answered with an error —
        # either way the merged answer is not the whole answer
        resp.partial_result = bool(exceptions)
        resp.num_servers_queried = len(attempted)
        resp.num_servers_responded = responded
        resp.time_used_ms = (time.time() - start) * 1000.0
        if cache_key is not None:
            # put() itself refuses partial/errored responses. Hedged and
            # retry-salvaged rounds land queried != responded, which the
            # gate also refuses — DELIBERATELY: a repeat of that query
            # must re-exercise the slow/dead server, not replay a cached
            # answer past it.
            self.result_cache.put(*cache_key, resp)
        return resp


def _error_response(code: int, message: str, start: float) -> BrokerResponse:
    resp = BrokerResponse()
    resp.exceptions = [{"errorCode": code, "message": message}]
    resp.time_used_ms = (time.time() - start) * 1000.0
    return resp

