"""Broker routing: which server executes which segments.

A copy of pinot_tpu/broker/routing.py on the port's query context.

Reference parity: pinot-broker routing/ — BrokerRoutingManager.java:100
(segment preselect -> select -> prune -> instance select), instance
selectors (BalancedInstanceSelector, ReplicaGroupInstanceSelector),
segment pruners (partition, time), TimeBoundaryManager.java:56 for hybrid
tables.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (Expression, Function,
                                               Identifier, Literal)


#: never-repeating suffix for epochs computed during a torn (concurrently
#: mutated) segment-set iteration — see RoutingTable.epoch()
_torn_epochs = itertools.count(1)


@dataclass
class SegmentInfo:
    name: str
    servers: List[str]                       # replicas holding this segment
    partition_id: Optional[int] = None       # for partition pruning
    partition_column: Optional[str] = None
    num_partitions: int = 0
    start_time: Optional[int] = None         # time-range pruning
    end_time: Optional[int] = None
    #: segment content version (CRC); feeds the routing epoch so a
    #: replace-by-name invalidates broker result-cache entries
    version: int = 0


class _ObservedSegments(dict):
    """Segment dict that bumps its owner's mutation counter on EVERY
    mutating operation. The routing mutation API is direct dict
    assignment (cluster/mini.py add / remove), so memoizing
    epoch() safely requires the invalidation hook to live in the dict
    itself — every mutation site is covered by construction, including
    future ones."""

    __slots__ = ("_route",)

    def __init__(self, route: "TableRoute", *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._route = route

    def _bump(self):
        # next() on itertools.count is atomic at the C level; a plain
        # `+= 1` is load/add/store and can LOSE an increment when two
        # threads mutate concurrently (routing mutators take no lock),
        # leaving the epoch memo valid for a set it no longer matches.
        # Racing bumps may store out of order — the worst case is a
        # spurious recompute, never a stale memo (the memo is only kept
        # while token == current counter).
        self._route.mutation_version = next(self._route._mut_counter)

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._bump()

    def __delitem__(self, k):
        super().__delitem__(k)
        self._bump()

    def pop(self, *args):
        try:
            return super().pop(*args)
        finally:
            self._bump()

    def popitem(self):
        try:
            return super().popitem()
        finally:
            self._bump()

    def clear(self):
        super().clear()
        self._bump()

    def update(self, *args, **kwargs):
        super().update(*args, **kwargs)
        self._bump()

    def __ior__(self, other):
        # dict.__ior__ would mutate in place WITHOUT going through
        # update() — the one hole in "every mutation site is covered"
        self.update(other)
        return self

    def setdefault(self, k, default=None):
        try:
            return super().setdefault(k, default)
        finally:
            self._bump()


@dataclass
class TableRoute:
    """Routing state for one physical table (OFFLINE or REALTIME)."""
    table_name: str
    segments: Dict[str, SegmentInfo] = field(default_factory=dict)
    time_column: Optional[str] = None
    #: >= 2 makes this a replica-group fault domain: each segment's
    #: `servers` list is GROUP-ORDERED (element g = the group-g replica,
    #: the assignment contract), and the broker scatters each query to
    #: ONE group instead of round-robin across replicas
    num_replica_groups: int = 0
    #: bumped by _ObservedSegments on every segment-dict mutation; the
    #: epoch memo keys on it (counter read/compare is GIL-atomic)
    mutation_version: int = 0

    def __post_init__(self):
        self._mut_counter = itertools.count(self.mutation_version + 1)
        if not isinstance(self.segments, _ObservedSegments):
            self.segments = _ObservedSegments(self, self.segments)


class ReplicaGroupInstanceSelector:
    """Pick ONE replica group per query (ref
    routing/instanceselector/ReplicaGroupInstanceSelector.java): every
    segment of the query scatters to the same group, so a query touches
    one fault domain — and a whole-group loss is survivable by
    re-scattering onto another group, which balanced routing cannot
    express.

    Choice discipline, in order:

      1. health — only groups with NO unhealthy member are candidates
         (one dead member would fail part of the scatter; the caller
         falls back to per-segment balanced selection when every group
         is degraded).
      2. stickiness — a query fingerprint maps to the group that served
         it before (bounded LRU): per-segment partial caches and HBM
         residency live on the servers that executed the plan, so
         repeats must land on the same machines to hit them.
      3. round-robin over the healthy groups, for new fingerprints.

    The JAX selector ranks new fingerprints' groups by an adaptive
    selector's latency and by resident bytes the controller's instance
    sweep reports before its round-robin. Its MiniCluster, which the
    port copies, feeds neither, so every group ties and both steps are
    left out until the broker role brings their feeds.
    """

    def __init__(self, sticky_max: int = 4096):
        self.sticky_max = int(sticky_max)
        #: (physical table, query fingerprint) -> group index
        self._sticky: "OrderedDict[tuple, int]" = OrderedDict()
        self._rr = 0
        self._lock = threading.Lock()

    def pick_group(self, physical_table: str,
                   groups: Sequence[Sequence[str]],
                   unhealthy: Set[str],
                   fingerprint: Optional[str] = None) -> Optional[int]:
        """Index of the group this query scatters to, or None when no
        group is fully healthy (caller degrades to per-segment
        selection). Sticky entries are dropped the moment their group
        stops being healthy — demotion, not just avoidance, so the next
        repeat re-evaluates instead of bouncing off the dead group."""
        healthy = [g for g, members in enumerate(groups)
                   if members and not (set(members) & unhealthy)]
        if not healthy:
            return None
        key = None
        if fingerprint is not None:
            key = (physical_table, fingerprint)
            with self._lock:
                g = self._sticky.get(key)
                if g is not None:
                    if g in healthy:
                        self._sticky.move_to_end(key)
                        return g
                    del self._sticky[key]  # demoted group: unstick
        if len(healthy) == 1:
            g = healthy[0]
        else:
            with self._lock:
                g = healthy[self._rr % len(healthy)]
                self._rr += 1
        if key is not None:
            with self._lock:
                self._sticky[key] = g
                self._sticky.move_to_end(key)
                while len(self._sticky) > self.sticky_max:
                    self._sticky.popitem(last=False)
        return g


def _derive_groups(segments: Sequence[SegmentInfo],
                   num_groups: int) -> List[List[str]]:
    """Group membership recovered from the assignment contract: a
    segment's server list is group-ordered, so column g over all
    segments IS group g. No separate group map can drift from the
    placements actually in effect."""
    groups: List[set] = [set() for _ in range(num_groups)]
    for seg in segments:
        for g in range(min(num_groups, len(seg.servers))):
            groups[g].add(seg.servers[g])
    return [sorted(g) for g in groups]


class RoutingTable:
    """segment->servers map + instance selection for one logical table."""

    def __init__(self, offline: Optional[TableRoute] = None,
                 realtime: Optional[TableRoute] = None,
                 time_boundary: Optional[int] = None,
                 group_selector=None):
        self.offline = offline
        self.realtime = realtime
        #: hybrid split: offline serves time <= boundary, realtime the rest
        #: (ref TimeBoundaryManager.java:56)
        self.time_boundary = time_boundary
        #: ReplicaGroupInstanceSelector used for sides with
        #: num_replica_groups >= 2 (one group per query); None falls
        #: back to per-segment selection even for grouped tables
        self.group_selector = group_selector
        self._rr = 0
        self._lock = threading.Lock()
        #: memoized epochs: validity-token tuple -> epoch string. One
        #: entry per side-selection ('both' and 'offline' cache
        #: independently); pins the route objects it hashed so id() reuse
        #: after gc can never alias a stale memo.
        self._epoch_memo: Dict[str, tuple] = {}
        #: number of actual O(#segments) hash passes (test observability
        #: for the memoization contract)
        self.epoch_computes = 0

    @property
    def has_realtime(self) -> bool:
        return self.realtime is not None and bool(self.realtime.segments)

    def epoch(self) -> str:
        """Content hash of the result-affecting routing state: per-side
        segment sets with their versions, plus the hybrid time boundary.
        Any segment add / replace (version change) / remove or boundary
        move yields a new epoch, which is how the broker result cache
        invalidates — stale entries stop being addressable (no explicit
        purge fan-out, TTL + LRU reclaim the bytes). Replica placement is
        deliberately EXCLUDED: moving a segment between servers does not
        change query results.

        MEMOIZED: the O(#segments) hash runs once per segment-set
        mutation, not once per cacheable query — `TableRoute.segments` is
        an observing dict that bumps `mutation_version` at every mutation
        site, and the memo is keyed on (route identity, mutation_version,
        time_boundary). Mutating a SegmentInfo IN PLACE does not move the
        counter; routing rebuilds always swap whole SegmentInfo objects.
        """
        return self._memoized_epoch("both", (self.offline, self.realtime))

    def offline_epoch(self) -> str:
        """Epoch of ONLY the offline side (+ time boundary, which shapes
        the offline extra filter). Key for hybrid-table offline-partial
        caching: realtime appends/commits don't move it, so the offline
        partial stays addressable while the consuming side re-executes."""
        return self._memoized_epoch("offline", (self.offline,))

    def offline_segments_for(self, ctx: QueryContext) -> set:
        """Names of offline segments a COMPLETE plan for `ctx` must
        cover (everything routing wouldn't prune). Callers caching the
        offline partial compare this against what the plan actually
        placed: a segment with no live replica is silently dropped by
        _route_physical, and placement is deliberately outside the
        epoch, so coverage must be checked separately."""
        if self.offline is None:
            return set()
        return {s.name for s in self.offline.segments.values()
                if not _prunable(s, ctx)}

    def prunes_to_zero(self, ctx: QueryContext) -> bool:
        """True when routing would select NO segment for `ctx` purely by
        pruning (or the table is empty) — the negative-cache gate. A
        segment dropped because no replica is placeable does NOT count:
        placement is outside the epoch, so caching that empty answer
        would outlive the outage."""
        for side in (self.offline, self.realtime):
            if side is None:
                continue
            for seg in side.segments.values():
                if not _prunable(seg, ctx):
                    return False
        return True

    def _memoized_epoch(self, which: str, sides: tuple) -> str:
        # identity + mutation counter, never TableRoute.__eq__ (a
        # dataclass eq would walk the whole segment dict — the exact
        # O(#segments) cost being memoized away). The memo entry pins the
        # route objects it hashed, so an id() can't be reused for a
        # different live route while its memo is current.
        token = (tuple(id(s) if s is not None else None for s in sides),
                 tuple(s.mutation_version if s is not None else -1
                       for s in sides),
                 self.time_boundary)
        memo = self._epoch_memo.get(which)
        if memo is not None and memo[0] == token:
            return memo[2]
        value = self._compute_epoch(sides)
        if not value.startswith("<torn:"):
            # torn epochs never repeat by design — memoizing one would
            # repeat it; tuple assignment is atomic under the GIL
            self._epoch_memo[which] = (token, sides, value)
        return value

    def _compute_epoch(self, sides: tuple) -> str:
        """Reads race segment-set mutation (routing mutators don't lock
        the dicts — same read-mostly convention as route()); a torn
        iteration returns a never-repeating epoch, degrading that one
        query to a cache miss instead of failing it."""
        self.epoch_computes += 1
        for _ in range(3):
            try:
                h = hashlib.sha1()
                for side in sides:
                    if side is None:
                        h.update(b"<none>\0")
                        continue
                    h.update(side.table_name.encode())
                    h.update(b"\0")
                    for name in sorted(side.segments):
                        info = side.segments.get(name)
                        if info is None:
                            raise RuntimeError("segment set changed")
                        # NUL-delimited fields: names routinely end in
                        # digits, so 'day_1'+'2345' must not hash like
                        # 'day_12'+'345'
                        h.update(name.encode())
                        h.update(b"\0")
                        h.update(str(info.version).encode())
                        h.update(b"\0")
                h.update(str(self.time_boundary).encode())
                return h.hexdigest()
            except RuntimeError:  # dict resized mid-iteration
                continue
        return f"<torn:{id(self)}:{next(_torn_epochs)}>"

    def route(self, ctx: QueryContext, unhealthy: Optional[Set[str]] = None
              ) -> List[Tuple[str, str, List[str], Optional[str]]]:
        """Returns [(server, physical_table, segment_names, extra_filter)].

        extra_filter is the time-boundary predicate SQL fragment to AND in
        (the reference rewrites the query per physical table the same way).
        unhealthy: servers the failure detector wants skipped — a segment
        whose replicas are ALL unhealthy still routes (partial answers
        beat silently dropped segments, matching the reference's fallback
        when the selector exhausts candidates).
        """
        out: List[Tuple[str, str, List[str], Optional[str]]] = []
        if self.offline is not None:
            extra = None
            if self.realtime is not None and self.time_boundary is not None \
                    and self.offline.time_column:
                extra = f"{self.offline.time_column} <= {self.time_boundary}"
            out.extend(self._route_physical(self.offline, ctx, extra,
                                            unhealthy or set()))
        if self.realtime is not None:
            extra = None
            if self.offline is not None and self.time_boundary is not None \
                    and self.realtime.time_column:
                extra = f"{self.realtime.time_column} > {self.time_boundary}"
            out.extend(self._route_physical(self.realtime, ctx, extra,
                                            unhealthy or set()))
        return out

    # ------------------------------------------------------------------
    def _route_physical(self, route: TableRoute, ctx: QueryContext,
                        extra_filter: Optional[str], unhealthy: Set[str]):
        selected = [s for s in route.segments.values()
                    if not _prunable(s, ctx)]
        if route.num_replica_groups >= 2 and self.group_selector is not None \
                and selected:
            entries = self._route_one_group(route, ctx, selected,
                                            extra_filter, unhealthy)
            if entries is not None:
                return entries
            # no fully-healthy group: degrade to per-segment selection
            # below — known-dead servers are skipped segment by segment,
            # which beats scattering part of the query at a corpse
        per_server: Dict[str, List[str]] = {}
        with self._lock:
            for seg in selected:
                server = _pick_replica(seg.servers, self._rr, unhealthy)
                if server is None:
                    continue
                per_server.setdefault(server, []).append(seg.name)
            self._rr += 1
        return [(server, route.table_name, names, extra_filter)
                for server, names in per_server.items()]

    def _route_one_group(self, route: TableRoute, ctx: QueryContext,
                         selected: List[SegmentInfo],
                         extra_filter: Optional[str],
                         unhealthy: Set[str]):
        """Scatter the WHOLE query to one replica group (the fault-domain
        contract). None when no group is fully healthy."""
        groups = _derive_groups(selected, route.num_replica_groups)
        g = self.group_selector.pick_group(
            route.table_name, groups, unhealthy,
            fingerprint=ctx.fingerprint())
        if g is None:
            return None
        per_server: Dict[str, List[str]] = {}
        with self._lock:
            for seg in selected:
                if g < len(seg.servers):
                    server = seg.servers[g]
                    if server in unhealthy:
                        # stale group view (segment set mutated since
                        # health check): place on any healthy replica
                        server = _pick_replica(seg.servers, self._rr,
                                               unhealthy)
                else:
                    # partially-replicated segment (fewer copies than
                    # groups): fall back per segment rather than drop it
                    server = _pick_replica(seg.servers, self._rr, unhealthy)
                if server is None:
                    continue
                per_server.setdefault(server, []).append(seg.name)
            self._rr += 1
        return [(server, route.table_name, names, extra_filter)
                for server, names in per_server.items()]

    # -- fault-domain introspection ------------------------------------
    def _route_named(self, physical_table: str) -> Optional[TableRoute]:
        for r in (self.offline, self.realtime):
            if r is not None and r.table_name == physical_table:
                return r
        return None

    def group_peers(self, physical_table: str, server: str) -> Set[str]:
        """Every server sharing a replica-group index with `server`
        (itself included) — the demotion set when one member fails
        mid-query: the retry must avoid the WHOLE group, because sending
        the re-scatter to the dead member's healthy peers splits the
        query across fault domains and a second loss in either would
        fail it. Empty for non-grouped tables."""
        route = self._route_named(physical_table)
        if route is None or route.num_replica_groups < 2:
            return set()
        positions = {i for seg in route.segments.values()
                     for i, s in enumerate(seg.servers) if s == server}
        if not positions:
            return set()
        return {seg.servers[i] for seg in route.segments.values()
                for i in positions if i < len(seg.servers)}

    def group_index_of(self, physical_table: str,
                       server: str) -> Optional[int]:
        """The replica-group index `server` serves for this table (its
        lowest position across segment replica lists) — failpoint/test
        observability for group-scoped chaos. None when ungrouped or
        unknown."""
        route = self._route_named(physical_table)
        if route is None or route.num_replica_groups < 2:
            return None
        positions = [i for seg in route.segments.values()
                     for i, s in enumerate(seg.servers) if s == server]
        return min(positions) if positions else None

    def reroute_segments(self, physical_table: str, segment_names: List[str],
                         exclude: Set[str], extra_filter: Optional[str]):
        """Re-place segments on surviving replicas after a server failed
        mid-query (ref QueryRouter retry on unhealthy server). Returns
        (entries, unplaced_segment_names) — unplaced segments have NO
        surviving replica and must surface as an error, never silently
        vanish from the answer. For replica-group tables the shared rr
        index makes the re-placement CONVERGE: excluding the demoted
        group leaves every segment's surviving replicas in the same
        group order, so one rr value lands all of them on one surviving
        group."""
        route = self._route_named(physical_table)
        if route is None:
            return [], list(segment_names)
        per_server: Dict[str, List[str]] = {}
        unplaced: List[str] = []
        with self._lock:
            for name in segment_names:
                seg = route.segments.get(name)
                if seg is None:
                    unplaced.append(name)
                    continue
                server = _pick_replica(seg.servers, self._rr, exclude,
                                       strict=True)
                if server is None:
                    unplaced.append(name)
                    continue
                per_server.setdefault(server, []).append(seg.name)
            self._rr += 1
        return ([(server, physical_table, names, extra_filter)
                 for server, names in per_server.items()], unplaced)


def _pick_replica(servers: List[str], rr: int, skip: Set[str],
                  strict: bool = False) -> Optional[str]:
    """Balanced selection over healthy replicas (ref
    BalancedInstanceSelector); falls back to ANY replica when all are
    marked unhealthy — unless strict (mid-query retry must not resend to
    the server that just failed)."""
    if not servers:
        return None
    healthy = [s for s in servers if s not in skip]
    if healthy:
        return healthy[rr % len(healthy)]
    if strict:
        return None
    return servers[rr % len(servers)]


def _prunable(seg: SegmentInfo, ctx: QueryContext) -> bool:
    """Partition pruning (ref broker/routing/segmentpruner/): a segment
    can be skipped when an EQ/IN filter on the partition column proves
    EVERY matching row hashes to a different partition."""
    if ctx.filter is None or seg.partition_column is None or not seg.num_partitions:
        return False
    values = _partition_values(ctx.filter, seg.partition_column)
    if not values:
        return False
    for value in values:
        p = _modulo_partition(value, seg.num_partitions)
        if p is None:  # non-numeric value: cannot prove mismatch, keep
            return False
        if p == seg.partition_id:
            return False
    return True


def _partition_values(expr: Expression, column: str) -> Optional[list]:
    """Literal values a top-level (AND-reachable) EQ or IN predicate on
    `column` restricts rows to — the partition-pruning surface. None
    when no such predicate constrains the column (or an IN carries a
    non-literal operand, which makes the value set unprovable)."""
    if not isinstance(expr, Function):
        return None
    if expr.name == "and":
        for a in expr.args:
            v = _partition_values(a, column)
            if v is not None:
                return v
        return None
    if not expr.args or not isinstance(expr.args[0], Identifier) \
            or expr.args[0].name != column:
        return None
    if expr.name == "equals" and len(expr.args) == 2 \
            and isinstance(expr.args[1], Literal):
        return [expr.args[1].value]
    if expr.name == "in" and len(expr.args) >= 2:
        if all(isinstance(a, Literal) for a in expr.args[1:]):
            return [a.value for a in expr.args[1:]]
    return None


def _modulo_partition(value, num_partitions: int) -> Optional[int]:
    """Ref segment-spi partition/ModuloPartitionFunction — numeric-only.
    Returns None for non-numeric values: Python's salted str hash is not
    stable across processes, so using it would silently mis-prune."""
    try:
        return int(value) % num_partitions
    except (TypeError, ValueError):
        return None


class BrokerRoutingManager:
    """All tables' routing state (ref BrokerRoutingManager.java:100).
    cluster/mini.py writes it on every table and segment change."""

    def __init__(self, group_selector=None):
        self._tables: Dict[str, RoutingTable] = {}
        #: memoized single-side views for suffix-addressed queries
        #: ('tbl_OFFLINE'): a fresh wrapper per get_route would carry an
        #: empty epoch memo, re-hashing O(#segments) per query — the
        #: exact cost the epoch memoization removes
        self._suffix_views: Dict[str, RoutingTable] = {}
        #: shared ReplicaGroupInstanceSelector: one per broker, so
        #: fingerprint stickiness and residency hints span all tables
        self.group_selector = (ReplicaGroupInstanceSelector()
                               if group_selector is None else group_selector)
        self._lock = threading.Lock()

    def set_route(self, logical_table: str, routing: RoutingTable) -> None:
        if routing.group_selector is None:
            routing.group_selector = self.group_selector
        with self._lock:
            self._tables[logical_table] = routing
            for suffix in ("_OFFLINE", "_REALTIME"):
                self._suffix_views.pop(logical_table + suffix, None)

    def get_route(self, table: str) -> Optional[RoutingTable]:
        from pinot_tpu_torch.models import base_table_name
        base = base_table_name(table)
        with self._lock:
            rt = self._tables.get(base)
            if rt is None:
                return None
            if base == table:
                return rt
            view = self._suffix_views.get(table)
            if view is None:
                # the view SHARES the underlying TableRoute, so segment
                # mutations flow through; only the memo lives here
                view = (RoutingTable(offline=rt.offline)
                        if table.endswith("_OFFLINE")
                        else RoutingTable(realtime=rt.realtime))
                view.group_selector = rt.group_selector
                self._suffix_views[table] = view
            return view

    @property
    def table_names(self) -> List[str]:
        with self._lock:
            return list(self._tables.keys())
