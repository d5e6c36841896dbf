"""The broker's units against the JAX package's, one event sequence at a
time: the same inputs through each package's class, the same outputs.

- routing (broker/routing.py): the segment -> server cover of balanced
  and replica-group routes (health, stickiness, a degraded group),
  partition pruning, the hybrid time boundary's extra filters,
  `prunes_to_zero`, `offline_segments_for`, `group_peers`,
  `group_index_of`, `reroute_segments` and the routing epoch (the same
  sha1 hex in both packages, moved by an add, a replace and a boundary
  move, not by a replica move);
- the failure detector (seeded jitter), the retry budget and the quota
  buckets (table and tenant, all-or-nothing);
- the LRU/TTL cache on a fake clock, the negative cache and the result
  cache (a complete response cached, a partial refused, a hybrid offline
  partial, the typed codec's bytes decoded to the same response);
- the trace store and the in-flight registry, and the port's tracing
  additions (a server's tree grafted under a span, the sampled upgrade,
  the wire context).
"""
import random

import pytest

from pinot_tpu.broker import adaptive as jax_adaptive
from pinot_tpu.broker import failure_detector as jax_fd
from pinot_tpu.broker import quota as jax_quota
from pinot_tpu.broker import routing as jax_routing
from pinot_tpu.cache import broker_cache as jax_bcache
from pinot_tpu.cache import core as jax_core
from pinot_tpu.query.context import QueryContext as JaxContext
from pinot_tpu.query.reduce import BrokerResponse as JaxResponse
from pinot_tpu.query.reduce import ResultTable as JaxTable
from pinot_tpu.utils import trace_store as jax_ts
from pinot_tpu.utils import errorcodes as jax_codes
from pinot_tpu_torch.broker import adaptive, failure_detector, quota, routing
from pinot_tpu_torch.cache import broker_cache, core
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.reduce import BrokerResponse, ResultTable
from pinot_tpu_torch.query.results import AggregationResult, ExecutionStats
from pinot_tpu_torch.utils import errorcodes, trace_store, tracing
from pinot_tpu_torch.utils.metrics import MetricsRegistry


# -- routing ---------------------------------------------------------------

def _segments(mod, n_seg: int, servers, groups: int, parts: int):
    """n_seg segments over `servers`: segment i on servers[i % n], its
    replicas the next ones (group-ordered when grouped); with parts, the
    partition of segment i is i % parts on column `p`."""
    out = {}
    n = len(servers)
    copies = max(groups, 1)
    for i in range(n_seg):
        reps = [servers[(i + g) % n] for g in range(copies)]
        if groups >= 2:
            # group g's replica is always servers[g-th half]: a grouped
            # table's server list is group-ordered
            half = n // groups
            reps = [servers[g * half + i % half] for g in range(groups)]
        out[f"s_{i}"] = mod.SegmentInfo(
            name=f"s_{i}", servers=reps,
            partition_id=(i % parts) if parts else None,
            partition_column="p" if parts else None,
            num_partitions=parts, version=1000 + i)
    return out


def _both_routes(n_seg=8, servers=("a", "b", "c", "d"), groups=0, parts=0,
                 hybrid=False):
    """The same RoutingTable in each package: an offline side, and a
    realtime one split at time boundary 100 when hybrid."""
    out = []
    for mod in (jax_routing, routing):
        off = mod.TableRoute("t_OFFLINE", time_column="ts",
                             num_replica_groups=groups)
        off.segments.update(_segments(mod, n_seg, list(servers), groups,
                                      parts))
        rt = None
        if hybrid:
            rt = mod.TableRoute("t_REALTIME", time_column="ts")
            rt.segments.update({f"r_{i}": mod.SegmentInfo(
                f"r_{i}", [servers[i % len(servers)]]) for i in range(3)})
        mgr = mod.BrokerRoutingManager()
        mgr.set_route("t", mod.RoutingTable(
            offline=off, realtime=rt, time_boundary=100 if hybrid else None))
        out.append(mgr)
    return out


def _ctx(sql):
    return JaxContext.from_sql(sql), QueryContext.from_sql(sql)


def _plan(plan):
    return sorted((s, t, sorted(n), e) for s, t, n, e in plan)


ROUTE_SQL = ["SELECT COUNT(*) FROM t",
             "SELECT COUNT(*) FROM t WHERE p = 2",
             "SELECT COUNT(*) FROM t WHERE p IN (1, 6) AND x > 3",
             "SELECT COUNT(*) FROM t WHERE p = 'a'",
             "SELECT COUNT(*) FROM t WHERE p = 3 OR p = 1",
             "SELECT SUM(v) FROM t WHERE p = 7 GROUP BY x"]


@pytest.mark.parametrize("layout", ["balanced", "grouped", "partitioned",
                                    "hybrid"])
def test_routing_plans_match_jax(layout):
    kw = {"balanced": {}, "grouped": {"groups": 2},
          "partitioned": {"parts": 4}, "hybrid": {"hybrid": True}}[layout]
    jmgr, tmgr = _both_routes(**kw)
    for table in ("t", "t_OFFLINE", "t_REALTIME", "nosuch"):
        jr, tr = jmgr.get_route(table), tmgr.get_route(table)
        assert (jr is None) == (tr is None)
    jr, tr = jmgr.get_route("t"), tmgr.get_route("t")
    assert jr.epoch() == tr.epoch() and not tr.epoch().startswith("<torn")
    assert jr.offline_epoch() == tr.offline_epoch()
    for unhealthy in (set(), {"a"}, {"a", "c"}, {"a", "b", "c", "d"}):
        for sql in ROUTE_SQL:
            jc, tc = _ctx(sql)
            assert _plan(jr.route(jc, unhealthy)) == \
                _plan(tr.route(tc, unhealthy)), (layout, unhealthy, sql)
            assert jr.prunes_to_zero(jc) == tr.prunes_to_zero(tc)
            assert jr.offline_segments_for(jc) == \
                tr.offline_segments_for(tc)
    for server in ("a", "b", "c", "d", "z"):
        assert jr.group_peers("t_OFFLINE", server) == \
            tr.group_peers("t_OFFLINE", server)
        assert jr.group_index_of("t_OFFLINE", server) == \
            tr.group_index_of("t_OFFLINE", server)
    names = [f"s_{i}" for i in range(8)] + ["gone"]
    for exclude in ({"a"}, {"a", "b"}, {"a", "b", "c", "d"}):
        je, ju = jr.reroute_segments("t_OFFLINE", names, exclude, "x > 1")
        te, tu = tr.reroute_segments("t_OFFLINE", names, exclude, "x > 1")
        assert (_plan(je), ju) == (_plan(te), tu)


def test_replica_group_selector_matches_jax():
    """Stickiness, demotion of an unhealthy group and round-robin, for
    one event sequence."""
    sel = (jax_routing.ReplicaGroupInstanceSelector(sticky_max=3),
           routing.ReplicaGroupInstanceSelector(sticky_max=3))
    groups = [["a", "b"], ["c", "d"], ["e"]]
    rng = random.Random(5)
    for step in range(60):
        unhealthy = set(rng.sample("abcde", rng.randint(0, 2)))
        fp = rng.choice([None, "q1", "q2", "q3", "q4"])
        picks = [s.pick_group("t", groups, unhealthy, fp) for s in sel]
        assert picks[0] == picks[1], (step, unhealthy, fp)


def test_routing_epoch_moves_as_jax():
    jmgr, tmgr = _both_routes(hybrid=True)
    epochs = []
    for mod, mgr in ((jax_routing, jmgr), (routing, tmgr)):
        rt = mgr.get_route("t")
        seen = [rt.epoch()]
        rt.offline.segments["s_9"] = mod.SegmentInfo("s_9", ["a"], version=7)
        seen.append(rt.epoch())
        rt.offline.segments["s_9"] = mod.SegmentInfo("s_9", ["a"], version=8)
        seen.append(rt.epoch())
        rt.offline.segments["s_9"] = mod.SegmentInfo("s_9", ["b"], version=8)
        seen.append(rt.epoch())  # a replica move: the same epoch
        rt.time_boundary = 150
        seen.append(rt.epoch())
        del rt.offline.segments["s_9"]
        seen.append(rt.offline_epoch())
        epochs.append(seen)
    assert epochs[0] == epochs[1]
    assert len(set(epochs[1])) == 5 and epochs[1][2] == epochs[1][3]


# -- failure detector, retry budget, quotas ------------------------------

def test_failure_detector_matches_jax(monkeypatch):
    import pinot_tpu.broker.failure_detector as jmod
    import pinot_tpu_torch.broker.failure_detector as tmod
    now = [1000.0]
    for mod in (jmod, tmod):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
    dets = (jax_fd.ConnectionFailureDetector(jitter_seed=3),
            failure_detector.ConnectionFailureDetector(jitter_seed=3))
    rng = random.Random(11)
    for _ in range(200):
        server = rng.choice("abc")
        op = rng.choice(["failure", "timeout", "overload", "success",
                         "tick"])
        hint = rng.choice([None, 0.5, 30.0])
        for d in dets:
            if op == "failure":
                d.mark_failure(server)
            elif op == "timeout":
                d.mark_timeout(server)
            elif op == "overload":
                d.mark_overload(server, retry_after_s=hint)
            elif op == "success":
                d.mark_success(server)
        if op == "tick":
            now[0] += rng.uniform(0.0, 5.0)
        for fn in ("unhealthy_servers", "overloaded_servers",
                   "any_overloaded"):
            assert getattr(dets[0], fn)() == getattr(dets[1], fn)(), fn
        assert dets[0].failure_count(server) == \
            dets[1].failure_count(server)
        assert dets[0].is_healthy(server) == dets[1].is_healthy(server)


def test_retry_budget_matches_jax():
    budgets = (jax_adaptive.RetryBudget(ratio=0.5, min_tokens=2, cap=4),
               adaptive.RetryBudget(ratio=0.5, min_tokens=2, cap=4))
    rng = random.Random(2)
    for _ in range(100):
        table = rng.choice(["t1", "t2"])
        if rng.random() < 0.4:
            for b in budgets:
                b.deposit(table)
        else:
            got = [b.try_withdraw(table) for b in budgets]
            assert got[0] == got[1]
        assert budgets[0].tokens(table) == budgets[1].tokens(table)


def test_quota_buckets_match_jax(monkeypatch):
    import pinot_tpu.broker.quota as jmod
    import pinot_tpu_torch.broker.quota as tmod
    now = [50.0]
    for mod in (jmod, tmod):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    mgrs = (jax_quota.QueryQuotaManager(), quota.QueryQuotaManager())
    for m in mgrs:
        m.set_quota("t1", 2.0)
        m.set_quota("t2", 0.5)
        m.set_tenant_quota("blue", 3.0)
        m.set_table_tenant("t1", "blue")
        m.set_table_tenant("t3", "blue")
    rng = random.Random(4)
    for _ in range(120):
        tables = rng.choice([["t1"], ["t2"], ["t3"], ["t1", "t3"],
                             ["t2", "t1"]])
        got = [m.check_many(tables) for m in mgrs]
        assert got[0] == got[1], tables
        now[0] += rng.choice([0.0, 0.1, 0.4, 1.5])
    assert mgrs[1].quota_of("t2") == 0.5 and mgrs[1].tenant_of("t1") == \
        "blue" and mgrs[1].tenant_quota_of("blue") == 3.0


# -- caches ----------------------------------------------------------------

def test_lru_ttl_cache_matches_jax():
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    caches = (jax_core.LruTtlCache(100, 5.0, clock=clock),
              core.LruTtlCache(100, 5.0, clock=clock))
    rng = random.Random(6)
    for _ in range(300):
        key = rng.randrange(12)
        op = rng.random()
        if op < 0.45:
            payload = bytes(rng.randrange(1, 40))
            assert caches[0].put(key, payload) == caches[1].put(key, payload)
        elif op < 0.9:
            assert caches[0].get(key) == caches[1].get(key)
        elif op < 0.95:
            lim = rng.randrange(12)
            assert caches[0].invalidate(lambda k: k < lim) == \
                caches[1].invalidate(lambda k: k < lim)
        else:
            now[0] += rng.uniform(0.0, 4.0)
        assert len(caches[0]) == len(caches[1])
        assert caches[0].size_bytes == caches[1].size_bytes
        assert vars(caches[0].stats) == vars(caches[1].stats)
    assert core.cache_bypassed({"skipCache": "true"}) and \
        core.cache_bypassed({"useCache": "FALSE"}) and \
        not core.cache_bypassed({"trace": "true"})


def test_negative_cache_matches_jax():
    caches = (jax_bcache.NegativeResultCache(),
              broker_cache.NegativeResultCache())
    for c in caches:
        c.put("fp1", "t", "e1")
        c.put("fp2", "t_OFFLINE", "e1")
        c.put("fp3", "u", "e1")
    for key in (("fp1", "t", "e1"), ("fp1", "t", "e2"), ("fp3", "u", "e1")):
        assert caches[0].hit(*key) == caches[1].hit(*key)
    assert caches[0].drop_table("t") == caches[1].drop_table("t") == 2
    assert [c.hit("fp3", "u", "e1") for c in caches] == [True, True]


def _response(mod_resp, mod_table, **kw):
    resp = mod_resp()
    resp.result_table = mod_table(["c", "s"], ["LONG", "DOUBLE"],
                                  [(3, 1.5), (4, -2.25)])
    resp.num_servers_queried = resp.num_servers_responded = 2
    for k, v in kw.items():
        setattr(resp, k, v)
    return resp


def test_result_cache_matches_jax():
    caches = (jax_bcache.BrokerResultCache(),
              broker_cache.BrokerResultCache())
    full = (_response(JaxResponse, JaxTable),
            _response(BrokerResponse, ResultTable))
    partial = (_response(JaxResponse, JaxTable, partial_result=True),
               _response(BrokerResponse, ResultTable, partial_result=True))
    short = (_response(JaxResponse, JaxTable, num_servers_responded=1),
             _response(BrokerResponse, ResultTable, num_servers_responded=1))
    for c, f, p, s in zip(caches, full, partial, short):
        assert c.put("fp", "t", "e1", f)
        assert not c.put("fp", "t", "e2", p)
        assert not c.put("fp", "t", "e3", s)
    got = [c.get("fp", "t", "e1") for c in caches]
    assert [tuple(r) for r in got[1].rows] == \
        [tuple(r) for r in got[0].rows] == [(3, 1.5), (4, -2.25)]
    assert got[1].result_table.columns == ["c", "s"]
    assert got[1].num_servers_queried == 2
    assert [c.get("fp", "t", "e2") for c in caches] == [None, None]
    # a hybrid table's offline partial
    stats = ExecutionStats(num_docs_scanned=5, total_docs=9)
    caches[1].put_offline_partial("fp", "t", "off1",
                                  [AggregationResult([7, 2.5])], stats)
    res, st = caches[1].get_offline_partial("fp", "t", "off1")
    assert res[0].intermediates == [7, 2.5] and st == stats
    with pytest.raises(ValueError, match="tiered"):
        from pinot_tpu_torch.utils.config import PinotConfiguration
        broker_cache.BrokerResultCache.from_config(PinotConfiguration(
            {"pinot.broker.result.cache.backend": "tiered"}))


# -- tracing, the trace store, the in-flight registry ---------------------

def test_trace_store_matches_jax():
    stores = (jax_ts.TraceStore(capacity=3), trace_store.TraceStore(
        capacity=3))
    for s in stores:
        for i in range(5):
            s.record(f"t{i}", {"operator": "X", "n": i}, sql=f"q{i}",
                     duration_ms=i + 0.12345, slow=i % 2 == 0,
                     extra={"partialResult": False})
        s.record("t9@server_1", {"operator": "Y"}, extra={"traceId": "t9"})
    strip = [[{k: v for k, v in e.items() if k != "storedAt"}
              for e in s.recent()] for s in stores]
    assert strip[0] == strip[1] and len(strip[1]) == 3
    for tid in ("t4", "t0", "t9"):
        a, b = (s.get(tid) for s in stores)
        assert (a is None) == (b is None)
        if a is not None:
            assert a["trace"] == b["trace"]


def test_inflight_registry_matches_jax(monkeypatch):
    import pinot_tpu.utils.trace_store as jmod
    import pinot_tpu_torch.utils.trace_store as tmod
    now = [100.0]
    for mod in (jmod, tmod):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
    regs = (jax_ts.InflightRegistry(), trace_store.InflightRegistry())
    for r in regs:
        r.begin("q1", sql="SELECT 1", trace_id="q1")
        r.phase("q1", "route", "t")
        r.begin("q2", sql="SELECT 2", trace_id="q2", deadline=100.5)
    now[0] += 0.25
    for r in regs:
        r.annotate("q1", tenant="blue", deadline=101.0)
        r.phase("q2", "gather")
    assert regs[0].snapshot() == regs[1].snapshot()
    for r in regs:
        r.end("q1")
    assert regs[0].snapshot() == regs[1].snapshot() and len(regs[1]) == 1
    payload = trace_store.debug_payload("broker", "/debug/queries")
    assert payload["role"] == "broker"
    assert trace_store.debug_payload("broker", "/nope") is None


def test_tracing_stitches_and_upgrades():
    """A server's shipped tree grafts under the scatter span; a request's
    sampled flag can be raised from inside it; the wire context carries
    the trace id and a fresh span id."""
    rt = tracing.RequestTrace(sampled=False)
    assert tracing.current_request() is None and not tracing.active()
    with rt:
        assert tracing.current_request() is rt and tracing.active()
        assert tracing.current_trace_id() == rt.trace_id
        tracing.annotate(table="t")
        assert tracing.get_attr("table") == "t"
        tracing.current_request().sampled = True
        h = tracing.capture().child("ServerScatter", server="s0")
        wire = rt.wire_context()
        h.graft({"operator": "ServerRequest", "durationMs": 1.5,
                 "instance": "s0", "children": [
                     {"operator": "DeviceDispatch", "durationMs": 0.5}]})
        h.graft({"broken": object()})  # a torn tree is dropped
        h.end()
    assert tracing.current_request() is None
    assert rt.sampled and wire["traceId"] == rt.trace_id and \
        len(wire["spanId"]) == 8 and wire["sampled"]
    tree = rt.to_dict()
    scatter = tree["children"][0]
    assert scatter["children"][0]["children"][0]["operator"] == \
        "DeviceDispatch"
    assert tracing.TraceContext.from_wire(wire).trace_id == rt.trace_id


def test_exposition_and_error_codes():
    reg = MetricsRegistry("broker")
    reg.add_meter("broker_queries")
    reg.add_meter("x", labels={"t": 'a"b'})
    reg.set_gauge("g", 2.5)
    for ms in (1.0, 2.0, 3.0):
        reg.add_timing("broker_query_ms", ms, exemplar="abc")
    text = reg.prometheus_text()
    assert "# TYPE pinot_tpu_broker_broker_queries counter" in text
    assert 'pinot_tpu_broker_x{t="a\\"b"} 1' in text
    assert 'pinot_tpu_broker_broker_query_ms{quantile="0.5"} 2' in text
    assert '# EXEMPLAR pinot_tpu_broker_broker_query_ms trace_id="abc"' \
        in text
    assert reg.exemplar("broker_query_ms") == "abc"
    for name in ("SQL_PARSING", "TABLE_DOES_NOT_EXIST", "QUERY_EXECUTION",
                 "SERVER_OVERLOADED", "EXECUTION_TIMEOUT", "SERVER_ERROR",
                 "QUOTA_EXCEEDED"):
        assert getattr(errorcodes, name) == getattr(jax_codes, name)
    msg = "overloaded " + jax_codes.format_retry_after(250.4)
    assert errorcodes.parse_retry_after(msg) == \
        jax_codes.parse_retry_after(msg) == 250.0
    assert errorcodes.parse_retry_after("no hint") is None
