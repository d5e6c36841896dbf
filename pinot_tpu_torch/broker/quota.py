"""Per-table and per-tenant query quotas: token-bucket QPS limits.

A copy of pinot_tpu/broker/quota.py.

Reference parity: pinot-broker
queryquota/HelixExternalViewBasedQueryQuotaManager.java — per-table
maxQueriesPerSecond from TableConfig, enforced broker-side with a rate
limiter; exceeding it rejects the query (the reference meters and
answers 429-equivalent errors) instead of letting a runaway tenant
starve the cluster. Layered on top: per-TENANT
buckets (the table->tenant map comes from TableConfig tenant tags), so
one tenant's whole table fleet shares a ceiling — a noisy tenant's
flood is rejected at the broker edge before it can crowd the scatter
pool, and the rejection names the tenant, not an innocent table.

Acquisition is all-or-nothing across both scopes: a query consumes a
table token AND a tenant token only when BOTH buckets have one —
otherwise a rejected query would still drain the surviving scope's
budget and the 429s would cascade onto well-behaved tables.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class _Bucket:
    def __init__(self, qps: float):
        self.qps = qps
        #: burst capacity >= 1 so fractional quotas (0.5 QPS = one query
        #: per 2s) still admit queries instead of rejecting forever
        self.cap = max(qps, 1.0)
        self.tokens = self.cap
        self.last = time.monotonic()

    def refill(self) -> None:
        now = time.monotonic()
        self.tokens = min(self.cap, self.tokens + (now - self.last) * self.qps)
        self.last = now

    def has_token(self) -> bool:
        return self.tokens >= 1.0

    def take(self) -> None:
        self.tokens -= 1.0

    def try_acquire(self) -> bool:
        self.refill()
        if self.has_token():
            self.take()
            return True
        return False


class QueryQuotaManager:
    def __init__(self):
        self._buckets: Dict[str, _Bucket] = {}
        self._tenant_buckets: Dict[str, _Bucket] = {}
        self._table_tenant: Dict[str, str] = {}
        self._lock = threading.Lock()

    # -- configuration -------------------------------------------------
    def set_quota(self, table: str, qps: Optional[float]) -> None:
        """qps None/<=0 removes the limit."""
        with self._lock:
            self._set(self._buckets, table, qps)

    def set_tenant_quota(self, tenant: str, qps: Optional[float]) -> None:
        """Cluster-wide QPS ceiling for one tenant's whole table fleet."""
        with self._lock:
            self._set(self._tenant_buckets, tenant, qps)

    @staticmethod
    def _set(buckets: Dict[str, _Bucket], key: str,
             qps: Optional[float]) -> None:
        if qps is None or qps <= 0:
            buckets.pop(key, None)
        else:
            cur = buckets.get(key)
            if cur is None or cur.qps != qps:
                buckets[key] = _Bucket(qps)

    def set_table_tenant(self, table: str, tenant: Optional[str]) -> None:
        """Record which tenant's bucket a table's queries draw from."""
        with self._lock:
            if tenant:
                self._table_tenant[table] = tenant
            else:
                self._table_tenant.pop(table, None)

    # -- enforcement ---------------------------------------------------
    def check(self, table: str) -> Optional[str]:
        """None when admitted (tokens consumed); otherwise the rejection
        reason — naming the scope that is actually over budget."""
        return self.check_many([table])

    def check_many(self, tables) -> Optional[str]:
        """All-or-nothing admission for a query reading SEVERAL tables
        (the MSE tree): every table bucket and each DISTINCT tenant
        bucket is charged exactly once, and only when all of them have
        budget — a rejection must not drain any scope, and one N-table
        query is one query against its tenant's ceiling."""
        with self._lock:
            table_buckets = []
            tenant_buckets = {}
            for table in dict.fromkeys(tables):  # dedup, order kept
                tb = self._buckets.get(table)
                if tb is not None:
                    tb.refill()
                    table_buckets.append((table, tb))
                tenant = self._table_tenant.get(table)
                if tenant and tenant not in tenant_buckets:
                    nb = self._tenant_buckets.get(tenant)
                    if nb is not None:
                        nb.refill()
                        tenant_buckets[tenant] = nb
            for table, tb in table_buckets:
                if not tb.has_token():
                    return f"table {table} is over its QPS quota"
            for tenant, nb in tenant_buckets.items():
                if not nb.has_token():
                    return f"tenant {tenant} is over its QPS quota"
            # every scope has budget: consume atomically
            for _table, tb in table_buckets:
                tb.take()
            for nb in tenant_buckets.values():
                nb.take()
            return None

    def try_acquire(self, table: str) -> bool:
        """False when the table (or its tenant) is over its QPS quota."""
        return self.check(table) is None

    # -- introspection -------------------------------------------------
    def quota_of(self, table: str) -> Optional[float]:
        with self._lock:
            b = self._buckets.get(table)
            return b.qps if b else None

    def tenant_quota_of(self, tenant: str) -> Optional[float]:
        with self._lock:
            b = self._tenant_buckets.get(tenant)
            return b.qps if b else None

    def tenant_of(self, table: str) -> Optional[str]:
        with self._lock:
            return self._table_tenant.get(table)
