"""The broker's retry budget: a copy of pinot_tpu/broker/adaptive.py's
`RetryBudget`.

It is the broker's anti-amplification governor (Finagle's RetryBudget
shape): retries and hedges are paid for out of a per-table token bucket
that only clean primary responses refill, so a failing or overloaded
fleet sees offered load CONVERGE toward the organic rate instead of
multiplying — the retry-storm failure mode ("The Tail at Scale"; DAGOR,
SOSP 2018).

Not here: the JAX module's `AdaptiveServerSelector`. Only the JAX
package's process-per-role broker (cluster/roles.py) wires one; its
in-process MiniCluster, which the port's cluster copies, routes by
round-robin, so the port has no caller for it yet.
"""
from __future__ import annotations

import threading
from typing import Dict


class RetryBudget:
    """Per-table token bucket: every clean primary response DEPOSITS
    ``ratio`` tokens (capped at ``cap``), every retry/hedge attempt
    WITHDRAWS one. A table starts with ``min_tokens`` so a cold broker
    can still salvage the odd failure; a table drowning in failures
    runs dry and its failures surface as typed partials instead of
    re-offered load."""

    def __init__(self, ratio: float = 0.2, min_tokens: float = 3.0,
                 cap: float = 10.0, metrics=None):
        self.ratio = max(0.0, float(ratio))
        self.min_tokens = max(0.0, float(min_tokens))
        self.cap = max(self.min_tokens, float(cap))
        self._tokens: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._metrics = metrics

    @classmethod
    def from_config(cls, config, metrics=None) -> "RetryBudget":
        if config is None:
            return cls(metrics=metrics)
        return cls(
            ratio=config.get_float("pinot.broker.retry.budget.ratio"),
            min_tokens=config.get_float("pinot.broker.retry.budget.min"),
            cap=config.get_float("pinot.broker.retry.budget.cap"),
            metrics=metrics)

    def _gauge(self, table: str, tokens: float) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge("broker_retry_budget_tokens",
                                    round(tokens, 3),
                                    labels={"table": table})

    def deposit(self, table: str) -> None:
        """One clean primary response earns ``ratio`` retries' worth."""
        with self._lock:
            cur = self._tokens.get(table, self.min_tokens)
            cur = min(self.cap, cur + self.ratio)
            self._tokens[table] = cur
        self._gauge(table, cur)

    def try_withdraw(self, table: str, cost: float = 1.0) -> bool:
        """Spend one retry/hedge; False = budget exhausted (the caller
        surfaces the failure typed instead of retrying)."""
        with self._lock:
            cur = self._tokens.get(table, self.min_tokens)
            if cur < cost:
                granted = False
            else:
                granted = True
                cur -= cost
                self._tokens[table] = cur
        if not granted:
            if self._metrics is not None:
                self._metrics.add_meter("broker_retry_budget_exhausted")
            return False
        self._gauge(table, cur)
        return True

    def tokens(self, table: str) -> float:
        with self._lock:
            return self._tokens.get(table, self.min_tokens)
