"""Per-query span trees, and the trace context a request carries.

A trimmed copy of pinot_tpu/utils/tracing.py (ref pinot-spi
trace/Tracing.java:45): `RequestTrace` opens a request's root span and
makes it the calling thread's current span; `Scope` times a child span of
the current one; `annotate` sets attributes on the current span;
`capture` gives a `SpanHandle`, which code off the request thread (the
dispatch staging pool) uses to open and close its own child spans;
`TraceContext` is what crosses a wire hop (`RequestTrace.wire_context`
writes it, `from_wire` reads it). The server's tree travels back after
the response payload, as the reference's does, and the broker grafts it
under its scatter span (`SpanHandle.graft`): one tree across processes.
`current_request` is the enclosing request, whose `sampled` flag the
broker raises for a `trace=true` query. utils/trace_store.py keeps the
finished trees.
"""
from __future__ import annotations

import contextvars
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_current: contextvars.ContextVar[Optional["TraceNode"]] = \
    contextvars.ContextVar("pinot_tpu_torch_trace", default=None)
_request: contextvars.ContextVar[Optional["RequestTrace"]] = \
    contextvars.ContextVar("pinot_tpu_torch_trace_req", default=None)

#: one lock for all tree mutation: handles append spans from pool threads
#: while the request thread keeps building
_tree_lock = threading.Lock()


@dataclass
class TraceContext:
    """What crosses a wire hop: the trace id, the parent span id, and
    whether the client asked for the trace back."""

    trace_id: str
    span_id: str = ""
    sampled: bool = False

    def to_wire(self) -> dict:
        return {"traceId": self.trace_id, "spanId": self.span_id,
                "sampled": self.sampled}

    @classmethod
    def from_wire(cls, d: Optional[dict]) -> Optional["TraceContext"]:
        if not d or not d.get("traceId"):
            return None
        return cls(trace_id=str(d["traceId"]),
                   span_id=str(d.get("spanId", "")),
                   sampled=bool(d.get("sampled")))


@dataclass
class TraceNode:
    operator: str
    start_ms: float = 0.0
    duration_ms: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["TraceNode"] = field(default_factory=list)

    def to_dict(self) -> dict:
        with _tree_lock:
            return self._to_dict_locked()

    def _to_dict_locked(self) -> dict:
        return {"operator": self.operator,
                "durationMs": round(self.duration_ms, 3),
                **self.attrs,
                **({"children": [c._to_dict_locked()
                                 for c in self.children]}
                   if self.children else {})}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceNode":
        """Inverse of to_dict: a remote side's shipped tree."""
        attrs = {k: v for k, v in d.items()
                 if k not in ("operator", "durationMs", "children")}
        node = cls(operator=str(d.get("operator", "?")),
                   duration_ms=float(d.get("durationMs", 0.0) or 0.0),
                   attrs=attrs)
        node.children = [cls.from_dict(c) for c in d.get("children", ())]
        return node


class SpanHandle:
    """A thread-safe handle on one span, for code where the current span
    does not flow (pool threads)."""

    __slots__ = ("node",)

    def __init__(self, node: TraceNode):
        self.node = node

    def child(self, operator: str, **attrs) -> "SpanHandle":
        """Open a child span (timing starts now); end it with .end()."""
        n = TraceNode(operator, attrs=dict(attrs))
        n.start_ms = time.perf_counter() * 1000.0
        with _tree_lock:
            self.node.children.append(n)
        return SpanHandle(n)

    def end(self, **attrs) -> None:
        with _tree_lock:
            self.node.attrs.update(attrs)
            if self.node.duration_ms == 0.0 and self.node.start_ms:
                self.node.duration_ms = \
                    time.perf_counter() * 1000.0 - self.node.start_ms

    def set(self, **attrs) -> None:
        with _tree_lock:
            self.node.attrs.update(attrs)

    def graft(self, tree: Optional[dict]) -> None:
        """Attach a remote side's shipped tree (to_dict form) as a child:
        the stitch point of a cross-process trace. A torn tree is
        dropped, never fails the query."""
        if not tree:
            return
        try:
            node = TraceNode.from_dict(tree)
        except Exception:  # noqa: BLE001
            return
        with _tree_lock:
            self.node.children.append(node)


class Scope:
    """A timed child span of the current span (ref InvocationScope); a
    no-op when no request is traced."""

    def __init__(self, operator: str, **attrs):
        self.node = TraceNode(operator, attrs=dict(attrs))
        self._token = None

    def __enter__(self) -> "Scope":
        parent = _current.get()
        if parent is not None:
            with _tree_lock:
                parent.children.append(self.node)
            self._token = _current.set(self.node)
            self.node.start_ms = time.perf_counter() * 1000.0
        return self

    def set(self, **attrs) -> None:
        if self._token is not None:
            with _tree_lock:
                self.node.attrs.update(attrs)

    def __exit__(self, *exc):
        if self._token is not None:
            self.node.duration_ms = \
                time.perf_counter() * 1000.0 - self.node.start_ms
            _current.reset(self._token)


class RequestTrace:
    """Root span of one request; current for the opening thread."""

    def __init__(self, request_id: Any = 0, operator: str = "BrokerRequest",
                 trace_id: Optional[str] = None, sampled: bool = True,
                 **attrs):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.sampled = sampled
        self.root = TraceNode(operator,
                              attrs={"requestId": request_id,
                                     "traceId": self.trace_id, **attrs})
        self._token = None

    def __enter__(self) -> "RequestTrace":
        self.root.start_ms = time.perf_counter() * 1000.0
        self._token = _current.set(self.root)
        self._req_token = _request.set(self)
        return self

    def __exit__(self, *exc):
        self.root.duration_ms = \
            time.perf_counter() * 1000.0 - self.root.start_ms
        _current.reset(self._token)
        _request.reset(self._req_token)

    def handle(self) -> SpanHandle:
        return SpanHandle(self.root)

    def wire_context(self) -> dict:
        """The TraceContext shipped on an outgoing hop, a fresh parent
        span id each time."""
        return TraceContext(self.trace_id, uuid.uuid4().hex[:8],
                            self.sampled).to_wire()

    def to_dict(self) -> dict:
        return self.root.to_dict()


def active() -> bool:
    return _current.get() is not None


def current_request() -> Optional[RequestTrace]:
    """The enclosing RequestTrace, or None when untraced."""
    return _request.get()


def current_trace_id() -> Optional[str]:
    req = _request.get()
    return None if req is None else req.trace_id


def get_attr(name: str, default: Any = None) -> Any:
    """An attribute of the current span (default when untraced)."""
    node = _current.get()
    if node is None:
        return default
    with _tree_lock:
        return node.attrs.get(name, default)


def capture() -> Optional[SpanHandle]:
    """A handle on the current span (None when tracing is off): capture
    on the request thread, attach children from any thread later."""
    node = _current.get()
    return None if node is None else SpanHandle(node)


def annotate(**attrs) -> None:
    """Set attributes on the current span (a no-op when tracing is off)."""
    node = _current.get()
    if node is not None:
        with _tree_lock:
            node.attrs.update(attrs)
