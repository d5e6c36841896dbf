"""The server's query path: per-server execution and its TCP transport.

A trimmed copy of pinot_tpu/server/query_server.py (ref pinot-core
ServerQueryExecutorV1Impl, QueryServer + InstanceRequestHandler
.channelRead0 at transport/InstanceRequestHandler.java:122). An asyncio TCP
server speaks length-prefixed frames:

  request : u32 len | JSON {requestId, tableName, sql, segments?,
            extraFilter?, timeoutMs?, tenant?, queryId?, traceContext?}
            or {cancel: queryId}
  response: u32 len | PDT1 bytes (server/datatable.py)

Execution runs on a worker pool (one FCFS scheduler) through
query/executor.py `execute_context` over the table's acquired segments,
with ONE device engine for the server's lifetime. A refused shape is
answered by the host executor there; a table the server does not hold is
a TABLE_DOES_NOT_EXIST reply, a missed deadline or a cancel a typed 250
reply, and any other exception a QUERY_EXECUTION reply naming it: a
kernel that fails to build or launch fails the query. A traced request
(one that carries a traceContext) runs under the server's own span tree,
which follows the reply; a sampled or slow one (at or over
`pinot.server.slow.query.threshold.ms`) keeps its tree in the server's
trace store, and a slow one logs a slow-query line. A request's tenant is
accepted and charged nothing until the schedulers are ported. Not ported
yet: admission control and the other schedulers, streaming replies and
workload accounting.
"""
from __future__ import annotations

import asyncio
import json
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import torch

from pinot_tpu_torch.cache.warmup import (FingerprintLog, SegmentWarmup,
                                          is_cacheable_shape)
from pinot_tpu_torch.query.context import QueryContext, merge_extra_filter
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.server import datatable
from pinot_tpu_torch.server.data_manager import (InstanceDataManager,
                                                 TableDataManager)
from pinot_tpu_torch.utils import errorcodes, trace_store, tracing
from pinot_tpu_torch.utils.accounting import (BrokerTimeoutError,
                                              QueryCancelledError,
                                              ResourceAccountant)
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.metrics import get_registry

_LEN = struct.Struct("<I")

#: seconds a socket read waits past the shipped budget, so the server's
#: typed 250 reply, not a socket timeout, is how a deadline surfaces
_SOCKET_GRACE_S = 2.0

#: the transport's worker threads (one FCFS pool)
NUM_THREADS = 8


def _error_reply(code: int, message: str) -> bytes:
    return datatable.serialize_results(
        [], [{"errorCode": code, "message": message}])


class ServerQueryExecutor:
    """Executes one query over this server's segments of a table."""

    def __init__(self, data_manager: InstanceDataManager, device=None,
                 value_dtype: torch.dtype = torch.float32,
                 config: Optional[PinotConfiguration] = None, devices=None):
        """device, devices: None for both means every card of the host
        (one card alone, several as a segments-only mesh, JAX :222-235),
        and raises RuntimeError when no CUDA device is present; "cpu" runs
        the plain PyTorch kernels (the tests); devices=[...] a
        segments-only mesh over those devices (a logical one where they
        repeat). A device the server cannot use raises here: it never
        moves to the CPU by itself."""
        from pinot_tpu_torch.parallel.mesh import default_devices
        if device is None and devices is None:
            devices = default_devices()
        if any(torch.device(d).type == "cuda"
               for d in (devices if devices is not None else [device])) \
                and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's server runs on the card; pass "
                "device='cpu' for the plain PyTorch kernels")
        self.data_manager = data_manager
        self.device, self.devices = device, devices
        self.value_dtype = value_dtype
        self.config = config or PinotConfiguration()
        #: per-query deadline and cancel registry
        self.accountant = ResourceAccountant()
        self.deadline_grace_s = self.config.get_int(
            "pinot.server.query.deadline.grace.ms") / 1000.0
        self._slow_threshold_ms = self.config.get_float(
            "pinot.server.slow.query.threshold.ms")
        self._trace_capacity = self.config.get_int(
            "pinot.trace.store.capacity")
        self._engine = None
        self._engine_lock = threading.Lock()
        data_manager.add_segment_listener(self._on_segment_event)
        self.fingerprint_log = FingerprintLog()
        self.warmup = SegmentWarmup(self.fingerprint_log,
                                    self._shared_engine)
        data_manager.set_warmup_hook(self.warmup.warm)

    def _shared_engine(self):
        """The server's one engine (JAX :222): it owns the staging levels,
        which must outlive a request, and spans the server's devices."""
        with self._engine_lock:
            if self._engine is None:
                from pinot_tpu_torch.ops.engine import TorchOperatorExecutor
                self._engine = TorchOperatorExecutor(
                    self.device, self.value_dtype, config=self.config,
                    metrics_labels={
                        "instance": self.data_manager.instance_id},
                    devices=self.devices)
            return self._engine

    @property
    def engine(self):
        return self._shared_engine()

    def _on_segment_event(self, event: str, table_name: str,
                          segment_name: str) -> None:
        """A replaced or removed segment's staged rows, blocks and params
        leave the engine now (JAX :177); on replace the live segment's,
        which the warm-up just staged, stay."""
        if event not in ("replace", "remove") or self._engine is None:
            return
        keep = None
        if event == "replace":
            tdm = self.data_manager.table(table_name, create=False)
            if tdm is not None:
                keep = tdm.current_segment(segment_name)
        self._engine.invalidate_segment(segment_name, keep=keep)

    def _record_plan(self, table_name: str, ctx: QueryContext, sql: str,
                     extra_filter: Optional[str]) -> None:
        """Log an aggregation or DISTINCT plan for the warm-up."""
        if is_cacheable_shape(ctx):
            self.fingerprint_log.record(table_name, ctx.fingerprint(), sql,
                                        extra_filter)

    def cancel(self, query_id) -> bool:
        """A broker's cancel: the query's next check raises."""
        return self.accountant.cancel(str(query_id))

    def execute(self, table_name: str, sql: str,
                segments: Optional[List[str]] = None,
                extra_filter: Optional[str] = None,
                query_id=None, timeout_ms: Optional[float] = None,
                deadline: Optional[float] = None,
                trace_ctx: Optional[dict] = None,
                arrival_s: Optional[float] = None,
                tenant: Optional[str] = None) -> bytes:
        """PDT1 bytes (see _execute_inner). trace_ctx: the broker's
        TraceContext wire dict; the server then runs the query under its
        own span tree, rooted at ServerRequest with the time the request
        waited for a worker, keeps it in the server's trace store when
        sampled or slow (JAX :314-360), and appends it after the payload.
        tenant: the request's scheduling group, shown in /debug/queries;
        nothing is charged to it yet."""
        tc = tracing.TraceContext.from_wire(trace_ctx)
        if tc is None:
            return self._execute_inner(table_name, sql, segments,
                                       extra_filter, query_id, timeout_ms,
                                       deadline)
        instance = self.data_manager.instance_id
        rt = tracing.RequestTrace(
            request_id=str(query_id or ""), operator="ServerRequest",
            trace_id=tc.trace_id, sampled=tc.sampled,
            instance=instance, table=table_name)
        if arrival_s is not None:
            rt.handle().set(queueWaitMs=round(
                max(0.0, time.time() - arrival_s) * 1000.0, 3))
        inflight = trace_store.get_inflight("server")
        key = f"{tc.trace_id}:{query_id}"
        inflight.begin(key, sql=sql, trace_id=tc.trace_id,
                       detail=table_name, tenant=tenant, deadline=deadline)
        inflight.phase(key, "execute", table_name)
        try:
            with rt:
                payload = self._execute_inner(table_name, sql, segments,
                                              extra_filter, query_id,
                                              timeout_ms, deadline)
        finally:
            inflight.end(key)
        dur = rt.root.duration_ms
        tree = rt.to_dict()
        slow = self._slow_threshold_ms > 0 and dur >= self._slow_threshold_ms
        if tc.sampled or slow:
            # keyed by instance too: servers sharing a process (an
            # embedded cluster) record the same trace id
            trace_store.get_store("server", self._trace_capacity).record(
                f"{tc.trace_id}@{instance}", tree, sql=sql,
                duration_ms=dur, slow=slow,
                extra={"traceId": tc.trace_id, "instance": instance})
            if slow:
                trace_store.log_slow_query(
                    "server", tc.trace_id, sql, dur,
                    self._slow_threshold_ms, table=table_name,
                    instance=instance)
        get_registry("server").set_exemplar(
            "query_execution", {"table": table_name}, tc.trace_id)
        return payload + datatable.serialize_value(tree)

    def _execute_inner(self, table_name: str, sql: str,
                       segments: Optional[List[str]] = None,
                       extra_filter: Optional[str] = None,
                       query_id=None, timeout_ms: Optional[float] = None,
                       deadline: Optional[float] = None) -> bytes:
        """extra_filter: an expression ANDed into the filter tree.
        timeout_ms: the broker's remaining budget; the local deadline (with
        a small grace) cancels the query cooperatively. deadline: an
        absolute deadline from the transport, which wins over timeout_ms."""
        metrics = get_registry("server")
        labels = {"table": table_name}
        metrics.add_meter("queries", labels=labels)
        t0 = time.perf_counter()
        qid = None if query_id is None else str(query_id)
        cancel_check = None
        if qid is not None:
            if deadline is not None:
                timeout_s = deadline - time.time()
            else:
                timeout_s = (float(timeout_ms) / 1000.0
                             + self.deadline_grace_s if timeout_ms else None)
            self.accountant.begin_query(qid, timeout_s)
            cancel_check = self.accountant.checker(qid)
        try:
            ctx = QueryContext.from_sql(sql)
            merge_extra_filter(ctx, extra_filter)
            self._record_plan(table_name, ctx, sql, extra_filter)
            tdm = self.data_manager.table(table_name, create=False)
            if tdm is None:
                return _error_reply(errorcodes.TABLE_DOES_NOT_EXIST,
                                    f"table {table_name} not found")
            sdms = tdm.acquire_segments(segments)
            try:
                ex = QueryExecutor([s.segment for s in sdms],
                                   engine=self._shared_engine(),
                                   cancel_check=cancel_check)
                results, prune_stats = ex.execute_context(ctx)
                return datatable.serialize_results(results,
                                                   extra_stats=prune_stats)
            finally:
                TableDataManager.release_all(sdms)
        except (QueryCancelledError, BrokerTimeoutError) as e:
            # late work is dropped, never half-merged: a typed 250
            metrics.add_meter("queries_killed", labels=labels)
            return _error_reply(BrokerTimeoutError.ERROR_CODE,
                                f"{type(e).__name__}: {e}")
        except Exception as e:  # noqa: BLE001 — the server answers
            metrics.add_meter("query_exceptions", labels=labels)
            return _error_reply(errorcodes.QUERY_EXECUTION,
                                f"{type(e).__name__}: {e}")
        finally:
            if qid is not None:
                self.accountant.finish_query(qid)
            metrics.add_timing("query_execution",
                               (time.perf_counter() - t0) * 1e3,
                               labels=labels)


class QueryServer:
    """The asyncio TCP transport (the Netty QueryServer analog), its
    queries on a plain worker pool."""

    def __init__(self, executor: ServerQueryExecutor, host: str = "127.0.0.1",
                 port: int = 0):
        self.executor = executor
        self.host = host
        self.port = port
        self._pool = ThreadPoolExecutor(
            max_workers=NUM_THREADS,
            thread_name_prefix=f"query-{executor.data_manager.instance_id}")
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                n = _LEN.unpack(await reader.readexactly(4))[0]
                req = json.loads(await reader.readexactly(n))
                if "cancel" in req:
                    # out of band, on its own connection: the query's own
                    # channel waits for the reply being cancelled
                    ack = json.dumps({"cancelled": bool(
                        self.executor.cancel(req["cancel"]))}).encode()
                    writer.write(_LEN.pack(len(ack)) + ack)
                    await writer.drain()
                    continue
                # the broker's remaining budget -> a local deadline from
                # the moment the request was read
                arrival = time.time()
                timeout_ms = req.get("timeoutMs")
                deadline = (arrival + float(timeout_ms) / 1000.0
                            + self.executor.deadline_grace_s
                            if timeout_ms else None)
                resp = await loop.run_in_executor(
                    self._pool, lambda r=req, d=deadline, a=arrival:
                    self.executor.execute(
                        r["tableName"], r["sql"], r.get("segments"),
                        r.get("extraFilter"),
                        query_id=r.get("queryId") or r.get("requestId"),
                        timeout_ms=r.get("timeoutMs"), deadline=d,
                        trace_ctx=r.get("traceContext"), arrival_s=a,
                        tenant=r.get("tenant")))
                writer.write(_LEN.pack(len(resp)) + resp)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    def start(self) -> None:
        """Serve on a background thread; sets self.port."""
        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop

            async def main():
                self._server = await asyncio.start_server(
                    self._handle, self.host, self.port)
                self.port = self._server.sockets[0].getsockname()[1]
                self._started.set()
                async with self._server:
                    await self._server.serve_forever()

            try:
                loop.run_until_complete(main())
            except asyncio.CancelledError:
                pass
            finally:
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"query-server-{self.port}")
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("query server failed to start")

    def stop(self) -> None:
        """Stop serving and join the loop and the workers (idempotent)."""
        if self._loop is not None and not self._loop.is_closed():
            def shutdown():
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()
            try:
                self._loop.call_soon_threadsafe(shutdown)
            except RuntimeError:
                pass  # the loop closed between the check and the call
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=True)


class ServerConnection:
    """A broker's channel pool to one server (ref ServerChannels:65):
    each request takes its own socket, up to `pool_size` idle ones are
    kept."""

    POOL_SIZE = 4

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()

    def _take(self) -> socket.socket:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return socket.create_connection((self.host, self.port), timeout=30)

    def _give(self, sock: socket.socket) -> None:
        with self._lock:
            if len(self._idle) < self.POOL_SIZE:
                self._idle.append(sock)
                return
        _close_quietly(sock)

    def request(self, table_name: str, sql: str,
                segments: Optional[List[str]] = None, request_id: int = 0,
                extra_filter: Optional[str] = None,
                timeout_ms: Optional[float] = None, query_id=None,
                tenant: Optional[str] = None,
                trace_ctx: Optional[dict] = None) -> bytes:
        """The server's PDT1 reply. timeout_ms: the remaining budget,
        shipped to the server and the socket's read timeout (plus a
        grace). tenant: the scheduling group the server charges (JAX
        :763-769). trace_ctx: a TraceContext wire dict; the server's span
        tree then follows the reply's payload."""
        payload = json.dumps({
            "requestId": request_id, "tableName": table_name, "sql": sql,
            "segments": segments, "extraFilter": extra_filter,
            "timeoutMs": timeout_ms, "tenant": tenant,
            "queryId": query_id, "traceContext": trace_ctx}).encode()
        frame = _LEN.pack(len(payload)) + payload
        sock = self._take()
        try:
            sock.settimeout(float(timeout_ms) / 1000.0 + _SOCKET_GRACE_S
                            if timeout_ms else 30.0)
            sock.sendall(frame)
            resp = self._read_frame(sock)
        except socket.timeout:
            # a slow query, not a dead channel: resending would run it twice
            _close_quietly(sock)
            raise
        except ConnectionError:
            # one retry on a fresh dial: a pooled socket may be stale
            _close_quietly(sock)
            sock = socket.create_connection((self.host, self.port),
                                            timeout=30)
            try:
                sock.sendall(frame)
                resp = self._read_frame(sock)
            except (socket.timeout, ConnectionError):
                _close_quietly(sock)
                raise
        self._give(sock)
        return resp

    def cancel(self, query_id) -> bool:
        """Best-effort cancel on a fresh socket; never raises."""
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=2.0) as sock:
                msg = json.dumps({"cancel": str(query_id)}).encode()
                sock.sendall(_LEN.pack(len(msg)) + msg)
                return bool(json.loads(self._read_frame(sock))
                            .get("cancelled"))
        except (OSError, ValueError):
            return False

    @staticmethod
    def _read_frame(sock: socket.socket) -> bytes:
        hdr = b""
        while len(hdr) < 4:
            chunk = sock.recv(4 - len(hdr))
            if not chunk:
                raise ConnectionError("server closed connection")
            hdr += chunk
        n = _LEN.unpack(hdr)[0]
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(min(1 << 20, n - len(buf)))
            if not chunk:
                raise ConnectionError("server closed connection mid-frame")
            buf += chunk
        return bytes(buf)

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for sock in idle:
            _close_quietly(sock)


def _close_quietly(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass
