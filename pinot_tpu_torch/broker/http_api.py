"""The broker's HTTP API: the client edge.

A copy of pinot_tpu/broker/http_api.py (ref pinot-broker
api/resources/PinotClientRequest.java:100): POST /query/sql with JSON
{"sql": "..."} answers the BrokerResponse JSON; GET /health, /metrics
(the broker's and the servers' registries in the Prometheus text
format) and /debug/traces[/<id>] and /debug/queries (utils/trace_store.py).
Stdlib http.server on a daemon thread: the edge is not the hot path.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from pinot_tpu_torch.broker.request_handler import BrokerRequestHandler
from pinot_tpu_torch.utils.metrics import get_registry
from pinot_tpu_torch.utils.trace_store import debug_payload


class BrokerHttpServer:
    def __init__(self, handler: BrokerRequestHandler, host: str = "127.0.0.1",
                 port: int = 0):
        self.handler = handler
        broker = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, status: int, body: bytes = b"",
                      ctype: Optional[str] = None) -> None:
                self.send_response(status)
                if ctype:
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.partition("?")[0].rstrip("/") or "/"
                if path == "/health":
                    self._send(200, b"OK", "text/plain")
                elif path == "/metrics":
                    self._send(200, (
                        get_registry("broker").prometheus_text()
                        + get_registry("server").prometheus_text()).encode(),
                        "text/plain")
                else:
                    payload = (debug_payload("broker", path)
                               if path.startswith("/debug/") else None)
                    if payload is None:
                        self._send(404)
                    else:
                        self._send(200, json.dumps(payload, default=str)
                                   .encode(), "application/json")

            def do_POST(self):
                if self.path not in ("/query/sql", "/query"):
                    self._send(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n))
                    sql = req["sql"]
                    if not isinstance(sql, str):
                        raise TypeError("sql must be a string")
                except (json.JSONDecodeError, KeyError, TypeError):
                    self._send(400)
                    return
                resp = broker.handler.handle(sql)
                self._send(200, json.dumps(resp.to_dict(), default=str)
                           .encode(), "application/json")

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"broker-http-{self.port}")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()
