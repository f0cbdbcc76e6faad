"""Stdlib-only JSON-over-HTTP frontend for the serving subsystem.

The port of tpusvm/serve/http.py: the same routes, bodies and codes.
http.server.ThreadingHTTPServer gives one handler thread per connection;
handler threads block in Server.submit_many(), so concurrent HTTP clients'
rows coalesce in the micro-batcher exactly like in-process callers — the
HTTP layer adds no batching logic of its own. No third-party dependencies.

Routes:
  GET  /healthz                   {"status": "ok"|"degraded"|"draining",
                                   "models": {name: breaker state}};
                                  HTTP 200 while serving (degraded
                                  included — other models still work),
                                  503 once draining
  POST /admin/drain               stop admitting requests, wait for
                                  in-flight work ({"drained": bool});
                                  the zero-downtime-restart hook
  POST /admin/swap                {"name": ..., "path": model.npz}
                                  atomic hot-swap: stage the artifact
                                  fully off to the side (load, compile,
                                  probe-verify), then flip the serving
                                  generation — in-flight batches finish
                                  on the old model. 200 {"swapped":
                                  true, "generation": g, "latency_s"};
                                  a failed stage rolls back (the old
                                  generation keeps serving) and returns
                                  409 {"swapped": false, "error": ...};
                                  unknown model name -> 404. The
                                  `refresh --swap URL` handoff endpoint.
  GET  /v1/models                 hosted-model summaries (Server.status())
  GET  /v1/models/<name>/metrics  one model's metrics JSON
  GET  /metrics                   plaintext metrics for every model
  GET  /metrics.json              this replica's fleet snapshot payload
                                  (obs.fleet: role/instance-attributed,
                                  mergeable registry snapshot, the
                                  JAX package's payload)
  POST /v1/models/<name>:predict  {"instances": [[...], ...]}
                                  (an X-Tpusvm-Trace header names the
                                  caller's span: with `serve --trace`
                                  the request is a serve.request span
                                  carrying that context)
                                  -> {"predictions": [...], "scores": [...],
                                      "statuses": [...]}
                                  Calibrated binary models add
                                  "proba": [P(y=+1), ...] (Platt-scaled
                                  host-side from the served scores — the
                                  exact predict_proba arithmetic); SVR
                                  models serve the regressed value as the
                                  prediction.

Degraded-mode response codes (per-request detail always in `statuses`):
  200  every row scored
  429  load shed (OVERLOADED) or backpressure (QUEUE_FULL) — retryable
       after backoff; Retry-After: 1 is set
  503  the model's breaker is open (UNAVAILABLE), the server is
       draining (DRAINING), or a scoring error/timeout
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from tpusvm_torch.status import ServeStatus


class _Handler(BaseHTTPRequestHandler):
    # the Server instance is attached to the HTTP server object
    protocol_version = "HTTP/1.1"

    @property
    def _srv(self):
        return self.server.tpusvm_server

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code: int = 200,
                   retry_after: bool = False) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after:
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/healthz":
            health = self._srv.health()
            self._send_json(
                health,
                code=503 if health["status"] == "draining" else 200,
            )
        elif self.path == "/metrics":
            self._send(200, self._srv.metrics_text().encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/metrics.json":
            # the fleet collector's scrape target: one mergeable
            # (role, instance)-attributed registry snapshot payload
            self._send_json(self._srv.fleet_snapshot())
        elif self.path == "/v1/models":
            self._send_json(self._srv.status())
        elif self.path.startswith("/v1/models/") and self.path.endswith("/metrics"):
            name = self.path[len("/v1/models/"):-len("/metrics")]
            try:
                self._send_json(self._srv.metrics(name))
            except KeyError as e:
                self._send_json({"error": str(e)}, code=404)
        else:
            self._send_json({"error": f"no route {self.path}"}, code=404)

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/admin/drain":
            ok = self._srv.drain()
            self._send_json({"drained": ok})
            return
        if self.path == "/admin/swap":
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                name = payload["name"]
                path = payload["path"]
            except (ValueError, KeyError, TypeError) as e:
                self._send_json(
                    {"error": f"bad request body (need name+path): {e}"},
                    code=400)
                return
            try:
                out = self._srv.swap(name, path)
            except KeyError as e:
                self._send_json({"swapped": False, "error": str(e)},
                                code=404)
                return
            except Exception as e:  # noqa: BLE001 — the stage rolled
                # back; the old generation is still serving, so this is
                # a conflict report, not a handler crash
                self._send_json(
                    {"swapped": False,
                     "error": f"{type(e).__name__}: {e}"},
                    code=409)
                return
            self._send_json({"swapped": True, **out})
            return
        if not (self.path.startswith("/v1/models/")
                and self.path.endswith(":predict")):
            self._send_json({"error": f"no route {self.path}"}, code=404)
            return
        name = self.path[len("/v1/models/"):-len(":predict")]
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            instances = payload["instances"]
            X = np.asarray(instances, dtype=np.float64)
        except (ValueError, KeyError, TypeError) as e:
            self._send_json({"error": f"bad request body: {e}"}, code=400)
            return
        # honour a propagated trace context: with a tracer attached (serve
        # --trace) the scoring is a serve.request span whose attrs carry
        # the caller's ctx, naming the router's forward span as its
        # parent; without one the header is accepted and ignored
        tracer = getattr(self.server, "tpusvm_tracer", None)
        span = contextlib.nullcontext()
        if tracer is not None:
            from tpusvm_torch.obs.trace import TRACE_HEADER, TraceContext

            attrs = {"model": name, "rows": int(X.shape[0])}
            ctx = TraceContext.from_header(self.headers.get(TRACE_HEADER))
            if ctx is not None:
                attrs["ctx"] = ctx.to_dict()
            span = tracer.span("serve.request", **attrs)
        try:
            with span:
                results = self._srv.submit_many(
                    name, X, timeout_s=payload.get("timeout_s"))
        except KeyError as e:
            self._send_json({"error": str(e)}, code=404)
            return
        except ValueError as e:
            self._send_json({"error": str(e)}, code=400)
            return
        statuses = [ServeStatus(r.status).name for r in results]
        ok = all(r.ok for r in results)
        st_set = {ServeStatus(r.status) for r in results}
        if ok:
            code = 200
        elif st_set & {ServeStatus.UNAVAILABLE, ServeStatus.DRAINING,
                       ServeStatus.ERROR, ServeStatus.TIMEOUT,
                       ServeStatus.SHUTDOWN}:
            code = 503  # not retryable-by-backoff alone
        else:
            code = 429  # OVERLOADED / QUEUE_FULL: back off and retry
        body = {
            "predictions": [
                None if r.label is None else np.asarray(r.label).item()
                for r in results
            ],
            "scores": [
                None if r.scores is None else np.asarray(r.scores).tolist()
                for r in results
            ],
            "statuses": statuses,
        }
        entry = self._srv.registry.get(name)
        if entry.platt is not None and entry.kind == "binary":
            # calibrated model: Platt-scale the served scores on the host,
            # the exact predict_proba arithmetic (kernels/platt.py), so the
            # field is the offline estimator's P(y=+1) bit for bit
            from tpusvm_torch.kernels.platt import platt_proba

            body["proba"] = [
                None if r.scores is None
                else float(platt_proba(np.asarray(r.scores), *entry.platt))
                for r in results
            ]
        self._send_json(body, code=code, retry_after=code in (429, 503))


def make_http_server(server, host: str = "127.0.0.1", port: int = 8471,
                     verbose: bool = False) -> ThreadingHTTPServer:
    """Bind (not yet serving) a ThreadingHTTPServer over a serve.Server.

    port=0 binds an ephemeral port (tests); read httpd.server_address.
    Call .serve_forever() (blocking) or start_http_thread() below.
    """
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.tpusvm_server = server
    # set by `serve --trace`: per-request serve.request spans, honouring a
    # propagated X-Tpusvm-Trace context
    httpd.tpusvm_tracer = None
    httpd.verbose = verbose
    # handler threads must not block interpreter exit
    httpd.daemon_threads = True
    return httpd


def start_http_thread(httpd: ThreadingHTTPServer) -> threading.Thread:
    """Run an HTTP server on a daemon thread (in-process tests / CLI).

    Pair with stop_http_server (directly, or via Server.attach_http +
    Server.close): daemon=True alone keeps interpreter exit unblocked but
    leaks the listening socket for the life of the process."""
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="tpusvm-torch-serve-http")
    t.start()
    return t


def stop_http_server(httpd: ThreadingHTTPServer,
                     thread: Optional[threading.Thread] = None,
                     timeout_s: float = 5.0) -> None:
    """Shut down the serve loop, CLOSE the listening socket, and join
    the serving thread. Idempotent; safe after a manual shutdown().

    shutdown() only stops serve_forever — without server_close() the
    bound port stays held, and without the join a still-draining handler
    can race interpreter teardown."""
    httpd.shutdown()
    httpd.server_close()
    if thread is not None:
        thread.join(timeout=timeout_s)


def revivable_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    """n ports that are free now and lie below the kernel's ephemeral range,
    for replica processes that must come back on their own port after a
    SIGKILL: a port of the ephemeral range can be taken, while its process
    is dead, as the local port of any outgoing connection, and the revive
    then fails with EADDRINUSE. Each caller starts its search at an offset
    from its pid, so concurrent callers rarely meet. [0] * n (the kernel
    chooses) where the range cannot be read or nothing below it is free."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return [0] * n
    first = max(1024, low - 8192)
    width = low - first
    out: List[int] = []
    for k in range(width):
        port = first + (os.getpid() * 7 + k) % width
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
        out.append(port)
        if len(out) == n:
            return out
    return [0] * n
