"""The routing front door: threaded stdlib HTTP over N serve replicas.

The port's copy of tpusvm/router/proxy.py. One Router owns the three
fabric pieces (ReplicaSet membership with HRW placement, HealthPoller
admission, rollout skew tracking) and exposes them behind the same
ThreadingHTTPServer shape serve/http.py uses (one handler thread per
connection, stdlib only). It is host logic: the replicas behind it
(`python -m tpusvm_torch serve`) score on the card.

Forwarding semantics:

  * a predict request is forwarded to its PLACED replica (HRW, k-way);
    on a connection failure or a replica 503 the router tries the NEXT
    candidate in admission order, under the shared Retry machinery with
    DEFAULT_IO_POLICY classification (connection-level failures surface
    as the retryable TransientIOError class; anything else propagates).
    The candidate list is the placed replicas first, then the healthy
    rest of the fleet (placement is affinity, not exclusivity: every
    replica hosts every model);
  * a replica 429 (OVERLOADED / QUEUE_FULL) maps to a client 429 with the
    replica's Retry-After kept and NO failover: bouncing the request to
    the next replica would amplify exactly the load being shed;
  * admin routes are non-idempotent and never retried: the rollout driver
    issues each per-replica /admin/swap at most once (rollout.py), and
    the router's own admin routes change local state only;
  * no candidate at all -> 503 NO_REPLICA; candidates exhausted -> 503
    ALL_DOWN (status.RouterStatus).

Every per-replica forward attempt passes the ``router.forward`` fault
point, so a chaos plan injects transients and latency into the fabric
itself (router-chaos-smoke). With a tracer attached, a forward is a
``router.forward`` span and the outbound request carries an
``X-Tpusvm-Trace`` context minted inside it, so a replica's
``serve.request`` span names it as its parent.

Counters on the registry: router.requests / router.forwards
(per replica) / router.retries / router.failovers / router.no_replica,
plus the poller's router.replica_state / router.replicas_up gauges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from tpusvm_torch import faults
from tpusvm_torch.router.health import HealthPoller
from tpusvm_torch.router.placement import ReplicaSet
from tpusvm_torch.router.rollout import staggered_rollout
from tpusvm_torch.status import RouterStatus


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing-tier knobs (`python -m tpusvm_torch router`)."""

    replicas: Tuple[str, ...] = ()   # replica base URLs (http://h:p)
    replication: int = 2             # HRW replication factor k
    seed: int = 0                    # placement seed (byte-reproducible)
    poll_interval_s: float = 0.5     # health poll period
    down_after: int = 2              # consecutive failed polls -> down
    health_timeout_s: float = 2.0    # per-poll fetch timeout
    forward_timeout_s: float = 10.0  # per-attempt forward timeout
    skew_window: int = 1             # rollout hold threshold

    def __post_init__(self):
        if self.replication < 1:
            raise ValueError(
                f"replication must be >= 1, got {self.replication}")


def _http_post(url: str, body: bytes, timeout_s: float,
               headers: Optional[Dict[str, str]] = None
               ) -> Tuple[int, bytes, Optional[str]]:
    """One real forward attempt: (code, body, Retry-After header).

    HTTP error codes come back AS codes (a 429/503 carries a payload the
    client should see); connection-level failures — refused, reset,
    timeout, DNS — are raised as the retryable TransientIOError class so
    the shared retry policy classifies them exactly like a flaky disk.

    `headers` (trace-context injection) merge over the JSON default."""
    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, resp.read(), resp.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Retry-After")
    except (urllib.error.URLError, ConnectionError, TimeoutError,
            OSError, http.client.HTTPException) as e:
        # HTTPException covers a replica dying MID-response (BadStatusLine,
        # IncompleteRead after a SIGKILL) — same failover as a refusal
        raise faults.TransientIOError(
            f"forward to {url} failed: {type(e).__name__}: {e}"
        ) from e


class _CandidatesExhausted(Exception):
    """Every admissible candidate was tried (non-retryable by design)."""


class Router:
    """Placement + admission + failover over a fleet of serve replicas.

    Thread-safety: handler threads call forward()/health() freely. The
    membership view is an immutable snapshot (ReplicaSet), the health
    view an immutable dict (HealthPoller); the only mutable Router state
    is the rollout-hold map, guarded by its own lock."""

    def __init__(self, config: RouterConfig = RouterConfig(),
                 transport: Callable = _http_post,
                 fetch=None, registry=None,
                 log_fn: Optional[Callable[[str], None]] = print,
                 tracer=None):
        if registry is None:
            from tpusvm_torch.obs.registry import default_registry

            registry = default_registry()
        self.config = config
        self.log = log_fn or (lambda msg: None)
        self._transport = transport
        self._registry = registry
        self._tracer = tracer
        self.instance = f"router-{os.getpid()}"
        self.replica_set = ReplicaSet(config.replicas,
                                      k=config.replication,
                                      seed=config.seed)
        poll_kw = {} if fetch is None else {"fetch": fetch}
        self.poller = HealthPoller(
            lambda: self.replica_set.replicas(),
            interval_s=config.poll_interval_s,
            down_after=config.down_after,
            timeout_s=config.health_timeout_s,
            registry=registry, log_fn=self.log, **poll_kw)
        self._lock = threading.Lock()
        # model -> held SkewReport json; written only by rollout()
        self._holds: Dict[str, dict] = {}
        self._httpd = None
        self._http_thread = None
        self._c_requests = registry.counter("router.requests")
        self._c_retries = registry.counter("router.retries")
        self._c_failovers = registry.counter("router.failovers")
        self._c_no_replica = registry.counter("router.no_replica")

    # --------------------------------------------------------- placement
    def candidates(self, model: str) -> list:
        """Admission-ordered forward candidates for `model`: the HRW
        placement first, then the healthy remainder of the fleet."""
        view = self.replica_set.view()
        placed = self.replica_set.placement(model)
        return self.poller.admissible(placed, fallback=view.replicas)

    # -------------------------------------------------------- forwarding
    def forward(self, model: str, body: bytes,
                suffix: str = ":predict", ctx=None
                ) -> Tuple[int, bytes, Optional[str]]:
        """Forward a predict-class request; (code, body, Retry-After).

        Retries the next placement on connection failure or replica 503
        (one attempt per candidate, DEFAULT_IO_POLICY backoff between
        attempts); 429 returns immediately — see the module doc.

        ctx: the inbound TraceContext (the client's X-Tpusvm-Trace
        header). With a tracer attached the forward becomes a
        ``router.forward`` span carrying the inbound ctx in its attrs,
        and the OUTBOUND request carries a context minted under that
        span — the replica's serve.request span then parents into this
        router's timeline. Without a tracer the inbound context passes
        through unchanged (the router is transparent to tracing)."""
        span = contextlib.nullcontext()
        if self._tracer is not None:
            attrs = {"model": model}
            if ctx is not None:
                attrs["ctx"] = ctx.to_dict()
            span = self._tracer.span("router.forward", **attrs)
        with span:
            return self._forward(model, body, suffix, ctx)

    def _forward(self, model: str, body: bytes, suffix: str, ctx
                 ) -> Tuple[int, bytes, Optional[str]]:
        from tpusvm_torch.obs.trace import TRACE_HEADER

        out_ctx = ctx
        if self._tracer is not None and self._tracer.role is not None:
            out_ctx = self._tracer.ctx()  # inside the router.forward span
        headers = ({TRACE_HEADER: out_ctx.to_header()}
                   if out_ctx is not None else None)
        self._c_requests.inc()
        cands = self.candidates(model)
        if not cands:
            self._c_no_replica.inc()
            return 503, json.dumps({
                "error": f"no admissible replica for model {model!r}",
                "router": RouterStatus.NO_REPLICA.name,
            }).encode(), None
        it = iter(cands)
        tried: list = []

        def _one_candidate():
            url = next(it, None)
            if url is None:
                raise _CandidatesExhausted()
            if tried:
                self._c_failovers.inc()
            tried.append(url)
            faults.point("router.forward", replica=url, model=model)
            target = url.rstrip("/") + f"/v1/models/{model}{suffix}"
            if headers is not None:
                code, data, retry_after = self._transport(
                    target, body, self.config.forward_timeout_s, headers)
            else:
                # 3-arg form kept for injected transports that predate
                # trace propagation (tests stub this signature)
                code, data, retry_after = self._transport(
                    target, body, self.config.forward_timeout_s)
            if code == 503:
                # breaker open / draining / scoring error there: the
                # next placement may well serve it — retryable
                raise faults.TransientIOError(
                    f"replica {url} answered 503")
            return url, code, data, retry_after

        policy = dataclasses.replace(faults.DEFAULT_IO_POLICY,
                                     max_attempts=len(cands))
        retry = faults.Retry(policy, op="router.forward",
                             on_retry=self._c_retries.inc)
        try:
            url, code, data, retry_after = retry(_one_candidate)
        except (_CandidatesExhausted, faults.RetryExhaustedError):
            return 503, json.dumps({
                "error": f"every candidate replica failed for "
                         f"{model!r} (tried {tried})",
                "router": RouterStatus.ALL_DOWN.name,
            }).encode(), None
        self._registry.counter("router.forwards", replica=url).inc()
        if code == 429 and retry_after is None:
            retry_after = "1"  # honest backpressure needs a hint
        return code, data, retry_after

    # ----------------------------------------------------------- rollout
    def rollout(self, model: str, path: str,
                window: Optional[int] = None) -> dict:
        """Staggered fleet rollout with skew holds (rollout.py); the
        hold state feeds this router's /healthz until cleared."""
        w = self.config.skew_window if window is None else int(window)
        out = staggered_rollout(self.poller, model, path, window=w,
                                log_fn=self.log)
        with self._lock:
            if out["status"] == RouterStatus.SKEW_HOLD.name:
                self._holds[model] = out["report"]
            else:
                self._holds.pop(model, None)
        return out

    def holds(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._holds)

    # ------------------------------------------------------------ status
    def status_code(self) -> RouterStatus:
        states = self.poller.states()
        if not self.replica_set.replicas():
            return RouterStatus.NO_REPLICA
        up = [u for u, s in states.items()
              if s in ("ok", "degraded")]
        if not up:
            # never-polled replicas report no state at all: still
            # nothing admissible, which is NO_REPLICA, not ALL_DOWN
            return (RouterStatus.ALL_DOWN if states
                    else RouterStatus.NO_REPLICA)
        if self.holds():
            return RouterStatus.SKEW_HOLD
        return RouterStatus.OK

    def health(self) -> dict:
        """The router's own /healthz payload (fleet-level view)."""
        snap = self.poller.snapshot()
        states = {u: r.state for u, r in snap.items()}
        code = self.status_code()
        if code in (RouterStatus.NO_REPLICA, RouterStatus.ALL_DOWN):
            status = "down"
        elif code == RouterStatus.SKEW_HOLD \
                or any(s != "ok" for s in states.values()):
            status = "degraded"
        else:
            status = "ok"
        view = self.replica_set.view()
        return {
            "status": status,
            "router": code.name,
            "replicas": states,
            "holds": self.holds(),
            "placement": {
                "version": view.version,
                "replicas": list(view.replicas),
                "replication": self.replica_set.k,
                "seed": self.replica_set.seed,
            },
        }

    def replica_detail(self) -> dict:
        """GET /v1/replicas: the poller's full per-replica records."""
        out = {}
        for url, rec in sorted(self.poller.snapshot().items()):
            out[url] = {
                "state": rec.state,
                "replica_id": rec.replica_id,
                "uptime_s": rec.uptime_s,
                "generations": dict(rec.generations),
                "breakers": dict(rec.breakers),
                "burning": list(rec.burning),
                "failures": rec.failures,
                "last_error": rec.last_error,
            }
        return out

    def metrics_text(self) -> str:
        return self._registry.render_text()

    # -------------------------------------------------------------- fleet
    def fleet_payload(self) -> dict:
        """This router process's own fleet snapshot payload (the same
        shape every serve replica exports at /metrics.json)."""
        from tpusvm_torch.obs.fleet import snapshot_payload

        return snapshot_payload(
            "router", self.instance, self._registry.snapshot(),
            status={"router": self.status_code().name,
                    "replicas": self.poller.states()})

    def fleet_view(self):
        """One synchronous scrape over the CURRENT replica membership
        plus this router itself — the GET /fleet/metrics backend."""
        from tpusvm_torch.obs.fleet import FleetCollector

        c = FleetCollector(timeout_s=self.config.health_timeout_s)
        for url in self.replica_set.replicas():
            c.add_replica(url)
        c.add_callable(self.fleet_payload, name="router")
        return c.scrape_once()

    def fleet_metrics_text(self) -> str:
        from tpusvm_torch.obs.fleet import render_fleet_text

        return render_fleet_text(self.fleet_view())

    def fleet_metrics_json(self) -> dict:
        from tpusvm_torch.obs.fleet import fleet_json

        return fleet_json(self.fleet_view())

    # --------------------------------------------------------- lifecycle
    def start(self) -> "Router":
        self.poller.start()
        return self

    def attach_http(self, httpd, thread=None) -> None:
        with self._lock:
            self._httpd = httpd
            self._http_thread = thread

    def close(self) -> None:
        with self._lock:
            httpd, http_thread = self._httpd, self._http_thread
            self._httpd = self._http_thread = None
        if httpd is not None:
            from tpusvm_torch.serve.http import stop_http_server

            stop_http_server(httpd, http_thread)
        self.poller.stop()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def _router(self) -> Router:
        return self.server.tpusvm_router

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str,
              retry_after: Optional[str] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", retry_after)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/healthz":
            health = self._router.health()
            self._send_json(health,
                            code=503 if health["status"] == "down"
                            else 200)
        elif self.path == "/metrics":
            self._send(200, self._router.metrics_text().encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/metrics.json":
            self._send_json(self._router.fleet_payload())
        elif self.path == "/fleet/metrics":
            self._send(200, self._router.fleet_metrics_text().encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/fleet/metrics.json":
            self._send_json(self._router.fleet_metrics_json())
        elif self.path == "/v1/replicas":
            self._send_json(self._router.replica_detail())
        else:
            self._send_json({"error": f"no route {self.path}"}, code=404)

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/admin/rollout":
            try:
                payload = json.loads(self._read_body() or b"{}")
                name, path = payload["name"], payload["path"]
            except (ValueError, KeyError, TypeError) as e:
                self._send_json(
                    {"error": f"bad request body (need name+path): {e}"},
                    code=400)
                return
            out = self._router.rollout(name, path,
                                       window=payload.get("window"))
            self._send_json(
                out,
                code=409 if out["status"]
                == RouterStatus.SKEW_HOLD.name else 200)
            return
        if self.path in ("/admin/join", "/admin/leave"):
            try:
                payload = json.loads(self._read_body() or b"{}")
                url = payload["url"]
            except (ValueError, KeyError, TypeError) as e:
                self._send_json(
                    {"error": f"bad request body (need url): {e}"},
                    code=400)
                return
            rs = self._router.replica_set
            changed = (rs.join(url) if self.path == "/admin/join"
                       else rs.leave(url))
            self._send_json({"changed": changed,
                             "version": rs.version,
                             "replicas": list(rs.replicas())})
            return
        if self.path.startswith("/v1/models/") and (
                self.path.endswith(":predict")):
            from tpusvm_torch.obs.trace import TRACE_HEADER, TraceContext

            name = self.path[len("/v1/models/"):-len(":predict")]
            code, data, retry_after = self._router.forward(
                name, self._read_body(),
                ctx=TraceContext.from_header(
                    self.headers.get(TRACE_HEADER)))
            self._send(code, data, "application/json",
                       retry_after=retry_after)
            return
        self._send_json({"error": f"no route {self.path}"}, code=404)


def make_router_http(router: Router, host: str = "127.0.0.1",
                     port: int = 8470,
                     verbose: bool = False) -> ThreadingHTTPServer:
    """Bind (not yet serving) the router's HTTP front door.

    port=0 binds an ephemeral port; read httpd.server_address. Same
    ownership contract as serve/http.py: pair with start_http_thread
    and Router.close() (which stops the listener AND the poller)."""
    httpd = ThreadingHTTPServer((host, port), _RouterHandler)
    httpd.tpusvm_router = router
    httpd.verbose = verbose
    httpd.daemon_threads = True
    return httpd
