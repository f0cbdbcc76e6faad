"""Replica health: /healthz polling -> per-replica state machine.

The port's copy of tpusvm/router/health.py. The router never guesses a
replica's condition from a failed forward alone: a background poller
reads each replica's /healthz (the payload serve/server.py exports:
overall status, per-model breaker states, the swap/generation block, SLO
burn gauges, replica_id, uptime_s) and runs a per-replica state machine:

  ok        the last poll answered "ok"
  degraded  the replica answered but reported trouble: an open/half-open
            breaker, a failed last swap, OR a burning SLO budget (a
            burning replica is deprioritized for new placements before
            its breaker ever trips)
  draining  the replica answered 503 "draining": in-flight work finishes
            there but the router sends nothing new
  down      `down_after` consecutive poll failures (refused, timeout,
            garbage), or never successfully polled at all

A single missed poll does NOT down a replica (it keeps its previous state
until the streak reaches `down_after`); forwarding failures in the
meantime are the proxy's failover's job.

Per-replica states are exported as gauges (``router.replica_state
{replica=...}``, coded via STATE_CODES) plus a ``router.replicas_up``
count on the router's registry.

The poll thread is owned: daemon=True AND stop() joins it. `poll_once()`
is the deterministic test surface; the snapshot readers consume is an
immutable dict replaced whole under the poller lock.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

REPLICA_STATES = ("ok", "degraded", "draining", "down")

#: gauge encoding of the state machine (router.replica_state)
STATE_CODES = {"ok": 0, "degraded": 1, "draining": 2, "down": 3}


def fetch_healthz(url: str, timeout_s: float = 2.0) -> dict:
    """GET <url>/healthz and parse the JSON payload.

    A draining replica answers 503 WITH a healthz body — the payload is
    read off the HTTPError too, so "draining" is a state, not a fetch
    failure. Anything unparseable raises (the poller counts it as a
    failed poll)."""
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                    timeout=timeout_s) as resp:
            raw = resp.read()
    except urllib.error.HTTPError as e:
        raw = e.read()
    obj = json.loads(raw)
    if not isinstance(obj, dict) or "status" not in obj:
        raise ValueError(f"{url}/healthz returned no status: {obj!r}")
    return obj


def post_json(url: str, obj: dict, timeout_s: float = 10.0
              ) -> Tuple[int, dict]:
    """POST a JSON body, return (code, parsed JSON payload).

    Error codes (4xx/5xx) come back as (code, payload) rather than
    raising — a 409 swap rollback is an answer, not an exception. Used
    for the NON-idempotent admin routes, so there is deliberately no
    retry here (rollout.py's per-replica swap must fire at most once)."""
    body = json.dumps(obj).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read() or b"{}")
        except ValueError:
            payload = {}
        return e.code, payload


@dataclasses.dataclass
class ReplicaHealth:
    """One replica's current view, as the last polls saw it."""

    url: str
    state: str = "down"            # never successfully polled yet
    replica_id: Optional[str] = None
    uptime_s: Optional[float] = None
    generations: Dict[str, int] = dataclasses.field(default_factory=dict)
    breakers: Dict[str, str] = dataclasses.field(default_factory=dict)
    burning: Tuple[str, ...] = ()  # models with a burning SLO budget
    failures: int = 0              # CONSECUTIVE failed polls
    polls: int = 0                 # successful polls, ever
    last_error: Optional[str] = None


class HealthPoller:
    """Background /healthz poller feeding the replica state machine.

    `replicas` is a sequence of base URLs or a callable returning one
    (the router passes its ReplicaSet's live view, so joins/leaves are
    picked up on the next poll). `fetch` is injectable for tests —
    poll_once() with a stub fetch is the deterministic state-machine
    test surface."""

    def __init__(self, replicas: Union[Sequence[str], Callable],
                 interval_s: float = 1.0, down_after: int = 2,
                 timeout_s: float = 2.0,
                 fetch: Callable[..., dict] = fetch_healthz,
                 registry=None,
                 log_fn: Optional[Callable[[str], None]] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if down_after < 1:
            raise ValueError(f"down_after must be >= 1, got {down_after}")
        if registry is None:
            from tpusvm_torch.obs.registry import default_registry

            registry = default_registry()
        self._replicas = (replicas if callable(replicas)
                          else (lambda: tuple(replicas)))
        self.interval_s = interval_s
        self.down_after = int(down_after)
        self.timeout_s = timeout_s
        self._fetch = fetch
        self._registry = registry
        self.log = log_fn or (lambda msg: None)
        self._lock = threading.Lock()
        # url -> ReplicaHealth; REPLACED WHOLE under the lock at each
        # poll, so snapshot() hands out a dict no poll will mutate
        self._health: Dict[str, ReplicaHealth] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ polling
    def _classify(self, rec: ReplicaHealth, payload: dict) -> str:
        rec.replica_id = payload.get("replica_id", rec.replica_id)
        if payload.get("uptime_s") is not None:
            rec.uptime_s = float(payload["uptime_s"])
        rec.generations = {
            name: int(sw["generation"])
            for name, sw in (payload.get("swap") or {}).items()
            if isinstance(sw, dict) and "generation" in sw
        }
        rec.breakers = dict(payload.get("models") or {})
        rec.burning = tuple(sorted(
            name for name, st in (payload.get("slo") or {}).items()
            if isinstance(st, dict) and st.get("burning")
        ))
        status = payload.get("status")
        if status == "draining":
            return "draining"
        if status == "degraded" or rec.burning:
            # burn-aware: a burning budget deprioritizes the replica
            # even when the replica itself still says "ok" (slo_shed off)
            return "degraded"
        return "ok"

    def poll_once(self) -> Dict[str, str]:
        """One poll pass over the current membership; {url: state}."""
        urls = tuple(self._replicas())
        with self._lock:
            old = self._health
        nxt: Dict[str, ReplicaHealth] = {}
        for url in urls:
            prev = old.get(url)
            rec = dataclasses.replace(prev) if prev is not None \
                else ReplicaHealth(url=url)
            try:
                payload = self._fetch(url, timeout_s=self.timeout_s)
            except Exception as e:  # noqa: BLE001 — a dead replica is a
                # state, not a poller crash
                rec.failures += 1
                rec.last_error = f"{type(e).__name__}: {e}"
                if rec.failures >= self.down_after or rec.polls == 0:
                    if rec.state != "down":
                        self.log(f"router: replica {url} DOWN "
                                 f"({rec.last_error})")
                    rec.state = "down"
                # else: keep the previous state for the grace window
            else:
                was = rec.state
                rec.failures = 0
                rec.polls += 1
                rec.last_error = None
                rec.state = self._classify(rec, payload)
                if was == "down" and rec.state != "down" and prev is not None:
                    self.log(f"router: replica {url} back ({rec.state})")
            nxt[url] = rec
            self._registry.gauge(
                "router.replica_state", replica=url
            ).set(float(STATE_CODES[rec.state]))
        up = sum(1 for r in nxt.values() if r.state in ("ok", "degraded"))
        self._registry.gauge("router.replicas_up").set(float(up))
        # tpusvm: guarded-by=single-writer publication; only the poll thread writes _health, and it is replaced whole — the earlier read is a snapshot base, not a predicate
        with self._lock:
            self._health = nxt
        return {url: rec.state for url, rec in nxt.items()}

    def snapshot(self) -> Dict[str, ReplicaHealth]:
        """The last poll's view (the dict is never mutated after
        publication; treat the records as read-only)."""
        with self._lock:
            return self._health

    def states(self) -> Dict[str, str]:
        return {url: rec.state for url, rec in self.snapshot().items()}

    # --------------------------------------------------------- admission
    def admissible(self, placed: Sequence[str],
                   fallback: Sequence[str] = ()) -> list:
        """Forwarding order for a request placed on `placed`.

        Two tiers — the placed replicas, then the rest of the fleet
        (`fallback`; in this fleet every replica hosts every model, so
        placement is an affinity, not an exclusivity) — and within each
        tier "ok" before "degraded" (the burn-aware deprioritization).
        draining and down replicas are excluded outright; a replica the
        poller has never seen is excluded until its first good poll."""
        snap = self.snapshot()

        def tier(urls):
            ok_, deg = [], []
            for u in urls:
                rec = snap.get(u)
                if rec is None or rec.state in ("down", "draining"):
                    continue
                (deg if rec.state == "degraded" else ok_).append(u)
            return ok_ + deg

        out = tier(placed)
        seen = set(out)
        out += [u for u in tier(fallback) if u not in seen]
        return out

    # ------------------------------------------------------------ thread
    def start(self) -> "HealthPoller":
        if self._thread is not None:
            raise RuntimeError("health poller already started")
        self.poll_once()  # first view before anyone is admitted

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — keep polling
                    self.log(f"router: poll error: "
                             f"{type(e).__name__}: {e}")

        # tpusvm: guarded-by=owner-only lifecycle; start/stop run on the owning thread, the poll thread never touches _thread
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="tpusvm-torch-router-health")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            # tpusvm: guarded-by=owner-only lifecycle; cleared after the joined thread exited
            self._thread = None
