"""Deterministic, seeded fault injection at named points.

The port's copy of tpusvm/faults/injection.py. Call sites invoke
``faults.point("stream.read_shard")`` on their I/O paths, and a seeded
:class:`FaultPlan` (JSON, the JAX package's format) decides per hit
whether to raise a :class:`TransientIOError`, inject latency, corrupt a
byte payload or simulate a process kill. With no plan active a point is
one ``is None`` check.

Determinism: every rule draws from its own
``np.random.default_rng(seed ^ crc32(f"{index}:{point}"))`` stream and
hits are counted under a lock, so the same plan against the same workload
fires the same faults in the same order in either package.

The points the port has call sites for:

  ``stream.read_shard``       ShardedDataset.load_shard (stream/format.py)
  ``ingest.write_shard``      ShardWriter's atomic shard write; carries
                              the npz byte payload, so ``corrupt`` rules
                              apply here (stream/format.py)
  ``stream.journal``          the ingest journal write and close()'s two
                              commit transitions (stream/format.py)
  ``solver.outer_checkpoint`` the solver-state checkpoint write
                              (solver/checkpoint.py)
  ``cascade.round``           entry to every cascade round, under Retry
                              (parallel/cascade.py)
  ``cascade.checkpoint``      the cascade round-state write
                              (parallel/cascade.py)
  ``models.save``             the model artifact write
                              (models/serialization.py)
  ``pod.round``               entry to every pod round, under Retry
                              (pod/coordinator.py)
  ``pod.merge``               the pod round-state write (pod/state.py)
  ``pod.worker``              every request a pod worker takes; a kill
                              there is escalated to a real SIGKILL
                              (pod/worker.py)
  ``serve.score``             every scoring attempt of a served batch,
                              under Retry (serve/server.py)
  ``serve.swap``              the start of a hot-swap stage
                              (serve/server.py)
  ``registry.load``           a served artifact's bytes; carries the
                              payload, so ``corrupt`` rules apply here
                              (serve/registry.py)
  ``cache.read``              the serve-state and bucket-manifest reads,
                              under Retry (serve/cache.py)
  ``serve.state_write``       the serve-state and bucket-manifest writes
                              (serve/cache.py)
  ``stream.append``           the append journal's writes and the append
                              commit's two transitions (stream/append.py)
  ``autopilot.tick``          entry to every autopilot tick
                              (autopilot/loop.py)
  ``autopilot.refresh``       the autopilot's fit/save/swap stage
                              (autopilot/loop.py)
  ``autopilot.state``         the autopilot_state.json write
                              (autopilot/state.py)
  ``tenants.tick``            entry to every tenants tick (tenants/loop.py)
  ``tenants.store``           the tenant store's writes and the coalesced
                              refresh's fleet checkpoints (tenants/store.py)
  ``router.forward``          every per-replica forward attempt of the
                              router, under Retry (router/proxy.py)

Every name of POINTS has a call site in the port.

Kill semantics: :class:`SimulatedKill` subclasses ``BaseException``, so
no ``except Exception`` recovery path, the retry machinery included, can
swallow it: what survives one is what survives a real SIGKILL, the bytes
already durable on disk.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

PLAN_FORMAT_VERSION = 1

#: The canonical injection-point registry, the JAX package's set, so a plan
#: written for either package loads in the other. Call sites use these
#: literal names; plan validation rejects typos against this set.
POINTS = frozenset({
    "stream.read_shard",
    "ingest.write_shard",
    "serve.score",
    "serve.swap",
    "registry.load",
    "cache.read",
    "cascade.round",
    "solver.outer_checkpoint",
    "stream.append",
    "autopilot.tick",
    "autopilot.refresh",
    "stream.journal",
    "models.save",
    "serve.state_write",
    "autopilot.state",
    "cascade.checkpoint",
    "router.forward",
    "tenants.tick",
    "tenants.store",
    "pod.round",
    "pod.merge",
    "pod.worker",
})

KINDS = ("transient", "latency", "corrupt", "kill")


class FaultError(Exception):
    """Base class for injected (recoverable) faults."""


class TransientIOError(FaultError, OSError):
    """An injected transient I/O failure — the retryable fault class.

    Subclasses OSError so call sites that already classify OSErrors as
    retryable treat the injected fault exactly like a real flaky disk."""


class SimulatedKill(BaseException):
    """Injected process death. BaseException on purpose: retry loops and
    ``except Exception`` recovery must NOT catch it — only state already
    durable on disk survives, which is precisely what a chaos test wants
    to measure."""


@dataclasses.dataclass
class FaultRule:
    """One plan entry: WHAT fires at WHICH point, and how often.

    p:        per-hit fire probability (seeded; 1.0 = every hit).
    max_hits: total fires allowed (None = unbounded) — a transient rule
              with max_hits=2 fails a retried operation twice and then
              lets the third attempt through, the retry-to-success shape.
    at_hit:   fire EXACTLY on the Nth hit of the point (1-based),
              ignoring p — the deterministic "kill at the k-th
              checkpoint" primitive.
    delay_ms: sleep duration for kind="latency".
    """

    point: str
    kind: str
    p: float = 1.0
    max_hits: Optional[int] = None
    at_hit: Optional[int] = None
    delay_ms: float = 1.0
    # runtime state (not part of the JSON surface)
    fires: int = dataclasses.field(default=0, compare=False)

    def validate(self) -> None:
        if self.point not in POINTS:
            raise ValueError(
                f"fault plan names unknown injection point {self.point!r}; "
                f"registered points: {sorted(POINTS)}"
            )
        if self.kind not in KINDS:
            raise ValueError(
                f"fault rule for {self.point!r} has unknown kind "
                f"{self.kind!r}; kinds: {KINDS}"
            )
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"fault rule p must be in [0, 1], got {self.p}")
        if self.max_hits is not None and self.max_hits < 1:
            raise ValueError(f"max_hits must be >= 1, got {self.max_hits}")
        if self.at_hit is not None and self.at_hit < 1:
            raise ValueError(f"at_hit must be >= 1, got {self.at_hit}")


class FaultPlan:
    """A seeded, deterministic set of fault rules.

    Thread-safe: hit counts and each rule's RNG stream are guarded by one
    lock (injection sits on I/O paths where a lock is noise)."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 source: str = "<inline>"):
        for r in rules:
            r.validate()
        self.rules = rules
        self.seed = int(seed)
        self.source = source
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        # one independent, platform-stable stream per rule: seed mixed
        # with a CRC of the point name and the rule's index, so adding a
        # rule never perturbs another rule's draw sequence
        self._rngs = [
            np.random.default_rng(
                (self.seed ^ zlib.crc32(f"{i}:{r.point}".encode()))
                & 0xFFFFFFFF
            )
            for i, r in enumerate(rules)
        ]

    @classmethod
    def from_json(cls, obj: dict, source: str = "<inline>") -> "FaultPlan":
        if not isinstance(obj, dict) or "format_version" not in obj:
            raise ValueError(
                "not a tpusvm fault plan (no format_version key)"
            )
        v = obj["format_version"]
        if v != PLAN_FORMAT_VERSION:
            raise ValueError(
                f"unsupported fault plan format_version {v!r} (this build "
                f"reads version {PLAN_FORMAT_VERSION})"
            )
        known = {"point", "kind", "p", "max_hits", "at_hit", "delay_ms"}
        rules = []
        for i, r in enumerate(obj.get("rules", [])):
            bad = set(r) - known
            if bad:
                raise ValueError(
                    f"fault plan rule {i} has unknown keys {sorted(bad)}; "
                    f"known: {sorted(known)}"
                )
            if "point" not in r or "kind" not in r:
                raise ValueError(
                    f"fault plan rule {i} needs 'point' and 'kind'"
                )
            rules.append(FaultRule(
                point=str(r["point"]),
                kind=str(r["kind"]),
                p=float(r.get("p", 1.0)),
                max_hits=(None if r.get("max_hits") is None
                          else int(r["max_hits"])),
                at_hit=(None if r.get("at_hit") is None
                        else int(r["at_hit"])),
                delay_ms=float(r.get("delay_ms", 1.0)),
            ))
        return cls(rules, seed=int(obj.get("seed", 0)), source=source)

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def _decide(self, point: str):
        """(hit_number, [rules that fire this hit]) under the lock."""
        with self._lock:
            n = self._hits.get(point, 0) + 1
            self._hits[point] = n
            firing = []
            for rule, rng in zip(self.rules, self._rngs):
                if rule.point != point:
                    continue
                if rule.at_hit is not None:
                    fire = n == rule.at_hit
                else:
                    if rule.max_hits is not None \
                            and rule.fires >= rule.max_hits:
                        continue
                    fire = rule.p >= 1.0 or rng.random() < rule.p
                if fire:
                    rule.fires += 1
                    firing.append((rule, rng))
            return n, firing


def load_plan(path: str) -> FaultPlan:
    """Read + validate a JSON fault plan file."""
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"fault plan {path!r} is not valid JSON: {e}")
    return FaultPlan.from_json(obj, source=path)


# ------------------------------------------------------------- activation
_active: Optional[FaultPlan] = None
_sink: Optional[Callable] = None


def activate(plan: FaultPlan) -> FaultPlan:
    """Install a plan process-wide."""
    global _active
    _active = plan
    return plan


def deactivate() -> None:
    global _active
    _active = None


def active_plan() -> Optional[FaultPlan]:
    return _active


class active:
    """Context manager: activate a plan for a with-block (tests)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return activate(self.plan)

    def __exit__(self, *exc) -> None:
        deactivate()


def set_event_sink(fn: Optional[Callable]) -> None:
    """Route fault and retry events to `fn(name, **attrs)`; None drops
    them. Counters in the default metrics registry are emitted regardless
    of the sink."""
    global _sink
    _sink = fn


def emit(name: str, **attrs) -> None:
    """Emit one fault-lifecycle event to the installed sink (if any)."""
    if _sink is not None:
        _sink(name, **attrs)


def _counter(name: str, **labels):
    from tpusvm_torch.obs.registry import default_registry

    return default_registry().counter(name, **labels)


def point(name: str, payload: Optional[bytes] = None, **attrs):
    """An injection point. Returns `payload` (possibly corrupted).

    With no active plan this is a single global read. With a plan, the
    hit is counted and every matching rule that fires is applied in rule
    order:

      transient -> raise TransientIOError (retryable)
      latency   -> time.sleep(delay_ms)
      corrupt   -> flip one payload byte at a seeded offset (requires a
                   bytes payload; a corrupt rule firing on a payload-less
                   point is a plan bug and raises ValueError)
      kill      -> raise SimulatedKill (BaseException — uncatchable by
                   retry/except-Exception paths)
    """
    plan = _active
    if plan is None:
        return payload
    if name not in POINTS:
        raise ValueError(f"unregistered injection point {name!r}")
    hit, firing = plan._decide(name)
    for rule, rng in firing:
        _counter("faults.injected", point=name, kind=rule.kind).inc()
        emit("fault.injected", point=name, kind=rule.kind, hit=hit,
             **attrs)
        if rule.kind == "transient":
            raise TransientIOError(
                f"injected transient fault at {name} (hit {hit}, "
                f"plan {plan.source})"
            )
        if rule.kind == "latency":
            time.sleep(rule.delay_ms / 1e3)
        elif rule.kind == "corrupt":
            if payload is None:
                raise ValueError(
                    f"corrupt rule fired at {name!r}, which carries no "
                    "byte payload to corrupt (corrupt applies to "
                    "ingest.write_shard and registry.load)"
                )
            buf = bytearray(payload)
            # seeded offset keeps the corruption reproducible; skip the
            # first 64 bytes so the zip header stays parseable and the
            # damage lands in DATA (the checksum's job to catch)
            lo = min(64, len(buf) - 1)
            idx = int(rng.integers(lo, len(buf)))
            buf[idx] ^= 0xFF
            payload = bytes(buf)
        elif rule.kind == "kill":
            raise SimulatedKill(
                f"injected process kill at {name} (hit {hit}, "
                f"plan {plan.source})"
            )
    return payload
