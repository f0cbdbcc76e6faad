"""Deterministic fault injection and the retry primitive it tests.

  injection.py  named injection points at the port's I/O call sites and a
                seeded, JSON-configured FaultPlan (the JAX package's
                format) that raises transients, injects latency, corrupts
                bytes or simulates kills;
  retry.py      Retry(policy): exponential backoff with seeded jitter and
                per-class retryability, adopted by shard reads, ingest
                writes, solver checkpoint writes and served scoring;
  breaker.py    the per-model circuit breaker behind degraded-mode
                serving (serve/server.py).

``python -m tpusvm_torch.faults`` (__main__.py) is the chaos command
line: ``validate``, ``kill-resume-smoke``, ``pod-chaos-smoke``,
``swap-chaos-smoke``, ``autopilot-chaos-smoke``, ``tenant-chaos-smoke``
and ``router-chaos-smoke``.
"""

from tpusvm_torch.faults.breaker import BreakerOpenError, CircuitBreaker

from tpusvm_torch.faults.injection import (
    KINDS,
    PLAN_FORMAT_VERSION,
    POINTS,
    FaultError,
    FaultPlan,
    FaultRule,
    SimulatedKill,
    TransientIOError,
    activate,
    active,
    active_plan,
    deactivate,
    emit,
    load_plan,
    point,
    set_event_sink,
)
from tpusvm_torch.faults.retry import (
    DEFAULT_IO_POLICY,
    Retry,
    RetryExhaustedError,
    RetryPolicy,
)

__all__ = [
    "BreakerOpenError",
    "CircuitBreaker",
    "DEFAULT_IO_POLICY",
    "FaultError",
    "FaultPlan",
    "FaultRule",
    "KINDS",
    "PLAN_FORMAT_VERSION",
    "POINTS",
    "Retry",
    "RetryExhaustedError",
    "RetryPolicy",
    "SimulatedKill",
    "TransientIOError",
    "activate",
    "active",
    "active_plan",
    "deactivate",
    "emit",
    "load_plan",
    "point",
    "set_event_sink",
]
