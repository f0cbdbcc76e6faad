"""One retry/backoff primitive for the port's I/O-shaped calls.

The port's copy of tpusvm/faults/retry.py. ``Retry(policy)`` runs a call
with exponential backoff, seeded jitter, a max-attempts budget and
per-class retryability: an injected TransientIOError (or another class
the policy names) is retried, anything else propagates at once, and
:class:`SimulatedKill` (a BaseException) is never caught.

Jitter comes from ``np.random.default_rng(policy.seed)`` owned by the
Retry instance, so a chaos test's sleep schedule is reproducible.
Exhaustion raises :class:`RetryExhaustedError` naming the operation, the
attempt count and the last error (chained); the stream reader maps it to
``StreamStatus.READ_FAILED``.

Adopters: shard reads (stream/reader.py), ingest shard and journal
writes (stream/format.py), solver checkpoint writes
(solver/checkpoint.py). Every attempt, recovery and exhaustion counts in
the default metrics registry (``retry.attempts`` / ``retry.recovered`` /
``retry.exhausted``, labelled by op) and goes out as a ``retry.*`` event
through faults.emit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Type

import numpy as np

from tpusvm_torch.faults.injection import TransientIOError, emit


class RetryExhaustedError(RuntimeError):
    """All attempts failed; `last` is the final exception (also chained)."""

    def __init__(self, op: str, attempts: int, last: BaseException):
        self.op = op
        self.attempts = attempts
        self.last = last
        super().__init__(
            f"{op}: retry budget exhausted after {attempts} attempts "
            f"(last error: {type(last).__name__}: {last})"
        )


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape + retryability classification.

    Delay before attempt k (k >= 2) is
    ``min(max_delay_s, base_delay_s * multiplier**(k-2))`` scaled by a
    uniform jitter in [1-jitter, 1+jitter]. Defaults are sized for local
    file I/O — milliseconds, not the seconds a remote store would want.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.005
    max_delay_s: float = 0.25
    multiplier: float = 2.0
    jitter: float = 0.5
    retryable: Tuple[Type[BaseException], ...] = (TransientIOError,)
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay_for(self, attempt: int, rng) -> float:
        """Sleep before attempt `attempt` (2-based; attempt 1 never waits)."""
        raw = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** (attempt - 2))
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * float(rng.random()) - 1.0)
        return raw


#: Default policy for shard/manifest I/O (stream reads, ingest writes,
#: solver-checkpoint writes): retry injected transients AND real OSErrors
#: except a missing file, which no amount of waiting conjures back.
DEFAULT_IO_POLICY = RetryPolicy(
    retryable=(TransientIOError, InterruptedError, BlockingIOError,
               TimeoutError),
)


class Retry:
    """Callable retry executor: ``Retry(policy, op="x")(fn, *args)``.

    One instance per call site (it owns the jitter RNG and the op label);
    thread-safe only in the sense that concurrent calls share the RNG —
    adopters (the stream reader's single producer thread, the ingest
    writer, the checkpoint writer) are single-threaded at the call site.
    """

    def __init__(self, policy: RetryPolicy = RetryPolicy(), op: str = "op",
                 metrics=None, sleep: Callable[[float], None] = time.sleep,
                 on_retry: Optional[Callable[[], None]] = None):
        if metrics is None:
            from tpusvm_torch.obs.registry import default_registry

            metrics = default_registry()
        self.policy = policy
        self.op = op
        self.sleep = sleep
        self.on_retry = on_retry
        self._rng = np.random.default_rng(policy.seed)
        self._attempts = metrics.counter("retry.attempts", op=op)
        self._recovered = metrics.counter("retry.recovered", op=op)
        self._exhausted = metrics.counter("retry.exhausted", op=op)

    def __call__(self, fn: Callable, *args, **kwargs):
        p = self.policy
        last: Optional[BaseException] = None
        for attempt in range(1, p.max_attempts + 1):
            if attempt > 1:
                if self.on_retry is not None:
                    self.on_retry()
                self.sleep(p.delay_for(attempt, self._rng))
            self._attempts.inc()
            try:
                out = fn(*args, **kwargs)
            except p.retryable as e:
                last = e
                emit("retry.failed_attempt", op=self.op, attempt=attempt,
                     error=f"{type(e).__name__}: {e}")
                continue
            # any non-retryable exception (and SimulatedKill, which as a
            # BaseException never matches `retryable`) propagates here
            if attempt > 1:
                self._recovered.inc()
                emit("retry.recovered", op=self.op, attempts=attempt)
            return out
        self._exhausted.inc()
        emit("retry.exhausted", op=self.op, attempts=p.max_attempts,
             error=f"{type(last).__name__}: {last}")
        raise RetryExhaustedError(self.op, p.max_attempts, last) from last
