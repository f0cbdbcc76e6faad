"""Per-model circuit breaker for degraded-mode serving.

The port's copy of tpusvm/faults/breaker.py (host only). The failure it
prevents: a model whose scoring path is broken (bad weights swapped in, a
failing card, persistent injected faults) keeps absorbing queue slots and
device time, and every caller pays a full scoring attempt to learn the
model is down. The breaker is the three-state machine:

  CLOSED     healthy; failures are counted, successes reset the count.
             `threshold` CONSECUTIVE failures trip it.
  OPEN       every allow() is refused at once (callers get
             ServeStatus.UNAVAILABLE without paying device time) until
             `cooldown_s` has elapsed.
  HALF_OPEN  after the cooldown, exactly ONE probe is admitted; its
             success closes the breaker (recovery), its failure reopens
             it for another cooldown.

The clock is injectable so recovery tests are deterministic. Trips and
recoveries are emitted through faults.emit and counted by the listener
callback (serve wires it to the model's metrics).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from tpusvm_torch.faults.injection import emit

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class BreakerOpenError(RuntimeError):
    """Raised by guarded paths when the breaker refuses the call."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(
            f"circuit breaker for {name!r} is open (scoring is failing); "
            "retry after the cooldown"
        )


class CircuitBreaker:
    """Consecutive-failure trip + half-open probe recovery."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 30.0,
                 name: str = "", clock: Callable[[], float] = time.monotonic,
                 listener: Optional[Callable[[str], None]] = None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.name = name
        self._clock = clock
        self._listener = listener
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_out = False
        self.trips = 0
        self.recoveries = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        # lazy OPEN -> HALF_OPEN transition on inspection: no timer thread
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.cooldown_s:
            return HALF_OPEN
        return self._state

    def _notify(self, event: str) -> None:
        if self._listener is not None:
            self._listener(event)
        emit(f"breaker.{event}", model=self.name, state=self._state,
             consecutive=self._consecutive)

    def allow(self) -> bool:
        """May a call proceed right now? HALF_OPEN admits one probe."""
        with self._lock:
            st = self._effective_state()
            if st == CLOSED:
                return True
            if st == OPEN:
                return False
            # HALF_OPEN: one probe in flight at a time
            if self._state == OPEN:
                self._state = HALF_OPEN
                self._probe_out = False
                self._notify("half_open")
            if self._probe_out:
                return False
            self._probe_out = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probe_out = False
                self.recoveries += 1
                self._notify("recovered")

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN:
                # failed probe: back to a full cooldown
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_out = False
                self._notify("reopened")
            elif self._state == CLOSED \
                    and self._consecutive >= self.threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1
                self._notify("tripped")

    def describe(self) -> dict:
        with self._lock:
            return {
                "state": self._effective_state(),
                "consecutive_failures": self._consecutive,
                "trips": self.trips,
                "recoveries": self.recoveries,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
            }

    # ------------------------------------------------------- persistence
    def snapshot(self) -> dict:
        """Raw machine state for crash-safe supervisors: unlike
        describe(), the STORED state (not the lazily advanced effective
        one) plus the open time in the breaker's own clock domain, so
        restore() replays the cooldown arithmetic exactly."""
        with self._lock:
            return {
                "state": self._state,
                "consecutive": self._consecutive,
                "opened_at": self._opened_at,
                "trips": self.trips,
                "recoveries": self.recoveries,
            }

    def restore(self, snap: dict) -> None:
        """Reinstall a snapshot(): the resumed supervisor's breaker makes
        the allow() decisions the killed one would have (the caller
        supplies the same clock domain)."""
        state = snap["state"]
        if state not in (CLOSED, OPEN, HALF_OPEN):
            raise ValueError(f"unknown breaker state {state!r}")
        with self._lock:
            self._state = state
            self._consecutive = int(snap["consecutive"])
            self._opened_at = float(snap["opened_at"])
            self._probe_out = False
            self.trips = int(snap.get("trips", 0))
            self.recoveries = int(snap.get("recoveries", 0))
