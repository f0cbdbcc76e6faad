"""Deadline-aware micro-batching of single-row predict requests.

The port's copy of tpusvm/serve/batcher.py (host only). The throughput
lever: one padded-bucket replay scores a whole batch for roughly the cost
of scoring one row (the bucket program is small next to the per-call
overhead at serving sizes), so coalescing k concurrent single-row
requests into one batch is about k-fold throughput, IF no request waits
unboundedly for the batch to fill. Hence the deadline rule: a batch
flushes when it reaches max_batch rows OR when its OLDEST member has
waited max_delay; an idle server ships a lone request after at most
max_delay.

Concurrency model: clients enqueue and block on a per-request event; ONE
worker thread per batcher drains the queue, runs the scoring callback
(which launches the device work) and distributes results. All scoring
for a model therefore happens on a single thread while any number of
client threads submit.

Backpressure is a bounded queue with fast-fail: when the queue is full the
request is rejected immediately (QUEUE_FULL) instead of absorbing unbounded
latency — the Clipper/SLO-serving discipline. Per-request timeouts bound
the other tail: a client stops waiting after its deadline, and the worker
drops requests that are already dead on arrival rather than paying kernel
time for an answer nobody reads.

Degraded mode: an optional shed_at threshold answers
OVERLOADED before the hard bound is reached (deliberate load shedding a
dashboard can tell apart from a mis-sized queue); a BreakerOpenError from
the scoring callback fails the batch with UNAVAILABLE (the model's circuit
breaker is open — no kernel time spent); drain() stops admission
(DRAINING) and waits, via an in-queue barrier, for everything already
accepted to resolve — the zero-downtime-restart primitive.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from tpusvm_torch.faults.breaker import BreakerOpenError
from tpusvm_torch.status import ServeStatus

# run_batch: (m, d) scaled-or-raw rows -> (scores, labels) with leading dim m
RunBatch = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass
class ServeResult:
    """Outcome of one predict request."""

    status: ServeStatus
    scores: Optional[np.ndarray] = None   # binary: (); ovr: (K,)
    label: Optional[object] = None        # binary: +/-1; ovr: class id
    latency_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == ServeStatus.OK


class _Request:
    __slots__ = ("x", "enq_t", "deadline_t", "event", "result")

    def __init__(self, x: np.ndarray, enq_t: float,
                 deadline_t: Optional[float]):
        self.x = x
        self.enq_t = enq_t
        self.deadline_t = deadline_t
        self.event = threading.Event()
        self.result: Optional[ServeResult] = None


_SENTINEL = object()


class _DrainBarrier:
    """Queue marker for drain(): its event fires once every request that
    was enqueued before it has been scored (or failed)."""

    __slots__ = ("event",)

    def __init__(self):
        self.event = threading.Event()


class MicroBatcher:
    """Bounded request queue + one scoring worker for a single model.

    shed_at: load-shedding threshold (requests observed while the queue
    already holds >= shed_at entries come back OVERLOADED immediately —
    deliberate degraded-mode shedding, distinct from the hard QUEUE_FULL
    bound). None (default) disables shedding.
    """

    def __init__(self, run_batch: RunBatch, *, max_batch: int = 64,
                 max_delay_s: float = 0.002, queue_size: int = 1024,
                 timeout_s: float = 1.0, metrics=None,
                 shed_at: Optional[int] = None,
                 admission=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if shed_at is not None and shed_at < 1:
            raise ValueError(f"shed_at must be >= 1, got {shed_at}")
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.timeout_s = timeout_s
        self.metrics = metrics
        self.shed_at = shed_at
        # optional admission predicate (e.g. the SLO burn gauge): False
        # sheds the request with OVERLOADED before it queues
        self.admission = admission
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._closed = False
        self._draining = False
        self._barriers: List[_DrainBarrier] = []  # worker-thread only
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tpusvm-torch-serve-batcher")
        self._worker.start()

    # ------------------------------------------------------------- client
    def _reject(self, t0: float) -> Optional[ServeResult]:
        """Admission control shared by submit paths: draining beats
        shedding beats the hard queue bound (checked at put time)."""
        if self._draining:
            if self.metrics:
                self.metrics.inc("draining")
            return ServeResult(ServeStatus.DRAINING,
                               latency_s=time.monotonic() - t0)
        if self.shed_at is not None and self._q.qsize() >= self.shed_at:
            if self.metrics:
                self.metrics.inc("overloaded")
            return ServeResult(ServeStatus.OVERLOADED,
                               latency_s=time.monotonic() - t0)
        if self.admission is not None and not self.admission():
            if self.metrics:
                self.metrics.inc("overloaded")
            return ServeResult(ServeStatus.OVERLOADED,
                               latency_s=time.monotonic() - t0)
        return None

    def submit(self, x: np.ndarray,
               timeout_s: Optional[float] = None) -> ServeResult:
        """Score one row; blocks until a result or the deadline."""
        if self._closed:
            return ServeResult(ServeStatus.SHUTDOWN)
        timeout = self.timeout_s if timeout_s is None else timeout_s
        t0 = time.monotonic()
        rejected = self._reject(t0)
        if rejected is not None:
            return rejected
        req = _Request(x, t0, t0 + timeout if timeout is not None else None)
        if self.metrics:
            self.metrics.inc("requests")
        try:
            self._q.put_nowait(req)
        except queue.Full:
            if self.metrics:
                self.metrics.inc("queue_full")
            return ServeResult(ServeStatus.QUEUE_FULL,
                               latency_s=time.monotonic() - t0)
        if not req.event.wait(timeout):
            if self.metrics:
                self.metrics.inc("timeouts")
            return ServeResult(ServeStatus.TIMEOUT,
                               latency_s=time.monotonic() - t0)
        res = req.result
        res.latency_s = time.monotonic() - t0
        if self.metrics:
            # the worker never counts timeouts (a dead-on-arrival drop and
            # the client's own expiry would double-count); the client
            # counts exactly one outcome per request
            if res.ok:
                self.metrics.observe_latency(res.latency_s)
            elif res.status == ServeStatus.TIMEOUT:
                self.metrics.inc("timeouts")
        return res

    def submit_many(self, rows: Sequence[np.ndarray],
                    timeout_s: Optional[float] = None) -> List[ServeResult]:
        """Enqueue every row, then wait for all — rows coalesce naturally."""
        if self._closed:
            return [ServeResult(ServeStatus.SHUTDOWN) for _ in rows]
        timeout = self.timeout_s if timeout_s is None else timeout_s
        t0 = time.monotonic()
        deadline = t0 + timeout if timeout is not None else None
        reqs: List[Optional[_Request]] = []
        results: List[Optional[ServeResult]] = []
        for x in rows:
            rejected = self._reject(t0)
            if rejected is not None:
                reqs.append(None)
                results.append(rejected)
                continue
            req = _Request(x, t0, deadline)
            if self.metrics:
                self.metrics.inc("requests")
            try:
                self._q.put_nowait(req)
                reqs.append(req)
                results.append(None)
            except queue.Full:
                if self.metrics:
                    self.metrics.inc("queue_full")
                reqs.append(None)
                results.append(ServeResult(ServeStatus.QUEUE_FULL))
        for i, req in enumerate(reqs):
            if req is None:
                continue
            remaining = None if deadline is None else deadline - time.monotonic()
            expired = remaining is not None and remaining <= 0
            if expired or not req.event.wait(remaining):
                if self.metrics:
                    self.metrics.inc("timeouts")
                results[i] = ServeResult(ServeStatus.TIMEOUT,
                                         latency_s=time.monotonic() - t0)
                continue
            res = req.result
            res.latency_s = time.monotonic() - t0
            if self.metrics:
                if res.ok:
                    self.metrics.observe_latency(res.latency_s)
                elif res.status == ServeStatus.TIMEOUT:
                    self.metrics.inc("timeouts")
            results[i] = res
        return results

    @property
    def depth(self) -> int:
        return self._q.qsize()

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Stop admitting requests (they come back DRAINING) and wait for
        everything already queued to complete. True if quiesced in time.
        Idempotent; safe to close() afterwards."""
        if self._closed:
            return True
        # readers tolerate staleness: a racing submit either drains or
        # lands before the in-queue barrier, which serializes the rest
        # tpusvm: guarded-by=one-way latch; bool store is GIL-atomic
        self._draining = True
        bar = _DrainBarrier()
        try:
            self._q.put(bar, timeout=timeout_s)
        except queue.Full:
            return False
        return bar.event.wait(timeout_s)

    def close(self, timeout_s: float = 5.0) -> None:
        if self._closed:
            return
        # requests that race past the stale read are resolved by the
        # post-join queue sweep below (no dropped futures)
        # tpusvm: guarded-by=one-way latch; bool store is GIL-atomic
        self._closed = True
        self._q.put(_SENTINEL)
        self._worker.join(timeout=timeout_s)
        # final sweep: requests that raced past the _closed check while
        # the worker was exiting must still resolve (no dropped futures)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(req, _DrainBarrier):
                req.event.set()
            elif req is not _SENTINEL:
                req.result = ServeResult(ServeStatus.SHUTDOWN)
                req.event.set()

    # ------------------------------------------------------------- worker
    def _collect(self) -> Optional[List[_Request]]:
        """Block for the first request, then coalesce in two phases:

        1. GREEDY DRAIN — take everything already queued, up to max_batch.
           Under backlog (arrival rate > service rate) this is what keeps
           occupancy at max_batch: the oldest request's max_delay budget
           is already spent, and a deadline-only loop would degrade to
           one-request batches exactly when batching matters most
           (measured: occupancy 1.0 and 12ms p50 under 8-client overload).
        2. DEADLINE LINGER — if the batch still has room and the OLDEST
           member's max_delay budget is not yet spent, wait out the
           remainder for co-riders. An idle server therefore ships a lone
           request after at most max_delay.
        """
        while True:
            first = self._q.get()
            if first is _SENTINEL:
                return None
            if isinstance(first, _DrainBarrier):
                # everything enqueued before the barrier is already
                # scored (the previous batch completed before this
                # _collect): the drain is complete at this point
                first.event.set()
                continue
            batch = [first]
            while len(batch) < self.max_batch:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                if req is _SENTINEL:
                    self._q.put(_SENTINEL)
                    return batch
                if isinstance(req, _DrainBarrier):
                    # fire only after THIS batch (its predecessors) runs
                    self._barriers.append(req)
                    return batch
                batch.append(req)
            flush_at = first.enq_t + self.max_delay_s
            while len(batch) < self.max_batch:
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    req = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if req is _SENTINEL:
                    # flush what we have; the next _collect sees the
                    # re-queued sentinel and exits
                    self._q.put(_SENTINEL)
                    break
                if isinstance(req, _DrainBarrier):
                    self._barriers.append(req)
                    break
                batch.append(req)
            return batch

    def _fire_barriers(self) -> None:
        for bar in self._barriers:
            bar.event.set()
        self._barriers.clear()

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                break
            now = time.monotonic()
            live = []
            for req in batch:
                # dead on arrival: its client already stopped waiting —
                # don't spend kernel time on it
                if req.deadline_t is not None and now > req.deadline_t:
                    req.result = ServeResult(ServeStatus.TIMEOUT)
                    req.event.set()
                else:
                    live.append(req)
            if not live:
                self._fire_barriers()
                continue
            X = np.stack([r.x for r in live])
            try:
                scores, labels = self.run_batch(X)
            except BreakerOpenError:
                # the model's circuit breaker refused the batch before
                # any kernel time was spent: degraded mode, not an error
                if self.metrics:
                    self.metrics.inc("unavailable", len(live))
                for req in live:
                    req.result = ServeResult(ServeStatus.UNAVAILABLE)
                    req.event.set()
                self._fire_barriers()
                continue
            except Exception:  # noqa: BLE001 — a scoring failure must fail
                # the batch's requests, never kill the worker
                if self.metrics:
                    self.metrics.inc("errors", len(live))
                for req in live:
                    req.result = ServeResult(ServeStatus.ERROR)
                    req.event.set()
                self._fire_barriers()
                continue
            if self.metrics:
                self.metrics.inc("ok", len(live))
            for i, req in enumerate(live):
                req.result = ServeResult(ServeStatus.OK, scores=scores[i],
                                         label=labels[i])
                req.event.set()
            self._fire_barriers()
        # drain anything still queued so no client waits out its full
        # timeout against a dead worker
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(req, _DrainBarrier):
                req.event.set()
            elif req is not _SENTINEL:
                req.result = ServeResult(ServeStatus.SHUTDOWN)
                req.event.set()
