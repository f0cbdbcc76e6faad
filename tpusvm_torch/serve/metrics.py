"""Serving metrics: counters, batch-occupancy histogram, latency percentiles.

The port's copy of tpusvm/serve/metrics.py, over the port's
obs/registry.py. The OUTPUT contracts are the JAX package's:
`snapshot()` returns the same dict (the same keys, which the router and
the parity tests read) and `render_text()` the same `name{labels} value`
lines.

Everything is host-side Python; one registry lock keeps a scrape
consistent (a request is never observed counted with its latency
missing). Latency percentiles come from a bounded reservoir of the most
recent completions (default 4096) rather than a streaming sketch: exact
over the window, O(window log window) only at scrape time, and the window
bounds memory regardless of uptime. The reservoir stays outside the
registry: exact windowed percentiles are not a mergeable aggregate.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence

from tpusvm_torch.obs.registry import MetricsRegistry

_COUNTERS = (
    "requests",      # rows accepted into the queue
    "ok",            # rows answered with a score
    "errors",        # rows failed by an exception in the scoring path
    "timeouts",      # rows that missed their deadline (client- or queue-side)
    "queue_full",    # rows fast-failed by backpressure (never enqueued)
    "batches",       # flushes run by the micro-batcher
    "recompiles",    # bucket captures AFTER warm-up (steady state target: 0)
    # degraded-mode serving:
    "overloaded",    # rows shed by the load-shedding threshold
    "unavailable",   # rows refused because the circuit breaker is open
    "draining",      # rows refused because the server is draining
    "retries",       # scoring attempts re-run by the retry policy
    "breaker_trips",       # closed -> open transitions
    "breaker_recoveries",  # half-open probe succeeded, breaker closed
    # hot-swap:
    "swaps",           # successful generation flips
    "swap_failures",   # staged swaps that failed + rolled back
)


# failures that BURN the SLO error budget: outcomes where the server
# accepted work and failed to serve it. Admission-control rejections
# (overloaded / queue_full / draining) deliberately do not burn — they
# are the mechanism protecting the budget, and counting them would make
# shedding indistinguishable from the overload it prevents.
_SLO_ERROR_COUNTERS = ("errors", "timeouts", "unavailable")


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Per-model serving SLO budgets.

    p99_ms:       latency target — at most 1% of windowed requests may
                  complete slower than this (the definition of p99);
    error_budget: allowed fraction of windowed completions that fail;
    window_s:     sliding evaluation window.

    BURN RATE is (observed violation rate) / (allowed rate): 1.0 means
    the budget is being consumed exactly as fast as allowed; above 1.0
    the SLO is burning and /healthz reports "degraded". The gauges are
    exported on /metrics (serve.slo_latency_burn / serve.slo_error_burn)
    and feed the admission-control path (ServeConfig.slo_shed)."""

    p99_ms: float
    error_budget: float = 0.001
    window_s: float = 60.0
    # the p99 definition: 1% of requests may exceed the target
    latency_budget: float = 0.01

    def validate(self) -> "SLOConfig":
        if self.p99_ms <= 0:
            raise ValueError(f"slo p99_ms must be > 0, got {self.p99_ms}")
        if not (0.0 < self.error_budget < 1.0):
            raise ValueError(
                f"slo error_budget must be in (0, 1), got "
                f"{self.error_budget}"
            )
        if self.window_s <= 0:
            raise ValueError(
                f"slo window_s must be > 0, got {self.window_s}"
            )
        return self


class Metrics:
    """Thread-safe serving counters for one model (registry-backed)."""

    def __init__(self, buckets: Sequence[int], latency_window: int = 4096,
                 slo: Optional[SLOConfig] = None, clock=None):
        self.registry = MetricsRegistry()
        self.slo = slo.validate() if slo is not None else None
        self._clock = clock or time.monotonic
        # sliding SLO windows: (t, latency_s) completions and
        # (t, ok_n, err_n) outcome batches, pruned at observation and
        # scrape time — memory is bounded by window traffic
        self._slo_lat: collections.deque = collections.deque()
        self._slo_out: collections.deque = collections.deque()
        self._counts = {k: self.registry.counter(f"serve.{k}")
                        for k in _COUNTERS}
        # per-bucket occupancy: how many batches flushed at this bucket
        # size, and how many real (non-padding) rows they carried
        self._buckets = sorted(int(b) for b in buckets)
        self._bucket_batches = {
            b: self.registry.counter("serve.bucket_batches", bucket=str(b))
            for b in self._buckets
        }
        self._bucket_rows = {
            b: self.registry.counter("serve.bucket_rows", bucket=str(b))
            for b in self._buckets
        }
        self._lock = threading.Lock()
        self._lat = collections.deque(maxlen=latency_window)

    def inc(self, name: str, n: int = 1) -> None:
        self._counts[name].inc(n)
        if self.slo is not None:
            if name == "ok":
                with self._lock:
                    self._slo_out.append((self._clock(), n, 0))
            elif name in _SLO_ERROR_COUNTERS:
                with self._lock:
                    self._slo_out.append((self._clock(), 0, n))

    def observe_batch(self, bucket: int, rows: int) -> None:
        bucket = int(bucket)
        if bucket not in self._bucket_batches:
            # late-registered bucket (direct-path chunking can exceed the
            # configured set); get-or-create keeps the accounting complete
            self._bucket_batches[bucket] = self.registry.counter(
                "serve.bucket_batches", bucket=str(bucket))
            self._bucket_rows[bucket] = self.registry.counter(
                "serve.bucket_rows", bucket=str(bucket))
        self._counts["batches"].inc()
        self._bucket_batches[bucket].inc()
        self._bucket_rows[bucket].inc(rows)

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(float(seconds))
            if self.slo is not None:
                self._slo_lat.append((self._clock(), float(seconds)))

    # ---------------------------------------------------------------- SLO
    def _prune_slo(self, now: float) -> None:
        """Drop window entries older than window_s (caller holds _lock)."""
        cutoff = now - self.slo.window_s
        while self._slo_lat and self._slo_lat[0][0] < cutoff:
            self._slo_lat.popleft()
        while self._slo_out and self._slo_out[0][0] < cutoff:
            self._slo_out.popleft()

    def slo_status(self) -> Optional[dict]:
        """Burn rates over the current window (None when no SLO is set).

        Computed at scrape time from the windowed completions; also
        refreshes the serve.slo_* registry gauges so /metrics and merged
        registry snapshots carry the same numbers."""
        if self.slo is None:
            return None
        s = self.slo
        with self._lock:
            self._prune_slo(self._clock())
            lats = [v for _, v in self._slo_lat]
            ok = sum(o for _, o, _ in self._slo_out)
            err = sum(e for _, _, e in self._slo_out)
        target_s = s.p99_ms / 1e3
        slow = sum(1 for v in lats if v > target_s)
        slow_frac = (slow / len(lats)) if lats else 0.0
        latency_burn = slow_frac / s.latency_budget
        total = ok + err
        err_rate = (err / total) if total else 0.0
        error_burn = err_rate / s.error_budget
        burning = latency_burn >= 1.0 or error_burn >= 1.0
        self.registry.gauge("serve.slo_latency_burn").set(latency_burn)
        self.registry.gauge("serve.slo_error_burn").set(error_burn)
        self.registry.gauge("serve.slo_burning").set(1.0 if burning else 0.0)
        self.registry.gauge("serve.slo_window_requests").set(float(total))
        return {
            "p99_target_ms": s.p99_ms,
            "error_budget": s.error_budget,
            "window_s": s.window_s,
            "window_requests": total,
            "window_latencies": len(lats),
            "slow_frac": slow_frac,
            "error_rate": err_rate,
            "latency_burn": latency_burn,
            "error_burn": error_burn,
            "burning": burning,
        }

    # ------------------------------------------------------------- export
    @staticmethod
    def _percentile(sorted_lat, frac: float) -> Optional[float]:
        if not sorted_lat:
            return None
        idx = min(len(sorted_lat) - 1, int(frac * len(sorted_lat)))
        return sorted_lat[idx]

    def snapshot(self) -> dict:
        """One consistent JSON-able view of every counter and derived stat
        (the JAX package's schema).

        All counter values come from ONE registry.snapshot() call — a
        single acquisition of the shared registry lock — instead of a
        per-metric .value loop: N reacquisitions would cost N lock
        round-trips under scrape load AND let a concurrent batch be
        half-visible between two reads (ok incremented, its bucket row
        counts not yet), which breaks the occupancy arithmetic below."""
        reg = self.registry.snapshot()
        counts = {k: 0 for k in _COUNTERS}
        batches: Dict[int, int] = {b: 0 for b in self._bucket_batches}
        rows: Dict[int, int] = {b: 0 for b in self._bucket_rows}
        for e in reg["metrics"]:
            if e["type"] != "counter":
                continue
            if e["name"] == "serve.bucket_batches":
                batches[int(e["labels"]["bucket"])] = e["value"]
            elif e["name"] == "serve.bucket_rows":
                rows[int(e["labels"]["bucket"])] = e["value"]
            elif e["name"].startswith("serve."):
                key = e["name"][len("serve."):]
                if key in counts:
                    counts[key] = e["value"]
        with self._lock:
            lat = sorted(self._lat)
        total_rows = sum(rows.values())
        total_batches = sum(batches.values())
        occupancy = {
            str(b): {
                "batches": batches[b],
                "rows": rows[b],
                # mean real rows per flushed batch of this bucket size
                "mean_rows": (rows[b] / batches[b]) if batches[b] else 0.0,
            }
            for b in sorted(batches)
        }
        snap = {
            **counts,
            "batch_occupancy": occupancy,
            "mean_batch_rows": (total_rows / total_batches) if total_batches else 0.0,
            "latency_s": {
                "count": len(lat),
                "p50": self._percentile(lat, 0.50),
                "p95": self._percentile(lat, 0.95),
                "p99": self._percentile(lat, 0.99),
                "max": lat[-1] if lat else None,
            },
        }
        slo = self.slo_status()
        if slo is not None:
            snap["slo"] = slo
        return snap

    def registry_snapshot(self) -> dict:
        """The mergeable obs.registry view of the same counters (for
        cross-worker aggregation / trace embedding)."""
        return self.registry.snapshot()

    def render_text(self, prefix: str = "tpusvm_serve", labels: str = "") -> str:
        """Plaintext /metrics-style dump (one `name{labels} value` per line)."""
        snap = self.snapshot()
        lab = f"{{{labels}}}" if labels else ""
        lines = [f"{prefix}_{k}_total{lab} {snap[k]}" for k in _COUNTERS]
        lines.append(
            f"{prefix}_mean_batch_rows{lab} {snap['mean_batch_rows']:.4f}"
        )
        for b, occ in snap["batch_occupancy"].items():
            sep = "," if labels else ""
            blab = f"{{{labels}{sep}bucket=\"{b}\"}}"
            lines.append(f"{prefix}_batches{blab} {occ['batches']}")
            lines.append(f"{prefix}_batch_rows{blab} {occ['rows']}")
        for p in ("p50", "p95", "p99"):
            v = snap["latency_s"][p]
            if v is not None:
                sep = "," if labels else ""
                qlab = f"{{{labels}{sep}quantile=\"{p[1:]}\"}}"
                lines.append(f"{prefix}_latency_seconds{qlab} {v:.6f}")
        slo = snap.get("slo")
        if slo is not None:
            for k in ("latency_burn", "error_burn"):
                lines.append(f"{prefix}_slo_{k}{lab} {slo[k]:.6f}")
            lines.append(
                f"{prefix}_slo_burning{lab} {1 if slo['burning'] else 0}"
            )
        return "\n".join(lines) + "\n"
