"""Process-wide metrics registry: counters, gauges, bucketed histograms.

The port's copy of tpusvm/obs/registry.py (pure Python; the port imports
nothing of the JAX package). A metric is a (name, labels) pair owned by a
MetricsRegistry; a SNAPSHOT is a JSON-able dict that merges exactly
across processes:

  * counters add (integers: associative, commutative, exact);
  * gauges combine by max (the high-water marks the stream reader's live
    shards and a queue's depth want);
  * histograms add per-bucket counts, sum and count (identical bounds
    required; mismatched bounds raise ValueError).

One lock per registry keeps a snapshot consistent. The fault points
(faults/injection.py) and the retry primitive (faults/retry.py) count
their hits here, and the stream reader its loads and stalls.

Renderers: `snapshot()` (schema-versioned dict), `render_text()`
(Prometheus-style `name{labels} value` lines).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

SNAPSHOT_VERSION = 1

# default histogram bounds: latency-ish log scale; callers with real
# domains (batch sizes, shard counts) pass their own
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic integer counter. Merge rule: add."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._v

    def read_locked(self) -> int:
        """Raw value. CALLER holds the shared registry lock — the
        snapshot path acquires it exactly once for all metrics (the
        lock is shared and non-reentrant, so reacquiring per metric
        would deadlock; reading without it would tear)."""
        return self._v


class Gauge:
    """Last-set value with a high-water mark. Merge rule: max.

    `set` tracks the running maximum too, so snapshot merges (which must
    be order-free) expose the high-water mark — the semantics every
    current gauge (queue depth, live shards) wants across workers."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def set_max(self, v: float) -> None:
        with self._lock:
            self._v = max(self._v, float(v))

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def read_locked(self) -> float:
        """Raw value; caller holds the shared registry lock (see
        Counter.read_locked)."""
        return self._v


class Histogram:
    """Bucketed histogram with fixed ascending bounds (+inf implicit).

    Merge rule: elementwise add of counts/sum/count — exact, provided
    both sides share the same bounds."""

    def __init__(self, lock: threading.Lock, bounds: Sequence[float]):
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(set(b)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"ascending, got {bounds}")
        self._lock = lock
        self.bounds = b
        self._counts = [0] * (len(b) + 1)  # last = +inf overflow
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def read_locked(self) -> dict:
        """(bounds, counts, sum, count) copies; caller holds the shared
        registry lock (see Counter.read_locked) — one acquisition covers
        the whole histogram, so counts/sum/count are mutually consistent
        even when the snapshot races a writer."""
        return {"bounds": list(self.bounds), "counts": list(self._counts),
                "sum": self._sum, "count": self._n}


class MetricsRegistry:
    """Get-or-create home for every metric of one process/worker."""

    def __init__(self):
        self._lock = threading.Lock()
        # keyed by (name, labels) ALONE so one name cannot be two metric
        # types — a vocabulary clash is a bug worth a loud TypeError, not
        # two silently-coexisting series
        self._metrics: Dict[Tuple[str, _LabelKey], Tuple[str, object]] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str], make):
        key = (name, _label_key(labels))
        with self._lock:
            entry = self._metrics.get(key)
            if entry is None:
                entry = self._metrics[key] = (kind, make())
            elif entry[0] != kind:
                raise TypeError(
                    f"metric {name!r} is already registered as a "
                    f"{entry[0]}, requested {kind}"
                )
            return entry[1]

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", name, labels,
                         lambda: Counter(self._lock))

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", name, labels, lambda: Gauge(self._lock))

    def histogram(self, name: str, bounds: Sequence[float] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        m = self._get("histogram", name, labels,
                      lambda: Histogram(self._lock, bounds))
        if m.bounds != tuple(float(x) for x in bounds):
            raise ValueError(
                f"histogram {name!r} already registered with bounds "
                f"{m.bounds}, requested {tuple(bounds)}"
            )
        return m

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """One consistent, JSON-able, MERGEABLE view of every metric.

        The shared registry lock is taken EXACTLY ONCE for the whole
        snapshot (every metric wrapper holds the same lock, so a
        per-metric value() loop would deadlock on the non-reentrant
        lock — and releasing between metrics would let a scrape observe
        metric A after a compound update and metric B before it). The
        wrappers' read_locked() accessors make that contract explicit."""
        out: List[dict] = []
        with self._lock:
            items = sorted(self._metrics.items())
            for (name, lkey), (kind, m) in items:
                entry = {"name": name, "type": kind, "labels": dict(lkey)}
                if kind in ("counter", "gauge"):
                    entry["value"] = m.read_locked()
                else:
                    entry.update(m.read_locked())
                out.append(entry)
        return {"v": SNAPSHOT_VERSION, "metrics": out}

    def render_text(self, prefix: str = "tpusvm") -> str:
        return render_snapshot_text(self.snapshot(), prefix=prefix)


def _entry_key(e: dict) -> Tuple[str, str, _LabelKey]:
    return (e["type"], e["name"], _label_key(e["labels"]))


def merge_snapshots(*snaps: dict) -> dict:
    """Exact, associative, commutative merge of registry snapshots.

    merge(a, b) == merge(b, a) on every metric type, and
    merge(merge(a, b), c) == merge(a, merge(b, c)) — the property that
    lets fold-parallel workers and cascade leaves emit independently and
    be combined in any order."""
    merged: Dict[Tuple[str, str, _LabelKey], dict] = {}
    for snap in snaps:
        if snap.get("v") != SNAPSHOT_VERSION:
            raise ValueError(
                f"unsupported metrics snapshot version {snap.get('v')!r} "
                f"(this build reads v{SNAPSHOT_VERSION})"
            )
        for e in snap["metrics"]:
            key = _entry_key(e)
            cur = merged.get(key)
            if cur is None:
                merged[key] = {**e, "labels": dict(e["labels"])}
                continue
            if e["type"] == "counter":
                cur["value"] += e["value"]
            elif e["type"] == "gauge":
                cur["value"] = max(cur["value"], e["value"])
            else:
                if cur["bounds"] != e["bounds"]:
                    raise ValueError(
                        f"cannot merge histogram {e['name']!r}: bounds "
                        f"{cur['bounds']} != {e['bounds']}"
                    )
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], e["counts"])]
                cur["sum"] += e["sum"]
                cur["count"] += e["count"]
    return {"v": SNAPSHOT_VERSION,
            "metrics": [merged[k] for k in sorted(merged)]}


def escape_label_value(v: str) -> str:
    """Escape a label value per the Prometheus exposition format:
    backslash, double-quote and newline must be backslash-escaped
    (https://prometheus.io/docs/instrumenting/exposition_formats/).
    Backslash first — escaping it last would re-escape the others."""
    return (str(v).replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_snapshot_text(snap: dict, prefix: str = "tpusvm") -> str:
    """Prometheus-style text rendering of a (possibly merged) snapshot."""
    lines: List[str] = []
    for e in snap["metrics"]:
        name = f"{prefix}_{e['name'].replace('.', '_')}"
        lab = _fmt_labels(e["labels"])
        if e["type"] == "counter":
            lines.append(f"{name}_total{lab} {e['value']}")
        elif e["type"] == "gauge":
            lines.append(f"{name}{lab} {e['value']:g}")
        else:
            cum = 0
            for bound, c in zip(list(e["bounds"]) + ["+Inf"],
                                e["counts"]):
                cum += c
                sep = "," if e["labels"] else ""
                blab = _fmt_labels(e["labels"])[:-1] if e["labels"] else "{"
                lines.append(f'{name}_bucket{blab}{sep}le="{bound}"}} {cum}')
            lines.append(f"{name}_sum{lab} {e['sum']:g}")
            lines.append(f"{name}_count{lab} {e['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------- default
_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry shared by subsystems that have no
    natural owner object (the fault points, the stream reader's prefetch
    counters)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def reset_default_registry() -> None:
    """Testing hook: drop the process-wide registry."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
