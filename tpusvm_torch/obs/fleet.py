"""Fleet metrics aggregation: one merged view over many processes.

The port's copy of tpusvm/obs/fleet.py, byte-compatible with it, so a
collector of either package reads a port replica, a port router or a
port autopilot's drop, and renders the same strings:

  * each process exports ONE payload (`snapshot_payload`):
    ``{"v": 1, "role": ..., "instance": ..., "pid": ..., "status": {...},
    "snapshot": <registry snapshot>}``, over HTTP (`/metrics.json` on
    serve replicas and the router) or as an on-disk drop for a process
    with no listener (the autopilot; `write_snapshot_file`, staged and
    fsync_replace'd so a reader never sees a torn file);
  * `merge_fleet` tags every metric entry with (role, instance) labels
    and folds the payloads with `merge_snapshots`: the merged page IS the
    sum of the per-process pages, exactly (the `fleet-metrics` gate);
  * `FleetCollector` owns the scrape loop (injectable fetch and clock; an
    owned background thread, daemon=True, that stop() joins), derives
    per-process rates from counter deltas between scrapes, and feeds the
    renderers: `render_fleet_text` (one fleet-wide Prometheus page),
    `fleet_json`, and `format_top` (the `top` table).
"""

from __future__ import annotations

import json
import os
import threading
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpusvm_torch.obs.registry import (SNAPSHOT_VERSION, merge_snapshots,
                                       render_snapshot_text)

FLEET_SCHEMA_VERSION = 1

#: counters whose per-scrape delta defines a process's qps in `top`
RATE_COUNTERS = ("serve.ok", "router.requests", "pod.worker_requests")


# --------------------------------------------------------------- payloads
def snapshot_payload(role: str, instance: str, snapshot: dict,
                     status: Optional[dict] = None,
                     pid: Optional[int] = None) -> dict:
    """The one-process export every fleet source speaks."""
    if snapshot.get("v") != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported metrics snapshot version {snapshot.get('v')!r}")
    return {"v": FLEET_SCHEMA_VERSION, "role": role, "instance": instance,
            "pid": os.getpid() if pid is None else int(pid),
            "status": status or {}, "snapshot": snapshot}


def parse_payload(obj: Any) -> dict:
    """Validate a fleet payload read off the wire or disk; ValueError on
    junk or an unknown schema version."""
    if not isinstance(obj, dict) or obj.get("v") != FLEET_SCHEMA_VERSION:
        v = obj.get("v") if isinstance(obj, dict) else None
        raise ValueError(
            f"not a fleet snapshot payload (v={v!r}, this build reads "
            f"v{FLEET_SCHEMA_VERSION})")
    for k in ("role", "instance", "snapshot"):
        if k not in obj:
            raise ValueError(f"fleet payload missing {k!r}")
    return obj


def tag_snapshot(snap: dict, **labels: str) -> dict:
    """A copy of a registry snapshot with `labels` merged into every
    entry's label set. Fleet labels (role/instance) take precedence over
    same-named process-local labels: the collector's identity assignment
    must win, or two processes could alias one series."""
    out = []
    for e in snap["metrics"]:
        out.append({**e, "labels": {**e["labels"],
                                    **{k: str(v) for k, v in labels.items()}}})
    return {"v": snap["v"], "metrics": out}


def merge_fleet(payloads) -> dict:
    """Fold per-process payloads into ONE registry snapshot, every entry
    tagged with its origin (role, instance). Being a `merge_snapshots`
    fold over label-disjoint entries, the merged page equals the union of
    the per-process pages exactly, counter totals included."""
    tagged = [tag_snapshot(p["snapshot"], role=p["role"],
                           instance=p["instance"]) for p in payloads]
    if not tagged:
        return {"v": SNAPSHOT_VERSION, "metrics": []}
    return merge_snapshots(*tagged)


# ---------------------------------------------------------- on-disk drops
def write_snapshot_file(path: str, payload: dict) -> None:
    """Publish a payload for a process with no HTTP listener (the
    autopilot): a staged write beside the target and fsync_replace, so a
    reader never sees a torn file and a crash mid-write leaves the
    previous drop."""
    from tpusvm_torch.utils.durable import fsync_replace

    parse_payload(payload)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload, sort_keys=True))
        f.flush()
    fsync_replace(tmp, path)


def read_snapshot_file(path: str) -> dict:
    with open(path) as f:
        return parse_payload(json.load(f))


# -------------------------------------------------------------- transport
def http_fetch_json(url: str, timeout_s: float = 2.0) -> Any:
    """GET a JSON document (the collector's default fetch; injectable)."""
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


class FleetView:
    """One scrape's outcome: per-process payloads, per-source errors, and
    the merged fleet snapshot."""

    def __init__(self, processes: List[dict], errors: Dict[str, str],
                 merged: dict, scraped_at: float):
        self.processes = processes
        self.errors = errors
        self.merged = merged
        self.scraped_at = scraped_at


class FleetCollector:
    """Scrapes fleet sources into one merged view.

    Sources (added once, scraped every pass):
      * `add_replica(url)`: GET <url>/metrics.json (a serve replica, or any
        process exporting a fleet payload over HTTP);
      * `add_router(url)`: GET <url>/fleet/metrics.json and adopt the
        router's already-collected process list;
      * `add_file(path)`: read an on-disk drop (the autopilot);
      * `add_callable(fn)`: fn() -> payload or a list of them (the
        router's own payload, and the test seam).

    `scrape_once()` is the synchronous surface. `start()` runs it on an
    owned background thread (`top`'s refresher): daemon=True, and stop()
    joins it. fetch and clock are injectable, so the renderers and the
    rate arithmetic are deterministic under test.
    """

    def __init__(self, fetch: Callable[..., Any] = http_fetch_json,
                 clock: Optional[Callable[[], float]] = None,
                 timeout_s: float = 2.0):
        import time

        self._fetch = fetch
        self._clock = clock or time.monotonic
        self.timeout_s = timeout_s
        self._sources: List[Tuple[str, str, Any]] = []
        self._lock = threading.Lock()
        self._view: Optional[FleetView] = None
        # (role, instance) -> {counter: (total, t)} from the previous
        # scrape; written under _lock with _rates (rates() reads there)
        self._prev: Dict[Tuple[str, str], Dict[str, Tuple[float, float]]] = {}
        self._rates: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ sources
    def add_replica(self, url: str) -> "FleetCollector":
        self._sources.append(("replica", url.rstrip("/"), None))
        return self

    def add_router(self, url: str) -> "FleetCollector":
        self._sources.append(("router", url.rstrip("/"), None))
        return self

    def add_file(self, path: str) -> "FleetCollector":
        self._sources.append(("file", path, None))
        return self

    def add_callable(self, fn: Callable[[], Any],
                     name: str = "callable") -> "FleetCollector":
        self._sources.append(("call", name, fn))
        return self

    # ------------------------------------------------------------- scrape
    def _scrape_source(self, kind: str, name: str, spec: Any) -> List[dict]:
        if kind == "replica":
            return [parse_payload(self._fetch(name + "/metrics.json",
                                              timeout_s=self.timeout_s))]
        if kind == "router":
            doc = self._fetch(name + "/fleet/metrics.json",
                              timeout_s=self.timeout_s)
            if not isinstance(doc, dict) or not isinstance(
                    doc.get("processes"), list):
                raise ValueError(f"{name}: not a fleet page: {doc!r}")
            return [parse_payload(p) for p in doc["processes"]]
        if kind == "file":
            return [read_snapshot_file(name)]
        out = spec()
        if isinstance(out, list):
            return [parse_payload(p) for p in out]
        return [parse_payload(out)]

    def _update_rates(self, processes: List[dict], now: float) -> None:
        nxt: Dict[Tuple[str, str], Dict[str, Tuple[float, float]]] = {}
        rates: Dict[Tuple[str, str], Dict[str, float]] = {}
        # held across read, compute and publish: two concurrent scrapes
        # must not both compute from one _prev and both publish
        with self._lock:
            for p in processes:
                key = (p["role"], p["instance"])
                totals = {
                    e["name"]: float(e["value"])
                    for e in p["snapshot"]["metrics"]
                    if e["type"] == "counter" and e["name"] in RATE_COUNTERS
                }
                nxt[key] = {k: (v, now) for k, v in totals.items()}
                prev = self._prev.get(key, {})
                r: Dict[str, float] = {}
                for k, v in totals.items():
                    if k in prev:
                        pv, pt = prev[k]
                        dt = now - pt
                        if dt > 0 and v >= pv:
                            r[k] = (v - pv) / dt
                if r:
                    # qps = the sum of this process's request-counter rates
                    rates[key] = {"qps": sum(r.values()), **r}
            self._prev = nxt
            self._rates = rates

    def scrape_once(self) -> FleetView:
        """One pass over every source; a source's failure is a row of
        `errors`, not a collector crash."""
        processes: List[dict] = []
        errors: Dict[str, str] = {}
        for kind, name, spec in self._sources:
            try:
                processes.extend(self._scrape_source(kind, name, spec))
            except Exception as e:  # noqa: BLE001 — a dead source is a
                # fleet observation, not a scrape failure
                errors[name] = f"{type(e).__name__}: {e}"
        now = self._clock()
        self._update_rates(processes, now)
        view = FleetView(processes, errors, merge_fleet(processes), now)
        with self._lock:
            self._view = view
        return view

    def view(self) -> Optional[FleetView]:
        """The last scrape's view (immutable after publication)."""
        with self._lock:
            return self._view

    def rates(self) -> Dict[Tuple[str, str], Dict[str, float]]:
        """Per-(role, instance) counter rates from the last two scrapes;
        empty until a second scrape has produced deltas."""
        with self._lock:
            return dict(self._rates)

    # ------------------------------------------------------------- thread
    def start(self, interval_s: float = 2.0) -> "FleetCollector":
        """Begin background refreshing (the `top` loop)."""
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if self._thread is not None:
            raise RuntimeError("fleet collector already started")
        self.scrape_once()  # a first view before the caller renders

        def run():
            while not self._stop.wait(interval_s):
                try:
                    self.scrape_once()
                except Exception:  # noqa: BLE001 — keep scraping; the
                    # per-source errors dict is the reporting channel
                    pass

        # tpusvm: guarded-by=owner-only lifecycle; start/stop run on the owning thread, the scrape thread never touches _thread
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="tpusvm-torch-fleet-collector")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            # tpusvm: guarded-by=owner-only lifecycle; cleared after the joined thread exited
            self._thread = None

    def __enter__(self) -> "FleetCollector":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


# -------------------------------------------------------------- renderers
def render_fleet_text(view: FleetView, prefix: str = "tpusvm") -> str:
    """One fleet-wide Prometheus page: the merged snapshot rendered by the
    registry's renderer, headed by provenance comments."""
    head = [f"# fleet: {len(view.processes)} process(es), "
            f"{len(view.errors)} error(s)"]
    head += [f"# fleet error: {name}: {err}"
             for name, err in sorted(view.errors.items())]
    return "\n".join(head) + "\n" + render_snapshot_text(
        view.merged, prefix=prefix)


def fleet_json(view: FleetView) -> dict:
    """The /fleet/metrics.json document: per-process payloads + merged."""
    return {"v": FLEET_SCHEMA_VERSION, "processes": view.processes,
            "errors": view.errors, "merged": view.merged}


def _counter_total(snap: dict, name: str) -> Optional[float]:
    vals = [e["value"] for e in snap["metrics"]
            if e["type"] == "counter" and e["name"] == name]
    return float(sum(vals)) if vals else None


def _gauge_value(snap: dict, name: str) -> Optional[float]:
    vals = [e["value"] for e in snap["metrics"]
            if e["type"] == "gauge" and e["name"] == name]
    return max(float(v) for v in vals) if vals else None


def top_rows(view: FleetView,
             rates: Optional[Dict[Tuple[str, str], Dict[str, float]]] = None
             ) -> List[dict]:
    """One row per process for the `top` table, sorted (role, instance).

    Role-specific columns come from each payload's status block (serve:
    per-model generation/breaker/p99/burn summarized to the worst model;
    pod workers: the live_shards gauge); absent facts render as "-"."""
    rates = rates or {}
    rows = []
    for p in view.processes:
        status = p.get("status") or {}
        models = status.get("models") or {}
        gens = [m.get("generation") for m in models.values()
                if isinstance(m, dict) and m.get("generation") is not None]
        breakers = [m.get("breaker") for m in models.values()
                    if isinstance(m, dict) and m.get("breaker")]
        p99s = [m.get("p99_s") for m in models.values()
                if isinstance(m, dict) and m.get("p99_s") is not None]
        burning = any(m.get("burning") for m in models.values()
                      if isinstance(m, dict))
        worst_breaker = None
        for state in ("open", "half-open", "closed"):
            if state in breakers:
                worst_breaker = state
                break
        key = (p["role"], p["instance"])
        rows.append({
            "role": p["role"],
            "instance": p["instance"],
            "pid": p.get("pid"),
            "generation": max(gens) if gens else status.get("generation"),
            "qps": (rates.get(key) or {}).get("qps"),
            "p99_s": max(p99s) if p99s else None,
            "burn": burning if models else status.get("burning"),
            "breaker": worst_breaker or status.get("breaker"),
            "live_shards": _gauge_value(p["snapshot"], "pod.live_shards"),
            "requests": _counter_total(
                p["snapshot"], {"serve": "serve.ok",
                                "router": "router.requests",
                                "pod-worker": "pod.worker_requests"
                                }.get(p["role"], "")),
        })
    rows.sort(key=lambda r: (r["role"], str(r["instance"])))
    return rows


_TOP_COLUMNS = ("ROLE", "INSTANCE", "PID", "GEN", "REQS", "QPS",
                "P99MS", "BURN", "BREAKER", "SHARDS")


def _top_cell(row: dict, col: str) -> str:
    if col == "ROLE":
        return row["role"]
    if col == "INSTANCE":
        return str(row["instance"])
    if col == "PID":
        return "-" if row["pid"] is None else str(row["pid"])
    if col == "GEN":
        return "-" if row["generation"] is None else str(row["generation"])
    if col == "REQS":
        return "-" if row["requests"] is None else f"{row['requests']:.0f}"
    if col == "QPS":
        return "-" if row["qps"] is None else f"{row['qps']:.1f}"
    if col == "P99MS":
        return ("-" if row["p99_s"] is None
                else f"{row['p99_s'] * 1e3:.1f}")
    if col == "BURN":
        return "-" if row["burn"] is None else ("yes" if row["burn"] else "no")
    if col == "BREAKER":
        return row["breaker"] or "-"
    if col == "SHARDS":
        return ("-" if row["live_shards"] is None
                else f"{row['live_shards']:.0f}")
    raise KeyError(col)


def format_top(rows: List[dict], errors: Optional[Dict[str, str]] = None,
               clock_s: Optional[float] = None) -> str:
    """Render the fleet table (a pure function of its inputs)."""
    grid = [list(_TOP_COLUMNS)]
    grid += [[_top_cell(r, c) for c in _TOP_COLUMNS] for r in rows]
    widths = [max(len(row[i]) for row in grid)
              for i in range(len(_TOP_COLUMNS))]
    lines = []
    if clock_s is not None:
        lines.append(f"tpusvm fleet — {len(rows)} process(es) — "
                     f"t={clock_s:.1f}s")
    lines += ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
              for row in grid]
    for name, err in sorted((errors or {}).items()):
        lines.append(f"! {name}: {err}")
    return "\n".join(lines) + "\n"
