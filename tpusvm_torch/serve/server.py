"""The serving frontend: Server.submit()/submit_many() over named models.

The port of tpusvm/serve/server.py. One Server hosts any number of models
on one device (the card unless device="cpu" is asked for); each model
gets its own pinned ModelEntry (registry.py), bucket program cache with
one CUDA graph per bucket (buckets.py), metrics (metrics.py), circuit
breaker (faults/breaker.py) and micro-batcher worker (batcher.py), so a
slow model cannot head-of-line-block another.

Lifecycle: load/add -> warmup() -> submit()/submit_many() -> close().
warmup() captures every (model, bucket) graph so steady state builds
nothing (the `recompiles` count proves it); skipping it is legal, but the
first request to each bucket then pays the capture and counts it.

predict_direct() is the sequential one-request-at-a-time path: the same
bucket programs with no queue or coalescing, the throughput baseline
(sequential_qps) and the bit-identity oracle in tests.

Atomic hot-swap: a worker's servable state is one immutable `_Generation`
bundle (entry + program cache + generation number), and `Server.swap()`
stages its replacement FULLY off to the side (artifact load, retried and
classified; pinning on the device; every bucket captured; the pinned probe
rows scored through the new graphs) before flipping the worker's bundle
reference under the server lock. A batch reads its bundle exactly once, so
in-flight work finishes on the old generation and no request ever sees a
torn entry/cache pair; the old generation's graphs are released when its
last batch drops them. A failed stage changes NOTHING: the old generation
keeps serving, the failure shows on /healthz (`degraded`) and in the
swap_failures counter. Breaker state, SLO windows and every metric
survive the flip: only the bundle moves.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusvm_torch import faults
from tpusvm_torch.config import resolve_dtype
from tpusvm_torch.device import resolve_device
from tpusvm_torch.serve.batcher import MicroBatcher, ServeResult
from tpusvm_torch.serve.buckets import CompileCache, default_buckets
from tpusvm_torch.serve.metrics import Metrics
from tpusvm_torch.serve.registry import ModelEntry, ModelRegistry


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Per-server serving knobs (shared by every hosted model)."""

    max_batch: int = 64          # coalescing cap = largest bucket
    max_delay_ms: float = 2.0    # max added latency waiting for co-riders
    queue_size: int = 1024       # backpressure bound (fast-fail when full)
    timeout_ms: float = 1000.0   # default per-request deadline
    buckets: Optional[Tuple[int, ...]] = None  # default: powers of two
    block: int = 2048            # the scorer's block (solver/predict.py)
    # load shedding: requests arriving while the queue holds >= this
    # fraction of queue_size come back OVERLOADED instead of queueing;
    # None = off (the hard QUEUE_FULL bound alone)
    shed_threshold: Optional[float] = None
    # transient-scoring-fault retry budget (TransientIOError only; a real
    # scoring exception is not retried, it feeds the breaker)
    score_retries: int = 3
    # circuit breaker: consecutive failed BATCHES that trip it, and the
    # open-state cooldown before a half-open probe is admitted
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 30.0
    # serving SLOs: a latency target activates per-model budget tracking
    # (burn-rate gauges on /metrics, "degraded" on /healthz while a budget
    # burns); None = no SLO
    slo_p99_ms: Optional[float] = None
    slo_error_budget: float = 0.001   # allowed windowed error fraction
    slo_window_s: float = 60.0        # sliding evaluation window
    # admission control fed by the burn gauges: True sheds new requests
    # (OVERLOADED, retryable) while the latency budget burns
    slo_shed: bool = False

    def resolved_slo(self):
        """SLOConfig when a latency target is set, else None."""
        if self.slo_p99_ms is None:
            if self.slo_shed:
                raise ValueError(
                    "slo_shed=True needs an SLO to consult; set slo_p99_ms"
                )
            return None
        from tpusvm_torch.serve.metrics import SLOConfig

        return SLOConfig(p99_ms=self.slo_p99_ms,
                         error_budget=self.slo_error_budget,
                         window_s=self.slo_window_s).validate()

    def resolved_buckets(self) -> Tuple[int, ...]:
        if self.buckets is not None:
            b = tuple(sorted(int(x) for x in self.buckets))
            if not b or b[-1] < self.max_batch:
                raise ValueError(
                    f"buckets {b} do not cover max_batch={self.max_batch}"
                )
            return b
        return default_buckets(self.max_batch)

    def resolved_shed_at(self) -> Optional[int]:
        if self.shed_threshold is None:
            return None
        if not (0.0 < self.shed_threshold <= 1.0):
            raise ValueError(
                f"shed_threshold must be in (0, 1], got "
                f"{self.shed_threshold}"
            )
        return max(1, int(self.shed_threshold * self.queue_size))


class _Generation:
    """One immutable servable bundle: the unit the hot-swap flips.

    A scoring path reads the worker's `_gen` reference ONCE and uses this
    bundle throughout: entry and program cache can never be observed from
    different generations. The reference store is a single pointer write
    performed under the server lock."""

    __slots__ = ("entry", "cache", "generation", "loaded_t",
                 "probe_scores", "__weakref__")

    def __init__(self, entry: ModelEntry, cache: CompileCache,
                 generation: int, loaded_t: float, probe_scores=None):
        self.entry = entry
        self.cache = cache
        self.generation = generation
        self.loaded_t = loaded_t
        self.probe_scores = probe_scores


class SwapError(Exception):
    """A hot-swap stage failed and was rolled back; the previous
    generation keeps serving. Wraps the staging failure (load error,
    capture failure, probe mismatch) with the model name."""

    def __init__(self, name: str, cause: BaseException):
        self.name = name
        self.cause = cause
        super().__init__(
            f"swap of model {name!r} failed and was rolled back: "
            f"{type(cause).__name__}: {cause}"
        )


# torch.cuda.Stream() hands out streams from a fixed pool (32 a priority a
# device), so past 32 hosted models two workers share one CUDA stream: a
# capture on it would record, or refuse, the other worker's replays. One
# lock a CUDA stream keeps every capture, replay and copy on a stream
# serialized, whichever workers share it.
_STREAM_LOCKS: Dict[int, threading.RLock] = {}
_STREAM_LOCKS_GUARD = threading.Lock()


def _stream_lock(stream) -> threading.RLock:
    if stream is None:
        return threading.RLock()
    with _STREAM_LOCKS_GUARD:
        return _STREAM_LOCKS.setdefault(stream.cuda_stream, threading.RLock())


class _ModelWorker:
    """Metrics + batcher + breaker for one hosted model, serving the
    current `_Generation` bundle (entry + program cache)."""

    def __init__(self, entry: ModelEntry, config: ServeConfig,
                 clock=None):
        buckets = config.resolved_buckets()
        self.config = config
        self._clock = clock or time.monotonic
        self.metrics = Metrics(buckets, slo=config.resolved_slo(),
                               clock=clock)
        # one batch at a time through a generation's static buffers, and
        # every capture, replay and copy of every generation on one stream
        # under this lock (buckets.py): the batcher thread, predict_direct
        # and a stage take turns. Reentrant: a post-warm-up capture runs
        # inside a batch.
        self._stream = (torch.cuda.Stream(device=entry.device)
                        if entry.device.type == "cuda" else None)
        self._exec_lock = _stream_lock(self._stream)
        cache = self._cache(entry)
        self._gen = _Generation(entry, cache, entry.generation,
                                self._clock())
        # last swap attempt's outcome (None until the first swap):
        # {"outcome": "ok"|"failed", "generation": int, "error": str?};
        # one dict reference, replaced whole under the server lock
        self._last_swap: Optional[dict] = None
        self.breaker = faults.CircuitBreaker(
            threshold=config.breaker_threshold,
            cooldown_s=config.breaker_cooldown_s,
            name=entry.name,
            listener=self._on_breaker,
            **({"clock": clock} if clock is not None else {}),
        )
        self._retry = faults.Retry(
            faults.RetryPolicy(max_attempts=config.score_retries + 1,
                               retryable=(faults.TransientIOError,)),
            op="serve.score",
            on_retry=lambda: self.metrics.inc("retries"),
        )
        self.batcher = MicroBatcher(
            self._run_batch,
            max_batch=config.max_batch,
            max_delay_s=config.max_delay_ms / 1e3,
            queue_size=config.queue_size,
            timeout_s=config.timeout_ms / 1e3,
            metrics=self.metrics,
            shed_at=config.resolved_shed_at(),
            admission=(self._slo_admission if config.slo_shed else None),
        )

    # ------------------------------------------------------- generations
    def _cache(self, entry: ModelEntry) -> CompileCache:
        return CompileCache(entry, self.config.resolved_buckets(),
                            block=self.config.block,
                            registry=self.metrics.registry,
                            metrics=self.metrics, stream=self._stream,
                            lock=self._exec_lock)

    @property
    def entry(self) -> ModelEntry:
        return self._gen.entry

    @property
    def cache(self) -> CompileCache:
        return self._gen.cache

    @property
    def generation(self) -> int:
        return self._gen.generation

    def probe_rows(self, entry: Optional[ModelEntry] = None) -> np.ndarray:
        """The pinned probe rows every staged generation must score before
        it may serve. Seeded per feature width, so A->B->A swaps verify
        against the identical probe."""
        e = entry if entry is not None else self._gen.entry
        rng = np.random.default_rng(0xFEED ^ e.n_features)
        return rng.random((2, e.n_features))

    def stage(self, entry: ModelEntry) -> _Generation:
        """Build a fully warmed replacement bundle OFF TO THE SIDE.

        The entry's tensors are already pinned; this captures every
        bucket graph (bucket by bucket under the worker's lock, between
        the serving generation's batches) and scores the probe rows
        through the staged graphs: finite scores of the right shape.
        Nothing the serving path reads is touched; any failure here leaves
        the old generation serving."""
        faults.point("serve.swap", model=entry.name)
        cache = self._cache(entry)
        cache.warmup()
        probe = entry.validate_rows(self.probe_rows(entry))
        # the serving arithmetic (scale on the host, cast at the pad
        # upload), so the probe scores are the bundle's served bits
        with self._exec_lock:
            scores, _ = cache.scores(entry.scale(probe))
        want = ((probe.shape[0], len(entry.classes))
                if entry.kind == "ovr" else (probe.shape[0],))
        if scores.shape != want or not np.all(np.isfinite(scores)):
            raise SwapError(entry.name, ValueError(
                f"probe verification failed: scores shape {scores.shape} "
                f"(want {want}), finite={bool(np.all(np.isfinite(scores)))}"
            ))
        # the generation is stamped by the registry at flip time
        return _Generation(entry, cache, entry.generation, self._clock(),
                           probe_scores=scores)

    def flip(self, gen: _Generation) -> None:
        """Install a staged bundle: one reference store (the caller holds
        the server lock; in-flight batches keep their old bundle)."""
        self._gen = gen
        self._last_swap = {"outcome": "ok", "generation": gen.generation}
        self.metrics.inc("swaps")
        reg = self.metrics.registry
        reg.gauge("serve.generation").set(float(gen.generation))
        reg.gauge("serve.last_swap_ok").set(1.0)

    def retire(self, old, timeout_s: float = 10.0) -> bool:
        """Wait (up to timeout_s) for the replaced generation, a weak
        reference, to be dropped by its last in-flight batch, then hand
        its graph pool's memory back to the device (empty_cache, under the
        lock: no capture or replay is running then), so device memory
        stays flat over any number of swaps. False if a batch still held
        it at the timeout (its memory then goes back with a later swap)."""
        t0 = time.monotonic()
        while old() is not None:
            if time.monotonic() - t0 > timeout_s:
                return False
            time.sleep(0.001)
        if self._stream is not None:
            with self._exec_lock:
                torch.cuda.empty_cache()
        return True

    def record_swap_failure(self, error: BaseException) -> None:
        g = self._gen
        self._last_swap = {
            "outcome": "failed",
            "generation": g.generation,   # the generation STILL serving
            "error": f"{type(error).__name__}: {error}",
        }
        self.metrics.inc("swap_failures")
        self.metrics.registry.gauge("serve.last_swap_ok").set(0.0)

    def swap_status(self) -> dict:
        """Per-model swap/staleness view for health() and /metrics;
        staleness_s = time since the serving generation was installed."""
        g = self._gen
        staleness = max(0.0, self._clock() - g.loaded_t)
        reg = self.metrics.registry
        reg.gauge("serve.generation").set(float(g.generation))
        reg.gauge("serve.staleness_s").set(staleness)
        return {"generation": g.generation,
                "staleness_s": staleness,
                "last_swap": self._last_swap}

    def _slo_admission(self) -> bool:
        """SLO-fed admission control (config.slo_shed): refuse new work
        while the latency budget burns. Error burn does NOT shed: refusing
        traffic cannot un-fail requests."""
        st = self.metrics.slo_status()
        return st is None or st["latency_burn"] < 1.0

    def slo_status(self):
        return self.metrics.slo_status()

    def _on_breaker(self, event: str) -> None:
        if event == "tripped":
            self.metrics.inc("breaker_trips")
        elif event == "recovered":
            self.metrics.inc("breaker_recoveries")

    def _score(self, X: np.ndarray):
        """(scores, labels, [(bucket, rows), ...]) for validated f64 rows.

        Batches larger than the top bucket (only through the direct path:
        the batcher caps at max_batch) are chunked through it. The
        generation bundle is read ONCE: a swap flipping mid-batch changes
        nothing here."""
        g = self._gen
        e = g.entry
        if X.shape[0] == 0:
            shape = (0, len(e.classes)) if e.kind == "ovr" else (0,)
            empty_labels = (np.zeros(0) if e.kind == "svr"
                            else np.zeros(0, np.int32))
            return np.zeros(shape), empty_labels, []
        Xs = e.scale(X)
        top = g.cache.buckets[-1]
        parts, chunks = [], []
        with self._exec_lock:
            for i in range(0, Xs.shape[0], top):
                s, bucket = g.cache.scores(Xs[i:i + top])
                parts.append(s)
                chunks.append((bucket, s.shape[0]))
        scores = np.concatenate(parts) if len(parts) > 1 else parts[0]
        if e.kind == "binary":
            labels = np.where(scores > 0, 1, -1).astype(np.int32)
        elif e.kind == "svr":
            # regression: the score IS the prediction
            labels = scores
        else:
            labels = e.classes[np.argmax(scores, axis=1)]
        return scores, labels, chunks

    def _score_injected(self, X: np.ndarray):
        faults.point("serve.score", model=self.entry.name)
        return self._score(X)

    def _run_batch(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The batcher's scoring callback: breaker gate first (an open
        breaker fails the batch in microseconds, no device time), then
        the scoring attempt with transient-fault retries; outcomes feed
        the breaker so persistent failure trips it and a half-open probe
        recovers it. A failed replay raises here like any other scoring
        failure: nothing falls back to an eager path."""
        if not self.breaker.allow():
            raise faults.BreakerOpenError(self.entry.name)
        try:
            scores, labels, chunks = self._retry(self._score_injected, X)
        except Exception:
            # exhausted retries or a non-retryable scoring failure: one
            # consecutive-failure tick (a SimulatedKill, a BaseException,
            # bypasses this: a killed process counts nothing)
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        for bucket, rows in chunks:
            self.metrics.observe_batch(bucket, rows)
        if self._gen.entry.kind == "binary":
            # served-score sign tallies (registry counters, not snapshot()
            # keys: the snapshot schema is the JAX package's)
            pos = int(np.count_nonzero(labels > 0))
            reg = self.metrics.registry
            reg.counter("serve.scores_pos").inc(pos)
            reg.counter("serve.scores_neg").inc(len(labels) - pos)
        return scores, labels

    def drain(self, timeout_s: float = 10.0) -> bool:
        return self.batcher.drain(timeout_s)

    def close(self) -> None:
        self.batcher.close()


class Server:
    """In-process serving frontend over named SVM models on one device.

    dtype: the serving compute dtype of loaded artifacts (float32 or
    float64; an add_model estimator keeps its own). device: "cuda" (the
    default) or "cpu"; a missing card raises unless "cpu" is asked for."""

    def __init__(self, config: ServeConfig = ServeConfig(),
                 dtype=torch.float32, replica_id: Optional[str] = None,
                 device="cuda"):
        self.config = config
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the replica's identity: minted once per fresh replica, persisted
        # in serve_state.json and re-adopted by restore_state
        self.replica_id = replica_id or f"r-{uuid.uuid4().hex[:8]}"
        self._start_t = time.monotonic()
        self.registry = ModelRegistry()
        self._workers: Dict[str, _ModelWorker] = {}
        self._lock = threading.Lock()
        # serializes whole swap operations (stage + flip): staging is
        # slow (captures), so it must not hold the server lock, but two
        # concurrent swaps of one model must not interleave
        self._swap_lock = threading.Lock()
        self._closed = False
        self._draining = False
        self._httpd = None
        self._http_thread = None
        self._state_path: Optional[str] = None
        self._cache_dir: Optional[str] = None
        self._known_signatures: Optional[set] = None
        self._built_signatures: set = set()
        self._bound_address: Optional[str] = None

    # ----------------------------------------------------------- hosting
    def _install(self, entry: ModelEntry) -> ModelEntry:
        self.registry.add(entry)
        with self._lock:
            self._workers[entry.name] = _ModelWorker(entry, self.config)
        self._persist_state()
        return entry

    def load_model(self, name: str, path: str) -> ModelEntry:
        """Load a serialized .npz model (kind auto-detected) and pin it.

        A missing, corrupt or transiently unreadable artifact raises the
        classified ModelLoadError naming the path (transient I/O is
        retried first)."""
        return self._install(ModelEntry.from_path(
            name, path, dtype=self.dtype, device=self.device))

    def add_model(self, name: str, model) -> ModelEntry:
        """Host an already-fitted BinarySVC / OneVsRestSVC / EpsilonSVR."""
        return self._install(ModelEntry.from_estimator(name, model,
                                                       device=self.device))

    # --------------------------------------------------------- hot-swap
    def swap(self, name: str, model_or_path) -> dict:
        """Atomically replace a hosted model with a new generation.

        `model_or_path`: a serialized .npz path (the `refresh` handoff), a
        ModelEntry or an already-fitted estimator. The replacement is
        staged fully off to the side (load, pin, capture every bucket,
        probe) and only then does the worker's generation bundle flip,
        under the server lock, together with the registry entry. In-flight
        batches finish on the old generation; breaker state, SLO windows
        and metrics carry over.

        On ANY staging failure the old model keeps serving: the failure is
        recorded (healthz degrades, swap_failures increments) and
        re-raised. A SimulatedKill propagates unrecorded: a killed process
        records nothing, and the restarted server reloads the old
        generation from serve_state.json.

        Returns {"name", "generation", "latency_s", "staleness_before_s"}.
        """
        w = self._worker(name)
        t0 = time.perf_counter()
        with self._swap_lock:
            old = w._gen
            try:
                if isinstance(model_or_path, str):
                    entry = ModelEntry.from_path(name, model_or_path,
                                                 dtype=self.dtype,
                                                 device=self.device)
                elif isinstance(model_or_path, ModelEntry):
                    entry = model_or_path
                else:
                    entry = ModelEntry.from_estimator(name, model_or_path,
                                                      device=self.device)
                gen = w.stage(entry)
            except faults.SimulatedKill:
                raise
            except BaseException as e:  # noqa: BLE001 — every staging
                # failure must roll back AND be visible on healthz
                w.record_swap_failure(e)
                faults.emit("serve.swap_failed", model=name,
                            error=f"{type(e).__name__}: {e}",
                            generation=old.generation)
                raise
            staleness_before = max(0.0, w._clock() - old.loaded_t)
            with self._lock:
                gen.generation = self.registry.swap(entry)
                w.flip(gen)
            retired = weakref.ref(old)
            del old
            w.retire(retired)
            self._record_built([(entry, gen.cache)])
        latency = time.perf_counter() - t0
        w.metrics.registry.gauge("serve.swap_latency_s").set_max(latency)
        faults.emit("serve.swapped", model=name,
                    generation=gen.generation, latency_s=latency,
                    staleness_before_s=staleness_before)
        self._persist_state()
        return {"name": name, "generation": gen.generation,
                "latency_s": latency,
                "staleness_before_s": staleness_before}

    # ------------------------------------------------- restart robustness
    def configure_cache(self, cache_dir: str) -> dict:
        """Keep the bucket-signature manifest in `cache_dir` (serve/
        cache.py): returns the manifest found there, whose signatures are
        the ones `unknown_signatures()` holds this run's builds against;
        warm-ups and swaps record theirs back."""
        from tpusvm_torch.serve.cache import read_cache_manifest

        manifest = read_cache_manifest(cache_dir)
        self._cache_dir = cache_dir
        self._known_signatures = set(manifest.get("signatures", {}))
        return manifest

    def unknown_signatures(self) -> List[str]:
        """Bucket signatures this run built that the cache dir's manifest
        did not hold when configure_cache read it (the --assert-cached
        gate; empty without a cache dir)."""
        if self._known_signatures is None:
            return []
        return sorted(self._built_signatures - self._known_signatures)

    def _record_built(self, pairs) -> None:
        from tpusvm_torch.serve.cache import bucket_signature, \
            record_signatures

        sigs = [bucket_signature(e, b, c.block)
                for e, c in pairs for b in c.buckets]
        self._built_signatures.update(sigs)
        if self._cache_dir is not None:
            record_signatures(self._cache_dir, sigs)

    def enable_state(self, path: str) -> None:
        """Persist the registry manifest (model paths + generations) to
        `path` after every successful load/swap."""
        self._state_path = path
        self._persist_state()

    def set_bound_address(self, host: str, port: int) -> None:
        """Record the ACTUAL bound HTTP address into the persisted state
        (with `serve --port 0` the kernel picks the port)."""
        self._bound_address = f"{host}:{int(port)}"
        self._persist_state()

    @property
    def bound_address(self) -> Optional[str]:
        return self._bound_address

    def _persist_state(self) -> None:
        if self._state_path is None:
            return
        from tpusvm_torch.serve.cache import save_serve_state

        models = {}
        for n in self.registry.names():
            e, gen = self.registry.get_versioned(n)
            models[n] = {"path": e.source_path, "generation": gen}
        save_serve_state(self._state_path, models,
                         cache_dir=self._cache_dir,
                         address=self._bound_address,
                         replica_id=self.replica_id)

    def restore_state(self, path: str) -> dict:
        """Reload the model set recorded in a serve_state.json (either
        package's): every path-backed model is loaded and its generation
        counter restored. Models recorded without a source path cannot be
        restored and are reported in the returned dict's "skipped"."""
        from tpusvm_torch.serve.cache import load_serve_state

        state = load_serve_state(path)
        if state.get("replica_id"):
            # a revived replica IS the replica that wrote the state
            self.replica_id = state["replica_id"]
        restored, skipped = [], []
        for name, info in sorted(state["models"].items()):
            if name in self.registry:
                continue
            if not info.get("path"):
                skipped.append(name)
                continue
            entry = ModelEntry.from_path(name, info["path"],
                                         dtype=self.dtype,
                                         device=self.device)
            entry.generation = int(info.get("generation", 1))
            self._install(entry)
            restored.append(name)
        if state.get("cache_dir") and self._cache_dir is None:
            self.configure_cache(state["cache_dir"])
        return {"restored": restored, "skipped": skipped,
                "cache_dir": state.get("cache_dir")}

    def _worker(self, name: str) -> _ModelWorker:
        with self._lock:
            try:
                return self._workers[name]
            except KeyError:
                raise KeyError(
                    f"unknown model {name!r}; hosted: "
                    f"{sorted(self._workers)}"
                ) from None

    def warmup(self, name: Optional[str] = None) -> Dict[str, int]:
        """Capture every bucket graph; {model: programs built}. With a
        cache dir, every built signature is recorded into its manifest."""
        names = [name] if name is not None else self.registry.names()
        out = {n: self._worker(n).cache.warmup() for n in names}
        pairs = []
        for n in names:
            g = self._worker(n)._gen
            pairs.append((g.entry, g.cache))
        self._record_built(pairs)
        return out

    # ----------------------------------------------------------- serving
    def submit(self, name: str, x: np.ndarray,
               timeout_s: Optional[float] = None) -> ServeResult:
        """Score one row through the micro-batcher; blocks for the result."""
        w = self._worker(name)
        row = w.entry.validate_rows(x)
        if row.shape[0] != 1:
            raise ValueError(
                f"submit takes one row, got {row.shape[0]} (use submit_many)"
            )
        return w.batcher.submit(row[0], timeout_s=timeout_s)

    def submit_many(self, name: str, X: np.ndarray,
                    timeout_s: Optional[float] = None) -> List[ServeResult]:
        """Score rows through the micro-batcher (rows coalesce freely with
        other callers' requests)."""
        w = self._worker(name)
        rows = w.entry.validate_rows(X)
        return w.batcher.submit_many(list(rows), timeout_s=timeout_s)

    def predict_direct(self, name: str,
                       X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, labels) synchronously, bypassing the queue: the same
        scaler and bucket programs, no batching."""
        w = self._worker(name)
        rows = w.entry.validate_rows(X)
        scores, labels, _ = w._score(rows)
        return scores, labels

    # ------------------------------------------------------------ status
    def metrics(self, name: str) -> dict:
        return self._worker(name).metrics.snapshot()

    def score_stats(self, name: str) -> dict:
        """Cumulative served-score sign tallies of a binary model (both 0
        for ovr/svr models)."""
        reg = self._worker(name).metrics.registry
        return {"pos": reg.counter("serve.scores_pos").value,
                "neg": reg.counter("serve.scores_neg").value}

    def metrics_text(self) -> str:
        from tpusvm_torch.obs.registry import escape_label_value

        chunks = []
        for n in self.registry.names():
            w = self._worker(n)
            snap_labels = f'model="{escape_label_value(n)}"'
            chunks.append(w.metrics.render_text(labels=snap_labels))
            chunks.append(
                f'tpusvm_serve_compiled_shapes{{{snap_labels}}} '
                f'{w.cache.compiled_shapes}\n'
            )
        return "".join(chunks)

    def fleet_snapshot(self) -> dict:
        """This replica's fleet payload (obs/fleet.py): every model
        worker's registry snapshot merged into one (the per-model series
        are label-disjoint, so the merge is exact), plus a status block
        (generation / breaker / queue / p99 / burn per model). GET
        /metrics.json serves this verbatim."""
        from tpusvm_torch.obs.fleet import snapshot_payload
        from tpusvm_torch.obs.registry import merge_snapshots

        with self._lock:
            workers = dict(self._workers)
        snaps = [w.metrics.registry_snapshot() for w in workers.values()]
        merged = (merge_snapshots(*snaps) if snaps
                  else {"v": 1, "metrics": []})
        models = {}
        for n, w in workers.items():
            m = w.metrics.snapshot()
            slo = m.get("slo")
            models[n] = {
                "generation": w.generation,
                "breaker": w.breaker.state,
                "queue_depth": w.batcher.depth,
                "p99_s": m["latency_s"]["p99"],
                "burning": bool(slo["burning"]) if slo else False,
            }
        return snapshot_payload(
            "serve", self.replica_id, merged,
            status={"models": models,
                    "draining": self._draining,
                    "uptime_s": round(time.monotonic() - self._start_t,
                                      3)})

    def status(self) -> dict:
        """JSON-able server summary (models, buckets, builds, queues)."""
        models = {}
        for n in self.registry.names():
            w = self._worker(n)
            g = w._gen  # one bundle: entry/cache stats stay consistent
            models[n] = {
                **g.entry.describe(),
                **w.swap_status(),
                "buckets": list(g.cache.buckets),
                "compiled_shapes": g.cache.compiled_shapes,
                "compiles": g.cache.compiles,
                "recompiles": g.cache.recompiles,
                "warmed": g.cache.warmed,
                "graphed": g.cache.graphed,
                "queue_depth": w.batcher.depth,
                "breaker": w.breaker.describe(),
            }
        return {
            "models": models,
            "draining": self._draining,
            "state_path": self._state_path,
            "cache_dir": self._cache_dir,
            "device": str(self.device),
            "config": dataclasses.asdict(self.config),
        }

    def health(self) -> dict:
        """The /healthz payload: overall status + per-model breaker state.

        "ok" only when the server is accepting work; "draining" after
        drain(); a model with an open breaker, a burning SLO budget OR a
        failed last swap degrades the report to "degraded" without failing
        the whole check (the other models still serve)."""
        with self._lock:
            workers = dict(self._workers)
        breakers = {n: w.breaker.state for n, w in workers.items()}
        swap = {n: w.swap_status() for n, w in workers.items()}
        failed_swaps = [
            n for n, st in swap.items()
            if st["last_swap"] is not None
            and st["last_swap"]["outcome"] == "failed"
        ]
        slo = {n: st for n, w in workers.items()
               if (st := w.metrics.slo_status()) is not None}
        burning = [n for n, st in slo.items() if st["burning"]]
        if self._draining or self._closed:
            status = "draining"
        elif any(s != "closed" for s in breakers.values()) or burning \
                or failed_swaps:
            status = "degraded"
        else:
            status = "ok"
        out = {"status": status, "models": breakers, "swap": swap,
               "replica_id": self.replica_id,
               "uptime_s": round(time.monotonic() - self._start_t, 3)}
        if slo:
            out["slo"] = {
                n: {"latency_burn": st["latency_burn"],
                    "error_burn": st["error_burn"],
                    "burning": st["burning"]}
                for n, st in slo.items()
            }
        return out

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Stop admitting new requests (they come back DRAINING) and wait
        for in-flight work to finish. True when every model quiesced
        within the timeout: drain, then close, and no accepted request is
        ever dropped."""
        self._draining = True
        with self._lock:
            workers = list(self._workers.values())
        ok = True
        for w in workers:
            ok = w.drain(timeout_s) and ok
        faults.emit("serve.drained", complete=ok)
        return ok

    def attach_http(self, httpd, thread=None) -> None:
        """Register the HTTP frontend serving this Server so close() owns
        its shutdown: stop the serve loop, close the listening socket,
        join the serving thread."""
        with self._lock:
            self._httpd = httpd
            self._http_thread = thread

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = list(self._workers.values())
            httpd, http_thread = self._httpd, self._http_thread
            self._httpd = self._http_thread = None
        if httpd is not None:
            # outside the lock: shutdown blocks on the serve loop, and a
            # handler thread mid-request may call back into this Server
            from tpusvm_torch.serve.http import stop_http_server

            stop_http_server(httpd, http_thread)
        for w in workers:
            w.close()

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def sequential_qps(server: Server, name: str, rows: Sequence[np.ndarray],
                   duration_s: float) -> float:
    """Throughput of the one-request-at-a-time path (the baseline)."""
    import itertools

    n = 0
    t0 = time.perf_counter()
    for x in itertools.cycle(rows):
        server.predict_direct(name, x)
        n += 1
        if time.perf_counter() - t0 >= duration_s:
            break
    return n / (time.perf_counter() - t0)
