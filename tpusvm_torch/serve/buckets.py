"""Bucketed program cache: pad batches to power-of-two row buckets, one
captured CUDA graph per (model, bucket).

A program keyed on the exact batch shape would be built for every distinct
batch size the micro-batcher happens to form. Padding every batch up to
its power-of-two bucket caps the shape universe at len(buckets) ~
log2(max_batch) + 1 programs per model, all built AHEAD OF TIME by
warmup(); steady state then builds nothing.

On the card each bucket is one CUDA graph, captured at warm-up over a
static input buffer of the bucket's rows: a served batch copies its padded
rows from a pinned host buffer into that buffer, replays the graph and
copies the static output back, all on the cache's own stream. The program
is the offline scorer itself (models/svm.py:score_scaled) over the entry's
pinned tensors, and that scorer runs every block at the full `block` rows
(solver/predict.py), so a bucket graph and an offline call over thousands
of rows run products of one shape and a served score is the offline
score's bits. On the CPU the same object runs the same program eagerly.

The capture rules, for staging a generation while another one serves:

  * every generation of a model captures, replays and copies on the
    worker's one stream, and only under the worker's lock: a capture
    records whatever is launched into its stream, so no replay may be
    enqueued there while one is open, and cuBLAS's per-(handle, stream)
    workspace, which a graph keeps the address of, is then only ever used
    by kernels of that one stream, which run in order. The lock is held
    bucket by bucket, so requests wait out one bucket's capture at most;
  * each capture follows one eager run on the stream (cuBLAS sets up its
    handle and workspace outside the capture) and runs in the
    "thread_local" error mode, so other threads' CUDA calls (pinned
    copies, allocations) neither fail it nor are failed by it;
  * the graphs of one generation share a memory pool of their own; they
    replay one at a time under the lock, which is what makes sharing
    safe, and the pool is released with the graphs once the generation's
    last in-flight batch drops them;
  * a replay reads its static input and writes its static output, so a
    batch holds the lock from the copy-in to the copy-out.

A failed capture or replay raises; nothing falls back to an eager or CPU
path. Builds are observable: `compiles` counts programs built (captures
on the card) and `recompiles` those built after warm-up (steady-state
target: 0); each build is one compile record (obs/prof.py: the eager
warm-up as lower_s, the capture as compile_s) in the worker's registry,
and a prof.compile trace event while the observatory is on.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusvm_torch.device import to_dtype, to_numpy
from tpusvm_torch.models.svm import score_scaled
from tpusvm_torch.obs import prof
from tpusvm_torch.serve.registry import ModelEntry


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two row buckets 1, 2, 4, ... covering max_batch."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def bucket_for(m: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits m rows."""
    for b in buckets:
        if m <= b:
            return b
    raise ValueError(f"batch of {m} rows exceeds the largest bucket "
                     f"{max(buckets)}")


class _Eager:
    """One bucket's program run eagerly (the CPU)."""

    def __init__(self, cache: "CompileCache", bucket: int):
        self.cache = cache
        self.bucket = bucket
        self.lower_s = self.compile_s = 0.0

    def run(self, X: torch.Tensor, lock) -> np.ndarray:
        return to_numpy(self.cache.program(X))


class _Graph:
    """One bucket's captured CUDA graph with its static buffers: the
    device input and output the graph reads and writes, and pinned host
    buffers for the copies in and out."""

    def __init__(self, cache: "CompileCache", bucket: int):
        e = cache.entry
        dev = e.device
        self.bucket = bucket
        self.stream = cache.stream
        self.static_in = torch.zeros((bucket, e.n_features), dtype=e.dtype,
                                     device=dev)
        self.host_in = torch.zeros((bucket, e.n_features),
                                   dtype=e.dtype).pin_memory()
        s = self.stream
        s.wait_stream(torch.cuda.current_stream(dev))
        with cache.lock, torch.cuda.stream(s):
            # eager first: cuBLAS creates this thread's handle and the
            # (handle, stream) workspace outside the capture
            t0 = time.perf_counter()
            cache.program(self.static_in)
            s.synchronize()
            t1 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            # no garbage collection while capturing: a collection in this
            # thread could destroy an unreachable graph, a call the capture
            # forbids (the destroy fails and its pool leaks)
            collecting = gc.isenabled()
            gc.disable()
            try:
                self.graph.capture_begin(pool=cache.pool,
                                         capture_error_mode="thread_local")
                try:
                    self.static_out = cache.program(self.static_in)
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is already invalid
                    raise
                self.graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        self.host_out = torch.empty(self.static_out.shape,
                                    dtype=self.static_out.dtype).pin_memory()
        s.synchronize()
        # the compile observatory's split: eager warm-up, then capture
        self.lower_s = t1 - t0
        self.compile_s = time.perf_counter() - t1

    def run(self, X: torch.Tensor, lock) -> np.ndarray:
        # one batch at a time through the static buffers, and the previous
        # batch's copies are done before the host buffer is rewritten
        with lock:
            self.host_in.copy_(X)
            with torch.cuda.stream(self.stream):
                self.static_in.copy_(self.host_in, non_blocking=True)
                self.graph.replay()
                self.host_out.copy_(self.static_out, non_blocking=True)
            self.stream.synchronize()
            # a copy: the pinned buffer is the next batch's
            return to_numpy(self.host_out).copy()


class CompileCache:
    """(bucket -> built program) for one model, with build counts.

    stream, lock: the hosting worker's stream and its reentrant lock,
    shared by every generation of the model (a cache made alone gets its
    own); every capture, replay and copy runs on the stream under the
    lock."""

    def __init__(self, entry: ModelEntry, buckets: Sequence[int],
                 block: int = 2048, registry=None, metrics=None,
                 stream=None, lock=None):
        self.entry = entry
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        # the scorer's block: every bucket program runs full blocks, the
        # offline scorer's shape (solver/predict.py)
        self.block = block
        self._compiled: Dict[int, object] = {}
        self._lock = threading.Lock()
        self.compiles = 0          # programs built (captures on the card)
        self.recompiles = 0        # builds AFTER warm-up completed
        self.build_s = 0.0         # seconds spent building
        self.warmed = False
        # the hosting worker's registry (per-bucket build seconds) and
        # metrics (the recompiles counter on /metrics)
        self.registry = registry
        self.metrics = metrics
        self.graphed = entry.device.type == "cuda"
        self.lock = threading.RLock() if lock is None else lock
        self.stream = None
        self.pool = None
        if self.graphed:
            self.stream = (torch.cuda.Stream(device=entry.device)
                           if stream is None else stream)
            # this generation's graphs share one pool of their own
            self.pool = torch.cuda.graph_pool_handle()

    # -------------------------------------------------------------- build
    def program(self, X: torch.Tensor) -> torch.Tensor:
        """The scores of the scaled, padded rows X (on the entry's device,
        in its dtype): the offline scorer over the pinned tensors."""
        e = self.entry
        return score_scaled(X, e.X_sv, e.coef, e.b, e.config, e.fmap,
                            block=self.block)

    def _build(self, bucket: int):
        t0 = time.perf_counter()
        built = (_Graph(self, bucket) if self.graphed
                 else _Eager(self, bucket))
        self.build_s += time.perf_counter() - t0
        e = self.entry
        prof.record_compile(
            f"serve.bucket[{e.name}:b{bucket}]", built.lower_s,
            built.compile_s, registry=self.registry, model=e.name,
            bucket=bucket, kind=e.kind)
        return built

    def _get(self, bucket: int):
        # the device lock first, then the table's: the order every path
        # takes (a batch already holds the device lock)
        with self.lock, self._lock:
            fn = self._compiled.get(bucket)
            if fn is None:
                fn = self._build(bucket)
                self._compiled[bucket] = fn
                self.compiles += 1
                if self.warmed:
                    self.recompiles += 1
                    if self.metrics is not None:
                        self.metrics.inc("recompiles")
            return fn

    def warmup(self) -> int:
        """Build every bucket; returns how many were newly built.

        Idempotent: a second call builds nothing and keeps `warmed` set, so
        the recompile counter keeps meaning "builds the warm-up missed"."""
        before = self.compiles
        for b in self.buckets:
            self._get(b)
        self.warmed = True
        return self.compiles - before

    @property
    def compiled_shapes(self) -> int:
        with self._lock:
            return len(self._compiled)

    # -------------------------------------------------------------- score
    def padded(self, X: np.ndarray, bucket: int) -> torch.Tensor:
        """The m scaled f64 rows of X as a (bucket, d) host tensor in the
        model dtype, zero rows after them: the cast is the offline path's
        upload cast (device.to_dtype)."""
        Xp = torch.zeros((bucket, X.shape[1]), dtype=self.entry.dtype)
        Xp[:X.shape[0]] = to_dtype(X, self.entry.dtype)
        return Xp

    def scores(self, X: np.ndarray) -> Tuple[np.ndarray, int]:
        """Scores for the m rows of X through the padded bucket program.

        X must already be scaled, float64, of the entry's width. Returns
        (scores for the real rows, bucket used). Binary/svr: (m,); ovr:
        (m, K)."""
        m = X.shape[0]
        bucket = bucket_for(m, self.buckets)
        out = self._get(bucket).run(self.padded(X, bucket), self.lock)
        return out[:m], bucket

    def eager_scores(self, X: np.ndarray,
                     stream: Optional[torch.cuda.Stream] = None
                     ) -> np.ndarray:
        """The bucket program run eagerly (no graph) on `stream` (default:
        the cache's own): the card's check that a replay equals the eager
        program bit for bit."""
        m = X.shape[0]
        Xp = self.padded(X, bucket_for(m, self.buckets)).to(self.entry.device)
        if not self.graphed:
            return to_numpy(self.program(Xp))[:m]
        s = self.stream if stream is None else stream
        with self.lock:
            s.wait_stream(torch.cuda.current_stream(self.entry.device))
            with torch.cuda.stream(s):
                out = self.program(Xp).cpu()
        return out.numpy()[:m]
