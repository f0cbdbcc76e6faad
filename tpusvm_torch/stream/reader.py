"""Background-prefetching shard reader with a hard residency bound.

The port's copy of tpusvm/stream/reader.py. IO for shard k+1 overlaps
compute on shard k: ONE daemon producer thread loads (and, through the
`transform` hook, may map on the card), any consumer iterates; hand-off is
a queue, shutdown a sentinel, and a producer exception is re-raised in the
consumer.

A semaphore with `prefetch_depth + 1` permits gates every shard LOAD, and
a shard's permit is released only when the consumer moves past its block
(or the reader closes). At any instant

    resident shards = permits held <= prefetch_depth + 1

counted across the producer's in-flight load, the queue and the block the
consumer holds, raw or mapped. `max_live_shards` records the high-water
mark.

Shard ORDER is deterministic: manifest order by default, or a fixed
permutation from np.random.default_rng(seed). Each load runs under
faults.Retry around the ``stream.read_shard`` point; a read that stays
broken ends in ShardError(READ_FAILED) naming the shard.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from tpusvm_torch import faults
from tpusvm_torch.status import StreamStatus
from tpusvm_torch.stream.format import ShardedDataset, ShardError

_SENTINEL = object()


class ShardReader:
    """Iterate a ShardedDataset's (X, Y) blocks with background prefetch.

    Args:
      dataset: an open ShardedDataset.
      prefetch_depth: shards loaded ahead of the consumer (>= 1; 1 is
        classic double buffering). Peak residency is prefetch_depth + 1
        shards, enforced by a permit per resident shard.
      seed: None = manifest order; an int = a deterministic shuffled
        shard order (np.random.default_rng(seed).permutation).
      shards: optional subset of shard indices to read — only those
        shards are ever loaded (manifest order unless seed shuffles the
        subset). The pod tier's leaf loader: a leaf streams exactly the
        shards overlapping its row range, with per-shard blocks
        byte-identical to a full-manifest pass, and the residency bound
        unchanged. Indices must be unique and in range.
      scaler: optional fitted MinMaxScaler applied on the fly (e.g. the
        manifest-fitted global scaler), so consumers see scaled rows
        without a second pass over the data.
      dtype: optional numpy dtype the X block is cast to after scaling.
      transform: optional row-wise feature transform applied LAST (after
        scaler and dtype), per shard, on the producer thread: the
        approximate-kernel prefetch hook (approx/features.py: a hook that
        copies the block to the card and maps it there hands the
        consumer a card tensor, so no host round trip and no (n, D)
        array ever exists). The residency bound is unchanged: a block is
        one resident shard whether raw or mapped. Must be a pure
        (m, d) -> (m, D) function. Card work in the hook runs on the
        CUDA stream that was current on the consumer's thread when
        iteration began, so the consumer's later work on that stream is
        ordered after the mapped block is complete, and a block's memory
        is never handed back to another stream while the consumer uses
        it.
      verify: re-checksum each shard against the manifest on load.
      metrics: an obs.registry.MetricsRegistry for the pipeline health
        counters (default: the process-wide default_registry) —
        `stream.shards_loaded` (loads completed),
        `stream.producer_stalls` (loads that had to WAIT for a permit:
        the consumer is the bottleneck — healthy), and
        `stream.consumer_stalls` (consumer polls that found the queue
        empty: disk is the bottleneck — raise prefetch_depth), plus the
        `stream.live_shards` high-water gauge (the residency bound the
        tests audit via max_live_shards).

    Iterating yields (X, Y) per shard. `batches(m)` re-chunks the stream
    into fixed m-row batches (last one short) without widening the
    residency bound — a batch view borrows the current block.
    """

    def __init__(self, dataset: ShardedDataset, prefetch_depth: int = 2,
                 seed: Optional[int] = None, scaler=None, dtype=None,
                 verify: bool = False, metrics=None,
                 retry_policy: Optional[faults.RetryPolicy] = None,
                 transform=None, shards=None):
        if prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}"
            )
        self.dataset = dataset
        self.prefetch_depth = prefetch_depth
        self.scaler = scaler
        self.dtype = dtype
        self.transform = transform
        self.verify = verify
        if shards is None:
            order = np.arange(dataset.n_shards)
        else:
            order = np.asarray(shards, np.int64)
            if order.ndim != 1 or len(set(order.tolist())) != len(order):
                raise ValueError(
                    "shards must be a flat sequence of unique indices; "
                    f"got {shards!r}"
                )
            if order.size and (order.min() < 0
                               or order.max() >= dataset.n_shards):
                raise IndexError(
                    f"shard indices out of range [0, {dataset.n_shards})"
                )
        if seed is not None:
            order = np.random.default_rng(seed).permutation(order)
        self.shard_order = order
        if metrics is None:
            from tpusvm_torch.obs.registry import default_registry

            metrics = default_registry()
        self._loaded = metrics.counter("stream.shards_loaded")
        self._producer_stalls = metrics.counter("stream.producer_stalls")
        self._consumer_stalls = metrics.counter("stream.consumer_stalls")
        self._live_gauge = metrics.gauge("stream.live_shards")
        # transient read faults (injected or real flaky I/O) are retried
        # with backoff before the consumer ever hears about them; a read
        # that stays broken surfaces as ShardError(READ_FAILED) naming
        # the shard, not a raw exception from the prefetch thread
        self._retry = faults.Retry(
            retry_policy or faults.DEFAULT_IO_POLICY,
            op="stream.read_shard", metrics=metrics,
        )
        # residency accounting: one permit per resident shard
        self._permits = threading.Semaphore(prefetch_depth + 1)
        self._lock = threading.Lock()
        self._live = 0
        self.max_live_shards = 0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._consumer_holds = False
        self._started = False
        self._cuda_stream = None
        self._worker = threading.Thread(target=self._produce, daemon=True,
                                        name="tpusvm-torch-stream-reader")

    # ---------------------------------------------------------- producer
    def _acquire(self) -> bool:
        """One permit per shard load; polls so close() can interrupt."""
        stalled = False
        while not self._stop.is_set():
            if self._permits.acquire(timeout=0.05):
                with self._lock:
                    self._live += 1
                    self.max_live_shards = max(self.max_live_shards,
                                               self._live)
                self._live_gauge.set_max(self.max_live_shards)
                return True
            if not stalled:
                # first miss only: one stalled LOAD = one stall, however
                # many 50ms polls it spans
                stalled = True
                self._producer_stalls.inc()
        return False

    def _release(self) -> None:
        with self._lock:
            self._live -= 1
        self._permits.release()

    def _produce(self) -> None:
        if self._cuda_stream is None:
            self._produce_shards()
            return
        with torch.cuda.stream(self._cuda_stream):
            self._produce_shards()

    def _produce_shards(self) -> None:
        try:
            for i in self.shard_order:
                if not self._acquire():
                    return  # closed while waiting for a permit
                try:
                    try:
                        X, Y = self._retry(self.dataset.load_shard, int(i),
                                           verify=self.verify)
                    except faults.RetryExhaustedError as e:
                        raise ShardError(
                            self.dataset.manifest.shards[int(i)].filename,
                            StreamStatus.READ_FAILED, str(e),
                        ) from e
                    if self.scaler is not None:
                        X = self.scaler.transform(X)
                    if self.dtype is not None:
                        X = np.asarray(X, self.dtype)
                    if self.transform is not None:
                        X = self.transform(X)
                except BaseException:
                    self._release()
                    raise
                self._loaded.inc()
                self._q.put((X, Y))
                if self._stop.is_set():
                    return
            self._q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            self._q.put(e)

    # ---------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self._started:
            raise RuntimeError(
                "ShardReader is single-pass; construct a new reader to "
                "re-read (same seed = same order)"
            )
        # tpusvm: guarded-by=written on the consumer thread before the producer exists (Thread.start is the fence)
        self._started = True
        if torch.cuda.is_initialized():
            # tpusvm: guarded-by=written on the consumer thread before the producer exists (Thread.start is the fence)
            self._cuda_stream = torch.cuda.current_stream()
        self._worker.start()
        try:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    # the consumer outran the producer: disk/IO is the
                    # bottleneck for this stretch
                    self._consumer_stalls.inc()
                    item = self._q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                if self._consumer_holds:
                    self._release()  # moving past the previous block
                # tpusvm: guarded-by=consumer-thread confined (only the single consumer and its finally-close touch it)
                self._consumer_holds = True
                yield item
                # NOTE: the yielded block's permit is released when the
                # consumer asks for the NEXT block (or in close()) — the
                # block it is still processing stays counted as resident.
        finally:
            self.close()

    def batches(self, batch_size: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Fixed-size (X, Y) batches re-chunked across shard boundaries.

        Peak residency is unchanged (a carried remainder is a copy of at
        most batch_size - 1 rows, not a retained shard). X blocks may be
        numpy arrays or torch tensors (a transform that maps on the card);
        Y stays numpy.
        """
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        rx, ry = None, None
        for X, Y in self:
            if rx is not None:
                X = (torch.cat([rx, X]) if isinstance(X, torch.Tensor)
                     else np.concatenate([rx, X]))
                Y = np.concatenate([ry, Y])
                rx = ry = None
            n_full = len(X) // batch_size * batch_size
            for s in range(0, n_full, batch_size):
                yield X[s:s + batch_size], Y[s:s + batch_size]
            if n_full < len(X):
                # copy: the remainder must not pin the whole shard block
                tail = X[n_full:]
                rx = (tail.clone() if isinstance(tail, torch.Tensor)
                      else tail.copy())
                ry = Y[n_full:].copy()
        if rx is not None:
            yield rx, ry

    @property
    def live_shards(self) -> int:
        with self._lock:
            return self._live

    def close(self) -> None:
        """Stop the producer and drop queued blocks. Idempotent."""
        self._stop.set()
        if self._started:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL and not isinstance(item,
                                                            BaseException):
                    self._release()
            if self._consumer_holds:
                # tpusvm: guarded-by=consumer-thread confined (close runs on the consumer's __iter__ finally, or after it exits)
                self._consumer_holds = False
                self._release()
