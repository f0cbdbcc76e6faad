"""Streamed inference: decision scores over prefetched batches.

The port's copy of tpusvm/stream/infer.py. Batches flow off a ShardReader
(IO for the next shard overlapping the card's scoring of the current
batch) through the model's own decision_function/predict, so the
train-time scaler, the SV sum and the strict > 0 sign rule are the
in-memory path's, on the card the model was loaded for; peak memory is
prefetch_depth + 1 shards plus one batch.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from tpusvm_torch.stream.format import ShardedDataset
from tpusvm_torch.stream.reader import ShardReader


DEFAULT_BATCH = 4096


def predict_stream(model, dataset: ShardedDataset,
                   batch_size: int = DEFAULT_BATCH,
                   prefetch_depth: int = 2,
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (scores, Y) per fixed-size batch, in global row order.

    scores is model.decision_function on the RAW batch rows (the model
    applies its train-time scaler itself — the scaled-with-TRAIN-min/max
    evaluation protocol, main3.cpp:338-339); Y is the batch's stored
    labels. Binary models yield (m,) scores; one-vs-rest (m, K).
    """
    reader = ShardReader(dataset, prefetch_depth=prefetch_depth)
    for Xb, Yb in reader.batches(batch_size):
        yield np.asarray(model.decision_function(Xb)), Yb


def evaluate_stream(model, dataset: ShardedDataset,
                    batch_size: int = DEFAULT_BATCH,
                    prefetch_depth: int = 2,
                    n_limit: Optional[int] = None) -> Tuple[float, int]:
    """Accuracy of `model` over the dataset, never holding more than the
    residency bound. Returns (accuracy, n_rows_scored).

    n_limit caps scored rows (the gpu_svm_main4 argv[1] semantics applied
    to evaluation); the reader is closed early, so capped runs do not pay
    IO for the rest of the dataset.
    """
    correct = 0
    scored = 0
    reader = ShardReader(dataset, prefetch_depth=prefetch_depth)
    batches = reader.batches(batch_size)
    for Xb, Yb in batches:
        if n_limit is not None and scored + len(Xb) > n_limit:
            keep = n_limit - scored
            Xb, Yb = Xb[:keep], Yb[:keep]
        if len(Xb):
            pred = np.asarray(model.predict(Xb))
            correct += int((pred == Yb).sum())
            scored += len(Xb)
        if n_limit is not None and scored >= n_limit:
            batches.close()  # releases the reader via its finally
            break
    if scored == 0:
        raise ValueError("evaluate_stream: no rows scored")
    return correct / scored, scored
