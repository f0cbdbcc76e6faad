"""Mergeable per-shard dataset statistics.

The port's copy of tpusvm/stream/stats.py. Each shard records its own
min/max and class counts at ingest, and the dataset's statistics are an
exact merge of the partials: min and max are selections, so an elementwise
minimum/maximum over shards equals np.min/np.max on the concatenated
array bit for bit, and class counts are sums. A MinMaxScaler is therefore
fitted from a manifest without a row of X in memory (scaler_from_stats),
with the same bits as MinMaxScaler.fit on the whole array.

Python's json writes floats by repr (the shortest round-trip form), so an
f64 min/max written to the manifest reads back as the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from tpusvm_torch.data.scaler import MinMaxScaler, merge_minmax


@dataclasses.dataclass
class ShardStats:
    """Statistics of one shard (or of a whole dataset, after merging).

    min_val/max_val are per-feature float64 (the CSV readers' dtype);
    class_counts maps raw int label -> row count.
    """

    n_rows: int
    min_val: np.ndarray
    max_val: np.ndarray
    class_counts: Dict[int, int]

    def to_json(self) -> dict:
        return {
            "n_rows": int(self.n_rows),
            "min": [float(v) for v in self.min_val],
            "max": [float(v) for v in self.max_val],
            # JSON object keys are strings; from_json undoes this
            "class_counts": {str(k): int(v)
                             for k, v in sorted(self.class_counts.items())},
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ShardStats":
        return cls(
            n_rows=int(obj["n_rows"]),
            min_val=np.asarray(obj["min"], np.float64),
            max_val=np.asarray(obj["max"], np.float64),
            class_counts={int(k): int(v)
                          for k, v in obj["class_counts"].items()},
        )


def compute_stats(X: np.ndarray, Y: np.ndarray) -> ShardStats:
    """Per-shard statistics of one (X, Y) block. X must be non-empty
    (a shard with zero rows has no honest min/max)."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    if len(X) == 0:
        raise ValueError("compute_stats: empty shard")
    labels, counts = np.unique(Y, return_counts=True)
    return ShardStats(
        n_rows=int(len(X)),
        min_val=np.min(X, axis=0).astype(np.float64),
        max_val=np.max(X, axis=0).astype(np.float64),
        class_counts={int(l): int(c) for l, c in zip(labels, counts)},
    )


def merge_stats(parts: Sequence[ShardStats]) -> ShardStats:
    """Exact merge of per-shard statistics into dataset-global ones.

    min/max merge through data.scaler.merge_minmax (bit-identical to a
    full-array fit); counts are summed. Raises on an empty sequence.
    """
    if not parts:
        raise ValueError("merge_stats: no shard stats to merge")
    lo, hi = merge_minmax((p.min_val, p.max_val) for p in parts)
    counts: Dict[int, int] = {}
    for p in parts:
        for k, v in p.class_counts.items():
            counts[k] = counts.get(k, 0) + v
    return ShardStats(
        n_rows=sum(p.n_rows for p in parts),
        min_val=lo,
        max_val=hi,
        class_counts=counts,
    )


def scaler_from_stats(stats: ShardStats) -> MinMaxScaler:
    """The rank-0 global min/max broadcast, done without ever holding X:
    a MinMaxScaler whose transform is bit-identical to one fitted on the
    concatenated array (including the degenerate-range branch, which
    lives in the scaler itself)."""
    return MinMaxScaler.from_stats(stats.min_val, stats.max_val)
