"""Deterministic global row -> cascade-leaf assignment from a manifest.

The port's copy of tpusvm/stream/assign.py. data/partition.py slices a
whole in-memory array into the cascade's leaves; this module computes the
SAME assignment (contiguous ceil(n/P) chunks, or the stratified per-class
round-robin deal) as a function of (row count, labels, P), so each leaf
is filled by streaming shards one at a time into its (leaf, slot)
positions. The Partition equals data.partition on the concatenated array
bit for bit: same rows, per-leaf order, padding and global IDs.

Labels for the stratified deal come from a Y-only manifest pass
(ShardedDataset.load_labels); X is resident one shard at a time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from tpusvm_torch.data.partition import Partition
from tpusvm_torch.stream.format import ShardedDataset


class RowAssignment(NamedTuple):
    """Where every global row lands: leaf `part[i]`, padded slot `slot[i]`.

    cap is the padded per-leaf width (make_partition's cap for the same
    inputs); count[p] the realised rows of leaf p (trailing leaves can be
    short or empty under the contiguous scatter).
    """

    part: np.ndarray   # (n,) int32
    slot: np.ndarray   # (n,) int32
    count: np.ndarray  # (P,) int32
    cap: int


def assign_rows(n_rows: int, n_parts: int,
                Y: Optional[np.ndarray] = None,
                stratified: bool = False) -> RowAssignment:
    """Replicates data.partition's shard_rows as a row->(part, slot) map.

    Contiguous (default): row i -> part i // cap, slot i % cap with
    cap = ceil(n/P) — the reference's scatter; needs no labels.

    stratified=True: class ci's rows (original order) are dealt round-robin
    starting at part ci — row j of class ci -> part (ci + j) % P, slot =
    that part's running fill at deal time. Requires Y (one labels pass).
    """
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    if not stratified:
        cap = -(-n_rows // n_parts)  # ceil, as make_partition
        rows = np.arange(n_rows, dtype=np.int64)
        part = (rows // cap).astype(np.int32)
        slot = (rows % cap).astype(np.int32)
        count = np.zeros((n_parts,), np.int32)
        np.add.at(count, part, 1)
        return RowAssignment(part, slot, count, int(cap))

    if Y is None:
        raise ValueError("stratified assignment needs the labels Y")
    Y = np.asarray(Y)
    if len(Y) != n_rows:
        raise ValueError(f"len(Y)={len(Y)} != n_rows={n_rows}")
    part = np.zeros((n_rows,), np.int32)
    slot = np.zeros((n_rows,), np.int32)
    fill = np.zeros((n_parts,), np.int64)
    for ci, c in enumerate(np.unique(Y)):
        idx = np.flatnonzero(Y == c)
        j = np.arange(len(idx), dtype=np.int64)
        t = (ci + j) % n_parts
        # the k-th row of this class dealt to part p arrived at j = j0 + kP,
        # so j // P counts this class's earlier arrivals at the same part
        part[idx] = t.astype(np.int32)
        slot[idx] = (fill[t] + j // n_parts).astype(np.int32)
        np.add.at(fill, t, 1)
    count = fill.astype(np.int32)
    cap = max(1, int(count.max()))
    return RowAssignment(part, slot, count, cap)


def partition_from_dataset(dataset: ShardedDataset, n_parts: int,
                           stratified: bool = False, scaler=None,
                           prefetch_depth: int = 2) -> Partition:
    """Build the cascade's padded Partition by streaming shards.

    Bit-identical to data.partition(scaler.transform(X_full), Y_full,
    n_parts, stratified) without ever materialising X_full: the assignment
    is computed from the manifest (plus a Y-only pass when stratified),
    then each shard is loaded once — prefetched on a background thread —
    optionally scaled (pass the manifest-fitted scaler for the reference's
    global-min/max-before-scatter semantics), and scattered into its
    (leaf, slot) positions. Peak X residency: the (P, cap, d) partition
    buffer plus prefetch_depth + 1 shards.
    """
    from tpusvm_torch.stream.reader import ShardReader

    n, d = dataset.n_rows, dataset.n_features
    Y_all = dataset.load_labels() if stratified else None
    asg = assign_rows(n, n_parts, Y=Y_all, stratified=stratified)

    Xp = np.zeros((n_parts, asg.cap, d), np.float64)
    Yp = np.zeros((n_parts, asg.cap), np.int32)
    ids = np.full((n_parts, asg.cap), -1, np.int32)
    valid = np.zeros((n_parts, asg.cap), bool)

    reader = ShardReader(dataset, prefetch_depth=prefetch_depth,
                         scaler=scaler)
    row = 0
    for X, Y in reader:
        g = np.arange(row, row + len(X))
        p, s = asg.part[g], asg.slot[g]
        Xp[p, s] = X
        Yp[p, s] = Y
        ids[p, s] = g.astype(np.int32)
        valid[p, s] = True
        row += len(X)
    if row != n:
        raise ValueError(
            f"dataset yielded {row} rows, manifest says {n} (corrupt shard?)"
        )
    return Partition(Xp, Yp, ids, valid, asg.count)


def gather_rows(dataset: ShardedDataset,
                indices: Sequence[int]) -> np.ndarray:
    """X rows at the given global indices, in the given ORDER, loading only
    the shards that contain them (one at a time).

    The tune-fold primitive: a fold's shuffled train_idx / sorted val_idx
    gather into exactly the arrays the in-memory path would have sliced,
    with peak memory = output + one shard.
    """
    indices = np.asarray(indices, np.int64)
    if indices.size and (indices.min() < 0
                         or indices.max() >= dataset.n_rows):
        raise IndexError(
            f"row indices out of range [0, {dataset.n_rows})"
        )
    out = np.empty((len(indices), dataset.n_features), np.float64)
    for i, info in enumerate(dataset.manifest.shards):
        a, b = info.row_start, info.row_start + info.n_rows
        sel = np.flatnonzero((indices >= a) & (indices < b))
        if not sel.size:
            continue  # this shard's bytes are never read
        X, _ = dataset.load_shard(i)
        out[sel] = X[indices[sel] - a]
    return out
