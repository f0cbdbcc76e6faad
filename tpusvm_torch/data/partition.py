"""Data partitioning with global IDs: contiguous (reference) or stratified.

A numpy-only copy of the JAX package's tpusvm/data/partition.py, so both
packages deal the same rows to the same leaves. The reference's MPI
scatter (mpi_svm_main3.cpp:463-518) splits the dataset into P contiguous
chunks of ceil(n/P) rows (the last may be short, trailing ones empty) and
gives each row its original index as a global ID; the cascade's
dedup-by-ID merges and its ID-set convergence test key on these IDs. The
partition is a padded (P, cap, d) array with a validity mask.

stratified=True deals each class's rows round-robin over the shards
instead, so label-sorted input cannot hand a leaf a single-class shard;
the global IDs are the original row indices either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Partition(NamedTuple):
    """P padded chunks, as host numpy arrays.

    X:     (P, cap, d) float  — rows beyond `count[p]` are zero padding
    Y:     (P, cap) int32     — padded entries are 0 (neither +1 nor -1)
    ids:   (P, cap) int32     — global row index; padded entries are -1
    valid: (P, cap) bool
    count: (P,) int32
    """

    X: np.ndarray
    Y: np.ndarray
    ids: np.ndarray
    valid: np.ndarray
    count: np.ndarray


def _fill(X: np.ndarray, Y: np.ndarray, n_shards: int, cap: int,
          shard_rows) -> Partition:
    n, d = X.shape
    Xp = np.zeros((n_shards, cap, d), X.dtype)
    Yp = np.zeros((n_shards, cap), np.int32)
    ids = np.full((n_shards, cap), -1, np.int32)
    valid = np.zeros((n_shards, cap), bool)
    count = np.zeros((n_shards,), np.int32)
    for p, rows in enumerate(shard_rows):
        c = len(rows)
        if c:
            idx = np.asarray(rows, np.int32)
            Xp[p, :c] = X[idx]
            Yp[p, :c] = Y[idx]
            ids[p, :c] = idx
            valid[p, :c] = True
        count[p] = c
    return Partition(Xp, Yp, ids, valid, count)


def partition(X: np.ndarray, Y: np.ndarray, n_shards: int,
              stratified: bool = False) -> Partition:
    """Split (X, Y) into n_shards padded chunks with global IDs.

    stratified=False (default): the contiguous ceil(n/P)-row scatter;
    trailing shards can be short, or empty when n < n_shards *
    ceil(n/n_shards) by a full chunk (an empty leaf solves to
    NO_WORKING_SET with no SVs, which the cascade's merges mask out).

    stratified=True: class c's rows, in their original order, are dealt
    one at a time over the shards, starting at shard c's index (so the
    remainders of different classes do not all land on shard 0); cap is
    the largest shard, at least 1.
    """
    n, d = X.shape
    if not stratified:
        cap = -(-n // n_shards)  # ceil
        shard_rows = [range(p * cap, min(p * cap + cap, n))
                      if p * cap < n else range(0)
                      for p in range(n_shards)]
        return _fill(X, Y, n_shards, cap, shard_rows)

    shard_rows = [[] for _ in range(n_shards)]
    for ci, c in enumerate(np.unique(Y)):
        for j, i in enumerate(np.flatnonzero(Y == c)):
            shard_rows[(ci + j) % n_shards].append(int(i))
    cap = max(1, max(len(rows) for rows in shard_rows))
    return _fill(X, Y, n_shards, cap, shard_rows)
