"""Deterministic stratified k-fold splitting.

The port's copy of the JAX package's tpusvm/tune/folds.py (numpy only).
Per class, the row indices are shuffled by a seeded
`np.random.default_rng` and dealt round-robin to the k folds, so every
fold's train and validation sides carry every class, per-class fold
counts differ by at most one, and the split is a pure function of
(Y, k, seed).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class Fold(NamedTuple):
    """One CV split. Indices are into the original row order.

    train_idx is SHUFFLED (class-interleaved by construction, then mixed by
    a seeded permutation) so that prefix subsets of it — the successive-
    halving rungs — are themselves unbiased stratified-ish samples; a
    sorted train_idx would make small rungs echo whatever order the caller
    stored the data in (the exact hazard the stratified partitioner exists
    to kill).
    """

    train_idx: np.ndarray  # (n_train,) int32, shuffled
    val_idx: np.ndarray    # (n_val,) int32, sorted


def stratified_kfold(Y: np.ndarray, k: int, seed: int = 0) -> List[Fold]:
    """Split rows into k stratified folds; returns one Fold per held-out part.

    Y must be a 1-D label array (any hashable dtype; the binary {+1,-1}
    convention is not assumed, so multi-class tuning can reuse this).
    Every row lands in exactly one fold's val side. Requires every class to
    have at least k members — a class that cannot appear in each fold would
    make some folds' val metric structurally blind to it, which silently
    corrupts CV comparisons (better to fail loudly and let the caller lower
    k).
    """
    Y = np.asarray(Y)
    if Y.ndim != 1:
        raise ValueError(f"Y must be 1-D, got shape {Y.shape}")
    n = len(Y)
    if not 2 <= k <= n:
        raise ValueError(f"need 2 <= k <= n rows, got k={k}, n={n}")
    rng = np.random.default_rng(seed)
    classes = np.unique(Y)
    member = [[] for _ in range(k)]
    for c in classes:
        idx = np.flatnonzero(Y == c)
        if len(idx) < k:
            raise ValueError(
                f"class {c!r} has {len(idx)} rows < k={k} folds; every fold "
                "needs at least one validation member per class (lower k)"
            )
        rng.shuffle(idx)
        for f in range(k):
            member[f].extend(idx[f::k])
    folds = []
    for f in range(k):
        val = np.sort(np.asarray(member[f], np.int32))
        mask = np.ones(n, bool)
        mask[val] = False
        train = np.flatnonzero(mask).astype(np.int32)
        # mix the class-interleaved order so rung prefixes are random draws
        rng_f = np.random.default_rng(seed + 7919 * (f + 1))
        rng_f.shuffle(train)
        folds.append(Fold(train_idx=train, val_idx=val))
    return folds
