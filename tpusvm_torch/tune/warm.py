"""Warm-start seeding across grid points and halving rungs.

The port's copy of the JAX package's tpusvm/tune/warm.py (numpy only).
`blocked_smo_solve(alpha0=..., warm_start=True)` rebuilds the error vector
from seeded alphas with one f-update (kernel #1 for RBF on the card), as
the cascade does when it feeds merged SV sets up the tree
(mpi_svm_main3.cpp:156-186 semantics). During a grid sweep, adjacent
points in (log C, log gamma) share most of their active set, so seeding a
fit from its nearest already-solved neighbour's alphas skips most of the
cold-start SMO updates.

Two corrections make an arbitrary donor solution a VALID seed:

  - box feasibility: the donor's alphas are clipped into the recipient's
    [0, C] box (a donor with larger C can exceed it);
  - equality-constraint repair: pairwise SMO updates preserve
    sum(alpha_i * y_i) exactly, so a seed that violates the dual equality
    constraint (after clipping, or after rung resizing dropped rows) would
    pin that violation into every iterate; the heavier class side is
    scaled down so sum(alpha[y=+1]) == sum(alpha[y=-1]) again. Scaling
    DOWN keeps box feasibility for free.

Across successive-halving rungs the row sets are nested prefixes of each
fold's fixed shuffled order, so a previous rung's solution transfers by
zero-padding the new rows (`solver.blocked.pad_alpha0`, the resume-shape
helper); new rows start at alpha=0 exactly as cold SMO would start them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from tpusvm_torch.solver.blocked import pad_alpha0
from tpusvm_torch.tune.grid import nearest_point


def feasible_seed(alpha: np.ndarray, Y: np.ndarray, C: float) -> np.ndarray:
    """Project a donor alpha vector into the recipient's feasible set.

    Clip to [0, C], then restore sum(alpha * y) == 0 by scaling down the
    class side carrying more dual mass. If either side ends at zero mass
    the whole seed collapses to zeros (an all-one-sided seed cannot
    satisfy the equality constraint except trivially) — the caller then
    just runs a cold start.
    """
    a = np.clip(np.asarray(alpha, np.float64), 0.0, C)
    y = np.asarray(Y)
    pos = y > 0
    s_pos = float(a[pos].sum())
    s_neg = float(a[~pos].sum())
    if s_pos <= 0.0 or s_neg <= 0.0:
        return np.zeros_like(a)
    if s_pos > s_neg:
        a[pos] *= s_neg / s_pos
    elif s_neg > s_pos:
        a[~pos] *= s_pos / s_neg
    return a


def deployed_seed(sv_ids: np.ndarray, sv_alpha: np.ndarray, n_rows: int,
                  Y: np.ndarray, C: float) -> np.ndarray:
    """Full-length alpha0 for a refresh fit, from a DEPLOYED model's SV set.

    The online-learning warm start (`refresh`): the deployed artifact
    stores only its support vectors' (sv_ids, sv_alpha); the refresh
    training set must keep the deployed run's rows as a PREFIX (new data
    appends), so the donor solution scatters back to full length at its
    original row positions, new rows start at alpha=0 exactly as cold SMO
    would start them, and the result is projected feasible for the
    refresh problem's labels and box (feasible_seed).
    """
    ids = np.asarray(sv_ids, np.int64)
    if ids.size and int(ids.max()) >= n_rows:
        raise ValueError(
            f"deployed model's SV ids reach row {int(ids.max())} but the "
            f"refresh training set has only {n_rows} rows — refresh "
            "requires the deployed run's rows as a prefix of the new data"
        )
    a = np.zeros(n_rows, np.float64)
    a[ids] = np.asarray(sv_alpha, np.float64)
    return feasible_seed(a, Y, C)


def deployed_seed_ovr(sv_ids: np.ndarray, coef: np.ndarray, n_rows: int,
                      labels: np.ndarray, classes: np.ndarray,
                      C: float) -> np.ndarray:
    """(K, n) per-head alpha0 seeds for a one-vs-rest refresh, from the
    deployed artifact's signed coefficients.

    The state stores coef = alpha * y per head over the SV union, so each
    head's duals are |coef[k]|. Every head scatters to its original row
    positions (the prefix contract) and is projected feasible against ITS
    one-vs-rest labels: the heads share rows but not label vectors."""
    ids = np.asarray(sv_ids, np.int64)
    if ids.size and int(ids.max()) >= n_rows:
        raise ValueError(
            f"deployed OvR model's SV ids reach row {int(ids.max())} but "
            f"the refresh training set has only {n_rows} rows — refresh "
            "requires the deployed run's rows as a prefix of the new data"
        )
    coef = np.asarray(coef, np.float64)
    labels = np.asarray(labels)
    seeds = np.zeros((len(classes), n_rows), np.float64)
    for k, c in enumerate(classes):
        a = np.zeros(n_rows, np.float64)
        a[ids] = np.abs(coef[k])
        yk = np.where(labels == c, 1, -1).astype(np.int32)
        seeds[k] = feasible_seed(a, yk, C)
    return seeds


def deployed_seed_svr(sv_ids: np.ndarray, sv_coef: np.ndarray,
                      n_rows: int, C: float) -> np.ndarray:
    """Doubled-variable beta0 seed (length 2n) for an SVR refresh.

    The state stores signed coef_i = alpha_i - alpha*_i; at an SMO optimum
    the twin duals never overlap, so the doubling inverts exactly:
    beta_i = max(coef_i, 0) on the +1 half and beta_{n+i} = max(-coef_i, 0)
    on the -1 half (kernels/svr.py's label convention), projected feasible
    against the doubled labels."""
    ids = np.asarray(sv_ids, np.int64)
    if ids.size and int(ids.max()) >= n_rows:
        raise ValueError(
            f"deployed SVR model's SV ids reach row {int(ids.max())} but "
            f"the refresh training set has only {n_rows} rows — refresh "
            "requires the deployed run's rows as a prefix of the new data"
        )
    coef = np.asarray(sv_coef, np.float64)
    beta = np.zeros(2 * n_rows, np.float64)
    beta[ids] = np.maximum(coef, 0.0)
    beta[n_rows + ids] = np.maximum(-coef, 0.0)
    Y2 = np.concatenate([np.ones(n_rows, np.int32),
                         -np.ones(n_rows, np.int32)])
    return feasible_seed(beta, Y2, C)


class WarmStore:
    """Per-fold memory of solved points' alphas, queried by log-space
    nearest neighbour.

    Keyed by grid point; each entry keeps only the LATEST (largest-rung)
    alpha per fold — earlier rungs are strictly dominated as seeds. Alphas
    are host-side numpy (the store outlives any single device computation
    and a tune run can hold hundreds of entries).
    """

    def __init__(self):
        # fold -> point -> alpha (np.ndarray, length = that fit's rows)
        self._store: Dict[int, Dict[Tuple[float, float], np.ndarray]] = {}

    def record(self, fold: int, point: Tuple[float, float],
               alpha: np.ndarray) -> None:
        self._store.setdefault(fold, {})[point] = np.asarray(alpha)

    def seed(self, fold: int, point: Tuple[float, float], n_rows: int,
             Y_sub: np.ndarray, C: float) -> Optional[np.ndarray]:
        """Best available seed for `point` at `n_rows` training rows, or
        None (cold start). Preference order:

          1. the SAME point's previous-rung solution (strongest prior —
             the optimisation problem only gained rows);
          2. the nearest already-solved neighbour in (log C, log gamma).

        Either donor is resized with pad_alpha0 and projected feasible; a
        seed that projects to all-zeros is reported as None so callers
        don't pay the warm-start f reconstruction for a cold state.
        """
        entries = self._store.get(fold)
        if not entries:
            return None
        if point in entries:
            donor = entries[point]
        else:
            pts: List[Tuple[float, float]] = list(entries)
            donor = entries[pts[nearest_point(point, pts)]]
        a = feasible_seed(pad_alpha0(donor, n_rows), Y_sub, C)
        return a if a.any() else None
