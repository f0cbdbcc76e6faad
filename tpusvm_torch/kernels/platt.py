"""Platt scaling: calibrated P(y=+1 | decision score) for binary SVMs.

The port's copy of the JAX package's tpusvm/kernels/platt.py (numpy
only). Fits P(y=+1|f) = 1 / (1 + exp(A*f + B)) by regularised maximum
likelihood with the Newton method and backtracking line search of Lin,
Lin & Weng (2007). The fit runs on the host over a few thousand scalars.
BinarySVC.calibrate fits it on out-of-fold scores of k stratified fold
models (tune/folds.py), then maps the full model's decision function.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def fit_platt(scores: np.ndarray, labels: np.ndarray, *,
              max_iter: int = 100, min_step: float = 1e-10,
              sigma: float = 1e-12) -> Tuple[float, float]:
    """Fit (A, B) of P(y=+1|f) = 1/(1 + exp(A*f + B)).

    scores: decision-function values; labels: {+1, -1}. Targets are the
    Bayes-shrunk t+ = (N+ + 1)/(N+ + 2), t- = 1/(N- + 2) priors (Platt's
    regularisation — keeps the fit defined even on separable data).
    Raises ValueError unless both classes are present.
    """
    f = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels).ravel()
    if f.shape != y.shape:
        raise ValueError(
            f"scores/labels length mismatch: {f.shape} vs {y.shape}"
        )
    pos = y > 0
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError(
            "Platt calibration needs both classes in the calibration set; "
            f"got {n_pos} positive / {n_neg} negative"
        )
    hi = (n_pos + 1.0) / (n_pos + 2.0)
    lo = 1.0 / (n_neg + 2.0)
    t = np.where(pos, hi, lo)

    def objective(a, b):
        fApB = a * f + b
        # -sum t*log(p) + (1-t)*log(1-p); exp only ever sees -|fApB|, so
        # neither np.where branch can overflow
        return float(np.sum(
            np.where(fApB >= 0, t * fApB, (t - 1.0) * fApB)
            + np.log1p(np.exp(-np.abs(fApB)))
        ))

    a, b = 0.0, np.log((n_neg + 1.0) / (n_pos + 1.0))
    fval = objective(a, b)
    for _ in range(max_iter):
        fApB = a * f + b
        # p = P(y=+1), q = 1-p; exp(-|fApB|) keeps both branches finite
        e = np.exp(-np.abs(fApB))
        p = np.where(fApB >= 0, e / (1.0 + e), 1.0 / (1.0 + e))
        q = 1.0 - p
        d1 = t - p                 # Lin et al.'s d1 (negative gradient
        #                            of the per-point objective in fApB)
        d2 = p * q                 # second derivative per point
        g1 = float(np.sum(f * d1))
        g2 = float(np.sum(d1))
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        h11 = float(np.sum(f * f * d2)) + sigma
        h22 = float(np.sum(d2)) + sigma
        h21 = float(np.sum(f * d2))
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB     # < 0: Newton direction descends
        step = 1.0
        while step >= min_step:
            na, nb = a + step * dA, b + step * dB
            nf = objective(na, nb)
            if nf < fval + 1e-4 * step * gd:
                a, b, fval = na, nb, nf
                break
            step /= 2.0
        else:
            break  # line search failed: at numerical optimum
    return float(a), float(b)


def platt_proba(scores: np.ndarray, A: float, B: float) -> np.ndarray:
    """P(y=+1|f) = 1/(1 + exp(A*f + B)), overflow-stable. Shape of scores.

    Strictly monotone in the scores whenever A < 0 (the fitted sign on
    any informative score set).
    """
    f = np.asarray(scores, np.float64)
    fApB = A * f + B
    e = np.exp(-np.abs(fApB))  # exp never sees a positive argument
    return np.where(fApB >= 0, e / (1.0 + e), 1.0 / (1.0 + e))


def log_loss(proba: np.ndarray, labels: np.ndarray,
             clip: float = 1e-15) -> float:
    """Mean negative log-likelihood of {+1,-1} labels under P(y=+1)."""
    p = np.clip(np.asarray(proba, np.float64), clip, 1.0 - clip)
    y = np.asarray(labels).ravel()
    return float(-np.mean(np.where(y > 0, np.log(p), np.log(1.0 - p))))
