"""Epsilon-SVR as a doubled-variable classification-shaped SMO problem.

The port's copy of the JAX package's tpusvm/kernels/svr.py (numpy only).
Stack beta = [alpha; alpha*] over 2n variables with labels
y = [+1]*n + [-1]*n and pseudo-targets

    z_i     = t_i - epsilon   (the alpha half,  y = +1)
    z_{i+n} = t_i + epsilon   (the alpha* half, y = -1)

so that f_i = sum_j beta_j y_j K_ij - z_i has the classification
problem's gradient structure: selection, the stopping rule and the
analytic update are unchanged, and the solvers take z as `targets`.
The twin rows (i, i+n) have equal features, opposite labels and eta = 0;
their f values differ by exactly 2*epsilon in the non-violating
direction, so they are never selected as a violating pair.

Prediction collapses the doubling: coef_i = beta_i - beta_{i+n}, and
y(x) = sum_i coef_i K(x, x_i) - b, the classifiers' decision function.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def doubled_problem(t: np.ndarray, epsilon: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(Y2, z) for the 2n-variable problem; X doubles by concatenation.

    Y2 is the {+1, -1} label stacking, z the pseudo-target vector the
    solvers take as `targets`. Pure NumPy so the f64 oracle shares the
    construction byte-for-byte with the estimators.
    """
    t = np.asarray(t, np.float64)
    if t.ndim != 1:
        raise ValueError(f"targets must be 1-D, got shape {t.shape}")
    if epsilon < 0:
        raise ValueError(f"epsilon must be >= 0, got {epsilon}")
    n = len(t)
    Y2 = np.concatenate([np.ones(n, np.int32), -np.ones(n, np.int32)])
    z = np.concatenate([t - epsilon, t + epsilon])
    return Y2, z


def collapse_duals(beta: np.ndarray) -> np.ndarray:
    """Signed dual coefficients coef = alpha - alpha* from the 2n betas."""
    beta = np.asarray(beta)
    if beta.ndim != 1 or beta.shape[0] % 2:
        raise ValueError(
            f"expected a flat 2n dual vector, got shape {beta.shape}"
        )
    n = beta.shape[0] // 2
    return beta[:n] - beta[n:]
