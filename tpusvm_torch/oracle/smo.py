"""Serial SMO oracle in NumPy — the in-tree correctness anchor.

The port's copy of the JAX package's tpusvm/oracle/smo.py, on the port's
own SVMConfig and Status (numpy only, so no device is involved); its
results equal the original's bit for bit.

This mirrors the reference's serial solver (SMO_train, main3.cpp:162-294) with
the Keerthi first-order working-set heuristic, including every numerical
constant and tie-breaking rule, but written as the golden model for the
on-device solvers rather than as a performance path:

  - f initialised to -y (main3.cpp:171-172); optional warm start reconstructs
    f_i = sum_j alpha_j y_j K(x_j, x_i) - y_i like the cascade's
    SMO_train(init=false) (mpi_svm_main3.cpp:156-186).
  - i_high = argmin f over I_high = {y=+1, a<C-eps} u {y=-1, a>eps};
    i_low = argmax f over I_low (mirror sets); first-occurrence tie-break,
    identical to the reference's strict-improvement scan (main3.cpp:107-142).
  - stop when b_low <= b_high + 2*tau (main3.cpp:213).
  - kernel rows cached and recomputed only when the selected index changes
    (main3.cpp:191-232).
  - analytic 2-variable update with box [U, V] from s = y_h*y_l
    (calculate_U_V, main3.cpp:145-159), eta = K11+K22-2*K12 with
    eta <= eps bail-out, clip, paired alpha_high update (main3.cpp:234-279).
  - f update f_i += da_h y_h K_h[i] + da_l y_l K_l[i] (main3.cpp:271-275).
  - b = (b_high + b_low)/2 on exit (main3.cpp:291).

The iteration counter matches the reference exactly: it starts at 1 and
counts successful updates + 1 (main3.cpp:197, :281).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.kernels.svr import doubled_problem
from tpusvm_torch.status import Status


class OracleResult(NamedTuple):
    alpha: np.ndarray
    b: float
    b_high: float
    b_low: float
    n_iter: int
    status: Status


def rbf_row(X: np.ndarray, x: np.ndarray, gamma: float) -> np.ndarray:
    """K(x, X[j]) for all j: exp(-gamma * ||x - X[j]||^2) (main3.cpp:92-104)."""
    diff = X - x
    return np.exp(-gamma * np.einsum("ij,ij->i", diff, diff))


def kernel_row(X: np.ndarray, x: np.ndarray, config: SVMConfig) -> np.ndarray:
    """K(x, X[j]) for all j under the config's kernel family.

    The oracle's single kernel touchpoint, mirroring kernels/dispatch.py:
    "rbf" keeps the reference's per-pair formulation byte-for-byte;
    "linear"/"poly"/"sigmoid" are the dot forms in f64. The approximate
    families have no oracle kernel by design — their parity anchor is
    the EXACT rbf oracle on the same instance (the accuracy-delta gate
    of benchmarks/fuzz_parity.py mode 'rff'), so an approx family name
    reaching this function is a harness bug, not a fallback case.
    """
    if config.kernel == "linear":
        return X @ x
    if config.kernel == "poly":
        return (config.gamma * (X @ x) + config.coef0) ** config.degree
    if config.kernel == "sigmoid":
        return np.tanh(config.gamma * (X @ x) + config.coef0)
    if config.kernel != "rbf":
        raise ValueError(
            f"the NumPy oracle has no kernel {config.kernel!r} "
            "(approximate families are gated against the exact rbf "
            "oracle, not re-implemented here)"
        )
    return rbf_row(X, x, config.gamma)


def _masked_argmin(f: np.ndarray, mask: np.ndarray) -> int:
    """First index of the minimum of f over mask; -1 if mask empty.

    Equivalent to the reference's strict-improvement scan (main3.cpp:113-121):
    both take the FIRST occurrence of the minimum.
    """
    if not mask.any():
        return -1
    vals = np.where(mask, f, np.inf)
    return int(np.argmin(vals))


def _masked_argmax(f: np.ndarray, mask: np.ndarray) -> int:
    if not mask.any():
        return -1
    vals = np.where(mask, f, -np.inf)
    return int(np.argmax(vals))


def smo_train(
    X: np.ndarray,
    Y: np.ndarray,
    config: SVMConfig = SVMConfig(),
    alpha0: Optional[np.ndarray] = None,
    warm_start: bool = False,
    targets: Optional[np.ndarray] = None,
) -> OracleResult:
    """Train a binary SVM with serial SMO. Returns (alpha, b, ...).

    Args:
      X: (n, d) float64 scaled features.
      Y: (n,) labels in {+1, -1}.
      config: hyperparameters (defaults = reference constants); the kernel
        family/params come from config.kernel/degree/coef0 (kernel_row).
      alpha0: initial dual variables; zeros if None.
      warm_start: if True, reconstruct f from alpha0 (cascade semantics,
        mpi_svm_main3.cpp:156-186); if False alpha0 must be zeros and f = -y.
      targets: optional pseudo-target vector z replacing the labels in
        f_i = sum_j a_j y_j K_ij - z_i (the epsilon-SVR doubling,
        kernels/svr.py; None = z = Y, classification).
    """
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y)
    n = len(Y)
    C, eps, tau = config.C, config.eps, config.tau
    z = (Y.astype(np.float64) if targets is None
         else np.asarray(targets, np.float64))

    if alpha0 is None:
        alpha = np.zeros(n, np.float64)
    else:
        alpha = np.array(alpha0, np.float64, copy=True)

    if warm_start:
        # f_i = sum_j alpha_j y_j K(x_j, x_i) - z_i; only alpha != 0 contribute
        # (mpi_svm_main3.cpp:160-186 skips alpha_j == 0 as an optimisation —
        # algebraically identical to the full sum).
        f = np.empty(n, np.float64)
        nz = np.nonzero(alpha)[0]
        coef = alpha[nz] * Y[nz]
        for i in range(n):
            if len(nz):
                k = kernel_row(X[nz], X[i], config)
                f[i] = float(coef @ k) - float(z[i])
            else:
                f[i] = -float(z[i])
    else:
        f = -z.copy()

    pos = Y == 1
    i_high_prev = -1
    i_low_prev = -1
    k_high = np.zeros(n, np.float64)
    k_low = np.zeros(n, np.float64)
    b_high = np.nan
    b_low = np.nan

    n_iter = 1
    status = Status.RUNNING
    while status == Status.RUNNING:
        in_high = np.where(pos, alpha < C - eps, alpha > eps)
        in_low = np.where(pos, alpha > eps, alpha < C - eps)
        i_high = _masked_argmin(f, in_high)
        i_low = _masked_argmax(f, in_low)
        if i_high < 0 or i_low < 0:
            status = Status.NO_WORKING_SET
            break
        b_high = float(f[i_high])
        b_low = float(f[i_low])
        if b_low <= b_high + 2.0 * tau:
            status = Status.CONVERGED
            break

        if i_high != i_high_prev:
            i_high_prev = i_high
            k_high = kernel_row(X, X[i_high], config)
        if i_low != i_low_prev:
            i_low_prev = i_low
            k_low = kernel_row(X, X[i_low], config)

        s = int(Y[i_high]) * int(Y[i_low])
        K11 = k_high[i_high]
        K22 = k_low[i_low]
        K12 = k_high[i_low]
        eta = K11 + K22 - 2.0 * K12

        if s == -1:
            U = max(0.0, alpha[i_low] - alpha[i_high])
            V = min(C, C + alpha[i_low] - alpha[i_high])
        else:
            U = max(0.0, alpha[i_low] + alpha[i_high] - C)
            V = min(C, alpha[i_low] + alpha[i_high])
        if U > V + 1e-12:
            status = Status.INFEASIBLE_UV
            break
        if eta <= eps:
            status = Status.NONPOS_ETA
            break

        a_low_new = alpha[i_low] + Y[i_low] * (b_high - b_low) / eta
        # reference clip order: cap at V first, then floor at U (main3.cpp:261-264)
        a_low_new = max(min(a_low_new, V), U)
        a_high_new = alpha[i_high] + s * (alpha[i_low] - a_low_new)

        da_high = a_high_new - alpha[i_high]
        da_low = a_low_new - alpha[i_low]
        f += da_high * Y[i_high] * k_high + da_low * Y[i_low] * k_low
        alpha[i_high] = a_high_new
        alpha[i_low] = a_low_new

        n_iter += 1
        if da_high == 0.0 and da_low == 0.0:
            # zero-change update: the same pair would be re-selected forever
            # (the reference would spin to max_iter here); see Status.STALLED
            status = Status.STALLED
            break
        if n_iter > config.max_iter:
            status = Status.MAX_ITER
            break

    b = (b_high + b_low) / 2.0
    return OracleResult(alpha, b, b_high, b_low, n_iter, status)


def svr_train(
    X: np.ndarray,
    t: np.ndarray,
    config: SVMConfig = SVMConfig(),
) -> OracleResult:
    """Serial epsilon-SVR oracle: the 2n-variable doubling through smo_train.

    Builds the doubled problem (kernels.svr.doubled_problem: labels
    [+1]*n + [-1]*n, pseudo-targets t -/+ config.epsilon) over [X; X] and
    runs the UNCHANGED classification SMO skeleton on it. The returned
    alpha is the raw 2n beta vector; collapse with
    kernels.svr.collapse_duals for the signed prediction coefficients
    alpha_i - alpha*_i.
    """
    X = np.asarray(X, np.float64)
    Y2, z = doubled_problem(t, config.epsilon)
    return smo_train(np.concatenate([X, X]), Y2, config, targets=z)


def get_sv_indices(alpha: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """Indices with alpha > tol (main3.cpp:297-304)."""
    return np.nonzero(alpha > tol)[0]


def predict(
    X_test: np.ndarray,
    X_train: np.ndarray,
    Y_train: np.ndarray,
    alpha: np.ndarray,
    b: float,
    gamma: float,
    sv_tol: float = 1e-8,
) -> np.ndarray:
    """sign(sum_{k in SV} a_k y_k K(x, x_k) - b), strict >0 -> +1 (main3.cpp:391-402).

    Vectorised blockwise (a per-row Python loop makes mid-scale parity
    runs needlessly slow): squared distances via the
    norms+dot identity ||x-z||^2 = ||x||^2 + ||z||^2 - 2 x.z in float64,
    clamped at 0 — the same formulation as the framework's device kernels
    (ops/rbf.py), here with f64 accumulation so cancellation stays at the
    1e-12 level. The decision rule (strict >0 -> +1) is unchanged; scores
    can move by ~1ulp vs the old per-row diff loop, which only matters on
    an exactly-zero margin (measure zero on real data). Memory is bounded
    by blocking the test rows (~2e7 kernel entries per block)."""
    sv = get_sv_indices(alpha, sv_tol)
    # select SV rows first, THEN cast: avoids a full-size f64 copy of a
    # large f32 training matrix when only the m SV rows are needed
    Xsv = np.asarray(X_train)[sv].astype(np.float64)
    coef = np.asarray(alpha, np.float64)[sv] * np.asarray(Y_train)[sv]
    preds = np.empty(len(X_test), np.int32)
    m = len(sv)
    if m == 0:
        preds[:] = 1 if -b > 0 else -1  # empty SV sum: score = -b
        return preds
    sv_sq = np.einsum("kj,kj->k", Xsv, Xsv)
    block = max(1, int(2e7) // m)
    for s0 in range(0, len(X_test), block):
        # cast per block so a huge f32 test set is never duplicated whole
        B = np.asarray(X_test[s0:s0 + block], np.float64)
        d2 = (
            np.einsum("ij,ij->i", B, B)[:, None]
            + sv_sq[None, :]
            - 2.0 * (B @ Xsv.T)
        )
        scores = np.exp(-gamma * np.maximum(d2, 0.0)) @ coef - b
        preds[s0:s0 + block] = np.where(scores > 0, 1, -1)
    return preds
