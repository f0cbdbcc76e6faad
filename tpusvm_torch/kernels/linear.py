"""Linear kernel K(x, z) = x.z, with the primal fast path.

No row norms and no epilogue: every computation is one matmul over X, at
full f32 but for the f-update and the K-row refresh, which take the rung
`precision` names (ops/rbf.py:matmul_p). The blocked f-update K(X, X_B) @ coef collapses to the primal
form X @ (X_B^T coef): fold the coefficients into one (d,) weight first,
then one (n, d) x (d,) matvec, with no (block, q) kernel slab. The generic
blocked path (fast=False) is kept as the control arm and computes the same
sum in another association.
"""

from __future__ import annotations

import torch

from tpusvm_torch.config import BF16_RUNGS
from tpusvm_torch.ops.rbf import check_full_f32, coef_matvec, matmul_p


def linear_row(X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K(x, X[j]) for all j. Shape (n,)."""
    check_full_f32(X)
    return X @ x


def linear_rows_at(X: torch.Tensor, idx: torch.Tensor,
                   precision=None) -> torch.Tensor:
    """K(X[idx[k]], X[j]) as one (k, d) x (d, n) matmul. Shape (k, n)."""
    return matmul_p(X[idx], X.T, precision)


def linear_cross(XA: torch.Tensor, XB: torch.Tensor) -> torch.Tensor:
    """Full K(XA, XB) = XA @ XB^T, shape (nA, nB)."""
    check_full_f32(XA)
    return XA @ XB.T


def linear_cross_matvec(X: torch.Tensor, XB: torch.Tensor, coef: torch.Tensor,
                        *, block: int = 8192, fast: bool = True,
                        precision=None) -> torch.Tensor:
    """sum_k coef_k (x_i . xb_k) for all i. Shape (n,).

    fast=True: X @ (XB^T coef), O(q*d + n*d) flops and no slab; the (d,)
    weight stays at full f32 on the bf16 rungs (it is O(q*d), not the
    streamed contraction). fast=False: the generic blocked path, a
    (block, q) slab a step.
    """
    coef = coef.to(X.dtype)
    if fast:
        w_prec = None if precision in BF16_RUNGS else precision
        w = matmul_p(XB.T, coef, w_prec)
        return matmul_p(X, w, precision).to(X.dtype)
    n = X.shape[0]
    out = torch.empty(n, dtype=X.dtype, device=X.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = coef_matvec(matmul_p(X[start:stop], XB.T, precision),
                                      coef, precision)
    return out


def linear_matvec(X: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """sum_j coef_j (x_j . x_i) for all i = X @ (X^T coef). Shape (n,)."""
    return linear_cross_matvec(X, X, coef, fast=True)
