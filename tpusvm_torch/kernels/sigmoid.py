"""Sigmoid kernel K(x, z) = tanh(gamma * x.z + coef0).

Poly's structure with a tanh epilogue. The kernel is only conditionally
positive semi-definite; SMO still runs (pairs with eta <= eps are
excluded as everywhere else). torch's tanh and XLA's may differ in the
last place, so the two packages agree on sigmoid values to f32 rounding,
not bit for bit.
"""

from __future__ import annotations

import torch

from tpusvm_torch.kernels import _generic


def _epilogue(gamma, coef0):
    return lambda dots: torch.tanh(gamma * dots + coef0)


def sigmoid_row(X: torch.Tensor, x: torch.Tensor, gamma, coef0) -> torch.Tensor:
    """K(x, X[j]) for all j. Shape (n,)."""
    return _generic.cross(X, x[None, :], _epilogue(gamma, coef0))[:, 0]


def sigmoid_rows_at(X: torch.Tensor, idx: torch.Tensor, gamma,
                    coef0, precision=None) -> torch.Tensor:
    """K(X[idx[k]], X[j]) via one (k, d) x (d, n) matmul. Shape (k, n)."""
    return _generic.rows_at(X, idx, _epilogue(gamma, coef0), precision)


def sigmoid_cross(XA: torch.Tensor, XB: torch.Tensor, gamma,
                  coef0) -> torch.Tensor:
    """Full K(XA, XB), shape (nA, nB)."""
    return _generic.cross(XA, XB, _epilogue(gamma, coef0))


def sigmoid_cross_matvec(X: torch.Tensor, XB: torch.Tensor, coef: torch.Tensor,
                         gamma, coef0, *, block: int = 8192,
                         precision=None) -> torch.Tensor:
    """sum_k coef_k K(x_i, xb_k) for all i, blocked over i. Shape (n,)."""
    return _generic.cross_matvec(X, XB, coef, _epilogue(gamma, coef0), block,
                                 precision)


def sigmoid_matvec(X: torch.Tensor, coef: torch.Tensor, gamma, coef0, *,
                   block: int = 1024) -> torch.Tensor:
    """sum_j coef_j K(x_j, x_i) for all i. Shape (n,)."""
    return sigmoid_cross_matvec(X, X, coef, gamma, coef0, block=block)
