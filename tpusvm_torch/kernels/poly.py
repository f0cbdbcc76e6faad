"""Polynomial kernel K(x, z) = (gamma * x.z + coef0) ** degree.

The linear family's matmuls with a pointwise affine + integer-power
epilogue. The power is taken as jax.lax.integer_pow expands it (square and
multiply, low bit first: x**3 = x * (x*x)), so the port rounds the power
as the JAX package's traced program does; torch.pow with an integer
exponent may differ from that in the last place.
"""

from __future__ import annotations

import torch

from tpusvm_torch.kernels import _generic


def integer_pow(x: torch.Tensor, degree: int) -> torch.Tensor:
    """x ** degree for an int degree >= 1, by lax.integer_pow's steps."""
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    acc = None
    y = degree
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _epilogue(gamma, coef0, degree: int):
    return lambda dots: integer_pow(gamma * dots + coef0, degree)


def poly_row(X: torch.Tensor, x: torch.Tensor, gamma, coef0,
             degree: int) -> torch.Tensor:
    """K(x, X[j]) for all j. Shape (n,)."""
    return _generic.cross(X, x[None, :], _epilogue(gamma, coef0, degree))[:, 0]


def poly_rows_at(X: torch.Tensor, idx: torch.Tensor, gamma, coef0,
                 degree: int, precision=None) -> torch.Tensor:
    """K(X[idx[k]], X[j]) via one (k, d) x (d, n) matmul. Shape (k, n)."""
    return _generic.rows_at(X, idx, _epilogue(gamma, coef0, degree),
                            precision)


def poly_cross(XA: torch.Tensor, XB: torch.Tensor, gamma, coef0,
               degree: int) -> torch.Tensor:
    """Full K(XA, XB), shape (nA, nB)."""
    return _generic.cross(XA, XB, _epilogue(gamma, coef0, degree))


def poly_cross_matvec(X: torch.Tensor, XB: torch.Tensor, coef: torch.Tensor,
                      gamma, coef0, degree: int, *,
                      block: int = 8192, precision=None) -> torch.Tensor:
    """sum_k coef_k K(x_i, xb_k) for all i, blocked over i. Shape (n,)."""
    return _generic.cross_matvec(X, XB, coef, _epilogue(gamma, coef0, degree),
                                 block, precision)


def poly_matvec(X: torch.Tensor, coef: torch.Tensor, gamma, coef0,
                degree: int, *, block: int = 1024) -> torch.Tensor:
    """sum_j coef_j K(x_j, x_i) for all i. Shape (n,)."""
    return poly_cross_matvec(X, X, coef, gamma, coef0, degree, block=block)
