"""RBF kernel primitives as plain torch ops, at full f32.

The dot form exp(-g (|x|^2 + |z|^2 - 2 x.z)), with the squared distance
clamped at 0 against cancellation. The reference runs these contractions
at full f32 (Precision.HIGHEST); on a CUDA device a float32 matmul is full
f32 only while torch.backends.cuda.matmul.allow_tf32 is False, so every
function here refuses to run on CUDA with TF32 switched on (TF32 keeps ~3
decimal digits: a speed rung, never the default).
"""

from __future__ import annotations

from typing import Optional

import torch


def check_full_f32(t: torch.Tensor) -> None:
    """Raise if a CUDA matmul on `t` would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: float32 "
            "matmuls would run in TF32, but the RBF contractions run at "
            "full f32 (set torch.backends.cuda.matmul.allow_tf32 = False)"
        )


def sq_norms(X: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms |x_i|^2, shape (n,)."""
    return (X * X).sum(dim=1)


def coef_matvec(K: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """K @ coef, the coefficient epilogue of every kernel contraction."""
    check_full_f32(K)
    return K @ coef


def rbf_rows_at(X: torch.Tensor, idx: torch.Tensor, gamma,
                sn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K(X[idx[k]], X[j]) for a small index vector idx, shape (len(idx), n).

    The dot form with the row norms: (sn_i + sn_j) - 2 x_i.x_j, clamped at
    0 against cancellation, then exp(-gamma d2). Pass sn = sq_norms(X) to
    skip re-reading X for the norms.
    """
    check_full_f32(X)
    if sn is None:
        sn = sq_norms(X)
    d2 = sn[idx][:, None] + sn[None, :] - 2.0 * (X[idx] @ X.T)
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


def rbf_cross(XA: torch.Tensor, XB: torch.Tensor, gamma,
              snA: Optional[torch.Tensor] = None,
              snB: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full K(XA, XB) kernel matrix, shape (nA, nB)."""
    check_full_f32(XA)
    if snA is None:
        snA = sq_norms(XA)
    if snB is None:
        snB = sq_norms(XB)
    d2 = snA[:, None] + snB[None, :] - 2.0 * (XA @ XB.T)
    d2 = torch.clamp_min(d2, 0.0)
    return torch.exp(-gamma * d2)


def rbf_cross_matvec(X: torch.Tensor, XB: torch.Tensor, coef: torch.Tensor,
                     gamma, sn: Optional[torch.Tensor] = None,
                     block: int = 8192) -> torch.Tensor:
    """sum_k coef_k K(x_i, xb_k) for all i, blocked over i. Shape (n,).

    The blocked solver's error-vector update f += K(X, X_B) @ dcoef: one
    (block, q) kernel slab at a time, so the (n, q) slab is never whole.
    coef is cast to X's dtype; pass sn = sq_norms(X) when calling in a loop.
    """
    n = X.shape[0]
    if sn is None:
        sn = sq_norms(X)
    snB = sq_norms(XB)
    coef = coef.to(X.dtype)
    out = torch.empty(n, dtype=X.dtype, device=X.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        K = rbf_cross(X[start:stop], XB, gamma, sn[start:stop], snB)
        out[start:stop] = coef_matvec(K, coef)
    return out


def rbf_matvec(X: torch.Tensor, coef: torch.Tensor, gamma,
               block: int = 1024) -> torch.Tensor:
    """sum_j coef_j K(x_j, x_i) for all i, without the (n, n) matrix.

    The warm-start f reconstruction: one (n, block) kernel slab per step
    over blocks of j, accumulated in X's dtype. Shape (n,).
    """
    n = X.shape[0]
    sn = sq_norms(X)
    coef = coef.to(X.dtype)
    acc = torch.zeros(n, dtype=X.dtype, device=X.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        K = rbf_cross(X, X[start:stop], gamma, sn, sn[start:stop])
        acc = acc + coef_matvec(K, coef[start:stop])
    return acc
