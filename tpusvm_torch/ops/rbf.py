"""RBF kernel primitives as plain torch ops, at full f32 unless asked.

The dot form exp(-g (|x|^2 + |z|^2 - 2 x.z)), with the squared distance
clamped at 0 against cancellation. The reference runs these contractions
at full f32 (Precision.HIGHEST); on a CUDA device a float32 matmul is full
f32 only while torch.backends.cuda.matmul.allow_tf32 is False, so every
function here refuses to run on CUDA with TF32 switched on (TF32 keeps ~3
decimal digits: a speed rung, never the default).

The speed rungs are asked for by name, per call, through `matmul_p` (the
streamed contraction of the blocked f-update and the K-row refresh) and
`coef_matvec`, with the tokens of config.resolve_matmul_precision; the
flags a rung needs are switched for that one product and restored.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from tpusvm_torch.config import BF16_RUNGS, RAW_BF16, resolve_matmul_precision


def check_full_f32(t: torch.Tensor) -> None:
    """Raise if a CUDA matmul on `t` would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: float32 "
            "matmuls would run in TF32, but the RBF contractions run at "
            "full f32 (set torch.backends.cuda.matmul.allow_tf32 = False)"
        )


@contextlib.contextmanager
def _matmul_flags(allow_tf32: bool):
    """torch.backends.cuda.matmul's TF32 switch set for one product, and
    bf16 reduced-precision reductions off; both restored afterwards, so
    the trust tier everywhere else is untouched."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    try:
        m.allow_tf32 = allow_tf32
        m.allow_bf16_reduced_precision_reduction = False
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def _bf16_product(Ab: torch.Tensor, Bb: torch.Tensor) -> torch.Tensor:
    """Ab @ Bb of bfloat16 operands with the f32 accumulator kept as the
    output (JAX's preferred_element_type=float32), never rounded to bf16.

    On a CUDA card: cuBLAS's bf16 product with a float32 output
    (torch.mm(..., out_dtype=float32)). On the CPU, where torch has no such
    product, and as its plain version: the operands upcast and multiplied
    at full f32. A bf16 x bf16 product is exact in f32, so the two differ
    only in the order of the f32 sums."""
    if Ab.is_cuda and Ab.dim() == 2 and Bb.dim() == 2:
        return torch.mm(Ab, Bb, out_dtype=torch.float32)
    return Ab.float() @ Bb.float()


def matmul_p(A: torch.Tensor, B: torch.Tensor, precision=None) -> torch.Tensor:
    """A @ B at the requested precision rung (A 2-d, B 2-d or 1-d):

      "float32"/"highest": full f32, the trust tier;
      "bf16_f32":  the operands rounded to bfloat16, the products summed in
        f32 and returned in f32 (`_bf16_product`);
      "bf16_f32c": the same plus the residual of the LEFT operand (the
        streamed X block), (A - bf16(A)) @ bf16(B);
      RAW_BF16: the backend's single pass: TF32 on a CUDA card (switched on
        for this product only), plain f32 on the CPU.
    """
    p = resolve_matmul_precision(precision)
    if p in BF16_RUNGS:
        vec = B.dim() == 1
        Bm = B[:, None] if vec else B
        with _matmul_flags(False):
            Ab = A.to(torch.bfloat16)
            Bb = Bm.to(torch.bfloat16)
            out = _bf16_product(Ab, Bb)
            if p == "bf16_f32c":
                resid = (A.float() - Ab.float()).to(torch.bfloat16)
                out = out + _bf16_product(resid, Bb)
        return out[:, 0] if vec else out
    if p == RAW_BF16:
        with _matmul_flags(A.is_cuda):
            return A @ B
    check_full_f32(A)
    return A @ B


def sq_norms(X: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms |x_i|^2, shape (n,)."""
    return (X * X).sum(dim=1)


def coef_matvec(K: torch.Tensor, coef: torch.Tensor,
                precision=None) -> torch.Tensor:
    """K @ coef, the coefficient epilogue of every kernel contraction: at
    full f32 on every rung but an explicit RAW_BF16 (it is O(rows * q),
    noise next to the streamed contraction, so rounding it buys nothing)."""
    if resolve_matmul_precision(precision) == RAW_BF16:
        return matmul_p(K, coef, RAW_BF16)
    check_full_f32(K)
    return K @ coef


def rbf_rows_at(X: torch.Tensor, idx: torch.Tensor, gamma,
                sn: Optional[torch.Tensor] = None,
                precision=None) -> torch.Tensor:
    """K(X[idx[k]], X[j]) for a small index vector idx, shape (len(idx), n).

    The dot form with the row norms: (sn_i + sn_j) - 2 x_i.x_j, clamped at
    0 against cancellation, then exp(-gamma d2). Pass sn = sq_norms(X) to
    skip re-reading X for the norms. The dots go through `matmul_p` (the
    K-row refresh is a laddered contraction); the norms stay at full f32.
    """
    if sn is None:
        sn = sq_norms(X)
    d2 = sn[idx][:, None] + sn[None, :] - 2.0 * matmul_p(X[idx], X.T,
                                                         precision)
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
                     block: int = 8192, precision=None) -> torch.Tensor:
    """sum_k coef_k K(x_i, xb_k) for all i, blocked over i. Shape (n,).

    The blocked solver's error-vector update f += K(X, X_B) @ dcoef: one
    (block, q) kernel slab at a time, so the (n, q) slab is never whole.
    coef is cast to X's dtype; pass sn = sq_norms(X) when calling in a loop.
    precision: the rung of the distance contraction (`matmul_p`) and of
    the coefficient epilogue (`coef_matvec`); the norms stay at full f32.
    """
    n = X.shape[0]
    if sn is None:
        sn = sq_norms(X)
    snB = sq_norms(XB)
    coef = coef.to(X.dtype)
    out = torch.empty(n, dtype=X.dtype, device=X.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        d2 = (sn[start:stop, None] + snB[None, :]
              - 2.0 * matmul_p(X[start:stop], XB.T, precision))
        K = torch.exp(-gamma * torch.clamp_min(d2, 0.0))
        out[start:stop] = coef_matvec(K, coef, precision)
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
