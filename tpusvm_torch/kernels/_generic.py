"""The dot-plus-epilogue structure the poly and sigmoid families share:
one matmul forms the dots (full f32, or the rung `precision` names for the
K-row refresh and the f-update), a pointwise epilogue maps them to kernel
values. No primal collapse exists for a nonlinear epilogue, so
the f-update is the generic blocked path: a (block, q) tile a step, never
the (n, q) slab."""

from __future__ import annotations

from typing import Callable

import torch

from tpusvm_torch.ops.rbf import check_full_f32, coef_matvec, matmul_p

Epilogue = Callable[[torch.Tensor], torch.Tensor]


def rows_at(X: torch.Tensor, idx: torch.Tensor, epi: Epilogue,
            precision=None) -> torch.Tensor:
    return epi(matmul_p(X[idx], X.T, precision))


def cross(XA: torch.Tensor, XB: torch.Tensor, epi: Epilogue) -> torch.Tensor:
    check_full_f32(XA)
    return epi(XA @ XB.T)


def cross_matvec(X: torch.Tensor, XB: torch.Tensor, coef: torch.Tensor,
                 epi: Epilogue, block: int, precision=None) -> torch.Tensor:
    n = X.shape[0]
    coef = coef.to(X.dtype)
    out = torch.empty(n, dtype=X.dtype, device=X.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = coef_matvec(
            epi(matmul_p(X[start:stop], XB.T, precision)), coef, precision)
    return out
