"""The dot-plus-epilogue structure the poly and sigmoid families share:
one full-f32 matmul forms the dots, a pointwise epilogue maps them to
kernel values. No primal collapse exists for a nonlinear epilogue, so
the f-update is the generic blocked path: a (block, q) tile a step, never
the (n, q) slab."""

from __future__ import annotations

from typing import Callable

import torch

from tpusvm_torch.ops.rbf import check_full_f32, coef_matvec

Epilogue = Callable[[torch.Tensor], torch.Tensor]


def rows_at(X: torch.Tensor, idx: torch.Tensor, epi: Epilogue) -> torch.Tensor:
    check_full_f32(X)
    return epi(X[idx] @ X.T)


def cross(XA: torch.Tensor, XB: torch.Tensor, epi: Epilogue) -> torch.Tensor:
    check_full_f32(XA)
    return epi(XA @ XB.T)


def cross_matvec(X: torch.Tensor, XB: torch.Tensor, coef: torch.Tensor,
                 epi: Epilogue, block: int) -> torch.Tensor:
    check_full_f32(X)
    n = X.shape[0]
    coef = coef.to(X.dtype)
    out = torch.empty(n, dtype=X.dtype, device=X.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = coef_matvec(epi(X[start:stop] @ XB.T), coef)
    return out
