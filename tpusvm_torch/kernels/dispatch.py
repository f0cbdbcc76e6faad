"""Kernel-family dispatch: the solvers' only kernel touchpoint.

The SMO machinery touches the kernel through four computations: a K-row
batch for the selected indices (`rows_at`), the working-set matrix K_BB
(`cross`), the blocked f-update K(X, X_B) @ coef (`cross_matvec`) and the
warm-start reconstruction K @ coef (`matvec`). Each is routed by the
family name, as `tpusvm/kernels/dispatch.py` routes it:

  - "rbf":     ops/rbf.py, the dot form with row norms;
  - "linear":  x.z, no norms, and the primal fast path for the f-update;
  - "poly":    (gamma x.z + coef0) ** degree;
  - "sigmoid": tanh(gamma x.z + coef0);
  - "rff" / "nystrom": the approximate families, whose X is the already
    mapped feature matrix, so they route through the linear family. The
    maps themselves are not ported yet: the model layer refuses them.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpusvm_torch.config import APPROX_FAMILIES, KERNEL_FAMILIES
from tpusvm_torch.kernels import linear as _lin
from tpusvm_torch.kernels import poly as _poly
from tpusvm_torch.kernels import sigmoid as _sig
from tpusvm_torch.ops import rbf as _rbf


def validate_family(family: str) -> str:
    if family not in KERNEL_FAMILIES:
        raise ValueError(
            f"unknown kernel family {family!r}; supported: "
            f"{list(KERNEL_FAMILIES)}"
        )
    return family


def is_approx(family: str) -> bool:
    """Whether the family works on an explicit approximate feature map."""
    return validate_family(family) in APPROX_FAMILIES


def needs_norms(family: str) -> bool:
    """Whether the family consumes per-row squared norms (RBF only)."""
    return validate_family(family) == "rbf"


def sq_norms_for(family: str, X: torch.Tensor) -> Optional[torch.Tensor]:
    """sq_norms(X) for RBF, None for every other family."""
    return _rbf.sq_norms(X) if needs_norms(family) else None


def _linear_like(family: str) -> bool:
    return family == "linear" or family in APPROX_FAMILIES


def rows_at(family: str, X: torch.Tensor, idx: torch.Tensor, *, gamma,
            coef0=0.0, degree: int = 3, sn: Optional[torch.Tensor] = None,
            precision=None) -> torch.Tensor:
    """K(X[idx[k]], X[j]) for a small index vector. Shape (k, n).
    precision: the dots' rung (ops/rbf.py:matmul_p)."""
    if family == "rbf":
        return _rbf.rbf_rows_at(X, idx, gamma, sn, precision)
    if _linear_like(family):
        return _lin.linear_rows_at(X, idx, precision)
    if family == "sigmoid":
        return _sig.sigmoid_rows_at(X, idx, gamma, coef0, precision)
    validate_family(family)
    return _poly.poly_rows_at(X, idx, gamma, coef0, degree, precision)


def cross(family: str, XA: torch.Tensor, XB: torch.Tensor, *, gamma,
          coef0=0.0, degree: int = 3, snA: Optional[torch.Tensor] = None,
          snB: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full K(XA, XB), shape (nA, nB)."""
    if family == "rbf":
        return _rbf.rbf_cross(XA, XB, gamma, snA, snB)
    if _linear_like(family):
        return _lin.linear_cross(XA, XB)
    if family == "sigmoid":
        return _sig.sigmoid_cross(XA, XB, gamma, coef0)
    validate_family(family)
    return _poly.poly_cross(XA, XB, gamma, coef0, degree)


def cross_matvec(family: str, X: torch.Tensor, XB: torch.Tensor,
                 coef: torch.Tensor, *, gamma, coef0=0.0, degree: int = 3,
                 sn: Optional[torch.Tensor] = None, block: int = 8192,
                 fast: bool = True, precision=None) -> torch.Tensor:
    """sum_k coef_k K(x_i, xb_k) for all i: the blocked f-update. (n,).

    `fast` selects the linear families' primal form (True) or their
    generic blocked path (False); other families ignore it. precision:
    the contraction's rung (ops/rbf.py:matmul_p).
    """
    if family == "rbf":
        return _rbf.rbf_cross_matvec(X, XB, coef, gamma, sn, block,
                                     precision)
    if _linear_like(family):
        return _lin.linear_cross_matvec(X, XB, coef, block=block, fast=fast,
                                        precision=precision)
    if family == "sigmoid":
        return _sig.sigmoid_cross_matvec(X, XB, coef, gamma, coef0,
                                         block=block, precision=precision)
    validate_family(family)
    return _poly.poly_cross_matvec(X, XB, coef, gamma, coef0, degree,
                                   block=block, precision=precision)


def matvec(family: str, X: torch.Tensor, coef: torch.Tensor, *, gamma,
           coef0=0.0, degree: int = 3, block: int = 1024) -> torch.Tensor:
    """sum_j coef_j K(x_j, x_i) for all i: the warm-start f. (n,)."""
    if family == "rbf":
        return _rbf.rbf_matvec(X, coef, gamma, block)
    if _linear_like(family):
        return _lin.linear_matvec(X, coef)
    if family == "sigmoid":
        return _sig.sigmoid_matvec(X, coef, gamma, coef0, block=block)
    validate_family(family)
    return _poly.poly_matvec(X, coef, gamma, coef0, degree, block=block)
