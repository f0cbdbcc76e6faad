"""Batched prediction: sign(sum_j coef_j K(x, x_j) - b), any exact family.

One blocked matmul per test block, K(X_test_blk, X_train) @ coef through
kernels.cross, so the (m, n_train) kernel matrix is never whole. The
contractions are torch.matmul at full f32. Classification scores and
epsilon-SVR values are the same sum. Sign convention: strict `> 0 -> +1`,
the serial reference's.

Every block is a full `block` rows: the rows are zero-padded up to a
multiple of `block` and the padding's scores are dropped. BLAS on the CPU
and cuBLAS on the card choose their kernels, and with them the summation
order, by the product's shape, so a row's score would otherwise depend on
how many rows were scored with it. With one shape for every call a row's
score is the same bits whether it comes alone, in a served bucket or in an
offline call over thousands of rows (the serving contract, serve/).
"""

from __future__ import annotations

import torch

from tpusvm_torch import kernels
from tpusvm_torch.ops.rbf import coef_matvec


def decision_function(X_test: torch.Tensor, X_train: torch.Tensor,
                      coef: torch.Tensor, b, *, gamma: float,
                      block: int = 2048, kernel: str = "rbf",
                      degree: int = 3, coef0: float = 0.0) -> torch.Tensor:
    """f(x) = sum_j coef_j K(x, x_j) - b for each test row. Shape (m,),
    or (m, K) for a (n_train, K) coef (one column a head)."""
    m = X_test.shape[0]
    Xp = pad_rows(X_test, block)
    sn_train = kernels.sq_norms_for(kernel, X_train)
    out = torch.empty((Xp.shape[0],) + tuple(coef.shape[1:]),
                      dtype=X_test.dtype, device=X_test.device)
    for start in range(0, Xp.shape[0], block):
        K = kernels.cross(kernel, Xp[start:start + block], X_train,
                          gamma=gamma, coef0=coef0, degree=degree,
                          snB=sn_train)
        out[start:start + block] = coef_matvec(K, coef)
    return out[:m] - b


def pad_rows(X: torch.Tensor, block: int) -> torch.Tensor:
    """X with zero rows appended up to a multiple of `block` rows (at
    least one block)."""
    pad = block * max(1, -(-X.shape[0] // block)) - X.shape[0]
    if pad == 0:
        return X
    return torch.cat([X, X.new_zeros((pad,) + tuple(X.shape[1:]))])


def predict(X_test: torch.Tensor, X_train: torch.Tensor,
            Y_train: torch.Tensor, alpha: torch.Tensor, b, *, gamma: float,
            sv_tol: float = 1e-8, block: int = 2048, kernel: str = "rbf",
            degree: int = 3, coef0: float = 0.0) -> torch.Tensor:
    """Labels in {+1, -1}; strict > 0 -> +1.

    Alphas at or below sv_tol are zeroed before the sum, so the score is
    the support-vector-only sum exactly.
    """
    a = torch.where(alpha > sv_tol, alpha, torch.zeros_like(alpha))
    coef = a * Y_train.to(X_train.dtype)
    scores = decision_function(X_test, X_train, coef.to(X_train.dtype), b,
                               gamma=gamma, block=block, kernel=kernel,
                               degree=degree, coef0=coef0)
    return torch.where(scores > 0, 1, -1).to(torch.int32)
