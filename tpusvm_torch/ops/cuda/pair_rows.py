"""The pair solver's K-row refresh, with the cache skip on the card.

`pair_rows_kernel(X, idx, need, rows, ...)` writes rows[r] = K(X[idx[r]], X)
for every r with need[r] set, in place, and leaves the other rows as they
are. On a CUDA tensor it launches csrc/pair_rows.cu, which reads `need` from
device memory and returns at once when no flag is set, so a captured CUDA
graph can launch it every iteration; on a CPU tensor it runs the plain
version `pair_rows_ref`. Either way the rows of one index have one set of
bits, whatever k and the other flags: the skip changes speed, not values.

No TPU kernel is replaced: the JAX package computes these rows in XLA
(`rbf_rows_at`, tpusvm/ops/rbf.py:140, and the family functions), behind
a lax.cond that the card's graph cannot take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpusvm_torch.kernels.poly import integer_pow
from tpusvm_torch.ops.cuda import _build
from tpusvm_torch.ops.rbf import check_full_f32, sq_norms

_P = ctypes.c_void_p
FAMILY_CODE = {"rbf": 0, "linear": 1, "poly": 2, "sigmoid": 3}


def _dots(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x_{idx[r]} . x_j, one matrix-vector product a row: each row's bits
    do not depend on how many rows are asked for."""
    check_full_f32(X)
    Xi = X[idx]
    return torch.stack([X @ Xi[r] for r in range(Xi.shape[0])])


def family_rows(family: str, X: torch.Tensor, idx: torch.Tensor, *, gamma,
                coef0=0.0, degree: int = 3,
                sn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K(X[idx[r]], X[j]) by the torch formulas of ops/rbf.py:rbf_rows_at
    and of kernels/{linear,poly,sigmoid}.py. Shape (k, n)."""
    dots = _dots(X, idx)
    if family == "rbf":
        if sn is None:
            sn = sq_norms(X)
        d2 = sn[idx][:, None] + sn[None, :] - 2.0 * dots
        return torch.exp(-gamma * torch.clamp_min(d2, 0.0))
    if family == "linear":
        return dots
    if family == "poly":
        return integer_pow(gamma * dots + coef0, degree)
    if family == "sigmoid":
        return torch.tanh(gamma * dots + coef0)
    raise ValueError(f"pair_rows computes the exact families "
                     f"{sorted(FAMILY_CODE)}, not {family!r}")


def pair_rows_ref(X, idx, need, rows, *, family: str = "rbf", gamma=0.00125,
                  coef0=0.0, degree: int = 3, sn=None) -> torch.Tensor:
    """Plain version: rows <- where(need, K(X[idx], X), rows), in place."""
    fresh = family_rows(family, X, idx, gamma=gamma, coef0=coef0,
                        degree=degree, sn=sn)
    rows.copy_(torch.where(need[:, None], fresh, rows))
    return rows


@functools.cache
def _bind():
    fn = _build.load("pair_rows").tpusvm_pair_rows
    fn.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, _P,
                   _P, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return fn


def _operands(X, idx, need, rows, *, family, gamma, coef0, degree, sn):
    """The C entry point's arguments but the stream, for CUDA tensors,
    after the checks it relies on."""
    if family not in FAMILY_CODE:
        raise ValueError(f"pair_rows computes the exact families "
                         f"{sorted(FAMILY_CODE)}, not {family!r}")
    n, d = X.shape
    k = idx.shape[0]
    if (X.dtype != torch.float32 or not X.is_contiguous()
            or rows.dtype != torch.float32 or tuple(rows.shape) != (k, n)
            or not rows.is_contiguous() or idx.dtype != torch.int64
            or need.dtype != torch.bool or tuple(need.shape) != (k,)
            or not idx.is_contiguous() or not need.is_contiguous()):
        raise ValueError(
            "pair_rows_kernel takes contiguous X (n, d) float32, idx (k,) "
            "int64, need (k,) bool and rows (k, n) float32")
    if family == "rbf":
        if sn is None or sn.dtype != torch.float32 or tuple(sn.shape) != (n,):
            raise ValueError("the RBF rows need sn = sq_norms(X), (n,) float32")
        sn_ptr = sn.data_ptr()
    else:
        sn_ptr = None
    for t in (idx, need, rows):
        if t.device != X.device:
            raise ValueError("all operands must be on X's device")
    if X.data_ptr() % 16 or (sn_ptr is not None and sn_ptr % 16):
        raise ValueError("pair_rows_kernel streams X and sn with 16-byte bulk "
                         "copies: both must start 16-byte aligned (pass fresh "
                         "tensors, not views at an odd offset)")
    if not 1 <= k <= 256:
        raise ValueError(f"pair_rows_kernel refreshes 1 to 256 rows, not {k}")
    return (X.data_ptr(), n, d, idx.data_ptr(), need.data_ptr(), k, sn_ptr,
            rows.data_ptr(), FAMILY_CODE[family], float(gamma), float(coef0),
            int(degree))


def pair_rows_kernel(X, idx, need, rows, *, family: str = "rbf",
                     gamma=0.00125, coef0=0.0, degree: int = 3,
                     sn=None) -> torch.Tensor:
    """rows[r] <- K(X[idx[r]], X) where need[r], in place; returns rows.

    X (n, d) float32 contiguous and 16-byte aligned, idx (k,) int64 with
    1 <= k <= 256, need (k,) bool, rows (k, n) float32 contiguous, sn (n,)
    float32 = sq_norms(X), 16-byte aligned, for RBF. CPU tensors run
    `pair_rows_ref`; CUDA tensors launch csrc/pair_rows.cu, counted in
    `.launches` (a launch recorded into a CUDA graph is counted when the
    graph is replayed, by `replay`).
    """
    kw = dict(family=family, gamma=gamma, coef0=coef0, degree=degree, sn=sn)
    if not X.is_cuda:
        return pair_rows_ref(X, idx, need, rows, **kw)
    rc = _bind()(*_operands(X, idx, need, rows, **kw),
                 torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(rc, "pair_rows kernel")
    if not torch.cuda.is_current_stream_capturing():
        pair_rows_kernel.launches += 1
    return rows


pair_rows_kernel.launches = 0


def replay(graph, launches: int) -> None:
    """Replay a CUDA graph that holds `launches` captured pair_rows
    launches, and count them."""
    graph.replay()
    pair_rows_kernel.launches += launches
