"""The fused f-update, sum_k coef_k K(x_i, xb_k) for all rows i.

`rbf_cross_matvec_kernel` runs csrc/fused_fupdate.cu on a CUDA tensor
(the port of the TPU kernel rbf_cross_matvec_pallas,
tpusvm/ops/pallas/fused_fupdate.py) and its plain version
`rbf_cross_matvec_ref` on a CPU tensor. IEEE f32 throughout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpusvm_torch.ops.cuda import _build
from tpusvm_torch.ops.rbf import rbf_cross_matvec, sq_norms

_P = ctypes.c_void_p


def rbf_cross_matvec_ref(X: torch.Tensor, XB: torch.Tensor, coef: torch.Tensor,
                         gamma, sn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the blocked torch contraction, in f32. Shape (n,)."""
    X = X.float()
    return rbf_cross_matvec(X, XB.float(), coef.float(), float(gamma),
                            None if sn is None else sn.float())


@functools.cache
def _bind():
    fn = _build.load("fused_fupdate").tpusvm_rbf_cross_matvec
    fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _f32(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be float32 of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def rbf_cross_matvec_kernel(X: torch.Tensor, XB: torch.Tensor,
                            coef: torch.Tensor, gamma,
                            sn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_k coef_k exp(-gamma max(0, sn_i + snB_k - 2 x_i.xb_k)), (n,) f32.

    X (n, d) and XB (q, d) float32 (XB is the gathered X[B], row-major),
    coef (q,), sn = sq_norms(X) if given. CPU tensors run the plain
    version; CUDA tensors launch the kernel (counted in `.launches`).
    """
    if not X.is_cuda:
        return rbf_cross_matvec_ref(X, XB, coef, gamma, sn)
    n, d = X.shape
    q = XB.shape[0]
    X = _f32(X, "X", (n, d))
    XB = _f32(XB, "XB", (q, d))
    coef = _f32(coef, "coef", (q,))
    sn = sq_norms(X) if sn is None else _f32(sn, "sn", (n,))
    snB = sq_norms(XB)
    for t in (XB, coef, sn):
        if t.device != X.device:
            raise ValueError("all operands must be on X's device")
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    fn = _bind()
    rc = fn(X.data_ptr(), XB.data_ptr(), coef.data_ptr(), sn.data_ptr(),
            snB.data_ptr(), float(gamma), n, d, q, out.data_ptr(),
            torch.cuda.current_stream(X.device).cuda_stream)
    rbf_cross_matvec_kernel.launches += 1
    _build.check(rc, "rbf_cross_matvec kernel")
    return out


rbf_cross_matvec_kernel.launches = 0
