"""The fused f-update, sum_k coef_k K(x_i, xb_k) for all rows i.

`rbf_cross_matvec_kernel` runs csrc/fused_fupdate.cu on a CUDA tensor
(the port of the TPU kernel rbf_cross_matvec_pallas,
tpusvm/ops/pallas/fused_fupdate.py) and its plain version
`rbf_cross_matvec_ref` on a CPU tensor. `fused_fupdate_select_kernel`
(csrc/fused_select.cu, the port of fused_fupdate_select_pallas) adds the
next round's working-set candidates; its plain version is
`fused_fupdate_select_ref`.

The plain versions are IEEE f32. On the card the contraction runs as
3xTF32 on the tensor cores: each operand is split as a = hi + lo with
hi = tf32(a) and lo = tf32(a - hi) (`tf32_split`, rounding to nearest,
ties away from zero), and the kernel sums lo.hi + hi.lo + hi.hi in f32,
each 32-wide k slice in a fresh accumulator, the slices added with IEEE
adds. `rbf_cross_matvec_3xtf32` is a plain-torch model of that precision,
not of the card's rounding: the same split and the same three products,
each a full-depth f32 matmul, so that the CPU tests can show the solver
tolerates a contraction with the lo.lo term dropped.

`rbf_cross_matvec_batched_kernel` is the fleet's problem-axis launch of the
f-update: B problems over one X, each with its own X_B, coefficients and
gamma, in one launch whose rows equal solo launches bit for bit (plain
version `rbf_cross_matvec_batched_ref`, the solo plain version lane by
lane).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpusvm_torch.device import host_to_device
from tpusvm_torch.ops.cuda import _build
from tpusvm_torch.ops.rbf import (check_full_f32, rbf_cross_matvec,
                                  sq_norms)

_P = ctypes.c_void_p


def tf32_split(x: torch.Tensor):
    """(hi, lo) of a float32 tensor: hi = tf32(x), lo = tf32(x - hi).

    tf32 keeps 10 explicit significand bits: the low 13 bits of the f32
    pattern are rounded off to nearest, ties away from zero (PTX
    cvt.rna.tf32.f32), on the bit pattern, so subnormals round in their
    own scale, the sign is kept, and a NaN stays a NaN. x - hi is exact in
    f32, so hi + lo == x whenever lo needs no rounding, and |x - hi - lo|
    <= 2^-11 |x - hi| otherwise.
    """
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_split takes float32, got {x.dtype}")

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        # adding half an ulp to the magnitude bits rounds ties away from 0
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isnan(v), v, r)

    hi = rna(x)
    return hi, rna(x - hi)


def _dot_3xtf32(XA: torch.Tensor, XB: torch.Tensor) -> torch.Tensor:
    """XA . XB^T from the TF32 parts the kernel uses: three f32 matmuls of
    the parts (each product of two TF32 values is exact in f32), added."""
    check_full_f32(XA)
    ah, al = tf32_split(XA)
    bh, bl = tf32_split(XB)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def rbf_cross_matvec_3xtf32(X: torch.Tensor, XB: torch.Tensor,
                            coef: torch.Tensor, gamma,
                            sn: Optional[torch.Tensor] = None,
                            block: int = 8192) -> torch.Tensor:
    """The f-update with a 3xTF32 dot (the kernel's split and products, in
    three full-depth f32 matmuls rounded apart, which is coarser than the
    card's per-slice sums) and the plain version's f32 epilogue. Shape
    (n,)."""
    X = X.float()
    XB = XB.float()
    coef = coef.float()
    if sn is None:
        sn = sq_norms(X)
    snB = sq_norms(XB)
    out = torch.empty(X.shape[0], dtype=torch.float32, device=X.device)
    for start in range(0, X.shape[0], block):
        stop = min(start + block, X.shape[0])
        d2 = (sn[start:stop, None] + snB[None, :]
              - 2.0 * _dot_3xtf32(X[start:stop], XB))
        out[start:stop] = torch.exp(-gamma * torch.clamp_min(d2, 0.0)) @ coef
    return out


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
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _f32(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be float32 of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


# columns of X_B per work unit of the main loop (BN in csrc/rbf_tile.cuh)
_TILE_N = 128


def _tma_rows(X: torch.Tensor) -> torch.Tensor:
    """X as the main loop's TMA loads take it: rows padded with zero
    columns to a multiple of 4 floats (a 16-byte pitch; zero columns change
    neither a dot nor a norm), on a 16-byte aligned base (else copied)."""
    d = X.shape[1]
    if d % 4:
        return torch.nn.functional.pad(X, (0, 4 - d % 4))
    if X.data_ptr() % 16:
        return X.clone()
    return X


def _operands(X, XB, coef, sn):
    n, d = X.shape
    q = XB.shape[0]
    X = _f32(X, "X", (n, d))
    XB = _f32(XB, "XB", (q, d))
    coef = _f32(coef, "coef", (q,))
    sn = sq_norms(X) if sn is None else _f32(sn, "sn", (n,))
    for t in (XB, coef, sn):
        if t.device != X.device:
            raise ValueError("all operands must be on X's device")
    Xt = _tma_rows(X)
    ld = Xt.shape[1]
    # the kernel's scratch: X_B's TF32 hi and lo parts, then one partial
    # row sum per column tile of _TILE_N
    scratch = torch.empty(2 * q * ld + -(-q // _TILE_N) * n,
                          dtype=torch.float32, device=X.device)
    return (Xt, XB, coef, sn, sq_norms(XB), n, d, ld, q, scratch)


def rbf_cross_matvec_kernel(X: torch.Tensor, XB: torch.Tensor,
                            coef: torch.Tensor, gamma,
                            sn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_k coef_k exp(-gamma max(0, sn_i + snB_k - 2 x_i.xb_k)), (n,) f32.

    X (n, d) and XB (q, d) float32 (XB is the gathered X[B], row-major),
    coef (q,), sn = sq_norms(X) if given. CPU tensors run the plain
    version; CUDA tensors launch the kernel (counted in `.launches`), whose
    contraction is 3xTF32 on the tensor cores. For the kernel's TMA loads,
    X with d % 4 != 0 is padded with zero columns and a misaligned X is
    copied; X_B's TF32 parts and the per-tile partial sums go to scratch the
    wrapper allocates.
    """
    if not X.is_cuda:
        return rbf_cross_matvec_ref(X, XB, coef, gamma, sn)
    Xt, XB, coef, sn, snB, n, d, ld, q, scratch = _operands(X, XB, coef, sn)
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    rc = _bind()(Xt.data_ptr(), XB.data_ptr(), coef.data_ptr(), sn.data_ptr(),
                 snB.data_ptr(), float(gamma), n, d, ld, q, scratch.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream(X.device).cuda_stream)
    rbf_cross_matvec_kernel.launches += 1
    _build.check(rc, "rbf_cross_matvec kernel")
    return out


rbf_cross_matvec_kernel.launches = 0


def rbf_cross_matvec_batched_ref(X, XB, coef, gammas, sn):
    """Plain version of the problem-axis f-update: `rbf_cross_matvec_ref`
    for each problem b (XB[b], coef[b], gammas[b]). Returns (B, n) f32."""
    g = gammas.tolist() if hasattr(gammas, "tolist") else list(gammas)
    return torch.stack([rbf_cross_matvec_ref(X, XB[b], coef[b], g[b], sn)
                        for b in range(XB.shape[0])])


@functools.cache
def _bind_batched():
    fn = _build.load("fused_fupdate").tpusvm_rbf_cross_matvec_batched
    fn.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def rbf_cross_matvec_batched_kernel(X: torch.Tensor, XB: torch.Tensor,
                                    coef: torch.Tensor, gammas,
                                    sn) -> torch.Tensor:
    """sum_k coef[b, k] exp(-gammas[b] max(0, sn_i + snB[b, k] - 2 x_i.xb[b, k]))
    for every problem b: (B, n) f32.

    X (n, d) float32 shared; XB (B, q, d) float32 (problem b's gathered
    X[B_b]); coef (B, q); gammas (B,) (rounded to f32, as the solo launch
    rounds its gamma); sn = sq_norms(X) or None. CPU tensors run
    `rbf_cross_matvec_batched_ref`; CUDA tensors launch
    csrc/fused_fupdate.cu's problem-axis kernel (counted in `.launches`),
    whose row b equals `rbf_cross_matvec_kernel` on problem b's operands
    bit for bit: snB is taken lane by lane with the solo wrapper's own
    call.
    """
    if XB.dim() != 3:
        raise ValueError(f"XB must be (B, q, d), got {tuple(XB.shape)}")
    B, q, d = XB.shape
    if not X.is_cuda:
        return rbf_cross_matvec_batched_ref(X, XB, coef, gammas, sn)
    n = X.shape[0]
    X = _f32(X, "X", (n, d))
    XB = _f32(XB, "XB", (B, q, d))
    coef = _f32(coef, "coef", (B, q))
    sn = sq_norms(X) if sn is None else _f32(sn, "sn", (n,))
    dev = X.device
    g_t = (gammas if isinstance(gammas, torch.Tensor)
           else host_to_device(gammas, torch.float32, dev))
    g_t = g_t.to(device=dev, dtype=torch.float32).reshape(B).contiguous()
    # each problem's norms by the solo wrapper's call, so that its bits are
    # the solo launch's
    snB = torch.stack([sq_norms(XB[b]) for b in range(B)])
    Xt = _tma_rows(X)
    ld = Xt.shape[1]
    scratch = torch.empty(B * (2 * q * ld + -(-q // _TILE_N) * n),
                          dtype=torch.float32, device=dev)
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    rc = _bind_batched()(
        Xt.data_ptr(), XB.data_ptr(), coef.data_ptr(), sn.data_ptr(),
        snB.data_ptr(), g_t.data_ptr(), n, d, ld, q, B,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    rbf_cross_matvec_batched_kernel.launches += 1
    _build.check(rc, "rbf_cross_matvec batched kernel")
    return out


rbf_cross_matvec_batched_kernel.launches = 0


# ---------------------------------------------------------------------------
# The f-update with fused candidate selection (port of
# fused_fupdate_select_pallas): df as above, plus per row block the k_cand
# best I_high and I_low candidates of the updated f. The row block and
# k_cand define the candidate pool, so they follow the TPU kernel's
# arithmetic exactly; on the card they are not a memory budget.

_RESIDENT_BUDGET = 64_000_000
_STACK_BUDGET_FLOOR = 15_000_000


def _stack_bytes(block: int, q: int, d: int) -> int:
    return block * (2 * q * 8 + d * 4)


def _auto_block(q: int, d: int, n: int) -> int:
    """The TPU kernel's row block for (q, d, n); ValueError where its cost
    model admits none (selection_shape then takes 1024)."""
    if 4 * q * d + 12 * q > _RESIDENT_BUDGET:
        raise ValueError(f"no row block admitted at q={q}, d={d}")
    floor = max(8, min(128, n))
    if _stack_bytes(floor, q, d) > _STACK_BUDGET_FLOOR:
        raise ValueError(f"no row block admitted at q={q}, d={d}")
    block = floor
    while block < 1024 and _stack_bytes(2 * block, q, d) <= 12_000_000:
        block *= 2
    return block


def selection_shape(n: int, d: int, q: int, k_min: int = 8):
    """(block, nb, k_cand, ncand) of the candidate pool: rows per block,
    blocks, candidates per block and per index set, and nb * k_cand.
    k_cand covers a full q/2 half (with a k_min floor) and is <= block."""
    try:
        block = _auto_block(q, d, n)
    except ValueError:
        block = 1024
    block = min(block, max(n, 8))
    nb = -(-n // block)
    half = max(q // 2, 1)
    k_cand = min(max(k_min, -(-half // nb)), block)
    return block, nb, k_cand, nb * k_cand


def select_candidates_ref(f_new32, alpha32, y_eff, C, eps, n: int,
                          block: int, k_cand: int):
    """Plain version of the selection epilogue on the updated f32 f.

    Per block of `block` rows: the k_cand smallest keys of I_high and the
    k_cand largest of I_low, each pick taking the LAST row among equal
    keys; rows >= n and rows with y_eff == 0 belong to neither set, so a
    block short of members fills with +-inf at its largest unpicked rows
    (in the last block, rows >= n). Masks are f32: alpha32 against f32
    C - eps and eps. Returns (up_val, up_idx, low_val, low_idx), each
    (nb * k_cand,), indices int32 and global.
    """
    dev = f_new32.device
    f32 = torch.float32
    nb = -(-n // block)
    pad = nb * block - n
    C32 = torch.tensor(C, dtype=f32, device=dev)
    eps32 = torch.tensor(eps, dtype=f32, device=dev)
    a = alpha32.to(f32)
    ye = y_eff.to(torch.int32)
    m_h = torch.where(ye == 1, a < C32 - eps32, (ye == -1) & (a > eps32))
    m_l = torch.where(ye == 1, a > eps32, (ye == -1) & (a < C32 - eps32))
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    key_up = torch.nn.functional.pad(torch.where(m_h, f_new32, inf), (0, pad),
                                     value=float("inf")).view(nb, block)
    key_lo = torch.nn.functional.pad(torch.where(m_l, f_new32, -inf),
                                     (0, pad), value=-float("inf")).view(nb, block)
    # the picks in order are the rows sorted by key, then by row
    # descending: a stable sort of the row-reversed block
    rows = torch.arange(block - 1, -1, -1, device=dev)
    base = (torch.arange(nb, device=dev) * block)[:, None]

    def pick(key, descending):
        order = torch.sort(key.flip(1), dim=1, descending=descending,
                           stable=True).indices[:, :k_cand]
        val = torch.gather(key.flip(1), 1, order)
        return val.reshape(-1), (base + rows[order]).to(torch.int32).reshape(-1)

    up_val, up_idx = pick(key_up, False)
    low_val, low_idx = pick(key_lo, True)
    return up_val, up_idx, low_val, low_idx


def fused_fupdate_select_ref(X, XB, coef, gamma, sn, f32_f, alpha32, y_eff,
                             C, eps, *, block: int, k_cand: int):
    """Plain version: `rbf_cross_matvec_ref`, then the epilogue on
    f32_f + df. Returns (df, up_val, up_idx, low_val, low_idx)."""
    df = rbf_cross_matvec_ref(X, XB, coef, gamma, sn)
    n = X.shape[0]
    return (df, *select_candidates_ref(f32_f.float() + df, alpha32, y_eff, C,
                                       eps, n, block, k_cand))


@functools.cache
def _bind_select():
    fn = _build.load("fused_select").tpusvm_fused_fupdate_select
    fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def fused_fupdate_select_kernel(X, XB, coef, gamma, sn, f32_f, alpha32,
                                y_eff, C, eps, *, block: int, k_cand: int):
    """df (n,) f32 and the next round's candidates, as
    `fused_fupdate_select_ref` returns them.

    f32_f is the current f in f32, alpha32 the post-round alphas in f32,
    y_eff = y * valid as int32. CPU tensors run the plain version; CUDA
    tensors launch csrc/fused_select.cu (the f-update's three launches and
    the epilogue's, counted once in `.launches`): df bit-identical to
    `rbf_cross_matvec_kernel`'s.
    """
    if not X.is_cuda:
        return fused_fupdate_select_ref(X, XB, coef, gamma, sn, f32_f, alpha32,
                                        y_eff, C, eps, block=block,
                                        k_cand=k_cand)
    if not 1 <= k_cand <= block:
        raise ValueError(f"k_cand must be in [1, block={block}], got {k_cand}")
    Xt, XB, coef, sn, snB, n, d, ld, q, scratch = _operands(X, XB, coef, sn)
    f32_f = _f32(f32_f, "f32_f", (n,))
    alpha32 = _f32(alpha32, "alpha32", (n,))
    if y_eff.dtype != torch.int32 or tuple(y_eff.shape) != (n,):
        raise ValueError(f"y_eff must be int32 of shape ({n},)")
    y_eff = y_eff.contiguous()
    for t in (f32_f, alpha32, y_eff):
        if t.device != X.device:
            raise ValueError("all operands must be on X's device")
    nb = -(-n // block)
    dev = X.device
    df = torch.empty(n, dtype=torch.float32, device=dev)
    up_val = torch.empty(nb * k_cand, dtype=torch.float32, device=dev)
    low_val = torch.empty_like(up_val)
    up_idx = torch.empty(nb * k_cand, dtype=torch.int32, device=dev)
    low_idx = torch.empty_like(up_idx)
    rc = _bind_select()(
        Xt.data_ptr(), XB.data_ptr(), coef.data_ptr(), sn.data_ptr(),
        snB.data_ptr(), float(gamma), n, d, ld, q, scratch.data_ptr(),
        f32_f.data_ptr(), alpha32.data_ptr(),
        y_eff.data_ptr(), float(C), float(eps), block, k_cand, df.data_ptr(),
        up_val.data_ptr(), up_idx.data_ptr(), low_val.data_ptr(),
        low_idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    fused_fupdate_select_kernel.launches += 1
    _build.check(rc, "fused_fupdate_select kernel")
    return df, up_val, up_idx, low_val, low_idx


fused_fupdate_select_kernel.launches = 0


@functools.cache
def _bind_epilogue():
    fn = _build.load("fused_select").tpusvm_select_candidates
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                   _P]
    fn.restype = ctypes.c_int
    return fn


def select_epilogue_probe(df, f32_f, alpha32, y_eff, C, eps, *, block: int,
                          k_cand: int):
    """Launch fused_select.cu's epilogue alone on CUDA tensors (df, f32_f,
    alpha32 float32, y_eff int32, all (n,)), so that its time shows apart
    from the f-update's. Not a kernel of the solver: not counted in
    `.launches`. Returns the four candidate arrays."""
    if not df.is_cuda:
        raise ValueError("select_epilogue_probe measures the card: pass CUDA "
                         "tensors")
    n = df.shape[0]
    nb = -(-n // block)
    dev = df.device
    up_val = torch.empty(nb * k_cand, dtype=torch.float32, device=dev)
    low_val = torch.empty_like(up_val)
    up_idx = torch.empty(nb * k_cand, dtype=torch.int32, device=dev)
    low_idx = torch.empty_like(up_idx)
    ops = [_f32(t, name, (n,)) for t, name in ((df, "df"), (f32_f, "f32_f"),
                                               (alpha32, "alpha32"))]
    rc = _bind_epilogue()(
        *(t.data_ptr() for t in ops), y_eff.contiguous().data_ptr(), float(C),
        float(eps), n, block, k_cand, up_val.data_ptr(), up_idx.data_ptr(),
        low_val.data_ptr(), low_idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_select epilogue")
    return up_val, up_idx, low_val, low_idx
