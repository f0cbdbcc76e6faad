"""The working-set subproblem in one launch.

`inner_smo_kernel` runs csrc/inner_smo.cu on CUDA tensors (the port of the
TPU kernel inner_smo_pallas, single-pair _make_kernel,
tpusvm/ops/pallas/inner_smo.py) and its plain version `inner_smo_ref` on
CPU tensors. Both follow that kernel's semantics, not those of the solver's
accum-dtype loop engine: f32 compute, SHRINKING of a zero-progress pair's
i_low for the rest of the subproblem (instead of ending it), and end
reasons CONVERGED / NO_WORKING_SET / MAX_ITER only.

Both return (a_B_new (q,) f32, stat), stat an int32 tensor
[n_updates, progress, reason, iterations] on the input's device, so the
caller decides when to synchronise. reason -1 means the kernel's iteration
guard tripped (every iteration updates, shrinks one index or ends, so it
cannot in exact arithmetic); callers raise on it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusvm_torch.ops.cuda import _build
from tpusvm_torch.solver.analytic import pair_update
from tpusvm_torch.status import Status

_P = ctypes.c_void_p
_INF = float("inf")

# dynamic shared memory a block may use on Hopper (232,448 B), less the
# kernel's static reduction scratch
_SMEM_LIMIT = 232448 - 1024


def inner_smo_ref(K_BB, y_B, a_B, f_B, active_B, C, eps, tau, *,
                  max_inner: int, wss: int = 1, eta_exclude: bool = False):
    """Plain version: an eager torch loop with the kernel's semantics.

    Scalars are 0-d float32 tensors, never python floats (those are f64),
    so every step rounds as the kernel's f32 arithmetic does. Returns
    (a_B_new, stat) like the kernel wrapper.
    """
    _check_args(wss, eta_exclude)
    dev = K_BB.device
    f32 = torch.float32
    K = K_BB.to(f32)
    q = K.shape[0]
    diag = torch.diagonal(K).clone()
    y = y_B.to(f32)
    a = a_B.to(f32).clone()
    f = f_B.to(f32).clone()
    act = active_B.to(torch.bool).clone()
    C32 = torch.tensor(C, dtype=f32, device=dev)
    eps32 = torch.tensor(eps, dtype=f32, device=dev)
    tau32 = torch.tensor(tau, dtype=f32, device=dev)
    Cme = C32 - eps32
    pos = y > 0
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    n_upd = 0
    iters = 0
    progress = False
    reason = Status.RUNNING
    while reason == Status.RUNNING:
        iters += 1
        lo = a > eps32
        hi = a < Cme
        m_h = act & ((pos & hi) | (~pos & lo))
        m_l = act & ((pos & lo) | (~pos & hi))
        vh = torch.where(m_h, f, inf)
        vl = torch.where(m_l, f, -inf)
        # argmin/argmax return the first extremum: the index of the first
        # lane equal to it, even when every lane is +-inf
        i_h = int(torch.argmin(vh))
        i_l1 = int(torch.argmax(vl))
        b_h = vh[i_h]
        b_l = vl[i_l1]
        found = bool((b_h < inf) & (b_l > -inf))
        converged = found and bool(b_l <= b_h + 2.0 * tau32)
        proceed = found and not converged
        row_h = K[i_h]
        K11 = diag[i_h]
        i_l = i_l1
        g = None
        if wss == 2:
            eta_raw = K11 + diag - 2.0 * row_h
            eta_vec = torch.clamp_min(eta_raw, 1e-12)
            viol = m_l & (f > b_h)
            if eta_exclude:
                viol = viol & (eta_raw > eps32)
            diff = f - b_h
            vg = torch.where(viol, diff * diff / eta_vec, -inf)
            i_l2 = int(torch.argmax(vg))
            g = vg[i_l2]
            if eta_exclude and not bool(g > -inf):
                i_l2 = i_l1
            i_l = i_l2
        row_l = K[i_l]
        K22 = diag[i_l]
        K12 = row_h[i_l]
        y_h, y_l = y[i_h], y[i_l]
        a_h, a_l = a[i_h].clone(), a[i_l].clone()
        b_l_pair = b_l
        if wss == 2:
            eta_l = torch.clamp_min(K11 + K22 - 2.0 * K12, 1e-12)
            # sqrt taken in float64 and rounded once: torch's float32 CPU
            # sqrt is not always correctly rounded, IEEE sqrt (XLA's, CUDA's
            # sqrtf) is
            root = torch.sqrt((torch.clamp_min(g, 0.0) * eta_l).double())
            b_l_pair = b_h + root.float()
            if eta_exclude and not bool(g > -inf):
                b_l_pair = b_l
        upd = pair_update(K11, K22, K12, y_h, y_l, a_h, a_l, b_h, b_l_pair,
                          C32, eps32, torch.tensor(proceed, device=dev))
        f = _fma(upd.da_l * y_l, row_l, _fma(upd.da_h * y_h, row_h, f))
        # i_h == i_l forces eta == 0, hence zero deltas: the order is safe
        a[i_h] = a_h + upd.da_h
        a[i_l] = a_l + upd.da_l
        ok = bool(upd.do_update & ~upd.stalled)
        n_upd += int(ok)
        progress = progress or ok
        dead = proceed and bool(~upd.feasible | ~upd.eta_ok | upd.stalled)
        if dead:
            act[i_l] = False
        if not found:
            reason = Status.NO_WORKING_SET
        elif converged:
            reason = Status.CONVERGED
        elif n_upd >= max_inner:
            reason = Status.MAX_ITER
    stat = torch.tensor([n_upd, int(progress), int(reason), iters],
                        dtype=torch.int32, device=dev)
    return a, stat


def _fma(a, b, c):
    """f32 a*b + c with one rounding, as a fused multiply-add gives it.

    The reference's f32 row update compiles to two FMAs (XLA contracts
    f + A*row_h + B*row_l), and the kernel issues the same two; here the
    product is exact in float64 and the sum rounds once more to float32,
    which agrees with a true FMA except when the float64 sum lands exactly
    on a float32 rounding tie.
    """
    return (a.double() * b.double() + c.double()).float()


def _check_args(wss, eta_exclude):
    if wss not in (1, 2):
        raise ValueError(f"wss must be 1 or 2, got {wss}")
    if eta_exclude and wss != 2:
        raise ValueError("eta_exclude only applies to wss=2")


@functools.cache
def _bind():
    fn = _build.load("inner_smo").tpusvm_inner_smo
    fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def inner_smo_kernel(K_BB, y_B, a_B, f_B, active_B, C, eps, tau, *,
                     max_inner: int, wss: int = 1, eta_exclude: bool = False):
    """The subproblem on K_BB (q, q): returns (a_B_new (q,) f32, stat).

    stat is int32 [n_updates, progress, reason, iterations]. CPU tensors run
    `inner_smo_ref`; CUDA tensors launch the kernel (counted in
    `.launches`). Inputs may be any float dtype; compute is float32.
    """
    _check_args(wss, eta_exclude)
    if not K_BB.is_cuda:
        return inner_smo_ref(K_BB, y_B, a_B, f_B, active_B, C, eps, tau,
                             max_inner=max_inner, wss=wss,
                             eta_exclude=eta_exclude)
    q = K_BB.shape[0]
    if tuple(K_BB.shape) != (q, q):
        raise ValueError(f"K_BB must be square, got {tuple(K_BB.shape)}")
    if 5 * q * 4 > _SMEM_LIMIT:
        raise ValueError(
            f"q={q} does not fit: the kernel keeps 5 vectors of q floats "
            f"({5 * q * 4} bytes) in one block's shared memory, at most "
            f"{_SMEM_LIMIT} bytes"
        )
    dev = K_BB.device

    def vec(t):
        t = t.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(t.shape) != (q,):
            raise ValueError(f"working-set vectors must have shape ({q},)")
        return t

    K = K_BB.to(torch.float32).contiguous()
    y, a, f, act = vec(y_B), vec(a_B), vec(f_B), vec(active_B)
    a_out = torch.empty(q, dtype=torch.float32, device=dev)
    stat = torch.empty(4, dtype=torch.int32, device=dev)
    fn = _bind()
    rc = fn(K.data_ptr(), y.data_ptr(), a.data_ptr(), f.data_ptr(),
            act.data_ptr(), float(C), float(eps), float(tau), q,
            int(max_inner), int(wss), int(bool(eta_exclude)),
            a_out.data_ptr(), stat.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    inner_smo_kernel.launches += 1
    _build.check(rc, "inner_smo kernel")
    return a_out, stat


inner_smo_kernel.launches = 0

_PROBE_MODES = {"chain": 0, "rows": 1}


@functools.cache
def _bind_probe():
    fn = _build.load("inner_smo").tpusvm_inner_smo_floor_probe
    fn.argtypes = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   _P, _P]
    fn.restype = ctypes.c_int
    return fn


def iteration_floor_probe(K_BB, iters: int, *, wss: int, mode: str):
    """Launch a floor of `iters` kernel iterations on a CUDA K_BB (q, q).

    mode "chain": only the block-wide reductions and barriers an iteration
    of the kernel waits on; "rows": only its two K_BB row reads. Timing it
    gives a lower bound on the kernel's time per iteration. Not a kernel of
    the solver: it computes nothing and is not counted in `.launches`.
    """
    _check_args(wss, False)
    if not K_BB.is_cuda:
        raise ValueError("iteration_floor_probe measures the card: pass a "
                         "CUDA tensor")
    K = K_BB.to(torch.float32).contiguous()
    out = torch.empty(1024, dtype=torch.float32, device=K.device)
    rc = _bind_probe()(K.data_ptr(), K.shape[0], int(iters), int(wss),
                       _PROBE_MODES[mode], out.data_ptr(),
                       torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, "inner_smo floor probe")
    return out
