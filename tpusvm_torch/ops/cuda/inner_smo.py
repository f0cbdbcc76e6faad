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

`inner_smo_batched_kernel` is the fleet's problem-axis launch: B stacked
working sets, one thread block each (plain version
`inner_smo_batched_ref`, the solo plain version lane by lane); a lane's
outputs equal a solo launch on its operands bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusvm_torch.device import host_to_device
from tpusvm_torch.ops.cuda import _build
from tpusvm_torch.solver.analytic import pair_update
from tpusvm_torch.status import Status

_P = ctypes.c_void_p
_INF = float("inf")
_LANE = 128

# dynamic shared memory a block may use on Hopper (232,448 B), less room for
# the kernels' static scratch
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


def inner_smo_multipair_ref(K_BB, y_B, a_B, f_B, active_B, C, eps, tau, *,
                            max_inner: int, multipair: int, wss: int = 1):
    """Plain version of the multipair subproblem (p = multipair > 1).

    Per iteration: slot s pairs the first-argmin I_high row of
    [s*q/(2p), (s+1)*q/(2p)) with the first-argmax I_low row of
    [q/2 + s*q/(2p), ...), each against the iteration-start f (Jacobi);
    a slot steps only on a locally violating pair and never shrinks.
    Then the globally worst pair steps (Gauss-Seidel, alphas read after
    the slot writes), unless an applied slot update touched either of
    its ends; it shrinks its i_low only when every slot idled. f takes
    all 2(p+1) row terms into one df, in slot order, global last. A lane
    gets at most one nonzero alpha delta per iteration (asserted), which
    is why the kernel keeps one copy of alpha. Returns (a_B_new, stat)
    like `inner_smo_ref`.
    """
    p = multipair
    q = K_BB.shape[0]
    check_multipair(q, wss, p)
    if p < 2:
        raise ValueError(f"the multipair kernel runs p >= 2 slot pairs, got "
                         f"{p}; p=1 is inner_smo_ref")
    dev = K_BB.device
    f32 = torch.float32
    K = K_BB.to(f32)
    diag = torch.diagonal(K).clone()
    y = y_B.to(f32)
    a = a_B.to(f32).clone()
    f = f_B.to(f32).clone()
    act = active_B.to(torch.bool).clone()
    C32 = torch.tensor(C, dtype=f32, device=dev)
    eps32 = torch.tensor(eps, dtype=f32, device=dev)
    tau32 = torch.tensor(tau, dtype=f32, device=dev)
    Cme = C32 - eps32
    two_tau = 2.0 * tau32
    pos = y > 0
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    span = q // (2 * p)
    base = torch.arange(p, device=dev) * span
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
        i_hg = torch.argmin(vh)
        i_lg = torch.argmax(vl)
        b_h, b_l = vh[i_hg], vl[i_lg]
        found = (b_h < inf) & (b_l > -inf)
        converged = found & (b_l <= b_h + two_tau)
        proceed = found & ~converged
        # the p slots at once: argmin/argmax along each slot's rows give
        # the first occurrence, and the slot's first row when it is empty
        ih = base + torch.argmin(vh[:q // 2].view(p, span), dim=1)
        il = q // 2 + base + torch.argmax(vl[q // 2:].view(p, span), dim=1)
        bh_s, bl_s = vh[ih], vl[il]
        ok_s = (bh_s < inf) & (bl_s > -inf) & (bl_s > bh_s + two_tau)
        y_h, y_l = y[ih], y[il]
        upd = pair_update(diag[ih], diag[il], K[ih, il], y_h, y_l, a[ih],
                          a[il], bh_s, bl_s, C32, eps32, proceed & ok_s)
        ok = upd.do_update & ~upd.stalled
        a[ih] = a[ih] + upd.da_h
        a[il] = a[il] + upd.da_l
        touched = ok & ((ih == i_hg) | (il == i_hg) | (ih == i_lg)
                        | (il == i_lg))
        n_slot = ok.sum()
        glob_go = proceed & ~touched.any()
        a_hg, a_lg = a[i_hg].clone(), a[i_lg].clone()
        y_hg, y_lg = y[i_hg], y[i_lg]
        updg = pair_update(diag[i_hg], diag[i_lg], K[i_hg, i_lg], y_hg, y_lg,
                           a_hg, a_lg, b_h, b_l, C32, eps32, glob_go)
        okg = updg.do_update & ~updg.stalled
        deadg = glob_go & (n_slot == 0) & (~updg.feasible | ~updg.eta_ok
                                           | updg.stalled)
        a[i_hg] = a_hg + updg.da_h
        a[i_lg] = a_lg + updg.da_l
        # one nonzero delta per lane: the slots are disjoint, and the
        # global step runs only when no applied slot update touched it
        nz = torch.cat([ih[upd.da_h != 0], il[upd.da_l != 0],
                        torch.stack([i_hg, i_lg])[torch.stack(
                            [updg.da_h, updg.da_l]) != 0]])
        ch, cl = upd.da_h * y_h, upd.da_l * y_l
        df = _fma(ch[0], K[ih[0]], cl[0] * K[il[0]])
        for s in range(1, p):
            df = _fma(cl[s], K[il[s]], _fma(ch[s], K[ih[s]], df))
        df = _fma(updg.da_l * y_lg, K[i_lg], _fma(updg.da_h * y_hg, K[i_hg], df))
        f = f + df
        act[i_lg] = act[i_lg] & ~deadg
        n_ok = n_slot + okg.to(n_slot.dtype)
        idle = proceed & (n_ok == 0) & ~deadg
        # one host read per iteration
        n_ok_v, found_v, conv_v, idle_v, n_nz, n_nz_u = torch.stack([
            n_ok, found.long(), converged.long(), idle.long(),
            torch.tensor(nz.numel(), device=dev), nz.unique().numel()
            + torch.zeros((), dtype=torch.long, device=dev)]).tolist()
        assert n_nz == n_nz_u, "two nonzero alpha deltas on one lane"
        n_upd += n_ok_v
        progress = progress or n_ok_v > 0
        if not found_v or idle_v:
            reason = Status.NO_WORKING_SET
        elif conv_v:
            reason = Status.CONVERGED
        elif n_upd >= max_inner:
            reason = Status.MAX_ITER
    stat = torch.tensor([n_upd, int(progress), int(reason), iters],
                        dtype=torch.int32, device=dev)
    return a, stat


def check_multipair(q: int, wss: int, multipair: int) -> None:
    """The multipair kernel's argument checks (the TPU kernel's messages)."""
    if multipair < 1:
        raise ValueError(f"multipair must be >= 1, got {multipair}")
    if multipair > 1:
        if wss != 1:
            raise ValueError("multipair requires wss=1 (slot pairing is "
                             "first-order)")
        rows = q // _LANE
        if q % _LANE or rows % (2 * multipair):
            raise ValueError(
                f"multipair={multipair} needs (q//{_LANE}) % {2 * multipair} "
                f"== 0 (rows per slot per half >= 1), got q={q} (R={rows})"
            )


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


def _operands(K_BB, y_B, a_B, f_B, active_B):
    """Checked, contiguous float32 operands for a kernel launch."""
    q = K_BB.shape[0]
    if tuple(K_BB.shape) != (q, q):
        raise ValueError(f"K_BB must be square, got {tuple(K_BB.shape)}")
    if 5 * q * 4 > _SMEM_LIMIT:
        raise ValueError(
            f"q={q} does not fit: the kernels take working sets of up to 5 "
            f"vectors of q floats ({5 * q * 4} bytes) in one block's shared "
            f"memory, at most {_SMEM_LIMIT} bytes"
        )
    dev = K_BB.device

    def vec(t):
        t = t.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(t.shape) != (q,):
            raise ValueError(f"working-set vectors must have shape ({q},)")
        return t

    K = K_BB.to(torch.float32).contiguous()
    return K, vec(y_B), vec(a_B), vec(f_B), vec(active_B)


def inner_smo_kernel(K_BB, y_B, a_B, f_B, active_B, C, eps, tau, *,
                     max_inner: int, wss: int = 1, eta_exclude: bool = False,
                     multipair: int = 1):
    """The subproblem on K_BB (q, q): returns (a_B_new (q,) f32, stat).

    stat is int32 [n_updates, progress, reason, iterations]. CPU tensors run
    `inner_smo_ref`; CUDA tensors launch the kernel (counted in
    `.launches`). Inputs may be any float dtype; compute is float32.
    multipair=p > 1 runs `inner_smo_multipair_kernel` instead.
    """
    _check_args(wss, eta_exclude)
    check_multipair(K_BB.shape[0], wss, multipair)
    if multipair > 1:
        return inner_smo_multipair_kernel(
            K_BB, y_B, a_B, f_B, active_B, C, eps, tau, max_inner=max_inner,
            multipair=multipair, wss=wss)
    if not K_BB.is_cuda:
        return inner_smo_ref(K_BB, y_B, a_B, f_B, active_B, C, eps, tau,
                             max_inner=max_inner, wss=wss,
                             eta_exclude=eta_exclude)
    K, y, a, f, act = _operands(K_BB, y_B, a_B, f_B, active_B)
    q, dev = K.shape[0], K.device
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


def inner_smo_batched_ref(K_BB, y_B, a_B, f_B, active_B, Cs, eps, tau, *,
                          max_inner: int, wss: int = 1,
                          eta_exclude: bool = False):
    """Plain version of the problem-axis launch: `inner_smo_ref` on each
    lane (lane b's C is Cs[b]). Returns (a_out (B, q) f32, stat (B, 4))."""
    C_list = Cs.tolist() if hasattr(Cs, "tolist") else list(Cs)
    outs = [inner_smo_ref(K_BB[b], y_B[b], a_B[b], f_B[b], active_B[b],
                          C_list[b], eps, tau, max_inner=max_inner, wss=wss,
                          eta_exclude=eta_exclude)
            for b in range(a_B.shape[0])]
    return (torch.stack([a for a, _ in outs]),
            torch.stack([st for _, st in outs]))


@functools.cache
def _bind_batched():
    fn = _build.load("inner_smo").tpusvm_inner_smo_batched
    fn.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def inner_smo_batched_kernel(K_BB, y_B, a_B, f_B, active_B, Cs, eps, tau, *,
                             max_inner: int, wss: int = 1,
                             eta_exclude: bool = False):
    """B subproblems in one launch: K_BB (B, q, q), y_B/a_B/f_B/active_B
    (B, q), Cs (B,) (lane b's C, rounded to f32 as the solo launch rounds
    its C). Returns (a_out (B, q) f32, stat (B, 4) int32). CPU tensors run
    `inner_smo_batched_ref`; CUDA tensors launch
    csrc/inner_smo.cu's problem-axis kernel, <<<B, 512>>> (counted in
    `.launches`, apart from the solo launch's count)."""
    _check_args(wss, eta_exclude)
    if K_BB.dim() != 3 or K_BB.shape[1] != K_BB.shape[2]:
        raise ValueError(f"K_BB must be (B, q, q), got {tuple(K_BB.shape)}")
    B, q = K_BB.shape[0], K_BB.shape[1]
    if not K_BB.is_cuda:
        return inner_smo_batched_ref(K_BB, y_B, a_B, f_B, active_B, Cs, eps,
                                     tau, max_inner=max_inner, wss=wss,
                                     eta_exclude=eta_exclude)
    if 5 * q * 4 > _SMEM_LIMIT:
        raise ValueError(f"q={q} does not fit one block's shared memory")
    dev = K_BB.device

    def lanes(t, name):
        t = t.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(t.shape) != (B, q):
            raise ValueError(f"{name} must have shape ({B}, {q})")
        return t

    K = K_BB.to(torch.float32).contiguous()
    y, f, act = lanes(y_B, "y_B"), lanes(f_B, "f_B"), lanes(active_B, "active_B")
    a_in = lanes(a_B, "a_B")
    a_out = torch.empty_like(a_in)
    Cs_t = (Cs if isinstance(Cs, torch.Tensor)
            else host_to_device(Cs, torch.float32, dev))
    Cs_t = Cs_t.to(device=dev, dtype=torch.float32).contiguous()
    if tuple(Cs_t.shape) != (B,):
        raise ValueError(f"Cs must have shape ({B},)")
    stat = torch.empty((B, 4), dtype=torch.int32, device=dev)
    rc = _bind_batched()(
        K.data_ptr(), y.data_ptr(), a_in.data_ptr(), f.data_ptr(),
        act.data_ptr(), Cs_t.data_ptr(), float(eps),
        float(tau), q, int(max_inner), int(wss), int(bool(eta_exclude)), B,
        a_out.data_ptr(), stat.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    inner_smo_batched_kernel.launches += 1
    _build.check(rc, "inner_smo batched kernel")
    return a_out, stat


inner_smo_batched_kernel.launches = 0

# the CUDA multipair kernel reduces each of the 2p slot halves with its own
# warps of one 32-warp block
_MAX_MULTIPAIR = 16


@functools.cache
def _bind_multipair():
    fn = _build.load("inner_smo_multipair").tpusvm_inner_smo_multipair
    fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def inner_smo_multipair_kernel(K_BB, y_B, a_B, f_B, active_B, C, eps, tau, *,
                               max_inner: int, multipair: int, wss: int = 1):
    """The multipair subproblem (p = multipair >= 2 slot pairs per
    iteration): returns (a_B_new (q,) f32, stat) like `inner_smo_kernel`.

    CPU tensors run `inner_smo_multipair_ref`; CUDA tensors launch
    csrc/inner_smo_multipair.cu (counted in `.launches`, apart from the
    single-pair kernel's count).
    """
    q = K_BB.shape[0]
    check_multipair(q, wss, multipair)
    if multipair < 2:
        raise ValueError(f"the multipair kernel runs p >= 2 slot pairs, got "
                         f"{multipair}; p=1 is inner_smo_kernel")
    if not K_BB.is_cuda:
        return inner_smo_multipair_ref(K_BB, y_B, a_B, f_B, active_B, C, eps,
                                       tau, max_inner=max_inner,
                                       multipair=multipair, wss=wss)
    if multipair > _MAX_MULTIPAIR:
        raise ValueError(f"the CUDA multipair kernel takes p <= "
                         f"{_MAX_MULTIPAIR}, got {multipair}")
    K, y, a, f, act = _operands(K_BB, y_B, a_B, f_B, active_B)
    dev = K.device
    a_out = torch.empty(q, dtype=torch.float32, device=dev)
    stat = torch.empty(4, dtype=torch.int32, device=dev)
    rc = _bind_multipair()(
        K.data_ptr(), y.data_ptr(), a.data_ptr(), f.data_ptr(),
        act.data_ptr(), float(C), float(eps), float(tau), q, int(max_inner),
        int(multipair), a_out.data_ptr(), stat.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    inner_smo_multipair_kernel.launches += 1
    _build.check(rc, "inner_smo multipair kernel")
    return a_out, stat


inner_smo_multipair_kernel.launches = 0

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

    mode "chain": only the block-wide reductions an iteration of the kernel
    waits on (one barrier each); "rows": only its two K_BB row reads, into
    registers as the kernel reads them (both at once at wss=1; at wss=2 the
    second after the first, as the gain scan needs row_h first). Timing it
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


@functools.cache
def _bind_multipair_probe():
    fn = _build.load("inner_smo_multipair").tpusvm_inner_smo_multipair_floor_probe
    fn.argtypes = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   _P, _P]
    fn.restype = ctypes.c_int
    return fn


def multipair_floor_probe(K_BB, iters: int, *, multipair: int, mode: str):
    """`iteration_floor_probe` for the multipair kernel: mode "chain" runs
    only its per-iteration reductions and barriers, "rows" only its
    2(p+1) K_BB row reads, copied into shared memory and applied by the
    kernel's own bulk copies and f update. Not counted in `.launches`."""
    check_multipair(K_BB.shape[0], 1, multipair)
    if not K_BB.is_cuda:
        raise ValueError("multipair_floor_probe measures the card: pass a "
                         "CUDA tensor")
    K = K_BB.to(torch.float32).contiguous()
    out = torch.empty(1024, dtype=torch.float32, device=K.device)
    rc = _bind_multipair_probe()(
        K.data_ptr(), K.shape[0], int(multipair), int(iters),
        _PROBE_MODES[mode], out.data_ptr(),
        torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, "inner_smo multipair floor probe")
    return out
