"""Blocked working-set SMO on one device, driven from the host.

Each outer round:
  1. the Keerthi stop check b_low <= b_high + 2 tau over the masked f;
  2. working-set selection: the q/2 smallest-f I_high members and the q/2
     largest-f I_low members, by a stable sort so that ties go to the lower
     index (the order lax.top_k gives) -- over all n rows, or, with
     fused_selection, over the candidate pool the previous round's
     f-update kernel wrote;
  3. K_BB = K(X_B, X_B), one matmul (kernels.cross: any exact family);
  4. the inner subproblem on K_BB: the CUDA kernel (inner="kernel", one
     pair per iteration, or p slot pairs with multipair=p) or the
     accum-dtype eager loop (inner="loop");
  5. the f-update f += K(X, X_B) @ (dalpha * y_B): the fused CUDA kernel
     (fused_fupdate=True, RBF only; with fused_selection it also writes
     the next round's candidates) or the family's blocked torch
     contraction (kernels.cross_matvec).

The outer loop runs on the host with at most two host synchronisations per
round: one reads the stop check, one reads the inner kernel's status. The
inner loop never returns to the host on the kernel path (the "loop" engine
is the eager port of the reference's while loop, used on unaligned q and for
the zero-progress rescue).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from tpusvm_torch import kernels
from tpusvm_torch.device import resolve_device
from tpusvm_torch.ops.cuda.fused_fupdate import (fused_fupdate_select_kernel,
                                                 rbf_cross_matvec_kernel,
                                                 selection_shape)
from tpusvm_torch.ops.cuda.inner_smo import check_multipair, inner_smo_kernel
from tpusvm_torch.ops.rbf import rbf_cross_matvec, sq_norms
from tpusvm_torch.ops.selection import i_high_mask, i_low_mask
from tpusvm_torch.solver.analytic import pair_update
from tpusvm_torch.status import Status

_LANE = 128


@dataclasses.dataclass
class SMOResult:
    alpha: torch.Tensor   # (n,) accum dtype
    b: float              # (b_high + b_low) / 2
    b_high: float
    b_low: float
    n_iter: int           # total inner updates + 1 (the reference's count)
    status: Status
    n_outer: int          # outer rounds that ran a subproblem
    n_rescue: int         # kernel rounds redone with the loop engine
    n_host_syncs: int     # outer-loop host synchronisations
    host_wait_s: float    # host seconds spent blocked at those syncs


# The JAX solver's knobs that are not ported yet: (JAX default, ROADMAP
# Queue 1 item, what the knob does). At its default a knob asks for what
# the port already does, so a JAX solver_opts dict written out in full
# carries over.
_UNPORTED = {
    "refine": (0, "7(a)", "the exact-f refine before a convergence claim"),
    "shrink_stable": (0, "7(b)", "active-set shrinking"),
    "krow_cache": (0, "7(c)", "the K-row LRU cache"),
    "matmul_precision": (None, "7(d)", "the bf16 contraction rungs"),
    "resume_state": (None, "7(e)", "solver checkpoints"),
    "pause_at": (None, "7(e)", "solver checkpoints"),
    "return_state": (False, "7(e)", "solver checkpoints"),
    "telemetry": (0, "12", "the convergence telemetry ring"),
}

# the JAX package's engine names for inner
_JAX_INNER = {"pallas": "kernel", "xla": "loop"}


def _unported(name: str, value) -> None:
    default, item, what = _UNPORTED[name]
    raise NotImplementedError(
        f"{name}={value!r}: {what} is not ported yet (ROADMAP Queue 1 item "
        f"{item}); the port runs {name}={default!r}")


def _alias(name: str, value, short: str, short_value, default):
    """The value of a JAX knob that also has a short alias."""
    if value is not None and short_value is not None:
        raise ValueError(f"{name} and {short} are one knob; give one of them")
    if value is not None:
        return value
    return default if short_value is None else short_value


def _clamp_q(n: int, q: int) -> int:
    """q clamps to the (even) training-set size; tiny n floors at 2."""
    return min(q, n if n % 2 == 0 else n - 1) if n >= 2 else 2


def resolve_solver_config(n: int, q: int = 1024, inner: str = "auto",
                          fused_fupdate="auto", kernel: str = "rbf"):
    """Effective (q, inner, fused_fupdate) blocked_smo_solve will run.

    q clamps to the even training-set size; "auto" resolves both engines
    to their kernels when q is a multiple of 128 ("kernel" / True), else to
    the plain engines ("loop" / False). The fused f-update computes the RBF
    pipeline only: off RBF "auto" resolves to the family's contraction and
    an explicit True is refused. On a CPU device the kernels' plain
    versions run in their place.
    """
    if inner not in ("auto", "kernel", "loop"):
        raise ValueError(f"inner must be auto|kernel|loop, got {inner!r}")
    if fused_fupdate not in ("auto", True, False):
        raise ValueError(
            f"fused_fupdate must be True, False or 'auto', got {fused_fupdate!r}")
    kernels.validate_family(kernel)
    if kernel != "rbf" and fused_fupdate is True:
        raise ValueError(
            f"fused_fupdate=True implements the RBF pipeline only; "
            f"kernel={kernel!r} uses its own contraction "
            "(use fused_fupdate='auto')"
        )
    q = _clamp_q(n, q)
    aligned = q % _LANE == 0
    if inner == "auto":
        inner = "kernel" if aligned else "loop"
    if fused_fupdate == "auto":
        fused_fupdate = aligned and kernel == "rbf"
    return q, inner, bool(fused_fupdate)


def _inner_smo(K_BB, y_B, a_B, f_B, active_B, C, eps, tau, max_inner,
               wss: int = 1):
    """Pairwise SMO inside the working set, in the accum dtype of f_B.

    The eager port of the reference's loop engine: wss=1 picks i_low by
    first-order argmax f; wss=2 by maximal gain (f_j - b_high)^2 / eta_j
    over violating I_low members with eta > eps (first-order fallback when
    none). It ENDS on a zero-progress pair (INFEASIBLE_UV, NONPOS_ETA,
    STALLED). Returns (a_B_new, n_updates, progress, reason) with python
    scalars.
    """
    adt = f_B.dtype
    K = K_BB.to(adt)
    diag = torch.diagonal(K)
    y = y_B.to(adt)
    a = a_B.clone()
    f = f_B.clone()
    inf = float("inf")
    n_upd = 0
    progress = False
    reason = Status.RUNNING
    while reason == Status.RUNNING:
        m_h = i_high_mask(a, y_B, C, eps, active_B)
        m_l = i_low_mask(a, y_B, C, eps, active_B)
        i_h = int(torch.argmin(torch.where(m_h, f, inf)))
        found = bool(m_h.any() & m_l.any())
        b_h = f[i_h]
        masked_low = torch.where(m_l, f, -inf)
        if wss == 2:
            b_stop = masked_low.max()
            raw_eta = K[i_h, i_h] + diag - 2.0 * K[i_h]
            viol = m_l & (f > b_h) & (raw_eta > eps)
            vg = torch.where(viol, (f - b_h) ** 2
                             / torch.clamp_min(raw_eta, 1e-12), -inf)
            i_l = int(torch.argmax(vg)) if bool(viol.any()) \
                else int(torch.argmax(masked_low))
        else:
            i_l = int(torch.argmax(masked_low))
        b_l = f[i_l]
        gap_l = b_stop if wss == 2 else b_l
        converged = found and bool(gap_l <= b_h + 2.0 * tau)
        proceed = found and not converged
        upd = pair_update(K[i_h, i_h], K[i_l, i_l], K[i_h, i_l], y[i_h],
                          y[i_l], a[i_h], a[i_l], b_h, b_l, C, eps,
                          torch.tensor(proceed, device=f.device))
        f = f + upd.da_h * y[i_h] * K[i_h] + upd.da_l * y[i_l] * K[i_l]
        a[i_h] += upd.da_h
        a[i_l] += upd.da_l
        ok = bool(upd.do_update & ~upd.stalled)
        n_upd += int(ok)
        progress = progress or ok
        if not found:
            reason = Status.NO_WORKING_SET
        elif converged:
            reason = Status.CONVERGED
        elif not bool(upd.feasible):
            reason = Status.INFEASIBLE_UV
        elif not bool(upd.eta_ok):
            reason = Status.NONPOS_ETA
        elif bool(upd.stalled):
            reason = Status.STALLED
        elif n_upd >= max_inner:
            reason = Status.MAX_ITER
    return a, n_upd, progress, reason


def _top_k(key, k: int, largest: bool):
    """Indices of lax.top_k's k picks of the float32 `key` (or of the k
    smallest, as lax.top_k(-key) gives them): by IEEE total order, in
    which -0.0 < +0.0, equal values to the lower index first."""
    bits = key.contiguous().view(torch.int32)
    # flipping the magnitude bits of the negatives makes the int order the
    # float total order
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(order, descending=largest, stable=True).indices[:k]


def select_working_set(f, m_h, m_l, half: int):
    """(B, is_first): q = 2*half indices, I_high's half smallest-f members
    then I_low's half largest-f members not already taken, in lax.top_k's
    order (`_top_k`); is_first marks the first copy of an index picked
    twice.
    """
    n = f.shape[0]
    inf = float("inf")
    key_up = torch.where(m_h, f, inf).to(torch.float32)
    idx_up = _top_k(key_up, half, largest=False)
    # only genuine I_high members count as taken (fillers are not)
    in_up = torch.zeros(n, dtype=torch.bool, device=f.device)
    in_up[idx_up] = m_h[idx_up]
    key_low = torch.where(m_l & ~in_up, f, -inf).to(torch.float32)
    idx_low = _top_k(key_low, half, largest=True)
    B = torch.cat([idx_up, idx_low])
    dup_low = (idx_low[:, None] == idx_up[None, :]).any(dim=1)
    is_first = torch.cat([torch.ones(half, dtype=torch.bool, device=f.device),
                          ~dup_low])
    return B, is_first


def bootstrap_candidates(f, alpha, Y, valid, C, eps, ncand: int):
    """Round-1 candidate lists for fused selection: an exact masked top
    ncand over the full f (what the kernel's per-block epilogue
    approximates every later round), in lax.top_k's order. Returns (up_val, up_idx, low_val, low_idx); fillers are
    +-inf with index 0.
    """
    n = f.shape[0]
    m_h = i_high_mask(alpha, Y, C, eps, valid)
    m_l = i_low_mask(alpha, Y, C, eps, valid)
    key_up = torch.where(m_h, f, float("inf")).to(torch.float32)
    key_lo = torch.where(m_l, f, -float("inf")).to(torch.float32)
    k = min(ncand, n)
    ui = _top_k(key_up, k, largest=False)
    li = _top_k(key_lo, k, largest=True)
    uv, lv = key_up[ui], key_lo[li]
    pad = ncand - k
    if pad:
        uv = torch.cat([uv, uv.new_full((pad,), float("inf"))])
        lv = torch.cat([lv, lv.new_full((pad,), -float("inf"))])
        ui = torch.cat([ui, ui.new_zeros(pad)])
        li = torch.cat([li, li.new_zeros(pad)])
    return uv, ui.to(torch.int32), lv, li.to(torch.int32)


def select_from_candidates(cands, m_h, half: int):
    """(B, is_first) from a candidate pool: the half smallest-value I_high
    candidates, then the half largest-value I_low candidates whose row is
    not a genuine I_high pick, both in lax.top_k's order; filler indices clamp to
    n-1, and is_first marks the first occurrence of each row over all q
    (a row can repeat within a half through clamped fillers).
    """
    up_val, up_idx, low_val, low_idx = cands
    n = m_h.shape[0]
    sel_up = _top_k(up_val, half, largest=False)
    idx_up = torch.clamp(up_idx[sel_up].long(), max=n - 1)
    in_up = torch.zeros(n, dtype=torch.bool, device=m_h.device)
    in_up[idx_up] = m_h[idx_up]
    low_safe = torch.clamp(low_idx.long(), max=n - 1)
    low_key = torch.where(in_up[low_safe], -float("inf"), low_val)
    sel_lo = _top_k(low_key, half, largest=True)
    B = torch.cat([idx_up, low_safe[sel_lo]])
    pos = torch.arange(B.shape[0], device=B.device)
    earlier = (B[:, None] == B[None, :]) & (pos[None, :] < pos[:, None])
    return B, ~earlier.any(dim=1)


def blocked_smo_solve(
    X,
    Y,
    valid=None,
    alpha0=None,
    *,
    sn: Optional[torch.Tensor] = None,
    C: float = 10.0,
    gamma: float = 0.00125,
    eps: float = 1e-12,
    tau: float = 1e-5,
    max_iter: int = 100000,
    q: int = 1024,
    max_outer: int = 5000,
    max_inner: int = 1024,
    warm_start: bool = False,
    f0=None,
    accum_dtype=None,
    inner: str = "auto",
    fused_fupdate="auto",
    wss: int = 1,
    pallas_eta_exclude: Optional[bool] = None,
    pallas_multipair: Optional[int] = None,
    pallas_fused_selection: Optional[bool] = None,
    eta_exclude: Optional[bool] = None,
    multipair: Optional[int] = None,
    fused_selection: Optional[bool] = None,
    selection: str = "auto",
    pallas_layout: str = "packed",
    kernel_fast: bool = True,
    matmul_precision: Optional[str] = None,
    refine: int = 0,
    max_refines: int = 2,
    shrink_stable: int = 0,
    krow_cache: int = 0,
    telemetry: int = 0,
    resume_state=None,
    pause_at=None,
    return_state: bool = False,
    kernel: str = "rbf",
    degree: int = 3,
    coef0: float = 0.0,
    targets=None,
    device="cuda",
) -> SMOResult:
    """Train to the reference's stopping criterion with blocked working sets.

    X (n, d) float32 and Y (n,) in {+1, -1} (tensors or numpy arrays) are
    moved to `device`. valid masks rows out of the problem; alpha0 starts
    from given alphas, with warm_start=True rebuilding f from them (or f0
    supplying that f directly). accum_dtype (default: X's dtype) holds
    alpha and f. sn = sq_norms(X) may be passed to skip its computation.
    max_iter bounds total inner updates, checked between rounds.

    inner: "kernel" = the single-launch subproblem (CUDA on the card, its
    plain version on the CPU), "loop" = the accum-dtype eager loop, "auto"
    = kernel when q % 128 == 0; the JAX names "pallas" and "xla" mean
    "kernel" and "loop". A kernel round that makes no progress is
    redone with the loop engine. fused_fupdate: the fused f-update kernel
    (True), the blocked torch contraction (False), "auto" = as inner.
    wss: 1 = first-order partner, 2 = maximal-gain partner.
    pallas_eta_exclude (kernel engine, wss=2; default False): drop
    degenerate partners from the gain pick. pallas_multipair (kernel
    engine, wss=1; default 1): p > 1 runs the multipair subproblem, p slot
    pairs plus the global pair per iteration; needs (q//128) % (2p) == 0.
    pallas_fused_selection (fused f-update only; default False): the
    f-update kernel also writes per-row-block candidates, and the next
    round selects from them instead of from all n rows; the stop check
    stays exact over the full f. eta_exclude, multipair and
    fused_selection are short aliases of these three; giving a name and
    its alias together raises ValueError.

    The JAX solver's other knobs, so that its solver_opts carry over:
    selection ("auto", "exact" or "approx") always selects exactly, by
    sorts: approx_min_k exists only on the TPU. pallas_layout ("packed"
    or "flat") is accepted and ignored: it picks a vector layout in TPU
    registers, which a CUDA kernel does not have. kernel_fast (linear
    family only) picks the primal f-update (True) or the generic blocked
    one (False), as in the JAX package. matmul_precision None, "float32"
    and "highest" are the port's full-f32 contractions. max_refines caps
    the refines, so, as in the JAX package, it does nothing while refine
    is 0. The knobs that are not ported yet raise NotImplementedError
    naming their ROADMAP Queue 1 item unless they are at their JAX
    default: refine (7(a)), shrink_stable (7(b)), krow_cache (7(c)), the bf16
    matmul_precision rungs (7(d)), resume_state, pause_at and return_state
    (7(e)), telemetry (12).

    kernel, degree, coef0: the family (kernels/): K_BB and, off RBF, the
    f-update and the warm start go through kernels.cross / cross_matvec /
    matvec; the inner kernels read only K_BB, so they run for every
    family. targets: pseudo-targets z replacing the labels in
    f = K(alpha*y) - z (epsilon-SVR); they enter f0 only.
    """
    kernels.validate_family(kernel)
    if kernels.is_approx(kernel):
        raise NotImplementedError(
            f"kernel={kernel!r}: the approximate-kernel feature maps are not "
            "ported yet (ROADMAP Queue 1 item 10)")
    eta_exclude = _alias("pallas_eta_exclude", pallas_eta_exclude,
                         "eta_exclude", eta_exclude, False)
    multipair = _alias("pallas_multipair", pallas_multipair, "multipair",
                       multipair, 1)
    fused_selection = _alias("pallas_fused_selection",
                             pallas_fused_selection, "fused_selection",
                             fused_selection, False)
    inner = _JAX_INNER.get(inner, inner)
    if selection not in ("auto", "exact", "approx"):
        raise ValueError(
            f"selection must be auto|exact|approx, got {selection!r}")
    if pallas_layout not in ("packed", "flat"):
        raise ValueError(
            f"pallas_layout must be packed|flat, got {pallas_layout!r}")
    if matmul_precision not in (None, "float32", "highest"):
        _unported("matmul_precision", matmul_precision)
    for name, value in (("refine", refine),
                        ("shrink_stable", shrink_stable),
                        ("krow_cache", krow_cache), ("telemetry", telemetry),
                        ("resume_state", resume_state),
                        ("pause_at", pause_at),
                        ("return_state", return_state)):
        default = _UNPORTED[name][0]
        at_default = value is None if default is None else value == default
        if not at_default:
            _unported(name, value)
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    if X.dtype != torch.float32:
        X = X.to(torch.float32)
    Y = torch.as_tensor(Y, device=dev).to(torch.int32)
    n = Y.shape[0]
    adt = X.dtype if accum_dtype is None else accum_dtype
    if wss not in (1, 2):
        raise ValueError(f"wss must be 1 or 2, got {wss}")
    q, inner, fused = resolve_solver_config(n, q, inner, fused_fupdate,
                                            kernel)
    if inner == "kernel" and q % _LANE:
        raise ValueError(
            f"inner='kernel' needs the working-set size to be a multiple of "
            f"{_LANE}, but q={q} after clamping to the n={n} training rows; "
            "use inner='auto' to run the loop engine on unaligned problems"
        )
    if eta_exclude and (inner != "kernel" or wss != 2):
        raise ValueError(
            "eta_exclude configures the kernel engine's wss=2 gain pick; "
            f"the effective config here is inner={inner!r}, wss={wss}"
        )
    if multipair != 1:
        if inner != "kernel":
            raise ValueError(
                f"multipair={multipair} is a kernel-engine feature; the "
                f"effective inner engine here is {inner!r} (inner='auto' "
                "resolves to the kernel only when q is a multiple of 128)"
            )
        check_multipair(q, wss, multipair)
    if fused_selection and not fused:
        raise ValueError(
            "fused_selection extends the fused f-update kernel; the "
            "effective fused_fupdate here is False (fused_fupdate='auto' "
            "resolves to the kernel only when q is a multiple of 128)"
        )
    half = q // 2
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, device=dev).to(torch.bool))
    alpha = (torch.zeros(n, dtype=adt, device=dev) if alpha0 is None
             else torch.as_tensor(alpha0, device=dev).to(adt))
    alpha = torch.where(valid, alpha, torch.zeros((), dtype=adt, device=dev))
    yf = Y.to(adt)
    z = yf if targets is None else torch.as_tensor(targets, device=dev).to(adt)
    if not kernels.needs_norms(kernel):
        sn = None
    elif sn is None:
        sn = sq_norms(X)
    kern = dict(gamma=gamma, coef0=coef0, degree=degree)
    if kernel != "rbf":
        def matvec(X, XB, coef, gamma, sn):
            return kernels.cross_matvec(kernel, X, XB, coef, sn=sn,
                                        fast=kernel_fast, **kern)
    else:
        matvec = rbf_cross_matvec_kernel if fused else rbf_cross_matvec
    if f0 is not None:
        f = torch.as_tensor(f0, device=dev).to(adt)
    elif warm_start:
        coef = (alpha * yf).to(X.dtype)
        if kernel == "rbf":
            f = matvec(X, X, coef, gamma, sn).to(adt) - z
        else:
            f = kernels.matvec(kernel, X, coef, **kern).to(adt) - z
    else:
        f = -z
    f = torch.where(valid, f, torch.zeros((), dtype=adt, device=dev))

    if fused_selection:
        sel_block, _, k_cand, ncand = selection_shape(n, X.shape[1], q)
        # invalid rows enter the kernel with y=0, in neither index set
        y_eff = (Y * valid).to(torch.int32)
        cands = bootstrap_candidates(f, alpha, Y, valid, C, eps, ncand)

    nan = float("nan")
    b_high = b_low = nan
    n_updates = n_outer = n_rescue = n_syncs = 0
    wait_s = 0.0
    status = Status.RUNNING
    inf = float("inf")
    while status == Status.RUNNING:
        m_h = i_high_mask(alpha, Y, C, eps, valid)
        m_l = i_low_mask(alpha, Y, C, eps, valid)
        bh = torch.where(m_h, f, inf).min()
        bl = torch.where(m_l, f, -inf).max()
        found_t = m_h.any() & m_l.any()
        conv_t = found_t & (bl <= bh + 2.0 * tau)
        # host sync 1: the stop check
        t_wait = time.perf_counter()
        found, converged, bh_v, bl_v = torch.stack(
            [found_t.to(adt), conv_t.to(adt), bh, bl]).tolist()
        wait_s += time.perf_counter() - t_wait
        n_syncs += 1
        found, converged = bool(found), bool(converged)
        if found:
            b_high, b_low = bh_v, bl_v
        if not found:
            status = Status.NO_WORKING_SET
            break
        if converged:
            status = Status.CONVERGED
            break

        if fused_selection:
            B, is_first = select_from_candidates(cands, m_h, half)
        else:
            B, is_first = select_working_set(f, m_h, m_l, half)
        X_B = X[B]
        y_B = Y[B]
        a_B = alpha[B]
        f_B = f[B]
        # members selected only as +-inf filler (sets smaller than q/2)
        # must not take part in the subproblem
        active_B = valid[B] & is_first & (i_high_mask(a_B, y_B, C, eps)
                                          | i_low_mask(a_B, y_B, C, eps))
        K_BB = kernels.cross(kernel, X_B, X_B, **kern)
        if inner == "kernel":
            # the delta is taken against the f32-quantised baseline: the
            # kernel round-trips alpha through f32, so untouched lanes come
            # back as f32(a_B), not a_B
            a_B_q = a_B.to(torch.float32).to(adt)
            a_new, stat = inner_smo_kernel(
                K_BB, y_B, a_B, f_B, active_B, C, eps, tau,
                max_inner=max_inner, wss=wss, eta_exclude=eta_exclude,
                multipair=multipair)
            da_B = a_new.to(adt) - a_B_q
            # host sync 2: the kernel's status
            t_wait = time.perf_counter()
            upd, progress, reason, _ = stat.tolist()
            wait_s += time.perf_counter() - t_wait
            n_syncs += 1
            if reason < 0:
                raise RuntimeError(
                    "inner_smo kernel tripped its iteration guard "
                    f"(stat={stat.tolist()})")
            progress = bool(progress)
            if not progress:
                # f32 rescue: redo a zero-progress round in the accum dtype
                a_new, upd, progress, reason = _inner_smo(
                    K_BB, y_B, a_B, f_B, active_B, C, eps, tau, max_inner,
                    wss=wss)
                da_B = a_new - a_B
                n_rescue += 1
        else:
            a_new, upd, progress, reason = _inner_smo(
                K_BB, y_B, a_B, f_B, active_B, C, eps, tau, max_inner,
                wss=wss)
            da_B = a_new - a_B

        dcoef = da_B * y_B.to(adt)
        # index_add_, not a scatter-set: an inactive duplicate carries a
        # zero delta, so a doubly-indexed row stays right
        alpha.index_add_(0, B, da_B)
        if fused_selection:
            # the epilogue masks with the post-round alphas, and keys on
            # f32(f) + df
            df, *cands = fused_fupdate_select_kernel(
                X, X_B, dcoef.to(X.dtype), gamma, sn, f.to(torch.float32),
                alpha.to(torch.float32), y_eff, C, eps, block=sel_block,
                k_cand=k_cand)
        else:
            df = matvec(X, X_B, dcoef.to(X.dtype), gamma, sn)
        f = f + df.to(adt)
        n_outer += 1
        n_updates += int(upd)
        if not progress:
            # surface the loop engine's numerical bail-out, STALLED otherwise
            status = (Status(reason) if reason in (Status.INFEASIBLE_UV,
                                                   Status.NONPOS_ETA)
                      else Status.STALLED)
        elif n_updates >= max_iter or n_outer >= max_outer:
            status = Status.MAX_ITER

    return SMOResult(
        alpha=alpha,
        b=(b_high + b_low) / 2.0,
        b_high=b_high,
        b_low=b_low,
        n_iter=n_updates + 1,
        status=status,
        n_outer=n_outer,
        n_rescue=n_rescue,
        n_host_syncs=n_syncs,
        host_wait_s=wait_s,
    )
