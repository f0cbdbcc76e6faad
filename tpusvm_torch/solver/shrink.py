"""Active-set shrinking: solver work scales with the live set, not n.

The port of tpusvm/solver/shrink.py. Alphas that sit at a box bound and
stay Keerthi-safe for S consecutive rounds almost never move again
(Joachims '98; LIBSVM), so the solver stops carrying them.
shrinking_blocked_solve runs the loop in segments through the solver's
resume_state surface:

  1. run blocked_smo_solve for `shrink_every` outer rounds with
     shrink_stable=S counters in the carry (written, never read, by the
     solve);
  2. at the pause, freeze rows whose counter reached S and compact the
     live rows into a capacity bucket (a power of two, floored at
     shrink_min; buckets only shrink). The bucket's padding rows are
     invalid. The bucket, not the live count, is the compacted problem's
     n, and so decides its q clamp and its inner / fused_fupdate
     resolution, as in the JAX package;
  3. resume on the compacted problem. The live rows' f stays exact: it
     depends on frozen alphas only through terms that no longer change;
  4. when the compacted problem ends, un-shrink: scatter the alphas back,
     rebuild the full f from the nonzero coefficients (`_rebuild_f`: RBF
     runs the fused f-update, kernel #1 on the card), reactivate every row
     and resume on the full problem, whose own Keerthi check then decides,
     so a wrongly frozen alpha is revived, never dropped.

The counters, the host-sync count, the K-row cache's hit counts and the
convergence ring carry across compactions; per-row state is gathered with
the rows.

The bf16 drift guard (matmul_precision "bf16_f32"/"bf16_f32c" with
refine=0, as in the JAX package): bf16 f-update deltas leave a lasting
bias in the accumulated f, so at every pause f is rebuilt at the trust
tier from the alphas (`_rebuild_f`, kernel #1 for RBF), and once the
rebuilt gap is within bf16_anneal_factor x 2 tau the rest of the solve
runs at full f32; a convergence claim of the full problem made at a bf16
rung is judged once more on a rebuilt f (the "verify" event) before it is
accepted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusvm_torch import kernels
from tpusvm_torch.config import BF16_RUNGS
from tpusvm_torch.device import resolve_device
from tpusvm_torch.ops.cuda.fused_fupdate import selection_shape
from tpusvm_torch.solver.blocked import (blocked_smo_solve,
                                         bootstrap_candidates, rbf_rebuild,
                                         resolve_solver_config)
from tpusvm_torch.status import Status

#: kwargs of blocked_smo_solve that shrinking_blocked_solve sets itself
_SEGMENT_KWARGS = ("resume_state", "pause_at", "return_state")


def _bucket(n_live: int, lo: int, hi: int) -> int:
    """Capacity for n_live rows: a power of two, floored at lo, capped at
    hi."""
    cap = max(lo, 1 << max(0, int(n_live - 1).bit_length()))
    return min(cap, hi)


def _rebuild_f(X_eval, X, Y, valid_eval, alpha_np, z_eval, kern_kw, sn_eval):
    """f at the rows of X_eval from scratch, K(X_eval, X[nz]) @ coef - z,
    over a padded bucket of the nonzero alphas of the FULL problem (a power
    of two, at least 64; the padding coefficients are 0), always at the
    trust tier. X_eval is X itself (un-shrink, verify) or a compacted
    bucket (the bf16 rebuild at a pause). coef is formed in f64 and rounded
    to X's dtype, and z is in X's dtype, as in the JAX package's shrinking
    solve. RBF runs the fused f-update (kernel #1 on the card, its plain
    version on the CPU) on f32 features, the torch contraction in X's dtype
    otherwise."""
    n = X.shape[0]
    nz = np.flatnonzero(alpha_np != 0.0)
    cap = min(n, max(64, 1 << max(0, int(len(nz) - 1).bit_length())))
    idx = np.zeros(cap, np.int64)
    idx[:len(nz)] = nz
    coef = np.zeros(cap, np.float64)
    coef[:len(nz)] = alpha_np[nz] * Y.cpu().numpy()[nz].astype(np.float64)
    idx_t = torch.as_tensor(idx, device=X.device)
    coef_t = torch.as_tensor(coef, device=X.device).to(X.dtype)
    kernel = kern_kw["kernel"]
    if kernel == "rbf":
        f = rbf_rebuild(X)(X_eval, X[idx_t], coef_t, kern_kw["gamma"],
                           sn_eval)
    else:
        f = kernels.cross_matvec(
            kernel, X_eval, X[idx_t], coef_t, gamma=kern_kw["gamma"],
            coef0=kern_kw["coef0"], degree=kern_kw["degree"], sn=sn_eval,
            fast=kern_kw["kernel_fast"])
    f = f.to(z_eval.dtype) - z_eval
    return torch.where(valid_eval, f, torch.zeros((), dtype=f.dtype,
                                                  device=f.device))


def _host_gap(f, alpha, Y, valid, C: float, eps: float):
    """b_low - b_high of (f, alpha) on the host, None without a working
    set."""
    f_np = f.cpu().numpy().astype(np.float64)
    a_np = alpha.cpu().numpy().astype(np.float64)
    y_np = Y.cpu().numpy()
    v_np = valid.cpu().numpy()
    m_h = np.where(y_np == 1, a_np < C - eps, (y_np == -1) & (a_np > eps)) & v_np
    m_l = np.where(y_np == 1, a_np > eps, (y_np == -1) & (a_np < C - eps)) & v_np
    if not (m_h.any() and m_l.any()):
        return None
    return float(f_np[m_l].max() - f_np[m_h].min())


def shrinking_blocked_solve(X, Y, valid=None, alpha0=None, *,
                            shrink_every: int = 8, shrink_stable: int = 3,
                            shrink_min: int = 256,
                            shrink_gap_factor: float = 10.0,
                            max_unshrinks: int = 10, targets=None,
                            return_history: bool = False, device="cuda",
                            **kw):
    """blocked_smo_solve with active-set shrinking (module docstring).

    shrink_every: outer rounds between freeze/compaction decisions.
    shrink_stable: consecutive at-bound-and-safe rounds before a row may
    freeze. shrink_min: the smallest bucket. shrink_gap_factor: shrinking
    stops once the Keerthi gap is within this factor of the stopping band
    (a frozen row's stale f makes the judgement unreliable near
    convergence, and re-freezing after each un-shrink can oscillate).
    max_unshrinks: the backstop on re-shrink cycles; after it the solve
    runs unshrunk to the end. Each un-shrink that revealed wrongly frozen
    rows doubles the stability a row needs. matmul_precision="bf16_f32" or
    "bf16_f32c" without refine runs the drift guard (module docstring);
    "default" (raw single pass) is refused: it needs refine, which the
    compacted segments cannot run.

    Takes every blocked_smo_solve kwarg but the segmenting surface
    (resume_state, pause_at, return_state). refine applies to full-problem
    segments only (a compacted rebuild would drop the frozen rows' terms);
    fused_selection composes (its candidates are seeded again on every
    compaction). The result's shrink_history lists its events,
    {"event": "shrink"|"unshrink"|"verify"|"anneal", "round", "active",
    "cap"} ("anneal", the port's own, marks the pause at which a bf16 rung
    gave way to full f32);
    return_history=True also returns it, as (SMOResult, history).
    """
    for k in _SEGMENT_KWARGS:
        if k in kw:
            raise ValueError(
                f"{k} belongs to the shrinking solve's segmenting arguments; "
                "it cannot be passed through shrinking_blocked_solve")
    if shrink_stable < 1:
        raise ValueError(
            f"shrink_stable must be >= 1 round, got {shrink_stable}")
    if shrink_every < 1:
        raise ValueError(
            f"shrink_every must be >= 1 outer round, got {shrink_every}")
    if kw.get("matmul_precision") == "default":
        raise ValueError(
            "matmul_precision='default' (raw single pass) requires refine-"
            "mode drift control, which compacted segments cannot run (a "
            "reconstruction would drop the frozen rows' contributions); use "
            "matmul_precision='bf16_f32' with shrinking — its f32 "
            "accumulation is covered by the un-shrink revalidation")
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    Y = torch.as_tensor(Y, device=dev).to(torch.int32)
    n, d = X.shape
    C = kw.get("C", 10.0)
    eps = kw.get("eps", 1e-12)
    tau = kw.get("tau", 1e-5)
    refine_user = kw.pop("refine", 0)
    max_refines = kw.pop("max_refines", 2)
    krow_cache = kw.get("krow_cache", 0)
    fused_sel = kw.get("pallas_fused_selection",
                       kw.get("fused_selection")) or False
    kern_kw = {
        "kernel": kw.get("kernel", "rbf"),
        "gamma": kw.get("gamma", 0.00125),
        "coef0": kw.get("coef0", 0.0),
        "degree": kw.get("degree", 3),
        "kernel_fast": kw.get("kernel_fast", True),
    }
    # the bf16 rungs anneal: once the rebuilt (trust-tier) gap is within
    # this factor of the stopping band, the tail runs at full f32 (below it
    # the bf16 operand noise outweighs a round's progress)
    bf16_anneal_factor = 50.0
    cur_precision = kw.pop("matmul_precision", None)

    def is_bf16(p) -> bool:
        return p in BF16_RUNGS and refine_user <= 0

    valid_full = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
                  else torch.as_tensor(valid, device=dev).to(torch.bool))
    z_full = (Y if targets is None
              else torch.as_tensor(targets, device=dev)).to(X.dtype)
    sn_full = kw.pop("sn", None)
    if sn_full is None:
        sn_full = kernels.sq_norms_for(kern_kw["kernel"], X)
    i32, f32 = torch.int32, torch.float32
    history = []

    def seg_kw(refine_on: bool) -> dict:
        out = dict(kw, shrink_stable=shrink_stable, device=dev,
                   matmul_precision=cur_precision)
        if refine_on and refine_user > 0:
            out["refine"] = refine_user
            out["max_refines"] = max_refines
        return out

    def seeded(state, f, alpha, Y_c, valid_c, cap_n, **fields):
        """`state` with the carry of a new problem: candidates seeded for
        it, an empty K-row cache, the given per-row fields."""
        if fused_sel:
            q_eff = resolve_solver_config(cap_n, kw.get("q", 1024))[0]
            ncand = selection_shape(cap_n, d, q_eff)[3]
            cands = bootstrap_candidates(f, alpha, Y_c, valid_c, C, eps,
                                         ncand)
        else:
            cands = (torch.zeros(0, dtype=f32, device=dev),
                     torch.zeros(0, dtype=i32, device=dev)) * 2
        return dataclasses.replace(
            state, alpha=alpha, f=f, status=int(Status.RUNNING),
            cache=torch.zeros((krow_cache, cap_n), dtype=f32, device=dev),
            cache_keys=torch.full((krow_cache,), -1, dtype=i32, device=dev),
            cache_age=torch.zeros(krow_cache, dtype=i32, device=dev),
            cand_up_val=cands[0], cand_up_idx=cands[1],
            cand_low_val=cands[2], cand_low_idx=cands[3], **fields)

    # the current problem starts as the full one
    gids = np.arange(n, dtype=np.int64)  # global row id per local row
    X_c, Y_c, valid_c, z_c, sn_c = X, Y, valid_full, z_full, sn_full
    alpha_full = np.zeros(n, np.float64)
    is_full = True
    n_unshrinks = 0
    last_verified = -1  # n_updates at the last bf16 claim's verification

    # first segment: the plain entry (alpha0 / warm_start honoured)
    seg_precision = cur_precision
    res, state = blocked_smo_solve(
        X_c, Y_c, valid=valid_c, alpha0=alpha0, targets=targets, sn=sn_c,
        pause_at=shrink_every, return_state=True, **seg_kw(True))

    while True:  # bounded by max_iter / max_outer inside the solver
        status = Status(state.status)
        valid_np = valid_c.cpu().numpy()
        if status != Status.RUNNING:
            # ---- terminal segment: done, or un-shrink -------------------
            alpha_np = state.alpha.cpu().numpy().astype(np.float64)
            alpha_full[gids[valid_np]] = alpha_np[valid_np]
            unverified = (is_bf16(seg_precision) and status == Status.CONVERGED
                          and last_verified != state.n_updates)
            if is_full and not unverified:
                res.shrink_history = history
                return (res, history) if return_history else res
            # un-shrink (or verify a bf16 claim): rebuild the full f from
            # the scattered-back alphas and let the solver's own global
            # check decide
            event = "verify" if is_full else "unshrink"
            last_verified = state.n_updates
            alpha_dev = torch.as_tensor(alpha_full, device=dev).to(
                state.alpha.dtype)
            alpha_dev = torch.where(valid_full, alpha_dev,
                                    torch.zeros_like(alpha_dev))
            f_dev = _rebuild_f(X, X, Y, valid_full, alpha_full, z_full,
                               kern_kw, sn_full).to(state.f.dtype)
            state = seeded(state, f_dev, alpha_dev, Y, valid_full, n,
                           f_exact=True,
                           stable=torch.zeros(n, dtype=i32, device=dev))
            gids = np.arange(n, dtype=np.int64)
            X_c, Y_c, valid_c, z_c, sn_c = (X, Y, valid_full, z_full,
                                            sn_full)
            is_full = True
            if event == "unshrink":
                n_unshrinks += 1
            history.append({"event": event, "round": state.n_outer,
                            "active": int(valid_full.sum()), "cap": n})
        else:
            # ---- paused: freeze and compact? ----------------------------
            if is_bf16(cur_precision):
                # the drift guard's cadence half: rebuild f at the trust
                # tier at every pause, so the bf16 bias spans one segment
                alpha_np = state.alpha.cpu().numpy().astype(np.float64)
                alpha_full[gids[valid_np]] = alpha_np[valid_np]
                f_c = _rebuild_f(X_c, X, Y, valid_c, alpha_full, z_c,
                                 kern_kw, sn_c)
                state = dataclasses.replace(
                    state, f=f_c.to(state.f.dtype), f_exact=True)
                gap_now = _host_gap(state.f, state.alpha, Y_c, valid_c,
                                    float(C), eps)
                if gap_now is not None and \
                        gap_now <= bf16_anneal_factor * 2.0 * tau:
                    cur_precision = None
                    history.append({"event": "anneal",
                                    "round": state.n_outer,
                                    "active": int(valid_np.sum()),
                                    "cap": len(gids)})
            stable_np = state.stable.cpu().numpy()
            # every un-shrink that revealed wrongly frozen rows doubles the
            # stability a row needs before it may freeze again
            s_eff = shrink_stable * (1 << min(n_unshrinks, 20))
            live = valid_np & (stable_np < s_eff)
            n_live = int(live.sum())
            new_cap = _bucket(n_live, shrink_min, n)
            gap = state.b_low - state.b_high
            gap_ok = not np.isfinite(gap) \
                or gap > shrink_gap_factor * 2.0 * tau
            if gap_ok and n_unshrinks < max_unshrinks \
                    and 0 < n_live < int(valid_np.sum()) \
                    and new_cap < len(gids):
                # write every current alpha back (soon-frozen rows too)
                # before rows leave the problem
                alpha_np = state.alpha.cpu().numpy().astype(np.float64)
                alpha_full[gids[valid_np]] = alpha_np[valid_np]
                live_pos = np.flatnonzero(live)
                pad = new_cap - n_live
                sel_np = np.concatenate([live_pos,
                                         np.zeros(pad, live_pos.dtype)])
                gids = np.concatenate([gids[live_pos],
                                       np.zeros(pad, gids.dtype)])
                sel = torch.as_tensor(sel_np, device=dev)
                vmask = torch.zeros(new_cap, dtype=torch.bool, device=dev)
                vmask[:n_live] = True
                # gathered rows are a fresh tensor; sn travels with them
                X_c = X_c[sel]
                Y_c = torch.where(vmask, Y_c[sel], torch.zeros_like(Y_c[sel]))
                z_c = torch.where(vmask, z_c[sel], torch.zeros_like(z_c[sel]))
                sn_c = None if sn_c is None else sn_c[sel]
                zero_a = torch.zeros((), dtype=state.alpha.dtype, device=dev)
                alpha_c = torch.where(vmask, state.alpha[sel], zero_a)
                f_c = torch.where(vmask, state.f[sel], zero_a)
                stable_c = torch.where(vmask, state.stable[sel],
                                       torch.zeros_like(state.stable[sel]))
                state = seeded(state, f_c, alpha_c, Y_c, vmask, new_cap,
                               stable=stable_c)
                valid_c = vmask
                is_full = False
                history.append({"event": "shrink", "round": state.n_outer,
                                "active": n_live, "cap": new_cap})
        # compacted segments run 4x longer between pauses: a pause there
        # only checks for further shrinkage, and each costs host syncs
        stride = shrink_every if is_full else 4 * shrink_every
        seg_precision = cur_precision
        res, state = blocked_smo_solve(
            X_c, Y_c, valid=valid_c, targets=z_c, sn=sn_c,
            resume_state=state, pause_at=state.n_outer + stride,
            return_state=True, **seg_kw(is_full))
