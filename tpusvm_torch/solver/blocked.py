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

Around the rounds, as in the JAX package: refine (a convergence claim on
the accumulated f is judged again on an f rebuilt from the live alphas),
shrink_stable (per-row stability counters shrinking_blocked_solve reads),
krow_cache (an LRU cache of K rows for the f-update), matmul_precision (the
f-update's and the K-row refresh's contraction rung, ops/rbf.py:matmul_p),
telemetry (a ring of per-round gap, updates, status and live rows, written
on the device and never read by the solve), and the outer-loop carry
`OuterState`, which holds everything the next round reads, so that a
solve paused with pause_at and resumed with resume_state equals the
uninterrupted solve bit for bit (solver/checkpoint.py, solver/shrink.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tpusvm_torch import kernels
from tpusvm_torch.config import BF16_RUNGS, RAW_BF16
from tpusvm_torch.device import resolve_device
from tpusvm_torch.ops.cuda.fused_fupdate import (fused_fupdate_select_kernel,
                                                 rbf_cross_matvec_kernel,
                                                 selection_shape)
from tpusvm_torch.obs.convergence import ConvergenceTelemetry
from tpusvm_torch.ops.cuda.inner_smo import (boxed_operands, check_multipair,
                                             inner_smo_kernel)
from tpusvm_torch.ops.rbf import coef_matvec, rbf_cross_matvec, sq_norms
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
    n_refines: int = 0    # f rebuilds before a convergence claim (refine)
    cache_hits: Optional[int] = None    # K rows served by the cache
    cache_misses: Optional[int] = None  # K rows computed fresh
    # shrinking_blocked_solve's events (solver/shrink.py), None without it
    shrink_history: Optional[list] = None
    # the convergence ring (telemetry=T > 0), None without it
    telemetry: Optional[ConvergenceTelemetry] = None


@dataclasses.dataclass
class OuterState:
    """The outer loop's carry: everything the next round reads, so a solve
    run in segments (pause_at, then resume_state) equals one run straight
    through, bit for bit. The field names are the JAX package's _OuterState
    names where the meaning is the same; n_rescue, n_host_syncs and
    host_wait_s are the port's own counters. Tensors live on the solve's
    device (numpy arrays after load_solver_state); scalars are python
    numbers."""

    alpha: torch.Tensor       # (n,) accum dtype
    f: torch.Tensor           # (n,) accum dtype
    b_high: float
    b_low: float
    n_updates: int
    n_outer: int
    n_rescue: int
    n_host_syncs: int
    host_wait_s: float
    status: int
    f_exact: bool             # f rebuilt from alpha, no deltas on top since
    n_refines: int
    stable: torch.Tensor      # (n,) int32 stability counters; (0,) when off
    cache: torch.Tensor       # (slots, n) float32 K rows; (0, n) when off
    cache_keys: torch.Tensor  # (slots,) int32 training-row index, -1 empty
    cache_age: torch.Tensor   # (slots,) int32 rounds since last touch
    cache_hits: int
    cache_misses: int
    cand_up_val: torch.Tensor   # fused-selection candidates; (0,) when off
    cand_up_idx: torch.Tensor
    cand_low_val: torch.Tensor
    cand_low_idx: torch.Tensor
    # the convergence ring (telemetry=T; (0,) when off): slot i % T of each
    # holds round i's gap b_low - b_high (accum dtype, NaN without a
    # working set), inner updates, end-of-round status and live rows
    tele_gap: torch.Tensor
    tele_upd: torch.Tensor
    tele_status: torch.Tensor
    tele_active: torch.Tensor
    tele_i: int               # rounds recorded so far

    TENSORS = ("alpha", "f", "stable", "cache", "cache_keys", "cache_age",
               "cand_up_val", "cand_up_idx", "cand_low_val", "cand_low_idx",
               "tele_gap", "tele_upd", "tele_status", "tele_active")

    def to(self, device) -> "OuterState":
        """A copy on `device`: tensors (or numpy arrays) copied, so that the
        solve that resumes from it never writes into this one."""
        out = dataclasses.replace(self)
        for name in self.TENSORS:
            v = getattr(self, name)
            setattr(out, name, torch.as_tensor(v).to(device, copy=True))
        return out

    def arrays(self) -> dict:
        """Every field as a numpy array (one device-to-host copy each)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                           else np.asarray(v))
        return out

    @classmethod
    def from_arrays(cls, arrays) -> "OuterState":
        """The inverse of arrays(): tensors stay numpy until to(device)."""
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name.startswith("tele_") and f.name not in arrays:
                # a carry written before the ring existed: the ring off
                kw[f.name] = (0 if f.name == "tele_i" else
                              np.zeros(0, np.float64 if f.name == "tele_gap"
                                       else np.int32))
                continue
            v = np.asarray(arrays[f.name])
            if f.name in cls.TENSORS:
                kw[f.name] = v
            elif f.name == "f_exact":
                kw[f.name] = bool(v)
            elif f.name in ("b_high", "b_low", "host_wait_s"):
                kw[f.name] = float(v)
            else:
                kw[f.name] = int(v)
        return cls(**kw)


# the JAX package's engine names for inner
_JAX_INNER = {"pallas": "kernel", "xla": "loop"}

# the solver's matmul_precision values; "default" is raw single pass
_SOLVER_PRECISIONS = (None, "float32", "default", "highest", "bf16_f32",
                     "bf16_f32c")
_REDUCED = ("default",) + BF16_RUNGS


def check_precision_pairing(matmul_precision, refine: int, max_refines: int,
                            shrink_stable: int) -> None:
    """The JAX solver's pairing rules for the reduced rungs: raw single pass
    ("default") needs refine > 0 and max_refines >= 1; the bf16 rungs need
    those or shrink_stable > 0 (the shrinking driver re-checks every claim
    on a rebuilt f)."""
    if matmul_precision not in _SOLVER_PRECISIONS:
        raise ValueError(
            f"matmul_precision must be None, 'float32', 'default', "
            f"'highest', 'bf16_f32' or 'bf16_f32c', got {matmul_precision!r}")
    if matmul_precision == "default" and (refine <= 0 or max_refines < 1):
        raise ValueError(
            "matmul_precision='default' (raw single-pass products) "
            "accumulates f drift and must be paired with refine > 0 and "
            "max_refines >= 1 so convergence claims are re-validated on a "
            "full-precision reconstruction")
    if matmul_precision in BF16_RUNGS and (refine <= 0 or max_refines < 1) \
            and shrink_stable <= 0:
        raise ValueError(
            f"matmul_precision={matmul_precision!r} rounds the f-update "
            "operands to bfloat16; accumulated convergence claims need a "
            "full-precision revalidation — pair with refine > 0 and "
            "max_refines >= 1, or run under the shrinking driver "
            "(shrink_stable > 0: solver/shrink.py re-checks every claim on "
            "a rebuilt f at un-shrink)")


def ops_precision(matmul_precision):
    """The ops-layer token of a solver matmul_precision: "default" is
    RAW_BF16, None and the rest pass through."""
    return RAW_BF16 if matmul_precision == "default" else matmul_precision


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


def pad_alpha0(alpha, n: int):
    """Resize a previous solution's alphas to n rows for a warm re-solve.

    The resume-shape helper of warm starts across problem sizes: a donor
    solution transfers to a GROWN training set (successive-halving rungs
    are nested prefixes of one fixed row order, tune/) by giving the new
    rows alpha=0, the state a cold solve starts them in, and to a
    truncated set by dropping the tail rows' alphas. Works on numpy arrays
    and tensors alike (returns the family it was given); truncation
    generally breaks sum(alpha*y) = 0, so callers re-project the seed
    feasible (tune/warm.py:feasible_seed) before passing it as alpha0.
    """
    m = alpha.shape[0]
    if m == n:
        return alpha
    if m > n:
        return alpha[:n]
    if torch.is_tensor(alpha):
        return torch.cat([alpha, alpha.new_zeros(n - m)])
    return np.concatenate([alpha, np.zeros((n - m,), alpha.dtype)])


def resolve_solver_config(n: int, q: int = 1024, inner: str = "auto",
                          fused_fupdate="auto", kernel: str = "rbf",
                          matmul_precision=None, dtype=torch.float32):
    """Effective (q, inner, fused_fupdate) blocked_smo_solve will run.

    q clamps to the even training-set size; "auto" resolves both engines
    to their kernels when q is a multiple of 128 ("kernel" / True), else to
    the plain engines ("loop" / False). The kernels take float32 only, so
    for features of another dtype (X's, which the solve computes in, as the
    JAX solver does) "auto" resolves to the plain engines and an explicit
    kernel engine is refused by name. The fused f-update computes the RBF
    pipeline only: off RBF "auto" resolves to the family's contraction and
    an explicit True is refused. It runs at the trust tier only, so on the
    reduced rungs ("default", "bf16_f32", "bf16_f32c") "auto" resolves to
    the laddered contraction and an explicit True is refused, as in the
    JAX package's resolve_fused_fupdate. On a CPU device the kernels' plain
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
    if fused_fupdate is True and matmul_precision in _REDUCED:
        raise ValueError(
            "fused_fupdate=True cannot honour matmul_precision="
            f"{matmul_precision!r} (the fused kernel runs at the full-f32 "
            "trust tier); use fused_fupdate='auto' or False")
    if dtype != torch.float32:
        for engine, explicit in (("inner_smo (inner='kernel')",
                                  inner == "kernel"),
                                 ("rbf_cross_matvec (fused_fupdate=True)",
                                  fused_fupdate is True)):
            if explicit:
                raise ValueError(
                    f"the {engine} kernel takes float32 features, X is "
                    f"{dtype}; use 'auto' to run the plain engine in X's "
                    "dtype, or pass float32 features")
        inner = "loop" if inner == "auto" else inner
        fused_fupdate = False if fused_fupdate == "auto" else fused_fupdate
    q = _clamp_q(n, q)
    aligned = q % _LANE == 0
    if inner == "auto":
        inner = "kernel" if aligned else "loop"
    if fused_fupdate == "auto":
        fused_fupdate = (aligned and kernel == "rbf"
                         and matmul_precision not in _REDUCED)
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


def _cache_lookup(keys, B, dcoef):
    """(hit, slot_of, all_hit) of the K-row cache for working set B: hit
    marks members with a cached row, slot_of is the first slot holding it,
    all_hit (a 0-d tensor) says whether every member that moved is cached
    (a member with dcoef == 0 contributes nothing to the f-update)."""
    match = keys[None, :] == B[:, None]  # (q, slots)
    hit = match.any(dim=1)
    slot_of = match.to(torch.int8).argmax(dim=1)
    return hit, slot_of, (hit | (dcoef == 0)).all()


def _cache_fupdate(st, lookup, all_hit: bool, dcoef, B, rows_fn,
                   precision=None, dtype=torch.float32):
    """df = K(X, X_B) @ dcoef served from the cache when every moved member
    hits, else from all q rows computed fresh (rows_fn()), which then replace
    the empty slots first and the oldest after them. Updates the cache,
    keys, ages and hit/miss counts of `st` in place; returns df (n,) in
    `dtype` (X's: the rows are stored in f32 and the coefficients taken in
    X's dtype, as in the JAX solver). precision: the coefficient matvec's
    rung (coef_matvec)."""
    hit, slot_of, _ = lookup
    q = dcoef.shape[0]
    dcx = dcoef.to(dtype)
    age = st.cache_age + 1
    if all_hit:
        # an unmoved member's slot_of is arbitrary: its coefficient is 0
        dc = torch.where(hit, dcx, torch.zeros_like(dcx))
        df = coef_matvec(st.cache[slot_of].T.to(dtype), dc, precision)
        age[slot_of[hit]] = 0
        st.cache_hits += q
    else:
        rows = rows_fn().to(torch.float32)
        df = coef_matvec(rows.T.to(dtype), dcx, precision)
        # empty slots first, then the oldest; ties to the lower slot, as
        # lax.top_k orders them, so the q targets are distinct
        score = torch.where(st.cache_keys < 0,
                            torch.full_like(age, 2 ** 30), age)
        tgt = torch.sort(score, descending=True, stable=True).indices[:q]
        st.cache[tgt] = rows
        st.cache_keys[tgt] = B.to(torch.int32)
        age[tgt] = 0
        st.cache_misses += q
    st.cache_age = age
    return df


def rbf_rebuild(X):
    """The RBF contraction of the exact f rebuilds (refine, the shrinking
    driver's): kernel #1 (its plain version on the CPU) for float32 X,
    which is all the kernel takes, else the torch contraction in X's
    dtype."""
    return (rbf_cross_matvec_kernel if X.dtype == torch.float32
            else rbf_cross_matvec)


def refine_f(X, alpha, yf, z, valid, cap: int, *, kernel: str, sn, kern,
             kernel_fast: bool = True):
    """f rebuilt from scratch, K(X, X[idx]) @ (alpha*y)[idx] - z, over the
    `cap` rows of largest |alpha*y| (every nonzero coefficient whenever the
    live count fits the cap; the rest add exactly 0); invalid rows 0. RBF
    runs the fused f-update (kernel #1 on the card, its plain version on the
    CPU) on f32 features, the torch contraction in X's dtype otherwise."""
    coef = alpha * yf
    idx = _top_k(coef.abs().to(torch.float32), cap, largest=True)
    c = coef[idx].to(X.dtype)
    if kernel == "rbf":
        df = rbf_rebuild(X)(X, X[idx], c, kern["gamma"], sn)
    else:
        df = kernels.cross_matvec(kernel, X, X[idx], c, sn=sn,
                                  fast=kernel_fast, **kern)
    f = df.to(alpha.dtype) - z
    return torch.where(valid, f, torch.zeros((), dtype=f.dtype,
                                             device=f.device))


def kernel_delta_in_box(a_B, da_B, C):
    """A kernel round's alpha deltas, pulled back onto [0, C] where a_B +
    delta leaves the box; every other member keeps its delta's bits.

    A seeded solve (a warm refresh's deployed duals, a tune rung's
    padded, re-projected solution) starts from float64 alphas that are
    not float32 values. Its kernel rounds run the boxed subproblem on the
    deltas from them (ops/cuda/inner_smo.py:boxed_operands), whose bounds
    C - a_B are rounded to float32, so a member moved to a bound can land
    off it by that rounding; on the multipair kernel, which takes alpha
    itself, the delta is taken against f32(a_B) and lands off by a_B -
    f32(a_B), up to half a float32 ulp of C. Either way the next pair
    through it would be infeasible (U > V + 1e-12) and end the solve
    INFEASIBLE_UV, so the deltas are pulled back: the fleet's seeded lanes
    (fleet/solve.py) and a seeded refresh's solo solve
    (blocked_smo_solve's internal _seed_in_box, set by serve/refresh.py)
    do it. The JAX fleet runs the loop engine, whose alphas never leave
    the box. A cold solve's alphas are float32 values until a rescue
    round, and it keeps the JAX kernel path's arithmetic. C: a scalar, or
    (lanes, 1) with one C a lane."""
    a = a_B + da_B
    return torch.where(a < 0, -a_B, torch.where(a > C, C - a_B, da_B))


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
    resume_state: Optional[OuterState] = None,
    pause_at: Optional[int] = None,
    return_state: bool = False,
    kernel: str = "rbf",
    degree: int = 3,
    coef0: float = 0.0,
    targets=None,
    device="cuda",
    tracer=None,
    _seed_in_box: bool = False,
):
    """Train to the reference's stopping criterion with blocked working sets.

    X (n, d) and Y (n,) in {+1, -1} (tensors or numpy arrays) are moved to
    `device`; the solve computes in X's dtype, as the JAX solver does, and
    the kernels (float32 only) run for float32 X (resolve_solver_config).
    valid masks rows out of the problem; alpha0 starts
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

    refine (R > 0): a convergence claim on the accumulated f, while the
    live count (alpha > 0) fits min(R, n) and fewer than max_refines
    rebuilds have run, rebuilds f from the top-min(R, n) |alpha*y| rows
    (`refine_f`) and is judged again on that f. The decision rides on the
    stop check's host sync. Refused with fused selection, whose carried
    candidates a rebuilt f would orphan.

    shrink_stable (S > 0): per-row counters of consecutive rounds at a
    bound and unable to join a violating pair at the round's band,
    written every round and never read by the solve (so the solution is
    bit-identical to S = 0); solver/shrink.py reads them between segments.

    krow_cache (slots > 0, slots >= q): a (slots, n) float32 cache of K
    rows keyed by training-row index. A round whose moved members are all
    cached computes its f-update from the cached rows; any miss computes
    all q rows (kernels.rows_at, full-f32 matmul), uses them, and stores
    them in the empty, then oldest, slots. The f-update then takes the
    rows path: fused_fupdate="auto" resolves to it, True is refused.
    SMOResult.cache_hits / cache_misses count rows by source.

    resume_state / pause_at / return_state: the loop in segments.
    pause_at=k stops at the top of the round when n_outer has reached k
    (or the solve ended); return_state=True returns (SMOResult,
    OuterState); resume_state continues from such a state (alpha0,
    warm_start, f0 and targets are then unused: the state is the solve).
    A solve paused and resumed any number of times equals the
    uninterrupted one bit for bit.

    matmul_precision: the rung of the in-loop f-update's contraction and
    of the K-row cache's refresh (ops/rbf.py:matmul_p). None, "float32"
    and "highest" are full f32; "bf16_f32" rounds the operands to
    bfloat16 and sums in f32, "bf16_f32c" adds a compensated pass;
    "default" is the backend's raw single pass (TF32 on a CUDA card, f32
    on the CPU). K_BB, the warm start, the refine rebuilds (kernel #1 for
    RBF) and the row norms stay at full f32, so on a reduced rung #1
    launches in rebuilds only. The fused f-update runs at full f32: on a
    reduced rung fused_fupdate="auto" resolves to the laddered
    contraction and True raises. The pairings are the JAX solver's:
    "default" needs refine > 0 and max_refines >= 1, the bf16 rungs those
    or shrink_stable > 0 (the shrinking driver re-checks each claim).

    telemetry (T > 0): a T-slot ring carried in OuterState; each body
    execution of the outer loop (a round, a refine rebuild, the final
    check) writes its gap b_low - b_high (NaN without a working set), its
    inner updates, its end-of-round status and the live rows (valid rows
    not yet stable for shrink_stable rounds, or all valid rows) into slot
    (round mod T). Written on the device and never read, so the
    trajectory is bit-identical with it on or off and no host sync is
    added; SMOResult.telemetry holds it (obs/convergence.py).

    The JAX solver's other knobs, so that its solver_opts carry over:
    selection ("auto", "exact" or "approx") always selects exactly, by
    sorts: approx_min_k exists only on the TPU. pallas_layout ("packed"
    or "flat") is accepted and ignored: it picks a vector layout in TPU
    registers, which a CUDA kernel does not have. kernel_fast (linear
    family only) picks the primal f-update (True) or the generic blocked
    one (False), as in the JAX package.

    kernel, degree, coef0: the family (kernels/): K_BB and, off RBF, the
    f-update and the warm start go through kernels.cross / cross_matvec /
    matvec; the inner kernels read only K_BB, so they run for every
    family. targets: pseudo-targets z replacing the labels in
    f = K(alpha*y) - z (epsilon-SVR); they enter f0 and the refine
    rebuild only.

    tracer: anything with add_span(name, t0, t1) (obs.trace.Tracer, a
    benchmark's span list) receives the solve's host phases as spans on
    time.perf_counter, tiling the call from its entry to its return:
    solve.setup (the prologue), then per round solve.check (the masks,
    reductions and the flags' stack), solve.check_wait (sync 1 blocked),
    solve.refine (a refine rebuild) or solve.select (the working set and
    its gathers), solve.kbb, solve.inner (#2's launch or the loop engine),
    solve.inner_wait (sync 2 blocked), solve.rescue (a zero-progress round
    redone), solve.fupdate; and solve.finish. The wait spans are exactly
    the intervals host_wait_s sums. The results are the same bits with or
    without a tracer.

    _seed_in_box (internal, set by a seeded refresh): the kernel engine
    runs kernel #2's boxed subproblem on the deltas from the seed's float64
    alphas (the multipair kernel the plain one) and its round deltas are
    pulled back onto [0, C] (kernel_delta_in_box), as the fleet's seeded
    lanes do.
    """
    # each mark ends the span it names where the next one starts
    t_mark = time.perf_counter() if tracer is not None else 0.0

    def mark(name: str, now: Optional[float] = None) -> None:
        nonlocal t_mark
        if tracer is not None:
            now = time.perf_counter() if now is None else now
            tracer.add_span(name, t_mark, now)
            t_mark = now

    kernels.validate_family(kernel)
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
    for name, value in (("refine", refine), ("shrink_stable", shrink_stable),
                        ("krow_cache", krow_cache), ("telemetry", telemetry)):
        if not isinstance(value, int) or value < 0:
            raise ValueError(
                f"{name} must be a non-negative int, got {value!r}")
    check_precision_pairing(matmul_precision, refine, max_refines,
                            shrink_stable)
    prec = ops_precision(matmul_precision)
    if fused_selection and refine:
        raise ValueError(
            "fused_selection carries next-round candidates computed by the "
            "f-update kernel; refine rebuilds f outside the kernel, which "
            "would orphan them — use one or the other")
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    Y = torch.as_tensor(Y, device=dev).to(torch.int32)
    n = Y.shape[0]
    adt = X.dtype if accum_dtype is None else accum_dtype
    if wss not in (1, 2):
        raise ValueError(f"wss must be 1 or 2, got {wss}")
    if krow_cache:
        # the cache serves explicit K rows; the fused f-update never forms
        # them, so the two are exclusive
        if fused_fupdate is True:
            raise ValueError(
                "krow_cache consults explicit K rows before the f-update; "
                "the fused f-update (fused_fupdate=True) never forms rows "
                "to cache — pick one (fused_fupdate='auto' resolves to the "
                "rows path)")
        fused_fupdate = False
    q, inner, fused = resolve_solver_config(n, q, inner, fused_fupdate,
                                            kernel, matmul_precision, X.dtype)
    if krow_cache and krow_cache < q:
        raise ValueError(
            f"krow_cache={krow_cache} slots cannot hold a full working set "
            f"(q={q} after clamping): a miss round stores all q fresh rows "
            "at once — use krow_cache >= q or a smaller q")
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
                                        fast=kernel_fast, precision=prec,
                                        **kern)
    elif fused:
        matvec = rbf_cross_matvec_kernel
    else:
        def matvec(X, XB, coef, gamma, sn):
            return rbf_cross_matvec(X, XB, coef, gamma, sn, precision=prec)
    zero_a = torch.zeros((), dtype=adt, device=dev)
    if fused_selection:
        sel_block, _, k_cand, ncand = selection_shape(n, X.shape[1], q)
        # invalid rows enter the kernel with y=0, in neither index set
        y_eff = (Y * valid).to(torch.int32)

    if resume_state is not None:
        if resume_state.alpha.shape[0] != n:
            raise ValueError(
                f"resume_state is for n={resume_state.alpha.shape[0]} rows, "
                f"this solve has n={n}")
        if resume_state.cache.shape[0] != krow_cache:
            raise ValueError(
                f"resume_state carries a {resume_state.cache.shape[0]}-slot "
                f"K-row cache but this solve has krow_cache={krow_cache}; "
                "resume with the state's setting")
        if shrink_stable and resume_state.stable.shape[0] != n:
            raise ValueError(
                "resume_state carries no stability counters; resume with "
                "the state's shrink_stable setting")
        if fused_selection and resume_state.cand_up_val.shape[0] != ncand:
            raise ValueError(
                "resume_state carries no fused-selection candidates for "
                f"this problem ({resume_state.cand_up_val.shape[0]} of "
                f"{ncand}); resume with the state's fused_selection setting")
        if resume_state.tele_gap.shape[0] != telemetry:
            raise ValueError(
                f"resume_state carries a {resume_state.tele_gap.shape[0]}-"
                "slot telemetry ring but this solve was configured with "
                f"telemetry={telemetry}; resume with the state's telemetry "
                "setting")
        st = resume_state.to(dev)
    else:
        alpha = (torch.zeros(n, dtype=adt, device=dev) if alpha0 is None
                 else torch.as_tensor(alpha0, device=dev).to(adt))
        alpha = torch.where(valid, alpha, zero_a)
        if f0 is not None:
            f = torch.as_tensor(f0, device=dev).to(adt)
        elif warm_start:
            coef = (alpha * yf).to(X.dtype)
            if kernel == "rbf":
                # at full f32 on every rung
                f = (rbf_cross_matvec_kernel if fused else rbf_cross_matvec)(
                    X, X, coef, gamma, sn).to(adt) - z
            else:
                f = kernels.matvec(kernel, X, coef, **kern).to(adt) - z
        else:
            f = -z
        f = torch.where(valid, f, zero_a)
        i32, f32 = torch.int32, torch.float32
        if fused_selection:
            cands = bootstrap_candidates(f, alpha, Y, valid, C, eps, ncand)
        else:
            cands = (torch.zeros(0, dtype=f32, device=dev),
                     torch.zeros(0, dtype=i32, device=dev)) * 2
        nan = float("nan")
        st = OuterState(
            alpha=alpha, f=f, b_high=nan, b_low=nan, n_updates=0, n_outer=0,
            n_rescue=0, n_host_syncs=0, host_wait_s=0.0,
            status=int(Status.RUNNING),
            # -z (cold start), a warm-start rebuild and a given f0 are all
            # f as alpha0 gives it
            f_exact=True, n_refines=0,
            stable=torch.zeros(n if shrink_stable else 0, dtype=i32,
                               device=dev),
            cache=torch.zeros((krow_cache, n), dtype=f32, device=dev),
            cache_keys=torch.full((krow_cache,), -1, dtype=i32, device=dev),
            cache_age=torch.zeros(krow_cache, dtype=i32, device=dev),
            cache_hits=0, cache_misses=0,
            cand_up_val=cands[0], cand_up_idx=cands[1],
            cand_low_val=cands[2], cand_low_idx=cands[3],
            # NaN gaps tell slots never written from real gaps
            tele_gap=torch.full((telemetry,), float("nan"), dtype=adt,
                                device=dev),
            tele_upd=torch.zeros(telemetry, dtype=i32, device=dev),
            tele_status=torch.zeros(telemetry, dtype=i32, device=dev),
            tele_active=torch.zeros(telemetry, dtype=i32, device=dev),
            tele_i=0)

    refine_cap = min(refine, n) if refine > 0 else 0
    inf = float("inf")

    def record(gap_t, upd: int, status: int) -> None:
        """One ring slot: device writes only, no host sync."""
        if not telemetry:
            return
        t = st.tele_i % telemetry
        st.tele_gap[t] = gap_t
        st.tele_upd[t] = upd
        st.tele_status[t] = status
        live = valid & (st.stable < shrink_stable) if shrink_stable else valid
        st.tele_active[t] = live.sum()
        st.tele_i += 1

    mark("solve.setup")
    while st.status == Status.RUNNING and (pause_at is None
                                           or st.n_outer < pause_at):
        alpha, f = st.alpha, st.f
        m_h = i_high_mask(alpha, Y, C, eps, valid)
        m_l = i_low_mask(alpha, Y, C, eps, valid)
        bh = torch.where(m_h, f, inf).min()
        bl = torch.where(m_l, f, -inf).max()
        found_t = m_h.any() & m_l.any()
        conv_t = found_t & (bl <= bh + 2.0 * tau)
        flags = [found_t.to(adt), conv_t.to(adt), bh, bl]
        if refine_cap:
            # a rebuild from the top-cap rows is exact only while every
            # live alpha is among them
            live = ((alpha > 0) & valid).sum()
            flags.append((live <= refine_cap).to(adt))
        stacked = torch.stack(flags)
        # host sync 1: the stop check (and whether a refine fits)
        t_wait = time.perf_counter()
        found, converged, bh_v, bl_v, *fits = stacked.tolist()
        t_done = time.perf_counter()
        st.host_wait_s += t_done - t_wait
        st.n_host_syncs += 1
        mark("solve.check", t_wait)
        mark("solve.check_wait", t_done)
        found, converged = bool(found), bool(converged)
        gap_t = torch.where(found_t, bl - bh, float("nan")) if telemetry \
            else None
        if found:
            st.b_high, st.b_low = bh_v, bl_v
            if shrink_stable:
                # at a bound and unable to join a violating pair at this
                # round's band: written, never read, by the solve
                at_bound = (alpha <= eps) | (alpha >= C - eps)
                unsafe = ((m_h & (f < bl - 2.0 * tau))
                          | (m_l & (f > bh + 2.0 * tau)))
                keep = at_bound & ~unsafe & valid
                st.stable = torch.where(keep, st.stable + 1,
                                        torch.zeros_like(st.stable))
        if not found:
            st.status = int(Status.NO_WORKING_SET)
            record(gap_t, 0, st.status)
            break
        if (refine_cap and converged and not st.f_exact
                and st.n_refines < max_refines and bool(fits[0])):
            # the claim was made on the accumulated f: judge it again on f
            # rebuilt from the alphas
            st.f = refine_f(X, alpha, yf, z, valid, refine_cap,
                            kernel=kernel, sn=sn, kern=kern,
                            kernel_fast=kernel_fast)
            st.f_exact = True
            st.n_refines += 1
            record(gap_t, 0, st.status)
            mark("solve.refine")
            continue
        if converged:
            st.status = int(Status.CONVERGED)
            record(gap_t, 0, st.status)
            break

        if fused_selection:
            cands = (st.cand_up_val, st.cand_up_idx, st.cand_low_val,
                     st.cand_low_idx)
            B, is_first = select_from_candidates(cands, m_h, half)
        else:
            B, is_first = select_working_set(f, m_h, m_l, half)
        X_B = X[B]
        y_B = Y[B]
        a_B = alpha[B]
        f_B = f[B]
        y_Ba = y_B.to(adt)
        # members selected only as +-inf filler (sets smaller than q/2)
        # must not take part in the subproblem
        active_B = valid[B] & is_first & (i_high_mask(a_B, y_B, C, eps)
                                          | i_low_mask(a_B, y_B, C, eps))
        mark("solve.select")
        K_BB = kernels.cross(kernel, X_B, X_B, **kern)
        mark("solve.kbb")
        lookup = None
        if inner == "kernel" and _seed_in_box and multipair == 1:
            # a seeded solve: the boxed subproblem on the deltas from the
            # float64 alphas, pulled back onto [0, C]
            d0, f_c, lo, hi = boxed_operands(a_B, f_B, C, half)
            a_new, stat = inner_smo_kernel(
                K_BB, y_B, d0, f_c, active_B, C, eps, tau,
                max_inner=max_inner, wss=wss, eta_exclude=eta_exclude,
                box=(lo, hi))
            da_B = kernel_delta_in_box(a_B, a_new.to(adt), C)
        elif inner == "kernel":
            # the delta is taken against the f32-quantised baseline: the
            # kernel round-trips alpha through f32, so untouched lanes come
            # back as f32(a_B), not a_B
            a_B_q = a_B.to(torch.float32).to(adt)
            a_new, stat = inner_smo_kernel(
                K_BB, y_B, a_B, f_B, active_B, C, eps, tau,
                max_inner=max_inner, wss=wss, eta_exclude=eta_exclude,
                multipair=multipair)
            da_B = a_new.to(adt) - a_B_q
            if _seed_in_box:
                da_B = kernel_delta_in_box(a_B, da_B, C)
        if inner == "kernel":
            if krow_cache:
                lookup = _cache_lookup(st.cache_keys, B, da_B * y_Ba)
                stat = torch.cat([stat, lookup[2].to(stat.dtype).view(1)])
            # host sync 2: the kernel's status (and the cache's verdict)
            t_wait = time.perf_counter()
            upd, progress, reason, _, *all_hit = stat.tolist()
            t_done = time.perf_counter()
            st.host_wait_s += t_done - t_wait
            st.n_host_syncs += 1
            mark("solve.inner", t_wait)
            mark("solve.inner_wait", t_done)
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
                st.n_rescue += 1
                lookup = None
                mark("solve.rescue")
        else:
            a_new, upd, progress, reason = _inner_smo(
                K_BB, y_B, a_B, f_B, active_B, C, eps, tau, max_inner,
                wss=wss)
            da_B = a_new - a_B
            mark("solve.inner")

        dcoef = da_B * y_Ba
        if krow_cache and lookup is None:
            # the loop engine or a rescue set da_B: one more sync
            lookup = _cache_lookup(st.cache_keys, B, dcoef)
            all_hit = [bool(lookup[2])]
            st.n_host_syncs += 1
        # index_add_, not a scatter-set: an inactive duplicate carries a
        # zero delta, so a doubly-indexed row stays right
        alpha.index_add_(0, B, da_B)
        if krow_cache:
            df = _cache_fupdate(
                st, lookup, bool(all_hit[0]), dcoef, B,
                lambda: kernels.rows_at(kernel, X, B, sn=sn, precision=prec,
                                        **kern), prec, X.dtype)
        elif fused_selection:
            # the epilogue masks with the post-round alphas, and keys on
            # f32(f) + df
            df, *cands = fused_fupdate_select_kernel(
                X, X_B, dcoef.to(X.dtype), gamma, sn, f.to(torch.float32),
                alpha.to(torch.float32), y_eff, C, eps, block=sel_block,
                k_cand=k_cand)
            (st.cand_up_val, st.cand_up_idx, st.cand_low_val,
             st.cand_low_idx) = cands
        else:
            df = matvec(X, X_B, dcoef.to(X.dtype), gamma, sn)
        st.f = f + df.to(adt)
        st.f_exact = False
        st.n_outer += 1
        st.n_updates += int(upd)
        if not progress:
            # surface the loop engine's numerical bail-out, STALLED otherwise
            st.status = int(Status(reason) if reason in (
                Status.INFEASIBLE_UV, Status.NONPOS_ETA) else Status.STALLED)
        elif st.n_updates >= max_iter or st.n_outer >= max_outer:
            st.status = int(Status.MAX_ITER)
        record(gap_t, int(upd), st.status)
        mark("solve.fupdate")

    result = SMOResult(
        alpha=st.alpha,
        b=(st.b_high + st.b_low) / 2.0,
        b_high=st.b_high,
        b_low=st.b_low,
        n_iter=st.n_updates + 1,
        status=Status(st.status),
        n_outer=st.n_outer,
        n_rescue=st.n_rescue,
        n_host_syncs=st.n_host_syncs,
        host_wait_s=st.host_wait_s,
        n_refines=st.n_refines,
        cache_hits=st.cache_hits if krow_cache else None,
        cache_misses=st.cache_misses if krow_cache else None,
        telemetry=(ConvergenceTelemetry(
            gap=st.tele_gap, n_upd=st.tele_upd, status=st.tele_status,
            count=st.tele_i, active=st.tele_active) if telemetry else None),
    )
    mark("solve.finish")
    if return_state:
        return result, st
    return result
