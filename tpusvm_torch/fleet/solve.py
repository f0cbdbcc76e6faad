"""Batched many-model SMO: B problems over one X in one lockstep solve.

The port of tpusvm/fleet/solve.py. B optimisation problems share X and
differ in (y, C, gamma, valid, alpha0): the ten one-vs-rest heads, a
(C, gamma) sweep, per-tenant heads. The JAX package vmaps its blocked
solver over the problem axis; torch has no vmap over a data-dependent
loop, so here one host loop drives all B lanes in lockstep and every
round's device work is batched on the problem axis:

  1. the Keerthi stop check of every running lane, one host sync;
  2. working-set selection over (lanes, n), the solo solver's stable
     sorts on dim 1 (the same first-occurrence tie-break per lane);
  3. K_BB per lane, with the solo call (kernels.cross at the lane's
     gamma), stacked to (lanes, q, q);
  4. the subproblems in ONE launch of kernel #2 with a problem axis, one
     thread block per lane (ops/cuda/inner_smo.py:inner_smo_batched_kernel),
     its statuses read in the round's second host sync; a lane that
     made no progress is redone on the solo loop engine, as the solo
     solver does;
  5. the f-update: for RBF at full f32 ONE launch of kernel #1 with a
     problem axis (ops/cuda/fused_fupdate.py:rbf_cross_matvec_batched_kernel),
     else the family's contraction per lane (kernels.cross_matvec, at the
     matmul_precision rung).

Kernels #2 and #1 take float32 features. X of another dtype (bfloat16,
float64) runs the fleet's torch lanes: each lane's subproblem on the solo
loop engine and its f-update by the family's contraction, in X's dtype,
as the JAX fleet computes in X's dtype.

A lane that has left RUNNING is frozen: it takes part in no selection and
no launch, and its alpha, f, counters and ring no longer change, as the
JAX per-lane select freezes it. Every per-lane computation above is the
solo solver's on that lane's data, so a lane's bits do not depend on its
companions (the hard no-crosstalk gate of the JAX fleet) and, on the card,
equal the solo blocked fit at inner="kernel" with the fused f-update. A
seeded lane (a warm refresh's, a tune rung's) runs kernel #2's boxed
subproblem on the deltas from its float64 alphas, held to [0, C]
(solver/blocked.py:kernel_delta_in_box), as a seeded refresh's solo solve
does (serve/refresh.py) and a cold solo solve does not: on the float64
alphas themselves float32 cannot tell a member near C from C, nor take a
late step, and such rounds made no progress in the kernel.

Host syncs: two a round for the whole fleet (the stop check and the
kernel statuses). Index lists go to the card through pinned non-blocking
copies (device.host_to_device), so they add none.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpusvm_torch import kernels
from tpusvm_torch.device import host_to_device, resolve_device
from tpusvm_torch.fleet.batch import fleet_opt_errors, pack_problems
from tpusvm_torch.fleet.results import unpack_results
from tpusvm_torch.obs.convergence import ConvergenceTelemetry
from tpusvm_torch.ops.cuda.fused_fupdate import (
    rbf_cross_matvec_batched_kernel, rbf_cross_matvec_kernel)
from tpusvm_torch.ops.cuda.inner_smo import (boxed_operands,
                                             inner_smo_batched_kernel)
from tpusvm_torch.ops.rbf import rbf_cross_matvec, sq_norms
from tpusvm_torch.ops.selection import i_high_mask, i_low_mask
from tpusvm_torch.solver.blocked import (SMOResult, _clamp_q, _inner_smo,
                                         check_precision_pairing,
                                         kernel_delta_in_box, ops_precision,
                                         refine_f)
from tpusvm_torch.status import Status

# the JAX fleet's static surface (tpusvm/fleet/solve.py _FLEET_STATIC):
# every knob here is shared by the whole fleet
_FLEET_STATIC = (
    "q", "max_outer", "max_inner", "warm_start", "accum_dtype",
    "wss", "selection", "refine", "max_refines", "matmul_precision",
    "telemetry", "kernel", "degree", "kernel_fast", "return_state",
)

# knobs fleet_train strips at their inert defaults (fleet/batch.py)
_INERT = ("inner", "fused_fupdate", "krow_cache", "shrink_stable",
          "pallas_fused_selection", "pallas_eta_exclude", "pallas_multipair",
          "resume_state", "pause_at", "return_state", "pallas_layout")


@dataclasses.dataclass
class FleetState:
    """The fleet's carry: every lane's solve state, so that a fleet paused
    with pause_at and resumed with resume_states equals the uninterrupted
    fleet lane by lane, bit for bit. Tensors carry the leading lane axis;
    per-lane scalars are host lists; the last five counters are the
    fleet's own."""

    alpha: torch.Tensor         # (B, n) accum dtype
    f: torch.Tensor             # (B, n) accum dtype
    b_high: List[float]
    b_low: List[float]
    n_updates: List[int]
    n_outer: List[int]
    n_rescue: List[int]
    status: List[int]
    f_exact: List[bool]
    n_refines: List[int]
    tele_gap: torch.Tensor      # (B, T) accum dtype; (B, 0) when off
    tele_upd: torch.Tensor      # (B, T) int32
    tele_status: torch.Tensor   # (B, T) int32
    tele_active: torch.Tensor   # (B, T) int32
    tele_i: List[int]
    seeded: List[bool]          # started from a non-zero alpha0
    n_host_syncs: int = 0
    host_wait_s: float = 0.0
    n_rounds: int = 0           # lockstep rounds (loop body executions)
    lane_rounds: int = 0        # lane subproblems solved, summed
    bucket_rounds: int = 0      # lanes in the bucket, summed over rounds

    _LANE_TENSORS = ("alpha", "f", "tele_gap", "tele_upd", "tele_status",
                     "tele_active")
    _LANE_LISTS = ("b_high", "b_low", "n_updates", "n_outer", "n_rescue",
                   "status", "f_exact", "n_refines", "tele_i", "seeded")

    @property
    def B(self) -> int:
        return self.alpha.shape[0]

    def to(self, device) -> "FleetState":
        """A copy on `device`, so the resumed fleet never writes into this
        one."""
        out = dataclasses.replace(self)
        for name in self._LANE_TENSORS:
            setattr(out, name, getattr(self, name).to(device, copy=True))
        for name in self._LANE_LISTS:
            setattr(out, name, list(getattr(self, name)))
        return out


def _top_k_rows(key: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """solver/blocked.py:_top_k on each row of a (lanes, n) float32 key:
    lax.top_k's picks by IEEE total order, equal keys to the lower index
    (a stable sort, whose order is the same row by row as alone)."""
    bits = key.contiguous().view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(order, dim=1, descending=largest,
                      stable=True).indices[:, :k]


def select_working_sets(f, m_h, m_l, half: int):
    """solver/blocked.py:select_working_set on every row of (lanes, n):
    (B (lanes, q), is_first (lanes, q))."""
    inf = float("inf")
    key_up = torch.where(m_h, f, inf).to(torch.float32)
    idx_up = _top_k_rows(key_up, half, largest=False)
    # only genuine I_high members count as taken (fillers are not)
    in_up = torch.zeros_like(m_h)
    in_up.scatter_(1, idx_up, m_h.gather(1, idx_up))
    key_low = torch.where(m_l & ~in_up, f, -inf).to(torch.float32)
    idx_low = _top_k_rows(key_low, half, largest=True)
    B = torch.cat([idx_up, idx_low], dim=1)
    dup_low = (idx_low[:, :, None] == idx_up[:, None, :]).any(dim=2)
    is_first = torch.cat([torch.ones_like(dup_low), ~dup_low], dim=1)
    return B, is_first


def fleet_smo_solve(
    X,
    Ys,
    valids=None,
    alpha0s=None,
    *,
    Cs,
    gammas,
    sn: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
    tau: float = 1e-5,
    max_iter: int = 100000,
    q: int = 1024,
    max_outer: int = 5000,
    max_inner: int = 1024,
    warm_start: bool = False,
    accum_dtype=None,
    wss: int = 1,
    selection: str = "auto",
    refine: int = 0,
    max_refines: int = 2,
    matmul_precision: Optional[str] = None,
    telemetry: int = 0,
    kernel: str = "rbf",
    degree: int = 3,
    coef0: float = 0.0,
    kernel_fast: bool = True,
    resume_states: Optional[FleetState] = None,
    pause_at: Optional[int] = None,
    return_state: bool = False,
    device="cuda",
):
    """Solve B problems sharing X in one lockstep loop (module docstring).

    Ys (B, n) per-problem labels in {-1, 0, +1} (0 = an inert padding
    lane or a masked row); Cs, gammas (B,) per-problem hyperparameters
    (C is cast to the accumulator dtype, gamma to X's, as the JAX fleet
    casts them); valids (B, n) and alpha0s (B, n) optional per-problem row
    masks and warm seeds (warm_start=True rebuilds f lane by lane from
    them, with the solo f-update). The other knobs are blocked_smo_solve's,
    shared by the fleet; the bf16 rungs need refine (the fleet has no
    shrinking driver). sn: sq_norms(X) if given (RBF only).

    Returns one SMOResult with the problem axis on every field: alpha
    (B, n) tensor, b, b_high, b_low, n_iter, status, n_outer, n_rescue,
    n_refines (B,) numpy arrays, the fleet's n_host_syncs and
    host_wait_s, and the ring (telemetry=T) as (B, T) tensors. pause_at
    stops each lane once ITS n_outer reaches the bound; return_state=True
    returns (SMOResult, FleetState); resume_states continues from such a
    state.
    """
    kernels.validate_family(kernel)
    if wss not in (1, 2):
        raise ValueError(f"wss must be 1 or 2, got {wss}")
    if selection not in ("auto", "exact", "approx"):
        raise ValueError(
            f"selection must be auto|exact|approx, got {selection!r}")
    for name, value in (("refine", refine), ("telemetry", telemetry)):
        if not isinstance(value, int) or value < 0:
            raise ValueError(
                f"{name} must be a non-negative int, got {value!r}")
    check_precision_pairing(matmul_precision, refine, max_refines, 0)
    prec = ops_precision(matmul_precision)
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    # the kernels take float32 X; another dtype runs the torch lanes
    kernel_lanes = X.dtype == torch.float32
    Ys = torch.as_tensor(Ys, device=dev).to(torch.int32)
    if Ys.ndim != 2:
        raise ValueError(
            f"fleet_smo_solve wants Ys of shape (B, n), got "
            f"{tuple(Ys.shape)}; for a single problem use blocked_smo_solve")
    B, n = Ys.shape
    if X.shape[0] != n:
        raise ValueError(
            f"fleet problems carry {n} rows but X has {X.shape[0]}")
    C_host = np.asarray(Cs.cpu() if hasattr(Cs, "cpu") else Cs, np.float64)
    g_host = np.asarray(gammas.cpu() if hasattr(gammas, "cpu") else gammas,
                        np.float64)
    for name, arr in (("Cs", C_host), ("gammas", g_host)):
        if arr.shape != (B,):
            raise ValueError(f"{name} must be one value per problem, shape "
                             f"({B},), got {arr.shape}")
    adt = X.dtype if accum_dtype is None else accum_dtype
    # dtype discipline: C in the accumulator dtype, gamma in X's dtype
    C_acc = torch.tensor(C_host, dtype=adt).tolist()
    g_x = torch.tensor(g_host, dtype=X.dtype).tolist()
    C_dev = host_to_device(C_acc, adt, dev)[:, None]
    C32_dev = host_to_device(C_acc, torch.float32, dev)
    g_dev = host_to_device(g_x, torch.float32, dev)
    q = _clamp_q(n, q)
    half = q // 2
    # the problem-axis f-update computes the RBF pipeline at full f32
    batched_fupdate = (kernel_lanes and kernel == "rbf"
                       and prec in (None, "float32", "highest"))
    if not kernels.needs_norms(kernel):
        sn = None
    elif sn is None:
        sn = sq_norms(X)
    valids = (torch.ones((B, n), dtype=torch.bool, device=dev)
              if valids is None
              else torch.as_tensor(valids, device=dev).to(torch.bool))
    yf = Ys.to(adt)

    def kern(b: int) -> dict:
        return dict(gamma=g_x[b], coef0=coef0, degree=degree)

    if resume_states is not None:
        if resume_states.B != B or resume_states.alpha.shape[1] != n:
            raise ValueError(
                f"resume_states is for {resume_states.B} problems of "
                f"{resume_states.alpha.shape[1]} rows, this fleet has {B} of "
                f"{n}")
        if resume_states.tele_gap.shape[1] != telemetry:
            raise ValueError(
                f"resume_states carries a {resume_states.tele_gap.shape[1]}-"
                f"slot telemetry ring but this fleet has telemetry="
                f"{telemetry}; resume with the state's setting")
        st = resume_states.to(dev)
    else:
        zero_a = torch.zeros((), dtype=adt, device=dev)
        alpha = (torch.zeros((B, n), dtype=adt, device=dev) if alpha0s is None
                 else torch.as_tensor(alpha0s, device=dev).to(adt))
        alpha = torch.where(valids, alpha, zero_a)
        f = -yf
        seeded = ([False] * B if alpha0s is None
                  else alpha.ne(0).any(dim=1).tolist())
        if warm_start and alpha0s is not None:
            # once a solve, lane by lane, with the solo f-update (#1 for
            # RBF at full f32); a cold lane's f is -y exactly
            f = f.clone()
            for b in (b for b in range(B) if seeded[b]):
                coef = (alpha[b] * yf[b]).to(X.dtype)
                if kernel == "rbf":
                    fb = (rbf_cross_matvec_kernel if batched_fupdate
                          else rbf_cross_matvec)(X, X, coef, g_x[b], sn)
                else:
                    fb = kernels.matvec(kernel, X, coef, **kern(b))
                f[b] = fb.to(adt) - yf[b]
        f = torch.where(valids, f, zero_a)
        i32 = torch.int32
        st = FleetState(
            alpha=alpha, f=f, b_high=[float("nan")] * B,
            b_low=[float("nan")] * B, n_updates=[0] * B, n_outer=[0] * B,
            n_rescue=[0] * B, status=[int(Status.RUNNING)] * B,
            f_exact=[True] * B, n_refines=[0] * B,
            tele_gap=torch.full((B, telemetry), float("nan"), dtype=adt,
                                device=dev),
            tele_upd=torch.zeros((B, telemetry), dtype=i32, device=dev),
            tele_status=torch.zeros((B, telemetry), dtype=i32, device=dev),
            tele_active=torch.zeros((B, telemetry), dtype=i32, device=dev),
            tele_i=[0] * B, seeded=seeded)

    refine_cap = min(refine, n) if refine > 0 else 0
    n_valid = valids.sum(dim=1).to(torch.int32)  # the ring's live rows
    inf = float("inf")
    while True:
        R = [b for b in range(B) if st.status[b] == Status.RUNNING
             and (pause_at is None or st.n_outer[b] < pause_at)]
        if not R:
            break
        st.n_rounds += 1
        st.bucket_rounds += B
        Ri = host_to_device(R, torch.long, dev)
        alpha_R, f_R, Y_R, v_R, C_R = (st.alpha[Ri], st.f[Ri], Ys[Ri],
                                       valids[Ri], C_dev[Ri])
        m_h = i_high_mask(alpha_R, Y_R, C_R, eps, v_R)
        m_l = i_low_mask(alpha_R, Y_R, C_R, eps, v_R)
        bh = torch.where(m_h, f_R, inf).amin(dim=1)
        bl = torch.where(m_l, f_R, -inf).amax(dim=1)
        found_t = m_h.any(dim=1) & m_l.any(dim=1)
        conv_t = found_t & (bl <= bh + 2.0 * tau)
        flags = [found_t.to(adt), conv_t.to(adt), bh, bl]
        if refine_cap:
            live = ((alpha_R > 0) & v_R).sum(dim=1)
            flags.append((live <= refine_cap).to(adt))
        gap_R = (torch.where(found_t, bl - bh, float("nan")) if telemetry
                 else None)
        # host sync 1: every running lane's stop check
        t_wait = time.perf_counter()
        found_l, conv_l, bh_l, bl_l, *fits_l = torch.stack(flags).tolist()
        st.host_wait_s += time.perf_counter() - t_wait
        st.n_host_syncs += 1
        rec = []  # ring writes of this round: (lane, position in R, upd)
        P = []    # positions in R of the lanes that run a subproblem
        for j, b in enumerate(R):
            if found_l[j]:
                st.b_high[b], st.b_low[b] = bh_l[j], bl_l[j]
            else:
                st.status[b] = int(Status.NO_WORKING_SET)
            if (found_l[j] and refine_cap and conv_l[j] and not st.f_exact[b]
                    and st.n_refines[b] < max_refines and fits_l[0][j]):
                # the claim on the accumulated f is judged again on f
                # rebuilt from the alphas (kernel #1 for RBF)
                st.f[b] = refine_f(X, st.alpha[b], yf[b], yf[b], valids[b],
                                   refine_cap, kernel=kernel, sn=sn,
                                   kern=kern(b), kernel_fast=kernel_fast)
                st.f_exact[b] = True
                st.n_refines[b] += 1
            elif found_l[j] and conv_l[j]:
                st.status[b] = int(Status.CONVERGED)
            elif found_l[j]:
                P.append(j)
                continue
            rec.append((b, j, 0))
        if P:
            lanes = [R[j] for j in P]
            Pj = host_to_device(P, torch.long, dev)
            Pb = host_to_device(lanes, torch.long, dev)
            a_P, f_P, Y_P, C_P = alpha_R[Pj], f_R[Pj], Y_R[Pj], C_R[Pj]
            Bsel, is_first = select_working_sets(f_P, m_h[Pj], m_l[Pj], half)
            X_B = X[Bsel]
            y_B = Y_P.gather(1, Bsel)
            a_B = a_P.gather(1, Bsel)
            f_B = f_P.gather(1, Bsel)
            y_Ba = y_B.to(adt)
            # members selected only as +-inf filler (sets smaller than
            # q/2) must not take part in the subproblem
            active_B = (v_R[Pj].gather(1, Bsel) & is_first
                        & (i_high_mask(a_B, y_B, C_P, eps)
                           | i_low_mask(a_B, y_B, C_P, eps)))
            # each lane's K_BB by the solo call on a fresh gather of its
            # rows, as the solo round makes it (bit for bit the same)
            K_BB = torch.stack([
                kernels.cross(kernel, Xp, Xp, **kern(b))
                for Xp, b in ((X[Bsel[p]], b) for p, b in enumerate(lanes))])
            if kernel_lanes:
                # a cold lane's delta is taken against the f32-quantised
                # baseline, as the solo kernel round does; a seeded lane
                # runs the boxed subproblem on deltas from its float64
                # alphas, pulled back onto [0, C] (kernel_delta_in_box), as
                # a seeded refresh's solo round does
                a_in, f_in = a_B, f_B
                base, box = a_B.to(torch.float32).to(adt), None
                seeded = [st.seeded[b] for b in lanes]
                if any(seeded):
                    pull = host_to_device(seeded, torch.bool, dev)
                    d0, f_c, lo, hi = boxed_operands(a_B, f_B, C_P, half)
                    a_in = torch.where(pull[:, None], d0.to(adt), a_B)
                    f_in = torch.where(pull[:, None], f_c.to(adt), f_B)
                    base = torch.where(pull[:, None], d0.to(adt), base)
                    box = (lo, hi, pull)
                a_new, stat = inner_smo_batched_kernel(
                    K_BB, y_B, a_in, f_in, active_B, C32_dev[Pb], eps, tau,
                    max_inner=max_inner, wss=wss, box=box)
                da_B = a_new.to(adt) - base
                if box is not None:
                    da_B = torch.where(
                        pull[:, None], kernel_delta_in_box(a_B, da_B, C_P),
                        da_B)
                # host sync 2: the kernel's statuses
                t_wait = time.perf_counter()
                stats = stat.tolist()
                st.host_wait_s += time.perf_counter() - t_wait
                st.n_host_syncs += 1
            else:
                da_B = torch.zeros_like(a_B)
            outcome = []
            for p, b in enumerate(lanes):
                progress = False
                if kernel_lanes:
                    upd, progress, reason, _ = stats[p]
                    if reason < 0:
                        raise RuntimeError(
                            "inner_smo batched kernel tripped its iteration "
                            f"guard on lane {b} (stat={stats[p]})")
                if not progress:
                    # a torch lane, or the f32 rescue of a kernel lane: the
                    # round on the solo loop engine in the accum dtype
                    a_r, upd, progress, reason = _inner_smo(
                        K_BB[p], y_B[p], a_B[p], f_B[p], active_B[p],
                        C_acc[b], eps, tau, max_inner, wss=wss)
                    da_B[p] = a_r - a_B[p]
                    if kernel_lanes:
                        st.n_rescue[b] += 1
                outcome.append((int(upd), bool(progress), reason))
            dcoef = da_B * y_Ba
            # scatter_add: an inactive duplicate carries a zero delta
            st.alpha[Pb] = a_P.scatter_add(1, Bsel, da_B)
            if batched_fupdate:
                df = rbf_cross_matvec_batched_kernel(
                    X, X_B, dcoef.to(X.dtype), g_dev[Pb], sn)
            else:
                df = torch.stack([
                    kernels.cross_matvec(kernel, X, X_B[p],
                                         dcoef[p].to(X.dtype), sn=sn,
                                         fast=kernel_fast, precision=prec,
                                         **kern(b))
                    for p, b in enumerate(lanes)])
            st.f[Pb] = f_P + df.to(adt)
            st.lane_rounds += len(P)
            for (j, b), (upd, progress, reason) in zip(zip(P, lanes),
                                                       outcome):
                st.f_exact[b] = False
                st.n_outer[b] += 1
                st.n_updates[b] += upd
                if not progress:
                    st.status[b] = int(Status(reason) if reason in (
                        Status.INFEASIBLE_UV, Status.NONPOS_ETA)
                        else Status.STALLED)
                elif st.n_updates[b] >= max_iter or st.n_outer[b] >= max_outer:
                    st.status[b] = int(Status.MAX_ITER)
                rec.append((b, j, upd))
        if telemetry and rec:
            # the ring: device writes only, no host sync
            lanes_r = [b for b, _, _ in rec]
            bi = host_to_device(lanes_r, torch.long, dev)
            ti = host_to_device([st.tele_i[b] % telemetry for b in lanes_r],
                                torch.long, dev)
            st.tele_gap[bi, ti] = gap_R[host_to_device([j for _, j, _ in rec],
                                                       torch.long, dev)]
            st.tele_upd[bi, ti] = host_to_device([u for _, _, u in rec],
                                                 torch.int32, dev)
            st.tele_status[bi, ti] = host_to_device(
                [st.status[b] for b in lanes_r], torch.int32, dev)
            st.tele_active[bi, ti] = n_valid[bi]
            for b in lanes_r:
                st.tele_i[b] += 1

    bh_np, bl_np = np.asarray(st.b_high), np.asarray(st.b_low)
    result = SMOResult(
        alpha=st.alpha,
        b=(bh_np + bl_np) / 2.0,
        b_high=bh_np,
        b_low=bl_np,
        n_iter=np.asarray(st.n_updates) + 1,
        status=np.asarray(st.status),
        n_outer=np.asarray(st.n_outer),
        n_rescue=np.asarray(st.n_rescue),
        n_host_syncs=st.n_host_syncs,
        host_wait_s=st.host_wait_s,
        n_refines=np.asarray(st.n_refines),
        telemetry=(ConvergenceTelemetry(
            gap=st.tele_gap, n_upd=st.tele_upd, status=st.tele_status,
            count=np.asarray(st.tele_i), active=st.tele_active)
            if telemetry else None),
    )
    if return_state:
        return result, st
    return result


def fleet_train(
    X,
    Ys: Sequence,
    Cs: Sequence[float],
    gammas: Sequence[float],
    *,
    valids=None,
    alpha0s=None,
    sn=None,
    bucket: Optional[int] = None,
    compact_every: int = 0,
    stats: Optional[dict] = None,
    device="cuda",
    **solver_opts,
) -> List[SMOResult]:
    """Pack -> fleet solve -> per-problem SMOResults.

    Packs the B problems into a power-of-two bucket with inert padding
    lanes (fleet/batch.py), refuses the knobs a fleet cannot honour, solves,
    and unpacks the result into per-problem SMOResults (fleet/results.py).
    solver_opts are fleet_smo_solve's knobs (q, wss, telemetry, kernel, ...)
    plus eps/tau/max_iter; the JAX solver-option names at their inert
    values are accepted and dropped.

    compact_every: accepted for the JAX signature and inert. The JAX fleet
    runs every lane of its bucket each round, so it compacts: R outer
    rounds a segment, the finished lanes harvested, the survivors re-bucketed
    and resumed. Here a lane that has left RUNNING already takes part in no
    selection and no launch, so compaction has nothing left to save: every
    result is the single solve's (R >= 0 is still checked).

    stats (a dict, the port's own): filled with the fleet's counters:
    "rounds" (lockstep rounds), "lane_rounds" (lane subproblems solved),
    "bucket_rounds" (the bucket's lanes summed over rounds: what a program
    that runs frozen lanes would pay), "host_syncs" and "host_wait_s".
    """
    errors = fleet_opt_errors(solver_opts)
    if errors:
        raise ValueError("; ".join(errors))
    if compact_every < 0:
        raise ValueError(
            f"compact_every must be >= 0 rounds, got {compact_every}")
    opts = {k: v for k, v in solver_opts.items() if k not in _INERT}
    batch = pack_problems(Ys, Cs, gammas, valids=valids, alpha0s=alpha0s,
                          bucket=bucket)
    if batch.alpha0s is not None:
        # seeded lanes need the warm-start rebuild; cold lanes' is -y
        opts.setdefault("warm_start", True)
    dev = resolve_device(device)

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    res, st = fleet_smo_solve(
        X, on_dev(batch.Ys), on_dev(batch.valids), on_dev(batch.alpha0s),
        Cs=batch.Cs, gammas=batch.gammas, sn=sn, return_state=True,
        device=dev, **opts)
    if stats is not None:
        stats.update(rounds=st.n_rounds, lane_rounds=st.lane_rounds,
                     bucket_rounds=st.bucket_rounds,
                     host_syncs=st.n_host_syncs, host_wait_s=st.host_wait_s)
    return unpack_results(res, batch.n_problems)
