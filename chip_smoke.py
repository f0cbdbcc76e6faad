#!/usr/bin/env python3
"""Smoke run of tpusvm_torch on one NVIDIA GPU: build, check, train, score.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order (any failure raises and the script exits non-zero):
  1. provenance: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc builds every kernel from tpusvm_torch/csrc, in parallel;
  3. each kernel against its plain torch version on the card, and timed
     (CUDA events, median of >= 10 after warm-up) beside its bound, its
     plain version and, where one exists, a single PyTorch call; the inner
     kernels bit for bit (a_out and all four stat entries) at q=256 and at
     the full-width shape on a cold-start and a mid-solve working set (the
     multipair kernel at p = 2, 4 and 8), and beside measured floors per
     iteration (the reduction chain alone, one iteration's K_BB row reads
     alone, issued as the kernel issues them, and their sum); the f-update
     with candidate selection against the f-update alone (df bit for bit)
     and against the plain selection epilogue; the f-update's kernel
     values against f64 beside a single-pass TF32 product's (the error must
     be under a tenth of that one's, which it is only if the 3xTF32 lo terms
     apply), the f-update itself against f64 beside the plain f32 version's
     (within 3x of it), and its time beside its 3xTF32 bound on the tensor
     cores; the pair solver's K-row refresh (pair_rows) against its plain
     version at n=60000, d=784 for k=2 and k=20 in every exact family, its
     skip path (no row flagged: the rows untouched) and its time, at k=2
     and at k=20, beside its bound and torch.matmul(X[idx], X.T) with the
     epilogue; the fleet's problem-axis launches of #2 and #1 at B=16 lanes
     (mixed gammas and Cs), each lane bit for bit against a solo launch on
     its operands and against the plain versions, timed beside the lanes'
     solo launches and B times the solo bound; the fleet round's K_BB by
     the per-lane solo call beside one torch.bmm (time, bits);
  4. the main path at mid size, trained on the card and on the CPU, held
     to the same SV-ID set, status and b (within 1e-4); 4b. the same for
     the multipair + fused-selection path;
  5. the main path at full width: mnist_like(n=70000, d=784, noise=30,
     label_noise=0.005), BinarySVC on rows [:60000] with C=10,
     gamma=0.00125, q=2048, wss=2, max_inner=4096, f64 accumulators,
     scored on rows [60000:], saved and reloaded; both kernels' launch
     counts are read around this run and must be > 0; the fit's host
     phases (scale, cast, copy, solve, copy back, SV extraction) and the
     solver's time blocked at its host syncs are printed, and one
     {"bench": ...} line records the run as a benchmark (workload, solver
     configuration, train seconds, updates, SVs, accuracy, provenance);
  5b. the second path at full width: the same job with wss=1,
     multipair=4, fused_selection=True and max_iter=10^7; the multipair
     and fused-selection kernels' launch counts are read around it and
     must be > 0, it must end CONVERGED with accuracy within 0.002 of
     phase 5's;
  6. where the time goes: the fits of phases 5 and 5b (5b's first 500
     rounds) once more under torch.profiler, device time by kernel and the
     device's busy share of the wall time;
  7. the pair solver at full width: phase 5's job with solver="pair" and
     max_iter=10^6, counts set to 0 before it and read after (pair_rows
     must have launched, at most one host sync a chunk plus one), CONVERGED,
     accuracy within 0.002 of phase 5's, SV-ID difference and |db| printed;
     the row refresh's share of the fit, from phase 3's kernel time;
  8. one-vs-rest, 10 classes (benchmarks/ovr_10class.py's workload:
     mnist_like_multiclass(n=70000, noise=300), train [:60000], gamma =
     0.00125, f64 accumulators): (a) solver="blocked" (q=2048,
     max_inner=4096, wss=2; kernels #1 and #2 launch for every head) and
     (b) the batched pair solver (pair_rows must have launched; its share
     of an iteration as in phase 7); every head CONVERGED, accuracies within
     0.005, the share of test rows where (a) and (b) agree printed;
  9. tasks and families, cut: epsilon-SVR on svr_sine (20,000 train rows,
     C=10, gamma=20, epsilon=0.1) with both solvers (R^2 > 0.9, held-out
     predictions within 1e-3 of each other); linear and poly (degree 3,
     coef0 1) with both solvers and sigmoid once, on phase 5's data cut to
     10,000 rows; Platt calibration (3 folds) on that cut's RBF model,
     predict_proba monotone in decision_function; a save and load round
     trip of each kind; every pair fit must launch pair_rows;
  10. the front door, cut in rows: phase 5's rows [:10000] and
     [60000:62000] written as CSVs; `python -m tpusvm_torch train --train
     ... --test ...` in a subprocess prints the SV count, b and accuracy of
     an in-process fit on the rows it read, and so does the entry point's
     main in this process with --n-limit 5000; --mode oracle on 2,000 rows
     within the cross-engine band of the blocked
     fit on them; `info` names the card and describes phase 5's artifact;
  11. refine: phase 5's job with refine=4096, max_refines=2, CONVERGED with
     n_refines >= 1, kernel #1 launched in every rebuild, the f64 exact-f
     gap below phase 5's, accuracy within 0.002 of phase 5's;
  12. checkpoints: phase 5's job through BinarySVC.fit(checkpoint_path,
     checkpoint_every=4) stopped after round 8's checkpoint and resumed in
     a fresh estimator, equal to the fit without one bit for bit; the
     solver's carry (alpha and f) across a written checkpoint equal too;
     the write timed;
  13. phase 5's job (a) with shrink_every=2, shrink_stable=3 (kernels #1
     and #2 launch; compactions, un-shrinks and buckets printed) and (b)
     with krow_cache=2048 (#2 launches, the f-update takes cached or fresh
     K rows; hit and miss counts printed), each CONVERGED with accuracy
     within 0.002 of phase 5's, train seconds beside phase 5's;
  14. the cascade on phase 5's job and rows, P=4, sv_capacity 4096, in one
     process: (a) the tree with blocked leaves (phase 5's q, wss and
     max_inner), (b) the star with blocked leaves (layer 2 at 16,384 rows),
     (c) the star with pair leaves; each CONVERGED, accuracy within 0.002 of
     phase 5's, SV-ID Jaccard with phase 5 >= 0.85, every round and every
     leaf solve printed (rows, merged rows, SVs, iterations, status,
     seconds), kernel #1 launched in every blocked leaf solve and #2 (or
     pair_rows) in every leaf solve that updated, and the fit stopped by
     max_rounds with a round checkpoint and resumed equal to it bit for bit;
     (a) also holds #1 at q = the leaf's size (the warm-start rebuild)
     against its plain version; (d) four rank processes of `python -m
     tpusvm_torch train --mode cascade --distributed ...` on CSVs of (a)'s
     rows share the card, and rank 0 prints (a)'s SV count, b, accuracy and
     rounds and writes the only artifact, which `info` describes.
  15. (a) phase 5's job with telemetry=128, equal to phase 5 bit for bit
     (alpha, b, updates, rounds) with no host sync added, its ring's gap
     table printed; (b) phase 5's job at bf16_f32 and at bf16_f32c with
     refine=4096, max_refines=2: CONVERGED, within benchmarks/
     solver_ladder.py's gates (SV flips <= max(2, |SV|/25), |db| <= 1e-3)
     against phase 11, the f32 fit with the same refine (phase 5's own b
     is 1.5e-3 from phase 11's: over the gate), its b within 1e-3 of the
     f64 b of its alphas and that within 1e-3 of phase 11's (a second
     baseline computed in f64 torch, not by the rebuilds' kernel #1), its
     f64 exact-f gap
     within phase 11's f32 evaluation floor max(2 tau, 4e-7 sum(alpha)),
     within 0.002 of phase 5's accuracy, #1
     launched only in the refine rebuilds and #4 never; (c) phase 13(a)'s shrinking job at
     bf16_f32 (the drift guard): CONVERGED, its rebuilds, anneal round,
     un-shrinks and gates against 13(a) printed;
  16. the fleet: phase 8's ten heads at full width with solver="fleet"
     (q=2048, max_inner=4096, wss=2), once with compact_every=0 and once
     with 4: every head CONVERGED with 8(a)'s SV-ID set, status and held-out
     accuracy, |db| <= 1e-4; the problem-axis #1 and #2 launched and no solo
     #2; host syncs <= 2 a round; each head's bits unchanged with the heads
     in reverse order in the same bucket; compact_every=4 (accepted for the
     JAX signature, inert in the port, where a finished lane already runs
     nothing) changes no bit, round or launch; train seconds beside 8(a)'s
     and lane-rounds printed.
  (Phases 15 and 16 run after 13, before 14.)
Then one JSON line of kernel figures, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is present or the package is not beside this script.
"""

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

# published rates of the H100 SXM part (NVIDIA data sheet, dense, at its
# 700 W limit): f32 on the FMA units, device-memory bandwidth, and TF32 on
# the tensor cores
_PEAKS = {"NVIDIA H100 80GB HBM3": (67.0e12, 3.35e12, 495.0e12)}
C, GAMMA = 10.0, 0.00125
# the depth cuts of phases 8 and 9 (PERF.md section 4): training rows of
# the lockstep one-vs-rest pair fit and of the epsilon-SVR pair fit
N_OVR_PAIR = 60000
N_SVR_PAIR = 2000
# the depth cut of phase 6 (PERF.md section 4): the profiled 5b fit stops
# after this many of its 2,183 rounds
PROFILE_5B_ROUNDS = 500
# the row cuts of phase 10 (PERF.md section 4): the training CSV, its
# --n-limit run, the --mode oracle run, and the held-out CSV
N_CSV, N_CSV_LIMIT, N_ORACLE, N_CSV_TEST = 10000, 5000, 2000, 2000


def log(msg):
    print(msg, flush=True)


class PhaseClock:
    """Logs the wall seconds each phase took, so a slow run shows where."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phases):
        now = time.perf_counter()
        log(f"[time] phases {phases}: {now - self.t:.1f} s")
        self.t = now


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def peaks(name):
    if name not in _PEAKS:
        raise AssertionError(
            f"no peak rates for {name!r}: bounds are only known for "
            f"{sorted(_PEAKS)}")
    return _PEAKS[name]


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() over reps CUDA-event-timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_us(fn, reps=20):
    """Microseconds the host spends in one fn() that only launches work: the
    mean over reps calls made back to back, with no wait for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def precision_errors(kernel, plain, X, XB, coef, gamma, sn):
    """Max |err| against the same function in f64 of the f-update at
    `gamma` (`kernel`, the f32 `plain` version, and a single-pass TF32
    product with the plain epilogue), and of kernel values K(x_i, xb_k) of
    four columns at gamma = 1 / median d2 (the kernel run with a one-hot
    coef, which adds exact zeros), where the contraction's error shows above
    f32's rounding of the rest. Returns (fupdate errors, kernel-value
    errors, the four gammas). TF32 is switched on for the one product and
    off again."""
    import torch

    X64, XB64 = X.double(), XB.double()
    d2_64 = ((X64 * X64).sum(1)[:, None] + (XB64 * XB64).sum(1)[None, :]
             - 2.0 * (X64 @ XB64.T)).clamp_min(0.0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dot_tf32 = X @ XB.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    snB = (XB * XB).sum(1)
    d2_tf32 = (sn[:, None] + snB[None, :] - 2.0 * dot_tf32).clamp_min(0.0)

    def err(out, ref):
        return float((out.double() - ref).abs().max())

    ref = torch.exp(-gamma * d2_64) @ coef.double()
    fupdate = {"kernel": err(kernel(X, XB, coef, gamma, sn), ref),
               "plain f32": err(plain(X, XB, coef, gamma, sn), ref),
               "single-pass TF32": err(torch.exp(-gamma * d2_tf32) @ coef, ref)}
    q = XB.shape[0]
    values = dict.fromkeys(fupdate, 0.0)
    gammas = []
    for k in (0, q // 3, 2 * q // 3, q - 1):
        g = 1.0 / float(d2_64[:, k].median())
        gammas.append(g)
        e_k = torch.zeros_like(coef)
        e_k[k] = 1.0
        ref = torch.exp(-g * d2_64[:, k])
        for name, out in (("kernel", kernel(X, XB, e_k, g, sn)),
                          ("plain f32", plain(X, XB, e_k, g, sn)),
                          ("single-pass TF32", torch.exp(-g * d2_tf32[:, k]))):
            values[name] = max(values[name], err(out, ref))
    return fupdate, values, gammas


def pair_rows_bound_ms(n, d, k, peak_flops, peak_bw):
    """pair_rows' bound in ms: X read once, sn read and k rows written at
    the memory rate, against 2*k*n*d flops at the f32 FMA rate; the
    larger."""
    return max(4.0 * (n * d + n + k * n) / peak_bw,
               2.0 * k * n * d / peak_flops) * 1e3


def device_ms_by_kernel(fn):
    """fn() under torch.profiler: ({kernel name: device ms}, {kernel name:
    launches}, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_kernel, count = {}, {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    return by_kernel, count, wall_ms


def refresh_share(tag, kernel_ms, refreshes, train_s):
    """The K-row refresh's share of a pair fit: refreshes x phase 3's
    kernel time over the train time (a profiler over the fit would cost
    more than the fit)."""
    log(f"{tag} row refresh: {refreshes} refreshes x {kernel_ms:.4f} ms (phase "
        f"3) = {refreshes * kernel_ms / 1e3:.3f} s of {train_s:.3f} s "
        f"({100 * refreshes * kernel_ms / 1e3 / train_s:.1f}%)")


def rows_by_matmul(family, X, idx, sn, kw):
    """K(X[idx], X) by one torch.matmul(X[idx], X.T) and the family's
    epilogue: pair_rows' library yardstick (no need flags, no fixed
    per-row order)."""
    import torch

    dots = torch.matmul(X[idx], X.T)
    g = kw.get("gamma", 0.0)
    if family == "rbf":
        return torch.exp(-g * (sn[idx][:, None] + sn[None, :] - 2.0 * dots)
                         .clamp_min(0.0))
    if family == "linear":
        return dots
    if family == "poly":
        return (g * dots + kw["coef0"]) ** kw["degree"]
    return torch.tanh(g * dots + kw["coef0"])


def inner_working_sets(X, Y, sn, q, dev):
    """The inner kernels' inputs at full width: the first round's working
    set (the tie-heavy cold start f = -y) and the fourth round's (after three
    rounds of the wss=2 solve: nonzero alphas, f from them), each as
    (K_BB, y_B, a_B, f_B, active_B). Returns (cold, round4, B, alpha3, f3):
    B the first round's working set, alpha3 and f3 the state after three
    rounds."""
    import torch
    from tpusvm_torch.ops.cuda.fused_fupdate import rbf_cross_matvec_kernel
    from tpusvm_torch.ops.rbf import rbf_cross
    from tpusvm_torch.ops.selection import i_high_mask, i_low_mask
    from tpusvm_torch.solver.blocked import blocked_smo_solve, select_working_set

    def working_set(alpha, f):
        return select_working_set(f, i_high_mask(alpha, Y, C, 1e-12),
                                  i_low_mask(alpha, Y, C, 1e-12), q // 2)

    n = X.shape[0]
    alpha0 = torch.zeros(n, dtype=torch.float64, device=dev)
    B, _ = working_set(alpha0, -Y.to(torch.float64))
    XB, y_B = X[B].contiguous(), Y[B]
    cold = (rbf_cross(XB, XB, GAMMA), y_B, torch.zeros(q, device=dev), -y_B.float(),
            torch.ones(q, dtype=torch.bool, device=dev))
    res3 = blocked_smo_solve(X, Y, C=C, gamma=GAMMA, q=q, wss=2, max_inner=4096,
                             max_outer=3, accum_dtype=torch.float64, device=dev)
    alpha3 = res3.alpha
    yd = Y.to(torch.float64)
    f3 = rbf_cross_matvec_kernel(X, X, (alpha3 * yd).float(), GAMMA, sn).double() - yd
    B4, first4 = working_set(alpha3, f3)
    a_B4, y_B4 = alpha3[B4], Y[B4]
    act4 = first4 & (i_high_mask(a_B4, y_B4, C, 1e-12)
                     | i_low_mask(a_B4, y_B4, C, 1e-12))
    round4 = (rbf_cross(X[B4], X[B4], GAMMA), y_B4, a_B4, f3[B4], act4)
    return cold, round4, B, alpha3, f3


def exact_b(model, X, Y, device):
    """(b_high, b_low) of a fitted RBF BinarySVC recomputed in f64 from its
    own SVs over the training rows X (raw) and labels Y: how far the
    solver's incrementally updated f drifted from the f its alphas give."""
    import torch

    f64 = torch.float64
    Xs = torch.as_tensor(model.scaler_.transform(np.asarray(X)), dtype=f64,
                         device=device)
    sv = torch.as_tensor(model.sv_X_, dtype=f64, device=device)
    coef = torch.as_tensor(model.sv_alpha_ * model.sv_Y_, dtype=f64, device=device)
    y = torch.as_tensor(Y, dtype=f64, device=device)
    d2 = ((Xs * Xs).sum(1)[:, None] + (sv * sv).sum(1)[None, :]
          - 2.0 * (Xs @ sv.T)).clamp_min(0.0)
    f = torch.exp(-model.config.gamma * d2) @ coef - y
    alpha = torch.zeros(len(Y), dtype=f64, device=device)
    alpha[torch.as_tensor(model.sv_ids_, dtype=torch.int64, device=device)] = (
        torch.as_tensor(model.sv_alpha_, dtype=f64, device=device))
    C_, eps = model.config.C, model.config.eps
    pos = y > 0
    m_high = torch.where(pos, alpha < C_ - eps, alpha > eps)
    m_low = torch.where(pos, alpha > eps, alpha < C_ - eps)
    b_high = float(torch.where(m_high, f, float("inf")).min())
    b_low = float(torch.where(m_low, f, -float("inf")).max())
    return b_high, b_low


def phase_pair(X_all, Y_all, n_tr, counters, m5, acc5, device, k2_ms=None):
    """Phase 7: the binary pair solver on phase 5's job, the launch counts
    set to 0 before it and read after; on the card, the row refresh's share
    of an iteration (k2_ms: phase 3's pair_rows time at k=2). Returns
    (model, pair_rows launches)."""
    import torch
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.status import Status

    for fn in counters.values():
        fn.launches = 0
    model = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6), solver="pair",
                      device=device)
    sync(device)
    t = time.perf_counter()
    model.fit(X_all[:n_tr], Y_all[:n_tr])
    sync(device)
    train_s = time.perf_counter() - t
    counts = {k: fn.launches for k, fn in counters.items()}
    res = model.result_
    acc = float((model.predict(X_all[n_tr:]) == Y_all[n_tr:]).mean())
    its = model.n_iter_
    log(f"[7] pair solver, n={n_tr} d={X_all.shape[1]} C={C} gamma={GAMMA} "
        f"max_iter=10^6: train {train_s:.3f} s, status {model.status_.name}, "
        f"iterations {its} ({its / train_s:.0f}/s), row refreshes "
        f"{res.row_refreshes}, host syncs {res.host_syncs} ({res.chunks} chunks "
        f"of {res.chunk}, CUDA graph {res.graphed}), blocked at them "
        f"{res.host_wait_s:.3f} s, SV count {model.n_support_}, b "
        f"{model.b_:.15f}, accuracy {acc:.4f} on {len(Y_all) - n_tr}, launches "
        f"{counts}")
    log(f"[7] against phase 5's model: accuracy {acc:.4f} vs {acc5:.4f}, SV-ID "
        f"symmetric difference {len(set(m5.sv_ids_) ^ set(model.sv_ids_))} of "
        f"{m5.n_support_}, |db| {abs(m5.b_ - model.b_):.3e}")
    for name, m in (("phase 5 (blocked)", m5), ("phase 7 (pair)", model)):
        bh, bl = exact_b(m, X_all[:n_tr], Y_all[:n_tr], device)
        log(f"[7] {name}: b from its own SVs in f64 {(bh + bl) / 2:.15f} (the "
            f"solver's b {m.b_:.15f}, |diff| {abs((bh + bl) / 2 - m.b_):.3e}); "
            f"f64 b_low - b_high {bl - bh:.3e} (2 tau = 2e-5)")
    if k2_ms is not None:
        refresh_share("[7]", k2_ms, res.row_refreshes, train_s)
    check(model.status_ == Status.CONVERGED, f"[7] {model.status_.name}")
    check(counts["pair_rows"] > 0 or device == "cpu",
          f"[7] pair_rows not launched: {counts}")
    check(res.host_syncs <= res.chunks + 1, f"[7] {res.host_syncs} host syncs "
          f"for {res.chunks} chunks")
    check(abs(acc - acc5) <= 0.002, f"[7] accuracy {acc} vs phase 5 {acc5}")
    return model, counts["pair_rows"]


# the blocked one-vs-rest heads of phases 8(a) and 16
OVR_OPTS = dict(q=2048, max_inner=4096, wss=2)


def phase_ovr(Xm, lm, n_tr, n_pair, counters, device, k20_ms=None):
    """Phase 8: ten one-vs-rest heads, (a) blocked on the first n_tr rows
    and (b) the batched pair solver on the first n_pair (with (a) again at
    n_pair to compare with, when that is a cut); all scored on Xm[n_tr:];
    on the card, (b)'s row refresh share of an iteration (k20_ms: phase 3's
    pair_rows time at k=20). Returns (b)'s model and (a)'s (model,
    held-out predictions, accuracy)."""
    import torch
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import OneVsRestSVC
    from tpusvm_torch.status import Status

    ovr = {}
    runs = [("a", "blocked", OVR_OPTS, n_tr), ("b", "pair", {}, n_pair)]
    if n_pair < n_tr:
        runs.insert(1, ("a'", "blocked", OVR_OPTS, n_pair))
    for label, solver, sopts, n_fit in runs:
        for fn in counters.values():
            fn.launches = 0
        m = OneVsRestSVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                         solver=solver, solver_opts=sopts, device=device)
        sync(device)
        t = time.perf_counter()
        m.fit(Xm[:n_fit], lm[:n_fit])
        sync(device)
        secs = time.perf_counter() - t
        counts = {k: fn.launches for k, fn in counters.items()}
        pred = m.predict(Xm[n_tr:])
        acc = float((pred == lm[n_tr:]).mean())
        ovr[label] = (m, pred, acc)
        sts = [Status(int(v)).name for v in m.statuses_]
        log(f"[8{label}] one-vs-rest {len(m.classes_)} classes n={n_fit} "
            f"d={Xm.shape[1]} solver={solver} {json.dumps(sopts)}: train "
            f"{secs:.3f} s, accuracy {acc:.4f} on {len(lm) - n_tr}, SV union "
            f"{len(m.X_sv_)}, launches {counts}")
        log(f"[8{label}] heads: status {sts}, SVs "
            f"{[int((c != 0).sum()) for c in m.coef_]}, iterations "
            f"{[int(v) for v in m.n_iter_]}")
        if solver == "pair":
            r = m.results_
            log(f"[8b] lockstep: {r.chunks} chunks, host syncs {r.host_syncs}, "
                f"row refreshes {r.row_refreshes.tolist()}, CUDA graph {r.graphed}")
            check(counts["pair_rows"] > 0 or device == "cpu",
                  f"[8b] pair_rows not launched {counts}")
            if k20_ms is not None:
                # the busiest head's refreshes: a launch makes an X pass
                # when any head needs a row
                refresh_share("[8b]", k20_ms, int(r.row_refreshes.max()), secs)
        else:
            heads = len(m.classes_)
            check(device == "cpu" or (counts["fused_fupdate"] >= heads
                                      and counts["inner_smo"] >= heads),
                  f"[8a] kernels #1 and #2 not launched for every head: {counts}")
        check(all(v == "CONVERGED" for v in sts), f"[8{label}] heads {sts}")
    ref = "a'" if n_pair < n_tr else "a"
    (_, pa, acca), (mb, pb, accb) = ovr[ref], ovr["b"]
    log(f"[8] blocked ({ref}) against pair (b), n={n_pair}: accuracy {acca:.4f} vs "
        f"{accb:.4f}, test rows predicted alike {float((pa == pb).mean()):.4f}")
    check(abs(acca - accb) <= 0.005, f"[8] accuracies {acca} vs {accb}")
    return mb, ovr["a"]


def phase_tasks(X_all, Y_all, n_tr, n_cut, Xr, tr, n_svr, n_svr_pair, Xm_test,
                pair_model, ovr_model, device, counters):
    """Phase 9, cut in depth: epsilon-SVR, blocked on n_svr rows and both
    solvers on n_svr_pair (when that is a cut), held out Xr[n_svr:]; linear
    and poly with both solvers and sigmoid once on the first n_cut rows;
    Platt calibration of that cut's RBF model; a save and load of each
    kind. Every pair fit must launch pair_rows (counts set to 0 before it
    and read after)."""
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC, EpsilonSVR, load_any
    from tpusvm_torch.ops.cuda import _build
    from tpusvm_torch.status import Status

    blocked_opts = dict(q=2048, max_inner=4096, wss=2)
    svr = {}
    runs = [("blocked", blocked_opts, n_svr), ("pair", {}, n_svr_pair)]
    if n_svr_pair < n_svr:
        runs.insert(1, ("blocked", blocked_opts, n_svr_pair))
    def pair_launched(tag, solver):
        launched = counters["pair_rows"].launches
        check(solver != "pair" or device == "cpu" or launched > 0,
              f"[9] {tag}: pair_rows not launched")
        return launched

    for solver, sopts, n_fit in runs:
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        m = EpsilonSVR(SVMConfig(C=10.0, gamma=20.0, epsilon=0.1, max_iter=10**6),
                       solver=solver, solver_opts=sopts,
                       device=device).fit(Xr[:n_fit], tr[:n_fit])
        secs = time.perf_counter() - t
        r2 = m.score(Xr[n_svr:], tr[n_svr:])
        svr[(solver, n_fit)] = (m, m.predict(Xr[n_svr:]))
        log(f"[9] SVR svr_sine n={n_fit} (held out [{n_svr}:{len(tr)}]) d=1 C=10 "
            f"gamma=20 epsilon=0.1 solver={solver}: train {secs:.3f} s, status "
            f"{m.status_.name}, iterations {m.n_iter_}, SVs {m.n_support_}, "
            f"R^2 {r2:.4f}, pair_rows launches {pair_launched('SVR', solver)}")
        check(m.status_ == Status.CONVERGED, f"[9] SVR {solver}: {m.status_.name}")
        check(r2 > 0.9, f"[9] SVR {solver}: R^2 {r2}")
    dsvr = float(np.abs(svr[("blocked", n_svr_pair)][1]
                        - svr[("pair", n_svr_pair)][1]).max())
    log(f"[9] SVR blocked against pair, n={n_svr_pair}: max |d prediction| "
        f"{dsvr:.3e} on {len(tr) - n_svr} rows")
    check(dsvr <= 1e-3, f"[9] SVR solvers differ by {dsvr}")

    Xc, Yc = X_all[:n_cut], Y_all[:n_cut]
    Xt, Yt = X_all[n_tr:], Y_all[n_tr:]
    fam_models = {}
    for fam, fkw, solvers in (("linear", {}, ("blocked", "pair")),
                              ("poly", dict(degree=3, coef0=1.0), ("blocked", "pair")),
                              ("sigmoid", dict(coef0=0.0), ("blocked",))):
        for solver in solvers:
            for fn in counters.values():
                fn.launches = 0
            t = time.perf_counter()
            m = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6, kernel=fam,
                                    **fkw), solver=solver,
                          solver_opts=blocked_opts if solver == "blocked" else {},
                          device=device)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                m.fit(Xc, Yc)
            secs = time.perf_counter() - t
            fam_models[(fam, solver)] = m
            log(f"[9] {fam} {json.dumps(fkw)} n={n_cut} (cut from {n_tr}) "
                f"d={X_all.shape[1]} solver={solver}: train {secs:.3f} s, status "
                f"{m.status_.name}, iterations {m.n_iter_}, SVs {m.n_support_}, "
                f"b {m.b_:.9f}, accuracy {m.score(Xt, Yt):.4f} on {len(Yt)}, "
                f"pair_rows launches {pair_launched(fam, solver)}")
            if fam != "sigmoid":
                check(m.status_ == Status.CONVERGED,
                      f"[9] {fam} {solver}: {m.status_.name}")
    rbf_cut = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                        solver_opts=blocked_opts, device=device).fit(Xc, Yc)
    t = time.perf_counter()
    rbf_cut.calibrate(Xc, Yc, folds=3)
    secs = time.perf_counter() - t
    proba = rbf_cut.predict_proba(Xt)
    order = np.argsort(rbf_cut.decision_function(Xt), kind="stable")
    monotone = bool(np.all(np.diff(proba[order, 1]) >= 0))
    log(f"[9] Platt calibration, 3 folds, RBF n={n_cut}: {secs:.3f} s, A "
        f"{rbf_cut.platt_[0]:.6f}, B {rbf_cut.platt_[1]:.6f}, predict_proba "
        f"monotone in decision_function {monotone}, rows sum to 1 "
        f"{bool(np.allclose(proba.sum(1), 1.0))}")
    check(monotone and rbf_cut.platt_[0] < 0, "[9] Platt: not monotone increasing")

    for name, m, Xq in (("binary_poly", fam_models[("poly", "blocked")], Xt),
                        ("binary_pair", pair_model, Xt),
                        ("calibrated", rbf_cut, Xt), ("ovr", ovr_model, Xm_test),
                        ("svr", svr[("pair", n_svr_pair)][0], Xr[n_svr:])):
        path = str(_build.BUILD_DIR / f"chip_smoke_{name}.npz")
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        m.save(path)
        again = load_any(path, device=device)
        same = np.array_equal(again.decision_function(Xq), m.decision_function(Xq))
        log(f"[9] artifact {name}: saved and reloaded as {type(again).__name__}, "
            f"scores equal {same}")
        check(type(again) is type(m) and same, f"[9] artifact {name} differs")
        if name == "calibrated":
            check(np.array_equal(again.predict_proba(Xq), m.predict_proba(Xq)),
                  "[9] reloaded probabilities differ")


# the blocked job of phases 5 and 10-13: q, wss and max_inner of phase 5
FULL_OPTS = dict(q=2048, wss=2, max_inner=4096)


def _cli(args, device, timeout=600):
    """`python -m tpusvm_torch ARGS` in a subprocess from this checkout;
    (stdout, seconds). Fails on a non-zero exit."""
    import os
    from pathlib import Path

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    argv = [sys.executable, "-m", "tpusvm_torch", *args]
    if device == "cpu" and args[0] != "info":
        argv += ["--device", "cpu"]
    t = time.perf_counter()
    out = subprocess.run(argv, capture_output=True, text=True, cwd=root,
                         env=env, timeout=timeout)
    secs = time.perf_counter() - t
    check(out.returncode == 0, f"{' '.join(args[:3])}: exit {out.returncode}\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return out.stdout, secs


def _cli_in_process(args, device):
    """`python -m tpusvm_torch ARGS` run in this process (the entry point's
    main, its stdout captured): (stdout, seconds)."""
    import contextlib
    import io

    from tpusvm_torch.cli import main

    if device == "cpu" and args[0] != "info":
        args = [*args, "--device", "cpu"]
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    check(rc == 0, f"{' '.join(args[:3])}: exit {rc}\n{buf.getvalue()[-2000:]}")
    return buf.getvalue(), time.perf_counter() - t


def _line(pattern, text):
    import re

    m = re.search(pattern, text)
    check(m is not None, f"no {pattern!r} in:\n{text[-2000:]}")
    return m.group(1)


def _report(model, acc):
    """The CLI's lines for a binary fit: SV count, b, accuracy."""
    return (str(model.n_support_), f"{model.b_:.15f}", f"{acc:.4f}")


def phase_front(X_all, Y_all, n_tr, n_cut, n_lim, n_oracle, n_test, device,
                model_path):
    """Phase 10, cut in rows: phase 5's rows [:n_cut] and [n_tr:n_tr+n_test]
    as CSVs (the port's write_csv), then `python -m tpusvm_torch train
    --train ... --test ...` in a subprocess, which must print the SV count,
    b and accuracy of an in-process BinarySVC fit on the rows it read (the
    same program, so the same bits); then, through the same entry point's
    main in this process, again with --n-limit n_lim; --mode oracle on
    n_oracle rows, within the cross-engine band of the blocked fit on those
    rows (SV-ID symmetric difference <= 2, |db| <= 2.5e-4: PARITY.md);
    `info`, which must name the card, and `info` on phase 5's artifact."""
    import torch
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data import read_csv, write_csv
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.ops.cuda import _build
    from tpusvm_torch.status import Status

    d = _build.BUILD_DIR / "chip_smoke_csv"
    d.mkdir(parents=True, exist_ok=True)
    train_csv, test_csv = str(d / "train.csv"), str(d / "test.csv")
    t = time.perf_counter()
    write_csv(train_csv, X_all[:n_cut], Y_all[:n_cut])
    write_csv(test_csv, X_all[n_tr:n_tr + n_test], Y_all[n_tr:n_tr + n_test])
    t_write = time.perf_counter() - t
    t = time.perf_counter()
    X, Y = read_csv(train_csv)
    Xt, Yt = read_csv(test_csv)
    t_read = time.perf_counter() - t
    check(np.array_equal(X, X_all[:n_cut]) and np.array_equal(Y, Y_all[:n_cut]),
          "[10] the CSV does not read back to the rows written")
    log(f"[10] CSVs of {n_cut} + {n_test} rows x {X.shape[1]}: written in "
        f"{t_write:.1f} s, read back in {t_read:.1f} s, "
        f"{(d / 'train.csv').stat().st_size / 1e6:.0f} MB")
    flags = ["--C", str(C), "--gamma", str(GAMMA), "--max-iter", "1000000",
             "--q", str(FULL_OPTS["q"]), "--wss", str(FULL_OPTS["wss"]),
             "--max-inner", str(FULL_OPTS["max_inner"])]

    def in_process(n):
        m = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                      solver_opts=FULL_OPTS, device=device).fit(X[:n], Y[:n])
        return m, float((m.predict(Xt) == Yt).mean())

    # the first run goes through `python -m` in a subprocess; the others
    # call the same entry point's main here, which saves a process start
    # (about 9 s on the card's machine) each
    for n, extra, run in ((n_cut, [], _cli),
                          (n_lim, ["--n-limit", str(n_lim)], _cli_in_process)):
        out, secs = run(["train", "--train", train_csv, "--test", test_csv,
                         *flags, *extra], device)
        cli = (_line(r"SV count = (\d+)", out), _line(r"b = (-?[\d.]+)", out),
               _line(r"accuracy = ([\d.]+)", out))
        m, acc = in_process(n)
        where = "a subprocess" if run is _cli else "this process"
        log(f"[10] train --train CSV {' '.join(extra)}: {secs:.1f} s in "
            f"{where}, n = {_line(r'n = (\d+),', out)}, status "
            f"{_line(r'status = (\w+)', out)}, SV count / b / accuracy "
            f"{cli}; in process {_report(m, acc)}")
        check(_line(r"status = (\w+)", out) == "CONVERGED",
              f"[10] CLI status {out[-500:]}")
        check(m.status_ == Status.CONVERGED, f"[10] {m.status_.name}")
        check(cli == _report(m, acc), f"[10] CLI {cli} vs in process "
              f"{_report(m, acc)}")
    oracle_path = str(d / "oracle.npz")
    out, secs = _cli_in_process(
        ["train", "--train", train_csv, "--test", test_csv, *flags[:6],
         "--n-limit", str(n_oracle), "--mode", "oracle", "--save",
         oracle_path], device)
    orc = BinarySVC.load(oracle_path, device=device)
    m, acc = in_process(n_oracle)
    acc_o = float(_line(r"accuracy = ([\d.]+)", out))
    diff = len(set(orc.sv_ids_) ^ set(m.sv_ids_))
    log(f"[10] --mode oracle on {n_oracle} rows: {secs:.1f} s, "
        f"iterations {_line(r'iterations = (\d+)', out)}, SV count "
        f"{orc.n_support_}, b {orc.b_:.15f}, accuracy {acc_o:.4f}; the blocked "
        f"fit on those rows: SV count {m.n_support_}, b {m.b_:.15f}, accuracy "
        f"{acc:.4f}; SV-ID symmetric difference {diff}, |db| "
        f"{abs(orc.b_ - m.b_):.3e}")
    check(_line(r"status = (\w+)", out) == "CONVERGED", "[10] oracle status")
    check(diff <= 2 and abs(orc.b_ - m.b_) <= 2.5e-4 and abs(acc_o - acc) <= 0.002,
          "[10] oracle outside the cross-engine band of the blocked fit")
    out, secs = _cli_in_process(["info"], device)
    log(f"[10] info ({secs:.1f} s): " + " | ".join(out.strip().splitlines()))
    if device != "cpu":
        check(torch.cuda.get_device_name(0) in out, "[10] info names no card")
    out, secs = _cli_in_process(["info", model_path], device)
    log(f"[10] info {model_path} ({secs:.1f} s): "
        + " | ".join(out.strip().splitlines()))
    check("model: binary" in out, "[10] info does not describe the model")


def phase_refine(X_all, Y_all, n_tr, m5, acc5, device, counters):
    """Phase 11: phase 5's job with refine=4096, max_refines=2, kernel #1's
    launches counted around each rebuild; it must end CONVERGED with
    n_refines >= 1, its f64 exact-f gap below phase 5's, accuracy within
    0.002 of phase 5's. Returns the model and the two exact-f gaps."""
    import tpusvm_torch.solver.blocked as blk
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.status import Status

    fupdate = counters["fused_fupdate"]
    rebuilds = []
    plain_refine_f = blk.refine_f

    def counted(*args, **kw):
        before = fupdate.launches
        out = plain_refine_f(*args, **kw)
        rebuilds.append(fupdate.launches - before)
        return out

    for fn in counters.values():
        fn.launches = 0
    blk.refine_f = counted
    try:
        model = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                          solver_opts=dict(FULL_OPTS, refine=4096,
                                           max_refines=2), device=device)
        sync(device)
        t = time.perf_counter()
        model.fit(X_all[:n_tr], Y_all[:n_tr])
        sync(device)
        train_s = time.perf_counter() - t
    finally:
        blk.refine_f = plain_refine_f
    counts = {k: fn.launches for k, fn in counters.items()}
    res = model.result_
    acc = float((model.predict(X_all[n_tr:]) == Y_all[n_tr:]).mean())
    gaps = {}
    for name, m in (("phase 5", m5), ("phase 11 (refine)", model)):
        bh, bl = exact_b(m, X_all[:n_tr], Y_all[:n_tr], device)
        gaps[name] = bl - bh
    log(f"[11] refine=4096 max_refines=2: train {train_s:.3f} s, status "
        f"{model.status_.name}, refines {res.n_refines} (kernel #1 launches in "
        f"each rebuild {rebuilds}), outer rounds {res.n_outer}, updates "
        f"{model.n_iter_ - 1}, host syncs {res.n_host_syncs}, SV count "
        f"{model.n_support_}, b {model.b_:.15f}, accuracy {acc:.4f}, launches "
        f"{counts}")
    floor = 4e-7 * float(model.sv_alpha_.sum())
    log(f"[11] f64 exact-f gap b_low - b_high: phase 5 {gaps['phase 5']:.3e}, "
        f"with refine {gaps['phase 11 (refine)']:.3e} (2 tau = 2e-5; the f32 "
        f"evaluation floor 4e-7 * sum(alpha) = {floor:.3e}, "
        f"tests/test_shrink.py's band); against "
        f"phase 5: SV-ID symmetric difference "
        f"{len(set(m5.sv_ids_) ^ set(model.sv_ids_))} of {m5.n_support_}, |db| "
        f"{abs(m5.b_ - model.b_):.3e}, accuracy {acc:.4f} vs {acc5:.4f}")
    check(model.status_ == Status.CONVERGED, f"[11] {model.status_.name}")
    check(res.n_refines >= 1, "[11] no refine ran")
    check(len(rebuilds) == res.n_refines and all(
        k > 0 or device == "cpu" for k in rebuilds),
        f"[11] kernel #1 did not launch in every rebuild: {rebuilds}")
    check(counts["inner_smo"] > 0 or device == "cpu", f"[11] {counts}")
    # (a CPU rehearsal's cut has no drift to remove)
    check(gaps["phase 11 (refine)"] < gaps["phase 5"] or device == "cpu",
          f"[11] exact-f gap {gaps} not below phase 5's")
    check(abs(acc - acc5) <= 0.002, f"[11] accuracy {acc} vs phase 5 {acc5}")
    return model, gaps


class _Stopped(Exception):
    """Raised after a chosen checkpoint is on disk: the process 'dies'."""


def phase_checkpoint(X_all, Y_all, n_tr, device, stop_round=8, every=4):
    """Phase 12: phase 5's job through BinarySVC.fit(checkpoint_path,
    checkpoint_every), stopped once the checkpoint of round `stop_round` is
    on disk, then resumed in a fresh estimator: it must equal the run
    without a checkpoint bit for bit (alpha with torch.equal, the same b,
    n_iter and status). At the solver: a state paused at `stop_round`,
    written, read back and resumed gives alpha and f equal (torch.equal)
    to the uninterrupted solve's; the write is timed."""
    import os

    import torch
    import tpusvm_torch.solver.checkpoint as ckmod
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.ops.cuda import _build
    from tpusvm_torch.solver.blocked import blocked_smo_solve
    from tpusvm_torch.status import Status

    path = str(_build.BUILD_DIR / "chip_smoke_checkpoint.npz")
    if os.path.exists(path):
        os.remove(path)
    cfg = SVMConfig(C=C, gamma=GAMMA, max_iter=10**6)
    X, Y = X_all[:n_tr], Y_all[:n_tr]
    plain = BinarySVC(cfg, solver_opts=FULL_OPTS, device=device).fit(X, Y)
    save = ckmod.save_solver_state

    def save_then_stop(p, state, fp):
        save(p, state, fp)
        if state.n_outer >= stop_round:
            raise _Stopped(state.n_outer)

    ckmod.save_solver_state = save_then_stop
    try:
        BinarySVC(cfg, solver_opts=FULL_OPTS, device=device).fit(
            X, Y, checkpoint_path=path, checkpoint_every=every)
        check(False, "[12] the fit was not stopped")
    except _Stopped as e:
        stopped_at = e.args[0]
    finally:
        ckmod.save_solver_state = save
    check(os.path.exists(path), "[12] no checkpoint on disk")
    t = time.perf_counter()
    resumed = BinarySVC(cfg, solver_opts=FULL_OPTS, device=device).fit(
        X, Y, checkpoint_path=path, checkpoint_every=every, resume=True)
    resume_s = time.perf_counter() - t
    a, b = resumed.result_, plain.result_
    same = (torch.equal(a.alpha, b.alpha) and (a.b, a.n_iter, a.status)
            == (b.b, b.n_iter, b.status))
    log(f"[12] fit stopped after the checkpoint of round {stopped_at} (every "
        f"{every}), resumed in a fresh estimator in {resume_s:.3f} s: rounds "
        f"{a.n_outer}, updates {a.n_iter - 1}, status {a.status.name}, b "
        f"{a.b:.15f}; equal to the fit without a checkpoint bit for bit: "
        f"{same}; checkpoint removed at the end: {not os.path.exists(path)}")
    check(same, "[12] resumed fit differs from the uninterrupted one")
    check(a.status == Status.CONVERGED, f"[12] {a.status.name}")
    # the solver's carry itself: alpha and f across a written checkpoint
    Xs = torch.as_tensor(plain.scaler_.transform(X).astype(np.float32),
                         device=device)
    Yd = torch.as_tensor(Y, device=device)
    kw = dict(C=C, gamma=GAMMA, max_iter=10**6, accum_dtype=torch.float64,
              device=device, **FULL_OPTS)
    whole, st_whole = blocked_smo_solve(Xs, Yd, return_state=True, **kw)
    _, st = blocked_smo_solve(Xs, Yd, pause_at=stop_round, return_state=True,
                              **kw)
    fp = ckmod.solve_fingerprint(Xs, Yd, torch.float64, FULL_OPTS)
    sync(device)
    t = time.perf_counter()
    ckmod.save_solver_state(path, st, fp)
    write_ms = (time.perf_counter() - t) * 1e3
    size = os.path.getsize(path)
    t = time.perf_counter()
    back = ckmod.load_solver_state(path, fp)
    read_ms = (time.perf_counter() - t) * 1e3
    os.remove(path)
    res, st_end = blocked_smo_solve(Xs, Yd, resume_state=back,
                                    return_state=True, **kw)
    same = (torch.equal(res.alpha, whole.alpha)
            and torch.equal(st_end.f, st_whole.f)
            and (res.b, res.n_iter, res.status) == (whole.b, whole.n_iter,
                                                   whole.status))
    log(f"[12] solver carry at round {stop_round}: checkpoint write "
        f"{write_ms:.1f} ms ({size / 1e6:.2f} MB: alpha and f of {n_tr} rows "
        f"in f64; device-to-host copy, savez, fsync, rename), read "
        f"{read_ms:.1f} ms; resumed alpha and f equal to the uninterrupted "
        f"solve's (torch.equal): {same}")
    check(same, "[12] resumed solver carry differs")


def phase_shrink_cache(X_all, Y_all, n_tr, acc5, m5, train5_s, device,
                       counters):
    """Phase 13: phase 5's job (a) with shrink_every=2, shrink_stable=3 and
    (b) with krow_cache=2048; each CONVERGED, accuracy within 0.002 of phase
    5's. (a) must launch kernels #1 and #2; (b) #2, its f-update taking the
    rows path (kernel #1 resolved off, as in the JAX package). Returns 13(a)'s
    (model, accuracy) and train seconds."""
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.solver.blocked import resolve_solver_config
    from tpusvm_torch.status import Status

    secs = {}
    models = {}
    for tag, extra in (("13a", dict(shrink_every=2, shrink_stable=3)),
                       ("13b", dict(krow_cache=2048))):
        for fn in counters.values():
            fn.launches = 0
        model = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                          solver_opts=dict(FULL_OPTS, **extra), device=device)
        sync(device)
        t = time.perf_counter()
        model.fit(X_all[:n_tr], Y_all[:n_tr])
        sync(device)
        secs[tag] = time.perf_counter() - t
        counts = {k: fn.launches for k, fn in counters.items()}
        res = model.result_
        acc = float((model.predict(X_all[n_tr:]) == Y_all[n_tr:]).mean())
        models[tag] = (model, acc)
        log(f"[{tag}] {json.dumps(extra)}: train {secs[tag]:.3f} s, status "
            f"{model.status_.name}, outer rounds {res.n_outer}, updates "
            f"{model.n_iter_ - 1}, host syncs {res.n_host_syncs}, SV count "
            f"{model.n_support_}, b {model.b_:.15f}, accuracy {acc:.4f}; "
            f"against phase 5: SV-ID symmetric difference "
            f"{len(set(m5.sv_ids_) ^ set(model.sv_ids_))}, |db| "
            f"{abs(m5.b_ - model.b_):.3e}; launches {counts}")
        check(model.status_ == Status.CONVERGED, f"[{tag}] {model.status_.name}")
        check(abs(acc - acc5) <= 0.002, f"[{tag}] accuracy {acc} vs {acc5}")
        check(counts["inner_smo"] > 0 or device == "cpu", f"[{tag}] {counts}")
        if tag == "13a":
            hist = res.shrink_history
            caps = [h["cap"] for h in hist if h["event"] == "shrink"]
            log(f"[13a] compactions {len(caps)} (buckets {caps}, live rows "
                f"{[h['active'] for h in hist if h['event'] == 'shrink']}), "
                f"un-shrinks {sum(h['event'] == 'unshrink' for h in hist)}, "
                f"events {[(h['event'], h['round']) for h in hist]}")
            check(counts["fused_fupdate"] > 0 or device == "cpu",
                  f"[13a] kernel #1 not launched: {counts}")
        else:
            q = resolve_solver_config(n_tr, FULL_OPTS["q"])[0]
            log(f"[13b] K rows served from the cache {res.cache_hits}, "
                f"computed fresh {res.cache_misses} ({res.n_outer} rounds of "
                f"{q})")
            check(res.cache_hits + res.cache_misses == q * res.n_outer,
                  "[13b] cache accounting")
            check(counts["fused_fupdate"] == 0, f"[13b] {counts}")
    log(f"[13] train seconds: phase 5 {train5_s:.3f}, shrinking "
        f"{secs['13a']:.3f}, K-row cache {secs['13b']:.3f} (a finding, not a "
        f"claim: one run each)")
    return models["13a"], secs["13a"]


class LeafLog:
    """Stands in for tpusvm_torch.parallel.cascade._solve while a cascade
    fits: per leaf solve, its rows, merged (valid) rows, SVs, iterations,
    status, synchronised seconds and the launches of each counted kernel."""

    def __init__(self, counters, device, sv_tol):
        import tpusvm_torch.parallel.cascade as cmod

        self.cmod, self.orig = cmod, cmod._solve
        self.counters, self.device, self.sv_tol = counters, device, sv_tol
        self.solves = []

    def __enter__(self):
        self.cmod._solve = self
        return self

    def __exit__(self, *exc):
        self.cmod._solve = self.orig

    def __call__(self, train, *args, **kw):
        from tpusvm_torch.status import Status

        before = {k: fn.launches for k, fn in self.counters.items()}
        sync(self.device)
        t = time.perf_counter()
        res = self.orig(train, *args, **kw)
        sync(self.device)
        secs = time.perf_counter() - t
        valid = train.valid
        alpha = res.alpha.to(valid.device)
        self.solves.append(dict(
            rows=train.X.shape[0], merged=int(valid.sum()),
            svs=int((valid & (alpha > self.sv_tol)).sum()),
            iters=int(res.n_iter), status=Status(int(res.status)).name, s=secs,
            rescue=getattr(res, "n_rescue", 0),
            launches={k: fn.launches - before[k]
                      for k, fn in self.counters.items()}))
        return res


# phase 14's cases: (tag, topology, leaf solver, training rows); 14(c)'s
# pair leaves are cut in rows (PERF.md section 4): at 60,000 rows the star
# does not reach its ID-set fixed point (scripts/torch_cascade_probe.py:
# 34 rounds in 720 s on an H100, the global set moving by 1 to 9 IDs every
# round from round 5, each warm leaf about 17,700 iterations)
N_CASCADE_PAIR = 10000
CASCADE_CASES = (("14a", "tree", "blocked", 60000),
                 ("14b", "star", "blocked", 60000),
                 ("14c", "star", "pair", N_CASCADE_PAIR))
CASCADE_P, CASCADE_SV_CAP = 4, 4096


def _cascade_model(solver, device, max_rounds=50):
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC

    return BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6,
                               max_rounds=max_rounds), solver=solver,
                     solver_opts=FULL_OPTS if solver == "blocked" else {},
                     device=device)


def leaf_rebuild_check(model, X, Y, sv_cap, device):
    """Kernel #1 at q = the leaf's size: the warm-start rebuild of f over
    rank 0's first leaf (its partition chunk merged under the fit's final
    SVs, padded to chunk + sv_cap rows), X_B = X, coef = alpha*y in f32 as
    the blocked solver forms it, held against rbf_cross_matvec_ref in
    phase 3's band (1e-5 x sum |coef|) and timed. Returns (rows, err, tol,
    kernel ms, plain ms)."""
    import torch
    from tpusvm_torch.data.partition import partition
    from tpusvm_torch.ops.cuda.fused_fupdate import (rbf_cross_matvec_kernel,
                                                     rbf_cross_matvec_ref)
    from tpusvm_torch.ops.rbf import sq_norms
    from tpusvm_torch.parallel.cascade import _leaf
    from tpusvm_torch.parallel.svbuffer import empty, merge_dedup

    f32 = torch.float32
    part = partition(model.scaler_.transform(np.asarray(X)), np.asarray(Y),
                     CASCADE_P)
    leaf = _leaf(part, 0, f32, device)
    g = empty(sv_cap, X.shape[1], f32, device)
    k = len(model.sv_ids_)
    for field, vals in ((g.X, model.sv_X_), (g.Y, model.sv_Y_),
                        (g.alpha, model.sv_alpha_), (g.ids, model.sv_ids_)):
        field[:k] = torch.as_tensor(vals).to(device=device, dtype=field.dtype)
    g.valid[:k] = True
    train, _ = merge_dedup(g, leaf, part.X.shape[1] + sv_cap)
    coef = (torch.where(train.valid, train.alpha.double(), 0.0)
            * train.Y.double()).to(f32)
    sn = sq_norms(train.X)
    got = rbf_cross_matvec_kernel(train.X, train.X, coef, GAMMA, sn)
    want = rbf_cross_matvec_ref(train.X, train.X, coef, GAMMA, sn)
    sync(device)
    err = float((got - want).abs().max())
    tol = 1e-5 * float(coef.abs().sum())
    check(bool(torch.isfinite(got).all()), "[14a] #1 at the leaf's size: "
          "non-finite")
    k_ms = p_ms = float("nan")
    if device != "cpu":
        k_ms = cuda_ms(lambda: rbf_cross_matvec_kernel(train.X, train.X, coef,
                                                       GAMMA, sn))
        p_ms = cuda_ms(lambda: rbf_cross_matvec_ref(train.X, train.X, coef,
                                                    GAMMA, sn), reps=3)
    return train.X.shape[0], err, tol, k_ms, p_ms


def cascade_case(tag, topology, solver, X, Y, Xt, Yt, m5, acc5, device,
                 counters, ckpt, ref="phase 5"):
    """One of phase 14's one-process fits: the fit with its kernels' launches
    counted around it and per leaf solve, its rounds printed, CONVERGED,
    accuracy within 0.002 of the direct blocked fit m5's on the same rows
    (acc5), the SV-ID Jaccard with m5 at least 0.85; then the same fit
    stopped by max_rounds after round min(3, rounds - 1) with a round
    checkpoint and resumed with max_rounds=50, equal to it bit for bit.
    Returns (model, accuracy, train s, main-path launches, the leaf
    solves)."""
    import os

    from tpusvm_torch.config import CascadeConfig
    from tpusvm_torch.status import Status

    sv_cap = CASCADE_SV_CAP
    cc = CascadeConfig(n_shards=CASCADE_P, sv_capacity=sv_cap,
                       topology=topology)
    model = _cascade_model(solver, device)
    for fn in counters.values():
        fn.launches = 0
    with LeafLog(counters, device, model.config.sv_tol) as leaves:
        sync(device)
        t = time.perf_counter()
        model.fit_cascade(X, Y, cc)
        sync(device)
        train_s = time.perf_counter() - t
    counts = {k: fn.launches for k, fn in counters.items()}
    acc = float((model.predict(Xt) == Yt).mean())
    a, b = set(m5.sv_ids_.tolist()), set(model.sv_ids_.tolist())
    jac = len(a & b) / len(a | b)
    # solves a round: the tree's P leaves, P/2, ..., 1; the star's P and
    # its layer 2 (neither retries: merged_cap is P * sv_capacity)
    per_round = 2 * CASCADE_P - 1 if topology == "tree" else CASCADE_P + 1
    leaf_s = sum(s["s"] for s in leaves.solves)
    log(f"[{tag}] {topology} P={CASCADE_P} {solver} leaves, sv_capacity "
        f"{sv_cap}, n={len(Y)} d={X.shape[1]}: train {train_s:.3f} s, "
        f"{model.cascade_rounds_} rounds, status {model.status_.name}, "
        f"iterations {model.n_iter_}, SV count {model.n_support_}, b "
        f"{model.b_:.15f}, accuracy {acc:.4f} ({ref} {acc5:.4f}); leaf "
        f"solves {len(leaves.solves)} in {leaf_s:.3f} s, the rest (merges, "
        f"extraction, host) {train_s - leaf_s:.3f} s; launches {counts}")
    for i, h in enumerate(model.cascade_history_):
        rows = leaves.solves[i * per_round:(i + 1) * per_round]
        log(f"[{tag}]   round {h['round']}: global SVs {h['sv_count']}, b "
            f"{h['b']:.15f}, {h['time_s']:.3f} s (leaf solves "
            f"{sum(s['s'] for s in rows):.3f} s); leaves [rows, merged, SVs, "
            f"iterations, status, s(, rescue rounds)]: "
            + ", ".join(f"[{s['rows']}, {s['merged']}, {s['svs']}, "
                        f"{s['iters']}, {s['status']}, {s['s']:.3f}"
                        + (f", {s['rescue']}" if s["rescue"] else "") + "]"
                        for s in rows))
    log(f"[{tag}] against {ref}: SV-ID symmetric difference {len(a ^ b)} "
        f"({ref} {len(a)}, cascade {len(b)}), Jaccard {jac:.4f}, |db| "
        f"{abs(m5.b_ - model.b_):.3e}")
    check(model.status_ == Status.CONVERGED, f"[{tag}] {model.status_.name}")
    check(abs(acc - acc5) <= 0.002, f"[{tag}] accuracy {acc} vs {ref} {acc5}")
    check(jac >= 0.85, f"[{tag}] SV-ID Jaccard {jac} with {ref}")
    # before any per-solve check: a hook that saw no solve passes them all
    check(len(leaves.solves) > 0
          and per_round * model.cascade_rounds_ == len(leaves.solves),
          f"[{tag}] {len(leaves.solves)} leaf solves seen in "
          f"{model.cascade_rounds_} rounds, {per_round} a round expected")
    kernels = (("fused_fupdate",) if solver == "blocked" else ()) + (
        ("inner_smo",) if solver == "blocked" else ("pair_rows",))
    if device != "cpu":
        for s in leaves.solves:
            # the warm-start rebuild launches #1 in every blocked solve; the
            # inner kernel (or pair_rows) in every solve that updated
            need = [k for k in kernels
                    if k == "fused_fupdate" or s["iters"] > 1]
            check(all(s["launches"][k] > 0 for k in need),
                  f"[{tag}] a leaf solve launched no {need}: {s}")
        check(all(counts[k] > 0 for k in kernels), f"[{tag}] {counts}")

    stop = min(3, model.cascade_rounds_ - 1)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    first = _cascade_model(solver, device, max_rounds=stop).fit_cascade(
        X, Y, cc, checkpoint_path=ckpt)
    t = time.perf_counter()
    again = _cascade_model(solver, device).fit_cascade(
        X, Y, cc, checkpoint_path=ckpt, resume=True)
    resume_s = time.perf_counter() - t
    os.remove(ckpt)
    same = (np.array_equal(again.sv_ids_, model.sv_ids_)
            and again.sv_alpha_.tobytes() == model.sv_alpha_.tobytes()
            and again.b_ == model.b_
            and again.cascade_rounds_ == model.cascade_rounds_)
    times = [h["time_s"] for h in again.cascade_history_]
    log(f"[{tag}] stopped by max_rounds={stop} ({first.cascade_rounds_} rounds, "
        f"{first.status_.name}) with a round checkpoint, resumed with "
        f"max_rounds=50 in {resume_s:.3f} s ({len(times)} rounds, "
        f"{sum(times):.3f} s in them, the longest {max(times):.3f} s): "
        f"{again.cascade_rounds_} rounds, equal to the uninterrupted fit bit "
        f"for bit (SV IDs, alpha bits, b, rounds): {same}")
    check(same, f"[{tag}] the resumed fit differs from the uninterrupted one")
    return model, acc, train_s, {k: counts[k] for k in kernels}, leaves.solves


def start_cascade_csvs(n, n_tr, d, out_dir):
    """Writes phase 5's rows (mnist_like(n, d), seed 587, as phase 3 draws
    them) [:n_tr] and [n_tr:] as CSVs for phase 14(d) in a background
    process (the CSV writer is a Python loop: about 20 s for 70,000 rows of
    784), so it overlaps phases 14(a)-(c). Returns the process and the two
    paths."""
    import os
    from pathlib import Path

    out_dir.mkdir(parents=True, exist_ok=True)
    train, test = str(out_dir / "train.csv"), str(out_dir / "test.csv")
    code = ("import sys; from tpusvm_torch.data import mnist_like, write_csv; "
            "n, n_tr, d = map(int, sys.argv[1:4]); "
            "X, Y = mnist_like(n=n, d=d, noise=30.0, label_noise=0.005, "
            "seed=587); write_csv(sys.argv[4], X[:n_tr], Y[:n_tr]); "
            "write_csv(sys.argv[5], X[n_tr:], Y[n_tr:])")
    root = str(Path(__file__).resolve().parent)
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(n), str(n_tr), str(d), train, test],
        cwd=root, env=dict(os.environ, PYTHONPATH=root))
    return proc, train, test


def phase_cascade_ranks(writer, train_csv, test_csv, model_a, acc_a, train_a_s,
                        out_dir, device, deadline_s=600):
    """Phase 14(d): four rank processes of `python -m tpusvm_torch train
    --mode cascade --shards 4 --topology tree --distributed ...` on the CSVs
    of phase 5's rows, sharing the card; each is waited on with a deadline
    (all killed on expiry) and must exit 0. Rank 0 must print 14(a)'s SV
    count, accuracy, b to every printed digit and rounds, and write the only
    artifact, which `info` describes with 14(a)'s cascade line."""
    import os
    import socket
    from pathlib import Path

    t = time.perf_counter()
    check(writer.wait(timeout=deadline_s) == 0, "[14d] the CSV writer failed")
    wait_s = time.perf_counter() - t
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parent)
    flags = ["train", "--train", train_csv, "--test", test_csv, "--C", str(C),
             "--gamma", str(GAMMA), "--max-iter", "1000000",
             "--q", str(FULL_OPTS["q"]), "--wss", str(FULL_OPTS["wss"]),
             "--max-inner", str(FULL_OPTS["max_inner"]), "--mode", "cascade",
             "--shards", str(CASCADE_P), "--topology", "tree", "--sv-capacity",
             str(CASCADE_SV_CAP), "--distributed", "--coordinator-address",
             f"127.0.0.1:{port}", "--num-processes", str(CASCADE_P)]
    if device == "cpu":
        flags += ["--device", "cpu"]
    paths = [out_dir / f"rank{r}.npz" for r in range(CASCADE_P)]
    for p in paths:
        if p.exists():
            p.unlink()
    procs = []
    t = time.perf_counter()
    for r in range(CASCADE_P):
        with open(out_dir / f"rank{r}.out", "w") as o, \
                open(out_dir / f"rank{r}.err", "w") as e:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpusvm_torch", *flags, "--process-id",
                 str(r), "--save", str(paths[r])], cwd=root, stdout=o, stderr=e,
                env=dict(os.environ, PYTHONPATH=root)))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline_s - (time.perf_counter() - t)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        check(False, f"[14d] the ranks did not finish within {deadline_s} s")
    wall_s = time.perf_counter() - t
    outs = [(out_dir / f"rank{r}.out").read_text() for r in range(CASCADE_P)]
    errs = [(out_dir / f"rank{r}.err").read_text() for r in range(CASCADE_P)]
    rcs = [p.returncode for p in procs]
    check(rcs == [0] * CASCADE_P, f"[14d] rank exits {rcs}:\n"
          + "\n".join(f"rank {r}: {outs[r][-1500:]}\n{errs[r][-1500:]}"
                      for r in range(CASCADE_P) if rcs[r]))
    out = outs[0]
    got = (_line(r"(?m)^SV count = (\d+)", out), _line(r"(?m)^b = (-?[\d.]+)", out),
           _line(r"accuracy = ([\d.]+)", out),
           _line(r"cascade: (\d+) rounds", out))
    want = (*_report(model_a, acc_a), str(model_a.cascade_rounds_))
    rounds = [ln for ln in out.splitlines() if ln.startswith("=== Round")]
    log(f"[14d] {CASCADE_P} rank processes on one card: {wall_s:.1f} s wall "
        f"(after {wait_s:.1f} s waiting for the CSVs); rank 0: data "
        f"{_line(r'data time: ([\d.]+) s', out)} s, training "
        f"{_line(r'training time: ([\d.]+) s', out)} s (14(a) in one process "
        f"{train_a_s:.3f} s); SV count / b / accuracy / rounds {got}, 14(a) "
        f"{want}; rounds: " + " | ".join(rounds))
    check(got == want, f"[14d] rank 0 printed {got}, 14(a) {want}")
    check(all(not o.strip() for o in outs[1:]), "[14d] a rank other than 0 "
          "printed")
    check([p.exists() for p in paths] == [True] + [False] * (CASCADE_P - 1),
          "[14d] the artifact was not written by rank 0 alone")
    info, _ = _cli_in_process(["info", str(paths[0])], device)
    line = (f"cascade: topology=tree leaves={CASCADE_P} "
            f"rounds={model_a.cascade_rounds_}")
    log(f"[14d] info {paths[0].name}: " + " | ".join(info.strip().splitlines()))
    check(line in info, f"[14d] info lacks {line!r}")
    return wall_s


def phase_cascade(X_all, Y_all, n_tr, m5, acc5, device, counters, launches,
                  out_dir, clock):
    """Phase 14: the one-process fits of CASCADE_CASES (cascade_case; a case
    cut in rows is held to the direct blocked fit on its rows), kernel #1 at
    the leaf's size after 14(a), then 14(d)'s rank processes on CSVs written
    in the background meanwhile. Adds each case's launches to `launches`."""
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC

    writer, train_csv, test_csv = start_cascade_csvs(
        len(Y_all), n_tr, X_all.shape[1], out_dir)
    Xt, Yt = X_all[n_tr:], Y_all[n_tr:]
    try:
        fits = {}
        for tag, topology, solver, n_c in CASCADE_CASES:
            ref, ref_acc, ref_name = m5, acc5, "phase 5"
            if n_c < n_tr:
                # the cut: held to the direct blocked fit on the same rows
                ref = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                                solver_opts=FULL_OPTS, device=device).fit(
                                    X_all[:n_c], Y_all[:n_c])
                ref_acc = float((ref.predict(Xt) == Yt).mean())
                ref_name = f"the blocked fit on rows [:{n_c}]"
            n_c = min(n_c, n_tr)
            fits[tag] = cascade_case(
                tag, topology, solver, X_all[:n_c], Y_all[:n_c], Xt, Yt, ref,
                ref_acc, device, counters, str(out_dir / f"{tag}_rounds.npz"),
                ref=ref_name)
            for k, v in fits[tag][3].items():
                launches.setdefault(k, {})[tag] = v
            if tag == "14a":
                rows, err, tol, r_ms, rp_ms = leaf_rebuild_check(
                    fits[tag][0], X_all[:n_c], Y_all[:n_c], CASCADE_SV_CAP,
                    device)
                log(f"[14a] kernel #1 at q = the leaf's size (the warm-start "
                    f"rebuild, X_B = X, {rows} x {X_all.shape[1]}): max_abs_err "
                    f"{err:.3e} (tol {tol:.3e}); kernel {r_ms:.3f} ms, plain "
                    f"{rp_ms:.3f} ms")
                check(err <= tol, f"[14a] #1 at the leaf's size: error {err} "
                      f"over {tol}")
            clock(tag)
        model_a, acc_a, train_a_s = fits["14a"][:3]
        phase_cascade_ranks(writer, train_csv, test_csv, model_a, acc_a,
                            train_a_s, out_dir, device)
    finally:
        if writer.poll() is None:
            writer.kill()
            writer.wait()
    clock("14d")


# phase 3's problem-axis lanes: B working sets of phase 5's q over phase 5's
# rows, with these gammas and Cs (lanes 0 and 1 are the cold-start and
# round-4 sets of phase 5's own solve). Every lane runs: the fleet stacks
# only the lanes that solve a subproblem in a round.
FLEET_B = 16


def problem_axis_lanes(X, Y, cold, round4, B_cold, q, dev):
    """The 16 lanes of phase 3's problem-axis checks: (inner, fupdate,
    gammas, Cs). inner = (K_BB, y, a, f, active), stacked on the lane axis
    in f32: lane 0 phase 5's cold-start set, lane 1 its round-4 set, the
    others cold starts on random sets of q rows at their gamma. fupdate =
    (XB (B, q, d), coef (B, q)): lane 0 the cold-start rows, the others
    random rows."""
    import torch
    from tpusvm_torch.ops.rbf import rbf_cross

    n = X.shape[0]
    rng = np.random.default_rng(16)
    gammas = [GAMMA, GAMMA] + [GAMMA * (0.5, 1.0, 2.0, 4.0)[b % 4]
                               for b in range(2, FLEET_B)]
    Cs = [C, C] + [(1.0, 10.0, 100.0)[b % 3] for b in range(2, FLEET_B)]
    idx = [B_cold] + [torch.as_tensor(rng.choice(n, q, replace=False),
                                      device=dev) for _ in range(1, FLEET_B)]
    lanes = [cold, round4]
    for b in range(2, FLEET_B):
        XB = X[idx[b]].contiguous()
        y = Y[idx[b]]
        lanes.append((rbf_cross(XB, XB, gammas[b]), y,
                      torch.zeros(q, device=dev), -y.float(),
                      torch.ones(q, dtype=torch.bool, device=dev)))
    inner = tuple(torch.stack([ln[i].to(torch.float32) for ln in lanes])
                  for i in range(5))
    XB = torch.stack([X[i] for i in idx]).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(16)
    coef = (torch.randn(FLEET_B, q, generator=gen) * 0.5).to(dev)
    return inner, (XB, coef), gammas, Cs


def kbb_by_bmm(XB, g_t):
    """The fleet round's K_BB for every lane in one batched product:
    exp(-gamma_b max(0, sn_i + sn_j - 2 (XB_b XB_b^T)_ij)), (B, q, q)."""
    import torch

    snB = (XB * XB).sum(dim=2)
    d2 = snB[:, :, None] + snB[:, None, :] - 2.0 * torch.bmm(
        XB, XB.transpose(1, 2))
    return torch.exp(-g_t[:, None, None] * torch.clamp_min(d2, 0.0))


def phase_problem_axis(X, Y, sn, cold, round4, B_cold, q, dev, peak_bw,
                       peak_tf32, peak_flops, solo_fu_ms, solo_inner_ms):
    """Phase 3, the fleet's problem-axis launches at B = 16: #2 and #1,
    each lane held bit for bit against a solo launch of the same kernel on
    its operands and against the plain versions (#2 bit for bit, #1 within
    1e-5 sum|coef|), timed beside the lanes' solo launches one after
    another and beside B times the solo bound; and the fleet round's K_BB
    by one torch.bmm against the per-lane solo call that the fleet makes
    (time, and whether the bits are the solo call's). Returns the two
    kernels' JSON entries."""
    import torch
    from tpusvm_torch.ops.cuda.fused_fupdate import (
        rbf_cross_matvec_batched_kernel, rbf_cross_matvec_batched_ref,
        rbf_cross_matvec_kernel)
    from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_batched_kernel,
                                                 inner_smo_batched_ref,
                                                 inner_smo_kernel)
    from tpusvm_torch.ops.rbf import rbf_cross

    n, d = X.shape
    inner, (XB, coef), gammas, Cs = problem_axis_lanes(
        X, Y, cold, round4, B_cold, q, dev)
    lanes = range(FLEET_B)
    K, y, a, f, act = inner
    Cs_t = torch.tensor(Cs, dtype=torch.float32, device=dev)
    kw = dict(max_inner=4096, wss=2)

    def batched2():
        return inner_smo_batched_kernel(K, y, a, f, act, Cs_t, 1e-12, 1e-5,
                                        **kw)

    def solo2(b):
        return inner_smo_kernel(K[b], y[b], a[b], f[b], act[b], Cs[b], 1e-12,
                                1e-5, **kw)

    a_out, stat = batched2()
    t = time.perf_counter()
    a_ref, st_ref = inner_smo_batched_ref(K, y, a, f, act, Cs, 1e-12, 1e-5,
                                          **kw)
    torch.cuda.synchronize()
    p2_ms = (time.perf_counter() - t) * 1e3
    stats = stat.tolist()
    same_solo = []
    for b in lanes:
        a1, s1 = solo2(b)
        same_solo.append(torch.equal(a_out[b], a1) and stats[b] == s1.tolist())
    same_plain = torch.equal(a_out, a_ref) and stats == st_ref.tolist()
    k2_ms = cuda_ms(batched2)
    s2_ms = cuda_ms(lambda: [solo2(b) for b in lanes])
    iters = [stats[b][3] for b in lanes]
    b2_bytes = sum(it * 2.0 * q * 4 + 6.0 * q * 4 for it in iters)
    b2_bound = b2_bytes / peak_bw * 1e3
    log(f"[3] inner_smo problem axis B={FLEET_B} q={q} wss=2 (gammas "
        f"{sorted(set(round(g, 6) for g in gammas))}, Cs {sorted(set(Cs))}): "
        f"every lane bit-equal to its solo launch {all(same_solo)}, to the "
        f"plain version {same_plain}; updates {[st[0] for st in stats]}, "
        f"iterations {iters}")
    log(f"[3] inner_smo problem axis: kernel {k2_ms:.3f} ms for {FLEET_B} "
        f"lanes; their {FLEET_B} solo launches one after another "
        f"{s2_ms:.3f} ms ({s2_ms / k2_ms:.2f}x); plain {p2_ms:.1f} ms (one "
        f"run); bound {b2_bound:.4f} ms (bytes: the lanes' row reads, "
        f"{FLEET_B} x the solo bound's form); solo cold-start launch "
        f"{solo_inner_ms:.3f} ms")
    check(all(same_solo), f"inner_smo problem axis: lanes differ from solo "
          f"launches {same_solo}")
    check(same_plain, "inner_smo problem axis differs from its plain version")
    err2 = float((a_out - a_ref).abs().max())

    # #1: the f-update with a problem axis
    g_t = torch.tensor(gammas, dtype=torch.float32, device=dev)

    def batched1():
        return rbf_cross_matvec_batched_kernel(X, XB, coef, g_t, sn)

    def solo1(b):
        return rbf_cross_matvec_kernel(X, XB[b], coef[b], gammas[b], sn)

    out = batched1()
    want = rbf_cross_matvec_batched_ref(X, XB, coef, gammas, sn)
    torch.cuda.synchronize()
    bits = [torch.equal(out[b], solo1(b)) for b in lanes]
    errs = [float((out[b] - want[b]).abs().max()) for b in lanes]
    tols = [1e-5 * float(coef[b].abs().sum()) for b in lanes]
    k1_ms = cuda_ms(batched1)
    s1_ms = cuda_ms(lambda: [solo1(b) for b in lanes])
    p1_ms = cuda_ms(lambda: rbf_cross_matvec_batched_ref(
        X, XB, coef, gammas, sn), reps=3, warmup=1)
    lib1_ms = cuda_ms(lambda: torch.matmul(X, XB.transpose(1, 2)),
                      reps=3, warmup=1)
    flops = 2.0 * n * d * q
    b1_ops = FLEET_B * 3 * flops / peak_tf32 * 1e3
    b1_bytes = 4.0 * (n * d + FLEET_B * (q * d + q + n) + n) / peak_bw * 1e3
    log(f"[3] fused_fupdate problem axis B={FLEET_B} n={n} d={d} q={q}: every "
        f"row bit-equal to its solo launch {all(bits)}; max_abs_err to the "
        f"plain version {max(errs):.3e} (largest tol {max(tols):.3e})")
    log(f"[3] fused_fupdate problem axis: kernel {k1_ms:.3f} ms for "
        f"{FLEET_B} lanes ({k1_ms / FLEET_B:.3f} a lane); their solo launches "
        f"one after another {s1_ms:.3f} ms ({s1_ms / k1_ms:.2f}x); plain "
        f"{p1_ms:.3f} ms; torch.matmul(X, XB^T) batched {lib1_ms:.3f} ms; "
        f"bound {b1_ops:.3f} ms ({FLEET_B} x 3xTF32 {b1_ops / FLEET_B:.3f}, "
        f"{100 * b1_ops / k1_ms:.1f}% reached; bytes {b1_bytes:.4f} ms); solo "
        f"launch {solo_fu_ms:.3f} ms")
    check(all(bits), f"fused_fupdate problem axis: rows differ from solo "
          f"launches {bits}")
    check(all(e <= t for e, t in zip(errs, tols)),
          f"fused_fupdate problem axis: errors {errs} over {tols}")

    # K_BB of a fleet round: the per-lane solo call (what the fleet runs)
    # against one batched product
    def kbb_loop():
        return torch.stack([rbf_cross(XB[b], XB[b], gammas[b]) for b in lanes])

    loop = kbb_loop()
    bmm = kbb_by_bmm(XB, g_t)
    torch.cuda.synchronize()
    bmm_bits = [torch.equal(loop[b], bmm[b]) for b in lanes]
    bmm_err = float((loop - bmm).abs().max())
    # the fleet's batch count falls as lanes finish: the bmm's bits at
    # every count from 1 to B
    bmm_counts = [c for c in range(1, FLEET_B + 1)
                  if torch.equal(kbb_by_bmm(XB[:c], g_t[:c]), loop[:c])]
    del loop, bmm
    kloop_ms = cuda_ms(kbb_loop)
    kbmm_ms = cuda_ms(lambda: kbb_by_bmm(XB, g_t))
    kbb_bound = max(FLEET_B * 2.0 * q * q * d / peak_flops,
                    4.0 * FLEET_B * (q * d + q * q) / peak_bw) * 1e3
    log(f"[3] K_BB for B={FLEET_B} lanes of q={q}, d={d}: per-lane solo "
        f"call (the fleet's) {kloop_ms:.3f} ms, one torch.bmm {kbmm_ms:.3f} "
        f"ms ({kloop_ms / kbmm_ms:.2f}x); bmm lanes bit-equal to the solo "
        f"call {sum(bmm_bits)} of {FLEET_B}, max |diff| {bmm_err:.3e}; batch "
        f"counts at which every bmm lane is: {bmm_counts}; f32 bound "
        f"{kbb_bound:.3f} ms")
    shape = {"B": FLEET_B, "q": q}
    return [{
        "name": "inner_smo_batched", "route": "cuda",
        "source": "tpusvm_torch/csrc/inner_smo.cu",
        "replaces": "tpusvm/ops/pallas/inner_smo.py:545",
        "launches": None, "max_abs_err": err2, "ms": k2_ms, "kernel_ms": k2_ms,
        "plain_ms": p2_ms, "bound_ms": b2_bound, "bound_by": "bytes",
        "library_ms": None, "solo_launches_ms": s2_ms,
        "shape": dict(shape, max_inner=4096, wss=2, iterations=iters)}, {
        "name": "fused_fupdate_batched", "route": "cuda",
        "source": "tpusvm_torch/csrc/fused_fupdate.cu",
        "replaces": "tpusvm/ops/pallas/fused_fupdate.py:150",
        "launches": None, "max_abs_err": max(errs), "ms": k1_ms,
        "kernel_ms": k1_ms, "plain_ms": p1_ms,
        "bound_ms": max(b1_ops, b1_bytes),
        "bound_by": "operations" if b1_ops >= b1_bytes else "bytes",
        "library_ms": lib1_ms, "solo_launches_ms": s1_ms,
        "kbb_loop_ms": kloop_ms, "kbb_bmm_ms": kbmm_ms,
        "kbb_bmm_bits_equal": sum(bmm_bits), "kbb_bmm_equal_counts": bmm_counts,
        "shape": dict(shape, n=n, d=d)}]


def _gates(model, ref):
    """benchmarks/solver_ladder.py's gates of a fit against `ref`: (SV-set
    flips, |b - b_ref|, whether flips <= max(2, |SV|/25) and |db| <=
    1e-3)."""
    flips = len(set(model.sv_ids_) ^ set(ref.sv_ids_))
    db = abs(model.b_ - ref.b_)
    return flips, db, flips <= max(2, len(ref.sv_ids_) // 25) and db <= 1e-3


def phase_ring_and_rungs(X_all, Y_all, n_tr, m5, acc5, train5_s, m11, gaps11,
                         m13a, acc13a, train13a_s, device, counters):
    """Phase 15: (a) phase 5's job with telemetry=128, equal to phase 5 bit
    for bit (alpha, b, updates, rounds), its ring's table printed; (b) phase
    5's job at bf16_f32 and bf16_f32c with refine=4096, max_refines=2:
    CONVERGED, within the ladder gates against phase 11 (the f32 fit with
    the same refine: phase 5's own b sits 1.5e-3 from it, over the gate,
    PERF.md section 6, PR 9), its b and the f64 b of its alphas (exact_b,
    independent of the refine rebuilds) within 1e-3 of each other and the
    latter within 1e-3 of phase 11's f64 b, its f64 exact-f gap within the
    f32 evaluation floor max(2 tau, 4e-7 sum(alpha)) (phase 11's band),
    within 0.002 of phase 5's accuracy, kernel #1 launched only in the
    refine rebuilds and #4 never; the gates against phase 5 printed too;
    (c) phase 13(a)'s shrinking job at bf16_f32: CONVERGED within the
    ladder gates against 13(a), its rebuilds (#1 launches), anneal round,
    un-shrinks and exact-f gap printed."""
    import torch
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.obs.convergence import format_gap_table
    from tpusvm_torch.status import Status

    def fit(extra):
        for fn in counters.values():
            fn.launches = 0
        model = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                          solver_opts=dict(FULL_OPTS, **extra), device=device)
        sync(device)
        t = time.perf_counter()
        model.fit(X_all[:n_tr], Y_all[:n_tr])
        sync(device)
        secs = time.perf_counter() - t
        acc = float((model.predict(X_all[n_tr:]) == Y_all[n_tr:]).mean())
        return model, acc, secs, {k: fn.launches for k, fn in counters.items()}

    # (a) the ring
    m, acc, secs, counts = fit(dict(telemetry=128))
    r, r5 = m.result_, m5.result_
    same = (torch.equal(r.alpha, r5.alpha) and r.b == r5.b
            and r.n_iter == r5.n_iter and r.n_outer == r5.n_outer)
    conv = m.convergence_
    log(f"[15a] phase 5's job with telemetry=128: train {secs:.3f} s (phase 5 "
        f"{train5_s:.3f}), equal to phase 5 bit for bit {same} (alpha, b "
        f"{r.b:.15f}, updates {r.n_iter - 1}, rounds {r.n_outer}); ring: "
        f"{conv['rounds_recorded']} rounds recorded, host syncs "
        f"{r.n_host_syncs} (phase 5 {r5.n_host_syncs})")
    for line in format_gap_table(conv, max_rows=12).splitlines():
        log(f"    {line}")
    check(same, "[15a] the ring changed the trajectory")
    check(r.n_host_syncs == r5.n_host_syncs, "[15a] the ring added host syncs")
    check(conv["rounds_recorded"] == r.n_outer + r.n_refines + 1,
          f"[15a] ring count {conv['rounds_recorded']}")

    # (b) the bf16 rungs with refine; the second baseline is the f64 b
    # (b_high + b_low) / 2 that each fit's alphas give on f rebuilt in f64
    # (exact_b: torch f64, not kernel #1, so a bias of the refine rebuilds
    # that the rungs share with phase 11 shows there)
    b64_of = {}
    for tag, ref in (("5", m5), ("11", m11)):
        bh_r, bl_r = exact_b(ref, X_all[:n_tr], Y_all[:n_tr], device)
        b64_of[tag] = (bh_r + bl_r) / 2
    for rung in ("bf16_f32", "bf16_f32c"):
        m, acc, secs, counts = fit(dict(matmul_precision=rung, refine=4096,
                                        max_refines=2))
        r = m.result_
        flips, db, ok = _gates(m, m11)
        flips5, db5, ok5 = _gates(m, m5)
        bh, bl = exact_b(m, X_all[:n_tr], Y_all[:n_tr], device)
        b64 = (bh + bl) / 2
        db64_own, db64_11 = abs(m.b_ - b64), abs(b64 - b64_of["11"])
        log(f"[15b] {rung}, refine=4096: train {secs:.3f} s (phase 5 "
            f"{train5_s:.3f}), status {m.status_.name}, rounds {r.n_outer}, "
            f"updates {m.n_iter_ - 1}, refines {r.n_refines}, SVs "
            f"{m.n_support_}, b {m.b_:.15f}; against phase 11 (f32, the same "
            f"refine): SV flips {flips}, |db| {db:.3e}, within the gates {ok}; "
            f"against phase 5: SV flips {flips5}, |db| {db5:.3e}, within the "
            f"gates {ok5}; f64 exact-f gap {bl - bh:.3e} (the f32 evaluation "
            f"floor 4e-7 * sum(alpha) "
            f"{4e-7 * float(m.sv_alpha_.sum()):.3e}; phase 5 "
            f"{gaps11['phase 5']:.3e}, phase 11 "
            f"{gaps11['phase 11 (refine)']:.3e}); accuracy {acc:.4f} vs "
            f"{acc5:.4f}; launches {counts}")
        log(f"[15b] {rung}, f64 b: {b64:.15f}, |b - f64 b| {db64_own:.3e}; "
            f"against phase 11's f64 b {b64_of['11']:.15f}: {db64_11:.3e}; "
            f"phase 5's f64 b {b64_of['5']:.15f} (its b {m5.b_:.15f}): "
            f"{abs(b64 - b64_of['5']):.3e}")
        check(ok, f"[15b] {rung}: outside the ladder gates against phase 11 "
              f"(flips {flips}, |db| {db})")
        check(db64_own <= 1e-3 and db64_11 <= 1e-3,
              f"[15b] {rung}: b {m.b_} is {db64_own} from the f64 b of its "
              f"alphas, which is {db64_11} from phase 11's (gate 1e-3)")
        floor = max(2e-5, 4e-7 * float(m.sv_alpha_.sum()))
        check(bl - bh <= floor, f"[15b] {rung}: exact-f gap {bl - bh} over "
              f"the f32 evaluation floor {floor}")
        check(m.status_ == Status.CONVERGED, f"[15b] {rung}: {m.status_.name}")
        check(abs(acc - acc5) <= 0.002, f"[15b] {rung}: accuracy {acc}")
        check(device == "cpu" or counts["fused_fupdate"] == r.n_refines,
              f"[15b] {rung}: #1 launched outside the rebuilds {counts}")
        check(counts["fused_fupdate_select"] == 0, f"[15b] #4 launched {counts}")
        check(device == "cpu" or counts["inner_smo"] > 0, f"[15b] {counts}")

    # (c) the drift guard on the shrinking job
    m, acc, secs, counts = fit(dict(shrink_every=2, shrink_stable=3,
                                    matmul_precision="bf16_f32"))
    r = m.result_
    hist = r.shrink_history
    flips, db, ok = _gates(m, m13a)
    bh, bl = exact_b(m, X_all[:n_tr], Y_all[:n_tr], device)
    bh13, bl13 = exact_b(m13a, X_all[:n_tr], Y_all[:n_tr], device)
    anneal = [h["round"] for h in hist if h["event"] == "anneal"]
    log(f"[15c] phase 13(a)'s shrinking job at bf16_f32: train {secs:.3f} s "
        f"(13(a) {train13a_s:.3f}), status {m.status_.name}, rounds {r.n_outer}, "
        f"updates {m.n_iter_ - 1}; f rebuilt at the trust tier by #1 "
        f"{counts['fused_fupdate']} times (every bf16 pause, un-shrink and "
        f"verify), anneal to f32 at round {anneal or 'none'}, un-shrinks "
        f"{sum(h['event'] == 'unshrink' for h in hist)}, verifies "
        f"{sum(h['event'] == 'verify' for h in hist)}, compactions "
        f"{sum(h['event'] == 'shrink' for h in hist)}; against 13(a): SV flips "
        f"{flips}, |db| {db:.3e}, within the gates {ok}, accuracy {acc:.4f} "
        f"vs {acc13a:.4f}; f64 exact-f gap {bl - bh:.3e} (13(a) "
        f"{bl13 - bh13:.3e})")
    check(ok, f"[15c] outside the ladder gates (flips {flips}, |db| {db})")
    check(m.status_ == Status.CONVERGED, f"[15c] {m.status_.name}")
    check(device == "cpu" or counts["fused_fupdate"] > 0, f"[15c] {counts}")


def phase_fleet(Xm, lm, n_tr, ovr_a, device, counters, launches):
    """Phase 16: phase 8's ten heads at full width with solver="fleet"
    (q=2048, max_inner=4096, wss=2), with compact_every=0 and 4: every head
    CONVERGED with 8(a)'s SV-ID set, status and held-out accuracy, |db|
    within 1e-4; the problem-axis #1 and #2 launched and no solo #2; host
    syncs <= 2 a round; on the card, each head's bits the same with the
    heads in reverse order in the same bucket; compact_every=4 (inert in
    the port) changes no bit and no lane-round. Adds the fleet's launches
    to `launches`."""
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import OneVsRestSVC
    from tpusvm_torch.status import Status

    ma, _, acc_a = ovr_a
    fits = {}
    for tag, extra, labels in (("16", {}, lm), ("16c", dict(compact_every=4), lm),
                               ("16r", {}, 9 - lm)):
        for fn in counters.values():
            fn.launches = 0
        m = OneVsRestSVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                         solver="fleet",
                         solver_opts=dict(OVR_OPTS, **extra), device=device)
        sync(device)
        t = time.perf_counter()
        m.fit(Xm[:n_tr], labels[:n_tr])
        sync(device)
        secs = time.perf_counter() - t
        counts = {k: fn.launches for k, fn in counters.items()}
        fits[tag] = (m, counts)
        if tag == "16r":
            break
        acc = float((m.predict(Xm[n_tr:]) == lm[n_tr:]).mean())
        st = m.fleet_stats_
        sts = [Status(int(v)).name for v in m.statuses_]
        same_sv = [np.array_equal(np.nonzero(ra.alpha.cpu().numpy() > 1e-8)[0],
                                  np.nonzero(rb.alpha.cpu().numpy() > 1e-8)[0])
                   for ra, rb in zip(m.results_, ma.results_)]
        dbs = [abs(float(x) - float(y)) for x, y in zip(m.b_, ma.b_)]
        bitwise = [bool((ra.alpha == rb.alpha).all())
                   for ra, rb in zip(m.results_, ma.results_)]
        log(f"[{tag}] fleet of {len(m.classes_)} heads n={n_tr} "
            f"{json.dumps(dict(OVR_OPTS, **extra))}: train {secs:.3f} s (8(a)'s "
            f"sequential heads {ma.train_time_s_:.3f} s), accuracy {acc:.4f} "
            f"(8(a) {acc_a:.4f}); statuses {sts}; per-head SV-ID sets equal to "
            f"8(a)'s {same_sv}, alphas bit-equal to 8(a)'s {bitwise}; |db| "
            f"{[f'{x:.1e}' for x in dbs]}")
        log(f"[{tag}] lockstep rounds {st['rounds']}, lane-rounds "
            f"{st['lane_rounds']} (a program that runs frozen lanes: "
            f"{st['bucket_rounds']}), host syncs "
            f"{st['host_syncs']} ({st['host_syncs'] / st['rounds']:.2f} a round), "
            f"blocked at them {st['host_wait_s'] * 1e3:.1f} ms; launches {counts}")
        check(all(s == "CONVERGED" for s in sts), f"[{tag}] heads {sts}")
        check(all(same_sv), f"[{tag}] SV-ID sets differ from 8(a) {same_sv}")
        check(np.array_equal(m.statuses_, ma.statuses_), f"[{tag}] statuses")
        check(acc == acc_a, f"[{tag}] accuracy {acc} vs 8(a) {acc_a}")
        check(max(dbs) <= 1e-4, f"[{tag}] |db| {max(dbs)}")
        check(st["host_syncs"] <= 2 * st["rounds"], f"[{tag}] host syncs {st}")
        check(device == "cpu" or (counts["inner_smo_batched"] > 0
                                  and counts["fused_fupdate_batched"] > 0
                                  and counts["inner_smo"] == 0),
              f"[{tag}] launches {counts}")
        if tag == "16":
            for k in ("inner_smo_batched", "fused_fupdate_batched"):
                launches[k] = {"16": counts[k]}
    # lane invariance: the reversed heads in the same bucket of 16
    (mr, _), (m16, c16), (m16c, c16c) = fits["16r"], fits["16"], fits["16c"]
    K = len(m16.classes_)
    inv = [bool((ra.alpha == rb.alpha).all()) and float(ra.b) == float(rb.b)
           for ra, rb in zip(m16.results_, reversed(mr.results_))]
    same_comp = [bool((ra.alpha == rb.alpha).all())
                 for ra, rb in zip(m16.results_, m16c.results_)]
    rounds = {t: (m.fleet_stats_["rounds"], m.fleet_stats_["lane_rounds"])
              for t, m in (("16", m16), ("16c", m16c))}
    log(f"[16] lane invariance: each of the {K} heads bit-equal with the heads "
        f"in reverse order {inv}; compact_every=4 (inert): heads bit-equal to "
        f"compact_every=0's {same_comp}, (rounds, lane-rounds) {rounds}, "
        f"launches equal {c16 == c16c}")
    check(all(inv), f"[16] lanes depend on their companions {inv}")
    check(all(same_comp) and rounds["16"] == rounds["16c"] and c16 == c16c,
          f"[16] compact_every changed the solve {same_comp} {rounds}")


def sync(device):
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from tpusvm_torch.data.scaler import MinMaxScaler
        from tpusvm_torch.data.synthetic import mnist_like
        from tpusvm_torch.ops.cuda import _build
        from tpusvm_torch.ops.cuda.fused_fupdate import (
            fused_fupdate_select_kernel, fused_fupdate_select_ref,
            rbf_cross_matvec_kernel, rbf_cross_matvec_ref,
            select_candidates_ref, select_epilogue_probe, selection_shape)
        from tpusvm_torch.ops.cuda.fused_fupdate import (
            rbf_cross_matvec_batched_kernel)
        from tpusvm_torch.ops.cuda.inner_smo import (
            inner_smo_batched_kernel, inner_smo_kernel,
            inner_smo_multipair_kernel, inner_smo_multipair_ref, inner_smo_ref,
            iteration_floor_probe, multipair_floor_probe)
        from tpusvm_torch.ops.cuda.pair_rows import (pair_rows_kernel,
                                                     pair_rows_ref)
        from tpusvm_torch.ops.rbf import rbf_cross, sq_norms
        from tpusvm_torch.config import SVMConfig
        from tpusvm_torch.models import (BinarySVC, EpsilonSVR, OneVsRestSVC,
                                         load_any)
        from tpusvm_torch.status import Status
    except ImportError as e:
        print(f"chip_smoke: tpusvm_torch is not importable here ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    clock = PhaseClock()

    # ---- 1. provenance ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, peak_tf32 = peaks(kind)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; device {kind} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; peaks used "
        f"for bounds: f32 {peak_flops / 1e12:.1f} TFLOP/s, TF32 tensor "
        f"{peak_tf32 / 1e12:.1f} TFLOP/s, {peak_bw / 1e12:.2f} TB/s")

    # ---- 2. build ---------------------------------------------------------
    t = time.perf_counter()
    secs = _build.build_all()
    log(f"[2] built {sorted(secs)} in {time.perf_counter() - t:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in secs.items()})})")
    for name in secs:
        path = _build.BUILD_DIR / f"{name}.log"
        if path.exists():
            for line in path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    ptxas {name}: {line.strip()}")

    kernels = []

    # ---- 3. kernels against their plain versions --------------------------
    X_all, Y_all = mnist_like(n=70000, d=784, noise=30.0, label_noise=0.005,
                              seed=587)
    scaler = MinMaxScaler().fit(X_all[:60000])
    Xs = scaler.transform(X_all[:60000]).astype(np.float32)
    Ytr = Y_all[:60000]
    X = torch.as_tensor(Xs, device=dev)
    Y = torch.as_tensor(Ytr, device=dev)
    n, d = X.shape
    q = 2048

    sn = sq_norms(X)
    # the full-width solve's first working set (cold start) and fourth
    cold, round4, B, alpha3, f3 = inner_working_sets(X, Y, sn, q, dev)
    XB = X[B].contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    coef = (torch.randn(q, generator=gen) * 0.5).to(dev)

    def fused_case(Xc, XBc, cc, snc, label):
        got = rbf_cross_matvec_kernel(Xc, XBc, cc, GAMMA, snc)
        want = rbf_cross_matvec_ref(Xc, XBc, cc, GAMMA, snc)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * float(cc.abs().sum())
        log(f"[3] fused_fupdate {label}: max_abs_err {err:.3e} (tol {tol:.3e})")
        check(torch.isfinite(got).all().item(), f"fused_fupdate {label}: non-finite")
        check(err <= tol, f"fused_fupdate {label}: error {err} over {tol}")
        return err

    err_bench = fused_case(X, XB, coef, sn, f"bench n={n} d={d} q={q}")
    rng = np.random.default_rng(1)
    Xr = torch.as_tensor(rng.random((1000, 37)), dtype=torch.float32, device=dev)
    XBr = torch.as_tensor(rng.random((256, 37)), dtype=torch.float32, device=dev)
    cr = torch.as_tensor(rng.standard_normal(256), dtype=torch.float32, device=dev)
    fused_case(Xr, XBr, cr, None, "ragged n=1000 d=37 q=256")

    # the contraction's precision: 3xTF32 against a single-pass TF32 product
    fu_err, kv_err, kv_gammas = precision_errors(
        rbf_cross_matvec_kernel, rbf_cross_matvec_ref, X, XB, coef, GAMMA, sn)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 left switched on")
    for label, errs in ((f"kernel values at gamma=1/median d2 ({min(kv_gammas):.4g}"
                         f"..{max(kv_gammas):.4g})", kv_err),
                        (f"f-update at gamma={GAMMA}", fu_err)):
        log(f"[3] fused_fupdate bench precision, {label}, max |err| against f64: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; kernel / single-pass TF32 = "
            f"{errs['kernel'] / errs['single-pass TF32']:.3f}, kernel / plain f32 "
            f"= {errs['kernel'] / errs['plain f32']:.3f}")
    # kernel values isolate the contraction: the lo terms must apply
    check(kv_err["kernel"] < 0.1 * kv_err["single-pass TF32"],
          f"fused_fupdate kernel values: error {kv_err['kernel']} is not under a "
          f"tenth of single-pass TF32's {kv_err['single-pass TF32']}")
    # at the solver's gamma the f32 rounding of the epilogue's sum sets the
    # error, for the kernel as for the plain version
    check(fu_err["kernel"] <= 3.0 * fu_err["plain f32"],
          f"fused_fupdate at gamma={GAMMA}: error {fu_err['kernel']} is over 3x the "
          f"plain f32 version's {fu_err['plain f32']}")

    k_ms = cuda_ms(lambda: rbf_cross_matvec_kernel(X, XB, coef, GAMMA, sn))
    k_host = host_us(lambda: rbf_cross_matvec_kernel(X, XB, coef, GAMMA, sn))
    p_ms = cuda_ms(lambda: rbf_cross_matvec_ref(X, XB, coef, GAMMA, sn))
    lib_ms = cuda_ms(lambda: torch.matmul(X, XB.T))
    flops = 2.0 * n * d * q
    nbytes = 4.0 * (n * d + q * d + q + n + n)
    # the kernel's operations: three TF32 products on the tensor cores
    t_tc = 3 * flops / peak_tf32 * 1e3
    t_bytes = nbytes / peak_bw * 1e3

    def bounds_line(ms):
        return (f"bound: 3xTF32 {t_tc:.3f} ms ({100 * t_tc / ms:.1f}% of it "
                f"reached; bytes {t_bytes:.4f} ms); {flops / ms / 1e9:.1f} "
                f"effective TFLOP/s (2nqd / time), {3 * flops / ms / 1e9:.1f} TF32 "
                f"TFLOP/s issued; for reference, 2nqd at the f32 FMA rate takes "
                f"{flops / peak_flops * 1e3:.3f} ms")

    log(f"[3] fused_fupdate bench: kernel {k_ms:.3f} ms (host {k_host:.1f} us a "
        f"call in the wrapper), plain {p_ms:.3f} ms, torch.matmul(X, XB.T) "
        f"{lib_ms:.3f} ms; {bounds_line(k_ms)}")
    check(k_ms < lib_ms, f"fused_fupdate {k_ms} ms is not under torch.matmul's "
          f"{lib_ms} ms")
    kernels.append({
        "name": "fused_fupdate", "route": "cuda",
        "source": "tpusvm_torch/csrc/fused_fupdate.cu",
        "replaces": "tpusvm/ops/pallas/fused_fupdate.py:150",
        "launches": None, "max_abs_err": err_bench, "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": p_ms, "bound_ms": max(t_tc, t_bytes),
        "bound_by": "operations" if t_tc >= t_bytes else "bytes",
        "library_ms": lib_ms, "max_abs_err_f64": fu_err,
        "kernel_value_err_f64": kv_err,
        "shape": {"n": n, "d": d, "q": q}})

    # the inner kernels against their plain versions, bit for bit: a_out
    # and all four stat entries
    inner_errs = {"inner_smo": 0.0, "inner_smo_multipair": 0.0}

    def same(kernel_out, plain_out, label):
        (a_k, st_k), (a_r, st_r) = kernel_out, plain_out
        torch.cuda.synchronize()
        st = st_k.tolist()
        name = "inner_smo_multipair" if "multipair" in label else "inner_smo"
        inner_errs[name] = max(inner_errs[name], float((a_k - a_r).abs().max()))
        equal = torch.equal(a_k, a_r) and st == st_r.tolist()
        log(f"[3] {label}: stat kernel {st} plain {st_r.tolist()}, a_out and stat "
            f"bit-equal {equal}")
        check(equal, f"{label}: kernel differs from its plain version "
              f"(max |da| {float((a_k - a_r).abs().max())})")
        check(st[2] in (1, 2, 5), f"{label}: bad stat {st}")
        return st

    g2 = np.random.default_rng(3)
    Xq = torch.as_tensor(g2.random((256, 8)), dtype=torch.float32, device=dev)
    yq = torch.as_tensor(np.where(g2.random(256) < 0.5, 1, -1), device=dev)
    Kq = rbf_cross(Xq, Xq, 0.5)
    for wss, ex in ((1, False), (2, False), (2, True)):
        args = (Kq, yq, torch.zeros(256, device=dev), -yq.float(),
                torch.ones(256, dtype=torch.bool, device=dev), C, 1e-12, 1e-5)
        same(inner_smo_kernel(*args, max_inner=512, wss=wss, eta_exclude=ex),
             inner_smo_ref(*args, max_inner=512, wss=wss, eta_exclude=ex),
             f"inner_smo q=256 wss={wss} eta_exclude={ex}")

    # at the full-width shape: the first round's K_BB (cold start) and the
    # fourth round's (a mid-solve state: nonzero alphas, f from them)
    def inner_case(ws, label):
        inner_args = (*ws, C, 1e-12, 1e-5)
        out = inner_smo_kernel(*inner_args, max_inner=4096, wss=2)
        t = time.perf_counter()
        ref = inner_smo_ref(*inner_args, max_inner=4096, wss=2)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t) * 1e3
        st = same(out, ref, f"inner_smo q={q} max_inner=4096 wss=2 {label}")
        check(st[0] > 0, f"inner_smo q={q}: no update {st}")
        k_ms = cuda_ms(lambda: inner_smo_kernel(*inner_args, max_inner=4096, wss=2))
        return st, k_ms, p_ms

    st, k_ms, p_ms = inner_case(cold, "cold start")
    a_B4 = round4[2]
    st_mid, k_mid_ms, _ = inner_case(
        round4, f"round 4 ({int((a_B4 > 0).sum())} nonzero alphas)")
    log(f"[3] inner_smo q={q} round 4: kernel {k_mid_ms:.3f} ms for "
        f"{st_mid[0]} updates ({k_mid_ms * 1e3 / max(st_mid[3], 1):.2f} "
        "us/iteration)")

    def floors(probe, K_BB, iters, **kw):
        """Per-iteration floors in us: the reduction chain alone, one
        iteration's row reads alone (all in flight as the kernel issues
        them), and their sum."""
        chain = cuda_ms(lambda: probe(K_BB, iters, mode="chain", **kw))
        rows = cuda_ms(lambda: probe(K_BB, iters, mode="rows", **kw))
        return chain, rows, chain + rows

    def floors_line(ms, fl, iters):
        per = lambda t: t * 1e3 / max(iters, 1)
        chain, rows, both = fl
        return (f"{per(ms):.2f} us/iteration; floors per iteration: reduction "
                f"chain {per(chain):.2f} us, row reads {per(rows):.2f} us, their sum "
                f"{per(both):.2f} us (kernel at {ms / both:.2f}x the sum)")

    # floors on the cold-start run's iteration count (K_BB is L2-resident)
    iters = st[3]
    K_BB = cold[0]
    fl = floors(iteration_floor_probe, K_BB, iters, wss=2)
    ibytes = iters * 2.0 * q * 4 + 5.0 * q * 4 + q * 4
    i_bound = ibytes / peak_bw * 1e3
    log(f"[3] inner_smo q={q} cold start: kernel {k_ms:.3f} ms for {st[0]} "
        f"updates ({iters} iterations), {floors_line(k_ms, fl, iters)}; plain "
        f"{p_ms:.1f} ms (one run); HBM byte bound {i_bound:.4f} ms")
    kernels.append({
        "name": "inner_smo", "route": "cuda",
        "source": "tpusvm_torch/csrc/inner_smo.cu",
        "replaces": "tpusvm/ops/pallas/inner_smo.py:545",
        "launches": None, "max_abs_err": inner_errs["inner_smo"],
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": i_bound,
        "bound_by": "bytes", "library_ms": None,
        "chain_floor_ms": fl[0], "rows_floor_ms": fl[1], "floor_sum_ms": fl[2],
        "shape": {"q": q, "max_inner": 4096, "wss": 2, "updates": st[0],
                  "iterations": iters}})

    # the multipair kernel at the CPU tests' size, then at the full-width
    # shape for p = 2, 4, 8 on the cold-start and the round-4 working sets
    g3 = np.random.default_rng(7)
    X5 = torch.as_tensor(g3.random((512, 8)), dtype=torch.float32, device=dev)
    y5 = torch.as_tensor(np.where(g3.random(512) < 0.5, 1, -1), device=dev)

    def multipair_case(ws, p, label, max_inner=4096):
        margs = (*ws, C, 1e-12, 1e-5)
        out = inner_smo_multipair_kernel(*margs, max_inner=max_inner, multipair=p)
        t = time.perf_counter()
        ref = inner_smo_multipair_ref(*margs, max_inner=max_inner, multipair=p)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t) * 1e3
        st = same(out, ref, f"inner_smo multipair q={ws[0].shape[0]} p={p} {label}")
        check(st[0] > 0, f"multipair: no update {st}")
        ms = cuda_ms(lambda: inner_smo_multipair_kernel(
            *margs, max_inner=max_inner, multipair=p))
        log(f"[3]     kernel {ms:.3f} ms, {ms * 1e3 / st[3]:.2f} us/iteration, "
            f"{st[0] / st[3]:.2f} updates/iteration, plain {plain:.1f} ms "
            "(one run)")
        return st, ms, plain

    multipair_case((rbf_cross(X5, X5, 0.5), y5, torch.zeros(512, device=dev),
                    -y5.float(), torch.ones(512, dtype=torch.bool, device=dev)), 2,
                   "q=512 (CPU tests' size)")
    mp_runs = {}
    for p in (2, 4, 8):
        mp_runs[p] = multipair_case(cold, p, "cold start")
        multipair_case(round4, p, "round 4")
    # the path's p = 4: floors on the cold-start run's iteration count
    st_mp, mp_ms, mp_plain = mp_runs[4]
    mp_iters = st_mp[3]
    mp_fl = floors(multipair_floor_probe, K_BB, mp_iters, multipair=4)
    # bytes the run's updates need: two K_BB rows each, plus the vectors
    mp_bytes = st_mp[0] * 2.0 * q * 4 + 6.0 * q * 4
    mp_bound = mp_bytes / peak_bw * 1e3
    log(f"[3] inner_smo multipair q={q} p=4 cold start: kernel {mp_ms:.3f} ms for "
        f"{st_mp[0]} updates ({mp_iters} iterations, {mp_ms * 1e3 / st_mp[0]:.3f} "
        f"us/update; single-pair wss=2 {k_ms * 1e3 / st[0]:.3f} us/update), "
        f"{floors_line(mp_ms, mp_fl, mp_iters)}; HBM byte bound {mp_bound:.4f} ms")
    kernels.append({
        "name": "inner_smo_multipair", "route": "cuda",
        "source": "tpusvm_torch/csrc/inner_smo_multipair.cu",
        "replaces": "tpusvm/ops/pallas/inner_smo.py:277",
        "launches": None, "max_abs_err": inner_errs["inner_smo_multipair"],
        "ms": mp_ms, "kernel_ms": mp_ms,
        "plain_ms": mp_plain, "bound_ms": mp_bound, "bound_by": "bytes",
        "library_ms": None, "chain_floor_ms": mp_fl[0], "rows_floor_ms": mp_fl[1],
        "floor_sum_ms": mp_fl[2],
        "shape": {"q": q, "max_inner": 4096, "multipair": 4, "wss": 1,
                  "updates": st_mp[0], "iterations": mp_iters}})

    # the f-update with candidate selection: df against the f-update alone
    # (bit for bit), the candidates against the plain epilogue on that df,
    # at the bench shape (round 4's f and alpha) and a ragged shape
    def select_case(Xc, XBc, cc, snc, f32c, a32c, yec, label):
        nc, dc = Xc.shape
        blk, nb, kc, _ = selection_shape(nc, dc, XBc.shape[0])
        args = (Xc, XBc, cc, GAMMA, snc, f32c, a32c, yec, C, 1e-12)
        df, *cands = fused_fupdate_select_kernel(*args, block=blk, k_cand=kc)
        df1 = rbf_cross_matvec_kernel(Xc, XBc, cc, GAMMA, snc)
        want = select_candidates_ref(f32c + df, a32c, yec, C, 1e-12, nc, blk, kc)
        err = float((df - rbf_cross_matvec_ref(Xc, XBc, cc, GAMMA, snc)).abs().max())
        torch.cuda.synchronize()
        same = [torch.equal(g, w) for g, w in zip(cands, want)]
        log(f"[3] fused_select {label} (block {blk}, {nb} blocks, k_cand {kc}): "
            f"df bit-equal to fused_fupdate {torch.equal(df, df1)}, max_abs_err "
            f"to the plain contraction {err:.3e}; candidates equal to the plain "
            f"epilogue on the kernel's df {same}")
        check(torch.equal(df, df1), f"fused_select {label}: df differs")
        check(err <= 1e-5 * float(cc.abs().sum()), f"fused_select {label}: {err}")
        check(all(same), f"fused_select {label}: candidates differ {same}")
        return args, blk, kc, nb, err

    f3_32, a3_32 = f3.float(), alpha3.float()
    sel_args, blk, kc, nb, sel_err = select_case(X, XB, coef, sn, f3_32, a3_32,
                                        Y.to(torch.int32), f"bench n={n} d={d} q={q}")
    gr = np.random.default_rng(2)
    select_case(Xr, XBr, cr, None,
                torch.as_tensor(np.round(gr.standard_normal(1000), 1),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(gr.choice([0.0, C, 2.5], size=1000),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(np.where(gr.random(1000) < 0.5, 1, -1)
                                * (gr.random(1000) > 0.1), dtype=torch.int32,
                                device=dev), "ragged n=1000 d=37 q=256")
    s_ms = cuda_ms(lambda: fused_fupdate_select_kernel(*sel_args, block=blk,
                                                       k_cand=kc))
    f_ms = cuda_ms(lambda: rbf_cross_matvec_kernel(X, XB, coef, GAMMA, sn))
    df_bench = rbf_cross_matvec_kernel(X, XB, coef, GAMMA, sn)
    e_ms = cuda_ms(lambda: select_epilogue_probe(df_bench, f3_32, a3_32,
                                                 Y.to(torch.int32), C, 1e-12,
                                                 block=blk, k_cand=kc))
    sp_ms = cuda_ms(lambda: fused_fupdate_select_ref(*sel_args, block=blk,
                                                     k_cand=kc), reps=5)
    s_bytes = 4.0 * (n * d + q * d + q + 4 * n + n + 4 * nb * kc)
    s_byt = s_bytes / peak_bw * 1e3
    log(f"[3] fused_select bench: kernel {s_ms:.3f} ms (all four launches; the "
        f"f-update alone {f_ms:.3f} ms, the epilogue launch alone {e_ms:.4f} "
        f"ms), plain {sp_ms:.3f} ms, torch.matmul(X, XB.T) {lib_ms:.3f} ms; "
        f"{bounds_line(s_ms)}")
    check(s_ms < lib_ms, f"fused_select {s_ms} ms is not under torch.matmul's "
          f"{lib_ms} ms")
    kernels.append({
        "name": "fused_fupdate_select", "route": "cuda",
        "source": "tpusvm_torch/csrc/fused_select.cu",
        "replaces": "tpusvm/ops/pallas/fused_fupdate.py:334",
        "launches": None, "max_abs_err": sel_err, "ms": s_ms, "kernel_ms": s_ms,
        "plain_ms": sp_ms, "bound_ms": max(t_tc, s_byt),
        "bound_by": "operations" if t_tc >= s_byt else "bytes",
        "library_ms": lib_ms, "fupdate_alone_ms": f_ms, "epilogue_ms": e_ms,
        "shape": {"n": n, "d": d, "q": q, "block": blk, "k_cand": kc}})

    # the pair solver's K-row refresh against its plain version, every
    # exact family, k=2 (a binary fit) and k=20 (ten lockstep heads).
    # Tolerance: max |kernel - plain| over the rows within rtol x the
    # largest plain value (both are f32 dots of d terms in different
    # orders, ~d * 2^-24 of the dot's scale; poly cubes its base)
    pr_rtol = {"rbf": 1e-5, "linear": 1e-5, "poly": 3e-5, "sigmoid": 1e-5}
    pr_kw = {"rbf": dict(gamma=GAMMA), "linear": dict(gamma=0.0),
             "poly": dict(gamma=1.0 / d, coef0=1.0, degree=3),
             "sigmoid": dict(gamma=1.0 / d, coef0=-1.0)}
    gp = np.random.default_rng(4)
    pr_runs = {}
    for k in (2, 20):
        idx = torch.as_tensor(gp.choice(n, k, replace=False), device=dev)
        yes = torch.ones(k, dtype=torch.bool, device=dev)
        no = torch.zeros(k, dtype=torch.bool, device=dev)
        for fam, fkw in pr_kw.items():
            kw = dict(family=fam, sn=sn, **fkw)
            rows = torch.zeros(k, n, device=dev)
            got = pair_rows_kernel(X, idx, yes, rows, **kw)
            want = pair_rows_ref(X, idx, yes, torch.zeros(k, n, device=dev), **kw)
            before = rows.clone()
            pair_rows_kernel(X, idx, no, rows, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            untouched = torch.equal(rows, before)
            check(torch.isfinite(got).all().item(), f"pair_rows {fam} k={k}: non-finite")
            check(rel <= pr_rtol[fam], f"pair_rows {fam} k={k}: rel error {rel} over "
                  f"{pr_rtol[fam]}")
            check(untouched, f"pair_rows {fam} k={k}: the skip path changed the rows")
            t_k = cuda_ms(lambda: pair_rows_kernel(X, idx, yes, rows, **kw))
            t_skip = cuda_ms(lambda: pair_rows_kernel(X, idx, no, rows, **kw))
            t_p = cuda_ms(lambda: pair_rows_ref(X, idx, yes, rows, **kw))
            t_lib = cuda_ms(lambda: rows_by_matmul(fam, X, idx, sn, fkw))
            pr_runs[(fam, k)] = dict(ms=t_k, skip_ms=t_skip, plain_ms=t_p,
                                     library_ms=t_lib, max_abs_err=err)
            log(f"[3] pair_rows {fam} k={k} n={n} d={d}: max_abs_err {err:.3e} "
                f"(rel {rel:.2e}, tol {pr_rtol[fam]:.0e}), skip path untouched "
                f"{untouched}; kernel {t_k:.4f} ms, all need clear {t_skip:.4f} ms, "
                f"plain {t_p:.4f} ms, torch.matmul(X[idx], X.T) + epilogue "
                f"{t_lib:.4f} ms")
    # the skip's device cost: 100 launches with every need clear captured
    # in one CUDA graph and replayed (the wrapper's host time drops out;
    # measurement launches, not counted)
    for k in (2, 20):
        idx = torch.as_tensor(gp.choice(n, k, replace=False), device=dev)
        no = torch.zeros(k, dtype=torch.bool, device=dev)
        rows = torch.zeros(k, n, device=dev)
        kw = dict(family="rbf", sn=sn, gamma=GAMMA)
        pair_rows_kernel(X, idx, no, rows, **kw)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(100):
                pair_rows_kernel(X, idx, no, rows, **kw)
        skip_us = cuda_ms(g.replay) * 10.0
        pr_runs[("rbf", k)]["skip_device_us"] = skip_us
        log(f"[3] pair_rows rbf k={k}, every need clear, inside a CUDA graph: "
            f"{skip_us:.2f} us a launch on the device")
    # its bound at the binary pair solver's shape (k=2, RBF) and at ten
    # lockstep heads' (k=20): X read once, sn read, k rows written; 2*k*n*d
    # flops at the f32 FMA rate is below that at both
    pr_bound = pair_rows_bound_ms(n, d, 2, peak_flops, peak_bw)
    pr20_bound = pair_rows_bound_ms(n, d, 20, peak_flops, peak_bw)
    pr, pr20 = pr_runs[("rbf", 2)], pr_runs[("rbf", 20)]
    for k_, run, bound in ((2, pr, pr_bound), (20, pr20, pr20_bound)):
        log(f"[3] pair_rows rbf k={k_}: kernel {run['ms']:.4f} ms against its bound "
            f"{bound:.4f} ms ({100 * bound / run['ms']:.1f}% of it reached); "
            f"torch.matmul(X[idx], X.T) + epilogue {run['library_ms']:.4f} ms; "
            f"plain {run['plain_ms']:.4f} ms")
    kernels.append({
        "name": "pair_rows", "route": "cuda",
        "source": "tpusvm_torch/csrc/pair_rows.cu",
        "replaces": "none: port only; the JAX package computes these rows in "
                    "XLA (tpusvm/ops/rbf.py:140)",
        "launches": None, "max_abs_err": pr["max_abs_err"], "ms": pr["ms"],
        "kernel_ms": pr["ms"], "plain_ms": pr["plain_ms"], "bound_ms": pr_bound,
        "bound_by": "bytes", "library_ms": pr["library_ms"],
        "skip_ms": pr["skip_ms"], "skip_device_us": pr["skip_device_us"],
        "k20_ms": pr20["ms"], "k20_bound_ms": pr20_bound,
        "k20_library_ms": pr20["library_ms"], "k20_plain_ms": pr20["plain_ms"],
        "k20_max_abs_err": pr20["max_abs_err"],
        "shape": {"n": n, "d": d, "k": 2, "family": "rbf"}})

    solo_ms = {k["name"]: k["ms"] for k in kernels}
    kernels.extend(phase_problem_axis(
        X, Y, sn, cold, round4, B, q, dev, peak_bw, peak_tf32, peak_flops,
        solo_ms["fused_fupdate"], solo_ms["inner_smo"]))

    clock("1-3")

    # ---- 4. main path, mid size, card against CPU -------------------------
    Xm, Ym = mnist_like(n=2000, d=784, noise=30.0, label_noise=0.005, seed=587)
    opts = dict(q=256, wss=2, max_inner=512)
    fits = {}
    for where in ("cuda", "cpu"):
        t = time.perf_counter()
        fits[where] = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                                solver_opts=opts, device=where).fit(Xm, Ym)
        m = fits[where]
        log(f"[4] mid n=2000 on {where}: {time.perf_counter() - t:.2f} s, "
            f"status {m.status_.name}, SVs {m.n_support_}, b {m.b_:.9f}, "
            f"updates {m.n_iter_ - 1}, rounds {m.result_.n_outer}")
    mc, mh = fits["cuda"], fits["cpu"]
    check(mc.status_ == mh.status_ == Status.CONVERGED, "mid: not CONVERGED")
    check(np.array_equal(mc.sv_ids_, mh.sv_ids_),
          f"mid: SV-ID sets differ ({len(set(mc.sv_ids_) ^ set(mh.sv_ids_))} ids)")
    check(abs(mc.b_ - mh.b_) <= 1e-4, f"mid: |db| = {abs(mc.b_ - mh.b_)}")

    # ---- 4b. the multipair + fused-selection path, mid size, card vs CPU --
    opts_b = dict(q=512, wss=1, max_inner=512, multipair=2, fused_selection=True)
    fits = {}
    for where in ("cuda", "cpu"):
        t = time.perf_counter()
        fits[where] = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                                solver_opts=opts_b, device=where).fit(Xm, Ym)
        m = fits[where]
        log(f"[4b] mid n=2000 q=512 multipair=2 fused_selection on {where}: "
            f"{time.perf_counter() - t:.2f} s, status {m.status_.name}, SVs "
            f"{m.n_support_}, b {m.b_:.9f}, updates {m.n_iter_ - 1}, rounds "
            f"{m.result_.n_outer}, rescue rounds {m.result_.n_rescue}")
    mc, mh = fits["cuda"], fits["cpu"]
    check(mc.status_ == mh.status_ == Status.CONVERGED, "mid 4b: not CONVERGED")
    check(np.array_equal(mc.sv_ids_, mh.sv_ids_),
          f"mid 4b: SV-ID sets differ ({len(set(mc.sv_ids_) ^ set(mh.sv_ids_))} ids)")
    check(abs(mc.b_ - mh.b_) <= 1e-4, f"mid 4b: |db| = {abs(mc.b_ - mh.b_)}")

    clock("4, 4b")

    # ---- 5. and 5b. both paths at full width ------------------------------
    counters = {"fused_fupdate": rbf_cross_matvec_kernel,
                "inner_smo": inner_smo_kernel,
                "inner_smo_multipair": inner_smo_multipair_kernel,
                "fused_fupdate_select": fused_fupdate_select_kernel,
                "pair_rows": pair_rows_kernel,
                "inner_smo_batched": inner_smo_batched_kernel,
                "fused_fupdate_batched": rbf_cross_matvec_batched_kernel}
    full_opts = {
        "5": dict(q=2048, wss=2, max_inner=4096),
        "5b": dict(q=2048, wss=1, max_inner=4096, multipair=4,
                   fused_selection=True),
    }
    # 5b alone gets 10^7 updates: at p=4 the Jacobi slot steps overshoot at
    # this width and the solve needs about 2.6 million (PERF.md, section 6)
    max_iter = {"5": 10**6, "5b": 10**7}
    path_kernels = {"5": ("fused_fupdate", "inner_smo"),
                    "5b": ("inner_smo_multipair", "fused_fupdate_select")}
    launches = {}
    models = {}
    train_secs = {}
    for phase, sopts in full_opts.items():
        model = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=max_iter[phase]),
                          solver_opts=sopts, device="cuda")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.fit(X_all[:60000], Y_all[:60000])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        train_secs[phase] = train_s
        counts = {k: fn.launches for k, fn in counters.items()}
        for k in path_kernels[phase]:
            launches[k] = {phase: counts[k]}
        res = model.result_
        t = time.perf_counter()
        pred = model.predict(X_all[60000:])
        predict_s = time.perf_counter() - t
        acc = float((pred == Y_all[60000:]).mean())
        updates = model.n_iter_ - 1
        models[phase] = (model, acc)
        log(f"[{phase}] full width n=60000 d=784 {json.dumps(sopts)}: train "
            f"{train_s:.3f} s, status {model.status_.name}, outer rounds "
            f"{res.n_outer}, updates {updates} ({updates / train_s:.0f}/s), SV "
            f"count {model.n_support_}, b {model.b_:.15f}, accuracy {acc:.4f} on "
            f"10000, rescue rounds {res.n_rescue}, host syncs {res.n_host_syncs}, "
            f"predict {predict_s:.3f} s, launches {counts}")
        spans = {k: round(v * 1e3, 3) for k, v in model.fit_phases_.items()}
        log(f"[{phase}] fit phases, host ms: {json.dumps(spans)}; inside solve: "
            f"blocked at host syncs {res.host_wait_s * 1e3:.3f} ms, the rest (host "
            f"code and launches) "
            f"{(model.fit_phases_['solve'] - res.host_wait_s) * 1e3:.3f} ms")
        check(model.status_ == Status.CONVERGED, f"full {phase}: {model.status_.name}")
        check(all(counts[k] > 0 for k in path_kernels[phase]),
              f"full {phase}: kernels not launched: {counts}")
        check(np.isfinite(model.b_) and np.isfinite(model.sv_alpha_).all(),
              f"full {phase}: non-finite model")
        check(acc > 0.9, f"full {phase}: accuracy {acc}")
        if phase == "5":
            path = model5_path = str(_build.BUILD_DIR / "chip_smoke_model.npz")
            model.save(path)
            again = BinarySVC.load(path, device="cuda")
            check(np.array_equal(again.predict(X_all[60000:]), pred),
                  "reloaded model predicts differently")
            log(f"[5] saved and reloaded {path}: predictions equal")
            print(json.dumps({"bench": {
                "metric": "mnist60k_smo_train_time", "value": train_s, "unit": "s",
                "workload": {"generator": "mnist_like", "n": 70000, "d": 784,
                             "noise": 30.0, "label_noise": 0.005, "seed": 587,
                             "train_rows": "[:60000]", "test_rows": "[60000:]",
                             "note": "bench.py draws mnist_like(n=60000) and "
                                     "trains on all of it"},
                "solver": {"name": "blocked", "C": C, "gamma": GAMMA,
                           "eps": 1e-12, "tau": 1e-5, "max_iter": 10**6,
                           "max_outer": 5000, **sopts, "accum_dtype": "float64"},
                "train_s": train_s, "solve_s": model.fit_phases_["solve"],
                "updates": updates, "outer_rounds": res.n_outer,
                "n_sv": model.n_support_, "accuracy": acc,
                "status": model.status_.name,
                "provenance": {"torch": torch.__version__,
                               "cuda": torch.version.cuda,
                               "python": sys.version.split()[0],
                               "device": kind, "nvidia_smi": smi}}}), flush=True)
    (m5, acc5), (m5b, acc5b) = models["5"], models["5b"]
    log(f"[5b] against phase 5's model: accuracy {acc5b:.4f} vs {acc5:.4f}, SV-ID "
        f"symmetric difference {len(set(m5.sv_ids_) ^ set(m5b.sv_ids_))} of "
        f"{m5.n_support_}, |db| {abs(m5.b_ - m5b.b_):.3e}")
    check(abs(acc5b - acc5) <= 0.002, f"5b accuracy {acc5b} vs phase 5 {acc5}")

    clock("5, 5b")

    # ---- 6. where the time goes: each full-width fit again, profiled -----
    # (5b cut in depth to its first PROFILE_5B_ROUNDS rounds)
    for phase, sopts in full_opts.items():
        if phase == "5b":
            sopts = dict(sopts, max_outer=PROFILE_5B_ROUNDS)
        with warnings.catch_warnings():
            if phase == "5b":
                # the cut fit's own warning (its max_outer ends it as
                # MAX_ITER), and no other
                warnings.filterwarnings(
                    "ignore", r"SMO terminated with MAX_ITER ", RuntimeWarning)
            by_kernel, count, wall_ms = device_ms_by_kernel(
                lambda: BinarySVC(SVMConfig(C=C, gamma=GAMMA,
                                            max_iter=max_iter[phase]),
                                  solver_opts=sopts, device="cuda").fit(
                                      X_all[:60000], Y_all[:60000]))
        busy = sum(by_kernel.values())
        log(f"[6] profiled full-width fit of phase {phase} {json.dumps(sopts)}: "
            f"wall {wall_ms:.1f} ms, "
            f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%), idle "
            f"{100 * (1 - busy / wall_ms):.1f}%")
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {ms:9.3f} ms  {name[:100]}")
        # the f-update's own launches (csrc/rbf_tile.cuh): X_B's split, the
        # main loop, the sum of the partials
        fu = {k: v for k, v in by_kernel.items() if "rbf::" in k}
        log(f"[6] phase {phase} f-update: {sum(fu.values()):.1f} ms in all, "
            + ", ".join(f"{k.split('(')[0].split('::')[-1]} {v:.1f} ms in "
                        f"{count[k]} launches" for k, v in sorted(fu.items())))
        check(busy > 0, "profiler saw no device time")

    clock("6")

    # ---- 7, 8, 9. the pair solver, one-vs-rest, tasks and families -------
    from tpusvm_torch.data.synthetic import (BENCH_NOISE_MULTICLASS,
                                             mnist_like_multiclass, svr_sine)

    pair_model, pair_launches = phase_pair(
        X_all, Y_all, 60000, counters, m5, acc5, "cuda",
        k2_ms=pr_runs[("rbf", 2)]["ms"])
    launches["pair_rows"] = {"7": pair_launches}
    clock("7")
    Xm, lm = mnist_like_multiclass(n=70000, d=784, noise=BENCH_NOISE_MULTICLASS)
    ovr_model, ovr_a = phase_ovr(Xm, lm, 60000, N_OVR_PAIR, counters, "cuda",
                          k20_ms=pr_runs[("rbf", 20)]["ms"])
    clock("8")
    Xr, tr = svr_sine(n=24000, d=1, noise=0.05, seed=587)
    phase_tasks(X_all, Y_all, 60000, 10000, Xr, tr, 20000, N_SVR_PAIR, Xm[60000:],
                pair_model, ovr_model, "cuda", counters)
    clock("9")

    # ---- 10-13. the front door, refine, checkpoints, shrinking, cache ----
    phase_front(X_all, Y_all, 60000, N_CSV, N_CSV_LIMIT, N_ORACLE, N_CSV_TEST,
                "cuda", model5_path)
    clock("10")
    m11, gaps11 = phase_refine(X_all, Y_all, 60000, m5, acc5, "cuda", counters)
    clock("11")
    phase_checkpoint(X_all, Y_all, 60000, "cuda")
    clock("12")
    (m13a, acc13a), train13a_s = phase_shrink_cache(
        X_all, Y_all, 60000, acc5, m5, train_secs["5"], "cuda", counters)
    clock("13")

    # ---- 15, 16. the ring, the bf16 rungs, the fleet ----------------------
    phase_ring_and_rungs(X_all, Y_all, 60000, m5, acc5, train_secs["5"], m11,
                         gaps11, m13a, acc13a, train13a_s, "cuda", counters)
    clock("15")
    phase_fleet(Xm, lm, 60000, ovr_a, "cuda", counters, launches)
    clock("16")

    # ---- 14. the cascade: tree and star, blocked and pair leaves ---------
    phase_cascade(X_all, Y_all, 60000, m5, acc5, "cuda", counters, launches,
                  _build.BUILD_DIR / "chip_smoke_cascade", clock)

    for k in kernels:
        k["launches_by_phase"] = launches[k["name"]]
        k["launches"] = sum(launches[k["name"]].values())
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
