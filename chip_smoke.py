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
     solo launches and B times the solo bound; #2's problem-axis launch
     with boxed lanes (every other lane a seeded one: float64 seeds, some
     within a float32 ulp of C) against its plain version and solo
     launches, bit for bit; the fleet round's K_BB by the per-lane solo
     call beside one torch.bmm (time, bits);
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
  6. where the time goes: the fits of phases 5 and 5b (5b's first 250
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
  10. the front door at full width: phase 5's rows [:60000] and [60000:]
     as CSVs (written by a background process from the end of phase 5,
     with phase 8's ten-class rows for 20(b)), read by the native reader
     (seconds, MB/s; phase 5's rows back; the Python reader's bits on the
     first 10,000); `python -m tpusvm_torch train --train ... --test ...`
     in a subprocess prints the SV count, b and accuracy of an in-process
     fit on the rows it read, which equals phase 5 bit for bit, and so
     does the entry point's main in this process with --n-limit 5000;
     --mode oracle on 2,000 rows (the O(n^2) oracle, cut) within the
     cross-engine band of the blocked fit on them; `info` names the card
     and describes phase 5's artifact;
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
     rows share the card (started after (a), beside (b) and (c)), and rank
     0 prints (a)'s SV count, b, accuracy and
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
  17. the out-of-core tier on phase 5's rows: (a) the training rows
     ingested at 16,384 rows a shard (four shards) and the held-out rows,
     every shard validating OK, the manifest scaler equal to phase 5's
     bits, the ingest, validation and read rates in MB/s; (b) fit_stream
     equal to phase 5 bit for bit (SV IDs, alphas, b, rounds, updates),
     kernels #1 and #2 launched; (c) evaluate_stream's accuracy equal to
     phase 5's, predict_stream's scores within 1e-5 x sum(alpha) of its
     decision_function; (d) fit_cascade_stream with 14(b)'s star and
     blocked leaves equal to 14(b) bit for bit; (e) `ingest`, `train
     --data` and `predict --data` as subprocesses on phase 10's full-width
     CSVs, printing the in-process fit's bits;
  18. the approximate families on phase 5's job: (a) kernel="rff" at
     rff_dim 2048 and (b) kernel="nystrom" at 1,024 landmarks, each the
     blocked solver over the mapped rows on the card (#2 launched, #1 not:
     the linear path); (c) the streamed rff primal fit from 17(a)'s shards
     (batch 256, at most 64 epochs, tol 0.05), live shards <= 3 and at most
     one synchronizing call an epoch plus one outside the reader's thread
     (the reader's printed); each CONVERGED, within 0.055
     of phase 5's accuracy (benchmarks/approx_scale.py's gates), its
     artifact reloaded with the same scores; the rff probe error
     non-increasing over D = 512, 1024, 2048 (5% slack); train seconds and
     the map's share printed.
  19. the pod on 17(a)'s shards with 14(b)'s job (star, P=4, blocked
     leaves): (a) BinarySVC.fit_pod equal to 17(d) bit for bit (SV IDs,
     alphas, SV rows, b, rounds), every row in a worker, live shards <= 3
     per worker, no revive, kernels #1 and #2 launched in every worker
     process (counts read from the workers) and in the coordinator's
     layer-2 solves; fit, start-up and per-round seconds printed; (b)
     pod_fit with worker 1 SIGKILLed at its 2nd request: one revive,
     (a)'s bits; (c) `python -m tpusvm_torch.faults pod-chaos-smoke` and
     `kill-resume-smoke` and `python -m tpusvm_torch pod --smoke` as
     subprocesses on the card, started together at phase 18's start,
     before (a), each exiting 0
     with its ok line.
  20. the class axis and the front door: (a) OneVsRestSVC(solver="pair",
     class_parallel=True) on 8(b)'s job over the default mesh and over
     three members on the one card (12 heads with the padding), every head
     equal to 8(b)'s bit for bit, pair_rows launched; (b) two rank
     processes of `train --multiclass --class-parallel --distributed` on
     8(b)'s rows from a CSV, both saved models equal to (a)'s array by
     array; (c) phase 5's and 8(a)'s decision_function split over three
     members (predictions equal, scores within 1e-5 x sum|coef|) and
     `predict --mesh-predict`; (d) phase 5's job on rows [:5000] at
     float64 and bfloat16 (CONVERGED, no kernel launched, accuracy within
     0.002 of float32's) and the float64 pair solver on 2,000 rows (no
     pair_rows); (e) `predict --scores/--proba` on phase 9's Platt model,
     equal to the in-process values to the printed digits, and `train
     --smoke` in its three cells, subprocesses started together beside
     (d);
  21. tuning on phase 5's training rows: a halving search with one fleet
     a fold and rung (a 3 x 3 log grid around phase 5's C and gamma, 3
     folds, eta 3, rungs from 4,096 rows, phase 5's q, wss and max_inner),
     every fit ending CONVERGED or NO_WORKING_SET, the winner's CV accuracy
     within 0.005 of phase 5's, the problem-axis #1 and #2 launched, one
     lane of the last rung re-fit alone equal to it bit for bit, the
     results JSON described by `info`; `tune --smoke` as a subprocess;
  22. serving and refresh (tpusvm_torch.serve): (a) phase 5's artifact,
     8(a)'s ten-head model and 18(a)'s rff model served in-process with
     max_batch 64, one CUDA graph captured a bucket (count, seconds), at
     every bucket the replay, the program run eagerly on the worker's
     stream and on the default stream, and decision_function bit for bit;
     eight client threads send the 10,000 held-out rows one row a request,
     every score (and label) bit-equal to decision_function, 0 recompiles,
     QPS, p50/p99, batch occupancy and sequential_qps printed; (b) `serve
     --port 0 --state` as a subprocess: 1,000 held-out rows in POSTs of
     1-64 rows bit-equal to (a), /healthz, /metrics, /metrics.json and the
     state's address; (c) eight hot-swaps between phase 5's and phase 11's
     artifacts under four clients: every response one generation's bits,
     none lost, device memory flat (printed after the first and the last
     swap); (d) the refresh of phase 5's artifact on rows [:65000], warm
     and cold, CONVERGED, warm in fewer updates, #1 and #2 launched,
     accuracy on [65000:] within 0.002 of phase 5's, then `refresh --swap
     URL` into (b)'s server, whose scores are then the refreshed
     artifact's; (e) `serve --smoke`, `refresh --smoke` and
     `swap-chaos-smoke` as subprocesses beside (d).
  23. the closed loop (tpusvm_torch.autopilot, tpusvm_torch.tenants): (a)
     phase 5's artifact served in-process while the autopilot watches a
     fresh dataset of phase 5's training rows grown by five appends of
     1,000 held-out rows, one a tick: two chained warm refreshes swap in
     (the second killed at a solver checkpoint and resumed by a rebuilt
     supervisor), each bit-equal to a direct refresh_fit of its donor,
     CONVERGED, with #1 and #2's boxed subproblem launched, the grown
     dataset a one-shot ingest's, every one-row response of 8 clients a
     complete generation's bits; (b) 32 tenants over phase 8's rows (C in
     {2.5, 10, 40}) provisioned in one cold fleet launch and served, then
     the coalesced warm refresh twice (a control, and an arm killed at its
     second fleet checkpoint and resumed), rolled out under 8 clients:
     every tenant bit-equal to the control, view fingerprints equal,
     checkpoints reaped, memory flat, 1b and 2b launched (2b with boxed
     lanes), at most RESCUE_SHARE_MAX of the warm lane-rounds redone on
     the loop engine; (c) `autopilot-chaos-smoke` and
     `tenant-chaos-smoke` as subprocesses beside them.
  24. the router (tpusvm_torch.router): three `python -m tpusvm_torch
     serve --port P --state --trace` replica processes on the card (P a
     free port below the kernel's ephemeral range), each
     hosting phase 5's artifact, behind an in-process Router (replication
     2) and its HTTP front: (a) 8 one-row clients on the held-out rows
     through the router while the placed replica is SIGKILLed and revived
     on its recorded port with its replica id: no response lost, every
     score one generation's decision_function bits on the card,
     failovers > 0; then straight to the placed replica and through the
     router (requests/s, p50/p99: the router's hop); (b) generation 2,
     a warm refresh of phase 5's artifact on rows [:62000] (#1 and #2
     launched), rolled out staggered under that load: each replica swapped
     once, a uniform skew-free final vector; (c) every routed
     serve.request span resolves to a router.forward span of the router's
     trace, torn last lines counted; (d) `fleet-metrics --router URL
     --format json` equals merge_fleet of the payloads scraped directly,
     `top --once` prints a row a process; the replicas' device MiB; (e)
     `router-chaos-smoke` as a subprocess beside (a) and (b).
  25. observability, over runs that exist: (a) phase 10's subprocess
     `train` also writes --trace, --jsonl and a 128-slot convergence ring
     (its printed SV count, b and accuracy still phase 5's bits): `report
     --smoke` on the trace exits 0 here, its phase names are the
     subprocess's timing block, its last convergence.round ends
     CONVERGED, kernels #1 and #2 launched in that process (the trace's
     snapshot; the kernels line counts them as phase 25's); (b) phase
     10's in-process --n-limit run also takes --profile DIR, whose
     torch.profiler trace names #1 and #2's launches; (c) phase 5's job
     once more with the fit's tracer and the compile observatory on:
     alpha, b and updates equal phase 5's, the train seconds beside phase
     5's as an overhead fraction (printed with the JAX telemetry_overhead
     band of 0.02, not gated); (d) 19(a) traced into a directory, one file
     a process: `report --smoke DIR` exits 0, no cross-process parent is
     unresolved, 19's bits unchanged (and 19(c)'s pod-chaos-smoke runs its
     traced arm); (e) phase 2's builds and 22(a)'s graph captures under the
     observatory: one prof.compile record a library built, with its nvcc
     seconds, and one a (model, bucket) graph, as many as 22(a) captured;
     (f) phase 5's {"bench": ...} record as a JSONL: benchdiff of it
     against itself exits 0, a copy with the train seconds doubled fails at
     --level full and passes at --level smoke.
  (Phases 15 and 16 run after 13, before 14; 17 and 18 after 14; then
  19, 20, 21, 22, 23 and 24. Phase 25 runs inside 2, 10, 19 and 22, and
  its (c) and (f) right after 5b.)
Then one JSON line of kernel figures, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is present or the package is not beside this script.
"""

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

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
# after this many of its 2,183 rounds (500 until phase 23, 250 until phase
# 25 came in under the same time limit)
PROFILE_5B_ROUNDS = 125
# phase 10's --n-limit run and its --mode oracle run, cut in rows (PERF.md
# section 4: the serial NumPy oracle is O(n^2) by design); the native
# reader is held to the Python reader on the first N_CSV_PY rows
N_CSV_LIMIT, N_ORACLE, N_CSV_PY = 5000, 2000, 10000
# phase 20(d)'s cut in rows (PERF.md section 4): the eager torch engine
# that float64 and bfloat16 features run (10,000 rows until the closed
# loop's phase 23 came in beside it under the same time limit)
N_DTYPE_CUT = 5000


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
    if device == "cpu" and args[0] not in ("info", "ingest"):
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

    if device == "cpu" and args[0] not in ("info", "report", "benchdiff"):
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


def phase_front(X_all, Y_all, n_tr, n_lim, n_oracle, csvs, writers, m5,
                device, model_path, launches=None, trace_dir=None):
    """Phase 10, at full width: phase 5's rows [:n_tr] and [n_tr:] as
    CSVs (written in the background since phase 5), read by the native
    reader (seconds and MB/s), which must give phase 5's rows back and
    equal the Python reader bit for bit on the first N_CSV_PY rows; then
    `python -m tpusvm_torch train --train ... --test ...` in a subprocess,
    which must print the SV count, b and accuracy of an in-process
    BinarySVC fit on the rows it read (the same program, so the same
    bits), that fit equal to phase 5 bit for bit; then, through the same
    entry point's main in this process, again with --n-limit n_lim;
    --mode oracle on n_oracle rows, within the cross-engine band of the
    blocked fit on those rows (SV-ID symmetric difference <= 2, |db| <=
    2.5e-4: PARITY.md); `info`, which must name the card, and `info` on
    phase 5's artifact. Returns (train CSV, held-out CSV, the in-process
    fit, n_tr) for phase 17(e).

    With trace_dir (phase 25): the subprocess run is also traced (--trace,
    --jsonl, --convergence 128: 25(a), checked by phase_trace_front) and
    the in-process --n-limit run profiled (--profile: 25(b)); neither
    changes a printed bit."""
    import os

    import torch
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data import read_csv
    from tpusvm_torch.data.native_io import build_library, read_csv_fast
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.ops.cuda import _build
    from tpusvm_torch.status import Status

    train_csv, test_csv = csvs["train"], csvs["test"]
    wait_s = wait_for(train_csv, writers) + wait_for(test_csv, writers)
    t = time.perf_counter()
    build_library()
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    X, Y = read_csv_fast(train_csv)
    Xt, Yt = read_csv_fast(test_csv)
    read_s = time.perf_counter() - t
    mb = (os.path.getsize(train_csv) + os.path.getsize(test_csv)) / 1e6
    check(np.array_equal(X, X_all[:n_tr]) and np.array_equal(Y, Y_all[:n_tr])
          and np.array_equal(Xt, X_all[n_tr:])
          and np.array_equal(Yt, Y_all[n_tr:]),
          "[10] the CSVs do not read back to the rows written")
    t = time.perf_counter()
    Xp, Yp = read_csv(train_csv, n_limit=N_CSV_PY)
    py_s = time.perf_counter() - t
    t = time.perf_counter()
    Xn, Yn = read_csv_fast(train_csv, n_limit=N_CSV_PY)
    nat_s = time.perf_counter() - t
    same_py = Xp.tobytes() == Xn.tobytes() and Yp.tobytes() == Yn.tobytes()
    log(f"[10] CSVs of {len(Y)} + {len(Yt)} rows x {X.shape[1]} ({mb:.0f} MB; "
        f"waited {wait_s:.1f} s for the writers): native reader "
        f"{read_s:.2f} s ({mb / read_s:.0f} MB/s; its library built in "
        f"{build_s:.2f} s); on the first {N_CSV_PY} rows the native reader "
        f"{nat_s:.3f} s, the Python reader {py_s:.2f} s, bit-equal {same_py}")
    check(same_py, "[10] the native reader differs from the Python reader")
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
    fits = {}
    traced = {n_tr: [], n_lim: []}
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        paths25 = {k: str(trace_dir / v) for k, v in (
            ("trace", "train10.jsonl"), ("jsonl", "train10_events.jsonl"),
            ("profile", "profile10"))}
        for p in (paths25["trace"], paths25["jsonl"]):
            if os.path.exists(p):
                os.unlink(p)
        traced = {n_tr: ["--trace", paths25["trace"], "--jsonl",
                         paths25["jsonl"], "--convergence", "128"],
                  n_lim: ["--profile", paths25["profile"]]}
    outs = {}
    for n, extra, run in ((n_tr, [], _cli),
                          (n_lim, ["--n-limit", str(n_lim)], _cli_in_process)):
        out, secs = run(["train", "--train", train_csv, "--test", test_csv,
                         *flags, *extra, *traced[n]], device)
        outs[n] = out
        cli = (_line(r"SV count = (\d+)", out), _line(r"b = (-?[\d.]+)", out),
               _line(r"accuracy = ([\d.]+)", out))
        m, acc = fits[n] = in_process(n)
        where = "a subprocess" if run is _cli else "this process"
        log(f"[10] train --train CSV {' '.join(extra)}: {secs:.1f} s in "
            f"{where} (data {_line(r'data time: ([\d.]+) s', out)} s, "
            f"training {_line(r'training time: ([\d.]+) s', out)} s), n = "
            f"{_line(r'n = (\d+),', out)}, status "
            f"{_line(r'status = (\w+)', out)}, SV count / b / accuracy "
            f"{cli}; in process {_report(m, acc)}")
        check(_line(r"status = (\w+)", out) == "CONVERGED",
              f"[10] CLI status {out[-500:]}")
        check(m.status_ == Status.CONVERGED, f"[10] {m.status_.name}")
        check(cli == _report(m, acc), f"[10] CLI {cli} vs in process "
              f"{_report(m, acc)}")
    if trace_dir is not None:
        phase_trace_front(outs[n_tr], paths25, launches, device)
    m10 = fits[n_tr][0]
    same5 = _same_bits(m10, m5) and m10.n_iter_ == m5.n_iter_
    log(f"[10] the in-process fit on the CSV's rows equals phase 5 bit for "
        f"bit (SV IDs, alphas, SV rows, b, updates): {same5}")
    check(same5, "[10] the fit on the CSV's rows differs from phase 5")
    d = _build.BUILD_DIR / "chip_smoke_csv"
    d.mkdir(parents=True, exist_ok=True)
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
    return train_csv, test_csv, m10, n_tr

# ---- phase 25: observability over runs that exist ----------------------
# 25(c)'s printed band: the JAX benchmark's telemetry_overhead rule
# (tpusvm/obs/benchdiff.py: overhead_frac <= old + 0.02)
TRACER_OVERHEAD_BAND = 0.02


def phase_build_records(records, secs):
    """25(e), phase 2's half: one prof.compile record a library nvcc built,
    its compile_s that library's nvcc seconds, its cost unknown."""
    built = sorted(k for k, v in secs.items() if v > 0)
    recs = {r["executable"]: r for r in records}
    log(f"[25e] phase 2 under the compile observatory: {len(records)} "
        f"records for {len(built)} libraries built: "
        + ", ".join(f"{k} {r['compile_s']:.2f} s" for k, r in recs.items()))
    check(len(records) == len(built)
          and sorted(recs) == [f"nvcc:{k}" for k in built],
          f"[25e] build records {sorted(recs)} vs built {built}")
    for k in built:
        r = recs[f"nvcc:{k}"]
        check(r["compile_s"] == secs[k] and r["cost_available"] is False
              and r["flops"] is None, f"[25e] record of {k}: {r}")


def phase_tracer_cost(X_all, Y_all, n_tr, m5, train5_s, opts, counters,
                      trace_dir, smi, device="cuda"):
    """25(c): phase 5's job once more in this process with the fit's tracer
    and the compile observatory on: alpha, b and updates equal phase 5's;
    the train seconds printed beside phase 5's as an overhead fraction,
    with the JAX telemetry_overhead band beside it (printed, not gated)."""
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.obs import prof, read_trace
    from tpusvm_torch.obs.trace import Tracer

    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / "fit25c.jsonl"
    if path.exists():
        path.unlink()
    model = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                      solver_opts=opts, device=device)
    _zero(counters)
    with Tracer(str(path), argv=["chip_smoke 25c"]) as tracer, \
            prof.profiling(event_sink=tracer.event):
        sync(device)
        t = time.perf_counter()
        with tracer.span("training", phase=True):
            model.fit(X_all[:n_tr], Y_all[:n_tr], tracer=tracer)
        sync(device)
        train_s = time.perf_counter() - t
    counts = _count(counters)
    same = (_same_bits(model, m5) and model.n_iter_ == m5.n_iter_
            and model.result_.alpha.cpu().numpy().tobytes()
            == m5.result_.alpha.cpu().numpy().tobytes())
    recs = read_trace(str(path))
    spans = [r["name"] for r in recs if r["kind"] == "span"]
    frac = train_s / train5_s - 1.0
    log(f"[25c] phase 5's job with the fit's tracer and the observatory on: "
        f"train {train_s:.3f} s against phase 5's {train5_s:.3f} s, overhead "
        f"fraction {frac:+.4f} (the JAX telemetry_overhead band: "
        f"{TRACER_OVERHEAD_BAND}; printed, not gated); {len(recs)} trace "
        f"records, spans {spans}; alpha, b and updates equal phase 5's: "
        f"{same}; #1/#2 launches {counts['fused_fupdate']}/"
        f"{counts['inner_smo']} ({smi})")
    check(same, "[25c] the traced fit differs from phase 5")
    check(spans == [f"fit.{p}" for p in model.fit_phases_] + ["training"],
          f"[25c] spans {spans}")


def phase_benchdiff(bench5, out_dir):
    """25(f): phase 5's {"bench": ...} record as a JSONL artifact; benchdiff
    of it against itself exits 0, and a copy with the train seconds doubled
    fails at --level full and passes at --level smoke."""
    import contextlib
    import io

    from tpusvm_torch.cli import main as cli_main

    out_dir.mkdir(parents=True, exist_ok=True)
    base, slow = str(out_dir / "bench5.jsonl"), str(out_dir / "slow5.jsonl")
    doubled = dict(bench5, value=2 * bench5["value"],
                   train_s=2 * bench5["train_s"])
    for path, rec in ((base, bench5), (slow, doubled)):
        with open(path, "w") as f:
            f.write(json.dumps(rec) + "\n")
    rcs = {}
    for label, argv in (("self", [base, base]),
                        ("doubled full", [base, slow]),
                        ("doubled smoke", [base, slow, "--level", "smoke"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs[label] = cli_main(["benchdiff", *argv])
        verdict = [x for x in buf.getvalue().splitlines()
                   if x.startswith("verdict:")]
        log(f"[25f] benchdiff {label}: exit {rcs[label]}, {verdict}")
    check(rcs == {"self": 0, "doubled full": 1, "doubled smoke": 0},
          f"[25f] benchdiff exit codes {rcs}")


def phase_trace_front(out, paths, launches, device):
    """25(a) and (b), on phase 10's runs: the subprocess's trace passes
    `report --smoke` here, its phase names are the subprocess's timing
    block, its last convergence.round ends CONVERGED, kernels #1 and #2
    launched in that process (its snapshot's kernel.launches gauges, which
    the kernels line counts as phase 25's), its --jsonl records are the
    run's; the in-process run's profile names #1 and #2's launches."""
    import os
    import re

    from tpusvm_torch.obs import read_trace
    from tpusvm_torch.obs.report import (convergence_rows, nonzero_counters,
                                         phase_summary)

    rep, secs = _cli_in_process(["report", "--smoke", paths["trace"]],
                                device)
    recs = read_trace(paths["trace"])
    phases = list(phase_summary(recs)[0])
    block = re.findall(r"^(.+) time: [\d.]+ s$", out, re.M)
    block = [b for b in block if b != "elapsed"]
    conv = convergence_rows(recs)
    snap = [r for r in recs if r["kind"] == "event"
            and r["name"] == "metrics.snapshot"][-1]["attrs"]["snapshot"]
    counts = {e["labels"]["kernel"]: int(e["value"])
              for e in snap["metrics"] if e["name"] == "kernel.launches"}
    with open(paths["jsonl"]) as f:
        events = [json.loads(x) for x in f]
    log(f"[25a] phase 10's subprocess traced: {len(recs)} records, report "
        f"--smoke {secs:.2f} s: {rep.strip().splitlines()[-1]!r}; phases "
        f"{phases} (its timing block {block}); {len(conv)} convergence "
        f"rounds, the last {conv[-1]['status'] if conv else None}; kernel "
        f"launches {counts}; counters "
        f"{[c for c in nonzero_counters(recs) if 'kernel' in c]}; --jsonl "
        f"events {[e['event'] for e in events]}")
    check(phases == block, f"[25a] phases {phases} vs block {block}")
    check(conv and conv[-1]["status"] == "CONVERGED",
          f"[25a] last round {conv[-1] if conv else None}")
    check(counts.get("fused_fupdate", 0) > 0 and counts.get("inner_smo", 0)
          > 0, f"[25a] #1/#2 not launched in the subprocess: {counts}")
    check([e["event"] for e in events] == ["data", "train", "eval",
                                           "timing"], f"[25a] {events}")
    check(f"{events[1]['b']:.15f}" == _line(r"b = (-?[\d.]+)", out),
          "[25a] the --jsonl train record's b is not the printed b")
    for k in ("fused_fupdate", "inner_smo"):
        launches.setdefault(k, {})["25"] = counts[k]
    path = os.path.join(paths["profile"], "trace.json")
    with open(path) as f:
        prof = json.load(f)
    names = collections.Counter(
        e.get("name", "") for e in prof.get("traceEvents", [])
        if e.get("cat") == "kernel")
    k1 = sum(v for k, v in names.items() if "rbf_cross_matvec_kernel" in k)
    k2 = sum(v for k, v in names.items() if "inner_smo_kernel" in k)
    log(f"[25b] the in-process --n-limit run's --profile: {path} "
        f"({os.path.getsize(path) / 1e6:.1f} MB), {sum(names.values())} "
        f"kernel events, rbf_cross_matvec_kernel {k1}, inner_smo_kernel {k2}")
    check(k1 > 0 and k2 > 0, f"[25b] the profile names no #1/#2: {k1}/{k2}")



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


def phase_checkpoint(X_all, Y_all, n_tr, device, stop_round=8, every=4):
    """Phase 12: phase 5's job through BinarySVC.fit(checkpoint_path,
    checkpoint_every), killed by a fault plan (a simulated kill at the
    `solver.outer_checkpoint` point, faults/) at the write after round
    `stop_round`'s, so round `stop_round`'s checkpoint is on disk, then
    resumed in a fresh estimator: it must equal the run
    without a checkpoint bit for bit (alpha with torch.equal, the same b,
    n_iter and status). At the solver: a state paused at `stop_round`,
    written, read back and resumed gives alpha and f equal (torch.equal)
    to the uninterrupted solve's; the write is timed."""
    import os

    import torch
    import tpusvm_torch.solver.checkpoint as ckmod
    from tpusvm_torch import faults
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
    plan = faults.FaultPlan([faults.FaultRule(
        point="solver.outer_checkpoint", kind="kill",
        at_hit=stop_round // every + 1)])
    try:
        with faults.active(plan):
            BinarySVC(cfg, solver_opts=FULL_OPTS, device=device).fit(
                X, Y, checkpoint_path=path, checkpoint_every=every)
        check(False, "[12] the fit was not stopped")
    except faults.SimulatedKill:
        pass
    check(os.path.exists(path), "[12] no checkpoint on disk")
    with np.load(path) as z:
        stopped_at = int(z["n_outer"])
    check(stopped_at == stop_round, f"[12] checkpoint of round {stopped_at}")
    t = time.perf_counter()
    resumed = BinarySVC(cfg, solver_opts=FULL_OPTS, device=device).fit(
        X, Y, checkpoint_path=path, checkpoint_every=every, resume=True)
    resume_s = time.perf_counter() - t
    a, b = resumed.result_, plain.result_
    same = (torch.equal(a.alpha, b.alpha) and (a.b, a.n_iter, a.status)
            == (b.b, b.n_iter, b.status))
    log(f"[12] fit killed at the checkpoint write after round {stopped_at}'s "
        f"(every {every}; a fault plan's kill rule), resumed in a fresh estimator in {resume_s:.3f} s: rounds "
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
# round from round 5, each warm leaf about 17,700 iterations); 5,000 rows
# since phase 25 came in under the same time limit (10,000 before)
N_CASCADE_PAIR = 5000
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


def start_csv_writers(n, n_tr, d, out_dir):
    """Writes, in two background processes (the CSV writer is a Python
    loop: about 20 s for 70,000 rows of 784), phase 5's rows
    (mnist_like(n, d), seed 587, as phase 3 draws them) [:n_tr] and [n_tr:]
    for phases 10, 14(d) and 17(e), and phase 8's ten-class rows
    (mnist_like_multiclass(n, d), its noise) [:n_tr] for 20(b). Each file
    is written under a temporary name and renamed when complete. Returns
    {"train", "test", "ovr": path} and the two processes."""
    import os
    from pathlib import Path

    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {k: str(out_dir / f"{k}.csv") for k in ("train", "test", "ovr")}
    for p in paths.values():
        if os.path.exists(p):
            os.unlink(p)
    code = ("import os, sys; from tpusvm_torch.data import write_csv; "
            "from tpusvm_torch.data.synthetic import mnist_like, "
            "mnist_like_multiclass, BENCH_NOISE_MULTICLASS; "
            "n, n_tr, d = map(int, sys.argv[1:4]); "
            "kind, *out = sys.argv[4:]; "
            "X, Y = (mnist_like(n=n, d=d, noise=30.0, label_noise=0.005, "
            "seed=587) if kind == 'binary' else mnist_like_multiclass("
            "n=n, d=d, noise=BENCH_NOISE_MULTICLASS)); "
            "parts = [(X[:n_tr], Y[:n_tr]), (X[n_tr:], Y[n_tr:])]; "
            "[(write_csv(o + '.tmp', *xy), os.replace(o + '.tmp', o)) "
            "for o, xy in zip(out, parts)]")
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(n), str(n_tr), str(d), kind, *out],
        cwd=root, env=env)
        for kind, out in (("binary", [paths["train"], paths["test"]]),
                          ("multiclass", [paths["ovr"]]))]
    return paths, procs


def wait_for(path, procs, deadline_s=600):
    """Wait until a writer's file is complete (renamed into place); fail if
    a writer failed or the deadline passes."""
    import os

    t = time.perf_counter()
    while not os.path.exists(path):
        check(all(p.poll() in (None, 0) for p in procs),
              f"a CSV writer failed: {[p.poll() for p in procs]}")
        check(time.perf_counter() - t < deadline_s,
              f"{path} not written within {deadline_s} s")
        time.sleep(0.5)
    return time.perf_counter() - t


def start_cascade_ranks(train_csv, test_csv, out_dir, device):
    """Phase 14(d)'s four rank processes of `python -m tpusvm_torch train
    --mode cascade --shards 4 --topology tree --distributed ...` on the CSVs
    of phase 5's rows, started in the background (they share the card with
    14(b) and (c)): (processes, artifact paths, start time)."""
    import atexit
    import os
    import socket
    from pathlib import Path

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
    # a failed phase before their end must not leave them running
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs, paths, t


def phase_cascade_ranks(started, model_a, acc_a, train_a_s, out_dir, device,
                        deadline_s=600):
    """Phase 14(d), the end: each rank process (start_cascade_ranks) is
    waited on with a deadline (all killed on expiry) and must exit 0. Rank
    0 must print 14(a)'s SV count, accuracy, b to every printed digit and
    rounds, and write the only artifact, which `info` describes with
    14(a)'s cascade line."""
    procs, paths, t = started
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
    log(f"[14d] {CASCADE_P} rank processes on one card (started after 14(a), "
        f"beside 14(b) and (c)): {wall_s:.1f} s wall; "
        f"rank 0: data "
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
                  csvs, out_dir, clock):
    """Phase 14: the one-process fits of CASCADE_CASES (cascade_case; a case
    cut in rows is held to the direct blocked fit on its rows), kernel #1 at
    the leaf's size after 14(a), and 14(d)'s rank processes on phase 10's
    CSVs, started after 14(a) and finished after 14(c). Adds each case's launches to `launches`; returns the one-process
    fits by tag (cascade_case's tuples)."""
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC

    out_dir.mkdir(parents=True, exist_ok=True)
    Xt, Yt = X_all[n_tr:], Y_all[n_tr:]
    fits = {}
    ranks = None
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
            # 14(d)'s ranks run beside 14(b) and (c): their starts (an
            # interpreter and a CUDA context each) overlap those fits
            ranks = start_cascade_ranks(csvs["train"], csvs["test"], out_dir,
                                        device)
        clock(tag)
    model_a, acc_a, train_a_s = fits["14a"][:3]
    phase_cascade_ranks(ranks, model_a, acc_a, train_a_s, out_dir, device)
    clock("14d")
    return fits


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

    # the boxed subproblem of seeded lanes (every other lane): float64
    # seeds off the float32 grid, a fifth of them within a float32 ulp of
    # C, as a warm refresh's are
    from tpusvm_torch.ops.cuda.inner_smo import boxed_operands
    g = torch.Generator(device=dev).manual_seed(23)
    C_l = torch.tensor(Cs, dtype=torch.float64, device=dev)[:, None]
    u = torch.rand(a.shape, generator=g, device=dev, dtype=torch.float64)
    a64 = torch.where(u < 0.2, C_l - 1e-7 * u, a.double() * (1 - 1e-9 * u))
    pull = torch.arange(FLEET_B, device=dev) % 2 == 0
    d0, f_c, lo, hi = boxed_operands(a64, f.double(), C_l, q // 2)
    a_bx = torch.where(pull[:, None], d0.double(), a64)
    f_bx = torch.where(pull[:, None], f_c.double(), f.double())
    box = (lo, hi, pull)

    def boxed2():
        return inner_smo_batched_kernel(K, y, a_bx, f_bx, act, Cs_t, 1e-12,
                                        1e-5, box=box, **kw)

    a_bo, st_bo = boxed2()
    t = time.perf_counter()
    a_br, st_br = inner_smo_batched_ref(K, y, a_bx, f_bx, act, Cs, 1e-12,
                                        1e-5, box=box, **kw)
    torch.cuda.synchronize()
    pb_ms = (time.perf_counter() - t) * 1e3
    same_bx = torch.equal(a_bo, a_br) and torch.equal(st_bo, st_br)
    solo_bx = [torch.equal(a_bo[b], inner_smo_kernel(
        K[b], y[b], a_bx[b], f_bx[b], act[b], Cs[b], 1e-12, 1e-5,
        box=(lo[b], hi[b]) if bool(pull[b]) else None, **kw)[0])
        for b in lanes]
    kb_ms = cuda_ms(boxed2)
    log(f"[3] inner_smo problem axis with boxed lanes (every other lane "
        f"seeded): kernel {kb_ms:.3f} ms, plain {pb_ms:.1f} ms (one run); "
        f"bit-equal to the plain version {same_bx}, every lane to its solo "
        f"launch {all(solo_bx)}; updates {st_bo[:, 0].tolist()}")
    check(same_bx, "inner_smo boxed lanes differ from the plain version")
    check(all(solo_bx), f"inner_smo boxed lanes differ from solo launches "
          f"{solo_bx}")
    err2 = max(err2, float((a_bo - a_br).abs().max()))

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
        "boxed_ms": kb_ms, "boxed_plain_ms": pb_ms,
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


# phase 17's shards: phase 5's training rows at 16,384 rows a shard (four
# shards, the last one 10,848 rows) and its 10,000 held-out rows in one
STREAM_ROWS_PER_SHARD = 16384
# phase 17(e)'s shards of phase 10's 10,000-row CSV
CSV_ROWS_PER_SHARD = 4096


def _count(counters):
    return {k: fn.launches for k, fn in counters.items()}


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "boxed_launches"):
            fn.boxed_launches = 0


def _same_bits(a, b):
    """The fitted models' SV IDs, alpha bits, SV rows and b are equal."""
    return (np.array_equal(a.sv_ids_, b.sv_ids_)
            and a.sv_alpha_.tobytes() == b.sv_alpha_.tobytes()
            and np.asarray(a.sv_X_).tobytes() == np.asarray(b.sv_X_).tobytes()
            and a.b_ == b.b_)


def phase_stream(X_all, Y_all, n_tr, m5, acc5, m14b, csv10, device,
                 counters, launches, smi, out_dir):
    """Phase 17, the out-of-core tier on phase 5's rows: (a) ingest the
    training rows at STREAM_ROWS_PER_SHARD a shard and the held-out rows,
    every shard validating OK and the manifest scaler equal to phase 5's
    bits, the ingest, validation and read rates logged; (b) fit_stream of
    phase 5's job equal to phase 5 bit for bit (SV IDs, alphas, b, rounds,
    updates), kernels #1 and #2 counted; (c) evaluate_stream's accuracy
    equal to phase 5's, predict_stream's scores within 1e-5 x sum(alpha)
    of phase 5's decision_function (the contraction's blocking: batches of
    4,096 rows against one call); (d) fit_cascade_stream with 14(b)'s star
    and blocked leaves equal to 14(b) bit for bit; (e) `ingest`, `train
    --data` and `predict --data` as subprocesses on phase 10's full-width
    CSVs, which print the in-process fit's bits (phase 5's). Returns the
    training dataset and (d)'s model."""
    import shutil

    from tpusvm_torch.config import CascadeConfig, SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.status import Status, StreamStatus
    from tpusvm_torch.stream import (ShardReader, evaluate_stream,
                                     ingest_arrays, open_dataset,
                                     predict_stream)

    shutil.rmtree(out_dir, ignore_errors=True)
    train_dir, test_dir = str(out_dir / "train"), str(out_dir / "test")
    X, Y = X_all[:n_tr], Y_all[:n_tr]
    Xt, Yt = X_all[n_tr:], Y_all[n_tr:]
    mb = (X.astype(np.float64).nbytes + 4 * len(Y)) / 1e6
    t = time.perf_counter()
    man = ingest_arrays(train_dir, X, Y, rows_per_shard=STREAM_ROWS_PER_SHARD)
    ingest_s = time.perf_counter() - t
    ingest_arrays(test_dir, Xt, Yt, rows_per_shard=STREAM_ROWS_PER_SHARD)
    ds, ds_test = open_dataset(train_dir), open_dataset(test_dir)
    t = time.perf_counter()
    statuses = ds.validate() + ds_test.validate()
    validate_s = time.perf_counter() - t
    t = time.perf_counter()
    rows = sum(len(b[0]) for b in ShardReader(ds, scaler=ds.scaler()))
    read_s = time.perf_counter() - t
    sc = ds.scaler()
    same_scaler = (sc.min_val.tobytes() == m5.scaler_.min_val.tobytes()
                   and sc.max_val.tobytes() == m5.scaler_.max_val.tobytes())
    log(f"[17a] ingested {man.n_rows} x {man.n_features} rows into "
        f"{len(man.shards)} shards ({[s.n_rows for s in man.shards]}) in "
        f"{ingest_s:.2f} s ({mb / ingest_s:.0f} MB/s of f64 rows and labels: "
        f"npz write, sha256, stats, fsync), held-out {ds_test.n_rows} rows in "
        f"{ds_test.n_shards} shard; validate all {len(statuses)} shards in "
        f"{validate_s:.2f} s ({(mb + mb * len(Yt) / len(Y)) / validate_s:.0f} "
        f"MB/s), statuses {[s.name for s in statuses]}; a prefetched scaled "
        f"read of {rows} rows in {read_s:.2f} s ({mb / read_s:.0f} MB/s); "
        f"manifest scaler has phase 5's bits: {same_scaler} ({smi})")
    check(len(man.shards) == 4, f"[17a] {len(man.shards)} shards")
    check(all(s == StreamStatus.OK for s in statuses), f"[17a] {statuses}")
    check(same_scaler, "[17a] the manifest scaler differs from phase 5's")
    check(rows == n_tr, f"[17a] the reader gave {rows} rows")

    cfg = SVMConfig(C=C, gamma=GAMMA, max_iter=10**6)
    _zero(counters)
    sync(device)
    t = time.perf_counter()
    m = BinarySVC(cfg, solver_opts=FULL_OPTS, device=device).fit_stream(ds)
    sync(device)
    train_s = time.perf_counter() - t
    counts = _count(counters)
    same = (_same_bits(m, m5) and m.result_.n_outer == m5.result_.n_outer
            and m.n_iter_ == m5.n_iter_)
    for k in ("fused_fupdate", "inner_smo"):
        launches.setdefault(k, {})["17b"] = counts[k]
    log(f"[17b] fit_stream of phase 5's job: train {train_s:.3f} s (fit "
        f"phases {json.dumps({k: round(v, 3) for k, v in m.fit_phases_.items()})}"
        f"), status {m.status_.name}, rounds {m.result_.n_outer}, updates "
        f"{m.n_iter_ - 1}, SV count {m.n_support_}, b {m.b_:.15f}; phase 5's "
        f"bits (SV IDs, alphas, SV rows, b, rounds, updates): {same}; "
        f"launches {counts}")
    check(same, "[17b] fit_stream differs from phase 5")
    check(m.status_ == Status.CONVERGED, f"[17b] {m.status_.name}")
    check(device == "cpu" or (counts["fused_fupdate"] > 0
                              and counts["inner_smo"] > 0),
          f"[17b] kernels not launched: {counts}")

    t = time.perf_counter()
    acc, n_scored = evaluate_stream(m, ds_test)
    eval_s = time.perf_counter() - t
    scores = np.concatenate([s for s, _ in predict_stream(m, ds_test)])
    ref = m5.decision_function(Xt)
    err = float(np.abs(scores - ref).max())
    tol = 1e-5 * float(np.abs(m5.sv_alpha_).sum())
    log(f"[17c] evaluate_stream over {n_scored} held-out rows in batches of "
        f"4096: {eval_s:.3f} s, accuracy {acc:.4f} (phase 5 {acc5:.4f}); "
        f"predict_stream scores against phase 5's decision_function: max "
        f"|diff| {err:.3e} (tol {tol:.3e}), bit-equal "
        f"{scores.tobytes() == ref.tobytes()}")
    check(acc == acc5, f"[17c] accuracy {acc} vs phase 5 {acc5}")
    check(err <= tol, f"[17c] scores {err} over {tol}")

    cc = CascadeConfig(n_shards=CASCADE_P, sv_capacity=CASCADE_SV_CAP,
                       topology="star")
    _zero(counters)
    sync(device)
    t = time.perf_counter()
    mc = _cascade_model("blocked", device).fit_cascade_stream(ds, cc)
    sync(device)
    cas_s = time.perf_counter() - t
    counts = _count(counters)
    same = _same_bits(mc, m14b) and mc.cascade_rounds_ == m14b.cascade_rounds_
    for k in ("fused_fupdate", "inner_smo"):
        launches.setdefault(k, {})["17d"] = counts[k]
    log(f"[17d] fit_cascade_stream, 14(b)'s star with blocked leaves (P="
        f"{CASCADE_P}): {cas_s:.3f} s, {mc.cascade_rounds_} rounds, status "
        f"{mc.status_.name}, SV count {mc.n_support_}, b {mc.b_:.15f}; 14(b)'s "
        f"bits (SV IDs, alphas, SV rows, b, rounds): {same}; launches {counts}")
    check(same, "[17d] fit_cascade_stream differs from 14(b)")
    check(device == "cpu" or (counts["fused_fupdate"] > 0
                              and counts["inner_smo"] > 0),
          f"[17d] kernels not launched: {counts}")

    train_csv, test_csv, m10, n_cut = csv10
    csv_dir = str(out_dir / "csv")
    model_path = str(out_dir / "csv_model.npz")
    out, ing_s = _cli(["ingest", "--train", train_csv, "--out", csv_dir,
                       "--rows-per-shard", str(CSV_ROWS_PER_SHARD)], device)
    log(f"[17e] ingest --train CSV ({ing_s:.1f} s in a subprocess): "
        + " | ".join(out.strip().splitlines()[:2]))
    flags = ["--C", str(C), "--gamma", str(GAMMA), "--max-iter", "1000000",
             "--q", str(FULL_OPTS["q"]), "--wss", str(FULL_OPTS["wss"]),
             "--max-inner", str(FULL_OPTS["max_inner"])]
    out, tr_s = _cli(["train", "--data", csv_dir, "--test", test_csv, *flags,
                      "--save", model_path], device)
    Xc, Yc = X_all[:n_cut], Y_all[:n_cut]
    acc10 = float((m10.predict(X_all[n_tr:]) == Y_all[n_tr:]).mean())
    cli = (_line(r"SV count = (\d+)", out), _line(r"b = (-?[\d.]+)", out),
           _line(r"accuracy = ([\d.]+)", out))
    log(f"[17e] train --data ({tr_s:.1f} s in a subprocess): SV count / b / "
        f"accuracy {cli}; phase 10's in-process fit {_report(m10, acc10)}")
    check(cli == _report(m10, acc10), f"[17e] train --data {cli} vs in "
          f"process {_report(m10, acc10)}")
    out, pr_s = _cli(["predict", "--model", model_path, "--data", csv_dir],
                     device)
    acc_c = float((m10.predict(Xc) == Yc).mean())
    log(f"[17e] predict --data ({pr_s:.1f} s in a subprocess): "
        f"{_line(r'(accuracy = .*)', out)}; in process {acc_c:.4f} on the "
        f"{n_cut} training rows")
    check(_line(r"accuracy = ([\d.]+)", out) == f"{acc_c:.4f}",
          "[17e] predict --data differs from the in-process model")
    return ds, mc


# phase 19(c)'s subprocesses: the chaos command line's two smokes and the
# pod sub-command's gate, each on the card, each with the line it must print
POD_SMOKES = ((("tpusvm_torch.faults", "pod-chaos-smoke"),
               "pod chaos smoke ok"),
              (("tpusvm_torch.faults", "kill-resume-smoke"),
               "kill-resume smoke ok"),
              (("tpusvm_torch", "pod", "--smoke"), "pod ok"))


def _start_pod_smokes(device, out_dir, timeout=600):
    """Phase 19(c)'s subprocesses, all started together, their output to
    files in out_dir, and a thread that notes when each ends (and kills
    any still running after `timeout` s): (runs, ends, watcher)."""
    import os
    import threading
    from pathlib import Path

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    runs = []
    for i, (args, line) in enumerate(POD_SMOKES):
        argv = [sys.executable, "-m", *args]
        if device == "cpu":
            argv += ["--device", "cpu"]
        out_path = os.path.join(out_dir, f"smoke19c_{i}.out")
        err_path = os.path.join(out_dir, f"smoke19c_{i}.err")
        with open(out_path, "w") as out, open(err_path, "w") as err:
            proc = subprocess.Popen(argv, stdout=out, stderr=err, cwd=root,
                                    env=env)
        runs.append((args, line, proc, time.perf_counter(), out_path,
                     err_path))
    ends = {}

    def watch():
        deadline = time.perf_counter() + timeout
        while len(ends) < len(runs) and time.perf_counter() < deadline:
            for i, run in enumerate(runs):
                if i not in ends and run[2].poll() is not None:
                    ends[i] = time.perf_counter()
            time.sleep(0.1)
        _stop_pod_smokes(runs)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return runs, ends, watcher


def _stop_pod_smokes(runs):
    for run in runs:
        if run[2].poll() is None:
            run[2].kill()
            run[2].wait()


def _finish_pod_smokes(smokes):
    """Waits for 19(c)'s subprocesses, then checks each one's exit code and
    ok line."""
    runs, ends, watcher = smokes
    watcher.join()
    for i, (args, line, proc, t0, out_path, err_path) in enumerate(runs):
        with open(out_path) as f:
            out = f.read()
        with open(err_path) as f:
            err = f.read()
        ok = [x for x in out.splitlines() if x.startswith(line)]
        secs = ends.get(i, time.perf_counter()) - t0
        log(f"[19c] python -m {' '.join(args)}: exit {proc.returncode} in "
            f"{secs:.1f} s (the three started together before 19(a), "
            f"in the whole run at phase 18's start); "
            f"{ok[-1] if ok else out[-300:]!r}")
        check(proc.returncode == 0 and ok,
              f"[19c] {' '.join(args)}: exit {proc.returncode}\n"
              f"{out[-2000:]}\n{err[-2000:]}")


def _pod_bits(res, ref):
    """A PodResult's SV IDs, alpha bits, SV rows, b and rounds equal
    another's."""
    return (np.array_equal(res.sv_ids, ref.sv_ids)
            and res.sv_alpha.tobytes() == ref.sv_alpha.tobytes()
            and res.sv_X.tobytes() == ref.sv_X.tobytes()
            and res.b == ref.b and res.rounds == ref.rounds)


def phase_pod(ds, m17d, device, counters, launches, smi, prefetch_depth=2,
              smokes=None):
    """Phase 19, the pod on 17(a)'s dataset with 14(b)'s job (star, P =
    CASCADE_P, blocked leaves with phase 5's q, wss and max_inner): (a)
    BinarySVC.fit_pod equal to 17(d)'s fit_cascade_stream bit for bit (SV
    IDs, alphas, SV rows, b, rounds), every row in a worker, each worker's
    live shards <= prefetch_depth + 1, no revive, and kernels #1 and #2
    launched in every worker process (their counts read from the workers'
    RESULT frames) and in the coordinator's layer-2 solves; the fit's
    seconds, the workers' start-up (spawn, leaf load, up to READY) and
    each round's seconds printed; (b) pod_fit with worker 1 killed (a real
    SIGKILL) at its 2nd request: one revive, (a)'s bits; (c) the chaos
    smokes and `pod --smoke` as subprocesses, started together before (a)
    (each process start costs seconds; their times and (b)'s are not
    measurements), each exiting 0 with its ok line.

    25(d): (a) is traced, the coordinator's file and one a worker process
    in one directory (pod_fit's trace_dir): `report --smoke DIR` exits 0,
    every cross-process parent resolves, and (a)'s bits are 17(d)'s as
    before; (c)'s pod-chaos-smoke runs its traced arm."""
    import json as _json
    import os
    import shutil

    from tpusvm_torch.config import CascadeConfig, SVMConfig
    from tpusvm_torch.obs.report import merge_trace_files, reparent_stats
    from tpusvm_torch.obs.trace import Tracer
    from tpusvm_torch.pod import pod_fit

    cc = CascadeConfig(n_shards=CASCADE_P, sv_capacity=CASCADE_SV_CAP,
                       topology="star")

    def kernel_counts(coordinator, res):
        """{kernel: (coordinator, [per worker])} of #1 and #2."""
        return {k: (coordinator[k], [w.get(k, 0) for w in res.worker_launches])
                for k in ("fused_fupdate", "inner_smo")}

    # (c)'s subprocesses start first (smokes: already started, in the whole
    # run at phase 18's start): their starts overlap (a) and (b)
    if smokes is None:
        smokes = _start_pod_smokes(device, os.path.dirname(ds.path))
    try:
        tdir = os.path.join(os.path.dirname(ds.path), "pod_trace")
        shutil.rmtree(tdir, ignore_errors=True)
        os.makedirs(tdir)
        tracer = Tracer(os.path.join(tdir, "coordinator.jsonl"),
                        role="pod-coordinator", argv=["chip_smoke 19a"])
        _zero(counters)
        sync(device)
        t = time.perf_counter()
        try:
            m = _cascade_model("blocked", device).fit_pod(
                ds.path, cc, prefetch_depth=prefetch_depth, tracer=tracer,
                trace_dir=tdir)
        finally:
            tracer.close()
        sync(device)
        fit_s = time.perf_counter() - t
        res = m.pod_result_
        kc = kernel_counts(_count(counters), res)
        for k, (coord, workers) in kc.items():
            launches.setdefault(k, {})["19a"] = coord + sum(workers)
        same = _same_bits(m, m17d) and m.cascade_rounds_ == m17d.cascade_rounds_
        rounds_s = [round(h["time_s"], 3) for h in res.history]
        log(f"[19a] fit_pod, 14(b)'s star with blocked leaves in {CASCADE_P} "
            f"worker processes on 17(a)'s shards: {fit_s:.3f} s, of which "
            f"worker start-up (spawn, CUDA context, leaf load, up to READY) "
            f"{res.startup_s:.3f} s and rounds {rounds_s} (sum "
            f"{sum(rounds_s):.3f} s; 17(d) in process: see [17d]); "
            f"{m.cascade_rounds_} rounds, status {m.status_.name}, SV count "
            f"{m.n_support_}, b {m.b_:.15f}; 17(d)'s bits (SV IDs, alphas, SV "
            f"rows, b, rounds): {same}; worker rows {list(res.worker_rows)}, "
            f"live shards {list(res.worker_max_live_shards)}, revives "
            f"{res.revives}; #1/#2 launches (coordinator, [workers]) "
            f"{_json.dumps(kc)} ({smi})")
        check(same, "[19a] fit_pod differs from 17(d)")
        check(sum(res.worker_rows) == ds.n_rows, f"[19a] rows {res.worker_rows}")
        check(max(res.worker_max_live_shards) <= prefetch_depth + 1,
              f"[19a] live shards {res.worker_max_live_shards}")
        check(res.revives == 0, f"[19a] revives {res.revives}")
        check(device == "cpu" or all(
            coord > 0 and min(workers) > 0 for coord, workers in kc.values()),
              f"[19a] #1/#2 not launched in every process: {kc}")
        rep, secs = _cli_in_process(["report", "--smoke", tdir], device)
        files = sorted(os.path.join(tdir, x) for x in os.listdir(tdir)
                       if x.endswith(".jsonl"))
        stats = reparent_stats(merge_trace_files(files))
        log(f"[25d] 19(a) traced into {len(files)} files: report --smoke "
            f"{secs:.2f} s: {rep.strip().splitlines()[-1]!r}; {stats}; 19(a)'s "
            f"bits (17(d)'s) held: {same}")
        check(len(files) == CASCADE_P + 1 and stats["unresolved"] == 0
              and stats["reparented"] > 0, f"[25d] {len(files)} files, {stats}")

        plan = os.path.join(os.path.dirname(ds.path), "pod_kill_plan.json")
        with open(plan, "w") as f:
            _json.dump({"format_version": 1, "seed": 0, "rules": [
                {"point": "pod.worker", "kind": "kill", "at_hit": 2}]}, f)
        cfg = SVMConfig(C=C, gamma=GAMMA, max_iter=10**6, max_rounds=50)
        _zero(counters)
        t = time.perf_counter()
        rb = pod_fit(ds.path, cfg, cc, solver="blocked",
                     solver_opts=FULL_OPTS, prefetch_depth=prefetch_depth,
                     worker_faults={1: plan}, device=device)
        kb = kernel_counts(_count(counters), rb)
        for k, (coord, workers) in kb.items():
            launches[k]["19b"] = coord + sum(workers)
        same_b = _pod_bits(rb, res)
        log(f"[19b] pod_fit with worker 1 SIGKILLed at its 2nd request: "
            f"{time.perf_counter() - t:.3f} s (alongside 19(c)), start-up "
            f"{rb.startup_s:.3f} s, revives {rb.revives}, {rb.rounds} "
            f"rounds; 19(a)'s bits: {same_b}; #1/#2 launches "
            f"{_json.dumps(kb)}")
        check(rb.revives == 1, f"[19b] revives {rb.revives}")
        check(same_b, "[19b] the revived fit differs from 19(a)")
    except BaseException:
        _stop_pod_smokes(smokes[0])
        raise
    _finish_pod_smokes(smokes)
    return m


# phase 18's maps (the JAX bench's widths, benchmarks/approx_scale.py) and
# gates: each arm CONVERGED, its accuracy within APPROX_ACC_BAND of phase
# 5's, the rff probe error non-increasing in D with APPROX_ERR_SLACK
APPROX_RFF_DIM, APPROX_LANDMARKS = 2048, 1024
APPROX_ACC_BAND, APPROX_ERR_SLACK = 0.055, 1.05
APPROX_PROBE_D = (512, 1024, 2048)
# 18(c)'s primal knobs, cut (PERF.md section 4): the JAX bench's
# full-run batch of 256 (benchmarks/approx_scale.py), 64 epochs at most,
# the 5% plateau. At a batch of 1,024 the plateau comes after 30 epochs
# (1,770 steps) instead of 5-6, about 40 s instead of 8 on the card, at the
# same accuracy (scripts/torch_primal_batch_probe.py --rows 60000), which
# would take phases 17-18 past a minute
PRIMAL_OPTS = dict(primal_batch=256, primal_epochs=64, primal_tol=0.05)


def _sync_count(fn):
    """(fn(), the synchronizing CUDA calls torch reported during it): torch
    .cuda's sync debug mode warns at each one, on whichever thread makes
    it; each is recorded as (thread name, the innermost frame of this
    checkout's code that led to it)."""
    import threading
    import traceback
    from pathlib import Path

    import torch

    root = str(Path(__file__).resolve().parent)
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(root) and "chip_smoke" not in
                f.filename]
        where = (f"{Path(ours[-1].filename).name}:{ours[-1].lineno}"
                 if ours else f"{Path(filename).name}:{lineno}")
        seen.append((threading.current_thread().name, where))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # switched on before the recorder: the switch's own first use in a
        # process warns once, and that is no call of fn's
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, seen


def _round_trip(m, Xq, tag, device):
    import os

    from tpusvm_torch.models import load_any
    from tpusvm_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(_build.BUILD_DIR / f"chip_smoke_{tag}.npz")
    m.save(path)
    again = load_any(path, device=device)
    os.remove(path)
    same = (again.decision_function(Xq).tobytes()
            == m.decision_function(Xq).tobytes())
    check(same, f"[{tag}] the reloaded artifact scores differently")
    return same


def phase_approx(X_all, Y_all, n_tr, acc5, ds, device, counters, launches):
    """Phase 18, the approximate families on phase 5's job: (a) kernel="rff",
    rff_dim=APPROX_RFF_DIM, map_seed=0 and (b) kernel="nystrom",
    landmarks=APPROX_LANDMARKS, each the blocked solver (phase 5's q, wss,
    max_inner) over the mapped rows on the card, #2 on the linear path;
    (c) the streamed rff primal fit from 17(a)'s shards (PRIMAL_OPTS), its
    live shards <= prefetch_depth + 1 and its synchronizing calls outside
    the reader's thread <= one an epoch plus one (the reader's own are
    printed); each CONVERGED, within APPROX_ACC_BAND of phase 5's
    accuracy, its artifact round-tripped; the rff probe error over
    APPROX_PROBE_D non-increasing (APPROX_ERR_SLACK). Train seconds, the
    map's share (the map alone, CUDA events, over train seconds) and #2's
    launches are printed. Returns (a)'s model (phase 22 serves it)."""
    import torch

    from tpusvm_torch.approx import build_map, kernel_approx_error
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.status import Status

    X, Y = X_all[:n_tr], Y_all[:n_tr]
    Xt, Yt = X_all[n_tr:], Y_all[n_tr:]
    fitted = {}
    arms = (("18a", dict(kernel="rff", rff_dim=APPROX_RFF_DIM, map_seed=0)),
            ("18b", dict(kernel="nystrom", landmarks=APPROX_LANDMARKS,
                         map_seed=0)))
    for tag, kw in arms:
        cfg = SVMConfig(C=C, gamma=GAMMA, max_iter=10**6, **kw)
        _zero(counters)
        sync(device)
        t = time.perf_counter()
        m = BinarySVC(cfg, solver_opts=FULL_OPTS, device=device).fit(X, Y)
        sync(device)
        train_s = time.perf_counter() - t
        counts = _count(counters)
        launches.setdefault("inner_smo", {})[tag] = counts["inner_smo"]
        acc = float((m.predict(Xt) == Yt).mean())
        Xd = torch.as_tensor(m.scaler_.transform(X).astype(np.float32),
                             device=device)
        map_ms = cuda_ms(lambda: m.fmap_.transform(Xd), reps=3, warmup=1)
        res = m.result_
        log(f"[{tag}] {kw}: train {train_s:.3f} s, the map {map_ms:.1f} ms "
            f"alone ({100 * map_ms / 1e3 / train_s:.1f}% of train; mapped "
            f"{n_tr} x {m.fmap_.dim} f32, {n_tr * m.fmap_.dim * 4 / 1e6:.0f} "
            f"MB on the card), status {m.status_.name}, rounds {res.n_outer}, "
            f"updates {m.n_iter_ - 1}, SV count {m.n_support_}, b "
            f"{m.b_:.15f}, accuracy {acc:.4f} (phase 5 {acc5:.4f}), host "
            f"syncs {res.n_host_syncs}; fit phases "
            f"{json.dumps({k: round(v, 3) for k, v in m.fit_phases_.items()})}"
            f"; launches {counts}")
        check(m.status_ == Status.CONVERGED, f"[{tag}] {m.status_.name}")
        check(abs(acc - acc5) <= APPROX_ACC_BAND,
              f"[{tag}] accuracy {acc} vs phase 5 {acc5}")
        check(device == "cpu" or counts["inner_smo"] > 0,
              f"[{tag}] #2 not launched: {counts}")
        _round_trip(m, Xt, tag, device)
        fitted[tag] = m

    cfg = SVMConfig(C=C, gamma=GAMMA, kernel="rff", rff_dim=APPROX_RFF_DIM,
                    map_seed=0)
    _zero(counters)
    sync(device)
    t = time.perf_counter()
    m, syncs = _sync_count(lambda: BinarySVC(
        cfg, solver_opts=PRIMAL_OPTS, device=device).fit_stream(ds))
    sync(device)
    train_s = time.perf_counter() - t
    pr = m.primal_result_
    acc = float((m.predict(Xt) == Yt).mean())
    Xd = torch.as_tensor(m.scaler_.transform(X).astype(np.float32),
                         device=device)
    map_ms = cuda_ms(lambda: m.fmap_.transform(Xd), reps=3, warmup=1)
    reader = [w for t, w in syncs if t == "tpusvm-torch-stream-reader"]
    solver = [w for t, w in syncs if t != "tpusvm-torch-stream-reader"]
    where = {"solver": sorted(set(solver)), "reader": sorted(set(reader))}
    log(f"[18c] streamed rff primal fit from 17(a)'s {ds.n_shards} shards "
        f"{PRIMAL_OPTS}: train {train_s:.3f} s, status {m.status_.name}, "
        f"{pr.epochs_run} epochs, {pr.n_steps} steps ({pr.n_steps / max(pr.epochs_run, 1):.0f} "
        f"an epoch), objective {pr.objective:.9f}, b {m.b_:.9f}, accuracy "
        f"{acc:.4f} (phase 5 {acc5:.4f}); live shards <= "
        f"{m.stream_max_live_shards_} (bound 3); host reads counted by the "
        f"solver {pr.host_syncs}, synchronizing calls torch reported on the "
        f"solver's thread {len(solver)} and on the reader's {len(reader)}, "
        f"at {where}; the map over all rows {map_ms:.1f} ms "
        f"alone, x {pr.epochs_run} epochs = "
        f"{100 * map_ms * pr.epochs_run / 1e3 / train_s:.1f}% of train")
    check(m.status_ == Status.CONVERGED, f"[18c] {m.status_.name}")
    check(abs(acc - acc5) <= APPROX_ACC_BAND,
          f"[18c] accuracy {acc} vs phase 5 {acc5}")
    check(m.stream_max_live_shards_ <= 3,
          f"[18c] {m.stream_max_live_shards_} live shards")
    check(pr.host_syncs == pr.epochs_run + 1
          and len(solver) <= pr.epochs_run + 1,
          f"[18c] {len(solver)} synchronizing calls on the solver's thread "
          f"over {pr.epochs_run} epochs: {where}")
    _round_trip(m, Xt, "18c", device)

    Xs = m.scaler_.transform(X)
    errs = []
    for D in APPROX_PROBE_D:
        fm = build_map(SVMConfig(C=C, gamma=GAMMA, kernel="rff", rff_dim=D,
                                 map_seed=0), n_features=X.shape[1])
        errs.append(kernel_approx_error(Xs, fm, GAMMA, device=device))
    log(f"[18] rff probe max |K_hat - K| over 2048 row pairs at D = "
        f"{list(APPROX_PROBE_D)}: {[round(e, 6) for e in errs]}")
    check(all(b <= a * APPROX_ERR_SLACK for a, b in zip(errs, errs[1:])),
          f"[18] probe errors not non-increasing in D: {errs}")
    return fitted["18a"]


def _head_bits(m, ref, K):
    """Every head of two lockstep pair fits equal bit for bit (alpha, b,
    n_iter, status)."""
    import torch

    return all(
        torch.equal(m.results_.alpha[k], ref.results_.alpha[k])
        and m.results_.b[k].item() == ref.results_.b[k].item()
        and int(m.results_.n_iter[k]) == int(ref.results_.n_iter[k])
        and int(m.results_.status[k]) == int(ref.results_.status[k])
        for k in range(K))


def _same_artifact(a, b):
    """Two saved models hold the same arrays byte for byte (the zip
    entries themselves carry the write time)."""
    from tpusvm_torch.models.serialization import load_model

    sa, sb = load_model(a)[0], load_model(b)[0]
    return sorted(sa) == sorted(sb) and all(
        sa[k].dtype == sb[k].dtype and sa[k].tobytes() == sb[k].tobytes()
        for k in sa)


def _start(args, out_dir, name, device):
    """`python -m ARGS` as a background process from this checkout, its
    output in out_dir/name.out and .err."""
    import os
    from pathlib import Path

    root = str(Path(__file__).resolve().parent)
    if device == "cpu":
        args = [*args, "--device", "cpu"]
    with open(out_dir / f"{name}.out", "w") as o, \
            open(out_dir / f"{name}.err", "w") as e:
        return subprocess.Popen([sys.executable, "-m", *args], cwd=root,
                                stdout=o, stderr=e,
                                env=dict(os.environ, PYTHONPATH=root))


def _finish(procs, out_dir, deadline_s, tag):
    """Wait for named background processes until the deadline (all killed
    on expiry), polling, so each one's seconds run from its start to its
    exit; each must exit 0. Returns {name: (stdout, seconds)}."""
    t = time.perf_counter()
    secs = {}
    while len(secs) < len(procs):
        for name, (p, t0) in procs.items():
            if name not in secs and p.poll() is not None:
                secs[name] = time.perf_counter() - t0
        if time.perf_counter() - t > deadline_s:
            for p, _ in procs.values():
                p.kill()
                p.wait()
            check(False, f"[{tag}] not finished within {deadline_s} s")
        time.sleep(0.2)
    for name, (p, _) in procs.items():
        check(p.returncode == 0, f"[{tag}] {name}: exit {p.returncode}\n"
              f"{(out_dir / f'{name}.out').read_text()[-1500:]}\n"
              f"{(out_dir / f'{name}.err').read_text()[-1500:]}")
    return {name: ((out_dir / f"{name}.out").read_text(), secs[name])
            for name in procs}


def phase_class_axis(Xm, lm, n_tr, ovr_b, ovr_a, X_all, Y_all, m5, acc5,
                     csvs, writers, model5_path, device, counters, launches,
                     out_dir, clock):
    """Phase 20, the class axis and the front door: (a) class_parallel on
    8(b)'s job over the default mesh and over three members on one card
    (12 heads with the padding), every head equal to 8(b)'s bit for bit,
    pair_rows launched; (b) two rank processes of `train --multiclass
    --class-parallel --distributed` on 8(b)'s rows from a CSV, their saved
    models equal to each other and to (a)'s; (c) row-split scoring of phase
    5's and 8(a)'s models over three members (predictions equal, scores
    within 1e-5 x sum|coef|) and `predict --mesh-predict`; (d) phase 5's
    job on rows [:N_DTYPE_CUT] at float64 and bfloat16 (CONVERGED, no kernel
    launched, accuracy within 0.002 of the float32 fit) and the pair
    solver at float64 on 2,000 rows (no pair_rows); (e) `predict --scores`
    and `--proba` on phase 9's Platt model, equal to the in-process scores
    and probabilities to the printed digits, and `train --smoke` in its
    three cells, all as subprocesses started together."""
    import torch
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC, OneVsRestSVC, load_any
    from tpusvm_torch.ops.cuda import _build
    from tpusvm_torch.status import Status

    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = SVMConfig(C=C, gamma=GAMMA, max_iter=10**6)
    K = len(ovr_b.classes_)
    one_card = ["cpu"] * 3 if device == "cpu" else ["cuda:0"] * 3
    # (a) the class axis in this process
    a_path = str(out_dir / "class_parallel.npz")
    for tag, mesh in (("default mesh", None), ("3 members", one_card)):
        _zero(counters)
        sync(device)
        t = time.perf_counter()
        m = OneVsRestSVC(cfg, solver="pair", class_parallel=True, mesh=mesh,
                         device=device).fit(Xm[:n_tr], lm[:n_tr])
        sync(device)
        secs = time.perf_counter() - t
        counts = _count(counters)
        same = _head_bits(m, ovr_b, K) and len(m.classes_) == K
        r = m.results_
        members = len(m.class_mesh_["devices"])
        log(f"[20a] class_parallel, {tag} {json.dumps(m.class_mesh_)}: train "
            f"{secs:.3f} s, {K} heads padded to {-(-K // members) * members}, "
            f"statuses {[Status(int(v)).name for v in m.statuses_]}, chunks "
            f"{r.chunks}, host syncs {r.host_syncs}; every head equal to "
            f"8(b)'s bit for bit: {same}; launches {counts}")
        check(same, f"[20a] {tag}: heads differ from 8(b)")
        check(device == "cpu" or counts["pair_rows"] > 0,
              f"[20a] {tag}: pair_rows not launched {counts}")
        launches.setdefault("pair_rows", {})[f"20a {tag}"] = counts["pair_rows"]
        if mesh is None:
            m.save(a_path)
    clock("20a")

    # (b) the class axis over two rank processes on the one card
    waited = wait_for(csvs["ovr"], writers)
    flags = ["tpusvm_torch", "train", "--train", csvs["ovr"], "--multiclass",
             "--class-parallel", "--C", str(C), "--gamma", str(GAMMA),
             "--max-iter", "1000000", "--distributed", "--coordinator-address",
             f"file://{out_dir / 'store'}", "--num-processes", "2"]
    if (out_dir / "store").exists():
        (out_dir / "store").unlink()
    t = time.perf_counter()
    ranks = {f"rank{r}": (_start([*flags, "--process-id", str(r), "--save",
                                  str(out_dir / f"rank{r}.npz")], out_dir,
                                 f"rank{r}", device), t) for r in range(2)}
    done = _finish(ranks, out_dir, 600, "20b")
    wall = time.perf_counter() - t
    out0 = done["rank0"][0]
    equal = [_same_artifact(str(out_dir / f"rank{r}.npz"), a_path)
             for r in range(2)]
    log(f"[20b] two rank processes of train --multiclass --class-parallel "
        f"--distributed on 8(b)'s {n_tr} rows from a CSV (waited {waited:.1f} "
        f"s for it), one card: {wall:.1f} s wall; rank 0: data "
        f"{_line(r'data time: ([\d.]+) s', out0)} s, training "
        f"{_line(r'training time: ([\d.]+) s', out0)} s, "
        f"{_line(r'(status = .*)', out0)}; each rank's model equals (a)'s "
        f"(every array byte for byte): {equal}")
    check(all(equal), "[20b] a rank's model differs from (a)'s")
    check(not done["rank1"][0].strip(), "[20b] rank 1 printed")
    clock("20b")

    # (c) row-split scoring
    Xt, Yt = X_all[n_tr:], Y_all[n_tr:]
    m8a = ovr_a[0]
    for name, model, Xq, coef in (
            ("phase 5", m5, Xt, m5.sv_alpha_ * m5.sv_Y_),
            ("8(a)", m8a, Xm[n_tr:], m8a.coef_.T)):
        t = time.perf_counter()
        full = model.decision_function(Xq)
        full_s = time.perf_counter() - t
        t = time.perf_counter()
        split = model.decision_function(Xq, mesh=one_card)
        split_s = time.perf_counter() - t
        err = float(np.abs(split - full).max())
        tol = 1e-5 * float(np.abs(coef).sum(axis=0).max())
        pf, ps = ((full > 0, split > 0) if full.ndim == 1
                  else (full.argmax(1), split.argmax(1)))
        log(f"[20c] {name}'s decision_function over 3 members on one card: "
            f"{split_s:.3f} s (unsplit {full_s:.3f} s), max |diff| {err:.3e} "
            f"(tol {tol:.3e}), bit-equal {split.tobytes() == full.tobytes()}, "
            f"predictions equal {bool(np.array_equal(pf, ps))}")
        check(np.array_equal(pf, ps), f"[20c] {name}: predictions differ")
        check(err <= tol, f"[20c] {name}: scores {err} over {tol}")
    out, secs = _cli(["predict", "--model", model5_path, "--data",
                      csvs["test"], "--mesh-predict"], device)
    log(f"[20c] predict --mesh-predict ({secs:.1f} s in a subprocess): "
        f"{_line(r'(accuracy = .*)', out)}; phase 5 {acc5:.4f}")
    check(_line(r"accuracy = ([\d.]+)", out) == f"{acc5:.4f}",
          "[20c] predict --mesh-predict differs from phase 5")
    clock("20c")

    # (e)'s subprocesses start now and run beside (d)
    smokes = {}
    cal_path = str(_build.BUILD_DIR / "chip_smoke_calibrated.npz")
    for name, args in (
            ("scores", ["predict", "--model", cal_path, "--data", csvs["test"],
                        "--scores"]),
            ("proba", ["predict", "--model", cal_path, "--data", csvs["test"],
                       "--proba"]),
            ("smoke_svc", ["train", "--smoke"]),
            ("smoke_ovr", ["train", "--smoke", "--task", "ovr"]),
            ("smoke_svr", ["train", "--smoke", "--task", "svr"])):
        smokes[name] = (_start(["tpusvm_torch", *args], out_dir, name, device),
                        time.perf_counter())

    # (d) the feature dtype, cut in rows
    n_cut = N_DTYPE_CUT
    Xc, Yc = X_all[:n_cut], Y_all[:n_cut]
    fits = {}
    for dt, solver, n_fit in (("float32", "blocked", n_cut),
                              ("float64", "blocked", n_cut),
                              ("bfloat16", "blocked", n_cut),
                              ("float64", "pair", 2000)):
        _zero(counters)
        sync(device)
        t = time.perf_counter()
        m = BinarySVC(cfg, solver=solver, dtype=dt, device=device,
                      solver_opts=FULL_OPTS if solver == "blocked" else {}
                      ).fit(Xc[:n_fit], Yc[:n_fit])
        sync(device)
        secs = time.perf_counter() - t
        counts = _count(counters)
        acc = float((m.predict(Xt) == Yt).mean())
        fits[(dt, solver)] = (m, acc)
        ref, acc_ref = fits[("float32", "blocked")]
        jac = (len(set(m.sv_ids_) & set(ref.sv_ids_))
               / len(set(m.sv_ids_) | set(ref.sv_ids_)))
        rounds = getattr(m.result_, "n_outer", None)
        log(f"[20d] {dt} {solver} on rows [:{n_fit}]: train {secs:.3f} s, "
            f"status {m.status_.name}, rounds {rounds}, updates "
            f"{m.n_iter_ - 1}, SV count {m.n_support_}, b {m.b_:.12f}, accuracy "
            f"{acc:.4f} (float32 blocked on [:{n_cut}]: {acc_ref:.4f}), SV-ID "
            f"Jaccard with it {jac:.3f}; launches {counts}")
        check(m.status_ == Status.CONVERGED, f"[20d] {dt} {solver}: "
              f"{m.status_.name}")
        if dt != "float32":
            check(sum(counts.values()) == 0,
                  f"[20d] {dt} {solver} launched a float32 kernel: {counts}")
        if solver == "blocked":
            check(abs(acc - acc_ref) <= 0.002, f"[20d] {dt}: accuracy {acc} "
                  f"vs float32 {acc_ref}")
    clock("20d")

    # (e) the subprocesses
    done = _finish(smokes, out_dir, 600, "20e")
    cal = load_any(cal_path, device=device)
    for name, want in (
            ("scores", [f"{v:.15f}" for v in cal.decision_function(Xt)]),
            ("proba", [f"{v:.15f}" for v in cal.predict_proba(Xt)[:, 1]])):
        got = done[name][0].splitlines()
        log(f"[20e] predict --{name} on phase 9's Platt model (a "
            f"subprocess, done {done[name][1]:.1f} s after its start, read "
            f"after (d)): {len(got)} lines, "
            f"equal to the in-process values to the printed digits "
            f"{got == want}; first {got[:2]}")
        check(got == want, f"[20e] predict --{name} differs")
    for name in ("smoke_svc", "smoke_ovr", "smoke_svr"):
        line = _line(r"(train smoke ok .*)", done[name][0])
        log(f"[20e] train --smoke {name[6:]} (a subprocess beside (d), done "
            f"{done[name][1]:.1f} s after its start, read after (d)): {line}")
    clock("20e")


# phase 21's search: a 3 x 3 log grid (step 4) around phase 5's point,
# halving over 3 folds with eta 3 from 4,096 rows, one fleet a fold and rung
TUNE_SPAN, TUNE_FOLDS, TUNE_ETA, TUNE_MIN_RUNG = 1, 3, 3, 4096


def phase_tune(X_all, Y_all, n_tr, acc5, device, counters, launches,
               out_dir):
    """Phase 21, tuning on phase 5's training rows: the halving search with
    fleet=True (phase 5's q, wss and max_inner), every fit ending with a
    status JAX's tune accepts, the winner's mean CV accuracy within 0.005
    of phase 5's held-out accuracy, the problem-axis #1 and #2 launched, one
    lane of the last rung re-fit alone (a one-lane fleet_train with its
    seed) equal to its lane bit for bit, the results JSON written and
    described by `info` with format_table's text; `tune --smoke` as a
    subprocess beside it. Each rung's seconds and the phase's."""
    import torch
    from tpusvm_torch import fleet
    from tpusvm_torch.tune import (TuneConfig, format_table, load_tune_result,
                                   log_grid, save_tune_result, tune)

    out_dir.mkdir(parents=True, exist_ok=True)
    smoke = {"tune_smoke": (_start(["tpusvm_torch", "tune", "--smoke"],
                                   out_dir, "tune_smoke", device),
                            time.perf_counter())}
    grid = log_grid(C, GAMMA, span=TUNE_SPAN)
    calls = []
    real = fleet.fleet_train

    def recorded(Xr, Ys, Cs, gammas, **kw):
        outs = real(Xr, Ys, Cs, gammas, **kw)
        calls.append((Xr, Ys, Cs, gammas, kw, outs))
        return outs

    said = []

    def say(msg):
        said.append((time.perf_counter(), msg))

    _zero(counters)
    fleet.fleet_train = recorded
    sync(device)
    t0 = time.perf_counter()
    try:
        res = tune(X_all[:n_tr], Y_all[:n_tr], grid,
                   TuneConfig(folds=TUNE_FOLDS, schedule="halving",
                              eta=TUNE_ETA, min_rung=TUNE_MIN_RUNG,
                              fleet=True),
                   solver_opts=FULL_OPTS, log_fn=say, device=device)
    finally:
        fleet.fleet_train = real
    sync(device)
    secs = time.perf_counter() - t0
    counts = _count(counters)
    t_prev = t0
    for t, msg in said:
        if " rung " in msg:
            log(f"[21] {msg}: {t - t_prev:.3f} s")
            t_prev = t
    for line in format_table(res).splitlines():
        log(f"[21]   {line}")
    ended = [msg for _, msg in said if " ended " in msg]
    win = res.winner
    log(f"[21] halving tune, fleet, {grid.shape[0]}x{grid.shape[1]} grid, "
        f"{TUNE_FOLDS} folds, eta {TUNE_ETA}, min rung {TUNE_MIN_RUNG}: "
        f"{secs:.3f} s, {len(calls)} fleets, {res.total_updates} updates; "
        f"winner C={win['C']:g} gamma={win['gamma']:g} cv_accuracy "
        f"{win['cv_accuracy']:.4f} (phase 5 held out {acc5:.4f}); fits ending "
        f"outside CONVERGED/NO_WORKING_SET: {ended}; launches {counts}")
    check(not ended, f"[21] fits ended {ended}")
    check(abs(win["cv_accuracy"] - acc5) <= 0.005,
          f"[21] winner cv_accuracy {win['cv_accuracy']} vs phase 5 {acc5}")
    check(device == "cpu" or (counts["inner_smo_batched"] > 0
                              and counts["fused_fupdate_batched"] > 0),
          f"[21] the problem-axis kernels did not launch: {counts}")
    for k in ("inner_smo_batched", "fused_fupdate_batched", "fused_fupdate",
              "inner_smo"):
        launches.setdefault(k, {})["21"] = counts[k]
    Xr, Ys, Cs, gammas, kw, outs = calls[-1]
    one = dict(kw)
    if kw.get("alpha0s") is not None:
        one["alpha0s"] = [kw["alpha0s"][0]]
    solo = real(Xr, [Ys[0]], [Cs[0]], [gammas[0]], **one)[0]
    same = (torch.equal(solo.alpha, outs[0].alpha)
            and float(solo.b) == float(outs[0].b)
            and int(solo.n_iter) == int(outs[0].n_iter)
            and int(solo.status) == int(outs[0].status))
    log(f"[21] the last rung's lane 0 (C={Cs[0]:g}, gamma={gammas[0]:g}, "
        f"{Xr.shape[0]} rows, seeded {one.get('alpha0s') is not None}) re-fit "
        f"alone: equal bit for bit {same}")
    check(same, "[21] a lane differs from its one-lane fit")
    path = str(out_dir / "tune.json")
    save_tune_result(path, res)
    out, _ = _cli_in_process(["info", path], device)
    check(out.strip() == format_table(load_tune_result(path)),
          "[21] info does not print format_table's text")
    done = _finish(smoke, out_dir, 600, "21")
    log(f"[21] info {path}: format_table's text; tune --smoke "
        f"({done['tune_smoke'][1]:.1f} s in a subprocess, beside the search): "
        f"{_line(r'(tune smoke ok.*)', done['tune_smoke'][0])}")


# phase 22's cut: the held-out rows (22(a)) and HTTP rows (22(b)) and the
# swap clients' rows (22(c)); the refresh's appended rows (22(d)): phase
# 5's training rows then the first N_APPEND held-out rows
N_HTTP, N_SWAP_ROWS, N_SWAPS, N_APPEND = 1000, 64, 8, 5000
SERVE_SMOKES = ((("tpusvm_torch", "serve", "--smoke"), "smoke rings:"),
                (("tpusvm_torch", "refresh", "--smoke"), "refresh smoke ok"),
                (("tpusvm_torch.faults", "swap-chaos-smoke"),
                 "swap chaos smoke ok"))


def _http(url, body=None, timeout=60.0):
    """(status, bytes) of a GET (body None) or a JSON POST."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _load_clients(srv, name, X, threads):
    """`threads` client threads send the rows of X one row per request,
    thread t the rows t::threads; (scores in row order, labels, seconds,
    statuses that were not OK)."""
    import threading

    scores = [None] * len(X)
    labels = [None] * len(X)
    bad = []

    def run(t):
        for i in range(t, len(X), threads):
            r = srv.submit(name, X[i], timeout_s=60.0)
            if not r.ok:
                bad.append((i, r.status))
            scores[i], labels[i] = r.scores, r.label

    ts = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(300.0)
    secs = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "[22] a client thread hung")
    return scores, labels, secs, bad


def _serving_bits(tag, srv, name, est, Xt, device):
    """22(a)'s card check on one hosted model: at every bucket, the graph
    replay, the bucket program run eagerly on the worker's stream and on
    the default stream, and the estimator's decision_function on the
    default stream give the same bits. Returns the buckets' capture s."""
    import torch

    w = srv._worker(name)
    cache = w.cache
    for b in cache.buckets:
        rows = w.entry.scale(w.entry.validate_rows(Xt[:b]))
        replay, _ = cache.scores(rows)
        eager = cache.eager_scores(rows)
        default = cache.eager_scores(
            rows, stream=torch.cuda.current_stream() if device != "cpu"
            else None)
        offline = np.asarray(est.decision_function(Xt[:b]))
        check(replay.tobytes() == eager.tobytes() == default.tobytes()
              == offline.tobytes(),
              f"[{tag}] bucket {b}: replay, eager (worker stream), eager "
              f"(default stream) and decision_function differ")
    return cache.build_s


def phase_serve(X_all, Y_all, n_tr, m5, model5_path, m11, ovr_a, Xm, rff,
                device, counters, launches, smi, out_dir):
    """Phase 22, serving and refresh at full width (tpusvm_torch.serve):

    (a) phase 5's artifact, 8(a)'s ten-head model and 18(a)'s rff model
        served in-process (max_batch 64): warm-up captures one CUDA graph
        a bucket (count, seconds); at every bucket replay = eager on the
        worker's stream = eager on the default stream = decision_function
        bit for bit; eight client threads send the 10,000 held-out rows
        one row a request, every score (and label) bit-equal to the
        model's decision_function, recompiles 0; QPS, p50/p99, occupancy
        and sequential_qps printed;
    (b) `serve --model --port 0 --state` as a subprocess: 1,000 held-out
        rows in POSTs of 1-64 rows, bit-equal to (a); /healthz 200,
        /metrics and /metrics.json parse, the state names the address;
    (c) eight hot-swaps between phase 5's and phase 11's artifacts under
        four clients: every response one generation's bits, none lost;
        device memory after the first and the last swap;
    (d) refresh of phase 5's artifact on rows [:n_tr + N_APPEND], warm and
        cold, both CONVERGED, warm in fewer updates, #1 and #2 launched,
        accuracy on rows [n_tr + N_APPEND:] within 0.002 of phase 5's
        there; then `refresh --swap URL` into (b)'s server, whose served
        scores are then the refreshed artifact's decision_function bits;
    (e) `serve --smoke`, `refresh --smoke` and `swap-chaos-smoke` as
        subprocesses beside (d), each exiting 0."""
    import gc
    import os
    import threading
    import weakref

    import torch

    from tpusvm_torch.models import load_any
    from tpusvm_torch.obs import prof
    from tpusvm_torch.obs.fleet import parse_payload
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.serve.refresh import refresh_fit
    from tpusvm_torch.serve.server import sequential_qps
    from tpusvm_torch.status import Status

    out_dir.mkdir(parents=True, exist_ok=True)
    Xt, Xmt = X_all[n_tr:], Xm[n_tr:]
    paths = {"m5": model5_path, "ovr": str(out_dir / "ovr.npz"),
             "rff": str(out_dir / "rff.npz"), "m11": str(out_dir / "m11.npz")}
    ovr_a.save(paths["ovr"])
    rff.save(paths["rff"])
    m11.save(paths["m11"])

    # (b)'s server starts first: ~10 s of interpreter and torch start
    state = out_dir / "serve_state.json"
    if state.exists():
        state.unlink()
    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "tpusvm_torch", "serve", "--model",
            f"m5={paths['m5']}", "--port", "0", "--state", str(state)]
    if device == "cpu":
        argv += ["--device", "cpu"]
    serve_out = open(out_dir / "serve22b.out", "w")
    serve_err = open(out_dir / "serve22b.err", "w")
    t_b = time.perf_counter()
    server_proc = subprocess.Popen(argv, cwd=root, stdout=serve_out,
                                   stderr=serve_err,
                                   env=dict(os.environ, PYTHONPATH=root))
    import atexit

    atexit.register(lambda: server_proc.poll() is None and server_proc.kill())

    # (a) in-process, every model
    want = {}
    cases = (("m5", m5, Xt), ("ovr", ovr_a, Xmt), ("rff", rff, Xt))
    with Server(ServeConfig(max_batch=64), device=device) as srv:
        for name, _, _ in cases:
            srv.load_model(name, paths[name])
        t = time.perf_counter()
        # 25(e): the captures under the compile observatory
        with prof.profiling() as observatory:
            built = srv.warmup()
        warm_s = time.perf_counter() - t
        log(f"[22a] warm-up: {json.dumps(built)} bucket graphs captured in "
            f"{warm_s:.3f} s ({smi})")
        recs = [r for r in observatory.records
                if r["executable"].startswith("serve.bucket[")]
        per_model = {n: sum(r["model"] == n for r in recs) for n in built}
        log(f"[25e] phase 22(a)'s warm-up under the compile observatory: "
            f"{len(recs)} capture records {json.dumps(per_model)}; capture "
            f"seconds {sum(r['compile_s'] for r in recs):.3f}, eager "
            f"warm-up seconds {sum(r['lower_s'] for r in recs):.3f}")
        check(per_model == built and len(recs) == len(
            {r["executable"] for r in recs}),
              f"[25e] capture records {per_model} vs graphs {built}")
        for name, est, X in cases:
            cap = _serving_bits("22a", srv, name, est, X, device)
            offline = np.asarray(est.decision_function(X))
            scores, labels, secs, bad = _load_clients(srv, name, X, 8)
            check(not bad, f"[22a] {name}: statuses {bad[:5]}")
            got = np.stack(scores)
            check(got.tobytes() == offline.tobytes(),
                  f"[22a] {name}: served scores differ from "
                  "decision_function")
            if name == "ovr":
                check(np.array_equal(np.asarray(labels), est.predict(X)),
                      "[22a] ovr: served labels differ from predict")
            want[name] = got
            snap = srv.metrics(name)
            st = srv.status()["models"][name]
            check(snap["recompiles"] == 0 and st["recompiles"] == 0,
                  f"[22a] {name}: recompiles {snap['recompiles']}")
            seq = sequential_qps(srv, name, list(X[:256]), 1.0)
            lat = snap["latency_s"]
            log(f"[22a] {name} ({st['kind']}, {st['n_sv']} SVs, "
                f"{st['n_features']} features): {len(X)} rows one a request "
                f"from 8 threads in {secs:.3f} s = {len(X) / secs:.0f} QPS, "
                f"p50 {lat['p50'] * 1e3:.3f} ms, p99 {lat['p99'] * 1e3:.3f} "
                f"ms, mean batch rows {snap['mean_batch_rows']:.2f} over "
                f"{snap['batches']} batches, sequential_qps {seq:.0f}; "
                f"{st['compiles']} graphs, capture {cap:.3f} s; scores "
                f"bit-equal to decision_function, recompiles 0 ({smi})")

    # (b) the subprocess server over HTTP
    url = None
    deadline = time.perf_counter() + 180.0
    while url is None and time.perf_counter() < deadline:
        check(server_proc.poll() is None, "[22b] serve exited early:\n"
              + (out_dir / "serve22b.err").read_text()[-2000:])
        for line in (out_dir / "serve22b.out").read_text().splitlines():
            if line.startswith("serving on http://"):
                url = line.split()[2]
        time.sleep(0.2)
    check(url is not None, "[22b] serve did not come up within 180 s")
    up_s = time.perf_counter() - t_b
    rng = np.random.default_rng(22)
    i = 0
    sizes = []
    t = time.perf_counter()
    while i < N_HTTP:
        k = int(min(rng.integers(1, 65), N_HTTP - i))
        code, body = _http(f"{url}/v1/models/m5:predict",
                           {"instances": Xt[i:i + k].tolist()})
        check(code == 200, f"[22b] POST {k} rows: {code} {body[:300]!r}")
        got = np.asarray(json.loads(body)["scores"], np.float32)
        check(got.tobytes() == want["m5"][i:i + k].tobytes(),
              f"[22b] rows {i}:{i + k} over HTTP differ from (a)")
        sizes.append(k)
        i += k
    http_s = time.perf_counter() - t
    code, body = _http(f"{url}/healthz")
    check(code == 200 and json.loads(body)["status"] == "ok",
          f"[22b] /healthz {code} {body[:300]!r}")
    code, body = _http(f"{url}/metrics")
    lines = body.decode().splitlines()
    check(code == 200 and lines and all(
        len(x.rsplit(" ", 1)) == 2 and float(x.rsplit(" ", 1)[1]) >= 0
        for x in lines), "[22b] /metrics does not parse")
    code, body = _http(f"{url}/metrics.json")
    check(code == 200, f"[22b] /metrics.json {code}")
    payload = parse_payload(json.loads(body))
    saved = json.loads(state.read_text())
    check(url.endswith(saved.get("address", "?")),
          f"[22b] serve_state.json names {saved.get('address')}, not {url}")
    log(f"[22b] serve --port 0 up in {up_s:.1f} s at {url}; {N_HTTP} rows in "
        f"{len(sizes)} POSTs of 1-64 rows in {http_s:.3f} s, bit-equal to "
        f"(a); /healthz 200, /metrics {len(lines)} lines, /metrics.json "
        f"{len(payload['snapshot']['metrics'])} series, state address "
        f"{saved['address']} ({smi})")

    # (c) hot-swaps under load
    Xq = Xt[:N_SWAP_ROWS]
    refA = np.asarray(m5.decision_function(Xq))
    refB = np.asarray(m11.decision_function(Xq))
    check(refA.tobytes() != refB.tobytes(), "[22c] the generations' scores "
          "are equal: the torn-read check would be vacuous")
    mem, blocks = [], []
    gc.collect()  # (a)'s server: its memory freed now, not mid-loop
    with Server(ServeConfig(max_batch=64), device=device) as srv:
        srv.load_model("m", paths["m5"])
        srv.warmup()
        stop = threading.Event()
        bad, served = [], [0]
        lock = threading.Lock()

        def client(t):
            j = t
            while not stop.is_set():
                r = srv.submit("m", Xq[j % N_SWAP_ROWS], timeout_s=60.0)
                k = j % N_SWAP_ROWS
                with lock:
                    if not r.ok:
                        bad.append(("status", k, r.status))
                    elif r.scores != refA[k] and r.scores != refB[k]:
                        bad.append(("torn", k, float(r.scores)))
                    else:
                        served[0] += 1
                j += 4

        ts = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in ts:
            t.start()
        lat = []
        for k in range(N_SWAPS):
            old = weakref.ref(srv._worker("m")._gen)
            out = srv.swap("m", paths["m11"] if k % 2 == 0 else paths["m5"])
            lat.append(out["latency_s"])
            # swap() returns once the old generation's last in-flight
            # batch dropped it and its pool went back to the device
            check(old() is None, f"[22c] generation {k + 1} still alive "
                  "after its swap returned")
            if device != "cpu":
                mem.append(_settled_memory())
                blocks.append(_live_blocks())
        stop.set()
        for t in ts:
            t.join(60.0)
        check(not any(t.is_alive() for t in ts), "[22c] a client hung")
        gen = srv.registry.generation("m")
    check(not bad, f"[22c] {len(bad)} bad responses: {bad[:5]}")
    check(served[0] > 0, "[22c] nothing served")
    if mem:
        # swaps 2 and 8 both leave phase 5's artifact serving, 1 and 7
        # phase 11's: the same bytes must be requested
        check(mem[-1][0] == mem[1][0] and mem[-2][0] == mem[0][0],
              f"[22c] device bytes requested not flat across swaps "
              f"(requested, allocated, reserved): {mem}; allocator blocks "
              f"new at the last two reads ((bytes requested, pool, stream), "
              f"count, stack): {_new_blocks(blocks[1], blocks[-1])} "
              f"{_new_blocks(blocks[0], blocks[-2])}")
    log(f"[22c] {N_SWAPS} swaps (5 <-> 11) under 4 clients: {served[0]} "
        f"responses, every one a generation's bits, 0 lost; generation "
        f"{gen}; swap s {[round(x, 3) for x in lat]}; device memory "
        f"requested/allocated/reserved MiB after the first swap "
        f"{[round(x / 2**20, 1) for x in mem[0]] if mem else 'n/a'}, after "
        f"the last {[round(x / 2**20, 1) for x in mem[-1]] if mem else 'n/a'} "
        f"({smi})")

    # (d) refresh, with (e)'s smokes beside it
    smokes = {}
    for i, (args, line) in enumerate(SERVE_SMOKES):
        smokes[f"smoke22e_{i}"] = (_start(list(args), out_dir,
                                          f"smoke22e_{i}", device),
                                   time.perf_counter())
    n_ref = n_tr + N_APPEND
    Xr, Yr = X_all[:n_ref], Y_all[:n_ref]
    Xh, Yh = X_all[n_ref:], Y_all[n_ref:]
    acc5h = float((m5.predict(Xh) == Yh).mean())
    fits = {}
    for arm in ("warm", "cold"):
        _zero(counters)
        sync(device)
        t = time.perf_counter()
        m = refresh_fit(paths["m5"], Xr, Yr,
                        out_path=str(out_dir / f"refresh_{arm}.npz"),
                        warm=arm == "warm", solver_opts=FULL_OPTS,
                        device=device)
        sync(device)
        secs = time.perf_counter() - t
        counts = _count(counters)
        acc = float((m.predict(Xh) == Yh).mean())
        fits[arm] = (m, acc)
        if arm == "warm":
            launches.setdefault("fused_fupdate", {})["22"] = \
                counts["fused_fupdate"]
            launches.setdefault("inner_smo", {})["22"] = counts["inner_smo"]
        log(f"[22d] refresh {arm} on rows [:{n_ref}]: {secs:.3f} s, status "
            f"{m.status_.name}, updates {m.n_iter_ - 1}, rounds "
            f"{m.result_.n_outer}, SVs {m.n_support_}, b {m.b_:.15f}, "
            f"accuracy on [{n_ref}:] {acc:.4f} (phase 5 {acc5h:.4f}); "
            f"launches {counts} ({smi})")
        check(m.status_ == Status.CONVERGED, f"[22d] {arm}: {m.status_.name}")
        check(abs(acc - acc5h) <= 0.002,
              f"[22d] {arm} accuracy {acc} vs phase 5 {acc5h}")
        check(device == "cpu" or (counts["fused_fupdate"] > 0
                                  and counts["inner_smo"] > 0),
              f"[22d] {arm}: #1/#2 not launched: {counts}")
    check(fits["warm"][0].n_iter_ < fits["cold"][0].n_iter_,
          f"[22d] warm {fits['warm'][0].n_iter_} updates not below cold "
          f"{fits['cold'][0].n_iter_}")
    # the command line's refresh, on the same rows as one shard of a
    # dataset, swapped into (b)'s server over HTTP
    import shutil

    from tpusvm_torch.stream import ingest_arrays

    ds_dir = out_dir / "rows_refresh"
    shutil.rmtree(ds_dir, ignore_errors=True)
    ingest_arrays(str(ds_dir), Xr, Yr, rows_per_shard=n_ref)
    out_path = str(out_dir / "m5.npz")
    stdout, secs = _cli(["refresh", "--model", paths["m5"], "--data",
                         str(ds_dir), "--save", out_path, "--swap", url],
                        device)
    fresh = load_any(out_path, device=device)
    Xs = Xt[:N_HTTP]
    code, body = _http(f"{url}/v1/models/m5:predict",
                       {"instances": Xs.tolist()})
    check(code == 200, f"[22d] POST after the swap: {code}")
    got = np.asarray(json.loads(body)["scores"], np.float32)
    offline = np.asarray(fresh.decision_function(Xs))
    check(got.tobytes() == offline.tobytes(),
          "[22d] scores served after `refresh --swap` differ from the "
          "refreshed artifact's decision_function")
    check(got.tobytes() != want["m5"][:N_HTTP].tobytes(),
          "[22d] the swap changed no served score")
    fitted = _line(r"(refreshed model: .*)", stdout)
    swapped = _line(r"(swapped .*)", stdout)
    log(f"[22d] `refresh --swap {url}` in {secs:.1f} s: {fitted}; "
        f"{swapped}; {N_HTTP} rows served after it bit-equal to the "
        f"refreshed artifact's decision_function ({smi})")

    server_proc.terminate()
    try:
        server_proc.wait(30)
    except subprocess.TimeoutExpired:
        server_proc.kill()
        server_proc.wait()
    serve_out.close()
    serve_err.close()
    done = _finish(smokes, out_dir, 600, "22e")
    for i, (args, line) in enumerate(SERVE_SMOKES):
        text, secs = done[f"smoke22e_{i}"]
        ok = [x for x in text.splitlines() if x.startswith(line)]
        check(ok, f"[22e] {' '.join(args)}: no {line!r} line")
        log(f"[22e] python -m {' '.join(args)}: exit 0 in {secs:.1f} s "
            f"(beside (d); {smi}); {ok[-1]!r}")


# phase 23's cut: 23(a) appends N_LOOP_BATCHES batches of N_LOOP_BATCH rows,
# one a tick, under a row-growth threshold that refreshes every second
# batch; 23(b) runs N_TENANTS tenants over (C, gamma-multiple) palettes; the
# chaos gates run beside them
N_LOOP_BATCH, N_LOOP_BATCHES, LOOP_GROWTH = 1000, 5, 0.03
# 32 tenants, not 64: their two warm refreshes and roll-outs of 64 swaps
# each do not fit the run's time (PERF.md section 4); the C palette and
# the gamma multiples are the JAX tenant gate's
N_TENANTS, TENANT_C, TENANT_GAMMA = 32, (2.5, 10.0, 40.0), (0.5, 1.0, 2.0)
TENANT_GROWTH, TENANT_CKPT_EVERY, N_TENANT_ROWS = 0.05, 2, 64
# the warm refreshes' rounds redone on the float64 loop engine, at most
# this share of their lane-rounds: a seeded lane's rounds run kernel #2's
# boxed subproblem, and only a round whose violation float32 cannot
# resolve falls back
RESCUE_SHARE_MAX = 0.05
# 23(b)'s clients think 5 ms between requests: the supervisor's host loop
# over 64 lanes otherwise waits on their interpreter time
TENANT_THINK_S = 0.005
LOOP_SMOKES = ((("tpusvm_torch.faults", "autopilot-chaos-smoke"),
                "autopilot chaos smoke ok"),
               (("tpusvm_torch.faults", "tenant-chaos-smoke"),
                "tenant chaos smoke ok"))


class _LoopClients:
    """`threads` client threads send one-row requests until stopped:
    thread t takes request t, t + threads, ... of `pick(i) -> (model,
    row)`, waiting `think_s` after each answer; every answer is kept with
    its latency. `paused()` holds every thread between requests, so no
    request is in flight inside it."""

    def __init__(self, srv, pick, threads=8, think_s=0.0):
        import threading

        self.got, self.bad = [], []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._go = threading.Event()
        self._go.set()
        self._parked = [False] * threads

        def run(t):
            i = t
            while not self._stop.is_set():
                if not self._go.is_set():
                    self._parked[t] = True
                    self._go.wait(0.5)
                    continue
                name, row = pick(i)
                t0 = time.perf_counter()
                r = srv.submit(name, row[1], timeout_s=60.0)
                lat = time.perf_counter() - t0
                with self._lock:
                    if r.ok:
                        self.got.append((name, row[0], r.scores, lat,
                                         t0 - self._t0))
                    else:
                        self.bad.append((name, row[0], r.status,
                                         round(t0 - self._t0, 3)))
                i += threads
                if think_s:
                    self._stop.wait(think_s)

        # daemons: a failed gate must not leave the process waiting on them
        self._ts = [threading.Thread(target=run, args=(t,), daemon=True)
                    for t in range(threads)]
        self._t0 = time.perf_counter()
        for t in self._ts:
            t.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._stop.set()

    @contextlib.contextmanager
    def paused(self, tag):
        self._parked = [False] * len(self._parked)
        self._go.clear()
        try:
            deadline = time.perf_counter() + 60.0
            while (not all(self._parked)
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
            check(all(self._parked), f"[{tag}] the clients did not pause")
            yield
        finally:
            self._go.set()

    def stop(self, tag):
        self._stop.set()
        for t in self._ts:
            t.join(120.0)
        check(not any(t.is_alive() for t in self._ts),
              f"[{tag}] a client thread hung")
        secs = time.perf_counter() - self._t0
        lat = np.sort([g[3] for g in self.got]) if self.got else np.zeros(1)
        return {"requests": len(self.got), "secs": secs,
                "qps": len(self.got) / secs,
                "p50_ms": 1e3 * float(lat[len(lat) // 2]),
                "p99_ms": 1e3 * float(lat[min(len(lat) - 1,
                                              int(0.99 * len(lat)))])}


def _settled_memory(reads=3, gap_s=0.25, timeout_s=20.0):
    """(requested, allocated, reserved) device bytes once `reads` reads
    `gap_s` apart agree on the bytes requested (or at `timeout_s`).

    Requested bytes are what the live allocations asked for, the sum of
    their tensors' sizes; allocated bytes add the slack of the cached
    blocks that served them (a block up to 1 MiB larger than a request is
    handed out whole), which depends on the allocator's history, so the
    same model set loaded twice can read as different allocated bytes.
    Each read collects garbage first, then synchronizes and allocates
    once, which makes the caching allocator release the blocks whose
    cross-stream uses have completed: so a generation's tensors that a
    serving thread or a reference cycle lets go of only after a swap
    returned are not read as live, while memory that stays live is read
    as it is."""
    import gc

    import torch

    same, last = 0, None
    deadline = time.perf_counter() + timeout_s
    while True:
        gc.collect()
        torch.cuda.synchronize()
        torch.empty(1, device="cuda")
        cur = (torch.cuda.memory_stats()["requested_bytes.all.current"],
               torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        same = same + 1 if last is not None and cur[0] == last[0] else 1
        if same >= reads or time.perf_counter() > deadline:
            return cur
        last = cur
        time.sleep(gap_s)


def _live_blocks():
    """The caching allocator's live blocks, counted by (bytes requested,
    memory pool, stream, allocating Python stack): the stack is recorded
    only while torch.cuda.memory._record_memory_history is on, else
    empty."""
    import collections
    import os

    import torch

    out = collections.Counter()
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = tuple(f"{os.path.basename(f['filename'])}:{f['line']} "
                           f"{f['name']}" for f in blk.get("frames", ())
                           if f["filename"].endswith(".py"))[:8]
            out[(blk.get("requested_size", blk["size"]),
                 tuple(seg.get("segment_pool_id", ())),
                 seg["stream"], frames)] += 1
    return out


def _new_blocks(before, after, top=8):
    """The largest live blocks of `after` that `before` does not have."""
    new = after - before
    return [(k[:3], n, " <- ".join(k[3]) or "-")
            for k, n in sorted(new.items(), key=lambda kv: -kv[0][0])[:top]]


def _cuda_census():
    """The live CUDA tensors the collector can reach, by (shape, dtype):
    {key: bytes of their distinct storages}."""
    import collections
    import gc

    import torch

    seen, out = set(), collections.Counter()
    for o in gc.get_objects():
        try:
            if not (isinstance(o, torch.Tensor) and o.is_cuda):
                continue
            st = o.untyped_storage()
        except (ReferenceError, RuntimeError):
            continue
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        out[(tuple(o.shape), str(o.dtype))] += st.nbytes()
    return out


def _manifest_bytes(path):
    with open(path / "manifest.json", "rb") as f:
        return f.read()


def _loop_autopilot(X_all, Y_all, n_tr, acc5h, model5_path, device,
                    counters, launches, smi, out_dir):
    """23(a): the autopilot over an append-grown copy of phase 5's rows,
    with phase 5's artifact deployed in an in-process server."""
    import os
    import shutil

    from tpusvm_torch import faults
    from tpusvm_torch.autopilot import (Autopilot, AutopilotConfig,
                                        DriftThresholds)
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.serve.refresh import refresh_fit
    from tpusvm_torch.status import AutopilotStatus, Status
    from tpusvm_torch.stream import ShardWriter, ingest_arrays, open_dataset

    data, ref = out_dir / "loop_data", out_dir / "loop_ref"
    for p in (data, ref):
        shutil.rmtree(p, ignore_errors=True)
    for p in out_dir.glob("loop*.npz"):
        p.unlink()
    state = out_dir / "autopilot_state.json"
    if state.exists():
        state.unlink()
    t = time.perf_counter()
    ingest_arrays(str(data), X_all[:n_tr], Y_all[:n_tr],
                  rows_per_shard=STREAM_ROWS_PER_SHARD)
    ingest_s = time.perf_counter() - t
    n_end = n_tr + N_LOOP_BATCHES * N_LOOP_BATCH
    Xq = X_all[n_end:]
    cfg = AutopilotConfig(
        data_dir=str(data), model_path=model5_path,
        out_path=str(out_dir / "loop.npz"), state_path=str(state), name="m5",
        thresholds=DriftThresholds(growth=LOOP_GROWTH, feature=None,
                                   score=None),
        checkpoint_path=str(out_dir / "loop_ck.npz"), checkpoint_every=1,
        seed=23, device=device)
    gens = [(model5_path, n_tr)]
    fits, append_s, append_bytes = [], 0.0, 0
    kill = {}
    with Server(ServeConfig(max_batch=64), device=device) as srv:
        srv.load_model("m5", model5_path)
        srv.warmup()
        pilot = Autopilot(cfg, server=srv, log_fn=None)
        clients = _LoopClients(srv, lambda i: ("m5", (i % len(Xq),
                                                      Xq[i % len(Xq)])))
        statuses = []
        with clients:
            for k in range(N_LOOP_BATCHES):
                a = n_tr + k * N_LOOP_BATCH
                b = a + N_LOOP_BATCH
                t = time.perf_counter()
                w = ShardWriter.open_append(str(data))
                w.append(X_all[a:b], Y_all[a:b])
                w.close()
                append_s += time.perf_counter() - t
                append_bytes += X_all[a:b].nbytes + Y_all[a:b].astype(
                    np.int32).nbytes
                # the kill arm: generation 2's fit dies at its second solver
                # checkpoint, and a rebuilt supervisor resumes it
                plan = None
                if pilot.state.generation == 1 and not kill:
                    plan = faults.FaultPlan([faults.FaultRule(
                        point="solver.outer_checkpoint", kind="kill",
                        at_hit=2)], seed=0)
                _zero(counters)
                sync(device)
                t = time.perf_counter()
                try:
                    if plan is None:
                        out = pilot.tick()
                    else:
                        with faults.active(plan):
                            out = pilot.tick()
                except faults.SimulatedKill:
                    t_k = time.perf_counter()
                    kill["at_s"] = t_k - t
                    kill["checkpoint"] = os.path.exists(cfg.checkpoint_path)
                    pilot = Autopilot(cfg, server=srv, resume=True, log_fn=None)
                    out = pilot.tick()
                    kill["resume_s"] = time.perf_counter() - t_k
                sync(device)
                secs = time.perf_counter() - t
                counts = _count(counters)
                counts["inner_smo_boxed"] = counters["inner_smo"].boxed_launches
                statuses.append(out["status"])
                if out["status"] == AutopilotStatus.REFRESHED:
                    path = str(out_dir / f"loop_gen{out['generation']}.npz")
                    shutil.copyfile(cfg.out_path, path)
                    gens.append((path, out["rows"]))
                    fits.append((secs, counts))
            serving = clients.stop("23a")
    check(statuses == [AutopilotStatus.WATCHING, AutopilotStatus.REFRESHED,
                       AutopilotStatus.WATCHING, AutopilotStatus.REFRESHED,
                       AutopilotStatus.WATCHING],
          f"[23a] tick statuses {[s.name for s in statuses]}")
    check(kill.get("checkpoint"), f"[23a] the kill arm did not die at a "
          f"durable checkpoint: {kill}")
    # the grown dataset is a one-shot ingest of the rows it holds
    ingest_arrays(str(ref), X_all[:n_end], Y_all[:n_end],
                  rows_per_shard=STREAM_ROWS_PER_SHARD)
    ds = open_dataset(str(data))
    check(_manifest_bytes(data) == _manifest_bytes(ref)
          and all(s.name == "OK" for s in ds.validate()),
          "[23a] the grown dataset differs from a one-shot ingest")
    # each generation is a direct refresh_fit of its donor on its rows
    offline = {}
    for g in range(1, len(gens)):
        (donor, _), (path, rows) = gens[g - 1], gens[g]
        direct = refresh_fit(donor, X_all[:rows], Y_all[:rows],
                             out_path=str(out_dir / "loop_direct.npz"),
                             device=device)
        got = BinarySVC.load(path, device=device)
        check(direct.status_ == Status.CONVERGED,
              f"[23a] generation {g}: {direct.status_.name}")
        check(_same_bits(got, direct), f"[23a] generation {g} differs from "
              "a direct refresh_fit of its donor")
        secs, counts = fits[g - 1]
        acc = float((direct.predict(X_all[n_end:]) == Y_all[n_end:]).mean())
        if g == 2:
            check(abs(acc - acc5h) <= 0.002,
                  f"[23a] generation 2 accuracy {acc} vs phase 5 {acc5h}")
        check(device == "cpu" or (counts["fused_fupdate"] > 0
                                  and counts["inner_smo_boxed"] > 0),
              f"[23a] generation {g}: #1/#2's boxed subproblem not "
              f"launched: {counts}")
        for k in ("fused_fupdate", "inner_smo"):
            launches.setdefault(k, {})[f"23a gen{g}"] = counts[k]
        log(f"[23a] generation {g} on rows [:{rows}] (seeded by "
            f"{'phase 5' if g == 1 else f'generation {g - 1}'}): tick "
            f"{secs:.3f} s (read, refit, save, swap{', killed and resumed' if g == 2 else ''}), "
            f"status {direct.status_.name}, rounds {direct.result_.n_outer}, "
            f"updates {direct.n_iter_ - 1}, rounds redone on the loop engine "
            f"{direct.result_.n_rescue}, SVs {direct.n_support_}, b "
            f"{direct.b_:.15f}, accuracy on [{n_end}:] {acc:.4f} (phase 5 "
            f"{acc5h:.4f}); launches #1 {counts['fused_fupdate']}, #2 "
            f"{counts['inner_smo']} ({counts['inner_smo_boxed']} boxed); "
            f"bit-equal to a direct refresh_fit ({smi})")
        offline[g] = np.asarray(got.decision_function(Xq))
    offline[0] = np.asarray(BinarySVC.load(
        model5_path, device=device).decision_function(Xq))
    torn = [(i, s) for _, i, s, _, _ in clients.got
            if not any(s == offline[g][i] for g in offline)]
    check(not clients.bad and not torn, f"[23a] {len(clients.bad)} failed and "
          f"{len(torn)} torn responses: {clients.bad[:3]} {torn[:3]}")
    log(f"[23a] the loop: ingest of [:{n_tr}] {ingest_s:.2f} s; "
        f"{N_LOOP_BATCHES} appends of {N_LOOP_BATCH} rows in "
        f"{append_s:.3f} s = {append_bytes / append_s / 1e6:.1f} MB/s, the "
        f"grown manifest the one-shot ingest's bytes; statuses "
        f"{[s.name for s in statuses]}; kill arm: generation 2 killed at its "
        f"second checkpoint after {kill['at_s']:.3f} s, resumed in "
        f"{kill['resume_s']:.3f} s, bit-equal; {serving['requests']} one-row "
        f"requests from 8 clients in {serving['secs']:.3f} s = "
        f"{serving['qps']:.0f}/s, p50 {serving['p50_ms']:.3f} ms, p99 "
        f"{serving['p99_ms']:.3f} ms, each one generation's bits ({smi})")


def _tenant_records(n, gamma):
    from tpusvm_torch.tenants import TenantRecord

    # the JAX tenant gate's layout (tpusvm/faults/__main__.py): a (C,
    # gamma) palette, every eighth tenant a two-way row subset
    return [TenantRecord(
        tenant_id=f"t{i:02d}", positive_label=i % 10, C=TENANT_C[i % 3],
        gamma=TENANT_GAMMA[(i // 3) % 3] * gamma,
        row_mod=2 if i % 8 == 7 else None,
        row_ofs=(i // 8) % 2 if i % 8 == 7 else 0) for i in range(n)]


def _loop_tenants(Xm, lm, n_tr, gamma, n_tenants, device, counters,
                  launches, smi, out_dir):
    """23(b): n_tenants tenants over phase 8's ten-class rows: one cold
    fleet provision, every tenant served, then the coalesced warm refresh
    twice, a control arm and an arm killed at its second fleet checkpoint
    and resumed, each rolled out into the server under client load."""
    import dataclasses
    import gc
    import shutil
    from pathlib import Path

    import torch

    import tpusvm_torch.tenants.loop as tenants_loop
    from tpusvm_torch import faults
    from tpusvm_torch.autopilot import DriftThresholds
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.status import TenantsStatus
    from tpusvm_torch.stream import ShardWriter, ingest_arrays, open_dataset
    from tpusvm_torch.tenants import (TenantsConfig, TenantsSupervisor,
                                      provision_tenants, tenant_labels,
                                      view_fingerprint)

    for p in out_dir.glob("tenants_*"):
        shutil.rmtree(p) if p.is_dir() else p.unlink()
    data = {arm: out_dir / f"tenants_data_{arm}" for arm in ("c", "k")}
    ingest_arrays(str(data["c"]), Xm[:n_tr], lm[:n_tr],
                  rows_per_shard=STREAM_ROWS_PER_SHARD)
    shutil.copytree(data["c"], data["k"])
    donors = out_dir / "tenants_donors"
    recs = _tenant_records(n_tenants, gamma)
    tids = [r.tenant_id for r in recs]
    _zero(counters)
    sync(device)
    t = time.perf_counter()
    # the JAX gate's template, SVMConfig(): a budget of 10^5 updates a lane
    # (a C=40 lane at gamma <= 1/d needs more than 10^6 at this width and
    # ends MAX_ITER at its budget: PERF.md section 4)
    prov = provision_tenants(Xm[:n_tr], lm[:n_tr], recs,
                             artifacts_dir=str(donors), config=SVMConfig(),
                             solver_opts=OVR_OPTS, device=device)
    sync(device)
    cold = (time.perf_counter() - t, _count(counters), prov)
    by_c = {c: sorted({prov[r.tenant_id]["status"].name for r in recs
                       if r.C == c}) for c in TENANT_C}
    log(f"[23b] provisioned {n_tenants} tenants in {cold[0]:.3f} s (a "
        f"budget of {SVMConfig().max_iter} updates a lane): rounds "
        f"{max(o['n_outer'] for o in prov.values())}, statuses by C {by_c}, "
        f"per tenant (C, rounds, updates, rescued rounds) "
        f"{[(r.C, prov[r.tenant_id]['n_outer'], prov[r.tenant_id]['n_iter'] - 1, prov[r.tenant_id]['n_rescue']) for r in recs]}")
    n_end = n_tr + N_APPEND
    Xq = Xm[n_end:n_end + N_TENANT_ROWS]
    # every generation's offline scores of the query rows, by tenant
    ref = {tid: [np.asarray(BinarySVC.load(
        str(donors / f"{tid}.npz"), device=device).decision_function(Xq))]
        for tid in tids}
    outcomes = {}
    refresh = tenants_loop.refresh_drifted

    def recording(*a, **kw):
        t0 = time.perf_counter()
        out = refresh(*a, **kw)
        outcomes[kw["artifacts_dir"]] = out
        log(f"[23b] the coalesced refresh of {len(out)} tenants in "
            f"{time.perf_counter() - t0:.3f} s: rounds "
            f"{max(o['n_outer'] for o in out.values())}, updates "
            f"{sum(o['n_iter'] - 1 for o in out.values())}")
        return out

    tenants_loop.refresh_drifted = recording
    mem, census, blocks, runs, kill = [], [], [], {}, {}
    gc.collect()
    try:
        with Server(ServeConfig(max_batch=64), device=device) as srv:
            swaps = []
            swap = srv.swap

            def timed_swap(name, path):
                out = swap(name, path)
                swaps.append(out["latency_s"])
                if len(swaps) in (1, 64, 65, 128):
                    log(f"[23b] swap {len(swaps)} done at "
                        f"{time.perf_counter() - clients._t0:.3f} s")
                if len(swaps) % 16 == 0:
                    log(f"[23b] {len(swaps)} swaps, {sum(swaps):.3f} s in "
                        f"all, the longest {max(swaps):.3f} s")
                return out

            srv.swap = timed_swap
            t = time.perf_counter()
            for r in recs:
                srv.load_model(r.tenant_id, r.model_path)
            srv.warmup()
            host_s = time.perf_counter() - t
            log(f"[23b] {n_tenants} tenants hosted in {host_s:.3f} s")
            clients = _LoopClients(srv, lambda i: (
                tids[(7 * i + i // len(tids)) % len(tids)],
                (i % len(Xq), Xq[i % len(Xq)])), think_s=TENANT_THINK_S)
            with clients:
                marks = []
                for arm in ("c", "k"):
                    # the kill arm's append dies at its second journal write
                    # and is resumed by replaying its batch
                    plan = faults.FaultPlan([faults.FaultRule(
                        point="stream.append", kind="kill", at_hit=2)], seed=0)
                    for attempt in range(2):
                        try:
                            with faults.active(plan if arm == "k" else
                                               faults.FaultPlan([], seed=0)):
                                w = ShardWriter.open_append(str(data[arm]),
                                                            resume=attempt > 0)
                                w.append(Xm[n_tr:n_end], lm[n_tr:n_end])
                                w.close()
                            break
                        except faults.SimulatedKill:
                            kill["append"] = True
                    cfg = TenantsConfig(
                        data_dir=str(data[arm]),
                        store_path=str(out_dir / f"tenants_store_{arm}.json"),
                        artifacts_dir=str(out_dir / f"tenants_models_{arm}"),
                        thresholds=DriftThresholds(growth=TENANT_GROWTH,
                                                   feature=None, score=None),
                        checkpoint_every=TENANT_CKPT_EVERY, seed=23,
                        solver_opts=OVR_OPTS, device=device)
                    say = lambda m: log(f"[23b] arm {arm}: {m}")  # noqa: E731
                    marks.append((f"arm {arm}",
                                  round(time.perf_counter() - clients._t0, 3)))
                    sup = TenantsSupervisor(cfg, server=srv, log_fn=say)
                    for r in recs:
                        sup.register(dataclasses.replace(r))
                    _zero(counters)
                    sync(device)
                    t = t_k = time.perf_counter()
                    if arm == "k":
                        # tenants.store hit 1 is the stage="fitting" commit,
                        # hits 2.. the fleet checkpoints: hit 3 dies at the
                        # second segment's checkpoint write
                        plan = faults.FaultPlan([faults.FaultRule(
                            point="tenants.store", kind="kill", at_hit=3)],
                            seed=0)
                        try:
                            with faults.active(plan):
                                sup.tick()
                        except faults.SimulatedKill:
                            t_k = time.perf_counter()
                            kill["at_s"] = t_k - t
                            kill["checkpoint"] = bool(list(Path(
                                cfg.artifacts_dir).glob("fleet_*.ck.npz")))
                            sup = TenantsSupervisor(cfg, server=srv, resume=True,
                                                    log_fn=say)
                    out = sup.tick()
                    if arm == "k":
                        kill["resume_s"] = time.perf_counter() - t_k
                    sync(device)
                    secs = time.perf_counter() - t
                    boxed = counters["inner_smo_batched"].boxed_launches
                    # (a resumed tick finishes the persisted launch and
                    # reports no fresh drift)
                    done = outcomes.get(cfg.artifacts_dir, {})
                    check(out["status"] == TenantsStatus.REFRESHED
                          and sorted(done) == tids
                          and not any("error" in o for o in done.values()),
                          f"[23b] arm {arm}: {out['status'].name}, "
                          f"{len(done)} of {len(tids)} refreshed")
                    if device != "cpu":
                        # read with no request in flight (no capture runs in
                        # this thread now, and serving captures none)
                        with clients.paused(f"23b arm {arm}"):
                            mem.append(_settled_memory())
                            census.append(_cuda_census())
                            blocks.append(_live_blocks())
                    counts = _count(counters)
                    counts["inner_smo_batched_boxed"] = boxed
                    runs[arm] = (secs, counts, outcomes[cfg.artifacts_dir],
                                 cfg, sup)
                    log(f"[23b] arm {arm} refreshed and rolled out in "
                        f"{secs:.3f} s")
                serving = clients.stop("23b")
    finally:
        tenants_loop.refresh_drifted = refresh
    check(kill.get("append") and kill.get("checkpoint"),
          f"[23b] the kill arm's kills did not fire as planned: {kill}")
    labels = {arm: open_dataset(str(data[arm])).load_labels()
              for arm in data}
    (_, _, out_c, cfg_c, _), (_, _, out_k, cfg_k, _) = runs["c"], runs["k"]
    for r in recs:
        tid = r.tenant_id
        a = BinarySVC.load(out_c[tid]["out_path"], device=device)
        b = BinarySVC.load(out_k[tid]["out_path"], device=device)
        check(_same_bits(a, b) and out_c[tid]["n_iter"] == out_k[tid]["n_iter"],
              f"[23b] {tid}: the recovered refit differs from the control")
        check(view_fingerprint(*tenant_labels(labels["c"], r))
              == view_fingerprint(*tenant_labels(labels["k"], r)),
              f"[23b] {tid}: the view fingerprints differ")
        ref[tid].append(np.asarray(a.decision_function(Xq)))
    torn = [(n, i, round(t, 3)) for n, i, s, _, t in clients.got
            if not any(s == g[i] for g in ref[n])]
    check(not clients.bad and not torn, f"[23b] {len(clients.bad)} failed and "
          f"{len(torn)} torn responses (seconds since the clients started; "
          f"{marks}, the refresh/roll-out lines above): {clients.bad[:8]} "
          f"{torn[:8]} ... {torn[-4:]}")
    left = [p for cfg in (cfg_c, cfg_k)
            for p in Path(cfg.artifacts_dir).glob("*.ck.npz")]
    check(not left, f"[23b] fleet checkpoints left after the roll-out: {left}")
    for label, (secs, counts, outs) in (("cold provision", cold),
                                        ("warm control", runs["c"][:3]),
                                        ("warm, killed and resumed",
                                         runs["k"][:3])):
        check(device == "cpu" or (counts["fused_fupdate_batched"] > 0
                                  and counts["inner_smo_batched"] > 0),
              f"[23b] {label}: 1b/2b not launched: {counts}")
        rescued = sum(o["n_rescue"] for o in outs.values())
        lane_rounds = sum(o["n_outer"] for o in outs.values())
        share = rescued / max(lane_rounds, 1)
        if label.startswith("warm"):
            check(device == "cpu" or counts["inner_smo_batched_boxed"] > 0,
                  f"[23b] {label}: no 2b launch with boxed lanes: {counts}")
            check(share <= RESCUE_SHARE_MAX, f"[23b] {label}: {rescued} of "
                  f"{lane_rounds} lane-rounds redone on the loop engine "
                  f"({share:.3f} > {RESCUE_SHARE_MAX})")
        # the solo #1 launches are the seeded lanes' f rebuilds
        for k in ("fused_fupdate_batched", "inner_smo_batched",
                  "fused_fupdate", "inner_smo"):
            launches.setdefault(k, {})[f"23b {label}"] = counts[k]
        sts = [o["status"].name for o in outs.values()]
        log(f"[23b] {label} of {n_tenants} tenants on rows "
            f"[:{n_tr if label.startswith('cold') else n_end}]: {secs:.3f} s, "
            f"rounds {max(o['n_outer'] for o in outs.values())}, updates "
            f"{sum(o['n_iter'] - 1 for o in outs.values())}, statuses "
            f"{ {s: sts.count(s) for s in sorted(set(sts))} }, SVs "
            f"{sum(o['sv_count'] for o in outs.values())}; lane-rounds "
            f"{lane_rounds}, of them redone on the loop engine {rescued} "
            f"({100 * share:.2f}%); launches 1b "
            f"{counts['fused_fupdate_batched']}, 2b "
            f"{counts['inner_smo_batched']} "
            f"({counts.get('inner_smo_batched_boxed', 0)} with boxed lanes), "
            f"#1 {counts['fused_fupdate']}, #2 {counts['inner_smo']} ({smi})")
    if mem:
        grown = sorted(((v - census[0].get(k, 0), k) for k, v in
                        census[1].items() if v > census[0].get(k, 0)),
                       reverse=True)
        check(mem[1][0] <= mem[0][0], f"[23b] device bytes requested after "
              f"the last roll-out above the first's (requested, allocated, "
              f"reserved): {mem}; live CUDA tensors grown "
              f"(bytes, (shape, dtype)): {grown[:8]}; allocator blocks new "
              f"((bytes requested, pool, stream), count, stack): "
              f"{_new_blocks(blocks[0], blocks[1])}")
    log(f"[23b] {n_tenants} tenants hosted in {host_s:.3f} s; kill arm: its "
        f"append killed and resumed, its refresh killed at the second "
        f"fleet checkpoint after {kill['at_s']:.3f} s and resumed in "
        f"{kill['resume_s']:.3f} s, every tenant bit-equal to the control "
        f"(alphas, SV IDs, b, updates), view fingerprints equal, checkpoints "
        f"reaped; {serving['requests']} one-row requests from 8 clients in "
        f"{serving['secs']:.3f} s = {serving['qps']:.0f}/s, p50 "
        f"{serving['p50_ms']:.3f} ms, p99 {serving['p99_ms']:.3f} ms, each "
        f"one generation's bits; device memory requested/allocated/reserved "
        f"MiB after "
        f"the first and the last roll-out "
        f"{[[round(x / 2**20, 1) for x in m] for m in mem] or 'n/a'} ({smi})")


def phase_closed_loop(X_all, Y_all, n_tr, m5, model5_path, Xm, lm, gamma,
                      device, counters, launches, smi, out_dir,
                      n_tenants=N_TENANTS):
    """Phase 23, the closed loop at full width (tpusvm_torch.autopilot,
    tpusvm_torch.tenants):

    (a) phase 5's artifact served in-process; the autopilot over a fresh
        dataset of its training rows grown by N_LOOP_BATCHES appends of
        N_LOOP_BATCH held-out rows, one a tick (growth threshold
        LOOP_GROWTH): two chained warm refreshes swap in (generation 1 on
        62,000 rows seeded by phase 5's model, generation 2 on 64,000
        seeded by generation 1's, killed at its second solver checkpoint
        and resumed by a rebuilt supervisor), while 8 one-row clients
        score the last held-out rows: the grown dataset is a one-shot
        ingest's, each generation is a direct refresh_fit of its donor
        bit for bit and CONVERGED, #1 and #2 launched in each refresh,
        generation 2 within 0.002 of phase 5's accuracy, every response a
        complete generation's bits;
    (b) n_tenants tenants over phase 8's rows (a C palette, gamma
        multiples of `gamma`, every eighth a row subset): one cold fleet
        provision, every tenant served, then the coalesced warm refresh
        over the grown rows twice, a control and an arm killed at its
        second fleet checkpoint and resumed, each rolled out under 8
        one-row clients: bits, fingerprints, reaped checkpoints, flat
        memory, 1b and 2b launched;
    (c) autopilot-chaos-smoke and tenant-chaos-smoke as subprocesses
        beside (a) and (b), each exiting 0."""
    import atexit

    out_dir.mkdir(parents=True, exist_ok=True)
    smokes = {f"smoke23c_{i}": (_start(list(args), out_dir, f"smoke23c_{i}",
                                       device), time.perf_counter())
              for i, (args, _) in enumerate(LOOP_SMOKES)}
    # a failed gate must not leave them running
    atexit.register(lambda: [p.kill() for p, _ in smokes.values()
                             if p.poll() is None])
    acc5h = float((m5.predict(X_all[n_tr + N_LOOP_BATCHES * N_LOOP_BATCH:])
                   == Y_all[n_tr + N_LOOP_BATCHES * N_LOOP_BATCH:]).mean())
    t = time.perf_counter()
    _loop_autopilot(X_all, Y_all, n_tr, acc5h, model5_path, device,
                    counters, launches, smi, out_dir)
    log(f"[23a] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _loop_tenants(Xm, lm, n_tr, gamma, n_tenants, device, counters, launches,
                  smi, out_dir)
    log(f"[23b] {time.perf_counter() - t:.1f} s")
    done = _finish(smokes, out_dir, 600, "23c")
    for i, (args, line) in enumerate(LOOP_SMOKES):
        text, secs = done[f"smoke23c_{i}"]
        ok = [x for x in text.splitlines() if x.startswith(line)]
        check(ok, f"[23c] {' '.join(args)}: no {line!r} line")
        log(f"[23c] python -m {' '.join(args)}: exit 0 in {secs:.1f} s "
            f"(beside (a) and (b); {smi}); {ok[-1]!r}")

# phase 24's shape: N_ROUTER_REPLICAS replica processes of phase 5's model
# behind a router of replication 2; N_ROUTER_CLIENTS one-row clients, first
# a load through the router that runs through the kill, the revive and the
# rollout, then N_ROUTER_HOP requests straight to the placed replica and
# the same through the router (the router's hop); generation 2 is a warm
# refresh on rows [:n_tr + N_ROUTER_APPEND]
N_ROUTER_REPLICAS, N_ROUTER_CLIENTS, N_ROUTER_HOP = 3, 8, 1000
N_ROUTER_APPEND = 2000
ROUTER_SMOKES = ((("tpusvm_torch.faults", "router-chaos-smoke"),
                  "router chaos smoke ok"),)


def start_router_smokes(device, out_dir):
    """24(e)'s chaos gate as a background process: {name: (process, start
    time)}. Each runs in a process group of its own, which exit kills
    whole: a gate stopped midway leaves no replica process behind."""
    import atexit
    import os
    import signal

    out_dir.mkdir(parents=True, exist_ok=True)
    root = str(Path(__file__).resolve().parent)
    smokes = {}
    for i, (args, _) in enumerate(ROUTER_SMOKES):
        name = f"smoke24e_{i}"
        argv = [sys.executable, "-m", *args]
        if device == "cpu":
            argv += ["--device", "cpu"]
        with open(out_dir / f"{name}.out", "w") as o, \
                open(out_dir / f"{name}.err", "w") as e:
            p = subprocess.Popen(argv, cwd=root, stdout=o, stderr=e,
                                 env=dict(os.environ, PYTHONPATH=root),
                                 start_new_session=True)
        smokes[name] = (p, time.perf_counter())

    def kill_groups():
        for p, _ in smokes.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    atexit.register(kill_groups)
    return smokes


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def _one_row_clients(url, rows, threads, want, stop=None, done_after=None):
    """`threads` clients POST one row a request to `url` + the predict
    route, thread t the rows t::threads, until every row is sent (`stop`
    None) or `stop` is set (then they cycle). Each response is checked
    against `want(i, sent_at)`, the scores it may carry. Returns (ok count,
    bad list, latencies s, seconds)."""
    import threading
    import urllib.error
    import urllib.request

    bad, lat, ok = [], [], [0]
    lock = threading.Lock()

    def run(t):
        i = t
        while (i < len(rows)) if stop is None else not stop.is_set():
            k = i % len(rows)
            body = json.dumps({"instances": [rows[k]]}).encode()
            req = urllib.request.Request(
                url + "/v1/models/m:predict", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120.0) as r:
                    code, raw = r.status, r.read()
            except urllib.error.HTTPError as e:
                code, raw = e.code, e.read()
            except Exception as e:  # noqa: BLE001 — a transport failure
                # to the front door is a lost response
                code, raw = None, f"{type(e).__name__}: {e}".encode()
            dt = time.perf_counter() - t0
            with lock:
                if code != 200:
                    bad.append(("lost", k, code, raw[:200]))
                else:
                    s = np.float32(json.loads(raw)["scores"][0])
                    if s not in want(k, t0):
                        bad.append(("bits", k, float(s)))
                    else:
                        ok[0] += 1
                        lat.append(dt)
            i += threads

    ts = [threading.Thread(target=run, args=(t,), daemon=True)
          for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    if done_after is not None:
        done_after()
    for t in ts:
        t.join(300.0)
    secs = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "[24] a client thread hung")
    return ok[0], bad, lat, secs


def _card_mib():
    """The card's memory in use in MiB, from nvidia-smi (every process on
    it; per-process rows name the container's pids as 1)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def _trace_lines(path):
    """(records, torn lines) of one trace file: a line that is not a JSON
    record is counted (a SIGKILL can cut the last one), with its number."""
    recs, torn = [], []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            recs.append(json.loads(line))
        except ValueError:
            torn.append((i, len(lines)))
    return recs, torn


def phase_router(X_all, Y_all, n_tr, model5_path, device, counters,
                 launches, smi, out_dir):
    """Phase 24, the router (tpusvm_torch.router) in front of
    N_ROUTER_REPLICAS `python -m tpusvm_torch serve --port P --state ...
    --trace ...` replica processes on the card (P free and below the
    kernel's ephemeral range: serve/http.py revivable_ports), each hosting
    phase 5's artifact, warmed, with (e) running beside (a)-(b):

    (a) the in-process Router (replication 2) and its HTTP front; 8
        one-row clients on the held-out rows through the router while the
        placed replica is SIGKILLed and revived on its recorded port with
        its replica id: no response lost, every score bit-equal to one
        generation's decision_function on the card, router.failovers > 0;
        once (e) has ended, N_ROUTER_HOP requests from the same clients
        straight to the placed replica and the same through the router
        (requests/s and p50/p99: the router's hop);
    (b) generation 2, a warm refresh of phase 5's artifact on rows
        [:n_tr + N_ROUTER_APPEND] (#1 and #2 launched, counted), rolled
        out staggered under (a)'s load: each replica swapped once, a
        uniform skew-free final generation vector, and requests sent after
        the rollout returned get generation 2's bits;
    (c) every complete serve.request span a replica wrote for a routed
        request resolves to a router.forward span of the router's trace
        (role router); a killed replica's torn last line is counted;
    (d) `fleet-metrics --router URL --format json` equals merge_fleet of
        the per-process payloads scraped directly, `top --once` prints one
        row per process; the replicas' device MiB;
    (e) router-chaos-smoke as a subprocess, started with the phase (beside
        23(c)'s gates it slowed phase 23 by a third: PERF.md section 4),
        exits 0."""
    import atexit
    import os
    import shutil
    import threading
    import urllib.request

    import torch

    from tpusvm_torch.models import load_any
    from tpusvm_torch.obs.fleet import merge_fleet
    from tpusvm_torch.obs.registry import MetricsRegistry
    from tpusvm_torch.obs.trace import Tracer
    from tpusvm_torch.router import Router, RouterConfig, make_router_http
    from tpusvm_torch.serve.http import revivable_ports, start_http_thread
    from tpusvm_torch.serve.refresh import refresh_fit
    from tpusvm_torch.status import RouterStatus, Status

    shutil.rmtree(out_dir / "replicas", ignore_errors=True)
    (out_dir / "replicas").mkdir(parents=True)
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    procs, logs, traces = [], [], [[] for _ in range(N_ROUTER_REPLICAS)]
    if device != "cpu":
        sync(device)
        mem0 = (_card_mib(), torch.cuda.memory_reserved() / 2**20)
    smokes = start_router_smokes(device, out_dir)

    def state(i):
        return out_dir / "replicas" / f"rep{i}" / "serve_state.json"

    def spawn(i, port, first=True):
        state(i).parent.mkdir(parents=True, exist_ok=True)
        traces[i].append(out_dir / "replicas"
                         / f"rep{i}.{len(traces[i])}.jsonl")
        argv = [sys.executable, "-m", "tpusvm_torch", "serve", "--port",
                str(port), "--state", str(state(i)), "--trace",
                str(traces[i][-1])]
        if first:
            argv += ["--model", f"m={model5_path}"]
        if device == "cpu":
            argv += ["--device", "cpu"]
        log = open(out_dir / "replicas" / f"rep{i}.log", "ab")
        logs.append(log)
        return subprocess.Popen(argv, cwd=root, stdout=log,
                                stderr=subprocess.STDOUT, env=env)

    def wait_ready(i, deadline_s=240.0):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < deadline_s:
            check(procs[i].poll() is None, f"[24] replica {i} exited:\n"
                  + (out_dir / "replicas" / f"rep{i}.log").read_text()[-2000:])
            try:
                st = json.loads(state(i).read_text())
                if st.get("address") and st.get("models"):
                    url = f"http://{st['address']}"
                    code, body = _http(url + "/healthz", timeout=5.0)
                    if code == 200 and json.loads(body)["status"] == "ok":
                        return url, st["replica_id"]
            except (OSError, ValueError):
                pass
            time.sleep(0.1)
        check(False, f"[24] replica {i} not serving within {deadline_s} s")

    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    t_spawn = time.perf_counter()
    # ports below the kernel's ephemeral range: a dead replica's port
    # cannot be taken meanwhile as a connection's local port, so the
    # revive on its recorded port binds
    procs.extend(spawn(i, port) for i, port in
                 enumerate(revivable_ports(N_ROUTER_REPLICAS)))

    # (b)'s generation 2, made while the replicas start
    n_ref = n_tr + N_ROUTER_APPEND
    gen2_path = str(out_dir / "gen2.npz")
    _zero(counters)
    sync(device)
    t = time.perf_counter()
    g2 = refresh_fit(model5_path, X_all[:n_ref], Y_all[:n_ref],
                     out_path=gen2_path, warm=True, solver_opts=FULL_OPTS,
                     device=device)
    sync(device)
    refresh_s = time.perf_counter() - t
    counts = _count(counters)
    launches.setdefault("fused_fupdate", {})["24"] = counts["fused_fupdate"]
    launches.setdefault("inner_smo", {})["24"] = counts["inner_smo"]
    check(g2.status_ == Status.CONVERGED, f"[24b] refresh: {g2.status_.name}")
    check(device == "cpu" or (counts["fused_fupdate"] > 0
                              and counts["inner_smo"] > 0),
          f"[24b] refresh: #1/#2 not launched: {counts}")
    log(f"[24b] generation 2: warm refresh of phase 5 on rows [:{n_ref}] in "
        f"{refresh_s:.3f} s, status {g2.status_.name}, rounds "
        f"{g2.result_.n_outer}, updates {g2.n_iter_ - 1}, SVs "
        f"{g2.n_support_}; launches {counts} ({smi})")

    Xq = X_all[n_tr:]
    rows = [r.tolist() for r in np.asarray(Xq, np.float64)]
    gens = [np.asarray(load_any(p, device=device).decision_function(Xq))
            for p in (model5_path, gen2_path)]
    check(gens[0].tobytes() != gens[1].tobytes(),
          "[24] the generations' scores are equal: the bit check is vacuous")

    ready = [wait_ready(i) for i in range(N_ROUTER_REPLICAS)]
    start_s = time.perf_counter() - t_spawn
    urls = [u for u, _ in ready]
    ids = dict(ready)
    rtrace = out_dir / "replicas" / "router.jsonl"
    tracer = Tracer(str(rtrace), role="router")
    reg = MetricsRegistry()
    router = Router(RouterConfig(replicas=tuple(urls), replication=2, seed=7,
                                 poll_interval_s=0.2, down_after=2,
                                 forward_timeout_s=120.0),
                    registry=reg, log_fn=None, tracer=tracer).start()
    httpd = make_router_http(router, port=0)
    router.attach_http(httpd, start_http_thread(httpd))
    front = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    placed = router.replica_set.placement("m")
    log(f"[24a] {N_ROUTER_REPLICAS} replicas ready {start_s:.1f} s after "
        f"their start (beside the refresh and (e)): {urls}; router at "
        f"{front}, placement of m {list(placed)}")

    def metric(name):
        return sum(m["value"] for m in reg.snapshot()["metrics"]
                   if m["name"] == name)

    # (a) and (b): one load through the kill, the revive and the rollout
    stop = threading.Event()
    rolled = [None]  # when the rollout returned
    events = {}

    def want(k, t0):
        if rolled[0] is not None and t0 > rolled[0]:
            return (gens[1][k],)
        return (gens[0][k], gens[1][k])

    def chaos():
        try:
            _chaos()
        finally:
            stop.set()  # the clients stop whatever the gates said

    def _chaos():
        n0 = metric("router.requests")
        while metric("router.requests") < n0 + 500:
            time.sleep(0.01)
        dark = urls.index(placed[0])
        port = int(json.loads(state(dark).read_text())["address"]
                   .rsplit(":", 1)[1])
        t0 = time.perf_counter()
        procs[dark].kill()  # a real SIGKILL: nothing flushed, no close
        procs[dark].wait()
        events["killed_at"] = metric("router.requests")
        procs[dark] = spawn(dark, port, first=False)
        url, rid = wait_ready(dark)
        events["revive_s"] = time.perf_counter() - t0
        check(url == urls[dark], f"[24a] replica {dark} revived on {url}, "
              f"not {urls[dark]}")
        check(rid == ids[urls[dark]], f"[24a] replica {dark} revived as "
              f"{rid}, not {ids[urls[dark]]}")
        deadline = time.perf_counter() + 30.0
        while any(s != "ok" for s in router.poller.states().values()):
            check(time.perf_counter() < deadline,
                  f"[24a] the poller did not re-admit the revived replica: "
                  f"{router.poller.states()}")
            time.sleep(0.05)
        events["dark"] = dark
        t0 = time.perf_counter()
        events["rollout"] = router.rollout("m", gen2_path)
        rolled[0] = time.perf_counter()
        events["rollout_s"] = rolled[0] - t0
        time.sleep(1.0)  # traffic on generation 2 alone

    ok, bad, lat, secs = _one_row_clients(front, rows, N_ROUTER_CLIENTS, want,
                                          stop=stop, done_after=chaos)
    out = events["rollout"]
    rep = out["report"]
    failovers, retries = metric("router.failovers"), metric("router.retries")
    check(not bad, f"[24a] {len(bad)} lost or off-generation responses: "
          f"{bad[:5]}")
    check(failovers > 0, "[24a] the kill never exercised failover "
          "(router.failovers == 0)")
    check(out["status"] == RouterStatus.OK.name and not out["failed"]
          and sorted(out["swapped"]) == sorted(urls) and not out["skipped"],
          f"[24b] rollout: {out}")
    check(rep["skew"] == 0 and not rep["unknown"]
          and set(rep["vector"].values()) == {2},
          f"[24b] final generation vector not uniform at 2: {rep}")
    log(f"[24a] through the kill and revive of replica {events['dark']} "
        f"(the placed one, killed after {events['killed_at']:.0f} routed "
        f"requests) and the rollout, beside (e): {ok} responses, 0 lost, "
        f"every one a generation's bits, {ok / secs:.0f} requests/s over "
        f"{secs:.1f} s, p50 {_pct(lat, 50) * 1e3:.3f} ms, p99 "
        f"{_pct(lat, 99) * 1e3:.3f} ms; failovers {failovers:.0f}, retries "
        f"{retries:.0f}; revive {events['revive_s']:.1f} s (SIGKILL to "
        f"/healthz ok, same address and replica id) ({smi})")
    log(f"[24b] staggered rollout to generation 2 in "
        f"{events['rollout_s']:.3f} s under the load: swapped "
        f"{len(out['swapped'])} of {len(urls)} once each, final vector "
        f"{rep['vector']}, skew {rep['skew']} ({smi})")

    # (e) the chaos gate, running since the phase began
    done = _finish(smokes, out_dir, 600, "24e")
    for i, (args, line) in enumerate(ROUTER_SMOKES):
        text, secs = done[f"smoke24e_{i}"]
        ok_lines = [x for x in text.splitlines() if x.startswith(line)]
        check(ok_lines, f"[24e] {' '.join(args)}: no {line!r} line")
        log(f"[24e] python -m {' '.join(args)}: exit 0 in {secs:.1f} s "
            f"(beside (a) and (b); {smi}); {ok_lines[-1]!r}")

    # (a) the router's hop, with (e) ended: the same clients straight to
    # the placed replica, then through the router
    hop = {}
    for arm, url in (("direct", placed[0]), ("router", front)):
        n_ok, bad, lat, secs = _one_row_clients(
            url, rows[:N_ROUTER_HOP], N_ROUTER_CLIENTS,
            lambda k, t0: (gens[1][k],))
        check(not bad and n_ok == N_ROUTER_HOP,
              f"[24a] {arm}: {len(bad)} bad responses: {bad[:5]}")
        hop[arm] = (n_ok / secs, _pct(lat, 50) * 1e3, _pct(lat, 99) * 1e3)
    log(f"[24a] {N_ROUTER_HOP} one-row requests from {N_ROUTER_CLIENTS} "
        f"clients, every score generation 2's bits: straight to the placed "
        f"replica {hop['direct'][0]:.0f} requests/s, p50 "
        f"{hop['direct'][1]:.3f} ms, p99 {hop['direct'][2]:.3f} ms; through "
        f"the router {hop['router'][0]:.0f} requests/s, p50 "
        f"{hop['router'][1]:.3f} ms, p99 {hop['router'][2]:.3f} ms ({smi})")

    # (d) the fleet view, at rest: no request in flight, and the poller
    # stopped (each /healthz poll moves a replica's serve.staleness_s)
    router.poller.stop()
    # (the fleet commands take no device: "cuda" adds no --device flag)
    text, _ = _cli_in_process(["fleet-metrics", "--router", front,
                               "--format", "json"], "cuda")
    doc = json.loads(text)
    direct = []
    for url in [*router.replica_set.replicas(), front]:
        with urllib.request.urlopen(url + "/metrics.json", timeout=10) as r:
            direct.append(json.loads(r.read()))

    def canon(snap):
        return sorted(json.dumps(e, sort_keys=True) for e in snap["metrics"])

    want_merged = merge_fleet(direct)
    check(not doc["errors"] and len(doc["processes"]) == len(direct),
          f"[24d] fleet page: errors {doc['errors']}, "
          f"{len(doc['processes'])} processes")
    diff = sorted(set(canon(doc["merged"])) ^ set(canon(want_merged)))
    check(not diff, "[24d] fleet-metrics' merged view != merge_fleet of the "
          f"payloads scraped directly; the differing series: {diff[:6]}")
    totals = {}
    for e in doc["merged"]["metrics"]:
        if e["type"] == "counter":
            totals[e["name"]] = totals.get(e["name"], 0) + e["value"]
    top, _ = _cli_in_process(["top", "--once", "--router", front], "cuda")
    top_rows = top.splitlines()[1:]
    check(len(top_rows) == len(direct)
          and sorted(r.split()[0] for r in top_rows)
          == ["router"] + ["serve"] * N_ROUTER_REPLICAS,
          f"[24d] top --once:\n{top}")
    mib = "not measured (no card)"
    if device != "cpu":
        sync(device)
        # the card's use now, less this process's growth, is the replicas'
        # (e)'s processes have exited
        grew = (_card_mib() - mem0[0]) - (torch.cuda.memory_reserved() / 2**20
                                          - mem0[1])
        mib = (f"{grew:.0f} MiB for the {N_ROUTER_REPLICAS} replicas, "
               f"{grew / N_ROUTER_REPLICAS:.0f} each (nvidia-smi's "
               f"memory.used less this process's reserved growth)")
    log(f"[24d] fleet-metrics --router: {len(doc['processes'])} processes, "
        f"merged view equal to merge_fleet of the direct scrapes "
        f"({len(want_merged['metrics'])} series); counter totals "
        f"serve.ok {totals.get('serve.ok', 0):.0f} (the killed process's "
        f"went with it), router.requests {totals.get('router.requests', 0):.0f}"
        f", router.forwards {totals.get('router.forwards', 0):.0f}; top "
        f"--once {len(top_rows)} rows; device memory {mib} ({smi})")
    for line in top.splitlines():
        log(f"[24d]   {line}")

    # teardown: the router, then each replica by SIGTERM (a clean close
    # ends its trace)
    router.close()
    tracer.close()
    for p in procs:
        p.terminate()
    for i, p in enumerate(procs):
        try:
            rc = p.wait(60)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        check(rc == 0, f"[24] replica {i} exit {rc} on SIGTERM")
    for f in logs:
        f.close()

    # (c) every routed serve.request span resolves to a router.forward span
    rrecs, rtorn = _trace_lines(rtrace)
    check(not rtorn, f"[24c] the router's trace has torn lines {rtorn}")
    forwards = {r["id"] for r in rrecs
                if r.get("kind") == "span" and r["name"] == "router.forward"}
    tid = tracer.trace_id
    routed = unresolved = 0
    torn = {}
    for i in range(N_ROUTER_REPLICAS):
        for path in traces[i]:
            recs, tl = _trace_lines(path)
            if tl:
                torn[path.name] = tl
            check(all(line == n for line, n in tl),
                  f"[24c] {path.name}: a torn line before the last {tl}")
            for r in recs:
                if r.get("kind") == "span" and r["name"] == "serve.request" \
                        and r["attrs"].get("ctx"):
                    routed += 1
                    ctx = r["attrs"]["ctx"]
                    if ctx.get("trace_id") != tid \
                            or ctx.get("span_id") not in forwards:
                        unresolved += 1
    n_routed_ok = ok + N_ROUTER_HOP
    check(unresolved == 0, f"[24c] {unresolved} serve.request spans do not "
          f"resolve to a router.forward span")
    check(routed >= n_routed_ok, f"[24c] {routed} routed serve.request spans "
          f"for {n_routed_ok} routed responses")
    log(f"[24c] {routed} complete serve.request spans from "
        f"{sum(len(x) for x in traces)} replica trace files carry the "
        f"router's context, every one resolving to one of the "
        f"{len(forwards)} router.forward spans ({n_routed_ok} routed "
        f"responses); torn last lines: {torn or 'none'}")


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
    # (25(e): with the compile observatory on, one record a library built)
    from tpusvm_torch.obs import prof

    t = time.perf_counter()
    with prof.profiling() as observatory:
        secs = _build.build_all()
    log(f"[2] built {sorted(secs)} in {time.perf_counter() - t:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in secs.items()})})")
    phase_build_records(observatory.records, secs)
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
            bench5 = {
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
                "provenance": {"backend": "gpu", "torch": torch.__version__,
                               "cuda": torch.version.cuda,
                               "python": sys.version.split()[0],
                               "device": kind, "nvidia_smi": smi}}
            print(json.dumps({"bench": bench5}), flush=True)
    (m5, acc5), (m5b, acc5b) = models["5"], models["5b"]
    log(f"[5b] against phase 5's model: accuracy {acc5b:.4f} vs {acc5:.4f}, SV-ID "
        f"symmetric difference {len(set(m5.sv_ids_) ^ set(m5b.sv_ids_))} of "
        f"{m5.n_support_}, |db| {abs(m5.b_ - m5b.b_):.3e}")
    check(abs(acc5b - acc5) <= 0.002, f"5b accuracy {acc5b} vs phase 5 {acc5}")

    clock("5, 5b")
    # ---- 25(c), 25(f): the tracer's cost on phase 5's job; benchdiff -------
    trace_dir = _build.BUILD_DIR / "chip_smoke_trace"
    phase_tracer_cost(X_all, Y_all, 60000, m5, train_secs["5"],
                      full_opts["5"], counters, trace_dir, smi)
    phase_benchdiff(bench5, trace_dir)
    clock("25c, 25f")
    # the CSVs of phases 10, 14(d), 17(e) and 20(b), written in the
    # background from here on (stopped at exit if still running)
    import atexit

    csvs, writers = start_csv_writers(70000, 60000, 784,
                                      _build.BUILD_DIR / "chip_smoke_csvs")
    atexit.register(lambda: [p.kill() for p in writers if p.poll() is None])

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
    csv10 = phase_front(X_all, Y_all, 60000, N_CSV_LIMIT, N_ORACLE, csvs,
                        writers, m5, "cuda", model5_path, launches, trace_dir)
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
    fits14 = phase_cascade(X_all, Y_all, 60000, m5, acc5, "cuda", counters,
                           launches, csvs,
                           _build.BUILD_DIR / "chip_smoke_cascade", clock)

    # ---- 17, 18. the out-of-core tier, the approximate families ---------
    ds, m17d = phase_stream(X_all, Y_all, 60000, m5, acc5, fits14["14b"][0],
                            csv10, "cuda", counters, launches, smi,
                            _build.BUILD_DIR / "chip_smoke_stream")
    clock("17")
    # 19(c)'s subprocesses (their own synthetic data) start here, beside 18
    pod_smokes = _start_pod_smokes("cuda", str(Path(ds.path).parent))
    atexit.register(lambda: _stop_pod_smokes(pod_smokes[0]))
    rff18a = phase_approx(X_all, Y_all, 60000, acc5, ds, "cuda", counters,
                          launches)
    clock("18")

    # ---- 19. the pod: the cascade's leaves in worker processes ----------
    phase_pod(ds, m17d, "cuda", counters, launches, smi, smokes=pod_smokes)
    # (25(d) ran inside: 19(a) traced into a directory, one file a process)
    clock("19")

    # ---- 20, 21. the class axis and the front door; tuning --------------
    phase_class_axis(Xm, lm, 60000, ovr_model, ovr_a, X_all, Y_all, m5, acc5,
                     csvs, writers, model5_path, "cuda", counters, launches,
                     _build.BUILD_DIR / "chip_smoke_class", clock)
    phase_tune(X_all, Y_all, 60000, acc5, "cuda", counters, launches,
               _build.BUILD_DIR / "chip_smoke_tune")
    clock("21")

    # ---- 22. serving and refresh ----------------------------------------
    phase_serve(X_all, Y_all, 60000, m5, model5_path, m11, ovr_a[0], Xm,
                rff18a, "cuda", counters, launches, smi,
                _build.BUILD_DIR / "chip_smoke_serve")
    clock("22")

    # ---- 23. the closed loop: the autopilot, the tenants ----------------
    phase_closed_loop(X_all, Y_all, 60000, m5, model5_path, Xm, lm, GAMMA,
                      "cuda", counters, launches, smi,
                      _build.BUILD_DIR / "chip_smoke_loop")
    clock("23")

    # ---- 24. the router over serve replica processes ---------------------
    phase_router(X_all, Y_all, 60000, model5_path, "cuda", counters,
                 launches, smi, _build.BUILD_DIR / "chip_smoke_router")
    clock("24")

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
