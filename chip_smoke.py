#!/usr/bin/env python3
"""Smoke run of tpusvm_torch on one NVIDIA GPU: build, check, train, score.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order (any failure raises and the script exits non-zero):
  1. provenance: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc builds every kernel from tpusvm_torch/csrc, in parallel;
  3. each kernel against its plain torch version on the card, and timed
     (CUDA events, median of >= 10 after warm-up) beside its bound, its
     plain version and, where one exists, a single PyTorch call; the inner
     kernel at the full-width shape on a cold-start and a mid-solve working
     set, and beside two measured floors per iteration (its reduction chain
     alone, its K_BB row reads alone);
  4. the main path at mid size, trained on the card and on the CPU, held
     to the same SV-ID set, status and b (within 1e-4);
  5. the main path at full width: mnist_like(n=70000, d=784, noise=30,
     label_noise=0.005), BinarySVC on rows [:60000] with C=10,
     gamma=0.00125, q=2048, wss=2, max_inner=4096, f64 accumulators,
     scored on rows [60000:], saved and reloaded; both kernels' launch
     counts are read around this run and must be > 0; the fit's host
     phases (scale, cast, copy, solve, copy back, SV extraction) and the
     solver's time blocked at its host syncs are printed;
  6. where the time goes: the same fit once more under torch.profiler,
     device time by kernel and the device's busy share of the wall time.
Then one JSON line of kernel figures, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is present or the package is not beside this script.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# published rates of the H100 SXM part (NVIDIA data sheet, dense, at its
# 700 W limit): f32 on the FMA units, and device-memory bandwidth
_PEAKS = {"NVIDIA H100 80GB HBM3": (67.0e12, 3.35e12)}
C, GAMMA = 10.0, 0.00125


def log(msg):
    print(msg, flush=True)


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from tpusvm_torch.data.scaler import MinMaxScaler
        from tpusvm_torch.data.synthetic import mnist_like
        from tpusvm_torch.ops.cuda import _build
        from tpusvm_torch.ops.cuda.fused_fupdate import (rbf_cross_matvec_kernel,
                                                         rbf_cross_matvec_ref)
        from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_kernel,
                                                     inner_smo_ref,
                                                     iteration_floor_probe)
        from tpusvm_torch.ops.rbf import rbf_cross, sq_norms
        from tpusvm_torch.ops.selection import i_high_mask, i_low_mask
        from tpusvm_torch.config import SVMConfig
        from tpusvm_torch.models.svm import BinarySVC
        from tpusvm_torch.solver.blocked import (blocked_smo_solve,
                                                 select_working_set)
        from tpusvm_torch.status import Status
    except ImportError as e:
        print(f"chip_smoke: tpusvm_torch is not importable here ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. provenance ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(kind)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; device {kind} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; peaks used "
        f"for bounds: f32 {peak_flops / 1e12:.1f} TFLOP/s, "
        f"{peak_bw / 1e12:.2f} TB/s")

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

    # the first round's working set of the full-width solve: the tie-heavy
    # cold start f = -y
    alpha0 = torch.zeros(n, dtype=torch.float64, device=dev)
    f0 = -Y.to(torch.float64)
    B, _ = select_working_set(f0, i_high_mask(alpha0, Y, C, 1e-12),
                              i_low_mask(alpha0, Y, C, 1e-12), q // 2)
    XB = X[B].contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    coef = (torch.randn(q, generator=gen) * 0.5).to(dev)
    sn = sq_norms(X)

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

    k_ms = cuda_ms(lambda: rbf_cross_matvec_kernel(X, XB, coef, GAMMA, sn))
    p_ms = cuda_ms(lambda: rbf_cross_matvec_ref(X, XB, coef, GAMMA, sn))
    lib_ms = cuda_ms(lambda: torch.matmul(X, XB.T))
    flops = 2.0 * n * d * q
    nbytes = 4.0 * (n * d + q * d + q + n + n)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    log(f"[3] fused_fupdate bench: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
        f"torch.matmul(X, XB.T) {lib_ms:.3f} ms; bound {max(t_ops, t_bytes):.3f} ms "
        f"(operations {t_ops:.3f}, bytes {t_bytes:.4f}); "
        f"{flops / k_ms / 1e9:.1f} TFLOP/s achieved")
    kernels.append({
        "name": "fused_fupdate", "route": "cuda",
        "source": "tpusvm_torch/csrc/fused_fupdate.cu",
        "replaces": "tpusvm/ops/pallas/fused_fupdate.py:150",
        "launches": None, "max_abs_err": err_bench, "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": p_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms,
        "shape": {"n": n, "d": d, "q": q}})

    # the inner kernel against its plain version at the CPU tests' sizes
    g2 = np.random.default_rng(3)
    Xq = torch.as_tensor(g2.random((256, 8)), dtype=torch.float32, device=dev)
    yq = torch.as_tensor(np.where(g2.random(256) < 0.5, 1, -1), device=dev)
    Kq = rbf_cross(Xq, Xq, 0.5)
    inner_err = 0.0
    for wss, ex in ((1, False), (2, False), (2, True)):
        args = (Kq, yq, torch.zeros(256, device=dev), -yq.float(),
                torch.ones(256, dtype=torch.bool, device=dev), C, 1e-12, 1e-5)
        a_k, st_k = inner_smo_kernel(*args, max_inner=512, wss=wss, eta_exclude=ex)
        a_r, st_r = inner_smo_ref(*args, max_inner=512, wss=wss, eta_exclude=ex)
        torch.cuda.synchronize()
        err = float((a_k - a_r).abs().max())
        inner_err = max(inner_err, err)
        log(f"[3] inner_smo q=256 wss={wss} eta_exclude={ex}: stat kernel "
            f"{st_k.tolist()} plain {st_r.tolist()}, max_abs_err {err:.3e}")
        check(st_k.tolist()[:3] == st_r.tolist()[:3],
              f"inner_smo wss={wss} eta_exclude={ex}: status differs")
        check(err <= 1e-5 * C, f"inner_smo wss={wss}: error {err}")

    # at the full-width shape: the first round's K_BB (cold start) and the
    # fourth round's (a mid-solve state: nonzero alphas, f from them)
    def inner_case(K_BB, y_B, a_B, f_B, act_B, label):
        inner_args = (K_BB, y_B, a_B, f_B, act_B, C, 1e-12, 1e-5)
        a_k, st_k = inner_smo_kernel(*inner_args, max_inner=4096, wss=2)
        t = time.perf_counter()
        a_r, st_r = inner_smo_ref(*inner_args, max_inner=4096, wss=2)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t) * 1e3
        err = float((a_k - a_r).abs().max())
        st = st_k.tolist()
        log(f"[3] inner_smo q={q} max_inner=4096 wss=2 {label}: stat kernel "
            f"{st} plain {st_r.tolist()}, max_abs_err {err:.3e}")
        check(st[:3] == st_r.tolist()[:3], f"inner_smo q={q} {label}: status "
              f"differs (kernel {st}, plain {st_r.tolist()})")
        check(err <= 1e-5 * C, f"inner_smo q={q} {label}: error {err}")
        check(st[0] > 0 and st[2] in (1, 2, 5), f"inner_smo q={q}: bad stat {st}")
        k_ms = cuda_ms(lambda: inner_smo_kernel(*inner_args, max_inner=4096, wss=2))
        return err, st, k_ms, p_ms

    K_BB = rbf_cross(XB, XB, GAMMA)
    y_B = Y[B]
    err_cold, st, k_ms, p_ms = inner_case(
        K_BB, y_B, torch.zeros(q, device=dev), -y_B.float(),
        torch.ones(q, dtype=torch.bool, device=dev), "cold start")

    res3 = blocked_smo_solve(X, Y, C=C, gamma=GAMMA, q=q, wss=2, max_inner=4096,
                             max_outer=3, accum_dtype=torch.float64, device=dev)
    alpha3 = res3.alpha
    yd = Y.to(torch.float64)
    f3 = rbf_cross_matvec_kernel(X, X, (alpha3 * yd).float(), GAMMA, sn).double() - yd
    B4, first4 = select_working_set(f3, i_high_mask(alpha3, Y, C, 1e-12),
                                    i_low_mask(alpha3, Y, C, 1e-12), q // 2)
    a_B4, y_B4 = alpha3[B4], Y[B4]
    act4 = first4 & (i_high_mask(a_B4, y_B4, C, 1e-12)
                     | i_low_mask(a_B4, y_B4, C, 1e-12))
    K4 = rbf_cross(X[B4], X[B4], GAMMA)
    err_mid, st_mid, k_mid_ms, _ = inner_case(
        K4, y_B4, a_B4, f3[B4], act4,
        f"round 4 ({int((a_B4 > 0).sum())} nonzero alphas)")
    log(f"[3] inner_smo q={q} round 4: kernel {k_mid_ms:.3f} ms for "
        f"{st_mid[0]} updates ({k_mid_ms * 1e3 / max(st_mid[3], 1):.2f} "
        "us/iteration)")

    # floors on the cold-start run's iteration count: the reduction chain
    # alone, and the two K_BB row reads alone (K_BB is L2-resident)
    iters = st[3]
    chain_ms = cuda_ms(lambda: iteration_floor_probe(K_BB, iters, wss=2,
                                                     mode="chain"))
    rows_ms = cuda_ms(lambda: iteration_floor_probe(K_BB, iters, wss=2,
                                                    mode="rows"))
    ibytes = iters * 2.0 * q * 4 + 5.0 * q * 4 + q * 4
    i_bound = ibytes / peak_bw * 1e3
    per = lambda ms: ms * 1e3 / max(iters, 1)
    log(f"[3] inner_smo q={q} cold start: kernel {k_ms:.3f} ms for {st[0]} "
        f"updates ({iters} iterations, {per(k_ms):.2f} us/iteration), plain "
        f"{p_ms:.1f} ms (one run); floors: reduction chain {chain_ms:.3f} ms "
        f"({per(chain_ms):.2f} us/iteration, kernel at "
        f"{k_ms / chain_ms:.2f}x), row reads from L2 by one block "
        f"{rows_ms:.3f} ms ({per(rows_ms):.3f} us/iteration, "
        f"{ibytes / rows_ms / 1e6:.1f} GB/s); HBM byte bound {i_bound:.4f} ms")
    kernels.append({
        "name": "inner_smo", "route": "cuda",
        "source": "tpusvm_torch/csrc/inner_smo.cu",
        "replaces": "tpusvm/ops/pallas/inner_smo.py:545",
        "launches": None, "max_abs_err": max(inner_err, err_cold, err_mid),
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": i_bound,
        "bound_by": "bytes", "library_ms": None,
        "chain_floor_ms": chain_ms, "rows_floor_ms": rows_ms,
        "shape": {"q": q, "max_inner": 4096, "wss": 2, "updates": st[0],
                  "iterations": iters}})

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

    # ---- 5. main path at full width ---------------------------------------
    model = BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                      solver_opts=dict(q=2048, wss=2, max_inner=4096),
                      device="cuda")
    rbf_cross_matvec_kernel.launches = 0
    inner_smo_kernel.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.fit(X_all[:60000], Y_all[:60000])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = {"fused_fupdate": rbf_cross_matvec_kernel.launches,
                "inner_smo": inner_smo_kernel.launches}
    res = model.result_
    t = time.perf_counter()
    pred = model.predict(X_all[60000:])
    predict_s = time.perf_counter() - t
    acc = float((pred == Y_all[60000:]).mean())
    updates = model.n_iter_ - 1
    log(f"[5] full width n=60000 d=784: train {train_s:.3f} s, status "
        f"{model.status_.name}, outer rounds {res.n_outer}, updates {updates} "
        f"({updates / train_s:.0f}/s), SV count {model.n_support_}, "
        f"b {model.b_:.15f}, accuracy {acc:.4f} on 10000, rescue rounds "
        f"{res.n_rescue}, host syncs {res.n_host_syncs}, predict {predict_s:.3f} s, "
        f"launches {launches}")
    spans = {k: round(v * 1e3, 3) for k, v in model.fit_phases_.items()}
    log(f"[5] fit phases, host ms: {json.dumps(spans)}; inside solve: blocked "
        f"at host syncs {res.host_wait_s * 1e3:.3f} ms, the rest (host code "
        f"and launches) {(model.fit_phases_['solve'] - res.host_wait_s) * 1e3:.3f} ms")
    check(model.status_ == Status.CONVERGED, f"full: {model.status_.name}")
    check(all(v > 0 for v in launches.values()), f"kernels not launched: {launches}")
    check(np.isfinite(model.b_) and np.isfinite(model.sv_alpha_).all(),
          "full: non-finite model")
    check(acc > 0.9, f"full: accuracy {acc}")
    path = str(_build.BUILD_DIR / "chip_smoke_model.npz")
    model.save(path)
    again = BinarySVC.load(path, device="cuda")
    check(np.array_equal(again.predict(X_all[60000:]), pred),
          "reloaded model predicts differently")
    log(f"[5] saved and reloaded {path}: predictions equal")

    # ---- 6. where the time goes: one more full-width fit, profiled -------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        BinarySVC(SVMConfig(C=C, gamma=GAMMA, max_iter=10**6),
                  solver_opts=dict(q=2048, wss=2, max_inner=4096),
                  device="cuda").fit(X_all[:60000], Y_all[:60000])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_kernel = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time / 1e3
    busy = sum(by_kernel.values())
    log(f"[6] profiled full-width fit: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), idle "
        f"{100 * (1 - busy / wall_ms):.1f}%")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    check(busy > 0, "profiler saw no device time")

    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
