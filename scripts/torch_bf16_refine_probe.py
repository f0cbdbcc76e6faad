#!/usr/bin/env python3
"""The bf16 matmul_precision rungs on chip_smoke.py phase 5's job, with
refine, at several refine budgets: where does each stop, and how far is
its stop from the f32 solve?

    python3 scripts/torch_bf16_refine_probe.py [--device cpu --rows 4000]

The data are phase 5's rows (mnist_like(n=70000, d=784, noise=30,
label_noise=0.005, seed=587), rows [:60000] min-max scaled, C=10,
gamma=0.00125, q=2048, wss=2, max_inner=4096, f64 accumulators). For the
f32 solve and for each (rung, max_refines) with refine=4096 it prints
one line: status, rounds, updates, refines, b, the SV-ID symmetric
difference and |db| against the f32 solve (benchmarks/solver_ladder.py's
gates: flips <= max(2, |SV|/25), |db| <= 1e-3), and, from an f rebuilt in
f64 from the f32 features and the final alphas, the KKT gap b_low - b_high
(the solvers stop below 2 tau = 2e-5 on the f they carry) and the f64 b
(b_high + b_low) / 2 beside the f32 solve's f64 b. The f32 solve with
refine=4096 and the same budgets (chip_smoke.py phase 11) runs too. The
last line is one JSON object.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def exact_b(X, Y, alpha, C, gamma, eps=1e-12, block=4096):
    """(b_high, b_low) of alpha on f = K(alpha y) - y rebuilt in f64."""
    import torch

    Xd = X.double()
    yd = Y.double()
    coef = alpha.double() * yd
    nz = torch.nonzero(coef != 0).flatten()
    sn = (Xd * Xd).sum(1)
    f = torch.empty_like(yd)
    for s in range(0, X.shape[0], block):
        e = min(s + block, X.shape[0])
        d2 = sn[s:e, None] + sn[nz][None, :] - 2.0 * Xd[s:e] @ Xd[nz].T
        f[s:e] = torch.exp(-gamma * d2.clamp_min(0.0)) @ coef[nz]
    f = f - yd
    a = alpha.double()
    m_h = torch.where(Y == 1, a < C - eps, (Y == -1) & (a > eps))
    m_l = torch.where(Y == 1, a > eps, (Y == -1) & (a < C - eps))
    return float(f[m_h].min()), float(f[m_l].max())


def main(argv=None) -> int:
    import torch
    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.solver.blocked import blocked_smo_solve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=60000)
    ap.add_argument("--budgets", default="2,4,8")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    C, gamma = 10.0, 0.00125
    X_all, Y_all = mnist_like(n=70000, d=784, noise=30.0, label_noise=0.005,
                              seed=587)
    Xs = MinMaxScaler().fit(X_all[:60000]).transform(
        X_all[:60000]).astype(np.float32)[:args.rows]
    X = torch.as_tensor(Xs, device=args.device)
    Y = torch.as_tensor(Y_all[:args.rows], device=args.device)
    base = dict(C=C, gamma=gamma, q=2048, wss=2, max_inner=4096,
                max_iter=10**6, accum_dtype=torch.float64, device=args.device)
    runs = [("float32", None, 0)] + [
        (rung, 4096, int(m)) for rung in ("float32", "bf16_f32", "bf16_f32c")
        for m in args.budgets.split(",")]
    out = []
    ref = None
    for rung, refine, budget in runs:
        kw = dict(base)
        if refine:
            kw.update(matmul_precision=rung, refine=refine, max_refines=budget)
        t = time.perf_counter()
        r = blocked_smo_solve(X, Y, **kw)
        secs = time.perf_counter() - t
        sv = set(torch.nonzero(r.alpha > 1e-8).flatten().tolist())
        bh, bl = exact_b(X, Y, r.alpha, C, gamma)
        row = {"rung": rung, "max_refines": budget, "status": r.status.name,
               "rounds": r.n_outer, "updates": r.n_iter - 1,
               "refines": r.n_refines, "b": r.b, "seconds": secs,
               "exact_gap": bl - bh, "b64": (bh + bl) / 2}
        if ref is None:
            ref = (sv, r.b, row["b64"])
        row["db64"] = abs(r.b - ref[2])
        row["sv_flips"] = len(sv ^ ref[0])
        row["db"] = abs(r.b - ref[1])
        row["gates"] = (row["sv_flips"] <= max(2, len(ref[0]) // 25)
                        and row["db"] <= 1e-3)
        out.append(row)
        print(f"{rung:10s} max_refines={budget}: {row['status']}, rounds "
              f"{row['rounds']}, updates {row['updates']}, refines "
              f"{row['refines']}, b {row['b']:.9f}, SV flips {row['sv_flips']}, "
              f"|db| {row['db']:.3e}, gates {row['gates']}, exact-f gap "
              f"{row['exact_gap']:.3e}, f64 b {row['b64']:.9f} (|b - the f32 "
              f"solve's f64 b| {row['db64']:.3e}), {secs:.2f} s", flush=True)
    print(json.dumps({"probe": "bf16_refine", "rows": args.rows, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
