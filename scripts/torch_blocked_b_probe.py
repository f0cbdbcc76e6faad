#!/usr/bin/env python3
"""Where do the port's and the JAX package's blocked solves stop on one
rings problem, measured in f64?

    JAX_PLATFORMS=cpu python3 scripts/torch_blocked_b_probe.py [--sweep 6]

The problem is ROADMAP Queue 3's: rings(n=600, seed=0) min-max scaled,
the labels flipped, C=2, gamma=3, q=128, max_inner=256, tau=1e-5, f64
accumulators, on the CPU. Four solves: the port's blocked solver with
inner="kernel" (the kernels' plain versions on the CPU) and inner="loop",
the JAX package's with inner="pallas" (interpret mode, the fused f-update)
and inner="xla". For each it prints the status, rounds, b, and from the
f32 features and its final alphas, f rebuilt in f64: the exact-f KKT gap
b_low - b_high (each solver stops once its own carried f has b_low <=
b_high + 2 tau) and the f64 b = (b_high + b_low) / 2; the carried f's gap
and its drift max |f_carried - f_exact| (the f32 f-update increments
accumulated in f64); and the f64 dual objective sum(alpha) - 1/2
alpha' Q alpha. A solve whose carried gap meets 2 tau sits in the band
2 tau + 2 drift of the exact gap. --sweep S runs the port's kernel
engine against JAX's Pallas engine on rings(n=600, seed) for seeds 0..S-1,
labels as drawn and flipped, and counts the solves whose exact-f gap is
above 2 tau in each package. The last line is one JSON object.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

C, GAMMA, TAU = 2.0, 3.0, 1e-5


def gap_and_b(f, Y, alpha, eps=1e-12):
    """(b_low - b_high, (b_high + b_low) / 2) of alpha on the error vector f."""
    y = Y.astype(np.float64)
    a = np.asarray(alpha, np.float64)
    pos = y > 0
    high = np.where(pos, a < C - eps, a > eps)
    low = np.where(pos, a > eps, a < C - eps)
    b_high, b_low = f[high].min(), f[low].max()
    return float(b_low - b_high), float((b_high + b_low) / 2.0)


def exact_f_and_dual(Xs, Y, alpha):
    """f = K(alpha y) - y rebuilt in f64 from the f32 features, and the f64
    dual objective sum(alpha) - 1/2 (alpha y)' K (alpha y)."""
    X = Xs.astype(np.float64)
    y = Y.astype(np.float64)
    a = np.asarray(alpha, np.float64)
    sq = (X * X).sum(1)
    K = np.exp(-GAMMA * np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T,
                                   0.0))
    Kc = K @ (a * y)
    return Kc - y, float(a.sum() - 0.5 * (a * y) @ Kc)


def _solve_pair(Xs, Y, engines):
    """{name: (alpha, carried f, b, status, rounds)} for the named engines:
    ("port", inner) or ("jax", inner)."""
    import jax.numpy as jnp
    import torch

    from tpusvm.solver.blocked import blocked_smo_solve as j_solve
    from tpusvm_torch.solver.blocked import blocked_smo_solve

    kw = dict(C=C, gamma=GAMMA, tau=TAU, q=128, max_inner=256,
              max_iter=10**6)
    runs = {}
    for pkg, engine in engines:
        if pkg == "port":
            r, st = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y),
                                      inner=engine, accum_dtype=torch.float64,
                                      device="cpu", return_state=True, **kw)
            runs[f"port inner={engine}"] = (r.alpha.numpy(), st.f.numpy(),
                                           float(r.b), int(r.status),
                                           int(r.n_outer))
        else:
            r, st = j_solve(jnp.asarray(Xs), jnp.asarray(Y), inner=engine,
                            fused_fupdate=engine == "pallas",
                            accum_dtype=jnp.float64, return_state=True, **kw)
            runs[f"jax inner={engine}"] = (np.asarray(r.alpha),
                                          np.asarray(st.f), float(r.b),
                                          int(r.status), int(r.n_outer))
    return runs


def _measure(Xs, Y, alpha, f_carried):
    f_exact, dual = exact_f_and_dual(Xs, Y, alpha)
    gap, b64 = gap_and_b(f_exact, Y, alpha)
    cgap, _ = gap_and_b(np.asarray(f_carried, np.float64), Y, alpha)
    drift = float(np.abs(f_carried - f_exact).max())
    return gap, b64, cgap, drift, dual


def sweep(n_seeds):
    from tpusvm_torch.data import MinMaxScaler, rings

    above = {"port": 0, "jax": 0}
    rows = []
    for seed in range(n_seeds):
        for flip in (1, -1):
            X, Y = rings(n=600, seed=seed)
            Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
            Y = (flip * Y).astype(np.int32)
            runs = _solve_pair(Xs, Y, (("port", "kernel"), ("jax", "pallas")))
            (a_t, f_t, b_t, *_), (a_j, f_j, b_j, *_) = runs.values()
            g_t, b64_t, c_t, d_t, du_t = _measure(Xs, Y, a_t, f_t)
            g_j, b64_j, c_j, d_j, du_j = _measure(Xs, Y, a_j, f_j)
            above["port"] += g_t > 2 * TAU
            above["jax"] += g_j > 2 * TAU
            rows.append(dict(seed=seed, flip=flip, gap_port=g_t,
                             gap_jax=g_j, drift_port=d_t, drift_jax=d_j,
                             d_dual=du_t - du_j, d_b_f64=b64_t - b64_j))
            print(f"seed {seed} flip {flip:+d}: exact gap port {g_t:.3e} "
                  f"(carried {c_t:.3e}, drift {d_t:.2e}), jax {g_j:.3e} "
                  f"(carried {c_j:.3e}, drift {d_j:.2e}); f64 dual port - "
                  f"jax {du_t - du_j:+.2e}, f64 b port - jax "
                  f"{b64_t - b64_j:+.2e}")
    print(f"exact-f gap above 2 tau: port {above['port']}, jax "
          f"{above['jax']} of {len(rows)} solves each")
    print(json.dumps({"probe": "torch_blocked_b_probe", "sweep": rows,
                      "above_2tau": above}))


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", type=int, default=0, metavar="S")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if args.sweep:
        return sweep(args.sweep)
    from tpusvm_torch.data import MinMaxScaler, rings

    X, Y = rings(n=600, seed=0)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    Y = (-Y).astype(np.int32)
    runs = _solve_pair(Xs, Y, (("port", "kernel"), ("port", "loop"),
                               ("jax", "pallas"), ("jax", "xla")))
    out = {}
    for name, (alpha, f_carried, b, status, rounds) in runs.items():
        gap, b64, cgap, drift, dual = _measure(Xs, Y, alpha, f_carried)
        band = 2 * TAU + 2 * drift
        sv = int((alpha > 1e-8).sum())
        out[name] = dict(status=status, rounds=rounds, b=b, b_f64=b64,
                         gap_f64=gap, gap_carried=cgap, drift=drift,
                         band=band, within_band=gap <= band, dual_f64=dual,
                         svs=sv)
        print(f"{name:18s} status {status} rounds {rounds:3d} SVs {sv:3d} "
              f"b {b:.9f} f64 b {b64:.9f}; gap: carried {cgap:.3e}, f64 "
              f"{gap:.3e} (band 2 tau + 2 drift {band:.3e}: within "
              f"{gap <= band}; drift {drift:.2e}); f64 dual {dual:.12f}")
    pk, jp = out["port inner=kernel"], out["jax inner=pallas"]
    print(f"port kernel vs jax pallas: |db| {abs(pk['b'] - jp['b']):.3e}, "
          f"|d f64 b| {abs(pk['b_f64'] - jp['b_f64']):.3e}")
    print(json.dumps({"probe": "torch_blocked_b_probe", "runs": out}))


if __name__ == "__main__":
    main()
