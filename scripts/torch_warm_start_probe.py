#!/usr/bin/env python3
"""How warm is a cascade leaf's warm start? One leaf of chip_smoke.py
phase 14, solved warm twice at three precisions, on the CPU.

    python3 scripts/torch_warm_start_probe.py

The data are phase 5's rows [:60000] (mnist_like(n=70000, d=784,
noise=30, label_noise=0.005, seed=587), min-max scaled, C=10,
gamma=0.00125, f64 accumulators). The direct blocked fit on all 60,000
rows gives the global SV set and its alpha: the state a star leaf starts
from once the cascade is at its fixed point. Leaf 0 is that set merged
with partition chunk 0 (P=4, sv_capacity 4,096) as
tpusvm_torch.parallel.cascade's rounds merge it. It is solved warm (solve
1) by the pair solver, and then solved warm again from solve 1's alpha on the same rows
(solve 2), three ways:

  f32 alpha   alpha carried in the features' dtype, float32, as
              extract_svs stores it between rounds (the cascade as it is);
  f64 alpha   alpha carried in float64, the features float32 (the warm
              start still rebuilds f from float32 features and
              coefficients, as the solvers do);
  all f64     features and alpha in float64 (the reference's all-double
              program; the card's K-row kernel takes float32 only).

Each solve prints the KKT gap b_low - b_high of its warm start (read by
a solve of no update; the solvers stop below 2 tau = 2e-5), its
iterations, status, b, and the symmetric difference of its SV-ID set
with the set it started from. Solve 2 starts at an
optimum of its own rows: the iterations it needs are what carrying alpha
at that precision costs. The last line is one JSON object.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()

    import torch

    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data.partition import partition
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.parallel.cascade import _leaf
    from tpusvm_torch.parallel.svbuffer import empty, merge_dedup
    from tpusvm_torch.solver.smo import smo_solve
    from tpusvm_torch.status import Status

    opts = dict(q=2048, wss=2, max_inner=4096)
    cfg = SVMConfig(C=10.0, gamma=0.00125, max_iter=10**6)
    X, Y = mnist_like(n=70000, d=784, noise=30.0, label_noise=0.005,
                      seed=587)
    X, Y = X[:60000], Y[:60000]
    t = time.perf_counter()
    m = BinarySVC(cfg, solver_opts=opts, device="cpu").fit(X, Y)
    print(f"direct blocked fit: {m.n_support_} SVs, b {m.b_:.15f}, "
          f"{m.status_.name}, {time.perf_counter() - t:.1f} s", flush=True)
    glob = set(m.sv_ids_.tolist())
    Xs = m.scaler_.transform(X)
    def warm(train, max_iter):
        return smo_solve(train.X, train.Y, valid=train.valid,
                         alpha0=train.alpha, C=cfg.C, gamma=cfg.gamma,
                         eps=cfg.eps, tau=cfg.tau, max_iter=max_iter,
                         warm_start=True, accum_dtype=torch.float64,
                         device="cpu")

    out = {}
    for name, xdt, adt in (("f32 alpha", torch.float32, torch.float32),
                           ("f64 alpha", torch.float32, torch.float64),
                           ("all f64", torch.float64, torch.float64)):
        # partition's IDs are row numbers of X, so Xs[ids] are the SVs
        part = partition(Xs.astype(np.float64 if xdt == torch.float64
                                   else np.float32), Y, 4)
        leaf = _leaf(part, 0, xdt, "cpu")
        g = empty(4096, X.shape[1], xdt, "cpu")
        k = len(m.sv_ids_)
        g.X[:k] = torch.as_tensor(Xs[m.sv_ids_]).to(g.X)
        g.Y[:k] = torch.as_tensor(m.sv_Y_).to(g.Y)
        g.ids[:k] = torch.as_tensor(m.sv_ids_).to(g.ids)
        g.valid[:k] = True
        g = g._replace(alpha=torch.as_tensor(
            np.pad(m.sv_alpha_, (0, 4096 - k))).to(adt))
        own = leaf._replace(alpha=leaf.alpha.to(adt))
        train, _ = merge_dedup(g, own, part.X.shape[1] + 4096)
        start, rows = glob, []
        for step in (1, 2):
            # the KKT gap of the warm start itself: a solve of no update
            gap = warm(train, 0)
            gap = gap.b_low - gap.b_high
            t = time.perf_counter()
            res = warm(train, cfg.max_iter)
            secs = time.perf_counter() - t
            alpha = res.alpha
            ids = set(train.ids[train.valid & (alpha > cfg.sv_tol)].tolist())
            rows.append(dict(iterations=int(res.n_iter),
                             status=Status(int(res.status)).name,
                             b=float(res.b), start_gap=gap, svs=len(ids),
                             change=len(ids ^ start), seconds=secs))
            print(f"{name}, solve {step}: {json.dumps(rows[-1])}", flush=True)
            start = ids
            # the carried alpha, in the variant's storage dtype
            train = train._replace(
                alpha=torch.where(train.valid, alpha.to(adt), 0))
        out[name] = rows
    print(json.dumps(dict(global_svs=len(glob), leaf=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
