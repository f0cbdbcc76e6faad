#!/usr/bin/env python3
"""One cascade fit of chip_smoke.py phase 14 on one GPU, every leaf solve
printed the moment it ends, so a fit that runs long shows where its time
goes before any time limit cuts it.

    python3 scripts/torch_cascade_probe.py [--rows 60000] [--topology star]
        [--solver pair] [--deadline 700] [--device cuda] [--d 784]

The data are phase 5's (mnist_like(n=70000, d, noise=30,
label_noise=0.005, seed=587), C=10, gamma=0.00125 x 784/d, f64
accumulators), training rows [:rows], scored on [60000:] (or the rows
past `rows` when d is cut); P=4, sv_capacity 4,096, max_rounds 50,
max_iter 10^6 a leaf,
blocked leaves with phase 5's options. Each leaf solve prints its round,
its place in the round, rows, merged (valid) rows, SVs, iterations,
status, seconds, the kernels it launched, and the symmetric difference of
its SV-ID set with the same leaf's set one round before (for the star's
layer-2 solve, the last of a round, that is the global set whose
unchanged IDs end the fit); the fit's own verbose line follows each
round. Past
`--deadline` seconds of fitting the next leaf solve stops the fit, which
is reported as cut. At the end: the direct blocked fit on the same rows
(accuracy, SV-ID Jaccard), the nvidia-smi line, and one JSON object with
the figures. --device cpu --rows 2000 --d 32 rehearses it on a CPU.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


class Deadline(Exception):
    pass


class LiveLeafLog(cs.LeafLog):
    """chip_smoke.py's LeafLog, printing each solve as it ends and
    stopping the fit at the deadline."""

    def __init__(self, counters, device, sv_tol, per_round, deadline_s):
        super().__init__(counters, device, sv_tol)
        self.per_round, self.deadline_s = per_round, deadline_s
        self.t0 = time.perf_counter()
        self.prev_sets = {}
        self.cut = False

    def __call__(self, train, *args, **kw):
        if time.perf_counter() - self.t0 > self.deadline_s:
            self.cut = True
            raise Deadline
        res = super().__call__(train, *args, **kw)
        s = self.solves[-1]
        i = len(self.solves) - 1
        rnd, slot = i // self.per_round + 1, i % self.per_round
        alpha = res.alpha.to(train.valid.device)
        ids = set(train.ids[train.valid & (alpha > self.sv_tol)].tolist())
        prev = self.prev_sets.get(slot)
        self.prev_sets[slot] = ids
        s["delta"] = None if prev is None else len(ids ^ prev)
        launched = {k: v for k, v in s["launches"].items() if v}
        print(f"round {rnd} leaf {slot}: rows {s['rows']}, merged "
              f"{s['merged']}, SVs {s['svs']}, iterations {s['iters']}, "
              f"{s['status']}, {s['s']:.3f} s, launches {launched}, SV-ID "
              f"change against round {rnd - 1} {s['delta']} (at "
              f"{time.perf_counter() - self.t0:.1f} s)", flush=True)
        return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=60000)
    ap.add_argument("--topology", default="star", choices=("tree", "star"))
    ap.add_argument("--solver", default="pair", choices=("pair", "blocked"))
    ap.add_argument("--deadline", type=float, default=700.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d", type=int, default=784)
    a = ap.parse_args()

    import torch

    from tpusvm_torch.config import CascadeConfig, SVMConfig
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.ops.cuda.fused_fupdate import rbf_cross_matvec_kernel
    from tpusvm_torch.ops.cuda.inner_smo import inner_smo_kernel
    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel

    if a.device != "cpu" and not torch.cuda.is_available():
        print("torch_cascade_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = "not read (CPU)"
    if a.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}; device {a.device}; nvidia-smi: {smi}",
          flush=True)
    if a.d != 784:
        cs.GAMMA = cs.GAMMA * 784 / a.d
        cs.FULL_OPTS = dict(q=256, wss=2, max_inner=512)
    n_all = 70000 if a.d == 784 else a.rows + 400
    n_test = 60000 if a.d == 784 else a.rows
    X, Y = mnist_like(n=n_all, d=a.d, noise=30.0, label_noise=0.005, seed=587)
    Xtr, Ytr, Xt, Yt = X[:a.rows], Y[:a.rows], X[n_test:], Y[n_test:]

    counters = {"fused_fupdate": rbf_cross_matvec_kernel,
                "inner_smo": inner_smo_kernel, "pair_rows": pair_rows_kernel}
    cc = CascadeConfig(n_shards=cs.CASCADE_P, sv_capacity=cs.CASCADE_SV_CAP,
                       topology=a.topology)
    per_round = (2 * cs.CASCADE_P - 1 if a.topology == "tree"
                 else cs.CASCADE_P + 1)
    model = cs._cascade_model(a.solver, a.device)
    print(f"fit: {a.topology} P={cs.CASCADE_P} {a.solver} leaves, n={a.rows} "
          f"d={a.d}, sv_capacity {cs.CASCADE_SV_CAP}, max_rounds "
          f"{model.config.max_rounds}, deadline {a.deadline} s", flush=True)
    t = time.perf_counter()
    with LiveLeafLog(counters, a.device, model.config.sv_tol, per_round,
                     a.deadline) as leaves:
        try:
            model.fit_cascade(Xtr, Ytr, cc, verbose=True)
        except Deadline:
            pass
    fit_s = time.perf_counter() - t
    rounds = [leaves.solves[i:i + per_round]
              for i in range(0, len(leaves.solves), per_round)]
    out = dict(rows=a.rows, d=a.d, topology=a.topology, solver=a.solver,
               cut_at_deadline=leaves.cut, fit_s=fit_s,
               leaf_solves=len(leaves.solves),
               leaf_s=sum(s["s"] for s in leaves.solves),
               iterations=[[s["iters"] for s in r] for r in rounds],
               statuses=sorted({s["status"] for s in leaves.solves}),
               sv_counts=[[s["svs"] for s in r] for r in rounds],
               leaf_set_changes=[[s.get("delta") for s in r] for r in rounds],
               nvidia_smi=smi)
    if not leaves.cut:
        hist = model.cascade_history_
        print(f"fit: {model.cascade_rounds_} rounds, {model.status_.name}, "
              f"{fit_s:.3f} s, {model.n_support_} SVs, b {model.b_:.15f}",
              flush=True)
        ref = BinarySVC(SVMConfig(C=cs.C, gamma=cs.GAMMA, max_iter=10**6),
                        solver_opts=cs.FULL_OPTS, device=a.device).fit(Xtr, Ytr)
        acc = float((model.predict(Xt) == Yt).mean())
        acc_ref = float((ref.predict(Xt) == Yt).mean())
        s1, s2 = set(ref.sv_ids_.tolist()), set(model.sv_ids_.tolist())
        out.update(rounds=model.cascade_rounds_, status=model.status_.name,
                   global_svs=[h["sv_count"] for h in hist],
                   accuracy=acc, direct_accuracy=acc_ref,
                   jaccard=len(s1 & s2) / len(s1 | s2), b=model.b_)
        print(f"against the direct blocked fit on the same rows: accuracy "
              f"{acc:.4f} ({acc_ref:.4f}), Jaccard {out['jaccard']:.4f}",
              flush=True)
    else:
        print(f"fit: cut at the deadline after {len(leaves.solves)} leaf "
              f"solves, {fit_s:.3f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
