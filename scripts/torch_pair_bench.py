#!/usr/bin/env python3
"""Times the pair solver's pieces on one GPU: the K-row refresh kernel
(csrc/pair_rows.cu) and the chunked, graph-captured pair loop.

    python3 scripts/torch_pair_bench.py [--tree DIR] [--rows-only]
                                        [--chunks 16,32,64,128,256] [--iters 20000]

1. `pair_rows` at n=60000, d=784 (chip_smoke.py phase 5's scaled data),
   k = 2, 8 and 20 (two passes; the second's figures are kept), every
   exact family: the kernel with every `need` set, with none set (the
   skip: its launch alone), its plain version, and torch.matmul(X[idx],
   X.T) plus the family's epilogue, beside the bound (chip_smoke.py's
   `pair_rows_bound_ms`); CUDA events, one call a sample, median of 10
   (chip_smoke.py's `cuda_ms`). With --tree DIR (another checkout, such as
   the parent commit unpacked with `git archive` under build/), that
   tree's pair_rows is built by its own _build.py and timed in turns with
   this tree's (this, DIR, DIR, this), and its rows must equal this
   tree's bit for bit; the exit code is 1 if they do not.
2. The binary pair solve on the same data (C=10, gamma=0.00125, f64
   accumulators) for `--iters` iterations at each chunk size, captured as
   a CUDA graph, and one chunk of 256 run eagerly: microseconds an
   iteration, the host syncs and the peak device memory.
3. The same loop with K lockstep heads (one-vs-rest, K=10, chip_smoke.py
   phase 8's data) for `--iters` / 10 iterations at the default chunk.
--rows-only stops after 1. The last line is one JSON object with the
figures.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (C, GAMMA, cuda_ms, pair_rows_bound_ms, peaks,  # noqa: E402
                        rows_by_matmul)
from kernel_trees import pair_rows_of  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="16,32,64,128,256")
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--tree", help="another checkout whose pair_rows is timed "
                    "in turns with this tree's and must give the same bits")
    ap.add_argument("--rows-only", action="store_true",
                    help="time pair_rows only, not the pair loop")
    args = ap.parse_args()
    import torch

    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.data.synthetic import (BENCH_NOISE_MULTICLASS, mnist_like,
                                             mnist_like_multiclass)
    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel, pair_rows_ref
    from tpusvm_torch.ops.rbf import sq_norms
    from tpusvm_torch.solver.smo import smo_solve, smo_solve_batched

    if not torch.cuda.is_available():
        print("torch_pair_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    peak_flops, peak_bw, _ = peaks(torch.cuda.get_device_name(0))
    out = {"device": smi, "tree": args.tree, "pair_rows": {}, "solve": {},
           "batched": {}}
    other = pair_rows_of(args.tree) if args.tree else None
    bits_equal = True

    X_all, Y_all = mnist_like(n=70000, d=784, noise=30.0, label_noise=0.005,
                              seed=587)
    Xs = MinMaxScaler().fit(X_all[:60000]).transform(X_all[:60000])
    X = torch.as_tensor(Xs.astype(np.float32), device=dev)
    Y = torch.as_tensor(Y_all[:60000], device=dev)
    n, d = X.shape
    sn = sq_norms(X)
    fam_kw = {"rbf": dict(gamma=GAMMA), "linear": dict(gamma=0.0),
              "poly": dict(gamma=1.0 / d, coef0=1.0, degree=3),
              "sigmoid": dict(gamma=1.0 / d, coef0=-1.0)}
    rng = np.random.default_rng(0)
    for k in (2, 8, 20, 2, 8, 20):
        idx = torch.as_tensor(rng.choice(n, k, replace=False), device=dev)
        yes = torch.ones(k, dtype=torch.bool, device=dev)
        no = torch.zeros(k, dtype=torch.bool, device=dev)
        rows = torch.zeros(k, n, device=dev)
        bound = pair_rows_bound_ms(n, d, k, peak_flops, peak_bw)
        for fam, kw in fam_kw.items():
            kw = dict(family=fam, sn=sn, **kw)
            got = pair_rows_kernel(X, idx, yes, rows, **kw).clone()
            want = pair_rows_ref(X, idx, yes, torch.zeros(k, n, device=dev), **kw)
            err = float((got - want).abs().max() / want.abs().max())
            rec = dict(bound_ms=bound, rel_err=err)
            if other is not None:
                theirs = other(X, idx, yes, torch.zeros(k, n, device=dev), **kw)
                torch.cuda.synchronize()
                rec["bit_equal_to_tree"] = bool(torch.equal(theirs, got))
                bits_equal = bits_equal and rec["bit_equal_to_tree"]
                turns = {"this": [], "tree": []}
                for who in ("this", "tree", "tree", "this"):
                    fn = (lambda: pair_rows_kernel(X, idx, yes, rows, **kw)) \
                        if who == "this" else (lambda: other(X, idx, yes, rows, **kw))
                    turns[who].append(cuda_ms(fn))
                rec["turns"] = turns
                rec["tree_ms"] = float(np.mean(turns["tree"]))
            t_k = cuda_ms(lambda: pair_rows_kernel(X, idx, yes, rows, **kw))
            t_skip = cuda_ms(lambda: pair_rows_kernel(X, idx, no, rows, **kw))
            t_p = cuda_ms(lambda: pair_rows_ref(X, idx, yes, rows, **kw))
            t_lib = cuda_ms(lambda: rows_by_matmul(fam, X, idx, sn, fam_kw[fam]))
            rec.update(kernel_ms=t_k, skip_ms=t_skip, plain_ms=t_p, library_ms=t_lib)
            # two passes over the shapes: the second pass's figures stand
            out["pair_rows"][f"{fam} k={k}"] = rec
            tree = (f", tree {rec['tree_ms']:.4f} ms (turns this "
                    f"{rec['turns']['this']}, tree {rec['turns']['tree']}), bits "
                    f"equal {rec['bit_equal_to_tree']}") if other is not None else ""
            print(f"pair_rows {fam} k={k}: kernel {t_k:.4f} ms, skip "
                  f"{t_skip:.4f} ms, plain {t_p:.4f} ms, matmul+epilogue "
                  f"{t_lib:.4f} ms, bound {bound:.4f} ms ({100 * bound / t_k:.1f}% "
                  f"of it reached), max rel err {err:.2e}{tree}", flush=True)
    if args.rows_only:
        print(json.dumps(out))
        return 0 if bits_equal else 1

    kw = dict(C=C, gamma=GAMMA, accum_dtype=torch.float64, device="cuda")
    for chunk in [int(c) for c in args.chunks.split(",")]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        r = smo_solve(X, Y, max_iter=args.iters, chunk=chunk, **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        it = r.chunks * chunk
        rec = dict(seconds=s, iterations_run=it, us_per_iteration=s / it * 1e6,
                   n_iter=r.n_iter, status=r.status.name,
                   row_refreshes=r.row_refreshes, host_syncs=r.host_syncs,
                   peak_mb=torch.cuda.max_memory_allocated() / 2**20)
        out["solve"][f"graph chunk={chunk}"] = rec
        print(f"pair solve, graph, chunk {chunk}: {s:.3f} s for {it} "
              f"iterations ({rec['us_per_iteration']:.1f} us each), "
              f"{r.status.name}, refreshes {r.row_refreshes}, syncs "
              f"{r.host_syncs}, peak {rec['peak_mb']:.0f} MiB", flush=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = smo_solve(X, Y, max_iter=256, chunk=256, graph=False, **kw)
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    out["solve"]["eager chunk=256"] = dict(seconds=s, us_per_iteration=s / 256 * 1e6)
    print(f"pair solve, eager: {s / 256 * 1e6:.1f} us an iteration", flush=True)

    Xm, lm = mnist_like_multiclass(n=70000, d=784, noise=BENCH_NOISE_MULTICLASS)
    Xms = MinMaxScaler().fit(Xm[:60000]).transform(Xm[:60000])
    Xd = torch.as_tensor(Xms.astype(np.float32), device=dev)
    Ys = torch.as_tensor(np.stack([np.where(lm[:60000] == c, 1, -1)
                                   for c in range(10)]).astype(np.int32), device=dev)
    iters = max(args.iters // 10, 256)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rb = smo_solve_batched(Xd, Ys, max_iter=iters, **kw)
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    it = rb.chunks * rb.chunk
    out["batched"] = dict(seconds=s, iterations_run=it,
                          us_per_iteration=s / it * 1e6,
                          statuses=rb.status.tolist())
    print(f"batched pair solve, 10 heads: {s:.3f} s for {it} iterations "
          f"({s / it * 1e6:.1f} us each)", flush=True)
    print(json.dumps(out))
    return 0 if bits_equal else 1


if __name__ == "__main__":
    sys.exit(main())
