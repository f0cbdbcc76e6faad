#!/usr/bin/env python3
"""Times the inner-subproblem kernels (#2 inner_smo, #3 inner_smo_multipair)
of this checkout against those of other checkouts, in turns on one GPU, and
checks that every version gives the same bits.

    python3 scripts/torch_inner_bench.py --tree DIR [--tree DIR ...]

Builds both kernels from this checkout and from each DIR/tpusvm_torch/csrc
(such as a parent commit unpacked with `git archive` under build/), each
with its own tree's nvcc flags into its own build/ directory, and calls
their C entry points on the same inputs: chip_smoke.py's phase-3 working
sets at full width (mnist_like n=60000, q=2048; the cold start and round
4), #2 at wss=2 and #3 at p = 2, 4 and 8. For each shape every version's
a_out and stat must equal this tree's bit for bit; each version is timed
with chip_smoke.py's `cuda_ms` (one call per sample, median of 10) in
turns: this tree, the others, the others again in reverse order, this
tree. This tree's floors per iteration (reduction chain, row reads, their
sum) are printed beside. The last line is one JSON object with the figures;
the exit code is 1 if any version's bits differ.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import C, cuda_ms, inner_working_sets  # noqa: E402
from kernel_trees import load_tree as load_libs  # noqa: E402

_P = ctypes.c_void_p
MAX_INNER = 4096


def load_tree(tree):
    """The two C entry points built from `tree`, by that tree's own
    tpusvm_torch/ops/cuda/_build.py."""
    libs = load_libs(tree, ["inner_smo", "inner_smo_multipair"])
    single = libs["inner_smo"].tpusvm_inner_smo
    single.argtypes = [_P] * 5 + [ctypes.c_float] * 3 + [ctypes.c_int] * 4 + [_P] * 3
    multi = libs["inner_smo_multipair"].tpusvm_inner_smo_multipair
    multi.argtypes = [_P] * 5 + [ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [_P] * 3
    single.restype = multi.restype = ctypes.c_int
    return {"single": single, "multi": multi}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout to build and time against this one")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.ops.cuda.inner_smo import (_operands, iteration_floor_probe,
                                                 multipair_floor_probe)
    from tpusvm_torch.ops.rbf import sq_norms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    names = ["this"] + [Path(t).name for t in args.tree]
    libs = {"this": load_tree(ROOT)}
    for name, tree in zip(names[1:], args.tree):
        libs[name] = load_tree(tree)

    X_all, Y_all = mnist_like(n=70000, d=784, noise=30.0, label_noise=0.005, seed=587)
    Xs = MinMaxScaler().fit(X_all[:60000]).transform(X_all[:60000])
    X = torch.as_tensor(Xs.astype(np.float32), device=dev)
    Y = torch.as_tensor(Y_all[:60000], device=dev)
    q = 2048
    cold, round4, *_ = inner_working_sets(X, Y, sq_norms(X), q, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def runner(lib, ops, p):
        K, y, a, f, act = ops
        a_out = torch.empty(q, dtype=torch.float32, device=dev)
        stat = torch.empty(4, dtype=torch.int32, device=dev)
        head = (K.data_ptr(), y.data_ptr(), a.data_ptr(), f.data_ptr(), act.data_ptr(),
                C, 1e-12, 1e-5, q, MAX_INNER)
        tail = (a_out.data_ptr(), stat.data_ptr(), stream)

        def run():
            rc = (lib["single"](*head, 2, 0, *tail) if p == 1
                  else lib["multi"](*head, p, *tail))
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return a_out, stat
        return run

    shapes = []
    for label, ws in (("cold start", cold), ("round 4", round4)):
        ops = _operands(*ws)
        shapes.append((f"#2 wss=2 {label}", ops, 1))
        for p in (2, 4, 8):
            shapes.append((f"#3 p={p} {label}", ops, p))

    order = names + names[1:][::-1] + ["this"]
    results, all_equal = [], True
    for label, ops, p in shapes:
        runs = {n: runner(libs[n], ops, p) for n in names}
        a_this, st_this = (t.clone() for t in runs["this"]())
        equal = {}
        for n in names[1:]:
            a_n, st_n = runs[n]()
            torch.cuda.synchronize()
            equal[n] = torch.equal(a_n, a_this) and torch.equal(st_n, st_this)
            all_equal = all_equal and equal[n]
        times = {n: [] for n in names}
        for n in order:
            times[n].append(cuda_ms(runs[n]))
        st = st_this.tolist()
        iters = st[3]
        K = ops[0]
        if p == 1:
            probe = lambda mode: iteration_floor_probe(K, iters, wss=2, mode=mode)  # noqa: E731
        else:
            probe = lambda mode: multipair_floor_probe(K, iters, multipair=p, mode=mode)  # noqa: E731
        chain = cuda_ms(lambda: probe("chain"))
        rows = cuda_ms(lambda: probe("rows"))
        per = lambda ms: ms * 1e3 / max(iters, 1)  # noqa: E731
        ms = {n: float(np.mean(v)) for n, v in times.items()}
        print(f"{label}: {st[0]} updates, {iters} iterations; "
              + ", ".join(f"{n} {ms[n]:.3f} ms ({per(ms[n]):.2f} us/it, turns "
                          f"{', '.join(f'{t:.3f}' for t in times[n])})" for n in names)
              + "; " + ", ".join(f"{n}/this {ms[n] / ms['this']:.3f}" for n in names[1:])
              + f"; floors of this tree: chain {per(chain):.2f} us/it, rows "
              f"{per(rows):.2f} us/it, sum {per(chain + rows):.2f} us/it; "
              f"bit-equal to this {equal}", flush=True)
        results.append({"shape": label, "stat": st, "ms": ms, "turns": times,
                        "chain_floor_ms": chain, "rows_floor_ms": rows,
                        "bit_equal": equal})
    print(json.dumps({"device": smi, "trees": dict(zip(names, [str(ROOT)] + args.tree)),
                      "results": results}))
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
