#!/usr/bin/env python3
"""Times the f-update kernels (#1 fused_fupdate, #4 fused_select) of one
checkout on one GPU, to compare two versions in turns on one card.

    python3 scripts/torch_fupdate_bench.py [--tree DIR]

Builds the two kernels from DIR/tpusvm_torch/csrc (default: this checkout;
give another checkout, such as a parent commit unpacked with `git archive`),
then times #1, #4 and torch.matmul(X, XB.T) with chip_smoke.py's `cuda_ms`
at the bench shape (mnist_like n=60000, d=784, q=2048, scaled as the solver
sees it). Their checks against the plain versions are chip_smoke.py's phase
3 and tests/test_torch_cuda.py. The last line is one JSON object with the
figures.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))
from chip_smoke import cuda_ms  # noqa: E402

GAMMA = 0.00125


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.ops.cuda import _build
    from tpusvm_torch.ops.cuda.fused_fupdate import (
        fused_fupdate_select_kernel, rbf_cross_matvec_kernel)
    from tpusvm_torch.ops.rbf import sq_norms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"tree {args.tree}; device: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    secs = _build.build_all(["fused_fupdate", "fused_select"])
    print(f"built in {max(secs.values()):.1f} s")

    X_all, _ = mnist_like(n=70000, d=784, noise=30.0, label_noise=0.005,
                          seed=587)
    Xs = MinMaxScaler().fit(X_all[:60000]).transform(X_all[:60000])
    X = torch.as_tensor(Xs.astype(np.float32), device=dev)
    n, d = X.shape
    q = 2048
    B = torch.as_tensor(np.random.default_rng(0).permutation(n)[:q], device=dev)
    XB = X[B].contiguous()
    coef = (torch.randn(q, generator=torch.Generator().manual_seed(0)) * 0.5).to(dev)
    sn = sq_norms(X)
    y = torch.ones(n, dtype=torch.int32, device=dev)
    z = torch.zeros(n, device=dev)
    k1 = cuda_ms(lambda: rbf_cross_matvec_kernel(X, XB, coef, GAMMA, sn))
    k4 = cuda_ms(lambda: fused_fupdate_select_kernel(
        X, XB, coef, GAMMA, sn, z, z, y, 10.0, 1e-12, block=256, k_cand=8))
    lib = cuda_ms(lambda: torch.matmul(X, XB.T))
    print(f"bench n={n} d={d} q={q}: #1 {k1:.3f} ms "
          f"({2.0 * n * d * q / k1 / 1e9:.1f} TFLOP/s), #4 {k4:.3f} ms, "
          f"torch.matmul(X, XB.T) {lib:.3f} ms")
    print(json.dumps({"tree": args.tree, "device": smi, "k1_ms": k1,
                      "k4_ms": k4, "matmul_ms": lib}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
