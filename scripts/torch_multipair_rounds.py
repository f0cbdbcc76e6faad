#!/usr/bin/env python3
"""Per-round trace of tpusvm_torch's blocked solve with the multipair kernel.

    python3 scripts/torch_multipair_rounds.py [P ...]    # on a CUDA card

Runs the full-width MNIST-shaped job of chip_smoke.py (mnist_like n=70000,
d=784, rows [:60000], C=10, gamma=0.00125, q=2048, wss=1, max_inner=4096,
fused selection on) for each p given (default: 1 2 4 8), with the outer loop
of tpusvm_torch/solver/blocked.py written out so that every 20th round can
print the Keerthi gap b_low - b_high, the dual objective
sum(a) - 1/2 sum(a y (f + y)) and the inner kernel's stat. A dual that
falls between rounds means the round's Jacobi slot steps overshot. Stops
at convergence or after 400 rounds.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tpusvm_torch.data.scaler import MinMaxScaler  # noqa: E402
from tpusvm_torch.data.synthetic import mnist_like  # noqa: E402
from tpusvm_torch.ops.cuda.fused_fupdate import (  # noqa: E402
    fused_fupdate_select_kernel, selection_shape)
from tpusvm_torch.ops.cuda.inner_smo import inner_smo_kernel  # noqa: E402
from tpusvm_torch.ops.rbf import rbf_cross, sq_norms  # noqa: E402
from tpusvm_torch.ops.selection import i_high_mask, i_low_mask  # noqa: E402
from tpusvm_torch.solver.blocked import (  # noqa: E402
    bootstrap_candidates, select_from_candidates)

C, EPS, TAU, GAMMA, Q, MAX_INNER, ROUNDS = 10.0, 1e-12, 1e-5, 0.00125, 2048, 4096, 400


def trace(X, Y, p):
    n = Y.shape[0]
    dev = X.device
    sn = sq_norms(X)
    yf = Y.double()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    alpha = torch.zeros(n, dtype=torch.float64, device=dev)
    f = -yf
    block, _, k_cand, ncand = selection_shape(n, X.shape[1], Q)
    cands = bootstrap_candidates(f, alpha, Y, valid, C, EPS, ncand)
    updates = 0
    t0 = time.perf_counter()
    for r in range(1, ROUNDS + 1):
        m_h = i_high_mask(alpha, Y, C, EPS)
        m_l = i_low_mask(alpha, Y, C, EPS)
        gap = float(torch.where(m_l, f, -np.inf).max()
                    - torch.where(m_h, f, np.inf).min())
        if gap <= 2 * TAU:
            break
        B, first = select_from_candidates(cands, m_h, Q // 2)
        a_B, y_B = alpha[B], Y[B]
        act = first & (i_high_mask(a_B, y_B, C, EPS) | i_low_mask(a_B, y_B, C, EPS))
        a_new, stat = inner_smo_kernel(rbf_cross(X[B], X[B], GAMMA), y_B, a_B, f[B],
                                       act, C, EPS, TAU, max_inner=MAX_INNER,
                                       multipair=p)
        da = a_new.double() - a_B.float().double()
        alpha.index_add_(0, B, da)
        df, *cands = fused_fupdate_select_kernel(
            X, X[B], (da * y_B.double()).float(), GAMMA, sn, f.float(),
            alpha.float(), Y.to(torch.int32), C, EPS, block=block, k_cand=k_cand)
        f = f + df.double()
        st = stat.tolist()
        updates += st[0]
        if r % 20 == 0:
            dual = float(alpha.sum() - 0.5 * (alpha * yf * (f + yf)).sum())
            print(f"  p={p} round {r}: updates {updates}, gap {gap:.3e}, dual "
                  f"{dual:.6f}, inner stat {st}", flush=True)
    torch.cuda.synchronize()
    print(f"p={p}: {'CONVERGED' if gap <= 2 * TAU else 'not converged'} after "
          f"{r - 1} rounds, {updates} updates, {time.perf_counter() - t0:.2f} s",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    X_all, Y_all = mnist_like(n=70000, d=784, noise=30.0, label_noise=0.005,
                              seed=587)
    Xs = MinMaxScaler().fit(X_all[:60000]).transform(X_all[:60000])
    X = torch.as_tensor(Xs.astype(np.float32), device="cuda")
    Y = torch.as_tensor(Y_all[:60000], device="cuda")
    for p in [int(a) for a in sys.argv[1:]] or [1, 2, 4, 8]:
        trace(X, Y, p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
