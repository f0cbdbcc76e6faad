"""Plain reference of the RBF C-SVC: scaling, kernel blocks, a blocked
SMO solve and the judge of any solve's alphas.

Conventions are the reference implementation's: labels y in {+1, -1},
f = K (alpha * y) - y, the index sets I_up = {y=+1, a < C-eps} u {y=-1,
a > eps} and I_low = {y=+1, a > eps} u {y=-1, a < C-eps}, Keerthi's stop
b_low <= b_high + 2 tau with b_high = min over I_up of f and b_low = max
over I_low of f, b = (b_high + b_low) / 2 and the decision value
sum_k a_k y_k K(x, x_k) - b.

precision "f64": every kernel value is computed in float64 from the
float32 feature values. "bf16", the control one step below what the
configuration states (float32 at TF32 grade), rounds the features to
bfloat16 and computes the rest as "f64" does. "tf32", a reading of
what that grade admits, takes TF32 operands in the dot products of the
squared distance (the 10-bit mantissa a TF32 tensor-core product reads;
products exact and sums in float32, as such a product computes them),
with the norms, distances and exponentials in float32. The solver's
alphas and gradients stay float64 in all.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("f64", "tf32", "bf16")
_DEGENERATE_RANGE = 1e-12
# rows of X a kernel block holds: (block, q) float64 entries at a time
_BLOCK = 8192


def minmax_scale(X_train: np.ndarray, X: np.ndarray) -> np.ndarray:
    """X scaled per feature by X_train's min and range, in float64; a
    range below 1e-12 counts as 1."""
    lo = X_train.min(axis=0)
    r = X_train.max(axis=0) - lo
    r = np.where(r < _DEGENERATE_RANGE, 1.0, r)
    return (np.asarray(X, np.float64) - lo) / r


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero (the conversion a TF32 tensor-core product
    applies to its operands)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def rbf_block(A: torch.Tensor, B: torch.Tensor, gamma: float,
              precision: str = "f64") -> torch.Tensor:
    """K(A, B) as float64, A (m, d) and B (k, d) float32 feature values."""
    if precision in ("f64", "bf16"):
        if precision == "bf16":
            A, B = A.to(torch.bfloat16), B.to(torch.bfloat16)
        A64, B64 = A.double(), B.double()
        d2 = ((A64 * A64).sum(1)[:, None] + (B64 * B64).sum(1)[None, :]
              - 2.0 * (A64 @ B64.T))
        return torch.exp(-float(gamma) * d2.clamp_min(0.0))
    if precision == "tf32":
        dot = to_tf32(A) @ to_tf32(B).T
        d2 = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * dot
        g32 = torch.tensor(gamma, dtype=torch.float32, device=A.device)
        return torch.exp(-g32 * d2.clamp_min(0.0)).double()
    raise ValueError(f"precision must be one of {PRECISIONS}, "
                     f"got {precision!r}")


def kernel_matvec(X: torch.Tensor, XB: torch.Tensor, coef: torch.Tensor,
                  gamma: float, precision: str = "f64") -> torch.Tensor:
    """K(X, XB) @ coef in float64, in blocks of rows."""
    out = torch.empty(X.shape[0], dtype=torch.float64, device=X.device)
    for s in range(0, X.shape[0], _BLOCK):
        out[s:s + _BLOCK] = rbf_block(X[s:s + _BLOCK], XB, gamma,
                                      precision) @ coef
    return out


def index_sets(alpha, y_pos, C: float, eps: float):
    """(I_up, I_low) masks, torch or numpy alike."""
    if isinstance(alpha, np.ndarray):
        where = np.where
    else:
        where = torch.where
    up = where(y_pos, alpha < C - eps, alpha > eps)
    low = where(y_pos, alpha > eps, alpha < C - eps)
    return up, low


def _inner(K: np.ndarray, y: np.ndarray, a: np.ndarray, f: np.ndarray,
           C: float, eps: float, tau: float, max_inner: int):
    """Pairwise SMO on the working set's K (q, q), float64 on the host:
    i the first-order I_up pick, j the second-order (maximal gain) I_low
    partner. Returns (new alphas, updates)."""
    a, f = a.copy(), f.copy()
    diag = K.diagonal().copy()
    y_pos = y > 0
    up, low = index_sets(a, y_pos, C, eps)
    inf = np.inf
    n_upd = 0
    while n_upd < max_inner:
        fu = np.where(up, f, inf)
        i = int(fu.argmin())
        b_up = fu[i]
        fl = np.where(low, f, -inf)
        b_low = fl.max()
        if not (np.isfinite(b_up) and np.isfinite(b_low)) \
                or b_low <= b_up + 2.0 * tau:
            break
        Ki = K[i]
        eta = diag[i] + diag - 2.0 * Ki
        viol = low & (f > b_up) & (eta > eps)
        if viol.any():
            j = int(np.where(viol, (f - b_up) ** 2 / np.maximum(eta, 1e-12),
                             -inf).argmax())
        else:
            j = int(fl.argmax())
        e = eta[j]
        if e <= eps:
            break
        s = y[i] * y[j]
        if s < 0:
            lo, hi = max(0.0, a[j] - a[i]), min(C, C + a[j] - a[i])
        else:
            lo, hi = max(0.0, a[j] + a[i] - C), min(C, a[j] + a[i])
        if lo > hi + 1e-12:
            break
        aj = min(max(a[j] + y[j] * (f[i] - f[j]) / e, lo), hi)
        ai = a[i] + s * (a[j] - aj)
        da_i, da_j = ai - a[i], aj - a[j]
        if da_i == 0.0 and da_j == 0.0:
            break
        f += (da_i * y[i]) * Ki + (da_j * y[j]) * K[j]
        a[i], a[j] = ai, aj
        for k in (i, j):
            up[k] = a[k] < C - eps if y_pos[k] else a[k] > eps
            low[k] = a[k] > eps if y_pos[k] else a[k] < C - eps
        n_upd += 1
    return a, n_upd


def solve(X: torch.Tensor, y, *, C: float, gamma: float, eps: float,
          tau: float, q: int, max_inner: int, max_iter: int,
          max_outer: int = 5000, precision: str = "f64") -> dict:
    """A blocked SMO solve of the C-SVC dual on float32 features X (n, d)
    (any device): each round takes the q/2 smallest-f I_up and the q/2
    largest-f I_low rows, solves that subproblem to the stop tolerance
    (`_inner`), and updates f over all rows. Returns {"alpha" (n,)
    float64 numpy, "b", "status" ("CONVERGED", "MAX_ITER", "STALLED" or
    "NO_WORKING_SET"), "updates", "rounds"}."""
    dev = X.device
    y = torch.as_tensor(np.asarray(y), device=dev)
    y_pos = y > 0
    yd = y.to(torch.float64)
    n = y.shape[0]
    alpha = torch.zeros(n, dtype=torch.float64, device=dev)
    f = -yd
    half = max(1, q // 2)
    n_upd = rounds = 0
    status = "MAX_ITER"
    b = float("nan")
    for _ in range(max_outer):
        up, low = index_sets(alpha, y_pos, C, eps)
        if not (bool(up.any()) and bool(low.any())):
            status = "NO_WORKING_SET"
            break
        b_up = float(torch.where(up, f, float("inf")).min())
        b_low = float(torch.where(low, f, -float("inf")).max())
        b = 0.5 * (b_up + b_low)
        if b_low <= b_up + 2.0 * tau:
            status = "CONVERGED"
            break
        if n_upd >= max_iter:
            break
        k_up = min(half, int(up.sum()))
        pick_up = torch.topk(torch.where(up, f, float("inf")), k_up,
                             largest=False).indices
        low_free = low.clone()
        low_free[pick_up] = False
        k_low = min(half, int(low_free.sum()))
        pick_low = torch.topk(torch.where(low_free, f, -float("inf")), k_low,
                              largest=True).indices
        B = torch.cat([pick_up, pick_low])
        XB = X[B]
        K = rbf_block(XB, XB, gamma, precision).cpu().numpy()
        yB = yd[B].cpu().numpy()
        aB = alpha[B].cpu().numpy()
        a_new, upd = _inner(K, yB, aB, f[B].cpu().numpy(), C, eps, tau,
                            max_inner)
        rounds += 1
        if upd == 0:
            status = "STALLED"
            break
        da = torch.as_tensor(a_new - aB, device=dev)
        alpha[B] += da
        moved = da != 0
        coef = (da * yd[B])[moved]
        f = f + kernel_matvec(X, XB[moved], coef, gamma, precision)
        n_upd += upd
    return {"alpha": alpha.cpu().numpy(), "b": b, "status": status,
            "updates": n_upd, "rounds": rounds}


def judge(X: torch.Tensor, y, alpha: np.ndarray, *, C: float, gamma: float,
          eps: float) -> dict:
    """Any solve's alphas judged in float64 against the problem they
    claim to solve: f rebuilt from them over every row, then {"gap":
    b_low - b_high, "b": the midpoint, "dual": sum(a) - a'Qa/2,
    "box": how far any alpha lies outside [0, C], "balance": |sum a y|}."""
    dev = X.device
    y = torch.as_tensor(np.asarray(y), device=dev)
    yd = y.to(torch.float64)
    a = torch.as_tensor(np.asarray(alpha, np.float64), device=dev)
    nz = a != 0
    coef = (a * yd)[nz]
    f = kernel_matvec(X, X[nz], coef, gamma) - yd
    up, low = index_sets(a, y > 0, C, eps)
    b_up = float(torch.where(up, f, float("inf")).min())
    b_low = float(torch.where(low, f, -float("inf")).max())
    return {"gap": b_low - b_up, "b": 0.5 * (b_up + b_low),
            "dual": float(a.sum() - 0.5 * (a * yd * (f + yd)).sum()),
            "box": float(torch.clamp(torch.maximum(-a, a - C), min=0).max()),
            "balance": float((a * yd).sum().abs())}


def decision(X_test: torch.Tensor, sv_X: torch.Tensor, coef, b: float,
             gamma: float) -> np.ndarray:
    """sum_k coef_k K(x, sv_k) - b for every row of X_test, in float64."""
    coef = torch.as_tensor(np.asarray(coef, np.float64), device=sv_X.device)
    return (kernel_matvec(X_test, sv_X, coef, gamma) - b).cpu().numpy()
