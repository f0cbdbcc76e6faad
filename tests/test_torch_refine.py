"""refine / max_refines in the port's blocked solver against the JAX
package's blocked_smo_solve(refine=...), mirroring tests/test_blocked.py's
refine cases on the CPU.

Held to the repo's cross-engine criterion: the same status and SV-ID set,
|db| <= 1e-4 (PARITY.md's band at this scale), and the refine firing
(n_refines >= 1) in both packages. The rebuilt f is not bit-equal to
JAX's: the top-|coef| row set is the same, its sum order is not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.data import MinMaxScaler, blobs, mnist_like, rings
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm_torch.solver.blocked import blocked_smo_solve, refine_f
from tpusvm_torch.status import Status

_B_BAND = 1e-4


def _random_512():
    rng = np.random.default_rng(7)
    n, d = 512, 16
    X = rng.random((n, d)).astype(np.float32)
    Y = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    return X, Y, dict(C=10.0, gamma=1.0, tau=1e-5, q=128, max_inner=256,
                      max_outer=2000)


def _scaled(gen, **kw):
    X, Y = gen(**kw)
    return MinMaxScaler().fit_transform(X).astype(np.float32), Y


_CASES = {
    "blobs": lambda: (*_scaled(blobs, n=300, d=4, seed=3),
                      dict(C=1.0, gamma=0.5, q=128)),
    "rings": lambda: (*_scaled(rings, n=400, seed=11),
                      dict(C=10.0, gamma=10.0, q=128)),
    "mnist_like": lambda: (*_scaled(mnist_like, n=600, d=64, seed=5),
                           dict(C=10.0, gamma=1.0 / 64, q=256, wss=2)),
    "random_512": _random_512,
}


def _both(X, Y, kw, **extra):
    kw = dict(kw, max_iter=10**6, **extra)
    r_j = j_solve(jnp.asarray(X), jnp.asarray(Y), accum_dtype=jnp.float64,
                  **kw)
    r_t = blocked_smo_solve(X, Y, accum_dtype=torch.float64, device="cpu",
                            **kw)
    return r_j, r_t


def _sv(alpha):
    return np.flatnonzero(np.asarray(alpha) > 1e-8)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_refine_fires_and_matches_jax(case):
    X, Y, kw = _CASES[case]()
    r_j, r_t = _both(X, Y, kw, refine=len(Y), max_refines=2)
    assert int(r_j.status) == r_t.status == Status.CONVERGED
    assert int(r_j.n_refines) >= 1 and r_t.n_refines >= 1
    assert r_t.n_refines <= 2
    np.testing.assert_array_equal(_sv(r_t.alpha.numpy()), _sv(r_j.alpha))
    assert abs(r_t.b - float(r_j.b)) <= _B_BAND
    # the same optimum as without refine, within the f32 evaluation band
    # of tests/test_blocked.py
    r0 = blocked_smo_solve(X, Y, accum_dtype=torch.float64, device="cpu",
                           max_iter=10**6, **kw)
    assert r0.n_refines == 0
    assert abs(r_t.b - r0.b) <= 1e-3
    np.testing.assert_allclose(r_t.alpha.numpy(), r0.alpha.numpy(), atol=5e-3)


def test_overcap_refine_skips_like_jax():
    """More live alphas than the cap: the rebuild is skipped in both
    packages, and the solve is the refine=0 solve bit for bit."""
    X, Y, kw = _random_512()
    r_j, r_t = _both(X, Y, kw, refine=128, max_refines=2)
    assert int((r_t.alpha > 0).sum()) > 128
    assert int(r_j.n_refines) == r_t.n_refines == 0
    assert int(r_j.status) == r_t.status == Status.CONVERGED
    r0 = blocked_smo_solve(X, Y, accum_dtype=torch.float64, device="cpu",
                           max_iter=10**6, **kw)
    assert torch.equal(r_t.alpha, r0.alpha) and r_t.b == r0.b


@pytest.mark.parametrize("max_refines", [0, 1, 3])
def test_max_refines_bounds_the_rebuilds(max_refines):
    X, Y, kw = _CASES["rings"]()
    r = blocked_smo_solve(X, Y, accum_dtype=torch.float64, device="cpu",
                          max_iter=10**6, refine=len(Y),
                          max_refines=max_refines, **kw)
    assert r.status == Status.CONVERGED
    assert r.n_refines <= max_refines
    if max_refines == 0:
        r0 = blocked_smo_solve(X, Y, accum_dtype=torch.float64, device="cpu",
                               max_iter=10**6, **kw)
        assert torch.equal(r.alpha, r0.alpha)


def test_refine_keeps_two_host_syncs_a_round():
    X, Y, kw = _CASES["rings"]()
    r = blocked_smo_solve(X, Y, accum_dtype=torch.float64, device="cpu",
                          max_iter=10**6, refine=len(Y), **kw)
    # one stop check per body (rounds, refines, the last check) and one
    # kernel-status read per round
    assert r.n_host_syncs == 2 * r.n_outer + r.n_refines + 1


def test_refine_with_fused_selection_raises():
    X, Y, kw = _CASES["rings"]()
    with pytest.raises(ValueError, match="refine"):
        blocked_smo_solve(X, Y, device="cpu", refine=64, fused_selection=True,
                          fused_fupdate=True, **kw)
    with pytest.raises(ValueError, match="refine"):
        j_solve(jnp.asarray(X), jnp.asarray(Y), refine=64,
                pallas_fused_selection=True, fused_fupdate=True)


@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly"])
def test_refine_f_equals_the_full_rebuild(kernel):
    """refine_f over the top-cap rows equals f from every row whenever the
    cap holds every nonzero coefficient (the padding adds exactly 0).
    Tolerance: 1e-5 absolute, f32 sums of 300 terms in different orders."""
    from tpusvm_torch import kernels

    X, Y = _scaled(blobs, n=300, d=4, seed=3)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    r = blocked_smo_solve(Xt, Yt, C=1.0, gamma=0.5, q=128, kernel=kernel,
                          coef0=1.0, accum_dtype=torch.float64, device="cpu")
    yf = Yt.double()
    kern = dict(gamma=0.5, coef0=1.0, degree=3)
    sn = kernels.sq_norms_for(kernel, Xt)
    valid = torch.ones(300, dtype=torch.bool)
    nnz = int((r.alpha != 0).sum())
    f_cap = refine_f(Xt, r.alpha, yf, yf, valid, nnz + 17, kernel=kernel,
                     sn=sn, kern=kern)
    full = kernels.cross_matvec(kernel, Xt, Xt, (r.alpha * yf).float(),
                                sn=sn, **kern).double() - yf
    torch.testing.assert_close(f_cap, full, rtol=0, atol=1e-5)


def test_exact_f_gap_at_refine_zero_jax_beside_port():
    """ROADMAP 7(a)'s question on a CPU cut of the chip's full-width job
    (the same generator and hyperparameters, 1,200 rows, q=256): both
    packages at refine=0 stop on an accumulated f whose f64 rebuild is
    further from the band than 2 tau; the f64 gap b_low - b_high of each,
    with refine and without, is printed for PERF.md. Each gap must stay
    within 10x the band (2e-4): drift, not a wrong optimum."""
    X, Y = mnist_like(n=1200, d=784, noise=30.0, label_noise=0.005, seed=587)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    kw = dict(C=10.0, gamma=0.00125, q=256, wss=2, max_inner=4096)

    def gap(alpha):
        a = np.asarray(alpha, np.float64)
        x = Xs.astype(np.float64)
        y = Y.astype(np.float64)
        sq = (x * x).sum(1)
        K = np.exp(-0.00125 * np.maximum(sq[:, None] + sq[None, :]
                                         - 2.0 * x @ x.T, 0.0))
        f = K @ (a * y) - y
        m_h = np.where(y > 0, a < 10.0 - 1e-12, a > 1e-12)
        m_l = np.where(y > 0, a > 1e-12, a < 10.0 - 1e-12)
        return float(f[m_l].max() - f[m_h].min())

    gaps = {}
    for refine in (0, 4096):
        r_j, r_t = _both(Xs, Y, kw, refine=refine)
        assert int(r_j.status) == r_t.status == Status.CONVERGED
        gaps[refine] = (gap(r_j.alpha), gap(r_t.alpha.numpy()))
        print(f"refine={refine}: f64 gap JAX {gaps[refine][0]:.3e}, port "
              f"{gaps[refine][1]:.3e} (2 tau = 2e-5)")
    assert all(0 < g <= 2e-4 for pair in gaps.values() for g in pair)
