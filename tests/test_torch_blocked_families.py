"""The port's blocked solver with the linear, poly and sigmoid families
and with pseudo-targets, against the JAX `blocked_smo_solve` on the same
inputs, on the CPU.

Band (tests/test_kernels.py:177-182, the cross-engine standard for f32
features with f64 accumulators): the same status, SV sets within
max(2, n_sv // 25) of each other, |b - b_jax| < 2e-2. Both inner engines
run: the port's loop engine against JAX inner="xla", the inner kernel's
plain version against Pallas in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.data import MinMaxScaler
from tpusvm.data import synthetic as jsyn
from tpusvm.kernels.svr import doubled_problem
from tpusvm.oracle import get_sv_indices
from tpusvm.solver.blocked import blocked_smo_solve as j_blocked
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.status import Status

FAMILIES = {"linear": dict(gamma=0.5), "poly": dict(gamma=0.5, degree=3, coef0=1.0),
            "sigmoid": dict(gamma=0.5, coef0=0.0)}


def _sv(alpha):
    return set(get_sv_indices(np.asarray(alpha)).tolist())


def _check(rt, rj):
    assert rt.status == Status(int(rj.status)) == Status.CONVERGED
    sj = _sv(rj.alpha)
    assert len(_sv(rt.alpha) ^ sj) <= max(2, len(sj) // 25)
    assert abs(rt.b - float(rj.b)) < 2e-2


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("inner", ["loop", "kernel"])
def test_blocked_families_match_jax(family, inner):
    X, Y = jsyn.rings(n=400, seed=2)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    kw = dict(C=1.0, kernel=family, q=128, max_inner=256, **FAMILIES[family])
    rj = j_blocked(jnp.asarray(Xs), jnp.asarray(Y), accum_dtype=jnp.float64,
                   inner="xla" if inner == "loop" else "pallas", **kw)
    rt = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y),
                           accum_dtype=torch.float64, inner=inner,
                           device="cpu", **kw)
    _check(rt, rj)


def test_blocked_mnist_like_poly_warm_start_matches_jax():
    X, Y = jsyn.mnist_like(n=600, d=40, seed=4, noise=30.0)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    kw = dict(C=10.0, gamma=1.0 / 40, kernel="poly", degree=2, coef0=1.0,
              q=128, max_inner=512)
    cold = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y), max_outer=2,
                             accum_dtype=torch.float64, device="cpu", **kw)
    a0 = cold.alpha.numpy()
    rj = j_blocked(jnp.asarray(Xs), jnp.asarray(Y), alpha0=jnp.asarray(a0),
                   warm_start=True, accum_dtype=jnp.float64, **kw)
    rt = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y),
                           alpha0=torch.tensor(a0), warm_start=True,
                           accum_dtype=torch.float64, device="cpu", **kw)
    _check(rt, rj)


@pytest.mark.parametrize("family", ["rbf", "linear"])
def test_blocked_with_targets_matches_jax(family):
    X, t = jsyn.svr_sine(n=200, d=1, noise=0.05, seed=3)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    Y2, z = doubled_problem(t, 0.1)
    X2 = np.concatenate([Xs, Xs])
    kw = dict(C=10.0, gamma=20.0, kernel=family, q=128, max_inner=256)
    rj = j_blocked(jnp.asarray(X2), jnp.asarray(Y2), targets=jnp.asarray(z),
                   accum_dtype=jnp.float64, inner="xla", **kw)
    rt = blocked_smo_solve(torch.tensor(X2), torch.tensor(Y2),
                           targets=torch.tensor(z), accum_dtype=torch.float64,
                           inner="loop", device="cpu", **kw)
    _check(rt, rj)


def test_blocked_off_rbf_runs_the_family_contraction(monkeypatch):
    """fused_fupdate='auto' resolves to the family's own f-update off RBF,
    while the inner subproblem still runs the kernel engine."""
    from tpusvm_torch.solver import blocked

    X, Y = jsyn.blobs(n=300, d=4, seed=0)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    called = []
    real = blocked.inner_smo_kernel

    def spy(*a, **k):
        called.append(1)
        return real(*a, **k)

    monkeypatch.setattr(blocked, "inner_smo_kernel", spy)
    monkeypatch.setattr(blocked, "rbf_cross_matvec_kernel",
                        lambda *a, **k: pytest.fail("fused f-update off RBF"))
    r = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y), kernel="sigmoid",
                          gamma=0.5, q=128, accum_dtype=torch.float64,
                          device="cpu")
    assert called and r.status == Status.CONVERGED
