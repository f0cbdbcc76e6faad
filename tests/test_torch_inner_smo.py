"""The inner subproblem's plain version against the TPU kernel (interpret
mode), and the port's accum-dtype loop engine against the JAX loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.ops.pallas.inner_smo import inner_smo_pallas
from tpusvm.ops.rbf import rbf_cross
from tpusvm.solver.blocked import _inner_smo as j_inner_smo
from tpusvm_torch.ops.cuda.inner_smo import inner_smo_kernel, inner_smo_ref
from tpusvm_torch.solver.blocked import _inner_smo as t_inner_smo
from tpusvm_torch.status import Status

C, EPS, TAU = 10.0, 1e-12, 1e-5


def _subproblem(q, seed, d=8, gamma=0.5, dup=False):
    rng = np.random.default_rng(seed)
    if dup:  # exact duplicates -> eta == 0 pairs (the shrink path's food)
        X = np.repeat(rng.random((q // 2, d)).astype(np.float32), 2, axis=0)
    else:
        X = rng.random((q, d)).astype(np.float32)
    y = np.where(rng.random(q) < 0.5, 1, -1).astype(np.int32)
    K = np.asarray(rbf_cross(jnp.asarray(X), jnp.asarray(X), jnp.float32(gamma)))
    return K, y, np.zeros(q, np.float32), -y.astype(np.float32), np.ones(q, bool)


def _both(K, y, a0, f0, act, max_inner, wss, eta_exclude):
    a_p, n_p, pr_p, r_p = inner_smo_pallas(
        jnp.asarray(K), jnp.asarray(y), jnp.asarray(a0), jnp.asarray(f0),
        jnp.asarray(act), C, EPS, TAU, max_inner=max_inner, interpret=True,
        wss=wss, eta_exclude=eta_exclude)
    a_t, stat = inner_smo_ref(
        torch.tensor(K), torch.tensor(y), torch.tensor(a0), torch.tensor(f0),
        torch.tensor(act), C, EPS, TAU, max_inner=max_inner, wss=wss,
        eta_exclude=eta_exclude)
    return (np.asarray(a_p), (int(n_p), int(bool(pr_p)), int(r_p))), \
        (a_t.numpy(), tuple(stat.tolist()[:3]))


_ENGINES = [(1, False), (2, False), (2, True)]


@pytest.mark.parametrize("q", [128, 256])
@pytest.mark.parametrize("wss,eta_exclude", _ENGINES)
def test_ref_matches_pallas(q, wss, eta_exclude):
    K, y, a0, f0, act = _subproblem(q, seed=3)
    (a_p, st_p), (a_t, st_t) = _both(K, y, a0, f0, act, 512, wss, eta_exclude)
    assert st_t == st_p
    np.testing.assert_allclose(a_t, a_p, rtol=0, atol=1e-5 * C)
    # the invariants: box feasibility, sum(y a) conserved, dual ascent
    assert (a_t >= -1e-6).all() and (a_t <= C + 1e-6).all()
    np.testing.assert_allclose(float(np.sum(a_t * y)), 0.0, atol=1e-3)
    Q = K.astype(np.float64) * np.outer(y, y)
    assert a_t.sum() - 0.5 * a_t @ Q @ a_t > 0.1


@pytest.mark.parametrize("wss,eta_exclude", _ENGINES)
def test_ref_matches_pallas_with_degenerate_pairs(wss, eta_exclude):
    """Duplicated points: dead pairs are shrunk, not bailed out on."""
    K, y, a0, f0, act = _subproblem(128, seed=4047, d=4, dup=True)
    (a_p, st_p), (a_t, st_t) = _both(K, y, a0, f0, act, 4096, wss, eta_exclude)
    assert st_t == st_p
    assert st_t[2] in (Status.CONVERGED, Status.NO_WORKING_SET, Status.MAX_ITER)
    np.testing.assert_allclose(a_t, a_p, rtol=0, atol=1e-5 * C)


@pytest.mark.parametrize("wss,eta_exclude", _ENGINES)
def test_all_ties_input_takes_the_same_path(wss, eta_exclude):
    """Every kernel entry and every f equal: all picks are pure ties."""
    q = 128
    K = np.full((q, q), 0.5, np.float32)
    np.fill_diagonal(K, 1.0)
    y = np.tile(np.array([1, -1], np.int32), q // 2)
    (a_p, st_p), (a_t, st_t) = _both(K, y, np.zeros(q, np.float32),
                                     -y.astype(np.float32), np.ones(q, bool),
                                     64, wss, eta_exclude)
    assert st_t == st_p
    np.testing.assert_allclose(a_t, a_p, rtol=0, atol=1e-5 * C)


@pytest.mark.parametrize("wss,eta_exclude", _ENGINES)
def test_all_inf_input_takes_the_same_path(wss, eta_exclude):
    """No active member: every masked lane is +-inf, the "nothing found"
    picks return index 0 and the subproblem ends NO_WORKING_SET."""
    K, y, a0, f0, _ = _subproblem(128, seed=1)
    (a_p, st_p), (a_t, st_t) = _both(K, y, a0, f0, np.zeros(128, bool), 64,
                                     wss, eta_exclude)
    assert st_t == st_p == (0, 0, int(Status.NO_WORKING_SET))
    np.testing.assert_array_equal(a_t, a_p)


def test_wrapper_takes_the_plain_version_on_cpu():
    K, y, a0, f0, act = _subproblem(128, seed=2)
    args = [torch.tensor(v) for v in (K, y, a0, f0, act)]
    before = inner_smo_kernel.launches
    a_k, st_k = inner_smo_kernel(*args, C, EPS, TAU, max_inner=100, wss=2)
    a_r, st_r = inner_smo_ref(*args, C, EPS, TAU, max_inner=100, wss=2)
    np.testing.assert_array_equal(a_k.numpy(), a_r.numpy())
    assert st_k.tolist() == st_r.tolist()
    assert inner_smo_kernel.launches == before


def test_rejects_bad_engine_flags():
    K, y, a0, f0, act = (torch.tensor(v) for v in _subproblem(128, seed=2))
    with pytest.raises(ValueError, match="wss must be"):
        inner_smo_ref(K, y, a0, f0, act, C, EPS, TAU, max_inner=8, wss=3)
    with pytest.raises(ValueError, match="eta_exclude"):
        inner_smo_ref(K, y, a0, f0, act, C, EPS, TAU, max_inner=8,
                      eta_exclude=True)


def _loops(wss, max_inner):
    K, y, _, _, act = _subproblem(128, seed=3)
    a0 = np.zeros(128, np.float64)
    f0 = -y.astype(np.float64)
    a_j, n_j, pr_j, r_j = j_inner_smo(
        jnp.asarray(K), jnp.asarray(y), jnp.asarray(a0), jnp.asarray(f0),
        jnp.asarray(act), C, EPS, TAU, max_inner, wss=wss)
    a_t, n_t, pr_t, r_t = t_inner_smo(
        torch.tensor(K), torch.tensor(y), torch.tensor(a0), torch.tensor(f0),
        torch.tensor(act), C, EPS, TAU, max_inner, wss=wss)
    return ((np.asarray(a_j), int(n_j), bool(pr_j), int(r_j)),
            (a_t.numpy(), n_t, pr_t, int(r_t)))


def test_loop_engine_matches_jax_loop_f64_trajectory():
    """wss=1: the same 300-update trajectory, to f64 rounding."""
    (a_j, *st_j), (a_t, *st_t) = _loops(1, 300)
    assert st_t == st_j
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=1e-9)


@pytest.mark.parametrize("wss", [1, 2])
def test_loop_engine_matches_jax_loop_f64_optimum(wss):
    """Run to the subproblem optimum: the same end, the same alphas to the
    solver's cross-engine band. (At wss=2 the gain argmax amplifies the
    last-bit differences between XLA's contracted f64 row update and
    torch's separate multiply and add into a different path.)"""
    (a_j, n_j, pr_j, r_j), (a_t, n_t, pr_t, r_t) = _loops(wss, 20000)
    assert (pr_t, r_t) == (pr_j, r_j) == (True, int(Status.CONVERGED))
    assert abs(n_t - n_j) <= 0.1 * n_j
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=2e-3)
