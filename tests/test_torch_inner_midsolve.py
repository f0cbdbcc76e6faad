"""The inner subproblems' plain versions against the TPU kernel (interpret
mode) on mid-solve working sets: alphas at 0, C and inside the box, f off
-y, some lanes inactive, and duplicated points whose eta == 0 pairs are
shrunk. On the card, tests/test_torch_cuda.py holds the CUDA kernels to
these plain versions bit for bit on the same kind of inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.ops.pallas.inner_smo import inner_smo_pallas
from tpusvm.ops.rbf import rbf_cross
from tpusvm_torch.ops.cuda.inner_smo import inner_smo_multipair_ref, inner_smo_ref

C, EPS, TAU = 10.0, 1e-12, 1e-5


def _mid_solve(q, seed, dup):
    rng = np.random.default_rng(seed)
    X = np.resize(rng.random((q // 4 if dup else q, 8)), (q, 8)).astype(np.float32)
    y = np.where(rng.random(q) < 0.5, 1, -1).astype(np.int32)
    a = rng.choice([0.0, 0.0, C, 2.5, 7.25], size=q).astype(np.float32)
    f = np.round(-y + 0.5 * rng.standard_normal(q), 3).astype(np.float32)
    act = rng.random(q) > 0.15
    K = np.asarray(rbf_cross(jnp.asarray(X), jnp.asarray(X), jnp.float32(0.5)))
    return K, y, a, f, act


def _pallas(K, y, a, f, act, max_inner, **kw):
    a_p, n_p, pr_p, r_p = inner_smo_pallas(
        jnp.asarray(K), jnp.asarray(y), jnp.asarray(a), jnp.asarray(f),
        jnp.asarray(act), C, EPS, TAU, max_inner=max_inner, interpret=True, **kw)
    return np.asarray(a_p), (int(n_p), int(bool(pr_p)), int(r_p))


@pytest.mark.parametrize("dup,max_inner", [(False, 300), (True, 2048)])
@pytest.mark.parametrize("wss,eta_exclude", [(1, False), (2, False), (2, True)])
def test_single_pair_plain_matches_pallas_mid_solve(dup, max_inner, wss, eta_exclude):
    K, y, a, f, act = _mid_solve(128, 11 + wss, dup)
    a_p, st_p = _pallas(K, y, a, f, act, max_inner, wss=wss, eta_exclude=eta_exclude)
    a_t, stat = inner_smo_ref(*(torch.tensor(v) for v in (K, y, a, f, act)), C, EPS, TAU,
                              max_inner=max_inner, wss=wss, eta_exclude=eta_exclude)
    assert tuple(stat.tolist()[:3]) == st_p
    np.testing.assert_allclose(a_t.numpy(), a_p, rtol=0, atol=1e-5 * C)
    # inactive lanes never move
    np.testing.assert_array_equal(a_t.numpy()[~act], a[~act])


@pytest.mark.parametrize("q,p,dup,max_inner", [(512, 2, False, 400), (512, 2, True, 2048),
                                               (1024, 4, True, 600)])
def test_multipair_plain_matches_pallas_mid_solve(q, p, dup, max_inner):
    K, y, a, f, act = _mid_solve(q, q + p, dup)
    a_p, st_p = _pallas(K, y, a, f, act, max_inner, multipair=p)
    a_t, stat = inner_smo_multipair_ref(*(torch.tensor(v) for v in (K, y, a, f, act)), C,
                                        EPS, TAU, max_inner=max_inner, multipair=p)
    assert tuple(stat.tolist()[:3]) == st_p
    np.testing.assert_array_equal(a_t.numpy(), a_p)
    np.testing.assert_array_equal(a_t.numpy()[~act], a[~act])
