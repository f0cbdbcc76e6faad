"""The fused f-update's plain version against the TPU kernel (interpret
mode), at shapes that hit the masked tails the CUDA kernel handles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.ops.pallas.fused_fupdate import rbf_cross_matvec_pallas
from tpusvm.ops.rbf import sq_norms as j_sq_norms
from tpusvm_torch.ops.cuda.fused_fupdate import (rbf_cross_matvec_kernel,
                                                 rbf_cross_matvec_ref)
from tpusvm_torch.ops.rbf import sq_norms


def _inputs(n, q, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, d)).astype(np.float32),
            rng.random((q, d)).astype(np.float32),
            rng.standard_normal(q).astype(np.float32))


def _tol(coef):
    # f32 exp and summation order differ between XLA and torch
    return 1e-5 * float(np.abs(coef).sum())


@pytest.mark.parametrize("n,q,d,block", [
    (1000, 64, 16, 256),   # n not divisible by the block
    (256, 128, 16, 1024),  # block clamps to n
    (777, 32, 37, 128),    # d=37: the d tail, odd everything
    (300, 256, 37, None),  # the kernel's own block choice
])
def test_ref_matches_pallas(n, q, d, block):
    X, XB, coef = _inputs(n, q, d, n + q + d)
    want = np.asarray(rbf_cross_matvec_pallas(
        jnp.asarray(X), jnp.asarray(XB), jnp.asarray(coef), 0.25,
        block=block, interpret=True))
    got = rbf_cross_matvec_ref(torch.tensor(X), torch.tensor(XB),
                               torch.tensor(coef), 0.25)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(coef))


def test_traced_gamma_and_precomputed_sn():
    X, XB, coef = _inputs(300, 64, 8, 3)
    want = np.asarray(rbf_cross_matvec_pallas(
        jnp.asarray(X), jnp.asarray(XB), jnp.asarray(coef), jnp.float32(0.5),
        sn=j_sq_norms(jnp.asarray(X)), interpret=True))
    Xt = torch.tensor(X)
    got = rbf_cross_matvec_ref(Xt, torch.tensor(XB), torch.tensor(coef),
                               torch.tensor(0.5), sn=sq_norms(Xt))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(coef))


def test_wrapper_takes_the_plain_version_on_cpu():
    X, XB, coef = _inputs(130, 128, 37, 5)
    before = rbf_cross_matvec_kernel.launches
    args = (torch.tensor(X), torch.tensor(XB), torch.tensor(coef), 0.1)
    got = rbf_cross_matvec_kernel(*args)
    np.testing.assert_array_equal(got.numpy(),
                                  rbf_cross_matvec_ref(*args).numpy())
    assert rbf_cross_matvec_kernel.launches == before  # no kernel launched
