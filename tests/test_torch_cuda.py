"""The CUDA kernels against their plain versions on the card, and a fit
that goes through both. Marked `cuda`: skipped where no CUDA device is
present (run on the card with `python -m pytest tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.synthetic import mnist_like
from tpusvm_torch.models.svm import BinarySVC
from tpusvm_torch.ops.cuda.fused_fupdate import (rbf_cross_matvec_kernel,
                                                 rbf_cross_matvec_ref)
from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_kernel, inner_smo_ref,
                                             iteration_floor_probe)
from tpusvm_torch.ops.rbf import rbf_cross

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,q", [(1000, 37, 256), (4099, 784, 512), (7, 3, 5)])
def test_fused_fupdate_kernel_matches_plain(dev, n, d, q):
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(q), dtype=torch.float32, device=dev)
    got = rbf_cross_matvec_kernel(X, XB, coef, 0.1)
    want = rbf_cross_matvec_ref(X, XB, coef, 0.1)
    torch.cuda.synchronize()
    tol = 1e-5 * float(coef.abs().sum())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("q", [128, 256, 2048])
@pytest.mark.parametrize("wss,eta_exclude", [(1, False), (2, False), (2, True)])
def test_inner_smo_kernel_matches_plain(dev, q, wss, eta_exclude):
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.random((q, 8)), dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.where(rng.random(q) < 0.5, 1, -1), device=dev)
    args = (rbf_cross(X, X, 0.5), y, torch.zeros(q, device=dev), -y.float(),
            torch.ones(q, dtype=torch.bool, device=dev), 10.0, 1e-12, 1e-5)
    a_k, st_k = inner_smo_kernel(*args, max_inner=512, wss=wss,
                                 eta_exclude=eta_exclude)
    a_r, st_r = inner_smo_ref(*args, max_inner=512, wss=wss,
                              eta_exclude=eta_exclude)
    torch.cuda.synchronize()
    assert st_k.tolist()[:3] == st_r.tolist()[:3]
    assert float((a_k - a_r).abs().max()) <= 1e-5 * 10.0


@pytest.mark.parametrize("mode", ["chain", "rows"])
def test_iteration_floor_probe_runs(dev, mode):
    K = torch.rand(256, 256, device=dev)
    before = inner_smo_kernel.launches
    out = iteration_floor_probe(K, 100, wss=2, mode=mode)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert inner_smo_kernel.launches == before


def test_fit_launches_both_kernels(dev):
    X, Y = mnist_like(n=3000, d=784, noise=30.0, label_noise=0.005)
    rbf_cross_matvec_kernel.launches = 0
    inner_smo_kernel.launches = 0
    m = BinarySVC(SVMConfig(max_iter=10**6), device="cuda",
                  solver_opts=dict(q=256, wss=2, max_inner=512)).fit(X, Y)
    assert m.status_.name == "CONVERGED"
    assert rbf_cross_matvec_kernel.launches > 0
    assert inner_smo_kernel.launches > 0
