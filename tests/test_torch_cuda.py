"""The CUDA kernels against their plain versions on the card, and fits
that go through them. Marked `cuda`: skipped where no CUDA device is
present (run on the card with `python -m pytest tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.synthetic import mnist_like
from tpusvm_torch.models.svm import BinarySVC
from tpusvm_torch.ops.cuda.fused_fupdate import (fused_fupdate_select_kernel,
                                                 rbf_cross_matvec_3xtf32,
                                                 rbf_cross_matvec_kernel,
                                                 rbf_cross_matvec_ref,
                                                 select_candidates_ref,
                                                 select_epilogue_probe)
from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_kernel,
                                             inner_smo_multipair_kernel,
                                             inner_smo_multipair_ref,
                                             inner_smo_ref,
                                             iteration_floor_probe,
                                             multipair_floor_probe)
from tpusvm_torch.ops.rbf import rbf_cross

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# d=784: a d tail inside a 32-wide k slice; d=37 and d=3: the padded
# columns; n not a multiple of the 128-row unit; q=5 and q=2048
@pytest.mark.parametrize("n,d,q", [(1000, 37, 256), (4099, 784, 512), (7, 3, 5),
                                   (4099, 784, 2048), (300, 3, 2048),
                                   (129, 784, 5), (513, 37, 2048)])
def test_fused_fupdate_kernel_matches_plain(dev, n, d, q):
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(q), dtype=torch.float32, device=dev)
    got = rbf_cross_matvec_kernel(X, XB, coef, 0.1)
    want = rbf_cross_matvec_ref(X, XB, coef, 0.1)
    torch.cuda.synchronize()
    tol = 1e-5 * float(coef.abs().sum())
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol
    # the same call again gives the same bits: a fixed summation order
    assert torch.equal(rbf_cross_matvec_kernel(X, XB, coef, 0.1), got)


@pytest.mark.parametrize("d", [784, 37])
def test_fused_fupdate_kernel_takes_a_misaligned_view(dev, d):
    rng = np.random.default_rng(d)
    X = torch.as_tensor(rng.random((1000, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((256, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(256), dtype=torch.float32, device=dev)
    buf = torch.empty(X.numel() + 1, device=dev)
    Xm = buf[1:].view(X.shape)  # 4 bytes past a 16-byte boundary
    Xm.copy_(X)
    assert Xm.data_ptr() % 16 != 0
    got = rbf_cross_matvec_kernel(Xm, XB, coef, 0.1)
    assert torch.equal(got, rbf_cross_matvec_kernel(X, XB, coef, 0.1))


@pytest.mark.parametrize("n,d,q", [(1000, 37, 256), (4099, 784, 2048)])
def test_fused_fupdate_kernel_matches_the_3xtf32_model(dev, n, d, q):
    """The kernel against the CPU tests' 3xTF32 model on the same inputs,
    within the f-update's tolerance 1e-5 * sum|coef|."""
    rng = np.random.default_rng(q)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(q), dtype=torch.float32, device=dev)
    got = rbf_cross_matvec_kernel(X, XB, coef, 0.1)
    model = rbf_cross_matvec_3xtf32(X, XB, coef, 0.1)
    torch.cuda.synchronize()
    assert float((got - model).abs().max()) <= 1e-5 * float(coef.abs().sum())


def test_fused_fupdate_3xtf32_error_under_a_tenth_of_single_pass_tf32(dev):
    """Kernel values K(x_i, xb_k) of four columns (coef one-hot, so the sum
    adds exact zeros) at gamma = 1 / median d2, against f64: the 3xTF32
    contraction's error must be under a tenth of a single-pass TF32
    product's on the same inputs, which it is only if the lo terms apply."""
    rng = np.random.default_rng(11)
    n, d, q = 4099, 784, 2048
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    X64, XB64 = X.double(), XB.double()
    d2_64 = ((X64 * X64).sum(1)[:, None] + (XB64 * XB64).sum(1)[None, :]
             - 2.0 * (X64 @ XB64.T)).clamp_min(0.0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dot_tf32 = X @ XB.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    sn, snB = (X * X).sum(1), (XB * XB).sum(1)
    err_k = err_t = 0.0
    for k in (0, 700, 1400, q - 1):
        g = 1.0 / float(d2_64[:, k].median())
        ref = torch.exp(-g * d2_64[:, k])
        coef = torch.zeros(q, device=dev)
        coef[k] = 1.0
        got = rbf_cross_matvec_kernel(X, XB, coef, g, sn)
        tf32 = torch.exp(-g * (sn + snB[k] - 2.0 * dot_tf32[:, k]).clamp_min(0.0))
        err_k = max(err_k, float((got.double() - ref).abs().max()))
        err_t = max(err_t, float((tf32.double() - ref).abs().max()))
    assert err_t > 0 and err_k < 0.1 * err_t


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


@pytest.mark.parametrize("q,p", [(512, 2), (1024, 4), (2048, 8)])
def test_multipair_kernel_matches_plain(dev, q, p):
    rng = np.random.default_rng(q + p)
    X = torch.as_tensor(rng.random((q, 8)), dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.where(rng.random(q) < 0.5, 1, -1), device=dev)
    args = (rbf_cross(X, X, 0.5), y, torch.zeros(q, device=dev), -y.float(),
            torch.ones(q, dtype=torch.bool, device=dev), 10.0, 1e-12, 1e-5)
    before = inner_smo_kernel.launches
    a_k, st_k = inner_smo_multipair_kernel(*args, max_inner=1024, multipair=p)
    a_r, st_r = inner_smo_multipair_ref(*args, max_inner=1024, multipair=p)
    torch.cuda.synchronize()
    assert st_k.tolist() == st_r.tolist()
    assert float((a_k - a_r).abs().max()) <= 1e-5 * 10.0
    assert inner_smo_kernel.launches == before


@pytest.mark.parametrize("n,d,q,block,k_cand", [(1000, 37, 256, 128, 16),
                                                (300, 3, 64, 64, 32),
                                                (4099, 784, 512, 512, 8),
                                                (4099, 784, 2048, 256, 8),
                                                (129, 3, 5, 64, 8)])
def test_fused_select_kernel_matches_plain(dev, n, d, q, block, k_cand):
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(q), dtype=torch.float32, device=dev)
    f = torch.as_tensor(np.round(rng.standard_normal(n), 1), dtype=torch.float32,
                        device=dev)
    a = torch.as_tensor(rng.choice([0.0, 10.0, 2.5], size=n), dtype=torch.float32,
                        device=dev)
    y_eff = torch.as_tensor(np.where(rng.random(n) < 0.5, 1, -1)
                            * (rng.random(n) > 0.1), dtype=torch.int32, device=dev)
    df, *cands = fused_fupdate_select_kernel(X, XB, coef, 0.1, None, f, a, y_eff,
                                             10.0, 1e-12, block=block,
                                             k_cand=k_cand)
    want = select_candidates_ref(f + df, a, y_eff, 10.0, 1e-12, n, block, k_cand)
    alone = select_epilogue_probe(df, f, a, y_eff, 10.0, 1e-12, block=block,
                                  k_cand=k_cand)
    torch.cuda.synchronize()
    assert torch.equal(df, rbf_cross_matvec_kernel(X, XB, coef, 0.1))
    for got, w, e in zip(cands, want, alone):
        assert torch.equal(got, w) and torch.equal(e, w)


@pytest.mark.parametrize("mode", ["chain", "rows"])
def test_multipair_floor_probe_runs(dev, mode):
    K = torch.rand(512, 512, device=dev)
    before = inner_smo_multipair_kernel.launches
    out = multipair_floor_probe(K, 100, multipair=2, mode=mode)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert inner_smo_multipair_kernel.launches == before


def test_fit_launches_the_multipair_and_select_kernels(dev):
    X, Y = mnist_like(n=3000, d=784, noise=30.0, label_noise=0.005)
    inner_smo_multipair_kernel.launches = 0
    fused_fupdate_select_kernel.launches = 0
    m = BinarySVC(SVMConfig(max_iter=10**6), device="cuda",
                  solver_opts=dict(q=512, wss=1, max_inner=512, multipair=2,
                                   fused_selection=True)).fit(X, Y)
    assert m.status_.name == "CONVERGED"
    assert inner_smo_multipair_kernel.launches > 0
    assert fused_fupdate_select_kernel.launches > 0
