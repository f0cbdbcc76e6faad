"""The port's streaming primal solver against the JAX package's, on the CPU.

Bands, on a few shards of a small dataset (1,200 rows in 256-row shards):
  - the JAX package's status, epochs_run and step count, exactly;
  - w within 1e-4 x max |w_jax| (both solve over their own f32 mapped
    rows, which differ by tests/test_torch_approx.py's transform band)
    and the bias within 1e-4;
  - the objective that decides the plateau is read once an epoch from an
    f64 running sum on the device: it has the bits of the host's Python
    float sum of the same batch objectives (a reference loop over
    primal_batch_step here), and so does w;
  - the reader's residency bound holds (live shards <= prefetch_depth + 1)
    and the solver reads the device once an epoch plus once at the end.
"""

import numpy as np
import pytest
import torch

from tpusvm import stream as jstream
from tpusvm.config import SVMConfig as JConfig
from tpusvm.models import BinarySVC as JSVC
from tpusvm_torch import stream
from tpusvm_torch.approx import build_map, primal_batch_step
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import mnist_like
from tpusvm_torch.models import BinarySVC


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    X, Y = mnist_like(n=1200, d=16, noise=3.0, label_noise=0.01, seed=1)
    d = str(tmp_path_factory.mktemp("primal") / "d")
    stream.ingest_arrays(d, X, Y.astype(np.int32), rows_per_shard=256)
    return X, Y.astype(np.int32), d


_CASES = [("rff", dict(rff_dim=512), 128, 0.05, 16),
          ("nystrom", dict(landmarks=128), 128, 0.05, 16),
          ("rff", dict(rff_dim=256), 100, 0.01, 6)]


# the cases that end MAX_ITER warn so, in both packages
_MAX_ITER = "ignore:streaming primal fit ended:RuntimeWarning"


@pytest.mark.filterwarnings(_MAX_ITER)
@pytest.mark.parametrize("family,kw,batch,tol,epochs", _CASES)
def test_primal_matches_jax(shards, family, kw, batch, tol, epochs):
    X, Y, d = shards
    opts = dict(primal_batch=batch, primal_epochs=epochs, primal_tol=tol,
                prefetch_depth=1)
    cfg = dict(C=10.0, gamma=0.05, kernel=family, **kw)
    t = BinarySVC(SVMConfig(**cfg), solver_opts=opts,
                  device="cpu").fit_stream(stream.open_dataset(d))
    j = JSVC(JConfig(**cfg), solver_opts=opts).fit_stream(
        jstream.open_dataset(d))
    pr = t.primal_result_
    assert t.status_ == j.status_
    assert t.n_iter_ == j.n_iter_ == pr.n_steps
    assert pr.epochs_run * -(-len(X) // batch) == pr.n_steps
    wj = np.asarray(j.sv_X_)
    assert np.abs(t.sv_X_ - wj).max() <= 1e-4 * np.abs(wj).max()
    assert abs(t.b_ - j.b_) <= 1e-4
    assert t.stream_max_live_shards_ <= 2
    assert pr.host_syncs == pr.epochs_run + 1
    assert np.mean(t.predict(X) == j.predict(X)) >= 0.99
    assert t.sv_ids_.tolist() == [-1] and t.sv_alpha_.tolist() == [1.0]


@pytest.mark.filterwarnings(_MAX_ITER)
def test_device_objective_sum_has_the_host_sums_bits(shards):
    X, Y, d = shards
    cfg = SVMConfig(C=10.0, gamma=0.05, kernel="rff", rff_dim=256)
    opts = dict(primal_batch=100, primal_epochs=3, primal_tol=0.0)
    t = BinarySVC(cfg, solver_opts=opts, device="cpu").fit_stream(
        stream.open_dataset(d))
    # the reference: the JAX loop's host-side float(obj) sum, step for step
    ds = stream.open_dataset(d)
    sc = ds.scaler()
    fmap = build_map(cfg, n_features=X.shape[1])
    # mapped shard by shard, as the reader's hook maps them
    Z = torch.cat([fmap.transform(torch.as_tensor(
        sc.transform(X[s:s + 256]).astype(np.float32)))
        for s in range(0, len(X), 256)])
    n, lam = len(X), 1.0 / (10.0 * len(X))
    w, b = torch.zeros(fmap.dim), torch.zeros(())
    t_b, t_ex, prev = 1, 0, None
    for _ in range(3):
        obj_sum, k = 0.0, 0
        for s in range(0, n, 100):
            m = min(100, n - s)
            t_ex += m
            w, b, obj = primal_batch_step(
                w, b, Z[s:s + m], torch.as_tensor(Y[s:s + m], dtype=torch.float32),
                torch.ones(m, dtype=torch.bool), lam, float(t_ex), float(t_b))
            obj_sum += float(obj)
            k += 1
            t_b += 1
        prev = obj_sum / k
    assert t.primal_result_.objective == prev
    assert t.sv_X_[0].tobytes() == w.numpy().tobytes()
    assert t.b_ == float(b)


def test_primal_refuses_blocked_knobs(shards):
    _, _, d = shards
    m = BinarySVC(SVMConfig(kernel="rff", rff_dim=128),
                  solver_opts=dict(q=128), device="cpu")
    with pytest.raises(ValueError, match=r"primal knobs.*\['q'\]"):
        m.fit_stream(stream.open_dataset(d))
    with pytest.raises(ValueError, match="n_rows must be >= 1"):
        from tpusvm_torch.approx import streaming_primal_fit

        streaming_primal_fit(lambda e: [], 128, C=1.0, n_rows=0,
                             device="cpu")
