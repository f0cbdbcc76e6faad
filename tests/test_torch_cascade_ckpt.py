"""Cascade round checkpoints: the port's against the JAX package's format.

Band: bit for bit. A round checkpoint written by either package loads in
the other with every field equal bit for bit; a port fit stopped after
round k and resumed equals the uninterrupted fit bit for bit (SV IDs,
alpha bits, b, rounds); `_resume_fingerprint` equals the JAX function's
output and `_check_resume_fingerprints` raises the JAX messages. A fit
resumed from a JAX checkpoint lands on the oracle's SV-ID set with b
within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpusvm.config import CascadeConfig as JCascadeConfig
from tpusvm.config import SVMConfig as JSVMConfig
from tpusvm.parallel import cascade as jc
from tpusvm.parallel import svbuffer as jsb
from tpusvm_torch.config import CascadeConfig, SVMConfig
from tpusvm_torch.data import MinMaxScaler, rings
from tpusvm_torch.oracle import get_sv_indices, smo_train
from tpusvm_torch.parallel import cascade as tc
from tpusvm_torch.parallel import svbuffer as tsb

CFG = SVMConfig(C=10.0, gamma=10.0)


@pytest.fixture(scope="module")
def data():
    # three rounds or more at P=4 (the rows of test_torch_cli_front.py's
    # rings CSV)
    X, Y = rings(n=320, seed=13)
    return MinMaxScaler().fit_transform(X), Y


def _fit(Xs, Y, cc, cfg=CFG, **kw):
    return tc.cascade_fit(Xs, Y, cfg, cc, dtype=torch.float64, device="cpu",
                          **kw)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")) if a.dtype.kind == "f" else a


def _buf_np(seed, dtype=np.float32, alpha_dtype=np.float32):
    rng = np.random.default_rng(seed)
    valid = rng.random(12) < 0.6
    return dict(
        X=rng.standard_normal((12, 3)).astype(dtype),
        Y=np.where(valid, 1, 0).astype(np.int32),
        alpha=np.where(valid, rng.random(12), 0).astype(alpha_dtype),
        ids=np.where(valid, np.arange(12) * 3, -1).astype(np.int32),
        valid=valid)


def _same(a, b):
    for name in tsb.SVBuffer._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=name)


def _host(buf):
    return tsb.SVBuffer(*(t.numpy() for t in buf))


@pytest.mark.parametrize("adt", [np.float32, np.float64])
def test_save_load_round_trip(tmp_path, adt):
    f = _buf_np(0, alpha_dtype=adt)
    buf = tsb.SVBuffer(**{k: torch.as_tensor(v) for k, v in f.items()})
    path = str(tmp_path / "r.npz")
    tc.save_round_state(path, buf, {9, 3, 0}, 4, 0.25, n_shards=4,
                        topology="star")
    got, prev, nxt, b = tc.load_round_state(path, torch.float32)
    _same(_host(got), _host(buf))
    assert prev == {0, 3, 9} and nxt == 5 and b == 0.25
    assert not list(tmp_path.glob("*.tmp*"))


def test_port_checkpoint_loads_in_jax_and_back(tmp_path):
    f = _buf_np(1, alpha_dtype=np.float64)
    tbuf = tsb.SVBuffer(**{k: torch.as_tensor(v) for k, v in f.items()})
    jbuf = jsb.SVBuffer(**{k: jnp.asarray(v) for k, v in f.items()})
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tc.save_round_state(tpath, tbuf, {3, 6}, 2, -0.125, n_shards=2,
                        topology="tree")
    jc.save_round_state(jpath, jbuf, {3, 6}, 2, -0.125, n_shards=2,
                        topology="tree")
    with np.load(tpath) as a, np.load(jpath) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
    for path in (tpath, jpath):
        jg, jprev, jn, jb = jc.load_round_state(path, jnp.float32)
        tg, tprev, tn, tb = tc.load_round_state(path, torch.float32)
        _same(jsb.SVBuffer(*(np.asarray(x) for x in jg)), _host(tg))
        assert (jprev, jn, jb) == (tprev, tn, tb)
        jc.check_round_state_config(path, 2, "tree")
        tc.check_round_state_config(path, 2, "tree")


def test_jax_checkpoint_resumes_in_the_port(tmp_path, data):
    Xs, Y = data
    o = smo_train(Xs, Y, CFG)
    path = str(tmp_path / "j.npz")
    jres = jc.cascade_fit(
        Xs, Y, JSVMConfig(C=CFG.C, gamma=CFG.gamma, max_rounds=1),
        JCascadeConfig(n_shards=4, sv_capacity=256, topology="tree"),
        dtype=jnp.float64, checkpoint_path=path)
    assert jres.rounds == 1 and not jres.converged
    res = _fit(Xs, Y, CascadeConfig(n_shards=4, sv_capacity=256,
                                    topology="tree"),
               checkpoint_path=path, resume=True)
    assert res.converged and res.history[0]["round"] == 2
    assert set(res.sv_ids.tolist()) == set(get_sv_indices(o.alpha).tolist())
    np.testing.assert_allclose(res.b, o.b, atol=1e-4)
    # and the port's last write loads in the JAX package
    jg, prev, nxt, b = jc.load_round_state(path, jnp.float64)
    assert nxt == res.rounds + 1 and b == res.b
    assert prev == set(res.sv_ids.tolist())


@pytest.mark.parametrize("topology,solver,stop", [
    ("tree", "pair", 1), ("tree", "pair", 2), ("star", "pair", 2),
    ("tree", "blocked", 2), ("star", "blocked", 1)])
def test_resume_equals_uninterrupted_run(tmp_path, data, topology, solver,
                                         stop):
    Xs, Y = data
    cc = CascadeConfig(n_shards=4, sv_capacity=256, topology=topology)
    opts = {"q": 64} if solver == "blocked" else None
    full = _fit(Xs, Y, cc, solver=solver, solver_opts=opts)
    assert full.converged and full.rounds > stop
    path = str(tmp_path / "c.npz")
    part = _fit(Xs, Y, cc, cfg=SVMConfig(C=10.0, gamma=10.0, max_rounds=stop),
                solver=solver, solver_opts=opts, checkpoint_path=path)
    assert part.rounds == stop and not part.converged
    res = _fit(Xs, Y, cc, solver=solver, solver_opts=opts,
               checkpoint_path=path, resume=True)
    np.testing.assert_array_equal(res.sv_ids, full.sv_ids)
    np.testing.assert_array_equal(_bits(res.sv_alpha), _bits(full.sv_alpha))
    np.testing.assert_array_equal(_bits(res.sv_X), _bits(full.sv_X))
    assert res.b == full.b and res.rounds == full.rounds and res.converged
    for h, hf in zip(res.history, full.history[stop:]):
        np.testing.assert_array_equal(h["sv_ids"], hf["sv_ids"])
        np.testing.assert_array_equal(h["iters"], hf["iters"])
        assert h["b"] == hf["b"]


def test_resume_past_max_rounds_returns_the_checkpoint(tmp_path, data):
    Xs, Y = data
    cc = CascadeConfig(n_shards=2, sv_capacity=256, topology="star")
    path = str(tmp_path / "c.npz")
    part = _fit(Xs, Y, cc, cfg=SVMConfig(C=10.0, gamma=10.0, max_rounds=1),
                checkpoint_path=path)
    with pytest.warns(RuntimeWarning, match="already at round 1"):
        res = _fit(Xs, Y, cc, cfg=SVMConfig(C=10.0, gamma=10.0, max_rounds=1),
                   checkpoint_path=path, resume=True)
    assert res.rounds == 1 and not res.history
    np.testing.assert_array_equal(np.sort(res.sv_ids), np.sort(part.sv_ids))
    assert res.b == part.b


def test_missing_checkpoint_is_a_fresh_run(tmp_path, data):
    Xs, Y = data
    cc = CascadeConfig(n_shards=2, sv_capacity=256, topology="tree")
    path = str(tmp_path / "none.npz")
    a = _fit(Xs, Y, cc, checkpoint_path=path, resume=True)
    b = _fit(Xs, Y, cc)
    np.testing.assert_array_equal(a.sv_ids, b.sv_ids)
    assert a.b == b.b and a.rounds == b.rounds


def test_config_mismatch_and_version_gate_refuse(tmp_path, data):
    Xs, Y = data
    path = str(tmp_path / "c.npz")
    _fit(Xs, Y, CascadeConfig(n_shards=2, sv_capacity=256, topology="tree"),
         cfg=SVMConfig(C=10.0, gamma=10.0, max_rounds=1),
         checkpoint_path=path)
    with pytest.raises(ValueError, match="n_shards=2, this run partitions "
                       "into 4"):
        _fit(Xs, Y, CascadeConfig(n_shards=4, sv_capacity=256,
                                  topology="tree"),
             checkpoint_path=path, resume=True)
    with pytest.raises(ValueError, match="topology='tree', this run uses "
                       "'star'"):
        _fit(Xs, Y, CascadeConfig(n_shards=2, sv_capacity=256,
                                  topology="star"),
             checkpoint_path=path, resume=True)
    with pytest.raises(ValueError, match="capacity 256 vs 128"):
        _fit(Xs, Y, CascadeConfig(n_shards=2, sv_capacity=128,
                                  topology="tree"),
             checkpoint_path=path, resume=True)
    with np.load(path) as z:
        fields = dict(z)
    fields["ckpt_version"] = np.asarray(2)
    np.savez(path, **fields)
    for load in (tc.load_round_state, jc.load_round_state):
        with pytest.raises(ValueError,
                           match="unsupported cascade checkpoint version 2"):
            load(path)


@pytest.mark.parametrize("status,rnd,ids,b", [
    (0, 1, set(), 0.0), (1, 7, {5, 1, 99}, -0.3125),
    (2, 3, {2**31 - 2}, 1e-300), (1, 2, {0}, float("-inf"))])
def test_resume_fingerprint_matches_jax(status, rnd, ids, b):
    j = jc._resume_fingerprint(status, rnd, ids, b)
    t = tc._resume_fingerprint(status, rnd, ids, b)
    assert j.dtype == t.dtype == np.uint32
    np.testing.assert_array_equal(j, t)


def _fps(*rows):
    return np.stack([tc._resume_fingerprint(*r) for r in rows])


@pytest.mark.parametrize("fps,match", [
    (_fps((1, 3, {1}, 0.5), (2, 1, set(), 0.0)), "failed to load on "
     "processes \\[1\\]"),
    (_fps((1, 3, {1}, 0.5), (0, 1, set(), 0.0), (1, 3, {1}, 0.5)),
     "missing on processes \\[1\\]"),
    (_fps((1, 3, {1}, 0.5), (1, 4, {1}, 0.5)), "DIVERGENT"),
])
def test_check_resume_fingerprints_raises_the_jax_errors(fps, match):
    with pytest.raises(RuntimeError, match=match) as te:
        tc._check_resume_fingerprints(fps)
    with pytest.raises(RuntimeError) as je:
        jc._check_resume_fingerprints(fps)
    assert str(te.value) == str(je.value)
    tc._check_resume_fingerprints(fps[:1])
