"""The JAX blocked solver's knobs in the port's blocked solver, on the CPU.

The knob list is read from the JAX solver's signature, less its data and
hyperparameter arguments, so it follows the JAX package. Each knob at its
JAX default goes to both packages on a small rings fit, held to the repo's
cross-engine criterion: the same status, SV-ID set and training accuracy,
|db| <= 1e-4. Each knob at a non-default value goes to the port: it runs
as the port's mapped behaviour (bit for bit where the knob only renames or
cannot change the port's arithmetic), or raises NotImplementedError naming
its ROADMAP Queue 1 item. A JAX knob never ends in a TypeError.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.data import MinMaxScaler, rings
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm.solver.predict import predict as j_predict
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.solver.predict import predict as t_predict
from tpusvm_torch.status import Status

_DATA_ARGS = {"X", "Y", "valid", "alpha0", "sn", "C", "gamma", "eps", "tau",
              "max_iter", "q", "max_outer", "max_inner", "warm_start",
              "accum_dtype", "kernel", "degree", "coef0", "targets"}
_PARAMS = inspect.signature(j_solve).parameters
KNOBS = [name for name in _PARAMS if name not in _DATA_ARGS]
_BASE = dict(C=1.0, gamma=5.0, tau=1e-5, q=128, max_inner=256,
             max_iter=10**6)

# (non-default value, the options it needs, what the port does with it):
# "runs" = a knob the port has under the same name; a dict = the port's
# run with those options instead, which it must equal bit for bit;
# "refused" = NotImplementedError naming a ROADMAP Queue 1 item
_NON_DEFAULT = {
    "inner": ("xla", {}, dict(inner="loop")),
    "refine": (64, {}, "refused"),
    "max_refines": (4, {}, {}),
    "wss": (2, {}, "runs"),
    "matmul_precision": ("bf16_f32", {}, "refused"),
    "selection": ("approx", {}, {}),
    "fused_fupdate": (False, {}, "runs"),
    "pallas_layout": ("flat", {}, {}),
    "pallas_eta_exclude": (True, dict(inner="kernel", wss=2),
                           dict(inner="kernel", wss=2, eta_exclude=True)),
    "pallas_multipair": (2, dict(inner="kernel", q=512),
                         dict(inner="kernel", q=512, multipair=2)),
    "pallas_fused_selection": (True, dict(fused_fupdate=True),
                               dict(fused_fupdate=True,
                                    fused_selection=True)),
    "telemetry": (8, {}, "refused"),
    "kernel_fast": (False, dict(kernel="linear", C=0.5), "runs"),
    "shrink_stable": (3, {}, "refused"),
    "krow_cache": (4, {}, "refused"),
    "resume_state": (object(), {}, "refused"),
    "pause_at": (3, {}, "refused"),
    "return_state": (True, {}, "refused"),
}


def _data():
    X, Y = rings(n=600, seed=0)
    return MinMaxScaler().fit_transform(X).astype(np.float32), Y.astype(np.int32)


def _port(**kw):
    Xs, Y = _data()
    return blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y),
                             accum_dtype=torch.float64, device="cpu",
                             **{**_BASE, **kw})


def _sv(alpha):
    return np.nonzero(np.asarray(alpha) > 1e-8)[0]


def test_knob_list_follows_the_jax_signature():
    assert set(KNOBS) == set(_NON_DEFAULT)
    port = inspect.signature(blocked_smo_solve).parameters
    assert all(name in port for name in _PARAMS)


@pytest.mark.parametrize("knob", KNOBS)
def test_knob_at_its_jax_default_matches_jax(knob):
    Xs, Y = _data()
    default = _PARAMS[knob].default
    r_j = j_solve(jnp.asarray(Xs), jnp.asarray(Y), accum_dtype=jnp.float64,
                  **_BASE, **{knob: default})
    r_t = _port(**{knob: default})
    assert int(r_j.status) == r_t.status == Status.CONVERGED
    np.testing.assert_array_equal(_sv(r_t.alpha.numpy()), _sv(r_j.alpha))
    assert abs(r_t.b - float(r_j.b)) <= 1e-4
    gamma = _BASE["gamma"]
    p_j = np.asarray(j_predict(jnp.asarray(Xs), jnp.asarray(Xs), jnp.asarray(Y),
                               r_j.alpha, float(r_j.b), gamma=gamma))
    p_t = t_predict(torch.tensor(Xs), torch.tensor(Xs), torch.tensor(Y),
                    r_t.alpha.float(), r_t.b, gamma=gamma).numpy()
    assert (p_t == Y).mean() == (p_j == Y).mean()


@pytest.mark.parametrize("knob", KNOBS)
def test_knob_at_a_non_default_value(knob):
    value, needs, does = _NON_DEFAULT[knob]
    if does == "refused":
        with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item"):
            _port(**needs, **{knob: value})
        return
    r = _port(**needs, **{knob: value})
    assert r.status == Status.CONVERGED
    if isinstance(does, dict):
        ref = _port(**does)
        assert torch.equal(r.alpha, ref.alpha)
        assert (r.b, r.n_iter, r.n_outer) == (ref.b, ref.n_iter, ref.n_outer)


def test_linear_kernel_fast_false_matches_jax():
    """kernel_fast=False is the generic blocked f-update in both packages."""
    Xs, Y = _data()
    kw = dict(_BASE, kernel="linear", C=0.5, kernel_fast=False)
    r_j = j_solve(jnp.asarray(Xs), jnp.asarray(Y), accum_dtype=jnp.float64, **kw)
    r_t = _port(**kw)
    assert int(r_j.status) == r_t.status == Status.CONVERGED
    np.testing.assert_array_equal(_sv(r_t.alpha.numpy()), _sv(r_j.alpha))
    assert abs(r_t.b - float(r_j.b)) <= 1e-4


@pytest.mark.parametrize("jax_name,short,value,needs", [
    ("pallas_eta_exclude", "eta_exclude", True, dict(inner="kernel", wss=2)),
    ("pallas_multipair", "multipair", 2, dict(inner="kernel", q=512)),
    ("pallas_fused_selection", "fused_selection", True,
     dict(fused_fupdate=True)),
])
def test_jax_names_and_aliases_give_the_same_bits(jax_name, short, value, needs):
    a = _port(**needs, **{jax_name: value})
    b = _port(**needs, **{short: value})
    assert torch.equal(a.alpha, b.alpha)
    assert (a.b, a.b_high, a.b_low, a.n_iter, a.status, a.n_outer) == (
        b.b, b.b_high, b.b_low, b.n_iter, b.status, b.n_outer)


@pytest.mark.parametrize("jax_name,short,value", [
    ("pallas_eta_exclude", "eta_exclude", True),
    ("pallas_multipair", "multipair", 2),
    ("pallas_fused_selection", "fused_selection", True),
])
def test_a_name_and_its_alias_together_raise(jax_name, short, value):
    with pytest.raises(ValueError, match="one knob"):
        _port(**{jax_name: value, short: value})


def test_jax_solver_opts_carry_over_through_the_estimator():
    """A JAX solver_opts dict written out in full, at every default, fits
    through BinarySVC as the port's default fit does."""
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models.svm import BinarySVC

    Xs, Y = _data()
    opts = {name: _PARAMS[name].default for name in KNOBS}
    cfg = SVMConfig(C=1.0, gamma=5.0)
    full = BinarySVC(cfg, solver_opts=dict(opts, q=128), device="cpu").fit(Xs, Y)
    plain = BinarySVC(cfg, solver_opts=dict(q=128), device="cpu").fit(Xs, Y)
    assert np.array_equal(full.sv_ids_, plain.sv_ids_) and full.b_ == plain.b_
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 7\(a\)"):
        BinarySVC(cfg, solver_opts=dict(refine=64), device="cpu").fit(Xs, Y)
