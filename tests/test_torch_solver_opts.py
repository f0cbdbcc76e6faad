"""The JAX blocked solver's knobs in the port's blocked solver, on the CPU.

The knob list is read from the JAX solver's signature, less its data and
hyperparameter arguments, so it follows the JAX package. Each knob at its
JAX default goes to both packages on a small rings fit, held to the repo's
cross-engine criterion: the same status, SV-ID set and training accuracy,
|db| <= 1e-4. Each knob at a non-default value goes to the port: it runs
as the port's mapped behaviour (bit for bit where the knob only renames or
cannot change the port's arithmetic), or runs beside the JAX solver at the
same value and does what JAX's does there (refine, krow_cache, the
pause/resume surface, the bf16 matmul_precision rung with refine, and the
telemetry ring). A JAX knob never ends in a TypeError.

The fleet's counterpart reads the JAX fleet solver's static surface
(_FLEET_STATIC) and signature: every knob is accepted by the port's
fleet_smo_solve, and each at its JAX default gives the JAX fleet's SV sets,
statuses and b within 1e-4.
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
# "jax" = the knob runs in both packages and does there what
# _AS_JAX[knob] checks
_NON_DEFAULT = {
    "inner": ("xla", {}, dict(inner="loop")),
    "refine": (600, {}, "jax"),
    "max_refines": (4, {}, {}),
    "wss": (2, {}, "runs"),
    "matmul_precision": ("bf16_f32", {}, "jax"),
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
    "telemetry": (8, {}, "jax"),
    "kernel_fast": (False, dict(kernel="linear", C=0.5), "runs"),
    # the stability counters are written, never read: bit-transparent
    "shrink_stable": (3, {}, {}),
    "krow_cache": (256, {}, "jax"),
    "resume_state": (3, {}, "jax"),
    "pause_at": (3, {}, "jax"),
    "return_state": (True, {}, "jax"),
}


def _data():
    X, Y = rings(n=600, seed=0)
    return MinMaxScaler().fit_transform(X).astype(np.float32), Y.astype(np.int32)


def _port(**kw):
    Xs, Y = _data()
    return blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y),
                             accum_dtype=torch.float64, device="cpu",
                             **{**_BASE, **kw})


def _jax(**kw):
    Xs, Y = _data()
    return j_solve(jnp.asarray(Xs), jnp.asarray(Y), accum_dtype=jnp.float64,
                   **{**_BASE, **kw})


def _sv(alpha):
    return np.nonzero(np.asarray(alpha) > 1e-8)[0]


def _in_band(r_t, r_j):
    assert int(r_j.status) == r_t.status == Status.CONVERGED
    np.testing.assert_array_equal(_sv(r_t.alpha.numpy()), _sv(r_j.alpha))
    assert abs(r_t.b - float(r_j.b)) <= 1e-4


def _refine(value):
    r_t, r_j = _port(refine=value), _jax(refine=value)
    _in_band(r_t, r_j)
    assert r_t.n_refines >= 1 and int(r_j.n_refines) >= 1


def _krow_cache(value):
    r_t, r_j = _port(krow_cache=value), _jax(krow_cache=value)
    _in_band(r_t, r_j)
    # every round's q rows counted once, as hits or as misses
    for r in (r_t, r_j):
        assert int(r.cache_hits) + int(r.cache_misses) == 128 * int(r.n_outer)
    assert r_t.cache_hits > 0


def _pause_at(value):
    r_t, r_j = _port(pause_at=value), _jax(pause_at=value)
    assert r_t.n_outer == int(r_j.n_outer) == value
    assert r_t.status == int(r_j.status) == Status.RUNNING


def _return_state(value):
    (r_t, st_t), (r_j, st_j) = _port(return_state=value), _jax(
        return_state=value)
    _in_band(r_t, r_j)
    assert st_t.n_outer == r_t.n_outer and int(st_j.n_outer) == int(r_j.n_outer)
    assert torch.equal(st_t.alpha, r_t.alpha)


def _resume_state(pause):
    """Each package resumed from its own state, paused at `pause` rounds,
    equals its own uninterrupted solve bit for bit."""
    whole_t, whole_j = _port(), _jax()
    _, st_t = _port(pause_at=pause, return_state=True)
    _, st_j = _jax(pause_at=pause, return_state=True)
    r_t, r_j = _port(resume_state=st_t), _jax(resume_state=st_j)
    assert torch.equal(r_t.alpha, whole_t.alpha)
    assert (r_t.b, r_t.n_iter, r_t.n_outer) == (whole_t.b, whole_t.n_iter,
                                                whole_t.n_outer)
    assert np.asarray(r_j.alpha).tobytes() == np.asarray(whole_j.alpha).tobytes()
    _in_band(r_t, r_j)


def _matmul_precision(value):
    """bf16_f32 with its drift guard (refine) in both packages; without one
    both refuse."""
    with pytest.raises(ValueError, match="bf16_f32"):
        _port(matmul_precision=value)
    with pytest.raises(ValueError, match="bf16_f32"):
        _jax(matmul_precision=value)
    r_t = _port(matmul_precision=value, refine=600)
    r_j = _jax(matmul_precision=value, refine=600)
    _in_band(r_t, r_j)
    assert r_t.n_refines >= 1 and int(r_j.n_refines) >= 1


def _telemetry(value):
    """The ring in both packages: the port's solve bit for bit the solve
    without it, one entry per body execution in each package."""
    r_t, r_j = _port(telemetry=value), _jax(telemetry=value)
    _in_band(r_t, r_j)
    plain = _port()
    assert torch.equal(r_t.alpha, plain.alpha) and r_t.b == plain.b
    assert r_t.telemetry.count == r_t.n_outer + 1
    assert int(r_j.telemetry.count) == int(r_j.n_outer) + 1


_AS_JAX = {"refine": _refine, "krow_cache": _krow_cache,
           "pause_at": _pause_at, "return_state": _return_state,
           "resume_state": _resume_state,
           "matmul_precision": _matmul_precision, "telemetry": _telemetry}


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
    if does == "jax":
        _AS_JAX[knob](value)
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
    refined = BinarySVC(cfg, solver_opts=dict(q=128, refine=600),
                        device="cpu").fit(Xs, Y)
    assert refined.result_.n_refines >= 1
    with pytest.raises(ValueError, match="bf16_f32"):
        BinarySVC(cfg, solver_opts=dict(matmul_precision="bf16_f32"),
                  device="cpu").fit(Xs, Y)
    bf16 = BinarySVC(cfg, solver_opts=dict(q=128, matmul_precision="bf16_f32",
                                           refine=600), device="cpu").fit(Xs, Y)
    assert bf16.train_precision_ == "bf16_f32"
    ringed = BinarySVC(cfg, solver_opts=dict(q=128, telemetry=8),
                       device="cpu").fit(Xs, Y)
    assert ringed.convergence_["rounds_recorded"] == \
        ringed.result_.n_outer + 1
    assert np.array_equal(ringed.sv_ids_, plain.sv_ids_)


# ---- the fleet's knobs ------------------------------------------------------

from tpusvm.fleet import fleet_train as j_fleet_train  # noqa: E402
from tpusvm.fleet.solve import _FLEET_STATIC as J_FLEET_STATIC  # noqa: E402
from tpusvm.fleet.solve import fleet_smo_solve as j_fleet_solve  # noqa: E402
from tpusvm_torch.fleet import fleet_smo_solve, fleet_train  # noqa: E402
from tpusvm_torch.fleet.solve import _FLEET_STATIC  # noqa: E402

_J_FLEET_PARAMS = inspect.signature(j_fleet_solve).parameters


def test_fleet_knob_list_follows_the_jax_signature():
    assert tuple(_FLEET_STATIC) == tuple(J_FLEET_STATIC)
    port = inspect.signature(fleet_smo_solve).parameters
    assert all(name in port for name in _J_FLEET_PARAMS)
    assert all(name in port for name in J_FLEET_STATIC)


@pytest.mark.parametrize("knob", J_FLEET_STATIC)
def test_fleet_knob_at_its_jax_default_matches_jax(knob):
    """Two lanes (the labels and their flip, at _BASE's C and gamma)
    through both packages' fleet_train with the knob at its JAX default
    (the accumulator dtype is f64 in both, as everywhere in this file)."""
    Xs, Y = _data()
    base = dict(q=128, max_inner=256, max_iter=10**6)
    default = _J_FLEET_PARAMS[knob].default
    extra = {} if knob in ("accum_dtype", "q", "max_inner") else {knob: default}
    lanes = ([Y, -Y], [_BASE["C"]] * 2, [_BASE["gamma"]] * 2)
    r_t = fleet_train(torch.tensor(Xs), *lanes, device="cpu",
                      accum_dtype=torch.float64, **base, **extra)
    r_j = j_fleet_train(jnp.asarray(Xs), *lanes, accum_dtype=jnp.float64,
                        **base, **extra)
    for a, b in zip(r_t, r_j):
        assert int(a.status) == int(b.status) == Status.CONVERGED
        np.testing.assert_array_equal(_sv(a.alpha.numpy()), _sv(b.alpha))
        assert abs(float(a.b) - float(b.b)) <= 1e-4
