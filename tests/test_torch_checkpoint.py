"""Pause/resume and solver checkpoints in the port, on the CPU.

A blocked solve paused at every round and resumed from its OuterState, or
checkpointed to disk and resumed after a stop at every checkpoint, must
equal the uninterrupted solve bit for bit: torch.equal on alpha and f, and
the same b, n_iter, n_outer and status (tolerance: none). The checkpoint
file is refused when it belongs to another solve (the differing fields
named), to another format version, or to the JAX package; a missing file
is a fresh start; writes are atomic. The JAX cases of
tests/test_faults.py that need no fault injection are mirrored here, with
the watchdog standing in for the injected kill.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.data import MinMaxScaler, rings
from tpusvm_torch.solver import checkpoint as ckpt
from tpusvm_torch.solver.blocked import OuterState, blocked_smo_solve
from tpusvm_torch.solver.checkpoint import (WatchdogTimeout,
                                            checkpointed_blocked_solve,
                                            load_solver_state,
                                            save_solver_state,
                                            solve_fingerprint)
from tpusvm_torch.status import Status


def _solve_args(n=400, q=16):
    X, Y = rings(n=n, seed=11)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    return Xs, Y.astype(np.int32), dict(C=10.0, gamma=10.0, q=q,
                                        accum_dtype=torch.float64,
                                        device="cpu")


# configurations whose carry holds every kind of state: the loop engine,
# the kernel engine, refine, the K-row cache, the stability counters,
# fused-selection candidates, multipair
_CONFIGS = {
    "loop": dict(q=16),
    "kernel_wss2": dict(q=128, wss=2),
    "refine": dict(q=16, refine=400),
    "krow_cache": dict(q=16, krow_cache=48),
    "shrink_stable": dict(q=16, shrink_stable=2),
    "fused_selection": dict(q=128, fused_fupdate=True, fused_selection=True),
    "multipair": dict(n=600, q=512, inner="kernel", multipair=2),
}


def _same(a, b):
    assert torch.equal(a.alpha, b.alpha)
    assert (a.b, a.b_high, a.b_low, a.n_iter, a.n_outer, a.status) == (
        b.b, b.b_high, b.b_low, b.n_iter, b.n_outer, b.status)


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_pause_and_resume_at_every_round_is_bit_identical(name):
    cfg = dict(_CONFIGS[name])
    Xs, Y, kw = _solve_args(n=cfg.pop("n", 400))
    kw.update(cfg)
    whole, st_whole = blocked_smo_solve(Xs, Y, return_state=True, **kw)
    assert whole.status == Status.CONVERGED and whole.n_outer >= 3
    if "refine" in _CONFIGS[name]:
        assert whole.n_refines >= 1
    if "krow_cache" in _CONFIGS[name]:
        assert whole.cache_hits > 0 and whole.cache_misses > 0
    state, k = None, 0
    while state is None or state.status == Status.RUNNING:
        k += 1
        res, state = blocked_smo_solve(Xs, Y, resume_state=state, pause_at=k,
                                       return_state=True, **kw)
        assert state.n_outer == min(k, whole.n_outer)
    _same(res, whole)
    assert torch.equal(state.f, st_whole.f)
    assert k >= whole.n_outer
    if "krow_cache" in _CONFIGS[name]:
        assert (res.cache_hits, res.cache_misses) == (whole.cache_hits,
                                                      whole.cache_misses)
        assert torch.equal(state.cache, st_whole.cache)
        assert torch.equal(state.cache_age, st_whole.cache_age)


def test_resume_leaves_the_given_state_untouched():
    Xs, Y, kw = _solve_args()
    _, st = blocked_smo_solve(Xs, Y, pause_at=2, return_state=True, **kw)
    before = {k: v.clone() for k, v in vars(st).items()
              if isinstance(v, torch.Tensor)}
    blocked_smo_solve(Xs, Y, resume_state=st, **kw)
    blocked_smo_solve(Xs, Y, resume_state=st, **kw)
    assert all(torch.equal(getattr(st, k), v) for k, v in before.items())
    assert st.n_outer == 2


def test_resume_state_validation():
    Xs, Y, kw = _solve_args()
    _, st = blocked_smo_solve(Xs, Y, pause_at=2, return_state=True, **kw)
    with pytest.raises(ValueError, match="n=400 rows"):
        blocked_smo_solve(Xs[:300], Y[:300], resume_state=st, **kw)
    with pytest.raises(ValueError, match="krow_cache"):
        blocked_smo_solve(Xs, Y, resume_state=st, krow_cache=32, **kw)
    with pytest.raises(ValueError, match="shrink_stable"):
        blocked_smo_solve(Xs, Y, resume_state=st, shrink_stable=2, **kw)
    with pytest.raises(ValueError, match="fused_selection"):
        blocked_smo_solve(Xs, Y, resume_state=st, q=128, fused_fupdate=True,
                          fused_selection=True,
                          **{k: v for k, v in kw.items() if k != "q"})


def test_state_round_trips_through_numpy(tmp_path):
    Xs, Y, kw = _solve_args()
    kw.update(_CONFIGS["krow_cache"], shrink_stable=2)
    _, st = blocked_smo_solve(Xs, Y, pause_at=3, return_state=True, **kw)
    fp = solve_fingerprint(Xs, Y, torch.float64, {"q": 16})
    path = str(tmp_path / "ck.npz")
    save_solver_state(path, st, fp)
    back = load_solver_state(path, fp)
    for name, v in st.arrays().items():
        w = back.arrays()[name]
        assert v.dtype == w.dtype and v.tobytes() == w.tobytes(), name
    assert isinstance(back.f_exact, bool) and isinstance(back.b_high, float)
    whole = blocked_smo_solve(Xs, Y, **kw)
    _same(blocked_smo_solve(Xs, Y, resume_state=back, **kw), whole)


def test_checkpointed_solve_bit_identical_to_plain(tmp_path):
    Xs, Y, kw = _solve_args()
    plain = blocked_smo_solve(Xs, Y, **kw)
    assert plain.status == Status.CONVERGED
    ck = str(tmp_path / "ck.npz")
    res = checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                     checkpoint_every=4, **kw)
    _same(res, plain)
    assert not os.path.exists(ck)  # a solve that ends removes its file
    kept = checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                      checkpoint_every=4,
                                      keep_checkpoint=True, **kw)
    _same(kept, plain)


def _stop_after(k):
    calls = []

    def watchdog():
        calls.append(1)
        return len(calls) >= k
    return watchdog


def test_stop_at_every_checkpoint_then_resume_is_bit_identical(tmp_path):
    """test_faults.py's kill-at-every-checkpoint gate, with the watchdog
    stopping the solve right after checkpoint k is on disk."""
    Xs, Y, kw = _solve_args()
    plain = blocked_smo_solve(Xs, Y, **kw)
    n_ckpts = plain.n_outer // 2
    assert n_ckpts >= 2
    for k in range(1, n_ckpts + 1):
        ck = str(tmp_path / f"ck{k}.npz")
        with pytest.raises(WatchdogTimeout) as e:
            checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                       checkpoint_every=2,
                                       watchdog=_stop_after(k), **kw)
        assert e.value.n_outer == 2 * k and e.value.checkpoint_path == ck
        res = checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                         checkpoint_every=2, resume=True,
                                         **kw)
        _same(res, plain)


def test_missing_file_is_a_fresh_start(tmp_path):
    Xs, Y, kw = _solve_args()
    res = checkpointed_blocked_solve(Xs, Y, resume=True, checkpoint_every=3,
                                     checkpoint_path=str(tmp_path / "no.npz"),
                                     **kw)
    _same(res, blocked_smo_solve(Xs, Y, **kw))


def _checkpoint_on_disk(tmp_path, Xs, Y, kw):
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(WatchdogTimeout):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                   checkpoint_every=2,
                                   watchdog=_stop_after(1), **kw)
    assert os.path.exists(ck)
    return ck


def test_fingerprint_refuses_other_solves_naming_the_fields(tmp_path):
    Xs, Y, kw = _solve_args()
    ck = _checkpoint_on_disk(tmp_path, Xs, Y, kw)
    with pytest.raises(ValueError, match="gamma"):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                   checkpoint_every=2, resume=True,
                                   **dict(kw, gamma=20.0))
    with pytest.raises(ValueError, match="x_crc32"):
        checkpointed_blocked_solve(Xs + np.float32(1e-3), Y,
                                   checkpoint_path=ck, checkpoint_every=2,
                                   resume=True, **kw)
    with pytest.raises(ValueError, match="krow_cache"):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                   checkpoint_every=2, resume=True,
                                   krow_cache=32, **kw)
    with pytest.raises(ValueError, match="accum_dtype"):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                   checkpoint_every=2, resume=True,
                                   **dict(kw, accum_dtype=None))
    np.savez(str(tmp_path / "junk"), a=np.zeros(3))
    with pytest.raises(ValueError, match="not a tpusvm solver checkpoint"):
        checkpointed_blocked_solve(Xs, Y, resume=True, checkpoint_every=2,
                                   checkpoint_path=str(tmp_path / "junk.npz"),
                                   **kw)


def test_version_gate(tmp_path):
    Xs, Y, kw = _solve_args()
    ck = _checkpoint_on_disk(tmp_path, Xs, Y, kw)
    with np.load(ck) as z:
        arrays = dict(z)
    arrays["ckpt_version"] = np.asarray(ckpt.SOLVER_CKPT_VERSION + 1)
    np.savez(ck, **arrays)
    with pytest.raises(ValueError, match="unsupported solver checkpoint "
                                         "version"):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                   checkpoint_every=2, resume=True, **kw)


def test_a_jax_checkpoint_is_refused(tmp_path):
    from tpusvm import faults
    from tpusvm.solver.checkpoint import checkpointed_blocked_solve as j_ck

    Xs, Y, kw = _solve_args()
    jkw = dict(C=10.0, gamma=10.0, q=16, accum_dtype=jnp.float64)
    ck = str(tmp_path / "jax.npz")
    plan = faults.FaultPlan([faults.FaultRule(
        point="solver.outer_checkpoint", kind="kill", at_hit=2)])
    with pytest.raises(faults.SimulatedKill):
        with faults.active(plan):
            j_ck(jnp.asarray(Xs), jnp.asarray(Y), checkpoint_path=ck,
                 checkpoint_every=2, **jkw)
    assert os.path.exists(ck)
    port_kw = {k: v for k, v in kw.items() if k != "accum_dtype"}
    with pytest.raises(ValueError, match="JAX package"):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                   checkpoint_every=2, resume=True,
                                   accum_dtype=torch.float64, **port_kw)


def test_a_failed_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    Xs, Y, kw = _solve_args()
    ck = _checkpoint_on_disk(tmp_path, Xs, Y, kw)
    before = open(ck, "rb").read()

    def torn(tmp, final):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "fsync_replace", torn)
    with pytest.raises(OSError, match="disk full"):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                   checkpoint_every=2, resume=True, **kw)
    assert open(ck, "rb").read() == before
    monkeypatch.undo()
    res = checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                     checkpoint_every=2, resume=True, **kw)
    _same(res, blocked_smo_solve(Xs, Y, **kw))
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p
                and not p.endswith(".tmp.npz")]


def test_checkpointed_solve_validation():
    Xs, Y, kw = _solve_args()
    with pytest.raises(ValueError, match="checkpoint_every"):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path="x.npz",
                                   checkpoint_every=0, **kw)
    with pytest.raises(ValueError, match="segmenting"):
        checkpointed_blocked_solve(Xs, Y, checkpoint_path="x.npz",
                                   pause_at=3, **kw)


def test_estimator_fit_checkpoint_and_resume(tmp_path):
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC

    X, Y = rings(n=400, seed=11)
    cfg = SVMConfig(C=10.0, gamma=10.0)
    opts = dict(q=16)
    plain = BinarySVC(cfg, solver_opts=opts, device="cpu").fit(X, Y)
    ck = str(tmp_path / "fit.npz")
    m = BinarySVC(cfg, solver_opts=opts, device="cpu")
    m.fit(X, Y, checkpoint_path=ck, checkpoint_every=3)
    assert torch.equal(m.result_.alpha, plain.result_.alpha)
    # a resumed fit in a fresh estimator, from a checkpoint left on disk
    _, st = blocked_smo_solve(
        MinMaxScaler().fit_transform(X).astype(np.float32), Y, pause_at=3,
        return_state=True, C=10.0, gamma=10.0, q=16, eps=cfg.eps, tau=cfg.tau,
        max_iter=cfg.max_iter, accum_dtype=torch.float64, device="cpu")
    fp = solve_fingerprint(
        MinMaxScaler().fit_transform(X).astype(np.float32), Y, torch.float64,
        dict(C=10.0, gamma=10.0, eps=cfg.eps, tau=cfg.tau,
             max_iter=cfg.max_iter, kernel="rbf", degree=3, coef0=0.0, q=16))
    save_solver_state(ck, st, fp)
    again = BinarySVC(cfg, solver_opts=opts, device="cpu").fit(
        X, Y, checkpoint_path=ck, checkpoint_every=3, resume=True)
    assert torch.equal(again.result_.alpha, plain.result_.alpha)
    assert np.array_equal(again.sv_ids_, plain.sv_ids_) and again.b_ == plain.b_
    assert not os.path.exists(ck)


def test_outer_state_fields_cover_the_jax_carry():
    """Every JAX _OuterState field the port carries keeps its JAX name;
    the rest are the telemetry ring (ROADMAP Queue 1 item 12)."""
    from tpusvm.solver.blocked import _OuterState

    port = {f for f in OuterState.__dataclass_fields__}
    missing = set(_OuterState._fields) - port
    assert missing == {"tele_gap", "tele_upd", "tele_status", "tele_i",
                       "tele_active"}
