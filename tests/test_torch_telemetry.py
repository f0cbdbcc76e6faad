"""The blocked solver's convergence ring in the port, on the CPU.

The ring is written and never read, so a solve's trajectory (alpha, b,
statuses, counters) is bit-identical with it on or off. Against the JAX
package on the same numpy problems (made from a seed): where both
packages take the same trajectory (a first stop check that ends the
solve: converged at entry, or no working set) the rings agree entry for
entry, the gap within the cross-engine band 1e-4; on a multi-round solve
the trajectories part after round 1 (torch and XLA round the f-update's
f32 sums differently), so the rings agree on round 1 exactly and both end
CONVERGED with a gap within 2 tau. The host half (materialize,
format_gap_table) gives the JAX package's dict and text on the same ring.
The ring carries through pause/resume, a checkpoint file and the
shrinking driver; `train --convergence T` prints the table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.obs.convergence import ConvergenceTelemetry as JTele
from tpusvm.obs.convergence import format_gap_table as j_table
from tpusvm.obs.convergence import materialize as j_materialize
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm.solver.shrink import shrinking_blocked_solve as j_shrink
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.data.synthetic import rings
from tpusvm_torch.obs.convergence import format_gap_table, materialize
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.solver.checkpoint import (load_solver_state,
                                            save_solver_state,
                                            solve_fingerprint)
from tpusvm_torch.solver.shrink import shrinking_blocked_solve
from tpusvm_torch.status import Status

jax.config.update("jax_enable_x64", True)

KW = dict(C=10.0, gamma=10.0, q=64, max_inner=256, max_iter=10**6)


def _data(n=256, seed=5):
    X, Y = rings(n=n, seed=seed)
    return MinMaxScaler().fit_transform(X).astype(np.float32), Y


def _port(X, Y, **kw):
    return blocked_smo_solve(X, Y, accum_dtype=torch.float64, device="cpu",
                             **{**KW, **kw})


def _jax(X, Y, **kw):
    return j_solve(jnp.asarray(X), jnp.asarray(Y), accum_dtype=jnp.float64,
                   **{**KW, **kw})


def _same(a, b):
    assert torch.equal(a.alpha, b.alpha)
    assert (a.b, a.b_high, a.b_low, a.n_iter, a.status, a.n_outer,
            a.n_refines, a.n_host_syncs) == (
        b.b, b.b_high, b.b_low, b.n_iter, b.status, b.n_outer, b.n_refines,
        b.n_host_syncs)


@pytest.mark.parametrize("extra", [
    dict(), dict(q=128, inner="kernel", wss=2), dict(refine=256),
    dict(shrink_stable=2), dict(krow_cache=128),
    dict(matmul_precision="bf16_f32", refine=256)])
@pytest.mark.parametrize("T", [4, 64])
def test_trajectory_is_bit_identical_with_the_ring(extra, T):
    X, Y = _data()
    off = _port(X, Y, **extra)
    on = _port(X, Y, telemetry=T, **extra)
    _same(off, on)
    assert off.telemetry is None
    conv = materialize(on.telemetry)
    # one entry per body execution: every round, refine and final check
    assert conv["rounds_recorded"] == on.n_outer + on.n_refines + 1
    assert conv["wrapped"] == (conv["rounds_recorded"] > T)
    assert int(conv["status"][-1]) == on.status == Status.CONVERGED
    if not conv["wrapped"]:
        assert int(conv["updates"].sum()) == on.n_iter - 1
        assert conv["gap"][0] == 2.0  # f = -y at the start
    assert abs(conv["gap"][-1] - (on.b_low - on.b_high)) == 0.0
    # live rows: every valid row, or those not yet stable under tracking
    if "shrink_stable" not in extra:
        assert (conv["active"] == len(Y)).all()


def test_ring_matches_jax_where_the_trajectories_agree():
    X, Y = _data()
    # converged at the first check: warm start from the port's solution
    sol = _port(X, Y).alpha.numpy()
    for kw in (dict(alpha0=sol, warm_start=True),):
        t = materialize(_port(X, Y, telemetry=8, **kw).telemetry)
        j = j_materialize(_jax(X, Y, telemetry=8, **kw).telemetry)
        assert t["rounds_recorded"] == j["rounds_recorded"] == 1
        assert np.array_equal(t["updates"], j["updates"])
        assert np.array_equal(t["status"], j["status"])
        assert np.array_equal(t["active"], j["active"])
        np.testing.assert_allclose(t["gap"], j["gap"], atol=1e-4)
    # no working set: one class only, gap NaN in both
    Y1 = np.ones_like(Y)
    t = materialize(_port(X, Y1, telemetry=8).telemetry)
    j = j_materialize(_jax(X, Y1, telemetry=8).telemetry)
    assert t["rounds_recorded"] == j["rounds_recorded"] == 1
    assert np.isnan(t["gap"]).all() and np.isnan(j["gap"]).all()
    assert np.array_equal(t["status"], j["status"])
    assert int(t["status"][0]) == Status.NO_WORKING_SET
    assert np.array_equal(t["active"], j["active"])


@pytest.mark.parametrize("inner", [("loop", "xla")])
def test_ring_matches_jax_on_round_one_and_the_end(inner):
    X, Y = _data()
    t = materialize(_port(X, Y, telemetry=64, inner=inner[0]).telemetry)
    j = j_materialize(_jax(X, Y, telemetry=64, inner=inner[1]).telemetry)
    assert t["gap"][0] == j["gap"][0] == 2.0
    assert t["updates"][0] == j["updates"][0]
    assert t["active"][0] == j["active"][0]
    for c in (t, j):
        assert int(c["status"][-1]) == Status.CONVERGED
        assert c["gap"][-1] <= 2e-5
        assert (c["status"][:-1] == Status.RUNNING).all()


def test_host_half_gives_the_jax_dict_and_text():
    """materialize and format_gap_table of the port on a ring equal the JAX
    package's on the same arrays, wrapped or not, with and without
    active."""
    X, Y = _data()
    ring = _port(X, Y, telemetry=3, q=32).telemetry
    for active in (True, False):
        args = dict(gap=ring.gap.numpy(), n_upd=ring.n_upd.numpy(),
                    status=ring.status.numpy(), count=ring.count,
                    active=ring.active.numpy() if active else None)
        t = materialize(ring._replace(active=args["active"]))
        j = j_materialize(JTele(**args))
        assert t.keys() == j.keys()
        for k in t:
            assert np.array_equal(t[k], j[k], equal_nan=True) \
                if isinstance(t[k], np.ndarray) else t[k] == j[k]
        for rows in (40, 2):
            assert format_gap_table(t, max_rows=rows) == j_table(
                j, max_rows=rows)
    assert t["wrapped"]


def test_ring_carries_through_pause_resume_and_a_checkpoint(tmp_path):
    X, Y = _data()
    whole = _port(X, Y, telemetry=16)
    _, st = _port(X, Y, telemetry=16, pause_at=2, return_state=True)
    path = str(tmp_path / "c.npz")
    fp = solve_fingerprint(X, Y, torch.float64, dict(KW, telemetry=16))
    save_solver_state(path, st, fp)
    back = load_solver_state(path, fp)
    assert back.tele_i == st.tele_i
    resumed = _port(X, Y, telemetry=16, resume_state=back)
    _same(whole, resumed)
    for f in ("gap", "n_upd", "status", "active"):
        # bit for bit, the never-written slots' NaN gaps included
        assert np.array_equal(getattr(whole.telemetry, f).numpy(),
                              getattr(resumed.telemetry, f).numpy(),
                              equal_nan=f == "gap")
    assert whole.telemetry.count == resumed.telemetry.count
    with pytest.raises(ValueError, match="telemetry"):
        _port(X, Y, telemetry=8, resume_state=st)


def test_ring_carries_through_the_shrinking_driver():
    """Both packages' shrinking solves record one entry per body execution
    across compactions, with the live rows under tracking."""
    X, Y = _data(n=512, seed=3)
    kw = dict(KW, shrink_every=2, shrink_stable=2, shrink_min=64,
              telemetry=256)
    r = shrinking_blocked_solve(X, Y, accum_dtype=torch.float64,
                                device="cpu", **kw)
    j = j_shrink(jnp.asarray(X), jnp.asarray(Y), accum_dtype=jnp.float64,
                 **kw)
    for res in (r, j):
        c = (materialize if res is r else j_materialize)(res.telemetry)
        assert int(c["status"][-1]) == Status.CONVERGED
        assert c["rounds_recorded"] >= int(res.n_outer) + 1
        assert (c["active"] <= len(Y)).all() and c["active"].min() < len(Y)


def test_cli_convergence_prints_the_table(capsys):
    from tpusvm_torch.cli import main

    assert main(["train", "--synthetic", "rings", "--n", "300", "--n-test",
                 "50", "--gamma", "5", "--C", "1", "--q", "64", "--device",
                 "cpu", "--convergence", "16"]) == 0
    out = capsys.readouterr().out
    assert "convergence (b_low - b_high per outer round):" in out
    assert "round      gap            updates   active  status" in out
    assert "CONVERGED" in out.split("convergence (")[1]
    for bad, msg in ((["--multiclass"], "blocked solver"),
                     (["--solver", "pair"], "blocked solver"),
                     (["--solver-opt", "telemetry=4"], "same knob")):
        with pytest.raises(SystemExit, match=msg):
            main(["train", "--synthetic", "rings", "--n", "100", "--device",
                  "cpu", "--convergence", "8"] + bad)
