"""The closed loop's command line in tpusvm_torch, on the CPU: `autopilot
--smoke`, `tenants --smoke`, `info STORE.json` and the two chaos gates
(`python -m tpusvm_torch.faults autopilot-chaos-smoke|tenant-chaos-smoke`),
each a subprocess with --device cpu under a guard that makes jax and the
JAX package unimportable. `info` prints the JAX command line's lines for
the same store."""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(mod, argv, cwd, timeout=300):
    guard = ("import runpy, sys; sys.modules['jax'] = "
             "sys.modules['tpusvm'] = None; "
             f"sys.argv[0] = {mod!r}; "
             f"runpy.run_module({mod!r}, run_name='__main__', "
             "alter_sys=True)")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", guard, *argv],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=timeout)


@pytest.mark.parametrize("mod, argv, line", [
    ("tpusvm_torch", ["autopilot", "--smoke", "-q"], "autopilot smoke ok"),
    ("tpusvm_torch", ["tenants", "--smoke", "-q"], "tenants smoke ok"),
    ("tpusvm_torch.faults", ["autopilot-chaos-smoke"],
     "autopilot chaos smoke ok"),
    ("tpusvm_torch.faults", ["tenant-chaos-smoke"], "tenant chaos smoke ok"),
], ids=["autopilot", "tenants", "autopilot_chaos", "tenant_chaos"])
def test_closed_loop_gates_exit_0_on_the_cpu(tmp_path, mod, argv, line):
    out = _run(mod, argv + ["--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert line in out.stdout


def test_info_describes_a_tenant_store_as_jax_does(tmp_path):
    from tpusvm.cli import main as j_main
    from tpusvm_torch.tenants import TenantRecord, TenantsState, save_store

    st = TenantsState(seed=3, tick=9, stage="fitting", generation=4,
                      refreshes=11, failures=2,
                      inflight={"tenant_ids": ["a", "b"], "stage_rows": 640,
                                "plan": {"launches": [["a", "b"]],
                                         "solos": []}})
    st.tenants["a"] = TenantRecord("a", positive_label=0, C=1.0, gamma=2.0,
                                   generation=4, consecutive_triggered=1)
    st.tenants["b"] = TenantRecord("b", positive_label=1, C=3.0, gamma=0.5,
                                   row_mod=2, row_ofs=1, generation=3)
    path = str(tmp_path / "tenants_store.json")
    save_store(path, st)
    out = _run("tpusvm_torch", ["info", path], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_main(["info", path]) == 0
    assert out.stdout == buf.getvalue()
    assert "tenant store: 2 tenants, generation 4 (tick 9)" in out.stdout


@pytest.mark.parametrize("argv, message", [
    (["autopilot"], "--data DIR and --model NPZ are required"),
    (["tenants"], "--data DIR is required"),
    (["autopilot", "--trace", "t.jsonl"], "--data DIR and --model NPZ"),
    (["tenants", "--trace", "t.jsonl"], "--data DIR is required"),
], ids=["autopilot_args", "tenants_args", "autopilot_trace", "tenants_trace"])
def test_closed_loop_commands_refuse_by_name(argv, message, tmp_path,
                                             monkeypatch):
    from tpusvm_torch.cli import main
    from tpusvm_torch.obs.trace import read_trace

    # --trace is ported: the refusal still comes, and the trace it leaves
    # is complete (meta, the registry snapshot, end)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=message):
        main(argv + ["--device", "cpu"])
    if "--trace" in argv:
        recs = read_trace("t.jsonl")
        assert recs[0]["argv"] == [argv[0]] and recs[-1]["kind"] == "end"
        assert [r["name"] for r in recs if r["kind"] == "event"] == [
            "metrics.snapshot"]
