"""The repo's lock-discipline (conc) and crash-safety (dura) static auditors,
the JAX package's own and unedited, run over tpusvm_torch/: 0 findings,
with no baseline. Every suppression the port carries names its invariant
(the auditors ignore an empty one), and a copy of a port module with its
annotation or its staged commit taken away is found, so the clean verdict
is the auditors reading the port's files, not a blind spot.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "tpusvm_torch"


def _audit(arm, *paths, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "tpusvm.analysis", arm, "--no-baseline",
         "--format", "json", *map(str, paths)],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=120)
    return out.returncode, json.loads(out.stdout)


@pytest.mark.parametrize("arm", ["conc", "dura"])
def test_the_port_audits_clean_without_a_baseline(arm):
    rc, res = _audit(arm, "tpusvm_torch")
    assert res["findings"] == [] and rc == 0, res["findings"]
    assert res["baselined"] == 0 and res["files_scanned"] >= 100
    # the annotated sites: 13 lock invariants, 3 crash-safety invariants
    assert res["suppressed"] == {"conc": 13, "dura": 3}[arm]


@pytest.mark.parametrize("arm", ["conc", "dura"])
def test_no_baseline_file_grandfathers_a_port_finding(arm):
    path = REPO / f".tpusvm-{arm}-baseline.json"
    if path.exists():
        assert "tpusvm_torch" not in path.read_text()


def test_every_port_suppression_names_its_invariant():
    pat = re.compile(r"#\s*tpusvm:\s*(guarded-by|durable-by|disable)=?(.*)$")
    seen = 0
    for path in sorted(PKG.rglob("*.py")):
        for line in path.read_text().splitlines():
            m = pat.search(line)
            if m:
                seen += 1
                assert m.group(1) != "disable", (path, line)
                assert len(m.group(2).strip()) > 10, (path, line)
    assert seen == 16


@pytest.mark.parametrize("arm,module,strip,rule", [
    ("conc", "serve/batcher.py", "# tpusvm: guarded-by=", "JXC201"),
    ("conc", "stream/reader.py", "# tpusvm: guarded-by=", "JXC201"),
    ("dura", "utils/durable.py", "# tpusvm: durable-by=", "JXD302"),
    ("dura", "ops/cuda/_build.py", "# tpusvm: durable-by=", "JXD301"),
])
def test_a_stripped_annotation_is_found(tmp_path, arm, module, strip, rule):
    src = (PKG / module).read_text()
    assert strip in src
    dst = tmp_path / "tpusvm_torch" / module
    dst.parent.mkdir(parents=True)
    dst.write_text("\n".join(
        line for line in src.splitlines() if strip not in line) + "\n")
    rc, res = _audit(arm, "tpusvm_torch", cwd=tmp_path)
    assert rc != 0 and {f["rule"] for f in res["findings"]} == {rule}


def test_an_unstaged_checkpoint_write_is_found(tmp_path):
    # the pod's round checkpoint written straight to its final path (the
    # hazard the staged temp + fsync_replace commit repairs)
    src = (PKG / "pod" / "state.py").read_text()
    broken = src.replace('    tmp = path + ".tmp.npz"\n', "").replace(
        "        tmp,\n", "        path,\n").replace(
        "    fsync_replace(tmp, path)\n", "")
    assert broken != src
    dst = tmp_path / "tpusvm_torch" / "pod" / "state.py"
    dst.parent.mkdir(parents=True)
    dst.write_text(broken)
    rc, res = _audit("dura", "tpusvm_torch", cwd=tmp_path)
    assert rc != 0 and [f["rule"] for f in res["findings"]] == ["JXD301"]
