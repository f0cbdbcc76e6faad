"""`train --mode cascade` in the port's command line against the JAX one.

Band: across packages, on the rings CSV of test_torch_cli_front.py, the
same SV count and held-out accuracy line, both converged, b within 1e-4
(PARITY.md's cross-engine band); inside the port, a --checkpoint/--resume
run prints the uninterrupted run's SV count and b exactly. A cascade
artifact from either package loads in the other, and `info` prints the
same description, its cascade line included, in both.
"""

import re
import warnings

import numpy as np
import pytest

from tpusvm.cli import main as j_main
from tpusvm.data import rings, write_csv
from tpusvm_torch.cli import main as t_main

# small buffers and working sets keep the CPU leaves cheap; both CLIs
# take the same flags
FLAGS = ["--C", "10", "--gamma", "10", "--mode", "cascade", "--shards", "4",
         "--sv-capacity", "256", "--solver-opt", "q=64"]


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cascade_cli")
    X, _ = rings(n=420, seed=13)
    lab = np.where(np.linalg.norm(X, axis=1) < 1.0, 1,
                   np.where(X[:, 0] > 0, 2, 0)).astype(np.int32)
    write_csv(str(d / "a.csv"), X[:320], lab[:320])
    write_csv(str(d / "b.csv"), X[320:], lab[320:])
    return d


def _run(main, argv, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def _field(pattern, out):
    m = re.search(pattern, out, re.M)
    assert m, (pattern, out)
    return m.group(1)


@pytest.mark.parametrize("topology", ["tree", "star"])
def test_cascade_on_a_csv_matches_the_jax_cli(csvs, capsys, tmp_path,
                                              topology):
    src = ["--train", str(csvs / "a.csv"), "--test", str(csvs / "b.csv")]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    out_j = _run(j_main, ["train", *src, *FLAGS, "--topology", topology,
                          "--save", jpath], capsys)
    out_t = _run(t_main, ["train", *src, *FLAGS, "--topology", topology,
                          "--device", "cpu", "--save", tpath], capsys)
    for pat in (r"n = (\d+, n_features = \d+)", r"^SV count = (\d+)",
                r"(accuracy = .*)", r"cascade: \d+ rounds, converged = (\w+)"):
        assert _field(pat, out_t) == _field(pat, out_j), pat
    assert "converged = True" in out_t
    assert abs(float(_field(r"^b = (\S+)", out_t))
               - float(_field(r"^b = (\S+)", out_j))) <= 1e-4
    rounds = _field(r"cascade: (\d+) rounds", out_t)
    # either package's artifact: the same description in both, with the
    # cascade line
    for path in (jpath, tpath):
        info_t = _run(t_main, ["info", path], capsys)
        info_j = _run(j_main, ["info", path], capsys)
        assert info_t == info_j
    assert f"cascade: topology={topology} leaves=4 rounds={rounds}" in \
        _run(t_main, ["info", tpath], capsys)
    # and each package's artifact scores in the other
    from tpusvm.models import BinarySVC as JSVC
    from tpusvm_torch.data import read_csv
    from tpusvm_torch.models import BinarySVC

    Xt, Yt = read_csv(str(csvs / "b.csv"))
    for path in (jpath, tpath):
        t, j = BinarySVC.load(path, device="cpu"), JSVC.load(path)
        assert t.cascade_topology_ == j.cascade_topology_ == topology
        assert t.cascade_rounds_ == j.cascade_rounds_ == int(rounds)
        assert t.cascade_leaves_ == j.cascade_leaves_ == 4
        assert np.array_equal(t.predict(Xt), j.predict(Xt))


def test_checkpoint_and_resume_reproduce_the_run(csvs, capsys, tmp_path):
    src = ["--train", str(csvs / "a.csv"), "--device", "cpu"]
    ck = str(tmp_path / "c.npz")
    full = _run(t_main, ["train", *src, *FLAGS, "--topology", "star"], capsys)
    first = _run(t_main, ["train", *src, *FLAGS, "--topology", "star",
                          "--checkpoint", ck, "--max-rounds", "1"], capsys)
    assert "cascade: 1 rounds, converged = False" in first
    again = _run(t_main, ["train", *src, *FLAGS, "--topology", "star",
                          "--checkpoint", ck, "--resume"], capsys)
    assert "resuming cascade from round 2" in again
    for pat in (r"^SV count = (\d+)", r"^b = (\S+)",
                r"(cascade: \d+ rounds, converged = \w+)"):
        assert _field(pat, again) == _field(pat, full), pat


@pytest.mark.parametrize("argv,match", [
    (["--mode", "pod"], "pass --data DIR"),
    (["--mode", "cascade", "--shards", "3"], "power-of-two"),
    (["--mode", "cascade", "--shrink-every", "2"], "--mode single"),
    (["--stratify"], "only applies to --mode cascade"),
    (["--mode", "cascade", "--multiclass"], "--mode single"),
])
def test_cascade_flag_refusals(csvs, argv, match):
    with pytest.raises(SystemExit, match=match):
        t_main(["train", "--train", str(csvs / "a.csv"), "--device", "cpu",
                *argv])
