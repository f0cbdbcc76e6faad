"""The port's command line against the JAX package's, on one CSV.

Both CLIs train in-process on the same tmp CSV (written by
tpusvm.data.write_csv from a seeded draw) with the same flags, the port
with --device cpu and the JAX package on the CPU backend the test session
pins. Held to: the same SV count, the same held-out accuracy line, the
port CONVERGED and the JAX fit without a non-convergence warning, and b
within 1e-4 (PARITY.md's cross-engine band); --mode oracle equal bit for
bit (the same numpy code: b to all 15 printed places and the iteration
count). `info` prints the JAX command line's description of a model
artifact of either package line for line.
"""

import re
import warnings

import numpy as np
import pytest

from tpusvm.cli import main as j_main
from tpusvm.data import blobs, rings, write_csv
from tpusvm_torch.cli import main as t_main


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("front")
    X, _ = rings(n=420, seed=13)
    # three raw classes, so --positive-label picks the +1 class
    lab = np.where(np.linalg.norm(X, axis=1) < 1.0, 1,
                   np.where(X[:, 0] > 0, 2, 0)).astype(np.int32)
    write_csv(str(d / "a.csv"), X[:320], lab[:320])
    write_csv(str(d / "b.csv"), X[320:], lab[320:])
    Xb, Yb = blobs(n=360, d=5, seed=2)
    write_csv(str(d / "blobs_a.csv"), Xb[:280], Yb[:280])
    write_csv(str(d / "blobs_b.csv"), Xb[280:], Yb[280:])
    return d


def _run(main, argv, capsys):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    bad = [str(x.message) for x in w if "terminated with" in str(x.message)]
    return out, bad


def _field(pattern, out):
    m = re.search(pattern, out)
    assert m, (pattern, out)
    return m.group(1)


_CASES = {
    "default": ("", ["--C", "10", "--gamma", "10"]),
    "positive_label": ("", ["--C", "10", "--gamma", "10",
                             "--positive-label", "2"]),
    "n_limit": ("", ["--C", "10", "--gamma", "10", "--n-limit", "200"]),
    "preset": ("blobs_", ["--preset", "debug"]),
    "no_scale": ("", ["--C", "10", "--gamma", "10", "--no-scale"]),
    "accum_none": ("", ["--C", "1", "--gamma", "10", "--accum", "none"]),
    "tau_eps_sv_tol": ("", ["--C", "10", "--gamma", "10", "--tau", "1e-4",
                             "--eps", "1e-10", "--sv-tol", "1e-6"]),
    "oracle": ("", ["--C", "10", "--gamma", "10", "--mode", "oracle"]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_train_on_a_csv_matches_the_jax_cli(csvs, capsys, case):
    stem, flags = _CASES[case]
    src = ["--train", str(csvs / f"{stem}a.csv"),
           "--test", str(csvs / f"{stem}b.csv")]
    out_j, bad_j = _run(j_main, ["train", *src, *flags], capsys)
    out_t, bad_t = _run(t_main, ["train", *src, *flags, "--device", "cpu"],
                        capsys)
    assert not bad_j and not bad_t
    assert "status = CONVERGED" in out_t
    for pat in (r"n = (\d+, n_features = \d+)", r"SV count = (\d+)",
                r"(accuracy = [\d.]+ \(\d+/\d+\))"):
        assert _field(pat, out_t) == _field(pat, out_j), pat
    b_t, b_j = (float(_field(r"b = (-?[\d.]+)", o)) for o in (out_t, out_j))
    if case == "oracle":
        assert _field(r"b = (-?[\d.]+)", out_t) == _field(r"b = (-?[\d.]+)",
                                                          out_j)
        assert _field(r"iterations = (\d+)", out_t) == _field(
            r"iterations = (\d+)", out_j)
    else:
        assert abs(b_t - b_j) <= 1e-4
    if case == "n_limit":
        assert "n = 200," in out_t


def test_predict_on_a_csv_matches_the_jax_cli(csvs, tmp_path, capsys):
    model = str(tmp_path / "m.npz")
    _run(t_main, ["train", "--train", str(csvs / "a.csv"), "--C", "10",
                  "--gamma", "10", "--device", "cpu", "--save", model],
         capsys)
    for extra in ([], ["--n-limit", "40"], ["--positive-label", "2"]):
        argv = ["predict", "--model", model, "--data", str(csvs / "b.csv"),
                *extra]
        out_t, _ = _run(t_main, [*argv, "--device", "cpu"], capsys)
        out_j, _ = _run(j_main, argv, capsys)
        pat = r"(accuracy = [\d.]+ \(\d+/\d+\))"
        assert _field(pat, out_t) == _field(pat, out_j)


def test_checkpoint_and_shrink_flags(csvs, tmp_path, capsys):
    src = ["--train", str(csvs / "a.csv"), "--test", str(csvs / "b.csv"),
           "--C", "10", "--gamma", "10", "--device", "cpu"]
    plain, _ = _run(t_main, ["train", *src, "--q", "64"], capsys)
    ck = str(tmp_path / "ck.npz")
    out, _ = _run(t_main, ["train", *src, "--q", "64", "--checkpoint", ck,
                           "--checkpoint-every", "2"], capsys)
    pat = r"(b = -?[\d.]+)"
    assert _field(pat, out) == _field(pat, plain)
    out, _ = _run(t_main, ["train", *src, "--q", "64", "--checkpoint", ck,
                           "--resume"], capsys)
    assert _field(pat, out) == _field(pat, plain)
    out, _ = _run(t_main, ["train", *src, "--q", "64", "--shrink-every", "2",
                           "--solver-opt", "shrink_min=64", "--save",
                           str(tmp_path / "s.npz")], capsys)
    assert "status = CONVERGED" in out
    _run(t_main, ["info", str(tmp_path / "s.npz")], capsys)
    out, _ = _run(t_main, ["info", str(tmp_path / "s.npz")], capsys)
    assert "shrinking=every 2 rounds (stable 3)" in out
    out, _ = _run(t_main, ["train", *src, "--solver-opt", "refine=400",
                           "--solver-opt", "krow_cache=400"], capsys)
    assert "status = CONVERGED" in out


@pytest.mark.parametrize("argv,match", [
    (["--mode", "cascade", "--solver", "pair", "--shrink-every", "2"],
     "blocked solver"),
    (["--mode", "pod"], "item 9"),
    (["--solver", "pair", "--checkpoint", "c.npz"], "blocked solver"),
    (["--mode", "oracle", "--checkpoint", "c.npz"], "oracle"),
    (["--resume"], "--checkpoint"),
    (["--shrink-every", "2", "--solver", "pair"], "blocked solver"),
    (["--shrink-every", "2", "--checkpoint", "c.npz"], "cannot be combined"),
    (["--mode", "oracle", "--solver-opt", "q=64"], "oracle"),
    (["--mode", "oracle", "--multiclass"], "--mode single"),
])
def test_flag_refusals(csvs, argv, match):
    with pytest.raises(SystemExit, match=match):
        t_main(["train", "--train", str(csvs / "a.csv"), "--device", "cpu",
                *argv])


def test_exactly_one_data_source(csvs):
    with pytest.raises(SystemExit, match="exactly one"):
        t_main(["train", "--device", "cpu"])
    with pytest.raises(SystemExit, match="exactly one"):
        t_main(["train", "--train", str(csvs / "a.csv"), "--synthetic",
                "rings", "--device", "cpu"])


def test_info_without_a_path(capsys):
    assert t_main(["info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("torch ") and "\ncuda " in out
    import torch

    if not torch.cuda.is_available():
        assert "no CUDA device is visible" in out


def _models(tmp_path):
    """Artifacts of every kind: binary (rbf, poly), calibrated, svr and
    one-vs-rest from the port; binary sigmoid and one-vs-rest from the JAX
    package."""
    import jax.numpy as jnp

    from tpusvm.config import SVMConfig as JConfig
    from tpusvm.data import svr_sine
    from tpusvm.models import BinarySVC as JSVC
    from tpusvm.models import OneVsRestSVC as JOvR
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC

    X, Y = rings(n=200, seed=1)
    Xb, Yb = blobs(n=160, d=6, seed=4)
    lab = np.where(np.linalg.norm(X, axis=1) < 1.0, 1,
                   np.where(X[:, 0] > 0, 2, 0)).astype(np.int32)
    cfg = SVMConfig(C=10.0, gamma=10.0)
    m = BinarySVC(cfg, device="cpu").fit(X, Y)
    m.save(str(tmp_path / "svc.npz"))
    m.calibrate(X, Y, folds=2)
    m.save(str(tmp_path / "cal.npz"))
    BinarySVC(SVMConfig(C=1.0, gamma=1.0, kernel="poly", coef0=1.0),
              device="cpu").fit(Xb, Yb).save(str(tmp_path / "poly.npz"))
    Xr, tr = svr_sine(n=120, d=1, seed=2)
    EpsilonSVR(SVMConfig(C=10.0, gamma=20.0), device="cpu").fit(
        Xr, tr).save(str(tmp_path / "svr.npz"))
    OneVsRestSVC(cfg, device="cpu").fit(X, lab).save(str(tmp_path / "ovr.npz"))
    JSVC(JConfig(C=10.0, gamma=0.25, kernel="sigmoid", coef0=-1.0),
         dtype=jnp.float32).fit(Xb, Yb).save(str(tmp_path / "jsvc.npz"))
    JOvR(JConfig(C=10.0, gamma=10.0)).fit(X, lab).save(
        str(tmp_path / "jovr.npz"))
    return {name: str(tmp_path / f"{name}.npz")
            for name in ("svc", "cal", "poly", "svr", "ovr", "jsvc", "jovr")}


def test_info_describes_artifacts_of_either_package(tmp_path, capsys):
    for name, path in _models(tmp_path).items():
        assert t_main(["info", path]) == 0
        out_t = capsys.readouterr().out
        assert j_main(["info", path]) == 0
        out_j = capsys.readouterr().out
        assert out_t == out_j, name
        assert out_t.startswith("model: ")


def test_info_refuses_the_artifacts_of_later_items(tmp_path):
    js = tmp_path / "tune.json"
    js.write_text('{"kind": "tpusvm-tune-result"}')
    with pytest.raises(SystemExit, match="item 11"):
        t_main(["info", str(js)])
    with pytest.raises(SystemExit, match="item 11"):
        t_main(["info", str(tmp_path)])
    bad = tmp_path / "junk.bin"
    bad.write_bytes(b"\x00\x01")
    with pytest.raises(SystemExit, match="not a readable model"):
        t_main(["info", str(bad)])
