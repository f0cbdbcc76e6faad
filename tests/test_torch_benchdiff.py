"""tpusvm_torch.obs.benchdiff and `benchdiff` held to the JAX package's:
the same rules and keys, and on the committed fixtures and on records
written here, the same exit code and the same rendered verdict (text,
json, markdown) at both levels, with and without --allow-cross-backend.
Every comparison is exact.
"""

import contextlib
import dataclasses
import io
import json
import os

import pytest

from tpusvm.cli import main as j_main
from tpusvm.obs import benchdiff as jbd
from tpusvm_torch.cli import main as t_main
from tpusvm_torch.obs import benchdiff as tbd

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "benchdiff")
BASE = os.path.join(FIX, "baseline.jsonl")
REGR = os.path.join(FIX, "regressed.jsonl")


def test_rules_and_keys_are_the_jax_packages():
    assert tbd.KEY_FIELDS == jbd.KEY_FIELDS

    def flat(rules):
        return [dataclasses.astuple(r) for r in rules]

    assert flat(tbd.DEFAULT_RULES) == flat(jbd.DEFAULT_RULES)
    assert sorted(tbd.SCHEMA_RULES) == sorted(jbd.SCHEMA_RULES)
    for schema in jbd.SCHEMA_RULES:
        assert flat(tbd.SCHEMA_RULES[schema]) == flat(
            jbd.SCHEMA_RULES[schema]), schema
        assert flat(tbd.rules_for(schema)) == flat(jbd.rules_for(schema))


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _both(old, new, *flags):
    argv = ["benchdiff", old, new, *flags]
    j, t = _cli(j_main, argv), _cli(t_main, argv)
    assert t == j, (t[1], j[1])
    return t


@pytest.mark.parametrize("fmt", ["text", "json", "markdown"])
@pytest.mark.parametrize("level", ["full", "smoke"])
@pytest.mark.parametrize("pair", [(BASE, BASE), (BASE, REGR), (REGR, BASE),
                                  (REGR, REGR)],
                         ids=["base-base", "base-regr", "regr-base",
                              "regr-regr"])
def test_fixture_verdicts_match(pair, level, fmt):
    rc, out = _both(*pair, "--level", level, "--format", fmt)
    if pair[0] == pair[1]:
        assert rc == 0
    if fmt == "json":
        assert json.loads(out)["ok"] is (rc == 0)


def _port_record(**kw):
    """A benchmark record as the port writes one: chip_smoke.py phase 5's
    {"bench": ...} body, its backend named gpu."""
    rec = {"metric": "mnist60k_smo_train_time", "value": 8.25, "unit": "s",
           "train_s": 8.25, "updates": 123456, "n_sv": 9876,
           "accuracy": 0.9812, "status": "CONVERGED",
           "provenance": {"backend": "gpu", "device": "NVIDIA H100 80GB HBM3",
                          "torch": "2.x", "cuda": "12.x"}}
    rec.update(kw)
    return rec


def _write(path, *recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(path)


@pytest.mark.parametrize("fmt", ["text", "json", "markdown"])
def test_port_artifacts_gate_alike(tmp_path, fmt):
    port = _write(tmp_path / "port.jsonl", _port_record())
    slow = _write(tmp_path / "slow.jsonl", _port_record(value=16.5))
    tpu = _write(tmp_path / "tpu.jsonl", _port_record(
        value=7.0, provenance={"backend": "tpu", "device_kind": "v5e"}))
    f = ["--format", fmt]
    assert _both(port, port, *f)[0] == 0
    # the train seconds doubled: a timing regression at full, skipped at
    # smoke (where the runner is not the baseline's machine)
    assert _both(port, slow, *f)[0] == 1
    assert _both(port, slow, "--level", "smoke", *f)[0] == 0
    # a TPU artifact is not comparable with the port's: refused by default,
    # annotated when allowed
    assert _both(tpu, port, *f)[0] == 1
    rc, out = _both(tpu, port, "--allow-cross-backend", *f)
    assert rc == 0 and "tpu" in out and "gpu" in out


def test_missing_rows_and_unreadable_files_alike(tmp_path):
    two = _write(tmp_path / "two.jsonl", _port_record(),
                 _port_record(metric="other", value=1.0))
    one = _write(tmp_path / "one.jsonl", _port_record())
    assert _both(two, one)[0] == 1
    assert _both(one, two)[0] == 0
    torn = tmp_path / "torn.jsonl"
    torn.write_text('{"metric": "x", "value"\n')
    assert _both(str(torn), one)[0] == 1
    assert _both(str(tmp_path / "absent.jsonl"), one)[0] == 1


@pytest.mark.parametrize("level", ["full", "smoke"])
def test_diff_records_api_matches(level):
    old, new = jbd.load_jsonl(BASE), jbd.load_jsonl(REGR)
    assert tbd.load_jsonl(BASE) == old
    j = jbd.diff_records(old, new, level=level)
    t = tbd.diff_records(old, new, level=level)
    assert (t.ok, t.to_text(), t.to_json(), t.to_markdown()) == (
        j.ok, j.to_text(), j.to_json(), j.to_markdown())
