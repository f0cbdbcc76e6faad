"""Crash-safe tail appends in tpusvm_torch (stream/append.py), on the CPU,
held against the JAX package's tpusvm/stream/append.py.

Bands: exact. For the same seeded batches the port's grown dataset has the
JAX package's manifest bytes and shard rows, and a one-shot ingest's; a
kill at every hit of the append's fault points resumes to those bytes; a
session killed in one package leaves the other package's journal bytes
and resumes in the other package to the same dataset.
"""

import json
import os

import numpy as np
import pytest

from tpusvm import faults as j_faults
from tpusvm.stream import ShardWriter as JShardWriter
from tpusvm.stream import ingest_arrays as j_ingest_arrays
from tpusvm_torch import faults
from tpusvm_torch.data import rings
from tpusvm_torch.status import StreamStatus
from tpusvm_torch.stream import (AppendError, AppendWriter, ShardError,
                                 ShardWriter, append_blocks, ingest_arrays,
                                 ingest_blocks, open_dataset)

X, Y = rings(n=300, seed=11)
BATCHES = [(s, min(300, s + 40)) for s in range(150, 300, 40)]
JOURNAL = "ingest.journal.json"


def _prefix(tmp_path, name, ingest=ingest_arrays, n0=150):
    out = str(tmp_path / name)
    ingest(out, X[:n0], Y[:n0], rows_per_shard=64)
    return out


def _session(writer_cls, out, resume=False, batches=BATCHES):
    w = writer_cls.open_append(out, resume=resume)
    for a, b in batches:
        w.append(X[a:b], Y[a:b])
    return w.close()


def _manifest_bytes(out):
    with open(os.path.join(out, "manifest.json"), "rb") as f:
        return f.read()


def _rows(out):
    # shard files carry the zip write time, so rows are compared array by
    # array; the manifest's checksums cover their bytes
    return open_dataset(out).load_arrays()


def _same_dataset(a, b):
    assert _manifest_bytes(a) == _manifest_bytes(b)
    for x, y in zip(_rows(a), _rows(b)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert all(s == StreamStatus.OK for s in open_dataset(a).validate())
    assert not os.path.exists(os.path.join(a, JOURNAL))


@pytest.fixture()
def one_shot(tmp_path):
    return _prefix(tmp_path, "one_shot", n0=300)


@pytest.mark.parametrize("n0, batches", [
    (150, BATCHES),                       # a short tail shard re-cut
    (192, [(192, 256)]),                  # a full tail: no adoption
    (150, [(150, 151), (151, 300)]),      # a one-row batch, then the rest
], ids=["short_tail", "full_tail", "ragged"])
def test_append_equals_jax_and_a_one_shot_ingest(tmp_path, n0, batches):
    end = batches[-1][1]
    ref = str(tmp_path / "ref")
    ingest_arrays(ref, X[:end], Y[:end], rows_per_shard=64)
    port = _prefix(tmp_path, "port", n0=n0)
    jax = _prefix(tmp_path, "jax", ingest=j_ingest_arrays, n0=n0)
    m = _session(ShardWriter, port, batches=batches)
    _session(JShardWriter, jax, batches=batches)
    _same_dataset(port, ref)
    _same_dataset(port, jax)
    assert m.n_rows == end
    # the merged stats are a whole-array fit's (the old rows' extremes kept)
    st = open_dataset(port).stats()
    assert np.array_equal(st.min_val, X[:end].min(axis=0))
    assert np.array_equal(st.max_val, X[:end].max(axis=0))
    # the prefix is a strict prefix of the grown dataset
    Xg, Yg = _rows(port)
    assert np.array_equal(Xg[:n0], X[:n0]) and np.array_equal(Yg, Y[:end])


def _hits(tmp_path, point):
    out = _prefix(tmp_path, "count_" + point.replace(".", "_"))
    plan = faults.FaultPlan([], seed=0)
    with faults.active(plan):
        _session(ShardWriter, out)
    return plan.hits(point)


@pytest.mark.parametrize("point", ["stream.append", "ingest.write_shard"])
def test_a_kill_at_every_hit_resumes_to_the_same_bytes(tmp_path, one_shot,
                                                       point):
    hits = _hits(tmp_path, point)
    assert hits >= 3, f"{point} fired only {hits} times"
    for k in range(1, hits + 1):
        out = _prefix(tmp_path, f"k_{point.replace('.', '_')}_{k}")
        plan = faults.FaultPlan(
            [faults.FaultRule(point=point, kind="kill", at_hit=k)], seed=0)
        with pytest.raises(faults.SimulatedKill):
            with faults.active(plan):
                _session(ShardWriter, out)
        _session(ShardWriter, out, resume=True)
        _same_dataset(out, one_shot)


def _killed(pkg, out, k):
    """An append session of `pkg` killed at the k-th stream.append hit."""
    fl, writer = ((faults, ShardWriter) if pkg == "torch"
                  else (j_faults, JShardWriter))
    plan = fl.FaultPlan(
        [fl.FaultRule(point="stream.append", kind="kill", at_hit=k)], seed=0)
    with pytest.raises(fl.SimulatedKill):
        with fl.active(plan):
            _session(writer, out)


@pytest.mark.parametrize("k", [1, 3, 4, 5])
@pytest.mark.parametrize("first, then", [("torch", "jax"), ("jax", "torch")])
def test_a_journal_resumes_in_the_other_package(tmp_path, one_shot, first,
                                                then, k):
    """k: the session's first and last journal writes, the commit's entry
    (shards staged, none renamed) and its committed transition (manifest
    replaced, journal not yet deleted)."""
    assert _hits(tmp_path, "stream.append") == 5
    a = _prefix(tmp_path, "a", ingest=ingest_arrays)
    b = _prefix(tmp_path, "b", ingest=j_ingest_arrays)
    _killed("torch", a, k)
    _killed("jax", b, k)
    # the two packages leave the same crash site: journal and manifest
    for name in (JOURNAL, "manifest.json"):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        assert os.path.exists(pa) == os.path.exists(pb), name
        if os.path.exists(pa):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name
    site = a if first == "torch" else b
    _session(ShardWriter if then == "torch" else JShardWriter, site,
             resume=True)
    _same_dataset(site, one_shot)


def _refusal(case, tmp_path):
    out = _prefix(tmp_path, "r")
    if case == "not_a_dataset":
        with pytest.raises(FileNotFoundError, match="not a committed"):
            ShardWriter.open_append(str(tmp_path / "nope"))
    elif case == "rows_per_shard":
        with pytest.raises(AppendError, match="rows_per_shard"):
            ShardWriter.open_append(out, rows_per_shard=32)
    elif case == "feature_count":
        w = ShardWriter.open_append(out)
        with pytest.raises(ValueError, match="feature count"):
            w.append(np.zeros((4, 5)), np.ones(4, np.int32))
    elif case == "divergent_replay":
        _killed("torch", out, 2)
        w = ShardWriter.open_append(out, resume=True)
        a, b = BATCHES[0]
        with pytest.raises(AppendError, match="divergent"):
            w.append(X[a:b] + 1.0, Y[a:b])
    elif case == "journal_without_resume":
        _killed("torch", out, 2)
        with pytest.raises(AppendError, match="resume=True"):
            ShardWriter.open_append(out)
    elif case == "corrupt_staged_shard":
        plan = faults.FaultPlan([
            faults.FaultRule(point="ingest.write_shard", kind="corrupt",
                             at_hit=1),
            faults.FaultRule(point="stream.append", kind="kill", at_hit=2),
        ], seed=9)
        with pytest.raises(faults.SimulatedKill):
            with faults.active(plan):
                _session(ShardWriter, out)
        with pytest.raises(ShardError):
            ShardWriter.open_append(out, resume=True)
    elif case == "v1_journal":
        fresh = str(tmp_path / "v1")
        plan = faults.FaultPlan([faults.FaultRule(
            point="ingest.write_shard", kind="kill", at_hit=3)], seed=0)
        with pytest.raises(faults.SimulatedKill):
            with faults.active(plan):
                ingest_blocks(fresh, [(X, Y)], rows_per_shard=64)
        with pytest.raises(FileNotFoundError):
            ShardWriter.open_append(fresh, resume=True)
        # an append journal met by a fresh ingest's resume is named
        _killed("torch", out, 2)
        with pytest.raises(ValueError, match="APPEND-session journal"):
            ShardWriter(out, rows_per_shard=64, resume=True)
    elif case == "changed_under_the_journal":
        _killed("torch", out, 2)
        ingest_arrays(out + "_other", X[:100], Y[:100], rows_per_shard=64)
        os.replace(os.path.join(out + "_other", "manifest.json"),
                   os.path.join(out, "manifest.json"))
        with pytest.raises(AppendError, match="changed under"):
            ShardWriter.open_append(out, resume=True)
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "not_a_dataset", "rows_per_shard", "feature_count", "divergent_replay",
    "journal_without_resume", "corrupt_staged_shard", "v1_journal",
    "changed_under_the_journal"])
def test_append_refuses_what_it_cannot_apply_exactly_once(tmp_path, case):
    _refusal(case, tmp_path)


@pytest.mark.parametrize("how", ["transient", "empty", "fresh_resume",
                                 "append_blocks"])
def test_append_sessions_that_need_no_recovery(tmp_path, one_shot, how):
    out = _prefix(tmp_path, "s")
    if how == "transient":
        plan = faults.FaultPlan([faults.FaultRule(
            point="stream.append", kind="transient", max_hits=2)], seed=0)
        with faults.active(plan):
            _session(ShardWriter, out)
        assert plan.hits("stream.append") > 2
    elif how == "empty":
        before = _manifest_bytes(out)
        m = AppendWriter(out).close()
        assert _manifest_bytes(out) == before and m.n_rows == 150
        return
    elif how == "fresh_resume":
        _session(ShardWriter, out, resume=True)  # no journal: a fresh session
    else:
        m = append_blocks(out, ((X[a:b], Y[a:b]) for a, b in BATCHES))
        assert m.n_rows == 300
    _same_dataset(out, one_shot)


def test_an_appended_dataset_feeds_a_warm_refresh(tmp_path):
    import torch

    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve.refresh import refresh_fit

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _prefix(tmp_path, "loop")
        deployed = str(tmp_path / "dep.npz")
        BinarySVC(SVMConfig(C=10.0, gamma=10.0), device="cpu").fit(
            X[:150], Y[:150]).save(deployed)
        _session(ShardWriter, out)
        Xg, Yg = open_dataset(out).load_arrays()
        model = refresh_fit(deployed, Xg, Yg,
                            out_path=str(tmp_path / "re.npz"), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert model.status_.name == "CONVERGED"
    assert model.score(X, Y) > 0.8
    assert json.loads(_manifest_bytes(out))["n_rows"] == 300
