"""The port's sharded dataset tier against the JAX package's, on the CPU.

Band: bit for bit. A dataset written by either package opens, validates
and reads in the other: the same manifest bytes, the same shard arrays
and checksums. The manifest-fitted scaler has the bits of
MinMaxScaler.fit on the whole array. validate() gives the JAX package's
StreamStatus for a missing shard, a flipped byte and a truncated file.
The reader keeps its prefetch_depth + 1 residency bound, retries a
transient `stream.read_shard` fault and ends a persistent one in the
JAX package's ShardError(READ_FAILED). partition_from_dataset equals the
in-memory partition, and the JAX package's, bit for bit.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from tpusvm import faults as jfaults
from tpusvm import stream as jstream
from tpusvm.cli import main as j_main
from tpusvm.data import MinMaxScaler as JScaler
from tpusvm.data.partition import partition as j_partition
from tpusvm_torch import faults
from tpusvm_torch import stream
from tpusvm_torch.cli import main as t_main
from tpusvm_torch.data import MinMaxScaler, mnist_like, rings, write_csv
from tpusvm_torch.data.partition import partition
from tpusvm_torch.obs.registry import MetricsRegistry
from tpusvm_torch.status import StreamStatus


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.deactivate()
    jfaults.deactivate()


def _data(n=700, d=12, seed=3):
    X, Y = mnist_like(n=n, d=d, noise=3.0, label_noise=0.01, seed=seed)
    return X, Y.astype(np.int32)


def _files(path):
    return sorted(f for f in os.listdir(path) if not f.endswith(".tmp"))


def _arrays_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_crosses_between_packages_bit_for_bit(tmp_path, writer):
    X, Y = _data()
    wpkg, rpkg = (jstream, stream) if writer == "jax" else (stream, jstream)
    wpkg.ingest_arrays(str(tmp_path / "w"), X, Y, rows_per_shard=128)
    # the other package writes the same rows: the manifests are the same
    # bytes, key order and float formatting included
    rpkg.ingest_arrays(str(tmp_path / "r"), X, Y, rows_per_shard=128)
    assert (tmp_path / "w" / "manifest.json").read_bytes() == \
        (tmp_path / "r" / "manifest.json").read_bytes()
    assert _files(tmp_path / "w") == _files(tmp_path / "r")
    ds = rpkg.open_dataset(str(tmp_path / "w"))
    assert [int(s) for s in ds.validate()] == [0] * ds.n_shards
    assert ds.n_shards == 6 and ds.n_rows == len(X)
    other = wpkg.open_dataset(str(tmp_path / "w"))
    for i in range(ds.n_shards):
        Xa, Ya = ds.load_shard(i, verify=True)
        Xb, Yb = other.load_shard(i)
        _arrays_equal(Xa, Xb)
        _arrays_equal(Ya, Yb)
        info = ds.manifest.shards[i]
        assert stream.shard_checksum(Xa, Ya) == \
            jstream.shard_checksum(Xa, Ya) == info.sha256
    Xr, Yr = ds.load_arrays()
    _arrays_equal(Xr, X)
    _arrays_equal(Yr, Y)
    _arrays_equal(ds.load_labels(), Y)


def test_csv_ingest_is_the_jax_packages(tmp_path):
    X, Y = _data(n=300)
    labels = np.where(Y > 0, 3, 7)
    csv = str(tmp_path / "a.csv")
    write_csv(csv, X, labels)
    kw = dict(rows_per_shard=100, positive_label=3, block_rows=37)
    mt = stream.ingest_csv(str(tmp_path / "t"), csv, **kw)
    mj = jstream.ingest_csv(str(tmp_path / "j"), csv, **kw)
    assert mt.to_json() == mj.to_json()
    assert (tmp_path / "t" / "manifest.json").read_bytes() == \
        (tmp_path / "j" / "manifest.json").read_bytes()
    mc = stream.ingest_csv(str(tmp_path / "tm"), csv, rows_per_shard=64,
                           binary=False)
    assert mc.to_json() == jstream.ingest_csv(
        str(tmp_path / "jm"), csv, rows_per_shard=64,
        binary=False).to_json()


def test_manifest_scaler_has_the_whole_array_bits(tmp_path):
    X, Y = _data(n=500, d=9)
    X[:, 4] = 2.5  # a constant feature takes the degenerate-range branch
    stream.ingest_arrays(str(tmp_path / "d"), X, Y, rows_per_shard=97)
    ds = stream.open_dataset(str(tmp_path / "d"))
    sc = ds.scaler()
    full = MinMaxScaler().fit(X)
    jfull = JScaler().fit(X)
    for a, b in ((sc.min_val, full.min_val), (sc.max_val, full.max_val),
                 (sc.min_val, jfull.min_val), (sc.max_val, jfull.max_val)):
        _arrays_equal(np.asarray(a), np.asarray(b))
    _arrays_equal(sc.transform(X), full.transform(X))
    js = jstream.open_dataset(str(tmp_path / "d")).scaler()
    _arrays_equal(sc.transform(X), js.transform(X))
    with pytest.raises(ValueError, match="no shard stats"):
        stream.merge_stats([])


def _damage(path, how):
    if how == "missing":
        os.remove(path)
    elif how == "flipped":
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))
    else:
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[: len(raw) // 2])


@pytest.mark.parametrize("how,status", [
    ("missing", StreamStatus.MISSING_FILE),
    ("flipped", StreamStatus.CHECKSUM_MISMATCH),
    ("truncated", StreamStatus.CHECKSUM_MISMATCH)])
def test_validate_gives_the_jax_packages_status(tmp_path, capsys, how, status):
    X, Y = _data(n=400)
    d = str(tmp_path / "d")
    stream.ingest_arrays(d, X, Y, rows_per_shard=100)
    ds = stream.open_dataset(d)
    _damage(ds.shard_path(2), how)
    got = stream.open_dataset(d).validate()
    want = jstream.open_dataset(d).validate()
    assert [int(s) for s in got] == [int(s) for s in want]
    assert got == [StreamStatus.OK, StreamStatus.OK, status, StreamStatus.OK]
    with pytest.raises(stream.ShardError, match="shard-00002") as ei:
        stream.open_dataset(d).load_shard(2)
    assert ei.value.status == status
    # info DIR prints the JAX command line's report and exits 1
    assert t_main(["info", d]) == 1
    out_t = capsys.readouterr().out
    assert j_main(["info", d]) == 1
    assert out_t == capsys.readouterr().out
    assert f"shard-00002.npz: {status.name}" in out_t


def test_stats_and_row_count_mismatch_are_named(tmp_path):
    X, Y = _data(n=300)
    d = str(tmp_path / "d")
    stream.ingest_arrays(d, X, Y, rows_per_shard=100)
    man = json.loads((tmp_path / "d" / "manifest.json").read_text())
    man["shards"][0]["max"][0] += 1.0
    (tmp_path / "d" / "manifest.json").write_text(json.dumps(man))
    ds = stream.open_dataset(d)
    np.savez(ds.shard_path(1), X=X[100:150], Y=Y[100:150])
    got = ds.validate()
    assert got == [StreamStatus.STATS_MISMATCH, StreamStatus.ROW_COUNT_MISMATCH,
                   StreamStatus.OK]
    assert [int(s) for s in got] == [
        int(s) for s in jstream.open_dataset(d).validate()]


class _SlowConsumer:
    def __init__(self, reader):
        self.reader = reader
        self.live = []

    def run(self):
        rows = []
        for X, Y in self.reader:
            self.live.append(self.reader.live_shards)
            time.sleep(0.01)
            rows.append(X)
        return np.concatenate(rows)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_reader_keeps_its_residency_bound(tmp_path, depth):
    X, Y = _data(n=600)
    stream.ingest_arrays(str(tmp_path / "d"), X, Y, rows_per_shard=50)
    ds = stream.open_dataset(str(tmp_path / "d"))
    reg = MetricsRegistry()
    r = stream.ShardReader(ds, prefetch_depth=depth, metrics=reg)
    c = _SlowConsumer(r)
    _arrays_equal(c.run(), X)
    assert r.max_live_shards <= depth + 1
    assert max(c.live) <= depth + 1
    assert reg.gauge("stream.live_shards").value == r.max_live_shards
    assert reg.counter("stream.shards_loaded").value == 12
    # a seeded order is the JAX reader's order
    order = stream.ShardReader(ds, seed=4).shard_order
    jorder = jstream.ShardReader(jstream.open_dataset(str(tmp_path / "d")),
                                 seed=4).shard_order
    assert order.tolist() == jorder.tolist() != list(range(12))


def test_reader_hook_on_tensors_rechunks_like_numpy(tmp_path):
    X, Y = _data(n=333)
    stream.ingest_arrays(str(tmp_path / "d"), X, Y, rows_per_shard=64)
    ds = stream.open_dataset(str(tmp_path / "d"))
    sc = ds.scaler()
    plain = list(stream.ShardReader(ds, scaler=sc, dtype=np.float32)
                 .batches(50))
    hooked = list(stream.ShardReader(
        ds, scaler=sc, dtype=np.float32,
        transform=lambda B: torch.as_tensor(B) * 2.0).batches(50))
    assert [len(b[0]) for b in hooked] == [len(b[0]) for b in plain]
    for (Zt, Yt), (Zp, Yp) in zip(hooked, plain):
        assert isinstance(Zt, torch.Tensor)
        _arrays_equal(Zt.numpy(), Zp * 2.0)
        _arrays_equal(Yt, Yp)


def test_transient_read_faults_are_retried(tmp_path):
    X, Y = _data(n=400)
    d = str(tmp_path / "d")
    stream.ingest_arrays(d, X, Y, rows_per_shard=100)
    rule = dict(point="stream.read_shard", kind="transient", max_hits=3)
    reg = MetricsRegistry()
    plan = faults.FaultPlan([faults.FaultRule(**rule)], seed=5)
    with faults.active(plan):
        blocks = list(stream.ShardReader(stream.open_dataset(d), metrics=reg))
    _arrays_equal(np.concatenate([b[0] for b in blocks]), X)
    assert reg.counter("retry.recovered", op="stream.read_shard").value >= 1
    assert reg.counter("retry.exhausted", op="stream.read_shard").value == 0
    # the JAX reader under the same plan takes the same hits
    jplan = jfaults.FaultPlan([jfaults.FaultRule(**rule)], seed=5)
    with jfaults.active(jplan):
        list(jstream.ShardReader(jstream.open_dataset(d)))
    assert plan.hits("stream.read_shard") == jplan.hits("stream.read_shard") == 7


def test_persistent_read_fault_ends_in_read_failed(tmp_path):
    X, Y = _data(n=300)
    d = str(tmp_path / "d")
    stream.ingest_arrays(d, X, Y, rows_per_shard=100)
    rule = dict(point="stream.read_shard", kind="transient", max_hits=50)
    with faults.active(faults.FaultPlan([faults.FaultRule(**rule)], seed=5)):
        with pytest.raises(stream.ShardError, match="READ_FAILED") as ei:
            list(stream.ShardReader(stream.open_dataset(d),
                                    metrics=MetricsRegistry()))
    with jfaults.active(jfaults.FaultPlan([jfaults.FaultRule(**rule)],
                                          seed=5)):
        with pytest.raises(jstream.ShardError) as ej:
            list(jstream.ShardReader(jstream.open_dataset(d)))
    assert ei.value.status == StreamStatus.READ_FAILED
    assert int(ei.value.status) == int(ej.value.status)
    assert ei.value.filename == ej.value.filename == "shard-00000.npz"
    assert str(ei.value) == str(ej.value)


@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("parts", [2, 4])
def test_partition_from_dataset_is_the_in_memory_partition(tmp_path,
                                                           stratified, parts):
    X, Y = _data(n=501)
    order = np.argsort(Y, kind="stable")  # label-sorted: the stratified case
    X, Y = X[order], Y[order]
    d = str(tmp_path / "d")
    stream.ingest_arrays(d, X, Y, rows_per_shard=77)
    ds = stream.open_dataset(d)
    sc = ds.scaler()
    got = stream.partition_from_dataset(ds, parts, stratified=stratified,
                                        scaler=sc)
    want = partition(sc.transform(X), Y, parts, stratified=stratified)
    jgot = jstream.partition_from_dataset(jstream.open_dataset(d), parts,
                                          stratified=stratified,
                                          scaler=jstream.open_dataset(d)
                                          .scaler())
    jwant = j_partition(sc.transform(X), Y, parts, stratified=stratified)
    for a, b, c, e in zip(got, want, jgot, jwant):
        _arrays_equal(np.asarray(a), np.asarray(b))
        _arrays_equal(np.asarray(a), np.asarray(c))
        _arrays_equal(np.asarray(a), np.asarray(e))


def test_gather_rows_and_assignment(tmp_path):
    X, Y = _data(n=260)
    d = str(tmp_path / "d")
    stream.ingest_arrays(d, X, Y, rows_per_shard=60)
    ds = stream.open_dataset(d)
    idx = np.random.default_rng(0).permutation(260)[:40]
    _arrays_equal(stream.gather_rows(ds, idx), X[idx])
    for strat in (False, True):
        a = stream.assign_rows(260, 3, Y=Y, stratified=strat)
        b = jstream.assign_rows(260, 3, Y=Y, stratified=strat)
        for u, v in zip(a, b):
            _arrays_equal(np.asarray(u), np.asarray(v))
    with pytest.raises(IndexError):
        stream.gather_rows(ds, [260])


def test_ingest_kill_then_resume_is_identical(tmp_path):
    X, Y = rings(n=301, seed=11)
    Y = Y.astype(np.int32)

    def blocks():
        for s in range(0, len(X), 40):
            yield X[s:s + 40], Y[s:s + 40]

    ref = stream.ingest_blocks(str(tmp_path / "ref"), blocks(),
                               rows_per_shard=64)
    d = str(tmp_path / "d")
    plan = faults.FaultPlan([faults.FaultRule(
        point="ingest.write_shard", kind="kill", at_hit=3)])
    with pytest.raises(faults.SimulatedKill):
        with faults.active(plan):
            stream.ingest_blocks(d, blocks(), rows_per_shard=64)
    assert not os.path.exists(os.path.join(d, "manifest.json"))
    assert os.path.exists(os.path.join(d, "ingest.journal.json"))
    assert _files(d) == ["ingest.journal.json", "shard-00000.npz",
                         "shard-00001.npz"]
    # the JAX package resumes the port's journal to the same dataset
    got = jstream.ingest_blocks(d, blocks(), rows_per_shard=64, resume=True)
    assert got.to_json() == ref.to_json()
    assert not os.path.exists(os.path.join(d, "ingest.journal.json"))
    # transient write faults are retried to the same bytes
    d2 = str(tmp_path / "d2")
    plan = faults.FaultPlan([faults.FaultRule(
        point="ingest.write_shard", kind="transient", max_hits=2)])
    with faults.active(plan):
        again = stream.ingest_blocks(d2, blocks(), rows_per_shard=64)
    assert again.to_json() == ref.to_json()
    # a corrupt write is caught by validation
    d3 = str(tmp_path / "d3")
    plan = faults.FaultPlan([faults.FaultRule(
        point="ingest.write_shard", kind="corrupt", at_hit=2)])
    with faults.active(plan):
        stream.ingest_blocks(d3, blocks(), rows_per_shard=64)
    st = stream.open_dataset(d3).validate()
    assert st[1] == StreamStatus.CHECKSUM_MISMATCH and st.count(
        StreamStatus.OK) == 4


def test_ingest_smoke_and_synthetic_ingest(tmp_path, capsys):
    assert t_main(["ingest", "--smoke"]) == 0
    assert "ingest smoke ok: 301 rows, 5 shards" in capsys.readouterr().out
    d = str(tmp_path / "d")
    assert t_main(["ingest", "--synthetic", "rings", "--n", "300",
                   "--n-limit", "250", "--out", d,
                   "--rows-per-shard", "100"]) == 0
    X, Y = rings(n=300, seed=587)  # ingest draws no held-out rows
    Xr, Yr = stream.open_dataset(d).load_arrays()
    _arrays_equal(Xr, X[:250])
    _arrays_equal(Yr, Y[:250].astype(np.int32))


def test_open_refuses_what_is_not_a_dataset(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a sharded dataset"):
        stream.open_dataset(str(tmp_path))
    (tmp_path / "manifest.json").write_text('{"format_version": 9}')
    with pytest.raises(ValueError, match="format_version 9"):
        stream.open_dataset(str(tmp_path))
    with pytest.raises(ValueError, match="format_version 9"):
        stream.ShardWriter.open_append(str(tmp_path))
    with pytest.raises(ValueError, match="no rows appended"):
        stream.ShardWriter(str(tmp_path / "e")).close()
