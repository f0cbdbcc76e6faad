"""The port's pod tier (tpusvm_torch.pod) against the port's in-process
cascade and the JAX package, on tests/test_pod.py's fixture: rings(n=192,
seed=3) ingested at 24 rows a shard, P = 4, sv_capacity 128.

Bands: frames and round-state files cross the packages byte for byte; a
worker's leaf equals the in-process cascade's leaf byte for byte; the
port's pod_fit equals the port's cascade_fit (the pod's in-process
control) bit for bit — SV IDs, alpha bytes, b, rounds — and so do a
revived worker's run and a resumed coordinator's; against the JAX
package's cascade_fit (which tests/test_pod.py holds bit-equal to the JAX
pod) the band of tests/test_torch_cascade.py: the same SV-ID set, rounds
within +-1, |db| <= 1e-4. Worker start-up dominates the file, so the
control fits are shared per module and torch runs on one intra-op thread
(the workers take the coordinator's count from INIT).
"""

import contextlib
import io
import os
import socket
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import CascadeConfig as JCascadeConfig
from tpusvm.config import SVMConfig as JSVMConfig
from tpusvm.parallel.cascade import cascade_fit as j_cascade_fit
from tpusvm.parallel.svbuffer import SVBuffer as JSVBuffer
from tpusvm.pod import protocol as jprotocol
from tpusvm.pod import state as jstate
from tpusvm_torch import faults
from tpusvm_torch.cli import main as cli_main
from tpusvm_torch.config import CascadeConfig, SVMConfig
from tpusvm_torch.data import MinMaxScaler, rings
from tpusvm_torch.models import BinarySVC
from tpusvm_torch.oracle import get_sv_indices, smo_train
from tpusvm_torch.parallel.cascade import _leaf, cascade_fit
from tpusvm_torch.parallel.svbuffer import SVBuffer
from tpusvm_torch.pod import pod_fit, protocol
from tpusvm_torch.pod.coordinator import _Pod
from tpusvm_torch.pod.state import (check_pod_round_state_config,
                                    load_pod_round_state,
                                    save_pod_round_state)
from tpusvm_torch.pod.worker import load_leaf
from tpusvm_torch.stream import (ingest_arrays, open_dataset,
                                 partition_from_dataset)

CFG = SVMConfig(C=10.0, gamma=10.0, max_rounds=12)
JCFG = JSVMConfig(C=10.0, gamma=10.0, max_rounds=12)
P = 4
CPU = dict(device="cpu")


class _AnonymousTracer:
    """A tracer made without role=: it has no context to propagate."""

    role = None


def _cc(topology="tree"):
    return CascadeConfig(n_shards=P, sv_capacity=128, topology=topology)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Coordinator and workers on one intra-op thread: several worker
    processes of tiny solves contend badly for the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.deactivate()


@pytest.fixture(scope="module")
def rings_data():
    return rings(n=192, seed=3)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory, rings_data):
    X, Y = rings_data
    out = str(tmp_path_factory.mktemp("pod") / "ds")
    ingest_arrays(out, X, Y, rows_per_shard=24)
    return out


@pytest.fixture(scope="module")
def oracle(rings_data):
    X, Y = rings_data
    Xs = MinMaxScaler().fit_transform(X)
    return Xs, Y, smo_train(Xs, Y, CFG)


@pytest.fixture(scope="module")
def fits(data_dir, oracle, tmp_path_factory):
    """Per topology: the port's pod fit (the tree's with a round
    checkpoint) and its in-process control."""
    Xs, Y, _ = oracle
    ck = str(tmp_path_factory.mktemp("podck") / "tree.npz")
    out = {}
    for topo in ("tree", "star"):
        pod = pod_fit(data_dir, CFG, _cc(topo),
                      checkpoint_path=ck if topo == "tree" else None, **CPU)
        out[topo] = (pod, cascade_fit(Xs, Y, CFG, _cc(topo), **CPU))
    out["ckpt"] = ck
    return out


def _same_bits(res, ctrl):
    assert np.array_equal(res.sv_ids, ctrl.sv_ids)
    assert res.sv_alpha.dtype == ctrl.sv_alpha.dtype
    assert res.sv_alpha.tobytes() == ctrl.sv_alpha.tobytes()
    assert res.sv_X.tobytes() == ctrl.sv_X.tobytes()
    assert res.b == ctrl.b
    assert res.rounds == ctrl.rounds


# ---------------------------------------------------------------- protocol
_ARRAYS = {
    "f64": np.linspace(-1, 1, 7, dtype=np.float64),
    "f32": np.float32([[1.5, -2.25], [0.0, 3e-8]]),
    "i32": np.arange(-3, 3, dtype=np.int32),
    "mask": np.array([True, False, True]),
}
_META = {"op": "train", "req": 7, "b": 0.5, "use_partition": False}


def _raw_frame(sock):
    (total,) = struct.unpack(">I", protocol._recv_exact(sock, 4))
    return struct.pack(">I", total) + protocol._recv_exact(sock, total)


@pytest.mark.parametrize("arrays", [_ARRAYS, None], ids=["arrays", "meta"])
def test_frames_are_the_jax_frames_and_decode_in_both(arrays):
    a, b = socket.socketpair()
    try:
        # np.savez stamps each zip entry with the current second: compare
        # the port's frame with two JAX frames made around it in one second
        for _ in range(5):
            jprotocol.send_msg(a, _META, arrays)
            before = _raw_frame(b)
            protocol.send_msg(a, _META, arrays)
            port = _raw_frame(b)
            jprotocol.send_msg(a, _META, arrays)
            if _raw_frame(b) == before:
                break
        assert port == before
        # each package decodes the other's frame
        protocol.send_msg(a, _META, arrays)
        meta, got = jprotocol.recv_msg(b)
        jprotocol.send_msg(b, _META, arrays)
        meta2, got2 = protocol.recv_msg(a)
        assert meta == meta2 == _META
        for g in (got, got2):
            assert sorted(g) == sorted(arrays or {})
            for k, v in (arrays or {}).items():
                assert g[k].dtype == v.dtype and g[k].tobytes() == v.tobytes()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("frame,match", [
    (struct.pack(">I", 64) + b"\x00\x00\x00\x04abcd", "mid-frame"),
    (struct.pack(">I", 2) + b"xx", "bad frame length"),
    (struct.pack(">II", 8, 100) + b"xxxx", "bad meta length"),
])
def test_short_or_corrupt_frame_is_peer_death(frame, match):
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        a.close()
        with pytest.raises(ConnectionError, match=match):
            protocol.recv_msg(b)
    finally:
        b.close()


# ------------------------------------------------------------- round state
def _rand_arrays(rng, cap=16, dim=4):
    return dict(
        X=rng.normal(size=(cap, dim)).astype(np.float32),
        Y=np.where(rng.random(cap) < 0.5, 1, -1).astype(np.int32),
        alpha=rng.random(cap).astype(np.float64),
        ids=np.arange(cap, dtype=np.int32),
        valid=rng.random(cap) < 0.75,
    )


def test_round_state_files_cross_the_packages(tmp_path):
    rng = np.random.default_rng(7)
    arrs = _rand_arrays(rng)
    port_path, jax_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    save_pod_round_state(port_path,
                         SVBuffer(**{k: torch.as_tensor(v)
                                     for k, v in arrs.items()}),
                         {5, 2, 9}, 2, -1.5, P, "tree")
    jstate.save_pod_round_state(jax_path,
                                JSVBuffer(**{k: jnp.asarray(v)
                                             for k, v in arrs.items()}),
                                {5, 2, 9}, 2, -1.5, P, "tree")
    for path in (port_path, jax_path):
        jsv, jids, jnext, jb = jstate.load_pod_round_state(path)
        sv, ids, nxt, b = load_pod_round_state(path)
        assert (ids, nxt, b) == (jids, jnext, jb) == ({2, 5, 9}, 3, -1.5)
        for f, v in arrs.items():
            # alpha keeps its stored (f64) dtype in both
            assert getattr(sv, f).numpy().tobytes() == v.tobytes(), f
            assert np.asarray(getattr(jsv, f)).tobytes() == v.tobytes(), f
        check_pod_round_state_config(path, P, "tree")
        jstate.check_pod_round_state_config(path, P, "tree")
        with pytest.raises(ValueError, match="n_leaves=4"):
            check_pod_round_state_config(path, 8, "tree")
        with pytest.raises(ValueError, match="topology"):
            check_pod_round_state_config(path, P, "star")
    assert not os.path.exists(port_path + ".tmp.npz")


# ------------------------------------------------------------ leaf loading
@pytest.mark.parametrize("stratified", [False, True])
def test_leaf_is_the_partition_leaf(data_dir, stratified):
    ds = open_dataset(data_dir)
    part = partition_from_dataset(ds, P, stratified=stratified,
                                  scaler=ds.scaler())
    for r in range(P):
        want = _leaf(part, r, torch.float32, "cpu")
        got, rows, shards_read, live = load_leaf(
            ds, r, P, stratified=stratified, prefetch_depth=2, scale=True,
            dtype=torch.float32)
        for f in SVBuffer._fields:
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and g.is_contiguous()
            assert g.numpy().tobytes() == w.numpy().tobytes(), (r, f)
        assert rows == int(part.count[r])
        # only the leaf's own shards are read (contiguous: 2 of 8)
        assert shards_read == (ds.n_shards if stratified else 2)
        assert live <= 3


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("topology", ["tree", "star"])
def test_pod_equals_inprocess_cascade_and_recovers_oracle(fits, oracle,
                                                          topology):
    _, Y, o = oracle
    res, ctrl = fits[topology]
    assert res.converged and ctrl.converged
    _same_bits(res, ctrl)
    assert set(res.sv_ids.tolist()) == set(get_sv_indices(o.alpha).tolist())
    np.testing.assert_allclose(res.b, o.b, atol=1e-4)
    assert res.topology == topology and res.n_leaves == P
    assert sum(res.worker_rows) == len(Y)
    assert res.revives == 0
    assert max(res.worker_max_live_shards) <= 3
    # the CPU runs the kernels' plain versions: nothing is launched
    assert all(not w for w in res.worker_launches)
    assert res.startup_s > 0


@pytest.mark.parametrize("topology", ["tree", "star"])
def test_pod_agrees_with_jax_cascade(fits, oracle, topology):
    Xs, Y, _ = oracle
    res, _ = fits[topology]
    jres = j_cascade_fit(Xs, Y, JCFG, JCascadeConfig(
        n_shards=P, sv_capacity=128, topology=topology))
    assert res.converged and jres.converged
    assert set(res.sv_ids.tolist()) == set(np.asarray(jres.sv_ids).tolist())
    assert abs(res.rounds - jres.rounds) <= 1
    np.testing.assert_allclose(res.b, jres.b, atol=1e-4)
    for h, jh in zip(res.history, jres.history):
        assert set(h) == set(jh)
        assert h["iters"].shape == np.asarray(jh["iters"]).shape


def test_shrinking_leaves_recover_oracle(data_dir, oracle):
    # the shrinking driver the in-process cascade refuses runs on pod
    # leaves, and the SV-ID fixed point still lands on the oracle's set
    _, _, o = oracle
    res = pod_fit(data_dir, CFG, _cc(), solver="blocked",
                  solver_opts={"q": 64, "shrink_every": 2}, **CPU)
    assert res.converged
    assert set(res.sv_ids.tolist()) == set(get_sv_indices(o.alpha).tolist())
    np.testing.assert_allclose(res.b, o.b, atol=1e-4)


@pytest.mark.parametrize("kw,err,match", [
    (dict(solver="pair", solver_opts={"shrink_every": 2}), ValueError,
     "shrinking driver"),
    (dict(solver="fleet"), ValueError, "unknown solver"),
    (dict(trace_dir="t"), ValueError, "trace_dir needs a tracer"),
    (dict(trace_dir="t", tracer=_AnonymousTracer()), ValueError,
     "constructed with role="),
    (dict(trace_dir="t", trace_max_bytes=1), ValueError,
     "trace_dir needs a tracer"),
])
def test_pod_fit_refusals(data_dir, kw, err, match):
    with pytest.raises(err, match=match):
        pod_fit(data_dir, CFG, _cc(), **CPU, **kw)


def test_fit_pod_refuses_approximate_families(data_dir):
    for kernel in ("rff", "nystrom"):
        with pytest.raises(ValueError, match="approximate families"):
            BinarySVC(SVMConfig(kernel=kernel), device="cpu").fit_pod(
                data_dir, _cc())


def test_checkpoint_topology_mismatch_refused(fits, data_dir):
    with pytest.raises(ValueError, match="topology"):
        pod_fit(data_dir, CFG, _cc("star"), checkpoint_path=fits["ckpt"],
                resume=True, **CPU)


# ------------------------------------------------------------------ chaos
def test_worker_sigkill_revived_bit_identical(fits, data_dir, tmp_path):
    # worker 1 REALLY SIGKILLs itself on its 2nd request (mid round 2);
    # the coordinator revives it, skips any stale reply and re-runs the
    # round from its own state
    plan = tmp_path / "plan.json"
    plan.write_text('{"format_version": 1, "seed": 0, "rules": [{"point": '
                    '"pod.worker", "kind": "kill", "at_hit": 2}]}')
    res = pod_fit(data_dir, CFG, _cc(), worker_faults={1: str(plan)}, **CPU)
    assert res.revives == 1
    _same_bits(res, fits["tree"][0])
    assert sum(res.worker_rows) == 192


def test_coordinator_kill_at_round_then_resume_bit_identical(fits, data_dir,
                                                             tmp_path):
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(faults.SimulatedKill):
        with faults.active(faults.FaultPlan([faults.FaultRule(
                point="pod.round", kind="kill", at_hit=2)])):
            pod_fit(data_dir, CFG, _cc(), checkpoint_path=ck, **CPU)
    assert os.path.exists(ck)
    assert load_pod_round_state(ck)[2] == 2  # round 1 is durable
    res = pod_fit(data_dir, CFG, _cc(), checkpoint_path=ck, resume=True,
                  **CPU)
    _same_bits(res, fits["tree"][0])


def test_pod_round_transients_are_retried(fits, data_dir):
    plan = faults.FaultPlan([faults.FaultRule(
        point="pod.round", kind="transient", max_hits=2)])
    with faults.active(plan):
        res = pod_fit(data_dir, CFG, _cc(), **CPU)
    assert plan.rules[0].fires == 2
    _same_bits(res, fits["tree"][0])


def test_stale_large_reply_is_read_before_the_next_request():
    # a worker that was sent a request of an aborted round blocks sending
    # its (large) RESULT until the coordinator reads it: the coordinator
    # must read it before it sends the re-run's request, or both block in
    # their sends
    pod = _Pod(1, {}, 2, torch.device("cpu"))
    coord, worker = socket.socketpair()
    coord.settimeout(30)  # a regression fails here instead of hanging
    pod.workers[0].sock = coord
    pod._req = 1
    pod.workers[0].pending.add(1)
    got = {}

    def stale_worker():
        protocol.send_msg(worker, {"op": "result", "req": 1},
                          {"sv_X": np.zeros((1024, 1024), np.float32)})
        got["meta"], got["arrays"] = protocol.recv_msg(worker)

    import threading

    t = threading.Thread(target=stale_worker, daemon=True)
    t.start()
    big = SVBuffer(X=torch.zeros((1024, 1024)), Y=torch.zeros(1024,
                   dtype=torch.int32), alpha=torch.zeros(1024),
                   ids=torch.zeros(1024, dtype=torch.int32),
                   valid=torch.zeros(1024, dtype=torch.bool))
    try:
        assert pod.send_train(0, big) == 2
        t.join(timeout=30)
        assert got["meta"] == {"op": "train", "req": 2,
                               "use_partition": True}
        assert got["arrays"]["recv_X"].shape == (1024, 1024)
        assert pod.workers[0].pending == {2}
    finally:
        coord.close()
        worker.close()
        pod.workers[0].sock = None
        pod.shutdown()


# ------------------------------------------------------- front doors
def test_fit_pod_and_train_mode_pod(data_dir):
    model = BinarySVC(CFG, solver_opts={"q": 64}, device="cpu")
    model.fit_pod(data_dir, _cc("star"))
    ctrl = BinarySVC(CFG, solver_opts={"q": 64}, device="cpu")
    ctrl.fit_cascade_stream(open_dataset(data_dir), _cc("star"))
    assert np.array_equal(model.sv_ids_, ctrl.sv_ids_)
    assert model.sv_alpha_.tobytes() == ctrl.sv_alpha_.tobytes()
    assert model.b_ == ctrl.b_
    assert model.cascade_rounds_ == ctrl.cascade_rounds_
    assert model.pod_worker_rows_ == (48, 48, 48, 48)
    assert model.stream_max_live_shards_ <= 3
    assert model.scaler_.min_val.tobytes() == ctrl.scaler_.min_val.tobytes()
    assert model.train_precision_ == "f32" and model.shrink_every_ == 0

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["train", "--data", data_dir, "--mode", "pod",
                       "--topology", "star", "--sv-capacity", "128",
                       "--C", "10", "--gamma", "10", "--max-rounds", "12",
                       "--q", "64", "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0
    assert f"SV count = {model.n_support_}" in text
    assert f"b = {model.b_:.15f}" in text
    assert f"pod: 4 workers, {model.cascade_rounds_} rounds, converged = " \
           "True" in text


@pytest.mark.parametrize("argv,match", [
    (["--mode", "pod"], "pass --data DIR"),
    (["--mode", "single", "--data", "D", "--stratify"],
     "--mode cascade/pod"),
    (["--mode", "pod", "--data", "D", "--kernel", "rff"],
     "--mode pod --data with an approximate kernel"),
])
def test_train_mode_pod_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_main(["train", *argv, "--device", "cpu"])


def test_pod_smoke_command_on_the_cpu(capsys):
    assert cli_main(["pod", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pod ok: tree 3 rounds/13 SVs; star" in out
    assert "bit-identical to in-memory cascade" in out


def test_worker_snapshot_reports_its_registry(data_dir):
    # the SNAPSHOT op: a live worker answers with its metrics registry
    meta = dict(data=os.path.abspath(data_dir), n_leaves=4,
                stratified=False, prefetch_depth=2, scale=True,
                device="cpu", threads=1, dtype="float32",
                accum_dtype="float64", svm_config={}, solver="pair",
                solver_opts={}, train_cap=176, sv_cap=128)
    pod = _Pod(1, meta, 2, torch.device("cpu"))
    try:
        pod.start()
        (snap,) = pod.snapshots()
        assert snap["worker_id"] == 0 and snap["pid"] != os.getpid()
        values = {m["name"]: m.get("value")
                  for m in snap["snapshot"]["metrics"]}
        assert values["pod.worker_rows"] == 48.0
    finally:
        pod.shutdown()


# ------------------------------------------------------------- no card
def test_pod_entry_points_raise_without_a_card(data_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not "
                    "reachable")
    for call in (lambda: pod_fit(data_dir, CFG, _cc()),
                 lambda: BinarySVC(CFG).fit_pod(data_dir, _cc()),
                 lambda: cli_main(["train", "--data", data_dir, "--mode",
                                   "pod"]),
                 lambda: cli_main(["pod", "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_worker_told_to_use_a_missing_card_raises(data_dir):
    # a worker never falls back to the CPU: told "cuda" without a card it
    # dies before READY, and the coordinator raises
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not "
                    "reachable")
    meta = dict(data=os.path.abspath(data_dir), n_leaves=1,
                stratified=False, prefetch_depth=2, scale=True,
                device="cuda", threads=1, dtype="float32",
                accum_dtype="float64", svm_config={}, solver="pair",
                solver_opts={}, train_cap=320, sv_cap=128)
    pod = _Pod(1, meta, 2, torch.device("cpu"))
    try:
        with pytest.raises(RuntimeError, match="died before READY"):
            pod.start()
    finally:
        pod.shutdown()
