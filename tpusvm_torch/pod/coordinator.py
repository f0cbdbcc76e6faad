"""Pod cascade coordinator: drive N leaf workers to the SV fixed point.

The port of tpusvm/pod/coordinator.py. ``pod_fit`` is
``parallel.cascade.cascade_fit`` with the leaves moved into processes:
the coordinator owns ALL round state (the global SV buffer, each rank's
working SV set) and ships buffers explicitly over the framed-message
protocol, while workers are stateless per request — each TRAIN is one
cascade step body (merge_dedup -> solve -> extract_svs) against either
the worker's resident leaf partition (step/layer 1) or an explicitly
shipped buffer (deeper tree steps). The star topology's layer-2 union
runs IN the coordinator through ``parallel.cascade.star_merge`` followed
by a local merged solve, on the coordinator's device, mirroring the
reference's rank-0 retrain (mpi_svm_main2.cpp:540-621).

Identical merges, identical solves, identical diagnostics layout,
identical convergence/overflow/checkpoint logic as cascade_fit's
one-process rounds, so the two give the same bits on the same rows.

On a CUDA device the coordinator builds (or loads) the kernels before it
spawns a worker, so the workers only load the built libraries (the build
lock is per process). Every worker runs on the coordinator's device with
its intra-op thread count.

Failure semantics:
  * worker death (real SIGKILL or injected ``pod.worker`` kill) is
    detected as a socket error, the worker is respawned (WITHOUT its
    chaos plan — revival must not re-kill), re-derives its leaf
    bit-identically, and the in-flight round re-runs from its
    round-start state — value-identical because round inputs are
    untouched until a round commits;
  * coordinator death between rounds (``pod.round``) resumes from the
    fsync_replace'd checkpoint (pod/state.py, ``pod.merge``) written
    after every round;
  * stale replies from an aborted round are discarded by request
    sequence numbers.

Tracing is observation only: with a tracer the fit is one pod.fit span
with a pod.round span a round (pod.round and convergence.round events
beside them), and with a trace directory every worker writes its own file
under the coordinator's propagated context (pod/protocol.py attach_ctx),
so `report DIR` renders the whole fit as one timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import time
import warnings
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from tpusvm_torch import faults
from tpusvm_torch.config import CascadeConfig, SVMConfig, resolve_accum_dtype
from tpusvm_torch.device import resolve_device
from tpusvm_torch.pod.protocol import attach_ctx, recv_msg, send_msg
from tpusvm_torch.pod.state import (
    check_pod_round_state_config,
    load_pod_round_state,
    save_pod_round_state,
)
from tpusvm_torch.status import Status

# seconds a spawned worker has to connect back
_CONNECT_TIMEOUT_S = 120.0


class PodResult(NamedTuple):
    """Final global model + run/fleet telemetry.

    The model fields match CascadeResult; the pod extras are the
    provenance (topology, n_leaves), the per-worker residency high-water
    marks the bounded-RSS audit asserts on and the revive count chaos
    runs check, as in the JAX package. The port adds the kernel launches
    each worker reported (summed over its processes, revivals included,
    counting the requests whose results were used) and the seconds from
    the first spawn to the last READY (worker start, leaf load)."""

    sv_X: np.ndarray
    sv_Y: np.ndarray
    sv_alpha: np.ndarray
    sv_ids: np.ndarray
    b: float
    rounds: int
    converged: bool
    history: List[Dict[str, Any]]
    topology: str
    n_leaves: int
    worker_rows: tuple
    worker_max_live_shards: tuple
    revives: int
    worker_launches: tuple = ()
    startup_s: float = 0.0


class _WorkerDied(RuntimeError):
    def __init__(self, worker_id: int, why: str):
        super().__init__(f"pod worker {worker_id} died: {why}")
        self.worker_id = worker_id


class _Worker:
    """One leaf worker's process + connection + residency telemetry."""

    def __init__(self, worker_id: int):
        self.worker_id = worker_id
        self.proc: Optional[subprocess.Popen] = None
        self.sock: Optional[socket.socket] = None
        self.rows = 0
        self.max_live_shards = 0
        self.launches: Dict[str, int] = {}
        # TRAIN requests sent whose RESULT has not been read yet
        self.pending: set = set()

    def close(self) -> None:
        self.pending.clear()
        if self.sock is not None:
            with contextlib.suppress(OSError):
                self.sock.close()
            self.sock = None
        if self.proc is not None:
            with contextlib.suppress(OSError):
                self.proc.terminate()
            with contextlib.suppress(Exception):
                self.proc.wait(timeout=10)
            if self.proc.poll() is None:
                with contextlib.suppress(OSError):
                    self.proc.kill()
                with contextlib.suppress(Exception):
                    self.proc.wait(timeout=10)
            self.proc = None


class _Pod:
    """The worker fleet: spawn/handshake/revive + framed request plumbing."""

    def __init__(self, n_leaves: int, init_meta: dict, prefetch_depth: int,
                 device, worker_faults: Optional[Dict[int, str]] = None,
                 tracer=None):
        self.tracer = tracer
        self.n_leaves = n_leaves
        self.init_meta = init_meta
        self.prefetch_depth = prefetch_depth
        self.device = device
        self.worker_faults = dict(worker_faults or {})
        self.workers = [_Worker(r) for r in range(n_leaves)]
        self.revives = 0
        self.startup_s = 0.0
        self._req = 0
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(n_leaves)
        self.listener.settimeout(1.0)
        self.port = self.listener.getsockname()[1]

    # ------------------------------------------------------------ spawn
    def _spawn_proc(self, r: int, with_faults: bool) -> subprocess.Popen:
        import tpusvm_torch

        argv = [
            sys.executable, "-m", "tpusvm_torch.pod.worker",
            "--host", "127.0.0.1", "--port", str(self.port),
            "--worker-id", str(r),
        ]
        if with_faults and r in self.worker_faults:
            argv += ["--faults", self.worker_faults[r]]
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(tpusvm_torch.__file__))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.Popen(argv, env=env)

    def _exited(self, r: int) -> Optional[int]:
        proc = self.workers[r].proc
        return None if proc is None else proc.poll()

    def _handshake(self, pending: List[int], with_faults: bool) -> None:
        """Spawn `pending` workers, accept their HELLOs, INIT, READY."""
        for r in pending:
            self.workers[r].proc = self._spawn_proc(r, with_faults)
        waiting = set(pending)
        deadline = time.monotonic() + _CONNECT_TIMEOUT_S
        while waiting:
            for r in waiting:
                rc = self._exited(r)
                if rc is not None:
                    raise RuntimeError(
                        f"pod worker {r} exited with code {rc} before it "
                        "connected (its error is on stderr)")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"pod workers {sorted(waiting)} did not connect within "
                    f"{_CONNECT_TIMEOUT_S:.0f} s")
            try:
                conn, _ = self.listener.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            meta, _ = recv_msg(conn)
            wid = int(meta["worker_id"])
            if meta["op"] != "hello" or wid not in waiting:
                conn.close()
                continue
            self.workers[wid].sock = conn
            waiting.discard(wid)
        for r in pending:
            send_msg(self.workers[r].sock,
                     dict(self.init_meta, op="init", leaf=r))
        for r in pending:
            try:
                meta, _ = recv_msg(self.workers[r].sock)
            except (OSError, ConnectionError) as e:
                proc = self.workers[r].proc
                rc = None if proc is None else proc.wait(timeout=30)
                raise RuntimeError(
                    f"pod worker {r} died before READY (exit code {rc}; "
                    f"its error is on stderr): {e!r}") from e
            if meta["op"] != "ready":
                raise RuntimeError(
                    f"pod worker {r}: expected ready, got {meta['op']!r}"
                )
            w = self.workers[r]
            w.rows = int(meta["rows"])
            hwm = int(meta["max_live_shards"])
            w.max_live_shards = max(w.max_live_shards, hwm)
            # the bounded-RSS contract, asserted on every (re)spawn: a
            # leaf never holds more than the prefetch pipeline's permits
            if hwm > self.prefetch_depth + 1:
                raise RuntimeError(
                    f"pod worker {r} residency audit failed: "
                    f"max_live_shards={hwm} > prefetch_depth+1="
                    f"{self.prefetch_depth + 1}"
                )

    def start(self) -> None:
        t0 = time.perf_counter()
        self._handshake(list(range(self.n_leaves)), with_faults=True)
        self.startup_s = time.perf_counter() - t0

    def revive_dead(self) -> List[int]:
        """Respawn every dead worker (no chaos plan) and re-handshake."""
        dead = []
        for w in self.workers:
            alive = (w.proc is not None and w.proc.poll() is None
                     and w.sock is not None)
            if not alive:
                w.close()
                dead.append(w.worker_id)
        if dead:
            self.revives += len(dead)
            self._handshake(dead, with_faults=False)
        return dead

    # --------------------------------------------------------- requests
    def _recv_result(self, r: int):
        """The next frame from rank r (its request struck off the pending
        set when it is a RESULT); a socket error is the worker's death."""
        w = self.workers[r]
        try:
            meta, arrays = recv_msg(w.sock)
        except (OSError, ConnectionError) as e:
            raise _WorkerDied(r, repr(e)) from e
        if meta.get("op") == "result":
            w.pending.discard(meta.get("req"))
        return meta, arrays

    def send_train(self, r: int, recv_buf, own_buf=None) -> int:
        """Ship one TRAIN request; returns its sequence number.

        The replies of an aborted round that rank r still owes are read
        and dropped first: a worker blocked sending a large stale RESULT
        reads nothing, so a request sent to it now would block the
        coordinator in its send as well."""
        from tpusvm_torch.pod.worker import _buf_to_arrays

        while self.workers[r].pending:
            self._recv_result(r)
        self._req += 1
        req = self._req
        arrays = _buf_to_arrays(recv_buf, "recv_")
        if own_buf is not None:
            arrays.update(_buf_to_arrays(own_buf, "own_"))
        meta = {
            "op": "train",
            "req": req,
            "use_partition": own_buf is None,
        }
        if self.tracer is not None and self.tracer.role is not None:
            # per-request context: the worker's train span re-parents
            # under the coordinator's CURRENT open span (pod.round)
            meta = attach_ctx(meta, self.tracer.ctx())
        try:
            send_msg(self.workers[r].sock, meta, arrays)
        except (OSError, ConnectionError) as e:
            raise _WorkerDied(r, repr(e)) from e
        self.workers[r].pending.add(req)
        return req

    def collect(self, r: int, req: int):
        """Receive rank r's RESULT for request `req`, skipping stale
        replies left over from an aborted (revived) round."""
        from tpusvm_torch.pod.worker import _buf_from_arrays

        w = self.workers[r]
        while True:
            meta, arrays = self._recv_result(r)
            if meta.get("op") != "result" or meta.get("req") != req:
                continue
            for k, v in meta.get("launches", {}).items():
                w.launches[k] = w.launches.get(k, 0) + int(v)
            return meta, _buf_from_arrays(arrays, "sv_", self.device)

    def snapshots(self, timeout_s: float = 10.0) -> List[dict]:
        """Fetch every live worker's registry snapshot over the socket
        (the SNAPSHOT op). Dead/unresponsive workers are skipped — this
        is telemetry, not training; it must never fail a fit."""
        out: List[dict] = []
        for w in self.workers:
            if w.sock is None:
                continue
            self._req += 1
            req = self._req
            try:
                w.sock.settimeout(timeout_s)
                send_msg(w.sock, {"op": "snapshot", "req": req})
                while True:
                    meta, _ = recv_msg(w.sock)
                    if meta.get("op") == "snapshot_reply" \
                            and meta.get("req") == req:
                        out.append({"worker_id": w.worker_id,
                                    "pid": meta.get("pid"),
                                    "snapshot": meta["snapshot"]})
                        break
            except (OSError, ConnectionError, KeyError, ValueError):
                continue
            finally:
                with contextlib.suppress(OSError):
                    w.sock.settimeout(None)
        return out

    def shutdown(self) -> None:
        for w in self.workers:
            if w.sock is not None:
                with contextlib.suppress(OSError, ConnectionError):
                    send_msg(w.sock, {"op": "shutdown"})
            w.close()
        with contextlib.suppress(OSError):
            self.listener.close()


# ------------------------------------------------------------- rounds
def _tree_round(pod: _Pod, global_sv, *, n_leaves: int):
    """One classical-cascade round over the worker fleet.

    The one-process round's rank loop (parallel.cascade._tree_round_host)
    with each rank's step body executed by its worker; within a step all
    active ranks' requests are shipped before any reply is read, so
    distinct workers solve concurrently."""
    n_steps = n_leaves.bit_length()
    own: dict = {}
    recv = {r: global_sv for r in range(n_leaves)}
    mc = np.zeros((n_leaves, n_steps), np.int64)
    sc = np.zeros((n_leaves, n_steps), np.int64)
    it = np.zeros((n_leaves, n_steps), np.int64)
    st = np.full((n_leaves, n_steps), -1, np.int64)
    b = None
    step, si = 1, 0
    while step <= n_leaves:
        active = list(range(0, n_leaves, step))
        reqs = {
            r: pod.send_train(
                r, recv[r], own_buf=None if step == 1 else own[r])
            for r in active
        }
        for r in active:
            meta, sv = pod.collect(r, reqs[r])
            own[r] = sv
            mc[r, si] = meta["merged_count"]
            sc[r, si] = meta["sv_count"]
            it[r, si] = meta["n_iter"]
            st[r, si] = meta["status"]
            if r == 0:
                b = meta["b"]
        if step < n_leaves:
            for r in range(step, n_leaves, 2 * step):
                recv[r - step] = own[r]
        step *= 2
        si += 1
    diag = {"merged_count": mc, "sv_count": sc, "iters": it, "status": st}
    return own[0], b, diag


def _star_round(pod: _Pod, global_sv, *, n_leaves: int, merged_cap: int,
                full_merged_cap: int, sv_cap: int, cfg, accum_dtype,
                solver, solver_opts, device):
    """One modified-cascade round: worker layer 1, coordinator layer 2.

    Layer 2 reuses parallel.cascade.star_merge and a local solve on the
    coordinator's device — the reference's rank-0 retrain runs where the
    round state lives. A union overflowing a tight merged_cap is
    re-merged at the full concatenation bound BEFORE the solve (the
    in-process cascade reaches the same state by re-running the round);
    the widened cap is returned and kept for the remaining rounds.

    Returns (new_global, b, diag, merged_cap)."""
    from tpusvm_torch.parallel.cascade import star_merge
    from tpusvm_torch.parallel.svbuffer import extract_svs
    from tpusvm_torch.pod.worker import leaf_solve

    reqs = {r: pod.send_train(r, global_sv) for r in range(n_leaves)}
    svs, layer1 = [], []
    for r in range(n_leaves):
        meta, sv = pod.collect(r, reqs[r])
        svs.append(sv)
        layer1.append((meta["merged_count"], meta["sv_count"],
                       meta["n_iter"], meta["status"]))
    merged, merged_count = star_merge(svs, merged_cap)
    if merged_cap < full_merged_cap and int(merged_count) > merged_cap:
        warnings.warn(
            f"pod star round: worker-SV union of {int(merged_count)} "
            f"rows overflowed the star merge buffer ({merged_cap}); "
            f"retrying the merge at the full concatenation capacity "
            f"{full_merged_cap} (set star_merge_capacity to avoid the "
            "recompile)",
            RuntimeWarning,
            stacklevel=2,
        )
        merged_cap = full_merged_cap
        merged, merged_count = star_merge(svs, merged_cap)
    res2 = leaf_solve(merged, cfg, accum_dtype, solver, solver_opts, device)
    new_global, gcount = extract_svs(merged, res2.alpha, cfg.sv_tol,
                                     sv_cap)
    diag = {
        "merged_count": np.array(
            [[m, int(merged_count)] for m, _, _, _ in layer1], np.int64),
        "sv_count": np.array(
            [[s, int(gcount)] for _, s, _, _ in layer1], np.int64),
        "iters": np.array(
            [[i, int(res2.n_iter)] for _, _, i, _ in layer1], np.int64),
        "status": np.array(
            [[s, int(res2.status)] for _, _, _, s in layer1], np.int64),
    }
    return new_global, float(res2.b), diag, merged_cap


# -------------------------------------------------------------- pod_fit
def pod_fit(
    data: str,
    svm_config: SVMConfig = SVMConfig(),
    cascade_config: CascadeConfig = CascadeConfig(),
    dtype=None,
    accum_dtype="auto",
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    solver: str = "pair",
    solver_opts: Optional[dict] = None,
    stratified: bool = False,
    prefetch_depth: int = 2,
    scale: bool = True,
    worker_faults: Optional[Dict[int, str]] = None,
    max_revives: int = 8,
    tracer=None,
    trace_dir: Optional[str] = None,
    trace_max_bytes: Optional[int] = None,
    device="cuda",
) -> PodResult:
    """Train a binary SVM with the pod (multi-process) cascade.

    data: a sharded dataset directory (stream.ingest_arrays / `ingest`);
    each of the cascade_config.n_shards leaves becomes one worker process
    that streams only ITS manifest shards. scale=True (default) applies
    the manifest-fitted global MinMaxScaler in every worker — the
    reference's scale-before-scatter, matching fit_cascade_stream.
    dtype: the features' torch dtype (default float32); accum_dtype:
    "auto" = f64 accumulators, None = the features' dtype.

    solver/solver_opts: the leaf solver ("pair" or "blocked") and its
    knobs. Unlike cascade_fit, the host-side shrinking driver knobs
    (shrink_every, shrink_min, ...) are ACCEPTED with solver="blocked" —
    leaves are host processes, so solver.shrink's segmenting loop runs
    there.

    checkpoint_path/resume: per-round coordinator checkpoint through
    pod/state.py (fsync_replace; fault point ``pod.merge``); resume
    refuses a checkpoint from a different n_shards/topology.

    worker_faults: {worker_id: fault-plan path} applied to those
    workers' INITIAL spawn only (chaos runs); a revived worker never
    carries a plan, so an at_hit kill cannot loop forever.

    max_revives: total worker revivals tolerated before the fit gives
    up (a worker that dies deterministically on every respawn would
    otherwise re-run the round forever).

    device: where the coordinator's layer-2 solves and every worker run
    ("cuda" unless asked otherwise; no CPU fallback).

    tracer: a Tracer the fit writes its pod.fit and pod.round spans and
    its pod.round and convergence.round events to, and at the end every
    live worker's registry snapshot merged with the coordinator's.

    trace_dir: cross-process tracing; needs a `tracer` constructed with a
    role (its minted context propagates). Every worker opens its own
    Tracer in this directory (one file per worker PID: a revived worker
    starts a fresh file) with the coordinator's TraceContext from the
    INIT frame, and each TRAIN frame carries the current pod.round span's
    context, so `report <trace_dir>` stitches the whole fit into one
    timeline. trace_max_bytes bounds each worker's file (rotation). The
    traced fit is bit-identical to an untraced one.
    """
    from tpusvm_torch.parallel.svbuffer import empty
    from tpusvm_torch.pod.worker import SHRINK_DRIVER_KEYS
    from tpusvm_torch.stream.assign import assign_rows
    from tpusvm_torch.stream.format import open_dataset

    if solver not in ("pair", "blocked"):
        raise ValueError(f"unknown solver {solver!r}")
    driver_keys = sorted(SHRINK_DRIVER_KEYS & set(solver_opts or ()))
    if driver_keys and solver != "blocked":
        raise ValueError(
            f"solver_opts {driver_keys} belong to the shrinking driver, "
            "which wraps the blocked solver; pass solver='blocked' to "
            "use shrinking pod leaves"
        )
    dev = resolve_device(device)
    accum = resolve_accum_dtype(accum_dtype)
    dtype = torch.float32 if dtype is None else dtype
    cc = cascade_config
    n_leaves = cc.n_shards
    sv_cap = cc.sv_capacity

    dataset = open_dataset(data)
    n, d = dataset.n_rows, dataset.n_features
    Y_all = dataset.load_labels() if stratified else None
    asg = assign_rows(n, n_leaves, Y=Y_all, stratified=stratified)
    chunk = asg.cap
    train_cap = chunk + sv_cap
    merged_cap = cc.resolved_star_merge_capacity()
    full_merged_cap = n_leaves * sv_cap

    global_sv = empty(sv_cap, d, dtype, dev)
    prev_ids: set = set()
    history: List[Dict[str, Any]] = []
    converged = False
    rounds = 0
    b = 0.0
    start_round = 1

    if resume and checkpoint_path is not None \
            and os.path.exists(checkpoint_path):
        check_pod_round_state_config(checkpoint_path, n_leaves,
                                     cc.topology)
        global_sv, prev_ids, start_round, b = load_pod_round_state(
            checkpoint_path, dtype, dev
        )
        if global_sv.capacity != sv_cap or global_sv.X.shape[1] != d:
            raise ValueError(
                "pod checkpoint shapes do not match this run: capacity "
                f"{global_sv.capacity} vs {sv_cap}, d "
                f"{global_sv.X.shape[1]} vs {d}"
            )
        if verbose:
            print(f"resuming pod cascade from round {start_round} "
                  f"({len(prev_ids)} SVs in checkpoint)")
        rounds = start_round - 1
        if start_round > svm_config.max_rounds:
            warnings.warn(
                f"pod checkpoint is already at round {rounds} >= "
                f"max_rounds={svm_config.max_rounds}; returning the "
                "checkpointed model without training (raise max_rounds "
                "to continue)",
                RuntimeWarning,
                stacklevel=2,
            )

    if dev.type == "cuda":
        # every worker loads these libraries; build them once, here, before
        # any worker starts (the build lock is per process)
        from tpusvm_torch.ops.cuda import _build

        _build.build_all()

    init_meta = {
        "data": os.path.abspath(data),
        "n_leaves": n_leaves,
        "stratified": bool(stratified),
        "prefetch_depth": int(prefetch_depth),
        "scale": bool(scale),
        "device": str(dev),
        "threads": torch.get_num_threads(),
        "dtype": str(dtype).removeprefix("torch."),
        "accum_dtype": (None if accum is None
                        else str(accum).removeprefix("torch.")),
        "svm_config": dataclasses.asdict(svm_config),
        "solver": solver,
        "solver_opts": dict(solver_opts or {}),
        "train_cap": int(train_cap),
        "sv_cap": int(sv_cap),
    }
    fit_span = None
    if trace_dir is not None:
        if tracer is None or tracer.role is None:
            raise ValueError(
                "trace_dir needs a tracer constructed with role= (the "
                "workers parent their spans under its minted context)")
        os.makedirs(trace_dir, exist_ok=True)
    if tracer is not None:
        # opened by hand (closed in the outer finally) so the whole fit
        # (spawn, rounds, revivals, shutdown) is one span the workers'
        # propagated contexts parent under
        fit_span = tracer.span("pod.fit", phase=True,
                               topology=cc.topology, n_leaves=n_leaves)
        fit_span.__enter__()
    if trace_dir is not None:
        init_meta["trace"] = {
            "dir": os.path.abspath(trace_dir),
            "max_bytes": trace_max_bytes,
            "ctx": tracer.ctx().to_dict(),
        }
    pod = _Pod(n_leaves, init_meta, prefetch_depth, dev,
               worker_faults=worker_faults, tracer=tracer)

    new_global = global_sv
    round_retry = faults.Retry(faults.DEFAULT_IO_POLICY, op="pod.round")
    try:
        pod.start()
        if sum(w.rows for w in pod.workers) != n:
            raise RuntimeError(
                f"pod leaves loaded {sum(w.rows for w in pod.workers)} "
                f"rows, manifest says {n} (assignment bug?)"
            )
        for rnd in range(start_round, svm_config.max_rounds + 1):
            # chaos hook mirroring cascade.round: a kill here dies
            # between rounds; resume must reproduce the uninterrupted
            # trajectory from the checkpoint
            round_retry(faults.point, "pod.round", round=rnd)
            t0 = time.perf_counter()
            round_span = (tracer.span("pod.round", round=rnd)
                          if tracer else contextlib.nullcontext())
            with round_span:
                while True:
                    try:
                        if cc.topology == "tree":
                            out_global, b_r, diag = _tree_round(
                                pod, global_sv, n_leaves=n_leaves)
                        else:
                            out_global, b_r, diag, merged_cap = _star_round(
                                pod, global_sv, n_leaves=n_leaves,
                                merged_cap=merged_cap,
                                full_merged_cap=full_merged_cap,
                                sv_cap=sv_cap, cfg=svm_config,
                                accum_dtype=accum, solver=solver,
                                solver_opts=solver_opts, device=dev)
                        break
                    except _WorkerDied as e:
                        if pod.revives >= max_revives:
                            raise RuntimeError(
                                f"pod gave up after {pod.revives} worker "
                                f"revivals (last: {e})"
                            ) from e
                        revived = pod.revive_dead()
                        if verbose:
                            print(f"round {rnd}: revived workers "
                                  f"{revived}, re-running the round")
                        # round inputs (global_sv) are untouched until the
                        # round commits, so the re-run is bit-identical to an
                        # undisturbed round
                        continue
                new_global = out_global
                b = float(b_r)
            dt = time.perf_counter() - t0
            rounds = rnd

            if cc.topology == "tree":
                if diag["merged_count"].max() > train_cap:
                    raise RuntimeError(
                        f"pod train buffer overflow: "
                        f"{diag['merged_count'].max()} > capacity "
                        f"{train_cap}; increase sv_capacity"
                    )
            else:
                if diag["merged_count"][:, 0].max() > train_cap:
                    raise RuntimeError(
                        f"pod train buffer overflow: "
                        f"{diag['merged_count'][:, 0].max()} > capacity "
                        f"{train_cap}"
                    )
            if diag["sv_count"].max() > sv_cap:
                raise RuntimeError(
                    f"SV buffer overflow: {diag['sv_count'].max()} SVs > "
                    f"capacity {sv_cap}; increase sv_capacity"
                )

            ids_arr = new_global.ids[new_global.valid].cpu().numpy()
            ids_now = set(ids_arr.tolist())
            history.append({
                "round": rnd,
                "sv_count": len(ids_now),
                "sv_ids": np.sort(ids_arr),
                "b": b,
                "time_s": dt,
                "iters": diag["iters"],
                "status": diag["status"],
            })
            if tracer is not None:
                tracer.event(
                    "pod.round",
                    round=rnd,
                    sv_count=len(ids_now),
                    b=b,
                    time_s=dt,
                    topology=cc.topology,
                    merged_count=diag["merged_count"].tolist(),
                    leaf_sv_count=diag["sv_count"].tolist(),
                    iters=diag["iters"].tolist(),
                    status=diag["status"].tolist(),
                )
                # the report's shared convergence surface (the record
                # cascade_fit writes too): the worst status over the leaves
                # that solved this round (-1 marks a leaf without one)
                sts = [int(s) for s in np.asarray(diag["status"]).ravel()
                       if int(s) >= 0]
                tracer.event(
                    "convergence.round",
                    round=rnd,
                    updates=int(np.asarray(diag["iters"]).sum()),
                    active=len(ids_now),
                    status=Status(max(sts)).name if sts else "n/a",
                )
            bad = diag["status"][
                diag["status"] >= int(Status.INFEASIBLE_UV)]
            if bad.size:
                warnings.warn(
                    f"pod round {rnd}: solver bail-outs on some leaves "
                    f"(statuses "
                    f"{sorted(set(Status(int(s)).name for s in bad))}); "
                    "the merged model may be partially optimised",
                    RuntimeWarning,
                    stacklevel=2,
                )
            if verbose:
                print(
                    f"=== Round {rnd} === SV count = {len(ids_now)}, "
                    f"b = {b:.15f}, {dt:.3f}s"
                )

            if not ids_now:
                raise RuntimeError(
                    "pod cascade produced an empty global support-vector "
                    "set — all per-leaf solves found no working set (is "
                    "the data sorted by label, making leaves "
                    "single-class?); statuses: "
                    f"{diag['status'].tolist()}"
                )

            if ids_now == prev_ids:
                converged = True
            prev_ids = ids_now

            if checkpoint_path is not None:
                save_pod_round_state(checkpoint_path, new_global,
                                     prev_ids, rnd, b, n_leaves,
                                     cc.topology)

            if converged:
                break
            global_sv = new_global
    finally:
        if tracer is not None:
            # fleet telemetry, best effort: every live worker's registry
            # snapshot (label-tagged, merged with the coordinator's own)
            # lands in the trace before the fleet is torn down
            with contextlib.suppress(Exception):
                from tpusvm_torch.obs.fleet import (merge_fleet,
                                                    snapshot_payload)
                from tpusvm_torch.obs.registry import default_registry

                parts = [snapshot_payload(
                    "pod-worker", f"w{s['worker_id']}", s["snapshot"],
                    pid=s.get("pid")) for s in pod.snapshots()]
                parts.append(snapshot_payload(
                    "pod-coordinator", "coordinator",
                    default_registry().snapshot()))
                tracer.metrics_snapshot(merge_fleet(parts))
        pod.shutdown()
        if fit_span is not None:
            fit_span.__exit__(None, None, None)

    mask = new_global.valid.cpu().numpy()
    return PodResult(
        sv_X=new_global.X.cpu().numpy()[mask],
        sv_Y=new_global.Y.cpu().numpy()[mask],
        sv_alpha=new_global.alpha.cpu().numpy()[mask],
        sv_ids=new_global.ids.cpu().numpy()[mask],
        b=b,
        rounds=rounds,
        converged=converged,
        history=history,
        topology=cc.topology,
        n_leaves=n_leaves,
        worker_rows=tuple(w.rows for w in pod.workers),
        worker_max_live_shards=tuple(
            w.max_live_shards for w in pod.workers),
        revives=pod.revives,
        worker_launches=tuple(dict(w.launches) for w in pod.workers),
        startup_s=pod.startup_s,
    )
