"""The binary SVM estimator: scale, solve, extract SVs, score, persist.

  fit:      min-max scale on TRAIN data -> blocked or pair SMO -> extract SVs
  predict:  scale with TRAIN min/max -> sign(sum_sv a_k y_k K(x, x_k) - b)
  calibrate: Platt sigmoid on out-of-fold scores -> predict_proba

Attributes after fit carry the JAX estimator's names (sv_X_, sv_Y_,
sv_alpha_, sv_ids_, b_, n_iter_, status_, scaler_), as numpy arrays, so a
model moves between the packages through the shared `.npz` artifact.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from tpusvm_torch.config import (CascadeConfig, SVMConfig, is_approx_family,
                                 resolve_accum_dtype, resolve_dtype)
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device, to_dtype, to_numpy
from tpusvm_torch.kernels.platt import fit_platt, platt_proba
from tpusvm_torch.models.serialization import load_model, save_model
from tpusvm_torch.obs.convergence import materialize
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.solver.checkpoint import checkpointed_blocked_solve
from tpusvm_torch.solver.predict import decision_function as _decision
from tpusvm_torch.solver.shrink import shrinking_blocked_solve
from tpusvm_torch.solver.smo import smo_solve
from tpusvm_torch.status import Status
from tpusvm_torch.tune.folds import stratified_kfold

SOLVERS = ("blocked", "pair")


def check_solver(solver: str) -> None:
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; the port runs "
                         f"{list(SOLVERS)}")


def solve(solver: str, X, Y, cfg: SVMConfig, accum_dtype, opts: dict,
          device, *, checkpoint: Optional[dict] = None, **kw):
    """One solve of `solver` with the config's hyperparameters; kw adds
    targets, sn or warm-start arguments. As the JAX estimators route it:
    solver_opts' shrink_every (with shrink_min, shrink_gap_factor,
    max_unshrinks; shrink_stable defaults to 3) runs
    shrinking_blocked_solve, and `checkpoint` (checkpoint_path,
    checkpoint_every, resume) checkpointed_blocked_solve, both on the
    blocked solver only and not together."""
    opts = dict(opts)
    shrink_every = opts.pop("shrink_every", 0)
    shrink_kw = {k: opts.pop(k) for k in
                 ("shrink_min", "shrink_gap_factor", "max_unshrinks")
                 if k in opts}
    kw = dict(C=cfg.C, gamma=cfg.gamma, eps=cfg.eps, tau=cfg.tau,
              max_iter=cfg.max_iter, kernel=cfg.kernel, degree=cfg.degree,
              coef0=cfg.coef0, accum_dtype=resolve_accum_dtype(accum_dtype),
              device=device, **kw, **opts)
    if shrink_every and solver != "blocked":
        raise ValueError(
            "shrink_every drives the blocked solver's outer loop in "
            "compacted segments (solver/shrink.py); the pair solver has no "
            "working-set rounds to shrink")
    if checkpoint is not None:
        if solver != "blocked":
            raise ValueError(
                "checkpoint_path requires the blocked solver (the outer-loop "
                "carry is what gets persisted); the pair solver has no "
                "checkpointable round structure")
        if shrink_every:
            raise ValueError(
                "checkpoint_path and shrink_every both segment the outer "
                "loop and cannot be combined yet (the checkpoint carry would "
                "span changing compaction buckets)")
        return checkpointed_blocked_solve(X, Y, **checkpoint, **kw)
    if shrink_every:
        kw.setdefault("shrink_stable", 3)
        return shrinking_blocked_solve(
            X, Y, shrink_every=shrink_every,
            shrink_stable=kw.pop("shrink_stable"), **shrink_kw, **kw)
    fn = blocked_smo_solve if solver == "blocked" else smo_solve
    return fn(X, Y, **kw)


def shrink_provenance(opts: dict):
    """(shrink_every, shrink_stable) a fit with these solver_opts ran
    under, as the JAX estimators record them."""
    every = int(opts.get("shrink_every", 0))
    return every, int(opts.get("shrink_stable", 3 if every else 0))


def convergence_of(res) -> Optional[dict]:
    """The materialized convergence ring of a solve (obs/convergence.py),
    None when the solve carried none."""
    tele = getattr(res, "telemetry", None)
    return None if tele is None else materialize(tele)


def get_sv_indices(alpha: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """Indices with alpha > tol."""
    return np.nonzero(alpha > tol)[0]


class BinarySVC:
    """Binary C-SVC over any kernel family (config.kernel). The
    approximate families (rff, nystrom) fit their feature map on the host
    and map on the card; the solver, the SV rows (sv_X_) and scoring then
    live in the mapped space (fmap_, n_features_in_).

    accum_dtype: the solver's alpha/f dtype; "auto" = torch.float64 (f32
    features with f64 accumulators), None = same as the features.
    solver: "blocked" (the working-set solver, solver/blocked.py) or
    "pair" (one pair per iteration, solver/smo.py). solver_opts: that
    solver's knobs (blocked: q, max_outer, max_inner, wss, inner,
    fused_fupdate, pallas_eta_exclude, pallas_multipair,
    pallas_fused_selection and the JAX solver's other knobs, as
    solver/blocked.py lists them, and shrinking_blocked_solve's
    shrink_every, shrink_min, shrink_gap_factor and max_unshrinks; pair:
    chunk, graph, refresh). device: where fit and scoring run ("cuda" unless
    the caller asks for "cpu"). dtype: the feature dtype the solve and
    scoring compute in, torch.float32 (the default), torch.bfloat16 or
    torch.float64 (or their names); the card's kernels take float32, so the
    other dtypes run the solvers' torch engines (resolve_solver_config,
    resolve_pair_refresh). After calibrate(), platt_ = (A, B) and
    predict_proba is available.
    """

    def __init__(self, config: SVMConfig = SVMConfig(), scale: bool = True,
                 accum_dtype="auto", solver: str = "blocked",
                 solver_opts: Optional[dict] = None, device="cuda",
                 dtype=torch.float32):
        check_solver(solver)
        self.solver = solver
        self.dtype = resolve_dtype(dtype)
        self.config = config
        self.scale = scale
        self.accum_dtype = accum_dtype
        self.solver_opts = dict(solver_opts or {})
        self.device = device
        self.scaler_: Optional[MinMaxScaler] = None
        self.sv_X_: Optional[np.ndarray] = None
        self.sv_Y_: Optional[np.ndarray] = None
        self.sv_alpha_: Optional[np.ndarray] = None
        self.sv_ids_: Optional[np.ndarray] = None
        self.b_: float = 0.0
        self.b_high_: float = float("nan")
        self.b_low_: float = float("nan")
        self.n_iter_: int = 0
        self.status_: Status = Status.RUNNING
        self.train_time_s_: float = 0.0
        # host seconds per fit phase: scale, cast, to_device, solve,
        # to_host, sv_extract (the solver's own wait is result_.host_wait_s)
        self.fit_phases_: dict = {}
        self.result_ = None
        self.platt_: Optional[tuple] = None
        # the precision rung and shrinking cadence of the fit (artifact
        # provenance)
        self.train_precision_: str = "f32"
        self.shrink_every_: int = 0
        self.shrink_stable_: int = 0
        # the materialized convergence ring (solver_opts telemetry=T)
        self.convergence_: Optional[dict] = None
        # cascade provenance (fit_cascade): None/0 for a single solve
        self.cascade_history_: Optional[list] = None
        self.cascade_rounds_: int = 0
        self.cascade_topology_: Optional[str] = None
        self.cascade_leaves_: int = 0
        # approximate families: the fitted feature map and the raw input
        # width (sv_X_ then holds MAPPED rows)
        self.fmap_ = None
        self.n_features_in_: Optional[int] = None
        # streamed approximate fits: the reader's live-shard high-water
        # mark (the prefetch_depth + 1 bound) and the primal result
        self.stream_max_live_shards_: Optional[int] = None
        self.primal_result_ = None
        # pod fits: the rows each worker loaded and the PodResult (its
        # per-worker launches and start-up seconds)
        self.pod_worker_rows_: Optional[tuple] = None
        self.pod_result_ = None

    def _scale_fit(self, X: np.ndarray) -> np.ndarray:
        if self.scale:
            self.scaler_ = MinMaxScaler().fit(X)
            return self.scaler_.transform(X)
        return X

    def _map_fit(self, Xs: np.ndarray) -> None:
        """Fit the approximate feature map on the host (nothing for the
        exact families)."""
        if not is_approx_family(self.config.kernel):
            return
        from tpusvm_torch.approx import build_map

        self.n_features_in_ = int(Xs.shape[1])
        self.fmap_ = build_map(self.config, X_scaled=Xs)

    def fit(self, X: np.ndarray, Y: np.ndarray,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 64,
            resume: bool = False, tracer=None) -> "BinarySVC":
        """Scale, solve, extract the SVs.

        checkpoint_path (blocked solver only): the solver's outer-loop
        carry is written atomically every `checkpoint_every` outer rounds,
        and resume=True restarts from the file, bit-identical to an
        uninterrupted fit (solver/checkpoint.py; a missing file means a
        fresh start). The approximate families map the scaled rows on the
        card before the solve. tracer: an obs.trace.Tracer that receives
        each host phase of fit_phases_ as a `fit.<phase>` span; the fit's
        results are the same bits with or without one."""
        t0 = time.perf_counter()
        Xs = self._scale_fit(np.asarray(X))
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.add_span("fit.scale", t0, t1)
        phases = {"scale": t1 - t0}
        return self._fit_scaled(Xs, np.asarray(Y), t0, phases,
                                checkpoint_path=checkpoint_path,
                                checkpoint_every=checkpoint_every,
                                resume=resume, tracer=tracer)

    def _fit_scaled(self, Xs: np.ndarray, Y: np.ndarray, t0: float,
                    phases: dict, checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 64,
                    resume: bool = False, tracer=None) -> "BinarySVC":
        """The solve and SV extraction on already-scaled rows (fit, and
        fit_stream for the exact families). phases: host seconds so far."""
        dev = resolve_device(self.device)
        # the spans tile the fit from t0: the time since the caller's last
        # phase (the device's resolution) counts in the next one
        t = t0 + sum(phases.values())

        def span(name):
            nonlocal t
            now = time.perf_counter()
            phases[name] = now - t
            if tracer is not None:
                tracer.add_span(f"fit.{name}", t, now)
            t = now

        cfg = self.config
        # cast on the host: for float32 half the bytes cross to the device
        Xc = to_dtype(Xs, self.dtype)
        span("cast")
        Xd = Xc.to(dev)
        Yd = torch.as_tensor(Y, device=dev)
        span("to_device")
        self._map_fit(Xs)
        if self.fmap_ is not None:
            # the solver, the SV rows and scoring live in the mapped space
            Xd = self.fmap_.transform(Xd)
            span("map")
        ckpt = None
        if checkpoint_path is not None:
            ckpt = dict(checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every, resume=resume)
        res = solve(self.solver, Xd, Yd, cfg, self.accum_dtype,
                    self.solver_opts, dev, checkpoint=ckpt)
        span("solve")
        alpha = to_numpy(res.alpha)  # device->host copy: completion
        span("to_host")
        self.train_time_s_ = time.perf_counter() - t0
        self.result_ = res
        self.train_precision_ = self.solver_opts.get("matmul_precision") \
            or "f32"
        self.shrink_every_, self.shrink_stable_ = shrink_provenance(
            self.solver_opts)
        self.convergence_ = convergence_of(res)
        sv = get_sv_indices(alpha, cfg.sv_tol)
        if self.fmap_ is not None:
            self.sv_X_ = to_numpy(Xd[torch.as_tensor(sv, device=dev)])
        else:
            self.sv_X_ = Xs[sv]
        self.sv_Y_ = np.asarray(Y)[sv].astype(np.int32)
        self.sv_alpha_ = alpha[sv]
        self.sv_ids_ = sv.astype(np.int32)
        span("sv_extract")
        self.fit_phases_ = phases
        self.b_ = float(res.b)
        self.b_high_ = float(res.b_high)
        self.b_low_ = float(res.b_low)
        self.n_iter_ = int(res.n_iter)
        self.status_ = Status(int(res.status))
        if self.status_ != Status.CONVERGED:
            warnings.warn(
                f"SMO terminated with {self.status_.name} after "
                f"{self.n_iter_} iterations; the model may be partially "
                "optimised",
                RuntimeWarning,
                stacklevel=3,
            )
        return self

    def fit_stream(self, dataset, checkpoint_path: Optional[str] = None,
                   checkpoint_every: int = 64,
                   resume: bool = False) -> "BinarySVC":
        """Fit from a sharded dataset (stream/).

        The scaler comes from the MANIFEST statistics (the bits of a
        whole-array fit, stream/stats.py) and shards are scaled as they
        stream in. The exact families concatenate the scaled shards and
        solve as fit() does, with its bits (one copy to the card). The
        approximate families run the streaming primal solver
        (_fit_stream_approx): each shard is copied to the card and mapped
        there in the reader's prefetch hook and consumed batch by batch,
        so neither the raw nor the mapped (n, D) matrix exists anywhere.
        checkpoint_path/resume: see fit() (exact families only)."""
        from tpusvm_torch.stream.reader import ShardReader

        t0 = time.perf_counter()
        scaler = None
        if self.scale:
            self.scaler_ = scaler = dataset.scaler()
        if is_approx_family(self.config.kernel):
            if checkpoint_path is not None or resume:
                raise ValueError(
                    "checkpoint_path/resume is a blocked-solver outer-"
                    "loop surface; the streamed approximate fit runs "
                    "the approx/primal.py epoch schedule instead, which "
                    "has no checkpoints yet")
            return self._fit_stream_approx(dataset, scaler, t0)
        parts = [X for X, _ in ShardReader(dataset, scaler=scaler)]
        Xs = np.concatenate(parts)
        del parts
        phases = {"stream_scale": time.perf_counter() - t0}
        return self._fit_scaled(Xs, dataset.load_labels(), t0, phases,
                                checkpoint_path=checkpoint_path,
                                checkpoint_every=checkpoint_every,
                                resume=resume)

    def _fit_stream_approx(self, dataset, scaler, t0: float) -> "BinarySVC":
        """Out-of-core approximate training: per-shard mapping on the card
        in the reader's prefetch hook and the streaming primal solver.

        The result is a one-support-vector linear model over mapped
        features (sv_X_ = w, alpha*y = 1, b = bias). solver_opts:
        primal_batch (default 1024), primal_epochs (64), primal_tol (0.05)
        and prefetch_depth (2); anything else is a blocked-solver knob and
        is refused by name, as in the JAX package."""
        from tpusvm_torch.approx import build_map, streaming_primal_fit
        from tpusvm_torch.approx.features import nystrom_landmark_indices
        from tpusvm_torch.device import host_to_device
        from tpusvm_torch.stream.reader import ShardReader

        dev = resolve_device(self.device)
        cfg = self.config
        opts = dict(self.solver_opts)
        batch = int(opts.pop("primal_batch", 1024))
        epochs = int(opts.pop("primal_epochs", 64))
        tol = float(opts.pop("primal_tol", 0.05))
        prefetch_depth = int(opts.pop("prefetch_depth", 2))
        if opts:
            raise ValueError(
                f"streamed approximate fits take only the primal knobs "
                f"(primal_batch, primal_epochs, primal_tol, "
                f"prefetch_depth); got blocked-solver opts "
                f"{sorted(opts)}")
        n, d = dataset.n_rows, dataset.n_features
        self.n_features_in_ = int(d)
        if cfg.kernel == "nystrom":
            # the same seeded landmark rows the in-memory path draws,
            # gathered from the manifest without loading the rest
            from tpusvm_torch.stream.assign import gather_rows

            idx = nystrom_landmark_indices(n, cfg.landmarks, cfg.map_seed)
            rows = gather_rows(dataset, idx)
            if scaler is not None:
                rows = scaler.transform(rows)
            fmap = build_map(cfg, landmark_rows=rows)
        else:
            fmap = build_map(cfg, n_features=d)
        self.fmap_ = fmap
        fmap.device_arrays(dev)  # the parameters cross once, not per shard

        def to_card_and_map(X):
            return fmap.transform(host_to_device(X, torch.float32, dev))

        readers = []

        def make_reader(epoch):
            r = ShardReader(dataset, prefetch_depth=prefetch_depth,
                            scaler=scaler, dtype=np.float32,
                            transform=to_card_and_map)
            readers.append(r)
            return r

        res = streaming_primal_fit(
            make_reader, fmap.dim, C=cfg.C, n_rows=n, batch=batch,
            epochs=epochs, tol=tol, dtype=np.float32, device=dev)
        self.primal_result_ = res
        self.stream_max_live_shards_ = max(r.max_live_shards
                                           for r in readers)
        self.train_time_s_ = time.perf_counter() - t0
        self.sv_X_ = res.w[None, :].astype(np.float32)
        self.sv_Y_ = np.array([1], np.int32)
        self.sv_alpha_ = np.array([1.0], np.float32)
        # the primal weight vector is not a training row: sentinel id
        self.sv_ids_ = np.array([-1], np.int32)
        # decision_function computes Phi(x).sv_coef - b_; the primal model
        # is f = w.Phi(x) - bias: b_ IS the bias
        self.b_ = res.bias
        self.n_iter_ = int(res.n_steps)
        self.status_ = res.status
        if self.status_ != Status.CONVERGED:
            warnings.warn(
                f"streaming primal fit ended {self.status_.name} after "
                f"{res.epochs_run} epochs (objective {res.objective:g}); "
                "raise primal_epochs or loosen primal_tol",
                RuntimeWarning, stacklevel=3)
        return self

    def fit_cascade(self, X: np.ndarray, Y: np.ndarray,
                    cascade_config: CascadeConfig = CascadeConfig(),
                    group=None, verbose: bool = False,
                    checkpoint_path: Optional[str] = None,
                    resume: bool = False, stratified: bool = False,
                    tracer=None) -> "BinarySVC":
        """Cascade training (parallel/cascade.py): min-max scale on the full
        array, then every leaf solves with this estimator's solver
        ("blocked" by default; "pair" for the reference-faithful
        trajectory) and solver_opts, on this estimator's device.

        group: None runs every rank in this process; a torch.distributed
        group (parallel.init_group) makes this process one rank of
        n_shards, and every rank calls fit_cascade with the same data.
        checkpoint_path/resume: per-round cascade state. stratified:
        per-class round-robin sharding instead of the contiguous scatter.
        tracer: an obs.trace.Tracer receiving a cascade.round span and
        event a round (parallel/cascade.py). The approximate
        families cascade over the mapped rows: the map is fitted once on
        the full scaled data and every leaf runs the linear path."""
        from tpusvm_torch.parallel.cascade import cascade_fit

        t0 = time.perf_counter()
        Xs = self._scale_fit(np.asarray(X))
        self._map_fit(Xs)
        if self.fmap_ is not None:
            # the cascade runs over the MAPPED rows: mapped on the card,
            # then partitioned on the host like any other rows
            Xs = self.fmap_.transform_np(Xs, device=self.device)
        res = cascade_fit(
            Xs, Y, self.config, cascade_config, group=group,
            accum_dtype=self.accum_dtype, verbose=verbose,
            checkpoint_path=checkpoint_path, resume=resume,
            solver=self.solver, solver_opts=self.solver_opts,
            stratified=stratified, tracer=tracer, device=self.device,
            dtype=self.dtype,
        )
        return self._finish_cascade(res, t0, cascade_config)

    def _finish_cascade(self, res, t0: float,
                        cascade_config: CascadeConfig) -> "BinarySVC":
        self.train_time_s_ = time.perf_counter() - t0
        self.sv_X_ = res.sv_X
        self.sv_Y_ = res.sv_Y
        self.sv_alpha_ = res.sv_alpha
        self.sv_ids_ = res.sv_ids
        self.b_ = res.b
        self.n_iter_ = int(sum(h["iters"].sum() for h in res.history))
        self.status_ = (
            Status.CONVERGED if res.converged else Status.MAX_ITER
        )
        self.cascade_history_ = res.history
        self.cascade_rounds_ = res.rounds
        self.cascade_topology_ = cascade_config.topology
        self.cascade_leaves_ = int(cascade_config.n_shards)
        return self

    def fit_cascade_stream(self, dataset,
                           cascade_config: CascadeConfig = CascadeConfig(),
                           group=None, verbose: bool = False,
                           checkpoint_path: Optional[str] = None,
                           resume: bool = False, stratified: bool = False,
                           tracer=None) -> "BinarySVC":
        """The cascade from a sharded dataset: the scaler from the MANIFEST
        statistics, each leaf filled by streaming shards into the
        partition (stream.partition_from_dataset), so no (n, d) array
        exists. The partition equals fit_cascade's on the same rows bit
        for bit, so the model does too. Arguments as fit_cascade."""
        if is_approx_family(self.config.kernel):
            raise ValueError(
                "fit_cascade_stream does not support the approximate "
                f"families yet (kernel={self.config.kernel!r}): leaf "
                "partitions are filled with RAW rows and the mapped "
                "width would change every buffer shape; use fit_stream "
                "(the streaming primal path) or in-memory fit_cascade "
                "over mapped features")
        from tpusvm_torch.parallel.cascade import cascade_fit
        from tpusvm_torch.stream.assign import partition_from_dataset

        t0 = time.perf_counter()
        scaler = None
        if self.scale:
            self.scaler_ = scaler = dataset.scaler()
        part = partition_from_dataset(dataset, cascade_config.n_shards,
                                      stratified=stratified, scaler=scaler)
        res = cascade_fit(
            None, None, self.config, cascade_config, group=group,
            accum_dtype=self.accum_dtype, verbose=verbose,
            checkpoint_path=checkpoint_path, resume=resume,
            solver=self.solver, solver_opts=self.solver_opts,
            partition=part, tracer=tracer, device=self.device,
            dtype=self.dtype)
        return self._finish_cascade(res, t0, cascade_config)

    def fit_pod(self, data: str,
                cascade_config: CascadeConfig = CascadeConfig(),
                verbose: bool = False,
                checkpoint_path: Optional[str] = None,
                resume: bool = False, stratified: bool = False,
                prefetch_depth: int = 2, tracer=None,
                trace_dir: Optional[str] = None,
                trace_max_bytes: Optional[int] = None) -> "BinarySVC":
        """Pod (multi-process) cascade training from a sharded dataset
        directory: each leaf runs in its OWN worker process that streams
        only its manifest shards (pod/), on this estimator's device — the
        process-transport sibling of fit_cascade_stream, with the same
        fixed point, bit for bit, and the same manifest-fitted scaler.
        Leaves are host processes, so shrink_every and its siblings in
        solver_opts run the shrinking driver per leaf (solver="blocked").

        checkpoint_path/resume: per-round coordinator checkpoints
        (pod/state.py); a killed coordinator resumes bit-identically, a
        killed worker is revived mid-round. tracer: an obs.trace.Tracer for
        the pod.fit and pod.round spans and events; trace_dir (with a
        tracer made with role=) has every worker write its own trace file
        there, parented under the coordinator's spans (pod/coordinator.py);
        trace_max_bytes bounds each worker's file."""
        if is_approx_family(self.config.kernel):
            raise ValueError(
                "fit_pod does not support the approximate families yet "
                f"(kernel={self.config.kernel!r}): leaf partitions are "
                "filled with RAW rows and the mapped width would change "
                "every buffer shape; use fit_stream (the streaming "
                "primal path) or in-memory fit_cascade over mapped "
                "features")
        from tpusvm_torch.pod import pod_fit
        from tpusvm_torch.stream import open_dataset

        t0 = time.perf_counter()
        if self.scale:
            self.scaler_ = open_dataset(data).scaler()
        res = pod_fit(
            data, self.config, cascade_config,
            accum_dtype=self.accum_dtype, verbose=verbose,
            checkpoint_path=checkpoint_path, resume=resume,
            solver=self.solver, solver_opts=self.solver_opts,
            stratified=stratified, prefetch_depth=prefetch_depth,
            scale=self.scale, tracer=tracer, trace_dir=trace_dir,
            trace_max_bytes=trace_max_bytes, device=self.device,
            dtype=self.dtype)
        self.pod_result_ = res
        self.stream_max_live_shards_ = int(max(res.worker_max_live_shards))
        self.pod_worker_rows_ = tuple(int(r) for r in res.worker_rows)
        # ladder provenance, as fit() records it: pod leaves run the
        # shrinking driver and the precision rungs for real
        self.train_precision_ = (
            self.solver_opts.get("matmul_precision") or "f32")
        self.shrink_every_, self.shrink_stable_ = shrink_provenance(
            self.solver_opts)
        return self._finish_cascade(res, t0, cascade_config)

    def _check_fitted(self):
        if self.sv_X_ is None:
            raise RuntimeError("model is not fitted")

    def decision_function(self, X: np.ndarray, mesh=None) -> np.ndarray:
        """Scores f(x) = sum_k alpha_k y_k K(x, x_k) - b, in the model's
        dtype (bfloat16 scores come back as float32: numpy has no
        bfloat16).

        mesh: optional 1-D mesh (parallel/mesh.py, or a list of devices):
        the test rows are split into one contiguous chunk per mesh member,
        each scored on its device, and the scores concatenated in order.
        Each row's score depends on that row alone, so the scores match the
        unsplit call to the summation-order noise of the contraction."""
        self._check_fitted()
        return scores(self, self.sv_alpha_ * self.sv_Y_, self.b_, X, mesh)

    def predict(self, X: np.ndarray, mesh=None) -> np.ndarray:
        # strict > 0 -> +1
        return np.where(self.decision_function(X, mesh=mesh) > 0, 1,
                        -1).astype(np.int32)

    def score(self, X: np.ndarray, Y: np.ndarray, mesh=None) -> float:
        return float((self.predict(X, mesh=mesh) == np.asarray(Y)).mean())

    def calibrate(self, X: np.ndarray, Y: np.ndarray, folds: int = 3,
                  seed: int = 0) -> "BinarySVC":
        """Fit Platt-scaled predict_proba on held-out fold scores: `folds`
        clones trained on stratified splits (tune/folds.py), their
        out-of-fold decision scores pooled, the sigmoid fitted on that
        pool; it then maps THIS model's decision_function."""
        X = np.asarray(X)
        Y = np.asarray(Y)
        pooled = np.empty(len(Y), np.float64)
        for fold in stratified_kfold(Y, folds, seed=seed):
            sub = BinarySVC(config=self.config, scale=self.scale,
                            accum_dtype=self.accum_dtype, solver=self.solver,
                            solver_opts=self.solver_opts, device=self.device,
                            dtype=self.dtype)
            sub.fit(X[fold.train_idx], Y[fold.train_idx])
            pooled[fold.val_idx] = sub.decision_function(X[fold.val_idx])
        self.platt_ = fit_platt(pooled, Y)
        return self

    def predict_proba(self, X: np.ndarray, mesh=None) -> np.ndarray:
        """(m, 2) class probabilities [P(y=-1), P(y=+1)], Platt-scaled;
        monotone in decision_function (mesh: as there). Requires
        calibrate() first."""
        if self.platt_ is None:
            raise RuntimeError(
                "model is not calibrated; call calibrate(X, Y) (or train "
                "with --calibrate) before predict_proba")
        p = platt_proba(self.decision_function(X, mesh=mesh), *self.platt_)
        return np.stack([1.0 - p, p], axis=1)

    @property
    def n_support_(self) -> int:
        self._check_fitted()
        return len(self.sv_alpha_)

    def save(self, path: str) -> None:
        self._check_fitted()
        state = {
            "sv_X": self.sv_X_,
            "sv_Y": self.sv_Y_,
            "sv_alpha": self.sv_alpha_,
            "sv_ids": self.sv_ids_,
            "b": self.b_,
            "scale": self.scale,
        }
        if self.scale:
            state["scaler_min"] = self.scaler_.min_val
            state["scaler_max"] = self.scaler_.max_val
        if self.platt_ is not None:
            state["platt_a"], state["platt_b"] = self.platt_
        # training provenance of the v3+ format: the precision rung and
        # the shrinking cadence it was trained under
        state["train_precision"] = self.train_precision_
        state["shrink_every"] = self.shrink_every_
        state["shrink_stable"] = self.shrink_stable_
        # cascade provenance (format v4, additive): absent for a single
        # solve
        if self.cascade_topology_ is not None:
            state["cascade_topology"] = self.cascade_topology_
            state["cascade_leaves"] = int(self.cascade_leaves_)
            state["cascade_rounds"] = int(self.cascade_rounds_)
        # approximate-map provenance (format v4): the raw input width, and
        # nystrom's landmark rows and weights (rff regenerates omega)
        if self.fmap_ is not None:
            state.update(self.fmap_.state_entries())
        save_model(path, state, self.config)

    @classmethod
    def load(cls, path: str, device="cuda", dtype=torch.float32) -> "BinarySVC":
        state, config = load_model(path)
        model = cls(config=config, scale=bool(state["scale"]), device=device,
                    dtype=dtype)
        model.sv_X_ = state["sv_X"]
        model.sv_Y_ = state["sv_Y"]
        model.sv_alpha_ = state["sv_alpha"]
        model.sv_ids_ = state["sv_ids"]
        model.b_ = float(state["b"])
        if model.scale:
            model.scaler_ = MinMaxScaler(min_val=state["scaler_min"],
                                         max_val=state["scaler_max"])
        if "platt_a" in state:
            model.platt_ = (float(state["platt_a"]), float(state["platt_b"]))
        if "train_precision" in state:
            model.train_precision_ = str(state["train_precision"])
        if "shrink_every" in state:
            model.shrink_every_ = int(state["shrink_every"])
            model.shrink_stable_ = int(state["shrink_stable"])
        if "cascade_topology" in state:
            model.cascade_topology_ = str(state["cascade_topology"])
            model.cascade_leaves_ = int(state["cascade_leaves"])
            model.cascade_rounds_ = int(state["cascade_rounds"])
        load_map(model, state, config)
        model.status_ = Status.CONVERGED
        return model


def load_map(model, state: dict, config: SVMConfig) -> None:
    """Rebuild a loaded approximate-family model's feature map (rff from
    the config, nystrom from its stored arrays)."""
    if is_approx_family(config.kernel):
        from tpusvm_torch.approx import map_from_state

        model.fmap_ = map_from_state(state, config)
        model.n_features_in_ = model.fmap_.n_features_in


def scores(model, coef: np.ndarray, b, X: np.ndarray,
           mesh=None) -> np.ndarray:
    """sum_k coef_k K(x, sv_k) - b in the model's dtype for a fitted
    estimator with sv_X_ (the SV rows), config, scaler_, fmap_, dtype and
    device; coef (n_sv,) or (n_sv, K) for K heads. An approximate-family
    model maps the scaled rows on the card first (sv_X_ holds mapped rows).
    mesh: None scores on the model's device; a 1-D mesh (or a list of
    devices) splits the rows into one chunk per member (parallel/mesh.py:
    split_rows), scores each on its device and concatenates the chunks."""
    Xs = model.scaler_.transform(np.asarray(X)) if model.scale else np.asarray(X)
    Xq = to_dtype(Xs, model.dtype)
    if mesh is None:
        return _scores_on(model, coef, b, Xq.to(resolve_device(model.device)))
    from tpusvm_torch.parallel.mesh import as_mesh, split_rows

    mesh = as_mesh(mesh)
    for dev in mesh.devices:
        resolve_device(dev)
    parts = [_scores_on(model, coef, b, chunk)
             for chunk in split_rows(mesh, Xq)]
    return np.concatenate(parts)


def _scores_on(model, coef, b, Xq: torch.Tensor) -> np.ndarray:
    """The scores of the scaled rows Xq, on Xq's device."""
    sv, coef, b = score_operands(model, coef, b, Xq.device)
    return to_numpy(score_scaled(Xq, sv, coef, b, model.config,
                                 getattr(model, "fmap_", None)))


def score_operands(model, coef, b, device):
    """(SV rows, coef, b) of a fitted estimator on `device` in its dtype:
    the operands every scoring call feeds the decision (a served model
    pins exactly these once, serve/registry.py)."""
    dt = model.dtype
    sv = to_dtype(model.sv_X_, dt).to(device)
    coef = to_dtype(np.asarray(coef, np.float64), dt).to(device)
    b = to_dtype(np.asarray(b, np.float64), dt).to(device)
    return sv, coef, b


def score_scaled(Xq: torch.Tensor, sv: torch.Tensor, coef: torch.Tensor,
                 b: torch.Tensor, config: SVMConfig, fmap=None,
                 block: int = 2048) -> torch.Tensor:
    """sum_k coef_k K(x, sv_k) - b for scaled rows Xq on their device: the
    approximate families map first (sv then holds mapped rows). The one
    program offline scoring and every served bucket run."""
    if fmap is not None:
        from tpusvm_torch.approx import approx_decision_function

        return approx_decision_function(Xq, fmap, sv, coef, b, block=block)
    return _decision(Xq, sv, coef, b, gamma=config.gamma,
                     kernel=config.kernel, degree=config.degree,
                     coef0=config.coef0, block=block)
