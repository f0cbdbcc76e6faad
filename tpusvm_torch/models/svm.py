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

from tpusvm_torch.config import (CascadeConfig, SVMConfig, refuse_approx,
                                 resolve_accum_dtype)
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device
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
    """Binary C-SVC over any exact kernel family (config.kernel).

    accum_dtype: the solver's alpha/f dtype; "auto" = torch.float64 (f32
    features with f64 accumulators), None = same as the features.
    solver: "blocked" (the working-set solver, solver/blocked.py) or
    "pair" (one pair per iteration, solver/smo.py). solver_opts: that
    solver's knobs (blocked: q, max_outer, max_inner, wss, inner,
    fused_fupdate, pallas_eta_exclude, pallas_multipair,
    pallas_fused_selection and the JAX solver's other knobs, as
    solver/blocked.py lists them, and shrinking_blocked_solve's
    shrink_every, shrink_min, shrink_gap_factor and max_unshrinks; pair:
    chunk, graph). device: where fit and scoring run ("cuda" unless the caller
    asks for "cpu"). After calibrate(), platt_ = (A, B) and predict_proba
    is available.
    """

    def __init__(self, config: SVMConfig = SVMConfig(), scale: bool = True,
                 accum_dtype="auto", solver: str = "blocked",
                 solver_opts: Optional[dict] = None, device="cuda"):
        check_solver(solver)
        refuse_approx(config.kernel)
        self.solver = solver
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

    def _scale_fit(self, X: np.ndarray) -> np.ndarray:
        if self.scale:
            self.scaler_ = MinMaxScaler().fit(X)
            return self.scaler_.transform(X)
        return X

    def fit(self, X: np.ndarray, Y: np.ndarray,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 64,
            resume: bool = False) -> "BinarySVC":
        """Scale, solve, extract the SVs.

        checkpoint_path (blocked solver only): the solver's outer-loop
        carry is written atomically every `checkpoint_every` outer rounds,
        and resume=True restarts from the file, bit-identical to an
        uninterrupted fit (solver/checkpoint.py; a missing file means a
        fresh start)."""
        dev = resolve_device(self.device)
        phases = {}
        t0 = t = time.perf_counter()

        def span(name):
            nonlocal t
            now = time.perf_counter()
            phases[name] = now - t
            t = now

        Xs = self._scale_fit(np.asarray(X))
        span("scale")
        cfg = self.config
        # cast on the host: half the bytes cross to the device
        X32 = np.asarray(Xs, np.float32)
        span("cast")
        Xd = torch.as_tensor(X32, device=dev)
        Yd = torch.as_tensor(np.asarray(Y), device=dev)
        span("to_device")
        ckpt = None
        if checkpoint_path is not None:
            ckpt = dict(checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every, resume=resume)
        res = solve(self.solver, Xd, Yd, cfg, self.accum_dtype,
                    self.solver_opts, dev, checkpoint=ckpt)
        span("solve")
        alpha = res.alpha.cpu().numpy()  # device->host copy: completion
        span("to_host")
        self.train_time_s_ = time.perf_counter() - t0
        self.result_ = res
        self.train_precision_ = self.solver_opts.get("matmul_precision") \
            or "f32"
        self.shrink_every_, self.shrink_stable_ = shrink_provenance(
            self.solver_opts)
        self.convergence_ = convergence_of(res)
        sv = get_sv_indices(alpha, cfg.sv_tol)
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
                stacklevel=2,
            )
        return self

    def fit_stream(self, *args, **kwargs):
        raise NotImplementedError(
            "the streaming fit over a sharded dataset is not ported yet "
            "(ROADMAP Queue 1 item 11)")

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
        tracer: not ported yet (ROADMAP Queue 1 item 12)."""
        from tpusvm_torch.parallel.cascade import cascade_fit

        t0 = time.perf_counter()
        Xs = self._scale_fit(np.asarray(X))
        res = cascade_fit(
            Xs, Y, self.config, cascade_config, group=group,
            accum_dtype=self.accum_dtype, verbose=verbose,
            checkpoint_path=checkpoint_path, resume=resume,
            solver=self.solver, solver_opts=self.solver_opts,
            stratified=stratified, tracer=tracer, device=self.device,
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

    def fit_cascade_stream(self, *args, **kwargs):
        raise NotImplementedError(
            "the cascade fit from a sharded dataset is not ported yet "
            "(ROADMAP Queue 1 item 11: the stream tier); fit_cascade trains "
            "the same cascade from an in-memory array")

    def fit_pod(self, *args, **kwargs):
        raise NotImplementedError(
            "the pod fit is not ported yet (ROADMAP Queue 1 item 9(i): the "
            "pod leaves)")

    def _check_fitted(self):
        if self.sv_X_ is None:
            raise RuntimeError("model is not fitted")

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        """Scores f(x) = sum_k alpha_k y_k K(x, x_k) - b, in float32."""
        self._check_fitted()
        return scores(self, self.sv_alpha_ * self.sv_Y_, self.b_, X)

    def predict(self, X: np.ndarray) -> np.ndarray:
        # strict > 0 -> +1
        return np.where(self.decision_function(X) > 0, 1, -1).astype(np.int32)

    def score(self, X: np.ndarray, Y: np.ndarray) -> float:
        return float((self.predict(X) == np.asarray(Y)).mean())

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
                            solver_opts=self.solver_opts, device=self.device)
            sub.fit(X[fold.train_idx], Y[fold.train_idx])
            pooled[fold.val_idx] = sub.decision_function(X[fold.val_idx])
        self.platt_ = fit_platt(pooled, Y)
        return self

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """(m, 2) class probabilities [P(y=-1), P(y=+1)], Platt-scaled;
        monotone in decision_function. Requires calibrate() first."""
        if self.platt_ is None:
            raise RuntimeError(
                "model is not calibrated; call calibrate(X, Y) (or train "
                "with --calibrate) before predict_proba")
        p = platt_proba(self.decision_function(X), *self.platt_)
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
        save_model(path, state, self.config)

    @classmethod
    def load(cls, path: str, device="cuda") -> "BinarySVC":
        state, config = load_model(path)
        model = cls(config=config, scale=bool(state["scale"]), device=device)
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
        model.status_ = Status.CONVERGED
        return model


def scores(model, coef: np.ndarray, b, X: np.ndarray) -> np.ndarray:
    """sum_k coef_k K(x, sv_k) - b in float32 for a fitted estimator with
    sv_X_ (the SV rows), config, scaler_ and device; coef (n_sv,) or
    (n_sv, K) for K heads."""
    dev = resolve_device(model.device)
    cfg = model.config
    f32 = torch.float32
    Xs = model.scaler_.transform(np.asarray(X)) if model.scale else np.asarray(X)
    out = _decision(
        torch.as_tensor(np.asarray(Xs, np.float32), device=dev),
        torch.as_tensor(model.sv_X_, dtype=f32, device=dev),
        torch.as_tensor(np.array(coef, np.float32), device=dev),
        torch.as_tensor(np.array(b, np.float32), device=dev),
        gamma=cfg.gamma, kernel=cfg.kernel, degree=cfg.degree,
        coef0=cfg.coef0,
    )
    return out.cpu().numpy()
