"""The binary SVM estimator: scale, solve, extract SVs, score, persist.

  fit:      min-max scale on TRAIN data -> blocked SMO -> extract SVs
  predict:  scale with TRAIN min/max -> sign(sum_sv a_k y_k K(x, x_k) - b)

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

from tpusvm_torch.config import SVMConfig, resolve_accum_dtype
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device
from tpusvm_torch.models.serialization import load_model, save_model
from tpusvm_torch.solver.blocked import SMOResult, blocked_smo_solve
from tpusvm_torch.solver.predict import decision_function as _decision
from tpusvm_torch.status import Status


def get_sv_indices(alpha: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """Indices with alpha > tol."""
    return np.nonzero(alpha > tol)[0]


class BinarySVC:
    """Binary RBF C-SVC trained with the blocked SMO solver.

    accum_dtype: the solver's alpha/f dtype; "auto" = torch.float64 (f32
    features with f64 accumulators), None = same as the features.
    solver_opts: blocked_smo_solve knobs (q, max_outer, max_inner, wss,
    inner, fused_fupdate, eta_exclude, multipair, fused_selection). device:
    where fit and scoring run ("cuda" unless the caller asks for "cpu").
    """

    def __init__(self, config: SVMConfig = SVMConfig(), scale: bool = True,
                 accum_dtype="auto", solver_opts: Optional[dict] = None,
                 device="cuda"):
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
        self.result_: Optional[SMOResult] = None

    def _scale_fit(self, X: np.ndarray) -> np.ndarray:
        if self.scale:
            self.scaler_ = MinMaxScaler().fit(X)
            return self.scaler_.transform(X)
        return X

    def fit(self, X: np.ndarray, Y: np.ndarray) -> "BinarySVC":
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
        res = blocked_smo_solve(
            Xd, Yd,
            C=cfg.C, gamma=cfg.gamma, eps=cfg.eps, tau=cfg.tau,
            max_iter=cfg.max_iter,
            accum_dtype=resolve_accum_dtype(self.accum_dtype),
            device=dev, **self.solver_opts,
        )
        span("solve")
        alpha = res.alpha.cpu().numpy()  # device->host copy: completion
        span("to_host")
        self.train_time_s_ = time.perf_counter() - t0
        self.result_ = res
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

    def _check_fitted(self):
        if self.sv_X_ is None:
            raise RuntimeError("model is not fitted")

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        """Scores f(x) = sum_k alpha_k y_k K(x, x_k) - b, in float32."""
        self._check_fitted()
        dev = resolve_device(self.device)
        Xs = self.scaler_.transform(np.asarray(X)) if self.scale else np.asarray(X)
        f32 = torch.float32
        scores = _decision(
            torch.as_tensor(np.asarray(Xs, np.float32), device=dev),
            torch.as_tensor(self.sv_X_, dtype=f32, device=dev),
            torch.as_tensor(self.sv_alpha_ * self.sv_Y_, dtype=f32, device=dev),
            torch.tensor(self.b_, dtype=f32, device=dev),
            gamma=self.config.gamma,
        )
        return scores.cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        # strict > 0 -> +1
        return np.where(self.decision_function(X) > 0, 1, -1).astype(np.int32)

    def score(self, X: np.ndarray, Y: np.ndarray) -> float:
        return float((self.predict(X) == np.asarray(Y)).mean())

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
        # training provenance of the v3+ format: this port trains at full
        # f32 with no shrinking
        state["train_precision"] = "f32"
        state["shrink_every"] = 0
        state["shrink_stable"] = 0
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
        model.status_ = Status.CONVERGED
        return model
