"""Epsilon-SVR: the regression task over the same solvers.

fit stacks X2 = [X; X] with labels [+1]*n + [-1]*n and pseudo-targets
t -/+ epsilon (kernels/svr.py), runs the blocked or pair solver on it with
`targets=z`, and collapses the 2n duals to signed coefficients
coef_i = alpha_i - alpha*_i. Prediction is the classifiers' sum,

    y(x) = sum_i coef_i K(x, x_i) - b,

so the artifact differs from a classifier's only in carrying `sv_coef`
(signed) and a `task` marker. The approximate families map the single set
of rows on the card before the doubling (sv_X_ then holds mapped rows).
The port of `tpusvm/models/svr.py`.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from tpusvm_torch.config import SVMConfig, is_approx_family, resolve_dtype
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device, to_dtype, to_numpy
from tpusvm_torch.kernels.svr import collapse_duals, doubled_problem
from tpusvm_torch.models.serialization import load_model, save_model
from tpusvm_torch.models.svm import (check_solver, convergence_of, load_map,
                                     scores, solve)
from tpusvm_torch.status import Status


class EpsilonSVR:
    """Epsilon-insensitive support vector regression via doubled SMO.

    Attributes after fit: sv_X_, sv_coef_ (signed alpha - alpha*),
    sv_ids_, b_, n_iter_, status_, train_time_s_, scaler_, result_.
    dtype: the feature dtype (BinarySVC's).
    """

    def __init__(self, config: SVMConfig = SVMConfig(), scale: bool = True,
                 accum_dtype="auto", solver: str = "blocked",
                 solver_opts: Optional[dict] = None, device="cuda",
                 dtype=torch.float32):
        check_solver(solver)
        self.dtype = resolve_dtype(dtype)
        self.config = config
        self.scale = scale
        self.accum_dtype = accum_dtype
        self.solver = solver
        self.solver_opts = dict(solver_opts or {})
        self.device = device
        self.scaler_: Optional[MinMaxScaler] = None
        self.sv_X_: Optional[np.ndarray] = None
        self.sv_coef_: Optional[np.ndarray] = None
        self.sv_ids_: Optional[np.ndarray] = None
        self.b_: float = 0.0
        self.b_high_: float = float("nan")
        self.b_low_: float = float("nan")
        self.n_iter_: int = 0
        self.status_: Status = Status.RUNNING
        self.train_time_s_: float = 0.0
        self.result_ = None
        # the materialized convergence ring (solver_opts telemetry=T)
        self.convergence_: Optional[dict] = None
        # approximate families: the map and the raw input width
        self.fmap_ = None
        self.n_features_in_: Optional[int] = None

    def fit(self, X: np.ndarray, t: np.ndarray) -> "EpsilonSVR":
        """Fit on features X and CONTINUOUS targets t (not labels)."""
        dev = resolve_device(self.device)
        t0 = time.perf_counter()
        cfg = self.config
        X = np.asarray(X)
        t = np.asarray(t, np.float64)
        if self.scale:
            self.scaler_ = MinMaxScaler().fit(X)
            Xs = self.scaler_.transform(X)
        else:
            Xs = X
        Y2, z = doubled_problem(t, cfg.epsilon)
        X1 = to_dtype(Xs, self.dtype).to(dev)
        if is_approx_family(cfg.kernel):
            # the map is fitted on the single set of rows; the doubling
            # shares it
            from tpusvm_torch.approx import build_map

            self.n_features_in_ = int(np.asarray(Xs).shape[1])
            self.fmap_ = build_map(cfg, X_scaled=np.asarray(Xs))
            X1 = self.fmap_.transform(X1)
        X2 = torch.cat([X1, X1])
        res = solve(self.solver, X2, torch.as_tensor(Y2, device=dev), cfg,
                    self.accum_dtype, self.solver_opts, dev,
                    targets=torch.as_tensor(z, device=dev))
        beta = to_numpy(res.alpha)  # device->host copy: completion
        self.train_time_s_ = time.perf_counter() - t0
        self.result_ = res
        self.convergence_ = convergence_of(res)
        coef = collapse_duals(beta)
        sv = np.nonzero(np.abs(coef) > cfg.sv_tol)[0]
        self.sv_X_ = (to_numpy(X1[torch.as_tensor(sv, device=dev)])
                      if self.fmap_ is not None else Xs[sv])
        self.sv_coef_ = coef[sv]
        self.sv_ids_ = sv.astype(np.int32)
        self.b_ = float(res.b)
        self.b_high_ = float(res.b_high)
        self.b_low_ = float(res.b_low)
        self.n_iter_ = int(res.n_iter)
        self.status_ = Status(int(res.status))
        if self.status_ != Status.CONVERGED:
            warnings.warn(
                f"SVR SMO terminated with {self.status_.name} after "
                f"{self.n_iter_} iterations; the model may be partially "
                "optimised",
                RuntimeWarning,
                stacklevel=2,
            )
        return self

    def _check_fitted(self):
        if self.sv_X_ is None:
            raise RuntimeError("model is not fitted")

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Regressed values y(x) = sum_i coef_i K(x, x_i) - b. Shape (m,)."""
        self._check_fitted()
        return scores(self, self.sv_coef_, self.b_, X)

    # for SVR the score is the prediction
    decision_function = predict

    def score(self, X: np.ndarray, t: np.ndarray) -> float:
        """Coefficient of determination R^2 (1 = perfect regression)."""
        t = np.asarray(t, np.float64)
        resid = t - self.predict(X)
        ss_tot = float(((t - t.mean()) ** 2).sum())
        if ss_tot == 0.0:
            return 1.0 if float((resid ** 2).sum()) == 0.0 else 0.0
        return 1.0 - float((resid ** 2).sum()) / ss_tot

    @property
    def n_support_(self) -> int:
        self._check_fitted()
        return len(self.sv_coef_)

    def save(self, path: str) -> None:
        self._check_fitted()
        state = {
            "task": "svr",
            "sv_X": self.sv_X_,
            "sv_coef": self.sv_coef_,
            "sv_ids": self.sv_ids_,
            "b": self.b_,
            "scale": self.scale,
        }
        if self.scale:
            state["scaler_min"] = self.scaler_.min_val
            state["scaler_max"] = self.scaler_.max_val
        if self.fmap_ is not None:
            state.update(self.fmap_.state_entries())
        save_model(path, state, self.config)

    @classmethod
    def load(cls, path: str, device="cuda",
             dtype=torch.float32) -> "EpsilonSVR":
        state, config = load_model(path)
        if "sv_coef" not in state:
            raise ValueError(
                f"{path!r} is not an EpsilonSVR artifact (no sv_coef "
                "state); load it with BinarySVC/OneVsRestSVC")
        model = cls(config=config, scale=bool(state["scale"]), device=device,
                    dtype=dtype)
        model.sv_X_ = state["sv_X"]
        model.sv_coef_ = state["sv_coef"]
        model.sv_ids_ = state["sv_ids"]
        model.b_ = float(state["b"])
        if model.scale:
            model.scaler_ = MinMaxScaler(min_val=state["scaler_min"],
                                         max_val=state["scaler_max"])
        load_map(model, state, config)
        model.status_ = Status.CONVERGED
        return model
