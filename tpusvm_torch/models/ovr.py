"""One-vs-rest multi-class SVM: K binary heads over one X.

The port of `tpusvm/models/ovr.py`:
  - solver="pair", batched=True (the default): the K heads run in
    lockstep in one pair solve with a leading class axis
    (solver/smo.py:smo_solve_batched), each head predicated on its own
    status, one K-row refresh launch a step for all 2K rows; each head's
    result equals its solo smo_solve run bit for bit;
  - solver="pair", batched=False: the heads one after another;
  - solver="blocked": each head's blocked solve in turn, sharing one
    sq_norms pass over X;
  - prediction: one K(test, SV union) matrix times the (K, n_sv)
    coefficients; the class is the argmax of the K scores.
The fleet solver and the class-parallel mesh are not ported yet.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from tpusvm_torch import kernels
from tpusvm_torch.config import SVMConfig, refuse_approx, resolve_accum_dtype
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device
from tpusvm_torch.models.serialization import load_model, save_model
from tpusvm_torch.models.svm import scores, solve
from tpusvm_torch.solver.smo import smo_solve_batched
from tpusvm_torch.status import Status


class OneVsRestSVC:
    """K-class SVM as K one-vs-rest binary SVMs (any exact family).

    Attributes after fit: classes_, X_sv_ (the union of the heads' SVs),
    coef_ (K, n_sv) alpha*y, sv_ids_, b_ (K,), n_iter_ (K,), statuses_
    (K,), train_time_s_, results_ (the solver results).
    """

    def __init__(self, config: SVMConfig = SVMConfig(), scale: bool = True,
                 batched: Optional[bool] = None, accum_dtype="auto",
                 solver: str = "pair", solver_opts: Optional[dict] = None,
                 class_parallel: bool = False, device="cuda"):
        if solver == "fleet":
            raise NotImplementedError(
                "solver='fleet' (every head in one batched blocked launch) "
                "is not ported yet (ROADMAP Queue 1 item 8)")
        if solver not in ("pair", "blocked"):
            raise ValueError(f"solver must be pair|blocked|fleet, got "
                             f"{solver!r}")
        if class_parallel:
            raise NotImplementedError(
                "class_parallel=True (the class axis sharded over a device "
                "mesh) is not ported yet (ROADMAP Queue 1 item 9)")
        if solver == "blocked" and batched:
            warnings.warn(
                "batched=True has no effect with solver='blocked' "
                "(per-class sequential solves)", UserWarning, stacklevel=2)
        refuse_approx(config.kernel)
        self.config = config
        self.scale = scale
        self.batched = batched if batched is not None else solver == "pair"
        self.accum_dtype = accum_dtype
        self.solver = solver
        self.solver_opts = dict(solver_opts or {})
        self.device = device
        self.scaler_: Optional[MinMaxScaler] = None
        self.classes_: Optional[np.ndarray] = None
        self.X_sv_: Optional[np.ndarray] = None
        self.coef_: Optional[np.ndarray] = None
        self.sv_ids_: Optional[np.ndarray] = None
        self.b_: Optional[np.ndarray] = None
        self.n_iter_: Optional[np.ndarray] = None
        self.statuses_: Optional[np.ndarray] = None
        self.train_time_s_: float = 0.0
        self.results_ = None

    @property
    def sv_X_(self):
        # the name the shared scoring helper reads
        return self.X_sv_

    def fit(self, X: np.ndarray, labels: np.ndarray) -> "OneVsRestSVC":
        dev = resolve_device(self.device)
        cfg = self.config
        t0 = time.perf_counter()
        X = np.asarray(X)
        labels = np.asarray(labels)
        self.classes_ = np.unique(labels)
        Ys = np.stack([np.where(labels == c, 1, -1).astype(np.int32)
                       for c in self.classes_])  # (K, n)
        if self.scale:
            self.scaler_ = MinMaxScaler().fit(X)
            Xs = self.scaler_.transform(X)
        else:
            Xs = X
        if "shrink_every" in self.solver_opts:
            raise ValueError(
                "shrink_every supports binary and svr training; the JAX "
                "package's one-vs-rest does not route it either")
        Xd = torch.as_tensor(np.asarray(Xs, np.float32), device=dev)
        if self.solver == "pair" and self.batched:
            res = smo_solve_batched(
                Xd, torch.as_tensor(Ys, device=dev), C=cfg.C, gamma=cfg.gamma,
                eps=cfg.eps, tau=cfg.tau, max_iter=cfg.max_iter,
                accum_dtype=resolve_accum_dtype(self.accum_dtype),
                kernel=cfg.kernel, degree=cfg.degree, coef0=cfg.coef0,
                device=dev, **self.solver_opts)
            self.results_ = res
            alphas = res.alpha.numpy()
            bs = res.b.numpy()
            iters = res.n_iter.numpy()
            statuses = res.status.numpy()
        else:
            kw = {}
            if self.solver == "blocked":
                # the heads share X: one norms pass for all of them
                kw["sn"] = kernels.sq_norms_for(cfg.kernel, Xd)
            outs = [solve(self.solver, Xd, torch.as_tensor(y, device=dev),
                          cfg, self.accum_dtype, self.solver_opts, dev, **kw)
                    for y in Ys]
            self.results_ = outs
            alphas = np.stack([o.alpha.cpu().numpy() for o in outs])
            bs = np.asarray([float(o.b) for o in outs])
            iters = np.asarray([int(o.n_iter) for o in outs])
            statuses = np.asarray([int(o.status) for o in outs])
        self.train_time_s_ = time.perf_counter() - t0

        # keep only the union of support vectors across classes
        is_sv = (alphas > cfg.sv_tol).any(axis=0)
        sv_idx = np.nonzero(is_sv)[0]
        alphas_sv = np.where(alphas[:, sv_idx] > cfg.sv_tol,
                             alphas[:, sv_idx], 0.0)
        self.X_sv_ = Xs[sv_idx]
        self.coef_ = alphas_sv * Ys[:, sv_idx]
        self.sv_ids_ = sv_idx.astype(np.int32)
        self.b_ = bs
        self.n_iter_ = iters
        self.statuses_ = statuses
        not_conv = [(int(c), Status(int(s)).name)
                    for c, s in zip(self.classes_, statuses)
                    if s != Status.CONVERGED]
        if not_conv:
            warnings.warn(
                f"per-class SMO did not converge for {not_conv}; those "
                "classifiers may be partially optimised",
                RuntimeWarning, stacklevel=2)
        return self

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        """(m, K) one-vs-rest scores from one kernel matrix."""
        if self.X_sv_ is None:
            raise RuntimeError("model is not fitted")
        return scores(self, self.coef_.T, self.b_, X)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.classes_[np.argmax(self.decision_function(X), axis=1)]

    def score(self, X: np.ndarray, labels: np.ndarray) -> float:
        return float((self.predict(X) == np.asarray(labels)).mean())

    def save(self, path: str) -> None:
        if self.X_sv_ is None:
            raise RuntimeError("model is not fitted")
        state = {
            "classes": self.classes_,
            "sv_X": self.X_sv_,
            "coef": self.coef_,
            "b": self.b_,
            "scale": self.scale,
        }
        if self.sv_ids_ is not None:
            state["sv_ids"] = self.sv_ids_
        if self.scale:
            state["scaler_min"] = self.scaler_.min_val
            state["scaler_max"] = self.scaler_.max_val
        save_model(path, state, self.config)

    @classmethod
    def load(cls, path: str, device="cuda") -> "OneVsRestSVC":
        state, config = load_model(path)
        model = cls(config=config, scale=bool(state["scale"]), device=device)
        model.classes_ = state["classes"]
        model.X_sv_ = state["sv_X"]
        model.coef_ = state["coef"]
        model.sv_ids_ = state["sv_ids"] if "sv_ids" in state else None
        model.b_ = state["b"]
        if model.scale:
            model.scaler_ = MinMaxScaler(min_val=state["scaler_min"],
                                         max_val=state["scaler_max"])
        return model
