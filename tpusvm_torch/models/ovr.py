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
  - solver="fleet": every head in one lockstep fleet solve
    (fleet/solve.py:fleet_train, the problem-axis launches of kernels #2
    and #1), sharing the sq_norms pass; each head's result equals its
    solo blocked solve's on the same knobs;
  - prediction: one K(test, SV union) matrix times the (K, n_sv)
    coefficients; the class is the argmax of the K scores.
The approximate families (rff, nystrom) map ONCE for all heads, on the
card: the K problems share Phi(X) as they share X, and every solver mode
above runs the linear path over it. The class-parallel mesh is not ported
yet.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from tpusvm_torch import kernels
from tpusvm_torch.config import SVMConfig, is_approx_family, resolve_accum_dtype
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device
from tpusvm_torch.models.serialization import load_model, save_model
from tpusvm_torch.models.svm import load_map, scores, solve
from tpusvm_torch.solver.smo import smo_solve_batched
from tpusvm_torch.status import Status


class OneVsRestSVC:
    """K-class SVM as K one-vs-rest binary SVMs (any kernel family).

    Attributes after fit: classes_, X_sv_ (the union of the heads' SVs),
    coef_ (K, n_sv) alpha*y, sv_ids_, b_ (K,), n_iter_ (K,), statuses_
    (K,), train_time_s_, results_ (the solver results), fleet_stats_
    (solver="fleet": the fleet's rounds, lane rounds, bucket rounds and
    host syncs, fleet/solve.py:fleet_train).
    """

    def __init__(self, config: SVMConfig = SVMConfig(), scale: bool = True,
                 batched: Optional[bool] = None, accum_dtype="auto",
                 solver: str = "pair", solver_opts: Optional[dict] = None,
                 class_parallel: bool = False, device="cuda"):
        if solver not in ("pair", "blocked", "fleet"):
            raise ValueError(f"solver must be pair|blocked|fleet, got "
                             f"{solver!r}")
        if class_parallel:
            raise NotImplementedError(
                "class_parallel=True (the class axis sharded over a device "
                "mesh) is not ported yet (ROADMAP Queue 1 item 9(ii))")
        if solver == "blocked" and batched:
            warnings.warn(
                "batched=True has no effect with solver='blocked' "
                "(per-class sequential solves)", UserWarning, stacklevel=2)
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
        self.fleet_stats_: dict = {}
        # approximate families: the map and the raw input width (X_sv_
        # then holds MAPPED rows)
        self.fmap_ = None
        self.n_features_in_: Optional[int] = None

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
        if is_approx_family(cfg.kernel):
            # one map for all heads, fitted on the host, applied on the card
            from tpusvm_torch.approx import build_map

            self.n_features_in_ = int(np.asarray(Xs).shape[1])
            self.fmap_ = build_map(cfg, X_scaled=np.asarray(Xs))
            Xd = self.fmap_.transform(Xd)
        if self.solver == "fleet":
            self.fleet_stats_ = {}
            # one lockstep fleet trains every head: the K problems share X
            # (and the hoisted norms) and differ only in labels
            from tpusvm_torch.fleet import fleet_train

            K = Ys.shape[0]
            outs = fleet_train(
                Xd, list(Ys), [cfg.C] * K, [cfg.gamma] * K,
                sn=kernels.sq_norms_for(cfg.kernel, Xd), eps=cfg.eps,
                tau=cfg.tau, max_iter=cfg.max_iter, kernel=cfg.kernel,
                degree=cfg.degree, coef0=cfg.coef0,
                accum_dtype=resolve_accum_dtype(self.accum_dtype),
                stats=self.fleet_stats_, device=dev, **self.solver_opts)
            self.results_ = outs
            alphas = np.stack([o.alpha.cpu().numpy() for o in outs])
            bs = np.asarray([float(o.b) for o in outs])
            iters = np.asarray([int(o.n_iter) for o in outs])
            statuses = np.asarray([int(o.status) for o in outs])
        elif self.solver == "pair" and self.batched:
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
        if self.fmap_ is not None:
            self.X_sv_ = Xd[torch.as_tensor(sv_idx, device=dev)].cpu().numpy()
        else:
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
        if self.fmap_ is not None:
            state.update(self.fmap_.state_entries())
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
        load_map(model, state, config)
        return model
