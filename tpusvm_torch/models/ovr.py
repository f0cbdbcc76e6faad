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
  - solver="pair", class_parallel=True: the class axis split over a 1-D
    mesh (parallel/mesh.py). The K label rows are padded to a multiple of
    the mesh size with all-negative dummy rows (an empty I_high: they end
    NO_WORKING_SET at once and are dropped), and each member runs the
    lockstep solver on its contiguous slice on its device: members on
    different cards in one host thread each, members on one device one
    after another. fit(group=) makes this process one rank of a
    torch.distributed group instead: each rank solves its slice on
    rank_device(device, rank) and an all_gather gives every rank every
    head. Each head equals its batched=True head bit for bit, whatever
    the partition (a head's steps read its own row alone);
  - prediction: one K(test, SV union) matrix times the (K, n_sv)
    coefficients; the class is the argmax of the K scores; a mesh splits
    the test rows over its members.
The approximate families (rff, nystrom) map ONCE for all heads, on the
card: the K problems share Phi(X) as they share X, and every solver mode
above runs the linear path over it.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from tpusvm_torch import kernels
from tpusvm_torch.config import (SVMConfig, is_approx_family,
                                 resolve_accum_dtype, resolve_dtype)
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device, to_dtype, to_numpy
from tpusvm_torch.models.serialization import load_model, save_model
from tpusvm_torch.models.svm import load_map, scores, solve
from tpusvm_torch.solver.smo import BatchedSMOResult, smo_solve_batched
from tpusvm_torch.status import Status


class OneVsRestSVC:
    """K-class SVM as K one-vs-rest binary SVMs (any kernel family).

    Attributes after fit: classes_, X_sv_ (the union of the heads' SVs),
    coef_ (K, n_sv) alpha*y, sv_ids_, b_ (K,), n_iter_ (K,), statuses_
    (K,), train_time_s_, results_ (the solver results), fleet_stats_
    (solver="fleet": the fleet's rounds, lane rounds, bucket rounds and
    host syncs, fleet/solve.py:fleet_train), class_mesh_ (class_parallel:
    the mesh the fit ran over, {"axes", "shape", "processes", "devices"}).

    class_parallel=True (pair solver only) splits the class axis over
    `mesh`: a parallel/mesh.py Mesh or a list of devices; None means every
    visible card, capped at K (["cpu"] with device="cpu"). dtype: the
    feature dtype (BinarySVC's).
    """

    def __init__(self, config: SVMConfig = SVMConfig(), scale: bool = True,
                 batched: Optional[bool] = None, accum_dtype="auto",
                 solver: str = "pair", solver_opts: Optional[dict] = None,
                 class_parallel: bool = False, device="cuda", mesh=None,
                 dtype=torch.float32):
        if solver not in ("pair", "blocked", "fleet"):
            raise ValueError(f"solver must be pair|blocked|fleet, got "
                             f"{solver!r}")
        if class_parallel and solver != "pair":
            # the JAX package's rule and text
            raise ValueError(
                "class_parallel=True requires solver='pair' (the vmapped "
                "lockstep solver BASELINE config 5 names); the blocked "
                "solver trains classes sequentially and the fleet solver "
                "is already one single-launch batched program (sharding "
                "a fleet over the mesh is a future PR)"
            )
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
        self.class_parallel = class_parallel
        self.mesh = mesh
        self.dtype = resolve_dtype(dtype)
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
        self.class_mesh_: Optional[dict] = None

    @property
    def sv_X_(self):
        # the name the shared scoring helper reads
        return self.X_sv_

    def fit(self, X: np.ndarray, labels: np.ndarray,
            group=None, warm_seeds: Optional[np.ndarray] = None
            ) -> "OneVsRestSVC":
        """Fit the K one-vs-rest heads. group (class_parallel only): a
        torch.distributed group (parallel.init_group); every rank calls fit
        with the same data, solves its slice of the heads and ends with
        all of them. warm_seeds: optional (K, n) per-head alpha0 seeds
        (already feasible per head, tune.warm.deployed_seed_ovr), the
        one-vs-rest refresh's warm start; blocked solver only (the pair
        lockstep and the fleet take no per-head seeds)."""
        if warm_seeds is not None and self.solver != "blocked":
            raise ValueError(
                "warm_seeds requires solver='blocked' (per-head "
                f"sequential solves); got solver={self.solver!r}")
        if group is not None and not self.class_parallel:
            raise ValueError("group= splits the class axis over rank "
                             "processes; it needs class_parallel=True")
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
        Xd = to_dtype(Xs, self.dtype).to(dev)
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
            alphas, bs, iters, statuses = _stack(outs)
        elif self.solver == "pair" and (self.batched or self.class_parallel):
            res = (self._fit_class_parallel(Xd, Ys, group)
                   if self.class_parallel else self._lockstep(Xd, Ys, dev))
            self.results_ = res
            alphas, bs, iters, statuses = (
                to_numpy(t) for t in (res.alpha, res.b, res.n_iter, res.status))
        else:
            kw = {}
            if self.solver == "blocked":
                # the heads share X: one norms pass for all of them
                kw["sn"] = kernels.sq_norms_for(cfg.kernel, Xd)
            if warm_seeds is not None:
                warm_seeds = np.asarray(warm_seeds, np.float64)
                if warm_seeds.shape != Ys.shape:
                    raise ValueError(
                        f"warm_seeds shape {warm_seeds.shape} != (K, n) = "
                        f"{Ys.shape}")
            outs = []
            for k, y in enumerate(Ys):
                seed = {}
                if warm_seeds is not None and warm_seeds[k].any():
                    # an all-zero seed is a cold start: no f rebuild; a
                    # seeded head's kernel rounds are held to [0, C]
                    # (serve/refresh.py:_seeded)
                    seed = {"alpha0": warm_seeds[k], "warm_start": True,
                            "_seed_in_box": True}
                outs.append(solve(self.solver, Xd,
                                  torch.as_tensor(y, device=dev), cfg,
                                  self.accum_dtype, self.solver_opts, dev,
                                  **kw, **seed))
            self.results_ = outs
            alphas, bs, iters, statuses = _stack(outs)
        self.train_time_s_ = time.perf_counter() - t0

        # keep only the union of support vectors across classes
        is_sv = (alphas > cfg.sv_tol).any(axis=0)
        sv_idx = np.nonzero(is_sv)[0]
        alphas_sv = np.where(alphas[:, sv_idx] > cfg.sv_tol,
                             alphas[:, sv_idx], 0.0)
        if self.fmap_ is not None:
            self.X_sv_ = to_numpy(Xd[torch.as_tensor(sv_idx, device=dev)])
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

    def _lockstep(self, X: torch.Tensor, Ys: np.ndarray,
                  device) -> BatchedSMOResult:
        """The heads Ys (k, n) in one lockstep pair solve on `device`."""
        cfg = self.config
        return smo_solve_batched(
            X.to(device), torch.as_tensor(Ys, device=device), C=cfg.C,
            gamma=cfg.gamma, eps=cfg.eps, tau=cfg.tau, max_iter=cfg.max_iter,
            accum_dtype=resolve_accum_dtype(self.accum_dtype),
            kernel=cfg.kernel, degree=cfg.degree, coef0=cfg.coef0,
            device=device, **self.solver_opts)

    def _fit_class_parallel(self, Xd: torch.Tensor, Ys: np.ndarray,
                            group) -> BatchedSMOResult:
        """The lockstep pair solve with the class axis split over the mesh
        (or over the ranks of `group`); the heads' results in class order,
        the padding dropped."""
        from tpusvm_torch.parallel.mesh import (Mesh, as_mesh, make_mesh,
                                                require_1d_mesh)

        K, n = Ys.shape
        if group is not None:
            from tpusvm_torch.parallel.group import Exchange, rank_device

            if self.mesh is not None:
                raise ValueError(
                    "class_parallel over a process group runs one member a "
                    "rank, on rank_device(device, rank); pass mesh=None")
            ex = Exchange(group)
            mesh = Mesh(tuple(rank_device(self.device, r)
                              for r in range(ex.size)), ("classes",))
            mine = [ex.rank]
        else:
            if self.mesh is not None:
                mesh = as_mesh(self.mesh, axis="classes")
            elif Xd.device.type == "cpu":
                mesh = make_mesh(devices=["cpu"], axis="classes")
            else:
                mesh = make_mesh(min(K, torch.cuda.device_count()),
                                 axis="classes")
            mine = range(mesh.size)
        require_1d_mesh(mesh, "class_parallel")
        devices = [resolve_device(d) for d in mesh.devices]
        self.class_mesh_ = {
            "axes": tuple(mesh.axis_names),
            "shape": dict(mesh.shape),
            "processes": 1 if group is None else ex.size,
            "devices": [str(d) for d in devices],
        }
        # all-negative dummy heads: I_high is empty, so they end
        # NO_WORKING_SET at their first step and launch nothing
        pad = (-K) % mesh.size
        Ys_p = np.concatenate([Ys, -np.ones((pad, n), np.int32)])
        per = len(Ys_p) // mesh.size

        def run(js):
            # the members of one device, one after another, with that
            # device current in this thread (the pair loop's graph capture
            # and its kernel's stream follow the current device)
            d = devices[js[0]]
            with (torch.cuda.device(d) if d.type == "cuda"
                  else contextlib.nullcontext()):
                return {j: self._lockstep(Xd, Ys_p[j * per:(j + 1) * per], d)
                        for j in js}

        by_device = {}
        for j in mine:
            by_device.setdefault(str(devices[j]), []).append(j)
        groups = list(by_device.values())
        if len(groups) == 1:
            done = run(groups[0])
        else:
            done = {}
            with ThreadPoolExecutor(len(groups)) as pool:
                for fut in [pool.submit(run, js) for js in groups]:
                    done.update(fut.result())
        fields = ("alpha", "b", "b_high", "b_low", "n_iter", "status",
                  "row_refreshes")
        if group is not None:
            res = done[ex.rank]
            cat = {f: ex.gather_tensor(getattr(res, f))[:K] for f in fields}
            parts = [res]
        else:
            parts = [done[j] for j in range(mesh.size)]
            cat = {f: torch.cat([getattr(p, f) for p in parts])[:K]
                   for f in fields}
        return BatchedSMOResult(
            **cat, host_syncs=sum(p.host_syncs for p in parts),
            host_wait_s=sum(p.host_wait_s for p in parts),
            chunks=max(p.chunks for p in parts), chunk=parts[0].chunk,
            graphed=all(p.graphed for p in parts))

    def decision_function(self, X: np.ndarray, mesh=None) -> np.ndarray:
        """(m, K) one-vs-rest scores from one kernel matrix. mesh: the
        test rows split over a 1-D mesh, as BinarySVC.decision_function."""
        if self.X_sv_ is None:
            raise RuntimeError("model is not fitted")
        return scores(self, self.coef_.T, self.b_, X, mesh)

    def predict(self, X: np.ndarray, mesh=None) -> np.ndarray:
        return self.classes_[np.argmax(self.decision_function(X, mesh=mesh),
                                       axis=1)]

    def score(self, X: np.ndarray, labels: np.ndarray, mesh=None) -> float:
        return float((self.predict(X, mesh=mesh)
                      == np.asarray(labels)).mean())

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
    def load(cls, path: str, device="cuda",
             dtype=torch.float32) -> "OneVsRestSVC":
        state, config = load_model(path)
        model = cls(config=config, scale=bool(state["scale"]), device=device,
                    dtype=dtype)
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


def _stack(outs):
    """(alphas (K, n), b, n_iter, status) of the heads' solo results."""
    return (np.stack([to_numpy(o.alpha) for o in outs]),
            np.asarray([float(o.b) for o in outs]),
            np.asarray([int(o.n_iter) for o in outs]),
            np.asarray([int(o.status) for o in outs]))
