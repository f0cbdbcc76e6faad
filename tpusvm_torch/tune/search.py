"""The tune driver: fold x point scheduling, shared caches, warm chaining.

The port of tpusvm/tune/search.py. Two schedules over a GridSpec:

  - "grid": every point, full training folds, in snake order (so each fit
    warm-starts from an adjacent solved point), with optional plateau
    early-stopping;
  - "halving": successive halving over data-subset rungs (Li et al. 2018,
    Hyperband's inner loop): all points are fit on a small stratified
    subset first, the best 1/eta survive to an eta-times-larger subset,
    repeating until the full fold. Rung subsets are nested prefixes of
    each fold's fixed shuffled row order, which makes a point's
    previous-rung solution a valid (zero-padded) warm seed for its next
    rung.

Per fold, the scaled training rows, their row norms (sq_norms) and the
scaled validation side are computed once, on the device, and reused by
every fit and evaluation at every grid point and rung (rung subsets are
prefix slices, so the norms are shared too). Every rung uses one subset
size across folds (the minimum of the per-fold cap). fleet=True runs a
rung's points as one fleet_train a fold (fleet/solve.py: the problem-axis
launches of kernels #2 and #1 on the card), the points differing only in
(C, gamma).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tpusvm_torch import kernels as _kernels
from tpusvm_torch.config import SVMConfig, resolve_accum_dtype, resolve_dtype
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device, to_dtype, to_numpy
from tpusvm_torch.ops.rbf import coef_matvec, sq_norms
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.status import Status, TuneStatus
from tpusvm_torch.tune.folds import Fold, stratified_kfold
from tpusvm_torch.tune.grid import GridSpec
from tpusvm_torch.tune.results import TuneResult
from tpusvm_torch.tune.warm import WarmStore


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Search-level knobs (the per-point SVM hyperparameters come from the
    grid; numerical tolerances from the base SVMConfig passed to tune()).

    Attributes:
      folds: stratified CV fold count k (>= 2).
      seed: fold-split / rung-subset shuffle seed — the whole run is a
        pure function of (data, grid, config), so cold/warm A/Bs compare
        identical problems.
      schedule: "grid" or "halving".
      eta: halving aggressiveness — rung subsets grow by eta, the best
        ceil(1/eta) fraction of points survives each rung (>= 2).
      min_rung: smallest rung subset size (halving); rungs run
        min_rung, min_rung*eta, ..., full fold.
      warm_start: seed each fit from the nearest solved neighbour /
        previous rung (tune/warm.py); False = every fit cold — the
        benchmark's control arm.
      patience: grid schedule only — stop the sweep after this many
        consecutive points that fail to improve the best CV accuracy by
        more than plateau_tol (None = sweep every point). Unvisited
        points are recorded as SKIPPED. Ignored by halving (its pruning
        already bounds the cost of bad points).
      plateau_tol: minimum improvement that resets the patience counter.
      fleet: dispatch each rung's point population as ONE lockstep fleet
        solve per fold (fleet/solve.py) instead of per-point sequential
        fits — the B grid points share the fold's scaled X (and its
        cached norms), differing only in (C, gamma), which is exactly
        the fleet's problem axis. Warm seeding still works across RUNGS (a
        point's previous-rung solution seeds its next-rung lane), but
        not across points WITHIN a rung — the rung solves concurrently,
        so there is no "already-solved neighbour" to borrow from;
        expect slightly more updates per rung in exchange for the
        batched launch. Incompatible with patience (a plateau stop is a
        sequential notion). The sequential dispatch path remains the
        default and is what --no-fleet selects from the CLI.
      fleet_compact: fleet only — fleet_train's compact_every, accepted
        for the JAX signature and inert in the port (a finished lane
        already runs nothing; fleet/solve.py); >= 0.
    """

    folds: int = 3
    seed: int = 0
    schedule: str = "grid"
    eta: int = 3
    min_rung: int = 256
    warm_start: bool = True
    patience: Optional[int] = None
    plateau_tol: float = 0.0
    fleet: bool = False
    fleet_compact: int = 0

    def __post_init__(self):
        if self.schedule not in ("grid", "halving"):
            raise ValueError(
                f"schedule must be grid|halving, got {self.schedule!r}"
            )
        if self.folds < 2:
            raise ValueError(f"folds must be >= 2, got {self.folds}")
        if self.eta < 2:
            raise ValueError(f"eta must be >= 2, got {self.eta}")
        if self.min_rung < 2:
            raise ValueError(f"min_rung must be >= 2, got {self.min_rung}")
        if self.patience is not None and self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if self.fleet and self.patience is not None:
            raise ValueError(
                "fleet=True fits a whole rung's points in one batched "
                "launch; patience (a sequential plateau stop) cannot "
                "apply — drop one of the two"
            )
        if self.fleet_compact < 0:
            raise ValueError(
                f"fleet_compact must be >= 0, got {self.fleet_compact}"
            )


class _FoldCache:
    """Per-fold shared artifacts: scaled X (train fold order / val) on the
    device in the search's dtype, row norms, labels. Built once; every grid
    point's fit and eval reuse the same tensors, and rung subsets are
    prefix slices (so even the norms cache is shared across rungs).

    rows_fn(indices) -> (len(indices), d) raw feature rows — a slice of
    the in-memory array, or stream.gather_rows against a sharded dataset
    (which loads only the shards carrying the fold's rows); the cache is
    agnostic to where the bytes come from."""

    def __init__(self, rows_fn, Y: np.ndarray, fold: Fold, dtype,
                 scale: bool, device):
        Xtr = rows_fn(fold.train_idx)
        Xval = rows_fn(fold.val_idx)
        if scale:
            scaler = MinMaxScaler().fit(Xtr)
            Xtr = scaler.transform(Xtr)
            Xval = scaler.transform(Xval)
        self.Xtr = to_dtype(Xtr, dtype).to(device)
        self.Ytr = torch.as_tensor(Y[fold.train_idx], device=device)
        self.Ytr_host = np.asarray(Y[fold.train_idx])
        self.sn = sq_norms(self.Xtr)          # one X stream, whole sweep
        self.Xval = to_dtype(Xval, dtype).to(device)
        self.sn_val = sq_norms(self.Xval)
        self.Yval = np.asarray(Y[fold.val_idx])
        self.n_train = len(fold.train_idx)


def _rung_sizes(n_full: int, min_rung: int, eta: int) -> List[int]:
    if min_rung >= n_full:
        return [n_full]
    sizes = []
    s = min_rung
    while s < n_full:
        sizes.append(s)
        s *= eta
    sizes.append(n_full)
    return sizes


def _point_row(C: float, gamma: float, spec: Dict[str, Any]
               ) -> Dict[str, Any]:
    return {
        "C": C, "gamma": gamma, "kernel": spec["kernel"],
        "degree": spec["degree"], "coef0": spec["coef0"],
        "status": TuneStatus.SKIPPED.name,
        "rung": -1, "n_subset": 0, "cv_accuracy": None,
        "fold_accuracy": [], "sv_count": None, "n_updates": 0,
        "wall_s": 0.0, "warm_seeded": 0,
    }


def normalize_kernel_specs(kernel_specs, base: SVMConfig) -> List[Dict[str, Any]]:
    """Kernel-family search axis -> full {kernel, degree, coef0} dicts.

    Accepts None (search only the base config's family), bare family
    names, or partial dicts; degree/coef0 default from the base config.
    Duplicate fully-resolved specs are rejected (they would silently
    double the search cost and make the winner tie-break order-dependent).
    """
    if kernel_specs is None:
        kernel_specs = [base.kernel]
    out = []
    for spec in kernel_specs:
        if isinstance(spec, str):
            spec = {"kernel": spec}
        family = _kernels.validate_family(spec.get("kernel", base.kernel))
        if _kernels.is_approx(family):
            # the JAX package's refusal: tune sweeps gamma over shared
            # fold caches, but an approx family bakes gamma into its
            # feature map, so every gamma cell would need its own mapped
            # fold caches and warm store
            raise ValueError(
                f"tune does not search approximate kernel families "
                f"({family!r}): gamma parameterises the feature map "
                "itself (approx/), so the shared-fold-cache "
                "(C, gamma) sweep cannot apply; tune the exact 'rbf' "
                "family and train the chosen (C, gamma) with "
                f"kernel={family!r}, or sweep approx fits explicitly "
                "with benchmarks/approx_scale.py"
            )
        resolved = {
            "kernel": family,
            "degree": int(spec.get("degree", base.degree)),
            "coef0": float(spec.get("coef0", base.coef0)),
        }
        if resolved in out:
            raise ValueError(f"duplicate kernel spec {resolved}")
        out.append(resolved)
    return out


def tune(
    X: Optional[np.ndarray],
    Y: Optional[np.ndarray],
    grid: GridSpec,
    config: TuneConfig = TuneConfig(),
    *,
    base: SVMConfig = SVMConfig(),
    dtype=torch.float32,
    accum_dtype="auto",
    scale: bool = True,
    solver_opts: Optional[dict] = None,
    log_fn: Optional[Callable[[str], None]] = None,
    dataset=None,
    tracer=None,
    kernels=None,
    device="cuda",
) -> TuneResult:
    """Cross-validated search over `grid` (x kernel families); returns the
    TuneResult table.

    base: numerical-tolerance donor (tau/eps/sv_tol/max_iter); its C and
    gamma are ignored — the grid supplies those per point. Fits use the
    blocked solver with the fold's cached row norms; extra static knobs
    (q, max_inner, ...) pass through solver_opts.

    kernels: optional kernel-family search axis — a list of family names
    or {kernel, degree, coef0} dicts (normalize_kernel_specs; None =
    search only base.kernel). Each family runs the full (C, gamma)
    schedule over the SAME fold caches (scaled X / norms / labels are
    kernel-independent, so the per-fold setup is paid once for the whole
    matrix) with its OWN warm-start store — duals do not transfer across
    kernel geometries — and the winner is the global cv_accuracy argmax,
    carrying its kernel/degree/coef0 alongside C and gamma.

    dataset: a stream.ShardedDataset used INSTEAD of (X, Y) — pass None
    for both. Folds are computed from a labels-only manifest pass
    (identical splits to the in-memory path: stratified_kfold is a pure
    function of (Y, k, seed)), and each fold cache gathers only its own
    rows, shard by shard (stream.gather_rows), so the monolithic array is
    never materialised — peak residency is the fold caches plus one shard.

    dtype: the feature dtype of the fold caches (float32, bfloat16,
    float64). device: where the fold caches live and every fit runs
    ("cuda" unless the caller asks for "cpu").

    tracer: an obs.trace.Tracer; every scored point then lands as a
    `tune.point` event (C, gamma, rung, subset size, CV accuracy, update
    count, warm-seed count) and the winner as `tune.winner`: the search
    trajectory in the run's one trace file.
    """
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if dataset is not None:
        if X is not None or Y is not None:
            raise ValueError("tune: pass (X, Y) or dataset=, not both")
        from tpusvm_torch.stream.assign import gather_rows

        Y = dataset.load_labels()
        n_rows, n_feat = dataset.n_rows, dataset.n_features

        def rows_fn(idx):
            return gather_rows(dataset, idx)
    else:
        X = np.asarray(X)
        Y = np.asarray(Y)
        n_rows, n_feat = X.shape

        def rows_fn(idx):
            return X[idx]
    accum = resolve_accum_dtype(accum_dtype)
    opts = dict(solver_opts or {})
    say = log_fn or (lambda msg: None)
    t_run = time.perf_counter()

    folds = stratified_kfold(Y, config.folds, seed=config.seed)
    caches = [_FoldCache(rows_fn, Y, f, dtype, scale, dev) for f in folds]
    # uniform rung cap: one subset size a rung across the folds, as JAX
    n_full = min(c.n_train for c in caches)
    points = grid.points()
    specs = normalize_kernel_specs(kernels, base)
    all_rows: List[Dict[str, Any]] = []

    def run_family(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One kernel family's full (C, gamma) schedule over the shared
        fold caches, with its own warm store."""
        rows = [_point_row(C, g, spec) for C, g in points]
        store = WarmStore()
        rbf = spec["kernel"] == "rbf"
        kern = dict(kernel=spec["kernel"], degree=spec["degree"],
                    coef0=spec["coef0"])

        def seeds_for(pi: int, m: int) -> List[Optional[np.ndarray]]:
            """Per-fold warm seeds for one point (None entries = cold)."""
            if not config.warm_start:
                return [None] * len(caches)
            C = points[pi][0]
            return [store.seed(fi, points[pi], m, c.Ytr_host[:m], C)
                    for fi, c in enumerate(caches)]

        def fit_point(pi: int, m: int, rung: int) -> Dict[str, Any]:
            """All k fold fits of one point at rung size m: seeds first,
            then every solve dispatched, then one materialisation pass."""
            C, gamma = points[pi]
            t0 = time.perf_counter()
            seeds = seeds_for(pi, m)
            results = []
            for c, seed in zip(caches, seeds):
                alpha0 = None if seed is None else torch.as_tensor(
                    seed).to(accum or dtype)
                results.append(blocked_smo_solve(
                    c.Xtr[:m], c.Ytr[:m], alpha0=alpha0,
                    warm_start=seed is not None,
                    # the norms cache only exists for the RBF family
                    sn=c.sn[:m] if rbf else None,
                    C=C, gamma=gamma, eps=base.eps, tau=base.tau,
                    max_iter=base.max_iter, accum_dtype=accum, **kern,
                    device=dev, **opts,
                ))
            return score_point(pi, m, rung, results, seeds,
                               time.perf_counter() - t0)

        def fit_points_fleet(pis: List[int], m: int,
                             rung: int) -> List[Dict[str, Any]]:
            """One rung's whole point population, one fleet solve per
            fold: the B points share the fold's scaled rows and cached
            norms and differ only in (C, gamma) — exactly the fleet's
            problem axis (fleet/solve.py). Seeds are queried BEFORE the
            launches (previous rungs only — the rung solves
            concurrently, so same-rung neighbour seeding cannot
            happen); the launch wall is attributed evenly across the
            rung's points."""
            from tpusvm_torch import fleet

            t0 = time.perf_counter()
            seeds = {pi: seeds_for(pi, m) for pi in pis}
            Cs = [points[pi][0] for pi in pis]
            gs = [points[pi][1] for pi in pis]
            fold_results = []
            for fi, c in enumerate(caches):
                al0 = [seeds[pi][fi] for pi in pis]
                outs = fleet.fleet_train(
                    c.Xtr[:m], [c.Ytr_host[:m]] * len(pis), Cs, gs,
                    alpha0s=(al0 if any(a is not None for a in al0)
                             else None),
                    sn=c.sn[:m] if rbf else None,
                    compact_every=config.fleet_compact,
                    eps=base.eps, tau=base.tau, max_iter=base.max_iter,
                    accum_dtype=accum, **kern, device=dev, **opts,
                )
                fold_results.append(outs)
            solve_share = (time.perf_counter() - t0) / max(1, len(pis))
            return [
                score_point(pi, m, rung,
                            [fold_results[fi][j]
                             for fi in range(len(caches))],
                            seeds[pi], solve_share)
                for j, pi in enumerate(pis)
            ]

        def score_point(pi: int, m: int, rung: int, results, seeds,
                        solve_s: float) -> Dict[str, Any]:
            """Materialise + score one point's fold results into its row
            (shared by the sequential and fleet dispatch paths)."""
            C, gamma = points[pi]
            row = rows[pi]
            t_eval = time.perf_counter()
            accs, svs, updates = [], [], 0
            for fi, (c, res) in enumerate(zip(caches, results)):
                alpha = to_numpy(res.alpha)  # completion barrier
                store.record(fi, points[pi], alpha)
                coef = to_dtype(alpha * c.Ytr_host[:m], dtype).to(dev)
                K_val = _kernels.cross(
                    spec["kernel"], c.Xval, c.Xtr[:m], gamma=gamma,
                    coef0=spec["coef0"], degree=spec["degree"],
                    snA=c.sn_val if rbf else None,
                    snB=c.sn[:m] if rbf else None,
                )
                scores = to_numpy(coef_matvec(K_val, coef)
                              - to_dtype(float(res.b), dtype).to(dev))
                pred = np.where(scores > 0, 1, -1)
                accs.append(float((pred == c.Yval).mean()))
                svs.append(int((alpha > base.sv_tol).sum()))
                updates += int(res.n_iter) - 1
                status = Status(int(res.status))
                if status not in (Status.CONVERGED, Status.NO_WORKING_SET):
                    say(f"tune: point (C={C:g}, gamma={gamma:g}, "
                        f"kernel={spec['kernel']}) fold {fi} "
                        f"ended {status.name}")
            wall = solve_s + (time.perf_counter() - t_eval)
            row.update(
                rung=rung, n_subset=m,
                cv_accuracy=float(np.mean(accs)), fold_accuracy=accs,
                sv_count=float(np.mean(svs)),
                n_updates=row["n_updates"] + updates,
                wall_s=row["wall_s"] + wall,
                warm_seeded=row["warm_seeded"]
                + sum(s is not None for s in seeds),
            )
            if tracer is not None:
                tracer.event(
                    "tune.point", C=C, gamma=gamma, rung=rung, n_subset=m,
                    kernel=spec["kernel"],
                    cv_accuracy=row["cv_accuracy"], n_updates=updates,
                    warm_seeded=sum(s is not None for s in seeds),
                    wall_s=wall,
                )
            return row

        if config.schedule == "grid":
            if config.fleet:
                # the whole grid is one rung: one fleet launch per fold
                # trains every point's fit together (patience is
                # rejected by TuneConfig — there is no sequential sweep
                # to stop early)
                for row in fit_points_fleet(list(range(len(points))),
                                            n_full, rung=0):
                    row["status"] = TuneStatus.EVALUATED.name
                    say(f"tune: [{spec['kernel']}] C={row['C']:g} "
                        f"gamma={row['gamma']:g} "
                        f"cv={row['cv_accuracy']:.4f} "
                        f"updates={row['n_updates']} (fleet)")
            else:
                best = -np.inf
                since_improve = 0
                for pi in range(len(points)):
                    row = fit_point(pi, n_full, rung=0)
                    row["status"] = TuneStatus.EVALUATED.name
                    say(f"tune: [{spec['kernel']}] C={row['C']:g} "
                        f"gamma={row['gamma']:g} "
                        f"cv={row['cv_accuracy']:.4f} "
                        f"updates={row['n_updates']} "
                        f"warm={row['warm_seeded']}/{config.folds}")
                    if row["cv_accuracy"] > best + config.plateau_tol:
                        best = row["cv_accuracy"]
                        since_improve = 0
                    else:
                        since_improve += 1
                    if config.patience and since_improve >= config.patience:
                        say(f"tune: plateau after {pi + 1}/{len(points)} "
                            f"points (no improvement in {since_improve})")
                        break
        else:
            survivors = list(range(len(points)))
            sizes = _rung_sizes(n_full, config.min_rung, config.eta)
            for rung, m in enumerate(sizes):
                last = rung == len(sizes) - 1
                if config.fleet:
                    # the rung's surviving points as one fleet launch
                    # per fold — previous-rung seeds still apply (each
                    # lane warm-starts from ITS OWN last solution)
                    fit_points_fleet(survivors, m, rung=rung)
                else:
                    for pi in survivors:
                        fit_point(pi, m, rung=rung)
                say(f"tune: [{spec['kernel']}] rung {rung} (m={m}) "
                    f"scored {len(survivors)} points"
                    + (" (fleet)" if config.fleet else ""))
                # rank: best CV accuracy first, solve order breaks ties
                # deterministically
                ranked = sorted(
                    survivors,
                    key=lambda pi: (-rows[pi]["cv_accuracy"], pi),
                )
                if last:
                    for pi in survivors:
                        rows[pi]["status"] = TuneStatus.EVALUATED.name
                else:
                    keep = max(1, -(-len(survivors) // config.eta))
                    for pi in ranked[keep:]:
                        rows[pi]["status"] = TuneStatus.PRUNED.name
                    survivors = sorted(ranked[:keep])
        return rows

    for spec in specs:
        all_rows.extend(run_family(spec))

    evaluated = [r for r in all_rows
                 if r["status"] == TuneStatus.EVALUATED.name]
    if not evaluated:  # unreachable: both schedules evaluate >= 1 point
        raise RuntimeError("tune evaluated no grid points")
    win = max(evaluated, key=lambda r: r["cv_accuracy"])  # first max wins
    winner = {"C": win["C"], "gamma": win["gamma"],
              "kernel": win["kernel"], "degree": win["degree"],
              "coef0": win["coef0"],
              "cv_accuracy": win["cv_accuracy"]}
    say(f"tune: winner kernel={win['kernel']} C={win['C']:g} "
        f"gamma={win['gamma']:g} cv={win['cv_accuracy']:.4f}")
    if tracer is not None:
        tracer.event("tune.winner", **winner)
    return TuneResult(
        fleet=config.fleet,
        schedule=config.schedule,
        grid={"C_values": list(grid.C_values),
              "gamma_values": list(grid.gamma_values)},
        folds=config.folds,
        seed=config.seed,
        n=int(n_rows),
        d=int(n_feat),
        warm_start=config.warm_start,
        kernels=specs,
        points=all_rows,
        winner=winner,
        total_updates=int(sum(r["n_updates"] for r in all_rows)),
        wall_s=time.perf_counter() - t_run,
    )
