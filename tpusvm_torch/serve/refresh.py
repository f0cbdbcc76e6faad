"""`refresh`: crash-safe warm-started refits that hot-swap in.

The port of tpusvm/serve/refresh.py. Data arrives, the deployed model goes
stale; a refresh, instead of a cold retrain and a server restart:

  1. loads the DEPLOYED artifact and seeds the refit from its duals, by
     the artifact's task:
       svc  scatter (sv_ids, sv_alpha) to full length
            (tune/warm.py:deployed_seed);
       ovr  per-head |coef| scattered to the union sv_ids, projected
            feasible against each head's one-vs-rest labels
            (deployed_seed_ovr + OneVsRestSVC.fit(warm_seeds=...));
       svr  the doubled-variable inversion beta = [max(coef,0);
            max(-coef,0)] (deployed_seed_svr).
     The refresh training set must keep the deployed run's rows as a
     prefix (appended batches);
  2. runs the blocked solver (kernels #1 and #2 on the card; a seeded
     refit's kernel rounds are held to the box [0, C], as the fleet's
     seeded lanes are: `_seeded`), through
     `checkpointed_blocked_solve` when a checkpoint path is given: a
     killed refresh resumes BIT-IDENTICAL to an uninterrupted one, and an
     optional `watchdog` deadline stops a too-slow fit at a checkpointed
     segment boundary (solver/checkpoint.py:WatchdogTimeout). Binary
     classifiers only: the OvR and SVR estimators have no checkpoint
     surface and reject those flags by name;
  3. saves the result atomically (temp + os.replace: a `--watch`
     directory never sees a torn artifact);
  4. hands the artifact to the running server: in-process
     `Server.swap()`, or `POST /admin/swap` over HTTP (`--swap URL`);
     either way a failed stage leaves the old generation serving.

Approximate-family artifacts are rejected by name for every task: the
warm seed is a dual-space object.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional

import numpy as np
import torch


def _reject_approx(cfg, model_path: str) -> None:
    from tpusvm_torch.config import is_approx_family

    if is_approx_family(cfg.kernel):
        raise ValueError(
            f"refresh warm-starts the DUAL solve; {model_path!r} was "
            f"trained in the approximate regime ({cfg.kernel}) — retrain "
            f"it with `train --kernel {cfg.kernel}` on the grown dataset "
            "instead"
        )


def _seeded(alpha0) -> dict:
    """The solver options of a seeded refit: the deployed duals, the f
    rebuild from them, and the kernel rounds' deltas held to [0, C]. The
    seed's float64 alphas are mostly not float32 values, and kernel #2
    rounds alpha through float32, so without the pull-back a member moved
    to a bound lands up to half a float32 ulp of C off it and the solve
    can end INFEASIBLE_UV (solver/blocked.py:kernel_delta_in_box; the
    fleet's seeded lanes pull theirs back the same way)."""
    return {"alpha0": alpha0, "warm_start": True, "_seed_in_box": True}


def refresh_fit(model_path: str, X: np.ndarray, Y: np.ndarray, *,
                out_path: str,
                checkpoint_path: Optional[str] = None,
                checkpoint_every: int = 64,
                resume: bool = False,
                warm: bool = True,
                dtype=None,
                accum_dtype="auto",
                solver_opts: Optional[dict] = None,
                watchdog=None,
                device="cuda"):
    """Warm-started (optionally checkpointed) refit of a deployed model.

    Dispatches on the artifact's task (svc | ovr | svr); Y is labels for
    the classifiers and continuous targets for SVR. Returns the fitted
    estimator (already saved to `out_path`). `warm=False` is the control
    arm, the cold refit the warm path's update savings are measured
    against. `watchdog` (requires a checkpoint path) is a zero-argument
    deadline callable: truthy between solve segments raises
    WatchdogTimeout with the checkpoint durable. device: where the refit
    runs (the card unless "cpu" is asked for)."""
    from tpusvm_torch.models import model_task

    if watchdog is not None and checkpoint_path is None:
        raise ValueError(
            "watchdog needs checkpoint_path: the deadline stops the fit "
            "at a checkpointed segment boundary so it can resume"
        )
    task = model_task(model_path)
    fit = {"ovr": _refresh_ovr, "svr": _refresh_svr}.get(task, _refresh_svc)
    return fit(model_path, X, Y, out_path=out_path,
               checkpoint_path=checkpoint_path,
               checkpoint_every=checkpoint_every, resume=resume,
               warm=warm, dtype=dtype, accum_dtype=accum_dtype,
               solver_opts=solver_opts, watchdog=watchdog, device=device)


def _refresh_svc(model_path, X, Y, *, out_path, checkpoint_path,
                 checkpoint_every, resume, warm, dtype, accum_dtype,
                 solver_opts, watchdog, device):
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.tune.warm import deployed_seed

    base = BinarySVC.load(model_path, device=device)
    cfg = base.config
    _reject_approx(cfg, model_path)
    n = int(np.asarray(X).shape[0])
    opts = dict(solver_opts or {})
    if warm:
        a0 = deployed_seed(base.sv_ids_, base.sv_alpha_, n,
                           np.asarray(Y), cfg.C)
        if a0.any():
            opts.update(_seeded(a0))
    if watchdog is not None:
        # checkpointed_blocked_solve takes this named argument; refresh_fit
        # refuses it without a checkpoint, so it never reaches a plain solve
        opts["watchdog"] = watchdog
    model = BinarySVC(
        config=cfg,
        dtype=dtype if dtype is not None else torch.float32,
        scale=base.scale,
        accum_dtype=accum_dtype,
        solver="blocked",
        solver_opts=opts,
        device=device,
    )
    model.fit(X, Y, checkpoint_path=checkpoint_path,
              checkpoint_every=checkpoint_every, resume=resume)
    model.save(out_path)
    return model


def _reject_checkpoint(task: str, checkpoint_path) -> None:
    if checkpoint_path is not None:
        raise ValueError(
            f"checkpointed {task} refresh is not supported (the {task} "
            "estimator has no per-head checkpoint surface); drop "
            "--checkpoint or refresh a binary artifact"
        )


def _refresh_ovr(model_path, X, Y, *, out_path, checkpoint_path,
                 checkpoint_every, resume, warm, dtype, accum_dtype,
                 solver_opts, watchdog, device):
    from tpusvm_torch.models import OneVsRestSVC
    from tpusvm_torch.tune.warm import deployed_seed_ovr

    _reject_checkpoint("OvR", checkpoint_path)
    base = OneVsRestSVC.load(model_path, device=device)
    cfg = base.config
    _reject_approx(cfg, model_path)
    seeds = None
    if warm:
        if base.sv_ids_ is None:
            raise ValueError(
                f"{model_path!r} predates per-head OvR refresh (no sv_ids "
                "in the artifact); retrain and re-save it, or run a cold "
                "refresh (warm=False / --cold)"
            )
        seeds = deployed_seed_ovr(base.sv_ids_, base.coef_,
                                  int(np.asarray(X).shape[0]),
                                  np.asarray(Y), base.classes_, cfg.C)
        if not seeds.any():
            seeds = None
    model = OneVsRestSVC(
        config=cfg,
        dtype=dtype if dtype is not None else torch.float32,
        scale=base.scale,
        accum_dtype=accum_dtype,
        solver="blocked",
        solver_opts=dict(solver_opts or {}),
        device=device,
    )
    model.fit(X, Y, warm_seeds=seeds)
    model.save(out_path)
    return model


def _refresh_svr(model_path, X, Y, *, out_path, checkpoint_path,
                 checkpoint_every, resume, warm, dtype, accum_dtype,
                 solver_opts, watchdog, device):
    from tpusvm_torch.models import EpsilonSVR
    from tpusvm_torch.tune.warm import deployed_seed_svr

    _reject_checkpoint("SVR", checkpoint_path)
    base = EpsilonSVR.load(model_path, device=device)
    cfg = base.config
    _reject_approx(cfg, model_path)
    opts = dict(solver_opts or {})
    if warm:
        beta0 = deployed_seed_svr(base.sv_ids_, base.sv_coef_,
                                  int(np.asarray(X).shape[0]), cfg.C)
        if beta0.any():
            opts.update(_seeded(beta0))
    model = EpsilonSVR(
        config=cfg,
        dtype=dtype if dtype is not None else torch.float32,
        scale=base.scale,
        accum_dtype=accum_dtype,
        solver="blocked",
        solver_opts=opts,
        device=device,
    )
    model.fit(X, Y)
    model.save(out_path)
    return model


def swap_via_http(server_url: str, name: str, path: str,
                  timeout_s: float = 60.0) -> dict:
    """POST /admin/swap on a running `serve` frontend (either package's).

    Returns the server's JSON verdict; raises RuntimeError with the
    server's error body on a refused swap (404/409) so callers see the
    rollback reason, not a bare HTTPError."""
    import urllib.error

    body = json.dumps({"name": name, "path": path}).encode()
    req = urllib.request.Request(
        server_url.rstrip("/") + "/admin/swap", data=body,
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            detail = json.loads(e.read()).get("error", "")
        except ValueError:
            detail = ""
        raise RuntimeError(
            f"swap of {name!r} refused by {server_url} "
            f"(HTTP {e.code}): {detail or e.reason}"
        ) from e
