"""The refresh coalescer: drifted tenants -> power-of-two fleet launches.

The port of tpusvm/tenants/coalesce.py. N drifted tenants refreshed one
by one cost N dataset loads and N sequential solves. Coalescing packs the
currently drifted set into power-of-two ``fleet_smo_solve`` launches: X
is loaded, scaled and put on the card ONCE for the whole bucket,
per-tenant (C, gamma) enter as per-lane values, and each tenant's warm
seed (``tune.warm.deployed_seed`` of its deployed artifact) rides the
fleet's alpha0 lane, so a mixed warm/cold bucket is exact
(fleet/batch.py). On the card each round is one problem-axis launch of
the subproblem kernel (#2) and, for RBF, one of the f-update kernel (#1)
for every running lane (fleet/solve.py).

Coalescing rules (``coalesce_drifted``), the JAX package's:

  * tenants group by their launch static key: kernel family and shape,
    eps/tau/max_iter, sv_tol, the scale policy. Per-problem axes are
    exactly (y, valid, alpha0, C, gamma);
  * a group of >= ``min_fleet`` tenants becomes one fleet launch, padded
    to the next power of two with inert zero-label lanes;
  * singletons and odd-corpus tenants (a static key nobody shares, or an
    approximate-family artifact, whose refresh the dual-seed contract
    refuses) fall back to a solo ``refresh_fit``, checkpointed per
    tenant.

Crash safety (``checkpointed_fleet_refresh``): the launch runs in
``checkpoint_every``-outer-round segments (fleet_smo_solve's pause_at /
resume_states), and after each segment the batched carry is written
durably (tenants/store.py:save_fleet_checkpoint, fingerprinted against
this exact launch). The segment schedule is the JAX package's: a segment
starts at the largest n_outer of the RUNNING lanes and pauses
``checkpoint_every`` rounds later, so a supervisor killed mid-refresh
resumes at the boundaries an uninterrupted run pauses at, and every
lane's result is bit for bit the uninterrupted one's (each lane's carry
is independent state; segmenting is exact; the carry crosses card ->
numpy -> card without a changed bit).

Parity: a lane's bits do not depend on its companions or its position in
the bucket (fleet/solve.py), so a tenant refreshed in a launch equals
itself refreshed in any other launch; across packages the JAX fleet is a
vmapped XLA program, held to the cross-engine band (the same SV-ID set
and status, b within 1e-4).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpusvm_torch.status import Status
from tpusvm_torch.tenants.store import (
    TenantRecord,
    load_fleet_checkpoint,
    save_fleet_checkpoint,
)
from tpusvm_torch.tenants.views import tenant_labels

__all__ = [
    "CoalescePlan",
    "coalesce_drifted",
    "checkpointed_fleet_refresh",
    "provision_tenants",
    "refresh_drifted",
]


@dataclasses.dataclass
class CoalescePlan:
    """The coalescer's decision, JSON-able so the supervisor can persist it
    in the store's inflight record and a resumed run finishes the SAME
    launches (not a re-planned set later appends could have changed)."""

    launches: List[List[str]]   # each: the tenant ids of one fleet launch
    solos: List[str]            # tenant ids refreshed solo

    def to_json(self) -> dict:
        return {"launches": [list(ids) for ids in self.launches],
                "solos": list(self.solos)}

    @classmethod
    def from_json(cls, obj: dict) -> "CoalescePlan":
        return cls(launches=[list(ids) for ids in obj["launches"]],
                   solos=list(obj["solos"]))


def _static_key(rec: TenantRecord, base) -> tuple:
    """The launch-compatibility key: everything one fleet launch shares.
    The per-problem axes (y, valid, alpha0, C, gamma) are left out by
    construction."""
    cfg = base.config
    return (cfg.kernel, cfg.degree, cfg.coef0, cfg.eps, cfg.tau,
            cfg.max_iter, cfg.sv_tol, bool(base.scale))


def coalesce_drifted(records: Sequence[TenantRecord], donors: Dict,
                     min_fleet: int = 2) -> CoalescePlan:
    """Group the drifted set by launch static key; groups of >= min_fleet
    become fleet launches (tenant ids sorted inside each: a deterministic
    lane assignment), the rest go solo. `donors` maps tenant_id -> its
    loaded donor estimator."""
    from tpusvm_torch.config import is_approx_family

    groups: Dict[tuple, List[str]] = {}
    solos: List[str] = []
    for rec in sorted(records, key=lambda r: r.tenant_id):
        base = donors[rec.tenant_id]
        if is_approx_family(base.config.kernel):
            # odd corpus: the approximate primal regime has no dual warm
            # seed and refresh_fit refuses it by name; a solo attempt
            # makes the failure a counted per-tenant outcome, not a dead
            # launch
            solos.append(rec.tenant_id)
            continue
        groups.setdefault(_static_key(rec, base), []).append(
            rec.tenant_id)
    launches = []
    for key in sorted(groups, key=repr):
        ids = groups[key]
        if len(ids) >= max(2, min_fleet):
            launches.append(ids)
        else:
            solos.extend(ids)
    return CoalescePlan(launches=launches, solos=sorted(solos))


def _json_value(v):
    """A launch option as the fingerprint writes it: JSON scalars as they
    are, a torch dtype by its numpy name ("float64", as the fingerprint
    writes the corpus dtype), anything else as str()."""
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    return str(v)


def _launch_fingerprint(Xs, batch, tenant_ids, opts) -> dict:
    """The JSON-able identity of one coalesced launch: corpus bytes, the
    packed per-problem axes, the hyperparameter vectors, the shared
    options. A checkpoint of any other launch is refused with the
    differing fields named."""
    Xs = np.asarray(Xs)
    fp = {
        "n": int(Xs.shape[0]),
        "d": int(Xs.shape[1]),
        "x_dtype": str(Xs.dtype),
        "x_crc32": zlib.crc32(np.ascontiguousarray(Xs).tobytes()),
        "ys_crc32": zlib.crc32(
            np.ascontiguousarray(batch.Ys).tobytes()),
        "valids_crc32": (
            None if batch.valids is None
            else zlib.crc32(np.ascontiguousarray(batch.valids).tobytes())),
        "alpha0s_crc32": (
            None if batch.alpha0s is None
            else zlib.crc32(
                np.ascontiguousarray(batch.alpha0s).tobytes())),
        "Cs": [float(c) for c in batch.Cs],
        "gammas": [float(g) for g in batch.gammas],
        "bucket": int(batch.bucket),
        "tenant_ids": list(tenant_ids),
    }
    for k in sorted(opts):
        fp[k] = _json_value(opts[k])
    return fp


def _running(state) -> np.ndarray:
    return np.asarray(state.status) == int(Status.RUNNING)


def checkpointed_fleet_refresh(Xs, batch, *, checkpoint_path: str,
                               checkpoint_every: int = 64,
                               resume: bool = False,
                               fingerprint: dict,
                               dtype=None,
                               device="cuda",
                               **opts):
    """One coalesced launch to convergence, durably checkpointed.

    Runs the packed FleetBatch through fleet_smo_solve in
    `checkpoint_every`-outer-round segments; after each segment the
    batched carry is written atomically. resume=True restarts from the
    file when it exists (a missing file is a fresh start); the
    fingerprint refuses a checkpoint of any other launch. Returns the
    batched SMOResult.

    The checkpoint is NOT deleted here: deleting it at convergence would
    open a crash window between the solve's end and the per-tenant
    artifact saves where a kill forces a full refit. It stays until the
    caller has durably committed everything derived from it (the
    supervisor deletes it after its swapping-stage store commit);
    re-entering a finished checkpoint is cheap, the carry has no RUNNING
    lane and the solve returns at once.

    Segments start at the largest n_outer of the RUNNING lanes and pause
    `checkpoint_every` rounds later (the JAX package's schedule), so an
    interrupted run resumes at the boundaries an uninterrupted run pauses
    at and every lane's final alpha bytes are the uninterrupted run's."""
    from tpusvm_torch.device import resolve_device, to_dtype
    from tpusvm_torch.fleet.solve import fleet_smo_solve

    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    state = None
    if resume and os.path.exists(checkpoint_path):
        state = load_fleet_checkpoint(checkpoint_path, fingerprint)

    dev = resolve_device(device)
    Xd = to_dtype(Xs, dtype if dtype is not None else torch.float32).to(dev)
    Ys_d = torch.as_tensor(batch.Ys, device=dev)
    valids_d = (None if batch.valids is None
                else torch.as_tensor(batch.valids, device=dev))
    adt = opts.get("accum_dtype")
    alpha0s_d = (None if batch.alpha0s is None
                 else torch.as_tensor(batch.alpha0s, device=dev).to(
                     adt if adt is not None else Xd.dtype))
    if batch.alpha0s is not None:
        opts.setdefault("warm_start", True)

    while True:
        if state is None:
            start = 0
        else:
            n_outer = np.asarray(state.n_outer)
            running = _running(state)
            start = int(n_outer[running].max() if running.any()
                        else n_outer.max())
        res, state = fleet_smo_solve(
            Xd, Ys_d, valids_d, alpha0s_d, Cs=batch.Cs, gammas=batch.gammas,
            resume_states=state, pause_at=start + checkpoint_every,
            return_state=True, device=dev, **opts,
        )
        if not _running(state).any():
            return res
        save_fleet_checkpoint(checkpoint_path, state, fingerprint)


def _lane_model(cfg, scale, scaler, Xs, Y, lane, device):
    """One tenant's refreshed estimator from its fleet lane: the solo
    fit's SV extraction (models/svm.py:_solve_fit) applied to a lane, so
    a coalesced artifact has the shape, provenance fields and scaled-SV
    layout a solo one has."""
    from tpusvm_torch.device import to_numpy
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.models.svm import get_sv_indices

    model = BinarySVC(config=cfg, dtype=torch.float32, scale=scale,
                      accum_dtype="auto", solver="blocked", device=device)
    model.scaler_ = scaler if scale else None
    alpha = to_numpy(lane.alpha)
    sv = get_sv_indices(alpha, cfg.sv_tol)
    model.sv_X_ = np.asarray(Xs)[sv]
    model.sv_Y_ = np.asarray(Y)[sv].astype(np.int32)
    model.sv_alpha_ = alpha[sv]
    model.sv_ids_ = sv.astype(np.int32)
    model.b_ = float(lane.b)
    model.b_high_ = float(lane.b_high)
    model.b_low_ = float(lane.b_low)
    model.n_iter_ = int(lane.n_iter)
    model.status_ = Status(int(lane.status))
    model.result_ = lane
    return model


def _launch_opts(cfg0, opts: dict) -> dict:
    from tpusvm_torch.config import resolve_accum_dtype

    return dict(eps=cfg0.eps, tau=cfg0.tau, max_iter=cfg0.max_iter,
                kernel=cfg0.kernel, degree=cfg0.degree, coef0=cfg0.coef0,
                accum_dtype=resolve_accum_dtype("auto"), **opts)


def refresh_drifted(X, labels, records: Sequence[TenantRecord], *,
                    artifacts_dir: str,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 64,
                    resume: bool = False,
                    warm: bool = True,
                    plan: Optional[CoalescePlan] = None,
                    min_fleet: int = 2,
                    solver_opts: Optional[dict] = None,
                    log=None,
                    device="cuda") -> dict:
    """Refresh the drifted tenant set: coalesced fleet launches and solo
    fallbacks, every artifact saved atomically.

    X/labels are the SHARED corpus arrays (one load for every tenant).
    Returns {tenant_id: {"out_path", "status", "n_iter", "n_outer",
    "n_rescue" (the port's: rounds redone on the float64 loop engine),
    "sv_count", "mode", "checkpoint" (fleet), "error"?}}: a failed tenant
    is a counted outcome carrying its error, never a dead launch (the
    other lanes' artifacts still land). `plan` pins a persisted
    coalescing decision (the resume path); without it the plan is
    computed here. device: where the launches and the solo refits run
    (the card unless "cpu" is asked for)."""
    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.fleet.batch import pack_problems
    from tpusvm_torch.fleet.results import lane_result
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve.refresh import refresh_fit
    from tpusvm_torch.tune.warm import deployed_seed

    say = log or (lambda msg: None)
    X = np.asarray(X)
    labels = np.asarray(labels)
    n = int(X.shape[0])
    ckdir = checkpoint_dir or artifacts_dir
    os.makedirs(artifacts_dir, exist_ok=True)
    os.makedirs(ckdir, exist_ok=True)
    opts = dict(solver_opts or {})
    by_id = {r.tenant_id: r for r in records}
    donors = {r.tenant_id: BinarySVC.load(r.model_path, device=device)
              for r in records}
    if plan is None:
        plan = coalesce_drifted(records, donors, min_fleet=min_fleet)
    outcomes: dict = {}

    # scale ONCE: every scale=True tenant shares X, so the fitted min/max
    # (and the scaled matrix) is what each solo fit would compute (on the
    # host or, BinarySVC.fit's device route, on the card: the same bits)
    scaler = MinMaxScaler().fit(X)
    Xs_scaled = scaler.transform(X)

    for ids in plan.launches:
        recs = [by_id[t] for t in ids]
        bases = [donors[t] for t in ids]
        base0 = bases[0]
        cfg0 = base0.config
        Xs = Xs_scaled if base0.scale else X
        Ys, valids, seeds, Cs, gammas = [], [], [], [], []
        for rec, base in zip(recs, bases):
            Y, valid = tenant_labels(labels, rec)
            Ys.append(Y)
            valids.append(valid)
            a0 = None
            if warm:
                a0 = deployed_seed(base.sv_ids_, base.sv_alpha_, n,
                                   Y, rec.C)
                if not a0.any():
                    a0 = None
            seeds.append(a0)
            Cs.append(rec.C)
            gammas.append(rec.gamma)
        launch_opts = _launch_opts(cfg0, opts)
        batch = pack_problems(
            Ys, Cs, gammas,
            valids=None if all(v is None for v in valids) else valids,
            alpha0s=None if all(a is None for a in seeds) else seeds,
        )
        ck = os.path.join(ckdir, "fleet_%s.ck.npz"
                          % zlib.crc32(",".join(ids).encode()))
        fp = _launch_fingerprint(Xs, batch, ids, launch_opts)
        say(f"tenants: fleet launch of {len(ids)} tenants "
            f"(bucket {batch.bucket}, warm "
            f"{sum(a is not None for a in seeds)}/{len(ids)})")
        res = checkpointed_fleet_refresh(
            Xs, batch, checkpoint_path=ck,
            checkpoint_every=checkpoint_every, resume=resume,
            fingerprint=fp, dtype=torch.float32, device=device,
            **launch_opts,
        )
        for i, (rec, base) in enumerate(zip(recs, bases)):
            lane = lane_result(res, i)
            cfg = dataclasses.replace(base.config, C=rec.C,
                                      gamma=rec.gamma)
            out_path = os.path.join(artifacts_dir,
                                    rec.tenant_id + ".npz")
            try:
                model = _lane_model(cfg, base.scale, scaler, Xs,
                                    Ys[i], lane, device)
                model.save(out_path)
                outcomes[rec.tenant_id] = {
                    "out_path": out_path, "mode": "fleet",
                    "checkpoint": ck,
                    "status": model.status_,
                    "n_iter": model.n_iter_,
                    "n_outer": int(lane.n_outer),
                    "n_rescue": int(lane.n_rescue),
                    "sv_count": int(model.sv_ids_.shape[0]),
                }
            except Exception as e:  # noqa: BLE001 — one tenant's save
                # failure must not drop its bucket-mates' artifacts
                outcomes[rec.tenant_id] = {
                    "out_path": out_path, "mode": "fleet",
                    "checkpoint": ck,
                    "status": None, "n_iter": 0, "n_outer": 0,
                    "n_rescue": 0, "sv_count": 0,
                    "error": f"{type(e).__name__}: {e}",
                }

    for tid in plan.solos:
        rec = by_id[tid]
        out_path = os.path.join(artifacts_dir, tid + ".npz")
        try:
            Y, valid = tenant_labels(labels, rec)
            solo_opts = dict(opts)
            if valid is not None:
                solo_opts["valid"] = valid
            ck = os.path.join(ckdir, tid + ".solo_ck.npz")
            model = refresh_fit(
                rec.model_path, X, Y, out_path=out_path,
                checkpoint_path=ck, checkpoint_every=checkpoint_every,
                resume=resume, warm=warm, solver_opts=solo_opts,
                device=device,
            )
            outcomes[tid] = {
                "out_path": out_path, "mode": "solo",
                "status": model.status_,
                "n_iter": model.n_iter_,
                "n_outer": int(model.result_.n_outer),
                "n_rescue": int(model.result_.n_rescue),
                "sv_count": int(model.sv_ids_.shape[0]),
            }
        except Exception as e:  # noqa: BLE001 — a counted per-tenant
            # outcome; the rest of the drifted set still refreshes
            outcomes[tid] = {
                "out_path": out_path, "mode": "solo",
                "status": None, "n_iter": 0, "n_outer": 0, "n_rescue": 0,
                "sv_count": 0,
                "error": f"{type(e).__name__}: {e}",
            }
            say(f"tenants: solo refresh of {tid} FAILED "
                f"({type(e).__name__}: {e})")
    return outcomes


def provision_tenants(X, labels, records: Sequence[TenantRecord], *,
                      artifacts_dir: str, scale: bool = True,
                      config=None, solver_opts: Optional[dict] = None,
                      log=None, device="cuda") -> dict:
    """Cold-start a whole tenant fleet in ONE coalesced launch.

    The bootstrap of refresh_drifted: every record's first artifact is
    fitted from scratch in a single power-of-two fleet_smo_solve over the
    shared corpus (X scaled once, per-tenant C/gamma per lane) and saved
    atomically as artifacts_dir/<tenant_id>.npz; each record's model_path
    and rows_at_refresh are filled in. `config` is the shared static
    template (kernel, eps, tau, ...; default SVMConfig()); C and gamma
    always come from the records. Returns refresh_drifted's outcomes."""
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.device import resolve_device, to_dtype
    from tpusvm_torch.fleet.batch import pack_problems
    from tpusvm_torch.fleet.results import lane_result
    from tpusvm_torch.fleet.solve import fleet_smo_solve

    say = log or (lambda msg: None)
    X = np.asarray(X)
    labels = np.asarray(labels)
    os.makedirs(artifacts_dir, exist_ok=True)
    cfg0 = config if config is not None else SVMConfig()
    opts = dict(solver_opts or {})
    scaler = MinMaxScaler().fit(X) if scale else None
    Xs = scaler.transform(X) if scale else X

    Ys, valids, Cs, gammas = [], [], [], []
    for rec in records:
        rec.validate()
        Y, valid = tenant_labels(labels, rec)
        Ys.append(Y)
        valids.append(valid)
        Cs.append(rec.C)
        gammas.append(rec.gamma)
    batch = pack_problems(
        Ys, Cs, gammas,
        valids=None if all(v is None for v in valids) else valids,
    )
    say(f"tenants: provisioning {len(records)} tenants in one fleet "
        f"launch (bucket {batch.bucket})")
    dev = resolve_device(device)
    res = fleet_smo_solve(
        to_dtype(Xs, torch.float32).to(dev),
        torch.as_tensor(batch.Ys, device=dev),
        None if batch.valids is None
        else torch.as_tensor(batch.valids, device=dev),
        None, Cs=batch.Cs, gammas=batch.gammas, device=dev,
        **_launch_opts(cfg0, opts),
    )
    outcomes: dict = {}
    for i, rec in enumerate(records):
        cfg = dataclasses.replace(cfg0, C=rec.C, gamma=rec.gamma)
        out_path = os.path.join(artifacts_dir, rec.tenant_id + ".npz")
        lane = lane_result(res, i)
        model = _lane_model(cfg, scale, scaler, Xs, Ys[i], lane, device)
        model.save(out_path)
        rec.model_path = out_path
        rec.rows_at_refresh = int(X.shape[0])
        outcomes[rec.tenant_id] = {
            "out_path": out_path, "mode": "fleet",
            "status": model.status_, "n_iter": model.n_iter_,
            "n_outer": int(lane.n_outer),
            "n_rescue": int(lane.n_rescue),
            "sv_count": int(model.sv_ids_.shape[0]),
        }
    return outcomes
