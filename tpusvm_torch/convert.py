"""Carry state across from the JAX package, as numpy arrays.

`from_jax_state` builds the port's estimator from a fitted JAX
estimator's attributes (BinarySVC, calibrated or not, OneVsRestSVC or
EpsilonSVR); `solver_state_from_numpy` turns a JAX solve's
alphas (and optionally its f) into the port's warm start. Neither imports
anything of the JAX package: the caller hands over plain arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device
from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC
from tpusvm_torch.status import Status


def from_jax_state(state: Dict[str, np.ndarray], device="cuda"):
    """The port's estimator from a fitted JAX estimator's attributes.

    state keys are the JAX attribute names: a BinarySVC's sv_X_, sv_Y_,
    sv_alpha_, sv_ids_, b_ (and platt_ = (A, B) when calibrated); a
    OneVsRestSVC's classes_, X_sv_, coef_, sv_ids_, b_; an EpsilonSVR's
    sv_X_, sv_coef_, sv_ids_, b_. Plus scaler_min and scaler_max (absent
    for an unscaled model) and config (a dict of hyperparameters, or any
    object with those attributes; fields this port does not carry are
    ignored). Returns a BinarySVC, OneVsRestSVC or EpsilonSVR.
    """
    cfg = state.get("config", {})
    names = [f.name for f in dataclasses.fields(SVMConfig)]
    if not isinstance(cfg, dict):
        cfg = {k: getattr(cfg, k) for k in names if hasattr(cfg, k)}
    config = SVMConfig(**{k: v for k, v in cfg.items() if k in names})
    scaled = state.get("scaler_min") is not None
    if "classes_" in state:
        model = OneVsRestSVC(config=config, scale=scaled, device=device)
        model.classes_ = np.asarray(state["classes_"])
        model.X_sv_ = np.asarray(state["X_sv_"])
        model.coef_ = np.asarray(state["coef_"])
        model.b_ = np.asarray(state["b_"])
    elif "sv_coef_" in state:
        model = EpsilonSVR(config=config, scale=scaled, device=device)
        model.sv_X_ = np.asarray(state["sv_X_"])
        model.sv_coef_ = np.asarray(state["sv_coef_"])
        model.b_ = float(np.asarray(state["b_"]))
    else:
        model = BinarySVC(config=config, scale=scaled, device=device)
        model.sv_X_ = np.asarray(state["sv_X_"])
        model.sv_Y_ = np.asarray(state["sv_Y_"]).astype(np.int32)
        model.sv_alpha_ = np.asarray(state["sv_alpha_"])
        model.b_ = float(np.asarray(state["b_"]))
        if state.get("platt_") is not None:
            model.platt_ = tuple(float(v) for v in state["platt_"])
    if state.get("sv_ids_") is not None:
        model.sv_ids_ = np.asarray(state["sv_ids_"]).astype(np.int32)
    if scaled:
        model.scaler_ = MinMaxScaler(min_val=np.asarray(state["scaler_min"]),
                                     max_val=np.asarray(state["scaler_max"]))
    if not isinstance(model, OneVsRestSVC):
        model.status_ = Status.CONVERGED
    return model


def solver_state_from_numpy(alpha: np.ndarray, f: Optional[np.ndarray] = None,
                            device="cuda") -> dict:
    """blocked_smo_solve keyword arguments that resume from `alpha`.

    Float64 tensors on `device` (the card unless the caller asks for
    "cpu"): alpha0, with f0 = f when the caller has the solve's error
    vector, else warm_start=True so the solver rebuilds f from alpha.
    """
    device = resolve_device(device)
    alpha = np.asarray(alpha, np.float64)
    kw = {"alpha0": torch.tensor(alpha, device=device)}
    if f is None:
        kw["warm_start"] = True
    else:
        f = np.asarray(f, np.float64)
        if f.shape != alpha.shape:
            raise ValueError(f"f has shape {f.shape}, alpha {alpha.shape}")
        kw["f0"] = torch.tensor(f, device=device)
    return kw
