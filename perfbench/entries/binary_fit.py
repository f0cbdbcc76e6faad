"""One cold `BinarySVC.fit` of the configuration's binary job, from the
raw rows on the host, as a user calls it: min-max scaling, the float32
cast and copy to the card, the solve, the alphas back, SV extraction.
In a traced run the fit's own tracer hands its host phases (fit.scale,
fit.cast, fit.to_device, fit.solve, fit.to_host, fit.sv_extract) to the
harness's spans."""

from __future__ import annotations

import numpy as np

# the port's nvcc-built libraries this path launches
LIBRARIES = ("fused_fupdate", "inner_smo")


def setup(cfg: dict, traffic: dict, data: dict, device: str) -> dict:
    import torch
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models.svm import BinarySVC

    h = cfg["svm"]
    config = SVMConfig(C=h["C"], gamma=h["gamma"], eps=h["eps"],
                       tau=h["tau"], max_iter=h["max_iter"],
                       sv_tol=h["sv_tol"], kernel=h["kernel"])

    def make():
        return BinarySVC(config,
                         accum_dtype=getattr(torch, h["accum_dtype"]),
                         solver=cfg["solver"]["name"],
                         solver_opts=dict(cfg["solver"]["opts"]),
                         device=device, dtype=h["features"])

    return {"make": make, "X": data["X"], "Y": data["Y"]}


def unit(state: dict, spans) -> dict:
    """One fit; returns the program's objects and this fit's counters."""
    from tpusvm_torch.ops.cuda.fused_fupdate import rbf_cross_matvec_kernel
    from tpusvm_torch.ops.cuda.inner_smo import inner_smo_kernel

    l1, l2 = rbf_cross_matvec_kernel.launches, inner_smo_kernel.launches
    model = state["make"]().fit(state["X"], state["Y"],
                                tracer=spans if spans.enabled else None)
    res = model.result_
    return {
        "model": model,
        "counters": {
            "rounds": res.n_outer,
            "updates": res.n_iter - 1,
            "host_syncs": res.n_host_syncs,
            "host_wait_s": res.host_wait_s,
            "rescues": res.n_rescue,
            "fupdate_launches": rbf_cross_matvec_kernel.launches - l1,
            "fupdate_lanes": rbf_cross_matvec_kernel.launches - l1,
            "inner_launches": inner_smo_kernel.launches - l2,
            "inner_lanes": inner_smo_kernel.launches - l2,
            "kbb_lanes": res.n_outer,
        },
        "phases": dict(model.fit_phases_),
    }


def answers(cfg: dict, traffic: dict, data: dict, record: dict) -> list:
    """The fit as answers the reference judges: one lane."""
    from tpusvm_torch.device import to_numpy

    m = record["model"]
    h = cfg["svm"]
    alpha = to_numpy(m.result_.alpha).astype(np.float64)
    return [{
        "lane": "binary", "C": h["C"], "gamma": h["gamma"], "labels": "Y",
        "alpha": alpha, "b": float(m.b_), "status": m.status_.name,
        # the SV extraction: ids, alpha * y and the scaled rows it kept
        "sv_ids": np.asarray(m.sv_ids_), "sv_coef":
            np.asarray(m.sv_alpha_, np.float64) * np.asarray(m.sv_Y_),
        "sv_rows": np.asarray(m.sv_X_), "scaled_ids": np.asarray(m.sv_ids_),
        "scaled_rows": np.asarray(m.sv_X_),
    }]


def lane_specs(cfg: dict, traffic: dict, data: dict) -> list:
    """(lane, C, gamma, labels) of every answer a unit gives."""
    h = cfg["svm"]
    return [("binary", h["C"], h["gamma"], "Y")]
