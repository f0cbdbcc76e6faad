"""The comparison that decides `correct`: what the timed path produced,
judged by the plain reference (reference/svm.py), each number beside
its limit (limits/<cell>.json).

The answers are one per lane (a binary fit's one model, a head of a
one-vs-rest fit, a lane of a grid) of every unit of work in the
window. Equal answers are judged once. The numbers:

  kkt_gap    the largest b_low - b_high of any answer's alphas, with f
             rebuilt from them in float64 over every training row (how
             far from optimal the claimed solution is), as a share of
             the answer's sum of alphas;
  b_err      the largest gap between an answer's b and the b its alphas
             give (the midpoint of b_high and b_low of the judge's f),
             as a share of the answer's sum of alphas: over every
             answer, also those the reference does not re-solve;
  score_err  the largest gap between the decision values on the
             held-out rows of a model the program fitted and of the
             reference's own float64 solve of the same lane, over the
             lanes drawn from the seed, as a share of the reference's
             sum of alphas;
  dual_gap   the largest shortfall of an answer's dual objective below
             the reference's float64 solve of the same lane, over the
             lanes drawn from the seed, as a share of the reference's
             objective (both objectives computed by the judge, in
             float64 over every row): optimal for another problem, such
             as one whose kernel was computed in a lower precision, an
             answer falls short;
  scale_err  the largest gap between scaled rows the program kept (SV
             rows, or rows drawn from the seed) and the reference's
             scaling of the same rows (exact: limit 0);
  sv_err     SV ids, coefficients or rows that differ from what the
             program's own alphas give (exact: limit 0);
  unconverged  answers whose status is not CONVERGED (limit 0).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from perfbench.reference import svm

# kkt_gap and score_err are shares of a lane's sum of alphas, the scale
# of the rounding of f = K (alpha * y) - y and of a decision value: so
# lanes of another C read alike. A sum below C counts as C.


def scale_of(alpha, C: float) -> float:
    return max(float(np.sum(alpha)), float(C))


NUMBERS = ("kkt_gap", "b_err", "score_err", "dual_gap", "scale_err",
           "sv_err", "unconverged")


def problem(cfg: dict, data: dict, device) -> dict:
    """The reference's own view of the configuration's rows: scaled in
    float64 from the raw pixels, then the float32 feature values."""
    Xs = svm.minmax_scale(data["X"], data["X"])
    Xt = svm.minmax_scale(data["X"], data["X_test"])
    return {"Xs": Xs,
            "X": torch.as_tensor(Xs.astype(np.float32), device=device),
            "X_test": torch.as_tensor(Xt.astype(np.float32), device=device)}


def labels_of(data: dict, key) -> np.ndarray:
    if key == "Y":
        return np.asarray(data["Y"])
    _, c = key
    return np.where(np.asarray(data["labels"]) == c, 1, -1).astype(np.int32)


def digest(ans: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(ans):
        v = ans[k]
        h.update(k.encode())
        h.update(np.asarray(v).tobytes() if isinstance(v, np.ndarray)
                 else repr(v).encode())
    return h.hexdigest()


def reference_lanes(lanes: list, k: int, seed: int) -> list:
    """k of the lanes, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7919])
    k = min(k, len(lanes))
    return [lanes[i] for i in sorted(rng.choice(len(lanes), k,
                                                replace=False))]


def sv_mismatch(ans: dict, y: np.ndarray, sv_tol: float) -> int:
    """SV ids, coefficients and rows that differ from the extraction the
    program's own alphas give."""
    alpha = ans["alpha"]
    expect = np.nonzero(alpha > sv_tol)[0]
    ids = np.asarray(ans["sv_ids"])
    if ids.shape != expect.shape or np.any(ids != expect):
        return int(np.setxor1d(ids, expect).size or 1)
    bad = int(np.count_nonzero(ans["sv_coef"] != alpha[ids] * y[ids]))
    if "sv_union" in ans:
        union = np.asarray(ans["sv_union"])
        if not np.all(np.isin(ids, union)):
            bad += 1
    rows = np.asarray(ans["sv_rows"])
    at = np.searchsorted(np.asarray(ans["scaled_ids"]), ids)
    bad += int(np.count_nonzero(
        np.any(rows != np.asarray(ans["scaled_rows"])[at], axis=1)))
    return bad


def compare(cfg: dict, traffic: dict, data: dict, units: list, seed: int,
            device, prob: dict = None, log=None) -> dict:
    """The numbers over every unit's answers (a list of answer lists).
    Returns {name: value} for NUMBERS, and "lanes": answers judged."""
    h = cfg["svm"]
    prob = prob or problem(cfg, data, device)
    out = dict.fromkeys(NUMBERS, 0.0)
    out["sv_err"] = out["unconverged"] = 0
    out["dual_gap"] = -float("inf")
    distinct, duals = {}, {}
    for answers in units:
        for ans in answers:
            if ans["status"] != "CONVERGED":
                out["unconverged"] += 1
            distinct.setdefault(digest(ans), ans)
    judged = 0
    for ans in distinct.values():
        y = labels_of(data, ans["labels"])
        if "scaled_rows" in ans:
            ref_rows = prob["Xs"][np.asarray(ans["scaled_ids"])]
            out["scale_err"] = max(out["scale_err"], float(
                np.abs(np.asarray(ans["scaled_rows"]) - ref_rows).max(
                    initial=0.0)))
        if "sv_ids" in ans:
            out["sv_err"] += sv_mismatch(ans, y, h["sv_tol"])
        j = svm.judge(prob["X"], y, ans["alpha"], C=ans["C"],
                      gamma=ans["gamma"], eps=h["eps"])
        scale = scale_of(ans["alpha"], ans["C"])
        out["kkt_gap"] = max(out["kkt_gap"], j["gap"] / scale)
        out["b_err"] = max(out["b_err"], abs(ans["b"] - j["b"]) / scale)
        duals[id(ans)] = j["dual"]
        judged += 1
    lanes = sorted({a["lane"] for a in distinct.values()})
    k = int(traffic.get("check", {}).get("reference_lanes", 1))
    for lane in reference_lanes(lanes, k, seed):
        mine = [a for a in distinct.values() if a["lane"] == lane]
        a0 = mine[0]
        y = labels_of(data, a0["labels"])
        ref = solve_lane(cfg, prob, y, a0["C"], a0["gamma"])
        s_ref = scores_of(prob, y, ref["alpha"], ref["b"], a0["gamma"],
                          h["sv_tol"])
        d_ref = svm.judge(prob["X"], y, ref["alpha"], C=a0["C"],
                          gamma=a0["gamma"], eps=h["eps"])["dual"]
        if log:
            log(f"reference {lane}: {ref['status']}, {ref['updates']} "
                f"updates in {ref['rounds']} rounds, b {ref['b']!r}, dual "
                f"{d_ref!r}, sum of alphas {float(ref['alpha'].sum())!r}")
        scale = scale_of(ref["alpha"], a0["C"])
        for a in mine:
            s = scores_of(prob, y, a["alpha"], a["b"], a["gamma"],
                          h["sv_tol"], a)
            out["score_err"] = max(out["score_err"],
                                   float(np.abs(s - s_ref).max()) / scale)
            out["dual_gap"] = max(out["dual_gap"],
                                  (d_ref - duals[id(a)]) / abs(d_ref))
    out["lanes"] = judged
    return out


# the reference solves to a tenth of the configuration's stop tolerance,
# so that its optimum is sharper than the answers it is compared with
REFERENCE_TAU_SHARE = 0.1


def solve_lane(cfg: dict, prob: dict, y, C: float, gamma: float,
               precision: str = "f64") -> dict:
    """The reference's own solve of one lane at the configuration's
    working-set size, to a tenth of its stop tolerance."""
    h, opts = cfg["svm"], cfg["solver"]["opts"]
    return svm.solve(prob["X"], y, C=C, gamma=gamma, eps=h["eps"],
                     tau=h["tau"] * REFERENCE_TAU_SHARE, q=int(opts["q"]),
                     max_inner=int(opts["max_inner"]),
                     max_iter=int(h["max_iter"]) * 10, precision=precision)


def scores_of(prob: dict, y, alpha, b: float, gamma: float, sv_tol: float,
              ans: dict = None) -> np.ndarray:
    """Decision values on the held-out rows of a model: the SV rows and
    coefficients the program kept where it kept them, else those its
    alphas give."""
    if ans is not None and "sv_ids" in ans:
        rows = torch.as_tensor(np.asarray(ans["sv_rows"]).astype(np.float32),
                               device=prob["X"].device)
        coef = ans["sv_coef"]
    else:
        sv = np.nonzero(np.asarray(alpha) > sv_tol)[0]
        rows = prob["X"][torch.as_tensor(sv, device=prob["X"].device)]
        coef = np.asarray(alpha)[sv] * np.asarray(y)[sv]
    return svm.decision(prob["X_test"], rows, coef, b, gamma)
