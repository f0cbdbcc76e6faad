"""Unpacking a batched fleet result into per-problem SMOResults (the port
of tpusvm/fleet/results.py).

fleet_smo_solve returns one SMOResult whose fields carry the leading
problem axis (padding lanes included): alpha a (B, n) tensor, the scalars
(B,) numpy arrays, the telemetry ring (B, T) tensors. Consumers (the
one-vs-rest fleet, the CLI) want the per-problem surface a solo solve
gives them: this module slices the batch apart, drops the padding lanes
and re-wraps each lane's ring, so a fleet-trained problem is handled as a
solo-trained one is. The fleet-wide counters (host syncs, the time blocked
at them) are the same on every lane.
"""

from __future__ import annotations

from typing import List

from tpusvm_torch.obs.convergence import ConvergenceTelemetry
from tpusvm_torch.solver.blocked import SMOResult
from tpusvm_torch.status import Status

__all__ = ["lane_result", "unpack_results", "fleet_convergence_summary"]


def lane_result(res: SMOResult, i: int) -> SMOResult:
    """Lane i of a batched SMOResult as a per-problem SMOResult: its alpha,
    b, status and counters as the fleet computed them, its ring re-wrapped
    (obs/convergence.py works per head)."""
    tele = None
    if res.telemetry is not None:
        t = res.telemetry
        tele = ConvergenceTelemetry(gap=t.gap[i], n_upd=t.n_upd[i],
                                    status=t.status[i], count=int(t.count[i]),
                                    active=t.active[i])
    return SMOResult(
        alpha=res.alpha[i],
        b=float(res.b[i]),
        b_high=float(res.b_high[i]),
        b_low=float(res.b_low[i]),
        n_iter=int(res.n_iter[i]),
        status=Status(int(res.status[i])),
        n_outer=int(res.n_outer[i]),
        n_rescue=int(res.n_rescue[i]),
        n_host_syncs=int(res.n_host_syncs),
        host_wait_s=float(res.host_wait_s),
        n_refines=int(res.n_refines[i]),
        telemetry=tele,
    )


def unpack_results(res: SMOResult, n_problems: int) -> List[SMOResult]:
    """Batched SMOResult -> per-problem SMOResults (padding dropped)."""
    B = res.alpha.shape[0]
    if n_problems > B:
        raise ValueError(
            f"unpack_results: {n_problems} problems from a {B}-lane batch")
    return [lane_result(res, i) for i in range(n_problems)]


def fleet_convergence_summary(results: List[SMOResult]) -> dict:
    """Per-problem statuses, updates and rounds, and the fleet-level
    counts, for logs and benches; with the ring on, also the rounds each
    lane recorded."""
    statuses = [Status(int(r.status)) for r in results]
    summary = {
        "problems": len(results),
        "converged": sum(s == Status.CONVERGED for s in statuses),
        "statuses": [s.name for s in statuses],
        "updates": [int(r.n_iter) - 1 for r in results],
        "outer_rounds": [int(r.n_outer) for r in results],
    }
    if results and results[0].telemetry is not None:
        summary["telemetry_rounds"] = [int(r.telemetry.count)
                                       for r in results]
    return summary
