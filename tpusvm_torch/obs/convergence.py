"""The convergence ring's host half: the result container, the ring unwrap
and the gap table (a copy of tpusvm/obs/convergence.py's, with the JAX
report module's table renderer).

blocked_smo_solve(telemetry=T) carries a T-slot ring in its outer-loop
carry: each body execution writes its Keerthi gap b_low - b_high, inner
updates, end-of-round status and live rows into slot (round mod T), on the
device, never read by the solve. `materialize` brings it to the host once,
oldest round first; `format_gap_table` prints it as the JAX command line
does, through obs/report.py's table renderer, and `to_trace_events` writes
it as the convergence.round events `report` renders from a trace file.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np

from tpusvm_torch.obs.report import format_convergence_table
from tpusvm_torch.status import Status


class ConvergenceTelemetry(NamedTuple):
    """The ring as the solver returns it (tensors on the solve's device).

    gap:    (T,) accum dtype: b_low - b_high per recorded round, NaN where
            no working set existed.
    n_upd:  (T,) int32: inner alpha updates of the round.
    status: (T,) int32: the Status the round ended with.
    count:  rounds recorded (may exceed T: the ring then holds the last T).
    active: (T,) int32: live rows that round (valid rows not yet stable for
            shrink_stable rounds; all valid rows without shrink tracking).
    """

    gap: Any
    n_upd: Any
    status: Any
    count: Any
    active: Any = None


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def materialize(tele: ConvergenceTelemetry) -> Dict[str, Any]:
    """Unwrap the ring into oldest-first host arrays: {"gap", "updates",
    "status" (numpy), "rounds_recorded" (rounds the solver ran, >= len(gap)
    when the ring wrapped), "wrapped", and "active" when recorded}."""
    gap = _host(tele.gap)
    n_upd = _host(tele.n_upd)
    status = _host(tele.status)
    count = int(tele.count)
    T = gap.shape[0]
    if count <= T:
        order = np.arange(count)
    else:
        order = (count + np.arange(T)) % T  # the oldest surviving slot first
    out = {
        "gap": gap[order],
        "updates": n_upd[order],
        "status": status[order],
        "rounds_recorded": count,
        "wrapped": count > T,
    }
    if tele.active is not None:
        out["active"] = _host(tele.active)[order]
    return out


def to_trace_events(tracer, conv: Dict[str, Any]) -> None:
    """Write a materialized telemetry dict as convergence.round events
    (the records `report` renders as the gap table)."""
    first = conv["rounds_recorded"] - len(conv["gap"]) + 1
    active = conv.get("active")
    for i in range(len(conv["gap"])):
        g = float(conv["gap"][i])
        extra = {} if active is None else {"active": int(active[i])}
        tracer.event(
            "convergence.round",
            round=first + i,
            gap=None if np.isnan(g) else g,
            updates=int(conv["updates"][i]),
            status=Status(int(conv["status"][i])).name,
            **extra,
        )


def format_gap_table(conv: Dict[str, Any], max_rows: int = 40) -> str:
    """The gap table of a materialized ring, the JAX command line's text."""
    first = conv["rounds_recorded"] - len(conv["gap"]) + 1
    active = conv.get("active")
    rows = []
    for i in range(len(conv["gap"])):
        g = float(conv["gap"][i])
        row = {
            "round": first + i,
            "gap": None if np.isnan(g) else g,
            "updates": int(conv["updates"][i]),
            "status": Status(int(conv["status"][i])).name,
        }
        if active is not None:
            row["active"] = int(active[i])
        rows.append(row)
    return format_convergence_table(rows, max_rows=max_rows)
