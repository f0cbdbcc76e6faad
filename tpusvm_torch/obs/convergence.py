"""The convergence ring's host half: the result container, the ring unwrap
and the gap table (a copy of tpusvm/obs/convergence.py's, with the JAX
report module's table renderer).

blocked_smo_solve(telemetry=T) carries a T-slot ring in its outer-loop
carry: each body execution writes its Keerthi gap b_low - b_high, inner
updates, end-of-round status and live rows into slot (round mod T), on the
device, never read by the solve. `materialize` brings it to the host once,
oldest round first; `format_gap_table` prints it as the JAX command line
does. The trace events (`to_trace_events`) wait for the tracer (ROADMAP
Queue 1 item 12: `--trace`).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np

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


def format_convergence_table(rows: List[dict], max_rows: int = 40) -> str:
    """Fixed-width outer-round table: round, Keerthi gap, updates, live rows
    (when the ring recorded them), status; long runs elided in the middle
    (the first and last max_rows // 2 rounds are kept)."""
    if not rows:
        return "no convergence records in this trace"
    has_active = any(r.get("active") is not None for r in rows)
    if has_active:
        head = ["round      gap            updates   active  status",
                "-----      ---            -------   ------  ------"]
    else:
        head = ["round      gap            updates  status",
                "-----      ---            -------  ------"]
    idx = list(range(len(rows)))
    if len(idx) > max_rows:
        k = max_rows // 2
        idx = idx[:k] + [None] + idx[-k:]
    out = list(head)
    for i in idx:
        if i is None:
            out.append(f"  ... {len(rows) - 2 * (max_rows // 2)} "
                       "rounds elided ...")
            continue
        r = rows[i]
        gap = r.get("gap")
        gap_s = f"{gap:.6e}" if gap is not None else "n/a"
        line = (f"{r.get('round', i + 1):>5}  {gap_s:>13}  "
                f"{r.get('updates', 0):>7}")
        if has_active:
            act = r.get("active")
            line += f"  {act if act is not None else 'n/a':>7}"
        out.append(f"{line}  {r.get('status', '?')}")
    return "\n".join(out)


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
