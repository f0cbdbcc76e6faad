"""train_mfu: the whole fit's share of the card's peak: the float32
operations the solves need, counted once from shapes, over (the traced
window x the dense TF32 peak, 495 TFLOP/s). Per lane and round the
solve reported: the f-update, 2 n q d, and K_BB, 2 q^2 d; the rest
(selection, the subproblem) is O(n) or O(q) an update and left out.
The card's power limit is printed beside it."""

from perfbench.core import peaks


def count(n: int, d: int, q: int, lane_rounds: float) -> float:
    return (2.0 * n * q * d + 2.0 * q * q * d) * lane_rounds


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    lane_rounds = sum(u["counters"]["kbb_lanes"] or 0 for u in run.units)
    ops = count(run.n, run.d, run.q, lane_rounds)
    run.note(f"train_mfu: {lane_rounds} lane-rounds, {ops:.6e} operations "
             f"in {run.trace.window_s:.6f} s; card: {run.power}")
    return 100.0 * ops / (run.trace.window_s * peaks.TF32_FLOPS)
