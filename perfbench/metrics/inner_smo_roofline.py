"""inner_smo_roofline: the working-set subproblem's share of its roofline
(kernel #2 and its problem-axis launch 2b: csrc/inner_smo.cu),
100 * (least time its launches in the traced window need) / (their
device time).

Counted once, from shapes and the updates the solves report: each lane
reads its (q, q) K_BB once and its y, alpha, f and mask, and writes its
alphas (bytes, against HBM's bandwidth); each update of a pair scans the
q members for the partner's gain and moves their f, about 10 q float32
operations (against the float32 peak outside the tensor cores). The
least time is the larger of the two; at these shapes the bytes'."""

from perfbench.core import devtrace, peaks

KERNELS = ("inner_smo_kernel",)
OPS_PER_MEMBER_UPDATE = 10


def count(q: int, lanes: float, updates: float):
    """(operations, bytes) of one launch over `lanes` lanes that made
    `updates` pair updates in all."""
    ops = float(OPS_PER_MEMBER_UPDATE) * q * updates
    nbytes = 4.0 * lanes * (q * q + 5 * q)
    return ops, nbytes


def least_seconds(q, launches, lanes, updates):
    if not launches:
        return 0.0, "none"
    ops, nbytes = count(q, lanes / launches, updates / launches)
    t_ops, t_bytes = ops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES
    bound = "operations" if t_ops >= t_bytes else "bytes"
    return launches * max(t_ops, t_bytes), bound


def read(run):
    if run.trace is None:
        return None
    secs, _ = devtrace.kernel_seconds(run.trace, KERNELS)
    launches = sum(u["counters"]["inner_launches"] for u in run.units)
    lanes = sum(u["counters"]["inner_lanes"] or 0 for u in run.units)
    updates = sum(u["counters"]["updates"] for u in run.units)
    if secs <= 0 or not launches:
        return None
    least, bound = least_seconds(run.q, launches, lanes, updates)
    run.note(f"inner_smo_roofline: {launches} launches, {lanes} lanes, "
             f"{updates} updates, least {least:.6f} s ({bound}) over "
             f"{secs:.6f} s")
    return 100.0 * least / secs
