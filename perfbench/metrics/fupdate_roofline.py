"""fupdate_roofline: the f-update's share of its roofline (kernel #1 and
its problem-axis launch 1b: csrc/fused_fupdate.cu, csrc/rbf_tile.cuh),
100 * (least time its launches in the traced window need) / (their
device time).

Counted once, from shapes, whatever the kernel computes again: each
lane of a launch multiplies its (n, d) rows by the working set's (q, d)
rows, 2 n q d operations at float32 accuracy, against the dense TF32
tensor-core peak (3xTF32 emulates float32 there, but the algorithm's
operations are counted once); bytes: X and its norms read once a
launch, each lane's X_B and coefficients read and its (n,) f-update
written, against HBM's bandwidth. The least time of a launch is the
larger of the two, and at these shapes it is the operations' (the
reading prints which). Device time: the kernels the f-update launches
(the TF32 split of X_B, the tile kernel, the partial sums)."""

from perfbench.core import devtrace, peaks

KERNELS = ("rbf_cross_matvec_kernel", "tf32_split_kernel",
           "sum_partials_kernel")


def count(n: int, d: int, q: int, lanes: float):
    """(operations, bytes) of one launch over `lanes` lanes."""
    ops = 2.0 * n * q * d * lanes
    nbytes = 4.0 * (n * d + n + lanes * (q * d + q + n))
    return ops, nbytes


def least_seconds(n, d, q, launches, lanes):
    """Least time of `launches` launches carrying `lanes` lanes in all,
    and which bound it is."""
    if not launches:
        return 0.0, "none"
    ops, nbytes = count(n, d, q, lanes / launches)
    t_ops, t_bytes = ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES
    bound = "operations" if t_ops >= t_bytes else "bytes"
    return launches * max(t_ops, t_bytes), bound


def read(run):
    if run.trace is None:
        return None
    secs, _ = devtrace.kernel_seconds(run.trace, KERNELS)
    launches = sum(u["counters"]["fupdate_launches"] for u in run.units)
    lanes = sum(u["counters"]["fupdate_lanes"] or 0 for u in run.units)
    if secs <= 0 or not launches:
        return None
    least, bound = least_seconds(run.n, run.d, run.q, launches, lanes)
    run.note(f"fupdate_roofline: {launches} launches, {lanes} lanes, "
             f"least {least:.6f} s ({bound}) over {secs:.6f} s")
    return 100.0 * least / secs
