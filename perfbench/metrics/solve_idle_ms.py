"""solve_idle_ms: milliseconds a fit's solve leaves the device idle: each
fit.solve span's length less the union of the device's busy intervals
inside it (devtrace.busy_intervals, clipped to the span), mean per fit.
Nothing to read without a device trace or fit.solve spans."""

from perfbench.core import devtrace


def idle_seconds(busy, t0: float, t1: float) -> float:
    """The part of [t0, t1] that the disjoint `busy` intervals leave
    uncovered."""
    covered = sum(max(0.0, min(e, t1) - max(s, t0)) for s, e in busy)
    return (t1 - t0) - covered


def read(run):
    if run.trace is None or not run.n_units:
        return None
    solves = [(a, b) for name, a, b in run.spans.spans if name == "fit.solve"]
    if not solves:
        return None
    busy = devtrace.busy_intervals(run.trace)
    idle = sum(idle_seconds(busy, a, b) for a, b in solves)
    run.note(f"solve_idle_ms: {len(solves)} fit.solve spans, "
             f"{idle:.6f} s idle of {sum(b - a for a, b in solves):.6f} s")
    return 1e3 * idle / run.n_units
