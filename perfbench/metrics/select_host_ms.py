"""select_host_ms: host milliseconds a fit's outer loop spends on its
n-row work each round, the stop check's masks and reductions and the
working set's selection and gathers: the solve.check and solve.select
spans of blocked_smo_solve(tracer=), summed, mean per fit. Nothing to
read where the program records no such spans."""

SPANS = ("solve.check", "solve.select")


def read(run):
    secs = [b - a for name, a, b in run.spans.spans if name in SPANS]
    if not secs or not run.n_units:
        return None
    return 1e3 * sum(secs) / run.n_units
