"""launch_host_ms: host milliseconds a fit's outer loop spends launching
K_BB, the subproblem (#2) and the f-update (#1) and carrying f: the
solve.kbb, solve.inner and solve.fupdate spans of
blocked_smo_solve(tracer=), summed, mean per fit. Nothing to read where
the program records no such spans."""

SPANS = ("solve.kbb", "solve.inner", "solve.fupdate")


def read(run):
    secs = [b - a for name, a, b in run.spans.spans if name in SPANS]
    if not secs or not run.n_units:
        return None
    return 1e3 * sum(secs) / run.n_units
