"""device_idle_share: the share of the traced window in which no
operation ran on the device, 100 * (1 - union of the device intervals /
window), from the profiler's trace."""

from perfbench.core import devtrace


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_seconds(run.trace)
                    / run.trace.window_s)
