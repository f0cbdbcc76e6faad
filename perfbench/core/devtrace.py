"""The device trace of a `--trace 1` run, read from torch.profiler.

`by_kernel` is a frozen copy of the arithmetic of chip_smoke.py's
`device_ms_by_kernel` (as of the port's last bring-up commit): the
device time and the launches of each kernel name, summed over the
profiler's CUDA events. It lives here so that a later change to the
program's own profiling helpers (tpusvm_torch/utils/timing.py,
chip_smoke.py) cannot move the yardstick. Beside it: the union of the
device's busy intervals, and its idle gaps, on the host's perf_counter
clock, so that each gap can be named by the host span it fell in. The
profiler records the device's activity only (not every host-side
operator, whose parsing would outlast the run); a marker operation
launched at a known host time, the trace's first, ties the two clocks
to within a launch's latency.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

@dataclass
class Trace:
    # (name, start, end) of every device operation, perf_counter seconds
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    t0: float = 0.0   # the traced window, perf_counter seconds
    t1: float = 0.0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def base_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template or
    arguments: "void (anonymous namespace)::inner_smo_kernel(float
    const*, ...)" -> "inner_smo_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name.strip().rsplit("::", 1)[-1]


def start():
    """A running profiler of the device, and the marker: returns
    (profiler, the perf_counter seconds at which the marker, the trace's
    first device operation, was launched)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize()
    anchor = time.perf_counter()
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    return prof, anchor


def stop(prof, anchor: float, t0: float, t1: float) -> Trace:
    """Ends the profiler and reads its device operations onto the host
    clock: the first of them, the marker, started at `anchor`."""
    import torch

    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    raw = []  # (name, start ns, duration ns) of the device operations
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None and hasattr(results, "events"):
        for e in results.events():
            if str(e.device_type()).endswith("CUDA"):
                raw.append((e.name(), e.start_ns(), e.duration_ns()))
    else:  # an older profiler: FunctionEvents in microseconds
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                raw.append((e.name, e.time_range.start * 1e3,
                            (e.time_range.end - e.time_range.start) * 1e3))
    if not raw:
        raise RuntimeError("the profiler's trace holds no device operation")
    raw.sort(key=lambda o: o[1])
    offset = anchor - raw[0][1] * 1e-9
    ops = [(name, s * 1e-9 + offset, (s + d) * 1e-9 + offset)
           for name, s, d in raw[1:]]
    return Trace(ops=ops, t0=t0, t1=t1)


def by_kernel(trace: Trace) -> Tuple[Dict[str, float], Dict[str, int]]:
    """({kernel name: device seconds}, {kernel name: launches}) over the
    traced window (chip_smoke.py's device_ms_by_kernel, in seconds)."""
    secs, count = {}, {}
    for name, s, e in trace.ops:
        if e <= trace.t0 or s >= trace.t1:
            continue
        secs[name] = secs.get(name, 0.0) + (e - s)
        count[name] = count.get(name, 0) + 1
    return secs, count


def kernel_seconds(trace: Trace, names) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose base name is in
    `names`, over the traced window."""
    names = set(names)
    secs, count = by_kernel(trace)
    s = sum(v for k, v in secs.items() if base_name(k) in names)
    c = sum(v for k, v in count.items() if base_name(k) in names)
    return s, c


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the
    window, as disjoint (start, end) pairs in order."""
    out = []
    for _, s, e in trace.ops:
        s, e = max(s, trace.t0), min(e, trace.t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_seconds(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's stretches with no device operation, longest first."""
    gaps, t = [], trace.t0
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = e
    if trace.t1 > t:
        gaps.append((t, trace.t1))
    return sorted(gaps, key=lambda g: g[0] - g[1])
