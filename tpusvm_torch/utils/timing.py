"""Phase timing and the device profiler hook.

PhaseTimer lives in tpusvm_torch.obs.trace as a span adapter (each phase
also lands in an attached JSONL Tracer); this module re-exports it.

trace(log_dir) wraps torch.profiler for kernel-level traces (`--profile
DIR` / `--xprof DIR` on the command line): the body runs under the
profiler and a Chrome trace is written into DIR, with CUDA activity
recorded when the device is a card. On a card, a profile that holds no
CUDA activity is an error, never a quiet host-only file. With a JSONL
tracer (`--trace` beside `--profile`), the profile's first operation is a
marker launched at a perf_counter time that a `profile.anchor` event
records, so the profile's operations can be placed on the clock of the
trace's spans.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

from tpusvm_torch.obs.trace import PhaseTimer  # noqa: F401 — re-export

__all__ = ["ANCHOR", "PhaseTimer", "trace", "TRACE_FILE"]

# the Chrome trace's name inside the profile directory
TRACE_FILE = "trace.json"

# the name of the marker region that opens a profile taken beside a tracer
ANCHOR = "tpusvm.profile.anchor"


def _cuda_activity(prof) -> int:
    """Device-side events of a finished profile (kernels, copies)."""
    from torch.autograd import DeviceType

    events = prof.events()
    n = sum(1 for e in events
            if getattr(e, "device_type", None) == DeviceType.CUDA)
    # some releases hang a kernel on the host op that launched it instead
    return n or sum(len(getattr(e, "kernels", None) or ()) for e in events)


def _anchor(tracer, on_card: bool) -> None:
    """The profile's first operation: a one-element `aten::ones` inside the
    region named ANCHOR, launched at a perf_counter time that the tracer's
    `profile.anchor` event records (attrs marker, op, t). In trace.json
    that op's host event starts at t, so an operation's ts (microseconds)
    lies at t + (ts - the op's ts) * 1e-6 on the clock of the trace's
    spans; on a card its fill kernel, the profile's first device
    operation, starts a launch's latency later."""
    import torch

    if on_card:
        torch.cuda.synchronize()
    with torch.profiler.record_function(ANCHOR):
        t = time.perf_counter()
        torch.ones(1, device="cuda" if on_card else "cpu")
    if on_card:
        torch.cuda.synchronize()
    tracer.event("profile.anchor", marker=ANCHOR, op="aten::ones", t=t)


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: str = "cuda",
          tracer=None) -> Iterator[None]:
    """`with trace("prof_dir"):` profiles the body into
    prof_dir/trace.json (view in Perfetto or chrome://tracing); `with
    trace(None):` is a no-op. device: "cuda" records the card's activity
    too, and raises if the body launched nothing on it. tracer: a JSONL
    Tracer that receives the `profile.anchor` event tying the profile to
    its spans' clock (`_anchor`)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = str(device).startswith("cuda")
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if tracer is not None:
            _anchor(tracer, on_card)
        yield
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    if on_card and _cuda_activity(prof) == 0:
        raise RuntimeError(
            f"--profile {log_dir}: the profile holds no CUDA activity "
            "(CUPTI recorded no kernel); the body's device work is not in "
            "it")
