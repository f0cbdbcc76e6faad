"""Phase timing and the device profiler hook.

PhaseTimer lives in tpusvm_torch.obs.trace as a span adapter (each phase
also lands in an attached JSONL Tracer); this module re-exports it.

trace(log_dir) wraps torch.profiler for kernel-level traces (`--profile
DIR` / `--xprof DIR` on the command line): the body runs under the
profiler and a Chrome trace is written into DIR, with CUDA activity
recorded when the device is a card. On a card, a profile that holds no
CUDA activity is an error, never a quiet host-only file.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

from tpusvm_torch.obs.trace import PhaseTimer  # noqa: F401 — re-export

__all__ = ["PhaseTimer", "trace", "TRACE_FILE"]

# the Chrome trace's name inside the profile directory
TRACE_FILE = "trace.json"


def _cuda_activity(prof) -> int:
    """Device-side events of a finished profile (kernels, copies)."""
    from torch.autograd import DeviceType

    events = prof.events()
    n = sum(1 for e in events
            if getattr(e, "device_type", None) == DeviceType.CUDA)
    # some releases hang a kernel on the host op that launched it instead
    return n or sum(len(getattr(e, "kernels", None) or ()) for e in events)


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: str = "cuda") -> Iterator[None]:
    """`with trace("prof_dir"):` profiles the body into
    prof_dir/trace.json (view in Perfetto or chrome://tracing); `with
    trace(None):` is a no-op. device: "cuda" records the card's activity
    too, and raises if the body launched nothing on it."""
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
        yield
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    if on_card and _cuda_activity(prof) == 0:
        raise RuntimeError(
            f"--profile {log_dir}: the profile holds no CUDA activity "
            "(CUPTI recorded no kernel); the body's device work is not in "
            "it")
