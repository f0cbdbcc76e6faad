"""Device resolution (entry points run on the card unless asked not to)
and the host-side conversions to and from the card."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when a CUDA device is asked for
    and none is present (the port never falls back to the CPU quietly:
    pass device="cpu", or --device cpu on the command line)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; pass device='cpu' (command line: --device cpu) to "
            "run on the CPU"
        )
    return dev


def host_to_device(data, dtype, device) -> torch.Tensor:
    """A tensor of host data (a list or numpy array) on `device`, copied
    without a host synchronisation: on a CUDA device through pinned memory
    with non_blocking=True (the caching host allocator keeps the pinned
    buffer until the copy has run), so a per-round index list costs no
    stall of the host."""
    t = torch.as_tensor(data, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_dtype(X, dtype: torch.dtype) -> torch.Tensor:
    """Host values as a CPU tensor of `dtype` (numpy has no bfloat16, so
    the cast runs in torch; float32 and float64 round as numpy does)."""
    X = np.asarray(X)
    if not X.flags.writeable:
        X = X.copy()  # torch warns on aliasing read-only memory
    return torch.as_tensor(X).to(dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array on the host; bfloat16 comes back
    as float32 (numpy has no bfloat16), exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
