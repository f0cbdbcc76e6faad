"""Device resolution: entry points run on the card unless asked not to."""

from __future__ import annotations

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
