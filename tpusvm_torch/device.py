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
