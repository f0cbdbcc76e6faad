"""Keerthi index-set masks over (alpha, y) and the masked first-order picks.

torch.argmin/argmax document that they return the index of the FIRST
extremum, the deterministic tie-break of the reference's serial scan
(strict improvement), so the masked picks below take ties to the lowest
index as jnp.argmin/argmax do. Stable top-k selection lives with the
blocked solver.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def i_high_mask(alpha, y, C, eps, valid: Optional[torch.Tensor] = None):
    """I_high = {y=+1, a < C-eps} u {y=-1, a > eps}."""
    m = torch.where(y == 1, alpha < C - eps, (y == -1) & (alpha > eps))
    if valid is not None:
        m = m & valid
    return m


def i_low_mask(alpha, y, C, eps, valid: Optional[torch.Tensor] = None):
    """I_low = {y=+1, a > eps} u {y=-1, a < C-eps}."""
    m = torch.where(y == 1, alpha > eps, (y == -1) & (alpha < C - eps))
    if valid is not None:
        m = m & valid
    return m


def masked_argmin(f, mask, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first argmin of f over mask, any(mask)) along `dim`; entries
    outside the mask count as +inf."""
    vals = torch.where(mask, f, float("inf"))
    return torch.argmin(vals, dim=dim), mask.any(dim=dim)


def masked_argmax(f, mask, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first argmax of f over mask, any(mask)); entries outside the mask
    count as -inf."""
    vals = torch.where(mask, f, -float("inf"))
    return torch.argmax(vals, dim=dim), mask.any(dim=dim)
