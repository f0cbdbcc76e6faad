"""Keerthi index-set masks over (alpha, y).

Selection itself (first-occurrence argmin/argmax, stable top-k) lives with
its callers; torch.argmin/argmax return the first extremum, the
deterministic tie-break the reference's serial scan uses.
"""

from __future__ import annotations

from typing import Optional

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
