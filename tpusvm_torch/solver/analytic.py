"""The analytic 2-variable SMO update, shared by every engine.

Box bounds [U, V] from s = y_h*y_l, the eta positivity guard, the
reference's clip order (cap at V first, then floor at U) and zero-progress
(stall) detection. Inputs are 0-d tensors of one dtype (or python floats
for C and eps); the arithmetic stays in that dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PairUpdate(NamedTuple):
    da_h: torch.Tensor      # change to alpha[i_high] (0 unless do_update)
    da_l: torch.Tensor      # change to alpha[i_low]
    feasible: torch.Tensor  # U <= V + 1e-12
    eta_ok: torch.Tensor    # eta > eps
    do_update: torch.Tensor
    stalled: torch.Tensor   # do_update but both deltas rounded to exactly 0


def pair_update(K11, K22, K12, y_h, y_l, a_h, a_l, b_high, b_low, C, eps,
                proceed) -> PairUpdate:
    """The clipped 2-alpha step; `proceed` False gives zero deltas."""
    zero = torch.zeros_like(a_h)
    C = torch.as_tensor(C, dtype=a_h.dtype, device=a_h.device)
    s = y_h * y_l
    eta = K11 + K22 - 2.0 * K12
    U = torch.where(s < 0, torch.maximum(zero, a_l - a_h),
                    torch.maximum(zero, a_l + a_h - C))
    V = torch.where(s < 0, torch.minimum(C, C + a_l - a_h),
                    torch.minimum(C, a_l + a_h))
    feasible = U <= V + 1e-12
    eta_ok = eta > eps
    do_update = proceed & feasible & eta_ok
    safe_eta = torch.where(eta_ok, eta, torch.ones_like(eta))
    a_l_new = a_l + y_l * (b_high - b_low) / safe_eta
    # reference clip order: cap at V first, then floor at U
    a_l_new = torch.maximum(torch.minimum(a_l_new, V), U)
    a_h_new = a_h + s * (a_l - a_l_new)
    da_h = torch.where(do_update, a_h_new - a_h, zero)
    da_l = torch.where(do_update, a_l_new - a_l, zero)
    stalled = do_update & (da_h == 0) & (da_l == 0)
    return PairUpdate(da_h, da_l, feasible, eta_ok, do_update, stalled)
