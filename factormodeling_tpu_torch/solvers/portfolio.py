"""Long/short leg constraints shared by the MVO consumers (port of
``factormodeling_tpu/solvers/portfolio.py``): long leg sums to +1, short to
-1, sign-consistent boxes, zero-signal names pinned to 0, and the
equal-weight-per-leg fallback on solver failure."""

from __future__ import annotations

import torch

__all__ = ["leg_constraints", "equal_leg_fallback", "legs_feasible"]


def leg_constraints(signal_row: torch.Tensor, max_weight: float, dtype,
                    b: torch.Tensor | None = None):
    """``(lo, hi, E, b)`` of the MVO constraint set for one day's signal row.
    ``b`` (``[1, -1]``) may be passed in to avoid rebuilding it every day."""
    pos = signal_row > 0
    neg = signal_row < 0
    zero = torch.zeros(signal_row.shape, dtype=dtype, device=signal_row.device)
    lo = zero.masked_fill(neg, -max_weight)
    hi = zero.masked_fill(pos, max_weight)
    E = torch.stack([pos.to(dtype), neg.to(dtype)])
    if b is None:
        b = torch.tensor([1.0, -1.0], dtype=dtype, device=signal_row.device)
    return lo, hi, E, b


def equal_leg_fallback(signal_row: torch.Tensor) -> torch.Tensor:
    """Equal weights per leg, the solver-failure fallback."""
    pos = signal_row > 0
    neg = signal_row < 0
    cp = torch.clamp(pos.sum(), min=1).to(signal_row.dtype)
    cn = torch.clamp(neg.sum(), min=1).to(signal_row.dtype)
    return pos.to(signal_row.dtype) / cp - neg.to(signal_row.dtype) / cn


def legs_feasible(signal_row: torch.Tensor, max_weight: float) -> torch.Tensor:
    """Whether each leg can reach +-1 under the per-name cap."""
    pos = signal_row > 0
    neg = signal_row < 0
    return (pos.sum() * max_weight >= 1.0) & (neg.sum() * max_weight >= 1.0)
