"""Long/short leg constraints shared by the MVO consumers (port of
``factormodeling_tpu/solvers/portfolio.py``): long leg sums to +1, short to
-1, sign-consistent boxes, zero-signal names pinned to 0, and the
equal-weight-per-leg fallback on solver failure. Each helper takes one
day's signal row ``[N]`` or a stack of rows ``[B, N]``; ``max_weight`` is a
number or, over rows, a ``[B]`` tensor (one cap a row)."""

from __future__ import annotations

import torch

from factormodeling_tpu_torch.backtest.settings import knob

__all__ = ["leg_constraints", "equal_leg_fallback", "legs_feasible"]


def leg_constraints(signal_row: torch.Tensor, max_weight: float, dtype,
                    b: torch.Tensor | None = None):
    """``(lo, hi, E, b)`` of the MVO constraint set for a signal row
    (``E`` is ``[..., 2, N]``, ``b`` ``[..., 2]``). ``b`` (``[1, -1]``) may
    be passed in to avoid rebuilding it every day."""
    pos = signal_row > 0
    neg = signal_row < 0
    zero = torch.zeros(signal_row.shape, dtype=dtype, device=signal_row.device)
    if isinstance(max_weight, torch.Tensor):
        cap = knob(max_weight, zero)
        lo = torch.where(neg, -cap, zero)
        hi = torch.where(pos, cap, zero)
    else:
        lo = zero.masked_fill(neg, -max_weight)
        hi = zero.masked_fill(pos, max_weight)
    E = torch.stack([pos.to(dtype), neg.to(dtype)], dim=-2)
    if b is None:
        b = torch.tensor([1.0, -1.0], dtype=dtype, device=signal_row.device)
    return lo, hi, E, b.expand(signal_row.shape[:-1] + (2,))


def equal_leg_fallback(signal_row: torch.Tensor) -> torch.Tensor:
    """Equal weights per leg, the solver-failure fallback."""
    pos = signal_row > 0
    neg = signal_row < 0
    cp = torch.clamp(pos.sum(-1, keepdim=True), min=1).to(signal_row.dtype)
    cn = torch.clamp(neg.sum(-1, keepdim=True), min=1).to(signal_row.dtype)
    return pos.to(signal_row.dtype) / cp - neg.to(signal_row.dtype) / cn


def legs_feasible(signal_row: torch.Tensor, max_weight: float) -> torch.Tensor:
    """Whether each leg can reach +-1 under the per-name cap."""
    pos = signal_row > 0
    neg = signal_row < 0
    cp, cn = pos.sum(-1), neg.sum(-1)
    cap = knob(max_weight, cp, torch.get_default_dtype())
    return (cp * cap >= 1.0) & (cn * cap >= 1.0)
