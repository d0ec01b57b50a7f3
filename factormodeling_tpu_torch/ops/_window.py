"""Rolling-window and shift primitives over the date axis (port of
``factormodeling_tpu/ops/_window.py``).

pandas ``rolling(window)`` / ``shift`` semantics on dense panels: date axis
-2, asset axis -1, any leading batch dims. A window sum is a direct sum of
each trailing window (``unfold``), not a cumsum difference, so no long-range
cancellation enters it. Ragged-universe shifts compact present cells to the
front with a stable order and gather back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rolling_sum", "rolling_max", "rolling_min", "rolling_count",
           "rolling_valid", "shift", "compaction_order", "masked_shift",
           "forward_fill"]

_DATE_AXIS = -2


def _rolling_windows(x: torch.Tensor, window: int, pad_value, axis: int):
    """``[..., window]`` view of every trailing window along ``axis`` (moved
    last), the edge padded with ``pad_value``: the one home of the window
    alignment."""
    axis = axis % x.ndim
    padded = F.pad(x.movedim(axis, -1), (window - 1, 0), value=pad_value)
    return padded.unfold(-1, window, 1), axis


def rolling_sum(x: torch.Tensor, window: int, *, axis: int = _DATE_AXIS) -> torch.Tensor:
    """Trailing-window sum: out[t] = sum(x[t-window+1 : t+1]) (zero-padded edge)."""
    wins, axis = _rolling_windows(x, window, 0, axis)
    return wins.sum(-1).movedim(-1, axis)


def rolling_max(x: torch.Tensor, window: int, *, axis: int = _DATE_AXIS) -> torch.Tensor:
    """Trailing-window max (-inf-padded edge)."""
    wins, axis = _rolling_windows(x, window, float("-inf"), axis)
    return wins.amax(-1).movedim(-1, axis)


def rolling_min(x: torch.Tensor, window: int, *, axis: int = _DATE_AXIS) -> torch.Tensor:
    """Trailing-window min (+inf-padded edge)."""
    wins, axis = _rolling_windows(x, window, float("inf"), axis)
    return wins.amin(-1).movedim(-1, axis)


def rolling_count(valid: torch.Tensor, window: int, *, axis: int = _DATE_AXIS) -> torch.Tensor:
    """Trailing-window count of True cells."""
    return rolling_sum(valid.to(torch.int32), window, axis=axis).to(torch.int32)


def rolling_valid(x: torch.Tensor, window: int, *, axis: int = _DATE_AXIS) -> torch.Tensor:
    """Mask of cells where the full trailing window is observed (no NaN)."""
    return rolling_count(~torch.isnan(x), window, axis=axis) == window


def shift(x: torch.Tensor, periods: int = 1, *, axis: int = _DATE_AXIS,
          fill_value=float("nan")) -> torch.Tensor:
    """pandas ``shift(periods)`` along ``axis`` (positive = toward later dates)."""
    if periods == 0:
        return x
    axis = axis % x.ndim
    d = x.shape[axis]
    k = abs(periods)
    if k >= d:
        return torch.full_like(x, fill_value)
    out = torch.full_like(x, fill_value)
    if periods > 0:
        out.narrow(axis, k, d - k).copy_(x.narrow(axis, 0, d - k))
    else:
        out.narrow(axis, 0, d - k).copy_(x.narrow(axis, k, d - k))
    return out


def compaction_order(present: torch.Tensor, *, axis: int = _DATE_AXIS):
    """Stable order that moves present cells to the front of ``axis`` in date
    order, plus its inverse."""
    axis = axis % present.ndim
    d = present.shape[axis]
    shape = [1] * present.ndim
    shape[axis] = d
    ar = torch.arange(d, device=present.device).reshape(shape)
    key = torch.where(present, ar, ar + d)
    order = torch.argsort(key, dim=axis)
    inv = torch.argsort(order, dim=axis)
    return order, inv


def masked_shift(x: torch.Tensor, present: torch.Tensor, periods: int = 1,
                 *, axis: int = _DATE_AXIS) -> torch.Tensor:
    """``groupby(symbol).shift(periods)`` on a ragged universe: a symbol's
    value hops over the dates it is absent; absent cells come out NaN.

    ``present`` may have fewer leading dims than ``x`` (a ``[D, N]``
    universe under an ``[F, D, N]`` stack): the order is computed once on it
    and broadcast, never on a materialized broadcast copy."""
    axis_x = axis % x.ndim
    present = present.expand(x.shape[x.ndim - present.ndim:])
    order, inv = compaction_order(present, axis=axis_x - (x.ndim - present.ndim))
    compact = torch.take_along_dim(x, order.expand(x.shape), dim=axis_x)
    moved = shift(compact, periods, axis=axis_x)
    out = torch.take_along_dim(moved, inv.expand(x.shape), dim=axis_x)
    return torch.where(present, out, float("nan"))


def forward_fill(x: torch.Tensor, *, axis: int = _DATE_AXIS) -> torch.Tensor:
    """Per-column forward fill (reference ``ts_backfill``, despite its name an
    ffill): each cell takes the last non-NaN value at or before it."""
    axis = axis % x.ndim
    d = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = d
    ar = torch.arange(d, device=x.device).reshape(shape).expand(x.shape)
    last = torch.cummax(torch.where(torch.isnan(x), -1, ar), dim=axis).values
    filled = torch.take_along_dim(x, torch.clamp(last, 0, d - 1), dim=axis)
    return torch.where(last >= 0, filled, float("nan"))
