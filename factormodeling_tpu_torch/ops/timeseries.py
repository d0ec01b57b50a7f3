"""Time-series ops: per-symbol trailing-window transforms (port of
``factormodeling_tpu/ops/timeseries.py``; reference ``operations.py:6-51``).

Each op is a pandas ``groupby(symbol).rolling(window)`` with
``min_periods == window``: a cell is defined only when all ``window``
trailing observations of that symbol are non-NaN. Arrays are
``[..., D, N]`` (date axis -2, asset axis -1), and a per-symbol rolling op
is a windowed reduction along the date axis over all N columns at once.

Dispatch: on a CUDA tensor with ``window >= 2``, ``ts_std``, ``ts_zscore``,
``ts_rank`` and ``ts_decay`` launch the window-streaming kernel
(:mod:`._cuda_window`); every other case (the CPU, ``window < 2``, the ops
without a kernel) takes the torch counterpart of the JAX package's XLA
formulation below, which is that package's own CPU path. The JAX dispatch
also asks for ``N >= 128`` and ``D >= 8``, a concern of the TPU's 128-lane
padding that the card does not share, so those conditions are not copied.
"""

from __future__ import annotations

import functools

import torch

from factormodeling_tpu_torch.ops import _cuda_window as _cw
from factormodeling_tpu_torch.ops._window import (compaction_order,
                                                  forward_fill, rolling_count,
                                                  rolling_sum, shift)

__all__ = [
    "ts_sum",
    "ts_mean",
    "ts_std",
    "ts_zscore",
    "ts_rank",
    "ts_diff",
    "ts_delay",
    "ts_decay",
    "ts_backfill",
]

_DATE_AXIS = -2


def _use_streaming(x: torch.Tensor, window: int) -> bool:
    """The kernel takes every CUDA panel with a window of at least 2."""
    return x.device.type == "cuda" and x.ndim >= 2 and window >= 2


def _over_universe(op):
    """Give a time-series op pandas ragged-universe semantics.

    pandas rolling ops run on each symbol's own date sequence: a symbol
    absent on some dates has no row there, so windows and shifts span the
    gap. On dense arrays: compact each column's present cells to the front
    (stable order by presence), run the op, gather back, NaN out absent
    cells. ``universe=None`` skips the permutation. In-universe NaN values
    still count as NaN observations, as a NaN-valued pandas row does.
    """

    @functools.wraps(op)
    def wrapped(x: torch.Tensor, *args, universe: torch.Tensor | None = None,
                **kwargs):
        if universe is None:
            return op(x, *args, **kwargs)
        present = universe.expand(x.shape)
        order, inv = compaction_order(present, axis=_DATE_AXIS)
        xc = torch.take_along_dim(torch.where(present, x, float("nan")), order,
                                  dim=_DATE_AXIS)
        out = torch.take_along_dim(op(xc, *args, **kwargs), inv, dim=_DATE_AXIS)
        return torch.where(present, out, float("nan"))

    return wrapped


def _windowed(x: torch.Tensor, window: int):
    """(zero-filled values, full-window-valid mask)."""
    valid = ~torch.isnan(x)
    filled = torch.where(valid, x, 0.0)
    full = rolling_count(valid, window, axis=_DATE_AXIS) == window
    return filled, full


@_over_universe
def ts_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing-window sum (reference ``operations.py:6``)."""
    filled, full = _windowed(x, window)
    s = rolling_sum(filled, window, axis=_DATE_AXIS)
    return torch.where(full, s, float("nan"))


@_over_universe
def ts_mean(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing-window mean (reference ``operations.py:10``)."""
    filled, full = _windowed(x, window)
    s = rolling_sum(filled, window, axis=_DATE_AXIS)
    return torch.where(full, s / window, float("nan"))


def _ts_moments(x: torch.Tensor, window: int):
    """Rolling mean, ddof=1 variance (raw moments, clamped at 0) and the
    full-window mask. A full window with no changed consecutive pair and no
    infinity has variance exactly 0, as pandas' rolling std does."""
    filled, full = _windowed(x, window)
    s1 = rolling_sum(filled, window, axis=_DATE_AXIS)
    s2 = rolling_sum(filled * filled, window, axis=_DATE_AXIS)
    mean = s1 / window
    if window <= 1:
        # ddof=1 with one observation: pandas std is NaN everywhere
        return mean, torch.full_like(mean, float("nan")), full
    var = torch.clamp(s2 - s1 * mean, min=0.0) / (window - 1)
    changed = torch.cat(
        [torch.ones_like(filled[..., :1, :]),
         (filled[..., 1:, :] != filled[..., :-1, :]).to(filled.dtype)],
        dim=_DATE_AXIS)
    n_changes = rolling_sum(changed, window - 1, axis=_DATE_AXIS)
    all_finite = rolling_count(torch.isfinite(x), window,
                               axis=_DATE_AXIS) == window
    var = torch.where(full & all_finite & (n_changes == 0), 0.0, var)
    return mean, var, full


@_over_universe
def ts_std(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing-window sample std, ddof=1 (reference ``operations.py:14``)."""
    if _use_streaming(x, window):
        return _cw.ts_std_streaming(x.contiguous(), window)
    _, var, full = _ts_moments(x, window)
    return torch.where(full, torch.sqrt(var), float("nan"))


@_over_universe
def ts_zscore(x: torch.Tensor, window: int) -> torch.Tensor:
    """(x - rolling mean) / rolling std, std == 0 -> NaN (reference
    ``operations.py:18-21``); the rule fires on every constant window (the
    JAX package documents pandas' path-dependent divergence)."""
    if _use_streaming(x, window):
        return _cw.ts_zscore_streaming(x.contiguous(), window)
    mean, var, full = _ts_moments(x, window)
    std = torch.sqrt(var)
    std = torch.where(std == 0.0, float("nan"), std)
    return torch.where(full, (x - mean) / std, float("nan"))


@_over_universe
def ts_rank(x: torch.Tensor, window: int) -> torch.Tensor:
    """Fractional average-tie rank of the last element within its trailing
    window (reference ``operations.py:23-32``): pandas
    ``rolling(w, min_periods=w).apply(lambda s: s.rank(pct=True).iloc[-1])``.
    """
    if _use_streaming(x, window):
        return _cw.ts_rank_streaming(x.contiguous(), window)
    _, full = _windowed(x, window)
    less = torch.zeros_like(x)
    eq = torch.zeros_like(x)
    for j in range(window):
        lagged = torch.roll(x, j, dims=_DATE_AXIS)  # rows < j wrap around,
        less = less + (lagged < x).to(x.dtype)      # masked out by `full`
        eq = eq + (lagged == x).to(x.dtype)
    pct = (less + 0.5 * (eq + 1.0)) / window
    return torch.where(full, pct, float("nan"))


@_over_universe
def ts_diff(x: torch.Tensor, window: int) -> torch.Tensor:
    """x - x.shift(window) per symbol (reference ``operations.py:34``)."""
    return x - shift(x, window, axis=_DATE_AXIS)


@_over_universe
def ts_delay(x: torch.Tensor, window: int) -> torch.Tensor:
    """x.shift(window) per symbol (reference ``operations.py:37``)."""
    return shift(x, window, axis=_DATE_AXIS)


@_over_universe
def ts_decay(x: torch.Tensor, window: int) -> torch.Tensor:
    """Linear-decay weighted trailing mean, weights 1..window with the
    heaviest on the newest observation; ``window < 1`` is the identity
    (reference ``operations.py:40-48``)."""
    if window < 1:
        return x
    if _use_streaming(x, window):
        return _cw.decay_streaming(x.contiguous(), window)
    filled, full = _windowed(x, window)
    acc = torch.zeros_like(x)
    for j in range(window):
        acc = acc + (window - j) * torch.roll(filled, j, dims=_DATE_AXIS)
    denom = window * (window + 1) / 2.0
    return torch.where(full, acc / denom, float("nan"))


@_over_universe
def ts_backfill(x: torch.Tensor) -> torch.Tensor:
    """Per-symbol forward-fill (reference ``operations.py:50``; the name is
    historical, the reference implementation is an ffill)."""
    return forward_fill(x, axis=_DATE_AXIS)
