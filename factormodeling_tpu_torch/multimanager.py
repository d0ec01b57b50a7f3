"""Multi-manager layer (port of ``factormodeling_tpu/multimanager.py``): one
simulated book per factor, combined by daily factor weights into a single
portfolio.

Reference: ``multi_manager.py``. The JAX package ``vmap``s the per-factor
weight pass over the manager axis. The port's engine works on ``[D, N]``
panels (its shifts run along the date axis of a ``[D, N]`` signal), so the
managers are a loop of ``daily_trade_list`` calls, each a batched pass over
all dates, stacked into ``[M, D, N]`` books. The combination is one
contraction over managers with the reference's NaN rules: pandas
``.add(..., fill_value=0)`` replaces NaN values (not just missing labels)
with the fill before adding, so every NaN book cell and NaN factor weight
contributes exactly 0, while the counts take no fill and a NaN factor
weight poisons that date's counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from factormodeling_tpu_torch._device import check_device
from factormodeling_tpu_torch.backtest.engine import daily_trade_list
from factormodeling_tpu_torch.backtest.pnl import (DailyResult,
                                                   daily_portfolio_returns)
from factormodeling_tpu_torch.backtest.settings import SimulationSettings

__all__ = ["MultiManagerOutput", "compute_manager_weights",
           "compute_multimanager_weights", "run_multimanager_backtest"]


class MultiManagerOutput(NamedTuple):
    weights: torch.Tensor      # [D, N] combined (already shifted) book
    long_count: torch.Tensor   # [D] factor-weighted long counts
    short_count: torch.Tensor  # [D]
    result: DailyResult


def compute_manager_weights(factors: torch.Tensor,
                            settings: SimulationSettings, *, device=None):
    """Per-factor daily weight books: ``[M, D, N]`` shifted weights plus
    ``[M, D]`` long and short counts (reference ``compute_manager_weights``
    per factor, one ``daily_trade_list`` call a manager)."""
    check_device(device, factors, settings.returns)
    books, longs, shorts = [], [], []
    for signal in factors:
        w, lc, sc, _diag = daily_trade_list(signal, settings)
        books.append(w)
        longs.append(lc)
        shorts.append(sc)
    return torch.stack(books), torch.stack(longs), torch.stack(shorts)


def compute_multimanager_weights(factors: torch.Tensor,
                                 factor_weights: torch.Tensor,
                                 settings: SimulationSettings, *,
                                 device=None):
    """Combine manager books with daily factor weights
    (``multi_manager.py:32-81``).

    Args:
      factors: ``float[M, D, N]`` manager signals (already investability-
        masked if desired; the reference passes raw factor columns).
      factor_weights: ``float[D, M]`` daily factor weights.

    Returns (combined weights [D, N], long_count [D], short_count [D]), in
    the promoted type of the books and the weights.
    """
    check_device(device, factor_weights)
    books, lc, sc = compute_manager_weights(factors, settings, device=device)
    dtype = torch.promote_types(books.dtype, factor_weights.dtype)
    fw = factor_weights.to(dtype)
    combined = torch.einsum("md,mdn->dn", torch.nan_to_num(fw).T,
                            torch.nan_to_num(books.to(dtype)))
    # counts have no fill_value in the reference (multi_manager.py:69-70):
    # a NaN factor weight makes that date's counts NaN
    lc_c = (fw.T * lc).sum(0)
    sc_c = (fw.T * sc).sum(0)
    return combined, lc_c, sc_c


def run_multimanager_backtest(factors: torch.Tensor,
                              factor_weights: torch.Tensor,
                              settings: SimulationSettings, *,
                              device=None) -> MultiManagerOutput:
    """Combined book -> P&L (``multi_manager.py:84-100``; the combined
    weights are already shifted by the per-manager pass, so no second lag).
    ``device=None`` is the card; the inputs must lie on the device asked
    for."""
    combined, lc, sc = compute_multimanager_weights(
        factors, factor_weights, settings, device=device)
    result = daily_portfolio_returns(combined, settings)
    return MultiManagerOutput(weights=combined, long_count=lc, short_count=sc,
                              result=result)
