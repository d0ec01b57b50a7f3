"""Daily portfolio P&L with tiered transaction costs (port of
``factormodeling_tpu/backtest/pnl.py::daily_portfolio_returns``).

NaN weights/returns are zero-filled, the first date's turnover diff counts
0, the net column is the weighted sum of log-returns (named
``log_return``), and per-name P&L always subtracts costs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.ops._window import shift

__all__ = ["DailyResult", "daily_portfolio_returns"]

_N_AXIS = -1


class DailyResult(NamedTuple):
    log_return: torch.Tensor      # [D] net daily return (after costs if enabled)
    long_return: torch.Tensor     # [D]
    short_return: torch.Tensor    # [D]
    long_turnover: torch.Tensor   # [D]
    short_turnover: torch.Tensor  # [D]
    turnover: torch.Tensor        # [D]
    long_pnl_by_name: torch.Tensor   # [N] after-cost per-name long P&L
    short_pnl_by_name: torch.Tensor  # [N] after-cost per-name short P&L


def daily_portfolio_returns(weights: torch.Tensor,
                            s: SimulationSettings) -> DailyResult:
    """P&L of (already shifted) daily weights against the settings panels."""
    w = torch.nan_to_num(weights)
    r = torch.nan_to_num(s.returns)
    longs = torch.clamp(w, min=0.0)
    shorts = torch.abs(torch.clamp(w, max=0.0))

    long_ret_raw = (longs * r).sum(_N_AXIS)
    short_ret_raw = -(shorts * r).sum(_N_AXIS)

    dlong = torch.nan_to_num(torch.abs(longs - shift(longs, 1, axis=0)))
    dshort = torch.nan_to_num(torch.abs(shorts - shift(shorts, 1, axis=0)))
    lt = dlong.sum(_N_AXIS)
    st = dshort.sum(_N_AXIS)

    rates = s.cost_rates()
    l_cost = (dlong * rates).sum(_N_AXIS)
    s_cost = (dshort * rates).sum(_N_AXIS)
    if s.transaction_cost:
        long_ret = long_ret_raw - l_cost
        short_ret = short_ret_raw - s_cost
    else:
        long_ret, short_ret = long_ret_raw, short_ret_raw

    return DailyResult(
        log_return=long_ret + short_ret,
        long_return=long_ret,
        short_return=short_ret,
        long_turnover=lt,
        short_turnover=st,
        turnover=lt + st,
        long_pnl_by_name=(longs * r).sum(0) - (dlong * rates).sum(0),
        short_pnl_by_name=-(shorts * r).sum(0) - (dshort * rates).sum(0),
    )
