"""Daily portfolio P&L with tiered transaction costs, and the signal's IC
and turnover summary (port of ``factormodeling_tpu/backtest/pnl.py``).

NaN weights/returns are zero-filled, the first date's turnover diff counts
0, the net column is the weighted sum of log-returns (named
``log_return``), and per-name P&L always subtracts costs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.ops._window import shift

__all__ = ["DailyResult", "daily_portfolio_returns", "signal_metrics"]

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


def signal_metrics(signal: torch.Tensor, weights: torch.Tensor,
                   s: SimulationSettings) -> dict:
    """Daily signal IC and turnover summary: per-date Pearson correlation of
    the signal with same-day returns, its mean / std / IR, and the average
    daily total turnover of ``weights``. Values are 0-d tensors."""
    valid = ~torch.isnan(signal) & ~torch.isnan(s.returns)
    cnt = valid.sum(_N_AXIS).to(s.returns.dtype)
    cs = torch.where(cnt > 0, cnt, float("nan"))
    a0 = torch.where(valid, signal, 0.0)
    r0 = torch.where(valid, s.returns, 0.0)
    ma = a0.sum(_N_AXIS) / cs
    mr = r0.sum(_N_AXIS) / cs
    da = torch.where(valid, signal - ma[:, None], 0.0)
    dr = torch.where(valid, s.returns - mr[:, None], 0.0)
    ic = (da * dr).sum(_N_AXIS) / torch.sqrt((da * da).sum(_N_AXIS)
                                             * (dr * dr).sum(_N_AXIS))
    ok = ~torch.isnan(ic)
    n = ok.sum().to(s.returns.dtype)
    ns = torch.where(n > 0, n, float("nan"))
    mean = torch.where(ok, ic, 0.0).sum() / ns
    dev = torch.where(ok, ic - mean, 0.0)
    std = torch.sqrt((dev * dev).sum() / torch.where(n > 1, n - 1.0,
                                                     float("nan")))

    w = torch.nan_to_num(weights)
    longs = torch.clamp(w, min=0.0)
    shorts = torch.abs(torch.clamp(w, max=0.0))
    dl = torch.nan_to_num(torch.abs(longs - shift(longs, 1, axis=0)))
    ds = torch.nan_to_num(torch.abs(shorts - shift(shorts, 1, axis=0)))
    avg_turn = (dl.sum(_N_AXIS) + ds.sum(_N_AXIS)).mean()

    return {"IC": mean, "IC_IR": mean / std, "IC_Std": std,
            "Avg Turnover": avg_turn}
