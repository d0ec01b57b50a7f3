"""Portfolio analytics over a backtest result (port of
``factormodeling_tpu/analytics/analyzer.py``): host numpy reductions over
the ``[D]`` result columns. Dates are numpy datetime64 for the calendar
math (annualization over real calendar days / 365.25, monthly and yearly
returns by calendar); the ``log_return`` column converts to simple returns
by exponentiation, as the reference does.
"""

from __future__ import annotations

import numpy as np

from factormodeling_tpu_torch._device import host_array
from factormodeling_tpu_torch.backtest.pnl import DailyResult

__all__ = ["PortfolioAnalyzer"]

_COLUMNS = ("log_return", "long_return", "short_return", "long_turnover",
            "short_turnover", "turnover")


class PortfolioAnalyzer:
    def __init__(self, result, dates, trading_days_per_year: int = 252):
        """``result``: a :class:`DailyResult` (tensors on any device) or a
        mapping with ``log_return`` (and optionally the leg and turnover
        columns); ``dates``: the matching datetime64 array, in any order
        (sorted ascending here, like the reference's
        ``sort_values('date')``)."""
        if isinstance(result, DailyResult):
            cols = {k: host_array(getattr(result, k)) for k in _COLUMNS}
        else:
            cols = {k: host_array(v) for k, v in dict(result).items()}
        dates = np.asarray(dates, dtype="datetime64[ns]")
        order = np.argsort(dates, kind="stable")
        self.dates = dates[order]
        self.columns = {k: v[order] for k, v in cols.items()}
        self.trading_days = trading_days_per_year
        self.log_return = self.columns["log_return"]
        self.returns = np.exp(self.log_return) - 1.0
        self.cumulative_return = np.cumprod(1.0 + self.returns) - 1.0

    # ---- point metrics (the reference's names) ----
    def average_return(self):
        return float(self.returns.mean())

    def daily_volatility(self):
        return float(self.returns.std(ddof=1))

    def yearly_volatility(self):
        return self.daily_volatility() * np.sqrt(self.trading_days)

    def annualized_return(self):
        total_days = (self.dates[-1] - self.dates[0]) / np.timedelta64(1, "D")
        total_years = float(total_days) / 365.25
        final_value = self.cumulative_return[-1] + 1.0
        return float(final_value ** (1.0 / total_years) - 1.0)

    def sharpe_ratio(self, risk_free_rate: float = 0.0):
        excess = self.returns - risk_free_rate / self.trading_days
        return float(excess.mean() / excess.std(ddof=1)
                     * np.sqrt(self.trading_days))

    def sortino_ratio(self, risk_free_rate: float = 0.0):
        excess = self.returns - risk_free_rate / self.trading_days
        downside = excess[excess < 0]
        return float(excess.mean() / downside.std(ddof=1)
                     * np.sqrt(self.trading_days))

    def max_drawdown(self):
        return float(self.max_drawdown_curve().min())

    def max_drawdown_curve(self):
        cum = self.cumulative_return + 1.0
        peak = np.maximum.accumulate(cum)
        return cum / peak - 1.0

    def max_daily_return(self):
        return float(self.returns.max())

    def min_daily_return(self):
        return float(self.returns.min())

    def _calendar_compound(self, key_fn):
        keys = key_fn(self.dates)
        uniq, inv = np.unique(keys, return_inverse=True)
        out = np.ones(len(uniq))
        np.multiply.at(out, inv, 1.0 + self.returns)
        return uniq, out - 1.0

    def monthly_return(self):
        return self._calendar_compound(lambda d: d.astype("datetime64[M]"))

    def yearly_return(self):
        return self._calendar_compound(lambda d: d.astype("datetime64[Y]"))

    def summary(self) -> dict:
        """The reference's formatted summary table."""
        return {
            "Average Daily Return": f"{round(self.average_return() * 100, 2)}%",
            "Annualized Return": f"{round(self.annualized_return() * 100, 2)}%",
            "Yearly Volatility": f"{round(self.yearly_volatility() * 100, 2)}%",
            "Max Daily Return": f"{round(self.max_daily_return() * 100, 2)}%",
            "Sharpe Ratio": round(self.sharpe_ratio(), 2),
            "Sortino Ratio": round(self.sortino_ratio(), 2),
            "Max Drawdown": f"{round(self.max_drawdown() * 100, 2)}%",
            "Min Daily Return": f"{round(self.min_daily_return() * 100, 2)}%",
        }
