"""The reference ``portfolio_analyzer.py`` surface (port of
``factormodeling_tpu/compat/portfolio_analyzer.py``): ``PortfolioAnalyzer``
over a result DataFrame (a ``date`` column, or a date index, and the
``log_return`` / leg / turnover columns), a thin adapter over
:class:`factormodeling_tpu_torch.analytics.PortfolioAnalyzer` that adds the
reference's DataFrame constructor and dashboard method name.
"""

from __future__ import annotations

import pandas as pd

from factormodeling_tpu_torch.analytics import PortfolioAnalyzer as _DenseAnalyzer
from factormodeling_tpu_torch.analytics.analyzer import _COLUMNS
from factormodeling_tpu_torch.analytics.plots import plot_full_performance

__all__ = ["PortfolioAnalyzer"]


class PortfolioAnalyzer(_DenseAnalyzer):
    def __init__(self, df: pd.DataFrame, trading_days_per_year: int = 252):
        dates = pd.to_datetime(df["date"] if "date" in df.columns
                               else df.index)
        cols = {c: df[c].to_numpy() for c in _COLUMNS if c in df.columns}
        if "log_return" not in cols:
            raise ValueError("result frame needs a log_return column")
        super().__init__(cols, dates.to_numpy(),
                         trading_days_per_year=trading_days_per_year)

    def plot_full_performance(self, counts_df: pd.DataFrame | None = None):
        """The reference's multi-panel dashboard."""
        counts = None
        if counts_df is not None:
            counts = (counts_df.index.to_numpy(),
                      counts_df["long_count"].to_numpy(),
                      counts_df["short_count"].to_numpy())
        return plot_full_performance(self, counts)
