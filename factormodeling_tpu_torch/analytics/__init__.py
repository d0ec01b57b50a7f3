"""Analytics (L0), port of ``factormodeling_tpu/analytics``: the
decay-window sensitivity sweep, ``PortfolioAnalyzer``, the quantile bucket
backtests and the matplotlib dashboards (matplotlib imported on a plot's
first call)."""

from factormodeling_tpu_torch.analytics.analyzer import PortfolioAnalyzer  # noqa: F401
from factormodeling_tpu_torch.analytics.decay import (  # noqa: F401
    DEFAULT_DECAY_PERIODS,
    DecaySensitivity,
    batched_ts_decay,
    decay_sensitivity,
    plot_decay_sensitivity,
)
from factormodeling_tpu_torch.analytics.plots import (  # noqa: F401
    plot_factor_distributions,
    plot_full_performance,
    plot_quantile_backtests,
)
from factormodeling_tpu_torch.analytics.quantile import (  # noqa: F401
    QuantileBacktest,
    quantile_backtest_log,
)

__all__ = ["DEFAULT_DECAY_PERIODS", "DecaySensitivity", "PortfolioAnalyzer",
           "QuantileBacktest", "batched_ts_decay", "decay_sensitivity",
           "plot_decay_sensitivity", "plot_factor_distributions",
           "plot_full_performance", "plot_quantile_backtests",
           "quantile_backtest_log"]
