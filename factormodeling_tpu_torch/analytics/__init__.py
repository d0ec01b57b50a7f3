"""Analytics (L0), port of ``factormodeling_tpu/analytics``: the
decay-window sensitivity sweep. The plots, ``PortfolioAnalyzer`` and the
quantile backtests come with the analytics slice."""

from factormodeling_tpu_torch.analytics.decay import (  # noqa: F401
    DEFAULT_DECAY_PERIODS,
    DecaySensitivity,
    batched_ts_decay,
    decay_sensitivity,
)

__all__ = ["DEFAULT_DECAY_PERIODS", "DecaySensitivity", "batched_ts_decay",
           "decay_sensitivity"]
