"""Factor scoring."""

from factormodeling_tpu_torch.metrics.factor_metrics import (
    METRIC_COLUMNS, aggregate_metrics, daily_factor_stats, nan_mean_std,
    rolling_metrics, single_factor_metrics)

__all__ = ["METRIC_COLUMNS", "aggregate_metrics", "daily_factor_stats",
           "nan_mean_std", "rolling_metrics", "single_factor_metrics"]
