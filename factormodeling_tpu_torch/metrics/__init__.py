"""Factor scoring."""

from factormodeling_tpu_torch.metrics.factor_metrics import (daily_factor_stats,
                                                             nan_mean_std,
                                                             rolling_metrics)

__all__ = ["daily_factor_stats", "nan_mean_std", "rolling_metrics"]
