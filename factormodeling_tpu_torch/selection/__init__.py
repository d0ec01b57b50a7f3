"""Rolling factor selection: the selector registry, the driver and the
covariance estimates of the covariance-based selectors."""

from factormodeling_tpu_torch.selection.driver import (build_selection_context,
                                                       finalize_selection,
                                                       rolling_selection,
                                                       selection_metric_needs)
from factormodeling_tpu_torch.selection.selectors import (
    FACTOR_SELECTION_METHODS, SelectionContext, factor_momentum_selector,
    icir_top_selector, mvo_selector, pca_selector, register_selection_method,
    regression_selector)
from factormodeling_tpu_torch.selection.shrinkage import (ledoit_wolf_shrinkage,
                                                          masked_pairwise_cov)

__all__ = ["FACTOR_SELECTION_METHODS", "SelectionContext",
           "build_selection_context", "factor_momentum_selector",
           "finalize_selection", "icir_top_selector", "ledoit_wolf_shrinkage",
           "masked_pairwise_cov", "mvo_selector", "pca_selector",
           "register_selection_method", "regression_selector",
           "rolling_selection", "selection_metric_needs"]
