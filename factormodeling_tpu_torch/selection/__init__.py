"""Rolling factor selection."""

from factormodeling_tpu_torch.selection.driver import (build_selection_context,
                                                       finalize_selection,
                                                       rolling_selection,
                                                       selection_metric_needs)
from factormodeling_tpu_torch.selection.selectors import (
    FACTOR_SELECTION_METHODS, SelectionContext, register_selection_method)

__all__ = ["FACTOR_SELECTION_METHODS", "SelectionContext",
           "build_selection_context", "finalize_selection",
           "register_selection_method", "rolling_selection",
           "selection_metric_needs"]
