"""Composite-factor construction."""

from factormodeling_tpu_torch.composite.blend import (composite_weighted,
                                                      prefix_group_ids)

__all__ = ["composite_weighted", "prefix_group_ids"]
