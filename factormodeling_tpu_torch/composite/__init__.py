"""Composite-factor construction."""

from factormodeling_tpu_torch.composite.blend import (SUFFIXES,
                                                      composite_static,
                                                      composite_weighted,
                                                      prefix_group_ids,
                                                      suffix_code)

__all__ = ["SUFFIXES", "composite_static", "composite_weighted",
           "prefix_group_ids", "suffix_code"]
