"""Group ops: per-(date, group) transforms such as industry buckets (port of
``factormodeling_tpu/ops/group.py``; reference ``operations.py:104-168``).

Groups are dense int ids in ``[0, num_groups)`` with ``-1`` meaning "no
group" (pandas drops NaN group keys, so those rows transform to NaN); ids at
or above ``num_groups`` belong to no counted group either. The JAX package
builds per-(row, group) sums from one-hot matrix products because the TPU
serializes scatters; on the card a ``scatter_add_`` into a ``[rows, G + 1]``
table (the last column collects every cell outside the counted groups) is
the natural form. Group ranks reuse the sort machinery of :mod:`._rank`.
"""

from __future__ import annotations

import numpy as np
import torch

from factormodeling_tpu_torch.ops import _cuda_fused as _cf
from factormodeling_tpu_torch.ops._rank import segment_avg_rank
from factormodeling_tpu_torch.ops.cross_sectional import _mask_input, cs_zscore

__all__ = [
    "bucket",
    "cs_zscore_group_neutralize",
    "group_mean",
    "group_neutralize",
    "group_normalize",
    "group_rank_normalized",
]

_ASSET_AXIS = -1


def bucket(x: torch.Tensor, bin_range=(0.2, 1.0, 0.2)) -> torch.Tensor:
    """Fixed-bin bucketing into int ids 0..k-1 (-1 = NaN / out of range).

    Mirrors reference ``operations.py:104-110``: ``pd.cut`` with edges
    ``arange(low, up + 1e-8, step)``, right-closed intervals,
    ``include_lowest`` (the first interval also holds its left edge). The
    reference emits labels "group{i+1}"; this emits ``i``.
    """
    low, up, step = bin_range
    e = torch.as_tensor(np.arange(low, up + 1e-8, step), dtype=x.dtype,
                        device=x.device)
    idx = torch.searchsorted(e, x.contiguous(), side="left").to(torch.int32) - 1
    idx = torch.where(x == e[0], 0, idx)  # include_lowest
    bad = torch.isnan(x) | (x < e[0]) | (x > e[-1])
    return torch.where(bad, -1, idx)


def _per_row_segment_sums(x: torch.Tensor, group_ids, num_groups: int):
    """Per-(row, group) sum and count of the non-NaN values, gathered back to
    every cell. Rows are everything but the asset axis. Returns
    ``(sum_cell, count_cell, in_group)`` shaped like ``x``; cells whose id
    is outside ``[0, num_groups)`` get sum and count 0, and ``in_group``
    marks ``id >= 0``."""
    shape = x.shape
    n = shape[_ASSET_AXIS]
    gb = torch.as_tensor(group_ids, device=x.device).expand(shape) \
        .reshape(-1, n).to(torch.int64)
    xb = x.reshape(-1, n)
    counted = (gb >= 0) & (gb < num_groups)
    col = torch.where(counted, gb, num_groups)
    valid = ~torch.isnan(xb) & counted
    table = torch.zeros((xb.shape[0], num_groups + 1), dtype=x.dtype,
                        device=x.device)
    sums = table.scatter_add(1, col, torch.where(valid, xb, 0.0))
    cnts = table.scatter_add(1, col, valid.to(x.dtype))
    sum_cell = torch.where(counted, torch.gather(sums, 1, col), 0.0)
    cnt_cell = torch.where(counted, torch.gather(cnts, 1, col), 0.0)
    return (sum_cell.reshape(shape), cnt_cell.reshape(shape),
            (gb >= 0).reshape(shape))


def group_mean(x: torch.Tensor, group_ids, num_groups: int) -> torch.Tensor:
    """Per-(date, group) NaN-skipping mean broadcast to every row of the
    group, NaN-valued rows included (reference ``operations.py:112-122``).
    Rows without a group -> NaN."""
    s, c, in_group = _per_row_segment_sums(x, group_ids, num_groups)
    mean = s / torch.where(c > 0, c, float("nan"))
    return torch.where(in_group, mean, float("nan"))


def group_neutralize(x: torch.Tensor, group_ids, num_groups: int) -> torch.Tensor:
    """x minus its (date, group) mean (reference ``operations.py:124-134``)."""
    return x - group_mean(x, group_ids, num_groups)


def group_normalize(x: torch.Tensor, group_ids, num_groups: int) -> torch.Tensor:
    """Per-(date, group) z-score ddof=0 with the safe-sigma rule: sigma == 0
    or undefined -> 0 for every row of the group (reference
    ``operations.py:137-149``)."""
    s, c, in_group = _per_row_segment_sums(x, group_ids, num_groups)
    c_safe = torch.where(c > 0, c, float("nan"))
    mean = s / c_safe
    dev2 = (x - mean) ** 2  # NaN rows stay NaN -> skipped by the segment sum
    s2, _, _ = _per_row_segment_sums(dev2, group_ids, num_groups)
    sigma = torch.sqrt(s2 / c_safe)
    degenerate = (sigma == 0.0) | torch.isnan(sigma)
    out = torch.where(degenerate, 0.0, (x - mean) / sigma)
    return torch.where(in_group, out, float("nan"))


def group_rank_normalized(x: torch.Tensor, group_ids, num_groups: int,
                          method: str = "average",
                          tie_order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-(date, group) [0, 1] rank with pandas tie ``method`` (default
    average), NaNs preserved; groups with <= 1 valid row -> 0.5 for every row
    of the group, NaN rows included (reference ``operations.py:152-168``).
    ``tie_order`` (int, lower = earlier) resolves ``method='first'`` ties;
    defaults to asset-column order."""
    del num_groups  # sort-based; no table needed
    gids = torch.as_tensor(group_ids, device=x.device).expand(x.shape)
    ranks, counts = segment_avg_rank(x, gids, axis=_ASSET_AXIS, method=method,
                                     tie_order=tie_order)
    out = torch.where(counts <= 1, 0.5, (ranks - 1.0) / (counts - 1.0))
    return torch.where(gids >= 0, out, float("nan"))


def cs_zscore_group_neutralize(x: torch.Tensor, group_ids, num_groups: int,
                               universe: torch.Tensor | None = None,
                               use_kernel: bool = False) -> torch.Tensor:
    """``group_neutralize(cs_zscore(x), ...)``: the composite pipeline's
    normalization chain (reference ``operations.py:77,124`` back to back).

    ``use_kernel=True`` is the JAX package's ``use_pallas=True``: on a CUDA
    tensor it launches the one-pass kernel (:mod:`._cuda_fused`) when
    ``0 < num_groups <= 32`` and the group ids are at most 2-D and shared
    across ``x``'s leading axes; the kernel takes rows of any width. Every
    other case takes the composition, as the JAX package routes (its
    further ``N >= 128`` condition is the TPU's lane padding and is not
    copied). The two paths
    agree up to the order of their float sums."""
    x = _mask_input(x, universe)
    gids = torch.as_tensor(group_ids, device=x.device)
    if (use_kernel and x.device.type == "cuda" and x.ndim >= 2
            and gids.ndim <= 2 and gids.shape == x.shape[x.ndim - gids.ndim:]
            and 0 < num_groups <= _cf.MAX_FUSED_GROUPS):
        return _cf.zscore_group_neutralize_fused(
            x.contiguous(), gids.expand(x.shape[-2:]), num_groups)
    return group_neutralize(cs_zscore(x), gids, num_groups)
