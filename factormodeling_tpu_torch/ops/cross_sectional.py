"""Cross-sectional ops: per-date transforms over the asset axis (port of
``factormodeling_tpu/ops/cross_sectional.py``; reference
``operations.py:54-101,171-182``).

Each pandas ``groupby(level='date')`` is a masked reduction along the asset
axis (-1) over all dates and any leading factor axes at once.

Universe semantics: ``universe`` marks which cells exist in the originating
long index. The reference's NaN quirks depend on it: ``cs_rank``'s
normalizing denominator counts NaN-valued rows (``operations.py:58-60``),
and single-row dates get 0.5. ``universe=None`` means every column exists.
The JAX module's ``obs.trace.stage`` markers around ``cs_rank`` and
``cs_zscore`` come with the port of the observability layer.
"""

from __future__ import annotations

import torch

from factormodeling_tpu_torch.ops._rank import avg_rank, masked_quantile

__all__ = [
    "cs_rank",
    "cs_winsor",
    "cs_filter_center",
    "cs_zscore",
    "cs_bool",
    "cs_mean",
    "market_neutralize",
]

_ASSET_AXIS = -1


def _universe_count(x, universe):
    if universe is None:
        return torch.full(x.shape[:-1] + (1,), x.shape[-1], dtype=x.dtype,
                          device=x.device)
    return universe.expand(x.shape).sum(_ASSET_AXIS, keepdim=True).to(x.dtype)


def _masked_moments(x, *, ddof: int):
    valid = ~torch.isnan(x)
    cnt = valid.sum(_ASSET_AXIS, keepdim=True).to(x.dtype)
    s = torch.where(valid, x, 0.0).sum(_ASSET_AXIS, keepdim=True)
    mean = s / cnt
    dev = torch.where(valid, x - mean, 0.0)
    var = (dev * dev).sum(_ASSET_AXIS, keepdim=True) / torch.clamp(cnt - ddof,
                                                                   min=0.0)
    return mean, torch.sqrt(var), cnt


def _mask_input(x, universe):
    """Out-of-universe cells must not contaminate cross-sectional stats even
    when they hold non-NaN values (e.g. after a forward fill)."""
    if universe is None:
        return x
    return torch.where(universe, x, float("nan"))


def _quantile_bounds(x, qs):
    q = masked_quantile(x, qs, axis=_ASSET_AXIS)
    return q[..., 0:1], q[..., 1:2]


def cs_rank(x: torch.Tensor, universe: torch.Tensor | None = None,
            method: str = "average",
            tie_order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-date rank normalized to [0, 1]: ``(rank - 1) / (n - 1)`` with
    pandas tie ``method`` (default average), where ``n`` is the full group
    size *including NaN rows* (reference quirk, ``operations.py:58-60``);
    single-row dates -> 0.5. ``tie_order`` (int, lower = earlier) resolves
    ``method='first'`` ties; defaults to asset-column order."""
    x = _mask_input(x, universe)
    r = avg_rank(x, axis=_ASSET_AXIS, method=method, tie_order=tie_order)
    n = _universe_count(x, universe)
    out = torch.where(n == 1, 0.5, (r - 1.0) / (n - 1.0))
    if universe is not None:
        out = torch.where(universe, out, float("nan"))
    return out


def cs_winsor(x: torch.Tensor, limits=(0.01, 0.99), min_valid: int = 5,
              universe: torch.Tensor | None = None) -> torch.Tensor:
    """Clip to per-date [q_low, q_high] quantiles; dates with fewer than
    ``min_valid`` non-NaN rows pass through (reference ``operations.py:64-68``)."""
    x = _mask_input(x, universe)
    lo, hi = _quantile_bounds(x, limits)
    cnt = (~torch.isnan(x)).sum(_ASSET_AXIS, keepdim=True)
    clipped = torch.minimum(torch.maximum(x, lo), hi)
    return torch.where(cnt >= min_valid, clipped, x)


def cs_filter_center(x: torch.Tensor, center=(0.3, 0.7),
                     universe: torch.Tensor | None = None) -> torch.Tensor:
    """Zero out the middle quantile band, keep the tails (reference
    ``operations.py:70-75``). pandas ``where`` turns NaN rows into 0 too;
    cells outside the universe stay NaN."""
    x = _mask_input(x, universe)
    lo, hi = _quantile_bounds(x, center)
    keep = (x < lo) | (x > hi)  # False for NaN -> 0, matching pandas .where
    out = torch.where(keep, x, 0.0)
    if universe is not None:
        out = torch.where(universe, out, float("nan"))
    return out


def cs_zscore(x: torch.Tensor, universe: torch.Tensor | None = None) -> torch.Tensor:
    """Per-date z-score, ddof=0 (reference ``operations.py:77``). A constant
    date gives 0/0 -> NaN, matching pandas arithmetic."""
    x = _mask_input(x, universe)
    mean, std, _ = _masked_moments(x, ddof=0)
    return (x - mean) / std


def cs_bool(cond: torch.Tensor, true_value, false_value) -> torch.Tensor:
    """np.where pass-through (reference ``operations.py:80``)."""
    return torch.where(cond, true_value, false_value)


def cs_mean(x: torch.Tensor, universe: torch.Tensor | None = None) -> torch.Tensor:
    """Broadcast per-date mean of the non-NaN rows to every universe cell
    (reference ``operations.py:85``; pandas transform broadcasts to NaN rows)."""
    x = _mask_input(x, universe)
    mean, _, cnt = _masked_moments(x, ddof=0)
    out = torch.where(cnt > 0, mean, float("nan")).expand(x.shape)
    if universe is not None:
        out = torch.where(universe, out, float("nan"))
    return out


def market_neutralize(x: torch.Tensor, universe: torch.Tensor | None = None) -> torch.Tensor:
    """Per-date z-score ddof=0 with the reference's safe-sigma rule: sigma == 0
    or undefined -> the whole date becomes 0, NaN rows included (reference
    ``operations.py:171-182``; despite the name it is a z-score, not a demean)."""
    x = _mask_input(x, universe)
    mean, std, cnt = _masked_moments(x, ddof=0)
    degenerate = (std == 0.0) | torch.isnan(std) | (cnt == 0)
    out = torch.where(degenerate, 0.0, (x - mean) / std)
    if universe is not None:
        out = torch.where(universe, out, float("nan"))
    return out
