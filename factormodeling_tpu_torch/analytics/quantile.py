"""Per-factor quantile bucket backtests in log space (port of
``factormodeling_tpu/analytics/quantile.py``).

Per date the factor's ordinal ranks (pandas ``rank(method='first')``) are
cut into ``n`` buckets (1 = top) as pandas ``qcut`` cuts m distinct ranks,
at the closed-form edges ``1 + (m-1) * j / n``; labels shift one day per
symbol, log-returns average per (date, bucket) and cumulate in log space
(``expm1`` back), with the ``L1 - Sn`` long/short spread.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from factormodeling_tpu_torch.ops._window import masked_shift, shift

__all__ = ["QuantileBacktest", "quantile_backtest_log"]

_N_AXIS = -1


class QuantileBacktest(NamedTuple):
    group_log: torch.Tensor   # [..., D, G] per-date mean log-return per bucket (1=top first)
    cum: torch.Tensor         # [..., D, G] expm1(skipna-cumsum) per bucket
    spread_log: torch.Tensor  # [..., D] bucket-1 minus bucket-n log return
    spread_cum: torch.Tensor  # [..., D] cumulative spread


def _ordinal_rank(x: torch.Tensor) -> torch.Tensor:
    """pandas ``rank(method='first')``: ties broken by position, NaN -> NaN."""
    valid = ~torch.isnan(x)
    key = torch.where(valid, x, float("inf"))
    order = torch.argsort(key, dim=_N_AXIS, stable=True)
    rank0 = torch.argsort(order, dim=_N_AXIS, stable=True)
    return torch.where(valid, (rank0 + 1).to(x.dtype), float("nan"))


def _skipna_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    isn = torch.isnan(x)
    out = torch.cumsum(torch.where(isn, 0.0, x), dim=dim)
    return torch.where(isn, float("nan"), out)


def quantile_backtest_log(feature: torch.Tensor, returns: torch.Tensor,
                          n_groups: int = 5,
                          universe: torch.Tensor | None = None
                          ) -> QuantileBacktest:
    """Bucket backtest of ``feature [..., D, N]`` against log-returns
    ``[D, N]``; buckets ordered 1=top .. n=bottom like the reference."""
    if universe is not None:
        feature = torch.where(universe, feature, float("nan"))
        returns = torch.where(universe, returns, float("nan"))
    r = _ordinal_rank(feature)
    valid = ~torch.isnan(r)
    m = valid.sum(_N_AXIS, keepdim=True).to(feature.dtype)

    # qcut edges over ordinal ranks 1..m: e_j = 1 + (m-1) j/n, bins
    # (e_j, e_j+1] with include_lowest; label = #edges strictly below r
    j = torch.arange(1, n_groups, dtype=feature.dtype, device=feature.device)
    edges = 1.0 + (m[..., None] - 1.0) * j / n_groups   # [..., D, 1, n-1]
    lbl0 = (r[..., None] > edges).sum(-1).to(feature.dtype)
    lbl0 = torch.where(valid, lbl0, float("nan"))
    inv = n_groups - lbl0  # 1 = top

    if universe is not None:
        lagged = masked_shift(inv, universe, 1, axis=-2)
    else:
        lagged = shift(inv, 1, axis=-2)

    ok = ~torch.isnan(lagged) & ~torch.isnan(returns)
    grp_ids = torch.where(ok, lagged - 1.0, 0.0).to(torch.int64)  # 0..n-1
    groups = torch.arange(n_groups, device=feature.device)
    onehot = (grp_ids[..., None] == groups) & ok[..., None]
    rsum = torch.where(ok, torch.nan_to_num(returns), 0.0)
    sums = (onehot * rsum[..., None]).sum(-2)           # [..., D, G]
    cnts = onehot.sum(-2).to(feature.dtype)
    group_log = sums / torch.where(cnts > 0, cnts, float("nan"))

    cum = torch.expm1(_skipna_cumsum(group_log, dim=-2))
    spread_log = group_log[..., 0] - group_log[..., n_groups - 1]
    spread_cum = torch.expm1(_skipna_cumsum(spread_log, dim=-1))
    return QuantileBacktest(group_log, cum, spread_log, spread_cum)
