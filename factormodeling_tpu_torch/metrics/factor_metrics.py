"""Batched factor scoring: IC, rank-IC and cross-sectional factor returns
(port of ``factormodeling_tpu/metrics/factor_metrics.py``).

Per factor the exposures are shifted (look-ahead guard), then per date the
Pearson IC between exposure and return, the rank-IC (Pearson of
average-tie ranked exposures vs raw returns) and the no-intercept
univariate beta ``f.r / f.f`` are computed over the whole ``[F, D, N]``
stack at once. Window aggregates come from trailing-window sums at O(D*F).
"""

from __future__ import annotations

import torch

from factormodeling_tpu_torch.metrics._cuda_rank_ic import (
    rank_ic_postsort, rank_ic_postsort_plain)
from factormodeling_tpu_torch.ops._window import masked_shift, rolling_sum, shift

__all__ = ["daily_factor_stats", "nan_mean_std", "rolling_metrics"]

_ASSET_AXIS = -1
_DATE_AXIS = -2


def _masked_pearson(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over ``valid`` cells along the asset axis;
    zero-variance inputs give NaN."""
    cnt = valid.sum(_ASSET_AXIS).to(a.dtype)
    cs = torch.where(cnt > 0, cnt, float("nan"))
    ma = torch.where(valid, a, 0.0).sum(_ASSET_AXIS) / cs
    mb = torch.where(valid, b, 0.0).sum(_ASSET_AXIS) / cs
    da = torch.where(valid, a - ma[..., None], 0.0)
    db = torch.where(valid, b - mb[..., None], 0.0)
    cov = (da * db).sum(_ASSET_AXIS)
    va = (da * da).sum(_ASSET_AXIS)
    vb = (db * db).sum(_ASSET_AXIS)
    return cov / torch.sqrt(va * vb)


def _rank_ic(f: torch.Tensor, r: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pearson(rank(f), r) along the asset axis, the whole stack at once:
    one ``torch.sort`` of the keys (NaN last), the returns gathered along
    as payload, then the post-sort stage (:func:`rank_ic_postsort`: the
    CUDA kernel on a float32 card tensor, the plain version otherwise)."""
    key = torch.where(valid, f, float("nan"))
    rr = torch.where(valid, r, 0.0).expand(key.shape)
    n = key.shape[-1]
    s_key, idx = torch.sort(key, dim=-1)
    r_s = torch.gather(rr, -1, idx)
    # the kernel takes float32, the type the JAX package routes to its
    # Pallas kernel; other types take the plain post-sort, as XLA's there
    post = (rank_ic_postsort if key.dtype == torch.float32
            else rank_ic_postsort_plain)
    ic, _ = post(s_key.reshape(-1, n), r_s.reshape(-1, n))
    return ic.reshape(key.shape[:-1])


def daily_factor_stats(factors: torch.Tensor, returns: torch.Tensor,
                       *, shift_periods: int = 1,
                       universe: torch.Tensor | None = None,
                       min_pairs: int = 3,
                       stats: tuple = ("ic", "rank_ic", "factor_return")):
    """Per-(factor, date) IC / rank-IC / factor-return over a dense stack.

    ``factors`` is ``float[F, D, N]`` (shifted internally by
    ``shift_periods`` per symbol), ``returns`` ``float[D, N]``, ``universe``
    an optional ``bool[D, N]``. Dates with fewer than ``min_pairs`` valid
    pairs are NaN. Returns a dict with the requested subset of ``ic``,
    ``rank_ic``, ``factor_return`` (each ``[F, D]``) and ``n_pairs``.
    """
    unknown = set(stats) - {"ic", "rank_ic", "factor_return"}
    if unknown:
        raise ValueError(f"unknown stats {sorted(unknown)}; valid: "
                         "'ic', 'rank_ic', 'factor_return'")
    if shift_periods:
        if universe is not None:
            f = masked_shift(factors, universe, shift_periods, axis=_DATE_AXIS)
        else:
            f = shift(factors, shift_periods, axis=_DATE_AXIS)
    else:
        f = factors
    r = torch.where(universe, returns, float("nan")) if universe is not None else returns
    valid = ~torch.isnan(f) & ~torch.isnan(r)
    f = torch.where(valid, f, float("nan"))
    cnt = valid.sum(_ASSET_AXIS)
    enough = cnt >= min_pairs

    out = dict(n_pairs=cnt)
    if "ic" in stats:
        out["ic"] = torch.where(enough, _masked_pearson(f, r, valid), float("nan"))
    if "rank_ic" in stats:
        out["rank_ic"] = torch.where(enough, _rank_ic(f, r, valid), float("nan"))
    if "factor_return" in stats:
        f0 = torch.where(valid, f, 0.0)
        r0 = torch.where(valid, r, 0.0)
        num = (f0 * r0).sum(_ASSET_AXIS)
        den = (f0 * f0).sum(_ASSET_AXIS)
        beta = torch.where(den > 0, num / den, float("nan"))
        out["factor_return"] = torch.where(enough, beta, float("nan"))
    return out


def nan_mean_std(x: torch.Tensor, axis: int):
    """NaN-skipping (mean, std ddof=1, count) along ``axis``; empty -> NaN."""
    ok = ~torch.isnan(x)
    n = ok.sum(axis).to(x.dtype)
    ns = torch.where(n > 0, n, float("nan"))
    mean = torch.where(ok, x, 0.0).sum(axis) / ns
    dev = torch.where(ok, x - mean.unsqueeze(axis), 0.0)
    var = (dev * dev).sum(axis) / torch.where(n > 1, n - 1.0, float("nan"))
    return mean, torch.sqrt(var), n


def rolling_metrics(daily: dict, window: int) -> dict:
    """Per-factor metrics over every trailing window at once.

    ``daily`` is the output of :func:`daily_factor_stats` (arrays [F, D]);
    entry ``[:, t]`` of each output aggregates dates ``t-window+1 .. t``
    inclusive. The IC and rank-IC groups are ported; the factor-return group
    needs the regularized incomplete beta for its t-test p-value, which
    PyTorch lacks, and raises.
    """

    def win_mean_std(x):
        ok = ~torch.isnan(x)
        x0 = torch.where(ok, x, 0.0)
        n = rolling_sum(ok.to(x.dtype), window, axis=-1)
        ns = torch.where(n > 0, n, float("nan"))
        s = rolling_sum(x0, window, axis=-1)
        s2 = rolling_sum(x0 * x0, window, axis=-1)
        mean = s / ns
        var = (torch.clamp(s2 - s * mean, min=0.0)
               / torch.where(n > 1, n - 1.0, float("nan")))
        return mean, torch.sqrt(var), n

    if "factor_return" in daily:
        raise NotImplementedError(
            "rolling_metrics' factor-return group needs betainc (the "
            "regularized incomplete beta) for its t-test p-value, which "
            "PyTorch does not provide; not ported yet (see ROADMAP.md)")
    out = {}
    if "ic" in daily:
        ic_mean, ic_std, _ = win_mean_std(daily["ic"])
        out["IC"] = ic_mean
        out["IC_IR"] = ic_mean / ic_std
    if "rank_ic" in daily:
        ric_mean, ric_std, _ = win_mean_std(daily["rank_ic"])
        out["rank_IC"] = ric_mean
        out["rank_IC_IR"] = ric_mean / ric_std
    return out
