"""Rolling factor-selection driver (port of
``factormodeling_tpu/selection/driver.py``).

Per-date stats are computed once for the whole sample, trailing-window
metrics come from rolling sums, and the selector runs over all dates at
once. The reference's date conventions hold: exposures are shifted twice in
the selection path, windows cover ``dates[i-window : i]`` (today excluded),
processed dates are ``dates[window : -1]``, and daily rows are normalized to
sum 1 with all-zero rows left at 0.
"""

from __future__ import annotations

import torch

from factormodeling_tpu_torch.metrics.factor_metrics import (daily_factor_stats,
                                                             rolling_metrics)
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.ops._window import rolling_sum, shift
from factormodeling_tpu_torch.selection.selectors import (
    FACTOR_SELECTION_METHODS,
    SelectionContext,
    factor_momentum_selector,
    icir_top_selector,
    mvo_selector,
    pca_selector,
    regression_selector,
)

__all__ = ["rolling_selection", "build_selection_context",
           "finalize_selection", "finish_selection_context",
           "selection_metric_needs"]

_ALL_STATS = ("ic", "rank_ic", "factor_return")
#: daily stats each built-in selector reads, keyed by function identity (a
#: custom selector registered over a built-in name gets the full table);
#: momentum and the covariance-based selectors read the factor returns only
_METRIC_NEEDS = {
    icir_top_selector: lambda kw: (("rank_ic",)
                                   if kw.get("use_rank_icir", True)
                                   else ("ic",)),
    factor_momentum_selector: lambda kw: (),
    mvo_selector: lambda kw: (),
    pca_selector: lambda kw: (),
    regression_selector: lambda kw: (),
}


def build_selection_context(factors: torch.Tensor, returns: torch.Tensor,
                            factor_ret: torch.Tensor, window: int,
                            *, universe: torch.Tensor | None = None,
                            shift_periods: int = 2,
                            stats: tuple = _ALL_STATS,
                            stats_fn=None) -> SelectionContext:
    """Precompute the whole-sample tensors selectors consume (``factors``
    ``[F, D, N]`` unshifted, ``returns`` ``[D, N]``, ``factor_ret``
    ``[D, F]``). A window of W dates aggregates its last W-1 dates of
    double-shifted stats, as the reference's in-slice shift does.
    ``stats_fn`` replaces :func:`daily_factor_stats` (same arguments, the
    ``[F, D]`` tables back): the sharded step scores its blocks there."""
    metrics_win = {}
    if stats:
        with obs_stage("selection/daily_stats"):
            daily = (stats_fn or daily_factor_stats)(
                factors, returns, shift_periods=shift_periods,
                universe=universe, stats=stats)
        rm = rolling_metrics(daily, max(window - 1, 1))
        metrics_win = {k: shift(v, 1, axis=-1) for k, v in rm.items()}
    return finish_selection_context(metrics_win, factor_ret, window)


def finish_selection_context(metrics_win: dict, factor_ret: torch.Tensor,
                             window: int) -> SelectionContext:
    """A :class:`SelectionContext` from already-windowed metric tensors
    (``rolling_metrics`` output, shifted to exclude today) and the raw
    factor returns ``[D, F]``: the seam for callers that re-window hoisted
    per-date stats, and the last step of :func:`build_selection_context`."""
    ok = ~torch.isnan(factor_ret)
    sums = rolling_sum(torch.where(ok, factor_ret, 0.0), window, axis=0)
    return SelectionContext(metrics_win=metrics_win, factor_ret=factor_ret,
                            ret_win_sum=shift(sums, 1, axis=0, fill_value=0.0),
                            window=window)


def selection_metric_needs(method: str, method_kwargs: dict | None = None):
    """The daily stats the chosen selector reads; custom registry entries
    get the full table. Raises on an unregistered method."""
    selector = FACTOR_SELECTION_METHODS.get(method)
    if selector is None:
        raise ValueError(f"Unknown factor selection method: {method}")
    needs_fn = _METRIC_NEEDS.get(selector)
    return needs_fn(method_kwargs or {}) if needs_fn else _ALL_STATS


def finalize_selection(raw: torch.Tensor, window: int) -> torch.Tensor:
    """Zero outside the processed range ``dates[window:-1]``, NaN -> 0, rows
    normalized to sum 1 with all-zero rows left at 0; ``raw`` is ``[D, F]``
    or ``[C, D, F]`` lanes."""
    d = raw.shape[-2]
    i = torch.arange(d, device=raw.device)
    processed = (i >= window) & (i <= d - 2)
    raw = torch.where(processed[:, None], raw, 0.0)
    raw = torch.where(torch.isnan(raw), 0.0, raw)
    rowsum = raw.sum(-1, keepdim=True)
    return torch.where(rowsum > 0, raw / torch.where(rowsum > 0, rowsum, 1.0), 0.0)


def rolling_selection(factors: torch.Tensor, returns: torch.Tensor,
                      factor_ret: torch.Tensor, window: int,
                      method: str = "icir_top", method_kwargs: dict | None = None,
                      *, universe: torch.Tensor | None = None,
                      shift_periods: int = 2, stats_fn=None) -> torch.Tensor:
    """Daily factor weights ``float[D, F]``: zero outside the processed range
    ``dates[window:-1]``, rows normalized to sum 1 (all-zero rows stay 0).
    ``stats_fn``: as :func:`build_selection_context`'s."""
    selector = FACTOR_SELECTION_METHODS.get(method)
    if selector is None:
        raise ValueError(f"Unknown factor selection method: {method}")
    if window >= factor_ret.shape[0]:
        return torch.zeros_like(factor_ret)
    needs = selection_metric_needs(method, method_kwargs)
    ctx = build_selection_context(factors, returns, factor_ret, window,
                                  universe=universe,
                                  shift_periods=shift_periods, stats=needs,
                                  stats_fn=stats_fn)
    raw = selector(ctx, **(method_kwargs or {}))  # [D, F]
    return finalize_selection(raw, window)
