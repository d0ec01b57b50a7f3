"""The reference ``composite_factor.py`` surface (port of
``factormodeling_tpu/compat/composite_factor.py``): the static and weighted
blends and the two plotting helpers, over pandas panels.

The blends run in :mod:`factormodeling_tpu_torch.composite` on ``device``
(``None`` is the card) from panels densified at JAX's float width
(``threefry.numpy_dtype()``); this module converts formats
and keeps the reference's output conventions (static: NaN-preserving Series
on the panel index; weighted: zero-filled on the full panel index).
"""

from __future__ import annotations

import pandas as pd
import torch

from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.analytics.plots import (
    plot_factor_distributions as _plot_dists,
    plot_quantile_backtests as _plot_quantiles,
)
from factormodeling_tpu_torch.analytics.quantile import quantile_backtest_log
from factormodeling_tpu_torch.compat._convert import (PanelVocab,
                                                     densify_stack)
from factormodeling_tpu_torch.composite import (composite_static,
                                                composite_weighted)
from factormodeling_tpu_torch.threefry import numpy_dtype

__all__ = ["composite_factor_calculation", "weighted_composite_factor",
           "plot_factor_distributions", "plot_quantile_backtests_log"]


def _stack(factors_df: pd.DataFrame, columns, vocab: PanelVocab, dev):
    stack, universe = densify_stack(factors_df[list(columns)], vocab)
    return (torch.from_numpy(stack).to(dev),
            torch.from_numpy(universe).to(dev))


def composite_factor_calculation(factors_df: pd.DataFrame,
                                 selected_factors: list,
                                 method: str = "zscore", *,
                                 device=None) -> pd.Series:
    """Static equal blend of the selected factor columns: the per-date
    demeaned composite on the panel's long index (NaN preserved)."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(factors_df.index)
    stack, universe = _stack(factors_df, selected_factors, vocab, dev)
    comp = composite_static(stack, tuple(selected_factors), method=method,
                            universe=universe)
    return vocab.align_like(comp.cpu().numpy(), factors_df.index,
                            name="composite")


def weighted_composite_factor(factors_df: pd.DataFrame,
                              selection_df: pd.DataFrame,
                              method: str = "zscore", *,
                              device=None) -> pd.Series:
    """Per-date weighted blend driven by daily selection weights,
    zero-filled on the full panel index like the reference's final
    ``reindex().fillna(0)``."""
    dev = resolve_device(device)
    names = list(selection_df.columns)
    vocab = PanelVocab.from_indexes(factors_df.index)
    stack, universe = _stack(factors_df, names, vocab, dev)
    sel = selection_df.reindex(vocab.dates).fillna(0.0).to_numpy(
        dtype=numpy_dtype())
    comp = composite_weighted(stack, tuple(names),
                              torch.tensor(sel, device=dev), method=method,
                              universe=universe)
    return vocab.align_like(comp.cpu().numpy(), factors_df.index,
                            name="composite")


def plot_factor_distributions(factors_df: pd.DataFrame, exclude=None,
                              bins=50, ncols=6, figsize=(15, 5)):
    """Histogram grid of factor distributions."""
    vocab = PanelVocab.from_indexes(factors_df.index)
    stack, _ = densify_stack(factors_df, vocab)
    return _plot_dists(stack, list(factors_df.columns), exclude=exclude,
                       bins=bins, ncols=ncols, figsize=figsize)


def plot_quantile_backtests_log(com_factors_df: pd.DataFrame,
                                returns: pd.Series, n_groups: int = 5,
                                ncols: int = 2, figsize=(20, 6), *,
                                device=None):
    """Per-factor n-quantile bucket backtest in log-return space with the
    L1-Sn spread."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(com_factors_df.index, returns.index)
    rets, _ = vocab.densify(returns)
    rets = torch.from_numpy(rets).to(dev)
    results = {}
    for col in com_factors_df.columns:
        vals, uni = vocab.densify(com_factors_df[col])
        results[col] = quantile_backtest_log(
            torch.from_numpy(vals).to(dev), rets, n_groups=n_groups,
            universe=torch.from_numpy(uni).to(dev))
    return _plot_quantiles(results, vocab.dates.to_numpy(), n_groups=n_groups,
                           ncols=ncols, figsize=figsize)
