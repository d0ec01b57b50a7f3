"""The reference ``factor_selector.py`` surface (port of
``factormodeling_tpu/compat/factor_selector.py``): the metric table and the
rolling selector.

``single_factor_metrics`` keeps the reference signature and output (a
DataFrame indexed by factor, sorted by rank_IC_IR descending) and computes
every factor and date in one dense pass. ``FactorSelector`` keeps the
reference's constructor and ``prepare_selection()`` contract (the
init-time exposure shift, the trailing window excluding today, the
processed range ``dates[window:-1]``, row renormalization, the cached
result); the built-in methods go through the port's dense rolling path,
custom methods registered in ``FACTOR_SELECTION_METHODS`` through the
reference's per-date plugin loop. Both take ``device`` (``None`` is the
card) and densify at JAX's float width (``threefry.numpy_dtype()``): float64,
the reference's pandas precision, under the float64 default, where the
dense path's rank-IC takes the float64 route (never the float32-only fused
kernel).
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.compat import factor_selection_methods as fsm
from factormodeling_tpu_torch.compat._convert import (PanelVocab,
                                                     densify_stack,
                                                     level_values)
from factormodeling_tpu_torch.metrics.factor_metrics import (METRIC_COLUMNS,
                                                             aggregate_metrics,
                                                             daily_factor_stats)
from factormodeling_tpu_torch.selection.driver import rolling_selection
from factormodeling_tpu_torch.threefry import numpy_dtype

logger = logging.getLogger(__name__)

__all__ = ["single_factor_metrics", "FactorSelector",
           "FACTOR_SELECTION_METHODS"]

#: the reference's plugin registry; values follow the reference plugin
#: signature. The built-in names also have the dense path.
FACTOR_SELECTION_METHODS = {
    "icir_top": fsm.icir_top_selector,
    "momentum": fsm.factor_momentum_selector,
    "mvo": fsm.mvo_selector,
    "pca": fsm.pca_selector,
    "regression": fsm.regression_selector,
}

_DENSE_METHODS = frozenset(["icir_top", "momentum", "mvo", "pca",
                            "regression"])


def single_factor_metrics(factors_df: pd.DataFrame, returns: pd.Series, *,
                          device=None) -> pd.DataFrame:
    """Per-factor IC / rank-IC / factor-return metric table, sorted by
    rank_IC_IR descending."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(factors_df.index, returns.index)
    stack, universe = densify_stack(factors_df, vocab)
    rets, _ = vocab.densify(returns)
    daily = daily_factor_stats(torch.from_numpy(stack).to(dev),
                               torch.from_numpy(rets).to(dev),
                               shift_periods=1,
                               universe=torch.from_numpy(universe).to(dev))
    agg = aggregate_metrics(daily)
    table = pd.DataFrame({k: agg[k].cpu().numpy() for k in METRIC_COLUMNS},
                         index=pd.Index(factors_df.columns, name="factor"))
    return table.sort_values("rank_IC_IR", ascending=False)


class FactorSelector:
    """Rolling factor selection over a lookback window."""

    def __init__(self, factors_df: pd.DataFrame, returns: pd.Series,
                 factor_ret_df: pd.DataFrame, window: int, method: str,
                 method_kwargs: dict | None = None, *, device=None):
        logger.info("Initializing FactorSelector with method='%s' and "
                    "window=%d...", method, window)
        self.device = resolve_device(device)
        self.factor_cols = list(factors_df.columns)
        # the reference shifts exposures once at init
        self.factors = factors_df.groupby(level="symbol").shift(1)
        self.returns = returns
        self.factor_ret_df = factor_ret_df
        self.window = window
        self.method = method
        self.method_kwargs = method_kwargs or {}
        self.factor_selection: pd.DataFrame | None = None
        self.dates = sorted(
            set(level_values(self.factors.index, "date", 0))
            & set(self.factor_ret_df.index))
        logger.info("FactorSelector initialized.")

    def prepare_selection(self) -> pd.DataFrame:
        """Daily factor weights over ``dates[window:-1]``, rows normalized to
        sum 1; cached after the first call."""
        if self.factor_selection is not None:
            logger.info("Factor selection already prepared. Returning cached "
                        "result.")
            return self.factor_selection
        if self.method in _DENSE_METHODS:
            sel = self._dense_selection()
        elif self.method in FACTOR_SELECTION_METHODS:
            sel = self._plugin_selection()
        else:
            raise ValueError(f"Unknown factor selection method: {self.method}")
        sel.index.name = "date"
        sel.columns.name = "factor"
        self.factor_selection = sel
        return sel

    def _dense_selection(self) -> pd.DataFrame:
        dev = self.device
        dates = pd.Index(self.dates)
        factors = self.factors[
            level_values(self.factors.index, "date", 0).isin(dates)]
        vocab = PanelVocab(dates, pd.Index(
            level_values(factors.index, "symbol", 1).unique()).sort_values())
        stack, universe = densify_stack(factors, vocab)
        rets, _ = vocab.densify(self.returns)
        fr = np.array(self.factor_ret_df.reindex(index=dates,
                                                 columns=self.factor_cols),
                      dtype=numpy_dtype())
        # exposures already shifted once at init; the metrics path adds the
        # reference's second in-metrics shift
        weights = rolling_selection(
            torch.from_numpy(stack).to(dev), torch.from_numpy(rets).to(dev),
            torch.from_numpy(fr).to(dev), self.window, method=self.method,
            method_kwargs=self.method_kwargs,
            universe=torch.from_numpy(universe).to(dev), shift_periods=1)
        out = pd.DataFrame(weights.cpu().numpy(), index=dates,
                           columns=self.factor_cols)
        return out.iloc[self.window:-1]

    def _plugin_selection(self) -> pd.DataFrame:
        """Per-date plugin loop, the reference's own control flow, for
        custom registry entries."""
        plugin = FACTOR_SELECTION_METHODS[self.method]
        date_level = level_values(self.factors.index, "date", 0)
        ret_dates = level_values(self.returns.index, "date", 0)
        rows = []
        for i in range(self.window, len(self.dates) - 1):
            today = self.dates[i]
            win = self.dates[i - self.window:i]
            f_win = self.factors[date_level.isin(win)]
            r_win = self.returns[ret_dates.isin(win)]
            fr_win = self.factor_ret_df.loc[
                self.factor_ret_df.index.isin(win)]
            metrics = single_factor_metrics(f_win, r_win, device=self.device)
            # the reference hands plugins the window's date list, not its
            # length
            w = plugin(metrics, f_win, r_win, fr_win, today, win,
                       **self.method_kwargs)
            rows.append(w.reindex(self.factor_cols).fillna(0.0).rename(today))
        sel = pd.DataFrame(rows)
        sums = sel.sum(axis=1)
        return sel.div(sums.where(sums > 0, 1.0), axis=0)
