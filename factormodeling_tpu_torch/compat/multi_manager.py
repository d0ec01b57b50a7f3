"""The reference ``multi_manager.py`` surface (port of
``factormodeling_tpu/compat/multi_manager.py``): per-factor manager books
combined by daily factor weights into one backtest.

Each manager's weight pass runs through the port's engine (one
:class:`~factormodeling_tpu_torch.compat.portfolio_simulation.Simulation`
pass per factor, keeping each factor's own ragged universe for the 1-day
shift); the reference's per-date Python combination loop
(``multi_manager.py:54-73``) becomes one dense contraction with the same NaN
rules: pandas ``.add(fill_value=0)`` zero-fills NaN values as well as
missing labels, so no NaN survives the weight combination, while the count
aggregation has no fill and lets a NaN factor weight poison that date's
counts (``multi_manager.py:69-70``). The settings' ``device`` says where
the engine runs.
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd

from factormodeling_tpu_torch.compat._convert import PanelVocab
from factormodeling_tpu_torch.compat.portfolio_simulation import (
    Simulation,
    SimulationSettings,
)

logger = logging.getLogger(__name__)

__all__ = ["compute_manager_weights", "compute_multimanager_weights",
           "run_multimanager_backtest"]


def _settings(settings) -> SimulationSettings:
    return (settings if isinstance(settings, SimulationSettings)
            else SimulationSettings(**settings))


def compute_manager_weights(factor_series, settings, name="manager"):
    """One manager's (shifted daily weights, counts) (``multi_manager.py:15``)."""
    sim = Simulation(name=name, custom_feature=factor_series,
                     settings=_settings(settings))
    return sim._daily_trade_list()


def compute_multimanager_weights(factors_df, factor_weights, settings):
    """(final_weights, final_counts) (``multi_manager.py:32-81``): final
    weight = sum over managers of factor_weight x manager_weight on the
    factor_weights dates, zero rows dropped (NaN carried like the
    reference's ``add(..., fill_value=0)``)."""
    managers = []
    for fac in factor_weights.columns:
        if fac not in factors_df.columns:
            logger.warning("Factor %s not in factors_df, skipping.", fac)
            continue
        managers.append(fac)

    vocab = PanelVocab.from_indexes(factors_df.index)
    d, n = vocab.shape
    m = len(managers)
    books = np.zeros((m, d, n))
    counts = np.zeros((m, d, 2))
    mgr_has_date = np.zeros((m, d), dtype=bool)
    for i, fac in enumerate(managers):
        mgr_w, mgr_counts = compute_manager_weights(
            factors_df[fac].dropna(), settings, name=fac)
        books[i], _ = vocab.densify(mgr_w)
        mgr_has_date[i] = vocab.dates.isin(mgr_counts.index)
        aligned = mgr_counts.reindex(vocab.dates).fillna(0.0)
        counts[i] = aligned[["long_count", "short_count"]].to_numpy()

    dates = factor_weights.index
    fw_raw = factor_weights.reindex(index=vocab.dates,
                                    columns=managers).to_numpy()  # [D, M]
    # weights: pandas add(..., fill_value=0) zero-fills NaN values as well
    # as missing labels before adding (multi_manager.py:68), so absent cells
    # and NaN weights both contribute 0
    combined = np.einsum("md,mdn->dn", np.nan_to_num(fw_raw).T,
                         np.nan_to_num(books))
    # counts: no fill in the reference (multi_manager.py:69-70): a NaN
    # factor weight poisons the date's counts, but a manager missing the
    # date entirely is skipped (the try/except continue) and contributes 0
    skip = (fw_raw.T == 0.0) | ~mgr_has_date  # [M, D]; NaN fw is not skipped
    lc = np.where(skip, 0.0, fw_raw.T * counts[:, :, 0]).sum(axis=0)
    sc = np.where(skip, 0.0, fw_raw.T * counts[:, :, 1]).sum(axis=0)

    keep_dates = vocab.dates.isin(dates)
    membership = keep_dates[:, None] & (combined != 0.0)
    final_weights = vocab.to_series(combined, membership, name="weight")
    # one row per factor_weights date; zeros where no factor data exists,
    # but NaN-poisoned counts (NaN factor weight) survive the reindex
    base = pd.DataFrame(
        {"long_count": lc[keep_dates], "short_count": sc[keep_dates]},
        index=pd.Index(vocab.dates[keep_dates], name="date"))
    final_counts = base.reindex(dates)
    final_counts.loc[~dates.isin(base.index)] = 0.0
    return final_weights, final_counts


def run_multimanager_backtest(factors_df, returns, cap_flag, factor_weights,
                              settings):
    """(result, top_longs, top_shorts, counts) (``multi_manager.py:84-100``);
    the combined weights are already shifted per manager, so the P&L runs
    on them directly (no second lag)."""
    logger.info("Computing multimanager portfolio weights and counts...")
    weights, counts = compute_multimanager_weights(factors_df, factor_weights,
                                                   settings)
    logger.info("Running backtest...")
    sim = Simulation(name="multimanager", custom_feature=weights,
                     settings=_settings(settings))
    result, top_longs, top_shorts = sim._daily_portfolio_returns(weights)
    return result, top_longs, top_shorts, counts
