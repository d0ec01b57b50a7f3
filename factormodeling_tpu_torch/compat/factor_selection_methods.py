"""The reference ``factor_selection_methods.py`` surface (port of
``factormodeling_tpu/compat/factor_selection_methods.py``): selector
plugins with the reference signature

    (metrics_df, factors_win, returns_win, factor_ret_win, today, window,
     **kwargs) -> pd.Series of non-negative factor weights named by date.

These are the single-date plugins of the reference's plugin boundary;
:class:`~factormodeling_tpu_torch.compat.factor_selector.FactorSelector`
routes the built-in method names through the dense rolling path and calls
them per date only for custom registry entries. ``ledoit_wolf_shrinkage``
and the QP inside ``mvo_selector`` run in the port on ``device`` (a keyword
of theirs; ``None`` is the card).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.selection.shrinkage import \
    ledoit_wolf_shrinkage as _lw_dense
from factormodeling_tpu_torch.solvers.admm_qp import (BoxQPProblem,
                                                      admm_solve_dense)
from factormodeling_tpu_torch.threefry import numpy_dtype

__all__ = ["icir_top_selector", "factor_momentum_selector",
           "ledoit_wolf_shrinkage", "mvo_selector", "pca_selector",
           "regression_selector"]


def icir_top_selector(metrics_df, factors_win, returns_win, factor_ret_win,
                      today, window, icir_threshold=0.03, top_x=5,
                      use_rank_icir=True, **kwargs):
    """Equal-weight the top-x factors above the ICIR threshold."""
    col = "rank_IC_IR" if use_rank_icir else "IC_IR"
    score = metrics_df[col]
    picked = score[score > icir_threshold].nlargest(top_x)
    weights = pd.Series(0.0, index=metrics_df.index, name=today)
    if len(picked):
        weights[picked.index] = 1.0 / len(picked)
    return weights


def factor_momentum_selector(metrics_df, factors_win, returns_win,
                             factor_ret_win, today, window, max_weight=1.0,
                             **kwargs):
    """Weights proportional to the window-sum of factor returns, floored at
    0 and capped at ``max_weight`` only when it is < 1."""
    mom = factor_ret_win.sum(axis=0).clip(lower=0.0)
    if max_weight < 1.0:
        mom = mom.clip(upper=max_weight)
    total = mom.sum()
    weights = mom / total if total > 0 else mom * 0.0
    weights.name = today
    return weights


def ledoit_wolf_shrinkage(returns, device=None):
    """Constant-correlation Ledoit-Wolf shrunk covariance of a [T, F]
    window (DataFrame in, DataFrame out), in closed form on ``device``."""
    arr = torch.tensor(np.asarray(returns, dtype=numpy_dtype()))
    out = _lw_dense(arr.to(resolve_device(device))).cpu().numpy()
    if isinstance(returns, pd.DataFrame):
        return pd.DataFrame(out, index=returns.columns, columns=returns.columns)
    return out


def mvo_selector(metrics_df, factors_win, returns_win, factor_ret_win, today,
                 window, risk_aversion=1.0, max_weight=1.0,
                 turnover_penalty=0.0, previous_weights=None,
                 use_shrinkage=True, qp_iters=500, device=None, **kwargs):
    """Max-Sharpe factor weights on the capped simplex by the dense ADMM QP
    on ``device`` (solver failure -> zero weights, the reference's
    fallback), renormalized to sum 1 when positive."""
    dev = resolve_device(device)
    cols = factor_ret_win.columns
    f = len(cols)
    mu, cov = _window_moments(factor_ret_win, use_shrinkage, device)
    prev = (previous_weights.reindex(cols).fillna(0.0).to_numpy()
            if previous_weights is not None else np.zeros(f))
    cap = min(max_weight, 1.0)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=numpy_dtype()), device=dev)

    prob = BoxQPProblem(q=t(-mu), lo=t(np.zeros(f)), hi=t(np.full(f, cap)),
                        E=t(np.ones((1, f))), b=t(np.ones(1)),
                        l1=float(turnover_penalty), center=t(prev))
    res = admm_solve_dense(t(2.0 * risk_aversion * cov), prob, iters=qp_iters)
    w = res.x.cpu().numpy()
    if not np.all(np.isfinite(w)):
        w = np.zeros(f)
    return _clip_normalize(w, cols, today)


def _window_moments(factor_ret_win, use_shrinkage, device):
    """(mu, symmetrized cov) of a factor-return window, the shared preamble
    of the covariance-based plugins."""
    mu = factor_ret_win.mean(axis=0).to_numpy()
    if use_shrinkage:
        cov = np.asarray(ledoit_wolf_shrinkage(factor_ret_win, device))
    else:
        cov = factor_ret_win.cov().to_numpy()
    return mu, 0.5 * (cov + cov.T)


def _clip_normalize(w, cols, today):
    """Long-only clip and sum-1 renormalization, the plugins' tail."""
    vec = pd.Series(np.maximum(w, 0.0), index=cols, name=today)
    if vec.sum() > 0:
        vec = vec / vec.sum()
    return vec


def pca_selector(metrics_df, factors_win, returns_win, factor_ret_win, today,
                 window, use_shrinkage=True, device=None, **kwargs):
    """PCA blend: leading eigenvector of the window's factor-return
    covariance, oriented by mean returns, long-only clipped, normalized."""
    cols = factor_ret_win.columns
    mu, cov = _window_moments(factor_ret_win, use_shrinkage, device)
    if not (np.all(np.isfinite(cov)) and np.all(np.isfinite(mu))):
        return pd.Series(0.0, index=cols, name=today)
    _, vecs = np.linalg.eigh(cov)
    lead = vecs[:, -1]
    if np.dot(lead, mu) < 0:
        lead = -lead
    return _clip_normalize(lead, cols, today)


def regression_selector(metrics_df, factors_win, returns_win, factor_ret_win,
                        today, window, ridge=1e-4, use_shrinkage=True,
                        device=None, **kwargs):
    """Regression blend: characteristic-portfolio weights
    ``(Sigma + ridge * max(tr / F, 1) I)^-1 mu``, long-only clipped,
    normalized."""
    cols = factor_ret_win.columns
    f = len(cols)
    mu, cov = _window_moments(factor_ret_win, use_shrinkage, device)
    if not (np.all(np.isfinite(cov)) and np.all(np.isfinite(mu))):
        return pd.Series(0.0, index=cols, name=today)
    a = cov + ridge * max(np.trace(cov) / f, 1.0) * np.eye(f)
    try:
        w = np.linalg.solve(a, mu)
    except np.linalg.LinAlgError:
        return pd.Series(0.0, index=cols, name=today)
    if not np.all(np.isfinite(w)):
        return pd.Series(0.0, index=cols, name=today)
    return _clip_normalize(w, cols, today)
