"""Factor-selection methods behind the registry (port of
``factormodeling_tpu/selection/selectors.py``).

A selector consumes a :class:`SelectionContext` of precomputed whole-sample
tensors and emits raw daily weight rows for all dates at once,
``float[D, F]``; the driver masks them to the processed range and
row-normalizes. ``icir_top`` and ``momentum`` are one expression over all
dates; the covariance-based selectors (``mvo``, ``pca``, ``regression``)
solve ``batch_size`` dates per batched call (the JAX package's
``lax.map(..., batch_size=...)``), each date its own lane with no warm
start, so the result does not depend on ``batch_size``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from factormodeling_tpu_torch.selection.shrinkage import (
    ledoit_wolf_shrinkage, masked_pairwise_cov)
from factormodeling_tpu_torch.solvers.admm_qp import (BoxQPProblem,
                                                      admm_solve_dense)

__all__ = ["SelectionContext", "FACTOR_SELECTION_METHODS",
           "register_selection_method", "icir_top_selector",
           "factor_momentum_selector", "mvo_selector", "pca_selector",
           "regression_selector"]


@dataclasses.dataclass(frozen=True)
class SelectionContext:
    """Everything a selector may need, precomputed once for the whole sample.

    ``metrics_win[...][f, t]`` aggregates the window ending the day before
    ``t`` (the driver pre-shifts), so selectors read column ``t`` directly.
    """

    metrics_win: dict            # name -> float[F, D] trailing-window metrics
    factor_ret: torch.Tensor     # float[D, F] per-date factor returns (raw)
    ret_win_sum: torch.Tensor    # float[D, F] trailing-window sums (shifted)
    window: int


def icir_top_selector(ctx: SelectionContext, *, icir_threshold: float = 0.03,
                      top_x: int = 5, use_rank_icir: bool = True,
                      **_ignored) -> torch.Tensor:
    """Equal-weight the top ``top_x`` factors whose (rank-)ICIR exceeds the
    threshold; ties keep first-factor order like pandas ``nlargest``."""
    score = ctx.metrics_win["rank_IC_IR" if use_rank_icir else "IC_IR"]  # [F, D]
    eligible = score > icir_threshold  # NaN -> False
    keyed = torch.where(eligible, score, float("-inf"))
    order = torch.argsort(-keyed, dim=0, stable=True)
    rank_of = torch.argsort(order, dim=0, stable=True)
    chosen = eligible & (rank_of < top_x)
    return chosen.to(score.dtype).T  # [D, F]


def factor_momentum_selector(ctx: SelectionContext, *, max_weight: float = 1.0,
                             **_ignored) -> torch.Tensor:
    """Weight proportional to clip(window-sum of factor returns, 0, cap)."""
    mom = torch.clamp(ctx.ret_win_sum, min=0.0)  # [D, F]
    if max_weight < 1.0:
        mom = torch.clamp(mom, max=max_weight)
    return mom


def _windowed_moments(ctx: SelectionContext, today_idx: torch.Tensor, *,
                      use_shrinkage: bool):
    """(mu [B, F], cov [B, F, F]) of the trailing factor-return windows
    ending the day before each of ``today_idx [B]``: the shared plumbing of
    the covariance-based selectors. Rows on or after today are NaN (the
    clamped start would otherwise leak same-day and future returns for the
    early dates); without shrinkage the covariance is the pairwise-complete
    one of pandas ``DataFrame.cov()``."""
    ret = ctx.factor_ret
    start = torch.clamp(today_idx - ctx.window, min=0)
    rows = start[:, None] + torch.arange(ctx.window, device=ret.device)
    in_past = rows < today_idx[:, None]
    win = torch.where(in_past[..., None], ret[rows], float("nan"))  # [B, W, F]
    mu = torch.nanmean(win, dim=1)
    if use_shrinkage:
        cov = ledoit_wolf_shrinkage(win)
        cov = 0.5 * (cov + cov.mT)
    else:
        cov = masked_pairwise_cov(win)
    return mu, cov


def _by_chunks(ctx: SelectionContext, batch_size: int, solve_chunk):
    """Raw weights ``[D, F]`` from ``solve_chunk(today_idx [B])`` over the
    dates in chunks of ``batch_size``."""
    d = ctx.factor_ret.shape[0]
    dev = ctx.factor_ret.device
    return torch.cat([solve_chunk(torch.arange(lo, min(lo + batch_size, d),
                                               device=dev))
                      for lo in range(0, d, batch_size)])


def mvo_selector(ctx: SelectionContext, *, risk_aversion: float = 1.0,
                 max_weight: float = 1.0, turnover_penalty: float = 0.0,
                 use_shrinkage: bool = True, qp_iters: int = 500,
                 batch_size: int = 32, **_ignored) -> torch.Tensor:
    """Max-Sharpe factor weights: maximize ``mu'w - gamma w'Sigma w`` on the
    capped simplex by the dense ADMM QP, ``batch_size`` dates as lanes of
    one solve. A non-finite solution (NaN in the window) gives zero
    weights, the reference's failure fallback. The turnover term is inert
    by default, as in the reference (no previous weights are threaded)."""
    ret = ctx.factor_ret
    f = ret.shape[1]
    cap = max_weight if max_weight < 1.0 else 1.0

    def solve_chunk(idx):
        mu, cov = _windowed_moments(ctx, idx, use_shrinkage=use_shrinkage)
        b = idx.numel()
        zeros = torch.zeros((b, f), dtype=ret.dtype, device=ret.device)
        prob = BoxQPProblem(
            q=-mu, lo=zeros, hi=torch.full_like(zeros, cap),
            E=torch.ones((b, 1, f), dtype=ret.dtype, device=ret.device),
            b=torch.ones((b, 1), dtype=ret.dtype, device=ret.device),
            l1=float(turnover_penalty), center=zeros)
        w = admm_solve_dense(2.0 * risk_aversion * cov, prob,
                             iters=qp_iters).x
        ok = torch.isfinite(w).all(-1, keepdim=True)
        return torch.where(ok, torch.clamp(w, min=0.0), 0.0)

    return _by_chunks(ctx, batch_size, solve_chunk)


def _finite_moments(mu, cov):
    """(finite [B], cov with non-finite windows replaced by the identity)."""
    finite = torch.isfinite(cov).all(-1).all(-1) & torch.isfinite(mu).all(-1)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return finite, torch.where(finite[:, None, None], cov, eye)


def pca_selector(ctx: SelectionContext, *, use_shrinkage: bool = True,
                 batch_size: int = 64, **_ignored) -> torch.Tensor:
    """PCA blend: weight factors by the leading eigenvector of the trailing
    window's factor-return covariance, sign-oriented by the window's mean
    returns; negative loadings clip to 0, and a non-finite window gives
    zero weights."""

    def solve_chunk(idx):
        mu, cov = _windowed_moments(ctx, idx, use_shrinkage=use_shrinkage)
        finite, cov = _finite_moments(mu, cov)
        lead = torch.linalg.eigh(cov)[1][..., -1]   # ascending eigenvalues
        dot = (lead * mu).sum(-1)
        lead = lead * torch.sign(torch.where(dot == 0.0, 1.0, dot))[:, None]
        return torch.where(finite[:, None], torch.clamp(lead, min=0.0), 0.0)

    return _by_chunks(ctx, batch_size, solve_chunk)


def regression_selector(ctx: SelectionContext, *, ridge: float = 1e-4,
                        use_shrinkage: bool = True, batch_size: int = 64,
                        **_ignored) -> torch.Tensor:
    """Regression blend: characteristic-portfolio weights
    ``(Sigma + ridge * max(tr(Sigma) / F, 1) I)^-1 mu`` over the trailing
    window; negative weights clip to 0, and a non-finite window or solve
    gives zero weights."""

    def solve_chunk(idx):
        mu, cov = _windowed_moments(ctx, idx, use_shrinkage=use_shrinkage)
        finite, cov = _finite_moments(mu, cov)
        f = cov.shape[-1]
        mu0 = torch.where(finite[:, None], mu, 0.0)
        tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / f
        a = cov + ((ridge * torch.clamp(tr, min=1.0))[:, None, None]
                   * torch.eye(f, dtype=cov.dtype, device=cov.device))
        # solve_ex: a singular system surfaces as non-finite w, no host sync
        w = torch.linalg.solve_ex(a, mu0)[0]
        finite = finite & torch.isfinite(w).all(-1)
        return torch.where(finite[:, None], torch.clamp(w, min=0.0), 0.0)

    return _by_chunks(ctx, batch_size, solve_chunk)


FACTOR_SELECTION_METHODS: dict[str, Callable] = {
    "icir_top": icir_top_selector,
    "momentum": factor_momentum_selector,
    "mvo": mvo_selector,
    "pca": pca_selector,
    "regression": regression_selector,
}


def register_selection_method(name: str, fn: Callable) -> None:
    """Extend the selector registry."""
    FACTOR_SELECTION_METHODS[name] = fn
