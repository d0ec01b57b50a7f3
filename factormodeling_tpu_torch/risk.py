"""Statistical risk model: PCA on the asset return panel, refined by one
alternating-least-squares step (port of ``factormodeling_tpu/risk.py``):
the NaN-aware factor-return covariance (:func:`factor_covariance`: sample,
EWMA-weighted through :func:`ewma_weights`, or Ledoit-Wolf), the PCA
factor model (:func:`pca`, :func:`statistical_risk_model`), its factored
products (:func:`risk_matvec`, :func:`portfolio_variance`,
:func:`full_covariance`) and the dollar-neutral optimizer under it
(:func:`optimal_weights`).

The covariance stays factored, ``Sigma = B diag(f) B' + diag(idio)``, never
``N x N``. Exact PCA runs ``eigh`` on the smaller Gram dimension;
randomized subspace iteration (Halko et al.) finds the top-k components with
O(D N k) matmul work and is what ``method="auto"`` picks when
``k + oversample < min(D, N) // 4``.

Randomized PCA draws its Gaussian sketch as the JAX package does,
``jax.random.normal(jax.random.key(seed), (n, l))`` at the centred panel's
dtype (:func:`_sketch`, through :mod:`~factormodeling_tpu_torch.threefry`
on the panel's device): the same numbers to a few ulp on the CPU and on
the card.

``eigh``, ``qr`` and ``svd`` may pick other column signs than XLA's: compare
sign-invariant quantities (``B diag(f) B'``, ``factor_var``, ``idio_var``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from factormodeling_tpu_torch import threefry
from factormodeling_tpu_torch.ops._linalg import spd_solve
from factormodeling_tpu_torch.selection.shrinkage import (
    ledoit_wolf_shrinkage, masked_pairwise_cov)

__all__ = ["PCAResult", "RiskModel", "ewma_weights", "factor_covariance",
           "full_covariance", "optimal_weights", "pca", "portfolio_variance",
           "risk_matvec", "statistical_risk_model"]


class PCAResult(NamedTuple):
    """Top-k principal components of a (masked) ``[D, N]`` panel:
    ``components [k, N]`` orthonormal rows, ``explained_variance [k]``
    (ddof=1, descending), ``mean [N]`` removed before decomposition."""

    components: torch.Tensor
    explained_variance: torch.Tensor
    mean: torch.Tensor


class RiskModel(NamedTuple):
    """``Sigma = B diag(factor_var) B' + diag(idio_var)``: ``loadings
    [N, k]``, ``factor_var [k]`` (descending), ``idio_var [N]``, ``mean
    [N]``."""

    loadings: torch.Tensor
    factor_var: torch.Tensor
    idio_var: torch.Tensor
    mean: torch.Tensor


def ewma_weights(d: int, halflife: float, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """``[D]`` exponential weights, most recent observation last and
    heaviest, normalized to sum 1: ``w_t ~ 2^{-(D-1-t)/halflife}``."""
    ages = torch.arange(d - 1, -1, -1, dtype=dtype, device=device)
    w = torch.exp2(-ages / torch.tensor(halflife, dtype=dtype, device=device))
    return w / w.sum()


def _masked_mean(x: torch.Tensor, valid: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-column (optionally weighted) mean over valid cells of ``[D, N]``
    (NaN where none)."""
    w = valid.to(x.dtype) if weights is None else valid * weights[:, None]
    den = w.sum(0)
    x0 = torch.where(valid, x, 0.0)
    return (w * x0).sum(0) / torch.where(den > 0, den, float("nan"))


def factor_covariance(factor_returns: torch.Tensor, *,
                      weights: torch.Tensor | None = None, ddof: int = 1,
                      shrinkage: float = 0.0,
                      method: str = "sample") -> torch.Tensor:
    """NaN-aware covariance ``[F, F]`` of a ``[D, F]`` factor-return panel.

    ``method="sample"``: pairwise-complete (pandas ``DataFrame.cov``), with
    optional observation ``weights [D]`` (:func:`ewma_weights`; the
    denominator is then ``V1 - V2/V1``). ``method="ledoit_wolf"``:
    constant-correlation shrinkage of the mean-filled panel (no weights).
    ``shrinkage`` ``lam`` applies ``(1-lam) S + lam mean(diag S) I`` after
    estimation. Entries with too few joint observations are NaN."""
    x = factor_returns
    valid = ~torch.isnan(x)
    if method == "ledoit_wolf":
        if weights is not None:
            raise ValueError(
                "method='ledoit_wolf' does not support observation weights "
                "(the shrinkage moments are equal-weighted, ddof=1); use "
                "method='sample' for EWMA estimation")
        mu = _masked_mean(x, valid)
        cov = ledoit_wolf_shrinkage(torch.where(valid, x, mu[None, :]))
    elif method == "sample":
        cov = masked_pairwise_cov(x, weights=weights, ddof=ddof)
    else:
        raise ValueError(f"unknown covariance method: {method!r}")
    if shrinkage:
        lam = float(shrinkage)
        target = (torch.nanmean(torch.diagonal(cov))
                  * torch.eye(cov.shape[0], dtype=cov.dtype,
                              device=cov.device))
        cov = (1.0 - lam) * cov + lam * target
    return cov


def _demean_fill(returns: torch.Tensor, valid: torch.Tensor | None):
    """Masked demean of ``[D, N]``; missing cells -> 0 (mean-imputed)."""
    ok = ~torch.isnan(returns)
    valid = ok if valid is None else valid & ok
    mu = _masked_mean(returns, valid)
    mu = torch.where(torch.isnan(mu), 0.0, mu)
    c = torch.where(valid, returns - mu[None, :], 0.0)
    return c, mu, valid


def _sketch(n: int, l: int, seed: int, dtype, device) -> torch.Tensor:
    """The randomized PCA's ``[n, l]`` standard-normal test matrix: the JAX
    package's draw under ``seed``, in ``dtype`` on ``device``."""
    return threefry.normal(threefry.seed_key(seed), (n, l), dtype,
                           device=device)


def _pca_centered(c: torch.Tensor, k: int, method: str, oversample: int,
                  iters: int, seed: int):
    """Top-k decomposition of a centered, zero-filled ``[D, N]`` matrix ->
    ``(components [k, N], explained_variance [k])``."""
    d, n = c.shape
    if method == "auto":
        method = "randomized" if k + oversample < min(d, n) // 4 else "eigh"
    if method == "eigh":
        if d <= n:
            # dual: eigh of the date-space Gram, projected back; modes with
            # (numerically) zero eigenvalue are zeroed, not divided by a floor
            evals, evecs = torch.linalg.eigh(c @ c.T)        # ascending
            evals = evals.flip(-1)[:k]
            u = evecs.flip(-1)[:, :k]                        # [D, k]
            tol = torch.finfo(c.dtype).eps * max(d, n)
            ok = evals > evals[0] * tol
            scale = torch.sqrt(torch.where(ok, evals, 1.0))
            comps = (c.T @ (u / scale[None, :])).T           # [k, N]
            comps = torch.where(ok[:, None], comps, 0.0)
            evals = torch.where(ok, evals, 0.0)
        else:
            evals, evecs = torch.linalg.eigh(c.T @ c)
            evals = evals.flip(-1)[:k]
            comps = evecs.flip(-1)[:, :k].T
        explained = torch.clamp(evals, min=0.0) / (d - 1)
    elif method == "randomized":
        l = int(min(k + oversample, d, n))
        q = _sketch(n, l, seed, c.dtype, c.device)
        for _ in range(max(iters, 1)):
            q, _ = torch.linalg.qr(c.T @ (c @ q))
        _, s, vt = torch.linalg.svd(c @ q, full_matrices=False)
        comps = (vt @ q.T)[:k]                               # [k, N]
        explained = s[:k] ** 2 / (d - 1)
    else:
        raise ValueError(f"unknown PCA method: {method!r}")
    return comps, explained


def pca(returns: torch.Tensor, k: int, *, valid: torch.Tensor | None = None,
        demean: bool = True, method: str = "auto", oversample: int = 8,
        iters: int = 4, seed: int = 0) -> PCAResult:
    """Top-k PCA of a ``[D, N]`` (masked) return panel; missing cells are
    mean-imputed, eigenvalues are of the ddof=1 sample covariance.
    ``method``: ``"eigh"`` (exact), ``"randomized"`` (Halko subspace
    iteration) or ``"auto"``."""
    d, n = returns.shape
    k = int(min(k, d, n))
    if demean:
        c, mu, _ = _demean_fill(returns, valid)
    else:
        c = torch.nan_to_num(returns, nan=0.0)
        if valid is not None:
            c = torch.where(valid, c, 0.0)
        mu = torch.zeros(n, dtype=returns.dtype, device=returns.device)
    comps, explained = _pca_centered(c, k, method, oversample, iters, seed)
    return PCAResult(components=comps, explained_variance=explained, mean=mu)


def statistical_risk_model(returns: torch.Tensor, k: int, *,
                           valid: torch.Tensor | None = None,
                           method: str = "auto", min_idio_var: float = 1e-12,
                           refine: bool = True, oversample: int = 8,
                           iters: int = 4, seed: int = 0) -> RiskModel:
    """Estimate ``Sigma = B diag(f) B' + diag(idio)`` from a ``[D, N]``
    panel: PCA on the mean-imputed panel finds the factor directions; with
    ``refine`` one ALS step regresses each asset's observed returns on the
    factor scores (batched ``k x k`` masked normal equations through
    :func:`spd_solve`) and rotates the loadings so the factor covariance is
    diagonal. Residual variances are over observed cells (ddof=1), floored
    at ``min_idio_var``."""
    d, n = returns.shape
    k = int(min(k, d, n))
    c, mu, valid_eff = _demean_fill(returns, valid)
    comps, explained = _pca_centered(c, k, method, oversample, iters, seed)
    if refine:
        s = c @ comps.T                                      # [D, k] scores
        m = valid_eff.to(c.dtype)
        # per-asset masked normal equations (S' diag(m_i) S) g_i = S' c_i
        a = torch.einsum("dk,dn,dl->nkl", s, m, s)           # [N, k, k]
        y = torch.einsum("dk,dn->nk", s, c)                  # [N, k]
        tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / k
        eps = torch.finfo(c.dtype).eps * 100.0
        ridge = (torch.clamp(tr, min=1.0)[:, None, None] * eps
                 * torch.eye(k, dtype=c.dtype, device=c.device))
        g = spd_solve(a + ridge, y)                          # [N, k]
        # rotate so the factor covariance is diagonal: Cov(S) = U diag(f) U'
        sc = s - s.mean(0, keepdim=True)
        fvar, u = torch.linalg.eigh(sc.T @ sc / (d - 1))     # ascending
        b = g @ u.flip(-1)                                   # [N, k]
        factor_var = torch.clamp(fvar.flip(-1), min=0.0)
        resid = torch.where(valid_eff, c - s @ g.T, 0.0)
    else:
        b = comps.T
        factor_var = explained
        resid = torch.where(valid_eff, c - (c @ b) @ b.T, 0.0)
    cnt = valid_eff.sum(0).to(c.dtype)
    idio = (resid * resid).sum(0) / torch.where(cnt > 1, cnt - 1.0,
                                                float("nan"))
    idio = torch.clamp(torch.where(torch.isnan(idio), min_idio_var, idio),
                       min=min_idio_var)
    return RiskModel(loadings=b, factor_var=factor_var, idio_var=idio, mean=mu)


def risk_matvec(model: RiskModel, w: torch.Tensor) -> torch.Tensor:
    """``Sigma @ w`` in O(N k) without forming ``Sigma``: ``B (f * (B' w))
    + idio * w``; batched over leading axes of ``w``."""
    fw = (w @ model.loadings) * model.factor_var             # [..., k]
    return fw @ model.loadings.T + model.idio_var * w


def portfolio_variance(model: RiskModel, w: torch.Tensor) -> torch.Tensor:
    """``w' Sigma w`` in factored form; batched over leading axes of ``w``."""
    fw = (w @ model.loadings) * torch.sqrt(model.factor_var)
    return (fw * fw).sum(-1) + (w * w * model.idio_var).sum(-1)


def full_covariance(model: RiskModel) -> torch.Tensor:
    """``Sigma`` at ``[N, N]``: for tests and small universes only."""
    b = model.loadings
    return (b * model.factor_var[None, :]) @ b.T + torch.diag(model.idio_var)


def optimal_weights(model: RiskModel, signal: torch.Tensor, *,
                    max_weight: float = 0.03, return_weight: float = 0.0,
                    turnover_penalty: float = 0.0,
                    prev_weights: torch.Tensor | None = None,
                    qp_iters: int = 500, rho: float = 2.0,
                    polish: bool = True):
    """Dollar-neutral long/short MVO under the factored model: the backtest
    engine's constraint set (long leg +1, short leg -1, sign-consistent
    boxes of ``max_weight``, zero-signal names pinned to 0) with the
    variance ``w' Sigma w`` of ``Sigma = B diag(f) B' + diag(idio)``, solved
    by the low-rank ADMM path (O(N k) an iteration). Returns ``(weights,
    primal_residual, solver_ok)``; a failed or infeasible solve falls back
    to equal-weight legs."""
    from factormodeling_tpu_torch.solvers.admm_qp import (BoxQPProblem,
                                                          admm_solve_lowrank)
    from factormodeling_tpu_torch.solvers.portfolio import (
        equal_leg_fallback, leg_constraints, legs_feasible)

    dtype = model.loadings.dtype
    sig = torch.nan_to_num(signal).to(dtype)
    lo, hi, E, b = leg_constraints(sig, max_weight, dtype)
    prev = (torch.zeros_like(sig) if prev_weights is None
            else torch.nan_to_num(prev_weights).to(dtype))
    prob = BoxQPProblem(q=(-return_weight) * sig, lo=lo, hi=hi, E=E, b=b,
                        l1=turnover_penalty, center=prev)
    # the reference objective is w' Sigma w (not halved): P = 2 Sigma
    res = admm_solve_lowrank(2.0 * model.idio_var, model.loadings.T,
                             2.0 * model.factor_var, prob, rho=rho,
                             iters=qp_iters, polish=polish)
    w = res.x
    ok = torch.isfinite(w).all(-1) & legs_feasible(sig, max_weight)
    return (torch.where(ok[..., None], w, equal_leg_fallback(sig)),
            res.primal_residual, ok)
