"""Statistical risk model: PCA on the asset return panel, refined by one
alternating-least-squares step (port of ``factormodeling_tpu/risk.py``:
:class:`RiskModel`, :func:`pca` and :func:`statistical_risk_model`; the
factor-return covariance estimators and the risk-model optimizer are not
ported yet).

The covariance stays factored, ``Sigma = B diag(f) B' + diag(idio)``, never
``N x N``. Exact PCA runs ``eigh`` on the smaller Gram dimension;
randomized subspace iteration (Halko et al.) finds the top-k components with
O(D N k) matmul work and is what ``method="auto"`` picks when
``k + oversample < min(D, N) // 4``.

Randomized PCA draws its Gaussian sketch with a ``torch.Generator`` seeded
from ``seed`` on the CPU in float64 (:func:`_sketch`), then moves it to the
panel's device, so the CPU and the card see the same numbers. They are not
the JAX package's numbers (``jax.random`` cannot be reproduced), so the
components agree with the JAX package's only to within the subspace
iteration's convergence; the tests swap the JAX draw in.

``eigh``, ``qr`` and ``svd`` may pick other column signs than XLA's: compare
sign-invariant quantities (``B diag(f) B'``, ``factor_var``, ``idio_var``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from factormodeling_tpu_torch.ops._linalg import spd_solve

__all__ = ["PCAResult", "RiskModel", "pca", "statistical_risk_model"]


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


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-column mean over valid cells of ``[D, N]`` (NaN where none)."""
    w = valid.to(x.dtype)
    den = w.sum(0)
    x0 = torch.where(valid, x, 0.0)
    return (w * x0).sum(0) / torch.where(den > 0, den, float("nan"))


def _demean_fill(returns: torch.Tensor, valid: torch.Tensor | None):
    """Masked demean of ``[D, N]``; missing cells -> 0 (mean-imputed)."""
    ok = ~torch.isnan(returns)
    valid = ok if valid is None else valid & ok
    mu = _masked_mean(returns, valid)
    mu = torch.where(torch.isnan(mu), 0.0, mu)
    c = torch.where(valid, returns - mu[None, :], 0.0)
    return c, mu, valid


def _sketch(n: int, l: int, seed: int, dtype, device) -> torch.Tensor:
    """The randomized PCA's ``[n, l]`` standard-normal test matrix, drawn on
    the CPU in float64 from ``seed`` so every device sees the same one."""
    gen = torch.Generator().manual_seed(int(seed))
    q = torch.randn((n, l), generator=gen, dtype=torch.float64)
    return q.to(dtype=dtype, device=device)


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
