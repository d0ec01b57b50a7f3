"""Covariance estimates of a factor-return window (port of
``factormodeling_tpu/selection/shrinkage.py``).

Both take ``[..., T, F]`` windows, any leading batch axes (what ``vmap`` of
the JAX functions computes), and return ``[..., F, F]``.

Ledoit-Wolf constant-correlation shrinkage in closed form: every moment the
shrinkage intensity needs reduces to products of the centered data matrix,

    sum_k (c_ki c_kj - S_ij)^2
  =  (C^2)' C^2  - 2 S . (C' C)  +  n S^2     (elementwise in i, j)
"""

from __future__ import annotations

import torch

__all__ = ["ledoit_wolf_shrinkage", "masked_pairwise_cov"]


def ledoit_wolf_shrinkage(returns: torch.Tensor) -> torch.Tensor:
    """Shrink the sample covariance of ``returns [..., T, F]`` toward the
    constant-correlation target."""
    t, p = returns.shape[-2:]
    c = returns - returns.mean(-2, keepdim=True)
    ct = c.mT
    sample = (ct @ c) / (t - 1)

    var = torch.diagonal(sample, dim1=-2, dim2=-1)
    std = torch.sqrt(var)
    denom = std[..., :, None] * std[..., None, :]
    offdiag = ~torch.eye(p, dtype=torch.bool, device=returns.device)
    ok = (denom > 0) & offdiag
    corr = torch.where(ok, sample / torch.where(denom > 0, denom, 1.0), 0.0)
    n_ok = ok.sum((-2, -1))
    mean_corr = torch.where(
        n_ok > 0, corr.sum((-2, -1)) / torch.clamp(n_ok, min=1), 0.0)

    target = torch.where(offdiag, mean_corr[..., None, None] * denom,
                         torch.diag_embed(var))
    d = ((sample - target) ** 2).sum((-2, -1))
    c2 = c * c
    fourth = c2.mT @ c2
    cross = sample * (ct @ c)
    phi = (fourth - 2.0 * cross + t * sample * sample).sum((-2, -1)) / t

    lam = torch.clamp(torch.where(d > 0, phi / d, 1.0), 0.0, 1.0)
    lam = lam[..., None, None]
    return lam * target + (1.0 - lam) * sample


def masked_pairwise_cov(x: torch.Tensor, ddof: int = 1) -> torch.Tensor:
    """pandas ``DataFrame.cov()`` over ``x [..., T, F]`` with NaN holes:
    entry (i, j) uses only the rows where both columns are valid, with
    means over that joint sample. Pairs whose denominator is not positive
    come back NaN."""
    valid = ~torch.isnan(x)
    vf = valid.to(x.dtype)
    x0 = torch.where(valid, x, 0.0)
    v1 = vf.mT @ vf                           # joint counts          [F, F]
    sx = x0.mT @ vf                           # joint sums of x_i     [F, F]
    sxy = x0.mT @ x0                          # joint cross products  [F, F]
    nan = float("nan")
    num = sxy - sx * sx.mT / torch.where(v1 > 0, v1, nan)
    cov = num / torch.where(v1 - ddof > 0, v1 - ddof, nan)
    return 0.5 * (cov + cov.mT)
