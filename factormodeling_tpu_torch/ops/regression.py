"""Closed-form OLS ops: rolling per-symbol and per-date cross-sectional
(port of ``factormodeling_tpu/ops/regression.py``; reference
``operations.py:185-304``).

``cs_regression`` is one masked-moment reduction over the asset axis for all
dates at once. ``ts_regression_fast`` keeps the reference's
drop-missing-rows-then-roll semantics (windows span gaps) with a stable
per-column compaction of the valid pairs, rolled and gathered back.
``cs_ols`` builds every date's normal equations with batched matrix
products and solves them with the pivot-free :func:`~._linalg.spd_solve`,
as the JAX package does.
"""

from __future__ import annotations

import torch

from factormodeling_tpu_torch.ops._linalg import spd_solve
from factormodeling_tpu_torch.ops._window import (compaction_order,
                                                  masked_shift, rolling_max,
                                                  rolling_min, rolling_sum,
                                                  shift)

__all__ = ["ts_regression_fast", "cs_regression", "cs_ols",
           "TS_RETTYPES", "CS_RETTYPES"]

_DATE_AXIS = -2
_ASSET_AXIS = -1

# reference rettype codes (operations.py:229-240)
TS_RETTYPES = {0: "resid", 1: "alpha", 2: "beta", 3: "fitted", 6: "r2"}
CS_RETTYPES = ("resid", "beta", "alpha", "fitted", "r2")

_NAN = float("nan")


def _constant_in_window(vals, valid, window):
    """Full windows whose valid values are all equal (window max == min):
    a structural test the JAX package uses instead of the cancellation."""
    big = torch.where(valid, vals, float("-inf"))
    small = torch.where(valid, vals, float("inf"))
    return rolling_max(big, window) == rolling_min(small, window)


def ts_regression_fast(y: torch.Tensor, x: torch.Tensor, window: int,
                       lag: int = 0, rettype: int = 2,
                       universe: torch.Tensor | None = None) -> torch.Tensor:
    """Per-symbol rolling OLS y ~ x over the last ``window`` jointly-valid
    observations (reference ``operations.py:185-246``).

    ``lag`` shifts x forward ``lag`` dates per symbol (within ``universe``
    when given) before pairing; the reference shifts the long frame
    positionally, which leaks values across symbols (a documented divergence
    the JAX package fixes). rettype: 0=resid, 1=alpha, 2=beta, 3=fitted,
    6=R^2. Windows already span universe gaps (absent cells are NaN and
    dropped), so ``universe`` matters only for the lag shift.
    """
    if rettype not in TS_RETTYPES:
        raise ValueError(f"rettype {rettype} not implemented")
    if universe is not None:
        x = torch.where(universe, x, _NAN)
        y = torch.where(universe, y, _NAN)
    if lag:
        if universe is not None:
            x = masked_shift(x, universe, lag, axis=_DATE_AXIS)
        else:
            x = shift(x, lag, axis=_DATE_AXIS)
    pair_valid = ~torch.isnan(x) & ~torch.isnan(y)
    xx = torch.where(pair_valid, x, _NAN)
    yy = torch.where(pair_valid, y, _NAN)

    order, inv = compaction_order(pair_valid, axis=_DATE_AXIS)
    xc = torch.take_along_dim(xx, order, dim=_DATE_AXIS)
    yc = torch.take_along_dim(yy, order, dim=_DATE_AXIS)
    cvalid = torch.take_along_dim(pair_valid, order, dim=_DATE_AXIS)

    full = rolling_sum(cvalid.to(torch.int32), window) == window
    x0 = torch.where(cvalid, xc, 0.0)
    y0 = torch.where(cvalid, yc, 0.0)
    sx = rolling_sum(x0, window)
    sy = rolling_sum(y0, window)
    sxx = rolling_sum(x0 * x0, window)
    sxy = rolling_sum(x0 * y0, window)

    mx, my = sx / window, sy / window
    cov_xy = sxy / window - mx * my
    var_x = sxx / window - mx * mx
    var_x = torch.where(_constant_in_window(xc, cvalid, window), _NAN, var_x)
    beta = cov_xy / var_x
    alpha = my - beta * mx
    if rettype == 0:
        out = yc - (alpha + beta * xc)
    elif rettype == 1:
        out = alpha
    elif rettype == 2:
        out = beta
    elif rettype == 3:
        out = alpha + beta * xc
    else:  # 6: R^2 = cov^2 / (var_x var_y)
        var_y = rolling_sum(y0 * y0, window) / window - my * my
        var_y = torch.where(_constant_in_window(yc, cvalid, window), _NAN,
                            var_y)
        out = (cov_xy * cov_xy) / (var_x * var_y)
    out = torch.where(full, out, _NAN)
    return torch.take_along_dim(out, inv, dim=_DATE_AXIS)


def cs_regression(y: torch.Tensor, x: torch.Tensor, rettype: str = "resid",
                  universe: torch.Tensor | None = None) -> torch.Tensor:
    """Per-date OLS y ~ x over jointly-valid pairs (reference
    ``operations.py:248-304``): < 2 valid pairs -> all-NaN date; scalar
    rettypes (beta/alpha/r2) broadcast to the valid cells only."""
    if rettype not in CS_RETTYPES:
        raise ValueError(f"ERROR: rettype={rettype}")
    if universe is not None:
        x = torch.where(universe, x, _NAN)
        y = torch.where(universe, y, _NAN)
    pair_valid = ~torch.isnan(x) & ~torch.isnan(y)
    cnt = pair_valid.sum(_ASSET_AXIS, keepdim=True).to(y.dtype)
    x0 = torch.where(pair_valid, x, 0.0)
    y0 = torch.where(pair_valid, y, 0.0)
    cs = torch.where(cnt > 0, cnt, _NAN)
    mx = x0.sum(_ASSET_AXIS, keepdim=True) / cs
    my = y0.sum(_ASSET_AXIS, keepdim=True) / cs
    dx = torch.where(pair_valid, x - mx, 0.0)
    dy = torch.where(pair_valid, y - my, 0.0)
    cov_xy = (dx * dy).sum(_ASSET_AXIS, keepdim=True) / cs
    var_x = (dx * dx).sum(_ASSET_AXIS, keepdim=True) / cs
    beta = cov_xy / var_x
    alpha = my - beta * mx
    if rettype == "resid":
        out = y - (alpha + beta * x)
    elif rettype == "beta":
        out = beta.expand(y.shape)
    elif rettype == "alpha":
        out = alpha.expand(y.shape)
    elif rettype == "fitted":
        out = alpha + beta * x
    else:  # r2
        var_y = (dy * dy).sum(_ASSET_AXIS, keepdim=True) / cs
        out = ((cov_xy * cov_xy) / (var_x * var_y)).expand(y.shape)
    out = torch.where(pair_valid, out, _NAN)
    return torch.where(cnt >= 2, out, _NAN)


def cs_ols(y: torch.Tensor, x: torch.Tensor, *,
           universe: torch.Tensor | None = None,
           intercept: bool = True,
           ridge: float = 0.0) -> torch.Tensor:
    """Barra-style per-date multivariate cross-sectional OLS: each date's
    asset returns ``y [D, N]`` on that date's exposures ``x [F, D, N]``,
    giving ``[D, F]`` factor returns (the multi-factor generalization of
    :func:`cs_regression`). ``intercept`` demeans within the valid
    cross-section (the intercept is estimated, not returned); ``ridge``
    adds a Levenberg-style diagonal scaled by the mean diagonal of each
    date's normal matrix (0 keeps the JAX package's 10-eps floor). Dates
    with fewer valid assets than regressors are NaN rows."""
    f = x.shape[0]
    valid = ~torch.isnan(y) & ~torch.isnan(x).any(0)
    if universe is not None:
        valid = valid & universe
    m = valid.to(y.dtype)                                   # [D, N]
    xt = torch.where(valid[:, None, :], x.transpose(0, 1), 0.0)  # [D, F, N]
    y0 = torch.where(valid, y, 0.0)                         # [D, N]
    cnt = m.sum(-1)                                         # [D]

    if intercept:
        # demean within the valid cross-section == estimating an intercept
        cs = torch.where(cnt > 0, cnt, 1.0)
        xt = xt - (xt.sum(-1, keepdim=True) / cs[:, None, None]) * m[:, None, :]
        y0 = y0 - (y0.sum(-1, keepdim=True) / cs[:, None]) * m

    a = torch.matmul(xt, xt.transpose(1, 2))                # [D, F, F]
    b = torch.matmul(xt, y0[..., None])[..., 0]             # [D, F]
    tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / f
    eps = ridge if ridge > 0 else 10 * torch.finfo(y.dtype).eps
    eye = torch.eye(f, dtype=y.dtype, device=y.device)
    a = a + (torch.clamp(tr, min=1.0) * eps)[:, None, None] * eye
    beta = spd_solve(a, b)                                  # [D, F]
    need = f + (1 if intercept else 0)
    return torch.where((cnt >= need)[:, None], beta, _NAN)
