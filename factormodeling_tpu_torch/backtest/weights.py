"""Daily weight schemes: equal and linear (port of
``factormodeling_tpu/backtest/weights.py``). Both are per-date
cross-sectional transforms of the signal row, batched over the whole
``[D, N]`` panel, or ``[C, D, N]`` lanes whose ``pct`` / ``max_weight``
are ``[C]`` tensors (``settings.knob``)."""

from __future__ import annotations

import torch

from factormodeling_tpu_torch.backtest.settings import knob

__all__ = ["leg_masks", "equal_weights", "linear_weights", "normalize_legs",
           "cap_and_redistribute"]

_N_AXIS = -1


def leg_masks(signal: torch.Tensor):
    """(pos, neg, flat_day): sign masks (NaN is neither) and the stay-flat
    condition — either leg empty."""
    pos = signal > 0.0
    neg = signal < 0.0
    flat = (~pos.any(_N_AXIS)) | (~neg.any(_N_AXIS))
    return pos, neg, flat


def normalize_legs(w: torch.Tensor) -> torch.Tensor:
    """Long leg sums to +1, short leg to -1."""
    wp = torch.clamp(w, min=0.0)
    wn = torch.clamp(w, max=0.0)
    sp = wp.sum(_N_AXIS, keepdim=True)
    sn = -wn.sum(_N_AXIS, keepdim=True)
    wp = torch.where(sp > 0, wp / torch.where(sp > 0, sp, 1.0), wp)
    wn = torch.where(sn > 0, wn / torch.where(sn > 0, sn, 1.0), wn)
    return wp + wn


def _asc_rank(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0-based ascending rank among masked cells; ties keep first-index order."""
    keyed = torch.where(mask, values, float("inf"))
    order = torch.argsort(keyed, dim=_N_AXIS, stable=True)
    return torch.argsort(order, dim=_N_AXIS, stable=True)


def _desc_rank(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0-based descending rank among masked cells; ties keep first-index
    order (the stable rule pandas ``nlargest`` documents)."""
    keyed = torch.where(mask, values, float("-inf"))
    order = torch.argsort(-keyed, dim=_N_AXIS, stable=True)
    return torch.argsort(order, dim=_N_AXIS, stable=True)


def equal_weights(signal: torch.Tensor, pct: float):
    """Top-``pct`` of each leg at +-1, legs normalized: k = max(floor(count *
    pct), 1). Returns (weights [D, N], long_count [D], short_count [D]);
    ``pct`` may be a ``[C]`` tensor over ``[C, ..., N]`` lanes."""
    pos, neg, flat = leg_masks(signal)
    cp = pos.sum(_N_AXIS)
    cn = neg.sum(_N_AXIS)
    pct = knob(pct, cp, torch.get_default_dtype())
    k_long = torch.clamp(torch.floor(cp * pct), min=1.0).to(torch.int32)
    k_short = torch.clamp(torch.floor(cn * pct), min=1.0).to(torch.int32)
    sel_long = pos & (_desc_rank(signal, pos) < k_long[..., None])
    sel_short = neg & (_asc_rank(signal, neg) < k_short[..., None])
    w = sel_long.to(signal.dtype) - sel_short.to(signal.dtype)
    w = normalize_legs(w)
    w = torch.where(flat[..., None], 0.0, w)
    zero = torch.zeros_like(k_long)
    return w, torch.where(flat, zero, k_long), torch.where(flat, zero, k_short)


def cap_and_redistribute(w: torch.Tensor, max_weight: float,
                         max_iter: int = 10, tol: float = 1e-6) -> torch.Tensor:
    """Per-name cap with iterative pro-rata redistribution of the excess, as
    a fixed ``max_iter`` masked loop: converged dates freeze where the
    reference's ``break`` leaves them. ``max_weight`` may be a ``[C]``
    tensor over ``[C, ..., N]`` lanes."""
    max_weight = knob(max_weight, w)
    frozen = torch.zeros(w.shape[:-1] + (1,), dtype=torch.bool, device=w.device)
    for _ in range(max_iter):
        capped = torch.clamp(w, -max_weight, max_weight)
        long_excess = 1.0 - torch.where(capped > 0, capped, 0.0).sum(_N_AXIS, keepdim=True)
        short_excess = -1.0 - torch.where(capped < 0, capped, 0.0).sum(_N_AXIS, keepdim=True)
        ul = (w > 0) & (capped < max_weight)
        us = (w < 0) & (capped > -max_weight)
        has_ul = ul.any(_N_AXIS, keepdim=True)
        has_us = us.any(_N_AXIS, keepdim=True)
        done = (((long_excess.abs() < tol) & (short_excess.abs() < tol))
                | (~has_ul & ~has_us))
        ul_vals = torch.where(ul, capped, 0.0)
        ul_sum = ul_vals.sum(_N_AXIS, keepdim=True)
        add_l = torch.where(has_ul & (long_excess.abs() > tol),
                            long_excess * ul_vals / torch.where(ul_sum != 0, ul_sum, 1.0),
                            0.0)
        us_vals = torch.where(us, capped, 0.0)
        us_sum = us_vals.sum(_N_AXIS, keepdim=True)
        add_s = torch.where(has_us & (short_excess.abs() > tol),
                            short_excess * us_vals / torch.where(us_sum != 0, us_sum, 1.0),
                            0.0)
        w_next = capped + add_l + add_s
        frozen = frozen | done
        w = torch.where(frozen, w, w_next)
    return torch.clamp(w, -max_weight, max_weight)


def linear_weights(signal: torch.Tensor, max_weight: float):
    """Weights proportional to the signal, legs normalized, then capped with
    redistribution. Returns (weights [D, N], long_count [D], short_count [D]);
    ``max_weight`` may be a ``[C]`` tensor over ``[C, ..., N]`` lanes."""
    pos, neg, flat = leg_masks(signal)
    w = torch.where(pos | neg, torch.nan_to_num(signal), 0.0)
    w = normalize_legs(w)
    w = cap_and_redistribute(w, max_weight)
    w = torch.where(flat[..., None], 0.0, w)
    zero = torch.zeros_like(pos.sum(_N_AXIS))
    return (w, torch.where(flat, zero, pos.sum(_N_AXIS)),
            torch.where(flat, zero, neg.sum(_N_AXIS)))
