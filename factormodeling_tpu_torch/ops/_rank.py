"""Masked ranking and quantile primitives (port of
``factormodeling_tpu/ops/_rank.py``).

pandas cross-sectional semantics: average-tie ranks over the non-NaN subset
and linear-interpolation quantiles, both sort-based. ``torch.sort`` sends
NaN last in ascending order, and the tie tests compare neighbours with
``!=``, so each NaN is its own run and -0.0 ties with +0.0.
"""

from __future__ import annotations

import torch

__all__ = ["avg_rank", "masked_quantile", "sorted_avg_ranks"]


def _run_starts_to_first(is_start: torch.Tensor, ar: torch.Tensor) -> torch.Tensor:
    """Index of the first element of each element's run (last axis)."""
    return torch.cummax(torch.where(is_start, ar, -1), dim=-1).values


def _run_starts_to_last(is_start: torch.Tensor, ar: torch.Tensor) -> torch.Tensor:
    """Index of the last element of each element's run (last axis)."""
    n = is_start.shape[-1]
    nxt_start = torch.cat([is_start[..., 1:],
                           torch.ones_like(is_start[..., :1])], dim=-1)
    end_pos = torch.where(nxt_start, ar, n)
    return torch.cummin(end_pos.flip(-1), dim=-1).values.flip(-1)


def sorted_avg_ranks(s_key: torch.Tensor, valid_sorted: torch.Tensor,
                     axis: int = -1) -> torch.Tensor:
    """Average-tie 1-based ranks of an ALREADY-SORTED key array (NaNs last,
    each NaN its own run); invalid cells get rank NaN. The plain version of
    the rank-IC post-sort stage."""
    s_key = s_key.movedim(axis, -1)
    valid_sorted = valid_sorted.movedim(axis, -1)
    n = s_key.shape[-1]
    ar = torch.arange(n, device=s_key.device)
    prev = torch.cat([s_key[..., :1], s_key[..., :-1]], dim=-1)
    tie_start = s_key != prev
    tie_start[..., 0] = True
    tie_first = _run_starts_to_first(tie_start, ar)
    tie_last = _run_starts_to_last(tie_start, ar)
    ranks = 0.5 * (tie_first + tie_last).to(s_key.dtype) + 1.0
    return torch.where(valid_sorted, ranks, float("nan")).movedim(-1, axis)


def avg_rank(values: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """1-based average-tie rank among non-NaN values along ``axis`` (NaN ->
    NaN), i.e. pandas ``rank()``: one sort, sorted-space ranks, and a scatter
    back to the original order."""
    values = values.movedim(axis, -1)
    s_key, idx = torch.sort(values, dim=-1)
    ranks_sorted = sorted_avg_ranks(s_key, ~torch.isnan(s_key))
    ranks = torch.empty_like(ranks_sorted).scatter_(-1, idx, ranks_sorted)
    return ranks.movedim(-1, axis)


def masked_quantile(values: torch.Tensor, qs, *, axis: int = -1) -> torch.Tensor:
    """Linear-interpolation quantiles of the non-NaN values along ``axis``
    (pandas ``Series.quantile`` / ``np.nanpercentile`` rule).

    ``qs``: a sequence of K quantiles in [0, 1]; ``axis`` is replaced by K.
    No valid values -> NaN. Sort-based: ``torch.quantile`` refuses inputs
    above 2^24 elements, which a pooled ``[D, K*N]`` suffix panel passes.
    """
    values = values.movedim(axis, -1)
    n = values.shape[-1]
    qs_arr = torch.as_tensor(qs, dtype=values.dtype).reshape(-1).to(values.device)
    valid = ~torch.isnan(values)
    cnt = valid.sum(-1, keepdim=True).to(values.dtype)
    s = torch.sort(torch.where(valid, values, float("inf")), dim=-1).values
    pos = qs_arr * (cnt - 1.0)                                   # [..., K]
    lo = torch.clamp(torch.floor(pos), 0, n - 1).to(torch.int64)
    hi = torch.clamp(lo + 1, 0, n - 1)
    hi = torch.minimum(hi, torch.clamp(cnt.to(torch.int64) - 1, min=0))
    frac = pos - lo.to(values.dtype)
    v_lo = torch.gather(s, -1, lo)
    v_hi = torch.gather(s, -1, hi)
    out = v_lo + (v_hi - v_lo) * frac
    out = torch.where(cnt > 0, out, float("nan"))
    return out.movedim(-1, axis)
