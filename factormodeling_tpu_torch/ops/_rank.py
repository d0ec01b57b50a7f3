"""Masked ranking and quantile primitives (port of
``factormodeling_tpu/ops/_rank.py``).

pandas cross-sectional semantics: 1-based ranks over the non-NaN subset with
any pandas tie rule (average, min, max, first, dense), segment-scoped ranks
and linear-interpolation quantiles, all sort-based. ``torch.sort`` sends NaN
last in ascending order and its stable form keeps -0.0 and +0.0 in position
order, as the JAX package's sort does; the tie tests compare neighbours with
``!=``, so each NaN is its own run and -0.0 ties with +0.0. A multi-key sort
is a chain of stable single-key sorts from the least significant key up,
and order-dependent results go back to the original order by a scatter.
The JAX package's sharding hints at these sorts (``_assetspec.hint``
under ``ops/rank`` and ``ops/quantile``) have no counterpart here: the
port's sorts always see whole rows, which its asset-sharded step forms
once a stage before it calls them (``ops/_assetspec.py``: the blend's
percentiles under ``ops/quantile``, its rank transform under
``ops/rank``).
"""

from __future__ import annotations

import torch

__all__ = ["avg_rank", "masked_quantile", "rank_sorted", "segment_avg_rank",
           "sorted_avg_ranks"]

_TIE_METHODS = ("average", "min", "max", "first", "dense")


def _check_method(method: str) -> None:
    if method not in _TIE_METHODS:
        raise ValueError(f"rank method must be one of {_TIE_METHODS}, got {method!r}")


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


def _lexsort(keys):
    """Permutation (last axis) that sorts by ``keys`` lexicographically, the
    first key most significant; complete ties keep position order."""
    idx = None
    for key in reversed(keys):
        k = key if idx is None else torch.take_along_dim(key, idx, dim=-1)
        order = torch.sort(k, dim=-1, stable=True).indices
        idx = order if idx is None else torch.take_along_dim(idx, order, dim=-1)
    return idx


def _starts(s_key: torch.Tensor) -> torch.Tensor:
    """Run-start flags of a sorted last axis (NaN != NaN: each its own run)."""
    prev = torch.cat([s_key[..., :1], s_key[..., :-1]], dim=-1)
    start = s_key != prev
    start[..., 0] = True
    return start


def _unsort(sorted_vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(sorted_vals).scatter_(-1, idx, sorted_vals)


def segment_avg_rank(values: torch.Tensor, seg_ids: torch.Tensor, *,
                     axis: int = -1, method: str = "average",
                     tie_order: torch.Tensor | None = None):
    """1-based rank of each value among the valid values of its segment, plus
    the valid count of that segment. ``method`` follows pandas ``rank``;
    ``method='first'`` breaks ties by ``tie_order`` (int, broadcastable to
    ``values``, lower = earlier), by position along ``axis`` without one.

    ``seg_ids`` are int segment labels (< 0 = in no segment). NaN values
    and cells in no segment get rank NaN; a NaN cell that carries a segment
    id still reports its segment's count (``group_rank_normalized`` needs
    it); cells in no segment report 0. Sort by (segment, value[, tie]),
    run structure from cummax/cummin of run-start indices, scatter back."""
    _check_method(method)
    values = values.movedim(axis, -1)
    ar = torch.arange(values.shape[-1], device=values.device)
    seg = seg_ids.movedim(axis, -1).expand(values.shape).to(torch.int64)
    in_seg = seg >= 0
    valid = ~torch.isnan(values) & in_seg
    seg_key = torch.where(in_seg, seg, torch.iinfo(torch.int64).max)
    val_key = torch.where(valid, values, float("nan"))
    keys = [seg_key, val_key]
    if method == "first" and tie_order is not None:
        keys.append(tie_order.movedim(axis, -1).expand(values.shape)
                    .to(torch.int64))
    s_idx = _lexsort(keys)
    s_seg = torch.take_along_dim(seg_key, s_idx, dim=-1)
    s_val = torch.take_along_dim(val_key, s_idx, dim=-1)
    valid_sorted = ~torch.isnan(s_val)

    seg_start = _starts(s_seg)
    tie_start = seg_start | _starts(s_val)
    seg_first = _run_starts_to_first(seg_start, ar)
    tie_first = _run_starts_to_first(tie_start, ar)
    tie_last = _run_starts_to_last(tie_start, ar)

    # within a segment run the valid cells come first, so rank = offset + 1
    dtype = values.dtype
    if method == "average":
        ranks = 0.5 * ((tie_first - seg_first + 1)
                       + (tie_last - seg_first + 1)).to(dtype)
    elif method == "min":
        ranks = (tie_first - seg_first + 1).to(dtype)
    elif method == "max":
        ranks = (tie_last - seg_first + 1).to(dtype)
    elif method == "first":
        ranks = (ar - seg_first + 1).to(dtype)
    else:  # dense: index of this tie run among the segment's valid runs
        run_ind = (tie_start & valid_sorted).to(torch.int64)
        cs_runs = torch.cumsum(run_ind, dim=-1)
        base = torch.cummax(torch.where(seg_start, cs_runs - run_ind, -1),
                            dim=-1).values
        ranks = (cs_runs - base).to(dtype)
    ranks = torch.where(valid_sorted, ranks, float("nan"))

    # per-segment valid count broadcast to every member (NaN members too)
    vi = valid_sorted.to(torch.int64)
    csum = torch.cumsum(vi, dim=-1)
    base = torch.cummax(torch.where(seg_start, csum - vi, -1), dim=-1).values
    nxt_start = torch.cat([seg_start[..., 1:],
                           torch.ones_like(seg_start[..., :1])], dim=-1)
    total_at_last = torch.where(nxt_start, csum, torch.iinfo(torch.int64).max)
    total = torch.cummin(total_at_last.flip(-1), dim=-1).values.flip(-1)
    counts = (total - base).to(dtype)

    ranks = _unsort(ranks, s_idx)
    counts = torch.where(in_seg, _unsort(counts, s_idx), 0.0)
    return ranks.movedim(-1, axis), counts.movedim(-1, axis)


def sorted_avg_ranks(s_key: torch.Tensor, valid_sorted: torch.Tensor,
                     axis: int = -1) -> torch.Tensor:
    """Average-tie 1-based ranks of an ALREADY-SORTED key array (NaNs last,
    each NaN its own run); invalid cells get rank NaN. The plain version of
    the rank-IC post-sort stage."""
    s_key = s_key.movedim(axis, -1)
    valid_sorted = valid_sorted.movedim(axis, -1)
    n = s_key.shape[-1]
    ar = torch.arange(n, device=s_key.device)
    tie_start = _starts(s_key)
    tie_first = _run_starts_to_first(tie_start, ar)
    tie_last = _run_starts_to_last(tie_start, ar)
    ranks = 0.5 * (tie_first + tie_last).to(s_key.dtype) + 1.0
    return torch.where(valid_sorted, ranks, float("nan")).movedim(-1, axis)


def rank_sorted(values: torch.Tensor, *, axis: int = -1, carry=(),
                method: str = "average"):
    """1-based ranks **in sorted order** with a pandas tie ``method``, from
    one stable sort. Returns ``(ranks_sorted, valid_sorted, carried)``:
    ``ranks_sorted[i]`` is the rank of the i-th smallest value (NaN last),
    and ``carried`` holds each array of ``carry`` (broadcastable to
    ``values``) co-sorted into the same order."""
    _check_method(method)
    values = values.movedim(axis, -1)
    n = values.shape[-1]
    s_key, idx = torch.sort(values, dim=-1, stable=True)
    carried = tuple(torch.take_along_dim(
        c.movedim(axis, -1).expand(values.shape), idx, dim=-1).movedim(-1, axis)
        for c in carry)
    valid_sorted = ~torch.isnan(s_key)
    if method == "average":
        ranks = sorted_avg_ranks(s_key, valid_sorted)
    else:
        ar = torch.arange(n, device=values.device)
        tie_start = _starts(s_key)
        if method == "min":
            ranks = _run_starts_to_first(tie_start, ar).to(values.dtype) + 1.0
        elif method == "max":
            ranks = _run_starts_to_last(tie_start, ar).to(values.dtype) + 1.0
        elif method == "first":
            # stable sort + NaNs last: among valid cells, position IS the rank
            ranks = (ar + 1).to(values.dtype).expand(values.shape)
        else:  # dense
            ranks = torch.cumsum((tie_start & valid_sorted).to(torch.int64),
                                 dim=-1).to(values.dtype)
        ranks = torch.where(valid_sorted, ranks, float("nan"))
    return (ranks.movedim(-1, axis), valid_sorted.movedim(-1, axis), carried)


def avg_rank(values: torch.Tensor, *, axis: int = -1, method: str = "average",
             tie_order: torch.Tensor | None = None) -> torch.Tensor:
    """1-based rank among non-NaN values along ``axis`` (NaN -> NaN), i.e.
    pandas ``rank(method=...)``, average ties by default. For
    ``method='first'``, ``tie_order`` (int, broadcastable, lower = earlier)
    overrides the default position-along-axis tie resolution. One sort (two
    keys with a ``tie_order``), sorted-space ranks, a scatter back."""
    _check_method(method)
    values = values.movedim(axis, -1)
    if method == "first" and tie_order is not None:
        tie = tie_order.movedim(axis, -1).expand(values.shape).to(torch.int64)
        idx = _lexsort([values, tie])
        s_key = torch.take_along_dim(values, idx, dim=-1)
        pos = torch.arange(1, values.shape[-1] + 1, device=values.device)
        ranks_sorted = torch.where(torch.isnan(s_key), float("nan"),
                                   pos.to(values.dtype))
    else:
        ar = torch.arange(values.shape[-1], device=values.device)
        ranks_sorted, _, (idx,) = rank_sorted(values, carry=(ar,),
                                              method=method)
    return _unsort(ranks_sorted, idx).movedim(-1, axis)


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
