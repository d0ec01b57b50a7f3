"""Composite blends (port of ``factormodeling_tpu/composite/blend.py``):
the static equal blend and the per-date weighted blend.

Factor names follow ``<prefix>_<suffix>``: the suffix (``_eq``, ``_flx``,
``_long``, ``_short``) picks a per-date preprocessing rule, whose
percentiles the static blend takes PER COLUMN and the weighted blend POOLS
over all same-suffix columns active that day; the prefix defines the proxy
group. Group proxies are NaN-skipping means of their (active) members. The
static blend averages the proxies' per-row z-scores (``"zscore"``) or sums
their scipy-style propagate-NaN ranks (``"rank"``), NaN preserved; the
weighted blend weighs them by the day's renormalized group weights, NaN in
an active proxy propagates and the final panel is zero-filled.
"""

from __future__ import annotations

import numpy as np
import torch

from factormodeling_tpu_torch.ops._rank import avg_rank, masked_quantile

__all__ = ["SUFFIXES", "composite_static", "composite_weighted",
           "prefix_group_ids", "suffix_code"]

SUFFIXES = ("_eq", "_flx", "_long", "_short")
_SUFFIX_QS = {"_eq": (0.10, 0.90), "_flx": (0.02, 0.98),
              "_long": (0.02, 0.98), "_short": (0.02, 0.98)}


def suffix_code(name: str) -> str | None:
    """The preprocessing suffix a factor name ends with (None: no rule)."""
    for s in SUFFIXES:
        if name.endswith(s):
            return s
    return None


def prefix_group_ids(names) -> tuple[np.ndarray, list[str]]:
    """Group id per factor by the prefix before the first underscore;
    returns (gid[F], group prefixes)."""
    prefixes: list[str] = []
    gids = []
    for n in names:
        p = n.split("_", 1)[0]
        if p not in prefixes:
            prefixes.append(p)
        gids.append(prefixes.index(p))
    return np.asarray(gids, dtype=np.int64), prefixes


def _apply_suffix(vals, sfx: str, lo, hi, degenerate):
    """One suffix rule on ``vals[..., N]`` given per-row lo/hi/degenerate."""
    if sfx == "_eq":
        out = torch.where(vals <= lo, -1.0, torch.where(vals >= hi, 1.0, 0.0)).to(vals.dtype)
    else:
        span = hi - lo
        clipped = torch.minimum(torch.maximum(vals, lo), hi)
        if sfx == "_flx":
            out = (clipped - lo) / span * 2.0 - 1.0
        elif sfx == "_long":
            out = (clipped - lo) / span
        else:  # _short
            out = (clipped - hi) / span
    return torch.where(degenerate, 0.0, out)


def _preprocess(vals: torch.Tensor, names, *, pooled: bool,
                active: torch.Tensor | None = None) -> torch.Tensor:
    """Suffix preprocessing over a ``[F, D, N]`` stack: per-column
    percentiles (``pooled=False``, the static blend) or per-suffix
    percentiles pooled over the day's active columns (``pooled=True``, the
    weighted blend; ``active [D, F]``)."""
    f, d, n = vals.shape
    codes = [suffix_code(nm) for nm in names]
    out = vals.clone()
    for sfx in SUFFIXES:
        idx = [i for i, c in enumerate(codes) if c == sfx]
        if not idx:
            continue
        qlo, qhi = _SUFFIX_QS[sfx]
        sub = vals[idx]                                      # [K, D, N]
        if pooled:
            pool = sub.transpose(0, 1).reshape(d, len(idx) * n)  # [D, K*N]
            if active is not None:
                mask = active[:, idx].repeat_interleave(n, dim=1)
                pool = torch.where(mask, pool, float("nan"))
            qs = masked_quantile(pool, [qlo, qhi])           # [D, 2]
            lo = qs[:, 0][None, :, None]
            hi = qs[:, 1][None, :, None]
        else:
            qs = masked_quantile(sub, [qlo, qhi])            # [K, D, 2]
            lo = qs[..., 0:1]
            hi = qs[..., 1:2]
        degenerate = torch.isnan(lo) | torch.isnan(hi) | (hi == lo)
        out[idx] = _apply_suffix(sub, sfx, lo, hi, degenerate)
    return out


def _group_proxies(adj: torch.Tensor, onehot: torch.Tensor,
                   member_weight: torch.Tensor | None = None) -> torch.Tensor:
    """NaN-skipping mean over each prefix group's member factors:
    ``[F, D, N] -> [G, D, N]``; ``member_weight [D, F]`` (0/1) restricts it
    to the day's active factors."""
    valid = ~torch.isnan(adj)
    filled = torch.where(valid, adj, 0.0)
    v = valid.to(adj.dtype)
    if member_weight is not None:
        mw = member_weight.T[:, :, None]  # [F, D, 1]
        filled = filled * mw
        v = v * mw
    sums = torch.einsum("gf,fdn->gdn", onehot, filled)
    cnts = torch.einsum("gf,fdn->gdn", onehot, v)
    return sums / torch.where(cnts > 0, cnts, float("nan"))


def _safe_zscore_rows(x: torch.Tensor, universe) -> torch.Tensor:
    """Per-row zscore ddof=0 over valid cells; sigma 0/undefined -> row 0."""
    if universe is not None:
        x = torch.where(universe, x, float("nan"))
    valid = ~torch.isnan(x)
    cnt = valid.sum(-1, keepdim=True).to(x.dtype)
    cs = torch.where(cnt > 0, cnt, float("nan"))
    mu = torch.where(valid, x, 0.0).sum(-1, keepdim=True) / cs
    dev = torch.where(valid, x - mu, 0.0)
    sd = torch.sqrt((dev * dev).sum(-1, keepdim=True) / cs)
    degenerate = (sd == 0.0) | torch.isnan(sd)
    return torch.where(degenerate, 0.0, (x - mu) / sd)


def _rank_propagate(x: torch.Tensor, universe) -> torch.Tensor:
    """``(rankdata(x) - 1) / (len(x) - 1)`` with scipy's propagate-NaN rule:
    one NaN makes the whole row's ranks NaN; ``len`` counts the universe."""
    if universe is not None:
        x = torch.where(universe, x, float("nan"))
        uni = universe.expand(x.shape)
        cnt = uni.sum(-1, keepdim=True).to(x.dtype)
        isn = torch.isnan(x) & uni
    else:
        cnt = torch.full(x.shape[:-1] + (1,), x.shape[-1], dtype=x.dtype,
                         device=x.device)
        isn = torch.isnan(x)
    out = (avg_rank(x, axis=-1) - 1.0) / (cnt - 1.0)
    return torch.where(isn.any(-1, keepdim=True), float("nan"), out)


def _demean_rows(x: torch.Tensor, universe) -> torch.Tensor:
    if universe is not None:
        x = torch.where(universe, x, float("nan"))
    valid = ~torch.isnan(x)
    cnt = valid.sum(-1, keepdim=True).to(x.dtype)
    mu = (torch.where(valid, x, 0.0).sum(-1, keepdim=True)
          / torch.where(cnt > 0, cnt, float("nan")))
    return x - mu


def _onehot(gids: np.ndarray, n_groups: int, dtype, dev) -> torch.Tensor:
    """``[G, F]`` group membership of the factors."""
    return torch.as_tensor(np.arange(n_groups)[:, None] == gids,
                           dtype=dtype).to(dev)


def composite_static(factors: torch.Tensor, names, method: str = "zscore",
                     universe: torch.Tensor | None = None) -> torch.Tensor:
    """Static equal blend of ``factors [F, D, N]``: the demeaned composite
    ``float[D, N]``, NaN preserved (outside the universe too)."""
    if method not in ("zscore", "rank"):
        raise ValueError("method must be 'zscore' or 'rank'")
    gids, prefixes = prefix_group_ids(names)
    if universe is not None:
        factors = torch.where(universe, factors, float("nan"))
    adj = _preprocess(factors, names, pooled=False)
    proxies = _group_proxies(adj, _onehot(gids, len(prefixes), factors.dtype,
                                          factors.device))  # [G, D, N]
    if method == "zscore":
        normed = _safe_zscore_rows(proxies, universe)
        valid = ~torch.isnan(normed)
        cnt = valid.sum(0).to(factors.dtype)
        comp = (torch.where(valid, normed, 0.0).sum(0)
                / torch.where(cnt > 0, cnt, float("nan")))
    else:
        ranks = _rank_propagate(proxies, universe)
        # pandas' skipna sum: NaN rank rows contribute nothing
        comp = torch.where(torch.isnan(ranks), 0.0, ranks).sum(0)
    comp = _demean_rows(comp, universe)
    if universe is not None:
        comp = torch.where(universe, comp, float("nan"))
    return comp


def composite_weighted(factors: torch.Tensor, names, selection: torch.Tensor,
                       method: str = "zscore",
                       universe: torch.Tensor | None = None,
                       group_tilt: torch.Tensor | None = None) -> torch.Tensor:
    """Per-date weighted blend of ``factors [F, D, N]`` driven by the daily
    selection weights ``selection [D, F]`` (aligned with ``names``); rows
    with no active factor produce 0. Returns the zero-filled ``float[D, N]``
    composite (NaN outside the universe).

    ``group_tilt`` (``[G]``, nonnegative, in :func:`prefix_group_ids`
    order) rescales the day's raw per-group blend weights before their
    renormalization: a caller's preference over the prefix families (every
    entry 1 is the untilted blend). A tilt that zeroes every active group
    on a day zeroes that day's composite: under a tilt the equal-weight
    fallback is suppressed, since restoring weight to a group the caller
    excluded would invert the preference on exactly the days it binds.
    Without a tilt the fallback is unreachable (any active factor makes the
    weight total positive), so untilted outputs are unchanged."""
    if method not in ("zscore", "rank"):
        raise ValueError("method must be 'zscore' or 'rank'")
    gids, prefixes = prefix_group_ids(names)
    g = len(prefixes)
    dtype, dev = factors.dtype, factors.device
    if universe is not None:
        factors = torch.where(universe, factors, float("nan"))

    active = selection > 0.0  # [D, F]
    adj = _preprocess(factors, names, pooled=True, active=active)
    member = active.to(dtype)
    onehot = _onehot(gids, g, dtype, dev)
    proxies = _group_proxies(adj, onehot, member)  # [G, D, N]

    gw = torch.einsum("gf,df->dg", onehot, torch.where(active, selection, 0.0))
    if group_tilt is not None:
        gw = gw * torch.as_tensor(group_tilt, dtype=dtype, device=dev)[None, :]
    g_active = torch.einsum("gf,df->dg", onehot, member) > 0  # [D, G]
    total = gw.sum(-1, keepdim=True)
    n_active = g_active.sum(-1, keepdim=True).to(dtype)
    equal = torch.where(g_active, 1.0 / torch.where(n_active > 0, n_active,
                                                    float("nan")), 0.0)
    # tilted callers get no equal-weight fallback: a tilt-zeroed day stays
    # zeroed
    fallback = equal if group_tilt is None else torch.zeros_like(equal)
    gw = torch.where(total > 0, gw / torch.where(total > 0, total, 1.0),
                     fallback)

    if method == "zscore":
        normed = _safe_zscore_rows(proxies, universe)
    else:
        normed = _rank_propagate(proxies, universe)
    ga = g_active.T[:, :, None]
    contrib = torch.where(ga, normed * gw.T[:, :, None], 0.0)
    nan_hit = (ga & torch.isnan(normed)).any(0)
    comp = torch.where(nan_hit, float("nan"), contrib.sum(0))

    has_day = active.any(-1)  # [D]
    comp = torch.where(has_day[:, None], comp, float("nan"))
    comp = _demean_rows(comp, universe)
    comp = torch.where(torch.isnan(comp), 0.0, comp)
    if universe is not None:
        comp = torch.where(universe, comp, float("nan"))
    return comp
