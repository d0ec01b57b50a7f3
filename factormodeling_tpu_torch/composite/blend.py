"""Per-date weighted composite blend (port of
``factormodeling_tpu/composite/blend.py::composite_weighted``).

Factor names follow ``<prefix>_<suffix>``: the suffix (``_eq``, ``_flx``,
``_long``, ``_short``) picks a per-date preprocessing rule whose percentiles
POOL all same-suffix columns active that day; the prefix defines the proxy
group. Group proxies are NaN-skipping means of the day's active members,
blended by the day's renormalized group weights after a per-row z-score
(``"zscore"``) or scipy-style propagate-NaN ranks (``"rank"``); NaN in an
active proxy propagates and the final panel is zero-filled.
"""

from __future__ import annotations

import numpy as np
import torch

from factormodeling_tpu_torch.ops._rank import avg_rank, masked_quantile

__all__ = ["SUFFIXES", "composite_weighted", "prefix_group_ids"]

SUFFIXES = ("_eq", "_flx", "_long", "_short")
_SUFFIX_QS = {"_eq": (0.10, 0.90), "_flx": (0.02, 0.98),
              "_long": (0.02, 0.98), "_short": (0.02, 0.98)}


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


def _preprocess_pooled(vals: torch.Tensor, names, active: torch.Tensor) -> torch.Tensor:
    """Suffix preprocessing over a ``[F, D, N]`` stack with per-suffix
    percentiles pooled over the day's active columns (``active [D, F]``)."""
    f, d, n = vals.shape
    out = vals.clone()
    for sfx in SUFFIXES:
        idx = [i for i, nm in enumerate(names) if nm.endswith(sfx)]
        if not idx:
            continue
        qlo, qhi = _SUFFIX_QS[sfx]
        sub = vals[idx]                                      # [K, D, N]
        pool = sub.transpose(0, 1).reshape(d, len(idx) * n)  # [D, K*N]
        mask = active[:, idx].repeat_interleave(n, dim=1)
        pool = torch.where(mask, pool, float("nan"))
        qs = masked_quantile(pool, [qlo, qhi])               # [D, 2]
        lo = qs[:, 0][None, :, None]
        hi = qs[:, 1][None, :, None]
        degenerate = torch.isnan(lo) | torch.isnan(hi) | (hi == lo)
        out[idx] = _apply_suffix(sub, sfx, lo, hi, degenerate)
    return out


def _group_proxies(adj: torch.Tensor, onehot: torch.Tensor,
                   member_weight: torch.Tensor) -> torch.Tensor:
    """NaN-skipping mean over each prefix group's active member factors:
    ``[F, D, N] -> [G, D, N]``; ``member_weight [D, F]`` is 0/1."""
    valid = ~torch.isnan(adj)
    mw = member_weight.T[:, :, None]  # [F, D, 1]
    filled = torch.where(valid, adj, 0.0) * mw
    v = valid.to(adj.dtype) * mw
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


def composite_weighted(factors: torch.Tensor, names, selection: torch.Tensor,
                       method: str = "zscore",
                       universe: torch.Tensor | None = None) -> torch.Tensor:
    """Per-date weighted blend of ``factors [F, D, N]`` driven by the daily
    selection weights ``selection [D, F]`` (aligned with ``names``); rows
    with no active factor produce 0. Returns the zero-filled ``float[D, N]``
    composite (NaN outside the universe)."""
    if method not in ("zscore", "rank"):
        raise ValueError("method must be 'zscore' or 'rank'")
    gids, prefixes = prefix_group_ids(names)
    g = len(prefixes)
    dtype, dev = factors.dtype, factors.device
    if universe is not None:
        factors = torch.where(universe, factors, float("nan"))

    active = selection > 0.0  # [D, F]
    adj = _preprocess_pooled(factors, names, active)
    member = active.to(dtype)
    onehot = torch.as_tensor(np.arange(g)[:, None] == gids, dtype=dtype).to(dev)
    proxies = _group_proxies(adj, onehot, member)  # [G, D, N]

    gw = torch.einsum("gf,df->dg", onehot, torch.where(active, selection, 0.0))
    g_active = torch.einsum("gf,df->dg", onehot, member) > 0  # [D, G]
    total = gw.sum(-1, keepdim=True)
    n_active = g_active.sum(-1, keepdim=True).to(dtype)
    equal = torch.where(g_active, 1.0 / torch.where(n_active > 0, n_active,
                                                    float("nan")), 0.0)
    gw = torch.where(total > 0, gw / torch.where(total > 0, total, 1.0), equal)

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
