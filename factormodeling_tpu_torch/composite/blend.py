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

The weighted blend also takes lanes (one tenant or path each): a ``[C, D,
F]`` selection over shared ``[F, D, N]`` factors or ``[C, F, D, N]`` ones,
with ``[C, G]`` tilts. Its group sums add each group's members in order,
slot by slot, elementwise (no contraction over F or G that a batch's
shape could tile), so a lane is the bits of its unbatched call; lanes
past a memory budget run in chunks of lanes.
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


def _preprocess(vals: torch.Tensor, names) -> torch.Tensor:
    """Suffix preprocessing over a ``[F, D, N]`` stack with per-column
    percentiles (the static blend)."""
    codes = [suffix_code(nm) for nm in names]
    out = vals.clone()
    for sfx in SUFFIXES:
        idx = [i for i, c in enumerate(codes) if c == sfx]
        if not idx:
            continue
        qlo, qhi = _SUFFIX_QS[sfx]
        sub = vals[idx]                                      # [K, D, N]
        qs = masked_quantile(sub, [qlo, qhi])                # [K, D, 2]
        lo = qs[..., 0:1]
        hi = qs[..., 1:2]
        degenerate = torch.isnan(lo) | torch.isnan(hi) | (hi == lo)
        out[idx] = _apply_suffix(sub, sfx, lo, hi, degenerate)
    return out


def _pooled_bounds(vals: torch.Tensor, codes, active: torch.Tensor) -> dict:
    """The weighted blend's per-suffix percentiles, pooled over the day's
    active same-suffix columns: ``{suffix: (lo, hi, degenerate)}``, each
    ``[..., D, 1]``, from ``vals [..., F, D, N]`` and ``active [..., D,
    F]``."""
    d, n = vals.shape[-2:]
    out = {}
    for sfx in SUFFIXES:
        idx = [i for i, c in enumerate(codes) if c == sfx]
        if not idx:
            continue
        qlo, qhi = _SUFFIX_QS[sfx]
        sub = vals[..., idx, :, :]                           # [..., K, D, N]
        pool = sub.transpose(-3, -2).reshape(sub.shape[:-3]
                                             + (d, len(idx) * n))
        mask = active[..., idx].repeat_interleave(n, dim=-1)
        pool = torch.where(mask, pool, float("nan"))         # [..., D, K*N]
        qs = masked_quantile(pool, [qlo, qhi])               # [..., D, 2]
        lo, hi = qs[..., 0:1], qs[..., 1:2]
        out[sfx] = (lo, hi, torch.isnan(lo) | torch.isnan(hi) | (hi == lo))
    return out


def _group_proxies(adj: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """NaN-skipping mean over each prefix group's member factors:
    ``[F, D, N] -> [G, D, N]``."""
    valid = ~torch.isnan(adj)
    sums = torch.einsum("gf,fdn->gdn", onehot, torch.where(valid, adj, 0.0))
    cnts = torch.einsum("gf,fdn->gdn", onehot, valid.to(adj.dtype))
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
    adj = _preprocess(factors, names)
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


#: elements of one ``[lanes, F, D, N]`` intermediate the weighted blend
#: holds at once (0.5 GB in float32); a larger batch of lanes runs in
#: chunks of lanes, each lane's arithmetic the same in any chunk
_BLEND_CHUNK_ELEMS = 1 << 27


def _lane_slice(x, lanes: int, lo: int, hi: int, lane_ndim: int):
    """Lanes ``lo:hi`` of an argument that carries the lane axis (rank
    ``lane_ndim``), else the shared argument itself."""
    if x is None or np.ndim(x) < lane_ndim or np.shape(x)[0] != lanes:
        return x
    return x[lo:hi]


def _member_slots(members, device):
    """The groups' members as slots: slot ``m`` is ``(take [G], has [G])``,
    each group's ``m``-th member (its first where it has fewer) and whether
    it has one."""
    out = []
    for m in range(max(len(g) for g in members)):
        out.append((torch.as_tensor([g[min(m, len(g) - 1)] for g in members],
                                    device=device),
                    None if all(len(g) > m for g in members) else
                    torch.as_tensor([len(g) > m for g in members],
                                    device=device)))
    return out


def _group_sums(x, slots, axis: int, poison=None):
    """Each group's members of ``x`` summed in member order along
    ``axis`` (the factor axis becomes the group axis). The one-hot
    contraction over every factor turns another group's non-finite value
    into NaN (its zero coefficient times it): with ``poison`` (the
    non-finite flags of ``x``) a group takes NaN where a factor outside it
    holds one."""
    total = bad = None
    shape = [1] * x.ndim
    for take, has in slots:
        part = x.index_select(axis, take)
        if has is not None:
            shape[axis] = -1
            part = torch.where(has.reshape(shape), part, 0)
        total = part if total is None else total + part
        if poison is not None:
            b = poison.index_select(axis, take)
            if has is not None:
                b = torch.where(has.reshape(shape), b, 0)
            bad = b if bad is None else bad + b
    if poison is None:
        return total
    outside = poison.sum(axis, keepdim=True) > bad
    return torch.where(outside, float("nan"), total)


def composite_weighted(factors: torch.Tensor, names, selection: torch.Tensor,
                       method: str = "zscore",
                       universe: torch.Tensor | None = None,
                       group_tilt: torch.Tensor | None = None, *,
                       rank_rows=None) -> torch.Tensor:
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
    weight total positive), so untilted outputs are unchanged.

    Lanes (module docs): ``selection [C, D, F]``, ``factors`` shared or
    ``[C, F, D, N]``, ``universe`` shared or ``[C, D, N]``, ``group_tilt``
    ``[G]`` or ``[C, G]``; the composite is ``[C, D, N]``.

    ``rank_rows`` is the asset-sharded step's seam (``ops/_assetspec.py``:
    the pooled percentiles form rows under ``ops/quantile``, the rank
    transform under ``ops/rank``): ``rank_rows(proxies, universe,
    selection)`` returns the three on the rows the rank transform forms,
    and the blend finishes there."""
    if method not in ("zscore", "rank"):
        raise ValueError("method must be 'zscore' or 'rank'")
    f, d, n = factors.shape[-3:]
    if selection.ndim == 3:
        c = selection.shape[0]
        per = max(1, _BLEND_CHUNK_ELEMS // (f * d * n))
        if c > per:
            return torch.cat([composite_weighted(
                _lane_slice(factors, c, lo, lo + per, 4), names,
                selection[lo:lo + per], method=method,
                universe=_lane_slice(universe, c, lo, lo + per, 3),
                group_tilt=_lane_slice(group_tilt, c, lo, lo + per, 2),
                rank_rows=rank_rows)
                for lo in range(0, c, per)])
    gids, prefixes = prefix_group_ids(names)
    members = [np.flatnonzero(gids == j).tolist()
               for j in range(len(prefixes))]
    codes = [suffix_code(nm) for nm in names]
    dtype, dev = factors.dtype, factors.device
    slots = _member_slots(members, dev)
    if universe is not None:
        factors = torch.where(universe[..., None, :, :], factors,
                              float("nan"))

    active = selection > 0.0                                 # [..., D, F]
    member = active.to(dtype)

    # the suffix rules with the day's pooled percentiles, every factor
    lead = torch.broadcast_shapes(factors.shape[:-3], selection.shape[:-2])
    adj = torch.empty(lead + (f, d, n), dtype=dtype, device=dev)
    for sfx, (lo, hi, degenerate) in _pooled_bounds(factors, codes,
                                                    active).items():
        idx = [i for i, c in enumerate(codes) if c == sfx]
        adj[..., idx, :, :] = _apply_suffix(
            factors[..., idx, :, :], sfx, lo[..., None, :, :],
            hi[..., None, :, :], degenerate[..., None, :, :])
    raw = [i for i, c in enumerate(codes) if c is None]
    if raw:
        adj[..., raw, :, :] = factors[..., raw, :, :]
    valid = ~torch.isnan(adj)
    mw = member.mT[..., None]                                # [..., F, D, 1]
    # a masked cell is non-finite where it is +-Inf (NaN is filled)
    sums = _group_sums(torch.where(valid, adj, 0.0) * mw, slots, -3,
                       poison=torch.isinf(adj).to(torch.int32))
    cnts = _group_sums(valid.to(dtype) * mw, slots, -3)
    proxies = sums / torch.where(cnts > 0, cnts, float("nan"))  # [..., G, D, N]
    if rank_rows is not None:
        proxies, universe, selection = rank_rows(proxies, universe,
                                                 selection)
        active = selection > 0.0
        member = active.to(dtype)

    chosen = torch.where(active, selection, 0.0)
    gw = _group_sums(chosen, slots, -1,
                     poison=(~torch.isfinite(chosen)).to(torch.int32))
    if group_tilt is not None:
        gw = gw * torch.as_tensor(group_tilt, dtype=dtype, device=dev)[
            ..., None, :]
    g_active = _group_sums(member, slots, -1) > 0            # [..., D, G]
    total = gw.sum(-1, keepdim=True)
    n_active = g_active.sum(-1, keepdim=True).to(dtype)
    equal = torch.where(g_active, 1.0 / torch.where(n_active > 0, n_active,
                                                    float("nan")), 0.0)
    # tilted callers get no equal-weight fallback: a tilt-zeroed day stays
    # zeroed
    fallback = equal if group_tilt is None else torch.zeros_like(equal)
    gw = torch.where(total > 0, gw / torch.where(total > 0, total, 1.0),
                     fallback)
    uni = None if universe is None else universe[..., None, :, :]
    if method == "zscore":
        normed = _safe_zscore_rows(proxies, uni)
    else:
        normed = _rank_propagate(proxies, uni)
    ga = g_active.mT[..., None]                              # [..., G, D, 1]
    contrib = torch.where(ga, normed * gw.mT[..., None], 0.0)
    nan_hit = (ga & torch.isnan(normed)).any(-3)
    comp = torch.where(nan_hit, float("nan"), contrib.sum(-3))

    has_day = active.any(-1)                                 # [..., D]
    comp = torch.where(has_day[..., None], comp, float("nan"))
    comp = _demean_rows(comp, universe)
    comp = torch.where(torch.isnan(comp), 0.0, comp)
    if universe is not None:
        comp = torch.where(universe, comp, float("nan"))
    return comp
