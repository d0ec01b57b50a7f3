"""The reference ``operations.py`` surface over pandas panels (port of
``factormodeling_tpu/compat/operations.py``).

Every function keeps the reference's name, signature and semantics and
routes through the port's dense masked ops (:mod:`factormodeling_tpu_torch.ops`)
on a device: ``device=None`` is the card, ``device="cpu"`` asks for the CPU.
Inputs are (date, symbol)-MultiIndex Series; outputs realign to the input's
own index. On the card ``ts_decay``, ``ts_rank``, ``ts_std`` and
``ts_zscore`` take the window-streaming kernel, as the dense ops do.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from factormodeling_tpu_torch import ops as k
from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.compat._convert import PanelVocab, roundtrip

__all__ = [
    "ts_sum", "ts_mean", "ts_std", "ts_zscore", "ts_rank", "ts_diff",
    "ts_delay", "ts_decay", "ts_backfill",
    "cs_rank", "cs_winsor", "cs_filter_center", "cs_zscore", "cs_bool",
    "cs_mean",
    "sign", "power", "log", "abs_", "clip",
    "bucket", "group_mean", "group_neutralize", "group_normalize",
    "group_rank_normalized", "market_neutralize",
    "ts_regression_fast", "cs_regression",
]


def _put(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:      # a read-only view of a pandas buffer
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


# ---------------------------------------------------------------- time-series

def ts_sum(series: pd.Series, window: int, *, device=None) -> pd.Series:
    """Rolling per-symbol sum (``operations.py:6``)."""
    return roundtrip(series, lambda v, u: k.ts_sum(v, window, universe=u),
                     device=device)


def ts_mean(series: pd.Series, window: int, *, device=None) -> pd.Series:
    """Rolling per-symbol mean (``operations.py:10``)."""
    return roundtrip(series, lambda v, u: k.ts_mean(v, window, universe=u),
                     device=device)


def ts_std(series: pd.Series, window: int, *, device=None) -> pd.Series:
    """Rolling per-symbol std, ddof=1 (``operations.py:14``)."""
    return roundtrip(series, lambda v, u: k.ts_std(v, window, universe=u),
                     device=device)


def ts_zscore(series: pd.Series, window: int, *, device=None) -> pd.Series:
    """(x - rolling mean) / rolling std, zero-std -> NaN (``operations.py:18``)."""
    return roundtrip(series, lambda v, u: k.ts_zscore(v, window, universe=u),
                     device=device)


def ts_rank(series: pd.Series, window: int, *, device=None) -> pd.Series:
    """Trailing-window pct rank of the last value (``operations.py:23``)."""
    return roundtrip(series, lambda v, u: k.ts_rank(v, window, universe=u),
                     device=device)


def ts_diff(series: pd.Series, window: int, *, device=None) -> pd.Series:
    """x - x.shift(window) per symbol (``operations.py:34``)."""
    return roundtrip(series, lambda v, u: k.ts_diff(v, window, universe=u),
                     device=device)


def ts_delay(series: pd.Series, window: int, *, device=None) -> pd.Series:
    """x.shift(window) per symbol (``operations.py:37``)."""
    return roundtrip(series, lambda v, u: k.ts_delay(v, window, universe=u),
                     device=device)


def ts_decay(series: pd.Series, window: int, *, device=None) -> pd.Series:
    """Linear-decay weighted mean, weights 1..w (``operations.py:40``)."""
    return roundtrip(series, lambda v, u: k.ts_decay(v, window, universe=u),
                     device=device)


def ts_backfill(series: pd.Series, *, device=None) -> pd.Series:
    """Per-symbol forward fill (``operations.py:50``; the reference name is
    misleading — it is ffill, preserved as such)."""
    return roundtrip(series, lambda v, u: k.ts_backfill(v, universe=u),
                     device=device)


# ------------------------------------------------------------- cross-section

def cs_rank(series: pd.Series, method: str = "average", *,
            device=None) -> pd.Series:
    """Per-date [0, 1] rank, (r-1)/(n-1) with the reference's NaN-counting
    denominator (``operations.py:54``). ``method`` follows pandas ``rank``:
    average/min/max/first/dense — 'first' ties resolve by the series' own row
    order, like pandas, not by the dense layout's sorted-symbol order."""
    if method == "first":
        dev = resolve_device(device)
        vocab = PanelVocab.from_indexes(series.index)
        values, universe = vocab.densify(series)
        pos = vocab.densify_positions(series.index)
        out = k.cs_rank(_put(values, dev), universe=_put(universe, dev),
                        method="first", tie_order=_put(pos, dev))
        return vocab.align_like(out.cpu().numpy(), series.index,
                                name=series.name)
    return roundtrip(series, lambda v, u: k.cs_rank(v, universe=u,
                                                    method=method),
                     device=device)


def cs_winsor(series: pd.Series, limits=(0.01, 0.99), *,
              device=None) -> pd.Series:
    """Clip to the per-date quantile band; skipped below 5 valid names
    (``operations.py:64``)."""
    return roundtrip(series, lambda v, u: k.cs_winsor(v, limits, universe=u),
                     device=device)


def cs_filter_center(series: pd.Series, center=(0.3, 0.7), *,
                     device=None) -> pd.Series:
    """Zero out the middle quantile band, keep the tails (``operations.py:70``)."""
    return roundtrip(series,
                     lambda v, u: k.cs_filter_center(v, center, universe=u),
                     device=device)


def cs_zscore(series: pd.Series, *, device=None) -> pd.Series:
    """Per-date zscore, ddof=0 (``operations.py:77``)."""
    return roundtrip(series, lambda v, u: k.cs_zscore(v, universe=u),
                     device=device)


def cs_mean(series: pd.Series, *, device=None) -> pd.Series:
    """Per-date mean broadcast back to every name (``operations.py:85``)."""
    return roundtrip(series, lambda v, u: k.cs_mean(v, universe=u),
                     device=device)


def market_neutralize(series: pd.Series, *, device=None) -> pd.Series:
    """Per-date zscore ddof=0 with zero-sigma -> 0 (``operations.py:171``;
    despite the name it is a zscore, not a demean — preserved)."""
    return roundtrip(series, lambda v, u: k.market_neutralize(v, universe=u),
                     device=device)


# ---------------------------------------------------------------- elementwise
# Row-wise ops need no grid: the Series' own values go to the device as a
# flat float64 tensor and come back on the same index.

def _rowwise(series: pd.Series, fn, device) -> pd.Series:
    dev = resolve_device(device)
    vals = series.to_numpy(dtype=float, na_value=np.nan)
    return pd.Series(fn(_put(vals, dev)).cpu().numpy(), index=series.index,
                     name=series.name)


def cs_bool(condition: pd.Series, true_value: float, false_value: float, *,
            device=None) -> pd.Series:
    """np.where passthrough (``operations.py:80``)."""
    dev = resolve_device(device)
    cond = _put(np.asarray(condition, dtype=bool), dev)
    # numpy's types for the two values (a Python float is float64)
    tv, fv = (_put(np.asarray(v), dev) for v in (true_value, false_value))
    return pd.Series(k.cs_bool(cond, tv, fv).cpu().numpy(),
                     index=condition.index, name=condition.name)


def sign(series: pd.Series, *, device=None) -> pd.Series:
    """np.sign (``operations.py:88``)."""
    return _rowwise(series, k.sign, device)


def power(series: pd.Series, exp: float, *, device=None) -> pd.Series:
    """Elementwise power (``operations.py:91``)."""
    return _rowwise(series, lambda v: k.power(v, exp), device)


def log(series: pd.Series, *, device=None) -> pd.Series:
    """Elementwise natural log (``operations.py:94``)."""
    return _rowwise(series, k.log, device)


def abs_(series: pd.Series, *, device=None) -> pd.Series:
    """Elementwise absolute value (``operations.py:97``)."""
    return _rowwise(series, k.abs_, device)


def clip(series: pd.Series, lower, upper, *, device=None) -> pd.Series:
    """Elementwise clip (``operations.py:100``)."""
    return _rowwise(series, lambda v: k.clip(v, lower, upper), device)


# --------------------------------------------------------------------- groups

def bucket(series: pd.Series, bin_range=(0.2, 1.0, 0.2), *,
           device=None) -> pd.Series:
    """Fixed-bin labels "group{i}" per date (``operations.py:104``); values
    outside the bins (and NaN) -> NaN, like pd.cut."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(series.index)
    values, _ = vocab.densify(series)
    ids = k.bucket(_put(values, dev), bin_range).cpu().numpy()
    aligned = vocab.align_like(ids.astype(float), series.index)
    labels = aligned.map(lambda v: f"group{int(v) + 1}"
                         if np.isfinite(v) and v >= 0 else np.nan)
    labels.name = series.name
    return labels


def _group_op(series: pd.Series, group: pd.Series, kernel, device,
              need_positions: bool = False) -> pd.Series:
    """Shared densify path for per-(date, group) ops: NaN-labelled cells are
    dropped by pandas groupby -> NaN output, mirrored via a sentinel id.
    ``need_positions`` also passes the series' row-order positions (the
    pandas ``method='first'`` tie key) to the op."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(series.index, group.index)
    values, _ = vocab.densify(series)
    gids, n_groups = vocab.densify_labels(group)
    missing = gids < 0
    gids = np.where(missing, n_groups, gids)  # sentinel bucket, masked below
    args = (_put(values, dev), _put(gids, dev), n_groups + 1)
    if need_positions:
        args += (_put(vocab.densify_positions(series.index), dev),)
    out = kernel(*args).cpu().numpy().copy()
    out[missing] = np.nan
    return vocab.align_like(out, series.index, name=series.name)


def group_mean(series: pd.Series, group: pd.Series, *,
               device=None) -> pd.Series:
    """Per-(date, group) NaN-skipping mean (``operations.py:112``)."""
    return _group_op(series, group, k.group_mean, device)


def group_neutralize(series: pd.Series, group: pd.Series, *,
                     device=None) -> pd.Series:
    """x minus its per-(date, group) mean (``operations.py:124``)."""
    return _group_op(series, group, k.group_neutralize, device)


def group_normalize(series: pd.Series, group: pd.Series, *,
                    device=None) -> pd.Series:
    """Per-(date, group) zscore ddof=0, zero-sigma -> 0 (``operations.py:137``)."""
    return _group_op(series, group, k.group_normalize, device)


def group_rank_normalized(series: pd.Series, group: pd.Series,
                          method: str = "average", *,
                          device=None) -> pd.Series:
    """Per-(date, group) [0, 1] rank, <=1 valid -> 0.5 (``operations.py:152``);
    ``method`` follows pandas ``rank``: average/min/max/first/dense — 'first'
    ties resolve by the series' own row order, like pandas."""
    if method == "first":
        return _group_op(
            series, group,
            lambda v, g, n, pos: k.group_rank_normalized(
                v, g, n, method="first", tie_order=pos),
            device, need_positions=True)
    return _group_op(series, group,
                     lambda v, g, n: k.group_rank_normalized(v, g, n,
                                                             method=method),
                     device)


# ----------------------------------------------------------------- regression

def ts_regression_fast(y: pd.Series, x: pd.Series, window: int,
                       lag: int = 0, rettype: int = 2, *,
                       device=None) -> pd.Series:
    """Per-symbol rolling OLS y ~ x (``operations.py:185``); rettype 0=resid,
    1=alpha, 2=beta, 3=fitted, 6=R^2. The dense op lags x per symbol (the
    reference's positional long-frame shift can leak across symbols)."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(y.index, x.index)
    yv, yu = vocab.densify(y)
    xv, xu = vocab.densify(x)
    # the reference rolls over the joint-dropna'd rows (operations.py:200):
    # a present row whose y or x value is NaN leaves the window sequence
    # like an absent row, so the op's universe is the joint-validity mask
    valid = yu & xu & ~np.isnan(yv) & ~np.isnan(xv)
    out = k.ts_regression_fast(_put(yv, dev), _put(xv, dev), window, lag=lag,
                               rettype=rettype, universe=_put(valid, dev))
    return vocab.align_like(out.cpu().numpy(), y.index, name=y.name)


def cs_regression(y: pd.Series, x: pd.Series, rettype: str = "resid", *,
                  device=None) -> pd.Series:
    """Per-date OLS y ~ x (``operations.py:248``); rettype in
    {resid, beta, alpha, fitted, r2}; < 2 valid pairs -> NaN date."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(y.index, x.index)
    yv, _ = vocab.densify(y)
    xv, _ = vocab.densify(x)
    out = k.cs_regression(_put(yv, dev), _put(xv, dev), rettype=rettype)
    return vocab.align_like(out.cpu().numpy(), y.index, name=y.name)
