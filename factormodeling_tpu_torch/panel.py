"""Dense panel data model (port of ``factormodeling_tpu/panel.py``).

The reference's data model is a long pandas object indexed by
``(date, symbol)``; its dense form is a tensor pair:

- ``values: float[D, N]`` (``float[F, D, N]`` for factor stacks) with NaN
  marking missing observations, and
- ``universe: bool[D, N]``, True where the (date, symbol) cell exists in the
  long index at all (NaN-valued cells included).

Dates, symbols and factor names stay on the host as numpy vocabularies.
``Panel`` and ``FactorPanel`` are frozen dataclasses of tensors on one
device, which their constructors take (``device=None`` is the card); the
JAX package's pytree registration has no counterpart here. pandas is
imported only by the functions that take or return pandas objects, so this
module imports without it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from factormodeling_tpu_torch._device import host_array, resolve_device
from factormodeling_tpu_torch.threefry import numpy_dtype

__all__ = ["Panel", "FactorPanel", "from_long", "panel_to_long"]


def _as_np_vocab(x) -> np.ndarray:
    arr = np.asarray(x)
    if arr.ndim != 1:
        raise ValueError(f"vocabulary must be 1-D, got shape {arr.shape}")
    return arr


def _index_level(index, name: str, position: int):
    """A MultiIndex level by name, falling back to position only when the
    positional level is unnamed, so a (symbol, date)-ordered index with
    named levels is never silently transposed. Flat indexes and
    named-but-mismatched levels raise with the (date, symbol) contract
    spelled out. Shared by the compat layer (``compat/_convert.level_values``)."""
    import pandas as pd

    if not isinstance(index, pd.MultiIndex):
        raise TypeError(
            f"expected a (date, symbol)-MultiIndexed pandas object (the "
            f"reference's data model); got a flat {type(index).__name__}")
    if name in index.names:
        return index.get_level_values(name)
    if position >= index.nlevels or index.names[position] is not None:
        raise KeyError(
            f"MultiIndex level {name!r} not found (levels: "
            f"{list(index.names)}); levels resolve by the reference's names "
            f"('date', 'symbol'), with a positional fallback only for "
            f"unnamed levels")
    return index.get_level_values(position)


def _densify_long(df, columns, dtype: torch.dtype):
    """One pass over a (date, symbol)-indexed long frame -> stacked
    ``[C, D, N]`` numpy values of ``dtype`` + shared universe + vocabularies:
    the one pandas -> dense path behind ``Panel.from_series``,
    ``FactorPanel.from_frame`` and the :mod:`factormodeling_tpu_torch.io`
    loaders."""
    import pandas as pd

    dates, date_idx = np.unique(
        _index_level(df.index, "date", 0).to_numpy(), return_inverse=True)
    symbols, sym_idx = np.unique(
        _index_level(df.index, "symbol", 1).to_numpy(), return_inverse=True)
    d, n = len(dates), len(symbols)
    universe = np.zeros((d, n), dtype=bool)
    universe[date_idx, sym_idx] = True
    np_dtype = numpy_dtype(dtype)
    stacked = np.full((len(columns), d, n), np.nan, dtype=np_dtype)
    for i, col in enumerate(columns):
        stacked[i, date_idx, sym_idx] = pd.to_numeric(
            df[col], errors="coerce").to_numpy(dtype=np_dtype,
                                                na_value=np.nan)
    return stacked, universe, dates, symbols


def _long_index(dates, symbols, universe):
    """(date, symbol) MultiIndex of the universe cells, and their codes."""
    import pandas as pd

    di, si = np.nonzero(host_array(universe))
    idx = pd.MultiIndex.from_arrays([np.asarray(dates)[di],
                                     np.asarray(symbols)[si]],
                                    names=["date", "symbol"])
    return idx, di, si


@dataclasses.dataclass(frozen=True)
class Panel:
    """A dense (dates x assets) panel of one variable.

    ``values[d, n]`` is the observation for ``dates[d]``, ``symbols[n]``; NaN
    means missing. ``universe[d, n]`` is True where the (date, symbol) pair
    exists in the originating long index (NaN-valued cells included).
    """

    values: torch.Tensor    # float[D, N]
    universe: torch.Tensor  # bool[D, N]
    dates: np.ndarray
    symbols: np.ndarray

    def __post_init__(self):
        if self.values.ndim != 2:
            raise ValueError(f"Panel.values must be [D, N], got "
                             f"{tuple(self.values.shape)}")

    @property
    def n_dates(self) -> int:
        return self.values.shape[0]

    @property
    def n_symbols(self) -> int:
        return self.values.shape[1]

    @property
    def shape(self):
        return tuple(self.values.shape)

    def with_values(self, values: torch.Tensor) -> "Panel":
        return dataclasses.replace(self, values=values)

    @staticmethod
    def dense(values, dates=None, symbols=None, universe=None, *,
              device=None) -> "Panel":
        """A Panel from a raw array on ``device`` (``None`` is the card),
        defaulting to a full universe."""
        dev = resolve_device(device)
        values = torch.as_tensor(values).to(dev)
        d, n = values.shape
        dates = np.arange(d) if dates is None else dates
        symbols = np.arange(n) if symbols is None else symbols
        universe = (torch.ones((d, n), dtype=torch.bool, device=dev)
                    if universe is None
                    else torch.as_tensor(universe).to(dev, torch.bool))
        return Panel(values, universe, _as_np_vocab(dates),
                     _as_np_vocab(symbols))

    @staticmethod
    def from_series(series, *, dtype=torch.float32, device=None) -> "Panel":
        """A (date, symbol)-MultiIndex pandas Series -> dense Panel on
        ``device``. Levels resolve by name when named, by position
        otherwise."""
        dev = resolve_device(device)
        stacked, universe, dates, symbols = _densify_long(
            series.to_frame("value"), ("value",), dtype)
        return Panel(torch.from_numpy(stacked[0]).to(dev),
                     torch.from_numpy(universe).to(dev), dates, symbols)

    def to_series(self, name=None):
        """Inverse of :meth:`from_series`: long Series over universe cells."""
        import pandas as pd

        idx, di, si = _long_index(self.dates, self.symbols, self.universe)
        return pd.Series(host_array(self.values)[di, si], index=idx,
                         name=name)


@dataclasses.dataclass(frozen=True)
class FactorPanel:
    """A dense stack of factor panels: ``values[F, D, N]`` + shared universe."""

    values: torch.Tensor    # float[F, D, N]
    universe: torch.Tensor  # bool[D, N]
    dates: np.ndarray
    symbols: np.ndarray
    factor_names: tuple

    def __post_init__(self):
        if self.values.ndim != 3:
            raise ValueError(f"FactorPanel.values must be [F, D, N], got "
                             f"{tuple(self.values.shape)}")

    @property
    def n_factors(self) -> int:
        return self.values.shape[0]

    def factor(self, name: str) -> Panel:
        idx = self.factor_names.index(name)
        return Panel(self.values[idx], self.universe, self.dates,
                     self.symbols)

    def select(self, names: Sequence[str]) -> "FactorPanel":
        idx = torch.as_tensor([self.factor_names.index(n) for n in names],
                              device=self.values.device)
        return dataclasses.replace(self, values=self.values[idx],
                                   factor_names=tuple(names))

    @staticmethod
    def dense(values, dates=None, symbols=None, factor_names=None,
              universe=None, *, device=None) -> "FactorPanel":
        dev = resolve_device(device)
        values = torch.as_tensor(values).to(dev)
        f, d, n = values.shape
        dates = np.arange(d) if dates is None else dates
        symbols = np.arange(n) if symbols is None else symbols
        if factor_names is None:
            factor_names = tuple(f"f{i}" for i in range(f))
        universe = (torch.ones((d, n), dtype=torch.bool, device=dev)
                    if universe is None
                    else torch.as_tensor(universe).to(dev, torch.bool))
        return FactorPanel(values, universe, _as_np_vocab(dates),
                           _as_np_vocab(symbols), tuple(factor_names))

    @staticmethod
    def from_frame(df, *, exclude=(), dtype=torch.float32,
                   device=None) -> "FactorPanel":
        """A (date, symbol)-MultiIndex pandas DataFrame (one column per
        factor) -> dense FactorPanel on ``device``."""
        dev = resolve_device(device)
        names = tuple(c for c in df.columns if c not in exclude)
        stacked, universe, dates, symbols = _densify_long(df, names, dtype)
        return FactorPanel(torch.from_numpy(stacked).to(dev),
                           torch.from_numpy(universe).to(dev), dates,
                           symbols, names)

    def to_frame(self):
        """Inverse of :meth:`from_frame`: long DataFrame over universe cells."""
        import pandas as pd

        idx, di, si = _long_index(self.dates, self.symbols, self.universe)
        values = host_array(self.values)
        return pd.DataFrame({name: values[i, di, si]
                             for i, name in enumerate(self.factor_names)},
                            index=idx)


def from_long(dates_idx, symbols_idx, values, *, n_dates=None,
              n_symbols=None, dates=None, symbols=None, dtype=torch.float32,
              device=None) -> Panel:
    """Densify a long-format (date_idx, symbol_idx) -> value triple into a
    Panel on ``device``.

    ``dates_idx`` / ``symbols_idx`` are integer codes (e.g. pandas
    categorical codes). Cells never referenced are NaN with
    ``universe=False``; referenced cells get ``universe=True`` even when the
    value is NaN.
    """
    dev = resolve_device(device)
    dates_idx = np.asarray(dates_idx)
    symbols_idx = np.asarray(symbols_idx)
    if dates_idx.size and (dates_idx.min() < 0 or symbols_idx.min() < 0):
        raise ValueError(
            "negative index codes (e.g. pandas Categorical codes for NaN keys) "
            "would silently wrap; drop NaN-keyed rows before densifying")
    vals = np.asarray(values, dtype=numpy_dtype(dtype))
    d = int(n_dates if n_dates is not None else dates_idx.max() + 1)
    n = int(n_symbols if n_symbols is not None else symbols_idx.max() + 1)
    dense = np.full((d, n), np.nan, dtype=vals.dtype)
    universe = np.zeros((d, n), dtype=bool)
    dense[dates_idx, symbols_idx] = vals
    universe[dates_idx, symbols_idx] = True
    dates = np.arange(d) if dates is None else dates
    symbols = np.arange(n) if symbols is None else symbols
    return Panel(torch.from_numpy(dense).to(dev),
                 torch.from_numpy(universe).to(dev), _as_np_vocab(dates),
                 _as_np_vocab(symbols))


def panel_to_long(panel: Panel):
    """Host-side inverse of :func:`from_long`: (date_idx, symbol_idx, values)."""
    didx, sidx = np.nonzero(host_array(panel.universe))
    return didx, sidx, host_array(panel.values)[didx, sidx]
