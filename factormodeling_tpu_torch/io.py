"""Data ingestion and the artifact store (port of
``factormodeling_tpu/io.py``).

- **Ingestion**: the reference notebook's three input schemas into dense
  panels on a device (``device=None`` is the card; ``"cpu"`` asks for the
  CPU):
  1. ``2.symbol_features_long.csv``: long ``date,symbol`` rows carrying
     ``log_return``, ``cap_flag``, ``investability_flag`` ->
     :class:`MarketData` (three aligned
     :class:`~factormodeling_tpu_torch.panel.Panel`);
  2. ``8.factors_df.csv``: long ``date,symbol`` rows + one column per
     factor -> :class:`~factormodeling_tpu_torch.panel.FactorPanel`;
  3. ``9.single_factor_returns.csv``: ``date`` rows + one column per factor
     -> :class:`FactorReturns` (dense ``[D, F]``).
  CSV and parquet are told apart by extension.
- **Artifact store**: :class:`ArtifactStore`, parquet persistence for the
  stage outputs the reference writes to ``data/`` (factor-weight frames,
  composite signal panels, result frames), with content-addressed stage
  caching (``cached``, keyed by :func:`fingerprint`).

Arrays go to the device once per load (one copy of the densified block);
labels stay on the host in the panels' vocabularies. pandas (and pyarrow,
for parquet) are needed here, so the package imports this module on first
use.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Callable, NamedTuple, Sequence

import numpy as np
import pandas as pd
import torch

from factormodeling_tpu_torch._device import host_array, resolve_device
from factormodeling_tpu_torch.panel import (FactorPanel, Panel, _densify_long,
                                            _np_dtype)

__all__ = [
    "ArtifactStore",
    "FactorReturns",
    "MarketData",
    "fingerprint",
    "load_factor_returns",
    "load_factors",
    "load_symbol_features",
    "read_table",
    "write_table",
]

_FEATURE_COLUMNS = ("log_return", "cap_flag", "investability_flag")


def read_table(path: str | Path, **kwargs) -> pd.DataFrame:
    """Read a CSV or parquet table by extension (``.parquet``/``.pq`` ->
    parquet, anything else -> CSV)."""
    path = Path(path)
    if path.suffix in (".parquet", ".pq"):
        return pd.read_parquet(path, **kwargs)
    return pd.read_csv(path, **kwargs)


def write_table(df: pd.DataFrame, path: str | Path) -> Path:
    """Write a table as parquet (``.parquet``/``.pq``) or CSV by extension,
    creating parent directories."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix in (".parquet", ".pq"):
        df.to_parquet(path)
    else:
        df.to_csv(path)
    return path


def _long_frame(df: pd.DataFrame, date_col: str,
                symbol_col: str) -> pd.DataFrame:
    """Normalize a long table: datetime dates, (date, symbol) MultiIndex."""
    if date_col in df.columns:
        df = df.assign(**{date_col: pd.to_datetime(df[date_col])})
        df = df.set_index([date_col, symbol_col])
    elif not isinstance(df.index, pd.MultiIndex):
        raise ValueError(
            f"expected columns ({date_col!r}, {symbol_col!r}) or a "
            f"(date, symbol) MultiIndex; got columns {list(df.columns)}")
    return df


@dataclasses.dataclass(frozen=True)
class MarketData:
    """The three market panels of ``2.symbol_features_long.csv`` on one
    grid."""

    returns: Panel
    cap_flag: Panel
    investability_flag: Panel

    @property
    def dates(self) -> np.ndarray:
        return self.returns.dates

    @property
    def symbols(self) -> np.ndarray:
        return self.returns.symbols


class FactorReturns(NamedTuple):
    """Dense per-date factor returns (``9.single_factor_returns.csv``)."""

    values: torch.Tensor      # float[D, F]
    dates: np.ndarray
    factor_names: tuple

    def to_frame(self) -> pd.DataFrame:
        return pd.DataFrame(host_array(self.values),
                            index=pd.Index(self.dates, name="date"),
                            columns=list(self.factor_names))


def load_symbol_features(path: str | Path, *, date_col: str = "date",
                         symbol_col: str = "symbol", dtype=torch.float32,
                         device=None) -> MarketData:
    """Load the symbol-features schema into three aligned panels; the rows
    need at least the ``log_return``, ``cap_flag`` and
    ``investability_flag`` columns."""
    dev = resolve_device(device)
    df = _long_frame(read_table(path), date_col, symbol_col)
    missing = [c for c in _FEATURE_COLUMNS if c not in df.columns]
    if missing:
        raise ValueError(f"{path}: missing feature columns {missing}")
    stacked, universe, dates, symbols = _densify_long(
        df, _FEATURE_COLUMNS, dtype)
    uni = torch.from_numpy(universe).to(dev)
    block = torch.from_numpy(stacked).to(dev)
    return MarketData(*(Panel(block[i], uni, dates, symbols)
                        for i in range(len(_FEATURE_COLUMNS))))


def load_factors(path: str | Path, *, date_col: str = "date",
                 symbol_col: str = "symbol", exclude: Sequence[str] = (),
                 dtype=torch.float32, device=None) -> FactorPanel:
    """Load the factor-exposure schema (``8.factors_df.csv``) into a
    :class:`FactorPanel`; every non-index column is a factor unless
    excluded."""
    df = _long_frame(read_table(path), date_col, symbol_col)
    return FactorPanel.from_frame(df, exclude=exclude, dtype=dtype,
                                  device=device)


def load_factor_returns(path: str | Path, *, date_col: str = "date",
                        dtype=torch.float32, device=None) -> FactorReturns:
    """Load the per-date factor-return schema
    (``9.single_factor_returns.csv``)."""
    dev = resolve_device(device)
    df = read_table(path)
    if date_col in df.columns:
        df = df.assign(**{date_col: pd.to_datetime(df[date_col])})
        df = df.set_index(date_col)
    df = df.sort_index()
    values = df.to_numpy(dtype=_np_dtype(dtype), na_value=np.nan)
    return FactorReturns(torch.tensor(values, device=dev),
                         df.index.to_numpy(), tuple(df.columns))


# --------------------------------------------------------------- artifacts


def fingerprint(*parts) -> str:
    """Content hash of arrays / tensors / scalars / strings: the cache key
    for :meth:`ArtifactStore.cached`. Arrays hash their shape, dtype and
    bytes (a tensor as its host numpy copy), so any input change
    invalidates the stage; equal to the JAX package's on the same numpy
    inputs."""
    h = hashlib.blake2b(digest_size=10)
    for p in parts:
        if isinstance(p, (Panel, FactorPanel)):
            parts2 = (p.values, p.universe)
        elif isinstance(p, FactorReturns):
            parts2 = (p.values,) + p.factor_names
        else:
            parts2 = (p,)
        for q in parts2:
            if hasattr(q, "shape"):
                arr = np.ascontiguousarray(host_array(q))
                h.update(str(arr.shape).encode())
                h.update(str(arr.dtype).encode())
                h.update(arr.tobytes())
            else:
                h.update(repr(q).encode())
        h.update(b"|")
    return h.hexdigest()


class ArtifactStore:
    """Parquet-backed persistence for pipeline stage outputs, in the
    reference's ``data/`` layout (``factor_weights/*``,
    ``composite_factors/*``), with three artifact shapes:

    - frames: any date-indexed DataFrame (factor weights, result frames);
    - panels: :class:`Panel` (composite signals) stored long;
    - factor panels: :class:`FactorPanel` stored long, one column a factor.

    Panels load onto ``device`` (``None`` is the card).
    """

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        return self.root / f"{name}.parquet"

    def exists(self, name: str) -> bool:
        return self.path(name).exists()

    # ---- frames (factor weights, result frames, metric tables)

    def save_frame(self, name: str, df: pd.DataFrame) -> Path:
        return write_table(df, self.path(name))

    def load_frame(self, name: str) -> pd.DataFrame:
        return pd.read_parquet(self.path(name))

    # ---- panels

    def save_panel(self, name: str, panel: Panel) -> Path:
        return write_table(panel.to_series(name="value").to_frame(),
                           self.path(name))

    def load_panel(self, name: str, dtype=torch.float32,
                   device=None) -> Panel:
        return Panel.from_series(self.load_frame(name)["value"], dtype=dtype,
                                 device=device)

    def save_factor_panel(self, name: str, fp: FactorPanel) -> Path:
        return write_table(fp.to_frame(), self.path(name))

    def load_factor_panel(self, name: str, dtype=torch.float32,
                          device=None) -> FactorPanel:
        return FactorPanel.from_frame(self.load_frame(name), dtype=dtype,
                                      device=device)

    # ---- stage caching

    def cached(self, stage: str, key: str,
               compute: Callable[[], pd.DataFrame]) -> pd.DataFrame:
        """Content-addressed stage cache: reload ``<stage>-<key>`` if it was
        persisted with the same input fingerprint, else compute and
        persist."""
        name = f"{stage}-{key}"
        if self.exists(name):
            return self.load_frame(name)
        df = compute()
        self.save_frame(name, df)
        return df
