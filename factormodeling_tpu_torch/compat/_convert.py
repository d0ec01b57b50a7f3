"""Long-format pandas <-> dense panel conversion for the compat layer (port
of ``factormodeling_tpu/compat/_convert.py``).

The reference's data model is a (date, symbol)-MultiIndex Series; the dense
analog is ``values [D, N]`` with NaN holes plus a ``universe [D, N]`` mask.
A :class:`PanelVocab` pins one sorted (dates, symbols) vocabulary so every
panel of a call densifies onto the same grid and results realign to the
caller's own index. Values densify to float64, the reference's pandas
precision.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from factormodeling_tpu_torch._device import resolve_device

__all__ = ["PanelVocab", "level_values", "roundtrip"]


def level_values(index, name: str, position: int) -> pd.Index:
    """A MultiIndex level by name, falling back to position only when the
    positional level is unnamed, so a (symbol, date)-ordered index with
    named levels is never silently transposed. Flat indexes and
    named-but-mismatched levels raise with the (date, symbol) contract
    spelled out."""
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


class PanelVocab:
    """Shared sorted (dates, symbols) vocabulary for a set of long indexes."""

    def __init__(self, dates: pd.Index, symbols: pd.Index):
        self.dates = pd.Index(dates)
        self.symbols = pd.Index(symbols)

    @classmethod
    def from_indexes(cls, *indexes: pd.MultiIndex) -> "PanelVocab":
        """Vocabulary over the union of the given long indexes."""
        dates: pd.Index | None = None
        symbols: pd.Index | None = None
        for idx in indexes:
            d = pd.Index(level_values(idx, "date", 0).unique())
            s = pd.Index(level_values(idx, "symbol", 1).unique())
            dates = d if dates is None else dates.union(d)
            symbols = s if symbols is None else symbols.union(s)
        return cls(dates.sort_values(), symbols.sort_values())

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.dates), len(self.symbols)

    def codes(self, index: pd.MultiIndex) -> tuple[np.ndarray, np.ndarray]:
        """(date, symbol) integer codes of every row (-1 off the grid)."""
        return (self.dates.get_indexer(level_values(index, "date", 0)),
                self.symbols.get_indexer(level_values(index, "symbol", 1)))

    def densify(self, s: pd.Series) -> tuple[np.ndarray, np.ndarray]:
        """(values [D, N] float64 with NaN holes, universe [D, N] bool)."""
        values = np.full(self.shape, np.nan)
        universe = np.zeros(self.shape, dtype=bool)
        di, si = self.codes(s.index)
        keep = (di >= 0) & (si >= 0)
        values[di[keep], si[keep]] = pd.to_numeric(s, errors="coerce").to_numpy(
            dtype=float, na_value=np.nan)[keep]
        universe[di[keep], si[keep]] = True
        return values, universe

    def align_like(self, arr, index: pd.MultiIndex, name=None) -> pd.Series:
        """Dense array -> Series on the caller's own index (row order kept)."""
        arr = np.asarray(arr)
        di, si = self.codes(index)
        out = np.full(len(index), np.nan, dtype=arr.dtype)
        keep = (di >= 0) & (si >= 0)
        out[keep] = arr[di[keep], si[keep]]
        return pd.Series(out, index=index, name=name)


def roundtrip(series: pd.Series, fn, name=None, *, device=None) -> pd.Series:
    """Densify -> ``fn(values, universe)`` -> realign, the unary-op wrapper:
    ``fn`` gets float64 and bool ``[D, N]`` tensors on ``device`` (``None``
    is the card) and returns a dense ``[D, N]`` tensor."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(series.index)
    values, universe = vocab.densify(series)
    out = fn(torch.from_numpy(values).to(dev), torch.from_numpy(universe).to(dev))
    return vocab.align_like(out.cpu().numpy(), series.index,
                            name=name if name is not None else series.name)
