"""Long-format pandas <-> dense panel conversion for the compat layer (port
of ``factormodeling_tpu/compat/_convert.py``).

The reference's data model is a (date, symbol)-MultiIndex Series; the dense
analog is ``values [D, N]`` with NaN holes plus a ``universe [D, N]`` mask.
A :class:`PanelVocab` pins one sorted (dates, symbols) vocabulary so every
panel of a call densifies onto the same grid and results realign to the
caller's own index. Values densify at JAX's float width: float64 where
``torch.get_default_dtype()`` is float64 (the counterpart of the JAX
package's ``jax_enable_x64``, under which the test suite's pandas oracles
compare), float32 where it is float32, the production width the JAX
package densifies to with x64 off. Vocabularies and row codes are cached
on the identity of the pandas indexes (:class:`_IdentityCache`), as the
JAX package caches them.
The JAX package's ``jit_kernel`` (one compiled trace per compat call site)
has no counterpart: PyTorch runs the ops eagerly.
"""

from __future__ import annotations

import weakref

import numpy as np
import pandas as pd
import torch

from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.panel import _index_level
from factormodeling_tpu_torch.threefry import numpy_dtype

__all__ = ["PanelVocab", "densify_stack", "level_values", "roundtrip"]


class _IdentityCache:
    """Cache keyed on the identity of (tuples of) objects, pandas indexes
    first among them.

    pandas indexes are immutable and unhashable, and chained compat calls
    pass the same index objects all the way down (``align_like`` returns
    results on the caller's own index), so identity is both safe and the
    reuse pattern. Entries hold weakrefs and evict themselves when any
    keyed object is collected, so the cache neither pins panels alive nor
    serves a recycled ``id()``. ``maxsize`` bounds the entry count
    first-in-first-out, so value caches (device panels, masked signals)
    cannot pin unbounded memory across many distinct inputs.

    Callers caching data derived from a Series (not just its index) put
    ``series._values`` in the key: under pandas copy-on-write every
    in-place write swaps the backing array, so its identity is the
    mutation token.
    """

    def __init__(self, maxsize: int = 256):
        self._store: dict = {}
        self._maxsize = maxsize

    def get(self, keys: tuple, build):
        key = tuple(id(ix) for ix in keys)
        hit = self._store.get(key)
        if hit is not None:
            refs, value = hit
            if all(r() is ix for r, ix in zip(refs, keys)):
                return value
        value = build()

        def _evict(_, key=key):
            self._store.pop(key, None)

        while len(self._store) >= self._maxsize:
            self._store.pop(next(iter(self._store)))
        self._store[key] = (tuple(weakref.ref(ix, _evict) for ix in keys),
                            value)
        return value


_VOCAB_CACHE = _IdentityCache()


def level_values(index, name: str, position: int) -> pd.Index:
    """A MultiIndex level by name, falling back to position only when the
    positional level is unnamed (``panel._index_level``)."""
    return _index_level(index, name, position)


class PanelVocab:
    """Shared sorted (dates, symbols) vocabulary for a set of long indexes."""

    def __init__(self, dates: pd.Index, symbols: pd.Index):
        self.dates = pd.Index(dates)
        self.symbols = pd.Index(symbols)
        self._codes_cache = _IdentityCache()

    @classmethod
    def from_indexes(cls, *indexes: pd.MultiIndex) -> "PanelVocab":
        """Vocabulary over the union of the given long indexes, cached on
        the indexes' identity."""
        return _VOCAB_CACHE.get(indexes, lambda: cls._build(indexes))

    @classmethod
    def _build(cls, indexes) -> "PanelVocab":
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
        """(date, symbol) integer codes of every row (-1 off the grid),
        cached on the index's identity."""
        return self._codes_cache.get((index,), lambda: (
            self.dates.get_indexer(level_values(index, "date", 0)),
            self.symbols.get_indexer(level_values(index, "symbol", 1))))

    def densify(self, s: pd.Series) -> tuple[np.ndarray, np.ndarray]:
        """(values [D, N] at JAX's float width with NaN holes, universe
        [D, N] bool)."""
        values = np.full(self.shape, np.nan, dtype=numpy_dtype())
        universe = np.zeros(self.shape, dtype=bool)
        di, si = self.codes(s.index)
        keep = (di >= 0) & (si >= 0)
        values[di[keep], si[keep]] = pd.to_numeric(s, errors="coerce").to_numpy(
            dtype=float, na_value=np.nan)[keep]
        universe[di[keep], si[keep]] = True
        return values, universe

    def densify_labels(self, s: pd.Series) -> tuple[np.ndarray, int]:
        """Categorical labels -> int32 ids [D, N] (missing / NaN -> -1) and
        the label count."""
        codes, uniques = pd.factorize(np.asarray(s), use_na_sentinel=True)
        out = np.full(self.shape, -1, dtype=np.int32)
        di, si = self.codes(s.index)
        keep = (di >= 0) & (si >= 0)
        out[di[keep], si[keep]] = codes[keep]
        return out, len(uniques)

    def densify_positions(self, index: pd.MultiIndex) -> np.ndarray:
        """Row position of each (date, symbol) in the caller's order ->
        int32 [D, N] (absent cells INT32_MAX): the ``method='first'`` rank
        tie key, since pandas breaks those ties by appearance order."""
        out = np.full(self.shape, np.iinfo(np.int32).max, dtype=np.int32)
        di, si = self.codes(index)
        keep = (di >= 0) & (si >= 0)
        out[di[keep], si[keep]] = np.arange(len(index), dtype=np.int32)[keep]
        return out

    def to_series(self, arr, universe: np.ndarray, name=None) -> pd.Series:
        """Dense array -> long Series over the universe cells, sorted index."""
        arr = np.asarray(arr)
        di, si = np.nonzero(universe)
        idx = pd.MultiIndex.from_arrays(
            [self.dates.take(di), self.symbols.take(si)],
            names=["date", "symbol"])
        return pd.Series(arr[di, si], index=idx, name=name)

    def align_like(self, arr, index: pd.MultiIndex, name=None) -> pd.Series:
        """Dense array -> Series on the caller's own index (row order kept)."""
        arr = np.asarray(arr)
        di, si = self.codes(index)
        out = np.full(len(index), np.nan, dtype=arr.dtype)
        keep = (di >= 0) & (si >= 0)
        out[keep] = arr[di[keep], si[keep]]
        return pd.Series(out, index=index, name=name)


def densify_stack(factors_df: pd.DataFrame, vocab: PanelVocab):
    """Every column of a long-format frame on the vocabulary's grid:
    ``(stack [F, D, N] at JAX's float width, universe [D, N])``, the universe
    the union of the columns' own."""
    stack = np.empty((factors_df.shape[1],) + vocab.shape,
                     dtype=numpy_dtype())
    universe = np.zeros(vocab.shape, dtype=bool)
    for i, col in enumerate(factors_df.columns):
        vals, uni = vocab.densify(factors_df[col])
        stack[i] = vals
        universe |= uni
    return stack, universe


def roundtrip(series: pd.Series, fn, name=None, *, device=None) -> pd.Series:
    """Densify -> ``fn(values, universe)`` -> realign, the unary-op wrapper:
    ``fn`` gets JAX's float width and bool ``[D, N]`` tensors on
    ``device`` (``None`` is the card) and returns a dense ``[D, N]``
    tensor."""
    dev = resolve_device(device)
    vocab = PanelVocab.from_indexes(series.index)
    values, universe = vocab.densify(series)
    out = fn(torch.from_numpy(values).to(dev), torch.from_numpy(universe).to(dev))
    return vocab.align_like(out.cpu().numpy(), series.index,
                            name=name if name is not None else series.name)
