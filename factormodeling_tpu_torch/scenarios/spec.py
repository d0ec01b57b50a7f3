"""Scenario specs: seeded market transforms (port of
``factormodeling_tpu/scenarios/spec.py``).

Three scenario FAMILIES, each a frozen dataclass of host numbers stored as
the JAX package stores them (seeds and counts int32, rates and knobs
float32), so the identity setting reproduces the base market bit for bit:

- :class:`BootstrapSpec` — **resampled markets**: circular block
  bootstrap of the ``[D, N]`` return panel and every other per-date market
  surface. Each path draws block-start indices and gathers dates by
  ``idx[d] = (start[d // L] + d % L) mod D``. The resampled unit is the
  per-date JOINT observation (shifted exposures, same-date returns and the
  per-date selection stats computed from them).
- :class:`RegimeSpec` — **counterfactual regimes**: a structural break at
  a seeded per-path date, after which returns are vol-scaled,
  drift-shifted and cross-sectionally correlation-tightened
  (``r' = (1-c) * r + c * crossmean(r)``). All three are per-date positive
  affine maps of the cross-section, so the per-date IC and rank-IC stats
  are exactly invariant and the hoisted selection stats stay exact.
- :class:`AdversarialSpec` — **adversarial markets**: the fault classes of
  :mod:`~factormodeling_tpu_torch.resil.faults` re-targeted at the market
  inputs under a seeded per-path sustained window: per-date
  stale/drop/universe-collapse draws and per-cell NaN/Inf/outlier
  corruption of the ``[D, N]`` market surface inside the window.

The draws are the JAX package's: each path's root key is
``rng.lane_key("scenario/path", seed, path_ix)`` and every family sub-draw
folds its own registered lane under it, drawn with
:mod:`~factormodeling_tpu_torch.threefry` at the JAX package's shapes and
widths (the default width follows ``torch.get_default_dtype()``, the
counterpart of ``jax_enable_x64``), so two families at one seed never
share a stream and a seed gives the JAX package's paths on the CPU and on
the card. The scalar and per-date draws are made on the host (the regime's
for every path of a dispatch at once, under a batch of path keys); the
cell draws at the market's shape on the device the caller names. Each family's
``apply`` seam takes the drawn numbers (block starts; the break date and
intensity; the window uniform and the day and cell uniforms) and keeps the
JAX package's arithmetic on them. A rate of 0 draws nothing (no uniform in
[0, 1) falls below 0): :meth:`RegimeSpec.off` and
:meth:`AdversarialSpec.off` return every panel unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from factormodeling_tpu_torch import rng as rng_lanes
from factormodeling_tpu_torch import threefry

__all__ = ["SCENARIO_FAMILIES", "AdversarialSpec", "BootstrapSpec",
           "RegimeSpec", "family_of", "path_key"]


def _f32(v) -> float:
    """``v`` rounded to float32, the JAX package's storage of a knob."""
    return float(np.float32(v))


def path_key(spec, path_ix) -> tuple:
    """A path's root threefry key: seed x path index under the registered
    ``scenario/path`` lane; an array of path indices gives the batch of
    their keys. The JAX package keys on the spec's int32 seed leaf, whose
    key is ``(0, seed mod 2**32)``. Family sub-draws fold their own lanes
    under it (:func:`_sub`)."""
    path_ix = (np.asarray(path_ix, np.int64) if np.ndim(path_ix)
               else int(path_ix))
    return rng_lanes.lane_key("scenario/path", int(spec.seed) & 0xFFFFFFFF,
                              path_ix)


def _sub(key, lane: str) -> tuple:
    return threefry.fold_in(key, rng_lanes.lane_id(lane))


def _scalar(v, dtype, device):
    return torch.tensor(v, dtype=dtype, device=device)


def leaves(spec) -> list:
    """A spec's fields as host arrays in the JAX package's pytree order and
    dtypes: what its fingerprints hash (equal to the JAX package's)."""
    return [np.asarray(getattr(spec, f.name),
                       dtype=_LEAF_DTYPES.get(f.name, np.float32))
            for f in dataclasses.fields(spec)]


_LEAF_DTYPES = {"seed": np.int32, "block_len": np.int32,
                "window_len": np.int32, "collapse_keep": np.int32}


@dataclasses.dataclass(frozen=True)
class BootstrapSpec:
    """Circular block-bootstrap resampling (family ``"bootstrap"``).

    A block length >= D degenerates to a single rotated copy of the sample
    (one start draw), block length 1 to i.i.d. date resampling.
    """

    seed: int = 0
    block_len: int = 20

    @classmethod
    def make(cls, *, seed: int = 0, block_len: int = 20) -> "BootstrapSpec":
        if int(block_len) < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        return cls(seed=int(seed), block_len=int(block_len))

    def draws(self, key, d: int) -> np.ndarray:
        """``[D]`` block starts, one per possible block slot, at the default
        integer width."""
        return threefry.randint(_sub(key, "scenario/bootstrap"), (d,), 0, d,
                                device="cpu").numpy()

    def apply(self, starts, d: int) -> np.ndarray:
        """The resampled day indices from drawn block ``starts``, in their
        integer width."""
        length = max(int(self.block_len), 1)
        starts = np.asarray(starts)
        days = np.arange(d, dtype=starts.dtype)
        return (starts[days // length] + days % length) % d

    def day_index(self, key, d: int) -> np.ndarray:
        """``[D]`` resampled day indices for one path (host)."""
        return self.apply(self.draws(key, d), d)


@dataclasses.dataclass(frozen=True)
class RegimeSpec:
    """Counterfactual regime break (family ``"regime"``).

    Per path: a break date ``s ~ U{0..D-1}`` and an intensity
    ``u ~ U[0, 1]`` are drawn; from the break on, returns become
    ``(r * vol(u) + shift(u))`` tightened toward the cross-sectional mean
    by ``c(u)``, each knob interpolating from identity to its spec value
    with ``u``. ``vol_scale=1, mean_shift=0, corr_tighten=0``
    (:meth:`off`) is the bitwise identity on every path.
    """

    seed: int = 0
    vol_scale: float = 1.0
    mean_shift: float = 0.0
    corr_tighten: float = 0.0

    @classmethod
    def make(cls, *, seed: int = 0, vol_scale: float = 1.0,
             mean_shift: float = 0.0,
             corr_tighten: float = 0.0) -> "RegimeSpec":
        if float(vol_scale) <= 0.0:
            raise ValueError(f"vol_scale must be > 0, got {vol_scale}")
        if not 0.0 <= float(corr_tighten) < 1.0:
            raise ValueError(f"corr_tighten must be in [0, 1), got "
                             f"{corr_tighten}")
        return cls(seed=int(seed), vol_scale=_f32(vol_scale),
                   mean_shift=_f32(mean_shift),
                   corr_tighten=_f32(corr_tighten))

    @classmethod
    def off(cls, seed: int = 0) -> "RegimeSpec":
        """The identity regime: ``r * 1 + 0`` and ``(1-0) * r + 0 * m`` are
        exact in IEEE arithmetic, so every path is the base market."""
        return cls.make(seed=seed)

    def draws(self, key, d: int, dtype: torch.dtype) -> tuple:
        """``(s, u)``: the break date and the intensity, drawn in ``dtype``
        (the return panel's) as Python numbers; lists of them, a path
        each, under a batch of path keys."""
        s = threefry.randint(_sub(key, "scenario/regime_break"), (), 0, d,
                             device="cpu")
        u = threefry.uniform(_sub(key, "scenario/regime_intensity"), (),
                             dtype, device="cpu")
        return s.tolist(), u.tolist()

    def apply(self, returns: torch.Tensor, s: int, u: float) -> torch.Tensor:
        """The regime transform of the ``[D, N]`` return panel at drawn
        ``(s, u)``, in the panel's dtype (``u`` is drawn in it)."""
        dt, dev = returns.dtype, returns.device
        d = returns.shape[0]
        after = (torch.arange(d, device=dev) >= s)[:, None]
        one = _scalar(1.0, dt, dev)
        u = _scalar(u, dt, dev)
        scale = one + (_scalar(self.vol_scale, dt, dev) - one) * u
        shift = _scalar(self.mean_shift, dt, dev) * u
        c = _scalar(self.corr_tighten, dt, dev) * u
        r = returns * torch.where(after, scale, one)
        r = r + torch.where(after, shift, _scalar(0.0, dt, dev))
        ok = ~torch.isnan(r)
        n_ok = torch.clamp(ok.sum(-1, keepdim=True), min=1).to(dt)
        cross = torch.where(ok, r, 0.0).sum(-1, keepdim=True) / n_ok
        tight = (one - c) * r + c * cross
        return torch.where(after, tight, r)

    def transform_returns(self, key, returns: torch.Tensor) -> torch.Tensor:
        """Per-path regime transform of the ``[D, N]`` return panel."""
        return self.apply(returns, *self.draws(key, returns.shape[0],
                                               returns.dtype))


@dataclasses.dataclass(frozen=True)
class AdversarialSpec:
    """Scheduled adversarial market corruption (family ``"adversarial"``).

    One sustained window per path (start seeded, length ``window_len``);
    rates are Bernoulli probabilities per date (stale/drop/collapse) or per
    ``[D, N]`` cell (nan/inf/outlier) INSIDE the window and exactly zero
    outside it. All-zero rates (:meth:`off`) leave the market unchanged.
    """

    seed: int = 0
    window_len: int = 20
    nan_rate: float = 0.0
    inf_rate: float = 0.0
    outlier_rate: float = 0.0
    outlier_mag: float = 9.0
    stale_rate: float = 0.0
    drop_rate: float = 0.0
    collapse_rate: float = 0.0
    collapse_keep: int = 1

    @classmethod
    def make(cls, *, seed: int = 0, window_len: int = 20, nan_rate=0.0,
             inf_rate=0.0, outlier_rate=0.0, outlier_mag=9.0,
             stale_rate=0.0, drop_rate=0.0, collapse_rate=0.0,
             collapse_keep: int = 1) -> "AdversarialSpec":
        if int(window_len) < 1:
            raise ValueError(f"window_len must be >= 1, got {window_len}")
        return cls(seed=int(seed), window_len=int(window_len),
                   nan_rate=_f32(nan_rate), inf_rate=_f32(inf_rate),
                   outlier_rate=_f32(outlier_rate),
                   outlier_mag=_f32(outlier_mag), stale_rate=_f32(stale_rate),
                   drop_rate=_f32(drop_rate),
                   collapse_rate=_f32(collapse_rate),
                   collapse_keep=int(collapse_keep))

    @classmethod
    def off(cls, seed: int = 0) -> "AdversarialSpec":
        """All-zero rates: the window is drawn but corrupts nothing."""
        return cls.make(seed=seed)

    # ------------------------------------------------------------ the draws

    def window_draw(self, key) -> np.ndarray:
        """The window-start uniform in [0, 1), at the default width."""
        return threefry.uniform(_sub(key, "scenario/adv_window"), (),
                                device="cpu").numpy()

    def day_draws(self, key, d: int) -> tuple:
        """``(stale, drop, collapse)`` ``[D]`` uniforms at the default
        width, ``None`` for a class whose rate is 0."""
        return tuple(None if rate == 0.0 else threefry.uniform(
            _sub(key, lane), (d,), device="cpu").numpy()
            for lane, rate in (("scenario/adv_stale", self.stale_rate),
                               ("scenario/adv_drop", self.drop_rate),
                               ("scenario/adv_collapse", self.collapse_rate)))

    def cell_draws(self, key, shape, *, device) -> tuple:
        """``(nan, inf, outlier)`` uniforms of ``shape`` at the default
        width on ``device``, ``None`` for a class whose rate is 0."""
        return tuple(None if rate == 0.0 else threefry.uniform(
            _sub(key, lane), tuple(shape), device=device)
            for lane, rate in (("scenario/adv_nan", self.nan_rate),
                               ("scenario/adv_inf", self.inf_rate),
                               ("scenario/adv_outlier", self.outlier_rate)))

    # --------------------------------------------------- the apply seams

    def apply_schedule(self, u_win, day_u, d: int) -> tuple:
        """``(in_window, stale, drop, collapse)`` bool ``[D]`` host masks
        from the drawn window uniform (its dtype kept: the start is
        ``(u * lo).astype(int32)`` in that dtype) and day uniforms; day
        classes are zero outside the window by construction."""
        wl = min(max(int(self.window_len), 1), d)
        # start uniform over the d - wl + 1 valid placements [0, d - wl],
        # so the window ending at the last date is reachable
        lo = max(d - wl + 1, 1)
        u = np.asarray(u_win)
        start = int((u * u.dtype.type(lo)).astype(np.int32))
        days = np.arange(d)
        in_win = (days >= start) & (days < start + wl)

        def day(uniform, rate, skip_first=False):
            if uniform is None:
                return np.zeros(d, bool)
            m = (np.asarray(uniform) < rate) & in_win
            return m & (days > 0) if skip_first else m

        stale_u, drop_u, collapse_u = day_u
        return (in_win, day(stale_u, self.stale_rate, skip_first=True),
                day(drop_u, self.drop_rate),
                day(collapse_u, self.collapse_rate))

    def schedule(self, key, d: int) -> tuple:
        """Per-path window and day draws: ``(in_window[D], stale[D],
        drop[D], collapse[D])`` bool host masks."""
        return self.apply_schedule(self.window_draw(key),
                                   self.day_draws(key, d), d)

    def apply_cell_masks(self, cell_u, in_win) -> tuple:
        """The three bool ``[D, N]`` masks (NaN burst, Inf spike, outlier
        blast) inside the window from drawn cell uniforms, each compared
        with its rate in the uniform's dtype: tensors where the uniforms
        lie, host arrays for host uniforms."""
        out = []
        for uniform, rate in zip(cell_u, (self.nan_rate, self.inf_rate,
                                          self.outlier_rate)):
            if uniform is None:
                out.append(None)
            elif isinstance(uniform, torch.Tensor):
                win = torch.as_tensor(in_win, device=uniform.device)[:, None]
                out.append(win & (uniform < rate))
            else:
                uniform = np.asarray(uniform)
                out.append(np.asarray(in_win)[:, None]
                           & (uniform < uniform.dtype.type(rate)))
        return tuple(out)

    def cell_masks(self, key, shape, in_win, *, device) -> tuple:
        """The cell masks of one path on ``device``, drawn once at the
        ``[D, N]`` market-surface granularity: a corrupt symbol-date
        observation poisons the return panel and every factor computed
        from it. ``None`` stands for an all-False mask (a rate of 0)."""
        return self.apply_cell_masks(
            self.cell_draws(key, shape, device=device), in_win)

    def apply_cells(self, x: torch.Tensor, masks) -> torch.Tensor:
        """Apply the cell masks (bool tensors on ``x``'s device, or None) to
        a ``[D, N]`` panel or an ``[F, D, N]`` stack (masks broadcast over
        the factor axis): NaN, then sign-preserving Inf, then the outlier
        blast."""
        nan_m, inf_m, out_m = masks
        if nan_m is not None:
            x = torch.where(nan_m, float("nan"), x)
        if inf_m is not None:
            spike = torch.where(torch.nan_to_num(x) < 0, float("-inf"),
                                float("inf")).to(x.dtype)
            x = torch.where(inf_m, spike, x)
        if out_m is not None:
            scale = torch.pow(_scalar(10.0, x.dtype, x.device),
                              _scalar(self.outlier_mag, x.dtype, x.device))
            x = torch.where(out_m, (torch.nan_to_num(x) + 1.0) * scale, x)
        return x


#: family name -> spec class
SCENARIO_FAMILIES = {
    "bootstrap": BootstrapSpec,
    "regime": RegimeSpec,
    "adversarial": AdversarialSpec,
}


def family_of(spec) -> str:
    """The family name of a spec instance (raises on a foreign type)."""
    for name, cls in SCENARIO_FAMILIES.items():
        if isinstance(spec, cls):
            return name
    raise TypeError(f"not a scenario spec: {type(spec).__name__} "
                    f"(families: {sorted(SCENARIO_FAMILIES)})")
