"""Deterministic fault injection at the research step's stage boundaries
(port of ``factormodeling_tpu/resil/faults.py``).

Seedable, reproducible corruption of the step's inputs and intermediates,
so the degradation policy (:mod:`.policy`) can be exercised against every
failure class on demand. ``build_research_step``'s step takes
``fault_spec=None``: with None nothing here runs.

Fault classes (``FAULT_CLASSES``):

- ``nan_burst``: random cells -> NaN;
- ``inf_spike``: random cells -> +-Inf (sign-preserving);
- ``outlier``: random cells scaled to ``~10**outlier_mag``;
- ``stale_repeat``: random dates re-serve the PREVIOUS date's rows;
- ``drop_day``: random dates -> all-NaN rows;
- ``universe_collapse``: random dates keep only ``collapse_keep`` names of
  the universe input.

Cell faults apply first, then staleness, then drops, the JAX package's
order: a dropped day is dropped whatever else hit it, and a stale day
re-serves the (possibly corrupted) previous day.

The draws are the JAX package's: each class draws its uniforms with
:func:`~factormodeling_tpu_torch.threefry.uniform` under
``rng.lane_key(f"fault/{kind}", seed, stage_idx)``, at JAX's default width
(``torch.get_default_dtype()``, the counterpart of ``jax_enable_x64``), a
cell class at the tensor's shape on the tensor's device and a day class
``[D]``; the comparisons with each class's threshold take the JAX
package's types. So a spec corrupts the JAX package's cells on the CPU and
on the card alike. A class whose threshold is 0 draws nothing (no uniform
in [0, 1) falls below 0), so ``FaultSpec.off()`` returns every tensor
unchanged. :func:`_inject_with` and :func:`_collapse_with` apply given
uniforms (tensors or host arrays).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from factormodeling_tpu_torch import rng as rng_lanes
from factormodeling_tpu_torch import threefry

__all__ = ["DISPATCH_FAULT_CLASSES", "FAULT_CLASSES", "INJECT_STAGES",
           "DispatchFault", "DispatchFaultPlan", "FaultSpec", "inject",
           "inject_universe", "staleness_canary"]

#: stage boundaries whose tensors the injectors can corrupt, in step
#: order: the raw factor stack [F, D, N], the selection matrix [D, F], and
#: the composite signal [D, N]. ``FaultSpec.stage_gate`` indexes this tuple.
INJECT_STAGES = ("ops/factors_raw", "selection/rolling", "composite/blend")

#: the fault classes the spec can express
FAULT_CLASSES = ("nan_burst", "inf_spike", "outlier", "stale_repeat",
                 "drop_day", "universe_collapse")

_CELL_CLASSES = (("nan_burst", "nan_rate"), ("inf_spike", "inf_rate"),
                 ("outlier", "outlier_rate"))
_DAY_CLASSES = (("stale_repeat", "stale_rate"), ("drop_day", "drop_rate"))


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seedable fault configuration, host numbers stored as the JAX package
    stores them (rates and the gate in float32).

    Rates are per-cell (``nan_rate``/``inf_rate``/``outlier_rate``) or
    per-date (``stale_rate``/``drop_rate``/``collapse_rate``) Bernoulli
    probabilities; ``stage_gate`` scales every tensor fault at each stage
    of ``INJECT_STAGES`` (1.0 = inject there, 0.0 = leave alone).
    ``universe_collapse`` ignores the gate. Two runs with equal specs
    corrupt identical cells."""

    seed: int = 0
    stage_gate: tuple = (1.0, 1.0, 1.0)
    nan_rate: float = 0.0
    inf_rate: float = 0.0
    outlier_rate: float = 0.0
    outlier_mag: float = 9.0
    stale_rate: float = 0.0
    drop_rate: float = 0.0
    collapse_rate: float = 0.0
    collapse_keep: int = 1

    @classmethod
    def make(cls, *, seed: int = 0, stage: str | None = None,
             nan_rate=0.0, inf_rate=0.0, outlier_rate=0.0, outlier_mag=9.0,
             stale_rate=0.0, drop_rate=0.0, collapse_rate=0.0,
             collapse_keep: int = 1) -> "FaultSpec":
        """A spec from Python scalars. ``stage=None`` gates every stage on;
        a stage name gates exactly that boundary."""
        if stage is None:
            gate = (1.0,) * len(INJECT_STAGES)
        else:
            idx = INJECT_STAGES.index(stage)
            gate = tuple(1.0 if i == idx else 0.0
                         for i in range(len(INJECT_STAGES)))
        return cls(seed=int(seed), stage_gate=gate,
                   nan_rate=_f32(nan_rate), inf_rate=_f32(inf_rate),
                   outlier_rate=_f32(outlier_rate),
                   outlier_mag=_f32(outlier_mag),
                   stale_rate=_f32(stale_rate), drop_rate=_f32(drop_rate),
                   collapse_rate=_f32(collapse_rate),
                   collapse_keep=int(collapse_keep))

    @classmethod
    def off(cls, seed: int = 0) -> "FaultSpec":
        """The all-zero-rate spec: corrupts nothing."""
        return cls.make(seed=seed)

    @classmethod
    def single(cls, kind: str, *, stage: str = "ops/factors_raw",
               rate: float = 0.05, seed: int = 0, magnitude: float = 9.0,
               keep: int = 1) -> "FaultSpec":
        """One fault class at one boundary. ``magnitude`` is the outlier's
        log10 scale; ``keep`` the surviving names of a collapsed date."""
        if kind not in FAULT_CLASSES:
            raise ValueError(f"unknown fault class {kind!r}; valid: "
                             f"{FAULT_CLASSES}")
        kw = {"nan_burst": {"nan_rate": rate},
              "inf_spike": {"inf_rate": rate},
              "outlier": {"outlier_rate": rate, "outlier_mag": magnitude},
              "stale_repeat": {"stale_rate": rate},
              "drop_day": {"drop_rate": rate},
              "universe_collapse": {"collapse_rate": rate,
                                    "collapse_keep": keep}}[kind]
        return cls.make(seed=seed, stage=stage, **kw)


# --------------------------------------------------- dispatch-level faults

#: host-side fault classes injected AROUND a dispatch: ``dispatch_error``
#: (the dispatch raises before delivering) and ``dispatch_poison`` (it
#: completes but its outputs fail validation and must be discarded)
DISPATCH_FAULT_CLASSES = ("dispatch_error", "dispatch_poison")


class DispatchFault(RuntimeError):
    """An injected dispatch-level fault (see :data:`DISPATCH_FAULT_CLASSES`),
    retryable by design."""

    def __init__(self, kind: str, attempt: int):
        super().__init__(f"injected {kind} at dispatch attempt {attempt}")
        self.kind = kind
        self.attempt = attempt


@dataclasses.dataclass(frozen=True)
class DispatchFaultPlan:
    """Seedable host-side plan: which dispatch ATTEMPTS fault, and how.

    Deterministic per attempt index (a ``numpy`` generator of the
    ``serve/dispatch_fault`` lane keyed on ``(seed, attempt)``, the JAX
    package's stream), so a resumed run that restores its attempt counter
    rolls the same faults. Rates are disjoint shares of one uniform draw
    (``error_rate + poison_rate <= 1``)."""

    seed: int = 0
    error_rate: float = 0.0
    poison_rate: float = 0.0

    _LANE = "serve/dispatch_fault"

    def __post_init__(self):
        for name in ("error_rate", "poison_rate"):
            v = float(getattr(self, name))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.error_rate + self.poison_rate > 1.0:
            raise ValueError(
                f"error_rate + poison_rate must be <= 1 (disjoint shares "
                f"of one draw), got {self.error_rate} + {self.poison_rate}")

    def roll(self, attempt: int) -> "str | None":
        """The fault class injected at this attempt index, or None."""
        u = float(rng_lanes.lane_rng(self._LANE, self.seed,
                                     int(attempt)).uniform())
        if u < self.error_rate:
            return "dispatch_error"
        if u < self.error_rate + self.poison_rate:
            return "dispatch_poison"
        return None


# ------------------------------------------------------- tensor injection


def _thresholds(spec: FaultSpec, stage_idx: int, dtype: torch.dtype) -> dict:
    """Each class's mask threshold at one stage, in the JAX package's types
    for a tensor of ``dtype`` and uniforms of the default width: a cell
    class compares against ``gate * rate`` in the tensor's type, a day
    class against the gate times the rate in the uniforms' type."""
    xdt = threefry.numpy_dtype(dtype)
    ddt = np.promote_types(xdt, threefry.numpy_dtype())
    gate = np.asarray(spec.stage_gate[stage_idx], np.float32).astype(xdt)
    out = {kind: gate * np.asarray(getattr(spec, rate), np.float32).astype(xdt)
           for kind, rate in _CELL_CLASSES}
    out.update({kind: gate.astype(ddt) * np.asarray(getattr(spec, rate),
                                                    np.float32).astype(ddt)
                for kind, rate in _DAY_CLASSES})
    return out


def _key(spec, stage_idx: int, kind: str) -> tuple:
    """A class's key at one stage. The JAX package keys on the spec's int32
    seed leaf, whose key is ``(0, seed mod 2**32)``."""
    return rng_lanes.lane_key(f"fault/{kind}", int(spec.seed) & 0xFFFFFFFF,
                              stage_idx)


def _draws(spec: FaultSpec, stage_idx: int, shape, date_axis: int,
           thresholds: dict, device) -> dict:
    """The uniforms of every class whose threshold is positive: the
    tensor's shape for a cell class, ``[D]`` for a day class, on
    ``device``."""
    d = shape[date_axis]
    out = {}
    for kind, _ in _CELL_CLASSES + _DAY_CLASSES:
        if thresholds[kind] > 0:
            size = (d,) if kind in dict(_DAY_CLASSES) else tuple(shape)
            out[kind] = threefry.uniform(_key(spec, stage_idx, kind), size,
                                         device=device)
    return out


def _mask(u, thresh, device) -> torch.Tensor:
    """``u < thresh`` on the device, compared in the promoted type of the
    two as the JAX package compares: tensor uniforms where they lie, host
    uniforms on the host (their booleans then move)."""
    if isinstance(u, torch.Tensor):
        cmp = torch.promote_types(u.dtype, torch.from_numpy(
            np.asarray(thresh)).dtype)
        t = torch.tensor(float(thresh), dtype=cmp, device=u.device)
        return (u.to(cmp) < t).to(device)
    return torch.from_numpy(np.asarray(u) < thresh).to(device)


def _day_view(x: torch.Tensor, date_axis: int, mask_d: torch.Tensor):
    view = [1] * x.ndim
    view[date_axis] = x.shape[date_axis]
    return mask_d.reshape(view)


def _inject_with(stage_idx: int, x: torch.Tensor, spec: FaultSpec,
                 uniforms: dict, *, date_axis: int = 0) -> torch.Tensor:
    """Apply the faults of one stage given each class's uniforms
    (``uniforms[kind]``: the tensor's shape for a cell class, ``[D]`` for a
    day class; a missing class is not applied)."""
    thr = _thresholds(spec, stage_idx, x.dtype)
    dev = x.device
    date_axis = date_axis % x.ndim
    nan, inf = float("nan"), float("inf")
    if "nan_burst" in uniforms:
        x = torch.where(_mask(uniforms["nan_burst"], thr["nan_burst"], dev),
                        nan, x)
    if "inf_spike" in uniforms:
        spike = torch.where(torch.nan_to_num(x) < 0, -inf, inf).to(x.dtype)
        x = torch.where(_mask(uniforms["inf_spike"], thr["inf_spike"], dev),
                        spike, x)
    if "outlier" in uniforms:
        xdt = threefry.numpy_dtype(x.dtype)
        scale = float(np.power(np.asarray(10.0, xdt),
                               np.asarray(spec.outlier_mag, xdt)))
        blast = (torch.nan_to_num(x) + 1.0) * scale
        x = torch.where(_mask(uniforms["outlier"], thr["outlier"], dev),
                        blast, x)
    d = x.shape[date_axis]
    if "stale_repeat" in uniforms:
        stale = _mask(uniforms["stale_repeat"], thr["stale_repeat"], dev)
        stale = stale & (torch.arange(d, device=dev) > 0)
        prev = torch.index_select(
            x, date_axis, torch.clamp(torch.arange(d, device=dev) - 1, min=0))
        x = torch.where(_day_view(x, date_axis, stale), prev, x)
    if "drop_day" in uniforms:
        drop = _mask(uniforms["drop_day"], thr["drop_day"], dev)
        x = torch.where(_day_view(x, date_axis, drop), nan, x)
    return x


def inject(stage: str, x, spec: FaultSpec | None, *, date_axis: int = 0):
    """Corrupt one stage tensor per the spec; ``x`` itself when ``spec`` is
    None or no class fires at this stage.

    ``date_axis`` locates the date dimension for the day-level classes
    (factor stacks [F, D, N] pass 1; panels and matrices [D, ...] pass 0).
    """
    if spec is None or x is None:
        return x
    idx = INJECT_STAGES.index(stage)
    draws = _draws(spec, idx, x.shape, date_axis % x.ndim,
                   _thresholds(spec, idx, x.dtype), x.device)
    if not draws:
        return x
    return _inject_with(idx, x, spec, draws, date_axis=date_axis)


def _collapse_with(universe: torch.Tensor, spec: FaultSpec,
                   u) -> torch.Tensor:
    """Collapse the dates whose uniform ``u[d]`` falls below the rate to the
    first ``collapse_keep`` members."""
    day = _mask(u, np.float32(spec.collapse_rate), universe.device)
    rank = torch.cumsum(universe.to(torch.int32), dim=1)
    collapsed = universe & (rank <= spec.collapse_keep)
    return torch.where(day[:, None], collapsed, universe)


def inject_universe(universe, spec: FaultSpec | None):
    """Collapse random dates of a ``bool[D, N]`` universe to the first
    ``collapse_keep`` members; ungated by ``stage_gate`` (the universe is
    an input). Identity when either is None or the rate is 0."""
    if spec is None or universe is None or not spec.collapse_rate > 0:
        return universe
    u = threefry.uniform(_key(spec, 0, "universe_collapse"),
                         (universe.shape[0],), device=universe.device)
    return _collapse_with(universe, spec, u)


def staleness_canary(factors: torch.Tensor, *, date_axis: int = 1):
    """Day-over-day delta of the factor stack, first date NaN: a stale
    day's delta rows are exactly zero, so stale feeds (which move neither
    finite fraction nor absmax) show in its nonzero count."""
    d = factors.shape[date_axis]
    delta = factors - torch.roll(factors, 1, dims=date_axis)
    first = _day_view(factors, date_axis % factors.ndim,
                      torch.arange(d, device=factors.device) == 0)
    return torch.where(first, float("nan"), delta)
