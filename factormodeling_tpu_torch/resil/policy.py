"""Graceful degradation on the device: the response half of detect ->
degrade (port of ``factormodeling_tpu/resil/policy.py``).

A :class:`DegradePolicy` has four guards, each a ``torch.where`` select and
each counted (:class:`DegradeStats` rides ``StageCounters`` into reports):

- **NaN-day factor quarantine** (``quarantine_nan_frac``): a date whose
  in-universe factor NaN share exceeds the threshold is masked out of the
  rolling selection windows (its daily stats become NaN, which the
  NaN-aware rolling reducers skip). The date still trades; the blend keeps
  the ORIGINAL factors.
- **absmax clamp** (``clamp_absmax``): the composite signal is clamped to
  ``+-clamp_absmax`` before the backtest (Inf clamps too; NaN passes).
- **min-universe guard** (``min_universe``): a date with fewer investable
  names holds the previous date's book instead of rebalancing, applied to
  the pre-shift weights of every scheme (the solver's own day-over-day
  chain keeps its path; the executed book holds).
- **solver-fallback carry** (``carry_fallback``): a date whose solve fell
  back carries the previous book, in the same hold pass, keyed on the
  scheme's per-day ``solver_ok``.

``DegradePolicy.make()`` (every guard off) gives outputs bitwise equal to
no policy: every mask is all-False, and a select with an all-False mask
returns the original operand. The policy's fields are host numbers, rounded
as the JAX package stores them (the thresholds are float32 there), so a
threshold compares the same cells in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["DegradePolicy", "DegradeStats", "HoldStats", "clamp_signal",
           "hold_weights", "merge_stats", "quarantine_days",
           "quarantine_inputs"]


def _f32(v) -> float:
    """``v`` rounded to float32, the JAX package's storage of a threshold."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Degradation thresholds (module docs; :meth:`make` builds one)."""

    min_universe: int = 0                  # 0 disables the hold guard
    quarantine_nan_frac: float = 2.0       # > 1 disables quarantine
    clamp_absmax: float = float("inf")     # inf disables the clamp
    carry_fallback: bool = False           # False = equal-x0 floor only

    @classmethod
    def make(cls, *, min_universe: int = 0, quarantine_nan_frac: float = 2.0,
             clamp_absmax: float = float("inf"),
             carry_fallback: bool = False) -> "DegradePolicy":
        return cls(min_universe=int(min_universe),
                   quarantine_nan_frac=_f32(quarantine_nan_frac),
                   clamp_absmax=_f32(clamp_absmax),
                   carry_fallback=bool(carry_fallback))


class DegradeStats(NamedTuple):
    """Per-run degradation tallies (``int32`` 0-d tensors).

    quarantined_days: dates masked out of the rolling windows.
    held_days: dates whose book held on the min-universe guard.
    carry_days: dates whose book carried on a solver fallback.
    clamped_cells: signal cells clamped to ``+-clamp_absmax``.
    degrade_events: quarantined + held + carried + clamped DATES.
    """

    quarantined_days: torch.Tensor
    held_days: torch.Tensor
    carry_days: torch.Tensor
    clamped_cells: torch.Tensor
    degrade_events: torch.Tensor

    @classmethod
    def zeros(cls, device=None) -> "DegradeStats":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return cls(z, z, z, z, z)


class HoldStats(NamedTuple):
    """The engine's slice of :class:`DegradeStats` (the hold pass's
    tallies), carried on ``SimulationOutput.degrade``."""

    held_days: torch.Tensor    # int32[]
    carry_days: torch.Tensor   # int32[]


def quarantine_days(factors: torch.Tensor, universe,
                    policy: DegradePolicy) -> torch.Tensor:
    """``bool[D]``: dates whose in-universe factor NaN share exceeds the
    quarantine threshold. With no universe, every cell counts. A ``[C, F,
    D, N]`` stack (one a lane, universe ``[D, N]`` or ``[C, D, N]``) gives
    ``[C, D]``."""
    f, d, n = factors.shape[-3:]
    nan = torch.isnan(factors)
    if universe is not None:
        nan = nan & universe[..., None, :, :]
        denom = torch.clamp(universe.sum(-1) * f, min=1)
    else:
        denom = torch.full((d,), n * f, device=factors.device)
    frac = nan.sum((-3, -1)) / denom.to(factors.dtype)
    return frac > policy.quarantine_nan_frac


def quarantine_inputs(factors: torch.Tensor, factor_ret: torch.Tensor, qday):
    """NaN out the quarantined dates of the SELECTION inputs: their daily
    stats become NaN and the NaN-aware rolling windows skip them."""
    f_sel = torch.where(qday[None, :, None], float("nan"), factors)
    fr_sel = torch.where(qday[:, None], float("nan"), factor_ret)
    return f_sel, fr_sel


def clamp_signal(signal: torch.Tensor, policy: DegradePolicy):
    """Clamp the composite to ``+-clamp_absmax`` (Inf clamps too; NaN
    passes through). Returns ``(clamped, clamped_cells, clamped_days)``,
    the tallies one a lane for a ``[C, D, N]`` composite; with the default
    ``inf`` threshold the clamp is a bitwise identity."""
    c = policy.clamp_absmax
    over = torch.abs(signal) > c          # False for NaN; True for Inf
    clamped = torch.clamp(signal, -c, c)
    return (clamped, over.flatten(-2).sum(-1).to(torch.int32),
            over.any(-1).sum(-1).to(torch.int32))


def hold_weights(w: torch.Tensor, lc, sc, solver_ok, universe_count,
                 policy: DegradePolicy):
    """The pre-shift hold pass: dates failing the min-universe guard (or,
    with ``carry_fallback``, dates whose solve fell back) re-trade the last
    book that did not hold; day 0 holds to zeros (a flat day).

    The JAX package carries the book through a ``lax.scan``; here the same
    forward fill is one gather: the index of the last unheld day is the
    running maximum of ``where(hold, -1, day)``, and a day with none before
    it takes zeros. The gather only selects rows, so it is bitwise the
    scan. Leg counts on held dates are recounted from the held book.
    Returns ``(w, lc, sc, HoldStats)``; with the default policy the outputs
    are bitwise the inputs. ``[C, D, N]`` lanes hold each its own book and
    tally one a lane (``universe_count`` ``[D]`` shared or ``[C, D]``)."""
    held_mu = (universe_count < policy.min_universe).expand(lc.shape)
    carried = ~solver_ok & ~held_mu if policy.carry_fallback \
        else torch.zeros_like(held_mu)
    hold = held_mu | carried
    days = torch.arange(w.shape[-2], device=w.device)
    last = torch.cummax(torch.where(hold, -1, days), dim=-1).values
    book = torch.take_along_dim(w, torch.clamp(last, min=0)[..., None],
                                dim=-2)
    w2 = torch.where((last >= 0)[..., None], book, 0.0)
    lc2 = torch.where(hold, (w2 > 0).sum(-1).to(lc.dtype), lc)
    sc2 = torch.where(hold, (w2 < 0).sum(-1).to(sc.dtype), sc)
    stats = HoldStats(held_days=held_mu.sum(-1).to(torch.int32),
                      carry_days=carried.sum(-1).to(torch.int32))
    return w2, lc2, sc2, stats


def merge_stats(qday, clamped_cells, clamped_days,
                hold: HoldStats | None, device=None) -> DegradeStats:
    """Fold the pipeline-side tallies (quarantine, clamp) and the engine's
    :class:`HoldStats` into one :class:`DegradeStats`."""
    def i32(v):
        return torch.as_tensor(v, dtype=torch.int32, device=device)

    zero = i32(0)
    q = zero if qday is None else qday.sum().to(torch.int32)
    held = zero if hold is None else hold.held_days
    carry = zero if hold is None else hold.carry_days
    cells, days = i32(clamped_cells), i32(clamped_days)
    return DegradeStats(quarantined_days=q, held_days=held, carry_days=carry,
                        clamped_cells=cells,
                        degrade_events=q + held + carry + days)
