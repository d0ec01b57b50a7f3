"""Device-side stage counters of the research step (port of
``factormodeling_tpu/obs/counters.py``).

Per-date universe coverage, per-factor NaN share, selection churn, the
solver/polish acceptance tallies and the degradation-policy tallies, all
computed on the device from the step's own intermediates, with no extra
host reads. Collection is decided when the step is BUILT
(``build_research_step(collect_counters=...)``; None reads the global flag
:func:`enable_counters` / :func:`collecting` set): off, nothing here runs
and the step's outputs are those of a build without counters.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch._device import host_array

__all__ = ["StageCounters", "stage_counters", "summarize_counters",
           "enable_counters", "counters_enabled", "collecting"]

_ENABLED = False


def enable_counters(flag: bool = True) -> None:
    """Globally enable/disable counter collection for steps built after."""
    global _ENABLED
    _ENABLED = bool(flag)


def counters_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def collecting(flag: bool = True):
    """Scoped :func:`enable_counters`: counters collected by steps BUILT
    inside the block."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    try:
        yield
    finally:
        _ENABLED = prev


class StageCounters(NamedTuple):
    """Per-run counters, on the step's device (shapes per field).

    universe_size: ``int32[D]`` investable names per date.
    factor_nan_frac: ``[F]`` NaN share of each factor's raw panel (inside
      the universe when masked).
    selection_active: ``int32[D]`` factors with positive selection weight.
    selection_churn: ``[D]`` 0.5 * L1 day-over-day change of the selection
      rows (0 on day 0).
    long_count / short_count: ``int32[D]`` traded names per leg.
    active_days: ``int32[]`` days that traded.
    solver_fallback_days: ``int32[]`` active days whose solve fell back.
    polish_attempted / polish_accepted: ``int32[]`` polish tallies.
    qp_solves: ``int32[]`` QP solves the scheme dispatched.
    turnover_sweeps / turnover_converged_days / turnover_suffix_len:
      ``int32[]`` the turnover-parallel scheme's telemetry.
    anderson_accepted / anderson_rejected: ``int32[]`` Anderson tallies.
    quarantined_days / held_days / carry_fallback_days / clamped_cells /
      degrade_events: ``int32[]`` the degradation-policy tallies
      (``resil.policy.DegradeStats``; 0 without a policy).
    """

    universe_size: torch.Tensor
    factor_nan_frac: torch.Tensor
    selection_active: torch.Tensor
    selection_churn: torch.Tensor
    long_count: torch.Tensor
    short_count: torch.Tensor
    active_days: torch.Tensor
    solver_fallback_days: torch.Tensor
    polish_attempted: torch.Tensor
    polish_accepted: torch.Tensor
    qp_solves: torch.Tensor
    turnover_sweeps: torch.Tensor
    turnover_converged_days: torch.Tensor
    turnover_suffix_len: torch.Tensor
    anderson_accepted: torch.Tensor
    anderson_rejected: torch.Tensor
    quarantined_days: torch.Tensor
    held_days: torch.Tensor
    carry_fallback_days: torch.Tensor
    clamped_cells: torch.Tensor
    degrade_events: torch.Tensor


def stage_counters(factors: torch.Tensor, universe, selection: torch.Tensor,
                   sim, degrade=None) -> StageCounters:
    """The counters from the step's intermediates: ``factors [F, D, N]``
    raw, ``universe bool[D, N]`` or None, ``selection [D, F]``, the
    engine's ``SimulationOutput``, and optional ``DegradeStats``."""
    f, d, n = factors.shape
    dev = factors.device
    i32 = torch.int32
    if universe is not None:
        uni_size = universe.sum(-1).to(i32)
        nan_cnt = (torch.isnan(factors) & universe).sum((-2, -1))
        tot = torch.clamp(universe.sum(), min=1).to(factors.dtype)
    else:
        uni_size = torch.full((d,), n, dtype=i32, device=dev)
        nan_cnt = torch.isnan(factors).sum((-2, -1))
        tot = torch.tensor(d * n, dtype=factors.dtype, device=dev)
    diag = sim.diagnostics
    delta = selection - torch.roll(selection, 1, dims=0)
    churn = 0.5 * torch.abs(delta).sum(-1)
    churn = torch.where(torch.arange(d, device=dev) == 0, 0.0, churn)
    zero_i = torch.zeros((), dtype=i32, device=dev)
    return StageCounters(
        universe_size=uni_size,
        factor_nan_frac=nan_cnt.to(factors.dtype) / tot,
        selection_active=(selection > 0).sum(-1).to(i32),
        selection_churn=churn,
        long_count=sim.long_count.to(i32),
        short_count=sim.short_count.to(i32),
        active_days=diag.active.sum().to(i32),
        solver_fallback_days=(diag.active & ~diag.solver_ok).sum().to(i32),
        polish_attempted=torch.isfinite(diag.polish_pre_residual).sum().to(i32),
        polish_accepted=diag.polished.sum().to(i32),
        qp_solves=diag.qp_solves.sum().to(i32),
        turnover_sweeps=diag.sweeps.sum().to(i32),
        turnover_converged_days=diag.converged_days.sum().to(i32),
        turnover_suffix_len=diag.suffix_len.sum().to(i32),
        anderson_accepted=diag.anderson_accepted.sum().to(i32),
        anderson_rejected=diag.anderson_rejected.sum().to(i32),
        quarantined_days=(zero_i if degrade is None
                          else degrade.quarantined_days),
        held_days=zero_i if degrade is None else degrade.held_days,
        carry_fallback_days=(zero_i if degrade is None
                             else degrade.carry_days),
        clamped_cells=zero_i if degrade is None else degrade.clamped_cells,
        degrade_events=(zero_i if degrade is None
                        else degrade.degrade_events),
    )


def summarize_counters(counters: StageCounters) -> dict:
    """Host-side JSON-ready summary: scalars verbatim, per-date/per-factor
    arrays reduced to mean/max (NaN on empty); every field appears."""

    def _mm(a):
        a = a.astype(float)
        if a.size == 0:
            return {"mean": float("nan"), "max": float("nan")}
        return {"mean": float(a.mean()), "max": float(a.max())}

    out: dict = {}
    for key, val in counters._asdict().items():
        a = host_array(val)
        if a.ndim == 0:
            out[key] = (float(a) if np.issubdtype(a.dtype, np.floating)
                        else int(a))
        else:
            out[key] = _mm(a)
    return out
