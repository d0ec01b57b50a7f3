"""Simulation engine: signal -> daily weights -> shifted trades -> P&L (port
of ``factormodeling_tpu/backtest/engine.py``).

  1. mask the signal by the investability flag;
  2. per-date weights by scheme: ``equal`` / ``linear`` are batched
     cross-sections, ``mvo`` chunks of lane-batched solves,
     ``mvo_turnover`` a sequential day loop;
  3. with a ``DegradePolicy`` in the settings, the pre-shift weights pass
     through its hold pass (min-universe hold, solver-fallback carry);
  4. trade on yesterday's signal: weights shift 1 day per symbol;
  5. P&L with tiered costs.

Lanes: a ``[C, D, N]`` signal under settings whose tenant knobs are ``[C]``
tensors (``settings.lane_knobs``) and whose panels are ``[D, N]`` (shared)
or ``[C, D, N]`` (one a lane) is ``C`` backtests in one call, what
``jax.vmap(run_simulation)`` computes: every output leaf carries the
leading ``C``. Each step acts on every lane at once (the turnover scan's
day loop solves all lanes of a date in one lane-batched solve), and a lane
computes the bits of its own unbatched call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from factormodeling_tpu_torch.backtest.diagnostics import (SchemeStats,
                                                           SolverDiagnostics)
from factormodeling_tpu_torch.backtest.mvo import (mvo_turnover_weights,
                                                   mvo_weights)
from factormodeling_tpu_torch.backtest.pnl import (DailyResult,
                                                   daily_portfolio_returns)
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.backtest.weights import (equal_weights,
                                                       linear_weights)
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.ops._window import masked_shift, shift
from factormodeling_tpu_torch.resil.policy import HoldStats, hold_weights

__all__ = ["SimulationOutput", "daily_trade_list", "run_simulation"]


class SimulationOutput(NamedTuple):
    # leaves carry a leading C under lanes
    weights: torch.Tensor       # [D, N] shifted trade weights (NaN pre-history)
    long_count: torch.Tensor    # [D]
    short_count: torch.Tensor   # [D]
    result: DailyResult
    diagnostics: SolverDiagnostics
    # the hold pass's tallies when the settings carry a DegradePolicy, else
    # None (nothing of the policy ran)
    degrade: HoldStats | None = None


def daily_trade_list(signal: torch.Tensor, s: SimulationSettings):
    """Daily weights for the chosen scheme, shifted one day per symbol.
    Returns ``(weights, long_count, short_count, diagnostics)``."""
    shifted, lc, sc, diag, _ = _trade_list_and_degrade(signal, s)
    return shifted, lc, sc, diag


def _trade_list_and_degrade(signal: torch.Tensor, s: SimulationSettings):
    """:func:`daily_trade_list` plus the hold pass: with a policy in the
    settings the pre-shift weights go through ``resil.policy.hold_weights``
    before the shift, and the fifth return is its ``HoldStats`` (None
    without a policy)."""
    dates = signal.shape[:-1]          # [D], or [C, D] under lanes
    dev = signal.device
    with obs_stage(f"backtest/trade_list/{s.method}"):
        if s.method in ("equal", "linear"):
            if s.method == "equal":
                w, lc, sc = equal_weights(signal, s.pct)
            else:
                w, lc, sc = linear_weights(signal, s.max_weight)
            nan_d = torch.full(dates, float("nan"), dtype=signal.dtype,
                               device=dev)
            zero_i = torch.zeros(dates, dtype=torch.int32, device=dev)
            resid, ok = nan_d, torch.ones(dates, dtype=torch.bool, device=dev)
            tele = (torch.zeros(dates, dtype=torch.bool, device=dev), nan_d,
                    nan_d, zero_i, zero_i, zero_i)
            stats = SchemeStats(*(torch.zeros(dates[:-1], dtype=torch.int32,
                                              device=dev)
                                  for _ in range(4)))
        elif s.method == "mvo":
            w, lc, sc, resid, ok, tele, stats = mvo_weights(signal, s)
        else:
            w, lc, sc, resid, ok, tele, stats = mvo_turnover_weights(signal,
                                                                     s)

    hold_stats = None
    if s.degrade is not None:
        uni_count = (s.universe.sum(-1) if s.universe is not None
                     else torch.full(dates, signal.shape[-1], device=dev))
        with obs_stage("resil/hold"):
            w, lc, sc, hold_stats = hold_weights(w, lc, sc, ok, uni_count,
                                                 s.degrade)

    diag = SolverDiagnostics(
        primal_residual=resid, solver_ok=ok,
        long_sum=torch.clamp(w, min=0.0).sum(-1),
        short_sum=torch.clamp(w, max=0.0).sum(-1),
        active=(lc > 0) & (sc > 0),
        polished=tele[0], polish_pre_residual=tele[1],
        polish_post_residual=tele[2],
        qp_solves=stats.qp_solves, sweeps=stats.sweeps,
        converged_days=stats.converged_days, suffix_len=stats.suffix_len,
        anderson_accepted=tele[3], anderson_rejected=tele[4],
        iters_to_converge=tele[5])

    if s.universe is not None:
        shifted = masked_shift(w, s.universe, 1, axis=-2)
    else:
        shifted = shift(w, 1, axis=-2)
    return shifted, lc, sc, diag, hold_stats


def run_simulation(signal: torch.Tensor, s: SimulationSettings) -> SimulationOutput:
    """Full backtest of a signal panel under the settings: ``[D, N]``, or
    ``[C, D, N]`` lanes (module docs)."""
    masked = signal * s.investability_flag
    weights, lc, sc, diag, hold_stats = _trade_list_and_degrade(masked, s)
    with obs_stage("backtest/pnl"):
        result = daily_portfolio_returns(weights, s)
    return SimulationOutput(weights=weights, long_count=lc, short_count=sc,
                            result=result, diagnostics=diag,
                            degrade=hold_stats)
