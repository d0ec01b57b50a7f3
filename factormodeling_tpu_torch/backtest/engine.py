"""Simulation engine: signal -> daily weights -> shifted trades -> P&L (port
of ``factormodeling_tpu/backtest/engine.py``).

  1. mask the signal by the investability flag;
  2. per-date weights by scheme: ``equal`` / ``linear`` are batched
     cross-sections, ``mvo_turnover`` a sequential day loop;
  3. trade on yesterday's signal: weights shift 1 day per symbol;
  4. P&L with tiered costs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from factormodeling_tpu_torch.backtest.diagnostics import (SchemeStats,
                                                           SolverDiagnostics)
from factormodeling_tpu_torch.backtest.mvo import mvo_turnover_weights
from factormodeling_tpu_torch.backtest.pnl import (DailyResult,
                                                   daily_portfolio_returns)
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.backtest.weights import (equal_weights,
                                                       linear_weights)
from factormodeling_tpu_torch.ops._window import masked_shift, shift

__all__ = ["SimulationOutput", "daily_trade_list", "run_simulation"]


class SimulationOutput(NamedTuple):
    weights: torch.Tensor       # [D, N] shifted trade weights (NaN pre-history)
    long_count: torch.Tensor    # [D]
    short_count: torch.Tensor   # [D]
    result: DailyResult
    diagnostics: SolverDiagnostics


def daily_trade_list(signal: torch.Tensor, s: SimulationSettings):
    """Daily weights for the chosen scheme, shifted one day per symbol.
    Returns ``(weights, long_count, short_count, diagnostics)``."""
    if s.degrade is not None:
        raise NotImplementedError(
            "degradation policies (the resil layer) are not ported yet")
    d = signal.shape[0]
    dev = signal.device
    nan_d = torch.full((d,), float("nan"), dtype=signal.dtype, device=dev)
    zero_i = torch.zeros((d,), dtype=torch.int32, device=dev)
    if s.method in ("equal", "linear"):
        if s.method == "equal":
            w, lc, sc = equal_weights(signal, s.pct)
        else:
            w, lc, sc = linear_weights(signal, s.max_weight)
        resid, ok = nan_d, torch.ones((d,), dtype=torch.bool, device=dev)
        polish = (torch.zeros((d,), dtype=torch.bool, device=dev), nan_d, nan_d)
        stats = SchemeStats(*(torch.zeros((), dtype=torch.int32, device=dev)
                              for _ in range(4)))
    elif s.method == "mvo_turnover":
        w, lc, sc, resid, ok, polish, stats = mvo_turnover_weights(signal, s)
    else:
        raise NotImplementedError(
            "method='mvo' (plain per-date MVO) is not ported yet "
            "(see ROADMAP.md)")

    diag = SolverDiagnostics(
        primal_residual=resid, solver_ok=ok,
        long_sum=torch.clamp(w, min=0.0).sum(-1),
        short_sum=torch.clamp(w, max=0.0).sum(-1),
        active=(lc > 0) & (sc > 0),
        polished=polish[0], polish_pre_residual=polish[1],
        polish_post_residual=polish[2],
        qp_solves=stats.qp_solves, sweeps=stats.sweeps,
        converged_days=stats.converged_days, suffix_len=stats.suffix_len,
        anderson_accepted=zero_i, anderson_rejected=zero_i,
        iters_to_converge=zero_i)

    if s.universe is not None:
        shifted = masked_shift(w, s.universe, 1, axis=0)
    else:
        shifted = shift(w, 1, axis=0)
    return shifted, lc, sc, diag


def run_simulation(signal: torch.Tensor, s: SimulationSettings) -> SimulationOutput:
    """Full backtest of a signal panel under the settings."""
    masked = signal * s.investability_flag
    weights, lc, sc, diag = daily_trade_list(masked, s)
    result = daily_portfolio_returns(weights, s)
    return SimulationOutput(weights=weights, long_count=lc, short_count=sc,
                            result=result, diagnostics=diag)
