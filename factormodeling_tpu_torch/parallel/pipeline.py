"""The end-to-end research step (port of
``factormodeling_tpu/parallel/pipeline.py::build_research_step``)::

    factor scoring -> rolling selection -> weighted composite -> backtest
    -> summary

on one device, without the JAX package's mesh, counters, probes and
resilience arguments (later slices keep their names).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from factormodeling_tpu_torch._device import check_device, resolve_device
from factormodeling_tpu_torch.backtest.engine import (SimulationOutput,
                                                      run_simulation)
from factormodeling_tpu_torch.backtest.pnl import DailyResult
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.composite.blend import composite_weighted
from factormodeling_tpu_torch.metrics.factor_metrics import nan_mean_std
from factormodeling_tpu_torch.selection.driver import rolling_selection

__all__ = ["ResearchSummary", "ResearchOutput", "result_summary",
           "build_research_step"]

_ANNUALIZE = 252.0


class ResearchSummary(NamedTuple):
    """Scalars over the backtest result (NaN-aware), on the device."""

    total_log_return: torch.Tensor
    sharpe: torch.Tensor
    ann_volatility: torch.Tensor
    mean_turnover: torch.Tensor
    hit_rate: torch.Tensor


class ResearchOutput(NamedTuple):
    selection: torch.Tensor   # [D, F] daily factor weights
    signal: torch.Tensor      # [D, N] composite signal
    sim: SimulationOutput
    summary: ResearchSummary


def result_summary(result: DailyResult) -> ResearchSummary:
    """Summary scalars of a [D]-shaped daily result (simple-return Sharpe via
    exp(log_return) - 1); a ``[..., D]`` result (the sweep's combos) gives
    one summary per leading index."""
    simple = torch.expm1(result.log_return)
    mean, std, n = nan_mean_std(simple, -1)
    ok = ~torch.isnan(simple)
    t_mean, _, _ = nan_mean_std(result.turnover, -1)
    hits = (torch.where(ok, simple, 0.0) > 0).sum(-1).to(simple.dtype)
    root = math.sqrt(_ANNUALIZE)
    return ResearchSummary(
        total_log_return=torch.where(ok, result.log_return, 0.0).sum(-1),
        sharpe=mean / std * root,
        ann_volatility=std * root,
        mean_turnover=t_mean,
        hit_rate=hits / torch.where(n > 0, n, float("nan")),
    )


def build_research_step(*, names, window: int,
                        select_method: str = "icir_top",
                        select_kwargs: dict[str, Any] | None = None,
                        blend_method: str = "zscore",
                        sim_kwargs: dict[str, Any] | None = None,
                        device=None):
    """Close the static config over
    ``step(factors, returns, factor_ret, cap_flag, investability, universe)``.

    The step's inputs are ``factors [F, D, N]`` (order matching ``names``),
    ``returns [D, N]``, ``factor_ret [D, F]``, ``cap_flag`` /
    ``investability [D, N]`` and ``universe bool[D, N]``, all on the step's
    device (:func:`factormodeling_tpu_torch.convert.convert` puts numpy
    inputs there). ``device=None`` is the card; with no card it raises
    unless the caller asks for ``device="cpu"``.
    """
    names = tuple(names)
    select_kwargs = dict(select_kwargs or {})
    sim_kwargs = dict(sim_kwargs or {})
    dev = resolve_device(device)
    # validate the simulation knobs now rather than at the first call
    SimulationSettings(returns=None, cap_flag=None, investability_flag=None,
                       **sim_kwargs)

    def step(factors, returns, factor_ret, cap_flag, investability,
             universe) -> ResearchOutput:
        check_device(dev, factors, returns, factor_ret, cap_flag,
                     investability, universe)
        selection = rolling_selection(
            factors, returns, factor_ret, window, method=select_method,
            method_kwargs=select_kwargs, universe=universe)
        signal = composite_weighted(factors, names, selection,
                                    method=blend_method, universe=universe)
        settings = SimulationSettings(
            returns=returns, cap_flag=cap_flag,
            investability_flag=investability, universe=universe, **sim_kwargs)
        sim = run_simulation(signal, settings)
        return ResearchOutput(selection=selection, signal=signal, sim=sim,
                              summary=result_summary(sim.result))

    return step
