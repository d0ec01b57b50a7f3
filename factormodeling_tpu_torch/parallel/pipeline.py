"""The end-to-end research step (port of
``factormodeling_tpu/parallel/pipeline.py::build_research_step``)::

    factor scoring -> rolling selection -> weighted composite -> backtest
    -> summary

on one device, with the JAX package's resilience arguments (a
``FaultSpec`` injected at the stage boundaries, a ``DegradePolicy``'s
quarantine, clamp and hold), its device-side stage counters and its
numerics probes; the mesh is not ported yet.
"""

from __future__ import annotations

import contextlib
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
from factormodeling_tpu_torch.obs import counters as obs_counters
from factormodeling_tpu_torch.obs import probes as obs_probes
from factormodeling_tpu_torch.resil import faults as resil_faults
from factormodeling_tpu_torch.resil import policy as resil_policy
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
    # StageCounters when the step was built with counter collection on,
    # else None (nothing of the counters ran)
    counters: obs_counters.StageCounters | None = None
    # {stage: ProbeFrame} numerics probes when built with collect_probes,
    # else None (nothing of the probes ran); feed to RunReport.add_probes
    # or obs.probes.watchdog
    probes: dict | None = None


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
                        collect_counters: bool | None = None,
                        collect_probes: bool | None = None,
                        fault_spec=None, policy=None,
                        probe_canary: bool | None = None,
                        device=None):
    """Close the static config over
    ``step(factors, returns, factor_ret, cap_flag, investability, universe,
    fault_spec=None, policy=None)``.

    The step's inputs are ``factors [F, D, N]`` (order matching ``names``),
    ``returns [D, N]``, ``factor_ret [D, F]``, ``cap_flag`` /
    ``investability [D, N]`` and ``universe bool[D, N]``, all on the step's
    device (:func:`factormodeling_tpu_torch.convert.convert` puts numpy
    inputs there). ``device=None`` is the card; with no card it raises
    unless the caller asks for ``device="cpu"``.

    ``fault_spec`` / ``policy``: a
    :class:`~factormodeling_tpu_torch.resil.faults.FaultSpec` and a
    :class:`~factormodeling_tpu_torch.resil.policy.DegradePolicy` (the
    build-time values are the step's defaults). In the JAX package's stage
    order: faults inject into the raw factors and the universe; the
    quarantine NaNs out bad dates of the selection's inputs; faults inject
    into the selection; the blend takes the ORIGINAL factors; faults inject
    into the signal; the clamp; the engine's hold pass. With both None
    nothing of the resil layer runs; ``FaultSpec.off()`` with
    ``DegradePolicy.make()`` gives the clean outputs bit for bit.
    ``collect_counters`` (None reads ``obs.counters.counters_enabled()``)
    adds the :class:`~factormodeling_tpu_torch.obs.counters.StageCounters`
    to the output, the policy's tallies among them.

    ``collect_probes`` (None reads ``obs.probes.probes_enabled()``) opens a
    probe capture for each call and adds the JAX package's seven
    ``ProbeFrame`` summaries, in its order, to ``output.probes``: the raw
    factors, the staleness canary (``ops/factors_delta``, see below), the
    selection, the signal, the per-day final ADMM residual, the shifted
    weights and the daily P&L. Faults inject before a stage's probe; the
    clamp applies after the blend's. The frames stay on the device; the
    solves inside the call also collect ``iters_to_converge``
    (``SolverDiagnostics``). With probes off nothing of them runs and the
    outputs are bitwise those of a build without probes.
    ``probe_canary``: the staleness canary's gate (None follows fault-spec
    presence; False suppresses it; True adds it to a clean probed step,
    for production monitoring of stale feeds).
    """
    names = tuple(names)
    select_kwargs = dict(select_kwargs or {})
    sim_kwargs = dict(sim_kwargs or {})
    dev = resolve_device(device)
    if collect_counters is None:
        collect_counters = obs_counters.counters_enabled()
    if collect_probes is None:
        collect_probes = obs_probes.probes_enabled()
    default_fault, default_policy = fault_spec, policy
    # validate the simulation knobs now rather than at the first call
    SimulationSettings(returns=None, cap_flag=None, investability_flag=None,
                       **sim_kwargs)

    def step(factors, returns, factor_ret, cap_flag, investability,
             universe, fault_spec=None, policy=None) -> ResearchOutput:
        check_device(dev, factors, returns, factor_ret, cap_flag,
                     investability, universe)
        fault_spec = default_fault if fault_spec is None else fault_spec
        policy = default_policy if policy is None else policy
        # the capture is open for the whole call, so the solves inside it
        # collect their convergence telemetry too
        cap_ctx = (obs_probes.capture() if collect_probes
                   else contextlib.nullcontext())
        with cap_ctx as cap:
            out = _run(factors, returns, factor_ret, cap_flag, investability,
                       universe, fault_spec, policy)
        if collect_probes:
            out = out._replace(probes=cap.frames())
        return out

    def _run(factors, returns, factor_ret, cap_flag, investability,
             universe, fault_spec, policy) -> ResearchOutput:
        canary = (fault_spec is not None if probe_canary is None
                  else bool(probe_canary))
        if fault_spec is not None:
            factors = resil_faults.inject("ops/factors_raw", factors,
                                          fault_spec, date_axis=1)
            universe = resil_faults.inject_universe(universe, fault_spec)
        if collect_probes:
            # raw panels legitimately carry NaN: only a baseline judges them
            obs_probes.probe("ops/factors_raw", factors, expect_finite=None)
            if canary:
                # stale dates move neither finite fraction nor absmax; the
                # day-over-day delta's nonzero count sees them
                obs_probes.probe("ops/factors_delta",
                                 resil_faults.staleness_canary(factors),
                                 expect_finite=None)
        qday = None
        sel_factors, sel_fr = factors, factor_ret
        if policy is not None:
            qday = resil_policy.quarantine_days(factors, universe, policy)
            sel_factors, sel_fr = resil_policy.quarantine_inputs(
                factors, factor_ret, qday)
        selection = rolling_selection(
            sel_factors, returns, sel_fr, window, method=select_method,
            method_kwargs=select_kwargs, universe=universe)
        if fault_spec is not None:
            selection = resil_faults.inject("selection/rolling", selection,
                                            fault_spec, date_axis=0)
        if collect_probes:
            obs_probes.probe("selection/rolling", selection)
        # the blend takes the ORIGINAL factors: the quarantine protects the
        # rolling windows, not the day's own cross-section
        signal = composite_weighted(factors, names, selection,
                                    method=blend_method, universe=universe)
        if fault_spec is not None:
            signal = resil_faults.inject("composite/blend", signal,
                                         fault_spec, date_axis=0)
        if collect_probes:
            # out-of-universe cells are NaN by design: the healthy finite
            # fraction is the universe coverage, not 1
            obs_probes.probe("composite/blend", signal, expect_finite=None)
        clamped_cells = clamped_days = 0
        if policy is not None:
            signal, clamped_cells, clamped_days = resil_policy.clamp_signal(
                signal, policy)
        settings = SimulationSettings(
            returns=returns, cap_flag=cap_flag,
            investability_flag=investability, universe=universe,
            degrade=policy, **sim_kwargs)
        sim = run_simulation(signal, settings)
        if collect_probes:
            # per-day final ADMM residuals (NaN on days without a solve)
            obs_probes.probe("solver/admm", sim.diagnostics.primal_residual,
                             expect_finite=None)
            obs_probes.probe("backtest/weights", sim.weights,
                             expect_finite=None)
            obs_probes.probe("backtest/pnl", sim.result.log_return,
                             expect_finite=None)
        counters = None
        if collect_counters:
            degrade = None
            if policy is not None:
                degrade = resil_policy.merge_stats(
                    qday, clamped_cells, clamped_days, sim.degrade,
                    device=factors.device)
            counters = obs_counters.stage_counters(factors, universe,
                                                   selection, sim,
                                                   degrade=degrade)
        return ResearchOutput(selection=selection, signal=signal, sim=sim,
                              summary=result_summary(sim.result),
                              counters=counters)

    return step
