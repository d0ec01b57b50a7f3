"""The end-to-end research step, on one device or over a mesh (port of
``factormodeling_tpu/parallel/pipeline.py``)::

    factor scoring -> rolling selection -> weighted composite -> backtest
    -> summary

with the JAX package's resilience arguments (a ``FaultSpec`` injected at
the stage boundaries, a ``DegradePolicy``'s quarantine, clamp and hold),
its device-side stage counters and its numerics probes.

:func:`make_sharded_research_step` runs the same stages over a
``("factor", "date")`` mesh, one rank a device, with the collectives
written out (``parallel/mesh.py``): each rank scores its ``[F/f, D/d, N]``
block, the ``[D, F]`` tables are gathered, the rolling selection runs on
them on every rank, the blend runs on this rank's dates over all factors,
and the backtest runs on the gathered signal on every rank, with no
collective inside its day loop.
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
from factormodeling_tpu_torch.metrics.factor_metrics import (
    daily_factor_stats_dates, nan_mean_std)
from factormodeling_tpu_torch.obs import counters as obs_counters
from factormodeling_tpu_torch.obs import probes as obs_probes
from factormodeling_tpu_torch.obs.compile_log import (entry_point_tag,
                                                      instrument_jit)
from factormodeling_tpu_torch.obs.report import record_stage
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.parallel.mesh import (Placement, _block,
                                                    all_gather, axis_index,
                                                    axis_size, mesh_device,
                                                    panel_sharding,
                                                    stack_sharding)
from factormodeling_tpu_torch.resil import faults as resil_faults
from factormodeling_tpu_torch.resil import policy as resil_policy
from factormodeling_tpu_torch.selection.driver import rolling_selection

__all__ = ["ResearchSummary", "ResearchOutput", "result_summary",
           "build_research_step", "make_sharded_research_step"]

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


#: a row reduction on the card takes its block shape from the row count
#: below this many rows, so the summary reduces at least this many rows
#: (zero rows padded on): a lane's sums are then the same alone as in a
#: batch of lanes
_MIN_ROWS = 16


def result_summary(result: DailyResult) -> ResearchSummary:
    """Summary scalars of a [D]-shaped daily result (simple-return Sharpe via
    exp(log_return) - 1); a ``[..., D]`` result (the sweep's combos, the
    serving lanes) gives one summary per leading index."""
    lead = result.log_return.shape[:-1]
    rows = math.prod(lead)

    def padded(x):
        x = x.reshape(rows, x.shape[-1])
        if rows >= _MIN_ROWS:
            return x
        return torch.cat([x, x.new_zeros((_MIN_ROWS - rows, x.shape[-1]))])

    log_return, turnover = padded(result.log_return), padded(result.turnover)
    simple = torch.expm1(log_return)
    mean, std, n = nan_mean_std(simple, -1)
    ok = ~torch.isnan(simple)
    t_mean, _, _ = nan_mean_std(turnover, -1)
    hits = (torch.where(ok, simple, 0.0) > 0).sum(-1).to(simple.dtype)
    root = math.sqrt(_ANNUALIZE)
    return ResearchSummary(*(v[:rows].reshape(lead) for v in (
        torch.where(ok, log_return, 0.0).sum(-1),
        mean / std * root,
        std * root,
        t_mean,
        hits / torch.where(n > 0, n, float("nan")))))


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
    dev = resolve_device(device)
    run = _make_run(names=names, window=window, select_method=select_method,
                    select_kwargs=select_kwargs, blend_method=blend_method,
                    sim_kwargs=sim_kwargs, collect_counters=collect_counters,
                    collect_probes=collect_probes, fault_spec=fault_spec,
                    policy=policy, probe_canary=probe_canary)

    def step(factors, returns, factor_ret, cap_flag, investability,
             universe, fault_spec=None, policy=None) -> ResearchOutput:
        check_device(dev, factors, returns, factor_ret, cap_flag,
                     investability, universe)
        return run(factors, returns, factor_ret, cap_flag, investability,
                   universe, fault_spec, policy)

    return step


def _make_run(*, names, window, select_method, select_kwargs, blend_method,
              sim_kwargs, collect_counters, collect_probes, fault_spec,
              policy, probe_canary, stats_fn=None, blend_fn=None,
              sim_stage=None, sim_fn=None):
    """The step's body, ``run(factors, returns, factor_ret, cap_flag,
    investability, universe, fault_spec, policy)``. ``stats_fn`` (the
    selection's :func:`daily_factor_stats`), ``blend_fn`` (the blend,
    :func:`composite_weighted`'s arguments) and ``sim_fn`` (the backtest:
    ``sim_fn(signal, returns, cap_flag, investability, universe,
    sim_kwargs) -> (SimulationOutput, signal)``, the signal as the step
    returns it) are the sharded steps' seams; ``sim_stage`` names an
    ``obs.stage`` they open around the backtest, so the comms ledger would
    charge a collective there to it."""
    names = tuple(names)
    select_kwargs = dict(select_kwargs or {})
    sim_kwargs = dict(sim_kwargs or {})
    blend_fn = blend_fn or composite_weighted
    if collect_counters is None:
        collect_counters = obs_counters.counters_enabled()
    if collect_probes is None:
        collect_probes = obs_probes.probes_enabled()
    default_fault, default_policy = fault_spec, policy
    # validate the simulation knobs now rather than at the first call
    SimulationSettings(returns=None, cap_flag=None, investability_flag=None,
                       **sim_kwargs)

    def run(factors, returns, factor_ret, cap_flag, investability,
            universe, fault_spec=None, policy=None) -> ResearchOutput:
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
            with obs_stage("resil/faults"):
                factors = resil_faults.inject("ops/factors_raw", factors,
                                              fault_spec, date_axis=1)
                universe = resil_faults.inject_universe(universe,
                                                        fault_spec)
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
            with obs_stage("resil/quarantine"):
                qday = resil_policy.quarantine_days(factors, universe,
                                                    policy)
                sel_factors, sel_fr = resil_policy.quarantine_inputs(
                    factors, factor_ret, qday)
        with obs_stage("selection/rolling"):
            selection = rolling_selection(
                sel_factors, returns, sel_fr, window, method=select_method,
                method_kwargs=select_kwargs, universe=universe,
                stats_fn=stats_fn)
        if fault_spec is not None:
            with obs_stage("resil/faults"):
                selection = resil_faults.inject("selection/rolling",
                                                selection, fault_spec,
                                                date_axis=0)
        if collect_probes:
            obs_probes.probe("selection/rolling", selection)
        # the blend takes the ORIGINAL factors: the quarantine protects the
        # rolling windows, not the day's own cross-section
        with obs_stage("composite/blend"):
            signal = blend_fn(factors, names, selection,
                              method=blend_method, universe=universe)
        if fault_spec is not None:
            with obs_stage("resil/faults"):
                signal = resil_faults.inject("composite/blend", signal,
                                             fault_spec, date_axis=0)
        if collect_probes:
            # out-of-universe cells are NaN by design: the healthy finite
            # fraction is the universe coverage, not 1
            obs_probes.probe("composite/blend", signal, expect_finite=None)
        clamped_cells = clamped_days = 0
        if policy is not None:
            with obs_stage("resil/clamp"):
                signal, clamped_cells, clamped_days = \
                    resil_policy.clamp_signal(signal, policy)
        with (obs_stage(sim_stage) if sim_stage
              else contextlib.nullcontext()):
            if sim_fn is not None:
                sim, signal = sim_fn(signal, returns, cap_flag,
                                     investability, universe, sim_kwargs)
            else:
                sim = run_simulation(signal, SimulationSettings(
                    returns=returns, cap_flag=cap_flag,
                    investability_flag=investability, universe=universe,
                    degrade=policy, **sim_kwargs))
        if collect_probes:
            # per-day final ADMM residuals (NaN on days without a solve)
            obs_probes.probe("solver/admm", sim.diagnostics.primal_residual,
                             expect_finite=None)
            obs_probes.probe("backtest/weights", sim.weights,
                             expect_finite=None)
            obs_probes.probe("backtest/pnl", sim.result.log_return,
                             expect_finite=None)
        with obs_stage("pipeline/summary"):
            summary = result_summary(sim.result)
        counters = None
        if collect_counters:
            with obs_stage("obs/stage_counters"):
                degrade = None
                if policy is not None:
                    degrade = resil_policy.merge_stats(
                        qday, clamped_cells, clamped_days, sim.degrade,
                        device=factors.device)
                counters = obs_counters.stage_counters(factors, universe,
                                                       selection, sim,
                                                       degrade=degrade)
        return ResearchOutput(selection=selection, signal=signal, sim=sim,
                              summary=summary, counters=counters)

    run.collect_counters = collect_counters
    run.collect_probes = collect_probes
    return run


def _tables(blk: dict, dtype, gather) -> dict:
    """A block's ``{stat: [f, d]}`` tables through ``gather`` as one
    stacked ``[k, f, d]`` tensor, back in their own dtypes (stacked by
    copies, which ``meta`` tensors take without tracing)."""
    keys = list(blk)
    first = blk[keys[0]]
    table = torch.empty((len(keys),) + tuple(first.shape), dtype=dtype,
                        device=first.device)
    for i, k in enumerate(keys):
        table[i] = blk[k]
    table = gather(table)
    return {k: (table[i] if blk[k].dtype == table.dtype
                else table[i].to(blk[k].dtype))
            for i, k in enumerate(keys)}


class _MeshLayout:
    """The sharded step's scoring and blend over a ``(factor, date)``
    mesh. ``full`` says whether the step holds the whole stack (it
    gathers it when faults, a policy, probes or counters read it) or only
    its ``[F/f, D/d, N]`` block; either way each rank scores and blends
    its own block, and the layout gathers what the next stage needs."""

    def __init__(self, mesh, factor_axis, date_axis, n_factors, full):
        self.mesh, self.fa, self.da = mesh, factor_axis, date_axis
        self.n_factors, self.full = n_factors, full

    def _slices(self, n_dates):
        m = self.mesh
        return (_block(self.n_factors, axis_size(m, self.fa),
                       axis_index(m, self.fa)),
                _block(n_dates, axis_size(m, self.da),
                       axis_index(m, self.da)))

    def stats(self, factors, returns, *, shift_periods, universe, stats):
        """:func:`daily_factor_stats` of this rank's block (its shift
        reads earlier dates, so the block's factors are gathered over the
        date axis first), then the ``[F, D]`` tables gathered over both
        axes."""
        fsl, dsl = self._slices(returns.shape[0])
        with obs_stage("selection/daily_stats"):
            xs = (factors[fsl] if self.full
                  else all_gather(factors, self.mesh, self.da, dim=1))
            blk = daily_factor_stats_dates(xs, returns, dsl,
                                           shift_periods=shift_periods,
                                           universe=universe, stats=stats)
            return _tables(blk, returns.dtype, lambda t: all_gather(
                all_gather(t, self.mesh, self.da, dim=2), self.mesh,
                self.fa, dim=1))

    def blend(self, factors, names, selection, *, method, universe):
        """The blend of this rank's dates over every factor, then the
        ``[D, N]`` signal gathered over the date axis."""
        _, dsl = self._slices(selection.shape[0])
        with obs_stage("composite/blend"):
            xb = (factors[:, dsl] if self.full
                  else all_gather(factors, self.mesh, self.fa, dim=0))
            sig = composite_weighted(
                xb, names, selection[dsl], method=method,
                universe=None if universe is None else universe[dsl])
            return all_gather(sig, self.mesh, self.da, dim=0)


def _gather_or_none(placement: Placement, x):
    return None if x is None else placement.gather(x)


def make_sharded_research_step(mesh, *, names, window: int,
                               select_method: str = "icir_top",
                               select_kwargs: dict[str, Any] | None = None,
                               blend_method: str = "zscore",
                               sim_kwargs: dict[str, Any] | None = None,
                               factor_axis: str = "factor",
                               date_axis: str = "date",
                               collect_counters: bool | None = None,
                               collect_probes: bool | None = None,
                               fault_spec=None, policy=None,
                               probe_canary: bool | None = None):
    """The research step over a ``(factor, date)`` mesh (module docs).

    Returns ``(step, shard_inputs)``: ``shard_inputs(*full_inputs)`` cuts
    this rank's blocks (``factors [F/f, D/d, N]``, the ``[D, N]`` panels
    ``[D/d, N]``, ``factor_ret [D/d, F/f]``) and moves them to this rank's
    device; ``step(*blocks, fault_spec=None, policy=None)`` returns the
    full :class:`ResearchOutput` on every rank. Every rank must hold the
    same full inputs (the JAX package's multi-controller contract).
    ``collect_counters``, ``collect_probes``, ``fault_spec``, ``policy``
    and ``probe_canary`` are :func:`build_research_step`'s; the faults,
    the policy, the probes and the counters read the whole stack, so with
    any of them on the step gathers it first. In a world of one the
    outputs are bitwise the unsharded step's. The step carries ``.mesh``
    and ``.declared_in_shardings`` (the placements ``shard_inputs``
    cuts, which :func:`~factormodeling_tpu_torch.obs.comms.sharding_lint`
    checks)."""
    names = tuple(names)
    f_size = axis_size(mesh, factor_axis)
    d_size = axis_size(mesh, date_axis)
    if len(names) % f_size:
        raise ValueError(
            f"{len(names)} factors are not divisible by the mesh's "
            f"'{factor_axis}' axis ({f_size}); pad the factor stack (unique "
            f"prefixes, all-NaN exposures) or pick a mesh whose factor axis "
            f"divides F")
    if collect_counters is None:
        collect_counters = obs_counters.counters_enabled()
    if collect_probes is None:
        collect_probes = obs_probes.probes_enabled()
    dev = mesh_device(mesh)
    record_stage("parallel/pipeline", kind="stage",
                 mesh_shape=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                 factors=len(names), window=window,
                 select_method=select_method, blend_method=blend_method)
    fs = stack_sharding(mesh, factor_axis, date_axis)            # [F, D, N]
    ps = panel_sharding(mesh, date_axis)                         # [D, N]
    frs = Placement(mesh, (date_axis, factor_axis))              # [D, F]
    in_shardings = (fs, ps, frs, ps, ps, ps)
    cfg = dict(names=names, window=window, select_method=select_method,
               select_kwargs=select_kwargs, blend_method=blend_method,
               sim_kwargs=sim_kwargs, collect_counters=collect_counters,
               collect_probes=collect_probes, probe_canary=probe_canary)
    default_fault, default_policy = fault_spec, policy
    # by whether the call holds the whole stack (module docs)
    runs = {}
    for full in (False, True):
        layout = _MeshLayout(mesh, factor_axis, date_axis, len(names), full)
        runs[full] = _make_run(**cfg, fault_spec=None, policy=None,
                               stats_fn=layout.stats, blend_fn=layout.blend,
                               sim_stage="backtest/weights")

    def step(factors, returns, factor_ret, cap_flag, investability,
             universe, fault_spec=None, policy=None) -> ResearchOutput:
        check_device(dev, factors, returns, factor_ret, cap_flag,
                     investability, universe)
        fault_spec = default_fault if fault_spec is None else fault_spec
        policy = default_policy if policy is None else policy
        full = (fault_spec is not None or policy is not None
                or collect_probes or collect_counters)
        with obs_stage("parallel/inputs"):
            returns, cap_flag, investability, universe = (
                _gather_or_none(ps, x)
                for x in (returns, cap_flag, investability, universe))
            factor_ret = frs.gather(factor_ret)
            if full:
                factors = fs.gather(factors)
        return runs[bool(full)](factors, returns, factor_ret, cap_flag,
                                investability, universe, fault_spec, policy)

    def shard_inputs(factors, returns, factor_ret, cap_flag, investability,
                     universe):
        if returns.shape[0] % d_size:
            raise ValueError(
                f"{returns.shape[0]} dates are not divisible by the mesh's "
                f"'{date_axis}' axis ({d_size}); pad the date axis (all-NaN "
                f"rows, universe=False) or pick a mesh whose date axis "
                f"divides D")
        args = (factors, returns, factor_ret, cap_flag, investability,
                universe)
        return tuple(None if a is None else p.shard(a)
                     for a, p in zip(args, in_shardings))

    # call statistics (obs.compile_log) under the JAX package's name: a
    # stable tag of the build's configuration and the mesh layout, so two
    # different builds never pool their counts
    jitted = instrument_jit(
        step, "parallel/research_step/" + entry_point_tag(
            names, window, select_method,
            tuple(sorted((select_kwargs or {}).items())),
            blend_method, tuple(sorted((sim_kwargs or {}).items())),
            tuple(zip(mesh.mesh_dim_names, mesh.shape)), factor_axis,
            date_axis, collect_counters, collect_probes))
    jitted.mesh = mesh
    jitted.declared_in_shardings = in_shardings
    return jitted, shard_inputs
