"""Asset-axis scale-out: the asset-sharded research step and the
ledger-driven layout chooser (port of
``factormodeling_tpu/parallel/asset_shard.py``).

- :func:`make_asset_mesh` builds a mesh carrying the asset axis (a flat
  ``("assets",)`` mesh by default; serving uses ``("configs",
  "assets")``; ``cluster.make_hybrid_mesh`` gives the multi-host form).
- :func:`make_asset_sharded_research_step` is the
  ``make_sharded_research_step`` sibling with the asset axis on every
  ``[..., N]`` operand. The factor stack and the four ``[D, N]`` panels
  stay this rank's ``[.., D/d, N/s]`` blocks until a stage needs whole
  rows; only ``factor_ret [D, F]`` is gathered at the inputs. Each stage
  forms the rows its mode gives this rank (``ops/_assetspec.py``:
  ``auto``, ``reshard``, ``gather``), the panel rows it reads with them,
  and computes on them: the scoring (``metrics/rank_ic``) gathers its
  ``[D, F]`` tables to every rank; the blend forms rows under
  ``ops/quantile`` (its rank transform under ``ops/rank``) and keeps its
  signal rows; the backtest's ``solver/iterates`` and
  ``backtest/weights`` stages take them on (``parallel/_asset_backtest.
  py``: a halo of earlier rows where a stage reads them, the scan's carry
  handed from block to block). The step returns the unsharded step's
  outputs with ``signal`` and ``sim.weights`` as this rank's ``[D/d,
  N/s]`` blocks; ``step.gather_outputs`` puts them together on every
  rank. With counters or probes on the step gathers its inputs (they read
  the stack whole) and runs the unsharded stages.
- :func:`choose_asset_specs` ranks each stage's modes by the comms
  ledger's bytes (``obs/comms.py``) without running the step on data: for
  each mode it runs the step's stages on ``meta`` tensors with the ledger
  recording only, the same collectives through the same wrappers, which
  issue nothing, while the scoring's, the blend's and the solves' compute
  is replaced by empty results of their output shapes (the weight schemes
  and the P&L run on the ``meta`` tensors as they are), so no kernel
  launches and the bytes come from the shapes alone.
  :func:`record_spec_choices` lands the verdicts as ``kind="spec_choice"``
  rows in the JAX package's schema.

The ledger charges a collective to the OUTERMOST known scope open around
it (``obs/comms.py``, the JAX package's rule): the scoring's collectives
run inside ``selection/rolling``, the blend's inside ``composite/blend``,
the solves' inside ``solver/admm`` and the weights' and P&L's inside
``backtest/weights``. :data:`_STAGE_LEDGER_SCOPES` is the JAX package's
mapping from each plan stage to the scopes its collectives land under,
and the chooser reads a stage's bytes over them: ``ops/rank`` and
``metrics/rank_ic`` share ``selection/rolling``, ``ops/rank`` and
``ops/quantile`` share ``composite/blend``, so those rank together (the
JAX package's shared-scope tie). A stage that issued nothing in every mode
is judged by the candidates' totals, and its row says ``"attribution":
"total"``.
"""

from __future__ import annotations

import torch

from factormodeling_tpu_torch._device import check_device
from factormodeling_tpu_torch.composite.blend import composite_weighted
from factormodeling_tpu_torch.metrics.factor_metrics import \
    daily_factor_stats
from factormodeling_tpu_torch.obs import comms as obs_comms
from factormodeling_tpu_torch.obs import counters as obs_counters
from factormodeling_tpu_torch.obs import probes as obs_probes
from factormodeling_tpu_torch.obs.compile_log import (entry_point_tag,
                                                      instrument_jit)
from factormodeling_tpu_torch.obs.report import record_stage
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.ops._assetspec import (
    ASSET_SORT_STAGES,
    _MODES,
    AssetSpecPlan,
    active_plan,
    hint,
    plan as install_plan,
)
from factormodeling_tpu_torch.parallel._asset_backtest import (
    block_masked_shift, sharded_simulation)
from factormodeling_tpu_torch.parallel.mesh import (ASSET_AXIS, Placement,
                                                    axis_size,
                                                    make_mesh, mesh_device,
                                                    panel_sharding,
                                                    stack_sharding)
from factormodeling_tpu_torch.parallel.pipeline import _make_run, _tables
from factormodeling_tpu_torch.selection.driver import \
    selection_metric_needs

__all__ = [
    "ASSET_SORT_STAGES",
    "AssetSpecPlan",
    "asset_in_shardings",
    "choose_asset_specs",
    "make_asset_mesh",
    "make_asset_sharded_research_step",
    "record_spec_choices",
]


#: the ledger scopes each plan stage's collectives land under (module
#: docs; the JAX package's mapping): the rank-IC rows are formed inside
#: rolling_selection, so its collectives attribute to the OUTERMOST scope,
#: selection/rolling
_STAGE_LEDGER_SCOPES = {
    "metrics/rank_ic": ("metrics/rank_ic", "selection/daily_stats",
                        "selection/rolling"),
    "ops/rank": ("selection/rolling", "selection/rolling_metrics",
                 "composite/blend"),
    "ops/quantile": ("composite/blend",),
    "backtest/weights": ("backtest/weights", "backtest/trade_list"),
    "solver/iterates": ("solver/admm", "solver/polish"),
}


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _shape(mesh) -> dict:
    return {n: int(s) for n, s in zip(_names(mesh), mesh.shape)}


def make_asset_mesh(axis_names: tuple[str, ...] = (ASSET_AXIS,),
                    n_devices: int | None = None, *, device=None):
    """A mesh carrying the asset axis: flat ``("assets",)`` by default,
    or any axis tuple containing :data:`~.mesh.ASSET_AXIS` (the serving
    layer's ``("configs", "assets")``)."""
    if ASSET_AXIS not in axis_names:
        raise ValueError(f"axis_names {axis_names} carry no "
                         f"{ASSET_AXIS!r} axis")
    return make_mesh(axis_names, n_devices=n_devices, device=device)


def asset_in_shardings(mesh, date_axis: str | None = None,
                       asset_axis: str = ASSET_AXIS) -> tuple:
    """The research step's declared input placements under an asset mesh:
    ``factors [F, D, N]`` and the ``[D, N]`` panels carry the asset axis
    on ``N`` (plus the date axis when given); ``factor_ret [D, F]`` never
    touches ``N`` and shards dates only."""
    if asset_axis not in _names(mesh):
        raise ValueError(f"mesh has no {asset_axis!r} axis "
                         f"(axes: {_names(mesh)})")
    if date_axis is not None and date_axis not in _names(mesh):
        raise ValueError(f"mesh has no {date_axis!r} axis "
                         f"(axes: {_names(mesh)})")
    fs = stack_sharding(mesh, None, date_axis, asset_axis)
    ps = panel_sharding(mesh, date_axis, asset_axis)
    frs = Placement(mesh, (date_axis, None))
    return (fs, ps, frs, ps, ps, ps)


def _same_grid(a, b) -> bool:
    return (a is b or (_names(a) == _names(b)
                       and tuple(a.shape) == tuple(b.shape)
                       and torch.equal(a.mesh.cpu(), b.mesh.cpu())))


class _AssetLayout:
    """The asset-sharded step's stages on this rank's blocks (module
    docs); the active plan decides the rows each stage forms. The factor
    stack is this rank's ``[F, D/d, N/s]`` block, the panels its ``[D/d,
    N/s]`` blocks. ``shapes_only``: the chooser's form, on ``meta``
    tensors: the same collectives on the same shapes, the compute replaced
    by empty results of its output shapes."""

    def __init__(self, mesh, date_axis, asset_axis, shapes_only=False):
        self.mesh, self.da, self.aa = mesh, date_axis, asset_axis
        self.shapes_only = shapes_only
        # the stage whose rows the blend's signal lies on
        self.sig_stage = "ops/quantile"

    def _dates(self, block) -> int:
        return block.shape[-2] * axis_size(self.mesh, self.da)

    def stats(self, factors, returns, *, shift_periods, universe, stats):
        """:func:`daily_factor_stats` of this rank's rows, the ``[D, F]``
        tables gathered to every rank. The shift reads earlier dates of
        each asset: the stack block is shifted along the date blocks
        (``_asset_backtest.block_masked_shift``: each date block's last
        ``shift_periods`` present values a name come from the blocks
        before) before it forms rows."""
        n, st = self._dates(returns), "metrics/rank_ic"
        with obs_stage("selection/daily_stats"):
            xs = factors
            if shift_periods:
                present = (torch.ones_like(returns, dtype=torch.bool)
                           if universe is None else universe)
                xs = block_masked_shift(
                    xs, present, shift_periods, self.mesh,
                    () if self.da is None else (self.da,))
            rows = hint(xs, st, batch_dim=1, batch_axis=self.da)
            panel = (returns[None] if universe is None else
                     torch.stack([returns, universe.to(returns.dtype)]))
            prow = hint(panel, st, batch_dim=1, batch_axis=self.da)
            p = active_plan()
            if self.shapes_only:
                blk = _stats_like(rows, stats)
            else:
                blk = daily_factor_stats(
                    rows, prow[0], shift_periods=0,
                    universe=None if universe is None else prow[1] > 0,
                    stats=stats)
            return _tables(blk, returns.dtype, lambda t: p.gather_rows(
                t, st, n, dim=2, batch_axis=self.da))

    def blend(self, factors, names, selection, *, method, universe,
              group_tilt=None):
        """The blend of this rank's rows (``selection [..., D, F]``, lanes
        leading): the stack's (and universe's) rows formed under
        ``ops/quantile``, the rank transform's under ``ops/rank`` (module
        docs of ``ops/_assetspec.py``); the signal stays on its rows
        (:attr:`sig_stage`)."""
        q, r = "ops/quantile", "ops/rank"
        n, p = selection.shape[-2], active_plan()
        stack = (factors if universe is None else
                 torch.cat([factors, universe[None].to(factors.dtype)]))
        rows = hint(stack, q, batch_dim=1, batch_axis=self.da)
        fr, ur = ((rows, None) if universe is None
                  else (rows[:-1], rows[-1] > 0))
        span = p.row_span(q, n, self.da)
        self.sig_stage, hook = q, None
        if method == "rank":
            self.sig_stage = r

            def hook(proxies, uni, sel):
                def move(x):
                    return p.relayout(x, q, r, n, batch_axis=self.da)

                return (move(proxies),
                        None if uni is None else move(
                            uni.to(proxies.dtype)) > 0,
                        selection[..., p.row_span(r, n, self.da), :])
        if self.shapes_only:
            sig = fr[0]
            if hook is not None:
                sig = hook(fr, ur, None)[0][0]
            return sig
        return composite_weighted(fr, names, selection[..., span, :],
                                  method=method, universe=ur,
                                  group_tilt=group_tilt, rank_rows=hook)

    def simulate(self, signal, returns, cap_flag, investability, universe,
                 sim_kwargs):
        """The backtest of the blend's rows on the panel blocks
        (``parallel/_asset_backtest.py``), and the signal as this rank's
        block."""
        p = active_plan()
        sim = sharded_simulation(p, self.da, signal, self.sig_stage,
                                 returns, cap_flag, investability, universe,
                                 sim_kwargs, shapes_only=self.shapes_only)
        with obs_stage("composite/blend"):
            block = p.to_block(signal, self.sig_stage, self._dates(returns),
                               batch_axis=self.da)
        return sim, block


def _stats_like(rows, stats) -> dict:
    """Empty ``[F, rows]`` tables of the keys and dtypes
    :func:`daily_factor_stats` returns for ``stats`` (read off a one-row
    run on the CPU)."""
    probe = daily_factor_stats(torch.zeros(1, 1, 2, dtype=rows.dtype),
                               torch.zeros(1, 2, dtype=rows.dtype),
                               shift_periods=0, stats=stats)
    return {k: torch.empty(rows.shape[:2], dtype=v.dtype, device=rows.device)
            for k, v in probe.items()}


def _gather_inputs(in_shardings, blocks, full: bool) -> list:
    """The step's inputs as its stages take them: ``factor_ret`` whole,
    the stack and the panels this rank's blocks (everything whole when
    ``full``)."""
    with obs_stage("parallel/inputs"):
        return [b if b is None or (i != 2 and not full) else p.gather(b)
                for i, (b, p) in enumerate(zip(blocks, in_shardings))]


def _resolve_date_axis(mesh, date_axis):
    if date_axis == "auto":
        return "date" if "date" in _names(mesh) else None
    return date_axis


def make_asset_sharded_research_step(mesh, *, names, window: int,
                                     select_method: str = "icir_top",
                                     select_kwargs=None,
                                     blend_method: str = "zscore",
                                     sim_kwargs=None,
                                     date_axis: str | None = "auto",
                                     asset_axis: str = ASSET_AXIS,
                                     plan: AssetSpecPlan | None = None,
                                     collect_counters: bool | None = None,
                                     collect_probes: bool | None = None):
    """The research step over an asset-carrying mesh (module docs).

    Returns ``(step, shard_inputs)`` as
    :func:`~.pipeline.make_sharded_research_step` does, with the asset
    axis on every ``[..., N]`` operand and ``plan`` (an
    :class:`AssetSpecPlan`, typically :func:`choose_asset_specs`' winner;
    None is every stage ``auto``) installed for each call.
    ``date_axis="auto"`` uses the mesh's ``"date"`` axis when it has one.
    The step's ``signal`` and ``sim.weights`` are this rank's ``[D/d,
    N/s]`` blocks (its other outputs whole); it carries ``.mesh``,
    ``.declared_in_shardings``, ``.plan`` and ``.gather_outputs(out)``,
    which gathers those two whole on every rank."""
    date_axis = _resolve_date_axis(mesh, date_axis)
    if plan is None:
        plan = AssetSpecPlan(mesh, axis=asset_axis)
    if not _same_grid(plan.mesh, mesh):
        # the plan's collectives run on PLAN.mesh's groups, so a plan
        # chosen on another rank grid would move data on the wrong one
        raise ValueError(
            f"plan was chosen on a different mesh (axes "
            f"{_names(plan.mesh)}, grid {tuple(plan.mesh.shape)}) than the "
            f"step mesh (axes {_names(mesh)}, grid {tuple(mesh.shape)}); "
            f"re-run choose_asset_specs on this mesh")
    if plan.axis != asset_axis:
        raise ValueError(f"plan shards assets over {plan.axis!r}, the step "
                         f"over {asset_axis!r}")
    in_shardings = asset_in_shardings(mesh, date_axis, asset_axis)
    record_stage("parallel/asset_shard", kind="stage",
                 mesh_shape=_shape(mesh), factors=len(tuple(names)),
                 window=window, select_method=select_method,
                 blend_method=blend_method, spec_plan=plan.spec_table())
    if collect_counters is None:
        collect_counters = obs_counters.counters_enabled()
    if collect_probes is None:
        collect_probes = obs_probes.probes_enabled()
    full = bool(collect_counters or collect_probes)
    layout = _AssetLayout(mesh, date_axis, asset_axis)
    run = _make_run(names=names, window=window, select_method=select_method,
                    select_kwargs=select_kwargs, blend_method=blend_method,
                    sim_kwargs=sim_kwargs, collect_counters=collect_counters,
                    collect_probes=collect_probes, probe_canary=None,
                    fault_spec=None, policy=None,
                    stats_fn=None if full else layout.stats,
                    blend_fn=None if full else layout.blend,
                    sim_fn=None if full else layout.simulate)
    dev = mesh_device(mesh)
    panels = in_shardings[1]

    def step(*blocks):
        check_device(dev, *blocks)
        inputs = _gather_inputs(in_shardings, blocks, full)
        with install_plan(plan):
            out = run(*inputs)
        if full:
            out = out._replace(signal=panels.block(out.signal),
                               sim=out.sim._replace(
                                   weights=panels.block(out.sim.weights)))
        return out

    def gather_outputs(out):
        return out._replace(signal=panels.gather(out.signal),
                            sim=out.sim._replace(
                                weights=panels.gather(out.sim.weights)))

    n_size = axis_size(mesh, asset_axis)
    d_size = axis_size(mesh, date_axis)

    def shard_inputs(factors, returns, factor_ret, cap_flag, investability,
                     universe):
        if returns.shape[-1] % n_size:
            raise ValueError(
                f"{returns.shape[-1]} assets are not divisible by the "
                f"mesh's '{asset_axis}' axis ({n_size}); pad the asset "
                f"axis (all-NaN columns, universe=False) or pick a mesh "
                f"whose asset axis divides N")
        if returns.shape[0] % d_size:
            raise ValueError(
                f"{returns.shape[0]} dates are not divisible by the "
                f"mesh's '{date_axis}' axis ({d_size}); pad the date axis "
                f"or pick a mesh whose date axis divides D")
        args = (factors, returns, factor_ret, cap_flag, investability,
                universe)
        return tuple(None if a is None else p.shard(a)
                     for a, p in zip(args, in_shardings))

    spec_table = plan.spec_table()
    jitted = instrument_jit(
        step, "parallel/asset_research_step/" + entry_point_tag(
            tuple(names), window, select_method,
            tuple(sorted((select_kwargs or {}).items())),
            blend_method, tuple(sorted((sim_kwargs or {}).items())),
            tuple(_shape(mesh).items()), date_axis, asset_axis,
            tuple(sorted(spec_table.items()))))
    jitted.mesh = mesh
    jitted.declared_in_shardings = in_shardings
    jitted.plan = plan
    jitted.gather_outputs = gather_outputs
    return jitted, shard_inputs


# ---------------------------------------------------------------- chooser


def _meta_blocks(in_shardings, shapes, dtype):
    """``meta`` tensors of this rank's block shapes: the chooser's
    candidates run on shapes alone."""
    f, d, n = shapes
    dims = ((f, d, n), (d, n), (d, f), (d, n), (d, n), (d, n))
    dtypes = (dtype,) * 5 + (torch.bool,)
    out = []
    for shape, dt, p in zip(dims, dtypes, in_shardings):
        p.check(shape)
        block = [s // axis_size(p.mesh, a) if a is not None else s
                 for s, a in zip(shape, p.dims + (None,) * len(shape))]
        out.append(torch.empty(block, dtype=dt, device="meta"))
    return out


def _stage_ops(ledger, stage: str):
    scopes = _STAGE_LEDGER_SCOPES.get(stage, (stage,))
    return [op for op in ledger.ops if op.stage in scopes]


def choose_asset_specs(mesh, *, names, window: int, shapes,
                       select_method: str = "icir_top", select_kwargs=None,
                       blend_method: str = "zscore", sim_kwargs=None,
                       date_axis: str | None = "auto",
                       asset_axis: str = ASSET_AXIS,
                       stages=ASSET_SORT_STAGES,
                       modes=_MODES, dtype=torch.float64):
    """Rank every layout mode per stage by the comms ledger's bytes and
    return ``(plan, ranking)``:

    - ``plan``: the winning :class:`AssetSpecPlan` (each stage pinned to
      its cheapest mode), ready for
      :func:`make_asset_sharded_research_step`;
    - ``ranking``: ``{stage: {"ranked": [[mode, bytes], ...] (ascending),
      "attribution": "stage" | "total", "by_axis": {axis: bytes}}}`` plus
      a ``"__total__"`` entry with each candidate's bytes.

    ``shapes`` is ``(F, D, N)``. Each candidate traces the inputs, the
    scoring, the blend and the backtest of ``sim_kwargs`` once on ``meta``
    tensors with the ledger recording only (module docs): no data moves
    and no kernel launches. Ties rank in ``modes`` order, so ``"auto"``
    wins a tie."""
    date_axis = _resolve_date_axis(mesh, date_axis)
    in_shardings = asset_in_shardings(mesh, date_axis, asset_axis)
    blocks = _meta_blocks(in_shardings, shapes, dtype)
    layout = _AssetLayout(mesh, date_axis, asset_axis, shapes_only=True)
    needs = selection_metric_needs(select_method, select_kwargs)
    ledgers: dict = {}
    for mode in modes:
        candidate = AssetSpecPlan(mesh, axis=asset_axis, default=mode)
        with obs_comms.recording(mesh, record_only=True) as ledger, \
                install_plan(candidate):
            factors, returns, factor_ret, cap, inv, universe = \
                _gather_inputs(in_shardings, blocks, False)
            # the scoring runs only for a selector that reads it, with
            # the selection's shift (rolling_selection's two dates); the blend
            # takes a [D, F] selection, factor_ret's shape
            if needs:
                with obs_stage("selection/rolling"):
                    layout.stats(factors, returns, shift_periods=2,
                                 universe=universe, stats=needs)
            with obs_stage("composite/blend"):
                signal = layout.blend(factors, names, factor_ret,
                                      method=blend_method, universe=universe)
            layout.simulate(signal, returns, cap, inv, universe,
                            dict(sim_kwargs or {}))
        ledgers[mode] = ledger

    totals = {mode: ledgers[mode].totals() for mode in modes}
    ranking: dict = {"__total__": {
        "ranked": sorted(([m, totals[m]["bytes_moved"]] for m in modes),
                         key=lambda mb: (mb[1], modes.index(mb[0]))),
        "by_axis": {m: totals[m]["by_axis"] for m in modes},
    }}
    chosen: dict = {}
    for stage in stages:
        per_mode = {m: sum(op.bytes_moved
                           for op in _stage_ops(ledgers[m], stage))
                    for m in modes}
        attribution = "stage"
        if not any(_stage_ops(ledgers[m], stage) for m in modes):
            # no site of this stage ran: judge by the whole run instead
            per_mode = {m: totals[m]["bytes_moved"] for m in modes}
            attribution = "total"
        ranked = sorted(([m, per_mode[m]] for m in modes),
                        key=lambda mb: (mb[1], modes.index(mb[0])))
        winner = ranked[0][0]
        chosen[stage] = winner
        if attribution == "stage":
            by_axis: dict = {}
            for op in _stage_ops(ledgers[winner], stage):
                by_axis[op.axis] = by_axis.get(op.axis, 0.0) + op.bytes_moved
        else:
            by_axis = totals[winner]["by_axis"]
        ranking[stage] = {"ranked": ranked, "attribution": attribution,
                          "by_axis": by_axis}
    return AssetSpecPlan(mesh, axis=asset_axis, modes=chosen), ranking


def record_spec_choices(plan: AssetSpecPlan, ranking: dict,
                        name: str = "asset_spec") -> list[dict]:
    """Land the chooser's verdicts as ``kind="spec_choice"`` report rows
    (one per stage) on the active RunReport, and return them: the stage,
    the CHOSEN mode (the plan's, possibly a caller's override), the
    ledger's ranked ``winner``, the full ranking, and the winner's
    per-axis byte split, in the JAX package's schema."""
    rows = []
    for stage, entry in ranking.items():
        if stage == "__total__":
            continue
        ranked = entry["ranked"]
        fields = dict(kind="spec_choice", stage=stage,
                      chosen=plan.mode_for(stage), winner=ranked[0][0],
                      ranked=ranked, attribution=entry.get("attribution"),
                      by_axis=entry.get("by_axis"),
                      mesh_shape=_shape(plan.mesh))
        record_stage(f"{name}/{stage}", **fields)
        rows.append({"name": f"{name}/{stage}", **fields})
    return rows
