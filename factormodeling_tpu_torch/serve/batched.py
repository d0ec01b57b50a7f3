"""The batched tenant step: one market, a batch of tenant configurations
(port of ``factormodeling_tpu/serve/batched.py``).

- The config-independent prefix is built once per dispatch: the selection
  metric context (the rank-IC / ICIR rolling metrics over the ``[F, D, N]``
  stack, K1 on the card) depends on the market alone, so
  :func:`~factormodeling_tpu_torch.selection.build_selection_context` runs
  once however many tenants the batch holds, as the JAX package hoists it
  out of its vmap.
- The tenant body runs once per dispatch on every lane at once, what the
  JAX package's vmap computes: the traced top-k mask ``rank_of < k`` over
  the ICIR scores (``[C]`` knobs), the manager-mix split, the group-tilted
  blend (``[C, D, F]`` selections), the simulation under ``[C]`` settings
  knobs (``backtest.engine``'s lanes; for ``mvo_turnover`` one day loop
  for the bucket, K2 launched once a segment a date for all its lanes),
  the summary. Every lane computes the bits of its own single-tenant
  step, which is the same code on one lane.

The batched step returns a
:class:`~factormodeling_tpu_torch.parallel.ResearchOutput` whose leaves
carry the leading config axis ``C``, as the JAX package's does; a
``lanes=k`` call computes the first ``k`` lanes only and fills the rest
with lane ``k-1``'s output, which is what computing them would give when
they repeat that lane's config (the front end's pad lanes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from factormodeling_tpu_torch.backtest.engine import run_simulation
from factormodeling_tpu_torch.backtest.settings import (LANE_KNOBS,
                                                        SimulationSettings,
                                                        lane_knobs)
from factormodeling_tpu_torch.composite import composite_weighted
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.parallel.pipeline import (ResearchOutput,
                                                        result_summary)
from factormodeling_tpu_torch.selection import (FACTOR_SELECTION_METHODS,
                                                build_selection_context,
                                                finalize_selection,
                                                selection_metric_needs)
from factormodeling_tpu_torch.serve.tenant import _VALUE_LEAVES, TenantConfig

__all__ = ["make_tenant_research_step", "make_batched_research_step",
           "make_sharded_batched_step", "tenant_step_parts"]


def _host(v, dtype) -> np.ndarray:
    """A value leaf as a host array of ``dtype``."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=dtype)


def _num(v):
    """A value leaf as a Python number."""
    return _host(v, None).item()


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equal-structured trees of NamedTuples
    (the step's outputs), tuples and lists; ``None`` stays ``None``."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_lane(out, lane: int):
    """Lane ``lane`` of a tree whose leaves carry a leading lane axis."""
    return _tree_map(lambda a: a[lane], out)


def _stack(outs, device):
    """Stack per-lane trees into one tree of ``[C, ...]`` tensors (Python
    scalar leaves become a ``[C]`` tensor on ``device``)."""
    def stack(*xs):
        if all(isinstance(x, torch.Tensor) for x in xs):
            return torch.stack(xs)
        return torch.as_tensor(np.asarray([_num(x) for x in xs]),
                               device=device)
    return _tree_map(stack, *outs)


def _config_lanes(stacked: TenantConfig, lanes) -> TenantConfig:
    """The lanes ``lanes`` (an index or a slice) of a
    :func:`~.tenant.stack_configs` batch."""
    return dataclasses.replace(stacked, **{
        name: getattr(stacked, name)[lanes] for name in _VALUE_LEAVES
        if getattr(stacked, name) is not None})


def one_lane(tenant: TenantConfig) -> TenantConfig:
    """A single config as a batch of one lane (every value leaf gains the
    leading axis)."""
    return dataclasses.replace(tenant, **{
        name: _host(getattr(tenant, name), None)[None]
        for name in _VALUE_LEAVES if getattr(tenant, name) is not None})


def lane_count(tenants: TenantConfig) -> int:
    """The lanes of a stacked batch."""
    return int(np.shape(tenants.top_k)[0])


def _context_lane(ctx, lane: int):
    """Lane ``lane`` of a context whose tensors carry a lane axis."""
    return dataclasses.replace(
        ctx, metrics_win={k: v[lane] for k, v in ctx.metrics_win.items()},
        factor_ret=ctx.factor_ret[lane], ret_win_sum=ctx.ret_win_sum[lane])


def tenant_step_parts(names, template: TenantConfig):
    """The tenant step's two halves: ``(build_ctx, tenant_body)``, where
    ``build_ctx(factors, returns, factor_ret, universe)`` builds the
    selection metric context from the market panels and
    ``tenant_body(tenants, ctx, factors, returns, cap_flag, investability,
    universe, policy=None)`` runs selector -> mix -> blend -> simulation ->
    summary against it for a :func:`~.tenant.stack_configs` batch of ``C``
    lanes (:func:`one_lane` makes one config a batch), every lane at once:
    the outputs carry the leading ``C``. The context and the panels are
    shared (unbatched) or carry the lane axis too (``[C, ...]``: one
    market view a lane, the scenario engine's paths).

    With ``policy`` (a
    :class:`~factormodeling_tpu_torch.resil.policy.DegradePolicy`) the
    composite is absmax-clamped after the blend and the simulation runs
    with the policy's hold and carry guards; ``policy=None`` (every
    serving caller) runs none of that.

    ``tenant_body`` is the composition of its two halves, which it carries
    as attributes: ``tenant_body.prefix(tenant, ctx, factors, universe,
    policy=None) -> (selection, signal)`` (selector, mix, blend, clamp) and
    ``tenant_body.simulate(tenant, selection, signal, returns, cap_flag,
    investability, universe, policy=None)`` (simulation and summary), so a
    caller whose paths share the factors and the context runs the prefix
    once (the scenario engine's regime family)."""
    return _make_parts(names, template)


def _make_parts(names, template: TenantConfig, layout=None):
    """The tenant step's halves (:func:`tenant_step_parts`); ``layout``
    (``parallel/asset_shard._AssetLayout``) runs the scoring, the blend
    and the simulation on asset-sharded panel blocks under the active
    plan, the simulation's signal and weights coming back as this rank's
    blocks."""
    names = tuple(names)
    window = template.window
    select_method = template.select_method
    select_static = dict(template.select_static)
    if select_method == "icir_top":
        # the value leaves own these; a static copy in select_static would
        # pin every tenant to one value
        for k in ("top_x", "icir_threshold", "use_rank_icir"):
            if k in select_static:
                raise ValueError(
                    f"select_static[{k!r}] shadows the traced icir_top "
                    f"knobs (top_k / icir_threshold) or the static "
                    f"use_rank_icir field")
        select_static["use_rank_icir"] = template.use_rank_icir
    selector = FACTOR_SELECTION_METHODS.get(select_method)
    if selector is None:
        raise ValueError(f"Unknown factor selection method: {select_method}")
    needs = selection_metric_needs(select_method, select_static)
    sim_static = dict(template.sim_static)

    def build_ctx(factors, returns, factor_ret, universe):
        if window >= factor_ret.shape[0]:
            raise ValueError(
                f"window {window} >= {factor_ret.shape[0]} dates: the "
                f"processed range is empty, nothing to serve")
        with obs_stage("serve/context"):
            return build_selection_context(
                factors, returns, factor_ret, window, universe=universe,
                stats=needs, stats_fn=None if layout is None else
                layout.stats)

    def prefix(t: TenantConfig, ctx, factors, universe, policy=None):
        c = lane_count(t)
        dev = factors.device
        kwargs = dict(select_static)
        if select_method == "icir_top":
            kwargs.update(
                top_x=torch.as_tensor(_host(t.top_k, np.int64), device=dev),
                icir_threshold=torch.as_tensor(_host(t.icir_threshold,
                                                     np.float64),
                                               device=dev))
        with obs_stage("serve/selection"):
            if select_method == "icir_top" or ctx.factor_ret.ndim == 2:
                raw = selector(ctx, **kwargs)  # [C, D, F] or shared [D, F]
            else:   # a selector over one context a lane
                raw = torch.stack([selector(_context_lane(ctx, i), **kwargs)
                                   for i in range(c)])
            if raw.ndim == 2:
                raw = raw.expand(c, *raw.shape)
            if t.manager_mix is not None:
                # capital splits among the day's selected factors by the
                # tenant's mix; finalize_selection renormalizes the rows
                raw = raw * torch.as_tensor(_host(t.manager_mix, None),
                                            dtype=raw.dtype,
                                            device=dev)[:, None, :]
            sel = finalize_selection(raw, window)
        with obs_stage("serve/blend"):
            blend = composite_weighted if layout is None else layout.blend
            signal = blend(factors, names, sel, method=template.blend_method,
                           universe=universe, group_tilt=t.blend_tilt)
        if policy is not None:
            from factormodeling_tpu_torch.resil import policy as resil_policy

            with obs_stage("resil/clamp"):
                signal, _, _ = resil_policy.clamp_signal(signal, policy)
        return sel, signal

    def simulate(t: TenantConfig, sel, signal, returns, cap_flag,
                 investability, universe, policy=None) -> ResearchOutput:
        knobs = lane_knobs({name: _host(getattr(t, name), np.float64)
                            for name in LANE_KNOBS}, signal.device)
        sim_kwargs = dict(method=template.method,
                          lookback_period=template.lookback_period,
                          degrade=policy, **knobs, **sim_static)
        if layout is not None:
            sim, signal = layout.simulate(signal, returns, cap_flag,
                                          investability, universe,
                                          sim_kwargs)
        else:
            sim = run_simulation(signal, SimulationSettings(
                returns=returns, cap_flag=cap_flag,
                investability_flag=investability, universe=universe,
                **sim_kwargs))
        with obs_stage("pipeline/summary"):
            summary = result_summary(sim.result)
        return ResearchOutput(selection=sel, signal=signal, sim=sim,
                              summary=summary)

    def tenant_body(t: TenantConfig, ctx, factors, returns, cap_flag,
                    investability, universe, policy=None) -> ResearchOutput:
        sel, signal = prefix(t, ctx, factors, universe, policy=policy)
        return simulate(t, sel, signal, returns, cap_flag, investability,
                        universe, policy=policy)

    tenant_body.prefix, tenant_body.simulate = prefix, simulate
    return build_ctx, tenant_body


def make_tenant_research_step(*, names, template: TenantConfig):
    """Single-config counterpart of the batched step:
    ``step(tenant, factors, returns, factor_ret, cap_flag, investability,
    universe=None)`` for any config of the template's signature bucket,
    the tenant's knobs read from its value leaves: the tenant body on one
    lane, so a lane of the batched step and this step run the same
    lines."""
    build_ctx, tenant_body = _make_parts(names, template)

    def step(tenant, factors, returns, factor_ret, cap_flag, investability,
             universe=None) -> ResearchOutput:
        ctx = build_ctx(factors, returns, factor_ret, universe)
        return tree_lane(tenant_body(one_lane(tenant), ctx, factors, returns,
                                     cap_flag, investability, universe), 0)

    return step


def _lanes_call(build_ctx, tenant_body, tenants, factors, returns,
                factor_ret, cap_flag, investability, universe, lanes):
    c = lane_count(tenants)
    k = c if lanes is None else int(lanes)
    if not 1 <= k <= c:
        raise ValueError(f"lanes must be in [1, {c}], got {lanes}")
    ctx = build_ctx(factors, returns, factor_ret, universe)
    with obs_stage("serve/tenants"):
        out = tenant_body(_config_lanes(tenants, slice(0, k)), ctx,
                          factors, returns, cap_flag, investability,
                          universe)
    if k == c:
        return out
    return _tree_map(lambda a: torch.cat(
        [a, a[k - 1:k].expand((c - k,) + a.shape[1:])]), out)


def make_batched_research_step(*, names, template: TenantConfig):
    """The batched step: ``step(tenants, factors, returns, factor_ret,
    cap_flag, investability, universe=None, *, lanes=None)`` where
    ``tenants`` is a :func:`~factormodeling_tpu_torch.serve.stack_configs`
    batch (every value leaf with a leading ``C`` axis) and the panels are
    shared. Returns a
    :class:`~factormodeling_tpu_torch.parallel.ResearchOutput` whose leaves
    carry the config axis: ``selection [C, D, F]``, ``signal [C, D, N]``,
    the stacked simulation outputs and summaries.

    The selection metric context is built once per call and the tenant
    body runs once on the computed lanes (module docs). ``lanes``: compute
    the first ``lanes`` lanes only; the rest repeat lane ``lanes - 1``'s
    output."""
    build_ctx, tenant_body = _make_parts(names, template)

    def step(tenants, factors, returns, factor_ret, cap_flag, investability,
             universe=None, *, lanes=None) -> ResearchOutput:
        return _lanes_call(build_ctx, tenant_body, tenants, factors, returns,
                           factor_ret, cap_flag, investability, universe,
                           lanes)

    return step


def make_sharded_batched_step(*, names, template: TenantConfig, mesh,
                              asset_axis: str = "assets"):
    """The batched step on asset-sharded panels: the same call as
    :func:`make_batched_research_step`'s, its ``[..., N]`` panels this
    rank's blocks along ``asset_axis`` of ``mesh`` (``factor_ret`` whole).
    The scoring, the blend and the simulation run under an
    ``AssetSpecPlan`` with every stage ``auto`` (``ops/_assetspec.py``:
    each stage forms its rows from the blocks, the layout the JAX server
    gets from its partitioner with no plan installed); the outputs'
    ``signal`` and ``sim.weights`` are this rank's ``[C, D, N/s]``
    blocks, the rest whole."""
    from factormodeling_tpu_torch.ops._assetspec import (AssetSpecPlan,
                                                         plan as install)
    from factormodeling_tpu_torch.parallel.asset_shard import _AssetLayout

    layout = _AssetLayout(mesh, None, asset_axis)
    plan = AssetSpecPlan(mesh, axis=asset_axis)
    build_ctx, tenant_body = _make_parts(names, template, layout)

    def step(tenants, factors, returns, factor_ret, cap_flag, investability,
             universe=None, *, lanes=None) -> ResearchOutput:
        with install(plan):
            return _lanes_call(build_ctx, tenant_body, tenants, factors,
                               returns, factor_ret, cap_flag, investability,
                               universe, lanes)

    return step
