"""The batched tenant step: one market, a batch of tenant configurations
(port of ``factormodeling_tpu/serve/batched.py``).

- The config-independent prefix is built once per dispatch: the selection
  metric context (the rank-IC / ICIR rolling metrics over the ``[F, D, N]``
  stack, K1 on the card) depends on the market alone, so
  :func:`~factormodeling_tpu_torch.selection.build_selection_context` runs
  once however many tenants the batch holds, as the JAX package hoists it
  out of its vmap.
- The tenant body runs once per lane: the top-k mask over the ICIR
  scores, the manager-mix split, the group-tilted blend, the simulation
  under the tenant's settings, the summary. The JAX package vmaps it; the
  port's backtest is a Python loop over dates, which no vmap reaches, so
  the body loops over the lanes (for ``mvo_turnover``, K2 launches once a
  segment a date a tenant).

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
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
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
           "tenant_step_parts"]


def _num(v):
    """A value leaf as a Python number."""
    if isinstance(v, torch.Tensor):
        return v.item()
    return np.asarray(v).item()


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


def _config_lane(stacked: TenantConfig, lane: int) -> TenantConfig:
    """Lane ``lane`` of a :func:`~.tenant.stack_configs` batch."""
    return dataclasses.replace(stacked, **{
        name: getattr(stacked, name)[lane] for name in _VALUE_LEAVES
        if getattr(stacked, name) is not None})


def tenant_step_parts(names, template: TenantConfig):
    """The tenant step's two halves: ``(build_ctx, tenant_body)``, where
    ``build_ctx(factors, returns, factor_ret, universe)`` builds the
    selection metric context from the market panels and
    ``tenant_body(tenant, ctx, factors, returns, cap_flag, investability,
    universe, policy=None)`` runs selector -> mix -> blend -> simulation ->
    summary for one tenant against it.

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


def _make_parts(names, template: TenantConfig):
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
            return build_selection_context(factors, returns, factor_ret,
                                           window, universe=universe,
                                           stats=needs)

    def prefix(t: TenantConfig, ctx, factors, universe, policy=None):
        kwargs = dict(select_static)
        if select_method == "icir_top":
            kwargs.update(top_x=int(_num(t.top_k)),
                          icir_threshold=_num(t.icir_threshold))
        with obs_stage("serve/selection"):
            raw = selector(ctx, **kwargs)  # [D, F]
            if t.manager_mix is not None:
                # capital splits among the day's selected factors by the
                # tenant's mix; finalize_selection renormalizes the rows
                raw = raw * torch.as_tensor(t.manager_mix, dtype=raw.dtype,
                                            device=raw.device)[None, :]
            sel = finalize_selection(raw, window)
        with obs_stage("serve/blend"):
            signal = composite_weighted(factors, names, sel,
                                        method=template.blend_method,
                                        universe=universe,
                                        group_tilt=t.blend_tilt)
        if policy is not None:
            from factormodeling_tpu_torch.resil import policy as resil_policy

            with obs_stage("resil/clamp"):
                signal, _, _ = resil_policy.clamp_signal(signal, policy)
        return sel, signal

    def simulate(t: TenantConfig, sel, signal, returns, cap_flag,
                 investability, universe, policy=None) -> ResearchOutput:
        settings = SimulationSettings(
            returns=returns, cap_flag=cap_flag,
            investability_flag=investability, universe=universe,
            method=template.method, lookback_period=template.lookback_period,
            max_weight=_num(t.max_weight), pct=_num(t.pct),
            shrinkage_intensity=_num(t.shrinkage_intensity),
            turnover_penalty=_num(t.turnover_penalty),
            return_weight=_num(t.return_weight),
            tcost_scale=_num(t.tcost_scale), degrade=policy, **sim_static)
        sim = run_simulation(signal, settings)
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
    the tenant's knobs read from its value leaves."""
    build_ctx, tenant_body = _make_parts(names, template)

    def step(tenant, factors, returns, factor_ret, cap_flag, investability,
             universe=None) -> ResearchOutput:
        ctx = build_ctx(factors, returns, factor_ret, universe)
        return tenant_body(tenant, ctx, factors, returns, cap_flag,
                           investability, universe)

    return step


def make_batched_research_step(*, names, template: TenantConfig):
    """The batched step: ``step(tenants, factors, returns, factor_ret,
    cap_flag, investability, universe=None, *, lanes=None)`` where
    ``tenants`` is a :func:`~factormodeling_tpu_torch.serve.stack_configs`
    batch (every value leaf with a leading ``C`` axis) and the panels are
    shared. Returns a
    :class:`~factormodeling_tpu_torch.parallel.ResearchOutput` whose leaves
    carry the config axis: ``selection [C, D, F]``, ``signal [C, D, N]``,
    the stacked simulation outputs and summaries.

    The selection metric context is built once per call, outside the
    lane loop (module docs). ``lanes``: compute the first ``lanes`` lanes
    only; the rest repeat lane ``lanes - 1``'s output."""
    build_ctx, tenant_body = _make_parts(names, template)

    def step(tenants, factors, returns, factor_ret, cap_flag, investability,
             universe=None, *, lanes=None) -> ResearchOutput:
        c = int(np.shape(tenants.top_k)[0])
        k = c if lanes is None else int(lanes)
        if not 1 <= k <= c:
            raise ValueError(f"lanes must be in [1, {c}], got {lanes}")
        ctx = build_ctx(factors, returns, factor_ret, universe)
        with obs_stage("serve/tenants"):
            outs = [tenant_body(_config_lane(tenants, i), ctx, factors,
                                returns, cap_flag, investability, universe)
                    for i in range(k)]
        return _stack(outs + [outs[-1]] * (c - k), factors.device)

    return step
