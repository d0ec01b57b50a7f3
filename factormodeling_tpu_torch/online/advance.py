"""The incremental research step: O(window) work per arriving date (port of
``factormodeling_tpu/online/advance.py``).

``online_step_parts`` builds the two halves of a per-date advance:

- ``advance_market(mstate, date_slice)``: push the date into the raw tail
  rings, compute THAT date's daily factor stats on the tail (one
  ``[F, T, N]`` pass, ``T = stats_tail``: the rank-IC post-sort kernel runs
  on ``F * T`` rows), push the stat columns and the factor-return row into
  the window rings, rebuild the ring-shaped selection context, and under
  ``covariance="risk_model"`` refit the risk model on its refit grid;
- ``advance_tenant(tenant, tstate, octx)``: selector -> manager mix ->
  finalize -> single-date blend -> the day's weight solve (the full step's
  own ``backtest.mvo._solve_day``, so the segment kernel runs once a
  segment a date for the QP schemes) -> per-symbol masked weight shift ->
  single-date P&L. ``advance_tenant.lanes(tenants, tstates, octx)`` is the
  same half for a session's ``C`` tenants at once (a stacked config batch
  and stacked states, ``state.stack_tenant_states``): one lane-batched
  solve of ``C`` lanes a date, what the JAX package's vmap of the tenant
  half computes; ``advance_tenant`` is it on one lane, so a session's
  lane and a single tenant's advance run the same lines.

The contract: feeding dates 0..D-1 one at a time gives the full research
step's rows 0..D-2. The mechanism is structural: every windowed aggregate
is computed by the port's own primitives (``rolling_sum``,
``rolling_metrics``, ``masked_shift``, the selectors, the blend, the day
solve) over a ring slice LONGER than its window, and ramp-up padding is
NaN/False, whose contribution to every NaN-aware reducer is exactly the
full step's edge padding. The rings keep their margin for the JAX
package's reason: there, a windowed reduction's output depends only on the
window's contents when the slice exceeds the window, and an exact-length
slice is not safe. On the CPU the port's rolling sum (``unfold(...).sum``)
sums each window in an order set by the window alone. On the card a
reduction's split can depend on how many outputs there are, so the tail
ring and the full panel may part in the last bit there; ``chip_smoke.py``
measures it.

The limits, each the ring horizon the O(window) claim buys (the JAX
module's list): a per-symbol universe gap longer than ``stats_tail -
shift_periods - 1`` reaches past the tail ring; NaN-thinned suffix pools in
the blend flip quantile-boundary cells between compiled shapes of the
blend itself (``[F, 1, N]`` against ``[F, D, N]``), so bitwise cases pin at
seeds without such pools; the history must reach ``lookback_period``
(``risk_lookback`` under the risk model) and ``mvo_batch``; and
``mvo_turnover`` advances with the sequential scan's semantics.

The stages: the advance opens the JAX package's seven ``obs.stage`` names
(:data:`ONLINE_STAGES`), around the same work and in its order:
``online/ingest`` (the ring pushes), ``online/daily_stats``,
``online/context`` (the rolling metrics and the selection context),
``online/selection``, ``online/blend``, ``online/solve`` and
``online/shift_pnl``; the risk refit runs outside any stage, as there. The
comms ledger and the device-time attribution charge to the outermost
known stage, so the advance's collectives and kernels land under them.

Over an asset mesh (``mesh=``): the state is this rank's blocks
(``state.shard_online_state``; the JAX package's leaf rule) and so is the
arriving date (``state.shard_date_slice``). Each cross-sectional stage
forms its rows through the asset-sharded step's layout plan
(``ops/_assetspec.py``; ``plan=None`` is every stage ``auto``):
``online/daily_stats`` scores the ``[F, T, N/s]`` tail's rows under
``metrics/rank_ic`` (the tail's ``T`` dates the batch dim; the masked
shift runs along ``T``, which every rank holds) and gathers the ``[F,
T]`` tables to every rank (``parallel.asset_shard._AssetLayout.stats``);
``online/context`` and ``online/selection`` run replicated; the
covariance ring's columns are gathered once a date in ``online/ingest``
for the risk refit and the solve, and the refit's model is held by the
leaf rule; ``online/blend`` forms the date's row under ``ops/quantile``
(``ops/rank``) and hands the signal back as this rank's block
(``_AssetLayout.blend``); ``online/solve`` forms the lanes' rows (the
session's ``C`` lanes are the batch dim) under ``backtest/weights``
(equal, linear) or ``solver/iterates`` (the QP schemes, with the warm
states' ``[C, N/s]`` leaves, the universe and the idiosyncratic
variances in the same collective), solves them and returns the weights,
the book and the warm states as blocks; ``online/shift_pnl`` keeps every
per-name carry as blocks and sums the day's P&L and leg turnovers from
the blocks' partial sums over the asset axis (one ``all_reduce``, so the
scalars may part from the unsharded advance's in the last bits; the rows
are bitwise). A row count the asset axis does not divide (the blend's one
date; ``C`` lanes) takes ``auto``'s layout under ``reshard``. The
advance's ``signal`` and ``weights`` are this rank's ``[C, N/s]`` blocks,
its other outputs whole: the convention of
``make_asset_sharded_research_step``'s outputs
(:func:`gather_advance_outputs` puts them together). With ``mesh=None`` the
advance issues no collective.

The window solve: the full step's ``_solve_day`` is lane-batched over
``returns0`` and the dates' indices. Here it gets one lane a tenant, the
NaN-zeroed lookback ring as ``returns0`` and ``today = min(p, lookback)``:
its window of at most ``lookback`` rows strictly before ``today`` is then
the ring's first ``min(p, lookback)`` rows, the rows the full panel's
window holds at date ``p``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch import risk as _risk
from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.backtest.mvo import QP_DTYPE, _solve_day
from factormodeling_tpu_torch.backtest.settings import (LANE_KNOBS,
                                                        SimulationSettings,
                                                        knob, lane_knobs)
from factormodeling_tpu_torch.backtest.weights import (equal_weights,
                                                       leg_masks,
                                                       linear_weights)
from factormodeling_tpu_torch.composite.blend import composite_weighted
from factormodeling_tpu_torch.metrics.factor_metrics import (
    daily_factor_stats, rolling_metrics)
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.online.state import (AdvanceOutputs, DateSlice,
                                                   MarketState, TenantState,
                                                   check_asset_divisible,
                                                   init_market_state,
                                                   init_tenant_state,
                                                   shard_date_slice,
                                                   shard_online_state,
                                                   stack_tenant_states,
                                                   tenant_state_lane)
from factormodeling_tpu_torch.ops._window import shift
from factormodeling_tpu_torch.parallel.mesh import mesh_device
from factormodeling_tpu_torch.selection.driver import (
    finish_selection_context, selection_metric_needs)
from factormodeling_tpu_torch.selection.selectors import (
    FACTOR_SELECTION_METHODS, SelectionContext)
from factormodeling_tpu_torch.serve.batched import (_config_lanes, _host,
                                                   lane_count, one_lane)
from factormodeling_tpu_torch.serve.tenant import TenantConfig
from factormodeling_tpu_torch.solvers.admm_qp import ADMMWarmState

__all__ = ["ONLINE_STAGES", "OnlineCtx", "gather_advance_outputs",
           "lane_outputs", "make_online_step", "online_step_parts"]

#: exposure lag of the selection path (the reference shifts twice)
_SHIFT = 2

#: the stages one ready advance opens, in order: the JAX package's
#: (``factormodeling_tpu/online/advance.py``)
ONLINE_STAGES = ("online/ingest", "online/daily_stats", "online/context",
                 "online/selection", "online/blend", "online/solve",
                 "online/shift_pnl")


class OnlineCtx(NamedTuple):
    """The market half's product, consumed by every tenant."""

    ctx: SelectionContext   # ring-shaped selection context
    p: int                  # the date being finalized (day - 1)
    ready: bool             # p >= 0
    factors_p: torch.Tensor  # [F, N] exposures at p
    returns_p: torch.Tensor  # [N]
    cap_p: torch.Tensor     # [N]
    invest_p: torch.Tensor  # [N]
    universe_p: Any         # bool[N] or None
    lb_ring: Any            # QP_DTYPE[LB, N] returns <= p-1 (whole on
    #                         every rank over a mesh), or None
    risk_model: Any         # day p's (loadings, fvar, idio, hist) or None


def _push(tail: torch.Tensor, row: torch.Tensor, axis: int) -> torch.Tensor:
    """Drop the oldest slot along ``axis`` and append ``row`` at the end."""
    axis = axis % tail.ndim
    return torch.cat([tail.narrow(axis, 1, tail.shape[axis] - 1),
                      row.unsqueeze(axis)], dim=axis)


def _push_left(ring: torch.Tensor, row: torch.Tensor,
               n_filled: int) -> torch.Tensor:
    """Left-aligned append: while ramping, write at ``n_filled``; once
    full, shift down and write at the top. Positions ``0..min(n, cap)-1``
    hold the most recent rows in date order, the layout the full step's
    window reads from a full panel. A new tensor: the engine's snapshots
    share the old one."""
    cap = ring.shape[0]
    if n_filled >= cap:
        return torch.cat([ring[1:], row[None]])
    out = ring.clone()
    out[n_filled] = row
    return out


def _probe_settings(template: TenantConfig) -> SimulationSettings:
    """Settings resolving the template's static simulation residue
    (mvo_batch, covariance and risk knobs, qp flags) as the full step
    would."""
    return SimulationSettings(returns=None, cap_flag=None,
                              investability_flag=None,
                              method=template.method,
                              lookback_period=template.lookback_period,
                              **dict(template.sim_static))


def online_step_parts(*, names, template: TenantConfig, n_assets: int,
                      dtype=torch.float64, has_universe: bool = False,
                      stats_tail: int = 8, device=None, mesh=None,
                      asset_axis: str = "assets", plan=None):
    """``(init_market, init_tenant, advance_market, advance_tenant)`` for
    the ``template``'s configuration on ``device`` (None is the card; the
    CPU only when asked for); ``advance_tenant.lanes`` advances a
    session's stacked lanes (module docs). ``stats_tail`` bounds the
    ragged-universe shift horizon of the daily-stats tail ring.

    ``mesh``: a ``DeviceMesh`` carrying ``asset_axis`` (the device is the
    mesh's): the state, the date slices and the ``[N]`` outputs are this
    rank's asset blocks (module docs), each stage forming its rows under
    ``plan`` (an :class:`~factormodeling_tpu_torch.ops._assetspec.
    AssetSpecPlan` on ``mesh``; None is every stage ``auto``)."""
    sharded = mesh is not None
    dev = mesh_device(mesh) if sharded else resolve_device(device)
    names = tuple(names)
    f = len(names)
    n = int(n_assets)
    window = int(template.window)
    select_method = template.select_method
    select_static = dict(template.select_static)
    if select_method == "icir_top":
        select_static["use_rank_icir"] = template.use_rank_icir
    selector = FACTOR_SELECTION_METHODS.get(select_method)
    if selector is None:
        raise ValueError(f"Unknown factor selection method: {select_method}")
    needs = tuple(selection_metric_needs(select_method, select_static))
    probe = _probe_settings(template)
    risk = probe.covariance == "risk_model"
    lb = int(probe.risk_lookback if risk else probe.lookback_period)
    tail = max(int(stats_tail), _SHIFT + 3)
    ring = window + 3
    q_p = ring - 2          # ring index of the finalized date p
    method = template.method
    warm_start = bool(probe.qp_warm_start)
    mvo_batch = int(probe.mvo_batch)
    needs_solver = method in ("mvo", "mvo_turnover")
    # the dates the full step's ladder treats as having no history
    no_hist_days = probe.risk_refit_every if risk else 1
    b_eq = torch.tensor([1.0, -1.0], dtype=QP_DTYPE, device=dev)
    rows = (_AssetRows(mesh, asset_axis, plan, n, method) if sharded
            else None)
    nb = n // rows.size if sharded else n   # the asset columns a rank holds

    def placed(state):
        return shard_online_state(state, mesh, asset_axis) if sharded \
            else state

    def init_market() -> MarketState:
        return placed(init_market_state(
            n_factors=f, n_assets=n, dtype=dtype, stats_needs=needs,
            tail=tail, ring=ring, lb=(lb if needs_solver else None),
            has_universe=has_universe,
            risk_factors=(probe.risk_factors if risk and needs_solver
                          else None), device=dev))

    def init_tenant() -> TenantState:
        return placed(init_tenant_state(
            n_assets=n, dtype=dtype, method=method,
            mvo_batch=(mvo_batch if method == "mvo" else None),
            warm_start=warm_start, device=dev))

    # --------------------------------------------------- market half

    def _refit_risk(lb_ring, p: int):
        """The risk model at refit day ``p``, fit on the (at most
        ``risk_lookback``) rows strictly before it, NaN-padded: the input
        ``backtest.mvo._risk_model_stack`` builds from the full panel."""
        n_used = min(p, lb)
        used = (torch.arange(lb, device=dev) < n_used)[:, None]
        m = _risk.statistical_risk_model(
            torch.where(used, lb_ring, float("nan")), probe.risk_factors)
        scale = (lb - 1.0) / max(n_used - 1.0, 1.0)
        return m.loadings, m.factor_var * scale, m.idio_var

    def _put(x, dt):
        return torch.as_tensor(x, device=dev).to(dt)

    def advance_market(mstate: MarketState, d: DateSlice):
        with rows.installed() if sharded else contextlib.nullcontext():
            return _advance_market(mstate, d)

    def _advance_market(mstate: MarketState, d: DateSlice):
        t = mstate.day + 1
        p = t - 1
        ready = p >= 0
        with obs_stage("online/ingest"):
            factors_tail = _push(mstate.factors_tail, _put(d.factors, dtype),
                                 -2)
            returns_tail = _push(mstate.returns_tail, _put(d.returns, dtype),
                                 0)
            cap_tail = _push(mstate.cap_tail, _put(d.cap_flag, dtype), 0)
            invest_tail = _push(mstate.invest_tail,
                                _put(d.investability, dtype), 0)
            universe_tail = None
            if has_universe:
                universe_tail = _push(mstate.universe_tail,
                                      _put(d.universe, torch.bool), 0)
            fr_ring = _push(mstate.fr_ring, _put(d.factor_ret, dtype), 0)
            # the covariance ring lags one finalization: solving date p
            # reads returns <= p-1, so each advance pushes date t-2's row
            # (at tail position -3 after this advance's push)
            lb_ring = lb_whole = mstate.lb_ring
            if lb_ring is not None and t >= 2:
                lb_ring = lb_whole = _push_left(
                    lb_ring, returns_tail[-3].to(QP_DTYPE), t - 2)
            if sharded and lb_ring is not None:
                # the refit and the solve read the window's whole rows
                lb_whole = rows.whole(lb_ring)
        stats_ring = mstate.stats_ring
        if needs:
            with obs_stage("online/daily_stats"):
                if sharded:
                    daily = rows.stats(factors_tail, returns_tail,
                                       universe_tail, needs)
                else:
                    daily = daily_factor_stats(
                        factors_tail, returns_tail, shift_periods=_SHIFT,
                        universe=universe_tail, stats=needs)
            stats_ring = {k: _push(stats_ring[k], daily[k][:, -1], -1)
                          for k in needs}

        risk_model = mstate.risk_model
        if risk_model is not None and ready \
                and p % probe.risk_refit_every == 0:
            risk_model = _refit_risk(lb_whole, p)
            if sharded:
                risk_model = (*risk_model[:2], rows.block(risk_model[2]))

        with obs_stage("online/context"):
            metrics_win = {}
            if needs:
                rm = rolling_metrics(stats_ring, max(window - 1, 1))
                metrics_win = {k: shift(v, 1, axis=-1)
                               for k, v in rm.items()}
            ctx = finish_selection_context(metrics_win, fr_ring, window)

        day_model = None
        if risk_model is not None:
            j = max(p, 0) // probe.risk_refit_every
            hist = min(j * probe.risk_refit_every, lb)
            day_model = (*risk_model, hist)

        mstate2 = MarketState(
            day=t, version=mstate.version + 1, factors_tail=factors_tail,
            returns_tail=returns_tail, cap_tail=cap_tail,
            invest_tail=invest_tail, universe_tail=universe_tail,
            stats_ring=stats_ring, fr_ring=fr_ring, lb_ring=lb_ring,
            risk_model=risk_model)
        octx = OnlineCtx(
            ctx=ctx, p=p, ready=ready, factors_p=factors_tail[:, -2, :],
            returns_p=returns_tail[-2], cap_p=cap_tail[-2],
            invest_p=invest_tail[-2],
            universe_p=universe_tail[-2] if has_universe else None,
            lb_ring=lb_whole, risk_model=day_model)
        return mstate2, octx

    # --------------------------------------------------- tenant half

    def _day_settings(t: TenantConfig, octx: OnlineCtx) -> SimulationSettings:
        knobs = lane_knobs({name: _host(getattr(t, name), np.float64)
                            for name in LANE_KNOBS}, dev)
        return dataclasses.replace(
            probe,
            returns=octx.returns_p[None], cap_flag=octx.cap_p[None],
            investability_flag=octx.invest_p[None],
            universe=(octx.universe_p[None] if has_universe else None),
            **knobs)

    def _day_weights(tstate: TenantState, octx: OnlineCtx, masked, s):
        """One date's pre-shift weight rows ``[C, N]`` through the scheme's
        per-day semantics: equal/linear are the engine's per-date calls;
        the QP schemes run ``_solve_day`` once on the ``C`` lanes with
        their carried warm states, then the per-day slice of
        ``mvo._finalize``. Returns ``(w, lc, sc, resid, ok, w_prev, warm,
        warm_ring)``; ``w_prev`` in ``QP_DTYPE``."""
        lanes = masked.shape[0]
        p_idx = max(octx.p, 0)
        pos, neg, flat = leg_masks(masked)
        nan_d = torch.full((lanes,), float("nan"), dtype=dtype, device=dev)
        true_d = torch.ones((lanes,), dtype=torch.bool, device=dev)
        if method in ("equal", "linear"):
            if method == "equal":
                w, lc, sc = equal_weights(masked[:, None], s.pct)
            else:
                w, lc, sc = linear_weights(masked[:, None], s.max_weight)
            return (w[:, 0], lc[:, 0], sc[:, 0], nan_d, true_d,
                    tstate.w_prev, tstate.warm, tstate.warm_ring)

        ucount = (octx.universe_p.sum() if has_universe
                  else torch.tensor(n, device=dev))
        zero_day = flat | (ucount < 2)
        todays = torch.full((lanes,), min(p_idx, lb), dtype=torch.int64,
                            device=dev)
        returns0 = torch.nan_to_num(octx.lb_ring)
        rm = None
        if octx.risk_model is not None:
            loadings, fvar, idio, hist = octx.risk_model
            rm = (loadings.repeat(lanes, 1, 1), fvar.repeat(lanes, 1),
                  idio.repeat(lanes, 1),
                  torch.full((lanes,), hist, dtype=torch.int64, device=dev))
        sig = masked.to(QP_DTYPE)
        may_lack = p_idx < no_hist_days
        warm, warm_ring = tstate.warm, tstate.warm_ring
        if method == "mvo":
            # the full step's chunks warm-start day t from day t - mvo_batch
            # (lane i from lane i of the chunk before): the slot ring
            slot = p_idx % mvo_batch
            warm_in = (None if warm_ring is None else ADMMWarmState(
                *(a[:, slot] for a in warm_ring)))
            w, resid, okc, state, _ = _solve_day(
                sig, returns0, todays, torch.zeros_like(sig), s, b_eq, False,
                risk_model=rm, warm=warm_in, may_lack_history=may_lack)
            if warm_ring is not None:
                warm_ring = ADMMWarmState(*(
                    torch.cat([a[:, :slot], v[:, None], a[:, slot + 1:]], 1)
                    for a, v in zip(warm_ring, state)))
        else:   # mvo_turnover, the sequential scan's day step
            nan_sig = ((torch.isnan(masked) & octx.universe_p).any(-1)
                       if has_universe
                       else torch.zeros((lanes,), dtype=torch.bool,
                                        device=dev))
            w, resid, okc, state, _ = _solve_day(
                sig, returns0, todays, tstate.w_prev, s, b_eq, True,
                risk_model=rm, warm=warm if warm_start else None,
                force_fallback=nan_sig, may_lack_history=may_lack)
            w = torch.where(zero_day[:, None], 0.0, w)
            if warm is not None:
                warm = state
        w_prev = w
        # the per-day slice of mvo._finalize: zero days, no-history k
        # counts, acceptance masking
        w = torch.where(zero_day[:, None], 0.0, w.to(dtype))
        lc, sc = pos.sum(-1), neg.sum(-1)
        if p_idx < no_hist_days:
            pct = knob(s.pct, lc, torch.get_default_dtype())
            lc = torch.clamp(torch.floor(lc * pct), min=1.0).to(lc.dtype)
            sc = torch.clamp(torch.floor(sc * pct), min=1.0).to(sc.dtype)
            okc = torch.ones_like(okc)
        okc = okc | zero_day
        lc = torch.where(zero_day, 0, lc)
        sc = torch.where(zero_day, 0, sc)
        return (w, lc, sc, resid.to(dtype), okc, w_prev, warm, warm_ring)

    def _day_weights_rows(tenants, tstate: TenantState, octx: OnlineCtx,
                          masked):
        """:func:`_day_weights` over a mesh: the lanes' rows, whole along
        the assets, formed under the plan (``_AssetRows.form``), solved
        there, and the weights, the book and the warm states handed back
        as this rank's blocks (the scalars gathered over the lanes)."""
        lanes = masked.shape[0]
        span = rows.lane_span(lanes)
        mine = (tenants if span == slice(0, lanes)
                else _config_lanes(tenants, span))
        got = rows.form(masked, tstate, octx, span)
        t_rows = dataclasses.replace(tstate, w_prev=got["w_prev"],
                                     warm=got["warm"],
                                     warm_ring=got["warm_ring"])
        o_rows = octx._replace(universe_p=got["universe"],
                               risk_model=got["risk_model"])
        out = _day_weights(t_rows, o_rows, got["masked"],
                           _day_settings(mine, octx))
        return rows.unform(out, tstate, lanes, needs_solver)

    def _not_ready(tstate: TenantState, octx: OnlineCtx, lanes: int):
        nan = torch.full((lanes,), float("nan"), dtype=dtype, device=dev)
        zero_i = torch.zeros((lanes,), dtype=torch.int64, device=dev)
        return tstate, AdvanceOutputs(
            ready=False, day=octx.p,
            selection=torch.zeros((lanes, f), dtype=dtype, device=dev),
            signal=torch.full((lanes, nb), float("nan"), dtype=dtype,
                              device=dev),
            weights=torch.full((lanes, nb), float("nan"), dtype=dtype,
                               device=dev),
            long_count=zero_i, short_count=zero_i, log_return=nan,
            long_return=nan, short_return=nan, long_turnover=nan,
            short_turnover=nan, turnover=nan, resid=nan,
            solver_ok=torch.ones((lanes,), dtype=torch.bool, device=dev))

    def advance_lanes(tenants: TenantConfig, tstate: TenantState,
                      octx: OnlineCtx):
        """The tenant half for a session's ``C`` lanes at once:
        ``tenants`` a :func:`~factormodeling_tpu_torch.serve.stack_configs`
        batch, ``tstate`` their stacked state
        (:func:`~.state.stack_tenant_states`); the outputs' tensors carry
        the leading ``C``. The day's solve is one ``_solve_day`` of ``C``
        lanes (one segment-kernel launch a segment for the session)."""
        lanes = lane_count(tenants)
        if not octx.ready:
            # the very first ingested date finalizes nothing: every carry
            # holds, so the stream's day 0 stays the recompute's day 0
            return _not_ready(tstate, octx, lanes)
        with rows.installed() if sharded else contextlib.nullcontext():
            return _advance_lanes(tenants, tstate, octx, lanes)

    def _advance_lanes(tenants, tstate, octx, lanes):
        p = octx.p
        # 1. selection: the selector over the ring context, then
        # finalize_selection's row masking and normalization over the
        # whole ring (the full step's layout, so the row sums reduce in its
        # order), read at the finalized date's column; processed iff
        # p >= window (p <= D-2 holds by construction: p's successor has
        # arrived)
        with obs_stage("online/selection"):
            kwargs = dict(select_static)
            if select_method == "icir_top":
                kwargs.update(
                    top_x=torch.as_tensor(_host(tenants.top_k, np.int64),
                                          device=dev),
                    icir_threshold=torch.as_tensor(
                        _host(tenants.icir_threshold, np.float64),
                        device=dev))
            if p >= window:
                raw = selector(octx.ctx, **kwargs)            # [C, R, F]
                if raw.ndim == 2:
                    raw = raw.expand(lanes, *raw.shape)
                if tenants.manager_mix is not None:
                    raw = raw * torch.as_tensor(
                        _host(tenants.manager_mix, None), dtype=raw.dtype,
                        device=dev)[:, None, :]
                keep = torch.arange(ring, device=dev) == q_p
                raw = torch.where(keep[:, None], raw, 0.0)
                raw = torch.where(torch.isnan(raw), 0.0, raw)
                rowsum = raw.sum(-1, keepdim=True)
                sel = torch.where(rowsum > 0, raw / torch.where(
                    rowsum > 0, rowsum, 1.0), 0.0)[:, q_p]
            else:
                sel = torch.zeros((lanes, f), dtype=dtype, device=dev)
        # 2. single-date blend (every op inside is per date)
        with obs_stage("online/blend"):
            if sharded:
                signal = rows.blend(octx.factors_p, names, sel,
                                    method=template.blend_method,
                                    universe=octx.universe_p,
                                    group_tilt=tenants.blend_tilt)
            else:
                signal = composite_weighted(
                    octx.factors_p[:, None, :], names, sel[:, None, :],
                    method=template.blend_method,
                    universe=(octx.universe_p[None] if has_universe
                              else None),
                    group_tilt=tenants.blend_tilt)[:, 0]
        # 3. the day's weight solve
        s = _day_settings(tenants, octx)
        masked = signal * octx.invest_p
        with obs_stage("online/solve"):
            if sharded:
                w, lc, sc, resid, okc, w_prev, warm, warm_ring = \
                    _day_weights_rows(tenants, tstate, octx, masked)
            else:
                w, lc, sc, resid, okc, w_prev, warm, warm_ring = \
                    _day_weights(tstate, octx, masked, s)
        with obs_stage("online/shift_pnl"):
            # 4. per-symbol masked weight shift (trade on yesterday's
            # book): a symbol's k-th present date trades its (k-1)-th
            # present book
            if has_universe:
                traded = torch.where(octx.universe_p, tstate.book_carry,
                                     float("nan"))
                book_carry = torch.where(octx.universe_p, w,
                                         tstate.book_carry)
            else:
                traded, book_carry = tstate.book_carry, w
            # 5. single-date P&L (backtest.pnl's row semantics; the first
            # date's turnover diff is 0)
            wt = torch.nan_to_num(traded)
            r = torch.nan_to_num(octx.returns_p)
            longs = torch.clamp(wt, min=0.0)
            shorts = torch.abs(torch.clamp(wt, max=0.0))
            long_ret_raw = (longs * r).sum(-1)
            short_ret_raw = -(shorts * r).sum(-1)
            if p > 0:
                prev = torch.nan_to_num(tstate.traded_prev)
                dlong = torch.abs(longs - torch.clamp(prev, min=0.0))
                dshort = torch.abs(shorts - torch.abs(torch.clamp(
                    prev, max=0.0)))
            else:
                dlong = dshort = torch.zeros_like(longs)
            rates = s.cost_rates()[..., 0, :]             # [C, N]
            l_cost, s_cost = (dlong * rates).sum(-1), (dshort * rates).sum(-1)
            lt, st = dlong.sum(-1), dshort.sum(-1)
            if sharded:
                # the blocks' partial sums, summed over the asset axis
                long_ret_raw, short_ret_raw, l_cost, s_cost, lt, st = \
                    rows.total(long_ret_raw, short_ret_raw, l_cost, s_cost,
                               lt, st)
            if probe.transaction_cost:
                long_ret = long_ret_raw - l_cost
                short_ret = short_ret_raw - s_cost
            else:
                long_ret, short_ret = long_ret_raw, short_ret_raw
            new = TenantState(
                w_prev=w_prev, book_carry=book_carry, traded_prev=traded,
                warm=warm, warm_ring=warm_ring,
                long_pnl_by_name=(tstate.long_pnl_by_name + longs * r
                                  - dlong * rates),
                short_pnl_by_name=(tstate.short_pnl_by_name - shorts * r
                                   - dshort * rates))
        out = AdvanceOutputs(
            ready=True, day=p, selection=sel, signal=signal, weights=traded,
            long_count=lc, short_count=sc, log_return=long_ret + short_ret,
            long_return=long_ret, short_return=short_ret, long_turnover=lt,
            short_turnover=st, turnover=lt + st, resid=resid, solver_ok=okc)
        return new, out

    def advance_tenant(t: TenantConfig, tstate: TenantState,
                       octx: OnlineCtx):
        """The tenant half for one tenant: :func:`advance_lanes` on one
        lane, so a session's lane and this advance run the same lines."""
        new, out = advance_lanes(one_lane(t), stack_tenant_states([tstate]),
                                 octx)
        return tenant_state_lane(new, 0), lane_outputs(out, 0)

    advance_tenant.lanes = advance_lanes
    return init_market, init_tenant, advance_market, advance_tenant


class _AssetRows:
    """The advance's cross-sectional stages over an asset mesh (module
    docs): the asset-sharded step's layout (``parallel.asset_shard.
    _AssetLayout``) for the scoring and the blend, and the lanes' rows of
    the solve, all under one plan."""

    def __init__(self, mesh, axis: str, plan, n: int, method: str):
        from factormodeling_tpu_torch.ops._assetspec import AssetSpecPlan
        from factormodeling_tpu_torch.parallel.asset_shard import (
            _AssetLayout, _same_grid)
        from factormodeling_tpu_torch.parallel.mesh import (_block,
                                                            axis_index)

        self.size = check_asset_divisible(n, mesh, axis)
        if plan is None:
            plan = AssetSpecPlan(mesh, axis=axis)
        if not _same_grid(plan.mesh, mesh) or plan.axis != axis:
            raise ValueError(
                f"plan shards {plan.axis!r} on a mesh of axes "
                f"{tuple(plan.mesh.mesh_dim_names)}, grid "
                f"{tuple(plan.mesh.shape)}; the advance shards {axis!r} on "
                f"{tuple(mesh.mesh_dim_names)}, grid {tuple(mesh.shape)}")
        self.mesh, self.axis, self.plan = mesh, axis, plan
        self.cols = _block(n, self.size, axis_index(mesh, axis))
        self.layout = _AssetLayout(mesh, None, axis)
        # the solve's stage: the QP schemes' iterates, else the weights
        self.stage = ("solver/iterates" if method in ("mvo", "mvo_turnover")
                      else "backtest/weights")

    def installed(self):
        from factormodeling_tpu_torch.ops._assetspec import plan

        return plan(self.plan)

    def whole(self, x):
        from factormodeling_tpu_torch.parallel.mesh import all_gather

        return all_gather(x, self.mesh, self.axis, dim=-1)

    def block(self, x):
        return x[..., self.cols].contiguous()

    def stats(self, factors_tail, returns_tail, universe_tail, needs):
        """The tail's daily stats ``{stat: [F, T]}``, whole on every
        rank."""
        return self.layout.stats(factors_tail, returns_tail,
                                 shift_periods=_SHIFT,
                                 universe=universe_tail, stats=needs)

    def blend(self, factors_p, names, sel, *, method, universe, group_tilt):
        """The date's signal ``[C, N/s]``: the blend of its row, handed
        back as this rank's block."""
        sig = self.layout.blend(
            factors_p[:, None, :], names, sel[:, None, :], method=method,
            universe=None if universe is None else universe[None],
            group_tilt=group_tilt)
        return self.plan.to_block(sig, self.layout.sig_stage, 1)[:, 0]

    def lane_span(self, lanes: int) -> slice:
        return self.plan.row_span(self.stage, lanes)

    def form(self, masked, tstate: TenantState, octx: OnlineCtx,
             span: slice) -> dict:
        """The solve's operands as this rank's lanes' rows, whole along the
        assets, in one collective: the masked signal, and for the QP
        schemes the previous book, the warm states' ``z``/``u`` (their
        ``rho`` sliced), the universe and the risk model's idiosyncratic
        variances (one row a lane)."""
        lanes = masked.shape[0]
        qp = self.stage == "solver/iterates"
        uni, rm = octx.universe_p, octx.risk_model
        warms = (("warm", tstate.warm, False),
                 ("warm_ring", tstate.warm_ring, True))
        parts = [masked.to(QP_DTYPE)]
        if qp:
            parts.append(tstate.w_prev)
            for _, w, ring in warms:
                if w is not None:
                    parts += _lane_rows(w.z, ring) + _lane_rows(w.u, ring)
            if uni is not None:
                parts.append(uni.to(QP_DTYPE).expand(lanes, -1))
            if rm is not None:
                parts.append(rm[2].expand(lanes, -1))
        got = iter(self.plan.rows(torch.stack(parts), self.stage,
                                  batch_dim=1).unbind(0))
        out = {"masked": next(got).to(masked.dtype), "w_prev": tstate.w_prev,
               "warm": tstate.warm, "warm_ring": tstate.warm_ring,
               "universe": uni, "risk_model": rm}
        if qp:
            out["w_prev"] = next(got)
            for key, w, ring in warms:
                if w is not None:
                    out[key] = ADMMWarmState(z=_from_rows(got, w.z, ring),
                                             u=_from_rows(got, w.u, ring),
                                             rho=w.rho[span])
            if uni is not None:
                out["universe"] = next(got)[0] > 0
            if rm is not None:
                out["risk_model"] = (rm[0], rm[1], next(got)[0], rm[3])
        return out

    def unform(self, out, tstate: TenantState, lanes: int, qp: bool):
        """:func:`_day_weights`' outputs on the rows back as the advance
        takes them: the weights, the book and the warm states' ``z``/``u``
        as this rank's ``[C, N/s]`` blocks (one collective under
        ``reshard``, a slice otherwise), the scalars and ``rho`` over every
        lane (one collective under ``reshard``)."""
        w, lc, sc, resid, okc, w_prev, warm, warm_ring = out
        wide, narrow = [w.to(QP_DTYPE)], [x.to(QP_DTYPE)
                                          for x in (lc, sc, resid, okc)]
        warms = ((warm, False), (warm_ring, True)) if qp else ()
        if qp:
            wide.append(w_prev)
            for x, ring in warms:
                if x is not None:
                    wide += _lane_rows(x.z, ring) + _lane_rows(x.u, ring)
                    narrow += _lane_rows(x.rho, ring)
        blocks = iter(self.plan.to_block(torch.stack(wide), self.stage,
                                         lanes, dim=1).unbind(0))
        flat = iter(self.plan.gather_rows(torch.stack(narrow), self.stage,
                                          lanes, dim=1).unbind(0))
        res = (next(blocks).to(w.dtype), next(flat).to(lc.dtype),
               next(flat).to(sc.dtype), next(flat).to(resid.dtype),
               next(flat) > 0)
        if not qp:
            return res + (tstate.w_prev, tstate.warm, tstate.warm_ring)
        res += (next(blocks),)
        for x, ring in warms:
            res += (None if x is None else ADMMWarmState(
                z=_from_rows(blocks, x.z, ring),
                u=_from_rows(blocks, x.u, ring),
                rho=_from_rows(flat, x.rho, ring)),)
        return res

    def total(self, *partials):
        """The partial sums (each ``[C]``) summed over the asset axis, in
        one collective."""
        from factormodeling_tpu_torch.parallel.mesh import all_reduce

        return all_reduce(torch.stack(partials), self.mesh,
                          self.axis).unbind(0)


def _lane_rows(a, ring: bool) -> list:
    """A warm-state leaf as operands with the lanes leading: the turnover
    state's ``[C, N]`` (``rho [C]``) as itself, plain MVO's ring's ``[C, B,
    N]`` (``rho [C, B]``) as its ``B`` slots."""
    return list(a.unbind(1)) if ring else [a]


def _from_rows(rows, like, ring: bool):
    """A leaf shaped as ``like`` from the next operands of the iterator
    ``rows`` (:func:`_lane_rows`' inverse)."""
    if not ring:
        return next(rows)
    return torch.stack([next(rows) for _ in range(like.shape[1])], 1)


def lane_outputs(out: AdvanceOutputs, lane: int) -> AdvanceOutputs:
    """Lane ``lane`` of a session's advance row (``ready`` and ``day`` are
    the market's)."""
    return AdvanceOutputs(out.ready, out.day,
                          *(getattr(out, k)[lane]
                            for k in AdvanceOutputs._fields[2:]))


def gather_advance_outputs(out: AdvanceOutputs, mesh,
                           asset_axis: str = "assets") -> AdvanceOutputs:
    """A sharded advance's row with ``signal`` and ``weights`` gathered
    whole over the asset axis, on every rank (its other fields are whole
    already)."""
    from factormodeling_tpu_torch.parallel.mesh import all_gather

    return out._replace(
        signal=all_gather(out.signal, mesh, asset_axis, dim=-1),
        weights=all_gather(out.weights, mesh, asset_axis, dim=-1))


def make_online_step(*, names, template: TenantConfig | None = None,
                     n_assets: int, dtype=torch.float64,
                     has_universe: bool = False, stats_tail: int = 8,
                     device=None, mesh=None, asset_axis: str = "assets",
                     plan=None):
    """Single-config convenience over :func:`online_step_parts`: returns
    ``(init_fn, advance_fn)`` where ``init_fn() -> (mstate, tstate)`` and
    ``advance_fn(tenant, mstate, tstate, date_slice) -> ((mstate',
    tstate'), AdvanceOutputs)`` is one per-date advance, the online
    engine's unit of work.

    With ``mesh`` the states, the date slice and the outputs' ``signal``
    and ``weights`` are this rank's asset blocks (module docs):
    ``advance_fn.shard_date_slice(ds)`` cuts a whole date's blocks and
    ``advance_fn.gather_outputs(out)`` gathers an output row whole."""
    template = template or TenantConfig()
    im, it, am, at = online_step_parts(
        names=names, template=template, n_assets=n_assets, dtype=dtype,
        has_universe=has_universe, stats_tail=stats_tail, device=device,
        mesh=mesh, asset_axis=asset_axis, plan=plan)

    def init_fn():
        return im(), it()

    def advance_fn(tenant, mstate, tstate, date_slice):
        mstate2, octx = am(mstate, date_slice)
        tstate2, out = at(tenant, tstate, octx)
        return (mstate2, tstate2), out

    if mesh is not None:
        advance_fn.shard_date_slice = (
            lambda ds: shard_date_slice(ds, mesh, asset_axis))
        advance_fn.gather_outputs = (
            lambda out: gather_advance_outputs(out, mesh, asset_axis))
    return init_fn, advance_fn
