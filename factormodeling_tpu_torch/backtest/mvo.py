"""MVO weight schemes (port of ``factormodeling_tpu/backtest/mvo.py``):
per-date minimum-variance ``mvo`` and the turnover-penalized
``mvo_turnover`` in ``scan`` and ``parallel`` mode, each with the trailing
sample covariance or the rolling statistical risk model.

The sample covariance keeps the factored form

    Sigma_shrunk = alpha I + s C'C,
    alpha = (1 - lam) * 1e-6 + lam * mean(diag(sample + 1e-6 I)),
    s     = (1 - lam) / (T - 1),   C = centered zero-filled window rows,

which the ADMM solver consumes through a Woodbury identity.
``covariance="risk_model"`` swaps it for a statistical factor model
(:mod:`factormodeling_tpu_torch.risk`) refit every ``risk_refit_every``
days on the ``risk_lookback`` rows before the refit day:
``Sigma = B diag(f) B' + diag(idio)`` rides the same Woodbury path with the
per-asset idio diagonal as a vector alpha and ``V = B'``.

Plain ``mvo`` solves its independent dates in chunks of ``mvo_batch``
lanes, one lane-batched solve per chunk (one segment-kernel launch per
segment for the whole chunk); lane ``i`` of a chunk warm-starts from lane
``i`` of the chunk before, and a ragged tail solves as a narrower chunk that
keeps its lanes' chains. ``mvo_turnover`` feeds yesterday's weights into
today's L1 term, so its days run in order, one lane each: the JAX
``lax.scan`` becomes a Python loop whose every ladder decision is a
``torch.where`` on the device, so the loop queues work and never waits on
the card. Fallback ladder: either leg empty or < 2 names -> flat day; no
history (no prior date; the first refit block under the risk model) ->
equal-scheme weights; one prior date, a NaN signal on a present name
(turnover only), solver failure or infeasible caps -> equal weight per leg.

Lanes (``backtest.engine``): a ``[C, D, N]`` signal under ``[C]`` knobs
solves every lane's dates in the same solves: a plain-MVO chunk is ``C *
mvo_batch`` solve lanes, each lane's chunk warm-starting from its own
chunk before, and the turnover scan is one day loop whose each date is one
solve of ``C`` lanes (one segment-kernel launch a segment for the bucket,
the host's day loop once). ``turnover_mode="parallel"`` batches its lanes
the same way, what ``jax.vmap`` of the JAX package's scheme computes: the
seed is one solve of ``C * count`` lanes a chunk; each sweep solves, a
chunk at a time, only the lanes still sweeping (a lane stops at its own
``turnover_tol`` or stall, and its trajectory, exit state and telemetry
stay as its last sweep left them, as the vmapped ``lax.cond`` leaves
them); the suffix is one day loop from the smallest of the lanes' first
unsettled days, each date one solve of the lanes at or past their own
start, the others passing their certified row through. The host reads one
``[C]`` vector of largest moves a sweep.

The QP and the risk-model fits run in float64 whatever the panels' dtype
(:data:`QP_DTYPE`), for both schemes and both covariances; the weights come
back in the panels' dtype. With the reference's numbers (turnover penalty
0.1 per unit of weight moved, daily return variances of order 4e-4 on
weights of order 1/N) the L1 term dwarfs the variance term, so a turnover
day's QP is close to a degenerate LP whose ties only the variance term
breaks; float32 cannot resolve that tie-break, and a float32 solve picks
another optimal vertex than the float64 solve on most days once one day
differs (yesterday's weights are today's L1 center, so a difference
persists). Measured on an H100 at 1332 days x 1000 names (``python -m
factormodeling_tpu_torch.qp_precision``): the same kernel in float32 vs
float64 differed by > 1e-4 on 66-68% of days, the two kernels in float32 on
99.7%; in float64 the two kernels agree exactly. The day loop is
launch-bound, so float64 costs no time that matters.

``turnover_mode="parallel"`` is the fixed-point (Picard) scheme: a seed
trajectory from plain MVO in chunks of ``mvo_batch`` cold lanes, then up to
``turnover_sweeps`` passes that re-solve every day at once against the
previous pass's weights for day ``t-1``, each day warm-started from its own
last exit state; the passes stop once no day moves by more than
``turnover_tol`` or the largest move stops halving. The days before the
first one that still moved pass through; from there the scan's own day loop
takes over. Its lanes honour ``s.solver_kernel``: with ``"fused"`` every
seed and sweep chunk is one segment-kernel launch per segment for all its
lanes. (The JAX package pins these lanes to its reference kernel to dodge a
jax 0.4.x fault, a vmapped ``pallas_call`` in ``lax.map``'s zero-size
remainder chunk; the port has no such fault. The kernel's lanes are bitwise
equal to its single-lane launches, and on a CPU tensor the fused path is the
kernel's plain twin, so the function computed is the JAX package's.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from factormodeling_tpu_torch import risk as _risk
from factormodeling_tpu_torch.backtest.diagnostics import SchemeStats
from factormodeling_tpu_torch.backtest.settings import (SimulationSettings,
                                                        knob)
from factormodeling_tpu_torch.backtest.weights import equal_weights, leg_masks
from factormodeling_tpu_torch.solvers.admm_qp import (ADMMWarmState,
                                                      BoxQPProblem,
                                                      admm_solve_lowrank)
from factormodeling_tpu_torch.solvers.portfolio import (
    equal_leg_fallback as _x0_legs,
    leg_constraints,
    legs_feasible,
)

__all__ = ["DateRows", "block_ret0", "mvo_turnover_weights", "mvo_weights"]

_JITTER = 1e-6

#: working precision of the MVO QPs and risk-model fits (see the module
#: docstring)
QP_DTYPE = torch.float64


class DateRows(NamedTuple):
    """A block of a run's dates (the asset-sharded step's row blocks): the
    signal's rows are the dates ``day0 ..``; the settings' ``returns``
    start at ``ret0`` (:func:`block_ret0`: the covariance window's and the
    risk model's earlier rows, a halo), every other panel at ``day0``;
    ``d_total`` is the run's date count."""

    day0: int
    ret0: int
    d_total: int


def block_ret0(s: SimulationSettings, day0: int, d_total: int) -> int:
    """The first returns row the dates from ``day0`` on read: the trailing
    window's ``lookback_period`` rows, or under the risk model the fit
    rows of ``day0``'s refit block."""
    if s.covariance == "risk_model":
        first = day0 // s.risk_refit_every * s.risk_refit_every
        return max(first - min(s.risk_lookback, d_total), 0)
    return max(day0 - min(s.lookback_period, d_total), 0)


def _window_factors(returns0: torch.Tensor, todays: torch.Tensor,
                    lookback: int, lane_ix: torch.Tensor | None = None,
                    rows: DateRows | None = None):
    """(C [B, L, N], t_used [B]) of the factored covariance for the dates
    ``todays`` (``[B]``, on the device): the centered zero-filled window of
    (at most ``lookback``) return rows strictly before each date —
    ``returns0`` is the NaN-zeroed panel, ``[D, N]`` shared by every solve
    lane or ``[C, D, N]`` one a lane, and then ``lane_ix [B]`` names each
    solve lane's; under ``rows`` it holds the dates from ``rows.ret0`` —
    and the usable-row count."""
    d, n = returns0.shape[-2:]
    if rows is not None:
        d = rows.d_total
    lookback = min(lookback, d)
    start = torch.clamp(todays - lookback, min=0)
    t_used = todays - start
    offs = torch.arange(lookback, device=returns0.device)
    used = (offs[None, :] < t_used[:, None])[..., None]        # [B, L, 1]
    idx = torch.clamp(start[:, None] + offs[None, :], max=d - 1)
    if rows is not None:
        # the used rows lie in the halo'd block; the others are masked
        idx = torch.clamp(idx - rows.ret0, 0, returns0.shape[-2] - 1)
    rows = (returns0[idx] if returns0.ndim == 2
            else returns0[lane_ix[:, None], idx])
    rows = torch.where(used, rows, 0.0)
    mean = rows.sum(1, keepdim=True) / torch.clamp(t_used, min=1)[:, None, None]
    return torch.where(used, rows - mean, 0.0), t_used


def _shrunk_terms(c: torch.Tensor, t_used: torch.Tensor, lam):
    """alpha and per-row scale of Sigma_shrunk = alpha I + s C'C, per lane
    (``[B]`` each); ``lam`` a number or one intensity a lane (``[B]``)."""
    lam = knob(lam, t_used, c.dtype)
    denom = torch.clamp(t_used - 1, min=1).to(c.dtype)
    # what the number's ``(1 - lam) / denom`` computes (a number over a
    # tensor is torch's reciprocal times the number), so a lane's tensor
    # intensity gives its bits
    s_row = (1.0 - lam) * torch.reciprocal(denom)
    avg_var = (c * c).sum((-2, -1)) / denom / c.shape[-1] + _JITTER
    alpha = (1.0 - lam) * _JITTER + lam * avg_var
    return alpha, s_row


def _risk_model_stack(returns: torch.Tensor, s: SimulationSettings,
                      rows: DateRows | None = None):
    """Rolling refits of the statistical risk model, stacked along a refit
    axis ``R = ceil(D / risk_refit_every)``: ``(loadings [R, N, k],
    factor_var [R, k], idio [R, N])``; ``[C, D, N]`` returns (one panel a
    lane) give one stack a lane, ``[C, R, ...]``. Under ``rows`` (returns
    from ``rows.ret0`` to the block's end) the stack holds the refits of
    the block's dates, from the refit block of ``rows.day0``.

    Model ``j`` is fit on the (at most ``risk_lookback``) rows of
    ``returns`` (with NaN) strictly before day ``j * risk_refit_every``,
    NaN-padded to ``risk_lookback`` rows, so no estimate sees its own block;
    block 0's model is fit on no rows and its days take the no-history
    ladder."""
    if returns.ndim == 3:
        return tuple(torch.stack(col) for col in
                     zip(*(_risk_model_stack(r, s, rows) for r in returns)))
    d, n = returns.shape
    ret0, first, end = 0, 0, d
    if rows is not None:
        ret0, end = rows.ret0, rows.ret0 + d
        first = rows.day0 // s.risk_refit_every * s.risk_refit_every
        d = rows.d_total
    lb = min(s.risk_lookback, d)
    out = []
    for day in range(first, end, s.risk_refit_every):
        start = max(day - lb, 0)
        n_used = day - start
        rows_ = torch.full((lb, n), float("nan"), dtype=returns.dtype,
                           device=returns.device)
        rows_[:n_used] = returns[start - ret0:day - ret0]
        m = _risk.statistical_risk_model(rows_, s.risk_factors)
        # the model's factor variances divide by (lb - 1) whatever the
        # padding: rescale to the observed rows' denominator
        scale = (lb - 1.0) / max(n_used - 1.0, 1.0)
        out.append((m.loadings, m.factor_var * scale, m.idio_var))
    return tuple(torch.stack(col) for col in zip(*out))


def _risk_model_for_day(stacks, todays: torch.Tensor, s: SimulationSettings,
                        lane_ix: torch.Tensor | None = None,
                        rows: DateRows | None = None):
    """The dates' ``(loadings [B, N, k], factor_var [B, k], idio [B, N],
    history [B])`` from the refit stack (a lane stack reads each solve
    lane's own, ``lane_ix [B]``; a block's stack starts at its first
    date's refit); ``history`` is the row count behind each block's fit,
    which drives the ladder like the sample window's ``t_used``."""
    loadings_s, fvar_s, idio_s = stacks
    j = torch.div(todays, s.risk_refit_every, rounding_mode="floor")
    d = s.returns.shape[-2] if rows is None else rows.d_total
    hist = torch.clamp(j * s.risk_refit_every, max=min(s.risk_lookback, d))
    if rows is not None:
        j = j - rows.day0 // s.risk_refit_every
    if loadings_s.ndim == 4:
        return (loadings_s[lane_ix, j], fvar_s[lane_ix, j],
                idio_s[lane_ix, j], hist)
    return loadings_s[j], fvar_s[j], idio_s[j], hist


def _cold_state(n: int, batch: int, dtype, device) -> ADMMWarmState:
    """Cold warm-states for ``batch`` lanes (zeros; rho NaN -> the solver
    starts from its own rho)."""
    z = torch.zeros((batch, n), dtype=dtype, device=device)
    return ADMMWarmState(z=z, u=torch.zeros_like(z),
                         rho=torch.full((batch,), float("nan"), dtype=dtype,
                                        device=device))


def _solve_day(signal_rows: torch.Tensor, returns0: torch.Tensor,
               todays: torch.Tensor, w_prev: torch.Tensor,
               s: SimulationSettings, b: torch.Tensor, turnover: bool,
               risk_model=None, warm: ADMMWarmState | None = None,
               force_fallback: torch.Tensor | None = None,
               may_lack_history: bool = True, iters: int | None = None,
               polish: bool | None = None, polish_passes: int | None = None,
               lane_ix: torch.Tensor | None = None,
               rows: DateRows | None = None):
    """One lane-batched solve of the dates ``todays`` with the full fallback
    ladder. ``signal_rows``/``w_prev`` are ``[B, N]`` in the QP dtype;
    the knobs of ``s`` are numbers or one value a solve lane (``[B]``,
    :meth:`SimulationSettings.lane_view`); ``lane_ix`` names each solve
    lane's panel when ``returns0`` is ``[C, D, N]``; ``risk_model`` is
    ``None`` (the sample covariance) or the dates'
    ``(loadings, factor_var, idio, history)``. Returns ``(w [B, N],
    primal_residual [B], solver_ok [B], warm_state, telemetry)`` with
    ``telemetry = (polished, pre_residual, post_residual, aa_accepted,
    aa_rejected, iters_to_converge)``. ``may_lack_history=False`` tells
    that no date has an empty window (the history is a function of the
    date alone), which skips building the equal-scheme fallback.

    ``iters`` / ``polish`` / ``polish_passes`` override the settings'
    budget and polish (the parallel scheme's seed and sweeps run reduced
    budgets). ``rows``: ``returns0`` holds a block's dates
    (:class:`DateRows`)."""
    dtype = returns0.dtype
    lanes, n = signal_rows.shape
    pos = signal_rows > 0
    neg = signal_rows < 0
    if risk_model is None:
        c, t_used = _window_factors(returns0, todays, s.lookback_period,
                                    lane_ix, rows)
        alpha, s_row = _shrunk_terms(c, t_used, s.shrinkage_intensity)
        s_vec = torch.where(
            torch.arange(c.shape[1], device=c.device)[None, :] < t_used[:, None],
            s_row[:, None], 0.0)
    else:
        loadings, factor_var, idio, t_used = risk_model
        alpha, c, s_vec = idio, loadings.mT, factor_var   # V = B': [B, k, N]

    lo, hi, E, b = leg_constraints(signal_rows, s.max_weight, dtype, b=b)
    if turnover:
        q = -knob(s.return_weight, signal_rows) * torch.nan_to_num(signal_rows)
        l1, center = s.turnover_penalty, w_prev
    else:
        q = torch.zeros_like(lo)
        l1, center = 0.0, torch.zeros_like(lo)
    # the reference objective is w' Sigma w (not halved) plus the L1 term;
    # the solver minimizes 1/2 x'Px + ..., so P = 2 Sigma
    prob = BoxQPProblem(q=q, lo=lo, hi=hi, E=E, b=b, l1=l1, center=center)
    res = admm_solve_lowrank(
        2.0 * alpha, c, 2.0 * s_vec, prob, rho=s.qp_rho,
        iters=s.resolved_qp_iters(turnover) if iters is None else iters,
        warm_start=warm, polish=s.qp_polish if polish is None else polish,
        polish_passes=polish_passes, anderson=s.qp_anderson,
        kernel=s.solver_kernel)
    w = res.x

    solver_ok = (torch.isfinite(w).all(-1)
                 & legs_feasible(signal_rows, s.max_weight) & (t_used >= 2))
    if force_fallback is not None:
        solver_ok = solver_ok & ~force_fallback
    w = torch.where(solver_ok[:, None], w, _x0_legs(signal_rows))

    if turnover:
        # post-solve pruning + per-leg renorm
        pruned = torch.where(torch.abs(w) < 1e-6, 0.0, w)
        long_den = torch.where(pos, pruned, 0.0).sum(-1, keepdim=True)
        short_den = -torch.where(neg, pruned, 0.0).sum(-1, keepdim=True)
        renorm = torch.where(
            pos, pruned / torch.where(long_den > 0, long_den, 1.0),
            torch.where(neg, pruned / torch.where(short_den > 0, short_den,
                                                  1.0), 0.0))
        w = torch.where(solver_ok[:, None] & (long_den > 0) & (short_den > 0),
                        renorm, w)

    if may_lack_history:   # no history at all -> equal-scheme fallback
        w = torch.where((t_used >= 1)[:, None], w,
                        equal_weights(signal_rows, s.pct)[0])
    nan = torch.full((lanes,), float("nan"), dtype=dtype, device=w.device)
    solved = solver_ok & (t_used >= 2)
    zero_i = torch.zeros((), dtype=torch.int32, device=w.device)
    itc = res.iters_to_converge if res.iters_to_converge is not None else zero_i
    telemetry = (res.polished & solved,
                 torch.where(solved, res.polish_pre_residual, nan),
                 torch.where(solved, res.polish_post_residual, nan),
                 torch.where(solved, res.aa_accepted, zero_i),
                 torch.where(solved, res.aa_rejected, zero_i),
                 torch.where(solved, itc, zero_i))
    # a rejected solve's iterates describe a discarded problem: reset cold
    state = ADMMWarmState(z=torch.where(solver_ok[:, None], res.z, 0.0),
                          u=torch.where(solver_ok[:, None], res.u, 0.0),
                          rho=torch.where(solver_ok, res.rho, nan))
    return (w, torch.where(t_used >= 2, res.primal_residual, nan),
            solver_ok | (t_used < 2), state, telemetry)


def _universe_count(signal: torch.Tensor, s: SimulationSettings):
    if s.universe is not None:
        return s.universe.sum(-1)
    return torch.full(signal.shape[:-1], signal.shape[-1], device=signal.device)


def _nan_signal_days(signal: torch.Tensor, s: SimulationSettings):
    """Days the reference's turnover solver rejects before solving: a
    present (universe) cell with a NaN signal value."""
    if s.universe is not None:
        return (torch.isnan(signal) & s.universe).any(-1)
    return torch.zeros(signal.shape[:-1], dtype=torch.bool, device=signal.device)


class _Panels:
    """What every solve of one run shares: the QP-dtype ``[C, D, N]``
    signal lanes, the NaN-zeroed returns (``[D, N]`` shared or one a lane),
    the risk model's refit stack, and the leg equality right-hand side. A
    solve of ``count`` dates runs ``C * count`` solve lanes, lane-major
    (solve lane ``b`` is lane ``b // count``, date ``first + b % count``).
    Under ``rows`` the signal is a block of the run's dates
    (:class:`DateRows`): ``first`` counts the block's rows, the solves
    see the run's dates."""

    def __init__(self, signal: torch.Tensor, s: SimulationSettings,
                 rows: DateRows | None = None):
        dev = signal.device
        self.signal = signal.to(QP_DTYPE)
        self.lanes = signal.shape[0]
        self.rows_of = rows
        self.returns0 = torch.nan_to_num(s.returns).to(QP_DTYPE)
        self.stacks = (_risk_model_stack(s.returns.to(QP_DTYPE), s, rows)
                       if s.covariance == "risk_model" else None)
        self.b = torch.tensor([1.0, -1.0], dtype=QP_DTYPE, device=dev)
        day0 = 0 if rows is None else rows.day0
        self.days = torch.arange(day0, day0 + signal.shape[1], device=dev)
        self._by_count: dict = {}

    def subset(self, lanes: tuple | None):
        """The lane index tensor of ``lanes`` (a tuple of lane numbers;
        None: every lane, no index)."""
        if lanes is None:
            return None
        if lanes not in self._by_count:
            self._by_count[lanes] = torch.as_tensor(lanes,
                                                    device=self.days.device)
        return self._by_count[lanes]

    def rows(self, x: torch.Tensor, first: int, count: int,
             lanes: tuple | None = None) -> torch.Tensor:
        """``x [C, D, ...]`` at the dates ``first .. first + count - 1`` as
        solve lanes ``[C * count, ...]`` (of the lanes ``lanes`` only)."""
        if lanes is not None:
            x = x[self.subset(lanes)]
        return x[:, first:first + count].reshape((-1,) + x.shape[2:])

    def _lanes_of(self, count: int, s: SimulationSettings,
                  lanes: tuple | None = None):
        """The solve lanes' lane index and settings for ``count`` dates of
        ``lanes`` (None: every lane)."""
        key = (count, lanes)
        if key not in self._by_count:
            ix = (torch.arange(self.lanes, device=self.days.device)
                  if lanes is None else self.subset(lanes))
            lane_ix = ix.repeat_interleave(count)
            self._by_count[key] = (
                lane_ix, s.lane_view(lane_ix) if s.lanes() else s)
        return self._by_count[key]

    def solve(self, first: int, count: int, w_prev, s: SimulationSettings,
              turnover: bool, warm, force_fallback=None,
              lanes: tuple | None = None, **overrides):
        """:func:`_solve_day` of the dates ``first .. first + count - 1`` of
        every lane, or of the lanes ``lanes`` only (``w_prev`` and ``warm``
        then hold theirs); ``force_fallback`` is a ``[C, D]`` mask;
        ``overrides`` are its ``iters``/``polish``/``polish_passes``."""
        lane_ix, s_lanes = self._lanes_of(count, s, lanes)
        todays = self.days[first:first + count]
        width = self.lanes if lanes is None else len(lanes)
        if width > 1:
            todays = todays.repeat(width)
        rm = (None if self.stacks is None
              else _risk_model_for_day(self.stacks, todays, s, lane_ix,
                                       self.rows_of))
        # the dates without history: day 0, or the first refit block
        no_hist = s.risk_refit_every if self.stacks is not None else 1
        day = first if self.rows_of is None else first + self.rows_of.day0
        return _solve_day(
            self.rows(self.signal, first, count, lanes), self.returns0, todays,
            w_prev, s_lanes, self.b, turnover, risk_model=rm,
            warm=warm if s.qp_warm_start else None,
            force_fallback=(None if force_fallback is None
                            else self.rows(force_fallback, first, count,
                                           lanes)),
            may_lack_history=day < no_hist, lane_ix=lane_ix,
            rows=self.rows_of, **overrides)


def _tree(fn, *trees):
    """``fn`` over the tensors of equal-structured tuples / NamedTuples."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    fields = [_tree(fn, *col) for col in zip(*trees)]
    return type(t)(*fields) if hasattr(t, "_fields") else tuple(fields)


def _cat(rows, lanes: int | None = None):
    """Per-solve outputs (tuples of tensors, nested tuples such as the warm
    state and the telemetry) concatenated along the date axis, field by
    field: dim 0, or with ``lanes`` each ``[C * count, ...]`` solve-lane
    row as ``[C, count, ...]`` along dim 1."""
    if lanes is None:
        return _tree(lambda *xs: torch.cat(xs), *rows)
    return _tree(lambda *xs: torch.cat(
        [x.reshape((lanes, -1) + x.shape[1:]) for x in xs], 1), *rows)


def _stack_rows(rows, out_dtype, lanes: int):
    """Concatenate per-solve outputs ``(w, resid, ok, telemetry)`` into
    ``[C, D, ...]`` lanes; float outputs go back to the panels' dtype."""
    w, resid, ok, (polished, pre, post, acc, rej, itc) = _cat(rows, lanes)
    return (w.to(out_dtype), resid.to(out_dtype), ok,
            (polished, pre.to(out_dtype), post.to(out_dtype), acc, rej, itc))


def _scheme_stats(values, lanes: int, device) -> SchemeStats:
    """``[C]`` stats from a number each (every lane alike) or a list of
    one a lane."""
    return SchemeStats(*(torch.as_tensor(
        v if isinstance(v, list) else [v] * lanes, dtype=torch.int32,
        device=device) for v in values))


def _lanes_in(signal: torch.Tensor):
    """``(signal [C, D, N], unbatched)``: an unbatched ``[D, N]`` call runs
    as one lane and its outputs drop the axis again."""
    if signal.ndim == 3:
        return signal, False
    return signal[None], True


def _lane_out(out, unbatched: bool):
    return _tree(lambda a: a[0], out) if unbatched else out


def _warm_rows(hist: ADMMWarmState, count: int) -> ADMMWarmState:
    """The first ``count`` dates of a ``[C, B, ...]`` warm history as
    ``[C * count, ...]`` solve lanes."""
    return ADMMWarmState(*(a[:, :count].reshape((-1,) + a.shape[2:])
                           for a in hist))


def mvo_weights(signal: torch.Tensor, s: SimulationSettings,
                rows: DateRows | None = None, carry=None):
    """Per-date minimum-variance weights: chunks of ``mvo_batch`` dates
    solve as one lane batch (every lane's, for ``[C, D, N]`` lanes); a
    date warm-starts from the exit state of the date ``mvo_batch`` before
    it, lane ``i`` of a chunk from lane ``i`` of the chunk before (disable
    with ``qp_warm_start=False``), and the ragged tail is a narrower chunk
    on the first lanes' chains. Returns ``(weights [D, N], long_count [D],
    short_count [D], resid, ok, telemetry, stats)``, with the leading ``C``
    under lanes; ``stats.qp_solves == D``.

    ``rows`` (:class:`DateRows`): the signal is a block of the run's dates,
    chunked from its first row; ``carry`` is the ``[C, mvo_batch, ...]``
    exit states of the ``mvo_batch`` dates before the block (None: cold,
    the run's first block), and the call returns ``(outputs, carry)``
    with the states of the block's last ``mvo_batch`` dates: the chain a
    block hands the next."""
    signal, unbatched = _lanes_in(signal)
    c, d, n = signal.shape
    d_total = d if rows is None else rows.d_total
    pos, neg, flat = leg_masks(signal)
    panels = _Panels(signal, s, rows)
    batch = min(s.mvo_batch, d_total)
    hist = carry
    if hist is None:
        cold = _cold_state(n, c * batch, QP_DTYPE, signal.device)
        hist = ADMMWarmState(*(a.reshape((c, batch) + a.shape[1:])
                               for a in cold))
    zeros = torch.zeros((c * batch, n), dtype=QP_DTYPE, device=signal.device)
    out = []
    for first in range(0, d, batch):
        count = min(batch, d - first)
        w, resid, ok, state, tele = panels.solve(
            first, count, zeros[:c * count], s, False,
            _warm_rows(hist, count))
        out.append((w, resid, ok, tele))
        hist = ADMMWarmState(*(torch.cat(
            [h, a.reshape((c, count) + a.shape[1:])], 1)[:, -batch:]
            for h, a in zip(hist, state)))
    w, resid, ok, tele = _stack_rows(out, s.returns.dtype, c)
    stats = _scheme_stats((d_total, 0, 0, 0), c, signal.device)
    res = _lane_out(_finalize(w, signal, s, pos, neg, flat, resid, ok, tele,
                              stats, panels.days), unbatched)
    return res if rows is None else (res, hist)


def _turnover_day_solve(panels: _Panels, s: SimulationSettings, zero_day,
                        nan_sig_day, first: int, count: int, w_prev, warm,
                        lanes: tuple | None = None, **overrides):
    """THE turnover day step, for the dates ``first .. first + count - 1``
    of every lane (of ``lanes`` only): the solve with the NaN-signal
    rejection, then zero days zeroed. The scan, the parallel sweeps and the
    parallel suffix all run it, so they cannot drift apart; ``overrides``
    as in :meth:`_Panels.solve`."""
    w, resid, ok, state, tele = panels.solve(
        first, count, w_prev, s, True, warm, nan_sig_day, lanes=lanes,
        **overrides)
    # the reference reads the last stored row as yesterday's weights, which
    # is the zero row on flat days
    w = torch.where(panels.rows(zero_day, first, count, lanes)[:, None], 0.0,
                    w)
    return w, resid, ok, state, tele


def _sequential_days(panels: _Panels, s: SimulationSettings, zero_day,
                     nan_sig_day, start: int, w_prev, warm):
    """The days ``start .. D-1`` one after another at the settings'
    budgets, each on the day before's weights and solver exit state, every
    lane in one solve a day: ``(w, resid, ok, telemetry)`` rows, one a
    day, and the last day's ``(w, exit state)``."""
    rows = []
    for today in range(start, panels.days.shape[0]):
        w, resid, ok, warm, tele = _turnover_day_solve(
            panels, s, zero_day, nan_sig_day, today, 1, w_prev, warm)
        rows.append((w, resid, ok, tele))
        w_prev = w
    return rows, (w_prev, warm)


def mvo_turnover_weights(signal: torch.Tensor, s: SimulationSettings,
                         rows: DateRows | None = None, carry=None):
    """Turnover-penalized weights: yesterday's (pre-shift) weights feed
    today's L1 turnover term, and each day warm-starts from yesterday's
    solver exit state (disable with ``qp_warm_start=False``).
    ``s.turnover_mode`` picks the scheme: ``"scan"``, the days in order, or
    ``"parallel"``, the fixed-point sweeps with the scan for the days they
    do not certify (module docstring). Returns ``(weights [D, N],
    long_count [D], short_count [D], resid, ok, telemetry, stats)``, with
    the leading ``C`` under ``[C, D, N]`` lanes: the scan runs one day loop
    for every lane, one solve of ``C`` lanes a date; the parallel scheme
    solves every lane still sweeping in one solve a chunk, and its suffix
    in one day loop (module docstring).

    ``rows`` (:class:`DateRows`, the scan only): the signal is a block of
    the run's dates; ``carry`` is the day before's ``(weights [C, N],
    exit state)`` (None: zeros and a cold state, the run's first block),
    and the call returns ``(outputs, carry)`` with the block's last day's:
    the carry a block hands the next (the parallel scheme's blocks:
    :func:`turnover_parallel_blocks`)."""
    if s.turnover_mode == "parallel":
        if rows is not None:
            raise ValueError("a block of dates runs the parallel scheme "
                             "through turnover_parallel_blocks")
        return turnover_parallel_blocks(signal, s)(None)[0]
    run = _TurnoverRun(signal, s, rows)
    out, stats, carry = _turnover_scan(run.panels, s, run.zero_day,
                                       run.nan_sig_day, carry)
    if rows is not None:
        stats = (rows.d_total, 0, 0, rows.d_total)
    res = run.outputs(out, stats)
    return res if rows is None else (res, carry)


class _TurnoverRun:
    """What a turnover run's day steps share: the lanes, the leg masks,
    the zero and NaN-signal days and the panels; :meth:`outputs` turns
    its rows into the scheme's outputs."""

    def __init__(self, signal: torch.Tensor, s: SimulationSettings,
                 rows: DateRows | None):
        self.signal, self.unbatched = _lanes_in(signal)
        self.s = s
        c, d, _ = self.signal.shape
        self.legs = leg_masks(self.signal)
        self.zero_day = self.legs[2] | (_universe_count(self.signal, s) < 2)
        self.nan_sig_day = _nan_signal_days(self.signal, s).expand(c, d)
        self.panels = _Panels(self.signal, s, rows)

    def outputs(self, out, stats):
        c = self.signal.shape[0]
        w, resid, ok, tele = _stack_rows(out, self.s.returns.dtype, c)
        pos, neg, flat = self.legs
        return _lane_out(_finalize(
            w, self.signal, self.s, pos, neg, flat, resid, ok, tele,
            _scheme_stats(stats, c, self.signal.device), self.panels.days),
            self.unbatched)


def turnover_parallel_blocks(signal: torch.Tensor, s: SimulationSettings,
                             rows: DateRows | None = None, comm=None):
    """The parallel scheme on a block of the run's dates (``rows``; None:
    the whole run): the seed and the sweeps run here, every block at once,
    and the returned ``suffix(carry) -> (outputs, carry)`` runs the
    block's part of the suffix on the day before's carry (None: zeros and
    a cold state) and hands on its last day's, as the scan's blocks do.
    ``comm`` joins the blocks' sweeps (the asset-sharded step's row
    blocks): ``comm.prev_row(x)`` is the row before the block of the
    last pass's trajectory (zeros before the run), ``comm.max(x)`` and
    ``comm.min(x)`` reduce a ``[lanes]`` vector over the blocks; None is
    one block."""
    run = _TurnoverRun(signal, s, rows)
    sw = _parallel_sweeps(run.panels, s, run.zero_day, run.nan_sig_day, comm)
    d = run.signal.shape[1] if rows is None else rows.d_total

    def suffix(carry):
        out, carry = _parallel_suffix(run.panels, s, run.zero_day,
                                      run.nan_sig_day, sw, carry)
        stats = ([d + k * d + (d - t) for k, t in zip(sw.sweeps, sw.starts)],
                 sw.sweeps, sw.starts, [d - t for t in sw.starts])
        return run.outputs(out, stats), carry

    return suffix


def _turnover_scan(panels: _Panels, s: SimulationSettings, zero_day,
                   nan_sig_day, carry=None):
    """Every day in order, every lane in one solve a day, from ``carry``
    (the day before's weights and exit state; None: zeros and a cold
    state): ``(rows, (qp_solves, sweeps, converged_days, suffix_len),
    carry)``."""
    c, d, n = panels.signal.shape
    dev = panels.signal.device
    if carry is None:
        carry = (torch.zeros((c, n), dtype=QP_DTYPE, device=dev),
                 _cold_state(n, c, QP_DTYPE, dev))
    rows, carry = _sequential_days(panels, s, zero_day, nan_sig_day, 0,
                                   *carry)
    return rows, (d, 0, 0, d), carry


# the sweeps stop once the largest per-day move shrank by less than this
# factor in a pass: the error front then advances about a day a pass, and
# the sequential suffix is cheaper than more sweeps (the JAX package's
# docs/architecture.md section 14)
_STALL_RATIO = 0.5


def _index_put(full, ix, part):
    """``full`` (a tree of ``[C, ...]`` tensors) with the lanes ``ix``
    replaced by ``part``'s (``ix`` None: ``part`` is every lane)."""
    if ix is None:
        return part
    return _tree(lambda f, p: f.index_copy(0, ix, p), full, part)


class _Sweeps(NamedTuple):
    """The parallel scheme's passes over a block: each lane's last
    executed pass ``(w, resid, ok, state, telemetry)`` on the block's
    rows (None before any), its sweep count and its first unsettled day
    of the run."""

    last: tuple | None
    sweeps: list
    starts: list


def _parallel_sweeps(panels: _Panels, s: SimulationSettings, zero_day,
                     nan_sig_day, comm=None) -> _Sweeps:
    """The fixed-point scheme's seed and sweeps (module docstring) on
    every lane at once:

    1. seed: plain MVO of every day in chunks of ``mvo_batch`` cold lanes
       at ``resolved_seed_iters()``, polish off; zero days zeroed; one
       solve of ``C * count`` lanes a chunk;
    2. sweeps: each day re-solved against the last pass's row ``t-1``,
       warm-started from its own last exit state, at
       ``resolved_sweep_iters()`` with ``turnover_polish_passes``, the
       lanes still sweeping in one solve a chunk; after each pass the
       ``[C]`` largest per-day moves ``max |dw|`` are read on the host and
       a lane stops at ``<= turnover_tol`` or when its move exceeds
       ``_STALL_RATIO`` times its pass before's (never after the first);
       a stopped lane keeps what its last pass left;
    3. a lane's first unsettled day: the first whose last move exceeds
       ``turnover_tol`` (the run's end when none does).

    Under ``comm`` (:func:`turnover_parallel_blocks`) the panels are one
    block of the run: its first day's ``t-1`` row, the largest moves and
    the first unsettled days come over the blocks."""
    c, d, n = panels.signal.shape
    dev = panels.signal.device
    day0 = 0 if panels.rows_of is None else panels.rows_of.day0
    d_total = d if panels.rows_of is None else panels.rows_of.d_total
    batch = min(s.mvo_batch, d)
    chunks = [(first, min(batch, d - first)) for first in range(0, d, batch)]
    zeros = torch.zeros((c * batch, n), dtype=QP_DTYPE, device=dev)
    seed = []
    for first, count in chunks:
        w, resid, ok, state, tele = panels.solve(
            first, count, zeros[:c * count], s, False, None,
            iters=s.resolved_seed_iters(), polish=False)
        w = torch.where(panels.rows(zero_day, first, count)[:, None], 0.0, w)
        seed.append((w, state))
    traj, state = _cat(seed, c)

    # each lane's last executed pass, [C, D, ...]; every lane runs the
    # first pass
    last = None
    delta = torch.full((c, d), math.inf, dtype=QP_DTYPE, device=dev)
    sweeps, dmax_prev = [0] * c, [math.inf] * c
    running = tuple(range(c))
    for _ in range(s.turnover_sweeps):
        if not running:
            break
        lanes = None if len(running) == c else running
        ix = panels.subset(lanes)
        sub = (lambda x: x) if ix is None else (lambda x: x[ix])
        before = (zeros[:len(running)] if comm is None
                  else comm.prev_row(sub(traj)[:, -1]))
        w_prev = torch.cat([before[:, None], sub(traj)[:, :-1]], 1)
        warm = _tree(sub, state)
        out = _cat([_turnover_day_solve(
            panels, s, zero_day, nan_sig_day, first, count,
            w_prev[:, first:first + count].reshape(-1, n),
            ADMMWarmState(*(a[:, first:first + count]
                            .reshape((-1,) + a.shape[2:]) for a in warm)),
            lanes=lanes, iters=s.resolved_sweep_iters(),
            polish_passes=s.turnover_polish_passes)
            for first, count in chunks], len(running))
        moved = (out[0] - sub(traj)).abs().max(-1).values
        delta = _index_put(delta, ix, moved)
        last = _index_put(last, ix, out)
        traj, state = last[0], last[3]
        most = moved.max(-1).values
        if comm is not None:
            most = comm.max(most)
        still = []
        for lane, dmax in zip(running, most.tolist()):
            sweeps[lane] += 1
            if not (dmax <= s.turnover_tol
                    or dmax > _STALL_RATIO * dmax_prev[lane]):
                dmax_prev[lane] = dmax
                still.append(lane)
        running = tuple(still)

    # certified prefix: a lane's days before its first one that still moved
    bad = delta > s.turnover_tol
    first_bad = torch.where(bad.any(-1), bad.to(torch.int8).argmax(-1) + day0,
                            d_total)
    if comm is not None:
        first_bad = comm.min(first_bad)
    return _Sweeps(last, sweeps, first_bad.tolist())


def _parallel_suffix(panels: _Panels, s: SimulationSettings, zero_day,
                     nan_sig_day, sw: _Sweeps, carry=None):
    """The parallel scheme's suffix on the panels' days: one day loop from
    the earliest lane's first unsettled day, each date one solve of the
    lanes at or past their own start (the scan's day step at the
    settings' budgets), the lanes before theirs passing their certified
    row and exit state through; the loop enters with the day before's
    weights and exit state (``carry`` at the block's first day; zeros and
    a cold state at the run's). Returns ``(rows, carry)``, the carry the
    block's last day's. A lane with no certified day re-solves every day
    with the scan's day step, so its result is the scan bit for bit."""
    c, d, n = panels.signal.shape
    dev = panels.signal.device
    day0 = 0 if panels.rows_of is None else panels.rows_of.day0
    starts = [t - day0 for t in sw.starts]
    lo = min(max(min(starts), 0), d)
    rows = []
    if lo:
        w, resid, ok, state, tele = sw.last
        rows.append(_tree(lambda a: a[:, :lo].reshape((-1,) + a.shape[2:]),
                          (w, resid, ok, tele)))
    if lo == d:
        return rows, (sw.last[0][:, d - 1],
                      ADMMWarmState(*(a[:, d - 1] for a in sw.last[3])))
    if lo:
        w_prev = sw.last[0][:, lo - 1]
        warm = ADMMWarmState(*(a[:, lo - 1] for a in sw.last[3]))
    elif carry is not None:
        w_prev, warm = carry
    else:
        w_prev = torch.zeros((c, n), dtype=QP_DTYPE, device=dev)
        warm = _cold_state(n, c, QP_DTYPE, dev)
    for today in range(lo, d):
        lanes = tuple(i for i in range(c) if starts[i] <= today)
        if len(lanes) == c:
            w, resid, ok, warm, tele = _turnover_day_solve(
                panels, s, zero_day, nan_sig_day, today, 1, w_prev, warm)
        else:
            # the lanes before their start pass their certified row through
            ix = panels.subset(lanes)
            w, resid, ok, warm, tele = _index_put(
                _tree(lambda a: a[:, today], sw.last), ix,
                _turnover_day_solve(
                    panels, s, zero_day, nan_sig_day, today, 1, w_prev[ix],
                    _tree(lambda a: a[ix], warm), lanes=lanes))
        rows.append((w, resid, ok, tele))
        w_prev = w
    return rows, (w_prev, warm)


def _no_hist_days(days: torch.Tensor, s: SimulationSettings):
    """Which of the dates ``days`` fall to the equal scheme for lack of
    history: day 0 under the sample window; the whole first refit block
    under the risk model."""
    if s.covariance == "risk_model":
        return days < s.risk_refit_every
    return days == 0


def _finalize(w, signal, s, pos, neg, flat, resid, ok, tele, stats, days):
    zero_day = flat | (_universe_count(signal, s) < 2)
    w = torch.where(zero_day[..., None], 0.0, w)
    zero = torch.zeros_like(pos.sum(-1))
    lc = pos.sum(-1)
    sc = neg.sum(-1)
    # no-history days fall back to the equal scheme: its k counts
    no_hist = _no_hist_days(days, s)
    pct = knob(s.pct, lc, torch.get_default_dtype())
    k_long = torch.clamp(torch.floor(lc * pct), min=1.0).to(lc.dtype)
    k_short = torch.clamp(torch.floor(sc * pct), min=1.0).to(sc.dtype)
    lc = torch.where(no_hist, k_long, lc)
    sc = torch.where(no_hist, k_short, sc)
    ok = ok | zero_day | no_hist
    dead = zero_day | no_hist
    polished, pre, post, acc, rej, itc = tele
    zero_i = torch.zeros((), dtype=acc.dtype, device=acc.device)
    tele = (polished & ~dead, torch.where(dead, float("nan"), pre),
            torch.where(dead, float("nan"), post),
            torch.where(dead, zero_i, acc), torch.where(dead, zero_i, rej),
            torch.where(dead, zero_i, itc))
    return (w, torch.where(zero_day, zero, lc), torch.where(zero_day, zero, sc),
            resid, ok, tele, stats)
