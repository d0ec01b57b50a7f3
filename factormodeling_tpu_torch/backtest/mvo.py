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
the host's day loop once). ``turnover_mode="parallel"`` runs its lanes one
after another.

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

__all__ = ["mvo_turnover_weights", "mvo_weights"]

_JITTER = 1e-6

#: working precision of the MVO QPs and risk-model fits (see the module
#: docstring)
QP_DTYPE = torch.float64


def _window_factors(returns0: torch.Tensor, todays: torch.Tensor,
                    lookback: int, lane_ix: torch.Tensor | None = None):
    """(C [B, L, N], t_used [B]) of the factored covariance for the dates
    ``todays`` (``[B]``, on the device): the centered zero-filled window of
    (at most ``lookback``) return rows strictly before each date —
    ``returns0`` is the NaN-zeroed panel, ``[D, N]`` shared by every solve
    lane or ``[C, D, N]`` one a lane, and then ``lane_ix [B]`` names each
    solve lane's — and the usable-row count."""
    d, n = returns0.shape[-2:]
    lookback = min(lookback, d)
    start = torch.clamp(todays - lookback, min=0)
    t_used = todays - start
    offs = torch.arange(lookback, device=returns0.device)
    used = (offs[None, :] < t_used[:, None])[..., None]        # [B, L, 1]
    idx = torch.clamp(start[:, None] + offs[None, :], max=d - 1)
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


def _risk_model_stack(returns: torch.Tensor, s: SimulationSettings):
    """Rolling refits of the statistical risk model, stacked along a refit
    axis ``R = ceil(D / risk_refit_every)``: ``(loadings [R, N, k],
    factor_var [R, k], idio [R, N])``; ``[C, D, N]`` returns (one panel a
    lane) give one stack a lane, ``[C, R, ...]``.

    Model ``j`` is fit on the (at most ``risk_lookback``) rows of
    ``returns`` (with NaN) strictly before day ``j * risk_refit_every``,
    NaN-padded to ``risk_lookback`` rows, so no estimate sees its own block;
    block 0's model is fit on no rows and its days take the no-history
    ladder."""
    if returns.ndim == 3:
        return tuple(torch.stack(col) for col in
                     zip(*(_risk_model_stack(r, s) for r in returns)))
    d, n = returns.shape
    lb = min(s.risk_lookback, d)
    out = []
    for day in range(0, d, s.risk_refit_every):
        start = max(day - lb, 0)
        n_used = day - start
        rows = torch.full((lb, n), float("nan"), dtype=returns.dtype,
                          device=returns.device)
        rows[:n_used] = returns[start:day]
        m = _risk.statistical_risk_model(rows, s.risk_factors)
        # the model's factor variances divide by (lb - 1) whatever the
        # padding: rescale to the observed rows' denominator
        scale = (lb - 1.0) / max(n_used - 1.0, 1.0)
        out.append((m.loadings, m.factor_var * scale, m.idio_var))
    return tuple(torch.stack(col) for col in zip(*out))


def _risk_model_for_day(stacks, todays: torch.Tensor, s: SimulationSettings,
                        lane_ix: torch.Tensor | None = None):
    """The dates' ``(loadings [B, N, k], factor_var [B, k], idio [B, N],
    history [B])`` from the refit stack (a lane stack reads each solve
    lane's own, ``lane_ix [B]``); ``history`` is the row count behind each
    block's fit, which drives the ladder like the sample window's
    ``t_used``."""
    loadings_s, fvar_s, idio_s = stacks
    j = torch.div(todays, s.risk_refit_every, rounding_mode="floor")
    hist = torch.clamp(j * s.risk_refit_every,
                       max=min(s.risk_lookback, s.returns.shape[-2]))
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
               lane_ix: torch.Tensor | None = None):
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
    budgets)."""
    dtype = returns0.dtype
    lanes, n = signal_rows.shape
    pos = signal_rows > 0
    neg = signal_rows < 0
    if risk_model is None:
        c, t_used = _window_factors(returns0, todays, s.lookback_period,
                                    lane_ix)
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
    (solve lane ``b`` is lane ``b // count``, date ``first + b % count``)."""

    def __init__(self, signal: torch.Tensor, s: SimulationSettings):
        dev = signal.device
        self.signal = signal.to(QP_DTYPE)
        self.lanes = signal.shape[0]
        self.returns0 = torch.nan_to_num(s.returns).to(QP_DTYPE)
        self.stacks = (_risk_model_stack(s.returns.to(QP_DTYPE), s)
                       if s.covariance == "risk_model" else None)
        self.b = torch.tensor([1.0, -1.0], dtype=QP_DTYPE, device=dev)
        self.days = torch.arange(signal.shape[1], device=dev)
        self._by_count: dict = {}

    def rows(self, x: torch.Tensor, first: int, count: int) -> torch.Tensor:
        """``x [C, D, ...]`` at the dates ``first .. first + count - 1`` as
        solve lanes ``[C * count, ...]``."""
        return x[:, first:first + count].reshape((-1,) + x.shape[2:])

    def _lanes_of(self, count: int, s: SimulationSettings):
        """The solve lanes' lane index and settings for ``count`` dates (a
        run has at most two widths: its chunks and a ragged tail)."""
        if count not in self._by_count:
            lane_ix = torch.arange(self.lanes, device=self.days.device) \
                .repeat_interleave(count)
            self._by_count[count] = (
                lane_ix, s.lane_view(lane_ix) if s.lanes() else s)
        return self._by_count[count]

    def solve(self, first: int, count: int, w_prev, s: SimulationSettings,
              turnover: bool, warm, force_fallback=None, **overrides):
        """:func:`_solve_day` of the dates ``first .. first + count - 1`` of
        every lane; ``force_fallback`` is a ``[C, D]`` mask; ``overrides``
        are its ``iters``/``polish``/``polish_passes``."""
        lane_ix, s_lanes = self._lanes_of(count, s)
        todays = self.days[first:first + count]
        if self.lanes > 1:
            todays = todays.repeat(self.lanes)
        rm = (None if self.stacks is None
              else _risk_model_for_day(self.stacks, todays, s, lane_ix))
        # the dates without history: day 0, or the first refit block
        no_hist = s.risk_refit_every if self.stacks is not None else 1
        return _solve_day(
            self.rows(self.signal, first, count), self.returns0, todays,
            w_prev, s_lanes, self.b, turnover, risk_model=rm,
            warm=warm if s.qp_warm_start else None,
            force_fallback=(None if force_fallback is None
                            else self.rows(force_fallback, first, count)),
            may_lack_history=first < no_hist, lane_ix=lane_ix, **overrides)


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
    return SchemeStats(*(torch.full((lanes,), v, dtype=torch.int32,
                                    device=device) for v in values))


def _lanes_in(signal: torch.Tensor):
    """``(signal [C, D, N], unbatched)``: an unbatched ``[D, N]`` call runs
    as one lane and its outputs drop the axis again."""
    if signal.ndim == 3:
        return signal, False
    return signal[None], True


def _lane_out(out, unbatched: bool):
    return _tree(lambda a: a[0], out) if unbatched else out


def mvo_weights(signal: torch.Tensor, s: SimulationSettings):
    """Per-date minimum-variance weights: chunks of ``mvo_batch`` dates
    solve as one lane batch (every lane's, for ``[C, D, N]`` lanes); lane
    ``i`` of a chunk warm-starts from lane ``i`` of the chunk before
    (disable with ``qp_warm_start=False``), and the ragged tail is a
    narrower chunk on the first lanes' chains. Returns ``(weights [D, N],
    long_count [D], short_count [D], resid, ok, telemetry, stats)``, with
    the leading ``C`` under lanes; ``stats.qp_solves == D``."""
    signal, unbatched = _lanes_in(signal)
    c, d, n = signal.shape
    pos, neg, flat = leg_masks(signal)
    panels = _Panels(signal, s)
    batch = min(s.mvo_batch, d)
    warm = _cold_state(n, c * batch, QP_DTYPE, signal.device)
    zeros = torch.zeros((c * batch, n), dtype=QP_DTYPE, device=signal.device)
    rows = []
    for first in range(0, d, batch):
        count = min(batch, d - first)
        lane_warm = ADMMWarmState(*(
            a.reshape((c, batch) + a.shape[1:])[:, :count]
            .reshape((c * count,) + a.shape[1:]) for a in warm))
        w, resid, ok, state, tele = panels.solve(first, count,
                                                 zeros[:c * count], s, False,
                                                 lane_warm)
        rows.append((w, resid, ok, tele))
        if count == batch:
            warm = state
    w, resid, ok, tele = _stack_rows(rows, s.returns.dtype, c)
    stats = _scheme_stats((d, 0, 0, 0), c, signal.device)
    return _lane_out(_finalize(w, signal, s, pos, neg, flat, resid, ok, tele,
                               stats), unbatched)


def _turnover_day_solve(panels: _Panels, s: SimulationSettings, zero_day,
                        nan_sig_day, first: int, count: int, w_prev, warm,
                        **overrides):
    """THE turnover day step, for the dates ``first .. first + count - 1``
    of every lane: the solve with the NaN-signal rejection, then zero days
    zeroed. The scan, the parallel sweeps and the parallel suffix all run
    it, so they cannot drift apart; ``overrides`` as in
    :meth:`_Panels.solve`."""
    w, resid, ok, state, tele = panels.solve(
        first, count, w_prev, s, True, warm, nan_sig_day, **overrides)
    # the reference reads the last stored row as yesterday's weights, which
    # is the zero row on flat days
    w = torch.where(panels.rows(zero_day, first, count)[:, None], 0.0, w)
    return w, resid, ok, state, tele


def _sequential_days(panels: _Panels, s: SimulationSettings, zero_day,
                     nan_sig_day, start: int, w_prev, warm) -> list:
    """The days ``start .. D-1`` one after another at the settings'
    budgets, each on the day before's weights and solver exit state, every
    lane in one solve a day; ``(w, resid, ok, telemetry)`` rows, one a
    day."""
    rows = []
    for today in range(start, panels.days.shape[0]):
        w, resid, ok, warm, tele = _turnover_day_solve(
            panels, s, zero_day, nan_sig_day, today, 1, w_prev, warm)
        rows.append((w, resid, ok, tele))
        w_prev = w
    return rows


def mvo_turnover_weights(signal: torch.Tensor, s: SimulationSettings):
    """Turnover-penalized weights: yesterday's (pre-shift) weights feed
    today's L1 turnover term, and each day warm-starts from yesterday's
    solver exit state (disable with ``qp_warm_start=False``).
    ``s.turnover_mode`` picks the scheme: ``"scan"``, the days in order, or
    ``"parallel"``, the fixed-point sweeps with the scan for the days they
    do not certify (module docstring). Returns ``(weights [D, N],
    long_count [D], short_count [D], resid, ok, telemetry, stats)``, with
    the leading ``C`` under ``[C, D, N]`` lanes: the scan runs one day loop
    for every lane, one solve of ``C`` lanes a date; the parallel scheme
    runs its lanes one after another."""
    if s.turnover_mode == "parallel" and signal.ndim == 3:
        c = signal.shape[0]
        outs = [mvo_turnover_weights(signal[i], s.lane(i, c))
                for i in range(c)]
        return _tree(lambda *xs: torch.stack(xs), *outs)
    signal, unbatched = _lanes_in(signal)
    c, d, n = signal.shape
    pos, neg, flat = leg_masks(signal)
    zero_day = flat | (_universe_count(signal, s) < 2)
    nan_sig_day = _nan_signal_days(signal, s).expand(c, d)
    panels = _Panels(signal, s)
    days = (_turnover_parallel if s.turnover_mode == "parallel"
            else _turnover_scan)
    rows, stats = days(panels, s, zero_day, nan_sig_day)
    w, resid, ok, tele = _stack_rows(rows, s.returns.dtype, c)
    stats = _scheme_stats(stats, c, signal.device)
    return _lane_out(_finalize(w, signal, s, pos, neg, flat, resid, ok, tele,
                               stats), unbatched)


def _turnover_scan(panels: _Panels, s: SimulationSettings, zero_day,
                   nan_sig_day):
    """Every day in order, every lane in one solve a day: ``(rows,
    (qp_solves, sweeps, converged_days, suffix_len))``."""
    c, d, n = panels.signal.shape
    dev = panels.signal.device
    rows = _sequential_days(panels, s, zero_day, nan_sig_day, 0,
                            torch.zeros((c, n), dtype=QP_DTYPE, device=dev),
                            _cold_state(n, c, QP_DTYPE, dev))
    return rows, (d, 0, 0, d)


# the sweeps stop once the largest per-day move shrank by less than this
# factor in a pass: the error front then advances about a day a pass, and
# the sequential suffix is cheaper than more sweeps (the JAX package's
# docs/architecture.md section 14)
_STALL_RATIO = 0.5


def _turnover_parallel(panels: _Panels, s: SimulationSettings, zero_day,
                       nan_sig_day):
    """The fixed-point scheme (module docstring) on one lane: ``(rows,
    (qp_solves, sweeps, converged_days, suffix_len))``.

    1. seed: plain MVO of every day in chunks of ``mvo_batch`` cold lanes
       at ``resolved_seed_iters()``, polish off; zero days zeroed;
    2. sweeps: each day re-solved against the last pass's row ``t-1``,
       warm-started from its own last exit state, at
       ``resolved_sweep_iters()`` with ``turnover_polish_passes``; after
       each pass its largest per-day move ``max |dw|`` is read on the host
       and the passes stop at ``<= turnover_tol`` or when it exceeds
       ``_STALL_RATIO`` times the pass before's (never after the first);
    3. the days before the first one whose last move exceeds
       ``turnover_tol`` keep the last pass's results; from that day on the
       scan's day loop runs at the settings' budgets, entering with the day
       before's weights and exit state (zeros and a cold state at day 0).

    The sequential days are the scan's own loop, so a run with no
    certified day is the scan bit for bit."""
    _, d, n = panels.signal.shape
    dev = panels.signal.device
    zero_day = zero_day[0]
    batch = min(s.mvo_batch, d)
    chunks = [(first, min(batch, d - first)) for first in range(0, d, batch)]
    zeros = torch.zeros((batch, n), dtype=QP_DTYPE, device=dev)
    seed = []
    for first, count in chunks:
        w, resid, ok, state, tele = panels.solve(
            first, count, zeros[:count], s, False, None,
            iters=s.resolved_seed_iters(), polish=False)
        w = torch.where(zero_day[first:first + count, None], 0.0, w)
        seed.append((w, resid, ok, state, tele))
    traj, _, _, state, _ = _cat(seed)

    last = None
    delta = torch.full((d,), math.inf, dtype=QP_DTYPE, device=dev)
    sweeps, dmax_prev = 0, math.inf
    for _ in range(s.turnover_sweeps):
        w_prev = torch.cat([zeros[:1], traj[:-1]])
        last = _cat([_turnover_day_solve(
            panels, s, zero_day[None], nan_sig_day, first, count,
            w_prev[first:first + count],
            ADMMWarmState(*(a[first:first + count] for a in state)),
            iters=s.resolved_sweep_iters(),
            polish_passes=s.turnover_polish_passes)
            for first, count in chunks])
        delta = (last[0] - traj).abs().max(-1).values
        traj, state = last[0], last[3]
        sweeps += 1
        dmax = float(delta.max())
        if dmax <= s.turnover_tol or dmax > _STALL_RATIO * dmax_prev:
            break
        dmax_prev = dmax

    # certified prefix: the days before the first one that still moved
    moved = torch.nonzero(delta > s.turnover_tol)
    start = int(moved[0, 0]) if moved.shape[0] else d
    rows = []
    if start:
        w, resid, ok, state, tele = last
        rows.append((w[:start], resid[:start], ok[:start],
                     tuple(t[:start] for t in tele)))
        w_prev = w[start - 1:start]
        warm = ADMMWarmState(*(a[start - 1:start] for a in state))
    else:
        w_prev, warm = zeros[:1], _cold_state(n, 1, QP_DTYPE, dev)
    rows += _sequential_days(panels, s, zero_day[None], nan_sig_day, start,
                             w_prev, warm)
    return rows, (d + sweeps * d + (d - start), sweeps, start, d - start)


def _no_hist_days(d: int, s: SimulationSettings, device):
    """Days that fall to the equal scheme for lack of history: day 0 under
    the sample window; the whole first refit block under the risk model."""
    days = torch.arange(d, device=device)
    if s.covariance == "risk_model":
        return days < s.risk_refit_every
    return days == 0


def _finalize(w, signal, s, pos, neg, flat, resid, ok, tele, stats):
    zero_day = flat | (_universe_count(signal, s) < 2)
    w = torch.where(zero_day[..., None], 0.0, w)
    zero = torch.zeros_like(pos.sum(-1))
    lc = pos.sum(-1)
    sc = neg.sum(-1)
    # no-history days fall back to the equal scheme: its k counts
    no_hist = _no_hist_days(signal.shape[-2], s, signal.device)
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
