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
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
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
                    lookback: int):
    """(C [B, L, N], t_used [B]) of the factored covariance for the dates
    ``todays`` (``[B]``, on the device): the centered zero-filled window of
    (at most ``lookback``) return rows strictly before each date —
    ``returns0`` is the NaN-zeroed panel — and the usable-row count."""
    d, n = returns0.shape
    lookback = min(lookback, d)
    start = torch.clamp(todays - lookback, min=0)
    t_used = todays - start
    offs = torch.arange(lookback, device=returns0.device)
    used = (offs[None, :] < t_used[:, None])[..., None]        # [B, L, 1]
    rows = returns0[torch.clamp(start[:, None] + offs[None, :], max=d - 1)]
    rows = torch.where(used, rows, 0.0)
    mean = rows.sum(1, keepdim=True) / torch.clamp(t_used, min=1)[:, None, None]
    return torch.where(used, rows - mean, 0.0), t_used


def _shrunk_terms(c: torch.Tensor, t_used: torch.Tensor, lam: float):
    """alpha and per-row scale of Sigma_shrunk = alpha I + s C'C, per lane
    (``[B]`` each)."""
    denom = torch.clamp(t_used - 1, min=1).to(c.dtype)
    s_row = (1.0 - lam) / denom
    avg_var = (c * c).sum((-2, -1)) / denom / c.shape[-1] + _JITTER
    alpha = (1.0 - lam) * _JITTER + lam * avg_var
    return alpha, s_row


def _risk_model_stack(returns: torch.Tensor, s: SimulationSettings):
    """Rolling refits of the statistical risk model, stacked along a refit
    axis ``R = ceil(D / risk_refit_every)``: ``(loadings [R, N, k],
    factor_var [R, k], idio [R, N])``.

    Model ``j`` is fit on the (at most ``risk_lookback``) rows of
    ``returns`` (with NaN) strictly before day ``j * risk_refit_every``,
    NaN-padded to ``risk_lookback`` rows, so no estimate sees its own block;
    block 0's model is fit on no rows and its days take the no-history
    ladder."""
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


def _risk_model_for_day(stacks, todays: torch.Tensor, s: SimulationSettings):
    """The dates' ``(loadings [B, N, k], factor_var [B, k], idio [B, N],
    history [B])`` from the refit stack; ``history`` is the row count behind
    each block's fit, which drives the ladder like the sample window's
    ``t_used``."""
    loadings_s, fvar_s, idio_s = stacks
    j = torch.div(todays, s.risk_refit_every, rounding_mode="floor")
    hist = torch.clamp(j * s.risk_refit_every,
                       max=min(s.risk_lookback, s.returns.shape[0]))
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
               polish: bool | None = None, polish_passes: int | None = None):
    """One lane-batched solve of the dates ``todays`` with the full fallback
    ladder. ``signal_rows``/``w_prev`` are ``[B, N]`` in the QP dtype;
    ``risk_model`` is ``None`` (the sample covariance) or the dates'
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
        c, t_used = _window_factors(returns0, todays, s.lookback_period)
        alpha, s_row = _shrunk_terms(c, t_used, s.shrinkage_intensity)
        s_vec = torch.where(
            torch.arange(c.shape[1], device=c.device)[None, :] < t_used[:, None],
            s_row[:, None], 0.0)
    else:
        loadings, factor_var, idio, t_used = risk_model
        alpha, c, s_vec = idio, loadings.mT, factor_var   # V = B': [B, k, N]

    lo, hi, E, b = leg_constraints(signal_rows, s.max_weight, dtype, b=b)
    if turnover:
        q = (-s.return_weight) * torch.nan_to_num(signal_rows)
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
    """What every solve of one run shares: the QP-dtype panels, the risk
    model's refit stack, and the leg equality right-hand side."""

    def __init__(self, signal: torch.Tensor, s: SimulationSettings):
        dev = signal.device
        self.signal = signal.to(QP_DTYPE)
        self.returns0 = torch.nan_to_num(s.returns).to(QP_DTYPE)
        self.stacks = (_risk_model_stack(s.returns.to(QP_DTYPE), s)
                       if s.covariance == "risk_model" else None)
        self.b = torch.tensor([1.0, -1.0], dtype=QP_DTYPE, device=dev)
        self.days = torch.arange(signal.shape[0], device=dev)

    def solve(self, first: int, count: int, w_prev, s: SimulationSettings,
              turnover: bool, warm, force_fallback=None, **overrides):
        """:func:`_solve_day` of the dates ``first .. first + count - 1``;
        ``overrides`` are its ``iters``/``polish``/``polish_passes``."""
        todays = self.days[first:first + count]
        rm = (None if self.stacks is None
              else _risk_model_for_day(self.stacks, todays, s))
        # the dates without history: day 0, or the first refit block
        no_hist = s.risk_refit_every if self.stacks is not None else 1
        return _solve_day(self.signal[first:first + count], self.returns0,
                          todays, w_prev, s, self.b, turnover, risk_model=rm,
                          warm=warm if s.qp_warm_start else None,
                          force_fallback=force_fallback,
                          may_lack_history=first < no_hist, **overrides)


def _cat(rows):
    """Per-solve outputs (tuples of tensors, nested tuples such as the warm
    state and the telemetry) concatenated along the date axis, field by
    field."""
    if isinstance(rows[0], torch.Tensor):
        return torch.cat(rows)
    fields = [_cat(col) for col in zip(*rows)]
    return (type(rows[0])(*fields) if hasattr(rows[0], "_fields")
            else tuple(fields))


def _stack_rows(rows, out_dtype):
    """Concatenate per-solve outputs ``(w, resid, ok, telemetry)`` along
    the date axis; float outputs go back to the panels' dtype."""
    w, resid, ok, (polished, pre, post, acc, rej, itc) = _cat(rows)
    return (w.to(out_dtype), resid.to(out_dtype), ok,
            (polished, pre.to(out_dtype), post.to(out_dtype), acc, rej, itc))


def mvo_weights(signal: torch.Tensor, s: SimulationSettings):
    """Per-date minimum-variance weights: chunks of ``mvo_batch`` dates
    solve as one lane batch; lane ``i`` warm-starts from lane ``i`` of the
    chunk before (disable with ``qp_warm_start=False``), and the ragged
    tail is a narrower chunk on the first lanes' chains. Returns
    ``(weights [D, N], long_count [D], short_count [D], resid, ok,
    telemetry, stats)``; ``stats.qp_solves == D``."""
    d, n = signal.shape
    pos, neg, flat = leg_masks(signal)
    panels = _Panels(signal, s)
    batch = min(s.mvo_batch, d)
    warm = _cold_state(n, batch, QP_DTYPE, signal.device)
    zeros = torch.zeros((batch, n), dtype=QP_DTYPE, device=signal.device)
    rows = []
    for first in range(0, d, batch):
        count = min(batch, d - first)
        lane_warm = ADMMWarmState(*(a[:count] for a in warm))
        w, resid, ok, state, tele = panels.solve(first, count, zeros[:count],
                                                 s, False, lane_warm)
        rows.append((w, resid, ok, tele))
        if count == batch:
            warm = state
    w, resid, ok, tele = _stack_rows(rows, s.returns.dtype)
    stats = SchemeStats(*(torch.tensor(v, dtype=torch.int32,
                                       device=signal.device)
                          for v in (d, 0, 0, 0)))
    return _finalize(w, signal, s, pos, neg, flat, resid, ok, tele, stats)


def _turnover_day_solve(panels: _Panels, s: SimulationSettings, zero_day,
                        nan_sig_day, first: int, count: int, w_prev, warm,
                        **overrides):
    """THE turnover day step, for the dates ``first .. first + count - 1``:
    the solve with the NaN-signal rejection, then zero days zeroed. The
    scan, the parallel sweeps and the parallel suffix all run it, so they
    cannot drift apart; ``overrides`` as in :meth:`_Panels.solve`."""
    w, resid, ok, state, tele = panels.solve(
        first, count, w_prev, s, True, warm,
        nan_sig_day[first:first + count], **overrides)
    # the reference reads the last stored row as yesterday's weights, which
    # is the zero row on flat days
    w = torch.where(zero_day[first:first + count, None], 0.0, w)
    return w, resid, ok, state, tele


def _sequential_days(panels: _Panels, s: SimulationSettings, zero_day,
                     nan_sig_day, start: int, w_prev, warm) -> list:
    """The days ``start .. D-1`` one after another at the settings'
    budgets, each on the day before's weights and solver exit state;
    ``(w, resid, ok, telemetry)`` rows, one a day."""
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
    long_count [D], short_count [D], resid, ok, telemetry, stats)``."""
    d, n = signal.shape
    pos, neg, flat = leg_masks(signal)
    zero_day = flat | (_universe_count(signal, s) < 2)
    nan_sig_day = _nan_signal_days(signal, s)
    panels = _Panels(signal, s)
    days = (_turnover_parallel if s.turnover_mode == "parallel"
            else _turnover_scan)
    rows, stats = days(panels, s, zero_day, nan_sig_day)
    w, resid, ok, tele = _stack_rows(rows, s.returns.dtype)
    stats = SchemeStats(*(torch.tensor(v, dtype=torch.int32,
                                       device=signal.device) for v in stats))
    return _finalize(w, signal, s, pos, neg, flat, resid, ok, tele, stats)


def _turnover_scan(panels: _Panels, s: SimulationSettings, zero_day,
                   nan_sig_day):
    """Every day in order: ``(rows, (qp_solves, sweeps, converged_days,
    suffix_len))``."""
    d, n = panels.signal.shape
    dev = panels.signal.device
    rows = _sequential_days(panels, s, zero_day, nan_sig_day, 0,
                            torch.zeros((1, n), dtype=QP_DTYPE, device=dev),
                            _cold_state(n, 1, QP_DTYPE, dev))
    return rows, (d, 0, 0, d)


# the sweeps stop once the largest per-day move shrank by less than this
# factor in a pass: the error front then advances about a day a pass, and
# the sequential suffix is cheaper than more sweeps (the JAX package's
# docs/architecture.md section 14)
_STALL_RATIO = 0.5


def _turnover_parallel(panels: _Panels, s: SimulationSettings, zero_day,
                       nan_sig_day):
    """The fixed-point scheme (module docstring): ``(rows, (qp_solves,
    sweeps, converged_days, suffix_len))``.

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
    d, n = panels.signal.shape
    dev = panels.signal.device
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
            panels, s, zero_day, nan_sig_day, first, count,
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
    rows += _sequential_days(panels, s, zero_day, nan_sig_day, start, w_prev,
                             warm)
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
    no_hist = _no_hist_days(signal.shape[0], s, signal.device)
    k_long = torch.clamp(torch.floor(lc * s.pct), min=1.0).to(lc.dtype)
    k_short = torch.clamp(torch.floor(sc * s.pct), min=1.0).to(sc.dtype)
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
