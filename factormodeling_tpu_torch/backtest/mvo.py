"""The turnover-penalized MVO weight scheme (port of
``factormodeling_tpu/backtest/mvo.py``: ``mvo_turnover`` in ``scan`` mode
with the trailing sample covariance).

Each date's covariance keeps the factored form

    Sigma_shrunk = alpha I + s C'C,
    alpha = (1 - lam) * 1e-6 + lam * mean(diag(sample + 1e-6 I)),
    s     = (1 - lam) / (T - 1),   C = centered zero-filled window rows,

which the ADMM solver consumes through a Woodbury identity. Yesterday's
weights enter today's L1 term, so the days run in order: the JAX
``lax.scan`` becomes a Python loop over dates whose every ladder decision is
a ``torch.where`` on the device, so the loop queues work and never waits on
the card. Fallback ladder: either leg empty or < 2 names -> flat day; no
prior dates -> equal-scheme weights; one prior date, a NaN signal on a
present name, solver failure or infeasible caps -> equal weight per leg.

The QP runs in float64 whatever the panels' dtype (:data:`QP_DTYPE`); the
weights come back in the panels' dtype. With the reference's numbers
(turnover penalty 0.1 per unit of weight moved, daily return variances of
order 4e-4 on weights of order 1/N) the L1 term dwarfs the variance term,
so a day's QP is close to a degenerate
LP whose ties only the variance term breaks; float32 cannot resolve that
tie-break, and a float32 solve picks another optimal vertex than the float64
solve on most days once one day differs (yesterday's weights are today's L1
center, so a difference persists). Measured on an H100 at 1332 days x 1000
names (``python -m factormodeling_tpu_torch.qp_precision``): the same
kernel in float32 vs float64 differed by > 1e-4 on 66-68% of days, the two
kernels in float32 on 99.7%; in float64 the two kernels agree exactly. The
day loop is launch-bound, so float64 costs no time that matters.

Not ported yet: plain ``mvo``, ``turnover_mode="parallel"`` and
``covariance="risk_model"``.
"""

from __future__ import annotations

import torch

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

__all__ = ["mvo_turnover_weights"]

_JITTER = 1e-6

#: working precision of the turnover QP (see the module docstring)
QP_DTYPE = torch.float64


def _window_factors(returns0: torch.Tensor, today: int, lookback: int):
    """(C, t_used) of the factored covariance for one date: the centered
    zero-filled window of (at most ``lookback``) return rows strictly before
    ``today`` — ``returns0`` is the NaN-zeroed panel — and the usable-row
    count. ``today`` is a host integer: the window's placement depends only
    on the date index, never on the data."""
    d, n = returns0.shape
    lookback = min(lookback, d)
    start = max(today - lookback, 0)
    t_used = today - start
    c = torch.zeros((lookback, n), dtype=returns0.dtype, device=returns0.device)
    rows = returns0[start:start + t_used]
    mean = rows.sum(0, keepdim=True) / max(t_used, 1)
    c[:t_used] = rows - mean
    return c, t_used


def _shrunk_terms(c: torch.Tensor, t_used: int, lam: float):
    """alpha and per-row scale of Sigma_shrunk = alpha I + s C'C."""
    denom = float(max(t_used - 1, 1))
    s_row = (1.0 - lam) / denom
    avg_var = (c * c).sum() / denom / c.shape[1] + _JITTER
    alpha = (1.0 - lam) * _JITTER + lam * avg_var
    return alpha, s_row


def _solve_day(signal_row: torch.Tensor, returns0: torch.Tensor, today: int,
               w_prev: torch.Tensor, s: SimulationSettings, b: torch.Tensor,
               warm: ADMMWarmState | None, force_fallback: torch.Tensor):
    """One turnover day's solve with the full fallback ladder. Returns
    ``(w [N], primal_residual [], solver_ok [], warm_state, polish)`` with
    ``polish = (polished, pre_residual, post_residual)``."""
    dtype = returns0.dtype
    pos = signal_row > 0
    neg = signal_row < 0
    c, t_used = _window_factors(returns0, today, s.lookback_period)
    alpha, s_row = _shrunk_terms(c, t_used, s.shrinkage_intensity)
    s_vec = torch.zeros(c.shape[0], dtype=dtype, device=c.device)
    s_vec[:t_used] = s_row

    lo, hi, E, b = leg_constraints(signal_row, s.max_weight, dtype, b=b)
    q = (-s.return_weight) * torch.nan_to_num(signal_row).to(dtype)
    # the reference objective is w' Sigma w (not halved) plus the L1 term;
    # the solver minimizes 1/2 x'Px + ..., so P = 2 Sigma
    prob = BoxQPProblem(q=q, lo=lo, hi=hi, E=E, b=b, l1=s.turnover_penalty,
                        center=w_prev.to(dtype))
    res = admm_solve_lowrank(2.0 * alpha, c, 2.0 * s_vec, prob, rho=s.qp_rho,
                             iters=s.resolved_qp_iters(True), warm_start=warm,
                             polish=s.qp_polish, kernel=s.solver_kernel)
    w = res.x

    solver_ok = (torch.isfinite(w).all() & legs_feasible(signal_row, s.max_weight)
                 & ~force_fallback)
    if t_used < 2:
        solver_ok = solver_ok & False
    w = torch.where(solver_ok, w, _x0_legs(signal_row))

    # post-solve pruning + per-leg renorm
    pruned = torch.where(torch.abs(w) < 1e-6, 0.0, w)
    long_den = torch.where(pos, pruned, 0.0).sum()
    short_den = -torch.where(neg, pruned, 0.0).sum()
    renorm = torch.where(
        pos, pruned / torch.where(long_den > 0, long_den, 1.0),
        torch.where(neg, pruned / torch.where(short_den > 0, short_den, 1.0),
                    0.0))
    w = torch.where(solver_ok & (long_den > 0) & (short_den > 0), renorm, w)

    if t_used < 1:   # no history at all -> equal-scheme fallback
        w = equal_weights(signal_row[None, :], s.pct)[0][0]
    nan = torch.full((), float("nan"), dtype=dtype, device=w.device)
    solved = solver_ok & (t_used >= 2)
    resid = res.primal_residual if t_used >= 2 else nan
    polish = (res.polished & solved,
              torch.where(solved, res.polish_pre_residual, nan),
              torch.where(solved, res.polish_post_residual, nan))
    # a rejected solve's iterates describe a discarded problem: reset cold
    state = ADMMWarmState(z=torch.where(solver_ok, res.z, 0.0),
                          u=torch.where(solver_ok, res.u, 0.0),
                          rho=torch.where(solver_ok, res.rho, nan))
    return w, resid, solver_ok | (t_used < 2), state, polish


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


def mvo_turnover_weights(signal: torch.Tensor, s: SimulationSettings):
    """Turnover-penalized weights: yesterday's (pre-shift) weights feed
    today's L1 turnover term, and each day warm-starts from yesterday's
    solver exit state (disable with ``qp_warm_start=False``). Returns
    ``(weights [D, N], long_count [D], short_count [D], resid, ok, polish,
    stats)``."""
    if s.turnover_mode != "scan":
        raise NotImplementedError(
            "turnover_mode='parallel' is not ported yet (see ROADMAP.md)")
    if s.covariance != "sample":
        raise NotImplementedError(
            "covariance='risk_model' is not ported yet (see ROADMAP.md)")
    if s.qp_anderson:
        raise NotImplementedError(
            "the Anderson-accelerated solver (qp_anderson > 0) is not ported "
            "yet (see ROADMAP.md)")
    d, n = signal.shape
    dtype, dev = QP_DTYPE, signal.device
    pos, neg, flat = leg_masks(signal)
    zero_day = flat | (_universe_count(signal, s) < 2)
    nan_sig_day = _nan_signal_days(signal, s)
    returns0 = torch.nan_to_num(s.returns).to(dtype)
    signal_q = signal.to(dtype)
    b = torch.tensor([1.0, -1.0], dtype=dtype, device=dev)

    w_prev = torch.zeros(n, dtype=dtype, device=dev)
    warm = None
    rows = []
    for today in range(d):
        w, resid, ok, state, polish = _solve_day(
            signal_q[today], returns0, today, w_prev, s, b,
            warm if s.qp_warm_start else None, nan_sig_day[today])
        # the reference reads the last stored row as yesterday's weights,
        # which is the zero row on flat days
        w = torch.where(zero_day[today], 0.0, w)
        rows.append((w, resid, ok) + polish)
        w_prev, warm = w, state
    w, resid, ok, polished, pre, post = (torch.stack(col) for col in zip(*rows))
    out_dtype = s.returns.dtype
    w, resid, pre, post = (a.to(out_dtype) for a in (w, resid, pre, post))
    stats = SchemeStats(*(torch.tensor(v, dtype=torch.int32, device=dev)
                          for v in (d, 0, 0, d)))
    return _finalize(w, signal, s, pos, neg, flat, resid, ok,
                     (polished, pre, post), stats)


def _finalize(w, signal, s, pos, neg, flat, resid, ok, polish, stats):
    zero_day = flat | (_universe_count(signal, s) < 2)
    w = torch.where(zero_day[..., None], 0.0, w)
    zero = torch.zeros_like(pos.sum(-1))
    lc = pos.sum(-1)
    sc = neg.sum(-1)
    # day 0 has no history and falls back to the equal scheme: its k counts
    no_hist = torch.arange(signal.shape[0], device=signal.device) == 0
    k_long = torch.clamp(torch.floor(lc * s.pct), min=1.0).to(lc.dtype)
    k_short = torch.clamp(torch.floor(sc * s.pct), min=1.0).to(sc.dtype)
    lc = torch.where(no_hist, k_long, lc)
    sc = torch.where(no_hist, k_short, sc)
    ok = ok | zero_day | no_hist
    dead = zero_day | no_hist
    polished, pre, post = polish
    polish = (polished & ~dead, torch.where(dead, float("nan"), pre),
              torch.where(dead, float("nan"), post))
    return (w, torch.where(zero_day, zero, lc), torch.where(zero_day, zero, sc),
            resid, ok, polish, stats)
