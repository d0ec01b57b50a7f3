"""Solver / invariant diagnostics carried by the backtest output (port of
``factormodeling_tpu/backtest/diagnostics.py``): the two records, and the
host-side reports over them (:func:`sweep_stats`, :func:`anderson_stats`,
:func:`polish_stats`, :func:`check_anomalies`), host numpy over ``.cpu()``
copies with the JAX package's keys and messages.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch._device import host_array

__all__ = ["SchemeStats", "SolverDiagnostics", "anderson_stats",
           "check_anomalies", "polish_stats", "sweep_stats"]


class SchemeStats(NamedTuple):
    """Per-run scalar solve-scheme telemetry (all ``int32[]``): QP solves
    dispatched, outer sweeps, certified-converged days, and days re-solved
    sequentially (the turnover scan reports D)."""

    qp_solves: torch.Tensor
    sweeps: torch.Tensor
    converged_days: torch.Tensor
    suffix_len: torch.Tensor


class SolverDiagnostics(NamedTuple):
    """Per-date solver and invariant telemetry (all ``[D]``), field for field
    the JAX package's record: ADMM primal residual (NaN without a solver),
    solver acceptance, pre-shift leg sums, traded days, polish acceptance
    and residuals, the scheme stats, the Anderson accept / rollback tallies
    per solved day (0 with ``qp_anderson=0``), and the first ADMM
    iteration at which the combined residual reached the polish grade a
    solved day (0 when the budget ran out first, and 0 on every day unless
    the solves collected it: ``build_research_step(collect_probes=True)``
    or ``obs.probing()``)."""

    primal_residual: torch.Tensor
    solver_ok: torch.Tensor
    long_sum: torch.Tensor
    short_sum: torch.Tensor
    active: torch.Tensor
    polished: torch.Tensor
    polish_pre_residual: torch.Tensor
    polish_post_residual: torch.Tensor
    qp_solves: torch.Tensor | int = 0
    sweeps: torch.Tensor | int = 0
    converged_days: torch.Tensor | int = 0
    suffix_len: torch.Tensor | int = 0
    anderson_accepted: torch.Tensor | int = 0
    anderson_rejected: torch.Tensor | int = 0
    iters_to_converge: torch.Tensor | int = 0


def sweep_stats(diag: SolverDiagnostics) -> dict:
    """JSON-ready view of the scheme telemetry on a diagnostics record."""
    days = int(host_array(diag.active).size)
    converged = int(host_array(diag.converged_days))
    return {
        "qp_solves": int(host_array(diag.qp_solves)),
        "sweeps": int(host_array(diag.sweeps)),
        "converged_days": converged,
        "converged_day_frac": (converged / days if days else float("nan")),
        "suffix_len": int(host_array(diag.suffix_len)),
    }


def anderson_stats(diag: SolverDiagnostics) -> dict:
    """JSON-ready summary of the Anderson telemetry: extrapolation steps
    taken vs safeguard resets over the run, and the acceptance share (NaN
    when the accelerator never engaged)."""
    acc = int(host_array(diag.anderson_accepted).sum())
    rej = int(host_array(diag.anderson_rejected).sum())
    return {
        "anderson_accepted": acc,
        "anderson_rejected": rej,
        "anderson_accept_rate": (acc / (acc + rej) if acc + rej
                                 else float("nan")),
    }


def polish_stats(diag: SolverDiagnostics) -> dict:
    """Accept-rate / residual summary of the active-set polish.

    ``attempted`` counts days whose pre-residual is finite; ``accept_rate``
    is accepted / attempted (NaN when nothing was attempted). Residual
    aggregates run over the attempted days' finite values, NaN (and no
    numpy warning) when there are none."""
    pre = host_array(diag.polish_pre_residual).astype(float)
    post = host_array(diag.polish_post_residual).astype(float)
    accepted = host_array(diag.polished).astype(bool)
    tried = np.isfinite(pre)
    n_tried = int(tried.sum())

    def _agg(a):
        a = a[np.isfinite(a)]
        if a.size == 0:
            return float("nan"), float("nan")
        return float(a.mean()), float(np.percentile(a, 99))

    pre_mean, pre_p99 = _agg(pre[tried])
    post_mean, post_p99 = _agg(post[tried])
    return {
        "attempted": n_tried,
        "accepted": int(accepted.sum()),
        "accept_rate": (float(accepted.sum() / n_tried) if n_tried
                        else float("nan")),
        "pre_residual_mean": pre_mean,
        "pre_residual_p99": pre_p99,
        "post_residual_mean": post_mean,
        "post_residual_p99": post_p99,
    }


def check_anomalies(diag: SolverDiagnostics, *, name: str = "simulation",
                    leg_tol: float = 1e-6, residual_tol: float = 1e-3,
                    warn: bool = True) -> list[str]:
    """Anomaly report over a simulation's diagnostics: equal-weight
    fallbacks on traded days, leg sums off +-1 by more than
    ``max(leg_tol, 8 * primal_residual)`` (the box violation the solver's
    own residual allows), and primal residuals above ``residual_tol``.
    Returns the messages; each is also issued through ``warnings.warn``
    unless ``warn=False``."""
    resid = host_array(diag.primal_residual)
    ok = host_array(diag.solver_ok)
    long_sum = host_array(diag.long_sum)
    short_sum = host_array(diag.short_sum)
    active = host_array(diag.active)

    messages: list[str] = []

    fell_back = active & ~ok
    if fell_back.any():
        days = np.flatnonzero(fell_back)
        messages.append(
            f"{name}: QP solver fell back to equal-weight x0 on "
            f"{days.size} day(s) (first at t={days[0]}) — infeasible caps "
            f"or a non-finite solution")

    with np.errstate(invalid="ignore"):
        day_tol = np.maximum(leg_tol, 8.0 * np.nan_to_num(resid))
        leg_bad = active & (
            (np.abs(long_sum - 1.0) > day_tol)
            | (np.abs(short_sum + 1.0) > day_tol))
    # the +-1 invariant is the QP's equality constraint: solver days only,
    # and fallback days carry the exact-leg x0
    leg_bad &= ok & ~np.isnan(resid)
    if leg_bad.any():
        days = np.flatnonzero(leg_bad)
        worst = float(np.max(np.abs(long_sum[leg_bad] - 1.0)
                             + np.abs(short_sum[leg_bad] + 1.0)))
        messages.append(
            f"{name}: leg sums deviate from +-1 beyond the solver's own "
            f"precision on {days.size} day(s) (first at t={days[0]}, worst "
            f"total deviation {worst:.2e})")

    with np.errstate(invalid="ignore"):
        not_converged = active & ok & (resid > residual_tol)
    if not_converged.any():
        days = np.flatnonzero(not_converged)
        messages.append(
            f"{name}: ADMM primal residual above {residual_tol:g} on "
            f"{days.size} day(s) (first at t={days[0]}, max "
            f"{float(np.nanmax(resid[not_converged])):.2e}) — consider "
            f"raising qp_iters")

    if warn:
        for msg in messages:
            warnings.warn(msg, stacklevel=2)
    return messages
