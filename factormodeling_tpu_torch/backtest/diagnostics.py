"""Solver / invariant diagnostics carried by the backtest output (port of
``factormodeling_tpu/backtest/diagnostics.py``: the two records; the
host-side report helpers are not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SchemeStats", "SolverDiagnostics"]


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
    and residuals, the scheme stats, and the Anderson / iterations-to-
    converge tallies (constant 0 in the port, which has neither)."""

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
