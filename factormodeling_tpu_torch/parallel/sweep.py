"""Candidate-combo sweep: many factor combinations, one backtest each (port
of ``factormodeling_tpu/parallel/sweep.py``, its single-device part).

The reference would run ``run_multimanager_backtest`` once per combo, each
time recomputing every manager's daily weight book. The per-manager books
depend only on (factor, settings), not on the combo, so they are computed
once (``[F, D, N]``), and every combo reduces to one contraction over the
manager axis plus the P&L. Combos run in chunks of ``combo_batch`` (the JAX
package's ``lax.map(..., batch_size=combo_batch)``): a chunk's books
``[B, D, N]`` go through the P&L on an explicit date axis, so each combo
gets the result of its own ``[D, N]`` call and the working set stays one
chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch._device import check_device
from factormodeling_tpu_torch.backtest.pnl import daily_portfolio_returns
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.multimanager import compute_manager_weights
from factormodeling_tpu_torch.obs.report import record_stage
from factormodeling_tpu_torch.parallel.pipeline import result_summary

__all__ = ["SweepOutput", "combo_weight_matrix", "manager_sweep"]


class SweepOutput(NamedTuple):
    log_return: torch.Tensor        # [C, D] daily net returns per combo
    turnover: torch.Tensor          # [C, D]
    total_log_return: torch.Tensor  # [C]
    sharpe: torch.Tensor            # [C]
    mean_turnover: torch.Tensor     # [C]


def combo_weight_matrix(combos, n_factors: int, weights=None, *,
                        device=None) -> torch.Tensor:
    """Dense ``float32[C, F]`` combo weights from index lists, on ``device``
    (``None`` is the card).

    ``combos``: int array ``[C, K]`` of factor indices per candidate;
    ``weights``: optional ``[C, K]`` per-member weights (default equal 1/K).
    Duplicate indices accumulate. Float32 always, as the JAX package
    returns it; :func:`manager_sweep` casts it to the books' type at the
    contraction.
    """
    dev = check_device(device)
    combos = np.asarray(combos, dtype=np.int64)
    c, k = combos.shape
    w = (np.full((c, k), 1.0 / k) if weights is None
         else np.asarray(weights, dtype=np.float64))
    dense = np.zeros((c, n_factors), dtype=np.float64)
    np.add.at(dense, (np.arange(c)[:, None], combos), w)
    return torch.from_numpy(dense.astype(np.float32)).to(dev)


def _combine_and_pnl(books: torch.Tensor, combo_weights: torch.Tensor,
                     settings: SimulationSettings,
                     combo_batch: int) -> SweepOutput:
    """Contract the books ``[F, D, N]`` against combo weights ``[C, F]`` in
    chunks of ``combo_batch`` combos, each chunk's ``[B, D, N]`` books
    through the P&L and the summary."""
    # pandas .add(fill_value=0) zero-fills NaN values before adding, so the
    # combination is one clean contraction; torch.einsum takes one type,
    # where the JAX package's promotes the float32 combo weights against the
    # books
    clean = torch.nan_to_num(books)
    weights = combo_weights.to(clean.dtype)
    parts = []
    for lo in range(0, weights.shape[0], combo_batch):
        combined = torch.einsum("cf,fdn->cdn", weights[lo:lo + combo_batch],
                                clean)
        res = daily_portfolio_returns(combined, settings)
        summ = result_summary(res)
        parts.append(SweepOutput(
            log_return=res.log_return, turnover=res.turnover,
            total_log_return=summ.total_log_return, sharpe=summ.sharpe,
            mean_turnover=summ.mean_turnover))
    return SweepOutput(*(torch.cat(field) for field in zip(*parts)))


def manager_sweep(factors: torch.Tensor, combo_weights: torch.Tensor,
                  settings: SimulationSettings, *, combo_batch: int = 8,
                  device=None) -> SweepOutput:
    """Single-device sweep: one book pass, then every combo's backtest.
    ``device=None`` is the card; the inputs must lie on the device asked
    for."""
    check_device(device, factors, combo_weights)
    record_stage("parallel/sweep", combos=int(combo_weights.shape[0]),
                 factors=int(factors.shape[0]), combo_batch=combo_batch)
    books, _, _ = compute_manager_weights(factors, settings, device=device)
    return _combine_and_pnl(books, combo_weights, settings, combo_batch)
