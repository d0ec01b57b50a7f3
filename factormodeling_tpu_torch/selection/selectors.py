"""Factor-selection methods behind the registry (port of
``factormodeling_tpu/selection/selectors.py``).

A selector consumes a :class:`SelectionContext` of precomputed whole-sample
tensors and emits raw daily weight rows for all dates at once,
``float[D, F]``; the driver masks them to the processed range and
row-normalizes. Ported: ``icir_top`` and ``momentum``. The covariance-based
selectors (``mvo``, ``pca``, ``regression``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["SelectionContext", "FACTOR_SELECTION_METHODS",
           "register_selection_method", "icir_top_selector",
           "factor_momentum_selector"]


@dataclasses.dataclass(frozen=True)
class SelectionContext:
    """Everything a selector may need, precomputed once for the whole sample.

    ``metrics_win[...][f, t]`` aggregates the window ending the day before
    ``t`` (the driver pre-shifts), so selectors read column ``t`` directly.
    """

    metrics_win: dict            # name -> float[F, D] trailing-window metrics
    factor_ret: torch.Tensor     # float[D, F] per-date factor returns (raw)
    ret_win_sum: torch.Tensor    # float[D, F] trailing-window sums (shifted)
    window: int


def icir_top_selector(ctx: SelectionContext, *, icir_threshold: float = 0.03,
                      top_x: int = 5, use_rank_icir: bool = True,
                      **_ignored) -> torch.Tensor:
    """Equal-weight the top ``top_x`` factors whose (rank-)ICIR exceeds the
    threshold; ties keep first-factor order like pandas ``nlargest``."""
    score = ctx.metrics_win["rank_IC_IR" if use_rank_icir else "IC_IR"]  # [F, D]
    eligible = score > icir_threshold  # NaN -> False
    keyed = torch.where(eligible, score, float("-inf"))
    order = torch.argsort(-keyed, dim=0, stable=True)
    rank_of = torch.argsort(order, dim=0, stable=True)
    chosen = eligible & (rank_of < top_x)
    return chosen.to(score.dtype).T  # [D, F]


def factor_momentum_selector(ctx: SelectionContext, *, max_weight: float = 1.0,
                             **_ignored) -> torch.Tensor:
    """Weight proportional to clip(window-sum of factor returns, 0, cap)."""
    mom = torch.clamp(ctx.ret_win_sum, min=0.0)  # [D, F]
    if max_weight < 1.0:
        mom = torch.clamp(mom, max=max_weight)
    return mom


FACTOR_SELECTION_METHODS: dict[str, Callable] = {
    "icir_top": icir_top_selector,
    "momentum": factor_momentum_selector,
}


def register_selection_method(name: str, fn: Callable) -> None:
    """Extend the selector registry."""
    FACTOR_SELECTION_METHODS[name] = fn
