"""Decay-window sensitivity sweep (port of
``factormodeling_tpu/analytics/decay.py``).

Reference: the notebook-level ``plot_decay_sensitivity`` helper
(``pipeline.ipynb`` cell 6): for each decay window it re-decays the
composite signal with ``ts_decay``, re-runs the backtest, and reports the
annualized return and Sharpe against the window. The JAX package runs the K
backtests as one ``vmap``; here they are a Python loop over the windows,
with the same arithmetic. On the card every window of at least 2 decays
through the window-streaming kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from factormodeling_tpu_torch._device import host_array
from factormodeling_tpu_torch.backtest.engine import run_simulation
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.ops.timeseries import ts_decay

__all__ = ["DEFAULT_DECAY_PERIODS", "DecaySensitivity", "batched_ts_decay",
           "decay_sensitivity", "plot_decay_sensitivity"]

# the reference helper's default sweep grid (pipeline.ipynb cell 6)
DEFAULT_DECAY_PERIODS = (1, 3, 5, 10) + tuple(range(25, 351, 25))


class DecaySensitivity(NamedTuple):
    decay_periods: tuple[int, ...]
    annualized_return: torch.Tensor   # [K] (prod(1+r))**(252/D) - 1
    sharpe: torch.Tensor              # [K] mean/std(ddof=1) * sqrt(252)
    log_return: torch.Tensor          # [K, D] daily net returns per window
    decayed: torch.Tensor             # [K, *signal.shape] the swept signals


def batched_ts_decay(x: torch.Tensor, windows: Sequence[int],
                     universe: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`ts_decay` for every window in ``windows`` -> ``[K, *x.shape]``."""
    return torch.stack([ts_decay(x, int(w), universe=universe)
                        for w in windows])


def _annualize(r: torch.Tensor):
    """(annualized return, Sharpe) per row of daily returns ``r [K, D]``.

    ``prod(1+r)**(252/D) - 1`` in sign-tracked log-magnitude space: the
    reference's numpy expression, including its ``prod <= 0`` cases (zero
    -> -1; negative -> NaN under a fractional power), without float32 over-
    or underflow at long horizons."""
    d = r.shape[1]
    one_r = 1.0 + r
    logmag = torch.log(torch.abs(one_r))        # log(0) -> -inf, prod -> 0
    neg_prod = (((one_r < 0.0).sum(1) % 2 == 1)
                & ~(one_r == 0.0).any(1))
    e = 252.0 / d
    mag = torch.exp(logmag.sum(1) * e)
    if e == int(e):                             # negative**integer is real
        ann = torch.where(neg_prod, mag * (-1.0 if int(e) % 2 else 1.0),
                          mag) - 1.0
    else:                                       # negative**fractional -> NaN
        ann = torch.where(neg_prod, float("nan"), mag - 1.0)
    sharpe = r.mean(1) / r.std(1, correction=1) * math.sqrt(252.0)
    return ann, sharpe


def decay_sensitivity(
    signal: torch.Tensor,
    settings: SimulationSettings,
    decay_periods: Sequence[int] = DEFAULT_DECAY_PERIODS,
    universe: torch.Tensor | None = None,
) -> DecaySensitivity:
    """Annualized return and Sharpe of the backtest at each decay window.

    Mirrors the reference helper's metrics: it treats the result frame's
    ``log_return`` column as a simple return (the reference's own naming
    quirk) and computes ``(prod(1+r))**(252/D) - 1`` and
    ``mean(r)/std(r, ddof=1) * sqrt(252)`` over all D rows. Beside the
    JAX package's fields, the result keeps the decayed signals the
    backtests ran on (``decayed``), which the sweep builds in full anyway.
    """
    periods = tuple(int(p) for p in decay_periods)
    decayed = batched_ts_decay(signal, periods, universe)        # [K, D, N]
    r = torch.stack([run_simulation(sig, settings).result.log_return
                     for sig in decayed])                        # [K, D]
    ann, sharpe = _annualize(r)
    return DecaySensitivity(decay_periods=periods, annualized_return=ann,
                            sharpe=sharpe, log_return=r, decayed=decayed)


def plot_decay_sensitivity(
    signal: torch.Tensor,
    settings: SimulationSettings,
    decay_periods: Sequence[int] = DEFAULT_DECAY_PERIODS,
    universe: torch.Tensor | None = None,
    figsize: tuple[int, int] = (12, 6),
    show: bool = True,
    sensitivity: DecaySensitivity | None = None,
):
    """Twin-axis annualized-return / Sharpe plot over the decay grid (the
    reference notebook's cell 6). Returns ``(fig, sensitivity)``; pass a
    precomputed ``sensitivity`` to plot without re-running the sweep.
    matplotlib is imported here, on the first call."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator, PercentFormatter

    sens = sensitivity if sensitivity is not None else decay_sensitivity(
        signal, settings, decay_periods, universe)
    periods = list(sens.decay_periods)
    ann = host_array(sens.annualized_return)
    sharpe = host_array(sens.sharpe)

    fig, ax1 = plt.subplots(figsize=figsize)
    ax1.plot(periods, ann, marker="*", linestyle="-",
             label="Annualized Return")
    ax1.set_xlabel("Decay Window Length")
    ax1.set_ylabel("Annualized Return", color="tab:blue")
    ax1.tick_params(axis="y", labelcolor="tab:blue")
    ax1.set_xticks(periods)
    ax1.set_xlim(min(periods), max(periods))
    ax1.yaxis.set_major_locator(MaxNLocator(nbins=6, prune="both"))
    ax1.yaxis.set_major_formatter(PercentFormatter(1.0))

    ax2 = ax1.twinx()
    ax2.plot(periods, sharpe, marker="o", linestyle="--", color="tab:orange",
             label="Sharpe Ratio")
    ax2.set_ylabel("Sharpe Ratio", color="tab:orange")
    ax2.tick_params(axis="y", labelcolor="tab:orange")
    ax2.yaxis.set_major_locator(MaxNLocator(nbins=6))

    lines1, labels1 = ax1.get_legend_handles_labels()
    lines2, labels2 = ax2.get_legend_handles_labels()
    ax1.legend(lines1 + lines2, labels1 + labels2, loc="best")
    ax1.set_title("Annualized Return & Sharpe vs. Decay Window")
    fig.tight_layout()
    if show:
        plt.show()
    return fig, sens
