"""Reference ``plot_decay_sensitivity`` (``pipeline.ipynb`` cell 6) on the
pandas surface (port of ``factormodeling_tpu/compat/decay.py``).

The notebook helper loops decay windows, re-running a full ``Simulation``
per window. Here the loop is the port's sweep
(:mod:`factormodeling_tpu_torch.analytics.decay`), with the same metric
formulas (``annret = prod(1+r)**(252/N) - 1``,
``sharpe = mean/std(ddof=1)*sqrt(252)``) and the same twin-axis plot, on the
settings' device.
"""

from __future__ import annotations

import pandas as pd
import torch

from factormodeling_tpu_torch._device import host_array
from factormodeling_tpu_torch.analytics.decay import (
    DEFAULT_DECAY_PERIODS,
    decay_sensitivity as _dense_decay_sensitivity,
    plot_decay_sensitivity as _dense_plot,
)
from factormodeling_tpu_torch.compat.portfolio_simulation import (
    Simulation,
    SimulationSettings,
)

__all__ = ["decay_sensitivity", "plot_decay_sensitivity"]


def _dense_inputs(composite_factor: pd.Series, settings: SimulationSettings):
    """(signal, dense settings, universe) of the composite on the
    settings' device."""
    sim = Simulation("decay_sensitivity", composite_factor, settings)
    sig, uni = sim._signal_dense()
    dev = sim._dev
    return (torch.from_numpy(sig).to(dev), sim._dense_settings(uni),
            torch.from_numpy(uni).to(dev))


def decay_sensitivity(
    composite_factor: pd.Series,
    settings: SimulationSettings,
    decay_period: list[int] = list(DEFAULT_DECAY_PERIODS),
) -> pd.DataFrame:
    """Annualized return and Sharpe per decay window as a DataFrame indexed
    by window length (the numbers the reference helper plots)."""
    sig, dense, uni = _dense_inputs(composite_factor, settings)
    sens = _dense_decay_sensitivity(sig, dense, tuple(decay_period),
                                    universe=uni)
    return pd.DataFrame(
        {"annualized_return": host_array(sens.annualized_return),
         "sharpe_ratio": host_array(sens.sharpe)},
        index=pd.Index(list(decay_period), name="decay_window"))


def plot_decay_sensitivity(
    composite_factor: pd.Series,
    settings: SimulationSettings,
    decay_period: list[int] = list(DEFAULT_DECAY_PERIODS),
    figsize: tuple[int, int] = (12, 6),
):
    """Reference signature and side effects (``pipeline.ipynb`` cell 6):
    forces ``output_returns=True`` / ``plot=False`` on the settings, sweeps
    the decay grid, draws the twin-axis annualized-return / Sharpe figure.

    Deliberate deviation, as in the JAX package: the reference loop's
    ``Simulation.run`` registers every decayed feature into the shared
    ``factors_df`` (columns ``decay_1``, ``decay_3``, ...) as a side effect
    of ``:72``; this sweep leaves ``factors_df`` untouched."""
    settings.output_returns = True
    settings.plot = False
    sig, dense, uni = _dense_inputs(composite_factor, settings)
    fig, _ = _dense_plot(sig, dense, tuple(decay_period), universe=uni,
                         figsize=figsize)
    return fig
