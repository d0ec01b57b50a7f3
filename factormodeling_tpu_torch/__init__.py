"""factormodeling_tpu_torch: the research step of ``factormodeling_tpu`` in
PyTorch, with its TPU kernels rewritten by hand in CUDA for Hopper, plus the
ops library (``fmt.ops``), the decay-window sweep
(``fmt.analytics.decay_sensitivity``), factor scoring (``fmt.metrics``),
rolling factor selection (``fmt.selection``) and the reference's pandas
selector surface (``fmt.compat``, imported on first use: it needs pandas).

The JAX package stays the reference; this package mirrors its layout and
public array layouts (``[F, D, N]`` stacks, ``[D, N]`` panels, ``[D, F]``
selections) and imports none of it. Entry points run on the card unless the
caller asks for ``device="cpu"``.
"""

import importlib

from factormodeling_tpu_torch import analytics, metrics, ops, selection
from factormodeling_tpu_torch.backtest import SimulationSettings, run_simulation
from factormodeling_tpu_torch.convert import (ResearchConfig, convert,
                                              convert_warm_state)
from factormodeling_tpu_torch.parallel import build_research_step, result_summary

__all__ = ["ResearchConfig", "SimulationSettings", "analytics",
           "build_research_step", "compat", "convert", "convert_warm_state",
           "metrics", "ops", "result_summary", "run_simulation", "selection"]


def __getattr__(name):
    if name == "compat":
        return importlib.import_module("factormodeling_tpu_torch.compat")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
