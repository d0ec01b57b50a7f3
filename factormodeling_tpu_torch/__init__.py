"""factormodeling_tpu_torch: the research step of ``factormodeling_tpu`` in
PyTorch, with its TPU kernels rewritten by hand in CUDA for Hopper, plus the
backtest engine and its reports (``fmt.backtest``), the blends
(``fmt.composite``), the ops library (``fmt.ops``), the analytics
(``fmt.analytics``: the decay-window sweep, ``PortfolioAnalyzer``, the
quantile backtests, the dashboards), factor scoring (``fmt.metrics``),
rolling factor selection (``fmt.selection``), the multi-manager layer
(``fmt.multimanager``) and the candidate-combo sweep
(``fmt.parallel.manager_sweep``, checkpointed or not), the run report and
stage counters (``fmt.obs``), the resilience layer (``fmt.resil``: fault
injection, the degrade policy, checkpoints), the online advance
(``fmt.online``: the research step a date at a time), many-tenant serving
(``fmt.serve``: the batched tenant step, ``TenantServer`` with its pad
ladder and many-tenant online advance, the request queue and admission), the risk model (``fmt.risk``), the seeded
RNG lanes (``fmt.rng``), the dense panel model (``fmt.panel``), the
scenario engine (``factormodeling_tpu_torch.scenarios``, imported only by
its caller), and two modules imported on first use: the reference's pandas
surface (``fmt.compat``) and the loaders, the artifact store and the
out-of-core chunk files (``fmt.io``; its table readers need pandas, and
pyarrow for parquet).

The JAX package stays the reference; this package mirrors its layout and
public array layouts (``[F, D, N]`` stacks, ``[D, N]`` panels, ``[D, F]``
selections) and imports none of it. Entry points run on the card unless the
caller asks for ``device="cpu"``.
"""

import importlib

__version__ = "0.1.0"

from factormodeling_tpu_torch import (analytics, backtest, composite, metrics,
                                      multimanager, obs, online, ops, panel,
                                      parallel, resil, risk, rng, selection,
                                      serve, solvers, threefry)
from factormodeling_tpu_torch.backtest import SimulationSettings, run_simulation
from factormodeling_tpu_torch.convert import (ResearchConfig, convert,
                                              convert_warm_state)
from factormodeling_tpu_torch.panel import FactorPanel, Panel
from factormodeling_tpu_torch.parallel import build_research_step, result_summary

__all__ = ["FactorPanel", "Panel", "ResearchConfig", "SimulationSettings",
           "analytics", "backtest", "build_research_step", "compat",
           "composite", "convert", "convert_warm_state", "io", "metrics",
           "multimanager", "obs", "online", "ops", "panel", "parallel",
           "resil", "result_summary", "risk", "rng", "run_simulation",
           "selection", "serve", "solvers", "threefry"]


def __getattr__(name):
    if name in ("compat", "io"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
