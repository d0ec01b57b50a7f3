"""factormodeling_tpu_torch: the research step of ``factormodeling_tpu`` in
PyTorch, with its TPU kernels rewritten by hand in CUDA for Hopper.

The JAX package stays the reference; this package mirrors its layout and
public array layouts (``[F, D, N]`` stacks, ``[D, N]`` panels, ``[D, F]``
selections) and imports none of it. Entry points run on the card unless the
caller asks for ``device="cpu"``.
"""

from factormodeling_tpu_torch.backtest import SimulationSettings, run_simulation
from factormodeling_tpu_torch.convert import ResearchConfig, convert
from factormodeling_tpu_torch.parallel import build_research_step, result_summary

__all__ = ["ResearchConfig", "SimulationSettings", "build_research_step",
           "convert", "result_summary", "run_simulation"]
