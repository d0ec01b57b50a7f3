"""The end-to-end research step, the manager sweep and its checkpointed
form (one device; no mesh yet)."""

from factormodeling_tpu_torch.parallel.pipeline import (ResearchOutput,
                                                        ResearchSummary,
                                                        build_research_step,
                                                        result_summary)
from factormodeling_tpu_torch.parallel.sweep import (
    SweepOutput, checkpointed_manager_sweep, combo_weight_matrix,
    manager_sweep)

__all__ = ["ResearchOutput", "ResearchSummary", "SweepOutput",
           "build_research_step", "checkpointed_manager_sweep",
           "combo_weight_matrix", "manager_sweep",
           "result_summary"]
