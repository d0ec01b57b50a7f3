"""The end-to-end research step, the manager sweep and its checkpointed
form, and the bounded LRU of built step callables the serving layer keeps
(one device; no mesh yet; the streaming functions are not ported yet)."""

from factormodeling_tpu_torch.parallel.pipeline import (ResearchOutput,
                                                        ResearchSummary,
                                                        build_research_step,
                                                        result_summary)
from factormodeling_tpu_torch.parallel.streaming import (
    clear_streaming_cache, set_kernel_cache_size, streaming_cache_stats)
from factormodeling_tpu_torch.parallel.sweep import (
    SweepOutput, checkpointed_manager_sweep, combo_weight_matrix,
    manager_sweep)

__all__ = ["ResearchOutput", "ResearchSummary", "SweepOutput",
           "build_research_step", "checkpointed_manager_sweep",
           "clear_streaming_cache", "combo_weight_matrix", "manager_sweep",
           "result_summary", "set_kernel_cache_size",
           "streaming_cache_stats"]
