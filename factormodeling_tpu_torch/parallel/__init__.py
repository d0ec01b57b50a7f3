"""The end-to-end research step, the manager sweep and its checkpointed
form, out-of-core factor streaming, and the bounded LRU of built callables
that streaming and the serving layer share (one device; no mesh yet)."""

from factormodeling_tpu_torch.parallel.pipeline import (ResearchOutput,
                                                        ResearchSummary,
                                                        build_research_step,
                                                        result_summary)
from factormodeling_tpu_torch.parallel.streaming import (
    chunk_sharding, chunk_slices, clear_streaming_cache, host_array_source,
    set_kernel_cache_size, streamed_factor_stats, streamed_linear_research,
    streamed_weighted_composite, streaming_cache_stats)
from factormodeling_tpu_torch.parallel.sweep import (
    SweepOutput, checkpointed_manager_sweep, combo_weight_matrix,
    manager_sweep)

__all__ = ["ResearchOutput", "ResearchSummary", "SweepOutput",
           "build_research_step", "checkpointed_manager_sweep",
           "chunk_sharding", "chunk_slices", "clear_streaming_cache",
           "combo_weight_matrix", "host_array_source", "manager_sweep",
           "result_summary", "set_kernel_cache_size",
           "streamed_factor_stats", "streamed_linear_research",
           "streamed_weighted_composite", "streaming_cache_stats"]
