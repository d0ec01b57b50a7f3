"""The end-to-end research step, the manager sweep and its checkpointed
form, out-of-core factor streaming, the bounded LRU of built callables
that streaming and the serving layer share, and the mesh layer: meshes on
``torch.distributed`` (one rank a device), the factor x date sharded step,
the sharded sweep, the asset-sharded step with its layout chooser, and the
cluster bring-up."""

from factormodeling_tpu_torch.parallel.asset_shard import (
    AssetSpecPlan, asset_in_shardings, choose_asset_specs, make_asset_mesh,
    make_asset_sharded_research_step, record_spec_choices)
from factormodeling_tpu_torch.parallel.cluster import (initialize_cluster,
                                                       make_hybrid_mesh,
                                                       num_slices)
from factormodeling_tpu_torch.parallel.mesh import (ASSET_AXIS,
                                                    balanced_mesh_shape,
                                                    make_mesh,
                                                    panel_sharding,
                                                    release_world,
                                                    replicated,
                                                    stack_sharding)
from factormodeling_tpu_torch.parallel.pipeline import (
    ResearchOutput, ResearchSummary, build_research_step,
    make_sharded_research_step, result_summary)
from factormodeling_tpu_torch.parallel.streaming import (
    chunk_sharding, chunk_slices, clear_streaming_cache, host_array_source,
    set_kernel_cache_size, streamed_factor_stats, streamed_linear_research,
    streamed_weighted_composite, streaming_cache_stats)
from factormodeling_tpu_torch.parallel.sweep import (
    SweepOutput, checkpointed_manager_sweep, combo_weight_matrix,
    make_sharded_manager_sweep, manager_sweep)

__all__ = ["ASSET_AXIS", "AssetSpecPlan", "ResearchOutput",
           "ResearchSummary", "SweepOutput", "asset_in_shardings",
           "balanced_mesh_shape", "build_research_step",
           "checkpointed_manager_sweep", "choose_asset_specs",
           "chunk_sharding", "chunk_slices", "clear_streaming_cache",
           "combo_weight_matrix", "host_array_source", "initialize_cluster",
           "make_asset_mesh", "make_asset_sharded_research_step",
           "make_hybrid_mesh", "make_mesh", "make_sharded_manager_sweep",
           "make_sharded_research_step", "manager_sweep", "num_slices",
           "panel_sharding", "record_spec_choices", "release_world",
           "replicated", "result_summary", "set_kernel_cache_size",
           "stack_sharding", "streamed_factor_stats",
           "streamed_linear_research", "streamed_weighted_composite",
           "streaming_cache_stats"]
