"""The end-to-end research step (one device; no mesh yet)."""

from factormodeling_tpu_torch.parallel.pipeline import (ResearchOutput,
                                                        ResearchSummary,
                                                        build_research_step,
                                                        result_summary)

__all__ = ["ResearchOutput", "ResearchSummary", "build_research_step",
           "result_summary"]
