"""Runtime observability (port of ``factormodeling_tpu/obs``, the part the
library layers call): the run report (:mod:`.report`: ``RunReport``,
``span``, ``record_stage``, ``active_report``, ``cost_estimate``), the
latency sketches (:mod:`.latency`), the research step's device-side
stage counters (:mod:`.counters`), the profiler stage markers
(:mod:`.trace`: ``stage``, ``annotate``) and the entry-point tags
(:mod:`.compile_log`: ``entry_point_tag``). The JAX package's probes,
compile telemetry, placement ledger and device-time attribution are not
ported yet.
"""

from factormodeling_tpu_torch.obs.counters import (  # noqa: F401
    StageCounters,
    collecting,
    counters_enabled,
    enable_counters,
    stage_counters,
    summarize_counters,
)
from factormodeling_tpu_torch.obs.latency import (  # noqa: F401
    LatencyRecorder,
    QuantileSketch,
    SLOSpec,
)
from factormodeling_tpu_torch.obs.report import (  # noqa: F401
    SCHEMA_VERSION,
    RunReport,
    SpanHandle,
    active_report,
    code_fingerprint,
    cost_estimate,
    live_watermark,
    record_stage,
    span,
)
from factormodeling_tpu_torch.obs.trace import annotate, stage  # noqa: F401

__all__ = ["LatencyRecorder", "QuantileSketch", "RunReport", "SCHEMA_VERSION",
           "SLOSpec", "SpanHandle", "StageCounters", "active_report",
           "annotate", "code_fingerprint", "collecting", "cost_estimate",
           "counters_enabled", "enable_counters", "live_watermark",
           "record_stage", "span", "stage", "stage_counters",
           "summarize_counters"]
