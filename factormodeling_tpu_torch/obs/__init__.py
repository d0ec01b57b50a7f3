"""Runtime observability (port of ``factormodeling_tpu/obs``, the part the
library layers call): the run report (:mod:`.report`: ``RunReport``,
``span``, ``record_stage``, ``active_report``, ``cost_estimate``) and the
latency sketches (:mod:`.latency`). The JAX package's trace markers,
stage counters, probes, compile telemetry, placement ledger and device-time
attribution are not ported yet.
"""

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

__all__ = ["LatencyRecorder", "QuantileSketch", "RunReport", "SCHEMA_VERSION",
           "SLOSpec", "SpanHandle", "active_report", "code_fingerprint",
           "cost_estimate", "live_watermark", "record_stage", "span"]
