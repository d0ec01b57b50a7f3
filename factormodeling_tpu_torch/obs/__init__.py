"""Runtime observability (port of ``factormodeling_tpu/obs``): the run
report (:mod:`.report`: ``RunReport``, ``span``, ``record_stage``,
``active_report``, ``cost_estimate``), the latency sketches
(:mod:`.latency`), the research step's device-side stage counters
(:mod:`.counters`), the numerics probes and their watchdog
(:mod:`.probes`), the report gate (:mod:`.regression`), the profiler stage
markers (:mod:`.trace`: ``stage``, ``annotate``), the entry-point tags
(:mod:`.compile_log`: ``entry_point_tag``) and the comms ledger
(:mod:`.comms`: the collectives the mesh layer's wrappers issued, by stage
and mesh axis, in the JAX package's ``kind="comms"`` rows).

The provenance ledger (:mod:`.lineage`), the operations sentry
(:mod:`.sentry`), the request flight recorder (:mod:`.reqtrace`) and the
cost meter (:mod:`.metering`) are deliberately not imported here: the
layers that take ``lineage=``, ``sentry=``, ``flight=`` or ``meter=``
import them when asked, so a run with every hook off never loads them.
The JAX package's compile telemetry and device-time attribution are not
ported yet (ROADMAP queue 1 item 6).
"""

from factormodeling_tpu_torch.obs import regression  # noqa: F401

from factormodeling_tpu_torch.obs.comms import (  # noqa: F401
    CommsLedger,
    comms_ledger,
    sharding_lint,
)
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
from factormodeling_tpu_torch.obs.probes import (  # noqa: F401
    ProbeFrame,
    enable_probes,
    probe,
    probe_profile,
    probes_enabled,
    probing,
    summarize_probes,
    watchdog,
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

__all__ = ["CommsLedger", "LatencyRecorder", "ProbeFrame", "QuantileSketch",
           "RunReport", "SCHEMA_VERSION", "SLOSpec", "SpanHandle",
           "StageCounters", "active_report", "annotate", "code_fingerprint",
           "collecting", "comms_ledger", "cost_estimate", "counters_enabled",
           "enable_counters", "enable_probes", "live_watermark", "probe",
           "probe_profile", "probes_enabled", "probing", "record_stage",
           "regression", "sharding_lint", "span", "stage", "stage_counters",
           "summarize_counters", "summarize_probes", "watchdog"]
