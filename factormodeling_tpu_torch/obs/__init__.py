"""Runtime observability (port of ``factormodeling_tpu/obs``): the run
report (:mod:`.report`: ``RunReport``, ``span``, ``record_stage``,
``active_report``, ``cost_estimate``), the latency sketches
(:mod:`.latency`), the research step's device-side stage counters
(:mod:`.counters`), the numerics probes and their watchdog
(:mod:`.probes`), the report gate (:mod:`.regression`), the profiler stage
markers (:mod:`.trace`: ``stage``, ``annotate``), and the telemetry, each
in the JAX package's row schema:

- :mod:`.compile_log`: ``instrument_jit`` entry points with per-name call
  statistics (a "compile" is the first call of a signature), the
  retrace detector, ``compile_stats``/``compile_totals`` and per-call
  latency under ``RunReport(latency=True)``;
- :mod:`.comms`: the collectives the mesh layer's wrappers issued, by
  stage and mesh axis (``kind="comms"``), and ``sharding_lint``;
- :mod:`.memory`: the measured device-memory footprint of one call
  (``memory_summary``, ``kind="memory"`` rows) and the allocator's live
  watermarks, skipped with the reason on the CPU;
- :mod:`.devtime`: one ``torch.profiler`` trace of one call, its device
  time attributed to the ``obs.stage`` scopes (``RunReport.add_devtime``,
  ``kind="devtime"``), skipped with the reason on the CPU.

``RunReport(comms=True)`` or ``RunReport.add_placement`` collects the
comms, memory and sharding rows of an entry point; ``add_cost_analysis``
and ``cost_estimate`` tally the FLOPs and bytes of one call.

The provenance ledger (:mod:`.lineage`), the operations sentry
(:mod:`.sentry`), the request flight recorder (:mod:`.reqtrace`) and the
cost meter (:mod:`.metering`) are deliberately not imported here: the
layers that take ``lineage=``, ``sentry=``, ``flight=`` or ``meter=``
import them when asked, so a run with every hook off never loads them.
"""

from factormodeling_tpu_torch.obs import (  # noqa: F401
    comms,
    devtime,
    memory,
    regression,
)

from factormodeling_tpu_torch.obs.comms import (  # noqa: F401
    CommsLedger,
    comms_ledger,
    sharding_lint,
)
from factormodeling_tpu_torch.obs.compile_log import (  # noqa: F401
    InstrumentedJit,
    compile_stats,
    compile_totals,
    instrument_jit,
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
    record_stage,
    span,
)
from factormodeling_tpu_torch.obs.memory import (  # noqa: F401
    live_watermark,
    memory_summary,
)
from factormodeling_tpu_torch.obs.trace import annotate, stage  # noqa: F401

__all__ = ["CommsLedger", "InstrumentedJit", "LatencyRecorder", "ProbeFrame",
           "QuantileSketch", "RunReport", "SCHEMA_VERSION", "SLOSpec",
           "SpanHandle", "StageCounters", "active_report", "annotate",
           "code_fingerprint", "collecting", "comms", "comms_ledger",
           "compile_stats", "compile_totals", "cost_estimate",
           "counters_enabled", "devtime", "enable_counters", "enable_probes",
           "instrument_jit", "live_watermark", "memory", "memory_summary",
           "probe", "probe_profile", "probes_enabled", "probing",
           "record_stage", "regression", "sharding_lint", "span", "stage",
           "stage_counters", "summarize_counters", "summarize_probes",
           "watchdog"]
