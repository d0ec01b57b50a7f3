"""Resilience layer: detect -> degrade -> recover (port of
``factormodeling_tpu/resil``).

- :mod:`.faults`: seedable fault injection at the research step's stage
  boundaries (NaN bursts, Inf spikes, outliers, stale/dropped dates,
  universe collapse), its masks drawn on the host from the JAX package's
  RNG lanes, and the dispatch-level fault plan;
- :mod:`.policy`: the :class:`DegradePolicy` (NaN-day quarantine, absmax
  clamp, min-universe hold, solver-fallback carry) with its
  :class:`DegradeStats`; the default policy is bitwise inert;
- :mod:`.checkpoint`: versioned, checksummed, atomic snapshot/resume in
  the JAX package's file format, used by the checkpointed combo sweep and
  the online engine;
- :mod:`.retry`: the bounded-backoff retry combinator under the snapshot
  IO.

The serving queue (``serve/queue.py``) and the streaming chunk loop
(``parallel/streaming.py``'s ``checkpoint=``) checkpoint through
:mod:`.checkpoint` too.
"""

from factormodeling_tpu_torch.resil.checkpoint import (  # noqa: F401
    SNAPSHOT_VERSION,
    Checkpointer,
    SnapshotCorrupt,
    fingerprint,
    io_retry,
    load_snapshot,
    save_snapshot,
)
from factormodeling_tpu_torch.resil.faults import (  # noqa: F401
    DISPATCH_FAULT_CLASSES,
    FAULT_CLASSES,
    INJECT_STAGES,
    DispatchFault,
    DispatchFaultPlan,
    FaultSpec,
    inject,
    inject_universe,
    staleness_canary,
)
from factormodeling_tpu_torch.resil.policy import (  # noqa: F401
    DegradePolicy,
    DegradeStats,
    HoldStats,
    clamp_signal,
    hold_weights,
    merge_stats,
    quarantine_days,
    quarantine_inputs,
)
from factormodeling_tpu_torch.resil.retry import (  # noqa: F401
    DeadlineExceeded,
    backoff_schedule,
    retry_call,
)

__all__ = ["DISPATCH_FAULT_CLASSES", "FAULT_CLASSES", "INJECT_STAGES",
           "SNAPSHOT_VERSION", "Checkpointer", "DeadlineExceeded",
           "DegradePolicy", "DegradeStats", "DispatchFault",
           "DispatchFaultPlan", "FaultSpec", "HoldStats", "SnapshotCorrupt",
           "backoff_schedule", "clamp_signal", "fingerprint", "hold_weights",
           "inject", "inject_universe", "io_retry", "load_snapshot",
           "merge_stats", "quarantine_days", "quarantine_inputs",
           "retry_call", "save_snapshot", "staleness_canary"]
