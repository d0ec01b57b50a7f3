"""The online advance: the research step one arriving date at a time (port
of ``factormodeling_tpu/online``).

- :mod:`.state`: the O(window) carries (:class:`MarketState`,
  :class:`TenantState`) and the :class:`DateSlice` ingestion unit;
- :mod:`.advance`: the per-date advance, whose rows are the full research
  step's;
- :mod:`.engine`: the host loop: every ingested date terminates in exactly
  one of APPLIED | REPLAYED | REJECTED, restatements roll back and replay
  from a bounded snapshot ring (beyond it, a counted replay from genesis),
  and the state checkpoints through ``resil.checkpoint`` under a
  fingerprint guard, so a killed engine resumes with no date applied twice
  and none lost.
"""

from factormodeling_tpu_torch.online.advance import (OnlineCtx,
                                                     make_online_step,
                                                     online_step_parts)
from factormodeling_tpu_torch.online.engine import (EngineGuards,
                                                    OnlineEngine,
                                                    OnlineVerdict)
from factormodeling_tpu_torch.online.state import (AdvanceOutputs, DateSlice,
                                                   MarketState, TenantState)

__all__ = ["AdvanceOutputs", "DateSlice", "EngineGuards", "MarketState",
           "OnlineCtx", "OnlineEngine", "OnlineVerdict", "TenantState",
           "make_online_step", "online_step_parts"]
