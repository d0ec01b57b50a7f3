"""Many-tenant serving (port of ``factormodeling_tpu/serve``, not its
mesh):

- :mod:`~factormodeling_tpu_torch.serve.tenant`: :class:`TenantConfig`,
  per-tenant knobs as value leaves and the program-shaping residue as
  static fields, which partition configs into buckets
  (:meth:`TenantConfig.static_key`);
- :mod:`~factormodeling_tpu_torch.serve.batched`:
  :func:`make_batched_research_step` (the selection context once a
  dispatch, the tenant body per lane) and its single-config counterpart
  :func:`make_tenant_research_step`;
- :mod:`~factormodeling_tpu_torch.serve.frontend`: :class:`TenantServer`
  (validate -> bucket -> pad ladder -> cached dispatch -> demux, and the
  many-tenant online advance);
- :mod:`~factormodeling_tpu_torch.serve.queue` /
  :mod:`~factormodeling_tpu_torch.serve.admission`: the traffic layer
  (virtual-clock request queue, seeded Poisson and bursty arrival traces,
  deadline-aware batching, admission control with a shed/degrade ladder,
  retried dispatch, checkpoint/resume; ``TenantServer.serve_queued``).
  Imported on first use (PEP 562 below): ``import
  factormodeling_tpu_torch.serve`` loads neither module.
"""

from factormodeling_tpu_torch.serve.batched import (  # noqa: F401
    make_batched_research_step,
    make_tenant_research_step,
    tenant_step_parts,
)
from factormodeling_tpu_torch.serve.frontend import (  # noqa: F401
    DEFAULT_PAD_LADDER,
    TenantAdvance,
    TenantResult,
    TenantServer,
)
from factormodeling_tpu_torch.serve.tenant import (  # noqa: F401
    TenantConfig,
    stack_configs,
)

__all__ = ["DEFAULT_PAD_LADDER", "TenantAdvance", "TenantConfig",
           "TenantResult", "TenantServer", "make_batched_research_step",
           "make_tenant_research_step", "stack_configs", "tenant_step_parts"]

#: traffic-layer names resolved lazily from their modules: importing
#: ``factormodeling_tpu_torch.serve`` must not load the queue or admission
_LAZY = {
    "queue": ("DEADLINE_MISS", "FAILED", "SERVED", "SHED", "VERDICTS",
              "DispatchEstimator", "QueueResult", "Request", "VirtualClock",
              "bursty_arrivals", "make_requests", "poisson_arrivals",
              "replay_traffic", "run_queued"),
    "admission": ("AdmissionPolicy", "LADDER_STEPS", "StaleCache"),
}
_LAZY_NAME_TO_MOD = {name: mod for mod, names in _LAZY.items()
                     for name in names}


def __getattr__(name):
    mod = _LAZY_NAME_TO_MOD.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY_NAME_TO_MOD))
