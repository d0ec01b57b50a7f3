"""Scenario engine: stress markets, counterfactual paths and distributional
risk analytics (port of ``factormodeling_tpu/scenarios``).

The tenant config is held fixed and the MARKET varies over a path axis:

- :mod:`~factormodeling_tpu_torch.scenarios.spec` — the three scenario
  families as seeded specs: :class:`BootstrapSpec` (circular
  block-bootstrap resampled markets), :class:`RegimeSpec`
  (counterfactual vol/drift/correlation regime breaks),
  :class:`AdversarialSpec` (the fault classes re-targeted at the market
  inputs under sustained scheduled windows), drawn on the host from the
  JAX package's RNG lanes.
- :mod:`~factormodeling_tpu_torch.scenarios.engine` —
  :func:`make_scenario_step` / :func:`run_scenarios`: paths run through
  the serving layer's per-tenant program, with the sort-heavy per-date
  stats hoisted out of the path loop (one K1 launch a dispatch on the
  card), chunked with exact checkpoint/resume.
- :mod:`~factormodeling_tpu_torch.scenarios.risk` — distributional P&L,
  VaR/ES at configurable levels, drawdown and turnover quantiles, folded
  through the mergeable quantile sketch and emitted as ``kind="scenario"``
  report rows.

Nothing else in the package imports this one at module level, so the
default research step never loads it.
"""

from factormodeling_tpu_torch.scenarios.engine import (  # noqa: F401
    ScenarioResult,
    make_scenario_runner,
    make_scenario_step,
    run_scenarios,
)
from factormodeling_tpu_torch.scenarios.risk import (  # noqa: F401
    DEFAULT_LEVELS,
    RISK_METRICS,
    RiskAccumulator,
    SignedSketch,
)
from factormodeling_tpu_torch.scenarios.spec import (  # noqa: F401
    SCENARIO_FAMILIES,
    AdversarialSpec,
    BootstrapSpec,
    RegimeSpec,
    family_of,
    path_key,
)
