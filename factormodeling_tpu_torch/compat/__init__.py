"""The reference library's pandas surface over the port (port of
``factormodeling_tpu/compat``): the same module names, call signatures and
(date, symbol)-MultiIndex pandas objects, each call densified onto a
``[D, N]`` grid, computed by the port on a device (``device=None`` is the
card; ``device="cpu"`` asks for the CPU) and realigned to the caller's
index. Panels densify to float64 always (``_convert``), where the JAX
package's compat densifies to float32 unless x64 is on.

Ported: ``factor_selector`` (``single_factor_metrics``, ``FactorSelector``),
``factor_selection_methods`` (the reference-signature plugins),
``composite_factor`` (the blends and their plots) and
``portfolio_analyzer`` (``PortfolioAnalyzer`` over a result frame), over
``_convert`` (``PanelVocab``, ``densify_stack``, ``level_values``,
``roundtrip``). ``operations``, ``portfolio_simulation``, ``decay``,
``multi_manager`` and ``install()`` (the bare-name ``sys.modules`` shims
the reference notebook imports through) are not ported yet.
"""

from factormodeling_tpu_torch.compat import (composite_factor,
                                             factor_selection_methods,
                                             factor_selector,
                                             portfolio_analyzer)

__all__ = ["composite_factor", "factor_selection_methods", "factor_selector",
           "portfolio_analyzer"]
