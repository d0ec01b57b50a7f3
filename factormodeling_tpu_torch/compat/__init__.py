"""The reference library's pandas surface over the port (port of
``factormodeling_tpu/compat``): the same module names, call signatures and
(date, symbol)-MultiIndex pandas objects, each call densified onto a
``[D, N]`` grid, computed by the port on a device (``device=None`` is the
card; ``device="cpu"`` asks for the CPU) and realigned to the caller's
index.

Ported: ``factor_selector`` (``single_factor_metrics``, ``FactorSelector``)
and ``factor_selection_methods`` (the reference-signature plugins), over
``_convert`` (``PanelVocab``, ``level_values``, ``roundtrip``). The other
modules and ``install()`` (the bare-name ``sys.modules`` shims the
reference notebook imports through) come with the analytics and compat
slice.
"""

from factormodeling_tpu_torch.compat import (factor_selection_methods,
                                             factor_selector)

__all__ = ["factor_selection_methods", "factor_selector"]
