"""The reference library's pandas surface over the port (port of
``factormodeling_tpu/compat``): the same module names, call signatures and
(date, symbol)-MultiIndex pandas objects, each call densified onto a
``[D, N]`` grid, computed by the port on a device (``device=None`` is the
card; ``device="cpu"`` asks for the CPU; ``Simulation`` and
``multi_manager`` read it from ``SimulationSettings.device``) and realigned
to the caller's index. Panels densify at JAX's float width (``_convert``):
float64 where ``torch.get_default_dtype()`` is float64, float32 where it
is float32, as the JAX package's compat follows ``jax_enable_x64``.

Modules: ``operations`` (the 28 reference ops), ``factor_selector``
(``single_factor_metrics``, ``FactorSelector``), ``factor_selection_methods``
(the reference-signature plugins), ``composite_factor`` (the blends and
their plots), ``portfolio_simulation`` (``SimulationSettings``,
``Simulation``), ``portfolio_analyzer`` (``PortfolioAnalyzer`` over a result
frame), ``multi_manager`` and ``decay`` (the notebook's decay-window
sweep), over ``_convert`` (``PanelVocab``, ``densify_stack``,
``level_values``, ``roundtrip``).

The reference's notebook imports these modules by their bare top-level
names (``import composite_factor``, ``from operations import ts_decay``).
:func:`install` binds those names in ``sys.modules`` to this package's
modules, so the notebook runs unmodified::

    import factormodeling_tpu_torch.compat as compat
    compat.install()          # before the notebook's own imports
    import operations         # -> factormodeling_tpu_torch.compat.operations
"""

from __future__ import annotations

import importlib
import sys

__all__ = ["REFERENCE_MODULES", "composite_factor", "decay",
           "factor_selection_methods", "factor_selector", "install",
           "multi_manager", "operations", "portfolio_analyzer",
           "portfolio_simulation", "uninstall"]

#: reference module name -> compat submodule (1:1): the notebook's import
#: cell names six of these; factor_selection_methods is on the bare
#: namespace through the reference's factor_selector.py
REFERENCE_MODULES = (
    "operations",
    "factor_selector",
    "factor_selection_methods",
    "composite_factor",
    "portfolio_simulation",
    "portfolio_analyzer",
    "multi_manager",
)

_PREFIX = f"{__name__}."


def install(*, overwrite: bool = False) -> list[str]:
    """Register the compat modules in ``sys.modules`` under the reference's
    bare top-level names, so the notebook's imports run unmodified.

    Names already bound to another module (the reference itself, or the
    JAX package's compat) are left alone unless ``overwrite=True``. All
    seven modules are imported before any name is bound, so a failing
    import leaves ``sys.modules`` untouched. Returns the names installed.
    """
    mods = {name: importlib.import_module(_PREFIX + name)
            for name in REFERENCE_MODULES}
    installed = []
    for name, mod in mods.items():
        if not overwrite and name in sys.modules:
            continue
        sys.modules[name] = mod
        installed.append(name)
    return installed


def uninstall() -> list[str]:
    """Undo :func:`install`: drop the bare names bound to this package's
    compat modules (names bound to anything else are untouched)."""
    removed = []
    for name in REFERENCE_MODULES:
        mod = sys.modules.get(name)
        if mod is not None and getattr(mod, "__name__", "").startswith(
                _PREFIX):
            del sys.modules[name]
            removed.append(name)
    return removed


def __getattr__(name):
    """The compat modules, imported on first use."""
    if name in REFERENCE_MODULES or name == "decay":
        return importlib.import_module(_PREFIX + name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
