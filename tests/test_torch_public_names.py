"""The port's package ``__init__``s export the JAX package's public names.

For every package of ``factormodeling_tpu`` with an ``__init__``, the
public names it exports (its ``__all__``, or else its names without a
leading underscore), leaving out submodules, are the port namesake's
public names, up to two lists named here: names only the JAX package has
because they are JAX's own (none exported by a package ``__init__`` today;
``JAX_ONLY`` keeps the rule), and names the port exports beyond the JAX
package's (``PORT_ONLY``, each with its reason).
"""

import __future__
import importlib
import types

import pytest

from tests.torch_threads import torch_one_thread  # noqa: F401

PACKAGES = ("", "analytics", "backtest", "compat", "composite", "metrics",
            "obs", "online", "ops", "parallel", "resil", "scenarios",
            "selection", "serve", "solvers")

#: names of JAX itself that a JAX package module may hold and the port has
#: no counterpart of (torch has no mesh sharding objects, no jit kernels,
#: no ``lax``)
JAX_ONLY = frozenset({"jax", "jnp", "lax", "Mesh", "NamedSharding",
                      "PartitionSpec", "jit_kernel", "shard_map"})

#: names the port's ``__init__``s export beyond the JAX package's
PORT_ONLY = {
    # the root exports the step's entry points (the JAX package's users
    # import them from their subpackages, which the port's also offers)
    "": {"ResearchConfig", "SimulationSettings", "build_research_step",
         "convert", "convert_warm_state", "result_summary",
         "run_simulation"},
    "analytics": {"DEFAULT_DECAY_PERIODS"},
    # the lanes' knobs for run_simulation on [C, D, N]
    "backtest": {"lane_knobs"},
    "metrics": {"nan_mean_std"},
    "obs": {"code_fingerprint"},
    # the asset layout's placements and the world's teardown
    "parallel": {"asset_in_shardings", "release_world"},
    "selection": {"masked_pairwise_cov"},
    "solvers": {"ADMMResult", "equal_leg_fallback", "leg_constraints",
                "legs_feasible"},
}


def public_names(module) -> set:
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in vars(module) if not n.startswith("_")]
    return {n for n in names
            if not isinstance(getattr(module, n, None),
                              (types.ModuleType, __future__._Feature))}


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "root")
def test_port_init_exports_the_jax_packages_public_names(package):
    suffix = f".{package}" if package else ""
    jax_mod = importlib.import_module(f"factormodeling_tpu{suffix}")
    port_mod = importlib.import_module(f"factormodeling_tpu_torch{suffix}")
    want = public_names(jax_mod) - JAX_ONLY
    got = public_names(port_mod)
    missing = sorted(n for n in want if not hasattr(port_mod, n))
    assert not missing, f"the port lacks {missing}"
    assert got - want == PORT_ONLY.get(package, set())
    # every exported name resolves, and a re-export is the defining
    # module's object
    for name in got:
        assert getattr(port_mod, name) is not None, name


def test_port_root_carries_the_version_and_panels():
    import factormodeling_tpu as jfm
    import factormodeling_tpu_torch as fmt
    from factormodeling_tpu_torch import panel

    assert fmt.__version__ == jfm.__version__
    assert fmt.Panel is panel.Panel and fmt.FactorPanel is panel.FactorPanel


def test_port_backtest_reexports_are_the_schemes_own():
    from factormodeling_tpu_torch import backtest
    from factormodeling_tpu_torch.backtest import mvo, weights

    assert backtest.mvo_weights is mvo.mvo_weights
    assert backtest.mvo_turnover_weights is mvo.mvo_turnover_weights
    for name in ("cap_and_redistribute", "equal_weights", "linear_weights",
                 "normalize_legs"):
        assert getattr(backtest, name) is getattr(weights, name), name
