"""The port's backtest engine against the JAX package, on the CPU in float64
with seeded numpy inputs: ``run_simulation`` for ``equal``, ``linear``,
plain ``mvo`` and ``mvo_turnover`` (both solver kernels), with the sample
covariance and the statistical risk model and with the Anderson
accelerator; the settings' resolution and validation rules, and the
default degrade policy's bitwise inertness.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.backtest import run_simulation as jax_run
from factormodeling_tpu_torch.backtest import (SimulationSettings,
                                               run_simulation)
from tests.torch_threads import torch_one_thread  # noqa: F401


def _market(seed, d=30, n=24):
    rng = np.random.default_rng(seed)
    returns = rng.normal(scale=0.02, size=(d, n))
    returns[rng.uniform(size=(d, n)) < 0.03] = np.nan
    signal = rng.normal(size=(d, n))
    signal[4] = np.abs(signal[4])              # a flat day: no short leg
    cap = rng.integers(0, 4, size=(d, n)).astype(float)
    invest = np.where(rng.uniform(size=(d, n)) < 0.05, 0.0, 1.0)
    universe = rng.uniform(size=(d, n)) > 0.08
    signal[~universe] = np.nan
    signal[9, 3] = np.nan                      # NaN on a present name
    universe[9, 3] = True
    return returns, signal, cap, invest, universe


def _run_both(seed, **kw):
    returns, signal, cap, invest, universe = _market(seed)
    t = SimulationSettings(returns=torch.from_numpy(returns),
                           cap_flag=torch.from_numpy(cap),
                           investability_flag=torch.from_numpy(invest),
                           universe=torch.from_numpy(universe), **kw)
    j = JaxSettings(returns=jnp.asarray(returns), cap_flag=jnp.asarray(cap),
                    investability_flag=jnp.asarray(invest),
                    universe=jnp.asarray(universe), **kw)
    got = run_simulation(torch.from_numpy(signal), t)
    want = jax.jit(jax_run)(jnp.asarray(signal), j)
    return got, want


def _close(a, b, tol, name):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               atol=tol, rtol=0, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(method="equal", pct=0.2),
    dict(method="linear", max_weight=0.15),
    dict(method="equal", pct=0.3, transaction_cost=False, tcost_scale=2.0),
])
def test_deterministic_schemes_match_jax(kw):
    got, want = _run_both(0, **kw)
    # same float64 arithmetic, reassociated
    _close(got.weights, want.weights, 1e-12, "weights")
    np.testing.assert_array_equal(got.long_count.numpy(),
                                  np.asarray(want.long_count))
    np.testing.assert_array_equal(got.short_count.numpy(),
                                  np.asarray(want.short_count))
    for f in got.result._fields:
        _close(getattr(got.result, f), getattr(want.result, f), 1e-12, f)


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_mvo_turnover_matches_jax(kernel):
    kw = dict(method="mvo_turnover", lookback_period=8, max_weight=0.3,
              turnover_penalty=0.1, solver_kernel=kernel)
    got, want = _run_both(1, **kw)
    # the 1e-6 solver pin of the JAX package's own fused-vs-reference fuzz
    _close(got.weights, want.weights, 1e-6, "weights")
    for f in got.result._fields:
        _close(getattr(got.result, f), getattr(want.result, f), 1e-8, f)
    np.testing.assert_array_equal(got.long_count.numpy(),
                                  np.asarray(want.long_count))
    dg, dw = got.diagnostics, want.diagnostics
    for f in ("solver_ok", "active", "polished"):
        np.testing.assert_array_equal(getattr(dg, f).numpy(),
                                      np.asarray(getattr(dw, f)), err_msg=f)
    for f in ("primal_residual", "long_sum", "short_sum"):
        _close(getattr(dg, f), getattr(dw, f), 1e-6, f)
    assert int(dg.qp_solves) == int(dw.qp_solves) == 30
    assert int(dg.suffix_len) == int(dw.suffix_len) == 30


def test_mvo_turnover_float32_panels_keep_their_dtype():
    returns, signal, cap, invest, universe = _market(2)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    s = SimulationSettings(returns=f32(returns), cap_flag=f32(cap),
                           investability_flag=f32(invest),
                           universe=torch.from_numpy(universe),
                           method="mvo_turnover", lookback_period=8,
                           max_weight=0.3, solver_kernel="fused")
    out = run_simulation(f32(signal), s)
    assert out.weights.dtype == torch.float32
    d = out.diagnostics
    traded = d.active & d.solver_ok
    assert traded.any()
    # the QP runs in float64; the legs hold to the float32 cast
    assert float((d.long_sum[traded] - 1).abs().max()) < 1e-5
    assert float((d.short_sum[traded] + 1).abs().max()) < 1e-5


def test_settings_resolution_and_validation_match_jax():
    panels = dict(returns=None, cap_flag=None, investability_flag=None)
    for polish in (True, False):
        for anderson in (0, 5):
            for warm in (True, False):
                for iters in (None, 17):
                    kw = dict(qp_polish=polish, qp_anderson=anderson,
                              qp_warm_start=warm, qp_iters=iters)
                    t = SimulationSettings(**panels, **kw)
                    j = JaxSettings(**panels, **kw)
                    for turnover in (True, False):
                        assert (t.resolved_qp_iters(turnover)
                                == j.resolved_qp_iters(turnover))
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxSettings)}
    port_fields = {f.name: f.default for f in dataclasses.fields(SimulationSettings)}
    assert port_fields == jax_fields
    for bad in (dict(method="x"), dict(covariance="x"), dict(turnover_mode="x"),
                dict(solver_kernel="x"), dict(qp_anderson=-1),
                dict(tcost_scale=-1.0)):
        with pytest.raises(ValueError):
            SimulationSettings(**panels, **bad)
        with pytest.raises(ValueError):
            JaxSettings(**panels, **bad)


def test_cost_rates_match_jax():
    rng = np.random.default_rng(3)
    cap = rng.integers(-1, 6, size=(5, 7)).astype(float)
    cap[0, 0] = np.nan
    t = SimulationSettings(returns=torch.zeros(5, 7, dtype=torch.float64),
                           cap_flag=torch.from_numpy(cap),
                           investability_flag=None, tcost_scale=1.5)
    j = JaxSettings(returns=jnp.zeros((5, 7)), cap_flag=jnp.asarray(cap),
                    investability_flag=None, tcost_scale=1.5)
    _close(t.cost_rates(), j.cost_rates(), 0.0, "rates")


_RISK = dict(covariance="risk_model", risk_factors=3, risk_lookback=12,
             risk_refit_every=5)


@pytest.mark.parametrize("kernel", ["reference", "fused"])
@pytest.mark.parametrize("seed,kw", [
    # D=30 over lanes of 8: three full chunks and a ragged tail of 6
    (1, dict(method="mvo", mvo_batch=8)),
    (1, dict(method="mvo", mvo_batch=8, **_RISK)),
    (1, dict(method="mvo_turnover", lookback_period=8, **_RISK)),
    # turnover under Anderson at a budget where the accelerated path is
    # stable: at the default 20 warm iterations the JAX package's own two
    # kernels already part by 0.2 in weight on these markets
    (2, dict(method="mvo_turnover", lookback_period=8, qp_anderson=5,
             qp_iters=60)),
    (1, dict(method="mvo", mvo_batch=8, qp_anderson=5)),
], ids=["mvo", "mvo_risk_model", "turnover_risk_model", "turnover_anderson",
        "mvo_anderson"])
def test_ported_options_match_jax(seed, kw, kernel):
    got, want = _run_both(seed, max_weight=0.3, solver_kernel=kernel, **kw)
    _close(got.weights, want.weights, 1e-6, "weights")
    for f in got.result._fields:
        _close(getattr(got.result, f), getattr(want.result, f), 1e-8, f)
    for f in ("long_count", "short_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    dg, dw = got.diagnostics, want.diagnostics
    for f in ("solver_ok", "active", "polished"):
        np.testing.assert_array_equal(getattr(dg, f).numpy(),
                                      np.asarray(getattr(dw, f)), err_msg=f)
    for f in ("primal_residual", "long_sum", "short_sum"):
        _close(getattr(dg, f), getattr(dw, f), 1e-6, f)
    for f in ("qp_solves", "sweeps", "converged_days", "suffix_len"):
        assert int(getattr(dg, f)) == int(getattr(dw, f)), f
    assert int(dg.qp_solves) == 30
    assert not dg.iters_to_converge.any()
    acc = dg.anderson_accepted.numpy()
    if kw.get("qp_anderson"):
        assert acc.sum() > 0
        if kw["method"] == "mvo":
            # the plain-MVO path is stable: the same extrapolations taken.
            # (Rollbacks are not compared: after convergence they test
            # residuals at rounding level.)
            np.testing.assert_array_equal(acc, np.asarray(dw.anderson_accepted))
    else:
        assert not acc.any() and not dg.anderson_rejected.any()


def test_unported_options_raise():
    """The degrade policy is ported: the default ``DegradePolicy.make()``
    runs the hold pass and gives the no-policy outputs bit for bit, with
    zero tallies; a ``degrade`` that is not a policy is refused."""
    from factormodeling_tpu_torch.resil import DegradePolicy

    returns, signal, cap, invest, universe = _market(4, d=12, n=5)
    kw = dict(returns=torch.from_numpy(returns), cap_flag=torch.from_numpy(cap),
              investability_flag=torch.from_numpy(invest),
              method="mvo_turnover")
    base = run_simulation(torch.from_numpy(signal), SimulationSettings(**kw))
    inert = run_simulation(torch.from_numpy(signal), SimulationSettings(
        degrade=DegradePolicy.make(), **kw))
    assert base.degrade is None
    assert int(inert.degrade.held_days) == int(inert.degrade.carry_days) == 0
    for a, b in zip(jax.tree_util.tree_leaves(tuple(base[:5])),
                    jax.tree_util.tree_leaves(tuple(inert[:5]))):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    with pytest.raises(TypeError, match="DegradePolicy"):
        SimulationSettings(degrade=object(), **kw)
