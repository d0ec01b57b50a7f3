"""The port's online advance against the full research step, on the CPU in
float64 with seeded numpy inputs (F=6, D=24-28, N=12).

- Feeding dates 0..D-1 one at a time through ``make_online_step`` gives the
  PORT's full research step's rows 0..D-2 bit for bit across the scheme
  ladder (equal, linear, mvo, mvo_turnover, NaN returns, a ragged universe,
  the risk model, momentum selection, warm starts off, Anderson): the
  selection, the signal, the traded weights, the leg counts and the solver
  acceptance; the daily P&L rows too, and the P&L rebuilt from the stacked
  online books. Ragged panels pin at seed 99, a seed without NaN-thinned
  blend pools (the quantile-boundary flip of the advance module's docs).
- The same rows against the JAX package's full-recompute step (its
  ``make_tenant_research_step``, the reference kernel) at the step
  tolerances of ``test_torch_pipeline.py``, the manager mix and the blend
  tilt included.
- Single advance calls against the JAX package's ``make_online_step`` at
  those tolerances. (The JAX package's own online ladder is bitwise only
  on some hosts; nothing here leans on it.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu.online import DateSlice as JaxSlice
from factormodeling_tpu.online import make_online_step as jax_online
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu.serve.batched import make_tenant_research_step
from factormodeling_tpu_torch.backtest.pnl import daily_portfolio_returns
from factormodeling_tpu_torch.online import DateSlice, make_online_step
from factormodeling_tpu_torch.serve import TenantConfig
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401

T = torch.from_numpy
F, D, N = 6, 24, 12
SUFFIXES = ("_eq", "_flx", "_long", "_short")
NAMES = tuple(f"fac{i}{SUFFIXES[i % 4]}" for i in range(F))
_QP = {"qp_iters": 30, "mvo_batch": 8}


def make_market(seed=7, nan_returns=False, ragged=False, d=D):
    rng = np.random.default_rng(seed)
    fac = rng.normal(size=(F, d, N))
    ret = rng.normal(scale=0.02, size=(d, N))
    cap = rng.integers(1, 4, size=(d, N)).astype(float)
    invest = np.ones((d, N))
    fr = rng.normal(scale=0.01, size=(d, F))
    universe = None
    if nan_returns:
        ret[rng.uniform(size=ret.shape) < 0.15] = np.nan
    if ragged:
        universe = np.ones((d, N), bool)
        for j in range(0, N, 3):
            a = int(rng.integers(2, d - 6))
            universe[a:a + 3, j] = False
        fac[rng.uniform(size=fac.shape) < 0.1] = np.nan
        ret = np.where(universe, ret, np.nan)
        fac = np.where(universe[None], fac, np.nan)
    return fac, ret, cap, invest, fr, universe


def slice_at(t, fac, ret, cap, invest, fr, universe):
    return DateSlice(factors=fac[:, t, :], returns=ret[t], factor_ret=fr[t],
                     cap_flag=cap[t], investability=invest[t],
                     universe=None if universe is None else universe[t])


def stream(tmpl, market, stats_tail=8):
    fac, ret, cap, invest, fr, universe = market
    init_fn, adv = make_online_step(
        names=NAMES, template=tmpl, n_assets=N,
        has_universe=universe is not None, stats_tail=stats_tail,
        device="cpu")
    mstate, tstate = init_fn()
    rows = []
    for t in range(ret.shape[0]):
        (mstate, tstate), o = adv(tmpl, mstate, tstate, slice_at(t, *market))
        if o.ready:
            rows.append(o)
    return rows, (mstate, tstate)


def port_recompute(tmpl, market):
    fac, ret, cap, invest, fr, universe = market
    d = ret.shape[0]
    select_kwargs = dict(tmpl.select_static)
    if tmpl.select_method == "icir_top":
        select_kwargs.update(top_x=int(tmpl.top_k),
                             icir_threshold=float(tmpl.icir_threshold),
                             use_rank_icir=tmpl.use_rank_icir)
    sim = dict(tmpl.sim_static, method=tmpl.method,
               lookback_period=tmpl.lookback_period,
               max_weight=float(tmpl.max_weight), pct=float(tmpl.pct),
               shrinkage_intensity=float(tmpl.shrinkage_intensity),
               turnover_penalty=float(tmpl.turnover_penalty),
               return_weight=float(tmpl.return_weight),
               tcost_scale=float(tmpl.tcost_scale))
    step = fmt.build_research_step(
        names=NAMES, window=tmpl.window, select_method=tmpl.select_method,
        select_kwargs=select_kwargs, blend_method=tmpl.blend_method,
        sim_kwargs=sim, device="cpu")
    uni = np.ones((d, N), bool) if universe is None else universe
    return step(T(fac), T(ret), T(fr), T(cap), T(invest), T(uni))


def jax_recompute(tmpl, market):
    fac, ret, cap, invest, fr, universe = market
    jt = JaxTenant(**{f.name: getattr(tmpl, f.name)
                      for f in dataclasses.fields(tmpl)})
    step = jax.jit(make_tenant_research_step(names=NAMES, template=jt))
    return step(jt, jnp.asarray(fac), jnp.asarray(ret), jnp.asarray(fr),
                jnp.asarray(cap), jnp.asarray(invest),
                None if universe is None else jnp.asarray(universe))


def stacked(rows, key):
    return torch.stack([getattr(r, key) for r in rows]).numpy()


LADDER = {
    "equal_dense": dict(method="equal"),
    "linear_dense": dict(method="linear"),
    "mvo_dense": dict(method="mvo", sim_static=_QP),
    "mvo_turnover_dense": dict(method="mvo_turnover", sim_static=_QP),
    "mvo_turnover_nan_returns": dict(method="mvo_turnover", sim_static=_QP,
                                     nan_returns=True),
    "mvo_nan_returns": dict(method="mvo", sim_static=_QP, nan_returns=True),
    "mvo_turnover_ragged_universe": dict(method="mvo_turnover",
                                         sim_static=_QP, ragged=True,
                                         seed=99, d=28),
    "equal_ragged_universe": dict(method="equal", ragged=True, seed=99,
                                  d=28),
    "mvo_turnover_risk_model": dict(
        method="mvo_turnover",
        sim_static=dict(_QP, covariance="risk_model", risk_factors=3,
                        risk_lookback=8, risk_refit_every=4)),
    "mvo_risk_model": dict(
        method="mvo",
        sim_static=dict(_QP, covariance="risk_model", risk_factors=3,
                        risk_lookback=8, risk_refit_every=4)),
    "momentum_selector": dict(method="equal", select_method="momentum"),
    "mvo_warm_start_off": dict(method="mvo",
                               sim_static=dict(_QP, qp_warm_start=False)),
    "turnover_anderson": dict(method="mvo_turnover",
                              sim_static=dict(_QP, qp_anderson=5)),
}


def _case(case):
    kw = dict(LADDER[case])
    seed = kw.pop("seed", 7)
    d = kw.pop("d", D)
    market = make_market(seed=seed, nan_returns=kw.pop("nan_returns", False),
                         ragged=kw.pop("ragged", False), d=d)
    tmpl = TenantConfig(window=6, lookback_period=6, **kw).normalized(F, 2)
    return tmpl, market, d


_BITWISE = (("selection", "selection"), ("signal", "signal"),
            ("weights", "sim.weights"), ("long_count", "sim.long_count"),
            ("short_count", "sim.short_count"),
            ("solver_ok", "sim.diagnostics.solver_ok"),
            ("resid", "sim.diagnostics.primal_residual"),
            ("log_return", "sim.result.log_return"),
            ("long_turnover", "sim.result.long_turnover"),
            ("turnover", "sim.result.turnover"))


def _get(out, path):
    for part in path.split("."):
        out = getattr(out, part)
    return out


@pytest.mark.parametrize("case", sorted(LADDER))
def test_incremental_matches_the_ports_recompute_bitwise(case):
    tmpl, market, d = _case(case)
    rows, _ = stream(tmpl, market)
    assert len(rows) == d - 1
    assert [r.day for r in rows] == list(range(d - 1))
    out = port_recompute(tmpl, market)
    for key, path in _BITWISE:
        a = stacked(rows, key)
        b = _get(out, path).numpy()[:d - 1]
        assert a.tobytes() == b.astype(a.dtype).tobytes(), f"{case}/{key}"
    # the P&L of the stacked online books is the recompute's, bit for bit
    fac, ret, cap, invest, fr, universe = market
    traded = np.concatenate([stacked(rows, "weights"),
                             out.sim.weights.numpy()[d - 1:]])
    s = fmt.SimulationSettings(
        returns=T(ret), cap_flag=T(cap), investability_flag=T(invest),
        universe=None if universe is None else T(universe),
        method=tmpl.method, tcost_scale=1.0)
    rebuilt = daily_portfolio_returns(T(traded), s)
    assert rebuilt.log_return.numpy().tobytes() == \
        out.sim.result.log_return.numpy().tobytes()


@pytest.mark.parametrize("case", ["equal_dense", "mvo_turnover_dense",
                                  "mvo_risk_model",
                                  "mvo_turnover_ragged_universe"])
def test_incremental_matches_the_jax_recompute(case):
    tmpl, market, d = _case(case)
    rows, _ = stream(tmpl, market)
    want = jax_recompute(tmpl, market)
    qp = tmpl.method in ("mvo", "mvo_turnover")
    for key, path, tol in (("selection", "selection", 1e-10),
                           ("signal", "signal", 1e-10),
                           ("weights", "sim.weights", 1e-6 if qp else 1e-12),
                           ("log_return", "sim.result.log_return",
                            1e-6 if qp else 1e-12)):
        np.testing.assert_allclose(
            stacked(rows, key), np.asarray(_get(want, path))[:d - 1],
            atol=tol, rtol=0, equal_nan=True, err_msg=f"{case}/{key}")


def test_manager_mix_and_blend_tilt_match_the_jax_recompute():
    market = make_market(seed=5)
    mix = np.linspace(0.5, 1.5, F)
    tmpl = TenantConfig(window=6, lookback_period=6, method="linear",
                        top_k=4, manager_mix=mix,
                        blend_tilt=np.asarray([1.0, 0.0, 2.0, 1.0, 0.0, 1.0])
                        ).normalized(F, F)
    rows, _ = stream(tmpl, market)
    want = jax_recompute(tmpl, market)
    for key, path in (("selection", "selection"), ("signal", "signal"),
                      ("weights", "sim.weights")):
        np.testing.assert_allclose(
            stacked(rows, key), np.asarray(_get(want, path))[:D - 1],
            atol=1e-12, rtol=0, equal_nan=True, err_msg=key)
    # every factor is its own prefix group here; the tilt zeroed two
    assert np.count_nonzero(stacked(rows, "signal")) > 0


@pytest.mark.parametrize("method", ["equal", "mvo_turnover"])
def test_single_advances_match_jax_make_online_step(method):
    market = make_market(seed=11, nan_returns=True)
    kw = dict(window=6, lookback_period=6, method=method)
    if method != "equal":
        kw["sim_static"] = _QP
    tmpl = TenantConfig(**kw).normalized(F, 2)
    jt = JaxTenant(**{f.name: getattr(tmpl, f.name)
                      for f in dataclasses.fields(tmpl)})
    jinit, jadv = jax_online(names=NAMES, template=jt, n_assets=N)
    jadv = jax.jit(jadv)
    init, adv = make_online_step(names=NAMES, template=tmpl, n_assets=N,
                                 device="cpu")
    ms, ts = init()
    jms, jts = jinit()
    fac, ret, cap, invest, fr, _ = market
    for t in range(D):
        (ms, ts), o = adv(tmpl, ms, ts, slice_at(t, *market))
        (jms, jts), jo = jadv(jt, jms, jts, JaxSlice(
            factors=jnp.asarray(fac[:, t]), returns=jnp.asarray(ret[t]),
            factor_ret=jnp.asarray(fr[t]), cap_flag=jnp.asarray(cap[t]),
            investability=jnp.asarray(invest[t])))
        assert o.ready == bool(jo.ready) and o.day == int(jo.day)
        if not o.ready:
            continue
        for key, tol in (("selection", 1e-10), ("signal", 1e-10),
                         ("weights", 1e-6), ("log_return", 1e-6),
                         ("turnover", 1e-6)):
            np.testing.assert_allclose(
                getattr(o, key).numpy(), np.asarray(getattr(jo, key)),
                atol=tol, rtol=0, equal_nan=True, err_msg=f"{t}/{key}")
        assert int(o.long_count) == int(jo.long_count)
        assert bool(o.solver_ok) == bool(jo.solver_ok)
    # the carried state agrees too
    np.testing.assert_allclose(ms.fr_ring.numpy(), np.asarray(jms.fr_ring),
                               atol=0, rtol=0, equal_nan=True)
    np.testing.assert_allclose(ts.long_pnl_by_name.numpy(),
                               np.asarray(jts.long_pnl_by_name), atol=1e-6,
                               rtol=0)
    assert ms.day == int(jms.day) == D - 1 and ms.version == D


def test_restated_tail_refinalizes_to_the_corrected_stream():
    """Re-streaming with one date's exposures corrected changes no
    finalized row before it (the rollback premise of the engine's ring)."""
    tmpl = TenantConfig(window=6, lookback_period=6).normalized(F, 2)
    market = make_market()
    fac = market[0].copy()
    fac[:, D - 4, :] *= 1.5
    rows, _ = stream(tmpl, market)
    rows2, _ = stream(tmpl, (fac,) + market[1:])
    a, b = stacked(rows, "selection"), stacked(rows2, "selection")
    assert a[:D - 4].tobytes() == b[:D - 4].tobytes()


def test_advance_state_stays_on_its_device_and_default_is_the_card():
    tmpl = TenantConfig(window=6, lookback_period=6, method="mvo",
                        sim_static=_QP).normalized(F, 2)
    rows, (ms, ts) = stream(tmpl, make_market(seed=3))
    leaves = fmt.resil.checkpoint.tree_leaves((ms, ts))
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    assert tensors and all(x.device.type == "cpu" for x in tensors)
    assert ts.w_prev.dtype == torch.float64 and ts.warm_ring.z.shape == (8, N)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_online_step(names=NAMES, template=tmpl, n_assets=N)
