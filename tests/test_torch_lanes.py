"""The port's lane-batched backtest (``run_simulation`` on a ``[C, D, N]``
signal under ``[C]`` settings knobs) on the CPU in float64, with seeded
numpy inputs (C=3 lanes whose six knobs all differ, D=24, N=16, lookback
6):

- each method and option (``equal``, ``linear``, plain ``mvo``, the
  ``mvo_turnover`` scan with the sample covariance and the risk model, with
  Anderson 0 and 5, under a ``DegradePolicy``, with ``[C, D, N]`` panels
  one a lane, and through the fused segment's plain twin) lane by lane
  bitwise the port's unbatched call on that lane's knobs and panels;
- ``equal``, ``linear``, ``mvo`` and the scan under a policy over lane
  panels against ``jax.vmap`` of the JAX package's ``run_simulation`` at
  ``test_torch_serve.py``'s tolerances (weights 1e-6, the daily P&L 1e-8,
  leg counts exact). Each JAX program compiles in ~11 s here, so the
  other scan options are held to JAX through their unbatched call
  (``test_torch_backtest.py::test_ported_options_match_jax`` at the same
  tolerances; Anderson on turnover days parts from JAX by design, ROADMAP
  queue 3) and the shared-panel scan through ``test_torch_serve.py``'s
  ``mvo_turnover`` bucket;
- the counts: the tenant body and ``run_simulation`` run once a dispatch,
  and the turnover scan's ``_solve_day`` once a date for the bucket (all
  its lanes in one solve), in the batched step, the scenario engine and
  ``advance_all``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.backtest import run_simulation as jax_run
from factormodeling_tpu.resil import DegradePolicy as JaxPolicy
from factormodeling_tpu_torch import scenarios
from factormodeling_tpu_torch.backtest import (SimulationSettings,
                                               run_simulation)
from factormodeling_tpu_torch.backtest import mvo as mvo_mod
from factormodeling_tpu_torch.backtest.settings import LANE_KNOBS, lane_knobs
from factormodeling_tpu_torch.online import DateSlice
from factormodeling_tpu_torch.online import advance as advance_mod
from factormodeling_tpu_torch.resil import DegradePolicy
from factormodeling_tpu_torch.resil.checkpoint import tree_leaves
from factormodeling_tpu_torch.serve import (TenantConfig, TenantServer,
                                            make_batched_research_step,
                                            stack_configs)
from factormodeling_tpu_torch.serve import batched as batched_mod
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401

C, D, N, LOOKBACK = 3, 24, 16, 6
KNOBS = dict(max_weight=[0.3, 0.25, 0.4], pct=[0.2, 0.3, 0.15],
             shrinkage_intensity=[0.1, 0.3, 0.05],
             turnover_penalty=[0.1, 0.05, 0.2],
             return_weight=[0.0, 0.1, 0.02], tcost_scale=[1.0, 0.5, 2.0])
_RISK = dict(covariance="risk_model", risk_factors=2, risk_lookback=12,
             risk_refit_every=5)
_POLICY = dict(min_universe=13, quarantine_nan_frac=0.5, clamp_absmax=5.0,
               carry_fallback=True)
#: (settings, a policy, panels one a lane, held to jax.vmap)
CASES = {
    "equal": (dict(method="equal"), False, False, True),
    "linear": (dict(method="linear"), False, False, True),
    "mvo": (dict(method="mvo", mvo_batch=8), False, False, True),
    "turnover_policy_lane_panels": (dict(method="mvo_turnover"), True, True,
                                    True),
    "turnover": (dict(method="mvo_turnover"), False, False, False),
    "turnover_risk_model": (dict(method="mvo_turnover", **_RISK), False,
                            False, False),
    "turnover_anderson": (dict(method="mvo_turnover", qp_anderson=5), False,
                          False, False),
    # the segment kernel's plain twin on the CPU
    "turnover_fused": (dict(method="mvo_turnover", solver_kernel="fused"),
                       False, False, False),
}


def _market(seed, lane_panels):
    """Signal lanes ``[C, D, N]`` and the panels, ``[D, N]`` or one a
    lane: NaN returns, a flat day, a NaN signal on a present name, a thin
    universe day (the policy's hold)."""
    rng = np.random.default_rng(seed)
    lead = (C,) if lane_panels else ()
    returns = rng.normal(scale=0.02, size=lead + (D, N))
    returns[rng.uniform(size=returns.shape) < 0.03] = np.nan
    cap = rng.integers(0, 4, size=lead + (D, N)).astype(float)
    invest = np.where(rng.uniform(size=lead + (D, N)) < 0.05, 0.0, 1.0)
    universe = rng.uniform(size=lead + (D, N)) > 0.08
    universe[..., 12, :5] = False
    signal = rng.normal(size=(C, D, N))
    signal[:, 4] = np.abs(signal[:, 4])
    signal[~np.broadcast_to(universe, signal.shape)] = np.nan
    signal[1, 9, 3] = np.nan
    return signal, dict(returns=returns, cap_flag=cap,
                        investability_flag=invest, universe=universe)


def _port(case):
    kw, policy, lane_panels, _ = CASES[case]
    signal, panels = _market(7, lane_panels)
    s = SimulationSettings(
        **{k: torch.from_numpy(v) for k, v in panels.items()},
        lookback_period=LOOKBACK,
        degrade=DegradePolicy.make(**_POLICY) if policy else None,
        **lane_knobs(KNOBS, "cpu"), **kw)
    return torch.from_numpy(signal), s, panels


def _jax(case, signal, panels):
    kw, policy, lane_panels, _ = CASES[case]
    pol = JaxPolicy.make(**_POLICY) if policy else None

    def one(sig, knobs, market):
        s = JaxSettings(lookback_period=LOOKBACK, degrade=pol, **market,
                        **knobs, **kw)
        return jax_run(sig, s)

    knobs = {k: jnp.asarray(v) for k, v in KNOBS.items()}
    market = {k: jnp.asarray(v) for k, v in panels.items()}
    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0 if lane_panels else None)))(
        jnp.asarray(signal), knobs, market)


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               atol=tol, rtol=0, equal_nan=True, err_msg=what)


def _bitwise(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), what


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_match_jax_vmap_and_the_unbatched_call(case):
    signal, s, panels = _port(case)
    got = run_simulation(signal, s)
    assert got.weights.shape == (C, D, N)
    # lane by lane: the unbatched call on the lane's knobs and panels
    for i in range(C):
        one = run_simulation(signal[i], s.lane(i, C))
        _bitwise(batched_mod.tree_lane(got, i), one, f"{case} lane {i}")
    if CASES[case][0].get("qp_anderson"):
        assert int(got.diagnostics.anderson_accepted.sum()) > 0
    if not CASES[case][3]:
        return
    want = _jax(case, signal.numpy(), panels)
    _close(got.weights, want.weights, 1e-6, "weights")
    for f in got.result._fields:
        _close(getattr(got.result, f), getattr(want.result, f), 1e-8, f)
    for f in ("long_count", "short_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    dg, dw = got.diagnostics, want.diagnostics
    np.testing.assert_array_equal(dg.solver_ok.numpy(),
                                  np.asarray(dw.solver_ok))
    for f in ("qp_solves", "sweeps", "converged_days", "suffix_len"):
        np.testing.assert_array_equal(getattr(dg, f).numpy(),
                                      np.asarray(getattr(dw, f)), f)
    if CASES[case][1]:
        assert int(got.degrade.held_days.sum()) > 0
        for f in got.degrade._fields:
            np.testing.assert_array_equal(getattr(got.degrade, f).numpy(),
                                          np.asarray(getattr(want.degrade,
                                                             f)), f)


def test_lane_knobs_are_checked_like_the_scalars():
    with pytest.raises(ValueError, match="tcost_scale"):
        lane_knobs(dict(tcost_scale=[1.0, -0.5]), "cpu")
    with pytest.raises(ValueError, match="lane knob"):
        lane_knobs(dict(lookback_period=[3]), "cpu")
    signal, s, _ = _port("equal")
    assert s.lanes() == C and set(LANE_KNOBS) == set(KNOBS)
    with pytest.raises(ValueError, match="one C"):
        SimulationSettings(returns=s.returns, cap_flag=s.cap_flag,
                           investability_flag=s.investability_flag,
                           max_weight=torch.ones(2), pct=torch.ones(3))


# ------------------------------------------------------------- the counts

F = 5
NAMES = ("fam0_f0_flx", "fam0_f1_eq", "fam1_f2_flx", "fam1_f3_long",
         "fam2_f4_flx")
_TURNOVER = dict(method="mvo_turnover", lookback_period=LOOKBACK,
                 window=6, icir_threshold=-1.0, sim_static=(("qp_iters", 30),))


def _serving_market():
    rng = np.random.default_rng(20261018)
    return dict(
        factors=rng.normal(size=(F, D, N)),
        returns=rng.normal(scale=0.02, size=(D, N)),
        factor_ret=rng.normal(scale=0.01, size=(D, F)),
        cap_flag=rng.integers(1, 4, size=(D, N)).astype(float),
        investability=np.ones((D, N)),
        universe=rng.uniform(size=(D, N)) > 0.05)


def _bucket():
    return [TenantConfig(top_k=2 + i, max_weight=0.3 + 0.05 * i,
                         turnover_penalty=0.05 * (i + 1), **_TURNOVER)
            for i in range(C)]


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_one_body_a_dispatch_and_one_solve_a_date(monkeypatch):
    market = _serving_market()
    sims = _counting(monkeypatch, batched_mod, "run_simulation")
    solves = _counting(monkeypatch, mvo_mod, "_solve_day")
    # the online advance imports the same function
    monkeypatch.setattr(advance_mod, "_solve_day", mvo_mod._solve_day)
    configs = [c.normalized(F, 3) for c in _bucket()]
    step = make_batched_research_step(names=NAMES, template=configs[0])
    out = step(stack_configs(configs),
               *(torch.from_numpy(np.asarray(market[k])) for k in
                 ("factors", "returns", "factor_ret", "cap_flag",
                  "investability", "universe")))
    assert out.sim.weights.shape == (C, D, N)
    # one simulation for the bucket; the scan solves every lane of a date
    # at once: D solves of C lanes, not C * D of one
    assert len(sims) == 1
    assert len(solves) == D and {a[0].shape[0] for a in solves} == {C}

    # the scenario engine: one tenant body a sub-batch of paths
    sims.clear()
    solves.clear()
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in market.items()}
    res = scenarios.run_scenarios(
        names=NAMES, template=TenantConfig(**_TURNOVER),
        spec=scenarios.AdversarialSpec.make(seed=3, window_len=10,
                                            nan_rate=0.05, stale_rate=0.3),
        n_paths=4, chunk=4, map_chunk=2, device="cpu", **tp)
    assert res.finite_ok and len(sims) == 2 and len(solves) == 2 * D
    assert {a[0].shape[0] for a in solves} == {2}

    # advance_all: one solve of the session's lanes a finalized date
    solves.clear()
    server = TenantServer(names=NAMES, pad_ladder=(1, 4), device="cpu",
                          **market)
    server.online_begin(_bucket())
    days = 8
    for t in range(days):
        rows = server.advance_all(DateSlice(
            market["factors"][:, t], market["returns"][t],
            market["factor_ret"][t], market["cap_flag"][t],
            market["investability"][t], market["universe"][t]))
        assert len(rows) == C
    assert len(solves) == days - 1 and {a[0].shape[0] for a in solves} == {C}


def test_blend_lanes_in_memory_chunks_are_the_whole_batch(monkeypatch):
    """Lanes past the blend's memory budget run in chunks of lanes (per-lane
    factors, universe and tilts sliced with them), bitwise the whole
    batch's."""
    from factormodeling_tpu_torch.composite import blend

    rng = np.random.default_rng(5)
    factors = torch.from_numpy(rng.normal(size=(C, F, D, N)))
    universe = torch.from_numpy(rng.uniform(size=(C, D, N)) > 0.1)
    sel = torch.from_numpy(np.where(rng.uniform(size=(C, D, F)) < 0.5, 0.0,
                                    rng.uniform(size=(C, D, F))))
    tilt = rng.uniform(0.5, 2.0, size=(C, 3))
    whole = blend.composite_weighted(factors, NAMES, sel, universe=universe,
                                     group_tilt=tilt)
    monkeypatch.setattr(blend, "_BLEND_CHUNK_ELEMS", F * D * N)
    chunked = blend.composite_weighted(factors, NAMES, sel,
                                       universe=universe, group_tilt=tilt)
    assert whole.shape == (C, D, N)
    assert whole.numpy().tobytes() == chunked.numpy().tobytes()
