"""The port's lane-batched ``turnover_mode="parallel"`` buckets
(``backtest/mvo.py::turnover_parallel_blocks`` on a ``[C, D, N]`` signal
under ``[C]`` knobs) on the CPU in float64, on ``tests/test_torch_lanes.py``'s
market (C=3, D=24, N=16, lookback 6):

- lane by lane bitwise the port's unbatched call on that lane's knobs, for
  a bucket whose lanes certify every day, only the two short-history
  ladder days, and three days (penalties 0, 50 and 0.1), and for one
  whose lanes stop at different sweeps (a lane certified at its first
  sweep while the others stall at their second), with a ragged chunk
  tail;
- the second against ``jax.vmap`` of the JAX package's ``run_simulation``
  at ``test_torch_lanes.py``'s tolerances (weights 1e-6, the daily P&L
  1e-8) with the leg counts, ``solver_ok`` and the four ``SchemeStats``
  exact lane by lane;
- the lane that certifies no solved day re-solves from day 2 with the
  scan's own day step: its lane is the scan's, bit for bit;
- the counts: each sweep solves, a chunk at a time, only the lanes still
  sweeping; the suffix solves each date once for the lanes past their
  start; the batched step and the scenario engine run one simulation for
  such a bucket.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.backtest import run_simulation as jax_run
from factormodeling_tpu_torch import scenarios
from factormodeling_tpu_torch.backtest import (SimulationSettings,
                                               run_simulation)
from factormodeling_tpu_torch.backtest import mvo as mvo_mod
from factormodeling_tpu_torch.backtest.settings import lane_knobs
from factormodeling_tpu_torch.serve import (TenantConfig,
                                            make_batched_research_step,
                                            stack_configs)
from factormodeling_tpu_torch.serve import batched as batched_mod
from tests.test_torch_lanes import (KNOBS, LOOKBACK, NAMES, _bitwise, _close,
                                    _counting, _market, _serving_market)
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401

C, D, N = 3, 24, 16
PENALTIES = [0.0, 50.0, 0.1]
#: (extra settings, each lane's (sweeps, certified days))
CASES = {
    # lane 0 certifies every day, lane 1 only the ladder days 0-1, lane 2
    # three days; every lane sweeps twice
    "starts": (dict(mvo_batch=8), [(2, 24), (2, 2), (2, 3)]),
    # lane 0 stops at its first sweep (certified), lanes 1-2 stall at their
    # second and start their suffix on days 2 and 3; chunks of 5, 5, 5, 5
    # and 4 dates
    "sweeps": (dict(mvo_batch=5, qp_iters=100), [(1, 24), (2, 2), (2, 3)]),
}


def _settings(case):
    extra, _ = CASES[case]
    signal, panels = _market(7, False)
    s = SimulationSettings(
        **{k: torch.from_numpy(v) for k, v in panels.items()},
        lookback_period=LOOKBACK, method="mvo_turnover",
        turnover_mode="parallel",
        **lane_knobs(dict(KNOBS, turnover_penalty=PENALTIES), "cpu"),
        **extra)
    return torch.from_numpy(signal), s, panels


def _stats(out):
    d = out.diagnostics
    return [tuple(int(getattr(d, f)[i]) for f in
                  ("qp_solves", "sweeps", "converged_days", "suffix_len"))
            for i in range(C)]


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_bucket_lanes_are_their_unbatched_calls(case):
    signal, s, _ = _settings(case)
    got = run_simulation(signal, s)
    assert got.weights.shape == (C, D, N)
    for i, (sweeps, certified) in enumerate(CASES[case][1]):
        assert _stats(got)[i] == (D + sweeps * D + D - certified, sweeps,
                                  certified, D - certified)
        one = run_simulation(signal[i], s.lane(i, C))
        _bitwise(batched_mod.tree_lane(got, i), one, f"{case} lane {i}")


def test_parallel_bucket_matches_jax_vmap():
    """Lanes that stop at different sweeps and start their suffix on
    different days, against what ``jax.vmap`` computes."""
    signal, s, panels = _settings("sweeps")
    got = run_simulation(signal, s)
    extra, _ = CASES["sweeps"]
    knobs = dict(KNOBS, turnover_penalty=PENALTIES)

    def one(sig, lane_knobs_, market):
        return jax_run(sig, JaxSettings(
            lookback_period=LOOKBACK, method="mvo_turnover",
            turnover_mode="parallel", **market, **lane_knobs_, **extra))

    want = jax.jit(jax.vmap(one, in_axes=(0, 0, None)))(
        jnp.asarray(signal.numpy()),
        {k: jnp.asarray(v) for k, v in knobs.items()},
        {k: jnp.asarray(v) for k, v in panels.items()})
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


def test_lane_with_no_certified_solve_is_the_scan_bit_for_bit():
    """Lane 1 (penalty 50) certifies only the ladder days 0-1: from day 2
    its suffix is the scan's day step on the scan's carry, so the lane is
    its own scan's, bit for bit, inside the bucket."""
    signal, s, _ = _settings("starts")
    got = run_simulation(signal, s)
    assert _stats(got)[1][2] == 2
    scan = run_simulation(signal[1], dataclasses.replace(
        s.lane(1, C), turnover_mode="scan"))
    lane = batched_mod.tree_lane(got, 1)
    for f in ("weights", "long_count", "short_count"):
        assert (getattr(lane, f).numpy().tobytes()
                == getattr(scan, f).numpy().tobytes()), f
    for f in ("polished", "solver_ok", "primal_residual"):
        assert (getattr(lane.diagnostics, f).numpy().tobytes()
                == getattr(scan.diagnostics, f).numpy().tobytes()), f


def test_sweeps_solve_the_running_lanes_and_the_suffix_each_date_once(
        monkeypatch):
    """On the "sweeps" bucket: the seed and the first sweep solve all three
    lanes a chunk, the second sweep only lanes 1-2; the suffix solves lane
    1 alone on day 2, then lanes 1-2 once a date (lane 0 is certified
    throughout)."""
    signal, s, _ = _settings("sweeps")
    solves = _counting(monkeypatch, mvo_mod, "_solve_day")
    run_simulation(signal, s)
    widths = [a[0].shape[0] for a in solves]
    chunks = [5, 5, 5, 5, 4]
    seed_and_first = [C * c for c in chunks] * 2
    second = [2 * c for c in chunks]
    assert widths == seed_and_first + second + [1] + [2] * (D - 3)


def test_serve_and_scenarios_run_one_simulation_for_a_parallel_bucket(
        monkeypatch):
    market = _serving_market()
    sims = _counting(monkeypatch, batched_mod, "run_simulation")
    solves = _counting(monkeypatch, mvo_mod, "_solve_day")
    template = dict(method="mvo_turnover", lookback_period=LOOKBACK,
                    window=6, icir_threshold=-1.0,
                    sim_static=(("qp_iters", 30),
                                ("turnover_mode", "parallel"),
                                ("mvo_batch", 8)))
    configs = [TenantConfig(top_k=2 + i, max_weight=0.3 + 0.05 * i,
                            turnover_penalty=0.05 * (i + 1), **template)
               .normalized(5, 3) for i in range(C)]
    step = make_batched_research_step(names=NAMES, template=configs[0])
    panels = [torch.from_numpy(np.asarray(market[k])) for k in
              ("factors", "returns", "factor_ret", "cap_flag",
               "investability", "universe")]
    out = step(stack_configs(configs), *panels)
    assert out.sim.weights.shape == (C, D, N)
    assert len(sims) == 1
    # the seed: one solve of every lane's chunk
    assert solves[0][0].shape[0] == C * 8
    single = make_batched_research_step(names=NAMES, template=configs[0])
    for i in range(C):
        one = single(stack_configs([configs[i]]), *panels)
        _bitwise(batched_mod.tree_lane(out.sim, i),
                 batched_mod.tree_lane(one.sim, 0), f"serve lane {i}")

    sims.clear()
    res = scenarios.run_scenarios(
        names=NAMES, template=TenantConfig(**template),
        spec=scenarios.AdversarialSpec.make(seed=3, window_len=10,
                                            nan_rate=0.05, stale_rate=0.3),
        n_paths=4, chunk=4, map_chunk=4, device="cpu",
        **{k: torch.from_numpy(np.asarray(v)) for k, v in market.items()})
    assert res.finite_ok and len(sims) == 1
