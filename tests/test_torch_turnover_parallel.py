"""The port's ``turnover_mode="parallel"`` (the fixed-point turnover scheme
of ``factormodeling_tpu_torch/backtest/mvo.py``) against the JAX package's
parallel mode, on the CPU in float64 with seeded numpy inputs, at D=16,
N=12 (the shape of ``tests/test_turnover_parallel.py``).

- the fallback-ladder matrix: weights within 1e-5 of the JAX package's
  parallel mode, leg counts, ``solver_ok`` and the scheme stats exact, and
  within 1e-5 of the port's own scan;
- the fused solver kernel (its plain twin on the CPU) in the lanes;
- the exhaustion fallback: no solved day certified, the suffix is the
  port's scan bit for bit;
- the contractive limit (penalty 0): the suffix vanishes;
- a ragged lane tail with per-day warm states, and the risk model through
  certified sweeps;
- on the card, the fused kernel's launches follow the scheme's schedule.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.backtest import run_simulation as jax_run
from factormodeling_tpu.backtest import sweep_stats as jax_sweep_stats
from factormodeling_tpu_torch.backtest import (SimulationSettings,
                                               run_simulation, sweep_stats)
from tests.torch_threads import torch_one_thread  # noqa: F401

D, N = 16, 12

# one jitted JAX entry point for the file: configurations that share their
# statics and shapes share a compilation
JAX_RUN = jax.jit(jax_run)


def make_market(rng, nan_frac=0.0):
    returns = rng.normal(scale=0.02, size=(D, N))
    if nan_frac:
        returns[rng.uniform(size=(D, N)) < nan_frac] = np.nan
    cap = rng.integers(1, 4, size=(D, N)).astype(float)
    invest = np.ones((D, N))
    signal = rng.normal(size=(D, N))
    if nan_frac:
        signal[rng.uniform(size=(D, N)) < nan_frac] = np.nan
    signal[3] = np.abs(signal[3])  # a long-only day -> zero day
    return dict(returns=returns, cap=cap, invest=invest, signal=signal)


def make_ragged(rng):
    """NaN returns and signals plus universe gaps: zero days, the NaN-signal
    rejection and short covariance windows."""
    m = make_market(rng, nan_frac=0.15)
    universe = np.ones((D, N), dtype=bool)
    for j in range(0, N, 3):
        a = int(rng.integers(2, D - 4))
        universe[a:a + 3, j] = False
    m["returns"] = np.where(universe, m["returns"], np.nan)
    m["signal"] = np.where(universe, m["signal"], np.nan)
    m["universe"] = universe
    return m


def run_port(m, **kw):
    uni = m.get("universe")
    s = SimulationSettings(
        returns=torch.from_numpy(m["returns"]),
        cap_flag=torch.from_numpy(m["cap"]),
        investability_flag=torch.from_numpy(m["invest"]),
        universe=None if uni is None else torch.from_numpy(uni),
        method="mvo_turnover", **kw)
    return run_simulation(torch.from_numpy(m["signal"]), s)


def run_jax(m, **kw):
    uni = m.get("universe")
    s = JaxSettings(returns=jnp.asarray(m["returns"]),
                    cap_flag=jnp.asarray(m["cap"]),
                    investability_flag=jnp.asarray(m["invest"]),
                    universe=None if uni is None else jnp.asarray(uni),
                    method="mvo_turnover", **kw)
    return JAX_RUN(jnp.asarray(m["signal"]), s)


def max_dw(a, b) -> float:
    return float(np.abs(np.nan_to_num(np.asarray(a))
                        - np.nan_to_num(np.asarray(b))).max())


def assert_matches_jax(got, want, tol):
    assert max_dw(got.weights, want.weights) <= tol
    np.testing.assert_array_equal(got.long_count.numpy(),
                                  np.asarray(want.long_count))
    np.testing.assert_array_equal(got.short_count.numpy(),
                                  np.asarray(want.short_count))
    np.testing.assert_array_equal(got.diagnostics.solver_ok.numpy(),
                                  np.asarray(want.diagnostics.solver_ok))
    assert sweep_stats(got.diagnostics) == jax_sweep_stats(want.diagnostics)


def assert_solve_count(stats):
    assert stats["qp_solves"] == D + stats["sweeps"] * D + stats["suffix_len"]
    assert stats["converged_days"] + stats["suffix_len"] == D


# the JAX file's matrix: production budgets, and a tight tolerance that
# leaves only the deterministic ladder days certified, so the sequential
# suffix carries the comparison
_TIGHT = dict(max_weight=0.5, lookback_period=6, mvo_batch=8,
              turnover_tol=1e-9)
LADDER_MATRIX = {
    "dense": dict(_TIGHT),
    "nan_universe_none": dict(_TIGHT, nan=True),
    "ragged_universe": dict(_TIGHT, ragged=True),
    "risk_model": dict(max_weight=0.5, mvo_batch=8, turnover_tol=1e-9,
                       covariance="risk_model", risk_factors=3,
                       risk_lookback=8, risk_refit_every=4),
    "warm_start_off": dict(_TIGHT, qp_warm_start=False),
    "polish_off": dict(_TIGHT, qp_polish=False),
}


@pytest.mark.parametrize("case", sorted(LADDER_MATRIX))
def test_parallel_matches_jax_across_ladder(rng, case):
    kw = dict(LADDER_MATRIX[case])
    nan = kw.pop("nan", False)
    if kw.pop("ragged", False):
        m = make_ragged(rng)
        # the ragged panel exercises the NaN-signal rejection
        assert (np.isnan(m["signal"]) & m["universe"]).any()
    else:
        m = make_market(rng, nan_frac=0.1 if nan else 0.0)
    got = run_port(m, turnover_mode="parallel", **kw)
    want = run_jax(m, turnover_mode="parallel", **kw)
    assert_matches_jax(got, want, 1e-5)
    np.testing.assert_allclose(got.result.log_return.numpy(),
                               np.asarray(want.result.log_return),
                               atol=1e-6, rtol=0, equal_nan=True)
    assert_solve_count(sweep_stats(got.diagnostics))
    scan = run_port(m, turnover_mode="scan", **kw)
    assert max_dw(got.weights, scan.weights) <= 1e-5
    np.testing.assert_array_equal(got.diagnostics.solver_ok.numpy(),
                                  scan.diagnostics.solver_ok.numpy())


def test_parallel_fused_kernel_lanes_match_jax(rng):
    """The lanes honour ``solver_kernel="fused"`` (the kernel's plain twin
    on a CPU tensor); the function is still the JAX package's, whose lanes
    run its reference kernel."""
    m = make_market(rng)
    got = run_port(m, turnover_mode="parallel", solver_kernel="fused",
                   **_TIGHT)
    want = run_jax(m, turnover_mode="parallel", solver_kernel="fused",
                   **_TIGHT)
    assert_matches_jax(got, want, 1e-5)
    ref = run_port(m, turnover_mode="parallel", **_TIGHT)
    assert max_dw(got.weights, ref.weights) <= 1e-6


def test_exhausted_sweeps_fall_back_to_the_scan_bit_for_bit(rng):
    """A penalty of 50 with one sweep certifies only the two short-history
    ladder days; the suffix from day 2 is the scan's own day loop, entered
    from the same state, and builds its Gram as the scan does."""
    m = make_market(rng)
    kw = dict(max_weight=0.5, lookback_period=6, turnover_penalty=50.0,
              turnover_sweeps=1)
    par = run_port(m, turnover_mode="parallel", **kw)
    scan = run_port(m, turnover_mode="scan", **kw)
    stats = sweep_stats(par.diagnostics)
    assert stats["sweeps"] == 1
    assert stats["converged_days"] == 2
    assert stats["suffix_len"] == D - 2
    assert stats["qp_solves"] == 2 * D + (D - 2)
    # JAX's own bar (float reassociation in its jitted graph), then bitwise
    np.testing.assert_allclose(par.weights.numpy(), scan.weights.numpy(),
                               rtol=0, atol=1e-7, equal_nan=True)
    np.testing.assert_array_equal(par.weights.numpy(), scan.weights.numpy())
    for f in ("polished", "solver_ok", "primal_residual"):
        np.testing.assert_array_equal(getattr(par.diagnostics, f).numpy(),
                                      getattr(scan.diagnostics, f).numpy(),
                                      err_msg=f)
    want = run_jax(m, turnover_mode="parallel", **kw)
    assert stats == jax_sweep_stats(want.diagnostics)


def test_certified_rejected_day_parts_from_the_scan_as_in_jax():
    """The JAX package's certificate is sweep stability: with warm starts
    off a sweep re-solves a day from cold, so once its ``w_prev`` settles a
    day whose reduced polish (``turnover_polish_passes``) the guard rejects
    is certified at its budget-limited iterate, where the scan's full
    polish is accepted. On this market that is day 2, 0.12 in weight from
    the scan; the port reproduces the JAX package's parallel mode there."""
    m = make_market(np.random.default_rng(11))
    kw = dict(_TIGHT, qp_warm_start=False)
    got = run_port(m, turnover_mode="parallel", **kw)
    assert_matches_jax(got, run_jax(m, turnover_mode="parallel", **kw), 1e-5)
    scan = run_port(m, turnover_mode="scan", **kw)
    jax_scan = run_jax(m, turnover_mode="scan", **kw)
    assert max_dw(got.weights[3], scan.weights[3]) > 1e-2   # day 2, shifted
    assert max_dw(scan.weights, jax_scan.weights) <= 1e-5
    assert sweep_stats(got.diagnostics)["converged_days"] > 2
    assert not got.diagnostics.polished[2] and scan.diagnostics.polished[2]


def test_decoupled_penalty_certifies_every_day(rng):
    """Penalty 0 is the contractive limit: the day map ignores ``w_prev``,
    the sweeps certify every day and the suffix vanishes."""
    m = make_market(rng)
    kw = dict(max_weight=0.5, lookback_period=6, qp_iters=1000, mvo_batch=8,
              turnover_penalty=0.0)
    got = run_port(m, turnover_mode="parallel", **kw)
    stats = sweep_stats(got.diagnostics)
    assert stats["suffix_len"] == 0
    assert stats["converged_days"] == D
    assert 1 <= stats["sweeps"] <= 4
    assert_solve_count(stats)
    want = run_jax(m, turnover_mode="parallel", **kw)
    assert max_dw(got.weights, want.weights) <= 1e-6
    assert stats == jax_sweep_stats(want.diagnostics)
    scan = run_port(m, turnover_mode="scan", **kw)
    assert max_dw(got.weights, scan.weights) <= 1e-6


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_ragged_lane_tail_keeps_per_day_warm_states(rng, kernel):
    """``mvo_batch=5`` over 16 dates leaves a tail chunk of one lane. With
    the polish off and the penalty 0, every sweep continues each day's own
    ADMM iterates, so a warm state taken from another date would show in
    the weights."""
    m = make_market(rng)
    kw = dict(max_weight=0.5, lookback_period=6, mvo_batch=5,
              turnover_penalty=0.0, qp_polish=False, turnover_tol=1e-7,
              solver_kernel=kernel)
    got = run_port(m, turnover_mode="parallel", **kw)
    want = run_jax(m, turnover_mode="parallel", **kw)
    stats = sweep_stats(got.diagnostics)
    assert stats["sweeps"] >= 2
    assert_matches_jax(got, want, 1e-8)
    assert_solve_count(stats)


def test_risk_model_certified_sweeps_match_jax(rng):
    """The risk model (no window Gram) through certified sweeps: penalty 0
    certifies every day, so the result is the sweeps' own."""
    m = make_ragged(rng)
    kw = dict(max_weight=0.5, mvo_batch=8, turnover_penalty=0.0,
              qp_iters=400, covariance="risk_model", risk_factors=3,
              risk_lookback=12, risk_refit_every=5)
    got = run_port(m, turnover_mode="parallel", **kw)
    want = run_jax(m, turnover_mode="parallel", **kw)
    stats = sweep_stats(got.diagnostics)
    assert stats["suffix_len"] == 0
    assert_matches_jax(got, want, 1e-5)
    assert_solve_count(stats)


def test_sweep_and_seed_budgets_resolve_as_in_jax():
    panels = dict(returns=None, cap_flag=None, investability_flag=None)
    for kw in (dict(), dict(qp_polish=False), dict(qp_anderson=5),
               dict(qp_warm_start=False, qp_iters=17),
               dict(turnover_sweep_iters=13),
               dict(turnover_seed_iters=11, turnover_sweep_iters=7)):
        t = SimulationSettings(**panels, **kw)
        j = JaxSettings(**panels, **kw)
        assert t.resolved_sweep_iters() == j.resolved_sweep_iters()
        assert t.resolved_seed_iters() == j.resolved_seed_iters()


def test_scan_reports_sequential_stats(rng):
    m = make_market(rng)
    got = run_port(m, max_weight=0.5, lookback_period=6, qp_iters=50)
    assert sweep_stats(got.diagnostics) == {
        "qp_solves": D, "sweeps": 0, "converged_days": 0,
        "converged_day_frac": 0.0, "suffix_len": D}


@pytest.mark.cuda
def test_parallel_on_card_launches_the_lane_schedule(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    m = make_market(rng)
    kw = dict(max_weight=0.5, lookback_period=6, mvo_batch=5,
              solver_kernel="fused", turnover_mode="parallel")
    uni = torch.ones((D, N), dtype=torch.bool)
    s = SimulationSettings(
        returns=torch.from_numpy(m["returns"]).cuda(),
        cap_flag=torch.from_numpy(m["cap"]).cuda(),
        investability_flag=torch.from_numpy(m["invest"]).cuda(),
        universe=uni.cuda(), method="mvo_turnover", **kw)
    ak.launches = ak.lane_launches = 0
    out = run_simulation(torch.from_numpy(m["signal"]).cuda(), s)
    stats = sweep_stats(out.diagnostics)
    # chunks of 5, 5, 5 and 1 dates: the last is a launch of one lane
    lane_chunks, chunks, segs = D // 5, math.ceil(D / 5), math.ceil(40 / 25)
    passes = 1 + stats["sweeps"]
    assert ak.lane_launches == lane_chunks * segs * passes
    assert ak.launches - ak.lane_launches == (
        (chunks - lane_chunks) * segs * passes + stats["suffix_len"] * segs)
    cpu = run_port(dict(m, universe=uni.numpy()), **kw)
    assert sweep_stats(cpu.diagnostics) == stats
    assert max_dw(out.weights.cpu(), cpu.weights) <= 1e-8
