"""The port's numerics probes against the JAX package's, on the CPU.

- ``frame_of`` on the same tensors (NaN, +-inf, zeros, denormals, float64
  values beyond the float32 range, empty, bool and int tensors): the
  counts, the log2 histogram, ``finite_frac`` and ``seq`` exact; absmax,
  mean and std within float32 rounding (``MOMENT_RTOL``: the two packages
  sum the float32 cells in different orders).
- The capture: identity when off, a repeated stage suffixed ``#k``, None
  passing through unrecorded, the host views (``summarize_probes``,
  ``probe_profile``, ``watchdog``) equal to the JAX package's on the same
  summaries.
- The probed research step at 6 x 300 x 40 (``mvo_turnover``, fused, 120
  iterations so the tally fires): the seven frames against
  ``build_research_step(collect_probes=True, probe_canary=True)`` of the
  JAX package run op by op, ``iters_to_converge`` exact; at 60 dates the
  probed outputs bitwise the unprobed step's. The JAX step is not jitted
  here: under ``jax.jit`` XLA contracts the ``_eq`` suffix's quantile
  interpolation differently, and on day 179 of this market one cell sits
  on the 90% quantile, so the jitted blend parts from the op-by-op one (and from the
  port) on that row; XLA also folds the finite fraction's division by the
  cell count into a reciprocal product (one float32 ulp).
- The watchdog's verdict on a faulted run (the JAX package's draws fed to
  the port) equal to the jitted JAX step's: the same first stage and
  dropped stages, the finite fractions within that ulp.
- ``ADMMResult.residual_traj`` and ``iters_to_converge``: None unless the
  solve collects; under ``probing()`` (read where the solve starts) the
  per-segment (primal, dual, rho) trajectory against the JAX solver's at
  its 1e-6 differential tolerance and the tally exact, for the low-rank
  solve (both kernels) and the dense one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu import resil as jresil
from factormodeling_tpu import rng as jrng
from factormodeling_tpu.obs import probes as jprobes
from factormodeling_tpu.parallel import build_research_step as jax_build
from factormodeling_tpu.solvers import admm_solve_dense as jax_dense
from factormodeling_tpu.solvers import admm_solve_lowrank as jax_lowrank
from factormodeling_tpu_torch.obs import probes
from factormodeling_tpu_torch.resil import faults
from factormodeling_tpu_torch.solvers import (admm_solve_dense,
                                              admm_solve_lowrank)
from tests.test_torch_admm import _jax_prob, _problem, _torch_prob

T = torch.from_numpy
#: float32 sums of the same cells in two orders: relative rounding of the
#: moments (|x| <= ~1e4 here, up to 5,000 cells)
MOMENT_RTOL, MOMENT_ATOL = 2e-6, 1e-6
EXACT = ("seq", "finite_frac", "nan_count", "inf_count", "log2_hist",
         "expect_finite")


def _cases():
    rng = np.random.default_rng(5)
    tiny = np.finfo(np.float32).tiny
    mixed = rng.normal(scale=30.0, size=(40, 50))
    mixed[rng.uniform(size=mixed.shape) < 0.1] = np.nan
    mixed[0, :3] = [np.inf, -np.inf, 0.0]
    return {
        "mixed_f64": mixed,
        "mixed_f32": mixed.astype(np.float32),
        "zeros": np.zeros((7, 3)),
        "denormals_f32": (np.arange(1, 9, dtype=np.float32) * tiny / 16),
        "beyond_f32": np.array([1e39, -3e300, 2.0, np.nan, 1e-300]),
        "all_nan": np.full(11, np.nan),
        "spread": np.exp2(np.arange(-24.0, 24.0, 0.5)) * np.where(
            np.arange(96) % 2, 1.0, -1.0),
        "empty": np.zeros((0, 4)),
        "bool": rng.uniform(size=(9, 9)) > 0.3,
        "int": rng.integers(-1000, 1000, size=(5, 6)).astype(np.int32),
    }


def _summaries(port_frame, jax_frame):
    return probes.summarize_frame(port_frame), jprobes.summarize_frame(
        jax_frame)


@pytest.mark.parametrize("case", list(_cases()))
@pytest.mark.parametrize("expect", [1.0, None, 0.5])
def test_frame_of_matches_jax(case, expect):
    x = _cases()[case]
    got, want = _summaries(
        probes.frame_of(torch.from_numpy(x), seq=3, expect_finite=expect),
        jprobes.frame_of(jnp.asarray(x), seq=3, expect_finite=expect))
    for key in EXACT:
        assert got[key] == want[key], key
    for key in ("absmax", "mean", "std"):
        np.testing.assert_allclose(got[key], want[key], rtol=MOMENT_RTOL,
                                   atol=MOMENT_ATOL, equal_nan=True,
                                   err_msg=key)


def test_beyond_float32_is_inf_in_the_top_bin():
    frame = probes.summarize_frame(probes.frame_of(
        torch.tensor([1e39, 1.0], dtype=torch.float64)))
    assert frame["absmax"] == np.inf and frame["inf_count"] == 0
    assert frame["log2_hist"][-1] == 1 and frame["finite_frac"] == 1.0


def test_capture_gating_suffixes_and_host_views():
    x = torch.tensor([1.0, float("nan"), 4.0])
    assert probes.probe("a", x) is x and not probes.collection_active()
    with probes.capture() as cap:
        assert probes.collection_active()
        probes.probe("a", x)
        probes.probe("a", x * 2, expect_finite=None)
        probes.probe("b", None)
        probes.probe("a", x[:1])
    assert list(cap.frames()) == ["a", "a#2", "a#3"]
    assert not probes.collection_active()
    with probes.probing():
        assert probes.collection_active() and probes.probes_enabled()
    assert not probes.probes_enabled()
    with jprobes.capture() as jcap:
        jprobes.probe("a", jnp.asarray(x.numpy()))
        jprobes.probe("a", jnp.asarray(x.numpy()) * 2, expect_finite=None)
        jprobes.probe("a", jnp.asarray(x.numpy()[:1]))
    got = probes.summarize_probes(cap.frames())
    want = jprobes.summarize_probes(jcap.frames())
    assert got == want
    assert probes.probe_profile(cap.frames(), absmax_stages=("a",),
                                nonzero_stages=("a#2",)) == \
        jprobes.probe_profile(jcap.frames(), absmax_stages=("a",),
                              nonzero_stages=("a#2",))
    for base in (None, {"a": 1.0}, {"a#3": {"finite_frac": 1.0,
                                            "absmax": 1e-3}}):
        assert probes.watchdog(cap.frames(), baseline=base) == \
            jprobes.watchdog(jcap.frames(), baseline=base)


# ------------------------------------------------------- the probed step

NAMES = ("mom_flx", "mom_eq", "val_long", "val_short", "qual_flx", "size")
F, D, N = len(NAMES), 300, 40
WINDOW = 20
SIM = dict(method="mvo_turnover", lookback_period=20, max_weight=0.2,
           solver_kernel="fused", qp_iters=120)
STAGES = ["ops/factors_raw", "ops/factors_delta", "selection/rolling",
          "composite/blend", "solver/admm", "backtest/weights",
          "backtest/pnl"]


def _market(d=D, seed=0):
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(F, d, N))
    factors[rng.uniform(size=factors.shape) < 0.02] = np.nan
    returns = rng.normal(scale=0.02, size=(d, N))
    factor_ret = rng.normal(scale=0.01, size=(d, F))
    cap = rng.integers(1, 4, size=(d, N)).astype(float)
    invest = np.ones((d, N))
    universe = rng.uniform(size=(d, N)) > 0.05
    return factors, returns, factor_ret, cap, invest, universe


@pytest.fixture(scope="module")
def stepped():
    arrays = _market()
    port = fmt.build_research_step(names=NAMES, window=WINDOW,
                                   sim_kwargs=SIM, collect_probes=True,
                                   probe_canary=True, device="cpu")
    jstep = jax_build(names=NAMES, window=WINDOW, sim_kwargs=SIM,
                      collect_probes=True, probe_canary=True)
    return port(*map(T, arrays)), jstep(*map(jnp.asarray, arrays))


def test_probed_step_frames_match_jax(stepped):
    got, want = stepped
    gs = probes.summarize_probes(got.probes)
    ws = jprobes.summarize_probes(want.probes)
    assert list(gs) == list(ws) == STAGES
    for stage in STAGES:
        a, b = gs[stage], ws[stage]
        for key in ("seq", "finite_frac", "nan_count", "inf_count",
                    "expect_finite"):
            assert a[key] == b[key], (stage, key)
        if stage == "solver/admm":
            # the day's final residual is the polished point's box/equality
            # residual: 0 in one package and 1e-16 in the other on a few
            # days, which moves a cell between "zero" and the lowest bin
            assert abs(sum(a["log2_hist"]) - sum(b["log2_hist"])) <= 3
            assert a["log2_hist"][1:] == b["log2_hist"][1:]
        else:
            assert a["log2_hist"] == b["log2_hist"], stage
        # the moments of the step's values: the outputs agree at the step
        # tolerances (1e-6 in weight), far inside float32 summary rounding
        for key in ("absmax", "mean", "std"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                       atol=1e-7, err_msg=(stage, key))


def test_probed_step_tallies_iterations_and_moves_no_output(stepped):
    got, want = stepped
    itc = got.sim.diagnostics.iters_to_converge.numpy()
    np.testing.assert_array_equal(
        itc, np.asarray(want.sim.diagnostics.iters_to_converge))
    assert (itc > 0).any() and itc.max() <= SIM["qp_iters"]
    arrays = tuple(map(T, _market(d=60, seed=1)))
    small = fmt.build_research_step(names=NAMES, window=WINDOW,
                                    sim_kwargs=SIM, collect_probes=True,
                                    device="cpu")(*arrays)
    plain = fmt.build_research_step(names=NAMES, window=WINDOW,
                                    sim_kwargs=SIM, device="cpu")(*arrays)
    assert plain.probes is None and not plain.sim.diagnostics.\
        iters_to_converge.any()
    assert small.sim.diagnostics.iters_to_converge.any()
    assert list(small.probes) == [s for s in STAGES
                                  if s != "ops/factors_delta"]
    for a, b in ((small.selection, plain.selection),
                 (small.signal, plain.signal),
                 (small.sim.weights, plain.sim.weights),
                 (small.sim.result.log_return, plain.sim.result.log_return)):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    rep = fmt.obs.RunReport("p")
    row = rep.add_probes("step", got.probes)
    assert row["kind"] == "watchdog" and row["first_bad_stage"] is None
    assert [r["stage"] for r in rep.rows if r["kind"] == "numerics"] == STAGES
    assert rep.add_probes("step", None) is None


def _jax_draws(jspec):
    def draws(spec, stage_idx, shape, date_axis, thresholds):
        d = shape[date_axis]
        out = {}
        for kind in ("nan_burst", "inf_spike", "outlier"):
            out[kind] = np.asarray(jax.random.uniform(
                jrng.lane_key(f"fault/{kind}", jspec.seed, stage_idx),
                tuple(shape)))
        for kind in ("stale_repeat", "drop_day"):
            out[kind] = np.asarray(jax.random.uniform(
                jrng.lane_key(f"fault/{kind}", jspec.seed, stage_idx), (d,)))
        return {k: v for k, v in out.items() if thresholds[k] > 0}
    return draws


_FAULT_SIM = dict(SIM, qp_iters=40)


@functools.lru_cache(maxsize=None)
def _jax_faulted_step():
    return jax.jit(jax_build(names=NAMES, window=WINDOW,
                             sim_kwargs=_FAULT_SIM, collect_probes=True,
                             probe_canary=True))


@functools.lru_cache(maxsize=None)
def _clean_profiles():
    arrays = _market(d=90, seed=2)
    port = fmt.build_research_step(names=NAMES, window=WINDOW,
                                   sim_kwargs=_FAULT_SIM, collect_probes=True,
                                   probe_canary=True, device="cpu")
    clean = port(*map(T, arrays))
    jclean = _jax_faulted_step()(*map(jnp.asarray, arrays),
                                 fault_spec=jresil.FaultSpec.off())
    kw = dict(absmax_stages=("composite/blend",),
              nonzero_stages=("ops/factors_delta",))
    return (arrays, port, clean, probes.probe_profile(clean.probes, **kw),
            jprobes.probe_profile(jclean.probes, **kw))


@pytest.mark.parametrize("fault", [dict(nan_rate=0.05),
                                   dict(stale_rate=0.25)])
def test_watchdog_on_a_faulted_run_is_jax_s(monkeypatch, fault):
    arrays, port, clean, base, jbase = _clean_profiles()
    spec_kw = dict(seed=3, **fault)
    jspec = jresil.FaultSpec.make(**spec_kw)
    monkeypatch.setattr(faults, "_draws", _jax_draws(jspec))
    got = port(*map(T, arrays), fault_spec=fmt.resil.FaultSpec.make(
        **spec_kw))
    want = _jax_faulted_step()(*map(jnp.asarray, arrays), fault_spec=jspec)
    verdict = probes.watchdog(got.probes, baseline=base)
    jverdict = jprobes.watchdog(want.probes, baseline=jbase)
    for key in ("mode", "first_bad_stage", "dropped"):
        assert verdict[key] == jverdict[key], key
    assert list(verdict["finite_frac"]) == list(jverdict["finite_frac"])
    for stage, frac in verdict["finite_frac"].items():
        np.testing.assert_allclose(frac, jverdict["finite_frac"][stage],
                                   rtol=np.finfo(np.float32).eps, atol=0)
    # stale dates repeat the day before's cells, NaNs included, so both
    # classes first show in the raw panel's finite fraction
    assert verdict["first_bad_stage"] == "ops/factors_raw"
    assert probes.watchdog(clean.probes, baseline=base)[
        "first_bad_stage"] is None


# ----------------------------------------------- the solver's trajectory

@pytest.mark.parametrize("kernel", ["reference", "fused", "dense"])
def test_residual_trajectory_and_tally_match_jax(kernel):
    p = _problem(4, l1=0.05)
    prob, t = _torch_prob(p)
    if kernel == "dense":
        cov = (np.diag(np.full(len(p["q"]), p["alpha"]))
               + p["V"].T @ np.diag(p["s"]) @ p["V"])

        def port():
            return admm_solve_dense(torch.from_numpy(cov), prob, iters=140)

        def jax_():
            return jax_dense(jnp.asarray(cov), _jax_prob(p), iters=140)
    else:
        def port():
            return admm_solve_lowrank(torch.tensor(p["alpha"]), t["V"],
                                      t["s"], prob, iters=140, kernel=kernel)

        def jax_():
            return jax_lowrank(jnp.asarray(p["alpha"]), jnp.asarray(p["V"]),
                               jnp.asarray(p["s"]), _jax_prob(p), iters=140,
                               kernel=kernel)
    off = port()
    assert off.residual_traj is None and off.iters_to_converge is None
    with probes.probing():
        got = port()
    with jprobes.probing():
        want = jax_()
    assert got.residual_traj.shape == (6, 3)
    np.testing.assert_allclose(got.residual_traj.numpy(),
                               np.asarray(want.residual_traj), atol=1e-6,
                               rtol=1e-6)
    assert int(got.iters_to_converge) == int(want.iters_to_converge) > 0
    assert off.x.numpy().tobytes() == got.x.numpy().tobytes()
