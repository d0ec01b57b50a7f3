"""The port's resilience layer against the JAX package, on the CPU in float64
(float32 where the JAX tests use it), with seeded numpy inputs.

- Fault injection: the port draws the JAX package's uniforms (threefry
  under ``rng.lane_key``); fed the JAX package's own uniforms through the
  private seam (``faults._inject_with`` / ``_collapse_with``), the port's
  application is bitwise the JAX ``inject`` for every class and stage, and
  its own draws are the JAX package's.
- The policy's guards bitwise: quarantine, clamp, and the hold pass (a
  gather where the JAX package scans) on drawn hold masks with day 0 held.
- ``run_simulation`` with a policy for all four schemes; the default policy
  is bitwise no policy.
- The faulted, policied research step at the JAX package's seed (the port
  drawing its own masks, at the float64 default), and its
  ``StageCounters``.
- Snapshots written by either package load in the other; ``fingerprint``;
  corruption, version skew and the meta guard; the retry schedule; the
  checkpointed sweep interrupted and resumed.
- ``composite_weighted(group_tilt=...)`` and ``TenantConfig``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu import resil as jresil
from factormodeling_tpu import rng as jrng
from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.backtest import run_simulation as jax_run
from factormodeling_tpu.composite import composite_weighted as jax_blend
from factormodeling_tpu.parallel import build_research_step as jax_build
from factormodeling_tpu.parallel import combo_weight_matrix as jax_cw
from factormodeling_tpu.parallel import manager_sweep as jax_sweep
from factormodeling_tpu.resil import policy as jpolicy
from factormodeling_tpu.serve.tenant import TenantConfig as JaxTenant
from factormodeling_tpu_torch import resil
from factormodeling_tpu_torch.parallel import sweep as sweep_mod
from factormodeling_tpu_torch.resil import checkpoint as ckpt
from factormodeling_tpu_torch.resil.checkpoint import tree_leaves
from factormodeling_tpu_torch.resil import faults
from factormodeling_tpu_torch.resil import policy
from factormodeling_tpu_torch.serve import TenantConfig
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_x64 import torch_float64  # noqa: F401

T = torch.from_numpy
NAMES = ("mom_flx", "val_flx", "qual_long", "size_short", "mom_eq")
F, D, N = len(NAMES), 40, 16
WINDOW = 8


def _bytes(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x
                      ).tobytes()


def _jax_uniforms(jspec, stage_idx, shape, date_axis):
    """The JAX package's draws of every class at one stage."""
    d = shape[date_axis]
    out = {}
    for kind in ("nan_burst", "inf_spike", "outlier"):
        out[kind] = np.asarray(jax.random.uniform(
            jrng.lane_key(f"fault/{kind}", jspec.seed, stage_idx), shape))
    for kind in ("stale_repeat", "drop_day"):
        out[kind] = np.asarray(jax.random.uniform(
            jrng.lane_key(f"fault/{kind}", jspec.seed, stage_idx), (d,)))
    return out


SPEC_KW = [
    dict(nan_rate=0.1),
    dict(inf_rate=0.15),
    dict(outlier_rate=0.1, outlier_mag=6.0),
    dict(stale_rate=0.3),
    dict(drop_rate=0.25),
    dict(nan_rate=0.05, inf_rate=0.05, outlier_rate=0.05, stale_rate=0.2,
         drop_rate=0.2),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("stage_idx,shape,axis",
                         [(0, (F, D, N), 1), (1, (D, F), 0), (2, (D, N), 0)])
@pytest.mark.parametrize("kw", SPEC_KW)
def test_fault_application_is_bitwise_jax_on_its_draws(kw, stage_idx, shape,
                                                       axis, dtype):
    rng = np.random.default_rng(stage_idx)
    x = rng.normal(size=shape).astype(dtype)
    x[rng.uniform(size=shape) < 0.05] = np.nan
    stage = faults.INJECT_STAGES[stage_idx]
    spec = resil.FaultSpec.make(seed=11, stage=stage, **kw)
    jspec = jresil.FaultSpec.make(seed=11, stage=stage, **kw)
    draws = _jax_uniforms(jspec, stage_idx, shape, axis)
    got = faults._inject_with(stage_idx, T(x.copy()), spec, draws,
                              date_axis=axis)
    want = jresil.inject(stage, jnp.asarray(x), jspec, date_axis=axis)
    assert got.dtype == T(x).dtype
    assert _bytes(got) == _bytes(want)
    # a stage the spec gates off is left alone
    other = (stage_idx + 1) % 3
    if shape == (D, N) or other != 0:
        off = faults._inject_with(other, T(x.copy()), spec, draws,
                                  date_axis=axis)
        assert _bytes(off) == _bytes(x)


def test_universe_collapse_is_bitwise_jax_on_its_draws():
    rng = np.random.default_rng(3)
    uni = rng.uniform(size=(D, N)) > 0.2
    spec = resil.FaultSpec.single("universe_collapse", rate=0.3, keep=3,
                                  seed=4)
    jspec = jresil.FaultSpec.single("universe_collapse", rate=0.3, keep=3,
                                    seed=4)
    u = np.asarray(jax.random.uniform(
        jrng.lane_key("fault/universe_collapse", jspec.seed, 0), (D,)))
    got = faults._collapse_with(T(uni), spec, u)
    want = jresil.inject_universe(jnp.asarray(uni), jspec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy().sum(1) <= np.maximum(uni.sum(1), 0)).all()


def test_host_draws_are_seeded_lanes_and_off_is_identity(torch_float64):
    rng = np.random.default_rng(5)
    x = T(rng.normal(size=(D, N)))
    assert faults.inject("composite/blend", x, None) is x
    assert faults.inject("composite/blend", x, resil.FaultSpec.off()) is x
    assert faults.inject_universe(x > 0, resil.FaultSpec.off()) is not None
    a = resil.FaultSpec.make(seed=2, nan_rate=0.2, drop_rate=0.2)
    b = resil.FaultSpec.make(seed=2, nan_rate=0.4, drop_rate=0.2)
    ya = faults.inject("composite/blend", x, a)
    assert _bytes(ya) == _bytes(faults.inject("composite/blend", x, a))
    yb = faults.inject("composite/blend", x, b)
    # the drop lane does not move with the NaN rate: the same days drop
    da = torch.isnan(ya).all(1)
    db = torch.isnan(yb).all(1)
    assert torch.equal(da, db) and bool(da.any())
    # a lane's draw is the JAX package's: threefry under its lane key
    u = fmt.threefry.uniform(fmt.rng.lane_key("fault/drop_day", 2, 2), (D,),
                             device="cpu")
    ju = jax.random.uniform(jrng.lane_key("fault/drop_day", 2, 2), (D,))
    assert _bytes(u) == _bytes(ju)
    np.testing.assert_array_equal(da.numpy(), u.numpy() < np.float32(0.2))
    jspec = jresil.FaultSpec.make(seed=2, nan_rate=0.2, drop_rate=0.2)
    assert _bytes(ya) == _bytes(jresil.inject("composite/blend",
                                              jnp.asarray(x.numpy()), jspec))


def test_spec_constructors_staleness_canary_and_dispatch_plan():
    with pytest.raises(ValueError, match="unknown fault class"):
        resil.FaultSpec.single("bogus")
    s = resil.FaultSpec.single("outlier", stage="selection/rolling",
                               rate=0.1, magnitude=4.0)
    j = jresil.FaultSpec.single("outlier", stage="selection/rolling",
                                rate=0.1, magnitude=4.0)
    for field in dataclasses.fields(s):
        np.testing.assert_array_equal(np.asarray(getattr(s, field.name)),
                                      np.asarray(getattr(j, field.name)),
                                      err_msg=field.name)
    rng = np.random.default_rng(6)
    fac = rng.normal(size=(F, D, N))
    fac[:, 5] = fac[:, 4]
    got = faults.staleness_canary(T(fac))
    want = jresil.staleness_canary(jnp.asarray(fac))
    assert _bytes(got) == _bytes(want)
    assert float(got[:, 5].abs().max()) == 0.0
    plan = resil.DispatchFaultPlan(seed=3, error_rate=0.2, poison_rate=0.3)
    jplan = jresil.DispatchFaultPlan(seed=3, error_rate=0.2, poison_rate=0.3)
    assert [plan.roll(i) for i in range(40)] == \
        [jplan.roll(i) for i in range(40)]
    with pytest.raises(ValueError):
        resil.DispatchFaultPlan(error_rate=0.7, poison_rate=0.4)
    err = resil.DispatchFault("dispatch_error", 3)
    assert err.kind == "dispatch_error" and err.attempt == 3


# ------------------------------------------------------- policy guards


def test_quarantine_and_clamp_match_jax():
    rng = np.random.default_rng(7)
    fac = rng.normal(size=(F, 12, N)).astype(np.float32)
    fac[:, 5] = np.nan
    fac[:2, 8, :] = np.nan
    uni = rng.uniform(size=(12, N)) > 0.1
    fr = rng.normal(size=(12, F)).astype(np.float32)
    for frac in (0.3, 0.5, 2.0):
        pol = resil.DegradePolicy.make(quarantine_nan_frac=frac)
        jpol = jresil.DegradePolicy.make(quarantine_nan_frac=frac)
        for u in (None, uni):
            got = policy.quarantine_days(T(fac), None if u is None else T(u),
                                         pol)
            want = jpolicy.quarantine_days(
                jnp.asarray(fac), None if u is None else jnp.asarray(u), jpol)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        fs, rs = policy.quarantine_inputs(T(fac), T(fr), got)
        jfs, jrs = jpolicy.quarantine_inputs(jnp.asarray(fac),
                                             jnp.asarray(fr), want)
        assert _bytes(fs) == _bytes(jfs) and _bytes(rs) == _bytes(jrs)
    sig = rng.normal(size=(10, N)).astype(np.float32) * 3
    sig[3, 4], sig[3, 5], sig[7, 0] = 50.0, -np.inf, np.nan
    for c in (2.5, float("inf")):
        got = policy.clamp_signal(T(sig), resil.DegradePolicy.make(
            clamp_absmax=c))
        want = jpolicy.clamp_signal(jnp.asarray(sig),
                                    jresil.DegradePolicy.make(clamp_absmax=c))
        assert _bytes(got[0]) == _bytes(want[0])
        assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])


@pytest.mark.parametrize("seed", range(4))
def test_hold_weights_gather_is_bitwise_the_jax_scan(seed):
    """Drawn hold masks (day 0 held on every seed), NaN weight cells, both
    guards: the one gather against the JAX package's carry."""
    rng = np.random.default_rng(seed)
    d = 30
    w = rng.normal(size=(d, N))
    w[rng.uniform(size=w.shape) < 0.05] = np.nan
    lc = rng.integers(0, 5, size=d).astype(np.int32)
    sc = rng.integers(0, 5, size=d).astype(np.int32)
    ok = rng.uniform(size=d) > 0.3
    ok[0] = False
    uni = rng.integers(0, 12, size=d).astype(np.int32)
    for mu, carry in ((0, True), (6, False), (6, True), (0, False)):
        pol = resil.DegradePolicy.make(min_universe=mu, carry_fallback=carry)
        jpol = jresil.DegradePolicy.make(min_universe=mu,
                                         carry_fallback=carry)
        got = policy.hold_weights(T(w), T(lc), T(sc), T(ok), T(uni), pol)
        want = jpolicy.hold_weights(jnp.asarray(w), jnp.asarray(lc),
                                    jnp.asarray(sc), jnp.asarray(ok),
                                    jnp.asarray(uni), jpol)
        for a, b in zip(got[:3], want[:3]):
            assert _bytes(a) == _bytes(b)
        assert int(got[3].held_days) == int(want[3].held_days)
        assert int(got[3].carry_days) == int(want[3].carry_days)
        if carry:
            assert float(got[0][0].abs().sum()) == 0.0   # day 0: flat
    stats = policy.merge_stats(torch.tensor([True, False, True]), 4, 2,
                               got[3])
    jstats = jpolicy.merge_stats(jnp.asarray([True, False, True]), 4, 2,
                                 want[3])
    assert [int(v) for v in stats] == [int(v) for v in jstats]


def _market(seed, d=30, n=24):
    rng = np.random.default_rng(seed)
    returns = rng.normal(scale=0.02, size=(d, n))
    signal = rng.normal(size=(d, n))
    signal[4] = np.abs(signal[4])
    cap = rng.integers(0, 4, size=(d, n)).astype(float)
    invest = np.ones((d, n))
    universe = rng.uniform(size=(d, n)) > 0.08
    universe[7, 5:] = False                    # a collapsed day
    signal[~universe] = np.nan
    return returns, signal, cap, invest, universe


@pytest.mark.parametrize("kw", [
    dict(method="equal", pct=0.2),
    dict(method="linear", max_weight=0.15),
    dict(method="mvo", lookback_period=8, max_weight=0.3, qp_iters=60),
    dict(method="mvo_turnover", lookback_period=8, max_weight=0.3,
         qp_iters=60),
])
def test_run_simulation_with_a_policy_matches_jax(kw):
    returns, signal, cap, invest, universe = _market(1)
    pol = dict(min_universe=10, carry_fallback=True)
    t = fmt.SimulationSettings(
        returns=T(returns), cap_flag=T(cap), investability_flag=T(invest),
        universe=T(universe), degrade=resil.DegradePolicy.make(**pol), **kw)
    j = JaxSettings(returns=jnp.asarray(returns), cap_flag=jnp.asarray(cap),
                    investability_flag=jnp.asarray(invest),
                    universe=jnp.asarray(universe),
                    degrade=jresil.DegradePolicy.make(**pol), **kw)
    got = fmt.run_simulation(T(signal), t)
    want = jax.jit(jax_run)(jnp.asarray(signal), j)
    tol = 1e-12 if kw["method"] in ("equal", "linear") else 1e-6
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=tol, rtol=0, equal_nan=True)
    np.testing.assert_array_equal(got.long_count.numpy(),
                                  np.asarray(want.long_count))
    assert int(got.degrade.held_days) == int(want.degrade.held_days) >= 1
    assert int(got.degrade.carry_days) == int(want.degrade.carry_days)
    np.testing.assert_allclose(got.result.log_return.numpy(),
                               np.asarray(want.result.log_return),
                               atol=tol, rtol=0)
    # the default policy is bitwise no policy
    base = fmt.run_simulation(T(signal), dataclasses.replace(t, degrade=None))
    inert = fmt.run_simulation(T(signal), dataclasses.replace(
        t, degrade=resil.DegradePolicy.make()))
    for a, b in zip(jax.tree_util.tree_leaves(tuple(base[:5])),
                    jax.tree_util.tree_leaves(tuple(inert[:5]))):
        assert _bytes(a) == _bytes(b)
    assert base.degrade is None and int(inert.degrade.held_days) == 0


# ------------------------------------------------------ the research step


def _step_inputs(seed=0):
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(F, D, N))
    factors[rng.uniform(size=factors.shape) < 0.03] = np.nan
    factors[:, 20] = np.nan                 # a quarantined date
    returns = rng.normal(scale=0.02, size=(D, N))
    factor_ret = rng.normal(scale=0.01, size=(D, F))
    cap = rng.integers(1, 4, size=(D, N)).astype(float)
    invest = np.ones((D, N))
    universe = rng.uniform(size=(D, N)) > 0.05
    return factors, returns, factor_ret, cap, invest, universe


_STEP_SIM = dict(method="mvo_turnover", lookback_period=8, max_weight=0.3,
                 qp_iters=60)
_CHAOS = dict(seed=3, nan_rate=0.02, inf_rate=0.01, drop_rate=0.05,
              collapse_rate=0.1, collapse_keep=3)
_POLICY = dict(min_universe=6, quarantine_nan_frac=0.5, clamp_absmax=4.0,
               carry_fallback=True)


def test_faulted_policied_step_matches_jax(torch_float64):
    arrays = _step_inputs()
    jspec = jresil.FaultSpec.make(**_CHAOS)
    step = fmt.build_research_step(
        names=NAMES, window=WINDOW, sim_kwargs=_STEP_SIM,
        collect_counters=True, device="cpu")
    got = step(*map(T, arrays), fault_spec=resil.FaultSpec.make(**_CHAOS),
               policy=resil.DegradePolicy.make(**_POLICY))
    jstep = jax.jit(jax_build(names=NAMES, window=WINDOW,
                              sim_kwargs=_STEP_SIM, collect_counters=True))
    want = jstep(*map(jnp.asarray, arrays), fault_spec=jspec,
                 policy=jresil.DegradePolicy.make(**_POLICY))
    # the fault application and everything before the solve: bitwise
    # where the JAX step's stages are exact (the selection's stats are the
    # existing step tolerances)
    np.testing.assert_allclose(got.selection.numpy(),
                               np.asarray(want.selection), atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(got.signal.numpy(), np.asarray(want.signal),
                               atol=1e-10, rtol=0, equal_nan=True)
    np.testing.assert_allclose(got.sim.weights.numpy(),
                               np.asarray(want.sim.weights), atol=1e-6,
                               rtol=0, equal_nan=True)
    gc = fmt.obs.summarize_counters(got.counters)
    from factormodeling_tpu import obs as jobs
    wc = jobs.summarize_counters(want.counters)
    assert set(gc) == set(wc)
    for key in ("quarantined_days", "held_days", "carry_fallback_days",
                "clamped_cells", "degrade_events", "active_days",
                "qp_solves"):
        assert gc[key] == wc[key], key
    assert gc["quarantined_days"] >= 1 and gc["held_days"] >= 1
    assert gc["clamped_cells"] >= 1
    for key in ("universe_size", "selection_active"):
        assert gc[key] == wc[key], key


def test_off_spec_and_default_policy_are_the_clean_step():
    arrays = tuple(map(T, _step_inputs(1)))
    step = fmt.build_research_step(names=NAMES, window=WINDOW,
                                   sim_kwargs=_STEP_SIM, device="cpu")
    clean = step(*arrays)
    inert = step(*arrays, fault_spec=resil.FaultSpec.off(),
                 policy=resil.DegradePolicy.make())
    assert clean.counters is None and clean.sim.degrade is None
    for a, b in zip(jax.tree_util.tree_leaves(
            (clean.selection, clean.signal, tuple(clean.sim[:4]),
             tuple(clean.summary))),
            jax.tree_util.tree_leaves(
                (inert.selection, inert.signal, tuple(inert.sim[:4]),
                 tuple(inert.summary)))):
        assert _bytes(a) == _bytes(b)
    # probes on (ported): the outputs stay bitwise the clean step's
    probed = fmt.build_research_step(names=NAMES, window=WINDOW,
                                     sim_kwargs=_STEP_SIM,
                                     collect_probes=True, device="cpu")(
        *arrays, fault_spec=resil.FaultSpec.off(),
        policy=resil.DegradePolicy.make())
    assert len(probed.probes) == 7
    for a, b in zip(tree_leaves((clean.selection, clean.signal,
                                 tuple(clean.sim[:4]))),
                    tree_leaves((probed.selection, probed.signal,
                                 tuple(probed.sim[:4])))):
        assert _bytes(a) == _bytes(b)
    with fmt.obs.collecting():
        built = fmt.build_research_step(names=NAMES, window=WINDOW,
                                        sim_kwargs=dict(method="equal"),
                                        device="cpu")
    counted = built(*arrays)
    assert isinstance(counted.counters, fmt.obs.StageCounters)
    rep = fmt.obs.RunReport("c")
    rep.add_counters("step", counted.counters)
    row = rep.rows[-1]
    assert row["kind"] == "counters"
    assert row["counters"]["degrade_events"] == 0
    assert set(row["counters"]) == set(fmt.obs.StageCounters._fields)


# ------------------------------------------------------------ snapshots


def _tree(rng):
    return {"arrays": [rng.normal(size=(3, 4)),
                       rng.integers(0, 9, size=(5,), dtype=np.int32),
                       rng.uniform(size=(2, 2)) > 0.5],
            "nested": {"t": (1.5, None, "tag"), "flag": True, "n": 7},
            "empty": []}


def test_snapshots_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(8)
    state = _tree(rng)
    tstate = {**state, "arrays": [T(a) for a in state["arrays"]]}
    # the port writes tensors, the JAX package reads them
    p = resil.save_snapshot(tmp_path / "port.ckpt", tstate, meta={"k": 1})
    loaded, meta = jresil.load_snapshot(p)
    assert meta == {"k": 1}
    for a, b in zip(loaded["arrays"], state["arrays"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert loaded["nested"]["t"] == (1.5, None, "tag")
    # the JAX package writes, the port reads
    q = jresil.save_snapshot(tmp_path / "jax.ckpt",
                             {**state, "arrays": [jnp.asarray(a) for a in
                                                  state["arrays"]]},
                             meta={"k": 1})
    back, meta = resil.load_snapshot(q)
    assert meta == {"k": 1}
    for a, b in zip(back["arrays"], state["arrays"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # the same state gives the same file, byte for byte
    assert p.read_bytes() == q.read_bytes()
    # tensors come back where the template's leaves lie, or where asked
    like = {**state, "arrays": [T(a) for a in state["arrays"]]}
    typed, _ = resil.load_snapshot(q, like=like)
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in typed["arrays"])
    assert _bytes(typed["arrays"][0]) == _bytes(state["arrays"][0])
    placed, _ = resil.load_snapshot(q, device="cpu")
    assert all(isinstance(a, torch.Tensor) for a in placed["arrays"])
    assert isinstance(back["arrays"][0], np.ndarray)


def test_snapshot_like_rehangs_typed_trees(tmp_path):
    warm = fmt.solvers.ADMMWarmState(z=torch.zeros(2, 3),
                                     u=torch.ones(2, 3),
                                     rho=torch.full((2,), 2.0))
    p = resil.save_snapshot(tmp_path / "w.ckpt",
                            [a.numpy() for a in warm])
    back, _ = resil.load_snapshot(p, like=warm)
    assert isinstance(back, fmt.solvers.ADMMWarmState)
    assert torch.equal(back.u, warm.u)
    with pytest.raises(resil.SnapshotCorrupt, match="template"):
        resil.load_snapshot(p, like=(warm, torch.zeros(1)))


def test_fingerprint_equals_jax_and_sees_content():
    rng = np.random.default_rng(9)
    arrays = [rng.normal(size=(6, 4)).astype(np.float32),
              rng.integers(0, 5, size=7), None,
              rng.uniform(size=(3, 3)) > 0.5, np.float64(2.5)]
    want = jresil.fingerprint(*arrays)
    assert resil.fingerprint(*arrays) == want
    assert resil.fingerprint(*[None if a is None else T(np.array(a))
                               for a in arrays]) == want
    b = arrays[0].copy()
    b[3, 2] += 1.0
    assert resil.fingerprint(b) != resil.fingerprint(arrays[0])
    assert resil.fingerprint(arrays[0], None) != \
        resil.fingerprint(arrays[0], arrays[0])
    assert (resil.fingerprint(np.zeros(4, np.float32))
            != resil.fingerprint(np.zeros(4, np.int32)))


def test_corruption_version_skew_and_meta_guard(tmp_path, monkeypatch,
                                                capsys):
    rng = np.random.default_rng(10)
    p = resil.save_snapshot(tmp_path / "s.ckpt", _tree(rng))
    raw = bytearray(p.read_bytes())
    flipped = bytearray(raw)
    flipped[-3] ^= 0x40
    p.write_bytes(bytes(flipped))
    with pytest.raises(resil.SnapshotCorrupt, match="checksum"):
        resil.load_snapshot(p)
    p.write_bytes(bytes(raw[:len(raw) // 2]))
    with pytest.raises(resil.SnapshotCorrupt):
        resil.load_snapshot(p)
    p.write_bytes(b"not a snapshot at all")
    with pytest.raises(resil.SnapshotCorrupt, match="magic"):
        resil.load_snapshot(p)
    monkeypatch.setattr(ckpt, "SNAPSHOT_VERSION", ckpt.SNAPSHOT_VERSION + 1)
    p = ckpt.save_snapshot(tmp_path / "v.ckpt", _tree(rng))
    monkeypatch.undo()
    with pytest.raises(resil.SnapshotCorrupt, match="version"):
        resil.load_snapshot(p)
    with pytest.raises(jresil.SnapshotCorrupt, match="version"):
        jresil.load_snapshot(p)

    ck = resil.Checkpointer(tmp_path / "c.ckpt", every=2)
    assert ck.resume() is None
    assert ck.maybe_save(0, {"i": 0}) is None
    assert ck.maybe_save(1, {"i": 1}, meta={"cfg": [1, 2]}) is not None
    state, meta = ck.resume(expect_meta={"cfg": [1, 2]})
    assert state == {"i": 1}
    assert ck.resume(expect_meta={"cfg": [9, 9]}) is None
    assert "different configuration" in capsys.readouterr().err
    path = tmp_path / "c.ckpt"
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(resil.SnapshotCorrupt):
        ck.resume()
    assert ck.resume(on_corrupt="discard") is None
    with pytest.raises(ValueError):
        ck.resume(on_corrupt="ignore")
    with pytest.raises(ValueError):
        resil.Checkpointer(tmp_path / "x", every=0)


def test_retry_schedule_and_deadlines_match_jax():
    for kw in (dict(retries=4), dict(retries=3, base=0.1, factor=3.0),
               dict(retries=5, base=0.2, max_delay_s=0.5)):
        assert resil.backoff_schedule(**kw) == jresil.backoff_schedule(**kw)
    with pytest.raises(ValueError):
        resil.backoff_schedule(-1)
    clock = {"t": 0.0}
    slept, retried = [], []

    def sleep(dt):
        slept.append(dt)
        clock["t"] += dt

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 4:
            raise OSError("transient")
        return "ok"

    assert resil.retry_call(flaky, retries=4, backoff=0.1, factor=2.0,
                            clock=lambda: clock["t"], sleep=sleep,
                            on_retry=lambda i, e, d: retried.append(i)) == "ok"
    assert slept == [0.1, 0.2, 0.4] and retried == [0, 1, 2]
    # the next backoff would cross the deadline: the failure propagates
    clock["t"], slept[:] = 0.0, []

    def dead():
        raise OSError("permanent")

    with pytest.raises(OSError, match="permanent"):
        resil.retry_call(dead, retries=5, backoff=0.1, deadline_s=0.25,
                         clock=lambda: clock["t"], sleep=sleep)
    assert slept == [0.1]
    with pytest.raises(resil.DeadlineExceeded):
        resil.retry_call(dead, deadline_s=-1.0, clock=lambda: 0.0)
    attempts = []

    def missing():
        attempts.append(1)
        raise FileNotFoundError("never checkpointed")

    with pytest.raises(FileNotFoundError):
        resil.io_retry(missing, backoff=0.0, no_retry=(FileNotFoundError,))
    assert len(attempts) == 1


# ------------------------------------------------------ checkpointed sweep


def _sweep_inputs(seed=11, n_combos=10):
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(F, 24, 12))
    returns = rng.normal(scale=0.02, size=(24, 12))
    cap = rng.integers(1, 4, size=(24, 12)).astype(float)
    combos = rng.integers(0, F, size=(n_combos, 2))
    settings = fmt.SimulationSettings(
        returns=T(returns), cap_flag=T(cap),
        investability_flag=torch.ones((24, 12), dtype=torch.float64),
        method="equal", pct=0.3)
    return T(factors), fmt.parallel.combo_weight_matrix(
        combos, F, device="cpu"), settings, (factors, returns, cap, combos)


def test_checkpointed_sweep_interrupted_and_resumed_is_bitwise(
        tmp_path, monkeypatch, capsys):
    factors, cw, settings, raw = _sweep_inputs()
    straight = fmt.parallel.manager_sweep(factors, cw, settings,
                                          combo_batch=2, device="cpu")
    real = sweep_mod._combine_and_pnl
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:                       # die inside chunk 2
            raise RuntimeError("simulated kill")
        return real(*a, **kw)

    monkeypatch.setattr(sweep_mod, "_combine_and_pnl", dying)
    ck = tmp_path / "sweep.ckpt"
    with pytest.raises(RuntimeError, match="simulated kill"):
        fmt.parallel.checkpointed_manager_sweep(
            factors, cw, settings, combo_batch=2, chunk_combos=3,
            checkpoint=resil.Checkpointer(ck), device="cpu")
    monkeypatch.setattr(sweep_mod, "_combine_and_pnl", real)
    state, _ = resil.load_snapshot(ck)
    assert state["next_chunk"] == 1 and len(state["parts"]) == 1
    resumed = fmt.parallel.checkpointed_manager_sweep(
        factors, cw, settings, combo_batch=2, chunk_combos=3,
        checkpoint=resil.Checkpointer(ck), device="cpu")
    for a, b in zip(resumed, straight):
        assert _bytes(a) == _bytes(b)
    # without a checkpoint, the chunked loop is the sweep too
    plain = fmt.parallel.checkpointed_manager_sweep(
        factors, cw, settings, combo_batch=2, chunk_combos=3, device="cpu")
    for a, b in zip(plain, straight):
        assert _bytes(a) == _bytes(b)
    # and the JAX package's sweep agrees
    f_np, returns, cap, combos = raw
    jset = JaxSettings(returns=jnp.asarray(returns), cap_flag=jnp.asarray(cap),
                       investability_flag=jnp.ones((24, 12)), method="equal",
                       pct=0.3)
    want = jax_sweep(jnp.asarray(f_np), jax_cw(combos, F), jset,
                     combo_batch=2)
    np.testing.assert_allclose(resumed.log_return.numpy(),
                               np.asarray(want.log_return), atol=1e-12,
                               rtol=0)
    # another configuration never resumes this snapshot's chunks
    for other in (dataclasses.replace(settings, pct=0.25),
                  dataclasses.replace(settings, method="linear")):
        fmt.parallel.checkpointed_manager_sweep(
            factors, cw, other, combo_batch=2, chunk_combos=3,
            checkpoint=resil.Checkpointer(ck), device="cpu")
        assert "different configuration" in capsys.readouterr().err
    # the provenance ledger (ported): one sweep_chunk edge a chunk, the
    # outputs unchanged
    from factormodeling_tpu_torch.obs.lineage import LineageLedger

    led = LineageLedger()
    lined = fmt.parallel.checkpointed_manager_sweep(
        factors, cw, settings, combo_batch=2, chunk_combos=3, lineage=led,
        device="cpu")
    np.testing.assert_array_equal(lined.log_return.numpy(),
                                  resumed.log_return.numpy())
    assert [e["edge_kind"] for e in led.edges].count("sweep_chunk") == 3


# ------------------------------------------------- blend tilt and tenants


@pytest.mark.parametrize("tilt", [[1.0, 1.0, 1.0, 1.0], [2.0, 0.5, 1.0, 0.0],
                                  [0.0, 0.0, 1.0, 0.0]])
@pytest.mark.parametrize("method", ["zscore", "rank"])
def test_composite_weighted_group_tilt_matches_jax(tilt, method):
    rng = np.random.default_rng(12)
    fac = rng.normal(size=(F, 12, N))
    fac[rng.uniform(size=fac.shape) < 0.05] = np.nan
    sel = rng.uniform(size=(12, F)) * (rng.uniform(size=(12, F)) > 0.4)
    sel[3] = 0.0
    uni = rng.uniform(size=(12, N)) > 0.1
    got = fmt.composite.composite_weighted(
        T(fac), NAMES, T(sel), method=method, universe=T(uni),
        group_tilt=T(np.asarray(tilt)))
    want = jax_blend(jnp.asarray(fac), NAMES, jnp.asarray(sel), method=method,
                     universe=jnp.asarray(uni),
                     group_tilt=jnp.asarray(tilt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=0, equal_nan=True)
    if tilt == [1.0] * 4:
        plain = fmt.composite.composite_weighted(
            T(fac), NAMES, T(sel), method=method, universe=T(uni))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-15,
                                   rtol=0, equal_nan=True)


def test_tenant_config_static_key_and_validation_match_jax():
    cases = [dict(), dict(method="mvo", window=6, sim_static={"qp_iters": 30}),
             dict(manager_mix=np.ones(F)), dict(blend_tilt=np.ones(4),
                                                select_method="momentum")]
    for kw in cases:
        got, want = TenantConfig(**kw), JaxTenant(**kw)
        assert got.static_key() == want.static_key()
        got.validate(F, 4, 40)
        want.validate(F, 4, 40)
    bad = [dict(top_k=0), dict(top_k=2.5), dict(method="x"),
           dict(sim_static={"max_weight": 0.1}),
           dict(sim_static={"qp_itrs": 3}), dict(window=0)]
    for kw in bad:
        with pytest.raises(ValueError):
            TenantConfig(**kw)
        with pytest.raises(ValueError):
            JaxTenant(**kw)
    invalid = [(dict(top_k=9), (F, 4, 40)), (dict(pct=1.5), (F, 4, 40)),
               (dict(max_weight=0.0), (F, 4, 40)),
               (dict(manager_mix=np.zeros(F)), (F, 4, 40)),
               (dict(blend_tilt=np.ones(3)), (F, 4, 40)),
               (dict(window=40), (F, 4, 40)),
               (dict(icir_threshold=float("nan")), (F, 4, 40))]
    for kw, args in invalid:
        with pytest.raises(ValueError):
            TenantConfig(**kw).validate(*args)
        with pytest.raises(ValueError):
            JaxTenant(**kw).validate(*args)
    norm = TenantConfig(top_k=3, manager_mix=[1.0] * F).normalized(F, 4)
    assert norm.top_k.dtype == np.int32 and norm.manager_mix.shape == (F,)
    stacked = fmt.serve.stack_configs([norm, norm])
    assert stacked.top_k.shape == (2,) and stacked.manager_mix.shape == (2, F)
    with pytest.raises(ValueError, match="buckets"):
        fmt.serve.stack_configs([norm, TenantConfig(method="mvo").normalized(
            F, 4)])
    with pytest.raises(ValueError):
        TenantConfig(max_weight=T(np.asarray(0.0))).validate(F, 4)
