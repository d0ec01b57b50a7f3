"""The port's scenario engine against the JAX package, on the CPU in float64,
with seeded numpy inputs (a 6 x 120 x 40 market, 4 paths).

The port draws the JAX package's scenario quantities (threefry under its
``path_key`` and lanes, at the float64 default the module sets, the
counterpart of the suite's x64). The JAX package's own draws (read off its
``path_key`` and lanes) go through each family's ``apply`` seam, which
reproduces the JAX package's ``day_index``, ``transform_returns``,
``schedule``, ``cell_masks`` and ``apply_cells`` on them, and the port's
own draws are the JAX package's; then, with the port drawing its own:

- each family's per-path metrics against the JAX package's scenario
  runner (one jitted runner a family, built once for the module), with and
  without a policy, at 1e-10, and the policy tallies exactly;
- the risk sketches' rows, state and merges exactly, given the same
  observations; the ``kind="scenario"`` report rows of the runs;
- the identity specs bitwise the plain tenant step; resume after the kill
  seam bit-equal to straight through, ledger included;
- ``import factormodeling_tpu_torch`` leaves the package unloaded (child
  interpreter).

The adversarial path differential runs its NaN, stale, drop and collapse
classes; the Inf spike and the outlier blast are held through the seam, the
corrupted views (bitwise) and the blend of a blasted view (1e-12 against
the JAX package's op-by-op blend). Whole paths with those classes part by
rounding, not by arithmetic: a date whose selected factors all hold an Inf
cell blends to a row of ties at 0 whose sign (so whether the names enter a
leg) is the rounding of the row's mean (-1.3e-17 in the JAX package, 0.0
here); and on rows holding ~1e9 blasts the JAX package's jitted blend
parts from its own op-by-op blend by O(1) (reassociated sums), where the
port follows the op-by-op one (ROADMAP queue 3).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from factormodeling_tpu import rng as jrng
from factormodeling_tpu import scenarios as jsc
from factormodeling_tpu.composite import composite_weighted as jax_blend
from factormodeling_tpu.obs import RunReport as JaxReport
from factormodeling_tpu.resil import DegradePolicy as JaxPolicy
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu_torch import obs, scenarios
from factormodeling_tpu_torch.composite import composite_weighted
from factormodeling_tpu_torch.obs.lineage import LineageLedger
from factormodeling_tpu_torch.resil import DegradePolicy
from factormodeling_tpu_torch.scenarios import engine, risk
from factormodeling_tpu_torch.serve import TenantConfig
from factormodeling_tpu_torch.serve.batched import make_tenant_research_step
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_x64 import torch_float64_module  # noqa: F401

NAMES = ("mom_eq", "val_flx", "qual_long", "size_short", "rev_flx", "mom_flx")
F, D, N, P = len(NAMES), 120, 40, 4
PANELS = ("factors", "returns", "factor_ret", "cap_flag", "investability",
          "universe")
TENANT = dict(top_k=2, icir_threshold=-1.0, method="equal", window=8,
              max_weight=0.5, pct=0.25)
POLICY = dict(min_universe=5, quarantine_nan_frac=0.3, clamp_absmax=5.0,
              carry_fallback=True)
SPECS = {
    "bootstrap": dict(seed=5, block_len=10),
    "regime": dict(seed=7, vol_scale=2.0, mean_shift=-0.005,
                   corr_tighten=0.4),
    # the NaN, stale, drop and collapse classes (module docs: the Inf and
    # outlier classes are held through the seam, the views and the blend)
    "adversarial": dict(seed=3, window_len=20, nan_rate=0.05,
                        stale_rate=0.3, drop_rate=0.2, collapse_rate=0.2),
}
METRIC_TOL = 1e-10


def _market():
    rng = np.random.default_rng(20261018)
    return dict(
        factors=rng.normal(size=(F, D, N)),
        returns=rng.normal(scale=0.02, size=(D, N)),
        factor_ret=rng.normal(scale=0.01, size=(D, F)),
        cap_flag=rng.integers(1, 4, size=(D, N)).astype(np.float64),
        investability=np.ones((D, N)),
        universe=rng.random((D, N)) > 0.1)


MARKET = _market()


def _torch_panels():
    return {k: torch.from_numpy(v) for k, v in MARKET.items()}


def _jax_panels():
    return {k: jnp.asarray(v) for k, v in MARKET.items()}


def _lane(key, lane):
    return random.fold_in(key, jrng.lane_id(lane))


def jax_draws(family, kw, p):
    """The JAX package's draws of ``family`` for path ``p``, in the form
    each port family's ``apply`` seam takes."""
    jspec = jsc.SCENARIO_FAMILIES[family].make(**kw)
    k = jsc.path_key(jspec, p)
    if family == "bootstrap":
        return np.asarray(random.randint(_lane(k, "scenario/bootstrap"),
                                         (D,), 0, D))
    if family == "regime":
        return (int(random.randint(_lane(k, "scenario/regime_break"), (),
                                   0, D)),
                float(random.uniform(_lane(k, "scenario/regime_intensity"),
                                     (), dtype=jnp.float64)))
    return (np.asarray(random.uniform(_lane(k, "scenario/adv_window"), ())),
            tuple(np.asarray(random.uniform(_lane(k, lane), (D,)))
                  for lane in ("scenario/adv_stale", "scenario/adv_drop",
                               "scenario/adv_collapse")),
            tuple(np.asarray(random.uniform(_lane(k, lane), (D, N)))
                  for lane in ("scenario/adv_nan", "scenario/adv_inf",
                               "scenario/adv_outlier")))


def _spec(family, kw=None):
    return scenarios.SCENARIO_FAMILIES[family].make(
        **(SPECS[family] if kw is None else kw))


@pytest.fixture(scope="module")
def jax_runs():
    """Per family and policy presence: the JAX package's per-path metrics
    and tallies (its jitted runner, called directly) and its report rows
    (``run_scenarios`` through the same runner); one runner a family."""
    jp = _jax_panels()
    tenant = JaxTenant(**TENANT).normalized(F, 4, dtype=np.float64)
    out = {}
    for family, kw in SPECS.items():
        runner = jsc.make_scenario_runner(names=NAMES,
                                          template=JaxTenant(**TENANT),
                                          family=family)
        jspec = jsc.SCENARIO_FAMILIES[family].make(**kw)
        for pol in (None, JaxPolicy.make(**POLICY)):
            res = runner(tenant, jspec, pol, jnp.arange(P, dtype=jnp.int32),
                         *(jp[k] for k in PANELS))
            mets, tallies = (res, {}) if pol is None else res
            rep = JaxReport("scen")
            jsc.run_scenarios(names=NAMES, template=JaxTenant(**TENANT),
                              spec=jspec, policy=pol, n_paths=P, chunk=P,
                              runner=runner, report=rep, **jp)
            out[family, pol is not None] = (
                {k: np.asarray(v) for k, v in mets.items()},
                {k: np.asarray(v) for k, v in tallies.items()},
                [r for r in rep.rows if r.get("kind") == "scenario"])
    return out


# ------------------------------------------------------------ risk sketches


@pytest.mark.parametrize("levels", [(0.95, 0.99), (0.5, 0.9, 0.975)])
def test_risk_rows_state_and_merges_are_jax_exactly(levels):
    rng = np.random.default_rng(len(levels))
    obs_ = {m: rng.normal(scale=s, size=97) for m, s in
            (("pnl_total", 0.3), ("max_drawdown", 0.2),
             ("mean_turnover", 1.0), ("worst_day_loss", 0.05), ("odd", 1))}
    obs_["max_drawdown"] = np.abs(obs_["max_drawdown"])
    obs_["pnl_total"][:5] = 0.0
    ours, theirs = risk.RiskAccumulator(levels), jsc.RiskAccumulator(levels)
    halves = [risk.RiskAccumulator(levels), risk.RiskAccumulator(levels)]
    for m, vals in obs_.items():
        for i, v in enumerate(vals):
            ours.observe(m, float(v))
            theirs.observe(m, float(v))
            halves[i % 2].observe(m, float(v))
    assert ours.rows("x", family="f") == theirs.rows("x", family="f")
    assert ours.state() == theirs.state()
    again = risk.RiskAccumulator.from_state(theirs.state())
    assert again.rows("x") == theirs.rows("x")
    merged = halves[1].merge(halves[0])
    for a, b in zip(merged.rows("x"), ours.rows("x")):
        for k in ("paths", "var", "es", "p50", "lo", "hi", "sketch_neg",
                  "sketch_pos"):
            if k in ("sketch_neg", "sketch_pos"):
                for f in ("count", "bucket_offset", "bucket_counts"):
                    assert a[k][f] == b[k][f]
            else:
                assert a[k] == b[k], k
    sk, jk = risk.SignedSketch(), jsc.SignedSketch()
    for v in obs_["pnl_total"]:
        sk.add(v)
        jk.add(v)
    for q in (0.0, 0.01, 0.5, 0.93, 1.0):
        assert sk.quantile(q) == jk.quantile(q)
    with pytest.raises(ValueError):
        sk.add(float("nan"))
    with pytest.raises(ValueError):
        risk.RiskAccumulator((1.0,))
    assert risk.RISK_METRICS == jsc.RISK_METRICS
    assert risk.DEFAULT_LEVELS == jsc.DEFAULT_LEVELS


# ---------------------------------------------------------------- the seams


def test_seams_reproduce_the_jax_transforms_on_its_draws():
    tp = _torch_panels()
    # bootstrap: the day indices
    spec = _spec("bootstrap")
    jspec = jsc.BootstrapSpec.make(**SPECS["bootstrap"])
    for p in range(P):
        want = np.asarray(jspec.day_index(jsc.path_key(jspec, p), D))
        got = spec.apply(jax_draws("bootstrap", SPECS["bootstrap"], p), D)
        np.testing.assert_array_equal(got, want)
        assert ((0 <= got) & (got < D)).all()
    # regime: the transformed returns
    spec = _spec("regime")
    jspec = jsc.RegimeSpec.make(**SPECS["regime"])
    for p in range(P):
        want = np.asarray(jspec.transform_returns(jsc.path_key(jspec, p),
                                                  jnp.asarray(
                                                      MARKET["returns"])))
        got = spec.apply(tp["returns"], *jax_draws(
            "regime", SPECS["regime"], p)).numpy()
        # a few ulps of returns ~0.02: the cross-sectional mean sums in
        # another order
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-16)
    # adversarial, every class: schedule, cell masks, the corrupted views
    kw = dict(SPECS["adversarial"], inf_rate=0.02, outlier_rate=0.05,
              window_len=30)
    spec = _spec("adversarial", kw)
    jspec = jsc.AdversarialSpec.make(**kw)
    for p in range(P):
        jkey = jsc.path_key(jspec, p)
        u_win, day_u, cell_u = jax_draws("adversarial", kw, p)
        want = [np.asarray(m) for m in jspec.schedule(jkey, D)]
        got = spec.apply_schedule(u_win, day_u, D)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert not (got[1] | got[2] | got[3])[~got[0]].any()
        jmasks = jspec.cell_masks(jkey, (D, N), jnp.asarray(want[0]))
        masks = spec.apply_cell_masks(cell_u, got[0])
        for g, w in zip(masks, jmasks):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert not g[~got[0]].any()
        tm = tuple(torch.from_numpy(m) for m in masks)
        for x in ("factors", "returns"):
            np.testing.assert_array_equal(
                spec.apply_cells(tp[x], tm).numpy(),
                np.asarray(jspec.apply_cells(jnp.asarray(MARKET[x]),
                                             jmasks)))
        # the port's own draws are the JAX package's
        key = scenarios.path_key(spec, p)
        for g, w in zip(spec.cell_masks(key, (D, N), got[0], device="cpu"),
                        masks):
            np.testing.assert_array_equal(g.numpy(), w)
        # the blend of the blasted view, against the JAX package's
        # op-by-op blend
        f_view = spec.apply_cells(tp["factors"], tm)
        sel = np.full((D, F), 1.0 / F)
        np.testing.assert_allclose(
            composite_weighted(f_view, NAMES, torch.from_numpy(sel),
                               universe=tp["universe"]).numpy(),
            np.asarray(jax_blend(jnp.asarray(f_view.numpy()), NAMES,
                                 jnp.asarray(sel),
                                 universe=jnp.asarray(MARKET["universe"]))),
            rtol=0, atol=1e-12)


def test_host_draws_are_seeded_lanes_and_off_is_identity():
    tp = _torch_panels()
    boot = scenarios.BootstrapSpec.make(seed=5, block_len=10)
    i0 = boot.day_index(scenarios.path_key(boot, 0), D)
    jboot = jsc.BootstrapSpec.make(seed=5, block_len=10)
    np.testing.assert_array_equal(
        i0, np.asarray(jboot.day_index(jsc.path_key(jboot, 0), D)))
    assert not np.array_equal(i0, boot.day_index(scenarios.path_key(boot, 1),
                                                 D))
    reg = scenarios.RegimeSpec.make(**SPECS["regime"])
    key0, key1 = (scenarios.path_key(reg, p) for p in (0, 1))
    assert reg.draws(key0, D, torch.float64) == reg.draws(key0, D,
                                                          torch.float64)
    assert reg.draws(key0, D, torch.float64) != reg.draws(key1, D,
                                                          torch.float64)
    assert reg.draws(key0, D, torch.float64) == jax_draws(
        "regime", SPECS["regime"], 0)
    for p in range(3):
        off = scenarios.AdversarialSpec.off()
        key = scenarios.path_key(off, p)
        assert torch.equal(scenarios.RegimeSpec.off().transform_returns(
            key, tp["returns"]), tp["returns"])
        in_win, *days = off.schedule(key, D)
        assert in_win.sum() == 20 and not any(d.any() for d in days)
        assert off.cell_masks(key, (D, N), in_win,
                              device="cpu") == (None, None, None)
    assert scenarios.family_of(reg) == "regime"
    with pytest.raises(TypeError):
        scenarios.family_of(object())
    for bad in (lambda: scenarios.BootstrapSpec.make(block_len=0),
                lambda: scenarios.RegimeSpec.make(vol_scale=0.0),
                lambda: scenarios.RegimeSpec.make(corr_tighten=1.0),
                lambda: scenarios.AdversarialSpec.make(window_len=0)):
        with pytest.raises(ValueError):
            bad()


# ------------------------------------------------------ paths against JAX


@pytest.mark.parametrize("with_policy", [False, True],
                         ids=["no_policy", "policy"])
@pytest.mark.parametrize("family", list(SPECS))
def test_path_metrics_match_jax(jax_runs, family, with_policy):
    spec = _spec(family)
    step = scenarios.make_scenario_step(names=NAMES,
                                        template=TenantConfig(**TENANT),
                                        family=family)
    tenant = TenantConfig(**TENANT).normalized(F, 4, dtype=np.float64)
    pol = DegradePolicy.make(**POLICY) if with_policy else None
    tp = _torch_panels()
    res = step(tenant, spec, pol, range(P), *(tp[k] for k in PANELS))
    mets, tallies = (res, {}) if pol is None else res
    want_m, want_t, _ = jax_runs[family, with_policy]
    assert sorted(mets) == sorted(want_m)
    for k, v in mets.items():
        assert np.isfinite(v.numpy()).all()
        np.testing.assert_allclose(v.numpy(), want_m[k], rtol=0,
                                   atol=METRIC_TOL, err_msg=k)
    assert sorted(tallies) == sorted(want_t)
    for k, v in tallies.items():
        np.testing.assert_array_equal(v.numpy(), want_t[k])
    if family == "adversarial" and with_policy:
        assert want_t["quarantined_days"].sum() > 0


@pytest.mark.parametrize("family", list(SPECS))
def test_report_rows_match_jax(jax_runs, family):
    spec = _spec(family)
    rep = obs.RunReport("scen")
    res = scenarios.run_scenarios(
        names=NAMES, template=TenantConfig(**TENANT), spec=spec,
        policy=DegradePolicy.make(**POLICY), n_paths=P, chunk=3,
        report=rep, device="cpu", **_torch_panels())
    assert res.finite_ok and res.completed and res.nonfinite_path_count == 0
    rows = [r for r in rep.rows if r.get("kind") == "scenario"]
    want = jax_runs[family, True][2]
    assert [r["name"] for r in rows] == [r["name"] for r in want]
    for got, exp in zip(rows, want):
        assert sorted(got) == sorted(exp)
        for k, v in exp.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, abs=1e-9), k
            elif k in ("sketch_neg", "sketch_pos"):
                for f in ("count", "bucket_offset", "bucket_counts"):
                    assert got[k][f] == v[f]
            elif k in ("var", "es"):
                np.testing.assert_allclose(got[k], v, atol=1e-9)
            else:
                assert got[k] == v, k


# -------------------------------------------------- identity and resume


def test_identity_specs_are_the_plain_tenant_step_bitwise():
    tp = _torch_panels()
    tpl = TenantConfig(**TENANT)
    tenant = tpl.normalized(F, 4, dtype=np.float64)
    base = make_tenant_research_step(names=NAMES, template=tpl)(
        tenant, *(tp[k] for k in PANELS))
    for spec in (scenarios.RegimeSpec.off(seed=3),
                 scenarios.AdversarialSpec.off(seed=4)):
        res = scenarios.run_scenarios(names=NAMES, template=tpl, spec=spec,
                                      n_paths=3, chunk=2, return_books=True,
                                      device="cpu", **tp)
        for p in range(3):
            book = res.book(p)
            for got, want in ((book.sim.weights, base.sim.weights),
                              (book.signal, base.signal),
                              (book.sim.result.log_return,
                               base.sim.result.log_return)):
                assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
            assert float(book.summary.total_log_return) == \
                float(base.summary.total_log_return)


def test_kill_and_resume_is_bit_equal_with_the_ledger(tmp_path,
                                                      monkeypatch):
    kw = dict(names=NAMES, template=TenantConfig(**TENANT),
              spec=scenarios.RegimeSpec.make(**SPECS["regime"]),
              n_paths=7, chunk=2, device="cpu", **_torch_panels())
    straight_ledger = LineageLedger()
    straight = scenarios.run_scenarios(lineage=straight_ledger, **kw)
    monkeypatch.setenv(engine._STOP_ENV, "2")
    ck = tmp_path / "scen.ckpt"
    partial = scenarios.run_scenarios(checkpoint_path=ck,
                                      lineage=LineageLedger(), **kw)
    assert not partial.completed and partial.rows == []
    monkeypatch.delenv(engine._STOP_ENV)
    ledger = LineageLedger()
    rep = obs.RunReport("scen")
    resumed = scenarios.run_scenarios(checkpoint_path=ck, lineage=ledger,
                                      report=rep, **kw)
    assert resumed.rows == straight.rows
    assert ledger.state() == straight_ledger.state()
    assert sum(r.get("kind") == "lineage" for r in rep.rows) == 4 + 2
    # a snapshot of another spec is skipped, never resumed into this run
    other = dict(kw, spec=scenarios.RegimeSpec.make(seed=8, vol_scale=2.0))
    fresh = scenarios.run_scenarios(checkpoint_path=ck, **other)
    assert fresh.rows[0]["paths"] == 7


def test_runner_guard_validation_and_map_chunk():
    tpl = TenantConfig(**TENANT)
    tp = _torch_panels()
    spec = scenarios.BootstrapSpec.make(seed=1, block_len=7)
    runner = scenarios.make_scenario_runner(names=NAMES, template=tpl,
                                            family="regime")
    assert runner.scenario_build == {"family": "regime",
                                     "return_books": False,
                                     "map_chunk": None}
    assert runner.name == "scenarios/step/regime"
    assert isinstance(runner.entry_point_tag, str)
    kw = dict(names=NAMES, template=tpl, spec=spec, device="cpu", **tp)
    with pytest.raises(ValueError, match="runner was built"):
        scenarios.run_scenarios(runner=runner, **kw)
    for bad in (dict(n_paths=0), dict(chunk=0),
                dict(return_books=True, checkpoint_path="x")):
        with pytest.raises(ValueError):
            scenarios.run_scenarios(**kw, **bad)
    with pytest.raises(ValueError, match="map_chunk"):
        scenarios.make_scenario_step(names=NAMES, template=tpl,
                                     family="bootstrap", map_chunk=0)
    short = {k: (v[:, :8] if k == "factors" else v[:8]) for k, v in tp.items()}
    with pytest.raises(ValueError, match="processed range is empty"):
        scenarios.run_scenarios(**dict(kw, **short))
    a = scenarios.run_scenarios(n_paths=5, chunk=5, **kw)
    b = scenarios.run_scenarios(n_paths=5, chunk=2, map_chunk=2, **kw)
    assert a.rows == b.rows
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            scenarios.run_scenarios(names=NAMES, template=tpl, spec=spec,
                                    **MARKET)
        else:
            raise RuntimeError("device='cpu'")


def test_import_leaves_scenarios_unloaded():
    code = textwrap.dedent("""
        import sys
        import factormodeling_tpu_torch as fmt
        from factormodeling_tpu_torch import parallel, serve, resil, obs
        loaded = [m for m in sys.modules if ".scenarios" in m]
        assert not loaded, loaded
        import factormodeling_tpu_torch.scenarios as sc
        assert sc.run_scenarios and "factormodeling_tpu_torch.scenarios" \\
            in sys.modules
        assert not [m for m in sys.modules if m.split(".")[0] == "jax"]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
