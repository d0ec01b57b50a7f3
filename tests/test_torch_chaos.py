"""The port's chaos matrix (``factormodeling_tpu_torch.chaos``) held cell for
cell against the JAX package's (``tools/chaos.py``, run in process as
``tests/test_chaos.py`` runs it) at the same seeds, on the CPU.

- the research matrix: ``test_chaos.py``'s ``SMOKE`` over every fault class
  x every policy, and the ``mvo_turnover`` scheme at ``tools/chaos.py``'s
  default shape over every fault class under ``full``: the cell set, each
  cell's ``ok``, ``first_bad_stage``, the five degrade counters and
  ``solver_fallback_days`` equal;
- the serving preset at ``test_serving_preset_smoke``'s arguments: every
  verdict count and the virtual makespan equal, the sentry's fired alert
  classes equal as sets;
- the online preset, every anomaly x both guards: each cell's terminal
  counts and reasons equal, its four checks true in both packages;
- the scenario preset at ``test_scenario_preset_smoke``'s arguments: the
  paths' degrade counters equal, each risk row at ``TOL_SMOOTH``;
- the fields the packages cannot share (``NOT_SHARED``: the online cells'
  state digests and content chains, the reports' wall times) are held
  instead between a straight run of the port's CLI and a run killed and
  resumed: four differentials in child interpreters (``--device cpu``),
  the research matrix's with a bit-flipped snapshot rejected (exit 2).

The port runs at JAX's x64 width (``torch_float64_module``) so its fault
masks are the JAX package's draws; the CLI children run at the float32
default, as the JAX package's CLI runs with x64 off.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO / "tools") not in sys.path:
    sys.path.insert(0, str(REPO / "tools"))

import chaos as jax_chaos  # noqa: E402  (tools/chaos.py)
from tools.device_goldens import TOL_SMOOTH  # noqa: E402

from factormodeling_tpu import obs as jax_obs  # noqa: E402
from factormodeling_tpu import resil as jax_resil  # noqa: E402
from factormodeling_tpu_torch import chaos  # noqa: E402
from factormodeling_tpu_torch import obs, resil  # noqa: E402
from tests.torch_isolation import reset_process_telemetry  # noqa: E402,F401
from tests.torch_threads import torch_one_thread  # noqa: E402,F401
from tests.torch_x64 import torch_float64_module  # noqa: E402,F401

QUIET = dict(progress=lambda _m: None)
SMOKE = dict(shape=(4, 28, 12), window=6, method="equal", rate=0.08,
             day_rate=0.25, seed=11)
TURNOVER = dict(shape=(6, 48, 16), window=8, method="mvo_turnover",
                policies=["full"], seed=0)
SERVING = dict(shape=(4, 30, 12), window=5, method="linear",
               faults=["none", "dispatch_error"],
               policies=["open", "bounded", "degrade"], n_requests=18, seed=1)
ONLINE = dict(shape=(5, 16, 10), window=4, method="equal", seed=0)
SCENARIOS = dict(shape=(4, 36, 12), window=6, method="equal",
                 families=["bootstrap", "regime", "adversarial"],
                 policies=["default", "guard", "full"], n_paths=4, seed=3)

#: the research cells' fields held equal across the packages
RESEARCH_FIELDS = ("fault", "policy", "ok", "first_bad_stage",
                   "quarantined_days", "held_days", "carry_fallback_days",
                   "clamped_cells", "degrade_events", "solver_fallback_days")
#: the serving cells' counts held equal
SERVING_COUNTS = ("submitted", "served", "shed_count", "deadline_miss_count",
                  "failed_count", "retry_count", "rung_downgrades",
                  "stale_served", "cheap_fallbacks", "dispatches",
                  "incidents")
CHECKS = ("trace_complete", "metering_conserved", "lineage_intact",
          "sentry_clean")

#: the fields left out of the cross-package comparison, each with its reason
NOT_SHARED = {
    "state_digest": "a hash of the online state's bytes: float rounding of "
                    "the computed state differs between the packages",
    "chain": "the online content chain hashes each applied state's id, a "
             "hash of computed bytes",
    "wall": "span rows' seconds: wall times of two programs",
}

_ENV = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
_ENV.pop("_FMT_CHAOS_DIE_AFTER_CELL", None)
_ENV.pop("_FMT_SERVE_DIE_AFTER_DISPATCH", None)
_ENV.pop("_FMT_ONLINE_DIE_AFTER_DATE", None)


def _both(runner_name, report=False, **kw):
    """The JAX package's and the port's verdicts (and reports) of one
    preset at the same arguments."""
    jrep = jax_obs.RunReport("jax") if report else None
    prep = obs.RunReport("port") if report else None
    j = getattr(jax_chaos, runner_name)(report=jrep, **QUIET, **kw)
    p = getattr(chaos, runner_name)(report=prep, device="cpu", **QUIET, **kw)
    return j, p, jrep, prep


# ------------------------------------------------------ research matrix


@pytest.fixture(scope="module")
def research_smoke():
    j, p, _, _ = _both("run_chaos", **SMOKE)
    return j, p


@pytest.fixture(scope="module")
def research_turnover():
    j, p, _, _ = _both("run_chaos", **TURNOVER)
    return j, p


def _hold_research(j, p, cell):
    got = {k: p["results"][cell][k] for k in RESEARCH_FIELDS}
    want = {k: j["results"][cell][k] for k in RESEARCH_FIELDS}
    assert got == want


def test_research_matrix_cell_set_equals_jax(research_smoke,
                                             research_turnover):
    for j, p in (research_smoke, research_turnover):
        assert sorted(p["results"]) == sorted(j["results"])
        assert (p["cells"], p["ok"], p["failed"]) == (j["cells"], j["ok"],
                                                      j["failed"])
    j, p = research_smoke
    assert p["cells"] == len(resil.FAULT_CLASSES) * 4 and p["ok"]


@pytest.mark.parametrize("fault", jax_resil.FAULT_CLASSES)
@pytest.mark.parametrize("policy", ("default", "guard", "clamp", "full"))
def test_research_smoke_cell_equals_jax(research_smoke, fault, policy):
    j, p = research_smoke
    _hold_research(j, p, f"chaos/{fault}/{policy}")


@pytest.mark.parametrize("fault", [f for f in jax_resil.FAULT_CLASSES
                                   if f != "outlier"])
def test_research_turnover_cell_equals_jax(research_turnover, fault):
    """The ``mvo_turnover`` cells (the segment kernel's plain version on the
    path) under ``full``; the outlier cell parts, and
    :func:`test_research_turnover_outlier_cell_parts_on_float32_rounding`
    holds why."""
    j, p = research_turnover
    _hold_research(j, p, f"chaos/{fault}/full")


#: the ``outlier/full`` cell of ``TURNOVER`` (its index in the grid is its
#: seed offset) and the day its signals part on
OUTLIER_CELL, OUTLIER_DAY = dict(fault="outlier", idx=2), 31


def test_research_turnover_outlier_cell_parts_on_float32_rounding(
        research_turnover):
    """The ``outlier/full`` turnover cell parts by one solver-fallback day,
    and the difference is float32 rounding, the reference's own:

    - the cell's signals part on one day only, where the outlier class
      puts cells of ~1e8 into the pooled percentiles of the blend's ``_flx``
      suffix, so every ordinary cell maps to within a few float32 units of
      -1 and the day's z-scores are made of those units;
    - on that day's faulted factors, the JAX package's float32 blend parts
      from its own float64 blend by more than 0.1 (so does the port's),
      while the two packages' float64 blends agree within 1e-12;
    - the JAX package's own backtest fed the port's signal gives the
      port's fallback counts, and fed its own signal its own: the solves
      agree, the signal's rounding decides."""
    import jax
    import jax.numpy as jnp

    from factormodeling_tpu.backtest import SimulationSettings
    from factormodeling_tpu.backtest import run_simulation as jax_sim
    from factormodeling_tpu.composite.blend import \
        composite_weighted as jax_blend
    from factormodeling_tpu.obs import probes as jax_probes
    from factormodeling_tpu.parallel import \
        build_research_step as jax_build
    from factormodeling_tpu.resil.faults import inject as jax_inject
    from factormodeling_tpu_torch.composite.blend import \
        composite_weighted as port_blend
    from factormodeling_tpu_torch.obs import probes as port_probes
    from factormodeling_tpu_torch.parallel import build_research_step

    j, p = research_turnover
    cell = "chaos/outlier/full"
    assert (p["results"][cell]["solver_fallback_days"],
            j["results"][cell]["solver_fallback_days"]) == (3, 2)
    f, d, n = TURNOVER["shape"]
    names, args = jax_chaos.make_inputs(f, d, n, seed=0)
    sim = dict(method="mvo_turnover", lookback_period=8, max_weight=0.4)
    build = dict(names=names, window=8, sim_kwargs=sim,
                 collect_counters=True, collect_probes=True)
    stages = dict(absmax_stages=("ops/factors_raw", "selection/rolling",
                                 "composite/blend"),
                  nonzero_stages=("ops/factors_delta",))
    j_step = jax.jit(jax_build(**build))
    p_step = build_research_step(device="cpu", **build)
    p_args = tuple(torch.as_tensor(np.asarray(a)) for a in args)
    outs = {}
    for key, step, res, probes, a in (
            ("jax", j_step, jax_resil, jax_probes, args),
            ("port", p_step, resil, port_probes, p_args)):
        clean = step(*a, fault_spec=res.FaultSpec.off(),
                     policy=res.DegradePolicy.make())
        absmax = probes.probe_profile(clean.probes, **stages)[
            "composite/blend"]["absmax"]
        pol = chaos.build_policies(res, float(absmax))["full"]
        spec = res.FaultSpec.single("outlier", rate=0.05,
                                    seed=OUTLIER_CELL["idx"])
        outs[key] = (step(*a, fault_spec=spec, policy=pol), spec, pol)
    (jo, j_spec, j_pol), (po, _, _) = outs["jax"], outs["port"]
    js, ps = np.asarray(jo.signal), po.signal.numpy()
    parted = np.nonzero(np.abs(np.nan_to_num(js) - np.nan_to_num(ps))
                        .max(1) > 1e-5)[0]
    assert parted.tolist() == [OUTLIER_DAY]
    np.testing.assert_array_equal(np.asarray(jo.selection),
                                  po.selection.numpy())

    faulted = np.asarray(jax_inject("ops/factors_raw", args[0], j_spec,
                                    date_axis=1))
    sel = np.asarray(jo.selection)
    blends = {}
    for width in (np.float32, np.float64):
        fx, sx = faulted.astype(width), sel.astype(width)
        blends["jax", width] = np.asarray(jax_blend(
            jnp.asarray(fx), names, jnp.asarray(sx), universe=args[5]))
        blends["port", width] = port_blend(
            torch.as_tensor(fx), names, torch.as_tensor(sx),
            universe=p_args[5]).numpy()
    row = OUTLIER_DAY
    np.testing.assert_allclose(blends["jax", np.float64][row],
                               blends["port", np.float64][row], atol=1e-12)
    for pkg in ("jax", "port"):
        gap = np.abs(blends[pkg, np.float32][row]
                     - blends[pkg, np.float64][row]).max()
        assert gap > 0.1, (pkg, gap)

    settings = SimulationSettings(
        returns=args[1], cap_flag=args[3], investability_flag=args[4],
        universe=args[5], degrade=j_pol, **sim)
    for signal, want in ((js, jo), (ps, po)):
        out = jax_sim(jnp.asarray(signal), settings)
        diag = out.diagnostics
        fallback = int((np.asarray(diag.active)
                        & ~np.asarray(diag.solver_ok)).sum())
        assert fallback == int(want.counters.solver_fallback_days)


#: the share of factor cells made NaN in
#: ``test_a_nan_bearing_panel_moves_the_attribution_in_both_packages``
#: (chip_smoke.py's path-1 panel has 3%)
PANEL_NAN = 0.03
#: the online cells' panel there: wide enough that the NaN share moves
NAN_ONLINE_SHAPE = (8, 16, 40)


def _nan_factors(factors, seed):
    """``factors`` with ``PANEL_NAN`` of its cells NaN, drawn from a
    generator of their own, and factor 0 NaN for name 0 (the name a
    collapsed universe keeps) on every date."""
    out = np.array(factors)
    out[np.random.default_rng(seed + 1).uniform(size=out.shape)
        < PANEL_NAN] = np.nan
    out[0, :, 0] = np.nan
    return out


def test_a_nan_bearing_panel_moves_the_attribution_in_both_packages(
        monkeypatch):
    """The matrix's attribution tables (``EXPECT_STAGE``,
    ``ONLINE_SENTRY``) hold on its own panel, which has no NaN cell. On a
    panel with NaN cells (``chip_smoke.py``'s path-1 panel) a stale date
    copies the day before's NaN cells too, so the watchdog names
    ``ops/factors_raw`` before the staleness canary, and a collapsed
    universe moves the NaN-share gauge the sentry's drift detector reads:
    the same cells part from the tables in both packages, stage for stage
    and alert for alert (why path 15 runs on the matrix's panel)."""
    import jax.numpy as jnp

    plain = jax_chaos.make_inputs

    def jax_nan_panel(f, d, n, seed=0):
        names, arrays = plain(f, d, n, seed=seed)
        return names, (jnp.asarray(_nan_factors(arrays[0], seed)),
                       *arrays[1:])

    def port_market(shape, seed):
        names, arrays = chaos.make_inputs(*shape, seed=seed)
        return names, (_nan_factors(arrays[0], seed), *arrays[1:])

    monkeypatch.setattr(jax_chaos, "make_inputs", jax_nan_panel)
    grid = dict(SMOKE, faults=["stale_repeat"])
    j = jax_chaos.run_chaos(**QUIET, **grid)
    p = chaos.run_chaos(device="cpu", market=port_market(SMOKE["shape"],
                                                         SMOKE["seed"]),
                        **QUIET, **grid)
    for cell in j["results"]:
        _hold_research(j, p, cell)
    assert "ops/factors_raw" in {r["first_bad_stage"]
                                 for r in j["results"].values()}

    grid = dict(ONLINE, shape=NAN_ONLINE_SHAPE, faults=["universe_collapse"])
    j = jax_chaos.run_online_chaos(**QUIET, **grid)
    p = chaos.run_online_chaos(device="cpu", market=port_market(
        NAN_ONLINE_SHAPE, ONLINE["seed"]), **QUIET, **grid)
    for cell, want in j["results"].items():
        got = p["results"][cell]
        for k in ("ok", "alerts_fired", "statuses", "rejected_reasons"):
            assert got[k] == want[k], (cell, k)
    assert any("nan_frac" in r["alerts_fired"]
               for r in j["results"].values())


# ------------------------------------------------------- serving preset


@pytest.fixture(scope="module")
def serving():
    return _both("run_serving_chaos", report=True, **SERVING)


def _makespan(rep, cell):
    rows = [r for r in rep.rows if r.get("kind") == "serving"
            and r.get("name") == f"chaos/{cell}"]
    assert len(rows) == 1, cell
    return rows[0]["virtual_makespan_s"]


@pytest.mark.parametrize("fault", SERVING["faults"])
@pytest.mark.parametrize("policy", SERVING["policies"])
def test_serving_cell_equals_jax(serving, fault, policy):
    j, p, jrep, prep = serving
    cell = f"serving/{fault}/{policy}"
    got, want = p["results"][cell], j["results"][cell]
    assert got["ok"] and want["ok"], (got["violations"], want["violations"])
    assert {k: got[k] for k in SERVING_COUNTS} == \
        {k: want[k] for k in SERVING_COUNTS}
    assert set(got["alerts_fired"]) == set(want["alerts_fired"])
    assert all(got[k] for k in CHECKS) and all(want[k] for k in CHECKS)
    assert _makespan(prep, cell) == _makespan(jrep, cell)


# -------------------------------------------------------- online preset


@pytest.fixture(scope="module")
def online():
    j, p, _, _ = _both("run_online_chaos", **ONLINE)
    return j, p


@pytest.mark.parametrize("anomaly", jax_chaos.ONLINE_ANOMALIES)
@pytest.mark.parametrize("policy", jax_chaos.ONLINE_POLICIES)
def test_online_cell_equals_jax(online, anomaly, policy):
    j, p = online
    cell = f"online/{anomaly}/{policy}"
    got, want = p["results"][cell], j["results"][cell]
    assert got["ok"] and want["ok"], (got["violations"], want["violations"])
    for k in ("statuses", "counters", "rejected_reasons", "alerts_fired",
              "incidents"):
        assert got[k] == want[k], k
    assert all(got[k] for k in CHECKS) and all(want[k] for k in CHECKS)
    # the fields the packages cannot share are there, in the JAX form
    assert len(got["state_digest"]) == len(want["state_digest"]) == 16
    assert len(got["chain"]) == len(want["chain"]) == 16
    assert set(got) == set(want)


# ------------------------------------------------------ scenario preset


@pytest.fixture(scope="module")
def scenarios():
    return _both("run_scenario_chaos", report=True, **SCENARIOS)


#: cells whose risk rows the JAX package's jitted scenario engine parts
#: from its own op-by-op engine on (the recorded reference behaviour: its
#: jitted blend parts from the op-by-op blend on rows the outlier and Inf
#: classes blast), held against the op-by-op run
JIT_PARTS = ("scenario/adversarial/full",)


@pytest.fixture(scope="module")
def scenarios_op_by_op():
    """The JAX package's ``JIT_PARTS`` cells' ``run_scenarios`` run op by
    op, each as its preset builds it (the spec from the cell's name, the
    policy the jitted grid's: its clamp threshold is the jitted baseline's,
    one float32 ulp from the op-by-op baseline's, on a cell whose clamped
    cells sit far beyond every other)."""
    import zlib

    import jax

    from factormodeling_tpu import scenarios as jax_scenarios
    from factormodeling_tpu.serve import TenantConfig as JaxTenant

    f, d, n = SCENARIOS["shape"]
    names, arrays = jax_chaos.make_inputs(f, d, n, seed=SCENARIOS["seed"])
    panels = dict(zip(("factors", "returns", "factor_ret", "cap_flag",
                       "investability", "universe"), arrays))
    template = JaxTenant(top_k=max(f // 2, 1), icir_threshold=-1.0,
                         method=SCENARIOS["method"],
                         window=SCENARIOS["window"], max_weight=0.5,
                         pct=0.25, lookback_period=min(8, d))
    clean = jax_scenarios.run_scenarios(
        names=names, template=template,
        spec=jax_scenarios.RegimeSpec.off(seed=SCENARIOS["seed"]),
        n_paths=1, chunk=1, return_books=True, **panels)
    policies = jax_chaos.build_policies(jax_resil, float(np.nanmax(np.abs(
        np.asarray(clean.books.signal)))))
    rep = jax_obs.RunReport("jax-op-by-op")
    for cell in JIT_PARTS:
        _, family, policy = cell.split("/")
        seed = SCENARIOS["seed"] + zlib.crc32(cell.encode()) % 100003
        with jax.disable_jit():
            jax_scenarios.run_scenarios(
                names=names, template=template,
                spec=jax_chaos._scenario_spec(jax_scenarios, family, seed, d),
                policy=policies[policy], n_paths=SCENARIOS["n_paths"],
                chunk=SCENARIOS["n_paths"], report=rep, tag=cell, **panels)
    return rep


def _risk_rows(rep, cell):
    return [r for r in rep.rows if r.get("kind") == "scenario"
            and r["name"].startswith(f"{cell}/")]


def _worst_var_es(rows, ref) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
               for a, b in zip(rows, ref) for k in ("var", "es"))


@pytest.mark.parametrize("family", SCENARIOS["families"])
@pytest.mark.parametrize("policy", SCENARIOS["policies"])
def test_scenario_cell_equals_jax(scenarios, scenarios_op_by_op, family,
                                  policy):
    j, p, jrep, prep = scenarios
    cell = f"scenario/{family}/{policy}"
    got, want = p["results"][cell], j["results"][cell]
    assert got["ok"] and want["ok"], (got["violations"], want["violations"])
    assert {k: v for k, v in got.items() if k != "violations"} == \
        {k: v for k, v in want.items() if k != "violations"}
    rows = _risk_rows(prep, cell)
    ref = _risk_rows(scenarios_op_by_op if cell in JIT_PARTS else jrep,
                     cell)
    assert [r["name"] for r in rows] == [r["name"] for r in ref] != []
    for a, b in zip(rows, ref):
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=TOL_SMOOTH,
                                             abs=TOL_SMOOTH), k
            elif k in ("var", "es"):
                np.testing.assert_allclose(a[k], v, rtol=TOL_SMOOTH,
                                           atol=TOL_SMOOTH, err_msg=k)
            elif k in ("sketch_neg", "sketch_pos"):
                assert a[k]["count"] == v["count"], k
            else:
                assert a[k] == v, k


def test_scenario_jit_parts_are_the_references_own(scenarios,
                                                  scenarios_op_by_op):
    """``JIT_PARTS``: the JAX package's jitted cell parts from its own
    op-by-op cell past ``TOL_SMOOTH`` in its risk rows; the port follows
    the op-by-op engine."""
    _, _, jrep, _ = scenarios
    for cell in JIT_PARTS:
        assert _worst_var_es(_risk_rows(jrep, cell),
                             _risk_rows(scenarios_op_by_op, cell)) > \
            TOL_SMOOTH


# ----------------------------------------- the CLI's kill/resume, the port


CLI = [sys.executable, "-m", "factormodeling_tpu_torch.chaos", "--device",
       "cpu", "--json"]
ARGS = {
    "research": ["--shape", "4,24,10", "--window", "6", "--method", "equal",
                 "--faults", "nan_burst,universe_collapse", "--policies",
                 "default,guard", "--rate", "0.08", "--day-rate", "0.25",
                 "--seed", "5"],
    "serving": ["--serving", "--shape", "4,30,12", "--window", "5",
                "--method", "linear", "--faults", "none,dispatch_error",
                "--policies", "bounded,degrade", "--requests", "18",
                "--seed", "1"],
    "scenarios": ["--scenarios", "--shape", "4,36,12", "--window", "6",
                  "--method", "equal", "--faults", "bootstrap,adversarial",
                  "--policies", "default,guard", "--paths", "4",
                  "--seed", "3"],
    "online": ["--online", "--shape", "5,14,8", "--window", "4",
               "--method", "equal", "--faults", "kill_after_apply",
               "--policies", "open"],
}
KILL = {"research": {"_FMT_CHAOS_DIE_AFTER_CELL": "1"},
        "serving": {"_FMT_SERVE_DIE_AFTER_DISPATCH": "2"},
        "scenarios": {"_FMT_CHAOS_DIE_AFTER_CELL": "1"},
        "online": {"_FMT_ONLINE_DIE_AFTER_DATE": "10"}}
CLI_TIMEOUT = 300


def _start(args, env_extra=None):
    return subprocess.Popen(CLI + args, cwd=REPO, env={**_ENV,
                                                       **(env_extra or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(procs):
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT)
        out[key] = subprocess.CompletedProcess(proc.args, proc.returncode,
                                               stdout, stderr)
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every differential's straight run and killed run at once, then the
    resumes and the corrupt snapshot's rejection at once (each child on
    one thread)."""
    tmp = tmp_path_factory.mktemp("chaos_cli")
    ck = {k: tmp / f"{k}.ckpt" for k in ARGS}
    first = {}
    for key, args in ARGS.items():
        first[key, "straight"] = _start(args)
        first[key, "killed"] = _start(args + ["--checkpoint", str(ck[key])],
                                      KILL[key])
    runs = _finish(first)
    corrupt = tmp / "corrupt.ckpt"
    if ck["research"].exists():
        shutil.copy(ck["research"], corrupt)
        raw = bytearray(corrupt.read_bytes())
        raw[-5] ^= 0x20
        corrupt.write_bytes(bytes(raw))
    second = {(key, "resumed"): _start(
        args + ["--checkpoint", str(ck[key]), "--report",
                str(tmp / f"{key}.jsonl")])
        for key, args in ARGS.items()}
    second["research", "corrupt"] = _start(
        ARGS["research"] + ["--checkpoint", str(corrupt)])
    runs.update(_finish(second))
    return runs, tmp


def _report(tmp, key):
    return [json.loads(line) for line in
            (tmp / f"{key}.jsonl").read_text().splitlines()]


def _assert_resumed(runs, key, killed_says, resumed_says=None):
    straight, killed = runs[key, "straight"], runs[key, "killed"]
    resumed = runs[key, "resumed"]
    assert straight.returncode == 0, straight.stderr[-2000:]
    assert killed.returncode == 137, killed.stderr[-2000:]
    assert killed_says in killed.stdout + killed.stderr
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    if resumed_says is not None:
        assert resumed_says in resumed.stderr
    assert resumed.stdout == straight.stdout   # byte-equal verdict JSON
    return json.loads(resumed.stdout)


def test_research_cli_kill_resume_and_corruption(cli_runs):
    """Killed right after cell 1's snapshot, a bit-flipped copy of the
    snapshot rejected with exit 2, the intact one resumed byte-equal."""
    runs, tmp = cli_runs
    verdict = _assert_resumed(runs, "research", "chaos: dying after cell 1",
                              "chaos: resumed 2/4 cells")
    assert verdict["cells"] == 4 and verdict["ok"]
    rejected = runs["research", "corrupt"]
    assert rejected.returncode == 2, rejected.stderr[-2000:]
    assert "corrupt" in rejected.stderr
    # the resumed report continues the killed run's: one baseline span,
    # each cell's degrade row once
    rows = _report(tmp, "research")
    assert sum(r.get("kind") == "span" and r.get("name") == "chaos/baseline"
               for r in rows) == 1
    assert sorted(r["name"] for r in rows if r.get("kind") == "degrade") \
        == sorted(verdict["results"])


def test_serving_cli_kill_resume_differential(cli_runs):
    """Killed between dispatches (the queue's
    ``_FMT_SERVE_DIE_AFTER_DISPATCH`` hook), resumed from the queue's and
    the cell loop's snapshots: no request served twice or lost."""
    runs, tmp = cli_runs
    verdict = _assert_resumed(runs, "serving", "dying after dispatch 2")
    assert verdict["ok"] and verdict["cells"] == 4
    rows = _report(tmp, "serving")
    assert sorted(r["name"] for r in rows if r.get("kind") == "serving"
                  and r["name"].startswith("serving/")) \
        == sorted(verdict["results"])


def test_scenario_cli_kill_resume_differential(cli_runs):
    runs, tmp = cli_runs
    verdict = _assert_resumed(runs, "scenarios",
                              "chaos-scenarios: dying after cell 1",
                              "chaos-scenarios: resumed 2/4 cells")
    assert verdict["ok"] and verdict["cells"] == 4
    rows = _report(tmp, "scenarios")
    assert sorted(r["name"] for r in rows
                  if r.get("kind") == "scenario_cell") \
        == sorted(verdict["results"])
    assert {r["name"].rsplit("/", 1)[0] for r in rows
            if r.get("kind") == "scenario"} == set(verdict["results"])


def test_online_cli_kill_resume_holds_the_unshared_fields(cli_runs):
    """``NOT_SHARED``'s online fields, held across the port itself: the
    engine killed mid-stream (``_FMT_ONLINE_DIE_AFTER_DATE``) and resumed
    gives the straight run's state digest and content chain, byte for
    byte."""
    runs, _ = cli_runs
    verdict = _assert_resumed(runs, "online", "")
    cell = verdict["results"]["online/kill_after_apply/open"]
    assert cell["ok"] and set(NOT_SHARED) - {"wall"} <= set(cell)
    assert cell["statuses"]["rejected"] == 1   # the duplicate re-feed


# ------------------------------------------------------- the CLI surface


def test_cli_without_a_card_raises_rather_than_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error; a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device|CUDA"):
        chaos.main(["--shape", "3,16,8", "--json"])


def test_cli_rejects_bad_usage_with_exit_2(capsys):
    assert chaos.main(["--serving", "--online", "--device", "cpu"]) == 2
    assert chaos.main(["--shape", "3,16", "--device", "cpu"]) == 2
    assert chaos.main(["--faults", "no_such_fault", "--device", "cpu",
                       "--shape", "3,16,8", "--method", "equal"]) == 2
    assert "unknown fault classes" in capsys.readouterr().err
