"""The port's mesh layer in real multi-process worlds: spawned ``gloo``
worlds of 2 and 4 ranks on the CPU, in float64, against the port's
unsharded runs and the JAX package's sharded counterparts.

One world a rank count runs every case once
(``factormodeling_tpu_torch.parallel._dist_check.launch``, the port of the
JAX package's two- and four-process check: each rank prints ``DIST_OK``
and ``DIST_ASSET_OK``), in a module-scoped fixture; the ranks rendezvous
through a ``FileStore`` under ``tmp_path``, import only the port, and write
what they computed there, which the tests below read. JAX runs only here,
in the parent, on the conftest's virtual CPU devices, at the worlds' mesh
shapes.

- The factor x date sharded step against the port's unsharded step and
  the JAX package's sharded step at the JAX package's tolerances
  (``tests/test_parallel.py``): selection, signal and ``log_return``
  1e-10, Sharpe 1e-8, for ``icir_top``/``equal`` and
  ``momentum``/``linear``; ``mvo`` and ``mvo_turnover`` weights 1e-8.
- The ledger: the sharded step issues no collective inside the
  backtest (the turnover day loop); each stage's bytes equal the byte
  model over the shapes; on the 2-D ``("date", "assets")`` mesh each
  layout mode issues its own collectives on the step's shapes (the
  asset-sharded step's stages compute on different rows in each mode),
  and ``choose_asset_specs`` (its stages run on ``meta`` tensors) ranks
  the JAX package's five stages by those bytes, with a different plan on
  each mesh shape; under ``reshard`` no rank is handed a whole ``[D, N]``
  panel, and the rows a stage holds are ``D/(d s)``.
- The sharded sweep against ``manager_sweep`` and the JAX package's
  sharded sweep at 1e-10.
- The asset-sharded step for ``equal``, ``linear``, ``mvo`` and the
  ``mvo_turnover`` scan, in every layout mode and under the JAX package's
  mixed plan, on both meshes, against the unsharded step (every rank,
  1e-10, in fact bitwise) and the JAX package's asset-sharded step at
  1e-10; its placement rows (``RunReport(comms=True)``) against the shape
  model and the JAX package's stage rule.
- Date-sharded streaming bitwise its unsharded run (whole chunks, block
  chunks, a disk source); the linear research and the composite.
- ``TenantServer(mesh=...)``: ``serve`` (no whole-panel gather on a
  dispatch) and ``advance_all`` against the unsharded server, the panels'
  fingerprint equal; on the ``("configs", "assets")`` mesh and an
  ``("assets",)`` mesh its online sessions hold their state as asset
  blocks, and ``advance_all`` of the four equal tenants and the turnover
  tenant matches the JAX package's sharded server.
- The asset-sharded online advance (``make_online_step(mesh=)``) for the
  JAX package's online ladder on a NaN and a ragged market and a
  risk-model cell, in every layout mode, against the unsharded advance
  (selection, signal and weights 1e-12 and in fact bitwise; counts and
  verdicts equal; the P&L scalars 1e-12), a session's lanes split over
  the asset ranks, the JAX package's sharded advance for its two tier-1
  cells, the state held as blocks by the JAX package's leaf rule, and the
  collectives all under the ``online/*`` stages.
- The divisibility errors; the ranks' modules hold no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.ops._assetspec import \
    ASSET_SORT_STAGES as JAX_STAGES
from factormodeling_tpu.parallel import (AssetSpecPlan as JaxPlan,
                                         make_asset_mesh as jax_asset_mesh,
                                         make_asset_sharded_research_step
                                         as jax_asset_step,
                                         make_mesh as jax_make_mesh,
                                         make_sharded_research_step
                                         as jax_sharded_step)
from factormodeling_tpu.parallel import sweep as jsweep
from factormodeling_tpu.parallel.asset_shard import \
    _STAGE_LEDGER_SCOPES as JAX_SCOPES
from factormodeling_tpu_torch.online.advance import ONLINE_STAGES
from factormodeling_tpu_torch.parallel import _dist_check as dc
from factormodeling_tpu_torch.selection.driver import selection_metric_needs
from tests.torch_threads import torch_one_thread  # noqa: F401

WORLDS = (2, 4)
RAW = dc.market()
# the JAX package's tolerances (tests/test_parallel.py)
TOL = {"selection": 1e-10, "signal": 1e-10, "log_return": 1e-10,
       "sharpe": 1e-8, "weights": 1e-8}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, tmp_path_factory):
    """Every case in one spawned world; the ranks' results."""
    n = request.param
    out = tmp_path_factory.mktemp(f"world{n}")
    try:
        dc.launch(timeout=300.0, n_proc=n, out_dir=str(out))
    except dc.DistributedUnsupported as e:
        pytest.skip(str(e))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float), atol=tol,
                               rtol=0, equal_nan=True, err_msg=what)


_jax_cache: dict = {}


def _jax_step(label, n):
    """The JAX package's sharded step on ``n`` of the virtual devices."""
    key = ("step", label, n)
    if key not in _jax_cache:
        _, select, sim = next(c for c in dc.STEP_CASES if c[0] == label)
        mesh = jax_make_mesh(("factor", "date"), n_devices=n)
        step, shard = jax_sharded_step(mesh, names=dc.NAMES,
                                       window=dc.WINDOW,
                                       select_method=select,
                                       sim_kwargs=sim)
        out = step(*shard(*RAW))
        _jax_cache[key] = {
            "selection": np.asarray(out.selection),
            "signal": np.asarray(out.signal),
            "log_return": np.asarray(out.sim.result.log_return),
            "weights": np.asarray(out.sim.weights),
            "sharpe": float(out.summary.sharpe)}
    return _jax_cache[key]


# ------------------------------------------------------ the sharded step


def test_every_rank_passed_the_check_and_holds_no_jax(world):
    n = len(world)
    assert [r["rank"] for r in world] == list(range(n))
    assert all(r["world"] == n for r in world)
    assert all(r["modules"] == [] for r in world)
    # two posed hosts: make_hybrid_mesh puts "factor" across them
    assert all(r["slices"] == 2 for r in world)
    assert tuple(world[0]["mesh_shape"]) == {2: (2, 1), 4: (2, 2)}[n]


@pytest.mark.parametrize("label", [c[0] for c in dc.STEP_CASES])
def test_sharded_step_matches_unsharded_and_jax(world, label):
    got = world[0][f"step/{label}"]
    # each rank held its outputs against its own unsharded step
    assert all(r[f"step/{label}/err"] <= 1e-10 for r in world)
    for r in world[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(r[f"step/{label}"][k], v)
    want = _jax_step(label, len(world))
    keys = (("weights", "log_return", "sharpe") if "mvo" in label
            else ("selection", "signal", "log_return", "sharpe"))
    for k in keys:
        _close(got[k], want[k], TOL[k], f"{label} {k}")


def test_faulted_probed_sharded_step_matches_unsharded(world):
    """With a fault spec, a policy, counters and probes (the whole stack
    gathered first), every rank's step is its unsharded step's."""
    assert all(r["step/faulted/err"] <= 1e-10 for r in world)
    for r in world:
        got, want = r["step/faulted/counters"]
        assert repr(got) == repr(want)          # NaN fields repr alike
        assert r["step/faulted/probes"] == sorted(
            ["ops/factors_raw", "ops/factors_delta", "selection/rolling",
             "composite/blend", "solver/admm", "backtest/weights",
             "backtest/pnl"])


def test_all_reduce_over_each_axis(world):
    """Ranks are numbered factor-major ((factor, date) grid, one host on
    each factor index): rank + 1 summed, maxed and minned over each
    axis's group."""
    sizes = dict(zip(("factor", "date"), world[0]["mesh_shape"]))
    for rank, r in enumerate(world):
        f, d = divmod(rank, sizes["date"])
        by_factor = [i * sizes["date"] + d + 1 for i in range(sizes["factor"])]
        by_date = [f * sizes["date"] + j + 1 for j in range(sizes["date"])]
        assert r["all_reduce"] == {
            "factor": [sum(by_factor), max(by_factor), min(by_factor)],
            "date": [sum(by_date), max(by_date), min(by_date)]}


def test_turnover_day_loop_issues_no_collective(world):
    ledger = world[0]["step/icir_top_mvo_turnover/ledger"]
    assert ledger
    for op in ledger:
        assert "backtest/" not in op["op_name"], op
        assert "solver/" not in op["op_name"], op
    stages = {op["stage"] for op in ledger}
    assert stages == {"parallel/inputs", "selection/rolling",
                      "composite/blend"}


def test_sharded_step_ledger_follows_the_byte_model(world):
    """Each all-gather's bytes are (S-1) x its operand x the mesh's ranks,
    and the operands are the blocks of the step's shapes."""
    ledger = world[0]["step/icir_top_equal/ledger"]
    sizes = dict(zip(("factor", "date"), world[0]["mesh_shape"]))
    n = len(world)
    f, d, nn = dc.F, dc.D, dc.N
    fb, db = f // sizes["factor"], d // sizes["date"]
    for op in ledger:
        s = sizes[op["axis"]]
        assert op["kind"] == "all-gather"
        assert op["group_size"] == s and op["n_groups"] == n // s
        assert op["bytes_moved"] == (s - 1) * op["operand_bytes"] * n
    blend = [op["operand_bytes"] for op in ledger
             if op["stage"] == "composite/blend"]
    # the factor block of this rank's dates, then the signal's date block
    assert blend == [fb * db * nn * 8, db * nn * 8]


# ------------------------------------------------------------ the sweep


def test_sharded_sweep_matches_manager_sweep_and_jax(world):
    got = world[0]["sweep"]
    for k, v in got.items():
        _close(v, world[0]["sweep/plain"][k], 1e-10, k)
    factors, returns, _, cap, invest, universe = RAW
    rng = np.random.default_rng(4)
    combos = np.stack([rng.choice(dc.F, 3, replace=False) for _ in range(8)])
    settings = JaxSettings(returns=jnp.asarray(returns),
                           cap_flag=jnp.asarray(cap),
                           investability_flag=jnp.asarray(invest),
                           universe=jnp.asarray(universe), method="equal",
                           pct=0.3)
    mesh = jax_make_mesh(("combo",), n_devices=len(world))
    want = jsweep.make_sharded_manager_sweep(mesh, combo_batch=2)(
        jnp.asarray(factors), jsweep.combo_weight_matrix(combos, dc.F),
        settings)
    for k, v in got.items():
        _close(v, np.asarray(getattr(want, k)), 1e-10, k)


# ----------------------------------------------------- the asset step


def _jax_asset(sim, mode, n):
    """The JAX package's asset-sharded step on the ``("date", "assets")``
    mesh of ``n`` virtual devices under ``mode`` (or the mixed plan)."""
    key = ("asset", sim, mode, n)
    if key not in _jax_cache:
        mesh = jax_asset_mesh(("date", "assets"), n_devices=n)
        plan = (JaxPlan(mesh, modes=dc.MIXED) if mode == "mixed"
                else JaxPlan(mesh, default=mode))
        step, shard = jax_asset_step(mesh, names=dc.NAMES, window=dc.WINDOW,
                                     sim_kwargs=dict(dc.ASSET_SIMS)[sim],
                                     plan=plan)
        out = step(*shard(*RAW))
        _jax_cache[key] = {
            "selection": np.asarray(out.selection),
            "signal": np.asarray(out.signal),
            "log_return": np.asarray(out.sim.result.log_return),
            "weights": np.asarray(out.sim.weights)}
    return _jax_cache[key]


def _asset_key(label, sim, mode):
    return (f"asset/{label}/{mode}" if sim == "equal"
            else f"asset/{label}/{sim}/{mode}")


@pytest.mark.parametrize("mode", dc.PLANS)
def test_asset_sharded_step_matches_unsharded_and_jax(world, mode):
    for label in ("date_assets", "assets"):
        assert all(r[f"asset/{label}/{mode}/err"] <= 1e-10 for r in world)
    got = world[0][f"asset/date_assets/{mode}"]
    want = _jax_asset("equal", mode, len(world))
    for k in ("selection", "signal", "log_return", "weights"):
        _close(got[k], want[k], 1e-10, f"{mode} {k}")


@pytest.mark.parametrize("sim", [s for s, _ in dc.ASSET_SIMS[1:]])
def test_asset_sharded_backtests_match_unsharded_and_jax(world, sim):
    """Every plan on both meshes: each rank's gathered outputs are the
    unsharded step's (held at 1e-10 on the rank; here bitwise), alike on
    every rank; the JAX package's asset step under its mixed plan at
    1e-10 (the parallel scheme is held to the JAX package's through its
    unsharded run, ``tests/test_torch_turnover_parallel.py``)."""
    local = world[0][f"asset/{sim}/local"]
    for label in ("date_assets", "assets"):
        for mode in dc.PLANS:
            key = _asset_key(label, sim, mode)
            for r in world:
                assert r[f"{key}/err"] <= 1e-10
                for k, v in local.items():
                    np.testing.assert_array_equal(r[key][k], v, err_msg=key)
    if sim == "mvo_turnover_parallel":
        return
    got = world[0][_asset_key("date_assets", sim, "mixed")]
    want = _jax_asset(sim, "mixed", len(world))
    for k in ("selection", "signal", "log_return", "weights"):
        _close(got[k], want[k], 1e-10, f"{sim} {k}")


def _model_bytes(ledger):
    """Per stage, the wrappers' bytes recounted from the ops' shapes."""
    out: dict = {}
    for op in ledger:
        s, b = op["group_size"], op["operand_bytes"]
        factor = {"all-gather": s - 1, "all-to-all": (s - 1) / s,
                  "all-reduce": 2 * (s - 1) / s,
                  "collective-permute": 1}[op["kind"]]
        out[op["stage"]] = (out.get(op["stage"], 0.0)
                            + factor * b * s * op["n_groups"])
    return out


def _layout_ops(mode, d, s):
    """The ``(kind, axis, operand bytes)`` the scoring and the blend issue
    under ``mode`` on a ``(d, s)`` ``("date", "assets")`` mesh
    (``ops/_assetspec.py``), keyed by the ledger stage the outermost-scope
    rule charges them to: the scoring runs inside ``selection/rolling``,
    where the shift first gathers each date block's last two present
    values a name (``[2, F, 2, N/s]``, the same in every mode), then forms
    rows of the shifted stack block and of the returns and universe, and
    gathers its ``[2, F, rows]`` tables
    (icir_top reads rank_ic, which comes with its pair count); the blend
    forms rows of the ``[F + 1, D/d, N/s]`` stack and universe block
    (``ops/quantile``) and keeps its signal rows, which go back to the
    ``[D/d, N/s]`` block at the end."""
    assert selection_metric_needs("icir_top") == ("rank_ic",)
    f, db, nn = dc.F, dc.D // d, dc.N
    blk = f * db * (nn // s) * 8
    panel = 2 * db * (nn // s) * 8
    fblk = (f + 1) * db * (nn // s) * 8
    table = 2 * f * db * 8
    shift = [("all-gather", "date", 2 * f * 2 * (nn // s) * 8)]
    if mode == "reshard" and db % s:
        mode = "auto"
    if mode == "auto":
        return {"selection/rolling": shift + [
                    ("all-gather", "assets", blk),
                    ("all-gather", "assets", panel),
                    ("all-gather", "date", table)],
                "composite/blend": [("all-gather", "assets", fblk)]}
    if mode == "reshard":
        return {"selection/rolling": shift + [
                    ("all-to-all", "assets", blk),
                    ("all-to-all", "assets", panel),
                    ("all-gather", "assets", table // s),
                    ("all-gather", "date", table)],
                "composite/blend": [("all-to-all", "assets", fblk),
                                    ("all-to-all", "assets",
                                     db // s * nn * 8)]}
    return {"selection/rolling": shift + [
                ("all-gather", "assets", blk),
                ("all-gather", "date", blk * s),
                ("all-gather", "assets", panel),
                ("all-gather", "date", panel * s)],
            "composite/blend": [("all-gather", "assets", fblk),
                                ("all-gather", "date", fblk * s)]}


def _bytes_of(ops, sizes, n):
    """The byte model over ``(kind, axis, operand bytes)`` ops, mesh-wide
    (``n`` ranks)."""
    factor = {"all-gather": lambda g: g - 1,
              "all-to-all": lambda g: (g - 1) / g}
    return sum(factor[k](sizes[a]) * b * n for k, a, b in ops)


def test_asset_ledger_bytes_follow_the_shapes(world):
    """On the 2-D mesh each layout stage issues its mode's collectives on
    the step's shapes, cut into this rank's blocks, and the ledger's
    per-stage bytes are the byte model's; the equal backtest forms its
    four panels' rows (``backtest/weights``) and hands each block the
    shifted row before it (one ``[N]`` row, a collective-permute) unless
    the mode gives every rank every row."""
    sizes = dict(zip(("date", "assets"),
                     world[0]["asset/date_assets/mesh_shape"]))
    d, s = sizes["date"], sizes["assets"]
    n = len(world)
    db, ns = dc.D // d, dc.N // s
    for mode in dc.MODES:
        ledger = world[0][f"asset/date_assets/{mode}/ledger"]
        by_stage: dict = {}
        for op in ledger:
            by_stage[op["stage"]] = (by_stage.get(op["stage"], 0.0)
                                     + op["bytes_moved"])
        assert by_stage == pytest.approx(_model_bytes(ledger))
        for stage, want in _layout_ops(mode, d, s).items():
            got = [(op["kind"], op["axis"], op["operand_bytes"])
                   for op in ledger if op["stage"] == stage]
            assert got == want, (mode, stage)
            assert by_stage.get(stage, 0.0) == pytest.approx(
                _bytes_of(want, sizes, n))
        # the shift's gather of the date blocks' last present values, the
        # same in every mode, opens the scoring
        stats = [(op["kind"], op["axis"], op["operand_bytes"])
                 for op in ledger if op["stage"] == "selection/rolling"][:1]
        assert stats == [("all-gather", "date", 2 * dc.F * 2 * ns * 8)]
        bt = [op for op in ledger if op["stage"] == "backtest/weights"]
        rows_kind = "all-to-all" if mode == "reshard" and db % s == 0 \
            else "all-gather"
        assert (bt[0]["kind"], bt[0]["axis"], bt[0]["operand_bytes"]) == (
            rows_kind, "assets", 4 * db * ns * 8)
        permutes = [op for op in bt if op["kind"] == "collective-permute"]
        if mode == "gather":
            assert not permutes
        else:
            assert [op["operand_bytes"] for op in permutes] == [dc.N * 8]
        assert set(by_stage) == {"parallel/inputs", "selection/rolling",
                                 "composite/blend", "backtest/weights"}


def test_reshard_hands_no_rank_a_whole_panel(world):
    """Under ``reshard`` no collective gives a rank a whole ``[D, N]``
    panel, and every row block a stage forms whole along the assets is
    ``D/(d s)`` rows (``D/s`` on the flat mesh); the solver stage adds
    the covariance window's halo, received a block at a time
    (``collective-permute``, never more rows than a block)."""
    for r in world:
        for label in ("date_assets", "assets"):
            shape = r[f"asset/{label}/mesh_shape"]
            d, s = (shape if label == "date_assets" else (1, shape[0]))
            rows = dc.D // (d * s)
            for sim, _ in dc.ASSET_SIMS:
                ledger = r[_asset_key(label, sim, "reshard") + "/ledger"]
                held = [tuple(op["out_shape"]) for op in ledger]
                assert all(h[-2:] != (dc.D, dc.N) for h in held), sim
                whole_n = [h[-2] for h in held if len(h) >= 2
                           and h[-1] == dc.N]
                assert whole_n and max(whole_n) == rows, (label, sim)
                if sim.startswith("mvo"):
                    halo = [op for op in ledger if op["stage"] ==
                            "solver/admm" and op["kind"] ==
                            "collective-permute" and op["out_shape"][-1]
                            == dc.N]
                    assert halo or d * s == 1


def test_placement_rows_follow_the_shapes_and_the_jax_rule(world):
    """The asset step's first call under ``RunReport(comms=True)`` lands
    its compile row and its placement rows from that same call: the
    ``kind="comms"`` rows' per-stage bytes are the shape model's, every
    collective's stage is the JAX package's ``_stage_of`` of its
    ``op_name`` path, the memory row is the CPU's failure form and the
    sharding verdict is clean."""
    from factormodeling_tpu.obs import comms as jax_comms
    from factormodeling_tpu_torch.obs import comms

    sizes = dict(zip(("date", "assets"),
                     world[0]["asset/date_assets/mesh_shape"]))
    d, s = sizes["date"], sizes["assets"]
    n = len(world)
    for mode in dc.MODES:
        rows = world[0][f"asset/date_assets/{mode}/placement"]
        assert [r["kind"] for r in rows[:1]] == ["compile"]
        assert rows[0]["compiles"] == 1 and not rows[0]["retraced"]
        by_stage = {r["stage"]: r["bytes_moved"] for r in rows
                    if r["kind"] == "comms"}
        assert set(by_stage) == {"parallel/inputs", "selection/rolling",
                                 "composite/blend", "backtest/weights",
                                 "total"}
        for stage, want in _layout_ops(mode, d, s).items():
            assert by_stage[stage] == pytest.approx(
                _bytes_of(want, sizes, n)), (mode, stage)
        ledger = world[0][f"asset/date_assets/{mode}/ledger"]
        assert by_stage["total"] == pytest.approx(
            sum(op["bytes_moved"] for op in ledger))
        for op in ledger:
            assert op["stage"] == jax_comms._stage_of(op["op_name"],
                                                      comms.STAGE_SCOPES)
        mem = [r for r in rows if r["kind"] == "memory"]
        assert len(mem) == 1 and mem[0]["source"] is None
        assert set(mem[0]) == {"kind", "name", "source", "reason",
                               "device_stats"}
        assert mem[0]["device_stats"].startswith("skipped: ")
        lint = [r for r in rows if r["kind"] == "sharding"]
        assert len(lint) == 1 and lint[0]["clean"]
        assert lint[0]["checked_inputs"] == 6


def test_chooser_ranks_by_the_ledger_bytes(world):
    """The chooser ranks the JAX package's five stages, each by the bytes
    its ledger scopes (the JAX package's mapping) hold, and pins each
    stage's winner; its shape-only bytes are those the real run's ledger
    shows in every mode, for the equal and the turnover backtests, and
    the backtest's stages rank by bytes that differ by mode."""
    plan = world[0]["chooser/plan"]
    n = len(world)
    assert set(plan) == set(JAX_STAGES)
    for sim, key in (("equal", "chooser/ranking"),
                     ("mvo_turnover", "chooser/ranking/mvo_turnover")):
        ranking = world[0][key]
        assert set(ranking) == set(JAX_STAGES) | {"__total__"}
        for stage, entry in ranking.items():
            ranked = entry["ranked"]
            assert sorted(b for _, b in ranked) == [b for _, b in ranked]
            if sim == "equal" and stage != "__total__":
                assert plan[stage] == ranked[0][0]
            for mode, got in ranked:
                real = world[0][_asset_key("date_assets", sim, mode)
                                + "/ledger"]
                if stage == "__total__" or entry["attribution"] == "total":
                    want = sum(op["bytes_moved"] for op in real)
                else:
                    want = sum(op["bytes_moved"] for op in real
                               if op["stage"] in JAX_SCOPES[stage])
                assert got == pytest.approx(want), (sim, stage, mode)
        for stage in ("backtest/weights", "solver/iterates"):
            if sim == "equal" and stage == "solver/iterates":
                # the equal scheme solves nothing: judged by the totals
                assert ranking[stage]["attribution"] == "total"
                continue
            assert ranking[stage]["attribution"] == "stage"
            by_mode = dict(ranking[stage]["ranked"])
            if n == 4:
                assert len(set(by_mode.values())) == 3, (sim, stage)
            else:   # (2, 1): one asset rank, resharding moves no byte
                assert by_mode["auto"] == by_mode["reshard"] < by_mode[
                    "gather"]
    # the parallel scheme's shape-only run charges every sweep it may run
    # (the real run's ledger holds those it ran): its solver stage ranks
    # by its own bytes
    par = world[0]["chooser/ranking/mvo_turnover_parallel"]
    assert par["solver/iterates"]["attribution"] == "stage"
    assert par["solver/iterates"]["ranked"][-1][0] == "gather"
    # the answer follows the mesh: on (2, 2) resharding moves least in
    # every stage; on (2, 1) the asset axis has one rank, reshard ties
    # auto and auto wins the tie
    assert plan == {st: "reshard" if n == 4 else "auto" for st in JAX_STAGES}
    # every row is computed as in any other layout: the outputs are the
    # auto plan's bit for bit
    for k, v in world[0]["chooser/run"].items():
        np.testing.assert_array_equal(v, world[0]["asset/date_assets/auto"][k])


# ------------------------------------------------ streaming and serving


def test_date_sharded_streaming_is_bitwise_unsharded(world):
    serial = world[0]["stream/serial"]
    for label in ("whole", "block"):
        for k, v in serial.items():
            np.testing.assert_array_equal(world[0][f"stream/{label}"][k], v)
    for k, v in world[0]["stream/disk/plain"].items():
        np.testing.assert_array_equal(world[0]["stream/disk"][k], v)
    for k, v in world[0]["stream/linear/plain"].items():
        _close(world[0]["stream/linear"][k], v, 1e-12, k)
    _close(world[0]["stream/composite"], world[0]["stream/composite/plain"],
           1e-12, "composite")


def test_sharded_server_matches_unsharded(world):
    """``serve`` on the mesh server (its dispatches run the bucket's step
    on the stored asset blocks, with no whole-panel gather) gives the
    unsharded server's outputs, and its panels' fingerprint is the
    unsharded server's; ``advance_all`` on the ``("configs", "assets")``
    and the ``("assets",)`` servers gives the unsharded server's rows
    (weights and signal 1e-12, the P&L 1e-12)."""
    assert world[0]["serve/mesh/stats"] == dict(
        zip(("configs", "assets"), {2: (2, 1), 4: (2, 2)}[len(world)]))
    assert world[0]["serve/assets/stats"] == {"assets": len(world)}
    assert world[0]["serve/plain/stats"] is None
    for r in world:
        for label in ("mesh", "assets"):
            assert r[f"serve/{label}/market_panels_calls"] == 0
            assert r[f"serve/{label}/fingerprint"] == \
                r["serve/plain/fingerprint"]
    for got, want in zip(world[0]["serve/mesh"], world[0]["serve/plain"]):
        for k, v in want.items():
            _close(got[k], v, 1e-12, k)
    for label in ("mesh", "assets"):
        for r in world:
            for got_rows, want_rows in zip(r[f"advance/{label}"],
                                           r["advance/plain"]):
                assert len(got_rows) == 5
                for got, want in zip(got_rows, want_rows):
                    assert got[0] == want[0]
                    for i, what in ((1, "weights"), (2, "signal"),
                                    (3, "log_return"), (4, "turnover")):
                        _close(got[i], want[i], 1e-12, f"{label} {what}")


def test_sharded_server_holds_its_online_state_as_asset_blocks(world):
    """Each session's market state and lane states are this rank's asset
    columns: ``N/s`` on the asset leaves (``s`` the mesh's asset axis),
    whole elsewhere; the tail is never a whole ``[F, T, N]`` where the
    axis splits."""
    for label, s in (("mesh", {2: 1, 4: 2}[len(world)]),
                     ("assets", len(world))):
        for r in world:
            for market, tenant in r[f"advance/{label}/held"]:
                assert market["factors_tail"] == (dc.F, 8, dc.N // s)
                for path in ("returns_tail", "cap_tail", "invest_tail",
                             "universe_tail", "lb_ring"):
                    if path in market:
                        assert market[path][-1] == dc.N // s, path
                assert market["fr_ring"][-1] == dc.F
                for path, shape in tenant.items():
                    assert shape[-1] == (dc.N // s if not path.endswith(
                        "rho") else shape[-1]), path


def _jax_server_rows(n):
    """The JAX package's sharded ``TenantServer`` on a ``("configs",
    "assets")`` mesh of ``n`` virtual devices: 6 dates of ``advance_all``
    for the four equal tenants and the turnover tenant."""
    key = ("server", n)
    if key not in _jax_cache:
        from factormodeling_tpu.online.state import DateSlice as JaxSlice
        from factormodeling_tpu.serve.frontend import \
            TenantServer as JaxServer
        from factormodeling_tpu.serve.tenant import TenantConfig as JaxCfg

        factors, returns, factor_ret, cap, invest, universe = RAW
        cfgs = [JaxCfg(window=dc.WINDOW, icir_threshold=-1.0, top_k=k,
                       pct=0.2 + 0.05 * k) for k in (1, 2, 3, 4)]
        cfgs.append(JaxCfg(window=dc.WINDOW, icir_threshold=-1.0, top_k=2,
                           method="mvo_turnover", lookback_period=6,
                           max_weight=0.5, sim_static=(("qp_iters", 30),)))
        server = JaxServer(
            names=dc.NAMES, factors=factors, returns=returns,
            factor_ret=factor_ret, cap_flag=cap, investability=invest,
            universe=universe, pad_ladder=(1, 4, 8),
            mesh=jax_asset_mesh(("configs", "assets"), n_devices=n))
        server.online_begin(cfgs)
        rows = []
        for t in range(6):
            adv = server.advance_all(JaxSlice(
                factors=jnp.asarray(factors[:, t]),
                returns=jnp.asarray(returns[t]),
                factor_ret=jnp.asarray(factor_ret[t]),
                cap_flag=jnp.asarray(cap[t]),
                investability=jnp.asarray(invest[t]),
                universe=jnp.asarray(universe[t])))
            rows.append([(bool(a.output.ready),
                          np.asarray(a.output.weights),
                          np.asarray(a.output.signal),
                          float(a.output.log_return),
                          float(a.output.turnover)) for a in adv])
        _jax_cache[key] = rows
    return _jax_cache[key]


def test_sharded_server_online_matches_jax_sharded_server(world):
    """``advance_all`` on the port's ``("configs", "assets")`` server
    against the JAX package's sharded server on the same mesh shape: the
    rows of every finalized date at 1e-12, the P&L at 1e-12 (the first
    date finalizes nothing: its placeholders differ by package)."""
    want = _jax_server_rows(len(world))
    for got_rows, want_rows in zip(world[0]["advance/mesh"], want):
        for got, w in zip(got_rows, want_rows):
            assert got[0] == w[0]
            if not got[0]:
                continue
            for i, what in ((1, "weights"), (2, "signal"),
                            (3, "log_return"), (4, "turnover")):
                _close(got[i], w[i], 1e-12, what)


# --------------------------------------------- the sharded online advance


def _online_cell_ids():
    return [f"{m}-{mk}" for m, mk in dc.ONLINE_CELLS]


@pytest.mark.parametrize("cell", dc.ONLINE_CELLS, ids=_online_cell_ids())
def test_online_advance_sharded_matches_unsharded(world, cell):
    """Every layout mode on every rank: the rows (selection, signal,
    weights) at 1e-12, in fact bitwise; counts, verdicts and readiness
    equal; the P&L scalars at 1e-12 (summed over the asset blocks)."""
    method, market = cell
    assert tuple(world[0]["online/mesh_shape"]) == (len(world),)
    for r in world:
        for mode in dc.MODES:
            gap = r[f"online/{method}/{market}/{mode}/gap"]
            for k in dc.ONLINE_ROWS:
                assert gap[k]["bitwise"], (mode, k, gap[k])
            for k in dc.ONLINE_EXACT:
                assert gap[k]["gap"] == 0.0, (mode, k)
            for k in dc.ONLINE_PNL:
                assert gap[k]["gap"] <= 1e-12, (mode, k, gap[k])
    # every rank gathers the same rows
    for r in world[1:]:
        for k, v in world[0][f"online/{method}/{market}/auto"].items():
            np.testing.assert_array_equal(
                r[f"online/{method}/{market}/auto"][k], v)


@pytest.mark.parametrize("method", ["mvo", "mvo_turnover"])
def test_online_lanes_sharded_match_unsharded(world, method):
    """A session of four lanes (knobs a lane; under ``reshard`` the lanes
    split over the asset ranks, their warm states brought to the solve's
    rows and back) against the unsharded lanes."""
    for r in world:
        for mode in dc.MODES:
            gap = r[f"online/lanes/{method}/{mode}/gap"]
            for k in dc.ONLINE_ROWS + dc.ONLINE_EXACT:
                assert gap[k]["bitwise"], (mode, k, gap[k])
            for k in dc.ONLINE_PNL:
                assert gap[k]["gap"] <= 1e-12, (mode, k, gap[k])


def _jax_online(method, market, n):
    """The JAX package's ``make_online_step`` under ``jax.jit`` on
    asset-sharded inputs over a flat ``("assets",)`` mesh of ``n`` virtual
    devices (``tests/test_asset_sharding.py``'s run)."""
    key = ("online", method, market, n)
    if key not in _jax_cache:
        from jax.sharding import NamedSharding, PartitionSpec

        from factormodeling_tpu.online.advance import make_online_step
        from factormodeling_tpu.online.state import DateSlice as JaxSlice
        from factormodeling_tpu.serve.tenant import TenantConfig as JaxCfg

        mesh = jax_asset_mesh(n_devices=n)
        raw = dc.online_market(market == "ragged")
        template = JaxCfg(**dc.online_config(method)).normalized(
            len(dc.ONLINE_NAMES), 2)
        init_fn, advance_fn = make_online_step(
            names=dc.ONLINE_NAMES, template=template, n_assets=dc.ONLINE_N,
            has_universe=True, stats_tail=8)
        step = jax.jit(advance_fn)
        mstate, tstate = init_fn()

        def put(a):
            dims = [None] * np.ndim(a)
            if np.ndim(a) and np.shape(a)[-1] == dc.ONLINE_N:
                dims[-1] = "assets"
            return jax.device_put(a, NamedSharding(mesh,
                                                   PartitionSpec(*dims)))

        outs = []
        for t in range(dc.ONLINE_D):
            ds = jax.tree_util.tree_map(put, JaxSlice(
                factors=jnp.asarray(raw[0][:, t]),
                returns=jnp.asarray(raw[1][t]),
                factor_ret=jnp.asarray(raw[2][t]),
                cap_flag=jnp.asarray(raw[3][t]),
                investability=jnp.asarray(raw[4][t]),
                universe=jnp.asarray(raw[5][t])))
            (mstate, tstate), out = step(template, mstate, tstate, ds)
            outs.append(out)
        _jax_cache[key] = {k: np.stack([np.asarray(getattr(o, k))
                                        for o in outs])
                           for k in dc.ONLINE_ROWS + dc.ONLINE_EXACT
                           + dc.ONLINE_PNL}
    return _jax_cache[key]


@pytest.mark.parametrize("cell", [("equal", "nan"),
                                  ("mvo_turnover", "ragged")],
                         ids=["equal-nan", "mvo_turnover-ragged"])
def test_online_advance_matches_jax_sharded_advance(world, cell):
    """The JAX package's two tier-1 cells: its sharded advance against the
    port's (every mode), the rows at 1e-12, counts and verdicts equal,
    the P&L at 1e-12."""
    method, market = cell
    want = _jax_online(method, market, len(world))
    ready = want["ready"].astype(bool)
    for mode in dc.MODES:
        got = world[0][f"online/{method}/{market}/{mode}"]
        np.testing.assert_array_equal(got["ready"].astype(bool), ready)
        for k in dc.ONLINE_ROWS + dc.ONLINE_PNL:
            _close(got[k][ready], want[k][ready], 1e-12, f"{mode} {k}")
        for k in dc.ONLINE_EXACT:
            np.testing.assert_array_equal(
                np.asarray(got[k][ready]).astype(np.int64),
                np.asarray(want[k][ready]).astype(np.int64), err_msg=k)


def _jax_leaf_dims(method, rung, n):
    """The JAX package's ``_online_state_specs`` over its own online state
    for ``method``: ``{path: dims}`` for the market state, the stacked
    tenant state of ``rung`` lanes and a date slice."""
    from factormodeling_tpu.online.advance import online_step_parts
    from factormodeling_tpu.online.state import DateSlice as JaxSlice
    from factormodeling_tpu.serve.frontend import TenantServer as JaxServer
    from factormodeling_tpu.serve.tenant import TenantConfig as JaxCfg

    template = JaxCfg(**dc.online_config(method)).normalized(
        len(dc.ONLINE_NAMES), 2)
    im, it, _, _ = online_step_parts(
        names=dc.ONLINE_NAMES, template=template, n_assets=dc.ONLINE_N,
        has_universe=True, stats_tail=8)
    one = it()
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *([one] * rung))
    host = type("Host", (), {})()
    host.mesh = jax_asset_mesh(("configs", "assets"), n_devices=n)
    host._asset_axis, host._config_axis = "assets", "configs"
    mspec, tspec = JaxServer._online_state_specs(host, rung, dc.ONLINE_N)
    raw = dc.online_market(True)
    ds = JaxSlice(*(jnp.asarray(a) for a in (
        raw[0][:, 0], raw[1][0], raw[2][0], raw[3][0], raw[4][0],
        raw[5][0])))

    def table(tree, spec):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            if not np.ndim(leaf):
                continue          # the day and version counters
            name = "/".join(str(getattr(k, "name", getattr(
                k, "key", getattr(k, "idx", k)))) for k in path)
            dims = tuple(spec(leaf).spec) if spec else ()
            out[name] = dims + (None,) * (np.ndim(leaf) - len(dims))
        return out

    def slice_spec(leaf):
        from jax.sharding import PartitionSpec

        last = "assets" if np.shape(leaf)[-1] == dc.ONLINE_N else None
        return type("S", (), {"spec": PartitionSpec(
            *([None] * (np.ndim(leaf) - 1) + [last]))})()

    return (table(im(), mspec), table(stacked, tspec),
            table(ds, slice_spec))


@pytest.mark.parametrize("cell", dc.ONLINE_SHAPE_CELLS,
                         ids=[f"{m}-{mk}" for m, mk in dc.ONLINE_SHAPE_CELLS])
def test_online_state_is_held_as_blocks_by_the_jax_rule(world, cell):
    """Every asset leaf of the market state, the lanes' states and the
    date slice is this rank's ``N/s`` columns, every other leaf whole (no
    rank holds a whole ``[F, T, N]`` tail), and each leaf's placement is
    the one the JAX package's ``_online_state_specs`` (its
    ``_shard_date_slice`` for the slice) gives it."""
    method, market = cell
    s = len(world)
    jm, jt, js = _jax_leaf_dims(method, 2, s)
    for r in world:
        held = r[f"online/{method}/{market}/held"]
        assert held["market_dims"] == jm
        assert held["tenant_dims"] == jt
        assert held["slice_dims"] == js
        for kind in ("market", "tenant", "slice"):
            dims = held[f"{kind}_dims"]
            assert set(held[kind]) == set(dims)
            for path, shape in held[kind].items():
                want = dc.ONLINE_N // s if dims[path][-1] == "assets" \
                    else None
                if want is not None:
                    assert shape[-1] == want, (kind, path, shape)
                else:
                    assert shape[-1:] != (dc.ONLINE_N,), (kind, path)
        tail = held["market"]["factors_tail"]
        assert tail == (len(dc.ONLINE_NAMES), 8, dc.ONLINE_N // s)


def test_online_collectives_lie_under_the_online_stages(world):
    """The sharded advance's collectives are all charged to the
    ``online/*`` stage that contains them (the ledger's outermost known
    scope), under every mode; the unsharded advance issues none."""
    seen = set()
    for method, market in dc.ONLINE_CELLS:
        cell = f"online/{method}/{market}"
        assert world[0][f"{cell}/plain/ledger"] == []
        for mode in dc.MODES:
            ops = world[0][f"{cell}/{mode}/ledger"]
            assert ops, (cell, mode)
            for op in ops:
                assert op["stage"] in ONLINE_STAGES, (cell, mode, op)
                assert op["op_name"].startswith(op["stage"]), op
                seen.add(op["stage"])
    # selection and context are replicated: no collective
    assert seen == {"online/ingest", "online/daily_stats", "online/blend",
                    "online/solve", "online/shift_pnl"}


def test_divisibility_errors(world):
    errors = world[0]["errors"]
    assert "not divisible by the mesh's 'factor' axis" in errors["factors"]
    assert "not divisible by the mesh's 'assets' axis" in errors["assets"]
    assert "not divisible by the mesh's 'combo' axis" in errors["combos"]
    if len(world) == 4:        # the (2, 2) mesh shards dates in two
        assert "not divisible by the mesh's 'date' axis" in errors["dates"]
    else:                      # (2, 1): one date block takes any D
        assert errors["dates"] is None
