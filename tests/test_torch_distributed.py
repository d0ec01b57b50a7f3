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
  fingerprint equal.
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
    unsharded server's."""
    assert world[0]["serve/mesh/stats"] == dict(
        zip(("configs", "assets"), {2: (2, 1), 4: (2, 2)}[len(world)]))
    assert world[0]["serve/plain/stats"] is None
    for r in world:
        assert r["serve/mesh/market_panels_calls"] == 0
        assert r["serve/mesh/fingerprint"] == r["serve/plain/fingerprint"]
    for got, want in zip(world[0]["serve/mesh"], world[0]["serve/plain"]):
        for k, v in want.items():
            _close(got[k], v, 1e-12, k)
    for got_rows, want_rows in zip(world[0]["advance/mesh"],
                                   world[0]["advance/plain"]):
        for (ready, w, sig), (ready2, w2, sig2) in zip(got_rows, want_rows):
            assert ready == ready2
            _close(w, w2, 1e-12, "weights")
            _close(sig, sig2, 1e-12, "signal")


def test_divisibility_errors(world):
    errors = world[0]["errors"]
    assert "not divisible by the mesh's 'factor' axis" in errors["factors"]
    assert "not divisible by the mesh's 'assets' axis" in errors["assets"]
    assert "not divisible by the mesh's 'combo' axis" in errors["combos"]
    if len(world) == 4:        # the (2, 2) mesh shards dates in two
        assert "not divisible by the mesh's 'date' axis" in errors["dates"]
    else:                      # (2, 1): one date block takes any D
        assert errors["dates"] is None
