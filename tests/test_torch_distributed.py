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
  the modes by those bytes, with a different plan on each mesh shape.
- The sharded sweep against ``manager_sweep`` and the JAX package's
  sharded sweep at 1e-10.
- The asset-sharded step in every layout mode against the unsharded step
  and the JAX package's asset-sharded step at 1e-10; its placement rows
  (``RunReport(comms=True)``) against the shape model and the JAX
  package's stage rule.
- Date-sharded streaming bitwise its unsharded run (whole chunks, block
  chunks, a disk source); the linear research and the composite.
- ``TenantServer(mesh=...)``: ``serve`` and ``advance_all`` against the
  unsharded server.
- The divisibility errors; the ranks' modules hold no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.parallel import (AssetSpecPlan as JaxPlan,
                                         make_asset_mesh as jax_asset_mesh,
                                         make_asset_sharded_research_step
                                         as jax_asset_step,
                                         make_mesh as jax_make_mesh,
                                         make_sharded_research_step
                                         as jax_sharded_step)
from factormodeling_tpu.parallel import sweep as jsweep
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


@pytest.mark.parametrize("mode", dc.MODES)
def test_asset_sharded_step_matches_unsharded_and_jax(world, mode):
    n = len(world)
    for label in ("date_assets", "assets"):
        assert all(r[f"asset/{label}/{mode}/err"] <= 1e-10 for r in world)
    got = world[0][f"asset/date_assets/{mode}"]
    mesh = jax_asset_mesh(("date", "assets"), n_devices=n)
    step, shard = jax_asset_step(mesh, names=dc.NAMES, window=dc.WINDOW,
                                 sim_kwargs=dc.ASSET_SIM,
                                 plan=JaxPlan(mesh, default=mode))
    out = step(*shard(*RAW))
    for k, want in (("selection", out.selection), ("signal", out.signal),
                    ("log_return", out.sim.result.log_return)):
        _close(got[k], np.asarray(want), 1e-10, f"{mode} {k}")


def _model_bytes(ledger):
    """Per stage, the wrappers' bytes recounted from the ops' shapes."""
    out: dict = {}
    for op in ledger:
        s, b = op["group_size"], op["operand_bytes"]
        factor = {"all-gather": s - 1, "all-to-all": (s - 1) / s,
                  "all-reduce": 2 * (s - 1) / s}[op["kind"]]
        out[op["stage"]] = (out.get(op["stage"], 0.0)
                            + factor * b * s * op["n_groups"])
    return out


def _layout_ops(mode, d, s):
    """The ``(kind, axis, operand bytes)`` each layout stage issues under
    ``mode`` on a ``(d, s)`` ``("date", "assets")`` mesh
    (``ops/_assetspec.py``), keyed by the ledger stage the outermost-scope
    rule charges them to: the scoring runs inside ``selection/rolling``,
    where the shift first gathers the stack block over the dates (the
    same in every mode), then forms rows of the shifted stack (every date
    of this rank's asset block) and gathers its ``[2, F, rows]`` tables
    (icir_top reads rank_ic, which comes with its pair count); the blend
    forms rows of the ``[F, D/d, N/s]`` block and gathers the ``[rows,
    N]`` signal."""
    assert selection_metric_needs("icir_top") == ("rank_ic",)
    f, db, nn = dc.F, dc.D // d, dc.N
    blk = f * db * (nn // s) * 8
    table, sig = 2 * f * db * 8, db * nn * 8
    shift = [("all-gather", "date", blk)]
    if mode == "reshard" and db % s:
        mode = "auto"
    if mode == "auto":
        return {"selection/rolling": shift + [("all-gather", "assets", blk),
                                              ("all-gather", "date", table)],
                "composite/blend": [("all-gather", "assets", blk),
                                    ("all-gather", "date", sig)]}
    if mode == "reshard":
        return {"selection/rolling": shift + [
                    ("all-to-all", "assets", blk),
                    ("all-gather", "assets", table // s),
                    ("all-gather", "date", table)],
                "composite/blend": [("all-to-all", "assets", blk),
                                    ("all-gather", "assets", sig // s),
                                    ("all-gather", "date", sig)]}
    return {"selection/rolling": shift + [("all-gather", "assets",
                                           blk * d)],
            "composite/blend": [("all-gather", "assets", blk),
                                ("all-gather", "date", blk * s)]}


#: the ledger stage each plan stage's collectives land under (the
#: outermost-scope rule; ``asset_shard._STAGE_LEDGER_SCOPES``)
_LEDGER_STAGE = {"metrics/rank_ic": "selection/rolling",
                 "composite/blend": "composite/blend"}


def _bytes_of(ops, sizes, n):
    """The byte model over ``(kind, axis, operand bytes)`` ops, mesh-wide
    (``n`` ranks)."""
    factor = {"all-gather": lambda g: g - 1,
              "all-to-all": lambda g: (g - 1) / g}
    return sum(factor[k](sizes[a]) * b * n for k, a, b in ops)


def test_asset_ledger_bytes_follow_the_shapes(world):
    """On the 2-D mesh each layout stage issues its mode's collectives on
    the step's shapes, cut into this rank's blocks, and the ledger's
    per-stage bytes are the byte model's."""
    sizes = dict(zip(("date", "assets"),
                     world[0]["asset/date_assets/mesh_shape"]))
    d, s = sizes["date"], sizes["assets"]
    n = len(world)
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
        # the shift's one gather of the stack block over the dates, the
        # same in every mode, opens the scoring; the backtest moves nothing
        stats = [(op["kind"], op["axis"], op["operand_bytes"])
                 for op in ledger if op["stage"] == "selection/rolling"][:1]
        assert stats == [("all-gather", "date",
                          dc.F * (dc.D // d) * (dc.N // s) * 8)]
        assert set(by_stage) == {"parallel/inputs", "selection/rolling",
                                 "composite/blend"}


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
                                 "composite/blend", "total"}
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
    ranking = world[0]["chooser/ranking"]
    plan = world[0]["chooser/plan"]
    n = len(world)
    sizes = dict(zip(("date", "assets"),
                     world[0]["asset/date_assets/mesh_shape"]))
    for stage, entry in ranking.items():
        if stage == "__total__":
            continue
        ranked = entry["ranked"]
        assert sorted(b for _, b in ranked) == [b for _, b in ranked]
        assert plan[stage] == ranked[0][0]
        # the chooser's shape-only bytes are the model's and those the
        # real run's ledger shows
        for mode, got in ranked:
            want = _bytes_of(_layout_ops(mode, sizes["date"],
                                         sizes["assets"])[_LEDGER_STAGE[stage]],
                             sizes, n)
            assert got == pytest.approx(want), (stage, mode)
            real = world[0][f"asset/date_assets/{mode}/ledger"]
            assert got == pytest.approx(_model_bytes(real).get(
                _LEDGER_STAGE[stage], 0.0))
    # the answer follows the mesh: on (2, 2) resharding moves least in
    # both stages; on (2, 1) the scoring's gather moves no byte (the
    # shifted stack already holds every date) and the blend keeps auto
    assert plan == ({"metrics/rank_ic": "reshard",
                     "composite/blend": "reshard"} if n == 4 else
                    {"metrics/rank_ic": "gather", "composite/blend": "auto"})
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
    assert world[0]["serve/mesh/stats"] == dict(
        zip(("configs", "assets"), {2: (2, 1), 4: (2, 2)}[len(world)]))
    assert world[0]["serve/plain/stats"] is None
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
