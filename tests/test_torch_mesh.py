"""The port's mesh layer in one process (a world of one over ``gloo`` on
the CPU), against the JAX package where it has a counterpart.

- ``balanced_mesh_shape`` equals the JAX package's for 1-16 devices.
- ``make_mesh`` and ``make_hybrid_mesh`` give a world of one with the axis
  names asked for; ``make_hybrid_mesh`` keeps the ``dcn_axis`` error and
  ``make_mesh`` refuses a device count other than the world's.
- ``initialize_cluster`` is a no-op in a single process.
- ``mesh_key``: its shape, ``None`` as ``()``, two meshes keying apart.
- The asset-layout seam: ``hint`` is the identity with no plan; the plan
  validates its modes and axis and restores on exit (the JAX package's
  ``tests/test_asset_sharding.py`` cases); each mode forms a world of
  one's rows through its own collectives; a plan from another mesh is
  refused.
- The sharded step, the asset-sharded step and the sharded sweep in a
  world of one are bitwise the unsharded runs; the ledger's byte model is
  the JAX package's; the lint flags a replicated input; the HLO readers
  raise.
"""

import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu.obs import comms as jax_comms
from factormodeling_tpu.parallel.mesh import \
    balanced_mesh_shape as jax_balanced
from factormodeling_tpu_torch.obs import comms
from factormodeling_tpu_torch.ops import _assetspec
from factormodeling_tpu_torch.parallel import (
    AssetSpecPlan, balanced_mesh_shape, initialize_cluster, make_asset_mesh,
    make_asset_sharded_research_step, make_hybrid_mesh, make_mesh,
    make_sharded_manager_sweep, make_sharded_research_step, release_world)
from factormodeling_tpu_torch.parallel import _dist_check as dc
from factormodeling_tpu_torch.serve.tenant import mesh_key
from tests.torch_threads import torch_one_thread  # noqa: F401

RAW = dc.market()


@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    """The module's meshes share one world of one, taken down at the end."""
    yield
    release_world()


def _eq(a, b):
    return torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0))


@pytest.mark.parametrize("n_axes", [1, 2, 3])
def test_balanced_mesh_shape_equals_jax(n_axes):
    for n in range(1, 17):
        assert balanced_mesh_shape(n, n_axes) == jax_balanced(n, n_axes)


def test_meshes_are_a_world_of_one_with_the_axis_names():
    mesh = make_mesh(("factor", "date"), device="cpu")
    assert mesh.mesh_dim_names == ("factor", "date")
    assert tuple(mesh.shape) == (1, 1)
    assert torch.distributed.get_world_size() == 1
    assert torch.distributed.get_backend() == "gloo"
    flat = make_mesh(("combo",), device="cpu")
    assert tuple(flat.shape) == (1,)
    hybrid = make_hybrid_mesh(("date", "assets"), device="cpu")
    assert hybrid.mesh_dim_names == ("date", "assets")
    with pytest.raises(ValueError, match="dcn_axis 'x' not in"):
        make_hybrid_mesh(("factor", "date"), dcn_axis="x", device="cpu")
    with pytest.raises(ValueError, match="spans every rank"):
        make_mesh(("factor", "date"), n_devices=4, device="cpu")
    with pytest.raises(ValueError, match="carry no 'assets' axis"):
        make_asset_mesh(("factor", "date"), device="cpu")


def test_initialize_cluster_is_a_no_op_in_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    was = torch.distributed.is_initialized()
    initialize_cluster()
    assert torch.distributed.is_initialized() == was


def test_mesh_key_shape_and_two_meshes_key_apart():
    a = make_asset_mesh(("configs", "assets"), device="cpu")
    b = make_asset_mesh(device="cpu")
    assert mesh_key(None) == ()
    key = mesh_key(a)
    assert key == (("configs", "assets"), (1, 1), (0,), "cpu")
    assert key != mesh_key(b)
    assert key == mesh_key(make_asset_mesh(("configs", "assets"),
                                           device="cpu"))


def test_hint_without_plan_is_identity():
    x = torch.ones(3, 5)
    assert _assetspec.active_plan() is None
    assert _assetspec.hint(x, "ops/rank") is x
    assert _assetspec.hint(x, "metrics/rank_ic", sort_dim=0) is x


def test_plan_validates_modes_and_mesh_axis():
    mesh = make_asset_mesh(device="cpu")
    with pytest.raises(ValueError, match="unknown asset-spec mode"):
        AssetSpecPlan(mesh, modes={"ops/rank": "teleport"})
    with pytest.raises(ValueError, match="unknown default mode"):
        AssetSpecPlan(mesh, default="teleport")
    with pytest.raises(ValueError, match="no 'assets' axis"):
        AssetSpecPlan(make_mesh(("factor", "date"), device="cpu"))


def test_plan_restores_on_exit():
    p = AssetSpecPlan(make_asset_mesh(device="cpu"))
    with _assetspec.plan(p) as active:
        assert active is p
        assert _assetspec.active_plan() is p
    assert _assetspec.active_plan() is None


def test_plan_modes_move_the_operand_unchanged():
    """In a world of one each mode's rows are the whole operand, through
    the mode's own collectives (a size-1 axis moves no byte)."""
    mesh = make_asset_mesh(("date", "assets"), device="cpu")
    x = torch.arange(24.0).reshape(2, 3, 4)
    for mode, kinds in (("auto", ["all-gather"] * 2),
                        ("gather", ["all-gather"] * 2),
                        ("reshard", ["all-to-all"] + ["all-gather"] * 2)):
        p = AssetSpecPlan(mesh, default=mode)
        with _assetspec.plan(p), comms.recording(mesh) as ledger:
            y = _assetspec.hint(x, "ops/quantile", batch_axis="date")
            assert p.row_span("ops/quantile", 3, "date") == slice(0, 3)
            z = p.gather_rows(y, "ops/quantile", 3, dim=1,
                              batch_axis="date")
        assert torch.equal(y, x) and torch.equal(z, x)
        assert [op.kind for op in ledger.ops] == kinds
        assert {op.stage for op in ledger.ops} == {"ops/quantile"}
        assert all(op.bytes_moved == 0.0 for op in ledger.ops)


def test_plan_from_another_mesh_is_refused():
    plan = AssetSpecPlan(make_asset_mesh(("configs", "assets"),
                                         device="cpu"))
    with pytest.raises(ValueError, match="different mesh"):
        make_asset_sharded_research_step(
            make_asset_mesh(device="cpu"), plan=plan, names=dc.NAMES,
            window=dc.WINDOW)


@pytest.mark.parametrize("sim", [dict(method="equal", pct=0.3),
                                 dict(method="mvo_turnover",
                                      lookback_period=8, qp_iters=40)],
                         ids=["equal", "mvo_turnover"])
def test_world_of_one_steps_are_bitwise_unsharded(sim):
    cfg = dict(names=dc.NAMES, window=dc.WINDOW, sim_kwargs=sim)
    ref = fmt.build_research_step(**cfg, device="cpu")(
        *[torch.as_tensor(a) for a in RAW])
    mesh = make_mesh(("factor", "date"), device="cpu")
    step, shard = make_sharded_research_step(mesh, **cfg)
    with comms.recording(mesh) as ledger:
        out = step(*shard(*RAW))
    assert step.mesh is mesh and len(step.declared_in_shardings) == 6
    amesh = make_asset_mesh(("date", "assets"), device="cpu")
    astep, ashard = make_asset_sharded_research_step(
        amesh, **cfg, plan=AssetSpecPlan(amesh, default="reshard"))
    aout = astep(*ashard(*RAW))
    for got in (out, aout):
        assert _eq(got.selection, ref.selection)
        assert _eq(got.signal, ref.signal)
        assert _eq(got.sim.weights, ref.sim.weights)
        assert _eq(got.sim.result.log_return, ref.sim.result.log_return)
    # every collective issued on the size-1 axes moves no byte
    assert ledger.ops and all(op.bytes_moved == 0.0 for op in ledger.ops)
    rows = ledger.rows("step")
    assert rows[-1]["stage"] == "total"
    assert rows[-1]["mesh_shape"] == {"factor": 1, "date": 1}


def test_world_of_one_faulted_probed_step_is_bitwise_unsharded():
    """Faults, a policy, counters and probes: the sharded step gathers the
    stack for them and still gives the unsharded outputs bit for bit."""
    cfg = dict(names=dc.NAMES, window=dc.WINDOW,
               sim_kwargs=dict(method="equal", pct=0.3),
               collect_counters=True, collect_probes=True,
               fault_spec=fmt.resil.FaultSpec.make(seed=1, nan_rate=0.01,
                                                   drop_rate=0.05),
               policy=fmt.resil.DegradePolicy.make(min_universe=5,
                                                   carry_fallback=True))
    ref = fmt.build_research_step(**cfg, device="cpu")(
        *[torch.as_tensor(a) for a in RAW])
    mesh = make_mesh(("factor", "date"), device="cpu")
    step, shard = make_sharded_research_step(mesh, **cfg)
    with comms.recording(mesh) as ledger:
        out = step(*shard(*RAW))
    assert _eq(out.signal, ref.signal) and _eq(out.sim.weights,
                                               ref.sim.weights)
    assert repr(fmt.obs.summarize_counters(out.counters)) == repr(
        fmt.obs.summarize_counters(ref.counters))
    assert list(out.probes) == list(ref.probes)
    # the stack is gathered whole (both axes) before the stages read it
    inputs = [op for op in ledger.ops if op.stage == "parallel/inputs"]
    assert [op.operand_bytes for op in inputs][-2:] == [RAW[0].nbytes] * 2


def test_world_of_one_sweep_is_bitwise_unsharded():
    factors, returns, _, cap, invest, universe = RAW
    settings = fmt.SimulationSettings(
        returns=torch.as_tensor(returns), cap_flag=torch.as_tensor(cap),
        investability_flag=torch.as_tensor(invest),
        universe=torch.as_tensor(universe), method="equal", pct=0.3)
    cw = fmt.parallel.combo_weight_matrix(
        np.arange(6).reshape(3, 2) % dc.F, dc.F, device="cpu")
    fac = torch.as_tensor(factors)
    got = make_sharded_manager_sweep(make_mesh(("combo",), device="cpu"),
                                     combo_batch=2)(fac, cw, settings)
    want = fmt.parallel.manager_sweep(fac, cw, settings, combo_batch=2,
                                      device="cpu")
    for a, b in zip(got, want):
        assert _eq(a, b)


def test_byte_model_and_scopes_are_the_jax_package():
    for kind in ("all-reduce", "all-gather", "all-to-all"):
        for s in (1, 2, 3, 8):
            assert comms._BYTE_FACTOR[kind](s) == jax_comms._BYTE_FACTOR[
                kind](s)
    assert set(jax_comms.STAGE_SCOPES) <= set(comms.STAGE_SCOPES)
    # the outermost open known stage takes the charge
    with comms.recording() as ledger, fmt.obs.stage("composite/blend"), \
            fmt.obs.stage("not/a/scope"):
        comms.record("all-gather", "date", 100, 4, 2)
    op = ledger.ops[0]
    assert op.stage == "composite/blend"
    assert op.op_name == "composite/blend/not/a/scope"
    assert op.bytes_moved == 3 * 100 * 8
    assert ledger.totals()["by_axis"] == {"date": 2400.0}


def test_sharding_lint_flags_a_replicated_input():
    mesh = make_mesh(("factor", "date"), device="cpu")
    step, shard = make_sharded_research_step(mesh, names=dc.NAMES,
                                             window=dc.WINDOW)
    blocks = shard(*RAW)
    clean = comms.sharding_lint(step, (RAW, blocks))
    assert clean["clean"] and clean["checked_inputs"] == 6
    bad = list(blocks)
    bad[0] = torch.as_tensor(RAW[0][:, :4])
    lint = comms.sharding_lint(step, (RAW, bad))
    assert not lint["clean"] and "input 0" in lint["flags"][0]


@pytest.mark.parametrize("fn", ["hlo_text_of", "resolve", "mesh_of",
                                "parse_collectives"])
def test_hlo_readers_raise_with_the_reason(fn):
    with pytest.raises(NotImplementedError, match="compiles no HLO"):
        getattr(comms, fn)("x")


def test_plan_stages_are_the_jax_packages_and_rows_move_between_them():
    """The plan's stages are the JAX package's five, in its order; in a
    world of one a stage's rows relaid to another's, and back to the
    input block, are the operand, and a row-block hand-off has no pair."""
    from factormodeling_tpu.ops._assetspec import \
        ASSET_SORT_STAGES as JAX_STAGES
    from factormodeling_tpu_torch.parallel.mesh import (block_count,
                                                        block_index, permute)

    assert _assetspec.ASSET_SORT_STAGES == JAX_STAGES
    mesh = make_asset_mesh(("date", "assets"), device="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    for a, b in (("reshard", "gather"), ("gather", "reshard"),
                 ("auto", "auto")):
        p = AssetSpecPlan(mesh, modes={"ops/quantile": a,
                                       "backtest/weights": b})
        assert set(p.spec_table()) == set(JAX_STAGES)
        with comms.recording(mesh) as ledger:
            y = p.relayout(x, "ops/quantile", "backtest/weights", 3,
                           batch_axis="date")
            z = p.to_block(y, "backtest/weights", 3, batch_axis="date")
            axes = p.row_axes("backtest/weights", 3, "date")
            assert block_count(mesh, axes) == 1
            assert block_index(mesh, axes) == 0
            assert permute(x, mesh, axes, []) is None
        assert torch.equal(y, x) and torch.equal(z, x)
        assert all(op.bytes_moved == 0.0 for op in ledger.ops)
