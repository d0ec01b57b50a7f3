"""The online advance's stages and its asset-sharded form in one process
(a world of one over ``gloo`` on the CPU), in float64.

- One ready advance opens exactly the JAX package's seven ``online/*``
  stages in its order: the port's read from the ``torch.profiler`` ranges
  ``obs.stage`` opens, the JAX package's recorded while its advance is
  traced (``jax.jit(...).lower``), for the equal, the turnover and the
  risk-model schemes.
- ``make_online_step(mesh=)`` on a world of one is bitwise the unsharded
  advance in every layout mode (P&L scalars included: one asset block's
  partial sums are the sums), for the JAX package's online ladder and the
  risk model; its collectives all lie under the ``online/*`` stages, the
  unsharded advance issues none, and the stages are known ledger scopes.
- An asset axis that does not divide ``N`` raises the server's error
  text, from the advance and from the placement.

The 2- and 4-rank worlds are ``tests/test_torch_distributed.py``'s.
"""

import contextlib

import jax
import jax.numpy as jnp
import pytest
import torch

from factormodeling_tpu_torch.obs import comms
from factormodeling_tpu_torch.online import DateSlice, make_online_step
from factormodeling_tpu_torch.online.advance import ONLINE_STAGES
from factormodeling_tpu_torch.online.state import shard_online_state
from factormodeling_tpu_torch.parallel import (AssetSpecPlan,
                                               make_asset_mesh,
                                               release_world)
from factormodeling_tpu_torch.parallel import _dist_check as dc
from factormodeling_tpu_torch.serve import TenantConfig
from tests.torch_threads import torch_one_thread  # noqa: F401

F = len(dc.ONLINE_NAMES)
METHODS = ("equal", "linear", "mvo", "mvo_turnover", "risk")


@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    yield
    release_world()


def _template(method):
    return TenantConfig(**dc.online_config(method)).normalized(F, 2)


def _slices(ragged=True):
    raw = dc.online_market(ragged)
    return [DateSlice(raw[0][:, t], raw[1][t], raw[2][t], raw[3][t],
                      raw[4][t], raw[5][t]) for t in range(dc.ONLINE_D)]


def _jax_stage_order(method):
    """The stage names the JAX package's advance opens, in order, recorded
    while ``jax.jit`` traces it (its readiness is traced, so every stage
    is opened)."""
    import factormodeling_tpu.online.advance as jadv
    from factormodeling_tpu.online.state import DateSlice as JaxSlice
    from factormodeling_tpu.serve.tenant import TenantConfig as JaxCfg

    template = JaxCfg(**dc.online_config(method)).normalized(F, 2)
    init_fn, advance_fn = jadv.make_online_step(
        names=dc.ONLINE_NAMES, template=template, n_assets=dc.ONLINE_N,
        has_universe=True, stats_tail=8)
    mstate, tstate = init_fn()
    ds = JaxSlice(*(jnp.asarray(a) for a in _slices()[1]))
    opened, stage = [], jadv.obs_stage

    @contextlib.contextmanager
    def recording(name):
        opened.append(name)
        with stage(name):
            yield

    jadv.obs_stage = recording
    try:
        jax.jit(advance_fn).lower(template, mstate, tstate, ds)
    finally:
        jadv.obs_stage = stage
    return [n for n in opened if n.startswith("online/")]


@pytest.mark.parametrize("method", ["equal", "mvo_turnover", "risk"])
def test_a_ready_advance_opens_the_jax_packages_seven_stages(method):
    tmpl = _template(method)
    init, adv = make_online_step(names=dc.ONLINE_NAMES, template=tmpl,
                                 n_assets=dc.ONLINE_N, has_universe=True,
                                 device="cpu")
    mstate, tstate = init()
    slices = _slices()
    (mstate, tstate), out = adv(tmpl, mstate, tstate, slices[0])
    assert not out.ready
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (mstate, tstate), out = adv(tmpl, mstate, tstate, slices[1])
    assert out.ready
    ranges = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name.startswith("online/"))
    opened = [name for _, name in ranges]
    assert opened == list(ONLINE_STAGES)
    assert opened == _jax_stage_order(method)


def _run(tmpl, slices, **kw):
    init, adv = make_online_step(names=dc.ONLINE_NAMES, template=tmpl,
                                 n_assets=dc.ONLINE_N, has_universe=True,
                                 device="cpu", **kw)
    mstate, tstate = init()
    sharded = "mesh" in kw
    outs, ops = [], []
    for ds in slices:
        if sharded:
            ds = adv.shard_date_slice(ds)
        with comms.recording(kw.get("mesh")) as ledger:
            (mstate, tstate), out = adv(tmpl, mstate, tstate, ds)
        ops += ledger.ops
        outs.append(adv.gather_outputs(out) if sharded else out)
    return outs, ops, (mstate, tstate)


def _bitwise(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(torch.nan_to_num(a.double(), 7.0),
                           torch.nan_to_num(b.double(), 7.0))
    return a == b


@pytest.mark.parametrize("method", METHODS)
def test_world_of_one_sharded_advance_is_bitwise_unsharded(method):
    tmpl = _template(method)
    for market in (False, True):
        slices = _slices(market)
        plain, ops, _ = _run(tmpl, slices)
        assert ops == []
        mesh = make_asset_mesh(device="cpu")
        for mode in dc.MODES:
            got, ops, (mstate, tstate) = _run(
                tmpl, slices, mesh=mesh,
                plan=AssetSpecPlan(mesh, default=mode))
            for t, (a, b) in enumerate(zip(plain, got)):
                for k in a._fields:
                    assert _bitwise(getattr(a, k), getattr(b, k)), \
                        (mode, t, k)
            assert ops and {op.stage for op in ops} <= set(ONLINE_STAGES)
            assert {op.stage for op in ops} >= {
                "online/daily_stats", "online/blend", "online/solve",
                "online/shift_pnl"}
            assert mstate.factors_tail.shape == (F, 8, dc.ONLINE_N)


def test_online_stages_are_known_ledger_scopes():
    assert set(ONLINE_STAGES) <= set(comms.STAGE_SCOPES)
    # the outermost known scope charges a collective inside the advance
    assert comms._stage_of(("online/daily_stats", "selection/daily_stats",
                            "metrics/rank_ic"), comms.STAGE_SCOPES) == \
        "online/daily_stats"


class _ThreeRanks:
    """A stand-in mesh whose asset axis has three ranks (only its shape
    is read before the check raises)."""

    mesh_dim_names = ("assets",)
    shape = (3,)
    device_type = "cpu"


def test_an_asset_axis_that_does_not_divide_n_raises_the_servers_error():
    with pytest.raises(ValueError) as online:
        make_online_step(names=dc.ONLINE_NAMES, template=_template("equal"),
                         n_assets=dc.ONLINE_N, mesh=_ThreeRanks())
    want = (f"{dc.ONLINE_N} assets are not divisible by the mesh's "
            f"'assets' axis (3); pad the asset axis or pick a mesh whose "
            f"asset axis divides N")
    assert str(online.value) == want
    with pytest.raises(ValueError) as state:
        shard_online_state(_slices()[0], _ThreeRanks())
    assert str(state.value) == want
