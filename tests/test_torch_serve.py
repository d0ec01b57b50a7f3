"""The port's serving layer (``factormodeling_tpu_torch.serve``: the batched
tenant step and ``TenantServer``) against the JAX package's, on the CPU in
float64 with seeded numpy inputs (F=5, D=30, N=8, window 6).

- The batched step lane by lane against the JAX package's batched step
  (through its ``TenantServer``, which pads and demuxes as the port's
  does) for an ``equal`` bucket with a manager mix and a blend tilt, a
  ``linear`` bucket with ``tcost_scale`` 0, and an ``mvo_turnover``
  bucket, at ``test_torch_pipeline.py``'s tolerances: selection and
  signal 1e-10, weights 1e-6, daily P&L and summaries 1e-8, leg counts
  exact.
- The port's lanes bitwise the port's single-tenant step; ``tcost_scale``
  0 bitwise the step with costs off; the ``select_static`` shadow guard;
  the selection context built once a dispatch whatever the lane count.
- The front end: invalid configs rejected before anything is built (the
  JAX package's cases), pad lanes invisible and demux in order, one cache
  entry a bucket over a 1000-config sweep, and ``serving_stats()`` equal
  to the JAX package's over one call sequence.
- ``advance_all`` lanes against the JAX package's at the step
  tolerances, and bitwise the port's single-tenant ``online_step_parts``
  rows.
- ``mesh=`` serves (a world of one; the multi-rank server is in
  ``test_torch_distributed.py``), the obs hooks run; ``TenantServer()``
  without ``device="cpu"`` raises on a machine without a card.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from factormodeling_tpu.online import DateSlice as JaxSlice
from factormodeling_tpu.parallel import streaming as jax_streaming
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu.serve import TenantServer as JaxServer
import factormodeling_tpu_torch as fmt
from factormodeling_tpu_torch.online import DateSlice, make_online_step
from factormodeling_tpu_torch.parallel import streaming
from factormodeling_tpu_torch.serve import (TenantConfig, TenantServer,
                                            make_batched_research_step,
                                            make_tenant_research_step,
                                            stack_configs)
from factormodeling_tpu_torch.serve import batched as batched_mod
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401

F, D, N, WINDOW = 5, 30, 8, 6
NAMES = ("fam0_f0_flx", "fam0_f1_eq", "fam1_f2_flx", "fam1_f3_long",
         "fam2_f4_flx")
LADDER = (1, 4, 8)
_TURNOVER = dict(method="mvo_turnover", lookback_period=6, max_weight=0.5,
                 sim_static=(("qp_iters", 30),))
#: three configs a bucket (rung 4, one pad lane); every config of a bucket
#: shares its static key
BUCKETS = {
    "equal_mix_tilt": [
        dict(top_k=2, pct=0.3, manager_mix=np.full(F, 0.7),
             blend_tilt=np.ones(3)),
        dict(top_k=3, pct=0.2, tcost_scale=1.7,
             manager_mix=np.array([10.0, 1, 1, 1, 1]),
             blend_tilt=np.array([5.0, 1.0, 1.0])),
        dict(top_k=5, pct=0.4, tcost_scale=0.0,
             manager_mix=np.array([1.0, 0, 2, 1, 1]),
             blend_tilt=np.array([1.0, 0.0, 2.0])),
    ],
    "linear": [
        dict(method="linear", top_k=2, max_weight=0.25),
        dict(method="linear", top_k=4, icir_threshold=0.01, max_weight=0.4,
             tcost_scale=0.0),
        dict(method="linear", top_k=1, max_weight=0.3, tcost_scale=0.5),
    ],
    "mvo_turnover": [
        dict(_TURNOVER, top_k=2),
        dict(_TURNOVER, top_k=3, turnover_penalty=0.2, max_weight=0.4),
        dict(_TURNOVER, top_k=2, turnover_penalty=0.05, tcost_scale=2.0),
    ],
}


def make_market(seed=20261017):
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(F, D, N))
    factors[rng.uniform(size=factors.shape) < 0.05] = np.nan
    return dict(
        factors=factors,
        returns=rng.normal(scale=0.02, size=(D, N)),
        factor_ret=rng.normal(scale=0.01, size=(D, F)),
        cap_flag=rng.integers(1, 4, size=(D, N)).astype(float),
        investability=np.ones((D, N)),
        universe=rng.uniform(size=(D, N)) > 0.05,
    )


def cfg(**kw):
    kw.setdefault("method", "equal")
    kw.setdefault("window", WINDOW)
    kw.setdefault("icir_threshold", -1.0)
    return TenantConfig(**kw)


def jax_cfg(c: TenantConfig) -> JaxTenant:
    return JaxTenant(**{f.name: getattr(c, f.name)
                        for f in dataclasses.fields(c)})


def panels(market):
    return tuple(torch.from_numpy(np.asarray(market[k])) for k in
                 ("factors", "returns", "factor_ret", "cap_flag",
                  "investability", "universe"))


@pytest.fixture(scope="module")
def market():
    return make_market()


@pytest.fixture(scope="module")
def port_server(market):
    return TenantServer(names=NAMES, pad_ladder=LADDER, device="cpu",
                        **market)


@pytest.fixture(scope="module")
def jax_outputs(market):
    """The JAX package's lanes for each bucket, served once for the
    module (one compiled executable a bucket at rung 4)."""
    server = JaxServer(names=NAMES, pad_ladder=LADDER, **market)
    cache = {}

    def get(bucket):
        if bucket not in cache:
            res = server.serve([jax_cfg(cfg(**kw)) for kw in BUCKETS[bucket]])
            cache[bucket] = [jax.tree_util.tree_map(np.asarray, r.output)
                             for r in res]
        return cache[bucket]

    return get


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, equal_nan=True, err_msg=what)


# ------------------------------------------------ the batched step vs JAX


@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_batched_lanes_match_jax(port_server, jax_outputs, bucket):
    configs = [cfg(**kw) for kw in BUCKETS[bucket]]
    got = port_server.serve(configs)
    want = jax_outputs(bucket)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        o = g.output
        tag = f"{bucket}[{i}]"
        assert w.selection.sum() > 0, tag
        _close(o.selection, w.selection, 1e-10, tag + " selection")
        _close(o.signal, w.signal, 1e-10, tag + " signal")
        _close(o.sim.weights, w.sim.weights, 1e-6, tag + " weights")
        _close(o.sim.result.log_return, w.sim.result.log_return, 1e-8,
               tag + " log_return")
        np.testing.assert_array_equal(o.sim.long_count.numpy(),
                                      w.sim.long_count, tag)
        np.testing.assert_array_equal(o.sim.short_count.numpy(),
                                      w.sim.short_count, tag)
        for field in o.summary._fields:
            _close(getattr(o.summary, field), getattr(w.summary, field),
                   1e-8, f"{tag} summary.{field}")


def _leaves_equal(a, b):
    from factormodeling_tpu_torch.resil.checkpoint import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (np.asarray(x).tobytes() == np.asarray(y).tobytes()
                and np.shape(x) == np.shape(y))


@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_lanes_bitwise_single_tenant_step(market, port_server, bucket):
    """Each lane is the port's single-tenant step for its config, to the
    bit (the batched step shares the context; the tenant body is the
    same)."""
    configs = [cfg(**kw) for kw in BUCKETS[bucket]]
    served = port_server.serve(configs)
    step = make_tenant_research_step(names=NAMES, template=configs[0])
    for c, r in zip(configs, served):
        one = step(c.normalized(F, 3), *panels(market))
        _leaves_equal(r.output, one)


def test_tcost_scale_zero_equals_costs_off(market, port_server):
    res = port_server.serve([cfg(top_k=2, tcost_scale=0.0)])[0]
    ref = fmt.build_research_step(
        names=NAMES, window=WINDOW,
        select_kwargs=dict(top_x=2, icir_threshold=-1.0),
        sim_kwargs=dict(method="equal", transaction_cost=False),
        device="cpu")(*panels(market))
    assert torch.equal(res.output.sim.result.log_return.nan_to_num(),
                       ref.sim.result.log_return.nan_to_num())


@pytest.mark.parametrize("key", ["top_x", "icir_threshold", "use_rank_icir"])
def test_select_static_shadow_guard(key):
    with pytest.raises(ValueError, match="shadows"):
        make_batched_research_step(
            names=NAMES, template=TenantConfig(select_static={key: 3}))


@pytest.mark.parametrize("c", [1, 5, 12])
def test_selection_context_once_per_dispatch(market, monkeypatch, c):
    """One context a dispatch however many lanes: the port's counterpart
    of the JAX package's vmap hoist, counted at build_selection_context."""
    calls = []
    real = batched_mod.build_selection_context

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(batched_mod, "build_selection_context", counting)
    configs = [cfg(top_k=1 + i % F, pct=0.1 + 0.02 * i).normalized(F, 3)
               for i in range(c)]
    step = make_batched_research_step(names=NAMES, template=configs[0])
    out = step(stack_configs(configs), *panels(market))
    assert len(calls) == 1 and out.selection.shape == (c, D, F)
    server = TenantServer(names=NAMES, pad_ladder=(1, 64), device="cpu",
                          **market)
    server.serve(configs)
    assert len(calls) == 2


# --------------------------------------------------------- the front end


@pytest.mark.parametrize("bad, match", [
    (dict(top_k=0), "top_k"),
    (dict(top_k=F + 1), "top_k"),
    (dict(top_k=2.5), "integer"),
    (dict(pct=0.0), "pct"),
    (dict(pct=1.5), "pct"),
    (dict(max_weight=np.nan), "max_weight"),
    (dict(tcost_scale=-0.1), "tcost_scale"),
    (dict(shrinkage_intensity=2.0), "shrinkage_intensity"),
    (dict(manager_mix=np.zeros(F)), "manager_mix"),
    (dict(manager_mix=np.ones(F - 1)), "manager_mix"),
    (dict(blend_tilt=-np.ones(3)), "blend_tilt"),
    (dict(window=D + 5), "window"),
])
def test_invalid_config_is_rejected_before_anything_runs(market, monkeypatch,
                                                         bad, match):
    """The JAX package's cases: a clear ValueError at the front end, and
    nothing built or run (no cache entry, no context)."""
    def never(*a, **kw):
        raise AssertionError("the context was built for a rejected config")

    monkeypatch.setattr(batched_mod, "build_selection_context", never)
    server = TenantServer(names=NAMES, pad_ladder=LADDER, device="cpu",
                          **market)
    cache0 = streaming.streaming_cache_stats()
    kw = dict(top_k=2, method="equal", window=WINDOW)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        server.serve([cfg(top_k=1), TenantConfig(**kw)])
    cache1 = streaming.streaming_cache_stats()
    assert (cache1["misses"], cache1["hits"]) == (cache0["misses"],
                                                  cache0["hits"])
    assert server.serving_stats()["dispatch_executions"] == 0


def test_pad_lanes_are_invisible_and_demux_preserves_order(market,
                                                           monkeypatch):
    """A config's result does not depend on its co-submissions, demux
    reorders across buckets, and the pad lanes are never computed (the
    tenant body runs once a dispatch, on its real lanes) but are
    tallied."""
    server = TenantServer(names=NAMES, pad_ladder=LADDER, device="cpu",
                          **market)
    trio = [cfg(top_k=1 + i, pct=0.1 + 0.05 * i) for i in range(3)]
    filler = [cfg(top_k=1 + i % F, method="linear", max_weight=0.2)
              for i in range(5)]
    alone = server.serve(trio)
    bodies = []
    real = batched_mod._make_parts

    def counting_parts(names, template):
        build_ctx, body = real(names, template)

        def counted(*a, **kw):
            bodies.append(batched_mod.lane_count(a[0]))
            return body(*a, **kw)

        return build_ctx, counted

    monkeypatch.setattr(batched_mod, "_make_parts", counting_parts)
    streaming.clear_streaming_cache()   # rebuild through the counting parts
    mixed = server.serve([filler[0], trio[0], filler[1], trio[1],
                          filler[2], trio[2], filler[3], filler[4]])
    # one body a dispatch (rungs 4 and 8) on its 3 and 5 real lanes: the 1
    # and 3 pad lanes are skipped
    assert sorted(bodies) == [3, 5]
    for j, pos in enumerate((1, 3, 5)):
        assert mixed[pos].index == pos and mixed[pos].config is trio[j]
        _leaves_equal(alone[j].output, mixed[pos].output)
    stats = server.serving_stats()
    assert stats["padded_lanes"] == 1 + 1 + 3
    assert stats["configs_served"] == 11


def test_thousand_config_sweep_occupies_one_entry_per_bucket(market):
    server = TenantServer(names=NAMES, device="cpu", **market)
    cache0 = streaming.streaming_cache_stats()
    configs = [cfg(top_k=1 + i % F, pct=0.1 + 0.02 * (i % 5),
                   tcost_scale=0.5 + 0.1 * (i % 4),
                   window=WINDOW + (i % 2))     # two buckets
               for i in range(1000)]
    results = server.serve(configs)
    assert [r.index for r in results] == list(range(1000))
    cache1 = streaming.streaming_cache_stats()
    assert cache1["size"] - cache0["size"] == 2
    assert cache1["misses"] - cache0["misses"] == 2
    assert cache1["evictions"] == cache0["evictions"]
    stats = server.serving_stats()
    assert (stats["bucket_count"], stats["executables"],
            stats["logical_dispatches"]) == (2, 2, 2)
    assert stats["padded_lanes"] == 2 * (512 - 500)
    assert stats["kernel_cache"]["capacity"] == 16


def test_serving_stats_equal_jax_over_one_call_sequence(market):
    """Both caches cleared, one call sequence on each package's server:
    every field of serving_stats() equal, the cache counters included."""
    seq = [[cfg(top_k=1 + i) for i in range(3)],
           [cfg(top_k=2), cfg(top_k=3, method="linear", max_weight=0.3),
            cfg(top_k=4, pct=0.2)],
           [cfg(top_k=5 - i) for i in range(3)]]
    stats = {}
    for pkg, server_cls, clear, conv, kw in (
            ("port", TenantServer, streaming.clear_streaming_cache,
             lambda c: c, dict(device="cpu")),
            ("jax", JaxServer, jax_streaming.clear_streaming_cache,
             jax_cfg, {})):
        clear()
        server = server_cls(names=NAMES, pad_ladder=LADDER, **market, **kw)
        for batch in seq:
            server.serve([conv(c) for c in batch])
        with pytest.raises(ValueError):
            server.serve([conv(cfg(top_k=9))])
        stats[pkg] = server.serving_stats()
        clear()
    assert stats["port"] == stats["jax"]
    assert (stats["port"]["bucket_count"], stats["port"]["executables"],
            stats["port"]["kernel_cache"]["hits"]) == (2, 2, 2)


def test_panels_fingerprint_equals_jax(market, port_server):
    jserver = JaxServer(names=NAMES, pad_ladder=LADDER, **market)
    assert port_server.panels_fingerprint() == jserver.panels_fingerprint()
    other = dict(market, returns=market["returns"] + 1e-9)
    assert TenantServer(names=NAMES, device="cpu",
                        **other).panels_fingerprint() != \
        port_server.panels_fingerprint()


# ----------------------------------------------------- the online advance


def _slices(market, cls):
    return [cls(factors=market["factors"][:, t],
                returns=market["returns"][t],
                factor_ret=market["factor_ret"][t],
                cap_flag=market["cap_flag"][t],
                investability=market["investability"][t],
                universe=market["universe"][t]) for t in range(D)]


ONLINE = [cfg(**BUCKETS["mvo_turnover"][0]),
          cfg(top_k=3, pct=0.2, manager_mix=np.full(F, 0.5),
              blend_tilt=np.array([1.0, 2.0, 1.0])),
          cfg(**BUCKETS["mvo_turnover"][1])]
_ROW_TOL = {"selection": 1e-10, "signal": 1e-10, "weights": 1e-6,
            "log_return": 1e-8, "turnover": 1e-8}


@pytest.fixture(scope="module")
def advanced(market):
    """Both packages' advance_all over every date: the port's rows and
    the JAX package's, lane by lane."""
    port = TenantServer(names=NAMES, pad_ladder=LADDER, device="cpu",
                        **market)
    jserver = JaxServer(names=NAMES, pad_ladder=LADDER, **market)
    port.online_begin(ONLINE)
    jserver.online_begin([jax_cfg(c) for c in ONLINE])
    rows = {"port": [], "jax": []}
    for ps, js in zip(_slices(market, DateSlice), _slices(market, JaxSlice)):
        rows["port"].append([a.output for a in port.advance_all(ps)])
        rows["jax"].append([jax.tree_util.tree_map(np.asarray, a.output)
                            for a in jserver.advance_all(js)])
    return port, rows


def test_advance_all_lanes_match_jax(advanced):
    port, rows = advanced
    ready = 0
    for t, (p_row, j_row) in enumerate(zip(rows["port"], rows["jax"])):
        for lane, (p, j) in enumerate(zip(p_row, j_row)):
            assert bool(p.ready) == bool(j.ready), (t, lane)
            if not p.ready:
                continue
            ready += 1
            for key, tol in _ROW_TOL.items():
                _close(getattr(p, key), getattr(j, key), tol,
                       f"date {t} lane {lane} {key}")
            assert int(p.long_count) == int(j.long_count), (t, lane)
    assert ready == 3 * (D - 1)
    stats = port.serving_stats()
    # two buckets (the turnover pair in rung 4, the equal tenant in rung 1)
    assert stats["logical_dispatches"] == 2 * D
    assert stats["padded_lanes"] == 2 * D


def test_advance_all_lanes_bitwise_single_tenant_rows(market, advanced):
    _, rows = advanced
    for lane, c in enumerate(ONLINE):
        init, adv = make_online_step(names=NAMES, template=c, n_assets=N,
                                     has_universe=True, device="cpu")
        mstate, tstate = init()
        norm = c.normalized(F, 3)
        for t, s in enumerate(_slices(market, DateSlice)):
            (mstate, tstate), o = adv(norm, mstate, tstate, s)
            _leaves_equal(rows["port"][t][lane], o)


# ------------------------------------------------- unported and card-only


def _advance_hooked(server, **hook):
    """One ``advance_all`` with an obs hook on; returns the hook."""
    server.online_begin([cfg(top_k=1)])
    server.advance_all(_slices(server._market, DateSlice)[0], **hook)
    return next(iter(hook.values()))


def _meter():
    from factormodeling_tpu_torch.obs.metering import CostMeter

    return CostMeter()


def _series():
    from factormodeling_tpu_torch.obs.reqtrace import HealthSeries

    return HealthSeries()


def _meshed_serve(server):
    """One config served over a ``("configs", "assets")`` world of one,
    beside the unsharded server's lane."""
    from factormodeling_tpu_torch.parallel import make_mesh, release_world

    try:
        meshed = TenantServer(names=NAMES, pad_ladder=LADDER,
                              mesh=make_mesh(("configs", "assets"),
                                             device="cpu"), **server._market)
        return (meshed.serve([cfg(top_k=1)]), server.serve([cfg(top_k=1)]),
                meshed.serving_stats()["mesh_shape"])
    finally:
        release_world()


def _same_lane(got, want) -> bool:
    return all(torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))
               for a, b in zip(got, want)
               for x, y in ((a.output.signal, b.output.signal),
                            (a.output.sim.weights, b.output.sim.weights)))


# the serving hooks are ported: the mesh serves and each other hook runs
# and records (its differential against the JAX package is in the
# test_torch_obs_* files; the multi-rank mesh in test_torch_distributed.py)
@pytest.mark.parametrize("call,check", [
    (_meshed_serve,
     lambda r: (len(r[0]) == 1 and _same_lane(r[0], r[1])
                and r[2] == {"configs": 1, "assets": 1})),
    (lambda s: s.serve([cfg(top_k=1)], lineage=True),
     lambda r: len(r) == 1),
    (lambda s: s.serve_queued([], flight=True),
     lambda r: r.flight is not None and r.flight.rows("q")),
    (lambda s: s.serve_queued([], lineage=True),
     lambda r: r.lineage is not None),
    (lambda s: s.serve_queued([], sentry=True),
     lambda r: r.sentry is not None),
    (lambda s: _advance_hooked(s, meter=_meter()),
     lambda m: len(m.accounts) == 1),
    (lambda s: _advance_hooked(s, series=_series()),
     lambda h: h.count == 1),
], ids=["mesh", "lineage", "flight", "queue_lineage", "sentry", "meter",
        "series"])
def test_unported_hooks_raise(market, call, check):
    server = TenantServer(names=NAMES, device="cpu", **market)
    server._market = market
    assert check(call(server))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a card")
def test_server_defaults_to_the_card(market):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TenantServer(names=NAMES, **market)
