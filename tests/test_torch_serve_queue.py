"""The port's serving traffic layer (``serve/queue.py``,
``serve/admission.py``) against the JAX package's, on the CPU in float64
(F=5, D=30, N=8, window 6, the JAX queue tests' market shape).

- With the virtual clock, a constant service model and the host-drawn
  ``DispatchFaultPlan``, scheduling is deterministic in both packages:
  ``QueueResult.log_lines()`` equal line for line to the JAX queue's on a
  Poisson trace with faults, a bursty overload with faults and an invalid
  config, and a two-bucket bursty overload through the stale and cheap
  ladder steps; the served outputs within the step tolerances of
  ``test_torch_pipeline.py`` (selection 1e-10, weights 1e-6); the arrival
  traces equal to the JAX package's to the bit.
- The JAX queue tests' cases on the port: ladder validation, guards,
  shedding with its reason, FAILED and DEADLINE_MISS, rung downgrades,
  the estimator, the stale cache (bitwise and marked, also from a
  restored snapshot), the cheap fallback, the p99 trigger, the
  checkpoint resume byte-equal in its verdict log and a different trace
  refused, replay byte-equal, the report rows, and the execution count
  over the logical one equal to the poisoned attempts.
- The elision contract in a child interpreter: ``import
  factormodeling_tpu_torch.serve`` and a synchronous ``serve`` load
  neither ``queue`` nor ``admission`` (both blocked), and no JAX.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from factormodeling_tpu.resil import DispatchFaultPlan as JaxFaultPlan
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu.serve import TenantServer as JaxServer
from factormodeling_tpu.serve import queue as jax_queue
from factormodeling_tpu.serve.admission import (
    AdmissionPolicy as JaxAdmission)
from factormodeling_tpu_torch import obs
from factormodeling_tpu_torch.obs.latency import LatencyRecorder
from factormodeling_tpu_torch.resil import DispatchFaultPlan
from factormodeling_tpu_torch.serve import TenantConfig, TenantServer
from factormodeling_tpu_torch.serve.admission import (AdmissionPolicy,
                                                      StaleCache)
from factormodeling_tpu_torch.serve.queue import (
    DEADLINE_MISS,
    FAILED,
    SERVED,
    SHED,
    DispatchEstimator,
    Request,
    VirtualClock,
    bursty_arrivals,
    make_requests,
    poisson_arrivals,
    replay_traffic,
)
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

F, D, N, WINDOW = 5, 30, 8, 6
NAMES = ("fam0_f0_flx", "fam0_f1_eq", "fam1_f2_flx", "fam1_f3_long",
         "fam2_f4_flx")
LADDER = (1, 4, 8)
SERVICE = 0.05


def make_market(seed=20260804):
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


@pytest.fixture(scope="module")
def market():
    return make_market()


def mk_server(market, **kw):
    kw.setdefault("pad_ladder", LADDER)
    return TenantServer(names=NAMES, device="cpu", **market, **kw)


def equal_cfg(i=0, **kw):
    kw.setdefault("method", "equal")
    kw.setdefault("window", WINDOW)
    kw.setdefault("icir_threshold", -1.0)
    kw.setdefault("top_k", 1 + i % F)
    return TenantConfig(**kw)


def linear_cfg(i=0, **kw):
    kw.setdefault("max_weight", 0.3)
    return equal_cfg(i, method="linear", **kw)


def const_service(_tag, _rung):
    return SERVICE


def _weights(out):
    return np.nan_to_num(np.asarray(out.sim.weights))


# --------------------------------------- the verdict log against JAX's


def _trace(name):
    """(configs, arrivals, deadline_s, queue kwargs without the fault
    plan, fault plan kwargs) of one traffic case."""
    if name == "poisson":
        cfgs = [equal_cfg(i, pct=0.1 + 0.02 * (i % 3)) for i in range(48)]
        return (cfgs, poisson_arrivals(48, rate_hz=0.8 * LADDER[-1] / SERVICE,
                                       seed=31), 0.3,
                dict(admission=dict(max_depth=8)),
                dict(seed=3, error_rate=0.1, poison_rate=0.1))
    if name == "bursty_faults":
        cfgs = [equal_cfg(i, pct=0.1 + 0.02 * (i % 3)) for i in range(24)]
        cfgs[5] = TenantConfig(top_k=2, window=D + 5)   # FAILED: rejected
        return (cfgs, bursty_arrivals(24, rate_hz=1.5 * LADDER[-1] / SERVICE,
                                      burst=5, seed=7), 0.6,
                dict(admission=dict(max_depth=10)),
                dict(seed=1, error_rate=0.25, poison_rate=0.15))
    # two buckets under overload: stale hits, cheap fallbacks, late
    # answers and failed dispatches all happen
    cfgs = [linear_cfg(i) if i % 3 == 0 else equal_cfg(i % 4)
            for i in range(48)]
    return (cfgs, bursty_arrivals(48, rate_hz=LADDER[-1] / SERVICE,
                                  burst=6, seed=5), 0.4,
            dict(admission=dict(max_depth=4, ladder=(
                "serve_stale", "cheap_fallback", "reject_new"))),
            dict(seed=4, error_rate=0.1, poison_rate=0.1))


TRACES = ("poisson", "bursty_faults", "bursty_ladder")


@pytest.fixture(scope="module")
def jax_runs(market):
    """The JAX queue's result for each trace, one JAX server for the
    module (each (bucket, rung) compiled once)."""
    server = JaxServer(names=NAMES, pad_ladder=LADDER, **market)
    cache = {}

    def get(name):
        if name not in cache:
            cfgs, arrivals, deadline, kw, faults = _trace(name)
            jcfgs = [JaxTenant(**{f.name: getattr(c, f.name)
                                  for f in dataclasses.fields(c)})
                     for c in cfgs]
            cache[name] = server.serve_queued(
                jax_queue.make_requests(jcfgs, arrivals,
                                        deadline_s=deadline),
                admission=JaxAdmission(**kw["admission"]),
                service_model=const_service,
                fault_plan=JaxFaultPlan(**faults), retries=2)
        return cache[name]

    return get


def _port_run(market, name, **extra):
    cfgs, arrivals, deadline, kw, faults = _trace(name)
    server = mk_server(market)
    res = server.serve_queued(
        make_requests(cfgs, arrivals, deadline_s=deadline),
        admission=AdmissionPolicy(**kw["admission"]),
        service_model=const_service,
        fault_plan=DispatchFaultPlan(**faults), retries=2, **extra)
    return server, cfgs, res


@pytest.mark.parametrize("name", TRACES)
def test_verdict_log_equals_jax_line_for_line(market, jax_runs, name):
    server, cfgs, res = _port_run(market, name)
    want = jax_runs(name)
    assert res.log_lines() == want.log_lines()
    assert res.counters == want.counters
    c = res.counters
    assert (c["served"] + c["shed_count"] + c["deadline_miss_count"]
            + c["failed_count"]) == len(cfgs)
    assert c["dispatch_faults"] > 0 and c["shed_count"] > 0
    if name == "bursty_ladder":
        assert (c["stale_served"] and c["cheap_fallbacks"]
                and c["deadline_miss_count"] and c["failed_count"])
    # served outputs (on time and late) at the step tolerances
    assert sorted(res.outputs) == sorted(want.outputs)
    for rid, out in res.outputs.items():
        ref = want.outputs[rid]
        np.testing.assert_allclose(np.asarray(out.selection),
                                   np.asarray(ref.selection), atol=1e-10,
                                   rtol=0, err_msg=f"rid {rid}")
        np.testing.assert_allclose(_weights(out), _weights(ref), atol=1e-6,
                                   rtol=0, err_msg=f"rid {rid}")
    # the step ran once a delivered dispatch and once a poisoned attempt
    # (discarded after it ran); an error attempt never reached it. A
    # dispatch makes one attempt and one more a retry
    plan = DispatchFaultPlan(**_trace(name)[4])
    stats = server.serving_stats()
    poisoned = sum(plan.roll(k) == "dispatch_poison"
                   for k in range(c["dispatches"] + c["retry_count"]))
    failed = {v["dispatch"] for v in res.verdicts
              if v["verdict"] == FAILED and v["dispatch"] is not None}
    assert stats["logical_dispatches"] == c["dispatches"]
    assert (stats["dispatch_executions"]
            == c["dispatches"] - len(failed) + poisoned)


@pytest.mark.parametrize("seed", [0, 7, 31])
def test_arrival_traces_equal_jax_to_the_bit(seed):
    for fn, jfn, kw in ((poisson_arrivals, jax_queue.poisson_arrivals, {}),
                        (bursty_arrivals, jax_queue.bursty_arrivals,
                         dict(burst=5))):
        a = fn(40, rate_hz=12.5, seed=seed, **kw)
        assert a.tobytes() == jfn(40, rate_hz=12.5, seed=seed, **kw).tobytes()
        assert a.tobytes() == fn(40, rate_hz=12.5, seed=seed, **kw).tobytes()
        assert np.all(np.diff(a) >= 0) and a[0] > 0
    assert not np.array_equal(poisson_arrivals(8, rate_hz=1.0, seed=seed),
                              bursty_arrivals(8, rate_hz=1.0, burst=1,
                                              seed=seed))
    b = bursty_arrivals(12, rate_hz=2.0, burst=4, seed=seed)
    assert len(np.unique(b)) == 3


# ------------------------------------------------------ guards and ladder


@pytest.mark.parametrize("bad", [
    (), (0, 8), (-1, 4), (8, 8), (8, 4), (1, 4.5, 8),
])
def test_pad_ladder_rejected_at_construction(market, bad):
    with pytest.raises(ValueError, match="pad_ladder"):
        mk_server(market, pad_ladder=bad)


def test_pad_ladder_valid_ascending_accepted(market):
    assert mk_server(market, pad_ladder=(2, 16)).pad_ladder == (2, 16)


def test_request_and_clock_guards():
    with pytest.raises(ValueError, match="deadline"):
        Request(0, equal_cfg(), 1.0, 1.0)
    with pytest.raises(ValueError, match="tenant"):
        Request(0, equal_cfg(), 0.0, 1.0, tenant="")
    with pytest.raises(ValueError, match="arrival"):
        make_requests([equal_cfg()], [0.0, 1.0], deadline_s=1.0)
    clk = VirtualClock()
    with pytest.raises(ValueError, match="advance"):
        clk.advance(-0.1)
    clk.advance_to(2.0)
    clk.advance_to(1.0)  # never rewinds
    assert clk.now_s == 2.0


def test_shed_verdicts_carry_reason_and_depth_bound_holds(market):
    server = mk_server(market)
    res = server.serve_queued(
        make_requests([equal_cfg(i) for i in range(12)], np.zeros(12),
                      deadline_s=1.0),
        admission=AdmissionPolicy(max_depth=4), service_model=const_service)
    shed = [v for v in res.verdicts if v["verdict"] == SHED]
    assert len(shed) == 8 and all(v["detail"] == "queue_depth"
                                  for v in shed)
    assert res.counters["served"] == 4


def test_failed_and_deadline_miss_semantics(market):
    server = mk_server(market)
    res = server.serve_queued(
        [Request(0, equal_cfg(), 0.0, 10.0)], service_model=const_service,
        fault_plan=DispatchFaultPlan(seed=0, error_rate=1.0), retries=2)
    v = res.by_rid()[0]
    assert v["verdict"] == FAILED and "dispatch_error" in v["detail"]
    assert res.counters["retry_count"] == 2 and 0 not in res.outputs
    res = server.serve_queued([Request(0, equal_cfg(), 0.0, 0.5)],
                              service_model=lambda _t, _r: 1.0)
    v = res.by_rid()[0]
    assert v["verdict"] == DEADLINE_MISS and 0 in res.outputs
    res = server.serve_queued(
        [Request(0, TenantConfig(top_k=2, window=D + 5), 0.0, 1.0),
         Request(1, equal_cfg(), 0.0, 1.0)], service_model=const_service)
    assert res.by_rid()[0]["verdict"] == FAILED
    assert "window" in res.by_rid()[0]["detail"]
    assert res.by_rid()[1]["verdict"] == SERVED


def test_rung_downgrade_under_deadline_pressure(market):
    server = mk_server(market, pad_ladder=(1, 4, 8, 64))
    cfgs = [equal_cfg(i) for i in range(9)]  # occupancy rung = 64
    tag = repr(server._normalize(cfgs[0]).static_key())
    est = DispatchEstimator(default_s=0.01)
    est.seed(tag, 64, 10.0)   # the big rung cannot meet any deadline
    for r in (8, 4, 1):
        est.seed(tag, r, 0.01)
    res = server.serve_queued(
        make_requests(cfgs, np.zeros(9), deadline_s=1.0),
        admission=AdmissionPolicy(max_depth=None), estimator=est,
        service_model=lambda _t, _r: 0.01)
    assert res.counters["rung_downgrades"] >= 1
    assert res.counters["served"] == 9
    assert res.counters["deadline_miss_count"] == 0
    assert any(v["rung"] in (4, 8) for v in res.verdicts)


def test_downgraded_chunk_serves_the_most_urgent_request(market):
    server = mk_server(market)
    cfg = equal_cfg(1)
    skey = server._normalize(cfg).static_key()
    est = DispatchEstimator()
    est.seed(repr(skey), 4, 10.0)
    est.seed(repr(skey), 1, 0.01)
    res = server.serve_queued(
        [Request(0, cfg, 0.0, 100.0), Request(1, cfg, 0.0, 1.0)],
        admission=AdmissionPolicy(max_depth=None), estimator=est,
        service_model=lambda _t, _r: 0.01)
    by = res.by_rid()
    assert by[0]["verdict"] == SERVED and by[1]["verdict"] == SERVED
    assert by[1]["dispatch"] == 0 and by[0]["dispatch"] == 1
    assert res.counters["rung_downgrades"] >= 1


def test_estimator_seeds_from_latency_sketches(market):
    server = mk_server(market)
    cfgs = [equal_cfg(i) for i in range(3)]  # occupancy rung = 4
    skey = server._normalize(cfgs[0]).static_key()
    rec = LatencyRecorder()
    for _ in range(5):
        rec.observe(server.entry_name(skey, 4), 10.0)  # rung 4 is "slow"
        rec.observe(server.entry_name(skey, 1), 0.01)
    res = server.serve_queued(
        make_requests(cfgs, np.zeros(3), deadline_s=1.0),
        admission=AdmissionPolicy(max_depth=None), seed_latency=rec,
        service_model=lambda _t, _r: 0.01)
    assert res.counters["rung_downgrades"] >= 1
    assert res.counters["served"] == 3


def test_dispatch_estimator_ewma_fallbacks_and_state_roundtrip():
    est = DispatchEstimator(alpha=0.5, default_s=0.2, lane_cost_s=0.01)
    assert est.estimate("b", 8) == pytest.approx(0.2 + 0.08)
    est.observe("b", 8, 1.0)
    assert est.estimate("b", 8) == 1.0
    est.observe("b", 8, 0.0)
    assert est.estimate("b", 8) == 0.5  # EWMA
    assert est.estimate("b", 4) == 0.5  # nearest known rung
    assert est.estimate("other", 4) == pytest.approx(0.2 + 0.04)
    est.seed("b", 8, 99.0)
    assert est.estimate("b", 8) == 0.5
    est.seed("c", 1, 7.0)
    est.observe("c", 1, 1.0)
    assert est.estimate("c", 1) == 1.0
    rt = DispatchEstimator(alpha=0.5)
    rt.load_state(est.state())
    assert rt.estimate("b", 8) == 0.5
    rt.observe("b", 8, 1.5)
    assert rt.estimate("b", 8) == 1.0


def test_serve_stale_is_bitwise_and_marked(market):
    server = mk_server(market)
    cfg = equal_cfg(2, pct=0.2)
    reqs = [Request(0, cfg, 0.0, 3.0)] + [Request(i, cfg, 10.0, 13.0)
                                          for i in (1, 2, 3)]
    res = server.serve_queued(
        reqs, admission=AdmissionPolicy(
            max_depth=1, ladder=("serve_stale", "reject_new")),
        service_model=const_service)
    by = res.by_rid()
    assert by[0]["verdict"] == SERVED and by[0]["detail"] == ""
    stale = [v for v in res.verdicts if v["detail"].startswith("stale:")]
    assert len(stale) == 2
    for v in stale:
        assert v["verdict"] == SERVED and v["dispatch"] is None
        assert res.outputs[v["rid"]] is res.outputs[0]
    assert res.counters["stale_served"] == 2


def test_cheap_fallback_reroutes_to_the_cheapest_bucket(market):
    server = mk_server(market)
    expensive = linear_cfg(1, max_weight=0.2)
    res = server.serve_queued(
        [Request(0, equal_cfg(0), 0.0, 5.0), Request(1, expensive, 0.0, 5.0),
         Request(2, expensive, 0.0, 5.0)],
        admission=AdmissionPolicy(
            max_depth=1, ladder=("cheap_fallback", "reject_new")),
        service_model=const_service)
    by = res.by_rid()
    assert by[1]["verdict"] == SERVED and by[1]["detail"] == "cheap_fallback"
    assert by[2]["verdict"] == SHED   # depth >= 2 x max_depth: no reroute
    assert res.counters["cheap_fallbacks"] == 1
    ref = server.serve([dataclasses.replace(expensive,
                                            method="equal")])[0].output
    np.testing.assert_array_equal(_weights(res.outputs[1]), _weights(ref))


def test_stale_hit_past_the_deadline_is_a_miss(market):
    server = mk_server(market)
    cfg_a = equal_cfg(2, pct=0.2)
    cfg_b = linear_cfg(1)
    reqs = [Request(0, cfg_a, 0.0, 2.0), Request(1, cfg_b, 5.0, 5.58),
            Request(2, cfg_b, 5.54, 30.0), Request(3, cfg_a, 5.54, 5.56)]
    res = server.serve_queued(
        reqs, admission=AdmissionPolicy(
            max_depth=1, ladder=("serve_stale", "reject_new")),
        service_model=const_service)
    by = res.by_rid()
    assert by[0]["verdict"] == SERVED
    assert by[3]["verdict"] == DEADLINE_MISS
    assert by[3]["detail"] == "stale:0" and 3 in res.outputs
    assert res.counters["stale_served"] == 1
    assert res.counters["deadline_miss_count"] == 1


def test_live_p99_triggers_shedding(market):
    server = mk_server(market)
    cfg = equal_cfg(1)
    skey = server._normalize(cfg).static_key()
    est = DispatchEstimator()
    est.seed(repr(skey), 1, 1.0)
    est.seed(repr(skey), 4, 1.0)
    res = server.serve_queued(
        [Request(0, cfg, 0.0, 2.0), Request(1, cfg, 3.0, 9.0),
         Request(2, cfg, 3.0, 9.0)],
        admission=AdmissionPolicy(max_depth=64, p99_budget_s=0.5),
        estimator=est, service_model=lambda _t, _r: 1.0)
    by = res.by_rid()
    assert by[0]["verdict"] == SERVED
    assert by[2]["verdict"] == SHED and by[2]["detail"] == "p99"
    assert by[1]["verdict"] == SERVED


def test_admission_policy_and_stale_cache_guards():
    with pytest.raises(ValueError, match="max_depth"):
        AdmissionPolicy(max_depth=0)
    with pytest.raises(ValueError, match="ladder"):
        AdmissionPolicy(ladder=("panic",))
    with pytest.raises(ValueError, match="p99"):
        AdmissionPolicy(p99_budget_s=-1.0)
    # the sentry's observe-only hook is ported: a callable is taken, and
    # anything else is refused with the reason
    assert AdmissionPolicy(on_alert=print).on_alert is print
    with pytest.raises(ValueError, match="on_alert"):
        AdmissionPolicy(on_alert=1)
    cache = StaleCache(cap=2)
    cache.put("a", 0, [np.zeros(2)])
    cache.put("b", 1, [np.ones(2)])
    cache.get("a")  # refresh
    cache.put("c", 2, [np.ones(2)])
    assert len(cache) == 2 and cache.get("b") is None
    assert cache.get("a") is not None


# --------------------------------------------------- checkpoint / resume


def _two_bucket_drain(market, **kw):
    cfgs = [equal_cfg(i, pct=0.1 + 0.02 * (i % 3)) if i % 3
            else linear_cfg(i) for i in range(24)]
    arrivals = bursty_arrivals(24, rate_hz=1.2 * LADDER[-1] / SERVICE,
                               burst=5, seed=11)
    return mk_server(market).serve_queued(
        make_requests(cfgs, arrivals, deadline_s=0.7),
        admission=AdmissionPolicy(max_depth=10),
        service_model=const_service,
        fault_plan=DispatchFaultPlan(seed=2, error_rate=0.3), retries=2, **kw)


def test_checkpoint_resume_verdict_log_byte_equal(market, tmp_path):
    """Stop right after a mid-drain snapshot, resume from it: the verdict
    log byte-equal to an uninterrupted drain, no request lost or served
    twice, two buckets interleaved (an emptied bucket keeps its place)."""
    straight = _two_bucket_drain(market)
    ck = tmp_path / "queue.ckpt"
    partial = _two_bucket_drain(market, checkpoint_path=ck,
                                _stop_after_dispatches=1)
    assert len(partial.verdicts) < 24 and ck.exists()
    resumed = _two_bucket_drain(market, checkpoint_path=ck)
    assert resumed.log_lines() == straight.log_lines()
    assert {v["rid"] for v in resumed.verdicts} == set(range(24))
    assert not ({v["rid"] for v in partial.verdicts} & set(resumed.outputs))
    for rid, out in resumed.outputs.items():
        np.testing.assert_array_equal(_weights(out),
                                      _weights(straight.outputs[rid]))


def test_stale_entry_restored_from_a_snapshot_is_bitwise(market, tmp_path):
    """A stale hit on an entry restored from the snapshot (flat leaves,
    hung back on the served lane's structure on the server's device) is
    the source dispatch's output to the bit."""
    cfg = equal_cfg(2, pct=0.2)
    reqs = [Request(0, cfg, 0.0, 3.0)] + [Request(i, cfg, 10.0, 13.0)
                                          for i in (1, 2, 3)]
    kw = dict(admission=AdmissionPolicy(
        max_depth=1, ladder=("serve_stale", "reject_new")),
        service_model=const_service)
    straight = mk_server(market).serve_queued(reqs, **kw)
    ck = tmp_path / "stale.ckpt"
    mk_server(market).serve_queued(reqs, checkpoint_path=ck,
                                   _stop_after_dispatches=1, **kw)
    resumed = mk_server(market).serve_queued(reqs, checkpoint_path=ck, **kw)
    assert resumed.log_lines() == straight.log_lines()
    from factormodeling_tpu_torch.resil.checkpoint import tree_leaves

    src = tree_leaves(straight.outputs[0])
    hits = [v["rid"] for v in resumed.verdicts
            if v["detail"].startswith("stale:")]
    assert len(hits) == 2
    for rid in hits:
        got = resumed.outputs[rid]
        assert type(got.sim.diagnostics).__name__ == "SolverDiagnostics"
        leaves = tree_leaves(got)
        assert len(leaves) == len(src)
        for a, b in zip(leaves, src):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_checkpoint_config_guard_refuses_different_trace(market, tmp_path):
    server = mk_server(market)
    cfgs = [equal_cfg(i) for i in range(4)]
    ck = tmp_path / "queue.ckpt"
    kw = dict(service_model=const_service, checkpoint_path=ck)
    server.serve_queued(make_requests(cfgs, np.arange(4.0), deadline_s=2.0),
                        **kw)
    res = server.serve_queued(
        make_requests(cfgs, np.arange(4.0) + 0.5, deadline_s=2.0), **kw)
    assert sorted(res.by_rid()) == [0, 1, 2, 3]
    assert res.counters["served"] == 4
    assert res.verdicts[0]["arrival_s"] == 0.5


def test_replay_traffic_is_byte_equal(market):
    cfgs, arrivals, deadline, kw, faults = _trace("bursty_faults")
    server = mk_server(market)
    run = dict(admission=AdmissionPolicy(**kw["admission"]),
               service_model=const_service,
               fault_plan=DispatchFaultPlan(**faults), retries=2)
    first = server.serve_queued(
        make_requests(cfgs, arrivals, deadline_s=deadline), **run)
    again = replay_traffic(server, first.traffic, cfgs, **run)
    assert again.log_lines() == first.log_lines()
    assert [t["verdict"] for t in first.traffic] == [
        first.by_rid()[t["rid"]]["verdict"] for t in first.traffic]


# --------------------------------------------------------- report rows


def test_sync_dispatch_row_shape(market):
    server = mk_server(market)
    rep = obs.RunReport("row-shape")
    with rep.activate():
        server.serve([equal_cfg(i) for i in range(3)])
    rows = [r for r in rep.rows if r["name"] == "serve/dispatch"]
    assert rows and all(
        set(r) == {"kind", "name", "entry_point", "rung", "configs",
                   "padded_lanes", "bucket_count"} for r in rows)


def test_serving_row_counts_sum_and_land_in_reports(market):
    server = mk_server(market)
    rep = obs.RunReport("serving-rows", latency=True)
    with rep.activate():
        server.serve_queued(
            make_requests([equal_cfg(i) for i in range(10)], np.zeros(10),
                          deadline_s=1.0),
            admission=AdmissionPolicy(max_depth=4),
            service_model=const_service)
    sv = [r for r in rep.rows if r.get("kind") == "serving"]
    assert len(sv) == 1
    row = sv[0]
    assert row["name"] == "serve/queue"
    assert (row["served"] + row["shed_count"] + row["deadline_miss_count"]
            + row["failed_count"]) == row["submitted"] == 10
    lat = {r["name"]: r for r in rep.latency_rows()}
    assert lat["serve/verdict/served"]["count"] == row["served"]
    assert lat["serve/verdict/shed"]["count"] == row["shed_count"]
    assert any(r["name"] == "serve/queue/dispatch" for r in rep.rows)
    assert not any(r["name"] == "serve/dispatch" for r in rep.rows)
    assert sum(r.get("kind") == "traffic" for r in rep.rows) == 10


# ------------------------------------------------------------- elision


def test_default_serve_path_elides_the_traffic_layer(market, tmp_path):
    """In a child interpreter with ``serve.queue`` and ``serve.admission``
    blocked: importing the serving package and a synchronous serve work
    and load neither module, and nothing of JAX; the served weights are
    bitwise this process's."""
    cfg = equal_cfg(2, pct=0.2)
    want = _weights(mk_server(market).serve([cfg])[0].output)
    market_path = tmp_path / "market.npz"
    weights_path = tmp_path / "weights.npy"
    np.savez(market_path, **{k: np.asarray(v) for k, v in market.items()})
    script = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
class _Block:
    BLOCKED = ("factormodeling_tpu_torch.serve.queue",
               "factormodeling_tpu_torch.serve.admission", "jax")
    def find_spec(self, name, path=None, target=None):
        if name in self.BLOCKED:
            raise ImportError(f"{{name}} is blocked for the elision pin")
        return None
sys.meta_path.insert(0, _Block())
import numpy as np
import factormodeling_tpu_torch.serve as serve
from factormodeling_tpu_torch.serve import TenantConfig, TenantServer
market = np.load({str(market_path)!r}, allow_pickle=False)
server = TenantServer(names={NAMES!r}, pad_ladder={LADDER!r}, device="cpu",
                      **{{k: market[k] for k in market.files}})
cfg = TenantConfig(top_k=3, icir_threshold=-1.0, method="equal",
                   window={WINDOW}, pct=0.2)
out = server.serve([cfg])[0].output
loaded = [m for m in sys.modules if m.startswith("jax")
          or m.startswith("factormodeling_tpu.")
          or m in _Block.BLOCKED]
assert not loaded, loaded
np.save({str(weights_path)!r}, np.nan_to_num(out.sim.weights.numpy()))
try:
    serve.AdmissionPolicy
except ImportError:
    print("LAZY_OK")
print("ELISION_OK")
"""
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ELISION_OK" in proc.stdout and "LAZY_OK" in proc.stdout
    np.testing.assert_array_equal(np.load(weights_path), want)
