"""The port's operations sentry and the serving queue's obs hooks against
the JAX package's, on the CPU.

- The same seeded signal sequence (cumulative counters, gauges with
  level shifts, NaN and missing samples, metering accounts) fed to both
  packages' ``Sentry`` with every detector family (multi-window burn
  rates, CUSUM, Page-Hinkley, the EWMA band, the budget watch): the
  alerts, incidents, rows and ``state()`` byte-equal, the checkers'
  findings equal, each package resuming the other's ``state()``.
- ``serve_queued(flight=True, lineage=True, sentry=True)`` with an
  ``AdmissionPolicy(on_alert=...)`` collector on one trace (faults,
  retries, shedding) in both packages: the verdict log line for line; the
  flight rows, the health series and the alert log byte-equal, except
  that the ``output_ids`` an incident cites follow the ledger's renaming
  (``torch_obs_streams``); the ledger up to renaming with panels and
  config ids byte-equal; the metering accounts under the JAX package's
  keys, conserved (the charged seconds are the virtual clock's, so they
  equal the JAX package's too); the on_alert hook sees every alert and
  changes no verdict; a drain killed after two dispatches and resumed
  ends with rows byte-equal to the straight drain's.
"""

import dataclasses
import json

import numpy as np
import pytest

from factormodeling_tpu.obs import lineage as jlin
from factormodeling_tpu.obs import sentry as jsn
from factormodeling_tpu.resil import DispatchFaultPlan as JaxFaultPlan
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu.serve import TenantServer as JaxServer
from factormodeling_tpu.serve import queue as jax_queue
from factormodeling_tpu.serve.admission import (
    AdmissionPolicy as JaxAdmission)
from factormodeling_tpu_torch.obs import lineage as plin
from factormodeling_tpu_torch.obs import metering as pmet
from factormodeling_tpu_torch.obs import reqtrace as prt
from factormodeling_tpu_torch.obs import sentry as psn
from factormodeling_tpu_torch.resil import DispatchFaultPlan
from factormodeling_tpu_torch.serve import TenantConfig, TenantServer
from factormodeling_tpu_torch.serve.admission import AdmissionPolicy
from factormodeling_tpu_torch.serve.queue import (bursty_arrivals,
                                                  make_requests)
from tests import torch_obs_streams as st
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401


def _detectors(mod):
    return [mod.BurnRateDetector("failure_rate", bad="failed",
                                 total="submitted", budget=0.05),
            mod.BurnRateDetector("retry_rate", bad="retries",
                                 total="submitted", budget=0.0),
            mod.CusumDetector("depth", k=0.5, h=3.0, warmup=4),
            mod.PageHinkley("occupancy", warmup=4),
            mod.EwmaBandDetector("latency", nsig=3.0, warmup=4)]


def _feed(sn, seed=3):
    rng = np.random.default_rng(seed)
    failed = retries = 0
    accounts: dict = {}
    for t in range(40):
        failed += int(t > 25 and rng.uniform() < 0.4)
        retries += int(rng.uniform() < 0.1)
        level = 1.0 if t < 20 else 4.0
        gauges = {"depth": level + rng.normal(scale=0.2),
                  "occupancy": 0.5 + (0.3 if t > 30 else 0.0)
                  + rng.normal(scale=0.01),
                  "latency": (float("nan") if t == 12
                              else 0.1 + rng.normal(scale=0.01)
                              + (0.5 if t in (33, 34) else 0.0))}
        if t % 7 == 3:
            gauges.pop("latency")
        tenant = f"t{t % 3}"
        acct = accounts.setdefault(tenant, {"wall_s": 0.0})
        acct["wall_s"] += 0.05 + 0.01 * (t % 5)
        sn.observe(t=0.25 * t,
                   counters={"submitted": 3 * (t + 1), "failed": failed,
                             "retries": retries},
                   gauges=gauges,
                   accounts={k: dict(v) for k, v in accounts.items()},
                   context={"trace_ids": [str(t)], "output_ids": [],
                            "tenants": [tenant],
                            "checkpoint": f"ck@{t}"})
    return sn


def _sentry(mod):
    return mod.Sentry(detectors=_detectors(mod),
                      budgets={"t1": {"wall_s": 0.8}})


def test_sentry_event_sequence_is_byte_equal_to_jax():
    port, jax_ = _feed(_sentry(psn)), _feed(_sentry(jsn))
    assert len(port.alerts) >= 3 and port.incidents
    assert port.state() == jax_.state()
    assert port.rows("q") == jax_.rows("q")
    assert port.fired_signals() == jax_.fired_signals()
    rows = port.rows("q") + [{"kind": "reqtrace", "name": "q",
                              "trace_id": str(t)} for t in range(40)]
    assert psn.sentry_errors(rows) == jsn.sentry_errors(rows) == []
    broken = [dict(r, alert_ids=["nope"]) if r["kind"] == "incident" else r
              for r in rows]
    assert psn.incident_errors(broken) == jsn.incident_errors(broken) != []
    assert psn.alert_errors(rows[:1]) == jsn.alert_errors(rows[:1])
    for a, b in ((_sentry(psn), jax_), (_sentry(jsn), port)):
        a.load_state(b.state())
        assert a.state() == b.state()
    assert [d.describe() for d in port.detectors] == \
        [d.describe() for d in jax_.detectors]
    assert [d.describe() for d in psn.default_detectors()] == \
        [d.describe() for d in jsn.default_detectors()]


# --------------------------------------------------------- the queue hooks

F, D, N, WINDOW = 5, 30, 8, 6
NAMES = ("fam0_f0_flx", "fam0_f1_eq", "fam1_f2_flx", "fam1_f3_long",
         "fam2_f4_flx")
LADDER, SERVICE = (1, 4, 8), 0.05


def _market(seed=20260804):
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(F, D, N))
    factors[rng.uniform(size=factors.shape) < 0.05] = np.nan
    return dict(factors=factors,
                returns=rng.normal(scale=0.02, size=(D, N)),
                factor_ret=rng.normal(scale=0.01, size=(D, F)),
                cap_flag=rng.integers(1, 4, size=(D, N)).astype(float),
                investability=np.ones((D, N)),
                universe=rng.uniform(size=(D, N)) > 0.05)


def _configs():
    cfgs = [dict(method="linear" if i % 3 == 0 else "equal", window=WINDOW,
                 icir_threshold=-1.0, top_k=1 + i % F, max_weight=0.3,
                 pct=0.1 + 0.02 * (i % 3)) for i in range(24)]
    cfgs[5] = dict(top_k=2, window=D + 5)       # FAILED: rejected
    return cfgs


QUEUE_KW = dict(admission=dict(max_depth=6, ladder=(
    "serve_stale", "cheap_fallback", "reject_new")),
    fault=dict(seed=1, error_rate=0.25, poison_rate=0.15))


def _const(_tag, _rung):
    return SERVICE


def _jax_run(market, seen):
    server = JaxServer(names=NAMES, pad_ladder=LADDER, **market)
    reqs = jax_queue.make_requests(
        [JaxTenant(**c) for c in _configs()],
        bursty_arrivals(24, rate_hz=LADDER[-1] / SERVICE, burst=6, seed=5),
        deadline_s=0.4)
    return server.serve_queued(
        reqs, admission=JaxAdmission(**QUEUE_KW["admission"],
                                     on_alert=seen.append),
        service_model=_const, fault_plan=JaxFaultPlan(**QUEUE_KW["fault"]),
        retries=2, flight=True, lineage=True, sentry=True)


def _port_run(market, seen=None, **kw):
    server = TenantServer(names=NAMES, pad_ladder=LADDER, device="cpu",
                          **market)
    reqs = make_requests(
        [TenantConfig(**c) for c in _configs()],
        bursty_arrivals(24, rate_hz=LADDER[-1] / SERVICE, burst=6, seed=5),
        deadline_s=0.4)
    admission = dict(QUEUE_KW["admission"])
    if seen is not None:
        admission["on_alert"] = seen.append
    return server.serve_queued(
        reqs, admission=AdmissionPolicy(**admission), service_model=_const,
        fault_plan=DispatchFaultPlan(**QUEUE_KW["fault"]), retries=2, **kw)


@pytest.fixture(scope="module")
def drains():
    market = _market()
    seen, jseen = [], []
    hooked = _port_run(market, seen, flight=True, lineage=True, sentry=True)
    plain = _port_run(market)
    return hooked, plain, seen, _jax_run(market, jseen), jseen


def test_hooked_queue_matches_jax(drains):
    res, plain, seen, want, jseen = drains
    assert res.log_lines() == want.log_lines() == plain.log_lines()
    assert res.counters == want.counters
    assert res.counters["retry_count"] and res.counters["shed_count"]
    # the ledger: panels and configs byte for byte, books up to renaming
    rows, jrows = res.lineage.rows("q"), want.lineage.rows("q")
    ids = st.renaming(rows, jrows)
    assert plin.ledger_errors(rows) == [] == jlin.ledger_errors(jrows)
    assert sum(r["edge_kind"] == "dispatch" for r in rows) == (
        res.counters["served"] + res.counters["deadline_miss_count"]
        - res.counters["stale_served"])
    # the alert log: byte-equal but for the incidents' output ids
    srows, sjrows = res.sentry.rows("q"), want.sentry.rows("q")
    assert len(srows) == len(sjrows) and res.sentry.alerts
    for a, b in zip(srows, sjrows):
        if a["kind"] == "incident":
            assert [ids[i] for i in a["output_ids"]] == b["output_ids"]
            a = dict(a, output_ids=b["output_ids"])
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert seen == [dict(a) for a in res.sentry.alerts] and \
        len(seen) == len(jseen)
    # the flight rows and the health series byte-equal
    assert res.flight.recorder.rows("q") == want.flight.recorder.rows("q")
    assert res.flight.series.row("h") == want.flight.series.row("h")
    assert prt.row_errors(res.flight.rows("q")) == []
    # metering: the JAX package's accounts, conserved
    row, jrow = res.flight.meter.row("m"), want.flight.meter.row("m")
    assert sorted(row["accounts"]) == sorted(jrow["accounts"])
    assert row == jrow
    assert pmet.conservation_errors(row) == []
    assert "overhead/retry" in row["accounts"] or \
        "overhead/failed" in row["accounts"]


def test_hooked_queue_resume_and_report_rows(drains, tmp_path):
    from factormodeling_tpu_torch import obs

    res, _, _, _, _ = drains
    market = _market()
    ck = tmp_path / "q.snap"
    straight = _port_run(market, checkpoint_path=ck, flight=True,
                         lineage=True, sentry=True)
    ck.unlink()
    _port_run(market, checkpoint_path=ck, flight=True, lineage=True,
              sentry=True, _stop_after_dispatches=2)
    rep = obs.RunReport("q")
    with rep.activate():
        resumed = _port_run(market, checkpoint_path=ck, flight=True,
                            lineage=True, sentry=True)
    assert resumed.log_lines() == straight.log_lines() == res.log_lines()
    assert resumed.flight.state() == straight.flight.state()
    assert resumed.lineage.state() == straight.lineage.state()
    assert resumed.sentry.state() == straight.sentry.state()
    rows = rep.all_rows()
    kinds = {r["kind"] for r in rows}
    assert {"reqtrace", "metering", "series", "lineage", "alert",
            "traffic", "serving"} <= kinds
    assert (prt.row_errors(rows) + plin.ledger_errors(rows)
            + plin.traffic_errors(rows) + psn.sentry_errors(rows)) == []
    with pytest.raises(ValueError, match="on_alert"):
        dataclasses.replace(AdmissionPolicy(), on_alert="print")
