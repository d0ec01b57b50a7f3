"""The port's request flight recorder, health series and cost meter against
the JAX package's, on the CPU, and the elision contract of the obs hooks.

- The same event sequence fed to both packages' ``FlightRecorder``,
  ``HealthSeries`` (past its ring cap) and ``CostMeter`` (charges with pad
  lanes and per-lane vectors, overheads, a merge): rows, ``state()``,
  ``chrome_trace`` and the checkers' findings byte-equal; each package
  loads the other's state.
- ``advance_all(meter=, series=)`` against the JAX front end's on one
  stream: the health series byte-equal; the meter's accounts are fenced
  wall times, so they are held to conservation and to the JAX package's
  account layout (one account a session and date, the pad lanes on
  ``overhead/pad``), not to its values; the lanes bitwise the unmetered
  advance's.
- Elision: in a child interpreter the unhooked engine, queue, step and
  sweep run with ``obs.lineage``, ``obs.sentry``, ``obs.reqtrace`` and
  ``obs.metering`` blocked, and none of the four is loaded.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from factormodeling_tpu.obs import metering as jmet
from factormodeling_tpu.obs import reqtrace as jrt
from factormodeling_tpu.online import DateSlice as JaxSlice
from factormodeling_tpu.serve import TenantConfig as JaxTenant
from factormodeling_tpu.serve import TenantServer as JaxServer
from factormodeling_tpu_torch.obs import metering as pmet
from factormodeling_tpu_torch.obs import reqtrace as prt
from factormodeling_tpu_torch.online import DateSlice
from factormodeling_tpu_torch.serve import TenantConfig, TenantServer

REPO = Path(__file__).resolve().parent.parent


def _record(mod):
    fr = mod.FlightRecorder()
    for i in range(4):
        tid = str(i)
        fr.begin(tid, t=0.1 * i, tenant=f"t{i % 2}", rid=i)
        fr.event(tid, "submit", t=0.1 * i)
        fr.event(tid, "admit", t=0.1 * i + 0.01, bucket="b")
        w = fr.open(tid, "queue/wait", t=0.1 * i + 0.01)
        fr.close(tid, w, t=0.5, bucket="b")
        d = fr.open(tid, "dispatch", t=0.5, dispatch=0, rung=4,
                    pad_fraction=0.0, members=["0", "1", "2", "3"])
        a = fr.open(tid, "attempt", t=0.5, parent=d, attempt=0,
                    fault="dispatch_error" if i == 2 else None)
        fr.close(tid, a, t=0.55)
        fr.close(tid, d, t=0.6)
        fr.event(tid, "demux", t=0.6)
        fr.finish(tid, "SERVED", t=0.6 + 1e-10 * i, rid=i)
    fr.begin("4", t=0.7)
    return fr


def _series(mod):
    hs = mod.HealthSeries(cap=5)
    for t in range(9):
        hs.sample(t=0.25 * t, depth=t % 4, occupancy=(t % 3) / 3,
                  shed_rate=t / 20, served_p99_s=None if t < 2 else 0.1 * t)
    return hs


def _meter(mod):
    m = mod.CostMeter()
    m.charge(["a", "b", "a"], 4, wall_s=0.4, qp_solves=0.0,
             per_lane={"qp_solves": [1.0, 2.0, 3.0, 3.0]})
    m.charge(["c"], 1, wall_s=0.05, comms_bytes=1024.0)
    m.overhead("overhead/retry", wall_s=0.05)
    other = mod.CostMeter()
    other.charge(["a", "d"], 8, wall_s=0.8)
    return m.merge(other)


def test_recorder_series_and_meter_are_byte_equal_to_jax():
    fr, jfr = _record(prt), _record(jrt)
    assert fr.rows("q") == jfr.rows("q") and fr.state() == jfr.state()
    assert fr.open_traces() == jfr.open_traces() == ["4"]
    assert prt.row_errors(fr.rows("q")) == jrt.row_errors(jfr.rows("q"))
    jfr.finish("4", "SHED", t=0.7)
    fr.finish("4", "SHED", t=0.7)
    assert prt.row_errors(fr.rows("q")) == [] == jrt.row_errors(
        jfr.rows("q"))
    assert prt.chrome_trace(fr.rows("q")) == jrt.chrome_trace(jfr.rows("q"))
    hs, jhs = _series(prt), _series(jrt)
    assert hs.row("h") == jhs.row("h") and hs.state() == jhs.state()
    m, jm = _meter(pmet), _meter(jmet)
    assert m.row("m") == jm.row("m") and m.state() == jm.state()
    assert pmet.conservation_errors(m.row("m")) == []
    assert pmet.account_sum(m.row("m"), "wall_s") == \
        jmet.account_sum(jm.row("m"), "wall_s")
    bad = dict(m.row("m"), totals={"wall_s": 9.0})
    assert pmet.conservation_errors(bad) == jmet.conservation_errors(bad)
    assert pmet.conservation_errors(bad) != []
    for cls, got in ((prt.FlightRecorder, jfr), (prt.HealthSeries, jhs),
                     (pmet.CostMeter, jm), (jrt.FlightRecorder, fr),
                     (jmet.CostMeter, m)):
        fresh = cls() if cls is not prt.HealthSeries else cls(cap=5)
        fresh.load_state(got.state())
        assert fresh.state() == got.state()
    with pytest.raises(ValueError, match="already"):
        fr.finish("4", "SERVED", t=1.0)


# ------------------------------------------------- advance_all's hooks

F, D, N = 4, 14, 8
NAMES = ("a_flx", "b_eq", "c_long", "d_flx")
CFGS = [dict(top_k=2, icir_threshold=-1.0, window=5, method="equal",
             pct=0.25),
        dict(top_k=3, icir_threshold=-1.0, window=5, method="equal",
             pct=0.3)]


def _market():
    rng = np.random.default_rng(9)
    return dict(factors=rng.normal(size=(F, D, N)),
                returns=rng.normal(scale=0.02, size=(D, N)),
                factor_ret=rng.normal(scale=0.01, size=(D, F)),
                cap_flag=rng.integers(1, 4, size=(D, N)).astype(float),
                investability=np.ones((D, N)),
                universe=rng.uniform(size=(D, N)) > 0.05)


def _slices(market, cls):
    return [cls(factors=market["factors"][:, t],
                returns=market["returns"][t],
                factor_ret=market["factor_ret"][t],
                cap_flag=market["cap_flag"][t],
                investability=market["investability"][t],
                universe=market["universe"][t]) for t in range(D)]


def _untag(account):
    return re.sub(r"/bucket/[0-9a-f]{6}@", "/bucket/<tag>@", account)


def test_advance_all_meter_and_series_match_jax():
    market = _market()
    port = TenantServer(names=NAMES, pad_ladder=(1, 4), device="cpu",
                        **market)
    plain = TenantServer(names=NAMES, pad_ladder=(1, 4), device="cpu",
                         **market)
    jserver = JaxServer(names=NAMES, pad_ladder=(1, 4), **market)
    port.online_begin([TenantConfig(**c) for c in CFGS])
    plain.online_begin([TenantConfig(**c) for c in CFGS])
    jserver.online_begin([JaxTenant(**c) for c in CFGS])
    meter, series = pmet.CostMeter(), prt.HealthSeries()
    jmeter, jseries = jmet.CostMeter(), jrt.HealthSeries()
    for t, (ps, js) in enumerate(zip(_slices(market, DateSlice),
                                     _slices(market, JaxSlice))):
        kw = {} if t % 2 else dict(date=100 + t)
        got = port.advance_all(ps, meter=meter, series=series, **kw)
        want = plain.advance_all(ps)
        jserver.advance_all(js, meter=jmeter, series=jseries, **kw)
        for a, b in zip(got, want):
            assert a.output.weights.numpy().tobytes() == \
                b.output.weights.numpy().tobytes()
    assert series.row("h") == jseries.row("h")
    row, jrow = meter.row("m"), jmeter.row("m")
    assert sorted(map(_untag, row["accounts"])) == \
        sorted(map(_untag, jrow["accounts"]))
    assert pmet.conservation_errors(row) == [] == jmet.conservation_errors(
        jrow)
    assert {k: v for k, v in row.items() if k not in ("accounts", "totals")} \
        == {k: v for k, v in jrow.items() if k not in ("accounts", "totals")}
    assert row["totals"]["wall_s"] > 0


# ------------------------------------------------------------- elision

def test_unhooked_paths_load_none_of_the_hook_modules(tmp_path):
    """In a child interpreter with the four hook modules blocked: the
    unhooked engine, queue, research step (probes off) and checkpointed
    sweep run, and none of the four is loaded."""
    script = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
BLOCKED = tuple(f"factormodeling_tpu_torch.obs.{{m}}" for m in
                ("lineage", "sentry", "reqtrace", "metering"))
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name in BLOCKED:
            raise ImportError(f"{{name}} is blocked for the elision pin")
        return None
sys.meta_path.insert(0, _Block())
import numpy as np
import torch
import factormodeling_tpu_torch as fmt
from factormodeling_tpu_torch.online import DateSlice, OnlineEngine
from factormodeling_tpu_torch.serve import TenantConfig, TenantServer
from factormodeling_tpu_torch.serve.queue import make_requests
rng = np.random.default_rng(0)
F, D, N = 4, 12, 6
names = ("a_flx", "b_eq", "c_long", "d_flx")
m = dict(factors=rng.normal(size=(F, D, N)),
         returns=rng.normal(scale=0.02, size=(D, N)),
         factor_ret=rng.normal(scale=0.01, size=(D, F)),
         cap_flag=rng.integers(1, 4, size=(D, N)).astype(float),
         investability=np.ones((D, N)))
tmpl = TenantConfig(window=4, lookback_period=4)
eng = OnlineEngine(names=names, n_assets=N, template=tmpl, device="cpu",
                   checkpoint={str(tmp_path / "e.snap")!r})
for t in range(D):
    eng.ingest(t, DateSlice(m["factors"][:, t], m["returns"][t],
                            m["factor_ret"][t], m["cap_flag"][t],
                            m["investability"][t]))
assert eng.flight_rows() == eng.lineage_rows() == eng.sentry_rows() == []
server = TenantServer(names=names, pad_ladder=(1, 4), device="cpu", **m)
cfgs = [TenantConfig(top_k=1 + i % F, icir_threshold=-1.0, window=4)
        for i in range(3)]
res = server.serve_queued(make_requests(cfgs, np.arange(3.0) * 0.2,
                                        deadline_s=30.0),
                          service_model=lambda _t, _r: 0.05)
assert res.flight is res.lineage is res.sentry is None
server.serve(cfgs)
server.online_begin(cfgs[:2])
server.advance_all(DateSlice(m["factors"][:, 0], m["returns"][0],
                             m["factor_ret"][0], m["cap_flag"][0],
                             m["investability"][0]))
ts = [torch.from_numpy(m[k]) for k in ("factors", "returns",
                                       "factor_ret", "cap_flag",
                                       "investability")]
out = fmt.build_research_step(names=names, window=4, device="cpu")(
    *ts, torch.ones((D, N), dtype=torch.bool))
assert out.probes is None
st = fmt.SimulationSettings(returns=ts[1], cap_flag=ts[3],
                            investability_flag=ts[4], pct=0.3)
fmt.parallel.checkpointed_manager_sweep(
    ts[0], fmt.parallel.combo_weight_matrix([[0, 1], [2, 3]], F,
                                            device="cpu"), st,
    combo_batch=1, checkpoint=fmt.resil.Checkpointer(
        {str(tmp_path / "s.snap")!r}), device="cpu")
loaded = [n for n in sys.modules if n in BLOCKED]
assert not loaded, loaded
print("ELISION_OK")
"""
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ELISION_OK" in proc.stdout
