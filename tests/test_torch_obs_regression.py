"""The port's copy of the report gate (``obs/regression.py``) against the
JAX package's, and the repo's report tools on the port's artifacts, on the
CPU.

- Both copies of ``diff_reports`` over the same pair of reports (a port
  ``RunReport`` with probe, counter, span, serving, traffic, reqtrace,
  metering, series, lineage, alert and incident rows, and variants of it
  that regress each check): the same findings, messages, first bad stage
  and exit verdict; ``numerics_baseline`` and the row extractors equal.
- ``tools/report_diff.py``, ``tools/lineage.py explain`` and ``strict``,
  ``tools/incident.py`` (rendering and ``--strict``) and
  ``tools/trace_report.py --strict`` read the port's report unchanged and
  exit 0 (``report_diff`` exits 1 on the regressed variant).
"""

import copy
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu.obs import regression as jreg
from factormodeling_tpu_torch.obs import regression as preg
from factormodeling_tpu_torch.resil import DispatchFaultPlan
from factormodeling_tpu_torch.serve import TenantConfig, TenantServer
from factormodeling_tpu_torch.serve.queue import (bursty_arrivals,
                                                  make_requests)
from tests.torch_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
F, D, N = 4, 24, 8
NAMES = ("a_flx", "b_eq", "c_long", "d_flx")


def _market():
    rng = np.random.default_rng(17)
    factors = rng.normal(size=(F, D, N))
    factors[rng.uniform(size=factors.shape) < 0.05] = np.nan
    return dict(factors=factors,
                returns=rng.normal(scale=0.02, size=(D, N)),
                factor_ret=rng.normal(scale=0.01, size=(D, F)),
                cap_flag=rng.integers(1, 4, size=(D, N)).astype(float),
                investability=np.ones((D, N)),
                universe=rng.uniform(size=(D, N)) > 0.05)


@pytest.fixture(scope="module")
def report_rows():
    """One port RunReport's rows: a probed, counted step and a queued drain
    with the flight recorder, the ledger and the sentry on."""
    market = _market()
    rep = fmt.obs.RunReport("port-obs", latency=True)
    with rep.activate():
        arrays = [torch.from_numpy(market[k]) for k in (
            "factors", "returns", "factor_ret", "cap_flag", "investability",
            "universe")]
        step = fmt.build_research_step(
            names=NAMES, window=6, collect_counters=True, collect_probes=True,
            sim_kwargs=dict(method="linear", max_weight=0.3), device="cpu")
        with rep.span("research_step") as sp:
            out = sp.add(step(*arrays))
        rep.add_counters("research_step", out.counters)
        rep.add_probes("research_step", out.probes)
        server = TenantServer(names=NAMES, pad_ladder=(1, 4), device="cpu",
                              **market)
        cfgs = [TenantConfig(top_k=1 + i % F, icir_threshold=-1.0, window=6,
                             pct=0.2 + 0.02 * (i % 3)) for i in range(12)]
        server.serve_queued(
            make_requests(cfgs, bursty_arrivals(12, rate_hz=40.0, burst=4,
                                                seed=2), deadline_s=0.5),
            service_model=lambda _t, _r: 0.05, retries=2,
            fault_plan=DispatchFaultPlan(seed=1, error_rate=0.3),
            flight=True, lineage=True, sentry=True)
    return json.loads(json.dumps(rep.all_rows(), default=float))


def _regressed(rows):
    rows = copy.deepcopy(rows)
    for r in rows:
        if r.get("kind") == "numerics" and r["stage"] == "composite/blend":
            r["finite_frac"] = r["finite_frac"] - 0.25
            r["nan_count"] += 40
        elif r.get("kind") == "counters":
            r["counters"] = dict(r["counters"], factor_nan_frac=0.9)
        elif r.get("kind") == "serving":
            r["failed_count"] += 3
            r["served_p99_s"] = 9.0
        elif r.get("kind") == "metering":
            r["accounts"] = {k: {c: 10 * v for c, v in a.items()}
                             for k, a in r["accounts"].items()}
        elif r.get("kind") == "series":
            r["max_depth"] = r.get("max_depth", 0) + 9
    rows = [r for r in rows if r.get("kind") != "lineage"]
    rows.append(dict(next(r for r in rows if r.get("kind") == "alert"
                          and not r.get("summary")), t_s=99.0,
                     alert_id="a99"))
    return rows


def _both(base, new, **kw):
    got, want = preg.diff_reports(base, new, **kw), jreg.diff_reports(
        base, new, **kw)
    return got, want


@pytest.mark.parametrize("variant", ["same", "regressed", "no_wall"])
def test_diff_reports_verdicts_equal_jax(report_rows, variant):
    base = report_rows
    new = base if variant == "same" else _regressed(base)
    kw = dict(check_wall=variant != "no_wall")
    got, want = _both(base, new, **kw)
    assert [dataclasses.asdict(f) for f in got.findings] == \
        [dataclasses.asdict(f) for f in want.findings]
    assert got.render() == want.render()
    assert got.ok == want.ok == (variant == "same")
    assert got.first_bad_stage == want.first_bad_stage
    if variant != "same":
        kinds = {f.kind for f in got.regressions}
        assert {"numerics", "counter"} <= kinds and got.first_bad_stage


def test_row_extractors_equal_jax(report_rows):
    rows = report_rows
    for fn in ("numerics_baseline", "span_totals", "counter_scalars",
               "serving_rows", "metering_rows", "series_rows",
               "lineage_rows", "traffic_rows", "alert_rows", "fired_alerts",
               "incident_rows", "latency_rows", "meta_row"):
        assert getattr(preg, fn)(rows) == getattr(jreg, fn)(rows), fn
    assert set(preg.numerics_baseline(rows)) >= {"ops/factors_raw",
                                                 "backtest/pnl"}
    assert preg.meta_row(rows)["schema_version"] == 5


def _cli(*argv):
    return subprocess.run([sys.executable, *map(str, argv)],
                          capture_output=True, text=True, timeout=120)


def test_tools_read_the_port_report(report_rows, tmp_path):
    path = tmp_path / "port.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in report_rows))
    bad = tmp_path / "regressed.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n"
                           for r in _regressed(report_rows)))
    same = _cli(TOOLS / "report_diff.py", path, path, "--no-wall")
    assert same.returncode == 0, same.stdout[-2000:] + same.stderr[-2000:]
    worse = _cli(TOOLS / "report_diff.py", path, bad, "--no-wall")
    assert worse.returncode == 1 and "REGRESSION" in worse.stdout
    rid = next(r["rid"] for r in report_rows if r.get("kind") == "lineage"
               and r.get("edge_kind") == "dispatch")
    explain = _cli(TOOLS / "lineage.py", "explain", path, "--rid", rid)
    assert explain.returncode == 0, explain.stderr[-2000:]
    assert f"rid={rid}" in explain.stdout
    strict = _cli(TOOLS / "lineage.py", "strict", path)
    assert strict.returncode == 0, strict.stderr[-2000:]
    incident = _cli(TOOLS / "incident.py", path)
    assert incident.returncode == 0, incident.stderr[-2000:]
    assert "inc0" in incident.stdout
    incident = _cli(TOOLS / "incident.py", path, "--strict")
    assert incident.returncode == 0, incident.stderr[-2000:]
    trace = _cli(TOOLS / "trace_report.py", path, "--strict")
    assert trace.returncode == 0, trace.stdout[-2000:] + trace.stderr[-2000:]
    assert "provenance ledger" in trace.stdout
