"""The port's telemetry against the JAX package's, on the CPU: the comms
ledger's stage rule, ``obs.memory``, ``obs.compile_log``, ``obs.devtime``
and the cost rows. Each test feeds the same inputs to the JAX module and
to the port.

- The stage rule: for every stack of one to three scopes drawn from
  ``STAGE_SCOPES``, JAX's ``_stage_of`` of the joined ``op_name`` path
  equals the port's ``_stage_of`` of the stack (the outermost known
  scope).
- ``memory``: the failure forms and the ``kind="memory"`` rows carry the
  JAX package's fields; the CPU gives the failure form and a cached
  watermark reason; the measured arithmetic on a stand-in allocator keeps
  the JAX identity ``peak = argument + output + temp - alias``.
- ``compile_log``: the scenario of JAX's
  ``test_compile_telemetry_and_retrace_detector`` and of
  ``test_instrument_jit_records_steady_state_calls_only`` through both
  packages give the same counts, flags, row keys and sketch count.
- ``devtime``: one synthetic event set written as a JAX trace (op events
  with ``op_name`` paths on ``/device:`` tracks) and as a Kineto trace
  (kernel events correlated to launches inside ``user_annotation``
  ranges) attributes identically; the CPU skip row is JAX's; and
  ``tools/trace_report.py --strict`` and ``tools/report_diff.py`` read a
  port report holding devtime, memory, comms, sharding and compile rows.
- Cost: a single product, elementwise op and reduction give JAX's FLOPs
  and bytes exactly; the equal-weight research step gives finite,
  positive figures in both.
"""

import itertools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu import obs as jobs
from factormodeling_tpu.obs import comms as jcomms
from factormodeling_tpu.obs import devtime as jdevtime
from factormodeling_tpu.obs import memory as jmemory
from factormodeling_tpu.parallel import build_research_step as jax_build
from factormodeling_tpu_torch import obs
from factormodeling_tpu_torch.obs import comms, devtime, memory
from tests.torch_isolation import reset_process_telemetry  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"


# ------------------------------------------------------------ stage rule


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stage_rule_is_the_jax_package_for_every_stack(depth):
    """The outermost known scope wins, the longest at one position: the
    port's rule over a stack is JAX's over the stack's joined path, with
    either package's vocabulary."""
    for vocab in (comms.STAGE_SCOPES, jcomms.STAGE_SCOPES):
        for stack in itertools.product(comms.STAGE_SCOPES, repeat=depth):
            assert comms._stage_of(stack, vocab) == jcomms._stage_of(
                "/".join(stack), vocab), stack
    # the asset step's rank-IC rows: the outermost scope takes them
    assert comms._stage_of(("selection/rolling", "selection/daily_stats",
                            "metrics/rank_ic"), comms.STAGE_SCOPES) == \
        "selection/rolling"
    assert comms._stage_of(("selection/rolling_metrics",),
                           comms.STAGE_SCOPES) == "selection/rolling_metrics"


def test_ledger_charges_the_outermost_open_stage():
    with comms.recording() as ledger, obs.stage("selection/daily_stats"), \
            obs.stage("metrics/rank_ic"):
        comms.record("all-gather", "date", 8, 2, 1)
    assert ledger.ops[0].stage == "selection/daily_stats"
    assert ledger.ops[0].stage == jcomms._stage_of(ledger.ops[0].op_name,
                                                   jcomms.STAGE_SCOPES)


# ---------------------------------------------------------------- memory


def test_memory_failure_forms_and_cached_watermark_match_jax():
    want = jmemory.memory_summary(object())
    got = memory.memory_summary(lambda: torch.ones(3))
    assert set(got) == set(want) == {"source", "reason"}
    assert got["source"] is None and got["reason"]
    assert memory.peak_bytes(lambda: torch.ones(3)) is None
    assert memory.live_watermark() is None
    assert jmemory.live_watermark() is None
    reason = memory.watermark_unavailable_reason()
    assert reason.startswith(jmemory.watermark_unavailable_reason())
    assert memory.live_watermark() is None        # the cached verdict
    assert memory.watermark_unavailable_reason() == reason
    # the old import keeps working
    from factormodeling_tpu_torch.obs.report import live_watermark
    assert live_watermark is memory.live_watermark


class _Allocator:
    """A stand-in for the card's caching allocator: 1000 bytes allocated
    before the call, 1800 at its high-water mark."""

    def __init__(self, monkeypatch):
        cuda = torch.cuda
        for name, value in (("is_available", lambda: True),
                            ("current_device", lambda: 0),
                            ("synchronize", lambda *a: None),
                            ("reset_peak_memory_stats", lambda *a: None),
                            ("memory_allocated", lambda *a: 1000),
                            ("max_memory_allocated", lambda *a: 1800)):
            monkeypatch.setattr(cuda, name, value)
        # CPU tensors stand in for the card's
        monkeypatch.setattr(memory, "_storages", lambda ts: {
            t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in ts})


def test_memory_rows_have_the_jax_fields_and_identity(monkeypatch):
    x = torch.ones(10, dtype=torch.float64)           # 80 B argument
    jrep = jobs.RunReport("j")
    jrep.add_placement("f", jax.jit(lambda a: a * 2), jnp.ones(8))
    jrow = next(r for r in jrep.rows if r["kind"] == "memory")
    # the CPU row: the failure form beside the cached skip reason
    rep = obs.RunReport("p")
    rep.add_placement("f", lambda a: a * 2, x)
    row = next(r for r in rep.rows if r["kind"] == "memory")
    assert set(row) == {"kind", "name", "source", "reason", "device_stats"}
    assert row["device_stats"] == jrow["device_stats"].replace(
        jmemory.watermark_unavailable_reason(),
        memory.watermark_unavailable_reason())
    # measured on the stand-in allocator: the argument, an output aliasing
    # it and a new 24 B output
    _Allocator(monkeypatch)
    summary = memory.memory_summary(lambda a: (a, a[:3] * 1.0), x)
    assert summary == {"source": "measured", "argument_bytes": 80,
                       "output_bytes": 104, "temp_bytes": 776,
                       "alias_bytes": 80, "generated_code_bytes": 0,
                       "peak_bytes": 880}
    assert summary["peak_bytes"] == (summary["argument_bytes"]
                                     + summary["output_bytes"]
                                     + summary["temp_bytes"]
                                     - summary["alias_bytes"])
    assert memory.peak_bytes(lambda a: a + 1, x) == 880
    rep = obs.RunReport("p")
    rep.add_placement("f", lambda a: a * 2, x)
    row = next(r for r in rep.rows if r["kind"] == "memory")
    assert set(row) - {"device_stats"} == set(jrow) - {"device_stats"}


# ----------------------------------------------------------- compile_log


def _compile_scenario(pkg, jit, ones):
    """JAX's test_compile_telemetry_and_retrace_detector, through ``pkg``'s
    obs; returns the wrappers' stats and the report's compile rows."""
    rep = pkg.RunReport("compile-unit")
    with rep.activate():
        healthy = pkg.instrument_jit(jit(lambda x: x * 2 + 1),
                                     "telemetry/healthy")
        healthy(ones(4))
        healthy(ones(4))          # the same signature again
        healthy(ones(6))          # a new signature
        unstable = pkg.instrument_jit(jit(lambda x: (x * x).sum()),
                                      "telemetry/unstable",
                                      expected_signatures=1)
        for k in range(4):
            unstable(ones(3 + k))
    stats = {w.name: (w.calls, w.compiles, w.retraces, w.retraced)
             for w in (healthy, unstable)}
    return stats, [r for r in rep.rows if r["kind"] == "compile"]


def test_compile_stats_and_retrace_detector_match_jax():
    before = obs.compile_totals()
    got, rows = _compile_scenario(obs, lambda f: f, torch.ones)
    want, jrows = _compile_scenario(jobs, jax.jit, jnp.ones)
    assert got == want == {"telemetry/healthy": (3, 2, 0, False),
                           "telemetry/unstable": (4, 4, 3, True)}
    assert [r["name"] for r in rows] == [r["name"] for r in jrows]
    for g, w in zip(rows, jrows):
        assert set(g) == set(w)
        assert {k: g[k] for k in g if k != "compile_s"} == \
            {k: w[k] for k in w if k != "compile_s"}
        assert g["compile_s"] >= 0.0
    stats = obs.compile_stats()
    assert stats["telemetry/unstable"]["retraced"]
    assert set(stats["telemetry/healthy"]) == set(
        jobs.compile_stats()["telemetry/healthy"])
    after = obs.compile_totals()
    assert set(after) == set(jobs.compile_totals())
    assert after["compiles"] == before["compiles"] + 6
    # transparent: attributes resolve on the wrapped callable
    fn = lambda x: x  # noqa: E731
    fn.marker = 7
    assert obs.instrument_jit(fn, "telemetry/attr").marker == 7


def _latency_count(pkg, jit, ones):
    step = pkg.instrument_jit(jit(lambda x: x * 2.0),
                              "telemetry/latency_entry")
    x = ones((8,))
    rep = pkg.RunReport("t", latency=True)
    with rep.activate():
        step(x)          # the "compile": left out of the sketch
        step(x)
        step(x)
    row = {r["name"]: r for r in rep.latency_rows()}[
        "telemetry/latency_entry"]
    assert row["p50_s"] > 0 and row["p99_s"] >= row["p50_s"]
    return row["count"]


def test_instrument_jit_records_steady_state_calls_only_as_jax():
    assert _latency_count(obs, lambda f: f, torch.ones) == _latency_count(
        jobs, jax.jit, jnp.ones) == 2


def test_comms_report_takes_placement_rows_from_the_compiling_call():
    calls = []

    def target(x):
        calls.append(1)
        return x + 1

    entry = obs.instrument_jit(target, "telemetry/placed")
    rep = obs.RunReport("p", comms=True)
    with rep.activate():
        entry(torch.ones(4))
        entry(torch.ones(4))
    assert len(calls) == 2         # no extra run
    assert [r["kind"] for r in rep.rows] == ["compile", "comms", "memory",
                                            "sharding"]
    assert rep.rows[1]["stage"] == "total"


# --------------------------------------------------------------- devtime

#: (stage stack, device µs, device index, category) of the synthetic step
_EVENTS = (
    (("selection/rolling", "selection/daily_stats", "metrics/rank_ic"),
     1000.0, 0, "kernel"),
    (("solver/admm",), 2500.0, 0, "kernel"),
    (("solver/admm",), 500.0, 1, "kernel"),
    (("backtest/pnl", "solver/admm"), 200.0, 0, "kernel"),
    (("not/a/scope",), 300.0, 0, "kernel"),
    (("selection/rolling_metrics",), 150.0, 0, "gpu_memcpy"),
    (("composite/blend",), 0.0, 0, "kernel"),
    ((), 75.0, 0, "gpu_memset"),
)


def _jax_trace():
    ev = [{"ph": "M", "name": "process_name", "pid": 7 + d,
           "args": {"name": f"/device:GPU:{d}"}} for d in (0, 1)]
    ev.append({"ph": "M", "name": "process_name", "pid": 1,
               "args": {"name": "/host:CPU"}})
    for i, (stack, dur, dev, _) in enumerate(_EVENTS):
        path = "/".join(("jit_step",) + stack + (f"fusion.{i}",))
        ev.append({"ph": "X", "pid": 7 + dev, "name": f"op.{i}",
                   "dur": dur, "args": {"long_name": path}})
    # host time never counts as device time
    ev.append({"ph": "X", "pid": 1, "name": "PjitFunction(step)",
               "dur": 9e6})
    return ev


def _kineto_trace():
    """The same step as Kineto exports it: annotations and launches on the
    host thread, kernels on the devices' streams correlated to their
    launches; a memset with no launch."""
    ev = [{"ph": "M", "name": "process_name", "pid": d,
           "args": {"name": "python3"}} for d in (0, 1)]
    ts = 1000.0
    for i, (stack, dur, dev, cat) in enumerate(_EVENTS):
        n = len(stack)
        for depth, name in enumerate(stack):
            ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "pid": 4242, "tid": 9, "ts": ts + depth,
                       "dur": 10.0 * (n - depth)})
            ev.append({"ph": "X", "cat": "gpu_user_annotation",
                       "name": name, "pid": dev, "tid": 7,
                       "ts": ts + depth, "dur": 10.0 * (n - depth)})
        corr = 100 + i
        if stack:
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "pid": 4242, "tid": 9,
                       "ts": ts + n + 0.5, "dur": 1.0,
                       "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add",
                       "pid": 4242, "tid": 9, "ts": ts + n, "dur": 2.0})
        ev.append({"ph": "X", "cat": cat, "name": f"kernel_{i}",
                   "pid": dev, "tid": 7, "ts": ts + 50.0, "dur": dur,
                   "args": {"correlation": corr if stack else None,
                            "device": dev}})
        ts += 100.0
    return ev


def test_devtime_attributes_kineto_and_jax_traces_alike():
    want = jdevtime.attribute_events(_jax_trace())
    got = devtime.attribute_events(_kineto_trace())
    assert got["per_stage"] == pytest.approx(want["per_stage"], abs=1e-12)
    assert set(got["per_stage"]) == set(want["per_stage"]) == {
        "selection/rolling", "solver/admm", "backtest/pnl",
        "selection/rolling_metrics"}
    assert got["unattributed_s"] == pytest.approx(want["unattributed_s"],
                                                  abs=1e-12)
    assert got["device_s"] == pytest.approx(want["device_s"], abs=1e-12)
    assert got["device_tracks"] == want["device_tracks"] == 2
    # the port reads the JAX-shaped trace as the JAX package does
    again = devtime.attribute_events(_jax_trace())
    assert again == want
    assert devtime.CANONICAL_STAGES[0] == jdevtime.CANONICAL_STAGES[0]
    assert set(jdevtime.CANONICAL_STAGES) <= set(devtime.CANONICAL_STAGES)


def test_capture_skips_with_the_jax_reason_on_cpu():
    f = jax.jit(lambda x: (x * x).sum())
    x = jnp.ones((64,))
    f(x).block_until_ready()
    want = jdevtime.capture(f, x)
    got = devtime.capture(lambda t: (t * t).sum(), torch.ones(64))
    assert got["skipped"] == want["skipped"]
    assert "no device tracks" in got["skipped"] and "cpu" in got["skipped"]
    assert set(got) == set(want) and got["wall_s"] >= 0.0
    row = obs.RunReport("t").add_devtime("step", lambda t: t + 1.0,
                                         torch.ones(8))
    jrow = jobs.RunReport("t").add_devtime("step", jax.jit(lambda t: t + 1.0),
                                           jnp.ones(8))
    assert set(row) == set(jrow) and row["skipped"] == jrow["skipped"]

    def crash(t):
        raise ZeroDivisionError("the step's own crash")

    with pytest.raises(ZeroDivisionError):
        obs.RunReport("t").add_devtime("step", crash, torch.ones(2))


def _cli(*argv):
    return subprocess.run([sys.executable, *map(str, argv)],
                          capture_output=True, text=True, timeout=120)


def _market(f=4, d=24, n=8, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(f, d, n)), rng.normal(scale=0.02, size=(d, n)),
            rng.normal(scale=0.01, size=(d, f)), np.ones((d, n)),
            np.ones((d, n)), rng.uniform(size=(d, n)) > 0.05)


_NAMES = ("a_x", "b_x", "c_y", "d_y")
_EQUAL = dict(names=_NAMES, window=6, select_method="icir_top",
              blend_method="zscore", sim_kwargs=dict(method="equal",
                                                     pct=0.3))


def test_trace_report_strict_and_report_diff_read_a_port_report(
        tmp_path, monkeypatch):
    from factormodeling_tpu_torch.parallel import (make_mesh,
                                                   make_sharded_research_step)

    raw = _market()
    mesh = make_mesh(("factor", "date"), device="cpu")
    step, shard = make_sharded_research_step(mesh, **_EQUAL)
    rep = obs.RunReport("telemetry", comms=True, latency=True)
    with rep.activate():
        step(*shard(*raw))              # compile + placement rows
        step(*shard(*raw))              # a steady-state call
    rep.add_cost_analysis("research_step", step, *shard(*raw))
    # the device-time rows of a card's trace: the synthetic Kineto step
    attr = devtime.attribute_events(_kineto_trace())
    monkeypatch.setattr(devtime, "capture", lambda *a, **k: {
        "wall_s": 0.01, "device_s": attr["device_s"],
        "per_stage": attr["per_stage"],
        "unattributed_s": attr["unattributed_s"],
        "host_overhead_frac": 1.0 - attr["device_s"] / 0.01,
        "device_tracks": attr["device_tracks"], "trace_path": None})
    total = rep.add_devtime("research_step", step, *shard(*raw))
    assert total["device_s"] == pytest.approx(
        sum(r["device_s"] for r in rep.rows if r["kind"] == "devtime"
            and r["stage"] != "total") + total["unattributed_s"])
    kinds = {r["kind"] for r in rep.rows}
    assert {"compile", "comms", "memory", "sharding", "devtime",
            "cost"} <= kinds
    assert rep.meta["mesh_shape"] == {"factor": 1, "date": 1}
    path = rep.write_jsonl(tmp_path / "port.jsonl")
    strict = _cli(TOOLS / "trace_report.py", path, "--strict")
    assert strict.returncode == 0, strict.stdout[-2000:] + strict.stderr
    for table in ("compile telemetry", "comms ledger", "device memory",
                  "sharding lint", "device time", "cost analysis"):
        assert table in strict.stdout
    same = _cli(TOOLS / "report_diff.py", path, path, "--no-wall")
    assert same.returncode == 0, same.stdout[-2000:] + same.stderr


def test_queue_ledger_costs_read_the_placement_rows():
    from factormodeling_tpu_torch.serve.queue import _ledger_costs

    rep = obs.RunReport("q")
    rep.record("serve/bucket/x", kind="comms", stage="total",
               bytes_moved=12.0)
    rep.record("serve/bucket/x", kind="memory", peak_bytes=34)
    assert _ledger_costs("serve/bucket/x") == {}        # no active report
    with rep.activate():
        assert _ledger_costs("serve/bucket/x") == {"comms_bytes": 12.0,
                                                   "mem_bytes": 34.0}
        assert _ledger_costs("serve/bucket/y") == {}


# ------------------------------------------------------------------ cost


@pytest.mark.parametrize("case", ["product", "elementwise", "reduction"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cost_of_single_ops_is_the_jax_package(case, dtype):
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(3, 4)).astype(dtype), rng.normal(
        size=(4, 5)).astype(dtype)
    v = rng.normal(size=(7,)).astype(dtype)
    m = rng.normal(size=(6, 5)).astype(dtype)
    fn, args = {"product": (lambda x, y: x @ y, (a, b)),
                "elementwise": (lambda x, y: x + y, (v, v)),
                "reduction": (lambda x: x.sum(0), (m,))}[case]
    want = jobs.cost_estimate(fn, *(jnp.asarray(x) for x in args))
    got = obs.cost_estimate(fn, *(torch.from_numpy(x) for x in args))
    assert got == want
    row = obs.RunReport("c").add_cost_analysis(
        "op", fn, *(torch.from_numpy(x) for x in args))
    assert {k: row[k] for k in ("flops", "bytes_accessed")} == want


def test_cost_of_the_equal_weight_step_is_finite_and_positive():
    raw = _market()
    jax_cost = jobs.cost_estimate(jax.jit(jax_build(**_EQUAL)),
                                  *(jnp.asarray(a) for a in raw))
    inputs, cfg = fmt.convert(*raw, **_EQUAL, device="cpu")
    cost = obs.cost_estimate(fmt.build_research_step(**cfg.as_kwargs()),
                             *inputs)
    for c in (cost, jax_cost):
        assert set(c) == {"flops", "bytes_accessed"}
        assert all(np.isfinite(v) and v > 0 for v in c.values())
    # a call that reads a host value has data-dependent work
    fail = obs.cost_estimate(lambda x: x.sum().item(), torch.ones(3))
    assert np.isnan(fail["flops"]) and "host" in fail["error"]
