"""Host-side run report: span timers, counter summaries, numerics probes,
entry-point call rows, placement-ledger rows (comms, memory, sharding),
device-time rows and cost rows merged into one JSONL/dict artifact (port
of ``factormodeling_tpu/obs/report.py``), in the JAX package's row schema.

The library's layers (``parallel/sweep.py``, the compat ``Simulation``,
the instrumented entry points of ``obs/compile_log.py``) record into the
*active* report when one is installed, and are no-ops when none is (the
default).

Span timing: CUDA launches are asynchronous, so a wall-clock window that
does not wait for its outputs measures the enqueue. ``span(...)`` builds the
fence in: tensors registered on the handle have their devices synchronized
inside the measured window. Device-memory gauges come from
``obs.memory.live_watermark`` (the caching allocator's); without a card
the span rows carry none, as the JAX package's carry none on the CPU.
:func:`cost_estimate` tallies the ATen operations of one call
(``obs/_cost.py``), where the JAX package reads XLA's cost analysis.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import torch

from factormodeling_tpu_torch.obs.counters import (StageCounters,
                                                   summarize_counters)
from factormodeling_tpu_torch.obs.latency import LatencyRecorder
from factormodeling_tpu_torch.obs.memory import _tensors, live_watermark

__all__ = ["RunReport", "SCHEMA_VERSION", "SpanHandle", "active_report",
           "code_fingerprint", "cost_estimate", "live_watermark",
           "record_stage", "span"]

#: the JAX package's report row-schema version: the rows this module writes
#: are a subset of its kinds, with the same fields
SCHEMA_VERSION = 5

_ACTIVE: "RunReport | None" = None


def active_report() -> "RunReport | None":
    """The currently installed report (``RunReport.activate``), or None."""
    return _ACTIVE


_CODE_FP: "str | None" = None


def code_fingerprint() -> "str | None":
    """Content hash of the ``factormodeling_tpu_torch`` source tree: every
    ``*.py`` and ``csrc`` file's relative path and bytes, in sorted path
    order. None when the tree cannot be read; computed once a process."""
    global _CODE_FP
    if _CODE_FP is None:
        try:
            root = Path(__file__).resolve().parents[1]
            h = hashlib.sha256()
            for p in sorted(q for q in root.rglob("*")
                            if q.is_file() and (q.suffix == ".py"
                                                or q.parent.name == "csrc")):
                h.update(p.relative_to(root).as_posix().encode() + b"\x00")
                h.update(p.read_bytes())
            _CODE_FP = h.hexdigest()[:16]
        except OSError:
            _CODE_FP = ""
    return _CODE_FP or None


def record_stage(name: str, **fields) -> None:
    """Record one stage row into the active report; no-op without one."""
    if _ACTIVE is not None:
        _ACTIVE.record(name, **fields)


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists, dicts,
    named tuples and dataclasses."""
    out.update(t.device for t in _tensors(obj, []) if t.is_cuda)
    return out


class SpanHandle:
    """Yielded by :func:`RunReport.span`; lets the body register outputs to
    fence on and extra fields to attach to the row."""

    def __init__(self):
        self._outputs = []
        self.fields: dict = {}

    def add(self, *outputs):
        """Register tensors (or nests of them) whose completion the span
        must wait for before the clock stops."""
        self._outputs.extend(outputs)
        return outputs[0] if len(outputs) == 1 else outputs


class RunReport:
    """Aggregator for one run's observability artifact.

    Rows are dicts with a ``kind`` ("span" | "counters" | "cost" | "stage")
    and a ``name``; :meth:`write_jsonl` emits one JSON object per row with
    the report's label/meta folded in. Install as the process-wide sink with
    :meth:`activate` so library layers can contribute rows::

        rep = RunReport("demo")
        with rep.activate():
            with rep.span("sweep") as sp:
                sp.add(manager_sweep(factors, combos, settings))
        rep.write_jsonl("run_report.jsonl")

    ``latency=True`` (or a :class:`LatencyRecorder`) folds every fenced span
    exit into the scope's quantile sketch; repeated same-name spans roll up
    into it instead of appending one row each, and ``slos`` judge the
    ``kind="latency"`` rows. Instrumented entry points
    (``obs.instrument_jit``) then record each steady-state call's fenced
    wall too.

    ``comms=True``: every instrumented entry point's call that "compiled"
    (the first call of a signature) contributes its placement rows
    (:meth:`add_placement`) from that same call. False (the default) runs
    none of it.
    """

    def __init__(self, label: str | None = None, meta: dict | None = None,
                 *, comms: bool = False, latency=False, slos=()):
        self.label = label
        self.meta = dict(meta or {})
        self.rows: list[dict] = []
        self.comms = bool(comms)
        self.slos = tuple(slos)
        if latency or self.slos:
            if isinstance(latency, bool):
                latency = LatencyRecorder()
            elif not isinstance(latency, LatencyRecorder):
                raise TypeError(
                    f"latency must be a bool or a LatencyRecorder, got "
                    f"{type(latency).__name__}")
            self.latency = latency
        else:
            self.latency = None
        self._span_row_names: set = set()
        self._span_mem_max: dict = {}

    # ------------------------------------------------------------- recording

    def record(self, name: str, *, kind: str = "stage", **fields) -> dict:
        row = {"kind": kind, "name": name, **fields}
        self.rows.append(row)
        return row

    @contextmanager
    def span(self, name: str, **fields):
        """Wall-clock a block, fencing on registered outputs at exit.

        The devices of the tensors registered through
        :meth:`SpanHandle.add` are synchronized inside the window, so
        ``wall_s`` covers the device work. A body that raises still records
        its row, marked ``error: true`` and ``fenced: false`` (the fence is
        skipped on that path); the exception propagates. With a card, the
        exit also samples the device-memory gauges into
        ``mem_bytes_in_use`` / ``mem_peak_bytes``.

        With a latency recorder, every sound clean exit (fenced outputs, or
        a declared ``sync="host"`` window) feeds the scope's sketch, and
        repeated same-name spans fold into it instead of appending a row;
        the first occurrence keeps its span row.
        """
        handle = SpanHandle()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield handle
            finally:
                raised = sys.exc_info()[0] is not None
                if handle._outputs and not raised:
                    for dev in _cuda_devices(handle._outputs, set()):
                        torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                err = {"error": True} if raised else {}
                gauges = live_watermark()
                mem = ({"mem_bytes_in_use": gauges["bytes_in_use"],
                        "mem_peak_bytes": gauges["peak_bytes_in_use"]}
                       if gauges is not None else {})
                sound = (bool(handle._outputs)
                         or fields.get("sync") == "host"
                         or handle.fields.get("sync") == "host")
                fold = self.latency is not None and not raised and sound
                if fold:
                    self.latency.observe(name, wall)
                    if mem:
                        self._span_mem_max[name] = max(
                            self._span_mem_max.get(name, 0),
                            mem["mem_peak_bytes"])
                suppress = fold and name in self._span_row_names
                if fold and not suppress:
                    self._span_row_names.add(name)
                if not suppress:
                    self.record(name, kind="span", wall_s=round(wall, 6),
                                fenced=bool(handle._outputs) and not raised,
                                **{**fields, **handle.fields, **mem, **err})

    def add_counters(self, name: str, counters) -> None:
        """A counters row from a :class:`~.counters.StageCounters` (summarized
        by :func:`~.counters.summarize_counters`) or a dict of scalars. None
        is ignored, so callers can pass ``output.counters``
        unconditionally."""
        if counters is None:
            return
        if isinstance(counters, dict):
            self.record(name, kind="counters", counters=counters)
            return
        if not isinstance(counters, StageCounters):
            raise TypeError(f"counters must be a StageCounters or a dict, "
                            f"got {type(counters).__name__}")
        self.record(name, kind="counters",
                    counters=summarize_counters(counters))

    def add_probes(self, name: str, probes, baseline: dict | None = None,
                   tol: float = 1e-6) -> dict | None:
        """Record a step's numerics probes (``ResearchOutput.probes``, a
        ``{stage: ProbeFrame}`` dict) as one ``kind="numerics"`` row per
        stage and a ``kind="watchdog"`` attribution row; the frames come to
        the host in one copy. None is ignored, so callers can pass
        ``output.probes`` unconditionally. ``baseline`` maps stage -> known
        good finite fraction (``obs.regression.numerics_baseline`` extracts
        one from a clean report), or a :func:`~.probes.probe_profile`.
        Returns the watchdog row (None when no probes were given)."""
        if not probes:
            return None
        from factormodeling_tpu_torch.obs import probes as _probes

        summaries = _probes.summarize_probes(probes)
        for stage, summary in summaries.items():
            self.record(name, kind="numerics", stage=stage, **summary)
        verdict = _probes.watchdog(summaries, baseline=baseline, tol=tol)
        return self.record(name, kind="watchdog", **verdict)

    def add_cost_analysis(self, name: str, fn, *args, **kwargs) -> dict:
        """A ``kind="cost"`` row, ``{"flops", "bytes_accessed"}``, from the
        ATen operations of one call of ``fn(*args, **kwargs)``
        (``obs/_cost.py``: on ``meta`` stand-ins where ``fn`` runs on them,
        else on the given arguments, which runs ``fn`` once more). A call
        that reads host values, or fails, records the JAX package's
        failure form, NaN fields and an ``error``; nothing raises."""
        from factormodeling_tpu_torch.obs import _cost

        return self.record(name, kind="cost",
                           **_cost.estimate(fn, *args, **kwargs))

    def _placement(self, name: str, target, args, kwargs, *,
                   declared_in_shardings=None, mesh=None, stages=None,
                   reraise: bool = False) -> tuple:
        """Run ``target(*args, **kwargs)`` once under the comms ledger and
        the memory measurement, and return ``(output, rows)`` with the
        placement rows (:meth:`add_placement`) not yet recorded. A failure
        gives a ``kind="comms"`` error row; with ``reraise`` the target's
        own exception propagates after it (an instrumented entry point's
        call must fail as it would without the report)."""
        from factormodeling_tpu_torch.obs import comms as _comms
        from factormodeling_tpu_torch.obs import memory as _memory

        if mesh is None:
            mesh = getattr(target, "mesh", None)
        if declared_in_shardings is None:
            declared_in_shardings = getattr(target, "declared_in_shardings",
                                            None)
        out, rows = None, []
        try:
            with _comms.recording(mesh) as ledger:
                out, mem = _memory.measure(target, *args, **kwargs)
            if stages is not None:
                ledger.ops = [op._replace(stage=_comms._stage_of(
                    [op.op_name], stages)) for op in ledger.ops]
            if ledger.mesh_shape:
                self.meta.setdefault("mesh_shape", ledger.mesh_shape)
            rows.extend(ledger.rows(name))
            gauges = _memory.live_watermark()
            if gauges is None:
                gauges = ("skipped: "
                          f"{_memory.watermark_unavailable_reason()}")
            rows.append({"kind": "memory", "name": name, **mem,
                         "device_stats": gauges})
            if declared_in_shardings is not None and mesh is not None:
                lint = _comms.sharding_lint(SimpleNamespace(
                    declared_in_shardings=declared_in_shardings, mesh=mesh),
                    (None, args))
            else:
                lint = {"clean": True, "flags": [],
                        "notes": ["no declared placements: nothing to "
                                  "lint"],
                        "checked_inputs": 0, "checked_outputs": 0,
                        "n_devices": 1}
            rows.append({"kind": "sharding", "name": name, **lint})
        except Exception as e:
            rows.append({"kind": "comms", "name": name, "error": str(e)})
            if reraise:
                self.rows.extend(rows)
                raise
        return out, rows

    def add_placement(self, name: str, target, *args,
                      declared_in_shardings=None, mesh=None, stages=None,
                      **kwargs) -> "dict | None":
        """The placement ledger of one call of ``target(*args, **kwargs)``
        (a callable; the port has no compiled artifact to read): run once
        under ``obs.comms.recording(mesh)``, it gives the
        ``kind="comms"`` rows (per-stage collective counts and byte
        estimates and a per-mesh-axis total, :mod:`.comms`), one
        ``kind="memory"`` row measured in the same call (:mod:`.memory`,
        with ``device_stats`` the live watermark or the ``"skipped:
        <reason>"`` string) and one ``kind="sharding"`` verdict of the
        handed tensors against the declared placements
        (:func:`.comms.sharding_lint`). ``mesh`` and
        ``declared_in_shardings`` default to the target's attributes;
        ``stages`` re-charges the collectives over another scope list.
        Failures record a ``kind="comms"`` error row rather than raising.
        Returns the lint verdict (or the error row)."""
        _, rows = self._placement(
            name, target, args, kwargs,
            declared_in_shardings=declared_in_shardings, mesh=mesh,
            stages=stages)
        self.rows.extend(rows)
        return rows[-1] if rows else None

    def add_devtime(self, name: str, fn, *args, stages=None,
                    trace_dir=None, **kwargs) -> dict:
        """Profiler device-time attribution of ONE extra fenced execution
        of ``fn(*args, **kwargs)`` (:mod:`.devtime`): per-stage
        ``kind="devtime"`` rows plus a ``stage="total"`` row carrying the
        host wall and ``host_overhead_frac``. A trace with no device tracks
        (the CPU) records ONE skip row with the reason. Profiler trouble
        never raises; ``fn``'s own exceptions propagate. Returns the
        total/skip row."""
        from factormodeling_tpu_torch.obs import devtime as _devtime

        kw = {"trace_dir": trace_dir, **kwargs}
        if stages is not None:
            kw["stages"] = stages
        summary = _devtime.capture(fn, *args, **kw)
        if "skipped" in summary:
            return self.record(name, kind="devtime", stage="total",
                               skipped=summary["skipped"],
                               wall_s=summary.get("wall_s"))
        for stage, secs in summary["per_stage"].items():
            self.record(name, kind="devtime", stage=stage, device_s=secs)
        return self.record(
            name, kind="devtime", stage="total",
            device_s=summary["device_s"],
            unattributed_s=summary["unattributed_s"],
            wall_s=summary["wall_s"],
            host_overhead_frac=summary["host_overhead_frac"],
            device_tracks=summary["device_tracks"],
            **({"trace_path": summary["trace_path"]}
               if summary.get("trace_path") else {}))

    def latency_rows(self) -> list:
        """The recorder's ``kind="latency"`` rows (one per scope, sorted,
        SLO-judged), each with the scope's device-memory peak where the
        spans sampled one; empty with latency off."""
        if self.latency is None:
            return []
        rows = self.latency.rows(self.slos)
        for row in rows:
            peak = self._span_mem_max.get(row["name"])
            if peak is not None:
                row["mem_peak_bytes_max"] = peak
        return rows

    # ------------------------------------------------------------ lifecycle

    @contextmanager
    def activate(self):
        """Install this report as the process-wide sink for
        :func:`record_stage` (and the layers that call it)."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev

    # -------------------------------------------------------------- output

    def header(self) -> dict:
        """The ``kind="meta"`` header row: row-schema version, the torch
        version, the device (the card's name and count, or the CPU) and a
        content hash of the port's source tree."""
        cuda = torch.cuda.is_available()
        return {"kind": "meta", "name": "report",
                "schema_version": SCHEMA_VERSION,
                "torch_version": torch.__version__,
                "backend": "gpu" if cuda else "cpu",
                "device_kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                "device_count": torch.cuda.device_count() if cuda else 1,
                "process_count": 1,
                "mesh_shape": self.meta.get("mesh_shape"),
                "code_fingerprint": code_fingerprint()}

    def all_rows(self) -> list:
        """Header + recorded rows + the latency rollup rows: what
        :meth:`write_jsonl` emits."""
        return [self.header()] + self.rows + self.latency_rows()

    def to_dict(self) -> dict:
        return {"label": self.label, "meta": self.meta, "rows": self.rows}

    def write_jsonl(self, path) -> Path:
        """One JSON object per row, ``kind="meta"`` header first (label and
        meta folded into each row); returns the path."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as fh:
            for row in self.all_rows():
                out = dict(row)
                if self.label is not None:
                    out.setdefault("label", self.label)
                if self.meta:
                    out.setdefault("meta", self.meta)
                fh.write(json.dumps(out, default=_json_default) + "\n")
        return path


def _json_default(o):
    """Last-resort JSON coercion: numpy scalars and arrays, 0-d tensors and
    paths."""
    import numpy as np

    if isinstance(o, torch.Tensor):
        return o.tolist()
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


@contextmanager
def span(name: str, **fields):
    """Module-level span: records into the active report when one is
    installed, else into a throwaway report (still useful for its fence and
    profiler annotation)."""
    rep = _ACTIVE if _ACTIVE is not None else RunReport()
    with rep.span(name, **fields) as handle:
        yield handle


def cost_estimate(fn, *args, **kwargs) -> dict:
    """Standalone ``{"flops": ..., "bytes_accessed": ...}`` estimate of one
    call of ``fn`` at the given args (:meth:`RunReport.add_cost_analysis`;
    NaN fields and an ``error`` where it reads host values or fails)."""
    rep = RunReport()
    row = rep.add_cost_analysis("estimate", fn, *args, **kwargs)
    return {k: row.get(k, float("nan"))
            for k in ("flops", "bytes_accessed")} | (
        {"error": row["error"]} if "error" in row else {})
