"""Host-side run report: span timers, counter summaries and cost rows merged
into one JSONL/dict artifact (port of ``factormodeling_tpu/obs/report.py``,
the part the library layers call).

The library's layers (``parallel/sweep.py``, the compat ``Simulation``)
record into the *active* report when one is installed, and are no-ops when
none is (the default).

Span timing: CUDA launches are asynchronous, so a wall-clock window that
does not wait for its outputs measures the enqueue. ``span(...)`` builds the
fence in: tensors registered on the handle have their devices synchronized
inside the measured window. Device-memory gauges come from
``torch.cuda.memory_stats()``; without a card the span rows carry none, as
the JAX package's carry none on the CPU. PyTorch has no ahead-of-time cost analysis (the JAX package
reads XLA's), so :func:`cost_estimate` returns the JAX package's failure
form: NaN fields and an ``error`` string.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from factormodeling_tpu_torch.obs.counters import (StageCounters,
                                                   summarize_counters)
from factormodeling_tpu_torch.obs.latency import LatencyRecorder

__all__ = ["RunReport", "SCHEMA_VERSION", "SpanHandle", "active_report",
           "code_fingerprint", "cost_estimate", "live_watermark",
           "record_stage", "span"]

#: the JAX package's report row-schema version: the rows this module writes
#: are a subset of its kinds, with the same fields
SCHEMA_VERSION = 5

_COST_ERROR = ("PyTorch has no ahead-of-time cost analysis; no FLOP or "
               "byte estimate is made")

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


def live_watermark() -> "dict | None":
    """Current device-memory gauges of the card, or None without one:
    ``{"bytes_in_use", "peak_bytes_in_use", "devices"}`` over the visible
    cards (``torch.cuda.memory_stats``: the caching allocator's allocated
    bytes, now and at their peak)."""
    if not torch.cuda.is_available():
        return None
    in_use, peak, n = 0, 0, torch.cuda.device_count()
    for i in range(n):
        stats = torch.cuda.memory_stats(i)
        in_use += int(stats.get("allocated_bytes.all.current", 0))
        peak = max(peak, int(stats.get("allocated_bytes.all.peak", 0)))
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak, "devices": n}


def record_stage(name: str, **fields) -> None:
    """Record one stage row into the active report; no-op without one."""
    if _ACTIVE is not None:
        _ACTIVE.record(name, **fields)


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists, dicts,
    named tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), out)
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
    ``kind="latency"`` rows.
    """

    def __init__(self, label: str | None = None, meta: dict | None = None,
                 *, latency=False, slos=()):
        self.label = label
        self.meta = dict(meta or {})
        self.rows: list[dict] = []
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

    def add_cost_analysis(self, name: str, fn=None, *args, **kwargs) -> dict:
        """A ``kind="cost"`` row in the JAX package's failure form: PyTorch
        has no ahead-of-time cost analysis, and running ``fn`` again under a
        FLOP counter would double the reported work. ``fn`` and its
        arguments are accepted for the JAX package's signature and not
        called."""
        del fn, args, kwargs
        return self.record(name, kind="cost", error=_COST_ERROR)

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
    """``{"flops", "bytes_accessed", "error"}`` in the JAX package's failure
    form (NaN fields; see :meth:`RunReport.add_cost_analysis`)."""
    del fn, args, kwargs
    return {"flops": float("nan"), "bytes_accessed": float("nan"),
            "error": _COST_ERROR}
