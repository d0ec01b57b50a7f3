"""Request flight recorder: per-request causal span trees on the virtual
clock, plus the ring-buffered health series.

Every other telemetry rail is AGGREGATE — latency sketches,
stage counters, verdict totals. When one tenant's request misses its
deadline, none of them can answer "where did its time go, which dispatch
carried it, and who shared that dispatch?". This module records the
missing artifact: one causal span tree per request (and per
``OnlineEngine`` tick), on the SAME explicit virtual clock the serving
queue schedules with, so the trace is a reproducible artifact and not a
race transcript — the same contract ``serve/queue.py`` holds for its
verdict log.

The span taxonomy (docs/architecture.md section 25):

- a root ``request`` span per trace, ``[arrival, terminal verdict]``;
- instant events for the admission decision (``admit`` / ``shed`` /
  ``reject`` / ``cheap_fallback`` / ``stale``);
- a ``queue/wait`` span from admission to batch formation;
- a ``dispatch`` span shared by every chunk member (the CAUSAL LINK:
  each member's tree carries the dispatch span with the same
  ``dispatch`` index, its rung, pad fraction, and downgrade/degrade
  marks, plus ``members`` — the trace ids that shared it);
- per-attempt child spans inside the dispatch (retries reuse the
  ``resil`` attempt indices, faults named);
- a ``demux`` event and the terminal ``verdict`` event.

Hard completeness invariant, judged from the artifact: every terminal
verdict has exactly ONE finished trace whose spans are all closed and
properly nested (children inside parents), and every ``members`` trace
id resolves to a trace in the same report — :func:`row_errors` is the
checker ``tools/trace_report.py --strict`` and the tests share.

:func:`chrome_trace` renders the rows as a Chrome-trace/Perfetto
timeline (``tools/trace_report.py --timeline``) — the same
``traceEvents`` format the JAX package's ``obs.devtime`` *parses*,
produced in reverse: one thread lane per trace, one ``X`` event per
span, timestamps in virtual microseconds.

Pure stdlib by design (no numpy/jax): ``tools/trace_report.py`` loads
this file standalone by path — the ``obs.latency`` / ``obs.regression``
contract — so traces render and validate on any box that has the JSONL.
"""

from __future__ import annotations

__all__ = ["FlightRecorder", "HealthSeries", "chrome_trace", "row_errors"]

#: nesting tolerance of the row-level validator: row times are rounded
#: to 1e-9 before emission, so a child sharing its parent's boundary can
#: land one rounding step outside it
_NEST_EPS = 2e-9


def _round9(t):
    return None if t is None else round(float(t), 9)


class FlightRecorder:
    """Per-trace causal span trees on an explicit clock (module docs).

    Every method takes the event time ``t`` explicitly — the recorder
    never reads an ambient clock, mirroring the queue's ``VirtualClock``
    discipline. Span ids are per-trace ordinals; the root span is id 0.
    State round-trips through a JSON-scalar dict (:meth:`state`), which
    is how the recorder rides the queue's checkpoint seam: a resumed
    run's trace log is byte-equal to a straight-through run's.
    """

    def __init__(self):
        # trace_id -> {"trace_id", "tenant", "verdict", "spans": [span]}
        # span: {"id", "parent", "name", "t0", "t1", "attrs": {...}}
        self.traces: dict = {}
        self._order: list = []  # insertion order for deterministic rows

    # ----------------------------------------------------------- recording

    def begin(self, trace_id, *, t, tenant=None, **attrs) -> None:
        trace_id = str(trace_id)
        if trace_id in self.traces:
            raise ValueError(f"trace {trace_id!r} already begun — trace "
                             f"ids must be unique per recorder")
        root = {"id": 0, "parent": None, "name": "request",
                "t0": float(t), "t1": None, "attrs": dict(attrs)}
        self.traces[trace_id] = {"trace_id": trace_id,
                                 "tenant": (None if tenant is None
                                            else str(tenant)),
                                 "verdict": None, "spans": [root]}
        self._order.append(trace_id)

    def _trace(self, trace_id) -> dict:
        tr = self.traces.get(str(trace_id))
        if tr is None:
            raise KeyError(f"unknown trace {trace_id!r} — begin() it "
                           f"first")
        return tr

    def open(self, trace_id, name: str, *, t, parent: int = 0,
             **attrs) -> int:
        """Open a child span; returns its id (pass back to :meth:`close`).
        ``parent`` defaults to the root span."""
        tr = self._trace(trace_id)
        sid = len(tr["spans"])
        if not any(s["id"] == parent for s in tr["spans"]):
            raise ValueError(f"trace {trace_id!r}: parent span {parent} "
                             f"does not exist")
        tr["spans"].append({"id": sid, "parent": int(parent),
                            "name": str(name), "t0": float(t), "t1": None,
                            "attrs": dict(attrs)})
        return sid

    def close(self, trace_id, sid: int, *, t, **attrs) -> None:
        tr = self._trace(trace_id)
        span = next((s for s in tr["spans"] if s["id"] == sid), None)
        if span is None:
            raise ValueError(f"trace {trace_id!r}: no span {sid}")
        if span["t1"] is not None:
            raise ValueError(f"trace {trace_id!r}: span {sid} "
                             f"({span['name']}) already closed")
        span["t1"] = float(t)
        span["attrs"].update(attrs)

    def event(self, trace_id, name: str, *, t, parent: int = 0,
              **attrs) -> int:
        """An instant (zero-duration) span."""
        sid = self.open(trace_id, name, t=t, parent=parent, **attrs)
        self.close(trace_id, sid, t=t)
        return sid

    def finish(self, trace_id, verdict: str, *, t, **attrs) -> None:
        """Close the root span with the terminal verdict. Exactly one
        finish per trace — the completeness invariant's write side."""
        tr = self._trace(trace_id)
        if tr["verdict"] is not None:
            raise ValueError(f"trace {trace_id!r} already finished with "
                             f"{tr['verdict']!r} — a request terminates "
                             f"in exactly one verdict")
        tr["verdict"] = str(verdict)
        root = tr["spans"][0]
        root["t1"] = float(t)
        root["attrs"].update(attrs)

    # ------------------------------------------------------------ reading

    def finished(self, trace_id) -> bool:
        tr = self.traces.get(str(trace_id))
        return tr is not None and tr["verdict"] is not None

    def open_traces(self) -> list:
        """Trace ids begun but never finished — each one is a request
        that terminated in zero verdicts (or has not terminated yet)."""
        return [tid for tid in self._order
                if self.traces[tid]["verdict"] is None]

    def complete(self) -> bool:
        """True when every begun trace finished with a fully closed,
        properly nested span tree — the in-process half of the
        completeness invariant (the artifact half is :func:`row_errors`)."""
        return not self.open_traces() and not row_errors(self.rows("x"))

    def rows(self, name: str) -> list:
        """One ``kind="reqtrace"`` row per trace, insertion-ordered,
        times rounded for stable JSON (internal state stays exact — the
        checkpoint round-trip must not drift a resumed run)."""
        out = []
        for tid in self._order:
            tr = self.traces[tid]
            root = tr["spans"][0]
            spans = [{"id": s["id"], "parent": s["parent"],
                      "name": s["name"], "t0": _round9(s["t0"]),
                      "t1": _round9(s["t1"]), **s["attrs"]}
                     for s in tr["spans"]]
            out.append({"kind": "reqtrace", "name": name,
                        "trace_id": tid, "tenant": tr["tenant"],
                        "verdict": tr["verdict"],
                        "t0": _round9(root["t0"]),
                        "t1": _round9(root["t1"]),
                        "complete": tr["verdict"] is not None,
                        "spans": spans})
        return out

    # ------------------------------------------- snapshot round-trip (JSON)

    def state(self) -> dict:
        return {"order": list(self._order),
                "traces": {tid: {"tenant": tr["tenant"],
                                 "verdict": tr["verdict"],
                                 "spans": [dict(s, attrs=dict(s["attrs"]))
                                           for s in tr["spans"]]}
                           for tid, tr in self.traces.items()}}

    def load_state(self, state: dict) -> None:
        self.traces = {}
        self._order = [str(t) for t in state.get("order", ())]
        for tid, tr in state.get("traces", {}).items():
            tid = str(tid)
            spans = []
            for s in tr["spans"]:
                spans.append({
                    "id": int(s["id"]),
                    "parent": (None if s["parent"] is None
                               else int(s["parent"])),
                    "name": str(s["name"]),
                    "t0": float(s["t0"]),
                    "t1": None if s["t1"] is None else float(s["t1"]),
                    "attrs": dict(s.get("attrs", {}))})
            self.traces[tid] = {"trace_id": tid,
                                "tenant": tr.get("tenant"),
                                "verdict": tr.get("verdict"),
                                "spans": spans}


class HealthSeries:
    """Ring-buffered virtual-clock health samples, taken at dispatch
    boundaries: queue depth, dispatch lane occupancy, cumulative shed
    rate, and the live served-p99. The ring bounds the artifact; the
    MAXIMA are tracked exactly outside it, so the regression gate on
    ``max_depth`` never depends on ring truncation."""

    def __init__(self, cap: int = 512):
        if int(cap) < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.samples: list = []   # [t, depth, occupancy, shed_rate, p99]
        self.count = 0
        self.max_depth = 0
        self.max_occupancy = 0.0

    def sample(self, *, t, depth: int, occupancy: float, shed_rate: float,
               served_p99_s=None) -> None:
        self.count += 1
        self.max_depth = max(self.max_depth, int(depth))
        self.max_occupancy = max(self.max_occupancy, float(occupancy))
        self.samples.append([_round9(t), int(depth),
                             round(float(occupancy), 6),
                             round(float(shed_rate), 6),
                             _round9(served_p99_s)])
        if len(self.samples) > self.cap:
            del self.samples[0]

    def row(self, name: str) -> dict:
        return {"kind": "series", "name": name, "count": self.count,
                "cap": self.cap, "max_depth": self.max_depth,
                "max_occupancy": round(self.max_occupancy, 6),
                "fields": ["t_s", "depth", "occupancy", "shed_rate",
                           "served_p99_s"],
                "samples": [list(s) for s in self.samples]}

    def state(self) -> dict:
        return {"cap": self.cap, "count": self.count,
                "max_depth": self.max_depth,
                "max_occupancy": self.max_occupancy,
                "samples": [list(s) for s in self.samples]}

    def load_state(self, state: dict) -> None:
        self.cap = int(state.get("cap", self.cap))
        self.count = int(state.get("count", 0))
        self.max_depth = int(state.get("max_depth", 0))
        self.max_occupancy = float(state.get("max_occupancy", 0.0))
        self.samples = [list(s) for s in state.get("samples", ())]


# ------------------------------------------------- artifact-level checks


def _span_errors(row: dict) -> list:
    """Structural violations of one reqtrace row's span tree."""
    errs = []
    label = f"{row.get('name', '?')}/{row.get('trace_id', '?')}"
    spans = row.get("spans") or []
    if not spans:
        return [f"reqtrace {label}: no spans at all"]
    by_id = {}
    for s in spans:
        sid = s.get("id")
        if sid in by_id:
            errs.append(f"reqtrace {label}: duplicate span id {sid}")
        by_id[sid] = s
    for s in spans:
        sid, name = s.get("id"), s.get("name", "?")
        t0, t1 = s.get("t0"), s.get("t1")
        if t1 is None:
            errs.append(f"reqtrace {label}: span {sid} ({name}) never "
                        f"closed")
            continue
        if t1 < t0:
            errs.append(f"reqtrace {label}: span {sid} ({name}) closes "
                        f"before it opens ({t1} < {t0})")
        parent = s.get("parent")
        if parent is None:
            continue
        p = by_id.get(parent)
        if p is None:
            errs.append(f"reqtrace {label}: span {sid} ({name}) has "
                        f"unknown parent {parent} — an orphan span")
            continue
        if p.get("t1") is None:
            continue  # the parent's own unclosed error already fired
        if (t0 < p["t0"] - _NEST_EPS) or (t1 > p["t1"] + _NEST_EPS):
            errs.append(
                f"reqtrace {label}: span {sid} ({name}) "
                f"[{t0}, {t1}] overlaps outside its parent "
                f"{parent} ({p.get('name')}) [{p['t0']}, {p['t1']}]")
    return errs


def row_errors(rows) -> list:
    """The completeness invariant judged from report rows alone (the
    ``--strict`` checker): every ``kind="reqtrace"`` row must be a
    finished, fully closed, properly nested tree; every dispatch span's
    ``members`` trace id must resolve to a trace under the same name
    (no orphan trace ids); and when a ``kind="serving"`` row shares a
    recorder's name, the trace count must equal its submissions — a
    submitted request with no trace is exactly the silent drop the
    flight recorder exists to make impossible."""
    errs = []
    traces: dict = {}   # name -> set of trace ids
    for r in rows:
        if r.get("kind") != "reqtrace":
            continue
        name, tid = r.get("name", "?"), r.get("trace_id")
        traces.setdefault(name, set()).add(tid)
        if not r.get("complete") or not r.get("verdict"):
            errs.append(f"reqtrace {name}/{tid}: trace never finished "
                        f"(no terminal verdict)")
        errs.extend(_span_errors(r))
    for r in rows:
        if r.get("kind") != "reqtrace":
            continue
        name, tid = r.get("name", "?"), r.get("trace_id")
        known = traces.get(name, set())
        for s in r.get("spans") or []:
            for member in s.get("members") or []:
                if str(member) not in known:
                    errs.append(
                        f"reqtrace {name}/{tid}: dispatch span "
                        f"{s.get('id')} links member trace "
                        f"{member!r} with no reqtrace row — an orphan "
                        f"trace id")
    for r in rows:
        if r.get("kind") != "serving":
            continue
        name = r.get("name", "?")
        if name not in traces:
            continue  # recorder off for this queue — nothing to judge
        submitted = r.get("submitted")
        if isinstance(submitted, int) and len(traces[name]) != submitted:
            errs.append(
                f"reqtrace {name}: {len(traces[name])} trace(s) for "
                f"{submitted} submitted request(s) — a request has no "
                f"flight record")
    return errs


# ---------------------------------------------------- chrome-trace export


def chrome_trace(rows) -> dict:
    """Render ``kind="reqtrace"`` rows as a Chrome-trace/Perfetto
    document: one process lane per recorder name, one thread lane per
    trace, one complete (``ph="X"``) event per span, timestamps in
    VIRTUAL microseconds. The inverse of the format
    the JAX package's ``obs.devtime`` parses — load the file at
    ``chrome://tracing`` or https://ui.perfetto.dev."""
    events: list = []
    pids: dict = {}
    next_tid: dict = {}  # pid -> next thread lane (O(1), not a rescan)
    for r in rows:
        if r.get("kind") != "reqtrace":
            continue
        name = str(r.get("name", "?"))
        if name not in pids:
            pids[name] = len(pids) + 1
            events.append({"ph": "M", "pid": pids[name], "tid": 0,
                           "name": "process_name",
                           "args": {"name": name}})
        pid = pids[name]
        tid = next_tid[pid] = next_tid.get(pid, 0) + 1
        tenant = r.get("tenant")
        label = f"rid {r.get('trace_id')}" + (
            f" ({tenant})" if tenant not in (None, str(r.get("trace_id")))
            else "")
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": label}})
        for s in r.get("spans") or []:
            t0 = s.get("t0")
            t1 = s.get("t1") if s.get("t1") is not None else t0
            if t0 is None:
                continue
            args = {k: v for k, v in s.items()
                    if k not in ("id", "parent", "name", "t0", "t1")
                    and v is not None}
            args["trace_id"] = r.get("trace_id")
            if r.get("verdict") and s.get("parent") is None:
                args["verdict"] = r["verdict"]
            events.append({"ph": "X", "pid": pid, "tid": tid,
                           "name": str(s.get("name", "?")),
                           "ts": round(float(t0) * 1e6, 3),
                           "dur": round((float(t1) - float(t0)) * 1e6, 3),
                           "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
