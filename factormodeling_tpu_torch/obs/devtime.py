"""Profiler device-time attribution: where the per-step latency lives
(port of ``factormodeling_tpu/obs/devtime.py``).

Every wall the report layer publishes is host time: a fenced
``time.perf_counter`` window around launches, device work and copies. A
host wall cannot say which ``obs.stage`` owns the device time. This module
runs one extra fenced call of a warm step under ``torch.profiler``
(Kineto over CUPTI on the card), exports the Chrome trace and attributes
its device events to the stages ``obs.trace.stage`` opened as
``record_function`` ranges.

A Kineto trace carries no ``op_name`` path on its kernels (the JAX
package reads XLA's op metadata there). So :func:`attribute_events`
charges a device event by the host side that launched it:

- the device events are found by their category (``kernel``,
  ``gpu_memcpy``, ``gpu_memset``), not by a ``/device:`` process name;
- each follows its ``args.correlation`` to the host launch event (a
  ``cuda_runtime`` or ``cuda_driver`` call, ``cudaLaunchKernel`` and
  kin) with the same correlation id;
- the ``user_annotation`` ranges on the launch's thread that contain the
  launch are its open stages, outermost first;
- the device time goes to the OUTERMOST known stage of that stack, by the
  comms ledger's rule (``obs/comms.py``'s ``_stage_of``: earliest
  position of the joined path, longest scope on a tie), so the devtime and
  comms per-stage buckets of one step agree;
- a device event with no launch, or no known stage, goes to
  ``unattributed``.

Events of a JAX-shaped trace (``/device:*`` process tracks whose events
carry the ``op_name`` path in their name or args) are read as the JAX
package reads them, so one attribution covers both shapes.

The skip ladder is the JAX package's; every rung degrades to a
skip-with-reason instead of raising:

1. ``torch.profiler.profile`` unavailable or raising at start — skipped,
   reason quoted;
2. no trace exported under the trace dir;
3. the trace exports but cannot be parsed;
4. the trace parses but carries **no device tracks**: without a card the
   profiler records the CPU activity only, so CPU runs skip here with the
   backend named. The attribution itself is pinned on the CPU by a
   synthetic-trace test (``tests/test_torch_obs_telemetry.py``) and runs
   on the card's Kineto trace unchanged.

Limits, as in the JAX package: a kernel launched outside any known stage
lands in ``unattributed``; gaps between device events (launch stalls, host
syncs) show only in ``host_overhead_frac`` = 1 − device_s / wall_s; the
traced call is one extra execution of a warm step, and its wall (with the
profiler's bookkeeping) is recorded in the row, never published as a
headline.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import shutil
import tempfile
import time

import torch

from factormodeling_tpu_torch.obs import memory as _memory
from factormodeling_tpu_torch.obs.comms import STAGE_SCOPES, _stage_of

__all__ = ["CANONICAL_STAGES", "attribute_events", "capture",
           "device_tracks", "parse_trace"]

#: the attribution vocabulary: the comms ledger's stage scopes (one list,
#: shared with :mod:`~factormodeling_tpu_torch.obs.comms`) plus the
#: probe-only raw-input scope; matched by the ledger's ``_stage_of`` rule
CANONICAL_STAGES = ("ops/factors_raw",) + STAGE_SCOPES

#: Kineto's categories of device work (the events that count as device
#: time) and of the host calls that launch it
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def parse_trace(path) -> list:
    """The ``traceEvents`` list of one exported Chrome-format trace
    (``.trace.json.gz`` or plain ``.json``)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    return events


def device_tracks(events) -> dict:
    """pid -> process name for every DEVICE track in the trace.

    A JAX/XLA trace names its device lanes ``/device:TPU:0``-style through
    ``process_name`` metadata. A Kineto trace gives each card a process
    whose events are the device work (categories ``kernel``,
    ``gpu_memcpy``, ``gpu_memset``); such a pid is a device track, named
    by its ``process_name`` metadata where the trace has one. Host lanes
    (the CPU ops, the runtime calls, the annotations) are never device
    tracks."""
    names = {}
    for e in events:
        if (e.get("ph") == "M" and e.get("name") == "process_name"
                and isinstance(e.get("args"), dict)):
            names[e.get("pid")] = str(e["args"].get("name", ""))
    out = {pid: n for pid, n in names.items() if n.startswith("/device:")}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS:
            pid = e.get("pid")
            if pid not in out:
                out[pid] = names.get(pid) or f"device {pid}"
    return out


def _aggregate_lanes(events, tracks) -> set:
    """(pid, tid) of AGGREGATE thread lanes on device tracks: lanes named
    "XLA Modules" / "Steps" in a JAX/XLA trace, whose single event spans
    the whole module and overlaps the per-op lane's. They are skipped
    whenever the pid also carries a non-aggregate lane. A Kineto trace's
    device lanes are its streams ("stream 7"), never aggregates, so it
    has none."""
    lane_names: dict = {}
    for e in events:
        if (e.get("ph") == "M" and e.get("name") == "thread_name"
                and e.get("pid") in tracks
                and isinstance(e.get("args"), dict)):
            lane_names[(e["pid"], e.get("tid"))] = \
                str(e["args"].get("name", ""))
    aggregates = set()
    for pid in tracks:
        lanes = {k: v for k, v in lane_names.items() if k[0] == pid}
        agg = {k for k, v in lanes.items()
               if any(t in v.lower() for t in ("module", "step"))}
        if agg and len(agg) < len(lanes):
            aggregates |= agg
    return aggregates


def _event_text(event) -> str:
    """The searchable metadata of a JAX-shaped op event: its display name
    plus every string arg."""
    parts = [str(event.get("name", ""))]
    args = event.get("args")
    if isinstance(args, dict):
        parts.extend(str(v) for v in args.values())
    return "\n".join(parts)


def _correlation(event):
    args = event.get("args")
    return args.get("correlation") if isinstance(args, dict) else None


class _Stacks:
    """The ``user_annotation`` ranges of each host thread, for the stack
    of ranges open at a launch's timestamp."""

    def __init__(self, events):
        lanes: dict = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation":
                ts = float(e.get("ts", 0.0))
                lanes.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (ts, -float(e.get("dur", 0.0)), str(e.get("name", ""))))
        # outermost first: earlier start, then the longer range
        self._lanes = {k: sorted(v) for k, v in lanes.items()}
        self._starts = {k: [r[0] for r in v] for k, v in self._lanes.items()}

    def at(self, launch) -> list:
        key = (launch.get("pid"), launch.get("tid"))
        ranges = self._lanes.get(key)
        if not ranges:
            return []
        ts = float(launch.get("ts", 0.0))
        hi = bisect.bisect_right(self._starts[key], ts)
        return [name for start, neg_dur, name in ranges[:hi]
                if start - neg_dur >= ts]


def attribute_events(events, stages=CANONICAL_STAGES) -> dict:
    """Attribute device-event durations to named stages (module docs).

    Complete (``ph == "X"``) events on device tracks contribute their
    ``dur`` (microseconds): a Kineto device event (``kernel``,
    ``gpu_memcpy``, ``gpu_memset``) to the outermost known stage of the
    annotations open around its launch, a JAX-shaped op event to the
    ledger's match on its metadata text; with no known stage, to
    ``unattributed``. Other events on a Kineto device track (its
    ``gpu_user_annotation`` mirrors of the host ranges) are not device
    work and are skipped. Aggregate lanes are excluded
    (:func:`_aggregate_lanes`). Returns ``{"device_s": total,
    "per_stage": {stage: seconds}, "unattributed_s": seconds,
    "device_tracks": n}`` (seconds, not µs)."""
    tracks = device_tracks(events)
    skip_lanes = _aggregate_lanes(events, tracks)
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS:
            c = _correlation(e)
            if c is not None:
                launches[c] = e
    stacks = _Stacks(events)
    per_stage: dict[str, float] = {}
    unattributed = 0.0
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in tracks \
                or (e.get("pid"), e.get("tid")) in skip_lanes:
            continue
        cat = e.get("cat")
        if cat is not None and cat not in _DEVICE_CATS \
                and not tracks[e.get("pid")].startswith("/device:"):
            continue
        dur_s = float(e.get("dur", 0.0)) * 1e-6
        if dur_s <= 0.0:
            continue
        total += dur_s
        if cat in _DEVICE_CATS:
            launch = launches.get(_correlation(e))
            path = "/".join(stacks.at(launch)) if launch is not None else ""
            stage = _stage_of([path], stages) if path else "unattributed"
        else:
            stage = _stage_of([_event_text(e)], stages)
        if stage == "unattributed":
            unattributed += dur_s
        else:
            per_stage[stage] = per_stage.get(stage, 0.0) + dur_s
    return {"device_s": total, "per_stage": per_stage,
            "unattributed_s": unattributed, "device_tracks": len(tracks)}


def _trace_files(trace_dir) -> set:
    paths = glob.glob(os.path.join(str(trace_dir), "**",
                                   "*.trace.json.gz"), recursive=True)
    paths += glob.glob(os.path.join(str(trace_dir), "**", "*.trace.json"),
                       recursive=True)
    return set(paths)


def _newest_trace(trace_dir, exclude=frozenset()) -> "str | None":
    """The newest trace export under ``trace_dir`` that is not in
    ``exclude`` (the files present before this capture started): a kept
    ``trace_dir`` is reusable across captures, and a capture whose
    profiler exported nothing must not attribute the previous capture's
    trace. Files that vanish between the glob and the stat rank last."""
    def mtime(p):
        try:
            return os.path.getmtime(p)
        except OSError:
            return float("-inf")

    paths = _trace_files(trace_dir) - set(exclude)
    newest = max(paths, key=mtime) if paths else None
    return newest if newest is not None and mtime(newest) > float("-inf") \
        else None


def _fence(out) -> None:
    """Wait for ``out``'s devices and the current card: the trace must
    hold every kernel the call launched."""
    _memory._fence(out)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def capture(fn, *args, stages=CANONICAL_STAGES, trace_dir=None,
            **kwargs) -> dict:
    """Trace ONE fenced execution of ``fn(*args, **kwargs)`` under
    ``torch.profiler`` and attribute its device time (module docs).
    Returns either ``{"wall_s", "device_s", "per_stage", "unattributed_s",
    "host_overhead_frac", "device_tracks", "trace_path"}`` or
    ``{"skipped": reason, "wall_s": ...}`` from the skip ladder. Never
    raises on profiler trouble; ``fn``'s own exceptions propagate.

    ``trace_dir=None`` (default) exports into a temporary directory
    deleted after parsing; pass a path to keep the raw trace
    (``<trace_dir>/devtime_<ns>.trace.json``)."""
    from torch.profiler import ProfilerActivity, profile

    keep = trace_dir is not None
    tdir = str(trace_dir) if keep else tempfile.mkdtemp(prefix="fm_devtime_")
    cuda = torch.cuda.is_available()
    backend = "gpu" if cuda else "cpu"
    preexisting = _trace_files(tdir) if keep else frozenset()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    try:
        os.makedirs(tdir, exist_ok=True)
        try:
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception as e:
            t0 = time.perf_counter()
            _fence(fn(*args, **kwargs))
            return {"skipped": f"profiler unavailable: {e}",
                    "wall_s": round(time.perf_counter() - t0, 6)}
        try:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _fence(out)
            wall = time.perf_counter() - t0
        except BaseException:
            try:
                prof.__exit__(None, None, None)
            except Exception:
                pass
            raise
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(
                tdir, f"devtime_{time.time_ns()}.trace.json"))
        except Exception as e:
            return {"skipped": f"profiler export failed: {e}",
                    "wall_s": round(wall, 6)}
        path = _newest_trace(tdir, exclude=preexisting)
        if path is None:
            return {"skipped": f"no trace exported under {tdir}",
                    "wall_s": round(wall, 6)}
        try:
            events = parse_trace(path)
        except Exception as e:
            return {"skipped": f"trace unparseable: {e}",
                    "wall_s": round(wall, 6)}
        attr = attribute_events(events, stages)
        if attr["device_tracks"] == 0:
            return {"skipped":
                    f"no device tracks in the exported trace (backend "
                    f"'{backend}' exposes host threads only)",
                    "wall_s": round(wall, 6)}
        frac = max(0.0, 1.0 - attr["device_s"] / wall) if wall > 0 else None
        # device seconds to the nanosecond (Kineto's resolution), so the
        # stages and the unattributed bucket sum to device_s within 1e-9
        # a stage
        return {"wall_s": round(wall, 6),
                "device_s": round(attr["device_s"], 9),
                "per_stage": {k: round(v, 9)
                              for k, v in sorted(attr["per_stage"].items())},
                "unattributed_s": round(attr["unattributed_s"], 9),
                "host_overhead_frac": (round(frac, 6)
                                       if frac is not None else None),
                "device_tracks": attr["device_tracks"],
                "trace_path": path if keep else None}
    finally:
        if not keep:
            shutil.rmtree(tdir, ignore_errors=True)
