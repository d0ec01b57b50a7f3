"""The serving traffic layer: request queue, deadline-aware micro-batching
and the verdict state machine (port of
``factormodeling_tpu/serve/queue.py``).

``TenantServer.serve`` is synchronous: submit, dispatch, demux, with no
arrival time, deadline, overload or failing dispatch. This module runs the
same dispatch under traffic:

- **requests, not lists**: every :class:`Request` carries its config, its
  (virtual) arrival time and an absolute deadline. The arrival traces
  (:func:`poisson_arrivals`, :func:`bursty_arrivals`) are seeded and drawn
  from the JAX package's host RNG lanes, so both packages draw the same
  trace. Time is an explicit :class:`VirtualClock` threaded through every
  decision, never a wall-clock read, so a verdict log is reproducible.
- **deadline-aware micro-batching**: a bucket flushes a partial rung once
  the oldest request's slack falls below the rung's estimated dispatch
  time (a per-(bucket, rung) EWMA, :class:`DispatchEstimator`, seedable
  from a latency recorder), and when the occupancy rung cannot finish
  inside the slack the batcher downgrades to the largest rung that can
  (``rung_downgrades``).
- **verdict completeness**: every submitted request ends in exactly one of
  ``SERVED | SHED | DEADLINE_MISS | FAILED``; the loop asserts the four
  counts sum to the submissions. An invalid config is a FAILED verdict (it
  does not raise out of the drain), a shed request says why, a late answer
  is delivered and marked ``DEADLINE_MISS``.
- **fault-tolerant dispatch**: each dispatch runs under
  :func:`~factormodeling_tpu_torch.resil.retry.retry_call` (bounded
  backoff on the virtual clock, capped at the chunk's latest deadline),
  with :class:`~factormodeling_tpu_torch.resil.faults.DispatchFaultPlan`
  as the fault hook.
- **checkpoint/resume**: with ``checkpoint_path`` the queue state (verdict
  log, clock, estimator, sketches, pending set, attempt counter, stale
  cache) is snapshotted through ``resil.checkpoint`` after every
  dispatch; a resumed drain serves no request twice, loses none, and its
  verdict log is byte-equal to an uninterrupted one. The
  ``_FMT_SERVE_DIE_AFTER_DISPATCH`` environment hook exits 137 right after
  the N-th dispatch's snapshot (the chaos matrix's serving kill).

The seconds charged a dispatch come from ``service_model`` (default: the
estimator's estimate), not from the wall clock; the dispatches themselves
run the real step, and their outputs are bitwise the synchronous path's.

The obs hooks are opt-in and import their modules only when asked:
``flight=`` (the request flight recorder, the per-tenant cost meter and
the health series, bundled as :class:`FlightKit`), ``lineage=`` (one
provenance edge a delivered lane) and ``sentry=`` (alerts and incidents
at every dispatch boundary, seen by ``AdmissionPolicy.on_alert``). They
run on the virtual clock, so their rows are reproducible, and their state
rides the checkpoint, so a resumed drain's rows are byte-equal to a
straight-through drain's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch import rng as rng_lanes
from factormodeling_tpu_torch._device import host_array
from factormodeling_tpu_torch.backtest.diagnostics import SolverDiagnostics
from factormodeling_tpu_torch.backtest.engine import SimulationOutput
from factormodeling_tpu_torch.backtest.pnl import DailyResult
from factormodeling_tpu_torch.obs.latency import QuantileSketch
from factormodeling_tpu_torch.obs.report import active_report, record_stage
from factormodeling_tpu_torch.parallel.pipeline import (ResearchOutput,
                                                        ResearchSummary)
from factormodeling_tpu_torch.resil import checkpoint as _ckpt
from factormodeling_tpu_torch.resil.faults import DispatchFault
from factormodeling_tpu_torch.resil.retry import retry_call
from factormodeling_tpu_torch.serve.admission import (
    CHEAP_FALLBACK,
    REJECT_NEW,
    SERVE_STALE,
    AdmissionPolicy,
    StaleCache,
)
from factormodeling_tpu_torch.serve.batched import tree_lane
from factormodeling_tpu_torch.serve.tenant import TenantConfig
from factormodeling_tpu_torch.serve.tenant import \
    config_leaves as _config_leaves

__all__ = ["DEADLINE_MISS", "FAILED", "SERVED", "SHED", "VERDICTS",
           "DispatchEstimator", "FlightKit", "QueueResult", "Request",
           "VirtualClock", "bursty_arrivals", "make_requests",
           "poisson_arrivals", "replay_traffic", "run_queued"]

#: the verdict state machine's four terminal states — every submitted
#: request ends in exactly one (the loop asserts the counts sum)
SERVED = "SERVED"
SHED = "SHED"
DEADLINE_MISS = "DEADLINE_MISS"
FAILED = "FAILED"
VERDICTS = (SERVED, SHED, DEADLINE_MISS, FAILED)

#: test hook (the chaos matrix's ``_FMT_CHAOS_DIE_AFTER_CELL`` one level
#: down): exit 137 without cleanup right after the snapshot that follows
#: this 0-based process-wide dispatch index, the mid-drain kill of the
#: resume differential. Read only when checkpointing is on.
_DIE_ENV = "_FMT_SERVE_DIE_AFTER_DISPATCH"

#: the process-wide dispatch tally the die hook reads (not queue state: a
#: resumed run starts its own tally)
_dispatch_tally = 0


# ------------------------------------------------------------ virtual time


@dataclasses.dataclass
class VirtualClock:
    """Explicit, monotonic virtual seconds — the ONLY time source the
    scheduling loop reads. Starts at 0 (or wherever the snapshot left
    it); advancing is the loop's explicit act, never an ambient read."""

    now_s: float = 0.0

    def advance(self, dt: float) -> None:
        if not (dt >= 0.0 and math.isfinite(dt)):
            raise ValueError(f"clock can only advance by a finite "
                             f"non-negative dt, got {dt!r}")
        self.now_s += dt

    def advance_to(self, t: float) -> None:
        """Jump forward to ``t`` (no-op when ``t`` is in the past —
        virtual time never rewinds)."""
        if math.isfinite(t):
            self.now_s = max(self.now_s, float(t))


def poisson_arrivals(n: int, *, rate_hz: float, seed: int = 0,
                     start_s: float = 0.0) -> np.ndarray:
    """``n`` open-loop Poisson arrival times (absolute virtual seconds):
    i.i.d. exponential gaps at ``rate_hz``, from the
    ``serve/arrivals/poisson`` RNG lane (:mod:`factormodeling_tpu_torch.
    rng`), so a poisson and a bursty trace at one seed are independent
    streams."""
    if n < 0 or rate_hz <= 0:
        raise ValueError(f"need n >= 0 and rate_hz > 0, got {n}, {rate_hz}")
    gaps = rng_lanes.lane_rng("serve/arrivals/poisson", seed).exponential(
        1.0 / rate_hz, size=int(n))
    return start_s + np.cumsum(gaps)


def bursty_arrivals(n: int, *, rate_hz: float, burst: int = 8,
                    seed: int = 0, start_s: float = 0.0) -> np.ndarray:
    """``n`` arrivals in bursts of ``burst`` simultaneous requests, with
    exponential inter-burst gaps of mean ``burst / rate_hz`` — the same
    long-run rate as :func:`poisson_arrivals`, concentrated into the
    spikes that stress admission control hardest."""
    if n < 0 or rate_hz <= 0:
        raise ValueError(f"need n >= 0 and rate_hz > 0, got {n}, {rate_hz}")
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    n_bursts = -(-int(n) // int(burst))
    gaps = rng_lanes.lane_rng("serve/arrivals/bursty", seed).exponential(
        burst / rate_hz, size=n_bursts)
    starts = start_s + np.cumsum(gaps)
    return np.repeat(starts, burst)[:int(n)]


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of traffic: who (``rid`` positionally, ``tenant`` stably),
    what (``config``), when it arrived, and the absolute virtual deadline
    by which the answer is worth having. ``tenant`` is the stable identity
    label the verdict rows carry; it defaults to ``str(rid)``
    (:meth:`label`)."""

    rid: int
    config: TenantConfig
    arrival_s: float
    deadline_s: float
    tenant: "str | None" = None

    def __post_init__(self):
        if not (self.deadline_s > self.arrival_s):
            raise ValueError(
                f"request {self.rid}: deadline {self.deadline_s!r} must be "
                f"after arrival {self.arrival_s!r}")
        if self.tenant is not None and not str(self.tenant):
            raise ValueError(f"request {self.rid}: tenant label must be "
                             f"a non-empty string or None")

    @property
    def label(self) -> str:
        """The stable tenant label (``tenant``, else ``str(rid)``)."""
        return str(self.tenant) if self.tenant is not None else str(self.rid)


def make_requests(configs, arrivals, *, deadline_s: float,
                  tenants=None) -> list:
    """Zip configs with an arrival trace under one relative deadline
    budget; rids are positional, ``tenants`` optionally labels each
    request with its stable identity."""
    arrivals = np.asarray(arrivals, dtype=float)
    configs = list(configs)
    if len(configs) != arrivals.shape[0]:
        raise ValueError(f"{len(configs)} configs vs "
                         f"{arrivals.shape[0]} arrival times")
    if tenants is None:
        tenants = [None] * len(configs)
    else:
        tenants = [None if t is None else str(t) for t in tenants]
        if len(tenants) != len(configs):
            raise ValueError(f"{len(configs)} configs vs "
                             f"{len(tenants)} tenant labels")
    return [Request(rid=i, config=c, arrival_s=float(t),
                    deadline_s=float(t) + float(deadline_s), tenant=lbl)
            for i, (c, t, lbl) in enumerate(zip(configs, arrivals,
                                                tenants))]


# ------------------------------------------------------- dispatch estimate


class DispatchEstimator:
    """Per-(bucket, rung) EWMA of dispatch service seconds — what the
    batcher compares a request's slack against.

    ``seed(...)`` installs a prior (it never overrides an observation);
    the queue seeds each (bucket, rung) from the matching
    ``serve/bucket/*`` sketch's p50 of a latency recorder the first time
    it needs the estimate. Fallback for a cold key: the bucket's nearest
    known rung, else ``default_s + lane_cost_s * rung``. Bucket keys are
    the ``repr`` of the static key, so the state round-trips through a
    JSON snapshot."""

    def __init__(self, *, alpha: float = 0.3, default_s: float = 0.05,
                 lane_cost_s: float = 0.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.default_s = float(default_s)
        self.lane_cost_s = float(lane_cost_s)
        self._est: dict = {}        # (bucket_tag, rung) -> seconds
        self._observed: set = set()  # keys backed by a real observation

    def estimate(self, bucket_tag: str, rung: int) -> float:
        v = self._est.get((bucket_tag, rung))
        if v is not None:
            return v
        known = sorted((r, s) for (b, r), s in self._est.items()
                       if b == bucket_tag)
        if known:
            _, s = min(known, key=lambda rs: abs(rs[0] - rung))
            return s
        return self.default_s + self.lane_cost_s * rung

    def seed(self, bucket_tag: str, rung: int, seconds: float) -> None:
        """Install a prior estimate; a no-op once the key exists (seeding
        must never fight live observations)."""
        self._est.setdefault((bucket_tag, int(rung)), float(seconds))

    def observe(self, bucket_tag: str, rung: int, seconds: float) -> None:
        key = (bucket_tag, int(rung))
        prev = self._est.get(key)
        if prev is None or key not in self._observed:
            self._est[key] = float(seconds)
        else:
            self._est[key] = (1 - self.alpha) * prev + self.alpha * float(seconds)
        self._observed.add(key)

    # ---- snapshot round-trip (JSON-scalar state)

    def state(self) -> dict:
        return {json.dumps([b, r]): v for (b, r), v in self._est.items()} | {
            "__observed__": sorted(json.dumps([b, r])
                                   for b, r in self._observed)}

    def load_state(self, state: dict) -> None:
        self._est = {}
        self._observed = set()
        for key, v in state.items():
            if key == "__observed__":
                continue
            b, r = json.loads(key)
            self._est[(b, int(r))] = float(v)
        for key in state.get("__observed__", ()):
            b, r = json.loads(key)
            self._observed.add((b, int(r)))


# ------------------------------------------------------------- the result


class QueueResult(NamedTuple):
    verdicts: list      # event-ordered verdict rows (dicts; the log)
    outputs: dict       # rid -> ResearchOutput lane (SERVED + DEADLINE_MISS)
    counters: dict      # the kind="serving" row's counts
    clock_s: float      # virtual makespan (last event time)
    flight: object = None  # the FlightKit when the recorder ran, else None
    traffic: list = None   # kind="traffic" arrival-trace rows (complete
    #                        drains only — the replay_traffic input)
    lineage: object = None  # the LineageLedger when provenance ran
    sentry: object = None   # the Sentry when the operations sentry ran

    def by_rid(self) -> dict:
        return {v["rid"]: v for v in self.verdicts}

    def log_lines(self) -> list:
        """The verdict log as deterministic JSONL lines — what the
        resume differential compares byte for byte."""
        return [json.dumps(v, sort_keys=True) for v in self.verdicts]


def _round(t: float) -> float:
    # verdict-row times are rounded for stable JSON; the CLOCK itself
    # stays exact (rounding scheduler state would drift a resumed run)
    return round(float(t), 9)


def _sketch_state(sk: QuantileSketch) -> dict:
    """Exact snapshot of a sketch (a rounded min/max could flip a
    post-resume quantile clamp — scheduler state must round-trip
    bit-exactly)."""
    idx = sorted(sk.counts)
    return {"idx": np.asarray(idx, np.int64),
            "cnt": np.asarray([sk.counts[i] for i in idx], np.int64),
            "count": int(sk.count),
            "total": np.asarray(sk.total, np.float64),
            "min": np.asarray(sk.min, np.float64),
            "max": np.asarray(sk.max, np.float64)}


def _sketch_restore(state: dict) -> QuantileSketch:
    sk = QuantileSketch()
    for i, c in zip(np.asarray(state["idx"]).tolist(),
                    np.asarray(state["cnt"]).tolist()):
        sk.counts[int(i)] = int(c)
    sk.count = int(state["count"])
    sk.total = float(state["total"])
    sk.min = float(state["min"])
    sk.max = float(state["max"])
    return sk


# ----------------------------------------------------- flight recorder kit

_SERIES_CAP = 512  # health-series ring length, as the JAX package's default


class FlightKit:
    """The request flight recorder's three instruments, bundled for the
    queue: the per-request causal span recorder
    (:class:`~factormodeling_tpu_torch.obs.reqtrace.FlightRecorder`), the
    per-tenant cost meter
    (:class:`~factormodeling_tpu_torch.obs.metering.CostMeter`) and the
    virtual-clock health series
    (:class:`~factormodeling_tpu_torch.obs.reqtrace.HealthSeries`). Built
    only when ``run_queued(flight=...)`` asks for it: the modules are
    imported here. Its state rides the queue's checkpoint as one JSON
    string."""

    def __init__(self):
        from factormodeling_tpu_torch.obs.metering import CostMeter
        from factormodeling_tpu_torch.obs.reqtrace import (FlightRecorder,
                                                           HealthSeries)

        self.recorder = FlightRecorder()
        self.meter = CostMeter()
        self.series = HealthSeries(cap=_SERIES_CAP)
        self.wait_sids: dict = {}  # rid -> open queue/wait span id
        # entry name -> {comms_bytes, mem_bytes}: an entry point's ledger
        # rows are written once (on its "compile", before its first
        # metered dispatch), and rescanning the report a dispatch would
        # make metered drains quadratic. Not snapshotted: a resumed run
        # rebuilds it from its own report.
        self.ledger_memo: dict = {}

    def rows(self, queue_name: str) -> list:
        """Every flight row of the kit: the ``kind="reqtrace"`` rows (named
        like the queue), the ``kind="metering"`` accounts row and the
        ``kind="series"`` health row."""
        return (self.recorder.rows(queue_name)
                + [self.meter.row(f"{queue_name}/metering"),
                   self.series.row(f"{queue_name}/health")])

    def state(self) -> str:
        return json.dumps(
            {"trace": self.recorder.state(), "meter": self.meter.state(),
             "series": self.series.state(),
             "wait": {str(rid): sid
                      for rid, sid in self.wait_sids.items()}},
            sort_keys=True)

    def load_state(self, state: str) -> None:
        doc = json.loads(state)
        self.recorder.load_state(doc["trace"])
        self.meter.load_state(doc["meter"])
        self.series.load_state(doc["series"])
        self.wait_sids = {int(rid): int(sid)
                          for rid, sid in doc.get("wait", {}).items()}


# ------------------------------------------------------------- the loop


class _Pending(NamedTuple):
    rid: int
    degraded: bool  # True when admission rewrote it to the cheap method


def run_queued(server, requests, *, admission=None, service_model=None,
               estimator=None, fault_plan=None, retries: int = 2,
               retry_backoff_s: float = 0.001, flush_headroom_s: float = 0.0,
               clock=None, seed_latency=None, checkpoint_path=None,
               checkpoint_every: int = 1, queue_name: str = "serve/queue",
               flight=None, lineage=None, sentry=None,
               _stop_after_dispatches=None) -> QueueResult:
    """Drain ``requests`` through ``server`` under the traffic layer
    (module docs). Prefer calling it as
    :meth:`~factormodeling_tpu_torch.serve.frontend.TenantServer.
    serve_queued`.

    ``admission``: an :class:`~factormodeling_tpu_torch.serve.admission.
    AdmissionPolicy` (default: bounded queue, pure shedding).
    ``service_model``: ``(bucket_tag, rung) -> virtual seconds`` charged
    per dispatch attempt; None charges the estimator's current estimate.
    ``seed_latency``: a ``LatencyRecorder`` (or ``{name: row}`` of
    ``kind="latency"`` rows) whose ``serve/bucket/*`` sketches seed the
    estimator. ``queue_name``: the ``kind="serving"`` summary row's name.
    Every complete drain also records ``kind="traffic"`` arrival-trace
    rows (rid, tenant, exact arrival and deadline seconds, static key,
    final verdict) on ``QueueResult.traffic`` and the active report; feed
    them to :func:`replay_traffic` to re-submit the trace.

    ``flight``: ``True`` builds a :class:`FlightKit` (or pass one to
    accumulate accounts across drains whose rids differ): every request
    gets a causal span tree on the virtual clock (``kind="reqtrace"``),
    every dispatch's charged seconds split into per-tenant accounts with
    the pad lanes billed to ``overhead/pad`` (``kind="metering"``), and the
    queue's health is sampled at every dispatch boundary
    (``kind="series"``). ``lineage``: ``True`` builds a
    :class:`~factormodeling_tpu_torch.obs.lineage.LineageLedger` (or pass
    one): every delivered lane records one edge from the panels and its
    config to the fingerprint of its weight book, with the entry point and
    the dispatch id; each dispatch copies its books to the host once.
    ``sentry``: ``True`` builds a default
    :class:`~factormodeling_tpu_torch.obs.sentry.Sentry` (or pass a
    configured one); it observes at every dispatch boundary, its alerts go
    to ``admission.on_alert`` (observe only), and a firing detector
    captures an incident citing the chunk's traces, output ids, tenants
    and the checkpoint. All three are off by default (their modules are
    then not imported), ride the checkpoint, land their rows on the active
    report on a complete drain, and return on the :class:`QueueResult`.
    ``_stop_after_dispatches``: test seam — return the partial result
    right after that many dispatches have snapshotted (the in-process half
    of the resume differential).
    """
    requests = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    rids = [r.rid for r in requests]
    if len(set(rids)) != len(rids):
        raise ValueError("request rids must be unique")
    admission = admission if admission is not None else AdmissionPolicy()
    clock = clock if clock is not None else VirtualClock()
    estimator = estimator if estimator is not None else DispatchEstimator()
    kit = None
    if flight:
        kit = flight if isinstance(flight, FlightKit) else FlightKit()
    ledger = None
    if lineage:
        from factormodeling_tpu_torch.obs.lineage import LineageLedger

        ledger = (lineage if isinstance(lineage, LineageLedger)
                  else LineageLedger())
    sn = None
    if sentry:
        from factormodeling_tpu_torch.obs.sentry import Sentry

        sn = sentry if isinstance(sentry, Sentry) else Sentry()
    ladder = server.pad_ladder
    top = ladder[-1]
    n = len(requests)
    req_by_rid = {r.rid: r for r in requests}

    # --- normalize/validate every config up front: an invalid config is a
    # FAILED verdict at its arrival, never an exception out of the drain
    normalized: dict = {}
    invalid: dict = {}
    for r in requests:
        try:
            normalized[r.rid] = server._normalize(r.config)
        except ValueError as e:
            invalid[r.rid] = str(e)

    cheap_cfg: dict = {}  # rid -> rewritten (cheap-method) normalized config

    # --- mutable queue state (everything the snapshot must round-trip)
    verdict_log: list = []
    verdict_lines: list = []  # rows pre-serialized once, not per snapshot
    done: set = set()
    outputs: dict = {}
    pending: dict = {}  # skey -> list[_Pending] (FIFO)
    sketches: dict = {}  # scope -> QuantileSketch (per-verdict latencies)
    stale = StaleCache(cap=admission.stale_cap)
    counters = {"submitted": n, "served": 0, "shed_count": 0,
                "deadline_miss_count": 0, "failed_count": 0,
                "retry_count": 0, "rung_downgrades": 0, "stale_served": 0,
                "cheap_fallbacks": 0, "dispatches": 0, "padded_lanes": 0,
                "dispatch_faults": 0}
    arr_idx = 0          # arrivals admitted so far
    attempt_counter = 0  # process-stable dispatch-attempt index (fault plan)
    dispatch_idx = 0     # completed dispatches (checkpoint grid)

    ck = None
    ck_meta = None
    if checkpoint_path is not None:
        arr = np.asarray([r.arrival_s for r in requests], np.float64)
        dl = np.asarray([r.deadline_s for r in requests], np.float64)
        cfg_fp = _ckpt.fingerprint(
            arr, dl, np.asarray(rids, np.int64),
            *[leaf for r in requests if r.rid in normalized
              for leaf in _config_leaves(normalized[r.rid])])
        ck_meta = {"entry": "serve_queue", "n": n, "trace": cfg_fp,
                   "ladder": list(ladder), "admission": repr(admission),
                   "retries": int(retries),
                   "retry_backoff_s": float(retry_backoff_s),
                   "flush_headroom_s": float(flush_headroom_s),
                   "fault_plan": repr(fault_plan),
                   **({"flight": True} if kit is not None else {}),
                   **({"lineage": True} if ledger is not None else {}),
                   **({"sentry": True} if sn is not None else {})}
        # a hook joins the guard only when on: snapshots of hook-off runs
        # stay resumable by hook-off runs
        ck = _ckpt.Checkpointer(checkpoint_path, every=checkpoint_every)
        got = ck.resume(expect_meta=ck_meta)
        if got is not None:
            state, _ = got
            verdict_lines = list(state["verdict_log"])
            verdict_log = [json.loads(line) for line in verdict_lines]
            done = {v["rid"] for v in verdict_log}
            clock.now_s = float(np.asarray(state["clock_s"]))
            arr_idx = int(state["arr_idx"])
            attempt_counter = int(state["attempt_counter"])
            dispatch_idx = int(state["dispatch_idx"])
            estimator.load_state(state["estimator"])
            counters.update({k: int(v) for k, v in
                             state["counters"].items()})
            counters["submitted"] = n
            sketches = {name: _sketch_restore(s)
                        for name, s in state["sketches"].items()}
            stale.load_state(state["stale"])
            if kit is not None and "flight" in state:
                kit.load_state(str(state["flight"]))
            if ledger is not None and "lineage" in state:
                ledger.load_state(str(state["lineage"]))
            if sn is not None and "sentry" in state:
                sn.load_state(str(state["sentry"]))
            for skey, items in state["pending"]:
                # bucket keys restore in snapshot order, EMPTY buckets
                # included — dispatch-order determinism across a resume
                # (see _state)
                bucket = pending.setdefault(skey, [])
                for rid, degraded in items:
                    rid = int(rid)
                    if bool(degraded):
                        cheap_cfg[rid] = server._normalize(
                            admission.cheapened(req_by_rid[rid].config))
                    bucket.append(_Pending(rid, bool(degraded)))

    # --- lineage inputs: the panels are one source a drain (registered
    # after a resume restored the ledger; the registration is idempotent),
    # configs are hashed at their first dispatch, per (rid, degraded)
    panels_id = lin_mesh = None
    lin_cfg_ids: dict = {}
    if ledger is not None:
        panels_id = ledger.source(server.panels_fingerprint(), "panels")
        lin_mesh = server.serving_stats().get("mesh_shape")

    def lin_config_id(rid: int, degraded: bool) -> str:
        key = (rid, degraded)
        cid = lin_cfg_ids.get(key)
        if cid is None:
            cfg = (cheap_cfg if degraded else normalized)[rid]
            cid = ledger.source(
                _ckpt.fingerprint(*_config_leaves(cfg)), "config",
                degraded=bool(degraded))
            lin_cfg_ids[key] = cid
        return cid

    def verdict(rid: int, kind: str, *, done_s: float, rung=None,
                dispatch=None, detail: str = "") -> None:
        r = req_by_rid[rid]
        row = {"rid": int(rid), "tenant": r.label, "verdict": kind,
               "arrival_s": _round(r.arrival_s),
               "deadline_s": _round(r.deadline_s),
               "done_s": _round(done_s),
               "latency_s": _round(max(0.0, done_s - r.arrival_s)),
               "rung": None if rung is None else int(rung),
               "dispatch": None if dispatch is None else int(dispatch),
               "detail": detail}
        verdict_log.append(row)
        verdict_lines.append(json.dumps(row, sort_keys=True))
        if kit is not None:
            kit.recorder.event(str(rid), "verdict", t=done_s,
                               verdict=kind, detail=detail or None)
            kit.recorder.finish(str(rid), kind, t=done_s,
                                rid=int(rid), detail=detail or None)
        done.add(rid)
        key = {SERVED: "served", SHED: "shed_count",
               DEADLINE_MISS: "deadline_miss_count",
               FAILED: "failed_count"}[kind]
        counters[key] += 1
        scope = f"serve/verdict/{kind.lower()}"
        sketches.setdefault(scope, QuantileSketch()).add(
            max(0.0, done_s - r.arrival_s))

    def depth() -> int:
        return sum(len(v) for v in pending.values())

    def served_p99():
        sk = sketches.get("serve/verdict/served")
        return sk.quantile(0.99) if sk is not None and sk.count else None

    def seed_estimate(skey, rung) -> None:
        if seed_latency is None:
            return
        name = server.entry_name(skey, rung)
        row = None
        sk_map = getattr(seed_latency, "sketches", None)
        if sk_map is not None:
            sk = sk_map.get(name)
            if sk is not None and sk.count:
                row = {"p50_s": sk.quantile(0.5)}
        elif isinstance(seed_latency, dict):
            row = seed_latency.get(name)
        if row and isinstance(row.get("p50_s"), (int, float)):
            estimator.seed(repr(skey), rung, float(row["p50_s"]))

    def admit(r: Request) -> None:
        """The admission decision at (virtual) arrival processing time:
        enqueue, or walk the policy's degrade ladder (admission module
        docs) — every path ends in an enqueue or a terminal verdict."""
        if kit is not None:
            kit.recorder.begin(str(r.rid), t=r.arrival_s, tenant=r.label,
                               rid=int(r.rid))
            kit.recorder.event(str(r.rid), "submit", t=r.arrival_s)
        if r.rid in invalid:
            if kit is not None:
                kit.recorder.event(str(r.rid), "reject", t=clock.now_s,
                                   reason=invalid[r.rid])
            verdict(r.rid, FAILED, done_s=clock.now_s,
                    detail=f"rejected: {invalid[r.rid]}")
            return
        reason = admission.overloaded(depth=depth(),
                                      served_p99_s=served_p99())
        if reason is None:
            skey = normalized[r.rid].static_key()
            pending.setdefault(skey, []).append(_Pending(r.rid, False))
            if kit is not None:
                kit.recorder.event(str(r.rid), "admit", t=clock.now_s,
                                   bucket=repr(skey))
                kit.wait_sids[r.rid] = kit.recorder.open(
                    str(r.rid), "queue/wait", t=clock.now_s)
            return
        for step in admission.ladder:
            if step == SERVE_STALE:
                key = _stale_key(normalized[r.rid])
                hit = stale.get(key)
                if hit is not None:
                    source_rid, out = hit
                    out = _rehang_output(server, out)
                    # write the typed lane back so a snapshot-restored
                    # entry is rebuilt once, not per hit
                    stale.put(key, source_rid, out)
                    outputs[r.rid] = out
                    counters["stale_served"] += 1
                    if kit is not None:
                        kit.recorder.event(
                            str(r.rid), "stale", t=clock.now_s,
                            reason=reason, source_rid=int(source_rid))
                    # a stale answer delivered past the deadline is still
                    # a miss — the dispatch path's rule, applied here too
                    kind = (SERVED if clock.now_s <= r.deadline_s
                            else DEADLINE_MISS)
                    verdict(r.rid, kind, done_s=clock.now_s,
                            detail=f"stale:{source_rid}")
                    return
            elif step == CHEAP_FALLBACK:
                # suspended once depth hits 2x the bound: rerouting must
                # not be allowed to un-bound the bounded queue
                hard = (admission.max_depth is not None
                        and depth() >= 2 * admission.max_depth)
                cheap = admission.cheapened(r.config)
                if cheap is not None and not hard:
                    cheap_cfg[r.rid] = server._normalize(cheap)
                    skey = cheap_cfg[r.rid].static_key()
                    pending.setdefault(skey, []).append(
                        _Pending(r.rid, True))
                    counters["cheap_fallbacks"] += 1
                    if kit is not None:
                        kit.recorder.event(
                            str(r.rid), "cheap_fallback", t=clock.now_s,
                            reason=reason, bucket=repr(skey))
                        kit.wait_sids[r.rid] = kit.recorder.open(
                            str(r.rid), "queue/wait", t=clock.now_s)
                    return
            elif step == REJECT_NEW:
                if kit is not None:
                    kit.recorder.event(str(r.rid), "shed", t=clock.now_s,
                                       reason=reason)
                verdict(r.rid, SHED, done_s=clock.now_s, detail=reason)
                return
        if kit is not None:
            kit.recorder.event(str(r.rid), "shed", t=clock.now_s,
                               reason=f"{reason}; no ladder step applied")
        verdict(r.rid, SHED, done_s=clock.now_s,
                detail=f"{reason}; no ladder step applied")

    def _remove_from_pending(skey, chunk) -> None:
        # the chunk is deadline-ordered, not the FIFO prefix — remove by
        # rid, keeping the bucket's remaining FIFO order intact
        taken = {p.rid for p in chunk}
        pending[skey] = [p for p in pending[skey] if p.rid not in taken]

    def rung_for(count: int) -> int:
        for r in ladder:
            if count <= r:
                return r
        return top

    def pick_dispatch():
        """(skey, rung, chunk) to flush NOW, or (None, wait_until) when
        every bucket can safely wait. Deterministic: buckets iterate in
        first-admission order (dict insertion)."""
        drain = arr_idx >= n  # no future arrivals: waiting buys nothing
        wait_until = math.inf
        for skey, items in pending.items():
            if not items:
                continue
            # chunk selection is earliest-deadline first (stable, so FIFO
            # breaks ties): the FIFO prefix could exclude the very request
            # whose slack triggered the flush
            by_deadline = sorted(
                items, key=lambda p: req_by_rid[p.rid].deadline_s)
            count = len(items)
            if count >= top:
                return (skey, top, by_deadline[:top], False), None
            r_occ = rung_for(count)
            seed_estimate(skey, r_occ)
            tag = repr(skey)
            est = estimator.estimate(tag, r_occ)
            oldest_deadline = min(req_by_rid[p.rid].deadline_s
                                  for p in items)
            # flush_at is the ONE quantity both the flush test and the
            # wake-up time derive from: computing "slack <= est" and
            # "deadline - est" apart lets float rounding wake the loop at
            # the flush instant without flushing (a livelock)
            flush_at = oldest_deadline - est - flush_headroom_s
            if drain or clock.now_s >= flush_at:
                # deadline pressure (or drain): flush now. If the
                # occupancy rung cannot finish inside the slack, downgrade
                # to the largest rung that can (when no rung fits,
                # occupancy stands: serve everyone, late)
                slack = oldest_deadline - clock.now_s
                rung, downgraded = r_occ, False
                if est > slack:
                    for r in reversed([r for r in ladder if r < r_occ]):
                        seed_estimate(skey, r)
                        if estimator.estimate(tag, r) <= slack:
                            rung, downgraded = r, True
                            break
                take = min(count, rung)
                return (skey, rung, by_deadline[:take], downgraded), None
            wait_until = min(wait_until, flush_at)
        return None, wait_until

    def dispatch(skey, rung, chunk, downgraded) -> None:
        nonlocal attempt_counter
        lanes = [(cheap_cfg if p.degraded else normalized)[p.rid]
                 for p in chunk]
        template = lanes[0]
        tag = repr(skey)
        service = (service_model(tag, rung) if service_model is not None
                   else estimator.estimate(tag, rung))
        # retry up to the chunk's LATEST deadline; a chunk already past
        # every deadline dispatches uncapped — a late answer marked
        # DEADLINE_MISS beats an undispatched one
        chunk_deadline = max(req_by_rid[p.rid].deadline_s for p in chunk)
        if chunk_deadline <= clock.now_s:
            chunk_deadline = None

        # batch formation: close each member's queue-wait span and open
        # the shared dispatch span (same dispatch index, rung, pad fraction
        # and member list in every member's tree)
        d_sids: dict = {}
        attempt_log: list = []
        dispatch_out_ids: list = []  # lineage edge ids (sentry incidents)
        if kit is not None:
            t_form = clock.now_s
            pad_f = (rung - len(chunk)) / rung
            members = [str(p.rid) for p in chunk]
            for p in chunk:
                wsid = kit.wait_sids.pop(p.rid, None)
                if wsid is not None:
                    kit.recorder.close(str(p.rid), wsid, t=t_form,
                                       bucket=tag)
                d_sids[p.rid] = kit.recorder.open(
                    str(p.rid), "dispatch", t=t_form,
                    dispatch=dispatch_idx, rung=int(rung),
                    pad_fraction=round(pad_f, 6),
                    downgraded=bool(downgraded),
                    degraded=bool(p.degraded), members=members)

        def one_attempt():
            nonlocal attempt_counter
            k = attempt_counter
            attempt_counter += 1
            t0 = clock.now_s
            clock.advance(service)
            fault = fault_plan.roll(k) if fault_plan is not None else None
            if fault == "dispatch_error":
                counters["dispatch_faults"] += 1
                attempt_log.append((k, t0, clock.now_s, fault))
                raise DispatchFault("dispatch_error", k)
            out = server._dispatch_padded(skey, rung, lanes, template)
            if fault == "dispatch_poison":
                # the dispatch "completed" but its outputs fail validation
                # and are discarded — distinct class, same retry path
                counters["dispatch_faults"] += 1
                attempt_log.append((k, t0, clock.now_s, fault))
                raise DispatchFault("dispatch_poison", k)
            attempt_log.append((k, t0, clock.now_s, None))
            return out

        def count_retry(_attempt, _exc, _delay):
            counters["retry_count"] += 1

        def flight_attempts(rid) -> None:
            # retries as child spans of the dispatch span, with the resil
            # attempt indices
            for k, a0, a1, fault in attempt_log:
                sid = kit.recorder.open(str(rid), "attempt", t=a0,
                                        parent=d_sids[rid],
                                        attempt=int(k), fault=fault)
                kit.recorder.close(str(rid), sid, t=a1)

        try:
            name, out, pad = retry_call(
                one_attempt, retries=retries, backoff=retry_backoff_s,
                exceptions=(DispatchFault,),
                deadline_s=chunk_deadline,
                clock=lambda: clock.now_s, sleep=clock.advance,
                on_retry=count_retry)
        except DispatchFault as e:
            if kit is not None:
                for p in chunk:
                    flight_attempts(p.rid)
                    kit.recorder.close(str(p.rid), d_sids[p.rid],
                                       t=clock.now_s, error=str(e))
                # every attempt burned service time and delivered nothing:
                # explicit overhead, not a bill
                for _ in attempt_log:
                    kit.meter.overhead("overhead/failed", wall_s=service)
            for p in chunk:
                verdict(p.rid, FAILED, done_s=clock.now_s, rung=rung,
                        dispatch=dispatch_idx,
                        detail=f"dispatch failed after retries: {e}")
            _remove_from_pending(skey, chunk)
            _sample_health(len(chunk), rung)
            _observe_sentry(chunk, rung, [])
            _finish_dispatch(downgraded)
            return

        t_done = clock.now_s
        estimator.observe(tag, rung, service)
        counters["padded_lanes"] += pad
        if kit is not None:
            for p in chunk:
                flight_attempts(p.rid)
                kit.recorder.close(str(p.rid), d_sids[p.rid], t=t_done)
                kit.recorder.event(str(p.rid), "demux", t=t_done)
            # metering: the successful attempt's cost splits across the
            # rung's lanes (pad lanes -> overhead/pad); earlier failed
            # attempts are explicit retry overhead
            for _ in attempt_log[:-1]:
                kit.meter.overhead("overhead/retry", wall_s=service)
            qp = _qp_per_lane(out, rung)
            if name not in kit.ledger_memo:
                kit.ledger_memo[name] = _ledger_costs(name)
            kit.meter.charge(
                [req_by_rid[p.rid].label for p in chunk], rung,
                wall_s=service,
                per_lane=None if qp is None else {"qp_solves": qp},
                **({"qp_solves": 0.0} if qp is not None else {}),
                **kit.ledger_memo[name])
        stale_enabled = SERVE_STALE in admission.ladder
        host_books = None
        if ledger is not None:
            # one device-to-host copy of the rung's weight books; each
            # lane's fingerprint then hashes a host slice
            host_books = host_array(out.sim.weights)
        for lane, p in enumerate(chunk):
            out_lane = tree_lane(out, lane)
            outputs[p.rid] = out_lane
            if stale_enabled:  # typed lane as-is: a stale hit is a lookup
                stale.put(_stale_key(lanes[lane]), p.rid, out_lane)
            r = req_by_rid[p.rid]
            kind = SERVED if t_done <= r.deadline_s else DEADLINE_MISS
            verdict(p.rid, kind, done_s=t_done, rung=rung,
                    dispatch=dispatch_idx,
                    detail="cheap_fallback" if p.degraded else "")
            if ledger is not None:
                # one content-addressed edge a delivered lane:
                # book fingerprint <- {panels, config}, with the entry
                # point and the flight recorder's dispatch id
                edge_id = ledger.edge(
                    _ckpt.fingerprint(host_books[lane]), "dispatch",
                    [panels_id, lin_config_id(p.rid, p.degraded)],
                    code={"static_key": tag, "bucket": name,
                          "rung": int(rung), "mesh": lin_mesh},
                    trace={"dispatch": int(dispatch_idx)},
                    rid=int(p.rid), tenant=r.label)
                if sn is not None:
                    dispatch_out_ids.append(edge_id)
        _remove_from_pending(skey, chunk)
        record_stage("serve/queue/dispatch", kind="stage",
                     entry_point=name, rung=rung, configs=len(chunk),
                     padded_lanes=pad, downgraded=bool(downgraded),
                     virtual_t_s=_round(t_done))
        _sample_health(len(chunk), rung)
        _observe_sentry(chunk, rung, dispatch_out_ids)
        _finish_dispatch(downgraded)

    def _sample_health(chunk_len: int, rung: int) -> None:
        # at the dispatch boundary, before the checkpoint in
        # _finish_dispatch, so the sample rides the snapshot
        if kit is None:
            return
        kit.series.sample(
            t=clock.now_s, depth=depth(),
            occupancy=chunk_len / rung,
            shed_rate=counters["shed_count"] / max(1, arr_idx),
            served_p99_s=served_p99())

    def _observe_sentry(chunk, rung, out_ids) -> None:
        # at the dispatch boundary, before the checkpoint, so the alert
        # log rides the snapshot
        if sn is None:
            return
        fired = sn.observe(
            t=clock.now_s,
            counters={"submitted": arr_idx,
                      "served": counters["served"],
                      "failed": counters["failed_count"],
                      "retries": counters["retry_count"],
                      "shed": counters["shed_count"],
                      "deadline_miss": counters["deadline_miss_count"],
                      "dispatches": counters["dispatches"]},
            gauges={"depth": depth(),
                    "occupancy": len(chunk) / rung,
                    "pad_fraction": (rung - len(chunk)) / rung,
                    "served_p99_s": served_p99()},
            accounts=kit.meter.accounts if kit is not None else None,
            context={
                "trace_ids": ([str(p.rid) for p in chunk]
                              if kit is not None else []),
                "output_ids": out_ids,
                "tenants": [req_by_rid[p.rid].label for p in chunk],
                "checkpoint": (f"{checkpoint_path}@{dispatch_idx}"
                               if ck is not None else None)})
        if fired and admission.on_alert is not None:
            # observe only: no scheduling decision reads the hook's result
            for alert in fired:
                admission.on_alert(alert)

    def _finish_dispatch(downgraded) -> None:
        nonlocal dispatch_idx
        global _dispatch_tally
        counters["dispatches"] += 1
        server._note_logical_dispatch()
        if downgraded:
            counters["rung_downgrades"] += 1
        dispatch_idx += 1
        _dispatch_tally += 1
        if ck is not None:
            ck.maybe_save(dispatch_idx - 1, _state(), meta=ck_meta)
            die_after = os.environ.get(_DIE_ENV)
            if die_after is not None and _dispatch_tally - 1 == int(die_after):
                print(f"serve_queued: dying after dispatch "
                      f"{_dispatch_tally - 1} ({_DIE_ENV} test hook)",
                      flush=True)
                os._exit(137)

    def _state() -> dict:
        # EVERY bucket, in dict order, INCLUDING emptied ones: pick_dispatch
        # iterates pending in insertion order, so a bucket emptied before
        # the snapshot and refilled after resume must come back in its
        # original position or the resumed dispatch order — and therefore
        # the verdict log — diverges from a straight-through run.
        # static_key tuples are JSON-scalar trees, which the snapshot codec
        # round-trips exactly
        pend = [(skey, [[p.rid, p.degraded] for p in items])
                for skey, items in pending.items()]
        state = {"verdict_log": list(verdict_lines),
                "clock_s": np.asarray(clock.now_s, np.float64),
                "arr_idx": arr_idx, "attempt_counter": attempt_counter,
                "dispatch_idx": dispatch_idx,
                "estimator": estimator.state(),
                "counters": {k: int(v) for k, v in counters.items()},
                "sketches": {nm: _sketch_state(sk)
                             for nm, sk in sketches.items()},
                "stale": stale.state(flatten=_flatten_output),
                "pending": pend}
        # the hooks ride the same snapshot seam, one JSON string each
        if kit is not None:
            state["flight"] = kit.state()
        if ledger is not None:
            state["lineage"] = ledger.state()
        if sn is not None:
            state["sentry"] = sn.state()
        return state

    # ------------------------------------------------------ the event loop
    while True:
        while arr_idx < n and requests[arr_idx].arrival_s <= clock.now_s:
            r = requests[arr_idx]
            arr_idx += 1
            if r.rid in done:  # resumed: already verdicted before the stop
                continue
            admit(r)
        decision, wait_until = pick_dispatch()
        if decision is not None:
            skey, rung, chunk, downgraded = decision
            dispatch(skey, rung, chunk, downgraded)
            if (_stop_after_dispatches is not None
                    and dispatch_idx >= _stop_after_dispatches):
                break
            continue
        next_arrival = (requests[arr_idx].arrival_s if arr_idx < n
                        else math.inf)
        t_next = min(next_arrival, wait_until)
        if not math.isfinite(t_next):
            break
        clock.advance_to(t_next)

    stopped_early = (_stop_after_dispatches is not None
                     and len(done) < n)
    if not stopped_early:
        total = (counters["served"] + counters["shed_count"]
                 + counters["deadline_miss_count"] + counters["failed_count"])
        assert total == n and len(done) == n, (
            f"verdict completeness violated: {total} verdicts for {n} "
            f"submissions ({counters})")
        if ck is not None:
            ck.save(_state(), meta=ck_meta)

    row = dict(counters)
    served_sk = sketches.get("serve/verdict/served")
    if served_sk is not None and served_sk.count:
        row["served_p50_s"] = _round(served_sk.quantile(0.5))
        row["served_p99_s"] = _round(served_sk.quantile(0.99))
    row["virtual_makespan_s"] = _round(clock.now_s)
    traffic = None
    if not stopped_early:
        # an early-stopped (test-seam) run emits no serving row: its
        # verdict counts cannot sum to the submissions yet
        record_stage(queue_name, kind="serving", **row)
        # the arrival trace: every submitted request's identity, exact
        # arrival/deadline seconds, bucket key and final verdict
        final = {v["rid"]: v["verdict"] for v in verdict_log}
        traffic = []
        for r in requests:
            cfg = normalized.get(r.rid)
            traffic.append(
                {"kind": "traffic", "name": queue_name, "rid": int(r.rid),
                 "tenant": None if r.tenant is None else str(r.tenant),
                 "arrival_s": float(r.arrival_s),
                 "deadline_s": float(r.deadline_s),
                 "static_key": (None if cfg is None
                                else repr(cfg.static_key())),
                 "verdict": final[r.rid]})
        rep = active_report()
        if rep is not None:
            rep.rows.extend(dict(t) for t in traffic)
            if rep.latency is not None:
                for scope, sk in sketches.items():
                    rep.latency.sketches.setdefault(
                        scope, QuantileSketch()).merge(sk)
            # the hooks' rows land only on a complete drain: a partial
            # trace set or ledger is the dangling shape --strict rejects
            for hook in (kit, ledger, sn):
                if hook is not None:
                    rep.rows.extend(hook.rows(queue_name))
    return QueueResult(verdicts=verdict_log, outputs=outputs,
                       counters=row, clock_s=clock.now_s, flight=kit,
                       traffic=traffic, lineage=ledger, sentry=sn)


# ---------------------------------------------------- recorded-traffic replay


def replay_traffic(server, rows, configs, *, name=None,
                   **kwargs) -> QueueResult:
    """Re-submit a recorded ``kind="traffic"`` arrival trace through
    :func:`run_queued`.

    ``rows`` may be a full report's rows — only ``kind="traffic"`` rows
    (optionally those of queue ``name``) are replayed. ``configs`` gives
    each rid's config (a sequence or mapping indexed by rid): the trace
    records the bucket key, not the config. With the same policy kwargs as
    the recorded run (admission, service model, fault plan, retries), the
    replay's verdict log is byte-equal to the recorded run's.
    """
    trows = [r for r in rows if r.get("kind") == "traffic"
             and (name is None or r.get("name") == name)]
    if not trows:
        raise ValueError("replay_traffic: no kind=\"traffic\" rows"
                         + (f" named {name!r}" if name is not None else ""))
    reqs = []
    for row in trows:
        rid = int(row["rid"])
        try:
            cfg = configs[rid]
        except (KeyError, IndexError):
            raise ValueError(f"replay_traffic: no config for rid "
                             f"{rid}") from None
        reqs.append(Request(rid=rid, config=cfg,
                            arrival_s=float(row["arrival_s"]),
                            deadline_s=float(row["deadline_s"]),
                            tenant=row.get("tenant")))
    return run_queued(server, reqs, **kwargs)


# --------------------------------------------------- flight cost sources


def _qp_per_lane(out, rung: int):
    """Per-lane QP solve counts from the dispatch output's
    ``SolverDiagnostics``, or None when the output does not carry them in
    the ``[rung]`` shape (metering is "when available", never a crash).
    One copy to the host a dispatch."""
    qp = getattr(getattr(getattr(out, "sim", None), "diagnostics", None),
                 "qp_solves", None)
    if not isinstance(qp, torch.Tensor) or tuple(qp.shape) != (rung,):
        return None
    return [float(v) for v in host_array(qp)]


def _ledger_costs(entry_name: str) -> dict:
    """Comms and memory bytes of one entry point from the placement rows
    the active report collected (``RunReport(comms=True)``): per-dispatch
    costs the meter splits like the wall. Empty without them."""
    rep = active_report()
    if rep is None:
        return {}
    comms = mem = None
    for r in rep.rows:
        if r.get("name") != entry_name:
            continue
        if r.get("kind") == "comms" and r.get("stage") == "total":
            comms = r.get("bytes_moved")
        elif r.get("kind") == "memory":
            mem = r.get("peak_bytes")
    out = {}
    if isinstance(comms, (int, float)):
        out["comms_bytes"] = float(comms)
    if isinstance(mem, (int, float)):
        out["mem_bytes"] = float(mem)
    return out


# ----------------------------------------------------------- tree helpers


def _flatten_output(out) -> list:
    return [host_array(leaf) for leaf in _ckpt.tree_leaves(out)]


def _output_skeleton() -> ResearchOutput:
    """The structure of a served lane, built from the output types (the
    serving path never carries a degrade policy or counters, so their
    slots are None): the template snapshot-restored flat leaves are hung
    on."""
    def fill(cls):
        return cls(*([0] * len(cls._fields)))

    return ResearchOutput(
        selection=0, signal=0,
        sim=SimulationOutput(weights=0, long_count=0, short_count=0,
                             result=fill(DailyResult),
                             diagnostics=fill(SolverDiagnostics),
                             degrade=None),
        summary=fill(ResearchSummary), counters=None)


def _rehang_output(server, leaves):
    """A typed ResearchOutput lane from snapshot-restored flat leaves,
    as tensors on the server's device. In-memory entries are the typed
    lane already and pass straight through (the stale hit stays a dict
    lookup)."""
    if not isinstance(leaves, list):
        return leaves
    skeleton = _output_skeleton()
    want = len(_ckpt.tree_leaves(skeleton))
    if len(leaves) != want:
        raise ValueError(f"a stale cache entry holds {len(leaves)} leaves, "
                         f"a served lane {want}")
    return _ckpt._rehang(skeleton, iter(leaves), server.device)


def _stale_key(config: TenantConfig) -> str:
    """Content key for the stale cache: static residue + value leaves —
    two requests share a stale answer only when their configs are
    value-identical."""
    return (repr(config.static_key()) + "|"
            + _ckpt.fingerprint(*_config_leaves(config)))
