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
  verdict log is byte-equal to an uninterrupted one.

The seconds charged a dispatch come from ``service_model`` (default: the
estimator's estimate), not from the wall clock; the dispatches themselves
run the real step, and their outputs are bitwise the synchronous path's.

Not ported yet: the flight recorder, the provenance ledger and the
operations sentry (``flight=``, ``lineage=``, ``sentry=``; ROADMAP queue 1
item 2): each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import NamedTuple

import numpy as np

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
from factormodeling_tpu_torch.serve.tenant import _VALUE_LEAVES, TenantConfig

__all__ = ["DEADLINE_MISS", "FAILED", "SERVED", "SHED", "VERDICTS",
           "DispatchEstimator", "QueueResult", "Request", "VirtualClock",
           "bursty_arrivals", "make_requests", "poisson_arrivals",
           "replay_traffic", "run_queued"]

#: the verdict state machine's four terminal states — every submitted
#: request ends in exactly one (the loop asserts the counts sum)
SERVED = "SERVED"
SHED = "SHED"
DEADLINE_MISS = "DEADLINE_MISS"
FAILED = "FAILED"
VERDICTS = (SERVED, SHED, DEADLINE_MISS, FAILED)


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
    traffic: list = None   # kind="traffic" arrival-trace rows (complete
    #                        drains only — the replay_traffic input)

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
    ``flight``, ``lineage``, ``sentry``: not ported yet; they raise.
    ``_stop_after_dispatches``: test seam — return the partial result
    right after that many dispatches have snapshotted (the in-process half
    of the resume differential).
    """
    for hook, value in (("flight", flight), ("lineage", lineage),
                        ("sentry", sentry)):
        if value:
            raise NotImplementedError(
                f"serve_queued({hook}=...) is not ported yet (ROADMAP "
                f"queue 1 item 2)")
    requests = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    rids = [r.rid for r in requests]
    if len(set(rids)) != len(rids):
        raise ValueError("request rids must be unique")
    admission = admission if admission is not None else AdmissionPolicy()
    clock = clock if clock is not None else VirtualClock()
    estimator = estimator if estimator is not None else DispatchEstimator()
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
                   "fault_plan": repr(fault_plan)}
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
        if r.rid in invalid:
            verdict(r.rid, FAILED, done_s=clock.now_s,
                    detail=f"rejected: {invalid[r.rid]}")
            return
        reason = admission.overloaded(depth=depth(),
                                      served_p99_s=served_p99())
        if reason is None:
            skey = normalized[r.rid].static_key()
            pending.setdefault(skey, []).append(_Pending(r.rid, False))
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
                    return
            elif step == REJECT_NEW:
                verdict(r.rid, SHED, done_s=clock.now_s, detail=reason)
                return
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

        def one_attempt():
            nonlocal attempt_counter
            k = attempt_counter
            attempt_counter += 1
            clock.advance(service)
            fault = fault_plan.roll(k) if fault_plan is not None else None
            if fault == "dispatch_error":
                counters["dispatch_faults"] += 1
                raise DispatchFault("dispatch_error", k)
            out = server._dispatch_padded(skey, rung, lanes, template)
            if fault == "dispatch_poison":
                # the dispatch "completed" but its outputs fail validation
                # and are discarded — distinct class, same retry path
                counters["dispatch_faults"] += 1
                raise DispatchFault("dispatch_poison", k)
            return out

        def count_retry(_attempt, _exc, _delay):
            counters["retry_count"] += 1

        try:
            name, out, pad = retry_call(
                one_attempt, retries=retries, backoff=retry_backoff_s,
                exceptions=(DispatchFault,),
                deadline_s=chunk_deadline,
                clock=lambda: clock.now_s, sleep=clock.advance,
                on_retry=count_retry)
        except DispatchFault as e:
            for p in chunk:
                verdict(p.rid, FAILED, done_s=clock.now_s, rung=rung,
                        dispatch=dispatch_idx,
                        detail=f"dispatch failed after retries: {e}")
            _remove_from_pending(skey, chunk)
            _finish_dispatch(downgraded)
            return

        t_done = clock.now_s
        estimator.observe(tag, rung, service)
        counters["padded_lanes"] += pad
        stale_enabled = SERVE_STALE in admission.ladder
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
        _remove_from_pending(skey, chunk)
        record_stage("serve/queue/dispatch", kind="stage",
                     entry_point=name, rung=rung, configs=len(chunk),
                     padded_lanes=pad, downgraded=bool(downgraded),
                     virtual_t_s=_round(t_done))
        _finish_dispatch(downgraded)

    def _finish_dispatch(downgraded) -> None:
        nonlocal dispatch_idx
        counters["dispatches"] += 1
        server._note_logical_dispatch()
        if downgraded:
            counters["rung_downgrades"] += 1
        dispatch_idx += 1
        if ck is not None:
            ck.maybe_save(dispatch_idx - 1, _state(), meta=ck_meta)

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
        return {"verdict_log": list(verdict_lines),
                "clock_s": np.asarray(clock.now_s, np.float64),
                "arr_idx": arr_idx, "attempt_counter": attempt_counter,
                "dispatch_idx": dispatch_idx,
                "estimator": estimator.state(),
                "counters": {k: int(v) for k, v in counters.items()},
                "sketches": {nm: _sketch_state(sk)
                             for nm, sk in sketches.items()},
                "stale": stale.state(flatten=_flatten_output),
                "pending": pend}

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
    return QueueResult(verdicts=verdict_log, outputs=outputs,
                       counters=row, clock_s=clock.now_s, traffic=traffic)


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


def _config_leaves(config: TenantConfig) -> list:
    """The config's value leaves, in the JAX package's pytree order (None
    leaves absent)."""
    return [np.asarray(getattr(config, name)) for name in _VALUE_LEAVES
            if getattr(config, name) is not None]


def _stale_key(config: TenantConfig) -> str:
    """Content key for the stale cache: static residue + value leaves —
    two requests share a stale answer only when their configs are
    value-identical."""
    return (repr(config.static_key()) + "|"
            + _ckpt.fingerprint(*_config_leaves(config)))
