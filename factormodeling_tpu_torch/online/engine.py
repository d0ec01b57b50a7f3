"""The online-advance host loop: exactly-once ingestion with restatement
replay and crash-consistent resume (port of
``factormodeling_tpu/online/engine.py``).

Every ingested date terminates in EXACTLY ONE of

- **APPLIED**: the date advanced the state machine; its outputs are the
  newly finalized date's research-step row;
- **REPLAYED**: a restated date rolled the state back to the snapshot taken
  before its original application and re-applied the corrected slice and
  every journaled successor. A restatement beyond the snapshot horizon
  takes the explicit replay from genesis over the retained history
  (counted in ``full_recompute_fallbacks``), or is REJECTED with
  ``restate_beyond_horizon`` when history retention is off;
- **REJECTED**: out-of-order or duplicate date ids, malformed slices,
  NaN-storm slices and universe collapses below the guard are refused WITH
  A REASON.

``ingested == applied + replayed + rejected`` always.

Crash consistency: after every applied date (thinned by
``checkpoint_every``) the engine state (the advance state, the snapshot
ring, the journal, the counters, the applied ids and a rolling content
hash) snapshots atomically through ``resil.checkpoint`` under a
config-fingerprint meta guard. A re-sent already-applied date is REJECTED
as a duplicate, a never-applied one applies, and a resumed stream's
outputs are byte-equal to a straight-through run.

The advance state lives on the engine's device (None is the card; the CPU
only when asked for); the snapshot ring holds references to its tensors,
which no advance writes in place. The host work a date: the admission
guards read the slice on the host (it arrives there), the slice moves to
the device, and the finalized row comes back in two reads
(:func:`_out_to_host`).

The obs hooks (``flight=``, ``lineage=``, ``sentry=``; off by default, and
their modules are not imported then) record each tick's span tree on the
ordinal clock, one content-addressed edge an applied date, and the
sentry's alerts, as the JAX package's engine does. The snapshot leaves are
the JAX package's (int32 counters, one warm-start lane without its lane
axis) and so is the configuration tag, so either package resumes the
other's snapshots and the ledger's ids of hashed host content (the date
slices, the genesis state, the audit chain) are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import deque

import numpy as np
import torch

from factormodeling_tpu_torch._device import host_array, resolve_device
from factormodeling_tpu_torch.obs.compile_log import entry_point_tag
from factormodeling_tpu_torch.obs.report import record_stage
from factormodeling_tpu_torch.online.advance import make_online_step
from factormodeling_tpu_torch.online.state import DateSlice
from factormodeling_tpu_torch.resil.checkpoint import (Checkpointer,
                                                       _rehang, tree_leaves)
from factormodeling_tpu_torch.serve.tenant import TenantConfig

__all__ = ["EngineGuards", "OnlineEngine", "OnlineVerdict"]

#: test hook: _exit(137) right after the checkpoint save of this date id,
#: the mid-stream kill of the resume differential
_DIE_ENV = "_FMT_ONLINE_DIE_AFTER_DATE"


@dataclasses.dataclass(frozen=True)
class EngineGuards:
    """Feed-level admission guards. The defaults are the OPEN policy (every
    well-ordered date applies); ``guarded`` thresholds reject anomalous
    slices with explicit reasons."""

    nan_frac_max: float | None = None   # None disables the NaN-storm guard
    min_universe: int = 0               # 0 disables the collapse guard

    @classmethod
    def open(cls) -> "EngineGuards":
        return cls()

    @classmethod
    def guarded(cls, *, nan_frac_max: float = 0.5,
                min_universe: int = 2) -> "EngineGuards":
        return cls(nan_frac_max=nan_frac_max, min_universe=min_universe)


@dataclasses.dataclass(frozen=True)
class OnlineVerdict:
    """One ingested date's terminal verdict (module docs)."""

    date: int
    status: str                 # "applied" | "replayed" | "rejected"
    reason: str | None = None   # rejection reason / replay kind
    outputs: tuple = ()         # finalized-row dicts (host numpy)
    replayed_dates: tuple = ()  # date ids re-applied by a replay


def _host_slice(d: DateSlice) -> dict:
    return {k: host_array(v) for k, v in d._asdict().items()
            if v is not None}


def _slice_from_host(h: dict) -> DateSlice:
    return DateSlice(factors=h["factors"], returns=h["returns"],
                     factor_ret=h["factor_ret"], cap_flag=h["cap_flag"],
                     investability=h["investability"],
                     universe=h.get("universe"))


_FLOAT_FIELDS = ("log_return", "long_return", "short_return",
                 "long_turnover", "short_turnover", "turnover", "resid")


def _out_to_host(o) -> dict:
    """The finalized row as host numpy, in two device reads: the float
    fields packed in one tensor, the counts and the acceptance in
    another."""
    f, n = o.selection.shape[0], o.signal.shape[0]
    floats = torch.cat([o.selection, o.signal, o.weights,
                        torch.stack([getattr(o, k).to(o.signal.dtype)
                                     for k in _FLOAT_FIELDS])]).cpu().numpy()
    ints = torch.stack([o.long_count, o.short_count,
                        o.solver_ok.to(o.long_count.dtype)]).cpu().numpy()
    out = {"ready": np.asarray(bool(o.ready)), "day": np.asarray(int(o.day)),
           "selection": floats[:f], "signal": floats[f:f + n],
           "weights": floats[f + n:f + 2 * n]}
    out.update({k: floats[f + 2 * n + i] for i, k in enumerate(_FLOAT_FIELDS)})
    out.update(long_count=ints[0], short_count=ints[1],
               solver_ok=ints[2].astype(bool))
    return out


def _jax_leaves(state) -> list:
    """The state's leaves as the JAX package's engine holds them, on the
    host: counters as int32, the one-lane warm start without its lane
    axis."""
    mstate, tstate = state
    if tstate.warm is not None:
        tstate = dataclasses.replace(
            tstate, warm=type(tstate.warm)(*(x[0] for x in tstate.warm)))
    return [np.asarray(x, np.int32) if isinstance(x, int)
            else host_array(x) for x in tree_leaves((mstate, tstate))]


class OnlineEngine:
    """Single-config online advance with the robustness contract (module
    docs).

    Args:
      names: factor names (the blend's prefix/suffix convention).
      n_assets: cross-section width N.
      template: the research configuration
        (:class:`~factormodeling_tpu_torch.serve.tenant.TenantConfig`).
      has_universe: whether slices carry a universe mask.
      horizon: the snapshot/journal ring depth, how many most recent applied
        dates can be restated by bounded rollback-and-replay.
      guards: :class:`EngineGuards` (default open).
      checkpoint: optional path or ``resil.Checkpointer``;
        ``checkpoint_every`` thins saves when a path is given.
      retain_history: keep every applied slice on the host so a
        beyond-horizon restatement can replay from genesis (O(history),
        counted); off -> such restatements are rejected.
      checkpoint_history: include the retained history in every checkpoint
        (each save then grows with the stream; thin with
        ``checkpoint_every`` or turn this off, after which a resumed
        engine rejects beyond-horizon restatements explicitly).
      stats_tail / dtype: threaded to :func:`~.advance.online_step_parts`
        (dtype default float64).
      device: the engine's device; None is the card, the CPU only when
        asked for.
      progress: optional callable taking one message string.
      flight: ``True`` builds a
        :class:`~factormodeling_tpu_torch.obs.reqtrace.FlightRecorder` (or
        pass one to share): every tick gets a span tree on the ORDINAL
        clock (tick ``i`` occupies ``[i, i+1]``) with the admission
        decision, the advance (replays as child events) and the verdict;
        :meth:`flight_rows` renders them. Traces are per process: they do
        not ride the checkpoint.
      lineage: ``True`` builds a
        :class:`~factormodeling_tpu_torch.obs.lineage.LineageLedger` (or
        pass one): every applied or replayed date records one edge from
        the pre-apply state's and the slice's fingerprints to the
        post-apply state's, with the version, the audit-chain head and the
        replay count; a replay's edge names the edge it ``supersedes``.
        Each date copies the state to the host and hashes it once (the
        next date's pre-state id is this output id). The ledger rides the
        checkpoint; :meth:`lineage_rows` renders it.
      sentry: ``True`` builds a default
        :class:`~factormodeling_tpu_torch.obs.sentry.Sentry` (or pass a
        configured one): every verdict feeds one observation on the
        ordinal clock (the counters, and the slice's ``nan_frac`` and
        ``universe_count``); a firing detector captures an incident citing
        the date, the last lineage output id and the checkpoint. Its state
        rides the checkpoint; :meth:`sentry_rows` renders the alert log.

    The scalar knobs of the template are normalized to float64 host
    numbers whatever ``dtype`` is: the day solve runs in float64, and the
    full research step takes the same knobs as Python floats.
    """

    def __init__(self, *, names, n_assets: int, template=None,
                 has_universe: bool = False, horizon: int = 8,
                 guards: EngineGuards | None = None, checkpoint=None,
                 checkpoint_every: int = 1, retain_history: bool = True,
                 checkpoint_history: bool = True, stats_tail: int = 8,
                 dtype=None, device=None, progress=None, flight=None,
                 lineage=None, sentry=None):
        from factormodeling_tpu_torch.composite.blend import prefix_group_ids

        self.names = tuple(names)
        self.n_assets = int(n_assets)
        self.horizon = int(horizon)
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self.guards = guards or EngineGuards.open()
        self.retain_history = bool(retain_history)
        self.checkpoint_history = bool(checkpoint_history)
        self._progress = progress or (lambda *_: None)
        self.device = resolve_device(device)
        dtype = torch.float64 if dtype is None else dtype
        template = template if template is not None else TenantConfig()
        _, prefixes = prefix_group_ids(self.names)
        self.template = template.normalized(len(self.names), len(prefixes),
                                            dtype=np.float64)
        self._has_universe = bool(has_universe)
        init_fn, self._advance = make_online_step(
            names=self.names, template=self.template, n_assets=self.n_assets,
            dtype=dtype, has_universe=has_universe, stats_tail=stats_tail,
            device=self.device)
        self._config_tag = entry_point_tag(
            self.names, self.n_assets, str(self.template.static_key()),
            has_universe, stats_tail, str(dtype).replace("torch.", ""))
        self._init_fn = init_fn
        self._state = init_fn()
        self._template_state = self._state
        # the current state's host leaves and lineage id, once computed
        self._state_host = self._state_id = None
        self._applied: list = []
        self._applied_set: set = set()
        # ring entries are [date_id, state BEFORE applying date_id, its
        # host leaves once needed, its lineage id once known]
        self._snapshots: deque = deque(maxlen=self.horizon)
        self._journal: deque = deque(maxlen=self.horizon)
        self._history: list = []
        # False after a resume restored fewer slices than applied dates:
        # the genesis-replay fallback would rebuild over a truncated prefix
        self._history_complete = True
        # append-only audit chain: every application ever made folds in,
        # replays included; deterministic for a given ingestion sequence
        self._chain = hashlib.sha256(self._config_tag.encode()).hexdigest()
        self.counters = {"ingested_dates": 0, "applied_dates": 0,
                         "replayed_dates": 0, "rejected_dates": 0,
                         "replay_applied_dates": 0,
                         "full_recompute_fallbacks": 0}
        self.rejected_reasons: dict = {}
        self._flight = None
        if flight:
            from factormodeling_tpu_torch.obs.reqtrace import FlightRecorder

            self._flight = (flight if isinstance(flight, FlightRecorder)
                            else FlightRecorder())
        self._lineage = None
        if lineage:
            from factormodeling_tpu_torch.obs.lineage import LineageLedger

            self._lineage = (lineage if isinstance(lineage, LineageLedger)
                             else LineageLedger())
        self._sentry = None
        if sentry:
            from factormodeling_tpu_torch.obs.sentry import Sentry

            self._sentry = (sentry if isinstance(sentry, Sentry)
                            else Sentry())
        self._ck = None
        if checkpoint is not None:
            self._ck = (checkpoint if isinstance(checkpoint, Checkpointer)
                        else Checkpointer(checkpoint, every=checkpoint_every))
            self._maybe_resume()
        if self._lineage is not None:
            # genesis anchor: the chain's first pre-state must resolve.
            # After a resume the current state's id is the last edge's
            # output id, already in the restored ledger, so nothing is
            # registered and the ledger stays byte-equal
            fp = self._current_id()
            if not self._lineage.known(fp):
                self._lineage.source(fp, "state_genesis")

    # ------------------------------------------------------------ state io

    def _unleaves(self, leaves):
        """A state from JAX-form host leaves (either package's snapshot),
        in the port's shapes and types."""
        like = tree_leaves(self._template_state)
        fixed = [int(np.asarray(v)) if isinstance(t, int)
                 else np.asarray(v).reshape(tuple(t.shape))
                 for t, v in zip(like, leaves)]
        return _rehang(self._template_state, iter(fixed), None)

    def _ck_meta(self) -> dict:
        # the hook keys only when on: snapshots of hook-off runs stay
        # resumable by hook-off engines of either package
        return {"entry": "online_engine", "config": self._config_tag,
                "horizon": self.horizon,
                "retain_history": self.retain_history,
                **({"lineage": True} if self._lineage is not None else {}),
                **({"sentry": True} if self._sentry is not None else {})}

    def _ring_leaves(self, entry) -> list:
        if entry[2] is None:
            entry[2] = _jax_leaves(entry[1])
        return entry[2]

    def _current_leaves(self) -> list:
        if self._state_host is None:
            self._state_host = _jax_leaves(self._state)
        return self._state_host

    def _current_id(self) -> str:
        if self._state_id is None:
            from factormodeling_tpu_torch.resil.checkpoint import fingerprint

            self._state_id = fingerprint(*self._current_leaves())
        return self._state_id

    def _set_state(self, state, host=None, state_id=None):
        self._state, self._state_host, self._state_id = state, host, state_id

    def _save(self, *, force: bool = False):
        if self._ck is None:
            return
        if not force and (self.counters["applied_dates"]) % self._ck.every:
            return
        state = {
            "state": self._current_leaves(),
            "applied": list(self._applied),
            "chain": self._chain,
            "counters": dict(self.counters),
            "rejected_reasons": dict(self.rejected_reasons),
            "snapshots": [[int(e[0]), self._ring_leaves(e)]
                          for e in self._snapshots],
            "journal": [[int(d), h] for d, h in self._journal],
            "history": ([[int(d), h] for d, h in self._history]
                        if self.retain_history and self.checkpoint_history
                        else []),
        }
        if self._lineage is not None:
            state["lineage"] = self._lineage.state()
        if self._sentry is not None:
            state["sentry"] = self._sentry.state()
        self._ck.save(state, meta=self._ck_meta())

    def _maybe_resume(self):
        got = self._ck.resume(expect_meta=self._ck_meta())
        if got is None:
            return
        state, _ = got
        self._set_state(self._unleaves(state["state"]),
                        host=list(state["state"]))
        self._applied = [int(d) for d in state["applied"]]
        self._applied_set = set(self._applied)
        self._chain = str(state["chain"])
        self.counters.update({k: int(v)
                              for k, v in state["counters"].items()})
        self.rejected_reasons = {k: int(v) for k, v in
                                 state["rejected_reasons"].items()}
        self._snapshots = deque(
            [[int(d), self._unleaves(leaves), leaves, None]
             for d, leaves in state["snapshots"]], maxlen=self.horizon)
        self._journal = deque([(int(d), h) for d, h in state["journal"]],
                              maxlen=self.horizon)
        self._history = [(int(d), h) for d, h in state["history"]]
        self._history_complete = (
            {d for d, _ in self._history} == set(self._applied))
        if self._lineage is not None and "lineage" in state:
            self._lineage.load_state(str(state["lineage"]))
        if self._sentry is not None and "sentry" in state:
            self._sentry.load_state(str(state["sentry"]))
        self._progress(f"online: resumed at date {self.last_date} "
                       f"({self.counters['applied_dates']} applied) "
                       f"from {self._ck.path}")

    # ----------------------------------------------------------- verdicts

    @property
    def last_date(self):
        return self._applied[-1] if self._applied else None

    @property
    def version(self) -> int:
        return int(self._state[0].version)

    def _reject(self, date: int, reason: str, h=None) -> OnlineVerdict:
        self.counters["rejected_dates"] += 1
        self.rejected_reasons[reason] = \
            self.rejected_reasons.get(reason, 0) + 1
        self._sentry_observe(date, h)
        self._record()
        return OnlineVerdict(date=int(date), status="rejected",
                             reason=reason)

    def _sentry_observe(self, date: int, h) -> None:
        """One sentry observation a verdict, on the ordinal clock (t = the
        ingestion count). The gauges are the admission guards' math on the
        current slice, omitted for a malformed slice."""
        if self._sentry is None:
            return
        c = self.counters
        gauges: dict = {}
        if h is not None and self._slice_reason(h) is None:
            fac = h["factors"]
            if "universe" in h:
                uni = h["universe"][None]
                denom = max(int(uni.sum()) * fac.shape[0], 1)
                nans = int((np.isnan(fac) & uni).sum())
            else:
                denom = max(fac.size, 1)
                nans = int(np.isnan(fac).sum())
            gauges["nan_frac"] = nans / denom
            gauges["universe_count"] = float(
                int(h["universe"].sum()) if "universe" in h
                else h["returns"].shape[-1])
        out_ids: list = []
        if self._lineage is not None:
            last = self._lineage.last_edge()
            if last is not None:
                out_ids.append(last["output_id"])
        self._sentry.observe(
            t=float(c["ingested_dates"]),
            counters={"ingested": c["ingested_dates"],
                      "applied": c["applied_dates"],
                      "replayed": c["replayed_dates"],
                      "rejected": c["rejected_dates"],
                      "replay_applied": c["replay_applied_dates"],
                      "fallbacks": c["full_recompute_fallbacks"]},
            gauges=gauges,
            context={"trace_ids": [], "output_ids": out_ids,
                     "tenants": [str(int(date))],
                     "checkpoint": (str(self._ck.path)
                                    if self._ck is not None else None)})

    def _guard_reason(self, h: dict):
        g = self.guards
        if g.nan_frac_max is not None:
            fac = h["factors"]
            if "universe" in h:
                uni = h["universe"][None]
                denom = max(int(uni.sum()) * fac.shape[0], 1)
                nans = int((np.isnan(fac) & uni).sum())
            else:
                denom = fac.size
                nans = int(np.isnan(fac).sum())
            if nans / denom > g.nan_frac_max:
                return "nan_storm"
        if g.min_universe > 0:
            count = (int(h["universe"].sum()) if "universe" in h
                     else h["returns"].shape[-1])
            if count < g.min_universe:
                return "universe_collapse"
        return None

    def _slice_reason(self, h: dict):
        """Host-side admission check of the slice's structure: a malformed
        tick terminates in a REJECTED verdict."""
        f, n = len(self.names), self.n_assets
        want = {"factors": (f, n), "returns": (n,), "factor_ret": (f,),
                "cap_flag": (n,), "investability": (n,)}
        if self._has_universe:
            want["universe"] = (n,)
        if set(h) != set(want):
            return "bad_slice_fields"
        for key, shape in want.items():
            if h[key].shape != shape:
                return "bad_slice_shape"
        return None

    def _apply_one(self, date: int, h: dict, *, replaying: bool) -> list:
        """Advance by one slice; returns the finalized output rows. The
        pre-apply state enters the ring only once the advance succeeded."""
        pre = [int(date), self._state, self._state_host, self._state_id]
        (mstate, tstate), out = self._advance(
            self.template, self._state[0], self._state[1],
            _slice_from_host(h))
        host = _out_to_host(out) if out.ready else None
        self._snapshots.append(pre)
        self._set_state((mstate, tstate))
        self._journal.append((int(date), h))
        if self.retain_history and not replaying:
            self._history.append((int(date), h))
        self._applied.append(int(date))
        self._applied_set.add(int(date))
        ch = hashlib.sha256()
        ch.update(bytes.fromhex(self._chain))
        ch.update(np.int64(date).tobytes())
        for key in sorted(h):
            ch.update(np.ascontiguousarray(h[key]).tobytes())
        self._chain = ch.hexdigest()
        if self._lineage is not None:
            from factormodeling_tpu_torch.resil.checkpoint import fingerprint

            led = self._lineage
            # the pre-state id is the previous application's output id (or
            # the genesis source), known without hashing again; a rollback
            # restores an older entry, whose id rides with it
            prev_id = pre[3] if pre[3] is not None else fingerprint(
                *self._ring_leaves(pre))
            pre[3] = prev_id
            slice_id = led.source(
                fingerprint(*[np.ascontiguousarray(h[k])
                              for k in sorted(h)]),
                "date_slice", date=int(date))
            sup = led.last_edge(date=int(date)) if replaying else None
            led.edge(self._current_id(),
                     "replayed" if replaying else "applied",
                     [prev_id, slice_id],
                     state={"version": self.version,
                            "chain": self._chain[:16],
                            "replays":
                                self.counters["replay_applied_dates"]},
                     date=int(date),
                     **({"supersedes": sup["output_id"]}
                        if sup is not None else {}))
        return [host] if host is not None else []

    def ingest(self, date: int, date_slice: DateSlice,
               restate: bool = False) -> OnlineVerdict:
        """One feed tick -> one terminal verdict (module docs). With the
        flight recorder on, every tick also ends in exactly one finished
        span tree (:meth:`flight_rows`)."""
        if self._flight is None:
            return self._ingest_inner(date, date_slice, restate)
        # the tick's ordinal slot [i, i+1] on the recorder's time axis
        i = float(self.counters["ingested_dates"])
        tid = f"tick{int(i)}"
        fr = self._flight
        fr.begin(tid, t=i, tenant=str(int(date)), date=int(date),
                 restate=bool(restate))
        fr.event(tid, "submit", t=i)
        verdict = self._ingest_inner(date, date_slice, restate)
        # the span tree is derived from the verdict after the fact: every
        # return path lands here exactly once
        if verdict.status == "rejected":
            fr.event(tid, "reject", t=i + 0.125, reason=verdict.reason)
        else:
            fr.event(tid, "admit", t=i + 0.125)
            sid = fr.open(tid, ("replay" if verdict.status == "replayed"
                                else "advance"), t=i + 0.25,
                          replays=len(verdict.replayed_dates) or None)
            replayed = verdict.replayed_dates
            for j, d in enumerate(replayed):
                tj = i + 0.25 + 0.5 * (j + 1) / (len(replayed) + 1)
                fr.event(tid, "advance", t=tj, parent=sid, date=int(d))
            fr.close(tid, sid, t=i + 0.75)
        fr.event(tid, "verdict", t=i + 0.875, verdict=verdict.status,
                 reason=verdict.reason)
        fr.finish(tid, verdict.status, t=i + 1.0, date=int(date),
                  reason=verdict.reason)
        return verdict

    def _row_name(self, name):
        if name is not None:
            return name
        return f"online/engine/{self._config_tag}"

    def flight_rows(self, name: str | None = None) -> list:
        """The recorder's ``kind="reqtrace"`` rows (empty with it off);
        ``name`` overrides the entry-point row name."""
        return [] if self._flight is None else self._flight.rows(
            self._row_name(name))

    def lineage_rows(self, name: str | None = None) -> list:
        """The ledger's ``kind="lineage"`` rows (empty with it off)."""
        return [] if self._lineage is None else self._lineage.rows(
            self._row_name(name))

    def sentry_rows(self, name: str | None = None) -> list:
        """The sentry's ``kind="alert"`` / ``kind="incident"`` rows (empty
        with it off)."""
        return [] if self._sentry is None else self._sentry.rows(
            self._row_name(name))

    def _ingest_inner(self, date: int, date_slice: DateSlice,
                      restate: bool = False) -> OnlineVerdict:
        date = int(date)
        self.counters["ingested_dates"] += 1
        h = _host_slice(date_slice)
        reason = self._slice_reason(h)
        if reason is not None:
            return self._reject(date, reason, h)
        if restate:
            return self._ingest_restatement(date, h)
        if self._applied and date <= self._applied[-1]:
            return self._reject(
                date, "duplicate" if date in self._applied_set
                else "out_of_order", h)
        reason = self._guard_reason(h)
        if reason is not None:
            return self._reject(date, reason, h)
        outs = self._apply_one(date, h, replaying=False)
        self.counters["applied_dates"] += 1
        self._sentry_observe(date, h)
        self._save()
        self._record()
        self._die_hook(date)
        return OnlineVerdict(date=date, status="applied",
                             outputs=tuple(outs))

    def _ingest_restatement(self, date: int, h: dict) -> OnlineVerdict:
        if date not in self._applied_set:
            return self._reject(date, "restate_unknown", h)
        # a corrected slice passes the SAME admission guards as a fresh one
        reason = self._guard_reason(h)
        if reason is not None:
            return self._reject(date, reason, h)
        ring_dates = [e[0] for e in self._snapshots]
        if date in ring_dates:
            verdict = self._rollback_replay(date, h)
        elif (self.retain_history and self._history_complete
              and any(d == date for d, _ in self._history)):
            self.counters["full_recompute_fallbacks"] += 1
            verdict = self._replay_from_genesis(date, h)
        else:
            # beyond every recovery horizon: no ring snapshot and no
            # complete retained stream to rebuild from
            return self._reject(date, "restate_beyond_horizon", h)
        self.counters["replayed_dates"] += 1
        self._sentry_observe(date, h)
        self._save(force=True)
        self._record()
        self._die_hook(date)
        return verdict

    def _patch_history(self, date: int, h: dict):
        if self.retain_history:
            self._history = [(d, h if d == date else old)
                             for d, old in self._history]

    def _rollback_replay(self, date: int, h: dict) -> OnlineVerdict:
        """Bounded rollback: restore the pre-apply state of the restated
        date, then re-apply it (corrected) and every journaled successor."""
        tail = [(d, (h if d == date else old))
                for d, old in self._journal if d >= date]
        idx = next(i for i, e in enumerate(self._snapshots) if e[0] == date)
        self._set_state(*self._snapshots[idx][1:])
        while len(self._snapshots) > idx:
            self._snapshots.pop()
        self._journal = deque(
            [(d, old) for d, old in self._journal if d < date],
            maxlen=self.horizon)
        self._applied = [d for d in self._applied if d < date]
        self._applied_set = set(self._applied)
        self._patch_history(date, h)
        outs: list = []
        replayed: list = []
        for d, hd in tail:
            outs.extend(self._apply_one(d, hd, replaying=True))
            replayed.append(d)
            self.counters["replay_applied_dates"] += 1
        return OnlineVerdict(date=date, status="replayed", reason="ring",
                             outputs=tuple(outs),
                             replayed_dates=tuple(replayed))

    def _replay_from_genesis(self, date: int, h: dict) -> OnlineVerdict:
        """The beyond-horizon fallback: fresh state, every retained slice
        re-applied with the restated date corrected; counted, and appended
        onto the audit chain like the ring path."""
        self._patch_history(date, h)
        self._set_state(self._init_fn())
        self._snapshots.clear()
        self._journal = deque(maxlen=self.horizon)
        self._applied = []
        self._applied_set = set()
        outs: list = []
        replayed: list = []
        for d, hd in self._history:
            outs.extend(self._apply_one(d, hd, replaying=True))
            replayed.append(d)
            self.counters["replay_applied_dates"] += 1
        return OnlineVerdict(date=date, status="replayed",
                             reason="full_recompute", outputs=tuple(outs),
                             replayed_dates=tuple(replayed))

    # ---------------------------------------------------------- telemetry

    def _die_hook(self, date: int):
        die_after = os.environ.get(_DIE_ENV)
        if die_after is not None and int(die_after) == int(date):
            self._progress(f"online: dying after date {date} "
                           f"({_DIE_ENV} test hook)")
            os._exit(137)

    def _record(self):
        record_stage(f"online/engine/{self._config_tag}", kind="online",
                     **self.report_fields())

    def report_fields(self) -> dict:
        """The ``kind="online"`` row body: the verdict counters, the reason
        breakdown and the stream position."""
        return {**self.counters,
                "rejected_reasons": dict(self.rejected_reasons),
                "last_date": self.last_date,
                "state_version": self.version,
                "horizon": self.horizon}

    def verdict_complete(self) -> bool:
        """Every ingestion terminated in exactly one verdict."""
        c = self.counters
        return c["ingested_dates"] == (c["applied_dates"]
                                       + c["replayed_dates"]
                                       + c["rejected_dates"])
