"""Operations sentry: online drift detection, SLO burn-rate alerting,
and auto-captured incident bundles for the serving/online stack.

Every other judgment rail is POST-HOC: the regression
differ compares two finished artifacts, ``--strict`` validates a report
after the run is over. The sentry is the missing ONLINE judgment layer —
it subscribes to the signals the stack already emits (verdict counters,
health gauges, metering accounts) at the same virtual-clock boundaries
the queue schedules on, and turns them into typed ``kind="alert"`` rows
and triage-ready ``kind="incident"`` bundles *during* the run. Three
detector families (docs/architecture.md §27):

- **SLO burn-rate** (:class:`BurnRateDetector`) — multi-window
  (fast/slow) burn alerts in the SRE-workbook style over CUMULATIVE
  event counters: the windowed bad-event rate divided by the declared
  budget must exceed the threshold in BOTH windows to fire (the fast
  window gives detection delay, the slow window suppresses blips). A
  ZERO budget means "this event is never legitimate" — any bad event in
  the fast window fires — which is how the default sentry watches
  dispatch failures and retries without ever false-positives on a clean
  drain that legitimately sheds under load.
- **drift detectors** (:class:`CusumDetector`, :class:`PageHinkley`,
  :class:`EwmaBandDetector`) — change detection over instantaneous
  gauges (queue depth, occupancy, pad fraction, online ``nan_frac`` /
  ``universe_count``), each against its own EWMA control baseline so no
  a-priori level needs declaring.
- **budget watch** (:class:`BudgetWatch`) — per-tenant metering accounts
  against declared cost budgets, the metering analog of ``SLOSpec``.

Alert semantics are FIRE-ON-TRANSITION: a detector fires once when it
enters alarm and re-arms only after the condition clears (burn windows
age out, CUSUM statistics reset), so a sustained excursion is one alert,
not one per evaluation — and the alert log for a given signal sequence
is deterministic, the property the kill/resume byte-equality pin rides.

On any firing evaluation with capture context, the sentry auto-captures
an **incident bundle**: the implicated trace ids (flight-recorder
joins), lineage output ids, tenants, per-tenant metering deltas since
the last capture, the firing detectors' frozen state, and the last
checkpoint reference. Completeness is artifact-checkable
(:func:`alert_errors` / :func:`incident_errors` / :func:`sentry_errors`
— shared by ``tools/incident.py``, ``tools/trace_report.py --strict``
and the tests): every firing alert names its detector, signal, window
and threshold; every incident's referenced trace/output/alert ids
resolve within the same report.

Everything here runs on the caller's EXPLICIT clock (the queue's virtual
seconds, the engine's ordinal tick axis) — the sentry never reads wall
time, so its alert log is a reproducible artifact, gateable under
``--no-wall``. Pure stdlib by design (``math``/``json`` only, no
numpy/jax): ``tools/incident.py`` loads this file standalone by path —
the ``obs.latency`` / ``obs.regression`` contract.
"""

from __future__ import annotations

import json
import math

__all__ = ["BudgetWatch", "BurnRateDetector", "CusumDetector",
           "EwmaBandDetector", "PageHinkley", "Sentry", "alert_errors",
           "incident_errors", "sentry_errors"]

#: the metadata every FIRING alert row must carry — the artifact-level
#: attribution contract ``--strict`` enforces
ALERT_META = ("detector", "signal", "window", "threshold")


def _round9(t):
    return None if t is None else round(float(t), 9)


# ------------------------------------------------------------- detectors


class BurnRateDetector:
    """Multi-window SLO burn-rate detector over cumulative counters.

    ``bad`` / ``total`` name the cumulative counter keys this detector
    reads at each evaluation (missing keys skip the evaluation — one
    detector set serves queue and engine alike). The burn over a window
    is ``(bad-event rate in window) / budget``; the detector fires when
    the burn exceeds ``threshold`` in BOTH the fast and the slow window.
    ``budget=0`` declares the event never-legitimate: any bad event in
    the fast window is an immediate (infinite-burn) alarm, reported with
    the windowed rate as the value (rows stay JSON-finite)."""

    kind = "burn_rate"

    def __init__(self, signal: str, *, bad: str, total: str,
                 budget: float, threshold: float = 1.0,
                 fast_window_s: float = 1.0, slow_window_s: float = 6.0):
        if not (float(budget) >= 0.0 and math.isfinite(float(budget))):
            raise ValueError(f"budget must be finite >= 0, got {budget}")
        if not (0.0 < float(fast_window_s) <= float(slow_window_s)):
            raise ValueError(
                f"need 0 < fast_window_s <= slow_window_s, got "
                f"{fast_window_s}, {slow_window_s}")
        if not (float(threshold) > 0.0):
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.signal = str(signal)
        self.bad = str(bad)
        self.total = str(total)
        self.budget = float(budget)
        self.threshold = float(threshold)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._snaps: list = []   # [t, bad_cum, total_cum], time-ordered
        self._alarmed = False

    def _window(self, t: float, window_s: float):
        """(bad_delta, total_delta) over ``[t - window_s, t]``; counts
        before the first snapshot are zero (a young stream's window
        simply reaches back to its start)."""
        t0 = t - window_s
        base_bad = base_total = 0.0
        for ts, b, tot in self._snaps:
            if ts <= t0:
                base_bad, base_total = b, tot
            else:
                break
        _, bad, total = self._snaps[-1]
        return bad - base_bad, total - base_total

    def _burn(self, bad_d: float, total_d: float):
        rate = bad_d / max(1.0, total_d)
        if self.budget == 0.0:
            return (math.inf if bad_d > 0 else 0.0), rate
        return rate / self.budget, rate

    def observe(self, t, counters, gauges, accounts):
        bad = counters.get(self.bad)
        total = counters.get(self.total)
        if bad is None or total is None:
            return None
        self._snaps.append([float(t), float(bad), float(total)])
        # prune to the slow window, keeping ONE snapshot at/before the
        # boundary (the window-start baseline)
        t0 = float(t) - self.slow_window_s
        while len(self._snaps) > 2 and self._snaps[1][0] <= t0:
            del self._snaps[0]
        fast_bad, fast_total = self._window(float(t), self.fast_window_s)
        slow_bad, slow_total = self._window(float(t), self.slow_window_s)
        fast_burn, fast_rate = self._burn(fast_bad, fast_total)
        slow_burn, _ = self._burn(slow_bad, slow_total)
        alarm = (fast_burn > self.threshold and slow_burn > self.threshold)
        fired = alarm and not self._alarmed
        self._alarmed = alarm
        if not fired:
            return None
        return {"detector": self.kind, "signal": self.signal,
                "window": self.window_label(), "threshold": self.threshold,
                "budget": self.budget, "value": round(fast_rate, 9),
                "detail": (f"{fast_bad:g} {self.bad} event(s) in the fast "
                           f"window over {fast_total:g} {self.total} — "
                           + ("zero-budget event occurred"
                              if self.budget == 0.0 else
                              f"burn {min(fast_burn, slow_burn):.3g}x "
                              f"budget in both windows"))}

    def window_label(self) -> str:
        return f"{self.fast_window_s:g}s/{self.slow_window_s:g}s"

    def describe(self) -> dict:
        return {"detector": self.kind, "signal": self.signal,
                "window": self.window_label(), "threshold": self.threshold,
                "budget": self.budget}

    def state(self) -> dict:
        return {"snaps": [list(s) for s in self._snaps],
                "alarmed": self._alarmed}

    def load_state(self, state: dict) -> None:
        self._snaps = [[float(a), float(b), float(c)]
                       for a, b, c in state.get("snaps", ())]
        self._alarmed = bool(state.get("alarmed", False))


class _GaugeDetector:
    """Shared shell of the gauge-driven drift detectors: read one gauge
    key per evaluation (missing -> skip), keep an EWMA baseline, defer
    the statistic to the subclass."""

    kind = "gauge"

    def __init__(self, signal: str, *, alpha: float = 0.2,
                 warmup: int = 5):
        if not 0.0 < float(alpha) <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if int(warmup) < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.signal = str(signal)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def _z(self, x: float) -> float:
        # normalized deviation against the EWMA band; the floor keeps a
        # constant-series baseline (exact-zero variance) from dividing
        # by zero while still letting any real step register as huge
        return (x - self.mean) / max(math.sqrt(max(self.var, 0.0)), 1e-9)

    def _update_baseline(self, x: float) -> None:
        if self.n == 1:
            self.mean, self.var = x, 0.0
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)

    def observe(self, t, counters, gauges, accounts):
        x = gauges.get(self.signal)
        if x is None or not math.isfinite(float(x)):
            return None
        x = float(x)
        self.n += 1
        if self.n <= self.warmup:
            # warmup folds into the baseline without arming — the first
            # samples DEFINE normal, they cannot deviate from it
            self._update_baseline(x)
            return None
        z = self._z(x)
        fired = self._step(z, x)
        self._update_baseline(x)
        if fired is None:
            return None
        return {"detector": self.kind, "signal": self.signal,
                "window": "ewma", "threshold": self._threshold(),
                "value": round(x, 9), **fired}

    def describe(self) -> dict:
        return {"detector": self.kind, "signal": self.signal,
                "window": "ewma", "threshold": self._threshold()}

    def _base_state(self) -> dict:
        return {"n": self.n, "mean": self.mean, "var": self.var}

    def _load_base(self, state: dict) -> None:
        self.n = int(state.get("n", 0))
        self.mean = float(state.get("mean", 0.0))
        self.var = float(state.get("var", 0.0))


class CusumDetector(_GaugeDetector):
    """Two-sided CUSUM over the EWMA-normalized deviation: accumulate
    ``max(0, s + |z| - k)`` per side and fire at ``s > h``; the firing
    side's accumulator resets (the re-arm)."""

    kind = "cusum"

    def __init__(self, signal: str, *, k: float = 0.5, h: float = 5.0,
                 alpha: float = 0.2, warmup: int = 5):
        super().__init__(signal, alpha=alpha, warmup=warmup)
        self.k = float(k)
        self.h = float(h)
        self.s_hi = 0.0
        self.s_lo = 0.0

    def _threshold(self) -> float:
        return self.h

    def _step(self, z: float, x: float):
        self.s_hi = max(0.0, self.s_hi + z - self.k)
        self.s_lo = max(0.0, self.s_lo - z - self.k)
        if self.s_hi > self.h:
            stat, self.s_hi = self.s_hi, 0.0
            return {"detail": f"cusum upward shift: s={stat:.3g} > "
                              f"h={self.h:g} (baseline {self.mean:.6g})"}
        if self.s_lo > self.h:
            stat, self.s_lo = self.s_lo, 0.0
            return {"detail": f"cusum downward shift: s={stat:.3g} > "
                              f"h={self.h:g} (baseline {self.mean:.6g})"}
        return None

    def state(self) -> dict:
        return {**self._base_state(), "s_hi": self.s_hi, "s_lo": self.s_lo}

    def load_state(self, state: dict) -> None:
        self._load_base(state)
        self.s_hi = float(state.get("s_hi", 0.0))
        self.s_lo = float(state.get("s_lo", 0.0))


class PageHinkley(_GaugeDetector):
    """Page-Hinkley test on the raw gauge: accumulate
    ``m += x - mean - delta`` against the running minimum and fire when
    ``m - min(m)`` exceeds ``lam`` (upward drift; the mirrored
    accumulator catches downward). Resets on fire."""

    kind = "page_hinkley"

    def __init__(self, signal: str, *, delta: float = 0.005,
                 lam: float = 5.0, alpha: float = 0.2, warmup: int = 5):
        super().__init__(signal, alpha=alpha, warmup=warmup)
        self.delta = float(delta)
        self.lam = float(lam)
        self.m_hi = 0.0
        self.min_hi = 0.0
        self.m_lo = 0.0
        self.min_lo = 0.0

    def _threshold(self) -> float:
        return self.lam

    def _step(self, z: float, x: float):
        self.m_hi += x - self.mean - self.delta
        self.min_hi = min(self.min_hi, self.m_hi)
        self.m_lo += self.mean - x - self.delta
        self.min_lo = min(self.min_lo, self.m_lo)
        if self.m_hi - self.min_hi > self.lam:
            stat = self.m_hi - self.min_hi
            self.m_hi = self.min_hi = 0.0
            return {"detail": f"page-hinkley upward drift: "
                              f"{stat:.3g} > lam={self.lam:g}"}
        if self.m_lo - self.min_lo > self.lam:
            stat = self.m_lo - self.min_lo
            self.m_lo = self.min_lo = 0.0
            return {"detail": f"page-hinkley downward drift: "
                              f"{stat:.3g} > lam={self.lam:g}"}
        return None

    def state(self) -> dict:
        return {**self._base_state(), "m_hi": self.m_hi,
                "min_hi": self.min_hi, "m_lo": self.m_lo,
                "min_lo": self.min_lo}

    def load_state(self, state: dict) -> None:
        self._load_base(state)
        self.m_hi = float(state.get("m_hi", 0.0))
        self.min_hi = float(state.get("min_hi", 0.0))
        self.m_lo = float(state.get("m_lo", 0.0))
        self.min_lo = float(state.get("min_lo", 0.0))


class EwmaBandDetector(_GaugeDetector):
    """Plain EWMA control band: fire when the normalized deviation
    leaves ``nsig`` sigmas (transition-latched — one alert per
    excursion, re-armed when the gauge returns inside the band)."""

    kind = "ewma_band"

    def __init__(self, signal: str, *, nsig: float = 4.0,
                 alpha: float = 0.2, warmup: int = 5):
        super().__init__(signal, alpha=alpha, warmup=warmup)
        self.nsig = float(nsig)
        self._alarmed = False

    def _threshold(self) -> float:
        return self.nsig

    def _step(self, z: float, x: float):
        alarm = abs(z) > self.nsig
        fired = alarm and not self._alarmed
        self._alarmed = alarm
        if not fired:
            return None
        return {"detail": f"gauge left the ewma band: |z|={abs(z):.3g} > "
                          f"{self.nsig:g} sigma (baseline {self.mean:.6g})"}

    def state(self) -> dict:
        return {**self._base_state(), "alarmed": self._alarmed}

    def load_state(self, state: dict) -> None:
        self._load_base(state)
        self._alarmed = bool(state.get("alarmed", False))


class BudgetWatch:
    """Per-tenant metering accounts against declared cost budgets — the
    metering analog of ``SLOSpec``. ``budgets`` maps tenant label to
    ``{cost_key: limit}``; each breach fires ONCE (the account only
    grows, so a breached pair stays breached — latching is the re-fire
    suppression)."""

    kind = "budget_watch"

    def __init__(self, budgets: dict, *, signal: str = "tenant_budget"):
        self.signal = str(signal)
        self.budgets = {str(t): {str(k): float(v) for k, v in lim.items()}
                        for t, lim in dict(budgets).items()}
        for t, lim in self.budgets.items():
            for k, v in lim.items():
                if not (v > 0.0 and math.isfinite(v)):
                    raise ValueError(f"budget {t}/{k} must be positive "
                                     f"finite, got {v}")
        self._breached: list = []  # ["tenant|key", ...] (JSON-stable)

    def observe(self, t, counters, gauges, accounts):
        if not accounts:
            return None
        fired = None
        for tenant in sorted(self.budgets):
            acct = accounts.get(tenant)
            if not acct:
                continue
            for key, limit in sorted(self.budgets[tenant].items()):
                mark = f"{tenant}|{key}"
                spent = float(acct.get(key, 0.0))
                if spent <= limit or mark in self._breached:
                    continue
                self._breached.append(mark)
                if fired is None:
                    fired = {"detector": self.kind, "signal": self.signal,
                             "window": "run", "threshold": limit,
                             "value": round(spent, 9), "tenant": tenant,
                             "detail": f"tenant {tenant!r} spent "
                                       f"{spent:.6g} {key} against a "
                                       f"budget of {limit:g}"}
        return fired

    def describe(self) -> dict:
        return {"detector": self.kind, "signal": self.signal,
                "window": "run", "tenants": sorted(self.budgets)}

    def state(self) -> dict:
        return {"breached": list(self._breached)}

    def load_state(self, state: dict) -> None:
        self._breached = [str(b) for b in state.get("breached", ())]


def default_detectors() -> list:
    """The sentry's default arming: ONLY the zero-budget burn detectors
    over dispatch failures and retries — events that are never
    legitimate on a clean drain, so the defaults cannot false-positive
    on a run that merely sheds or degrades under load (shed/miss/SLO and
    drift detectors arm by explicit declaration)."""
    return [BurnRateDetector("failure_rate", bad="failed",
                             total="submitted", budget=0.0),
            BurnRateDetector("retry_rate", bad="retries",
                             total="submitted", budget=0.0)]


# ------------------------------------------------------------- the sentry


class Sentry:
    """The online judgment loop (module docs): feed it the stack's
    signals at every evaluation boundary; it returns the alerts that
    fired and auto-captures incident bundles when capture context is
    supplied. State round-trips through ONE sorted-keys JSON string
    (:meth:`state`), which is how it rides the queue/engine checkpoint
    seams — a killed-and-resumed run's alert log is byte-equal to a
    straight-through run's."""

    def __init__(self, *, detectors=None, budgets=None):
        self.detectors = (list(detectors) if detectors is not None
                          else default_detectors())
        if budgets:
            self.detectors.append(BudgetWatch(budgets))
        self.alerts: list = []
        self.incidents: list = []
        self.evals = 0
        self._last_accounts: dict = {}  # tenant -> costs at last capture

    # ----------------------------------------------------------- observing

    def observe(self, *, t, counters=None, gauges=None, accounts=None,
                context=None) -> list:
        """One evaluation at explicit time ``t``: run every detector over
        the cumulative ``counters``, instantaneous ``gauges`` and
        metering ``accounts``; returns the alert dicts that fired (often
        empty). With ``context`` (trace_ids / output_ids / tenants /
        checkpoint), a firing evaluation auto-captures one incident."""
        self.evals += 1
        counters = counters or {}
        gauges = gauges or {}
        fired = []
        for det in self.detectors:
            res = det.observe(float(t), counters, gauges, accounts)
            if res is not None:
                alert = {"alert_id": f"a{len(self.alerts)}",
                         "t_s": _round9(t), **res}
                self.alerts.append(alert)
                fired.append(alert)
        if fired and context is not None:
            self.capture_incident(fired, t=t, accounts=accounts,
                                  **context)
        return fired

    def capture_incident(self, fired, *, t, accounts=None, trace_ids=(),
                         output_ids=(), tenants=(),
                         checkpoint=None) -> dict:
        """Bundle one alarm's triage context: the firing alerts, the
        implicated trace/output ids and tenants, each tenant's metering
        delta since the LAST capture (the alarm window's bill), the
        firing detectors' frozen state, and the checkpoint reference."""
        fired = list(fired)
        tenants = [str(x) for x in dict.fromkeys(tenants)]
        delta: dict = {}
        if accounts:
            for tn in tenants:
                cur = {k: float(v)
                       for k, v in (accounts.get(tn) or {}).items()}
                prev = self._last_accounts.get(tn, {})
                delta[tn] = {k: round(cur[k] - prev.get(k, 0.0), 9)
                             for k in sorted(cur)}
                self._last_accounts[tn] = cur
        fired_kinds = {(a.get("detector"), a.get("signal"))
                       for a in fired}
        det_state = [{"detector": d.kind, "signal": d.signal,
                      "state": d.state()}
                     for d in self.detectors
                     if (d.kind, d.signal) in fired_kinds]
        incident = {"incident_id": f"inc{len(self.incidents)}",
                    "t_s": _round9(t),
                    "alert_ids": [a["alert_id"] for a in fired],
                    "trace_ids": [str(x) for x in trace_ids],
                    "output_ids": [str(x) for x in output_ids],
                    "tenants": tenants,
                    "metering_delta": delta,
                    "checkpoint": (None if checkpoint is None
                                   else str(checkpoint)),
                    "detector_state": det_state}
        self.incidents.append(incident)
        return incident

    # ------------------------------------------------------------- reading

    def fired_signals(self) -> list:
        """The distinct signals that fired, in first-fire order — the
        chaos grids' attribution key."""
        return list(dict.fromkeys(a["signal"] for a in self.alerts))

    def rows(self, name: str) -> list:
        """The sentry as report rows: ONE summary ``kind="alert"`` row
        (always present, even at zero alerts — "the sentry ran and saw
        nothing" is itself gateable evidence), one row per firing alert,
        one ``kind="incident"`` row per captured bundle."""
        out = [{"kind": "alert", "name": name, "summary": True,
                "alerts_fired": len(self.alerts),
                "incidents": len(self.incidents), "evals": self.evals,
                "detectors": [d.describe() for d in self.detectors]}]
        out += [{"kind": "alert", "name": name, **a} for a in self.alerts]
        out += [{"kind": "incident", "name": name, **i}
                for i in self.incidents]
        return out

    # ------------------------------------------- snapshot round-trip (JSON)

    def state(self) -> str:
        return json.dumps(
            {"detectors": [d.state() for d in self.detectors],
             "alerts": self.alerts, "incidents": self.incidents,
             "evals": self.evals, "last_accounts": self._last_accounts},
            sort_keys=True)

    def load_state(self, state: str) -> None:
        doc = json.loads(state)
        saved = doc.get("detectors", ())
        if len(saved) != len(self.detectors):
            raise ValueError(
                f"sentry snapshot carries {len(saved)} detector state(s) "
                f"for {len(self.detectors)} configured detector(s) — "
                f"resume with the same detector set")
        for det, st in zip(self.detectors, saved):
            det.load_state(st)
        self.alerts = [dict(a) for a in doc.get("alerts", ())]
        self.incidents = [dict(i) for i in doc.get("incidents", ())]
        self.evals = int(doc.get("evals", 0))
        self._last_accounts = {
            str(t): {str(k): float(v) for k, v in acct.items()}
            for t, acct in doc.get("last_accounts", {}).items()}


# ------------------------------------------------- artifact-level checks


def alert_errors(rows) -> list:
    """Attribution completeness judged from report rows alone: every
    FIRING ``kind="alert"`` row must carry an ``alert_id`` and name its
    detector, signal, window and threshold; every summary row's
    ``alerts_fired`` / ``incidents`` counts must match the rows actually
    present under its name (a count with no rows is a silently dropped
    alert log)."""
    errs = []
    firing: dict = {}
    incidents: dict = {}
    summaries: dict = {}
    for r in rows:
        if r.get("kind") == "incident":
            incidents.setdefault(r.get("name", "?"), []).append(r)
        if r.get("kind") != "alert":
            continue
        name = r.get("name", "?")
        if r.get("summary"):
            summaries[name] = r
            continue
        firing.setdefault(name, []).append(r)
        aid = r.get("alert_id")
        if not aid:
            errs.append(f"alert {name!r}: firing alert row has no "
                        f"alert_id")
            aid = "?"
        for field in ALERT_META:
            if r.get(field) is None:
                errs.append(f"alert {name}/{aid}: missing {field!r} — a "
                            f"firing alert must name its detector, "
                            f"signal, window and threshold")
    for name, s in summaries.items():
        n_alerts = len(firing.get(name, []))
        n_inc = len(incidents.get(name, []))
        want = s.get("alerts_fired")
        if isinstance(want, int) and want != n_alerts:
            errs.append(f"alert {name!r}: summary claims {want} firing "
                        f"alert(s) but {n_alerts} row(s) present — the "
                        f"alert log was truncated or double-counted")
        want = s.get("incidents")
        if isinstance(want, int) and want != n_inc:
            errs.append(f"alert {name!r}: summary claims {want} "
                        f"incident(s) but {n_inc} row(s) present")
    return errs


def incident_errors(rows) -> list:
    """Referential integrity of every ``kind="incident"`` row: the
    cited alert ids must exist as firing alert rows under the same name,
    every referenced trace id must resolve to a ``kind="reqtrace"`` row,
    and every referenced output id to a ``kind="lineage"`` edge — a
    bundle pointing at evidence the report does not contain is exactly
    the dangling shape ``--strict`` exists to reject."""
    errs = []
    trace_ids = {str(r.get("trace_id")) for r in rows
                 if r.get("kind") == "reqtrace"}
    output_ids = {str(r.get("output_id")) for r in rows
                  if r.get("kind") == "lineage" and r.get("output_id")}
    alert_ids: dict = {}
    for r in rows:
        if (r.get("kind") == "alert" and not r.get("summary")
                and r.get("alert_id")):
            alert_ids.setdefault(r.get("name", "?"),
                                 set()).add(r["alert_id"])
    for r in rows:
        if r.get("kind") != "incident":
            continue
        name = r.get("name", "?")
        iid = r.get("incident_id")
        if not iid:
            errs.append(f"incident {name!r}: row has no incident_id")
            iid = "?"
        cited = r.get("alert_ids") or []
        if not cited:
            errs.append(f"incident {name}/{iid}: cites no alert ids — an "
                        f"incident must name the alerts that fired it")
        for aid in cited:
            if aid not in alert_ids.get(name, set()):
                errs.append(f"incident {name}/{iid}: cites alert "
                            f"{aid!r} with no firing alert row under "
                            f"{name!r} — a dangling alert id")
        for tid in r.get("trace_ids") or []:
            if str(tid) not in trace_ids:
                errs.append(f"incident {name}/{iid}: references trace "
                            f"{tid!r} with no reqtrace row — a dangling "
                            f"trace id")
        for oid in r.get("output_ids") or []:
            if str(oid) not in output_ids:
                errs.append(f"incident {name}/{iid}: references output "
                            f"{oid!r} with no lineage edge — a dangling "
                            f"output id")
    return errs


def sentry_errors(rows) -> list:
    """The combined artifact checker (``tools/incident.py --strict`` /
    ``tools/trace_report.py --strict``)."""
    return alert_errors(rows) + incident_errors(rows)
