"""RunReport regression gating: diff two report JSONLs, machine-checkably.

Every run emits a structured report (spans, counters, numerics
frames, compile rows); this module adds the *judgment*: given a known-good
baseline report and a fresh one, decide — with an exit code, not a human
squint — whether the fresh run regressed, and if a NaN appeared, WHICH
stage it was born in.

Checks (each can be tuned/disabled by the caller / ``tools/report_diff.py``
flags):

- **spans** — every baseline span name must still exist; per-name total
  wall seconds may not exceed ``wall_ratio`` x baseline (only spans whose
  baseline total is at least ``wall_min_s``, so microsecond stages cannot
  flake the gate).
- **counters** — every baseline counter key must still exist; keys with a
  known "bad direction" (``GATE_UP``: solver fallbacks, NaN share,
  retraces, ...) gate on increases beyond ``counter_tol``; everything else
  is reported as informational drift.
- **numerics** — every baseline probe stage must still exist; a stage
  whose finite fraction dropped more than ``finite_tol`` below baseline is
  a regression, and the FIRST such stage in trace order is the watchdog
  attribution (``first_bad_stage``) — the report-level answer to "where
  was this NaN born?". NaN/Inf count increases on a stage with an intact
  finite fraction are informational (a bigger tensor can carry more
  legitimate NaN).
- **meta** — reports carry a ``kind="meta"`` header (schema version,
  backend, device kind/count). MISMATCHED SCHEMA VERSIONS REFUSE to gate
  (one regression finding, nothing else judged — half the rows would be
  incomparable); a backend/device-kind mismatch is warned and disables
  wall gating (cross-machine wall ratios gate container speed, not code).
- **comms** (placement ledger) — per (entry point, stage): a
  collective KIND whose count increased is a regression (HLO op counts
  are deterministic; a new all-gather means the partitioner now moves
  data it didn't), and ``bytes_moved`` growth beyond ``comms_ratio`` with
  at least ``comms_min_bytes`` of absolute growth is a regression; byte
  shrinkage and brand-new ledger rows are notes (re-baseline to gate).
  Rows carrying a ``by_axis`` split (every per-stage row does)
  additionally gate PER MESH AXIS under the same ratio + floor, keyed on
  the ledger's stage names: an asset-axis byte blowup in one stage cannot
  hide behind another axis's shrinkage in that stage's total.
- **memory** — per entry point, ``peak_bytes`` growth beyond
  ``mem_ratio`` with at least ``mem_min_bytes`` absolute growth is a
  regression; a vanished memory row is a schema regression.
- **sharding** — a lint row that is no longer ``clean`` (or whose flag
  count grew) against a clean baseline is a regression: XLA started
  replicating or resharding something it didn't before.
- **latency** (quantile sketches) — every baseline latency scope
  must still exist; per-scope p50/p99 may not exceed ``wall_ratio`` x
  baseline (same 1.5x / ``--no-wall`` / cross-backend conventions as
  spans). The noise floor is count-aware: sketches under 100
  observations keep the span ``wall_min_s`` floor (a near-single-shot
  wall is mostly scheduler noise), while well-populated sketches —
  the 503-sample millisecond per-date advance baseline — gate down to
  1 ms. An ``slo_violated`` latency row in the NEW report is
  a regression REGARDLESS of wall gating: the SLO is the run's own
  declared budget, not a machine comparison (a pre-existing baseline
  violation is noted in the detail but does not excuse the new one).
- **devtime** — a baseline ``stage="total"`` device-time row (attribution
  or honest skip) that vanished is a schema regression; per-stage
  device-second drift is informational (device clocks gate via the SLO/
  latency artifacts, not via one traced execution).
- **serving** (request queue) — every baseline ``kind="serving"``
  row must still exist, and its ``shed_count`` / ``deadline_miss_count`` /
  ``retry_count`` / ``failed_count`` gate UP: under the same recorded
  traffic, more shed or missed or retried requests means the serving
  layer (or the hardware under it) got slower or flakier. Decreases and
  other drift are informational; new serving rows are re-baseline notes.
- **metering** (flight recorder) — every baseline
  ``kind="metering"`` row must still exist with every baseline ACCOUNT
  (per-tenant + the explicit overheads); a tenant account's cost growth
  beyond ``wall_ratio`` x baseline AND an absolute per-dimension floor
  (``metering_floor_s`` for seconds; 1 solve / 1 KiB / 1 MiB for the
  others) is a regression. The serving queue's metered wall is VIRTUAL
  (the scheduler's deterministic charge, not host time), so this gate
  stays armed under ``--no-wall`` — a cost drift there is a scheduling/
  billing change, never machine speed. ``pad_fraction`` growth beyond
  ``pad_frac_tol`` gates too: the pad account is the amortization-
  honesty number, and silent growth means the ladder stopped fitting
  the traffic. Decreases and brand-new rows/accounts are notes.
- **series** (health series) — every baseline ``kind="series"``
  row must still exist, and ``max_depth`` growth beyond ``wall_ratio`` x
  baseline with ``depth_slack`` absolute headroom is a regression
  (armed under ``--no-wall``: on the virtual clock the depth profile is
  a deterministic function of the recorded traffic, so growth is a
  scheduling regression, not machine speed). ``max_occupancy`` drift is
  informational.
- **alert** (operations sentry) — the sentry's alert log is a
  deterministic function of the recorded traffic on the virtual clock,
  so it gates in BOTH directions and stays armed under ``--no-wall``: a
  firing ``detector(signal)`` key absent from the baseline (or a
  firing-count/incident-count increase) is an operational regression —
  the run now trips an alarm it didn't; a vanished sentry summary
  scope, fired key or incident bundle is a schema regression — the
  sentry was disarmed or the capture path stopped emitting, silently
  un-auditing the run (re-baseline to accept an intentional fix).
  Brand-new sentry scopes are re-baseline notes. Alert CONTENTS
  (thresholds, values, detail strings) never gate here — completeness
  and attribution are ``tools/incident.py --strict``'s job.
- **bench** — bench rows are invocation-dependent (configs are selected
  per run), so presence is never gated; but a seconds-valued bench row
  present in both reports gates its value at ``wall_ratio`` — against
  ``max(baseline value, baseline spread max)`` when the baseline carries
  a ``spread`` (best-of-N min/max), so a documented container-speed
  swing absorbs into the gate instead of crying wolf. RATE-valued rows
  gate in the OPPOSITE direction under the same conventions: ANY unit
  ending in ``/s`` matches — the serving layer's ``configs/s``
  throughput and the scenario engine's ``paths/s`` gate through this one
  clause, no per-unit copies of the logic (unit-tested) — a drop below
  ``baseline / wall_ratio`` is a regression, judged against
  ``min(baseline value, baseline spread min)`` so the recorded
  run-to-run swing absorbs first.
- **scenario** (risk rows) — every baseline ``kind="scenario"``
  row must still exist; its VaR/ES vectors (oriented bigger-is-worse for
  every metric — loss magnitudes for PnL, raw upper tails for drawdown/
  turnover) gate on WORSENING beyond ``wall_ratio`` x ``max(baseline,
  baseline spread max)`` per level (the bench-row ratio+spread
  convention; scenario sweeps are seeded-deterministic, so the gate
  stays armed even under ``--no-wall`` — a risk worsening is never
  machine speed). Non-finite VaR/ES in the new report and
  ``nonfinite_paths`` growth are regressions outright (a path whose risk
  scalar isn't a number is a broken scenario, not a tail event);
  improvements and brand-new scenario rows are notes.
- **online** (advance-engine rows) — every baseline
  ``kind="online"`` row must still exist; its ``rejected_dates`` /
  ``replayed_dates`` / ``full_recompute_fallbacks`` gate UP (under the
  same recorded feed, more rejections or replays means the feed — or the
  engine's guards — got worse; the fallback count is an O(history)
  recompute a healthy stream never takes), and a NEW report whose
  verdict counts do not sum to its ingestions is a regression outright
  (the engine's completeness invariant, judged from the artifact). Both
  stay armed under ``--no-wall`` — verdict counts are never machine
  speed. The per-date advance latency scopes (``online/*`` and
  ``bench/online_advance``) additionally keep their p50/p99 ratio gate
  armed under ``--no-wall`` at the count-aware floor: the advance p99 is
  the product's own SLO surface, so a worsening must not hide behind a
  cross-machine diff (the finding is labeled so a genuinely cross-backend
  pair can be triaged).

Deliberately **pure stdlib** with no package-relative imports:
``tools/report_diff.py`` loads this file standalone (importlib by path) so
the gate runs on any box that has two JSONLs — CI, a laptop, a box with no
jax — exactly like ``tools/trace_report.py``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from collections import defaultdict
from pathlib import Path

__all__ = ["DiffResult", "Finding", "GATE_UP", "alert_rows", "bench_rows",
           "comms_rows", "counter_scalars", "devtime_rows", "diff_reports",
           "fired_alerts", "incident_rows", "latency_rows", "lineage_rows",
           "load_jsonl", "memory_rows", "meta_row", "metering_rows",
           "numerics_baseline", "online_rows", "scenario_rows",
           "series_rows", "serving_rows", "sharding_rows", "span_totals",
           "traffic_rows"]

#: absolute per-dimension growth floors of the metering gate — drift
#: below the floor never gates, whatever the ratio says (a 2x ratio on
#: a microsecond bill is noise, not a cost regression). wall_s uses the
#: tunable ``metering_floor_s`` instead.
METERING_FLOORS = {"qp_solves": 1.0, "iterations": 1.0,
                   "comms_bytes": 1024.0, "mem_bytes": float(1 << 20)}

#: online-engine counters whose INCREASE against a baseline is a
#: regression (kind="online" rows; see the module docs' online section)
ONLINE_GATE_UP = ("rejected_dates", "replayed_dates",
                  "full_recompute_fallbacks")

#: counter keys whose INCREASE is a regression (everything else drifts
#: informationally). Nested mean/max counters gate on their "mean" leaf.
#: ``degrade_events`` (resil.policy.DegradeStats): a healthy feed degrades
#: nowhere, so a baseline-relative growth of quarantined/held/carried/
#: clamped dates means the inputs (or the solver) got worse. The serving
#: queue's bad-direction counts (shed_count/deadline_miss_count/
#: retry_count/failed_count) gate through the dedicated
#: ``kind="serving"`` section in :func:`diff_reports`, NOT through this
#: tuple — they never appear in ``kind="counters"`` rows, and an
#: endswith match here could accidentally gate an unrelated counter.
GATE_UP = ("solver_fallback_days", "factor_nan_frac", "retraces",
           "turnover_suffix_len", "degrade_events")


@dataclasses.dataclass
class Finding:
    """One diff observation. ``regression`` findings drive the exit code;
    the rest are context."""

    kind: str       # "span" | "counter" | "numerics" | "schema" | "watchdog"
    name: str
    detail: str
    regression: bool = False

    def render(self) -> str:
        tag = "REGRESSION" if self.regression else "note"
        return f"{tag} [{self.kind}] {self.name}: {self.detail}"


@dataclasses.dataclass
class DiffResult:
    findings: list
    first_bad_stage: "str | None" = None

    @property
    def regressions(self) -> list:
        return [f for f in self.findings if f.regression]

    @property
    def ok(self) -> bool:
        return not self.regressions

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        if self.first_bad_stage is not None:
            lines.append(f"watchdog: first bad stage = {self.first_bad_stage}")
        lines.append(f"report_diff: {len(self.regressions)} regression(s), "
                     f"{len(self.findings) - len(self.regressions)} note(s)")
        return "\n".join(lines)


def load_jsonl(path) -> list:
    """Rows of one report JSONL; unparseable lines (a run killed mid-write
    truncates the last one) are skipped with a warning naming file and line
    — same contract as ``tools/trace_report.py``."""
    rows = []
    path = Path(path)
    # errors="replace": undecodable bytes (a binary file passed by
    # mistake, a torn multi-byte char at a truncation point) become
    # replacement chars that fail json.loads and take the skip-with-
    # warning path below — never a UnicodeDecodeError traceback, which
    # would escape the callers' OSError handling and exit with the wrong
    # code (tools/report_diff.py's exit-code contract)
    with path.open(errors="replace") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError as e:
                print(f"warning: {path}:{lineno}: skipping unparseable "
                      f"JSONL line ({e})", file=sys.stderr)
    return rows


# ----------------------------------------------------------------- views


def span_totals(rows) -> dict:
    """name -> total wall seconds over every span row."""
    out: dict = defaultdict(float)
    for r in rows:
        if r.get("kind") == "span":
            out[r["name"]] += float(r.get("wall_s", 0.0))
    return dict(out)


def counter_scalars(rows) -> dict:
    """(row_name, counter_key) -> gateable scalar. Nested ``{mean, max}``
    counters contribute their ``mean``; non-numeric values are skipped."""
    out: dict = {}
    for r in rows:
        if r.get("kind") != "counters":
            continue
        for key, val in (r.get("counters") or {}).items():
            if isinstance(val, dict):
                val = val.get("mean")
            if isinstance(val, (int, float)) and val == val:  # finite-ish
                out[(r["name"], key)] = float(val)
    return out


def numerics_frames(rows) -> dict:
    """(step_name, stage) -> numerics row (kind="numerics"; last occurrence
    wins). Keyed like :func:`counter_scalars` — by the probed STEP as well
    as the stage — so two instrumented steps that both probe a
    ``solver/admm`` stage never overwrite each other in a diff."""
    return {(r.get("name", ""), r["stage"]): r for r in rows
            if r.get("kind") == "numerics" and "stage" in r}


def numerics_baseline(rows, name: str | None = None) -> dict:
    """stage -> finite_frac from a report's numerics rows — the ``baseline``
    argument of ``obs.probes.watchdog`` and of ``RunReport.add_probes``.
    ``name`` selects one probed step's rows when the report carries
    several (stage keys collide across steps; without a filter the last
    row per stage wins)."""
    return {stage: float(r.get("finite_frac", 1.0))
            for (step, stage), r in numerics_frames(rows).items()
            if name is None or step == name}


def compile_rows(rows) -> dict:
    """name -> last compile row (cumulative fields, so last is the total)."""
    return {r["name"]: r for r in rows if r.get("kind") == "compile"}


def meta_row(rows) -> "dict | None":
    """The report's ``kind="meta"`` header row, or None (pre-PR-5
    reports have none and still diff — every meta check degrades to a
    note)."""
    for r in rows:
        if r.get("kind") == "meta":
            return r
    return None


def comms_rows(rows) -> dict:
    """(entry_point_name, stage) -> comms row (last occurrence wins;
    error rows — ledger collection failures — are excluded from
    gating)."""
    return {(r.get("name", ""), r.get("stage", "")): r for r in rows
            if r.get("kind") == "comms" and "error" not in r}


def memory_rows(rows) -> dict:
    """name -> last memory row."""
    return {r.get("name", ""): r for r in rows if r.get("kind") == "memory"}


def sharding_rows(rows) -> dict:
    """name -> last sharding-lint row."""
    return {r.get("name", ""): r for r in rows
            if r.get("kind") == "sharding"}


def latency_rows(rows) -> dict:
    """name -> last latency-sketch row (kind="latency")."""
    return {r.get("name", ""): r for r in rows
            if r.get("kind") == "latency"}


def devtime_rows(rows) -> dict:
    """(name, stage) -> last device-time row (kind="devtime"); error rows
    — capture failures — are excluded from gating, skip rows are not
    (an honest skip is part of the schema a baseline pins)."""
    return {(r.get("name", ""), r.get("stage", "")): r for r in rows
            if r.get("kind") == "devtime" and "error" not in r}


def serving_rows(rows) -> dict:
    """name -> last serving-queue row (kind="serving"; the verdict-count
    summary ``serve/queue.py`` emits, and the per-cell rows of the chaos
    serving preset)."""
    return {r.get("name", ""): r for r in rows
            if r.get("kind") == "serving"}


def scenario_rows(rows) -> dict:
    """name -> last scenario risk row (kind="scenario"; one row per
    (sweep tag, metric), the VaR/ES artifacts). Cell verdict
    rows (kind="scenario_cell") are not risk rows and are excluded."""
    return {r.get("name", ""): r for r in rows
            if r.get("kind") == "scenario"}


def online_rows(rows) -> dict:
    """name -> last online-engine row (kind="online"); last wins — the
    engine re-emits its counters after every verdict, and the final row
    carries the stream's terminal tallies."""
    return {r.get("name", "?"): r for r in rows
            if r.get("kind") == "online"}


def online_verdicts_complete(row) -> bool:
    """The engine's completeness invariant, judged from one row."""
    def n(key):
        v = row.get(key)
        return v if isinstance(v, (int, float)) \
            and not isinstance(v, bool) else None

    parts = [n("applied_dates"), n("replayed_dates"), n("rejected_dates")]
    total = n("ingested_dates")
    if total is None or any(p is None for p in parts):
        return False
    return sum(parts) == total


def metering_rows(rows) -> dict:
    """name -> last metering row (kind="metering", the flight
    recorder's per-tenant cost accounts)."""
    return {r.get("name", ""): r for r in rows
            if r.get("kind") == "metering"}


def series_rows(rows) -> dict:
    """name -> last health-series row (kind="series")."""
    return {r.get("name", ""): r for r in rows
            if r.get("kind") == "series"}


def bench_rows(rows) -> dict:
    """name -> last bench row (kind="bench", keyed by metric name)."""
    return {r.get("metric", r.get("name", "")): r for r in rows
            if r.get("kind") == "bench"}


def lineage_rows(rows) -> dict:
    """name -> count of provenance edges (kind="lineage", the
    ledger). The diff gates on PRESENCE per ledger name — a producing
    layer that stopped emitting its ledger is a schema break — not on
    edge contents (content ids legitimately change with the data)."""
    out: dict = defaultdict(int)
    for r in rows:
        if r.get("kind") == "lineage":
            out[r.get("name", "")] += 1
    return dict(out)


def traffic_rows(rows) -> dict:
    """name -> count of arrival-trace rows (kind="traffic", one per
    request of every complete ``serve_queued`` drain)."""
    out: dict = defaultdict(int)
    for r in rows:
        if r.get("kind") == "traffic":
            out[r.get("name", "")] += 1
    return dict(out)


def alert_rows(rows) -> dict:
    """name -> last sentry SUMMARY row (kind="alert" with summary=True,
    the operations sentry's per-scope roll-up)."""
    return {r.get("name", ""): r for r in rows
            if r.get("kind") == "alert" and r.get("summary")}


def fired_alerts(rows) -> dict:
    """name -> {"detector(signal)": firing count} over the non-summary
    ``kind="alert"`` rows — the diff's gate key: WHICH detectors fired,
    and how often, under the recorded traffic."""
    out: dict = {}
    for r in rows:
        if r.get("kind") != "alert" or r.get("summary"):
            continue
        key = f"{r.get('detector', '?')}({r.get('signal', '?')})"
        per = out.setdefault(r.get("name", ""), defaultdict(int))
        per[key] += 1
    return {name: dict(per) for name, per in out.items()}


def incident_rows(rows) -> dict:
    """name -> count of auto-captured incident bundles
    (kind="incident")."""
    out: dict = defaultdict(int)
    for r in rows:
        if r.get("kind") == "incident":
            out[r.get("name", "")] += 1
    return dict(out)


# ------------------------------------------------------------------ diff


def diff_reports(base_rows, new_rows, *, wall_ratio: float = 1.5,
                 wall_min_s: float = 0.05, check_wall: bool = True,
                 counter_tol: float = 1e-9,
                 finite_tol: float = 1e-6,
                 comms_ratio: float = 1.5,
                 comms_min_bytes: float = 1024.0,
                 mem_ratio: float = 1.5,
                 mem_min_bytes: float = 1 << 20,
                 risk_floor: float = 0.05,
                 metering_floor_s: float = 0.005,
                 pad_frac_tol: float = 0.05,
                 depth_slack: int = 2) -> DiffResult:
    """Compare a fresh report against a known-good baseline (see module
    docs for the checks). Returns a :class:`DiffResult`; ``not result.ok``
    means gate-failing regressions were found."""
    findings: list = []

    # ---- meta header: refuse mismatched schemas, warn on cross-backend
    base_m, new_m = meta_row(base_rows), meta_row(new_rows)
    if base_m is not None and new_m is not None:
        b_ver, n_ver = base_m.get("schema_version"), new_m.get("schema_version")
        if b_ver != n_ver:
            return DiffResult(findings=[Finding(
                "schema", "schema_version",
                f"baseline schema {b_ver} vs new {n_ver} — refusing to "
                f"gate incomparable reports (regenerate the baseline)",
                regression=True)])
        for key in ("backend", "device_kind"):
            if base_m.get(key) != new_m.get(key):
                findings.append(Finding(
                    "schema", key,
                    f"baseline {base_m.get(key)!r} vs new "
                    f"{new_m.get(key)!r} — cross-backend diff; wall "
                    f"gating disabled (machine speed is not a code "
                    f"regression)"))
                check_wall = False
        for key in ("jax_version", "device_count", "mesh_shape"):
            if base_m.get(key) != new_m.get(key):
                findings.append(Finding(
                    "schema", key, f"baseline {base_m.get(key)!r} vs new "
                                   f"{new_m.get(key)!r}"))
        b_fp, n_fp = (base_m.get("code_fingerprint"),
                      new_m.get("code_fingerprint"))
        if b_fp != n_fp:
            findings.append(Finding(
                "schema", "code_fingerprint",
                f"baseline code {b_fp!r} vs new {n_fp!r} — the reports "
                f"come from DIFFERENT installed source trees; this is a "
                f"cross-version comparison, read drift findings as "
                f"code-change effects, not environment noise"))
    elif (base_m is None) != (new_m is None):
        findings.append(Finding(
            "schema", "meta",
            "only one report carries a kind=\"meta\" header (pre-PR-5 "
            "baseline?) — environment compatibility not checkable"))

    # ---- spans
    base_spans, new_spans = span_totals(base_rows), span_totals(new_rows)
    for name, base_s in sorted(base_spans.items()):
        if name not in new_spans:
            findings.append(Finding("schema", name,
                                    "span present in baseline, missing in "
                                    "new report", regression=True))
            continue
        if not check_wall or base_s < wall_min_s:
            continue
        ratio = new_spans[name] / base_s if base_s > 0 else float("inf")
        if ratio > wall_ratio:
            findings.append(Finding(
                "span", name,
                f"wall {base_s:.4f}s -> {new_spans[name]:.4f}s "
                f"({ratio:.2f}x > {wall_ratio:g}x tolerance)",
                regression=True))

    # ---- counters
    base_c, new_c = counter_scalars(base_rows), counter_scalars(new_rows)
    for (name, key), base_v in sorted(base_c.items()):
        if (name, key) not in new_c:
            findings.append(Finding("schema", f"{name}/{key}",
                                    "counter present in baseline, missing "
                                    "in new report", regression=True))
            continue
        delta = new_c[(name, key)] - base_v
        if abs(delta) <= counter_tol:
            continue
        worse = any(key == g or key.endswith(g) for g in GATE_UP) and delta > 0
        findings.append(Finding(
            "counter", f"{name}/{key}",
            f"{base_v:g} -> {new_c[(name, key)]:g} (delta {delta:+g})",
            regression=worse))

    # ---- numerics frames (+ watchdog attribution)
    base_n, new_n = numerics_frames(base_rows), numerics_frames(new_rows)
    first_bad = None
    first_bad_label = None
    # ONE pass over the NEW report's rows in insertion order: rows are
    # appended chronologically (per-step in seq order by add_probes), so
    # insertion order IS the trace order of the run where the NaN actually
    # happened — a (step, seq) sort would let an alphabetically-early
    # downstream step steal the first-bad attribution, and a separate
    # new-only second loop would let a renamed upstream probe lose it to
    # a downstream baseline stage.
    for (step, stage), new_row in new_n.items():
        label = f"{step}/{stage}" if step else stage
        new_f = float(new_row.get("finite_frac", 1.0))
        base_row = base_n.get((step, stage))
        if base_row is not None:
            base_f = float(base_row.get("finite_frac", 1.0))
            if new_f < base_f - finite_tol:
                findings.append(Finding(
                    "numerics", label,
                    f"finite fraction dropped {base_f:.6g} -> {new_f:.6g}",
                    regression=True))
                if first_bad is None:
                    first_bad, first_bad_label = stage, label
            else:
                d_nan = (int(new_row.get("nan_count", 0))
                         - int(base_row.get("nan_count", 0)))
                if d_nan > 0:
                    findings.append(Finding(
                        "numerics", label,
                        f"nan_count +{d_nan} with finite fraction intact"))
            continue
        # a stage the baseline has never seen — a probe added/renamed
        # since it was taken, the likeliest NaN source — is judged by its
        # own declared expect_finite instead of passing silently
        expect = new_row.get("expect_finite")
        if expect is not None and new_f < float(expect) - finite_tol:
            findings.append(Finding(
                "numerics", label,
                f"stage absent from baseline and finite fraction "
                f"{new_f:.6g} below its declared expectation {expect:g}",
                regression=True))
            if first_bad is None:
                first_bad, first_bad_label = stage, label
        else:
            findings.append(Finding(
                "numerics", label, "stage absent from baseline (new or "
                "renamed probe) — re-baseline to gate it"))
    for (step, stage) in base_n:
        if (step, stage) not in new_n:
            label = f"{step}/{stage}" if step else stage
            findings.append(Finding("schema", label,
                                    "numerics frame present in baseline, "
                                    "missing in new report",
                                    regression=True))
    if first_bad is not None:
        findings.append(Finding(
            "watchdog", first_bad_label,
            "first stage (trace order) whose finite fraction dropped vs "
            "baseline — the NaN was born here or in the un-probed gap "
            "right before", regression=True))

    # ---- compile rows: retraces are gated, totals drift informationally
    base_k, new_k = compile_rows(base_rows), compile_rows(new_rows)
    for name, new_row in sorted(new_k.items()):
        base_retr = int(base_k.get(name, {}).get("retraces", 0) or 0)
        new_retr = int(new_row.get("retraces", 0) or 0)
        if new_retr > base_retr:
            findings.append(Finding(
                "counter", f"{name}/retraces",
                f"{base_retr} -> {new_retr} silent retraces",
                regression=True))

    # ---- comms ledger: collective counts gate UP, bytes gate on ratio
    base_cm, new_cm = comms_rows(base_rows), comms_rows(new_rows)
    for (name, stage), base_row in sorted(base_cm.items()):
        label = f"{name}/{stage}"
        new_row = new_cm.get((name, stage))
        if new_row is None:
            findings.append(Finding(
                "comms", label, "comms ledger row present in baseline, "
                "missing in new report", regression=True))
            continue
        base_c = base_row.get("collectives") or {}
        new_c = new_row.get("collectives") or {}
        for kind in sorted(set(base_c) | set(new_c)):
            b = int((base_c.get(kind) or {}).get("count", 0))
            n = int((new_c.get(kind) or {}).get("count", 0))
            if n > b:
                findings.append(Finding(
                    "comms", f"{label}/{kind}",
                    f"collective count {b} -> {n} — the partitioner now "
                    f"emits {'new' if b == 0 else 'more'} {kind} ops "
                    f"here", regression=True))
            elif n < b:
                findings.append(Finding(
                    "comms", f"{label}/{kind}",
                    f"collective count {b} -> {n} (improvement or "
                    f"restructure — re-baseline to gate it)"))
        b_bytes = float(base_row.get("bytes_moved", 0.0))
        n_bytes = float(new_row.get("bytes_moved", 0.0))
        growth = n_bytes - b_bytes
        if growth > comms_min_bytes and (
                b_bytes <= 0 or n_bytes / b_bytes > comms_ratio):
            findings.append(Finding(
                "comms", label,
                f"estimated comms bytes {b_bytes:.4g} -> {n_bytes:.4g} "
                f"(+{growth:.4g}, > {comms_ratio:g}x tolerance)",
                regression=True))
        elif growth < -comms_min_bytes:
            findings.append(Finding(
                "comms", label,
                f"estimated comms bytes {b_bytes:.4g} -> {n_bytes:.4g} "
                f"(improvement or restructure — re-baseline to gate it)"))
        # per-axis worsening (keyed on the ledger's stage names
        # through `label`): an ASSET-axis byte blowup in one stage must
        # not hide behind another axis's shrinkage in the stage total.
        # A baseline WITHOUT a by_axis split (an older artifact)
        # cannot gate — every axis would read 0 -> N on a byte-identical
        # program — so that case is a re-baseline note, not a regression.
        base_ax = base_row.get("by_axis") or {}
        new_ax = new_row.get("by_axis") or {}
        if not base_ax and new_ax:
            findings.append(Finding(
                "comms", label,
                "per-axis byte split absent from baseline (pre-round-18 "
                "report) — re-baseline to arm the per-axis gate"))
            continue
        for axis in sorted(set(base_ax) | set(new_ax)):
            b_ax = float(base_ax.get(axis, 0.0))
            n_ax = float(new_ax.get(axis, 0.0))
            ax_growth = n_ax - b_ax
            if ax_growth > comms_min_bytes and (
                    b_ax <= 0 or n_ax / b_ax > comms_ratio):
                findings.append(Finding(
                    "comms", f"{label}/axis:{axis}",
                    f"bytes over mesh axis {axis!r} {b_ax:.4g} -> "
                    f"{n_ax:.4g} (+{ax_growth:.4g}, > {comms_ratio:g}x "
                    f"tolerance) — this stage's layout started moving "
                    f"data over an axis it barely touched",
                    regression=True))
    for (name, stage) in sorted(set(new_cm) - set(base_cm)):
        findings.append(Finding(
            "comms", f"{name}/{stage}",
            "ledger row absent from baseline (new entry point/stage) — "
            "re-baseline to gate it"))

    # ---- memory: peak-residency growth gates on ratio + absolute floor
    base_mm, new_mm = memory_rows(base_rows), memory_rows(new_rows)
    for name, base_row in sorted(base_mm.items()):
        new_row = new_mm.get(name)
        if new_row is None:
            findings.append(Finding(
                "memory", name, "memory row present in baseline, missing "
                "in new report", regression=True))
            continue
        b_peak, n_peak = base_row.get("peak_bytes"), new_row.get("peak_bytes")
        if isinstance(b_peak, (int, float)) \
                and not isinstance(n_peak, (int, float)):
            # the gate must not silently disarm: a backend change that
            # drops memory_analysis turns every later real peak blowup
            # invisible unless the loss itself is flagged
            findings.append(Finding(
                "memory", name,
                f"baseline carries peak_bytes but the new report does not "
                f"(source {base_row.get('source')!r} -> "
                f"{new_row.get('source')!r}) — peak-memory gating "
                f"disarmed; re-baseline deliberately if intended",
                regression=True))
            continue
        if not isinstance(b_peak, (int, float)) \
                or not isinstance(n_peak, (int, float)):
            continue  # neither side gateable (cost_analysis fallback)
        growth = float(n_peak) - float(b_peak)
        if growth > mem_min_bytes and (
                b_peak <= 0 or n_peak / b_peak > mem_ratio):
            findings.append(Finding(
                "memory", name,
                f"peak device bytes {b_peak:.4g} -> {n_peak:.4g} "
                f"(+{growth:.4g}, > {mem_ratio:g}x tolerance)",
                regression=True))
        elif abs(growth) > 0:
            findings.append(Finding(
                "memory", name,
                f"peak device bytes {b_peak:.4g} -> {n_peak:.4g} "
                f"(within tolerance)"))

    # ---- sharding lint: losing cleanliness against a clean baseline
    base_sh, new_sh = sharding_rows(base_rows), sharding_rows(new_rows)
    for name, new_row in sorted(new_sh.items()):
        base_row = base_sh.get(name, {})
        base_flags = len(base_row.get("flags") or [])
        new_flags = len(new_row.get("flags") or [])
        if new_flags > base_flags:
            detail = "; ".join((new_row.get("flags") or [])[:3])
            findings.append(Finding(
                "sharding", name,
                f"lint flags {base_flags} -> {new_flags}: {detail}",
                regression=True))
        elif new_flags and base_flags:
            findings.append(Finding(
                "sharding", name,
                f"{new_flags} pre-existing lint flag(s) (baseline had "
                f"them too)"))
    for name in sorted(set(base_sh) - set(new_sh)):
        findings.append(Finding(
            "sharding", name, "sharding-lint row present in baseline, "
            "missing in new report", regression=True))

    # ---- latency sketches: presence + p50/p99 ratio (wall conventions),
    # and SLO verdicts (the run's own declared budgets — gated even when
    # wall gating is off, since a budget is not a machine comparison)
    base_lat, new_lat = latency_rows(base_rows), latency_rows(new_rows)
    for name, base_row in sorted(base_lat.items()):
        new_row = new_lat.get(name)
        if new_row is None:
            findings.append(Finding(
                "latency", name, "latency row present in baseline, "
                "missing in new report", regression=True))
            continue
        # the online-advance scopes stay armed under --no-wall: the
        # advance p99 is the product's own SLO surface (module docs'
        # online section), so its worsening must not hide behind a
        # cross-machine diff
        online_scope = (name.startswith("online/")
                        or name == "bench/online_advance")
        if not check_wall and not online_scope:
            continue
        # the span floor exists because a SINGLE-SHOT tiny wall is mostly
        # scheduler noise — but a quantile backed by many observations is
        # stable well below it (the per-date advance baseline is a
        # 503-sample millisecond sketch, exactly the distribution this
        # gate exists for), so well-populated sketches gate down to 1 ms
        floor = (wall_min_s if int(base_row.get("count", 0)) < 100
                 else min(wall_min_s, 1e-3))
        for key, label in (("p50_s", "p50"), ("p99_s", "p99")):
            b, n = base_row.get(key), new_row.get(key)
            if not isinstance(b, (int, float)) \
                    or not isinstance(n, (int, float)) or b < floor:
                continue
            ratio = n / b if b > 0 else float("inf")
            if ratio > wall_ratio:
                armed = (" — online advance scope, armed under --no-wall"
                         if not check_wall else "")
                findings.append(Finding(
                    "latency", f"{name}/{label}",
                    f"{label} {b:.6g}s -> {n:.6g}s ({ratio:.2f}x > "
                    f"{wall_ratio:g}x tolerance){armed}", regression=True))
    for name in sorted(set(new_lat) - set(base_lat)):
        findings.append(Finding(
            "latency", name, "latency scope absent from baseline (new "
            "or renamed) — re-baseline to gate it"))
    for name, new_row in sorted(new_lat.items()):
        if not new_row.get("slo_violated"):
            continue
        pre = ("; the baseline violated it too — the SLO gate is "
               "absolute, fix or re-budget"
               if (base_lat.get(name) or {}).get("slo_violated") else "")
        findings.append(Finding(
            "latency", f"{name}/slo",
            f"SLO violated: {new_row.get('slo_quantile')}-quantile "
            f"{new_row.get('slo_observed_s')}s > budget "
            f"{new_row.get('slo_budget_s')}s "
            f"(scope {new_row.get('slo_scope')!r}){pre}",
            regression=True))

    # ---- devtime: the total/skip row is schema, per-stage drift is news
    base_dt, new_dt = devtime_rows(base_rows), devtime_rows(new_rows)
    for (name, stg), base_row in sorted(base_dt.items()):
        if (name, stg) in new_dt:
            continue
        findings.append(Finding(
            "devtime", f"{name}/{stg}",
            "device-time row present in baseline, missing in new report",
            regression=(stg == "total")))

    # ---- serving rows: under the same recorded traffic, more shed /
    # missed / failed requests or more dispatch retries is a regression
    # in the bad direction (the serving layer got slower or flakier);
    # drops and other field drift are informational, new rows note
    base_sv, new_sv = serving_rows(base_rows), serving_rows(new_rows)
    for name, base_row in sorted(base_sv.items()):
        new_row = new_sv.get(name)
        if new_row is None:
            findings.append(Finding(
                "serving", name, "serving row present in baseline, "
                "missing in new report", regression=True))
            continue
        for key in ("shed_count", "deadline_miss_count", "retry_count",
                    "failed_count"):
            b, nv = base_row.get(key), new_row.get(key)
            if not isinstance(b, (int, float)) \
                    or not isinstance(nv, (int, float)) or nv == b:
                continue
            findings.append(Finding(
                "serving", f"{name}/{key}",
                f"{b:g} -> {nv:g} (delta {nv - b:+g})",
                regression=nv > b))
    for name in sorted(set(new_sv) - set(base_sv)):
        findings.append(Finding(
            "serving", name, "serving row absent from baseline (new "
            "traffic leg) — re-baseline to gate it"))

    # ---- scenario risk rows: VaR/ES worsening gates at ratio+spread,
    # non-finite risk and nonfinite-path growth gate outright. Scenario
    # sweeps are seeded-deterministic, so — unlike walls — this gate
    # stays armed under --no-wall and cross-backend: a risk worsening is
    # never machine speed.
    def _num(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    def _fin(v):
        return _num(v) and v == v and abs(v) != float("inf")

    base_sc, new_sc = scenario_rows(base_rows), scenario_rows(new_rows)
    for name, base_row in sorted(base_sc.items()):
        new_row = new_sc.get(name)
        if new_row is None:
            findings.append(Finding(
                "scenario", name, "scenario risk row present in baseline, "
                "missing in new report", regression=True))
            continue
        b_nf, n_nf = (base_row.get("nonfinite_paths", 0),
                      new_row.get("nonfinite_paths", 0))
        if _num(b_nf) and _num(n_nf) and n_nf > b_nf:
            findings.append(Finding(
                "scenario", f"{name}/nonfinite_paths",
                f"{b_nf:g} -> {n_nf:g} paths produced a non-finite risk "
                f"scalar — a broken scenario, not a tail event",
                regression=True))
        levels = base_row.get("levels")
        if levels != new_row.get("levels"):
            findings.append(Finding(
                "scenario", name,
                f"VaR/ES levels changed {levels} -> "
                f"{new_row.get('levels')} — re-baseline to gate them"))
            continue
        spread = base_row.get("spread") or {}
        for key in ("var", "es"):
            bs, ns = base_row.get(key) or [], new_row.get(key) or []
            smax = spread.get(key) or []
            for i, level in enumerate(levels or []):
                b = bs[i] if i < len(bs) else None
                nv = ns[i] if i < len(ns) else None
                label = f"{name}/{key}@{level:g}"
                if not _fin(nv):
                    findings.append(Finding(
                        "scenario", label,
                        f"non-finite {key.upper()} {nv!r} in the new "
                        f"report", regression=True))
                    continue
                if not _fin(b):
                    continue  # baseline itself ungateable
                s = smax[i] if i < len(smax) and _fin(smax[i]) else b
                eff = max(b, s)
                # ratio for well-sized risks, absolute floor for tiny or
                # negative ones (a ratio on a near-zero or negative VaR
                # gates noise / inverts direction)
                threshold = max(eff * wall_ratio, eff + risk_floor)
                if nv > threshold:
                    findings.append(Finding(
                        "scenario", label,
                        f"{key.upper()} worsened {b:.6g} -> {nv:.6g} "
                        f"(beyond {wall_ratio:g}x / +{risk_floor:g} of "
                        f"the baseline incl. recorded spread)",
                        regression=True))
                elif nv > max(b * wall_ratio, b + risk_floor):
                    findings.append(Finding(
                        "scenario", label,
                        f"{key.upper()} worsened {b:.6g} -> {nv:.6g} — "
                        f"within the baseline's recorded spread, judged "
                        f"run-to-run swing"))
    for name in sorted(set(new_sc) - set(base_sc)):
        findings.append(Finding(
            "scenario", name, "scenario risk row absent from baseline "
            "(new sweep) — re-baseline to gate it"))

    # ---- online-engine rows: verdict-count growth gates UP, completeness
    # gates outright. Verdict counts are never machine speed, so — like
    # the scenario gate — this section stays armed under --no-wall.
    base_on, new_on = online_rows(base_rows), online_rows(new_rows)
    for name, base_row in sorted(base_on.items()):
        new_row = new_on.get(name)
        if new_row is None:
            findings.append(Finding(
                "online", name, "online-engine row present in baseline, "
                "missing in new report", regression=True))
            continue
        for key in ONLINE_GATE_UP:
            b, nv = base_row.get(key), new_row.get(key)
            if not isinstance(b, (int, float)) \
                    or not isinstance(nv, (int, float)) or nv == b:
                continue
            findings.append(Finding(
                "online", f"{name}/{key}",
                f"{b:g} -> {nv:g} (delta {nv - b:+g})",
                regression=nv > b))
    for name, new_row in sorted(new_on.items()):
        if not online_verdicts_complete(new_row):
            findings.append(Finding(
                "online", f"{name}/completeness",
                f"verdict counts do not sum to ingestions "
                f"(applied {new_row.get('applied_dates')} + replayed "
                f"{new_row.get('replayed_dates')} + rejected "
                f"{new_row.get('rejected_dates')} != ingested "
                f"{new_row.get('ingested_dates')}) — a date terminated "
                f"in zero or two verdicts", regression=True))
        if name not in base_on:
            findings.append(Finding(
                "online", name, "online-engine row absent from baseline "
                "(new stream) — re-baseline to gate it"))

    # ---- metering rows (flight recorder): per-tenant cost
    # drift gates at ratio + absolute floor, pad-fraction growth gates
    # at pad_frac_tol. The queue's metered wall is the VIRTUAL charge —
    # deterministic for a recorded trace — so this section stays armed
    # under --no-wall: a drift is a scheduling/billing change, never
    # machine speed.
    base_mt, new_mt = metering_rows(base_rows), metering_rows(new_rows)
    for name, base_row in sorted(base_mt.items()):
        new_row = new_mt.get(name)
        if new_row is None:
            findings.append(Finding(
                "metering", name, "metering row present in baseline, "
                "missing in new report", regression=True))
            continue
        base_acc = base_row.get("accounts") or {}
        new_acc = new_row.get("accounts") or {}
        for label in sorted(base_acc):
            if label not in new_acc:
                findings.append(Finding(
                    "metering", f"{name}/{label}",
                    "account present in baseline, missing in new report "
                    "— a tenant's bill vanished", regression=True))
                continue
            for key, b in sorted(base_acc[label].items()):
                nv = new_acc[label].get(key)
                if not isinstance(b, (int, float)) \
                        or not isinstance(nv, (int, float)):
                    continue
                floor = (metering_floor_s if key == "wall_s"
                         else METERING_FLOORS.get(key, 0.0))
                growth = nv - b
                if growth > floor and (b <= 0 or nv / b > wall_ratio):
                    findings.append(Finding(
                        "metering", f"{name}/{label}/{key}",
                        f"metered cost {b:.6g} -> {nv:.6g} "
                        f"(+{growth:.6g}, > {wall_ratio:g}x with the "
                        f"{floor:g} absolute floor) — armed under "
                        f"--no-wall: the charge is virtual, not machine "
                        f"speed", regression=True))
                elif growth < -floor:
                    findings.append(Finding(
                        "metering", f"{name}/{label}/{key}",
                        f"metered cost {b:.6g} -> {nv:.6g} (improvement "
                        f"or restructure — re-baseline to gate it)"))
        for label in sorted(set(new_acc) - set(base_acc)):
            findings.append(Finding(
                "metering", f"{name}/{label}",
                "account absent from baseline (new tenant/overhead) — "
                "re-baseline to gate it"))
        b_pf, n_pf = base_row.get("pad_fraction"), new_row.get("pad_fraction")
        if isinstance(b_pf, (int, float)) and isinstance(n_pf, (int, float)):
            if n_pf > b_pf + pad_frac_tol:
                findings.append(Finding(
                    "metering", f"{name}/pad_fraction",
                    f"pad-overhead fraction grew {b_pf:.4f} -> {n_pf:.4f} "
                    f"(beyond +{pad_frac_tol:g}) — the pad ladder "
                    f"stopped fitting the traffic", regression=True))
            elif n_pf != b_pf:
                findings.append(Finding(
                    "metering", f"{name}/pad_fraction",
                    f"pad-overhead fraction {b_pf:.4f} -> {n_pf:.4f} "
                    f"(within tolerance)"))
    for name in sorted(set(new_mt) - set(base_mt)):
        findings.append(Finding(
            "metering", name, "metering row absent from baseline (new "
            "recorder scope) — re-baseline to gate it"))

    # ---- health-series rows: max queue depth gates on growth (the
    # virtual-clock depth profile is deterministic for a recorded trace
    # — armed under --no-wall like the metering section)
    base_se, new_se = series_rows(base_rows), series_rows(new_rows)
    for name, base_row in sorted(base_se.items()):
        new_row = new_se.get(name)
        if new_row is None:
            findings.append(Finding(
                "series", name, "health-series row present in baseline, "
                "missing in new report", regression=True))
            continue
        b_d, n_d = base_row.get("max_depth"), new_row.get("max_depth")
        if isinstance(b_d, (int, float)) and isinstance(n_d, (int, float)):
            if n_d > max(b_d * wall_ratio, b_d + depth_slack):
                findings.append(Finding(
                    "series", f"{name}/max_depth",
                    f"max queue depth {b_d:g} -> {n_d:g} (beyond "
                    f"{wall_ratio:g}x + {depth_slack:g} slack) — the "
                    f"backlog profile worsened under the same recorded "
                    f"traffic", regression=True))
            elif n_d != b_d:
                findings.append(Finding(
                    "series", f"{name}/max_depth",
                    f"max queue depth {b_d:g} -> {n_d:g} (within "
                    f"tolerance)"))
    for name in sorted(set(new_se) - set(base_se)):
        findings.append(Finding(
            "series", name, "health-series row absent from baseline "
            "(new recorder scope) — re-baseline to gate it"))

    # ---- lineage/traffic rows (provenance ledger): PRESENCE
    # per name is the schema contract — a producing layer that stopped
    # emitting its ledger (or a drain that stopped recording arrivals)
    # silently un-audits the run. Edge CONTENTS are content-addressed
    # and legitimately change with the inputs, so counts/ids never gate;
    # referential integrity is ``tools/lineage.py --strict``'s job.
    base_ln, new_ln = lineage_rows(base_rows), lineage_rows(new_rows)
    for name in sorted(set(base_ln) - set(new_ln)):
        findings.append(Finding(
            "lineage", name, "provenance ledger present in baseline, "
            "missing in new report — the run lost its audit trail",
            regression=True))
    for name in sorted(set(new_ln) - set(base_ln)):
        findings.append(Finding(
            "lineage", name, "provenance ledger absent from baseline "
            "(new lineage scope) — re-baseline to gate it"))
    base_tr, new_tr = traffic_rows(base_rows), traffic_rows(new_rows)
    for name in sorted(set(base_tr) - set(new_tr)):
        findings.append(Finding(
            "traffic", name, "arrival-trace rows present in baseline, "
            "missing in new report — the drain stopped recording "
            "traffic", regression=True))
    for name in sorted(set(new_tr) - set(base_tr)):
        findings.append(Finding(
            "traffic", name, "arrival-trace rows absent from baseline "
            "(new capture scope) — re-baseline to gate it"))

    # ---- sentry alert/incident rows: the alert log is
    # deterministic for a recorded trace on the virtual clock, so it
    # gates in BOTH directions and stays armed under --no-wall. A NEW
    # firing detector (or a firing-count increase) is the operational
    # regression the sentry exists to catch; a VANISHED summary scope,
    # fired key or incident is a schema break — the sentry was disarmed
    # or the capture path stopped emitting, which silently un-audits the
    # run (re-baseline to accept an intentional fix).
    base_al, new_al = alert_rows(base_rows), alert_rows(new_rows)
    base_fa, new_fa = fired_alerts(base_rows), fired_alerts(new_rows)
    for name in sorted(set(base_al) - set(new_al)):
        findings.append(Finding(
            "alert", name, "sentry summary present in baseline, missing "
            "in new report — the run lost its operations sentry",
            regression=True))
    for name in sorted(set(new_al) - set(base_al)):
        findings.append(Finding(
            "alert", name, "sentry summary absent from baseline (new "
            "sentry scope) — re-baseline to gate it"))
    for name in sorted(set(base_al) & set(new_al)):
        b_f, n_f = base_fa.get(name, {}), new_fa.get(name, {})
        for key in sorted(set(n_f) - set(b_f)):
            findings.append(Finding(
                "alert", f"{name}/{key}",
                f"alert began firing ({n_f[key]} time(s)) under the same "
                f"recorded traffic — not in baseline", regression=True))
        for key in sorted(set(b_f) - set(n_f)):
            findings.append(Finding(
                "alert", f"{name}/{key}",
                f"alert fired {b_f[key]} time(s) in baseline, none in "
                f"new report — detector disarmed or log truncated "
                f"(re-baseline to accept a fix)", regression=True))
        for key in sorted(set(b_f) & set(n_f)):
            if n_f[key] > b_f[key]:
                findings.append(Finding(
                    "alert", f"{name}/{key}",
                    f"alert firings grew {b_f[key]} -> {n_f[key]} under "
                    f"the same recorded traffic", regression=True))
            elif n_f[key] != b_f[key]:
                findings.append(Finding(
                    "alert", f"{name}/{key}",
                    f"alert firings {b_f[key]} -> {n_f[key]} "
                    f"(improvement — re-baseline to gate it)"))
    base_in, new_in = incident_rows(base_rows), incident_rows(new_rows)
    for name in sorted(set(base_al) | set(new_al)):
        b_i, n_i = base_in.get(name, 0), new_in.get(name, 0)
        if n_i > b_i:
            findings.append(Finding(
                "alert", f"{name}/incidents",
                f"incident bundles grew {b_i} -> {n_i} under the same "
                f"recorded traffic", regression=True))
        elif n_i < b_i and name in new_al:
            findings.append(Finding(
                "alert", f"{name}/incidents",
                f"incident bundles {b_i} -> {n_i} — capture path stopped "
                f"emitting (re-baseline to accept a fix)",
                regression=True))

    # ---- bench rows: seconds-valued rows gate at wall_ratio against the
    # spread-aware baseline; presence never gates (configs are selected
    # per invocation)
    if check_wall:
        base_b, new_b = bench_rows(base_rows), bench_rows(new_rows)
        for name in sorted(set(base_b) & set(new_b)):
            base_row, new_row = base_b[name], new_b[name]
            unit = base_row.get("unit", "s")
            if unit != new_row.get("unit", "s"):
                continue
            b, n = base_row.get("value"), new_row.get("value")
            if not isinstance(b, (int, float)) \
                    or not isinstance(n, (int, float)):
                continue
            spread = base_row.get("spread") or {}
            if unit == "s":
                if b < wall_min_s:
                    continue
                smax = spread.get("max_s")
                eff = max(b, smax) if isinstance(smax, (int, float)) else b
                if n > wall_ratio * eff:
                    findings.append(Finding(
                        "bench", name,
                        f"value {b:.6g}s -> {n:.6g}s ({n / b:.2f}x; exceeds "
                        f"{wall_ratio:g}x even against the baseline spread "
                        f"max {eff:.6g}s)", regression=True))
                elif n > wall_ratio * b:
                    findings.append(Finding(
                        "bench", name,
                        f"value {b:.6g}s -> {n:.6g}s ({n / b:.2f}x) — within "
                        f"the baseline's recorded best-of-N spread (max "
                        f"{eff:.6g}s), so judged run-to-run swing, not a "
                        f"regression"))
            elif unit.endswith("/s"):
                # throughput rows (bigger is better): a drop below
                # baseline / wall_ratio gates, spread-min absorbing first
                if b <= 0:
                    continue
                smin = spread.get("min_s")
                eff = min(b, smin) if isinstance(smin, (int, float)) else b
                if n * wall_ratio < eff:
                    findings.append(Finding(
                        "bench", name,
                        f"throughput {b:.6g} -> {n:.6g} {unit} "
                        f"({b / max(n, 1e-300):.2f}x drop; below 1/"
                        f"{wall_ratio:g} even against the baseline spread "
                        f"min {eff:.6g})", regression=True))
                elif n * wall_ratio < b:
                    findings.append(Finding(
                        "bench", name,
                        f"throughput {b:.6g} -> {n:.6g} {unit} — within "
                        f"the baseline's recorded best-of-N spread (min "
                        f"{eff:.6g}), so judged run-to-run swing, not a "
                        f"regression"))

    return DiffResult(findings=findings, first_bad_stage=first_bad)
