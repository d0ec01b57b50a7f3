"""Latency SLO telemetry: streaming quantile sketches and declarative SLOs
(the port's own copy of ``factormodeling_tpu/obs/latency.py``, stdlib only).

A fixed log-bucket histogram: bucket ``i`` covers
``[t0 * 2^(i/k), t0 * 2^((i+1)/k))`` seconds with ``t0 = 1 us`` and ``k = 8``
buckets per octave, so every quantile estimate is within one bucket width
(``2^(1/8)``, ~9% relative) of the exact sample quantile. Exact
count/sum/min/max ride alongside, and estimates are clamped into
``[min, max]``. The sketch is deterministic (the same observations in any
order give the same state), mergeable (per-process sketches add up exactly)
and round-trips through a plain dict.

- :class:`QuantileSketch` — the sketch.
- :class:`LatencyRecorder` — a per-scope sketch map that
  ``RunReport(latency=True)`` feeds from every fenced span exit; repeated
  same-name spans roll up into the scope's sketch.
- :class:`SLOSpec` — a declarative objective (scope pattern, quantile,
  budget); matching ``kind="latency"`` rows carry its verdict.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math

__all__ = ["LatencyRecorder", "QuantileSketch", "SLOSpec",
           "BUCKET_BASE_S", "BUCKETS_PER_OCTAVE", "N_BUCKETS"]

#: lower edge of bucket 0 — 1 µs; anything faster clamps into bucket 0
#: (a sub-microsecond "latency" is dispatch noise, not a serving number)
BUCKET_BASE_S = 1e-6
#: buckets per factor-of-2 — 2^(1/8) ≈ 9 % relative bucket width, the
#: quantile accuracy bound tested against np.percentile
BUCKETS_PER_OCTAVE = 8
#: 40 octaves above 1 µs ≈ 1.1e6 s — anything slower clamps into the
#: last bucket (min/max stay exact either way)
N_BUCKETS = 40 * BUCKETS_PER_OCTAVE


def _bucket_of(seconds: float) -> int:
    if seconds <= BUCKET_BASE_S:
        return 0
    i = int(math.floor(math.log2(seconds / BUCKET_BASE_S)
                       * BUCKETS_PER_OCTAVE))
    return min(max(i, 0), N_BUCKETS - 1)


def _bucket_upper_edge(i: int) -> float:
    return BUCKET_BASE_S * 2.0 ** ((i + 1) / BUCKETS_PER_OCTAVE)


class QuantileSketch:
    """Deterministic, mergeable streaming quantile summary of seconds.

    Fixed log-bucket histogram (module docs): insertion order never
    changes the state, and :meth:`merge` is associative and commutative
    — ``a.merge(b)`` equals the sketch of the concatenated observations,
    exactly. Quantile estimates are the covering bucket's upper edge
    clamped into the exact observed ``[min, max]``: within one bucket
    width of the true sample quantile, never beyond the observed range.
    """

    __slots__ = ("counts", "count", "total", "min", "max")

    def __init__(self):
        self.counts: dict[int, int] = {}   # sparse bucket -> count
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    def add(self, seconds: float) -> None:
        """Fold one observation. Non-finite/negative values are rejected
        loudly rather than clamped: a NaN latency means a broken timer,
        not a fast call, and folding it into bucket 0 would hide that."""
        seconds = float(seconds)
        if not math.isfinite(seconds) or seconds < 0.0:
            raise ValueError(f"latency observation must be a finite "
                             f"non-negative number of seconds, got "
                             f"{seconds!r}")
        i = _bucket_of(seconds)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.count += 1
        self.total += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (in place; returns self). Exact:
        bucket vectors add, count/total add, min/max combine."""
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile in seconds (nan on an empty sketch).

        The upper edge of the first bucket whose cumulative count reaches
        ``ceil(q * count)``, clamped into the exact observed range — so
        ``quantile(0) >= min`` and ``quantile(1) == max`` exactly."""
        if self.count == 0:
            return math.nan
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= target:
                return min(max(_bucket_upper_edge(i), self.min), self.max)
        return self.max  # unreachable; defensive

    def to_row(self) -> dict:
        """The sketch as JSON-ready row fields: exact count/total/min/max,
        the p50/p90/p99 estimates, and the trimmed bucket vector
        (``bucket_offset`` + dense ``bucket_counts``) under its fixed
        geometry — enough to reconstruct and re-merge the sketch from the
        artifact alone."""
        if self.count == 0:
            lo, counts = 0, []
        else:
            lo, hi = min(self.counts), max(self.counts)
            counts = [self.counts.get(i, 0) for i in range(lo, hi + 1)]
        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "min_s": round(self.min, 6) if self.count else None,
            "max_s": round(self.max, 6) if self.count else None,
            "p50_s": round(self.quantile(0.50), 6) if self.count else None,
            "p90_s": round(self.quantile(0.90), 6) if self.count else None,
            "p99_s": round(self.quantile(0.99), 6) if self.count else None,
            "bucket_base_s": BUCKET_BASE_S,
            "buckets_per_octave": BUCKETS_PER_OCTAVE,
            "bucket_offset": lo,
            "bucket_counts": counts,
        }

    @classmethod
    def from_row(cls, row: dict) -> "QuantileSketch":
        """Rebuild a sketch from :meth:`to_row` fields (rows from other
        processes/hosts merge into run totals). Refuses a row whose
        bucket geometry differs — merging across geometries would be
        silently wrong."""
        if (row.get("bucket_base_s") != BUCKET_BASE_S
                or row.get("buckets_per_octave") != BUCKETS_PER_OCTAVE):
            raise ValueError(
                f"sketch geometry mismatch: row has base "
                f"{row.get('bucket_base_s')!r} x "
                f"{row.get('buckets_per_octave')!r} buckets/octave, this "
                f"build uses {BUCKET_BASE_S} x {BUCKETS_PER_OCTAVE}")
        sk = cls()
        lo = int(row.get("bucket_offset", 0))
        for j, c in enumerate(row.get("bucket_counts") or []):
            if c:
                sk.counts[lo + j] = int(c)
        sk.count = int(row.get("count", 0))
        sk.total = float(row.get("total_s", 0.0))
        if sk.count:
            sk.min = float(row["min_s"])
            sk.max = float(row["max_s"])
        return sk


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative latency objective: scope(s), quantile, budget.

    ``scope`` is an ``fnmatch`` pattern against latency-row names
    (``"bench/daily_advance"``, ``"streaming/*"``); ``quantile`` the
    gated point (0.99 = p99); ``budget_s`` the ceiling in seconds.
    Matching rows carry ``slo_quantile`` / ``slo_budget_s`` /
    ``slo_observed_s`` / ``slo_violated``, so the SLO is judged from the
    artifact, not the live process."""

    scope: str
    quantile: float = 0.99
    budget_s: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.quantile <= 1.0:
            raise ValueError(f"SLO quantile must be in (0, 1], got "
                             f"{self.quantile}")
        if not (self.budget_s > 0.0 and math.isfinite(self.budget_s)):
            raise ValueError(f"SLO budget must be a positive finite "
                             f"number of seconds, got {self.budget_s}")

    def matches(self, name: str) -> bool:
        return fnmatch.fnmatchcase(name, self.scope)

    def judge(self, sketch: QuantileSketch) -> dict:
        """The row fields of this spec's verdict on one sketch (an empty
        sketch is vacuously un-violated — nothing was observed)."""
        observed = sketch.quantile(self.quantile) if sketch.count else None
        return {
            "slo_scope": self.scope,
            "slo_quantile": self.quantile,
            "slo_budget_s": self.budget_s,
            "slo_observed_s": (round(observed, 6)
                               if observed is not None else None),
            "slo_violated": bool(observed is not None
                                 and observed > self.budget_s),
        }


class LatencyRecorder:
    """Per-scope sketch map — the report layer's latency sink.

    ``observe(name, seconds)`` folds one fenced wall measurement into
    ``name``'s sketch; :meth:`rows` renders one ``kind="latency"`` row
    per scope (sorted by name for deterministic artifacts), each judged
    by the first matching :class:`SLOSpec` (declaration order wins, so
    list specific scopes before globs)."""

    def __init__(self):
        self.sketches: dict[str, QuantileSketch] = {}

    def observe(self, name: str, seconds: float) -> None:
        sk = self.sketches.get(name)
        if sk is None:
            sk = self.sketches[name] = QuantileSketch()
        sk.add(seconds)

    def sketch(self, name: str) -> "QuantileSketch | None":
        return self.sketches.get(name)

    def rows(self, slos=()) -> list:
        out = []
        for name in sorted(self.sketches):
            sk = self.sketches[name]
            row = {"kind": "latency", "name": name, **sk.to_row()}
            for spec in slos:
                if spec.matches(name):
                    row.update(spec.judge(sk))
                    break
            out.append(row)
        return out
