"""Distributional risk analytics over scenario paths: VaR/ES, drawdown and
turnover quantiles, folded through the mergeable quantile sketch (the
port's own copy of ``factormodeling_tpu/scenarios/risk.py``, stdlib only).

The scenario engine produces many counterfactual P&L curves; this module
turns the per-path scalars into report rows:

- :class:`SignedSketch` — a signed-value wrapper over two
  :class:`~factormodeling_tpu_torch.obs.latency.QuantileSketch` halves
  (negative magnitudes / non-negative values). The latency sketch is
  non-negative; P&L is signed, so the wrapper splits at zero and rebuilds
  signed quantiles from the pair. It stays deterministic (insertion order
  never changes the bucket state) and **exactly mergeable**: bucket
  vectors, counts and min/max combine bit for bit in any merge order (the
  float ``total`` is a sum, equal up to reassociation across merge trees;
  the engine folds path by path into one accumulator and snapshots it at
  full precision, so chunked and resumed sweeps give equal rows).
- **VaR / ES** at configurable levels: ``VaR_a`` is the a-quantile of the
  LOSS orientation of a metric (losses for P&L, the raw value for
  bad-up metrics like drawdown and turnover); ``ES_a`` the mean of the
  tail at or beyond it (each tail observation estimated at its bucket's
  upper edge clamped into the observed range, within one bucket width,
  ~9 % relative, of the sample statistic).
- :class:`RiskAccumulator` — the engine's per-metric sketch map;
  :meth:`RiskAccumulator.rows` renders one ``kind="scenario"`` report row
  per metric (VaR/ES vectors, distribution quantiles and the bucket
  vectors needed to re-merge).

Given the same observations, the rows, ``state()`` and ``from_state`` are
the JAX package's exactly.
"""

from __future__ import annotations

import math

from factormodeling_tpu_torch.obs.latency import QuantileSketch, _bucket_upper_edge

__all__ = ["DEFAULT_LEVELS", "RISK_METRICS", "RiskAccumulator",
           "SignedSketch"]

#: default VaR/ES confidence levels (row ``levels`` field)
DEFAULT_LEVELS = (0.95, 0.99)

#: metric name -> bad direction: "down" metrics worsen as they FALL (PnL —
#: VaR/ES are computed on losses), "up" metrics worsen as they RISE
#: (drawdown, turnover, worst-day loss). The engine emits exactly these.
RISK_METRICS = {
    "pnl_total": "down",
    "max_drawdown": "up",
    "mean_turnover": "up",
    "worst_day_loss": "up",
}


def _tail(sk: QuantileSketch, m: int, *, from_top: bool) -> tuple:
    """(estimated sum, count taken) of the TOP (``from_top``) or BOTTOM
    ``m`` observations of one non-negative sketch: buckets walked from
    the chosen end, each observation estimated at its bucket's upper
    edge clamped into [min, max]."""
    take = min(m, sk.count)
    left, total = take, 0.0
    for i in sorted(sk.counts, reverse=from_top):
        if left <= 0:
            break
        c = min(sk.counts[i], left)
        total += c * min(max(_bucket_upper_edge(i), sk.min), sk.max)
        left -= c
    return total, take


def _tail_high(sk: QuantileSketch, m: int) -> tuple:
    return _tail(sk, m, from_top=True)


def _tail_low(sk: QuantileSketch, m: int) -> tuple:
    return _tail(sk, m, from_top=False)


class SignedSketch:
    """Deterministic, exactly-mergeable streaming summary of SIGNED values
    (module docs): two latency sketches, one per sign, split at zero."""

    __slots__ = ("neg", "pos")

    def __init__(self):
        self.neg = QuantileSketch()   # magnitudes of values < 0
        self.pos = QuantileSketch()   # values >= 0

    @property
    def count(self) -> int:
        return self.neg.count + self.pos.count

    def add(self, value: float) -> None:
        """Fold one signed observation; non-finite values are rejected
        loudly (a NaN path metric means a broken scenario, not a risk
        number — the engine checks finiteness BEFORE folding and reports
        the offending path)."""
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(f"risk observation must be finite, got "
                             f"{value!r}")
        if value < 0.0:
            self.neg.add(-value)
        else:
            self.pos.add(value)

    def merge(self, other: "SignedSketch") -> "SignedSketch":
        """Exact merge (bucket vectors add); in place, returns self."""
        self.neg.merge(other.neg)
        self.pos.merge(other.pos)
        return self

    # ------------------------------------------------------------ queries

    def quantile(self, q: float) -> float:
        """Signed ``q``-quantile (nan on empty): rank-resolved across the
        two halves, each half within one bucket width of exact."""
        total = self.count
        if total == 0:
            return math.nan
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        rank = max(1, math.ceil(q * total))          # 1-based, ascending
        nc = self.neg.count
        if rank <= nc:
            # the rank-th smallest signed value lives in the negative
            # half: most negative == largest magnitude
            return -self.neg.quantile((nc - rank + 1) / nc)
        return self.pos.quantile((rank - nc) / self.pos.count)

    def tail_mean_high(self, m: int) -> float:
        """Estimated mean of the TOP ``m`` observations (nan when empty)."""
        m = min(m, self.count)
        if m <= 0:
            return math.nan
        s_pos, took = _tail_high(self.pos, m)
        s_neg, _ = _tail_low(self.neg, m - took)  # smallest magnitudes
        return (s_pos - s_neg) / m

    def tail_mean_low(self, m: int) -> float:
        """Estimated mean of the BOTTOM ``m`` observations (nan when
        empty) — the PnL loss tail ES reads."""
        m = min(m, self.count)
        if m <= 0:
            return math.nan
        s_neg, took = _tail_high(self.neg, m)     # largest magnitudes
        s_pos, _ = _tail_low(self.pos, m - took)
        return (s_pos - s_neg) / m

    def var_es(self, level: float, bad_direction: str) -> tuple:
        """``(VaR, ES)`` at one confidence level, ORIENTED so that bigger
        is always worse (module docs): for ``"down"`` metrics (PnL) both
        are loss magnitudes, for ``"up"`` metrics the raw upper tail."""
        if self.count == 0:
            return math.nan, math.nan
        tail = max(1, self.count - math.ceil(level * self.count))
        if bad_direction == "down":
            var = -self.quantile(1.0 - level)
            es = -self.tail_mean_low(tail)
        elif bad_direction == "up":
            var = self.quantile(level)
            es = self.tail_mean_high(tail)
        else:
            raise ValueError(f"bad_direction must be 'up' or 'down', got "
                             f"{bad_direction!r}")
        return var, es

    # --------------------------------------------------------- round-trip

    def to_fields(self) -> dict:
        """Both halves as row-embeddable dicts (the re-merge payload)."""
        return {"sketch_neg": self.neg.to_row(),
                "sketch_pos": self.pos.to_row()}

    @classmethod
    def from_fields(cls, fields: dict) -> "SignedSketch":
        sk = cls()
        sk.neg = QuantileSketch.from_row(fields["sketch_neg"])
        sk.pos = QuantileSketch.from_row(fields["sketch_pos"])
        return sk

    def state(self) -> dict:
        """FULL-precision snapshot payload (checkpoint/resume). The row
        fields (:meth:`to_fields`) round for artifact readability; resume
        must instead restore ``total``/``min``/``max`` exactly, or a
        resumed sweep's accumulated totals would drift off the straight-
        through run's by the rounding — breaking the engine's rows-bit-
        equal resume contract."""
        def half(sk: QuantileSketch) -> dict:
            return {"counts": {str(i): int(c)
                               for i, c in sorted(sk.counts.items())},
                    "count": int(sk.count), "total": float(sk.total),
                    "min": float(sk.min) if sk.count else None,
                    "max": float(sk.max) if sk.count else None}

        return {"neg": half(self.neg), "pos": half(self.pos)}

    @classmethod
    def from_state(cls, state: dict) -> "SignedSketch":
        out = cls()
        for name in ("neg", "pos"):
            sk = getattr(out, name)
            half = state[name]
            sk.counts = {int(i): int(c)
                         for i, c in half["counts"].items()}
            sk.count = int(half["count"])
            sk.total = float(half["total"])
            if sk.count:
                sk.min = float(half["min"])
                sk.max = float(half["max"])
        return out


class RiskAccumulator:
    """Per-metric :class:`SignedSketch` map — the scenario engine's sink.

    ``observe(metric, value)`` folds one path's scalar; :meth:`merge`
    folds another accumulator (per-chunk accumulators merge exactly, the
    checkpoint/resume invariance the engine pins); :meth:`rows` renders
    the ``kind="scenario"`` report rows.
    """

    def __init__(self, levels=DEFAULT_LEVELS):
        levels = tuple(float(v) for v in levels)
        for v in levels:
            if not 0.0 < v < 1.0:
                raise ValueError(f"VaR/ES levels must be in (0, 1), "
                                 f"got {v}")
        self.levels = levels
        self.sketches: dict[str, SignedSketch] = {}

    def observe(self, metric: str, value: float) -> None:
        sk = self.sketches.get(metric)
        if sk is None:
            sk = self.sketches[metric] = SignedSketch()
        sk.add(value)

    def merge(self, other: "RiskAccumulator") -> "RiskAccumulator":
        if other.levels != self.levels:
            raise ValueError(f"cannot merge accumulators with different "
                             f"levels {other.levels} vs {self.levels}")
        for metric, sk in other.sketches.items():
            mine = self.sketches.get(metric)
            if mine is None:
                # merge into a FRESH sketch, never alias the other's —
                # later folds must not mutate both accumulators
                mine = self.sketches[metric] = SignedSketch()
            mine.merge(sk)
        return self

    def rows(self, name_prefix: str, **extra) -> list:
        """One ``kind="scenario"`` row per metric, sorted for
        deterministic artifacts. ``extra`` fields (family, policy, ...)
        land on every row. Each row carries VaR/ES oriented bigger-is-
        worse at ``levels``, the signed distribution quantiles, and both
        bucket vectors (exact re-merge from the artifact alone)."""
        out = []
        for metric in sorted(self.sketches):
            sk = self.sketches[metric]
            direction = RISK_METRICS.get(metric, "up")
            var, es = [], []
            for level in self.levels:
                v, e = sk.var_es(level, direction)
                var.append(round(v, 6))
                es.append(round(e, 6))
            row = {
                "kind": "scenario",
                "name": f"{name_prefix}/{metric}",
                "metric": metric,
                "bad_direction": direction,
                "paths": sk.count,
                "levels": list(self.levels),
                "var": var,
                "es": es,
                "p50": round(sk.quantile(0.50), 6),
                "p90": round(sk.quantile(0.90), 6),
                "p99": round(sk.quantile(0.99), 6),
                "lo": round(sk.quantile(0.0), 6),
                "hi": round(sk.quantile(1.0), 6),
                **sk.to_fields(),
                **extra,
            }
            out.append(row)
        return out

    # --------------------------------------------------------- round-trip

    def state(self) -> dict:
        """FULL-precision JSON-scalar snapshot payload
        (``resil.checkpoint`` leaves; see :meth:`SignedSketch.state`)."""
        return {"levels": list(self.levels),
                "sketches": {m: sk.state()
                             for m, sk in sorted(self.sketches.items())}}

    @classmethod
    def from_state(cls, state: dict) -> "RiskAccumulator":
        acc = cls(levels=tuple(state["levels"]))
        for metric, fields in state["sketches"].items():
            acc.sketches[metric] = SignedSketch.from_state(fields)
        return acc
