"""Per-tenant cost metering: who paid for each batched dispatch.

The serving layer amortizes one executable dispatch over a pad-ladder
rung of lanes — some carrying real tenant configs, some padding the
chunk up to the rung. Every aggregate telemetry rail built so far
(latency sketches, stage counters, comms ledgers) reports the DISPATCH;
nothing says what one tenant's request cost, or who absorbed the pad
lanes' compute. This module is the billing half of the flight
recorder (:mod:`factormodeling_tpu_torch.obs.reqtrace`): split each dispatch's
measured cost across the chunk's lanes into mergeable per-tenant
accounts, with two honesty rules:

- **pad lanes are charged explicitly** — a padded lane burns real
  compute (the vmapped executable cannot skip it), and silently folding
  its cost into the real lanes would overstate every tenant's bill while
  understating the ladder's amortization overhead. Pad lanes charge the
  ``overhead/pad`` account; the published ``pad_fraction`` is the
  ladder-sizing signal ``tools/report_diff.py`` gates on growth.
- **conservation is checkable from the artifact** — every ``charge``
  records both the split and the dispatch total, so the emitted
  ``kind="metering"`` row carries ``accounts`` AND ``totals`` and
  ``tools/trace_report.py --strict`` fails any row whose account costs
  do not sum back to the measured dispatch totals (float tolerance).

What "measured cost" means per dimension (each optional — meter what the
caller has):

- ``wall_s`` — the dispatch's charged seconds. Under the serving queue
  this is the VIRTUAL service time the scheduler charged (deterministic
  — the reason the metering drift gate stays armed under ``--no-wall``);
  a hardware deployment threads the fenced wall from the latency
  rail through the same field. Retried/failed attempts charge the
  explicit ``overhead/retry`` / ``overhead/failed`` accounts — burnt
  compute that produced no answer is overhead, not a tenant's bill.
- ``qp_solves`` / ``iterations`` — per-lane solver work from
  ``StageCounters`` / ``SolverDiagnostics`` when the dispatch output
  carries them (``per_lane=`` overrides the uniform split with the
  per-lane vector).
- ``comms_bytes`` / ``mem_bytes`` — the placement-ledger estimates
  for the dispatch's entry point, when a ledger row is available.

Accounts are keyed on the STABLE tenant label (``Request.tenant``:
positional rids are meaningless across runs) and
merge associatively, so per-process meters combine into run totals the
same way the latency sketches do.

Pure stdlib by design (the report-tool contract shared with
``obs.latency`` / ``obs.regression``): ``math`` only, no numpy/jax.
"""

from __future__ import annotations

import math

__all__ = ["CostMeter", "OVERHEAD_FAILED", "OVERHEAD_PAD",
           "OVERHEAD_RETRY", "account_sum", "conservation_errors"]

#: the explicit overhead accounts — cost no tenant should be billed for,
#: kept visible so amortization claims stay honest
OVERHEAD_PAD = "overhead/pad"
OVERHEAD_RETRY = "overhead/retry"
OVERHEAD_FAILED = "overhead/failed"

#: the meterable cost dimensions (every account/total dict carries the
#: subset that was ever charged)
COST_KEYS = ("wall_s", "qp_solves", "iterations", "comms_bytes",
             "mem_bytes")

#: relative tolerance of the conservation check — the split is cost/rung
#: summed back rung times, so float reassociation only; the ABSOLUTE
#: tolerance is the ``conservation_errors(atol=...)`` parameter, whose
#: 1e-6 default accounts for the row's 1e-9 field rounding
CONSERVE_RTOL = 1e-9


def _add(acct: dict, key: str, value: float) -> None:
    if value:
        acct[key] = acct.get(key, 0.0) + float(value)


class CostMeter:
    """Mergeable per-tenant cost accounts (module docs).

    ``charge`` splits one dispatch's cost over its lanes; ``overhead``
    books burnt cost (retries, terminal failures) to an explicit
    overhead account. Accounts and totals are plain
    ``{key: {cost: float}}`` dicts, so the meter round-trips through a
    JSON snapshot (the queue checkpoint seam) and merges exactly.
    """

    def __init__(self):
        self.accounts: dict[str, dict] = {}
        self.totals: dict = {}
        self.dispatches = 0
        self.lanes = 0
        self.pad_lanes = 0

    # ------------------------------------------------------------ charging

    def charge(self, tenants, rung: int, *, per_lane=None,
               **costs) -> None:
        """Split one dispatch's cost across its ``rung`` lanes.

        ``tenants`` are the REAL lanes' stable labels (len <= rung); the
        remaining ``rung - len(tenants)`` lanes are padding and charge
        :data:`OVERHEAD_PAD`. Each cost in ``costs`` (see ``COST_KEYS``)
        splits uniformly — ``cost / rung`` per lane — unless
        ``per_lane[key]`` supplies a length-``rung`` vector of the
        actual per-lane values (the StageCounters path), in which case
        the total recorded for conservation is the vector's own sum.
        Non-finite costs are rejected loudly: a NaN bill means a broken
        meter, not a cheap dispatch."""
        tenants = [str(t) for t in tenants]
        rung = int(rung)
        if rung < 1 or len(tenants) > rung:
            raise ValueError(f"need 1 <= len(tenants) <= rung, got "
                             f"{len(tenants)} tenants at rung {rung}")
        per_lane = dict(per_lane or {})
        self.dispatches += 1
        self.lanes += len(tenants)
        pad = rung - len(tenants)
        self.pad_lanes += pad
        for key, total in costs.items():
            if key not in COST_KEYS:
                raise ValueError(f"unknown cost dimension {key!r}; valid: "
                                 f"{COST_KEYS}")
            if total is None:
                continue
            vec = per_lane.get(key)
            if vec is not None:
                vec = [float(v) for v in vec]
                if len(vec) != rung:
                    raise ValueError(f"per_lane[{key!r}] has {len(vec)} "
                                     f"entries for rung {rung}")
                total = sum(vec)
            else:
                total = float(total)
                vec = [total / rung] * rung
            if not math.isfinite(total):
                raise ValueError(f"non-finite dispatch cost {key}="
                                 f"{total!r} — a broken meter, not a "
                                 f"cheap dispatch")
            _add(self.totals, key, total)
            for lane in range(rung):
                label = (tenants[lane] if lane < len(tenants)
                         else OVERHEAD_PAD)
                _add(self.accounts.setdefault(label, {}), key, vec[lane])

    def overhead(self, account: str, **costs) -> None:
        """Book burnt cost (a retried or terminally failed attempt) to an
        explicit overhead account — it enters the totals too, so
        conservation still holds over the whole meter."""
        for key, total in costs.items():
            if key not in COST_KEYS:
                raise ValueError(f"unknown cost dimension {key!r}; valid: "
                                 f"{COST_KEYS}")
            if total is None:
                continue
            total = float(total)
            if not math.isfinite(total):
                raise ValueError(f"non-finite overhead cost {key}="
                                 f"{total!r}")
            _add(self.totals, key, total)
            _add(self.accounts.setdefault(str(account), {}), key, total)

    # ----------------------------------------------------------- reading

    def merge(self, other: "CostMeter") -> "CostMeter":
        """Fold ``other`` into self (in place; returns self). Exact:
        account dicts add key-wise, tallies add."""
        for label, acct in other.accounts.items():
            mine = self.accounts.setdefault(label, {})
            for key, v in acct.items():
                _add(mine, key, v)
        for key, v in other.totals.items():
            _add(self.totals, key, v)
        self.dispatches += other.dispatches
        self.lanes += other.lanes
        self.pad_lanes += other.pad_lanes
        return self

    def pad_fraction(self, key: str = "wall_s") -> "float | None":
        """The overhead-pad share of one cost dimension's total — the
        amortization-honesty number the regression gate watches. None
        when the dimension was never charged."""
        total = self.totals.get(key)
        if not total:
            return None
        pad = self.accounts.get(OVERHEAD_PAD, {}).get(key, 0.0)
        return pad / total

    def row(self, name: str) -> dict:
        """The meter as one JSON-ready ``kind="metering"`` row: sorted
        accounts, the dispatch totals (the conservation anchor), lane
        tallies, and the pad fraction."""
        rounded = {
            label: {k: round(v, 9) for k, v in sorted(acct.items())}
            for label, acct in sorted(self.accounts.items())}
        pf = self.pad_fraction()
        return {"kind": "metering", "name": name,
                "accounts": rounded,
                "totals": {k: round(v, 9)
                           for k, v in sorted(self.totals.items())},
                "dispatches": self.dispatches, "lanes": self.lanes,
                "pad_lanes": self.pad_lanes,
                "pad_fraction": (round(pf, 6) if pf is not None else None)}

    # ------------------------------------------- snapshot round-trip (JSON)

    def state(self) -> dict:
        return {"accounts": {k: dict(v)
                             for k, v in self.accounts.items()},
                "totals": dict(self.totals),
                "dispatches": self.dispatches, "lanes": self.lanes,
                "pad_lanes": self.pad_lanes}

    def load_state(self, state: dict) -> None:
        self.accounts = {str(k): {kk: float(vv) for kk, vv in v.items()}
                         for k, v in state.get("accounts", {}).items()}
        self.totals = {str(k): float(v)
                       for k, v in state.get("totals", {}).items()}
        self.dispatches = int(state.get("dispatches", 0))
        self.lanes = int(state.get("lanes", 0))
        self.pad_lanes = int(state.get("pad_lanes", 0))


def account_sum(row: dict, key: str) -> float:
    """Sum one cost dimension over a metering ROW's accounts."""
    return sum(float(acct.get(key, 0.0))
               for acct in (row.get("accounts") or {}).values())


def conservation_errors(row: dict, *, rtol: float = CONSERVE_RTOL,
                        atol: float = 1e-6) -> list:
    """Conservation violations of one ``kind="metering"`` row: for every
    cost dimension in ``totals``, the account splits must sum back to
    the dispatch total within tolerance (the row's values are rounded to
    1e-9, so the artifact-level ``atol`` default is looser than the
    in-memory one). The strict half of the metering contract, judged
    from the artifact alone — shared by ``tools/trace_report.py
    --strict`` and the tests."""
    errs = []
    totals = row.get("totals") or {}
    name = row.get("name", "?")
    for key, total in totals.items():
        if not isinstance(total, (int, float)) or isinstance(total, bool) \
                or not math.isfinite(float(total)):
            errs.append(f"metering row {name!r}: non-finite total "
                        f"{key}={total!r}")
            continue
        got = account_sum(row, key)
        if abs(got - float(total)) > atol + rtol * abs(float(total)):
            errs.append(f"metering row {name!r}: account {key} costs sum "
                        f"to {got!r} but the dispatch total is {total!r} "
                        f"— cost was dropped or double-billed")
    for label, acct in (row.get("accounts") or {}).items():
        extra = set(acct) - set(totals)
        if extra:
            errs.append(f"metering row {name!r}: account {label!r} "
                        f"carries cost(s) {sorted(extra)} absent from "
                        f"the totals")
    return errs
