"""Admission control and load-shedding for the serving queue (port of
``factormodeling_tpu/serve/admission.py``; no device code).

A bounded queue is the difference between a server that degrades and one
that collapses: without admission control, overload grows the backlog
without bound, EVERY request's latency diverges, and the server does
maximal work to deliver answers that all miss their deadlines. The
:class:`AdmissionPolicy` decides, at each request's (virtual) arrival,
whether the queue is overloaded — by depth against ``max_depth``, or by
the live served-latency p99 (the per-verdict quantile sketch the queue
maintains) against ``p99_budget_s`` — and when it is, walks the degrade
ladder, mildest client impact first in whatever order the deployment
prefers:

- ``"reject_new"`` — shed the arriving request with an explicit ``SHED``
  verdict naming the reason (``queue_depth`` / ``p99``). The classic
  answer: protect the requests already queued.
- ``"serve_stale"`` — answer instantly from the last dispatch's output
  for a VALUE-IDENTICAL config (static residue + every traced leaf; the
  :class:`StaleCache`). A stale answer costs zero queue time and zero
  compute — the verdict is ``SERVED`` with ``detail="stale:<rid>"`` so
  the client knows what it got. Falls through when no stale answer
  exists.
- ``"cheap_fallback"`` — rewrite the request to the cheapest weight
  scheme (``cheap_method``, default ``"equal"``: no solver graph) and
  queue it in THAT signature bucket: degraded research beats no research.
  Falls through when the config is already cheapest, and is suspended
  outright once depth reaches ``2 x max_depth`` (rerouting cannot be
  allowed to un-bound the bounded queue).

Any overloaded arrival no ladder step absorbs is SHED — the queue stays
bounded no matter what the ladder says. This is the degrade policy's
semantics at the serving layer: explicit, counted, mildest-first
degradation in place of silent failure (``resil.policy`` degrades the
COMPUTE inside a step; this ladder degrades the TRAFFIC around it).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["CHEAP_FALLBACK", "LADDER_STEPS", "REJECT_NEW", "SERVE_STALE",
           "AdmissionPolicy", "StaleCache"]

REJECT_NEW = "reject_new"
SERVE_STALE = "serve_stale"
CHEAP_FALLBACK = "cheap_fallback"
LADDER_STEPS = (REJECT_NEW, SERVE_STALE, CHEAP_FALLBACK)


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """When is the queue overloaded, and what happens then (module docs).

    ``max_depth=None`` disables the depth bound (shedding off — the
    bench's overload-baseline configuration, not a production one).
    ``p99_budget_s=None`` disables the latency trigger. ``ladder`` is
    consulted in order for each overloaded arrival; an empty ladder (or
    one no step of which applies) sheds.

    ``on_alert`` is the observe-only hook of the operations sentry: when
    the queue runs with ``sentry=`` on, every firing alert dict is passed
    to it at the dispatch boundary that fired it. No scheduling decision
    reads its result. Default None, inert. Excluded from
    ``repr``/comparison: the checkpoint meta guard keys on
    ``repr(policy)``, and a callback must not invalidate snapshots whose
    scheduling-relevant policy is unchanged."""

    max_depth: "int | None" = 64
    p99_budget_s: "float | None" = None
    ladder: tuple = (REJECT_NEW,)
    cheap_method: str = "equal"
    stale_cap: int = 256
    on_alert: object = dataclasses.field(default=None, repr=False,
                                         compare=False)

    def __post_init__(self):
        if self.max_depth is not None and int(self.max_depth) < 1:
            raise ValueError(f"max_depth must be >= 1 or None, got "
                             f"{self.max_depth}")
        if self.p99_budget_s is not None and not (
                float(self.p99_budget_s) > 0
                and math.isfinite(float(self.p99_budget_s))):
            raise ValueError(f"p99_budget_s must be positive finite or "
                             f"None, got {self.p99_budget_s}")
        unknown = [s for s in self.ladder if s not in LADDER_STEPS]
        if unknown:
            raise ValueError(f"unknown ladder steps {unknown}; valid: "
                             f"{LADDER_STEPS}")
        if int(self.stale_cap) < 1:
            raise ValueError(f"stale_cap must be >= 1, got {self.stale_cap}")
        if self.on_alert is not None and not callable(self.on_alert):
            raise ValueError(f"on_alert must be callable or None, got "
                             f"{self.on_alert!r}")

    def overloaded(self, *, depth: int, served_p99_s) -> "str | None":
        """The overload reason at this instant, or None. The p99 trigger
        only fires while a backlog exists — a past latency excursion with
        an empty queue is history, not overload."""
        if self.max_depth is not None and depth >= self.max_depth:
            return "queue_depth"
        if (self.p99_budget_s is not None and served_p99_s is not None
                and depth > 0 and served_p99_s > self.p99_budget_s):
            return "p99"
        return None

    def cheapened(self, config):
        """The config rewritten to the cheapest method, or None when it
        already is (the ladder step then falls through)."""
        if config.method == self.cheap_method:
            return None
        return dataclasses.replace(config, method=self.cheap_method)


class StaleCache:
    """Bounded FIFO-recency map from config content keys to the last
    dispatched answer — the ``serve_stale`` ladder step's store.

    In-memory entries hold the TYPED output lane as dispatched, so a
    stale hit is a dict lookup (the documented zero-compute cost), not a
    rebuild. Only the snapshot path flattens (``state(flatten=...)``),
    and only snapshot-RESTORED entries come back as flat leaf lists —
    the queue re-hangs those lazily on first hit. Insertion-order
    recency via pop/reinsert (the streaming kernel LRU idiom); state
    round-trips through the queue snapshot so a resumed run makes the
    SAME admission decisions a straight-through run would."""

    def __init__(self, cap: int = 256):
        self.cap = int(cap)
        # key -> [source_rid, payload, flat | None] — ``flat`` memoizes
        # the snapshot form so a per-dispatch checkpoint does not
        # re-transfer every cached lane to host every save (flat is
        # invalidated on put)
        self._entries: dict = {}

    def get(self, key: str):
        hit = self._entries.get(key)
        if hit is None:
            return None
        self._entries[key] = self._entries.pop(key)  # refresh recency
        return hit[0], hit[1]

    def put(self, key: str, source_rid: int, payload) -> None:
        self._entries.pop(key, None)
        flat = payload if isinstance(payload, list) else None
        self._entries[key] = [int(source_rid), payload, flat]
        while len(self._entries) > self.cap:
            self._entries.pop(next(iter(self._entries)))

    def __len__(self) -> int:
        return len(self._entries)

    # ---- snapshot round-trip (a JSON-like tree of array leaves)

    def state(self, flatten=None) -> dict:
        """Snapshot form. ``flatten`` maps a typed in-memory payload to
        its flat leaf list; the result is memoized per entry, so repeated
        per-dispatch snapshots flatten each cached lane ONCE."""
        for e in self._entries.values():
            if e[2] is None:
                e[2] = (e[1] if isinstance(e[1], list)
                        else flatten(e[1]) if flatten is not None else [])
        return {"keys": list(self._entries),
                "rids": [e[0] for e in self._entries.values()],
                "leaves": [e[2] for e in self._entries.values()]}

    def load_state(self, state: dict) -> None:
        self._entries = {}
        for key, rid, leaves in zip(state.get("keys", ()),
                                    state.get("rids", ()),
                                    state.get("leaves", ())):
            leaves = list(leaves)
            self._entries[key] = [int(rid), leaves, leaves]
