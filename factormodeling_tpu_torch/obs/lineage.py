"""Content-addressed provenance ledger: one derivation edge per published
number.

Every artifact the stack publishes — a served book, an advanced
``TenantState``, a scenario chunk's risk metrics — is content-addressed by
``resil.checkpoint.fingerprint`` (sha256 over each array's dtype, shape,
and raw bytes; 16 hex chars), and every production step is recorded as one
edge ``output_id <- inputs`` with the code identity (static key /
executable bucket / mesh), carried state (online version, fingerprint-chain
head, replay count), and the reqtrace dispatch id that joins the edge to
its causal span tree. The ledger answers the audit question the individual
subsystems cannot: *which input panel bytes, which executable, and which
sequence of applied/replayed dates produced THIS tenant's book on THIS
date?*

Edge taxonomy (``edge_kind``):

- ``"source"`` — a raw input artifact (no inputs): ``what`` names it
  (``panels``, ``config``, ``date_slice``, ``path_spec``, ``base_market``,
  ``state_genesis``, ``stream_inputs``, ``sweep_inputs``).
- ``"dispatch"`` — one served lane's output book: inputs are the panel and
  config fingerprints, ``code`` the executable identity, ``trace`` the
  reqtrace dispatch id.
- ``"applied"`` / ``"replayed"`` — one online date transition
  prev-state -> next-state; a replay caused by a restatement carries
  ``supersedes`` naming the edge it restates.
- ``"scenario_chunk"`` / ``"stream_chunk"`` / ``"sweep_chunk"`` — one
  checkpointed chunk of the scenario / streaming / sweep engines.

Elision contract (the obs layer's strong form): lineage is OFF by default,
no producing layer imports this module until a caller passes
``lineage=...``, the default path is pinned bit-identical with this module
made unimportable (subprocess test), and the lineage-on overhead is bounded
at <=2% on the serving bench. This module is deliberately STDLIB-ONLY —
fingerprints are computed by the producing layers (which already hold the
arrays and ``resil.checkpoint.fingerprint``) and enter the ledger as
strings, so ``tools/lineage.py`` and ``tools/trace_report.py`` can load the
checker standalone-by-path without jax or numpy.

Honest limits (also §26 of docs/architecture.md): referential integrity
proves the recorded GRAPH is sound — every referenced id resolves, chains
are acyclic — and a flipped byte in any *referenced* id is caught as a
dangling edge. It cannot re-verify CONTENT that has left disk: a terminal
``output_id`` nothing references can be altered undetected unless the
artifact itself is still available to re-fingerprint (``tools/lineage.py
--strict --artifacts`` recomputes any that are).
"""

from __future__ import annotations

import json

__all__ = ["LineageLedger", "explain_lines", "ledger_errors",
           "lineage_rows", "traffic_errors", "traffic_rows"]


class LineageLedger:
    """Append-only edge store with deterministic serialization.

    The ledger is pure host data: :meth:`state` is ONE sorted-keys JSON
    string (rides a checkpoint exactly like ``FlightKit.state()``), and
    :meth:`load_state` reconstructs it so a killed-and-resumed run appends
    the same edges in the same order as the uninterrupted run — the
    byte-equality contract the resume differential pins.
    """

    def __init__(self):
        self.edges: list = []
        self._ids: set = set()        # every recorded output_id
        self._src: set = set()        # (output_id, what) of source edges

    # ------------------------------------------------------------ recording

    def source(self, output_id: str, what: str, **fields) -> str:
        """Register a raw input artifact (terminal node, no inputs).
        Idempotent per ``(id, what)`` — re-registration after a resume or
        on a later dispatch of the same config is a no-op, which is what
        keeps resumed ledgers byte-equal."""
        output_id = str(output_id)
        key = (output_id, str(what))
        if key in self._src:
            return output_id
        self._src.add(key)
        self._append({"edge_kind": "source", "output_id": output_id,
                      "inputs": [], "what": str(what), **fields})
        return output_id

    def edge(self, output_id: str, edge_kind: str, inputs, *, code=None,
             state=None, trace=None, **fields) -> str:
        """Record one derivation edge ``output_id <- inputs``."""
        output_id = str(output_id)
        self._append({"edge_kind": str(edge_kind), "output_id": output_id,
                      "inputs": [str(i) for i in inputs],
                      **({"code": code} if code is not None else {}),
                      **({"state": state} if state is not None else {}),
                      **({"trace": trace} if trace is not None else {}),
                      **fields})
        return output_id

    def _append(self, e: dict) -> None:
        self.edges.append(e)
        self._ids.add(e["output_id"])

    # ------------------------------------------------------------- queries

    def known(self, output_id) -> bool:
        return str(output_id) in self._ids

    def last_edge(self, *, exclude_sources: bool = True, **match):
        """The most recent edge whose fields equal ``match`` (None when no
        edge matches) — how a replay finds the edge it supersedes."""
        for e in reversed(self.edges):
            if exclude_sources and e.get("edge_kind") == "source":
                continue
            if all(e.get(k) == v for k, v in match.items()):
                return e
        return None

    # -------------------------------------------------------------- output

    def rows(self, name: str) -> list:
        """One ``kind="lineage"`` RunReport row per edge, in record order
        (``seq`` pins the order after rows from several subsystems merge
        into one report)."""
        return [{"kind": "lineage", "name": str(name), "seq": i, **e}
                for i, e in enumerate(self.edges)]

    # ----------------------------------------------------- snapshot/resume

    def state(self) -> str:
        """The ledger as one deterministic JSON string (sorted keys), for
        embedding in a checkpoint payload."""
        return json.dumps({"edges": self.edges}, sort_keys=True)

    def load_state(self, state: str) -> None:
        """Restore from :meth:`state` (replaces current contents)."""
        data = json.loads(state)
        self.edges = [dict(e) for e in data["edges"]]
        self._ids = {e["output_id"] for e in self.edges}
        self._src = {(e["output_id"], e.get("what")) for e in self.edges
                     if e.get("edge_kind") == "source"}


# ------------------------------------------------------------- row views


def lineage_rows(rows) -> list:
    """Every ``kind="lineage"`` row, in report order."""
    return [r for r in rows if r.get("kind") == "lineage"]


def traffic_rows(rows) -> list:
    """Every ``kind="traffic"`` arrival-trace row, in report order."""
    return [r for r in rows if r.get("kind") == "traffic"]


# ------------------------------------------------- referential integrity


def ledger_errors(rows) -> list:
    """Referential-integrity findings over ``kind="lineage"`` rows,
    grouped by ledger ``name`` (one ledger per producing scope): every
    referenced input id must resolve to some edge's ``output_id``
    (sources give closure), ``supersedes`` references must resolve, and
    the derivation graph must be acyclic. Returns human-readable strings
    naming the broken edge; empty means sound."""
    errs: list = []
    by_name: dict = {}
    for r in lineage_rows(rows):
        by_name.setdefault(str(r.get("name", "?")), []).append(r)
    for name, edges in sorted(by_name.items()):
        known: set = set()
        for r in edges:
            oid = r.get("output_id")
            if not isinstance(oid, str) or not oid:
                errs.append(f"lineage {name}: edge seq={r.get('seq')} "
                            f"kind={r.get('edge_kind')!r} has no output_id")
            else:
                known.add(oid)
        adj: dict = {}
        for r in edges:
            oid = r.get("output_id")
            if not isinstance(oid, str) or not oid:
                continue
            label = (f"edge {r.get('edge_kind')} output_id={oid}"
                     + (f" seq={r['seq']}" if "seq" in r else ""))
            inputs = r.get("inputs")
            if not isinstance(inputs, list):
                errs.append(f"lineage {name}: {label} has malformed "
                            f"inputs ({type(inputs).__name__})")
                inputs = []
            for i in inputs:
                if i not in known:
                    errs.append(f"lineage {name}: {label} references "
                                f"unknown input {i} — dangling edge")
            sup = r.get("supersedes")
            if sup is not None and sup not in known:
                errs.append(f"lineage {name}: {label} supersedes unknown "
                            f"edge {sup}")
            adj.setdefault(oid, set()).update(
                i for i in inputs if i in known)
        errs.extend(_cycle_errors(name, adj))
    return errs


def _cycle_errors(name: str, adj: dict) -> list:
    """Iterative 3-color DFS over output_id -> inputs; any back edge is a
    cycle (a derivation chain must be a DAG rooted in sources)."""
    color = dict.fromkeys(adj, 0)      # 0 white, 1 gray, 2 black
    bad: list = []
    for root in adj:
        if color[root]:
            continue
        color[root] = 1
        stack = [(root, iter(sorted(adj[root])))]
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color.get(nxt, 2) == 1:
                    bad.append(f"lineage {name}: cycle through edge "
                               f"output_id={nxt} — chain not acyclic")
                elif color.get(nxt) == 0:
                    color[nxt] = 1
                    stack.append((nxt, iter(sorted(adj[nxt]))))
                    advanced = True
                    break
            if not advanced:
                color[node] = 2
                stack.pop()
    return sorted(set(bad))


# -------------------------------------------- traffic vs serving verdicts

# final-verdict kind -> the serving summary row's counter key (the four
# terminal states of the queue's verdict machine; stale serves and cheap
# fallbacks are admission EVENTS that still terminate in one of these)
_VERDICT_COUNTERS = {"SERVED": "served", "SHED": "shed_count",
                     "DEADLINE_MISS": "deadline_miss_count",
                     "FAILED": "failed_count"}


def traffic_errors(rows) -> list:
    """Cross-check ``kind="traffic"`` rows against the same report's
    ``kind="serving"`` summary row per queue name: row count must equal
    ``submitted`` and each final verdict's tally must match the summary
    counter it increments. A queue with traffic rows but no serving row
    (or vice versa) is itself a finding — the artifact lost half the
    evidence."""
    errs: list = []
    traffic: dict = {}
    for r in traffic_rows(rows):
        traffic.setdefault(str(r.get("name", "?")), []).append(r)
    serving = {str(r.get("name", "?")): r for r in rows
               if r.get("kind") == "serving"}
    for name, trows in sorted(traffic.items()):
        srow = serving.get(name)
        if srow is None:
            errs.append(f"traffic {name}: {len(trows)} traffic rows but "
                        f"no serving summary row")
            continue
        submitted = srow.get("submitted")
        if isinstance(submitted, int) and len(trows) != submitted:
            errs.append(f"traffic {name}: {len(trows)} traffic rows != "
                        f"{submitted} submitted")
        tally: dict = {}
        for r in trows:
            v = r.get("verdict")
            if v not in _VERDICT_COUNTERS:
                errs.append(f"traffic {name}: rid {r.get('rid')} has "
                            f"unknown verdict {v!r}")
                continue
            tally[v] = tally.get(v, 0) + 1
        for v, key in sorted(_VERDICT_COUNTERS.items()):
            want = srow.get(key)
            if isinstance(want, int) and tally.get(v, 0) != want:
                errs.append(f"traffic {name}: {tally.get(v, 0)} rows with "
                            f"verdict {v} != serving row {key}={want}")
    return errs


# ------------------------------------------------------ the causal story


def explain_lines(rows, *, tenant=None, date=None, rid=None,
                  output_id=None, name=None) -> list:
    """Walk the chain from a published artifact back to raw input
    fingerprints and render the causal story, one line per edge, indented
    by derivation depth. Selection: the LATEST non-source edge matching
    the given filters (latest wins, so a restated date explains its
    superseding replay). Reqtrace rows in the same ``rows`` are joined by
    dispatch id. Dangling references render as ``!! UNRESOLVED`` — the
    explain tool never hides a broken chain."""
    edges = [r for r in lineage_rows(rows)
             if name is None or str(r.get("name")) == str(name)]
    if not edges:
        return ["no lineage rows"
                + (f" for name={name}" if name is not None else "")
                + " — was the run recorded with lineage on?"]
    by_id: dict = {}
    for e in edges:
        by_id[e.get("output_id")] = e        # last occurrence wins

    def _match(e):
        if e.get("edge_kind") == "source":
            return False
        if tenant is not None and str(e.get("tenant")) != str(tenant):
            return False
        if date is not None and e.get("date") != date:
            return False
        if rid is not None and e.get("rid") != rid:
            return False
        if output_id is not None and e.get("output_id") != output_id:
            return False
        return True

    terms = [e for e in edges if _match(e)]
    if not terms:
        want = ", ".join(f"{k}={v}" for k, v in
                         (("tenant", tenant), ("date", date), ("rid", rid),
                          ("output_id", output_id)) if v is not None)
        return [f"lineage: no edge matches {want or 'any filter'} "
                f"({len(edges)} edges recorded)"]
    term = terms[-1]

    spans_by_dispatch: dict = {}
    for r in rows:
        if r.get("kind") != "reqtrace":
            continue
        for s in r.get("spans") or []:
            d = s.get("dispatch")
            if isinstance(d, int):
                spans_by_dispatch.setdefault(d, []).append(
                    (r.get("trace_id"), s))

    lines = [f"explain {term.get('name', '?')}: "
             f"{_edge_desc(term, spans_by_dispatch)}"]
    seen = {term.get("output_id")}

    def _walk(eid, depth):
        pad = "  " * depth
        e = by_id.get(eid)
        if e is None:
            lines.append(f"{pad}<- {eid}  !! UNRESOLVED (dangling "
                         f"reference)")
            return
        if eid in seen:
            lines.append(f"{pad}<- {e.get('edge_kind')} {eid} "
                         f"(shown above)")
            return
        seen.add(eid)
        lines.append(f"{pad}<- {_edge_desc(e, spans_by_dispatch)}")
        for i in e.get("inputs") or []:
            _walk(i, depth + 1)

    for i in term.get("inputs") or []:
        _walk(i, 1)
    return lines


def _edge_desc(e: dict, spans_by_dispatch: dict) -> str:
    bits = [f"{e.get('edge_kind', '?')} {e.get('output_id', '?')}"]
    for key in ("what", "rid", "tenant", "date", "chunk"):
        v = e.get(key)
        if v is not None:
            bits.append(f"{key}={v}")
    code = e.get("code") or {}
    if code:
        bits.append("code[" + " ".join(
            f"{k}={code[k]}" for k in sorted(code)) + "]")
    st = e.get("state") or {}
    if st:
        bits.append("state[" + " ".join(
            f"{k}={st[k]}" for k in sorted(st)) + "]")
    sup = e.get("supersedes")
    if sup is not None:
        bits.append(f"supersedes={sup}")
    tr = (e.get("trace") or {}).get("dispatch")
    if tr is not None:
        joined = spans_by_dispatch.get(tr) or []
        if joined:
            tid, s = joined[-1]
            bits.append(f"trace[dispatch={tr} reqtrace rid={tid} "
                        f"{s.get('name')} {s.get('t0')}s..{s.get('t1')}s]")
        else:
            bits.append(f"trace[dispatch={tr}]")
    return "  ".join(bits)
