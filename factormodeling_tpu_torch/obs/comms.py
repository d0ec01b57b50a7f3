"""The comms ledger: the collectives the port issued, by stage and mesh axis
(port of ``factormodeling_tpu/obs/comms.py``).

The JAX package reads its ledger out of the compiled HLO, where the
partitioner inserted the collectives. The port has no partitioner and no
HLO: every collective is written out through the three wrappers of
``parallel/mesh.py`` (``all_gather``, ``all_reduce``, ``all_to_all``), and
each call records one :class:`CollectiveOp` here while a ledger is open
(:func:`recording`):

- ``kind``: ``all-gather``, ``all-reduce``, ``all-to-all`` or
  ``collective-permute`` (a hand-off between neighbouring row blocks,
  charged one operand a sending rank);
- ``stage``: the stage the JAX package's rule gives for the open
  ``obs.trace.stage`` names joined into an ``op_name`` path: the
  outermost (earliest) known scope of :data:`STAGE_SCOPES`, the longest
  on a tie (``"unattributed"`` when none is);
- ``axis``: the mesh axis the call ran over;
- ``operand_bytes``: this rank's operand (the local block);
- ``bytes_moved``: the JAX package's byte model, unchanged: for a group of
  S ranks the per-participant link bytes are ``factor(kind, S) x
  operand_bytes`` with all-reduce ``2(S-1)/S``, all-gather ``S-1`` and
  all-to-all ``(S-1)/S``, totalled over every participant of the mesh
  (``n_groups x S``), as every rank of an SPMD program issues the same
  call.

A rank records the calls it issued; every rank issues the same ones, so
one rank's ledger is the program's. A collective inside a loop counts once
a trip (the JAX ledger counts an HLO op once, whatever its trip count).
:meth:`CommsLedger.by_stage`, :meth:`CommsLedger.totals` and
:meth:`CommsLedger.rows` give the JAX package's ``kind="comms"`` row
schema, so ``tools/trace_report.py`` and ``tools/report_diff.py`` read the
port's rows. Under :func:`recording` with ``record_only=True`` the
wrappers record without communicating and return stand-ins of the right
shape, so stages run on ``meta`` tensors give their ledger from the shapes
alone (``parallel/asset_shard.choose_asset_specs`` runs the asset-sharded
step's layout stages so).

:func:`sharding_lint` checks the tensors handed to a sharded step against
its declared placements. ``hlo_text_of``, ``resolve``, ``mesh_of`` and
``parse_collectives`` read compiled HLO, which the port does not have:
they raise ``NotImplementedError`` with that reason.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np

__all__ = ["CollectiveOp", "CommsLedger", "STAGE_SCOPES", "comms_ledger",
           "hlo_text_of", "mesh_of", "parse_collectives", "record",
           "record_only", "recording", "resolve", "sharding_lint"]

#: the ``obs.stage`` scopes collectives are charged to: the JAX package's,
#: plus the port's scopes for the sharded steps' input gathers and the
#: online advance's seven stages (``online/advance.py::ONLINE_STAGES``),
#: whose collectives run inside the advance's stages
STAGE_SCOPES = (
    "selection/rolling", "selection/daily_stats", "selection/rolling_metrics",
    "composite/blend", "backtest/trade_list", "backtest/weights",
    "backtest/pnl", "pipeline/summary", "obs/stage_counters",
    "solver/admm", "solver/polish", "metrics/rank_ic",
    "streaming/stats", "streaming/composite", "streaming/linear_research",
    "sweep/books", "sweep/combo_pnl",
    "parallel/inputs", "ops/rank", "ops/quantile", "solver/iterates",
    "serve/tenants", "resil/faults",
    "online/ingest", "online/daily_stats", "online/context",
    "online/selection", "online/blend", "online/solve", "online/shift_pnl",
)

#: per-participant link-bytes factor as a function of group size S (the
#: module docs' byte model)
_BYTE_FACTOR = {
    "all-reduce": lambda s: 2.0 * (s - 1) / s if s else 0.0,
    "all-gather": lambda s: float(s - 1),
    "reduce-scatter": lambda s: (s - 1) / s if s else 0.0,
    "all-to-all": lambda s: (s - 1) / s if s else 0.0,
    "collective-permute": lambda s: 1.0,
}

_NO_HLO = ("the port issues its collectives through parallel/mesh.py's "
           "wrappers and compiles no HLO; open obs.comms.recording() "
           "around the call instead")


class CollectiveOp(NamedTuple):
    """One collective a wrapper issued."""

    kind: str            # "all-gather", "all-reduce", "all-to-all" or
    #                      "collective-permute"
    stage: str           # the charged STAGE_SCOPES entry, or "unattributed"
    axis: str            # the mesh axis the call ran over
    operand_bytes: int   # this rank's operand
    bytes_moved: float   # mesh-wide estimate: factor(kind, S) x operand
    #                      x participants
    group_size: int
    n_groups: int
    op_name: str         # the open stages, outermost first, "/"-joined
    # the shape this rank holds after the call (the port's addition: what
    # a stage's rows are)
    out_shape: tuple = ()


class CommsLedger:
    """Aggregated collective-comms accounting for one run."""

    def __init__(self, ops: list | None = None,
                 mesh_shape: dict | None = None):
        self.ops = list(ops or ())
        self.mesh_shape = dict(mesh_shape) if mesh_shape else None

    def by_stage(self) -> dict:
        """stage -> {"collectives": {kind: {count, bytes_moved}},
        "bytes_moved": total, "by_axis": {axis: bytes}} in
        first-appearance order."""
        out: dict = {}
        for op in self.ops:
            bucket = out.setdefault(op.stage,
                                    {"collectives": {}, "bytes_moved": 0.0,
                                     "by_axis": {}})
            k = bucket["collectives"].setdefault(
                op.kind, {"count": 0, "bytes_moved": 0.0})
            k["count"] += 1
            k["bytes_moved"] += op.bytes_moved
            bucket["bytes_moved"] += op.bytes_moved
            bucket["by_axis"][op.axis] = (bucket["by_axis"].get(op.axis, 0.0)
                                          + op.bytes_moved)
        return out

    def totals(self) -> dict:
        by_kind: dict = {}
        by_axis: dict = {}
        for op in self.ops:
            k = by_kind.setdefault(op.kind, {"count": 0, "bytes_moved": 0.0})
            k["count"] += 1
            k["bytes_moved"] += op.bytes_moved
            by_axis[op.axis] = by_axis.get(op.axis, 0.0) + op.bytes_moved
        return {"collectives": len(self.ops),
                "bytes_moved": sum(op.bytes_moved for op in self.ops),
                "by_kind": by_kind, "by_axis": by_axis}

    def rows(self, name: str) -> list[dict]:
        """``kind="comms"`` RunReport rows: one per attributed stage plus
        a ``stage="total"`` roll-up carrying the per-axis byte split."""
        rows = [{"kind": "comms", "name": name, "stage": stage, **agg}
                for stage, agg in self.by_stage().items()]
        total = self.totals()
        rows.append({"kind": "comms", "name": name, "stage": "total",
                     "collectives": total["by_kind"],
                     "bytes_moved": total["bytes_moved"],
                     "by_axis": total["by_axis"],
                     "mesh_shape": self.mesh_shape})
        return rows


# --------------------------------------------------------------- recording

_LEDGERS: list = []      # the open ledgers, innermost last
_RECORD_ONLY: list = []  # one flag per open ledger


def _stage_of(open_stages, stages) -> str:
    """The OUTERMOST known scope of the open stages (outermost first),
    by the JAX package's rule on their ``"/"``-joined ``op_name`` path:
    the earliest position wins, and at one position the longest scope
    (``selection/rolling_metrics`` is not shadowed by its prefix
    ``selection/rolling``). ``obs/devtime.py`` charges device time by the
    same rule, so the two per-stage buckets of one step agree."""
    op_name = "/".join(open_stages)
    best, best_key = "unattributed", (len(op_name) + 1, 0)
    for scope in stages:
        pos = op_name.find(scope)
        if pos >= 0 and (pos, -len(scope)) < best_key:
            best, best_key = scope, (pos, -len(scope))
    return best


def record(kind: str, axis: str, operand_bytes: int, group_size: int,
           n_groups: int, out_shape: tuple = ()) -> None:
    """Charge one collective to every open ledger (a no-op with none
    open); the wrappers of ``parallel/mesh.py`` call it once a call."""
    if not _LEDGERS:
        return
    from factormodeling_tpu_torch.obs.trace import active_stages

    open_stages = active_stages()
    per_device = _BYTE_FACTOR[kind](group_size) * operand_bytes
    op = CollectiveOp(kind=kind, stage=_stage_of(open_stages, STAGE_SCOPES),
                      axis=axis, operand_bytes=int(operand_bytes),
                      bytes_moved=per_device * n_groups * group_size,
                      group_size=int(group_size), n_groups=int(n_groups),
                      op_name="/".join(open_stages),
                      out_shape=tuple(int(d) for d in out_shape))
    for ledger in _LEDGERS:
        ledger.ops.append(op)


def record_only() -> bool:
    """True inside a ``recording(record_only=True)`` block: the wrappers
    record and return stand-ins without communicating."""
    return bool(_RECORD_ONLY) and _RECORD_ONLY[-1]


@contextlib.contextmanager
def recording(mesh=None, *, record_only: bool = False):
    """Open a :class:`CommsLedger` that every wrapper call inside the
    block is charged to (nested ledgers each see the calls inside them).
    ``mesh`` fills the ledger's ``mesh_shape``."""
    shape = None
    if mesh is not None:
        shape = {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}
    ledger = CommsLedger(mesh_shape=shape)
    _LEDGERS.append(ledger)
    _RECORD_ONLY.append(bool(record_only))
    try:
        yield ledger
    finally:
        _LEDGERS.remove(ledger)
        _RECORD_ONLY.pop()


def comms_ledger(ops, *, mesh_shape: dict | None = None) -> CommsLedger:
    """A :class:`CommsLedger` over recorded :class:`CollectiveOp` s (the
    JAX package's takes a compiled artifact; see :func:`recording`)."""
    if isinstance(ops, str) or hasattr(ops, "as_text"):
        raise NotImplementedError(f"comms_ledger of compiled HLO: {_NO_HLO}")
    return CommsLedger(list(ops), mesh_shape=mesh_shape)


def hlo_text_of(target, *args, **kwargs) -> str:
    raise NotImplementedError(f"hlo_text_of: {_NO_HLO}")


def resolve(target, *args, **kwargs):
    raise NotImplementedError(f"resolve: {_NO_HLO}")


def mesh_of(compiled):
    raise NotImplementedError(f"mesh_of: {_NO_HLO}")


def parse_collectives(hlo_text: str, **kwargs):
    raise NotImplementedError(f"parse_collectives: {_NO_HLO}")


# --------------------------------------------------------------- lint


def sharding_lint(step, inputs) -> dict:
    """Check the tensors handed to a sharded step (``step``'s
    ``declared_in_shardings`` and ``mesh``) against its declared
    placements: each input must be this rank's block (the full dim over
    the axis's size along a sharded dim, the full dim elsewhere, so a
    full tensor handed to a sharded dim is flagged ``replicated``) and on
    the mesh's device type.

    ``inputs`` is ``(full_inputs, handed)``: the full host arrays and what
    was handed to the step. ``full_inputs`` None (``RunReport.
    add_placement``, which sees only the call's arguments) checks what a
    rank can see of its blocks alone: each handed tensor's rank against
    its declared placement and its device type against the mesh's, with
    a note that the block sizes went unchecked. Returns the JAX package's
    JSON-ready dict: ``clean``, ``flags``, ``notes``, ``checked_inputs``,
    ``checked_outputs`` (0: outputs are replicated by the contract) and
    ``n_devices``."""
    from factormodeling_tpu_torch.parallel.mesh import axis_size

    declared = step.declared_in_shardings
    mesh = step.mesh
    full, handed = inputs
    flags: list[str] = []
    notes: list[str] = []
    checked = 0
    if full is None:
        for i, (p, h) in enumerate(zip(declared, handed)):
            if not hasattr(h, "shape") or not hasattr(h, "device"):
                notes.append(f"input {i}: not a tensor, not checked")
                continue
            checked += 1
            if len(p.dims) > h.ndim:
                flags.append(f"input {i}: declared {tuple(p.dims)} on a "
                             f"{h.ndim}-d tensor")
            if h.device.type != mesh.device_type:
                flags.append(f"input {i}: on {h.device.type}, the mesh is "
                             f"{mesh.device_type}")
        notes.append("full shapes not given: block sizes not checked")
        return {"clean": not flags, "flags": flags, "notes": notes,
                "checked_inputs": checked, "checked_outputs": 0,
                "n_devices": int(np.prod(mesh.shape))}
    for i, (p, f, h) in enumerate(zip(declared, full, handed)):
        if h is None or f is None:
            notes.append(f"input {i}: absent, not checked")
            continue
        checked += 1
        want = list(np.shape(f))
        for d, a in enumerate(p.dims[:len(want)]):
            if a is not None:
                want[d] //= axis_size(mesh, a)
        got = list(h.shape)
        if got == list(np.shape(f)) and got != want:
            flags.append(f"input {i}: declared {tuple(p.dims)} but handed "
                         f"the full {tuple(got)} — REPLICATED, every rank "
                         f"holds (and computes on) the whole operand")
        elif got != want:
            flags.append(f"input {i}: declared {tuple(p.dims)} wants a "
                         f"{tuple(want)} block, handed {tuple(got)}")
        if h.device.type != mesh.device_type:
            flags.append(f"input {i}: on {h.device.type}, the mesh is "
                         f"{mesh.device_type}")
    return {"clean": not flags, "flags": flags, "notes": notes,
            "checked_inputs": checked, "checked_outputs": 0,
            "n_devices": int(np.prod(mesh.shape))}
