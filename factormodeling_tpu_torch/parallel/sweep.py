"""Candidate-combo sweep: many factor combinations, one backtest each (port
of ``factormodeling_tpu/parallel/sweep.py``).

The reference would run ``run_multimanager_backtest`` once per combo, each
time recomputing every manager's daily weight book. The per-manager books
depend only on (factor, settings), not on the combo, so they are computed
once (``[F, D, N]``), and every combo reduces to one contraction over the
manager axis plus the P&L. Combos run in chunks of ``combo_batch`` (the JAX
package's ``lax.map(..., batch_size=combo_batch)``): a chunk's books
``[B, D, N]`` go through the P&L on an explicit date axis, so each combo
gets the result of its own ``[D, N]`` call and the working set stays one
chunk. :func:`checkpointed_manager_sweep` runs the same chunks as a host
loop that snapshots after each, for runs that must survive interruption.
:func:`make_sharded_manager_sweep` splits the book pass by factors and the
combos over a ``("combo",)`` mesh, one rank a device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch._device import check_device
from factormodeling_tpu_torch.backtest.pnl import daily_portfolio_returns
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.multimanager import compute_manager_weights
from factormodeling_tpu_torch.obs.compile_log import (entry_point_tag,
                                                      instrument_jit)
from factormodeling_tpu_torch.obs.report import record_stage
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.parallel.mesh import (all_gather, axis_index,
                                                    axis_size, mesh_device)
from factormodeling_tpu_torch.parallel.pipeline import result_summary

__all__ = ["SweepOutput", "checkpointed_manager_sweep", "combo_weight_matrix",
           "make_sharded_manager_sweep", "manager_sweep"]


class SweepOutput(NamedTuple):
    log_return: torch.Tensor        # [C, D] daily net returns per combo
    turnover: torch.Tensor          # [C, D]
    total_log_return: torch.Tensor  # [C]
    sharpe: torch.Tensor            # [C]
    mean_turnover: torch.Tensor     # [C]


def combo_weight_matrix(combos, n_factors: int, weights=None, *,
                        device=None) -> torch.Tensor:
    """Dense ``float32[C, F]`` combo weights from index lists, on ``device``
    (``None`` is the card).

    ``combos``: int array ``[C, K]`` of factor indices per candidate;
    ``weights``: optional ``[C, K]`` per-member weights (default equal 1/K).
    Duplicate indices accumulate. Float32 always, as the JAX package
    returns it; :func:`manager_sweep` casts it to the books' type at the
    contraction.
    """
    dev = check_device(device)
    combos = np.asarray(combos, dtype=np.int64)
    c, k = combos.shape
    w = (np.full((c, k), 1.0 / k) if weights is None
         else np.asarray(weights, dtype=np.float64))
    dense = np.zeros((c, n_factors), dtype=np.float64)
    np.add.at(dense, (np.arange(c)[:, None], combos), w)
    return torch.from_numpy(dense.astype(np.float32)).to(dev)


def _combine_and_pnl(books: torch.Tensor, combo_weights: torch.Tensor,
                     settings: SimulationSettings,
                     combo_batch: int) -> SweepOutput:
    """Contract the books ``[F, D, N]`` against combo weights ``[C, F]`` in
    chunks of ``combo_batch`` combos, each chunk's ``[B, D, N]`` books
    through the P&L and the summary."""
    # pandas .add(fill_value=0) zero-fills NaN values before adding, so the
    # combination is one clean contraction; torch.einsum takes one type,
    # where the JAX package's promotes the float32 combo weights against the
    # books
    clean = torch.nan_to_num(books)
    weights = combo_weights.to(clean.dtype)
    parts = []
    for lo in range(0, weights.shape[0], combo_batch):
        combined = torch.einsum("cf,fdn->cdn", weights[lo:lo + combo_batch],
                                clean)
        res = daily_portfolio_returns(combined, settings)
        summ = result_summary(res)
        parts.append(SweepOutput(
            log_return=res.log_return, turnover=res.turnover,
            total_log_return=summ.total_log_return, sharpe=summ.sharpe,
            mean_turnover=summ.mean_turnover))
    return SweepOutput(*(torch.cat(field) for field in zip(*parts)))


def manager_sweep(factors: torch.Tensor, combo_weights: torch.Tensor,
                  settings: SimulationSettings, *, combo_batch: int = 8,
                  device=None) -> SweepOutput:
    """Single-device sweep: one book pass, then every combo's backtest.
    ``device=None`` is the card; the inputs must lie on the device asked
    for."""
    check_device(device, factors, combo_weights)
    record_stage("parallel/sweep", combos=int(combo_weights.shape[0]),
                 factors=int(factors.shape[0]), combo_batch=combo_batch)
    books, _, _ = compute_manager_weights(factors, settings, device=device)
    return _combine_and_pnl(books, combo_weights, settings, combo_batch)


def _settings_identity(settings: SimulationSettings):
    """``(static, tensors)`` of the settings: the repr of every non-tensor
    field (method, knobs, the policy, an absent universe) and the tensor
    fields in order, for the checkpoint's configuration guard."""
    static, tensors = {}, []
    for f in dataclasses.fields(settings):
        v = getattr(settings, f.name)
        if isinstance(v, torch.Tensor):
            tensors.append(v)
        else:
            static[f.name] = repr(v)
    return repr(sorted(static.items())), tensors


#: the JAX package's SimulationSettings pytree leaves, in its field order
#: (its static fields are no leaves; None fields are empty subtrees)
_SETTINGS_LEAVES = ("returns", "cap_flag", "investability_flag", "universe",
                    "degrade", "max_weight", "pct", "min_universe",
                    "tcost_scale", "shrinkage_intensity", "turnover_penalty",
                    "return_weight", "turnover_tol")


def _jax_leaves(combo_weights, factors, settings) -> list:
    """``jax.tree_util.tree_leaves((combo_weights, factors, settings))`` of
    the JAX package's sweep, as host arrays: the tensors' host copies, the
    Python knobs as ``np.asarray`` makes them, the policy's fields in its
    leaf dtypes (int32, float32, float32, bool). The lineage ledger's
    ``sweep_inputs`` id hashes them, so it is the JAX package's id."""
    out = [combo_weights, factors]
    for name in _SETTINGS_LEAVES:
        v = getattr(settings, name)
        if v is None:
            continue
        if name == "degrade":
            out += [np.int32(v.min_universe),
                    np.float32(v.quarantine_nan_frac),
                    np.float32(v.clamp_absmax), np.bool_(v.carry_fallback)]
        else:
            out.append(v if isinstance(v, torch.Tensor) else np.asarray(v))
    return out


def checkpointed_manager_sweep(factors: torch.Tensor,
                               combo_weights: torch.Tensor,
                               settings: SimulationSettings, *,
                               combo_batch: int = 8,
                               chunk_combos: int | None = None,
                               checkpoint=None, lineage=None,
                               device=None) -> SweepOutput:
    """:func:`manager_sweep` as a host loop over chunks of ``chunk_combos``
    combos with an atomic snapshot after each (an optional
    :class:`~factormodeling_tpu_torch.resil.checkpoint.Checkpointer`).

    The book pass runs first, on every start (the books can be GBs, a
    chunk's outputs are ``[C, D]`` rows). ``chunk_combos`` is rounded UP to
    a multiple of ``combo_batch``, so the chunks of ``combo_batch`` combos
    are the uninterrupted run's and the output is bitwise
    :func:`manager_sweep`'s. A resume skips the chunks the snapshot holds;
    a snapshot of another configuration (combo count, chunking, shapes,
    settings, input content) is skipped with a warning. Each chunk's
    outputs move to the host once, for the snapshots and the ledger; the
    returned outputs are on the inputs' device.

    ``lineage``: ``True`` or a shared
    :class:`~factormodeling_tpu_torch.obs.lineage.LineageLedger` records
    one ``sweep_chunk`` provenance edge a chunk (the chunk's output
    fingerprint, derived from the ``sweep_inputs`` source: the JAX
    package's fingerprint of the combos, the factors and the settings'
    pytree leaves); the ledger rides the checkpoint, so a resumed sweep's
    ledger is byte-equal to a straight-through run's, and its rows land on
    the active report at the end. Off by default; ``obs.lineage`` is not
    imported then."""
    dev = check_device(device, factors, combo_weights)
    ledger = None
    if lineage:
        from factormodeling_tpu_torch.obs.lineage import LineageLedger

        ledger = (lineage if isinstance(lineage, LineageLedger)
                  else LineageLedger())
    c = int(combo_weights.shape[0])
    if chunk_combos is None:
        chunk_combos = combo_batch * 4
    chunk_combos = max(combo_batch, -(-chunk_combos // combo_batch)
                       * combo_batch)
    books, _, _ = compute_manager_weights(factors, settings, device=device)

    start, parts, host_parts = 0, [], []
    ck_meta = None
    if checkpoint is not None:
        from factormodeling_tpu_torch.resil.checkpoint import fingerprint

        static, tensors = _settings_identity(settings)
        ck_meta = {"entry": "manager_sweep",
                   "config": [c, int(chunk_combos), int(combo_batch),
                              [int(v) for v in factors.shape], static],
                   "inputs": fingerprint(combo_weights, factors, *tensors)}
        got = checkpoint.resume(expect_meta=ck_meta)
        if got is not None:
            state, _ = got
            start = int(state["next_chunk"])
            host_parts = [SweepOutput(**p) for p in state["parts"]]
            parts = [SweepOutput(*(torch.tensor(a, device=dev) for a in p))
                     for p in host_parts]
            if ledger is not None and "lineage" in state:
                ledger.load_state(str(state["lineage"]))
            record_stage("parallel/sweep_resume", resumed_chunks=start)
    inputs_id = None
    if ledger is not None:
        from factormodeling_tpu_torch.resil.checkpoint import fingerprint

        # idempotent, and after any resume: the restored ledger already
        # holds this source, so the resumed ledger stays byte-equal
        inputs_id = ledger.source(
            fingerprint(*_jax_leaves(combo_weights, factors, settings)),
            "sweep_inputs")

    bounds = [(i, min(i + chunk_combos, c))
              for i in range(0, c, chunk_combos)]
    for idx in range(start, len(bounds)):
        lo, hi = bounds[idx]
        out = _combine_and_pnl(books, combo_weights[lo:hi], settings,
                               combo_batch)
        parts.append(out)
        if checkpoint is not None or ledger is not None:
            host_parts.append(SweepOutput(*(t.cpu().numpy() for t in out)))
        if ledger is not None:
            d = host_parts[-1]._asdict()
            ledger.edge(fingerprint(*[d[k] for k in sorted(d)]),
                        "sweep_chunk", [inputs_id], chunk=int(idx),
                        combos=[int(lo), int(hi)])
        if checkpoint is not None:
            checkpoint.maybe_save(
                idx, {"next_chunk": idx + 1,
                      "parts": [p._asdict() for p in host_parts],
                      **({"lineage": ledger.state()}
                         if ledger is not None else {})},
                meta=ck_meta)
    record_stage("parallel/sweep", combos=c, factors=int(factors.shape[0]),
                 combo_batch=combo_batch, chunked=chunk_combos,
                 resumed_chunks=start)
    if ledger is not None:
        from factormodeling_tpu_torch.obs.report import active_report

        rep = active_report()
        if rep is not None:
            rep.rows.extend(ledger.rows("parallel/sweep"))
    return SweepOutput(*(torch.cat(field) for field in zip(*parts)))


def make_sharded_manager_sweep(mesh, *, combo_axis: str = "combo",
                               combo_batch: int = 8):
    """The sweep over a 1-D mesh: ``sweep(factors, combo_weights, settings)
    -> SweepOutput``, full on every rank.

    The book pass runs factor-sharded over ``combo_axis`` (each rank builds
    the complete ``[D, N]`` books of its factors, the last rank's block
    padded with zero books when the axis does not divide ``F``), and the
    books are gathered once. The combos split over the same axis: each rank
    runs its ``C/S`` combos in chunks of ``combo_batch``, and the per-combo
    outputs are gathered. ``C`` must be divisible by the mesh size (pad
    with zero-weight combos otherwise). Every rank passes the same full
    inputs."""
    size = axis_size(mesh, combo_axis)
    rank = axis_index(mesh, combo_axis)
    dev = mesh_device(mesh)

    def sweep(factors, combo_weights, settings) -> SweepOutput:
        check_device(dev, factors, combo_weights)
        f = int(factors.shape[0])
        c = int(combo_weights.shape[0])
        if c % size:
            raise ValueError(
                f"{c} combos are not divisible by the mesh's "
                f"'{combo_axis}' axis ({size}); pad with zero-weight combos "
                f"or pick a mesh whose combo axis divides C")
        k = -(-f // size)
        if (size - 1) * k >= f:
            raise ValueError(f"{f} factors leave a rank of the mesh's "
                             f"'{combo_axis}' axis ({size}) no book to build")
        with obs_stage("sweep/books"):
            books, _, _ = compute_manager_weights(
                factors[rank * k:(rank + 1) * k], settings, device=dev)
            if books.shape[0] < k:
                books = torch.cat([books, books.new_zeros(
                    (k - books.shape[0],) + tuple(books.shape[1:]))])
            books = all_gather(books, mesh, combo_axis, dim=0)[:f]
        per = c // size
        with obs_stage("sweep/combo_pnl"):
            out = _combine_and_pnl(
                books, combo_weights[rank * per:(rank + 1) * per], settings,
                combo_batch)
            return SweepOutput(*(all_gather(t, mesh, combo_axis, dim=0)
                                 for t in out))

    # call statistics (obs.compile_log), under the JAX package's name
    wrapped = instrument_jit(
        sweep, "parallel/manager_sweep/" + entry_point_tag(
            tuple(zip(mesh.mesh_dim_names, mesh.shape)), combo_axis,
            combo_batch))
    wrapped.mesh = mesh
    return wrapped
