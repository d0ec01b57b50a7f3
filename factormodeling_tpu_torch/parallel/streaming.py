"""Out-of-core factor streaming: score and blend factor stacks larger than
the card's memory by chunking the factor axis (port of
``factormodeling_tpu/parallel/streaming.py``).

At the north-star scale (200 factors x 5040 dates x 5000 assets, float32)
the stack is ~20 GB. Dates and assets are needed whole (rolling windows,
cross-sections), but factors are independent, so factor chunks stream
through the card:

  pass 1  per-chunk :func:`~factormodeling_tpu_torch.metrics.daily_factor_stats`
          (K1 on C·D rows on the card) -> concat along F -> any
          [D, F]-consuming selection
  pass 2  per-chunk normalize + weighted contraction, accumulated into the
          composite signal [D, N]

or both in one pass for factorwise selectors
(:func:`streamed_linear_research`).

Chunks come from a *chunk source*, ``source(i) -> float[C_i, D, N]``:

- **host sources** (``fuse_source=False``): the source returns a host
  array (a slice of a host stack, :func:`host_array_source`; a
  memory-mapped chunk file, ``io.disk_chunk_source``). Each chunk is
  copied into a pinned staging buffer and moved to the card on a side copy
  stream; an event orders the compute after the copy, and a staging buffer
  is written again only after its last copy has finished. With
  ``prefetch`` a one-thread loader stages up to ``prefetch`` chunks ahead,
  so at most ``prefetch + 1`` chunks are in flight. Pinning and the copy
  stream are used only when the target device is CUDA.
- **device sources** (``fuse_source=True``): the source makes the chunk
  on the device from its index (e.g. from a seeded
  ``torch.Generator(device=...)``), so the chunk never crosses the link.

Serial, prefetched and device-sourced runs of the same chunks give bitwise
the same results: the compute on each chunk is the same.

The per-chunk callables are kept in a bounded LRU (the serving layer's
per-(bucket, rung) steps share it).

With ``mesh=`` (a mesh with a ``date_axis``, one rank a device) streaming
is date-sharded: every rank streams every factor chunk but computes on its
own dates only, and the per-date results are gathered over the date axis
at the end of the run (``parallel/mesh.py``'s collectives, charged to the
function's ``streaming/*`` stage). A chunk may arrive whole or as this
rank's date block (:func:`host_array_source` / ``io.disk_chunk_source``
with ``sharding=chunk_sharding(mesh)`` read only that block from the
host); the scoring's shift reads earlier dates, so a block chunk is
gathered over the date axis before it is scored. Each row is computed as
the unsharded run computes it, so ``streamed_factor_stats`` gives bitwise
the unsharded stats. The panels are passed whole, as every rank holds the
same inputs.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from factormodeling_tpu_torch import ops
from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.metrics.factor_metrics import (
    daily_factor_stats, daily_factor_stats_dates)
from factormodeling_tpu_torch.obs.compile_log import (entry_point_tag,
                                                      instrument_jit)
from factormodeling_tpu_torch.obs.report import record_stage
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.parallel.mesh import (Placement, _block,
                                                    all_gather, axis_index,
                                                    axis_size, mesh_device)

__all__ = ["chunk_sharding", "chunk_slices", "clear_streaming_cache",
           "host_array_source", "set_kernel_cache_size",
           "streaming_cache_stats", "streamed_factor_stats",
           "streamed_linear_research", "streamed_weighted_composite"]

# An entry is the built per-chunk callable, keyed on (source, config): the
# JAX package caches one jitted executable per key; the port has no jit, so
# a miss is one build and the counters read as the JAX package's. A cached
# callable of a device source holds the source, and with it whatever the
# source captured, so the cache is bounded.

_KERNEL_CACHE_SIZE = 16
_kernel_cache: "dict[tuple, object]" = {}
_cache_stats = {"hits": 0, "misses": 0, "evictions": 0}


def clear_streaming_cache() -> None:
    """Drop every cached callable and reset the counters."""
    _kernel_cache.clear()
    _cache_stats.update(hits=0, misses=0, evictions=0)


def streaming_cache_stats() -> dict:
    """``{"hits", "misses", "evictions", "size", "capacity"}`` since the
    last :func:`clear_streaming_cache`."""
    return {**_cache_stats, "size": len(_kernel_cache),
            "capacity": _KERNEL_CACHE_SIZE}


def set_kernel_cache_size(n: int) -> int:
    """Rebound the LRU (default 16). Shrinking evicts the least recently
    used entries at once, counted as evictions. Returns the previous
    capacity."""
    global _KERNEL_CACHE_SIZE
    if n < 1:
        raise ValueError(f"kernel cache size must be >= 1, got {n}")
    prev, _KERNEL_CACHE_SIZE = _KERNEL_CACHE_SIZE, int(n)
    _evict_to_cap()
    return prev


def _evict_to_cap() -> None:
    """Drop least-recently-used entries until the cache fits the cap (dict
    order is recency: `_cached_kernel` re-inserts on every hit)."""
    while len(_kernel_cache) > _KERNEL_CACHE_SIZE:
        _kernel_cache.pop(next(iter(_kernel_cache)))
        _cache_stats["evictions"] += 1


def _cached_kernel(source, config, build, *, name=None,
                   expected_signatures=None):
    """``build()``'s callable for ``(source, config)``, LRU-bounded;
    ``source`` (None for the serving layer) takes part in the key by
    identity, ``config`` by value. Entries carry call statistics
    (``obs.compile_log.instrument_jit``) under
    ``streaming/<kind>/kernel/<tag of the config>``, or ``name`` (the
    serving layer's ``serve/bucket/...`` and ``online/bucket/...``
    entries, with their pinned ``expected_signatures``)."""
    key = (source, config)
    fn = _kernel_cache.pop(key, None)
    if fn is None:
        fn = instrument_jit(build(),
                            name or f"streaming/{config[0]}/kernel/"
                                    f"{entry_point_tag(config)}",
                            expected_signatures=expected_signatures)
        _cache_stats["misses"] += 1
    else:
        _cache_stats["hits"] += 1
    _kernel_cache[key] = fn  # (re)insert at the end: dict order is recency
    _evict_to_cap()
    return fn


def chunk_slices(n_factors: int, chunk: int) -> list[slice]:
    """Contiguous factor-axis slices of width ``chunk`` (last may be short)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return [slice(i, min(i + chunk, n_factors))
            for i in range(0, n_factors, chunk)]


def chunk_sharding(mesh, date_axis: str = "date") -> Placement:
    """The placement of a streamed ``[C, D, N]`` chunk on a date-sharded
    mesh: factor chunks stream serially, dates span the ranks."""
    return Placement(mesh, (None, date_axis, None))


def host_array_source(stack, chunk: int, sharding=None):
    """``(source, slices)`` for a host-resident ``float[F, D, N]`` stack:
    ``source(i)`` is chunk ``i``'s host view; the streamed functions stage
    it to the device (module docs). With ``sharding`` (a
    :func:`chunk_sharding`) the view is this rank's date block only, so
    only that block crosses to the device."""
    slices = chunk_slices(stack.shape[0], chunk)
    if sharding is not None:
        return (lambda i: sharding.block(stack[slices[i]])), slices
    return (lambda i: stack[slices[i]]), slices


class _Dates:
    """This rank's share of a date-sharded streaming run (module docs);
    ``None`` mesh: the whole run on one device."""

    def __init__(self, mesh, date_axis: str, n_dates: int):
        self.mesh, self.axis, self.n = mesh, date_axis, n_dates
        size = axis_size(mesh, date_axis)
        if n_dates % size:
            raise ValueError(f"{n_dates} dates are not divisible by the "
                             f"mesh's '{date_axis}' axis ({size})")
        self.own = _block(n_dates, size, axis_index(mesh, date_axis))

    def whole(self, fac: torch.Tensor) -> torch.Tensor:
        """The chunk on every date (a block chunk gathered)."""
        if fac.shape[1] == self.n:
            return fac
        return all_gather(fac, self.mesh, self.axis, dim=1)

    def mine(self, fac: torch.Tensor) -> torch.Tensor:
        """This rank's dates of the chunk (a block chunk as it came)."""
        return fac[:, self.own] if fac.shape[1] == self.n else fac

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(x, self.mesh, self.axis, dim=dim)


def _run_device(mesh, device):
    return mesh_device(mesh) if mesh is not None else resolve_device(device)


class _Stager:
    """Moves host chunks to the target device. On CUDA: a ring of ``slots``
    pinned staging buffers and a side copy stream; chunk ``i`` goes through
    slot ``i % slots``, whose previous copy must have finished before the
    host writes the buffer again, and the consumer's stream waits on the
    chunk's copy event. The device tensor is allocated on the copy stream
    and recorded on the consumer's, so the allocator does not hand its
    memory out again before the compute is done. Elsewhere: a plain copy."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slots = slots
        self.pinned: list = [None] * slots
        self.copied: list = [None] * slots
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def stage(self, i: int, chunk):
        """Chunk ``i`` (a host array, or a tensor already on the device) as
        ``(tensor, event)``; the event is None when no copy is pending."""
        if (isinstance(chunk, torch.Tensor)
                and chunk.device.type == self.device.type):
            return chunk, None
        host = (chunk.cpu().numpy() if isinstance(chunk, torch.Tensor)
                else np.asarray(chunk))
        if not self.cuda:
            return torch.tensor(host, device=self.device), None
        slot = i % self.slots
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        buf = self.pinned[slot]
        want = torch.from_numpy(np.empty(0, host.dtype)).dtype
        if buf is None or buf.numel() < host.size or buf.dtype != want:
            buf = self.pinned[slot] = torch.empty(host.size, dtype=want,
                                                  pin_memory=True)
        view = buf[:host.size].view(host.shape)
        view.numpy()[...] = host
        with torch.cuda.stream(self.stream):
            out = torch.empty(host.shape, dtype=want, device=self.device)
            out.copy_(view, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.copied[slot] = ev
        return out, ev

    def take(self, staged) -> torch.Tensor:
        """The staged tensor, ordered after its copy on the caller's
        stream."""
        out, ev = staged
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            out.record_stream(cur)
        return out


def _prefetched(source, n_chunks: int, prefetch: int, stager: _Stager,
                start: int = 0):
    """Iterate the staged chunks ``start..n_chunks-1``, with up to
    ``prefetch`` chunks read and staged ahead on a one-thread loader."""
    if prefetch <= 0:
        for i in range(start, n_chunks):
            yield stager.take(stager.stage(i, source(i)))
        return

    def load(i):
        return stager.stage(i, source(i))

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = [pool.submit(load, i)
                   for i in range(start, min(start + prefetch, n_chunks))]
        for i in range(start, n_chunks):
            nxt = i + len(pending)
            if nxt < n_chunks:
                pending.append(pool.submit(load, nxt))
            yield stager.take(pending.pop(0).result())


def _chunks(source, n_chunks: int, *, fuse_source: bool, prefetch: int,
            device: torch.device, start: int = 0):
    """The device chunks ``start..n_chunks-1``: a device source called in
    order, or a host source staged (module docs)."""
    if fuse_source:
        return (source(i) for i in range(start, n_chunks))
    return _prefetched(source, n_chunks, prefetch,
                       _Stager(device, max(int(prefetch), 0) + 1),
                       start=start)


def _placed(x, device):
    if x is None or isinstance(x, torch.Tensor):
        if x is not None and x.device.type != device.type:
            raise ValueError(f"streaming asked to run on {device}, got a "
                             f"panel on {x.device}")
        return x
    return torch.as_tensor(np.asarray(x), device=device)


def streamed_factor_stats(source: Callable, n_chunks: int, returns, *,
                          shift_periods: int = 1, universe=None,
                          stats: tuple = ("ic", "rank_ic", "factor_return"),
                          fuse_source: bool = False, prefetch: int = 0,
                          mesh=None, date_axis: str = "date",
                          checkpoint=None, lineage=None,
                          device=None) -> dict:
    """Pass 1: per-(factor, date) stats for a streamed stack.

    Returns the :func:`daily_factor_stats` dict with every tensor
    ``[F_total, D]``, factors ordered by chunk index. ``returns`` and
    ``universe`` are tensors on ``device`` (None: the card; ``"cpu"``
    asks for the CPU) or host arrays, moved there once.
    ``fuse_source=True``: ``source`` is a device source (module docs);
    ``prefetch`` (host sources) stages that many chunks ahead.

    ``checkpoint``: optional
    :class:`~factormodeling_tpu_torch.resil.checkpoint.Checkpointer` —
    after every chunk (thinned by its ``every``) the per-chunk results
    snapshot atomically, and a matching snapshot on entry resumes from the
    first unprocessed chunk, bitwise the uninterrupted run. A snapshot
    whose config (chunk count, stats, shift, shapes) or input content
    (returns/universe fingerprints, and chunk 0's for host sources)
    differs is skipped with a warning. Chunks past the first are not
    re-verified.

    ``lineage``: ``True`` or a shared
    :class:`~factormodeling_tpu_torch.obs.lineage.LineageLedger` records
    one ``stream_chunk`` edge per chunk; the ledger rides the checkpoint,
    and its rows land on the active report at completion. Off by default.

    ``mesh`` / ``date_axis``: date-sharded streaming (module docs); the
    run's device is the mesh's. Each rank's checkpoint holds its own
    date blocks, so give each rank its own checkpoint path.
    """
    if n_chunks <= 0:
        raise ValueError(f"n_chunks must be positive, got {n_chunks}")
    dev = _run_device(mesh, device)
    returns, universe = _placed(returns, dev), _placed(universe, dev)
    one = _stats_kernel(source if fuse_source else None, shift_periods,
                        tuple(stats))
    dates = (None if mesh is None
             else _Dates(mesh, date_axis, int(returns.shape[0])))

    ledger = inputs_id = _lfp = None
    if lineage:
        from factormodeling_tpu_torch.obs.lineage import LineageLedger
        from factormodeling_tpu_torch.resil.checkpoint import \
            fingerprint as _lfp

        ledger = (lineage if isinstance(lineage, LineageLedger)
                  else LineageLedger())
    start, parts = 0, []
    ck_meta = None
    if checkpoint is not None:
        from factormodeling_tpu_torch.resil.checkpoint import fingerprint

        ck_meta = {"entry": "streamed_factor_stats",
                   "config": [int(n_chunks), list(stats),
                              int(shift_periods), bool(fuse_source),
                              [int(v) for v in returns.shape]],
                   # chunks from other inputs must never concatenate into
                   # one result
                   "inputs": fingerprint(returns, universe)}
        if not fuse_source:
            # re-reading one chunk at resume catches a regenerated or
            # repaired source file; device sources stay config-only
            ck_meta["chunk0"] = fingerprint(source(0))
        got = checkpoint.resume(expect_meta=ck_meta)
        if got is not None:
            state, _ = got
            start = int(state["next_chunk"])
            parts = list(state["parts"])
            if ledger is not None and "lineage" in state:
                ledger.load_state(str(state["lineage"]))
            record_stage("streaming/resume", entry="streamed_factor_stats",
                         resumed_chunks=start)
    if ledger is not None:
        # idempotent and after any resume
        inputs_id = ledger.source(_lfp(returns, universe), "stream_inputs")

    def _keep(part):
        # checkpointing fetches each part to the host once, as it lands
        if checkpoint is not None:
            part = {k: v.cpu().numpy() for k, v in part.items()}
        parts.append(part)

    chunks = _chunks(source, n_chunks, fuse_source=fuse_source,
                             prefetch=prefetch, device=dev, start=start)
    for i, fac in enumerate(chunks, start=start):
        if dates is None:
            _keep(one(fac, returns, universe))
        else:
            with obs_stage("streaming/stats"):
                fac = dates.whole(fac)
            _keep(one(fac, returns, universe, dates.own))
        if ledger is not None:
            # edge before the save, so the snapshot carries its own chunk
            p = parts[-1]
            ledger.edge(_lfp(*[p[k] for k in sorted(p)]), "stream_chunk",
                        [inputs_id], chunk=int(i))
        if checkpoint is not None:
            state = {"next_chunk": i + 1, "parts": parts}
            if ledger is not None:
                state["lineage"] = ledger.state()
            checkpoint.maybe_save(i, state, meta=ck_meta)
    record_stage("streaming/stats", chunks=n_chunks, fused=fuse_source,
                 prefetch=prefetch, cache=streaming_cache_stats())
    if ledger is not None:
        from factormodeling_tpu_torch.obs.report import active_report

        rep = active_report()
        if rep is not None:
            rep.rows.extend(ledger.rows("streaming/stats"))
    out = {k: torch.cat([torch.as_tensor(p[k], device=dev) for p in parts])
           for k in parts[0]}
    if dates is not None:
        with obs_stage("streaming/stats"):
            out = {k: dates.gather(v, 1) for k, v in out.items()}
    return out


def _stats_kernel(fused_source, shift_periods: int, stats: tuple):
    """One cached per-chunk callable per (source, config); a device source
    takes part in the key by identity, as the JAX package's fused kernels
    do (its hits and misses count alike)."""

    def build():
        def kernel(fac, returns, universe, dates=None):
            # dates: score those dates only (a date-sharded run's rank)
            with obs_stage("streaming/stats"):
                if dates is not None:
                    return daily_factor_stats_dates(
                        fac, returns, dates, shift_periods=shift_periods,
                        universe=universe, stats=stats)
                return daily_factor_stats(fac, returns,
                                          shift_periods=shift_periods,
                                          universe=universe, stats=stats)

        return kernel

    return _cached_kernel(fused_source, ("stats", shift_periods, stats),
                          build)


def _apply_transform(fac, universe, transform):
    if transform == "zscore":
        return ops.cs_zscore(fac, universe=universe)
    if transform == "rank":
        return ops.cs_rank(fac, universe=universe)
    if transform == "none":
        return fac
    return transform(fac)


def _check_transform(transform) -> None:
    if isinstance(transform, str) and transform not in ("zscore", "rank",
                                                        "none"):
        raise ValueError(f"unknown transform {transform!r}; valid: "
                         "'zscore', 'rank', 'none', or a callable")


def streamed_linear_research(source: Callable, n_chunks: int, returns, *,
                             chunk_weight_fn: Callable,
                             transform: Callable | str = "zscore",
                             shift_periods: int = 1, universe=None,
                             stats: tuple = ("ic", "rank_ic",
                                             "factor_return"),
                             fuse_source: bool = False, prefetch: int = 0,
                             mesh=None, date_axis: str = "date",
                             device=None) -> dict:
    """SINGLE-pass scoring + selection + blend for factor-separable
    selectors.

    A selector whose daily weights are factorwise up to one global
    per-date normalizer,

        w[f, d] = u[f, d] / sum_g u[g, d],   u[f, d] = fn(stats of factor f)

    (factor momentum: ``u = clip(window-sum of factor returns, 0, cap)``),
    lets every chunk be visited once: the chunk's stats, its unnormalized
    weights ``u`` and its contribution ``sum_f u[f, d] *
    transform(chunk)[f, d, n]`` come out while the chunk is resident, and
    the normalizer divides at the end:

        composite = (sum_chunks partial) / (sum_chunks sum_f u)

    — algebraically the two-pass result, at half the stack traffic.

    Args:
      chunk_weight_fn: ``fn(stats_dict) -> float[C, D]`` mapping a chunk's
        :func:`daily_factor_stats` dict (tensors ``[C, D]``) to that
        chunk's unnormalized daily weights; it sees only the chunk's own
        factors. Pass a stable callable: the per-chunk callables are
        cached on its identity.
      Other args as :func:`streamed_factor_stats` /
        :func:`streamed_weighted_composite`.

    Returns a dict: the requested per-date ``stats`` tensors ``[F, D]``,
    ``"unnormalized_weights"`` ``[F, D]``, ``"weight_norm"`` ``[D]`` and
    ``"composite"`` ``[D, N]`` (zero on dates with no positive weight).
    With ``mesh`` (module docs) each chunk's ``[C, D]`` stats are gathered
    over the date axis before ``chunk_weight_fn`` (its windows read every
    date), and the composite at the end.
    """
    if n_chunks <= 0:
        raise ValueError(f"n_chunks must be positive, got {n_chunks}")
    _check_transform(transform)
    dev = _run_device(mesh, device)
    returns, universe = _placed(returns, dev), _placed(universe, dev)
    dates = (None if mesh is None
             else _Dates(mesh, date_axis, int(returns.shape[0])))
    one = _linear_research_kernel(source if fuse_source else None,
                                  chunk_weight_fn, transform, shift_periods,
                                  tuple(stats), dates)
    stat_parts, u_parts, total, norm = [], [], None, None
    chunks = _chunks(source, n_chunks, fuse_source=fuse_source,
                             prefetch=prefetch, device=dev)
    for fac in chunks:
        stats_d, u, part = one(fac, returns, universe)
        stat_parts.append(stats_d)
        u_parts.append(u)
        total = part if total is None else total + part
        s = u.sum(dim=0)
        norm = s if norm is None else norm + s
    record_stage("streaming/linear_research", chunks=n_chunks,
                 fused=fuse_source, prefetch=prefetch,
                 cache=streaming_cache_stats())
    out = {k: torch.cat([p[k] for p in stat_parts])
           for k in stat_parts[0]}
    out["unnormalized_weights"] = torch.cat(u_parts)
    out["weight_norm"] = norm
    if dates is not None:
        with obs_stage("streaming/linear_research"):
            total = dates.gather(total, 0)
    safe = torch.where(norm > 0, norm, 1.0)
    out["composite"] = torch.where((norm > 0)[:, None],
                                   total / safe[:, None], 0.0)
    return out


def _linear_research_kernel(fused_source, chunk_weight_fn, transform,
                            shift_periods: int, stats: tuple, dates=None):
    """One cached per-chunk callable per (source, config, date share): a
    date-sharded rank scores and blends its own dates (module docs)."""
    def build():
        def kernel(fac, returns, universe):
            with obs_stage("streaming/linear_research"):
                if dates is None:
                    stats_d = daily_factor_stats(
                        fac, returns, shift_periods=shift_periods,
                        universe=universe, stats=stats)
                    u = chunk_weight_fn(stats_d)                  # [C, D]
                    z = _apply_transform(fac, universe, transform)
                    part = torch.einsum("fd,fdn->dn", u, torch.nan_to_num(z))
                    return stats_d, u, part
                whole = dates.whole(fac)
                own = dates.own
                mine = daily_factor_stats_dates(
                    whole, returns, own, shift_periods=shift_periods,
                    universe=universe, stats=stats)
                stats_d = {k: dates.gather(v, 1) for k, v in mine.items()}
                u = chunk_weight_fn(stats_d)                      # [C, D]
                z = _apply_transform(
                    dates.mine(fac),
                    None if universe is None else universe[own], transform)
                part = torch.einsum("fd,fdn->dn", u[:, own],
                                    torch.nan_to_num(z))
                return stats_d, u, part

        return kernel

    # the entry's closure holds `dates`, so its mesh's id is not reused
    # while the entry lives
    share = None if dates is None else (id(dates.mesh), dates.axis,
                                        dates.n, dates.own.start)
    return _cached_kernel(fused_source, ("linear_research", chunk_weight_fn,
                                         transform, shift_periods, stats,
                                         share), build)


def streamed_weighted_composite(source: Callable,
                                chunk_weights: Sequence, *,
                                transform: Callable | str = "zscore",
                                universe=None, fuse_source: bool = False,
                                prefetch: int = 0, mesh=None,
                                date_axis: str = "date",
                                device=None) -> torch.Tensor:
    """Pass 2: ``sum_f w[f, d] * transform(stack)[f, d, n]`` streamed.

    Args:
      source: ``source(i) -> float[C_i, D, N]`` chunk source (same order as
        pass 1).
      chunk_weights: per-chunk ``float[C_i, D]`` weight blocks. NaN cells
        of the transformed chunk contribute 0, as the dense blend's
        ``nan_to_num`` combine.
      transform: per-chunk normalization before the contraction: "zscore"
        (per-date cross-sectional), "rank" ([0, 1] cross-sectional rank),
        "none", or any callable ``float[C, D, N] -> float[C, D, N]``.
      fuse_source / prefetch / device / mesh / date_axis: as
        :func:`streamed_factor_stats` (with a mesh each rank blends its own
        dates and the composite is gathered at the end).

    Returns the composite ``float[D, N]``.
    """
    _check_transform(transform)
    chunk_weights = list(chunk_weights)
    if not chunk_weights:
        raise ValueError("chunk_weights is empty")
    dev = _run_device(mesh, device)
    universe = _placed(universe, dev)
    dates = None
    if mesh is not None:
        dates = _Dates(mesh, date_axis, int(np.shape(chunk_weights[0])[1]))
        if universe is not None:
            universe = universe[dates.own]
    one = _composite_kernel(source if fuse_source else None, transform)
    total = None
    chunks = _chunks(source, len(chunk_weights),
                             fuse_source=fuse_source, prefetch=prefetch,
                             device=dev)
    for w, fac in zip(chunk_weights, chunks):
        w = _placed(w, dev)
        if dates is not None:
            w, fac = w[:, dates.own], dates.mine(fac)
        part = one(fac, w, universe)
        total = part if total is None else total + part
    if dates is not None:
        with obs_stage("streaming/composite"):
            total = dates.gather(total, 0)
    record_stage("streaming/composite", chunks=len(chunk_weights),
                 fused=fuse_source, prefetch=prefetch,
                 cache=streaming_cache_stats())
    return total


def _composite_kernel(fused_source, transform):
    """One cached per-chunk callable per (source, transform)."""

    def build():
        def kernel(fac, w, universe):
            with obs_stage("streaming/composite"):
                return torch.einsum(
                    "fd,fdn->dn", w,
                    torch.nan_to_num(_apply_transform(fac, universe,
                                                      transform)))

        return kernel

    return _cached_kernel(fused_source, ("composite", transform), build)
