"""Device meshes, placement descriptors and the collectives over them (port
of ``factormodeling_tpu/parallel/mesh.py``).

The JAX package declares shardings and lets its partitioner insert the
collectives. The port is multi-process SPMD on ``torch.distributed``: one
rank a device, every rank running the same Python, and every collective
written out through the wrappers here (:func:`all_gather` along a mesh
axis, :func:`all_reduce`, :func:`all_to_all`, and :func:`permute`, the
hand-off between neighbouring row blocks), which record each call into the
comms ledger (:mod:`factormodeling_tpu_torch.obs.comms`).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` carrying the JAX
package's axis names (``"factor"``, ``"date"``, ``"combo"``, ``"assets"``,
``"configs"``); each axis's collectives run on ``mesh.get_group(name)``.
:func:`panel_sharding`, :func:`stack_sharding` and :func:`replicated` give
:class:`Placement` descriptors (which tensor dim lies along which mesh
axis): :meth:`Placement.shard` cuts this rank's block out of a full host
tensor, :meth:`Placement.gather` puts the full tensor back together.

The input contract is the JAX package's multi-controller one: every rank
holds the same full host inputs, cuts its own block, and returns the full
(replicated) outputs. A mesh built when no process group is initialized
is a world of one (:func:`ensure_world`): an in-process ``HashStore``, so
no socket is opened, ``nccl`` on the card and ``gloo`` on the CPU. Single
card code then runs the mesh path as the JAX package's does on one device.
NCCL takes one rank a device, so on one card the mesh is a world of one;
several ranks run as spawned ``gloo`` worlds on the CPU, or one rank a card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.obs import comms as obs_comms

__all__ = ["ASSET_AXIS", "Placement", "all_gather", "all_reduce",
           "all_to_all", "axis_index", "axis_size", "balanced_mesh_shape",
           "block_index", "block_count", "ensure_world", "make_mesh",
           "mesh_device", "panel_sharding", "permute", "release_world",
           "replicated", "stack_sharding"]

#: canonical mesh-axis name for the sharded asset dimension ``N``
ASSET_AXIS = "assets"

# the world this module formed itself (a world of one), which
# release_world may take down again
_OWN_WORLD = {"formed": False}


def balanced_mesh_shape(n_devices: int, n_axes: int = 2) -> tuple[int, ...]:
    """Split ``n_devices`` into ``n_axes`` near-balanced integer factors,
    largest first (8 -> (4, 2); 6 -> (3, 2); primes -> (p, 1))."""
    shape = [1] * n_axes
    rem = int(n_devices)
    # peel prime factors, always assigning to the currently smallest axis
    f = 2
    factors = []
    while f * f <= rem:
        while rem % f == 0:
            factors.append(f)
            rem //= f
        f += 1
    if rem > 1:
        factors.append(rem)
    for p in sorted(factors, reverse=True):
        shape[int(np.argmin(shape))] *= p
    return tuple(sorted(shape, reverse=True))


def ensure_world(device) -> None:
    """Initialize a world of one when no process group is up: an
    in-process ``HashStore`` (no socket), ``nccl`` for a CUDA device and
    ``gloo`` otherwise. A world the caller initialized is left as it is."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        kwargs["device_id"] = torch.device(
            "cuda", dev.index if dev.index is not None
            else torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kwargs)
    _OWN_WORLD["formed"] = True


def release_world() -> None:
    """Destroy the world of one :func:`ensure_world` formed (a world the
    caller initialized is the caller's to destroy)."""
    if _OWN_WORLD["formed"] and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_WORLD["formed"] = False


def make_mesh(axis_names: tuple[str, ...] = ("factor", "date"),
              n_devices: int | None = None, *, device=None):
    """A ``DeviceMesh`` of the balanced shape over the world's ranks, one
    rank a device, with the given axis names (single names give a flat
    mesh, the sweep's ``("combo",)``). ``device=None`` is the card; with no
    process group up the mesh is a world of one (:func:`ensure_world`).
    ``n_devices`` must equal the world size: every rank takes part."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    ensure_world(dev)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices} but the world has {world} "
                         f"ranks; a port mesh spans every rank (one a "
                         f"device)")
    shape = balanced_mesh_shape(world, len(axis_names))
    return init_device_mesh(dev.type, shape,
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its card (the current CUDA
    device) for a CUDA mesh, the CPU otherwise."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim_of(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis (axes: {names})")
    return names.index(axis)


def axis_size(mesh, axis: str | None) -> int:
    """Ranks along ``axis`` (1 for None)."""
    if axis is None:
        return 1
    return int(mesh.shape[_dim_of(mesh, axis)])


def axis_index(mesh, axis: str | None) -> int:
    """This rank's coordinate along ``axis`` (0 for None)."""
    if axis is None:
        return 0
    return int(mesh.get_local_rank(axis))


def _block(n: int, size: int, index: int) -> slice:
    k = n // size
    return slice(index * k, (index + 1) * k)


# ----------------------------------------------------------- collectives


def _record(kind: str, mesh, axis: str, x: torch.Tensor,
            out_shape) -> int:
    size = axis_size(mesh, axis)
    obs_comms.record(kind, axis, x.numel() * x.element_size(), size,
                     int(np.prod(mesh.shape)) // size, out_shape)
    return size


def _wire(x: torch.Tensor) -> torch.Tensor:
    # bool travels as uint8: not every backend reduces or gathers bool
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The blocks of ``x`` held along mesh ``axis``, concatenated along
    ``dim`` in the axis's rank order (every rank's block has ``x``'s
    shape). Issued on a size-1 axis too, so a world of one exercises its
    communicator."""
    shape = list(x.shape)
    shape[dim] *= axis_size(mesh, axis)
    size = _record("all-gather", mesh, axis, x, shape)
    if obs_comms.record_only():
        return x.new_empty(shape)
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=mesh.get_group(axis))
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` reduced (``"sum"``, ``"max"``, ``"min"``) over mesh ``axis``;
    a new tensor, ``x`` untouched."""
    _record("all-reduce", mesh, axis, x, x.shape)
    if obs_comms.record_only():
        return x.clone()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    out = _wire(x).clone()
    dist.all_reduce(out, op=ops[op], group=mesh.get_group(axis))
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``x`` into the axis's size blocks along ``split_dim``, send
    block ``j`` to the axis's rank ``j``, and concatenate the blocks
    received along ``concat_dim`` in rank order (the reshard: ``[B, N/S]``
    column blocks become ``[B/S, N]`` row blocks with ``split_dim=0``,
    ``concat_dim=1``)."""
    shape = list(x.shape)
    size = axis_size(mesh, axis)
    shape[split_dim] //= size
    shape[concat_dim] *= size
    _record("all-to-all", mesh, axis, x, shape)
    if obs_comms.record_only():
        return x.new_empty(shape)
    sends = [c.contiguous() for c in torch.chunk(_wire(x), size,
                                                 dim=split_dim)]
    recvs = [torch.empty_like(s) for s in sends]
    dist.all_to_all(recvs, sends, group=mesh.get_group(axis))
    out = torch.cat(recvs, dim=concat_dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def block_count(mesh, axes) -> int:
    """Row blocks along ``axes`` (a tuple of mesh axis names, the first
    major): the product of their sizes."""
    return int(np.prod([axis_size(mesh, a) for a in axes], dtype=np.int64))


def block_index(mesh, axes) -> int:
    """This rank's row block along ``axes`` (mixed radix, the first axis
    major): the order :func:`all_gather` over the last axis, then the one
    before, concatenates blocks in."""
    b = 0
    for a in axes:
        b = b * axis_size(mesh, a) + axis_index(mesh, a)
    return b


def _rank_of_block(mesh, axes, b: int) -> int:
    """The global rank holding row block ``b`` along ``axes`` whose
    coordinates on every other axis are this rank's."""
    names = tuple(mesh.mesh_dim_names or ())
    coord = [int(c) for c in mesh.get_coordinate()]
    for a in reversed(axes):
        size = axis_size(mesh, a)
        coord[names.index(a)] = b % size
        b //= size
    return int(mesh.mesh[tuple(coord)])


def permute(x: torch.Tensor, mesh, axes, pairs) -> torch.Tensor | None:
    """The collective-permute between row blocks along ``axes``: for each
    ``(src, dst)`` of ``pairs`` (block indices, :func:`block_index`) the
    rank holding block ``src`` sends ``x`` to the one holding ``dst`` with
    its other coordinates; returns what this rank received (``x``'s shape
    and dtype), None when it is no destination. Ranks in no pair issue
    nothing. The ledger charges one operand a pair and group (kind
    ``collective-permute``, byte factor 1), what moves."""
    pairs = [(int(a), int(b)) for a, b in pairs]
    blocks = block_count(mesh, axes)
    obs_comms.record("collective-permute", ",".join(axes),
                     x.numel() * x.element_size(), len(pairs),
                     int(np.prod(mesh.shape)) // max(blocks, 1), x.shape)
    if not pairs:
        return None
    me = block_index(mesh, axes)
    dst = [b for a, b in pairs if a == me]
    src = [a for a, b in pairs if b == me]
    if obs_comms.record_only():
        return x.new_empty(x.shape) if src else None
    ops, out = [], None
    if dst:
        ops.append(dist.P2POp(dist.isend, _wire(x),
                              _rank_of_block(mesh, axes, dst[0])))
    if src:
        out = torch.empty_like(_wire(x))
        ops.append(dist.P2POp(dist.irecv, out,
                              _rank_of_block(mesh, axes, src[0])))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if out is not None and x.dtype == torch.bool:
        out = out.to(torch.bool)
    return out


# ------------------------------------------------------------ placements


class Placement(NamedTuple):
    """Which mesh axis each tensor dim lies along (``None``: whole on
    every rank); dims past ``dims`` are whole. The port's counterpart of a
    ``NamedSharding`` with its ``PartitionSpec``."""

    mesh: object
    dims: tuple

    def _axes(self, ndim: int):
        return [(d, a) for d, a in enumerate(self.dims[:ndim])
                if a is not None]

    def check(self, shape) -> None:
        """Raise unless every sharded dim divides by its axis's size."""
        for d, a in self._axes(len(shape)):
            if shape[d] % axis_size(self.mesh, a):
                raise ValueError(f"dim {d} ({shape[d]}) is not divisible "
                                 f"by the mesh's {a!r} axis "
                                 f"({axis_size(self.mesh, a)})")

    def block(self, x):
        """This rank's block of ``x`` (a host array, a memory map or a
        tensor), sliced where it lies: nothing is copied."""
        self.check(x.shape)
        idx = [slice(None)] * len(x.shape)
        for d, a in self._axes(len(x.shape)):
            idx[d] = _block(x.shape[d], axis_size(self.mesh, a),
                            axis_index(self.mesh, a))
        return x[tuple(idx)]

    def shard(self, x, device=None) -> torch.Tensor:
        """This rank's block of the full host array or tensor ``x``, on
        ``device`` (default: the mesh's device for this rank)."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        dev = mesh_device(self.mesh) if device is None else device
        return self.block(t).to(dev).contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full tensor from this rank's block: one :func:`all_gather`
        a sharded dim, the last dim first."""
        for d, a in reversed(self._axes(x.ndim)):
            x = all_gather(x, self.mesh, a, dim=d)
        return x


def panel_sharding(mesh, date_axis: str | None = "date",
                   asset_axis: str | None = None) -> Placement:
    """A ``[D, N]`` panel: dates along ``date_axis``, assets whole unless
    ``asset_axis`` is given (either may be None for a mesh that lacks
    it)."""
    return Placement(mesh, (date_axis, asset_axis))


def stack_sharding(mesh, factor_axis: str | None = "factor",
                   date_axis: str | None = "date",
                   asset_axis: str | None = None) -> Placement:
    """An ``[F, D, N]`` stack: factors x dates over the mesh, plus
    optionally the asset axis on ``N``."""
    return Placement(mesh, (factor_axis, date_axis, asset_axis))


def replicated(mesh) -> Placement:
    return Placement(mesh, ())
