"""Multi-host bring-up and topology-aware meshes (port of
``factormodeling_tpu/parallel/cluster.py``).

The JAX package brings a cluster up with ``jax.distributed.initialize``;
the port's counterpart is ``torch.distributed.init_process_group``, one
process a device. Axis placement follows the JAX package's rule: the axis
with the least cross-shard traffic (factors, combos: contraction only)
spans hosts, the axis that exchanges the most (dates) stays inside a
host::

    mesh = make_hybrid_mesh(("factor", "date"))   # factor across hosts

One host (or a world of one) falls back to the balanced mesh, so the same
code runs everywhere.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.parallel.mesh import (balanced_mesh_shape,
                                                    ensure_world, make_mesh)

__all__ = ["initialize_cluster", "num_slices", "make_hybrid_mesh"]

#: the launcher variables that say a cluster is present (torchrun's)
_CLUSTER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize_cluster(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None, *,
                       backend: str | None = None) -> None:
    """Bring up the process group (one call per process, before any mesh).

    A no-op when a group is already up, or when no argument is given and
    no cluster environment (torchrun's ``MASTER_ADDR``/``WORLD_SIZE``/
    ``RANK``) is present: a single process then runs as a world of one
    when it builds a mesh. With arguments, ``coordinator_address`` is
    ``host:port`` (a TCP store) or a ``file://`` or ``tcp://`` URL, and
    ``num_processes``/``process_id`` are the world size and this rank.
    With a cluster environment and no arguments it initializes from it;
    a bring-up that was detected but failed raises. ``backend`` defaults
    to ``nccl`` with a card and ``gloo`` without."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        if None in explicit:
            raise ValueError("initialize_cluster needs coordinator_address, "
                             "num_processes and process_id together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes),
                                rank=int(process_id))
        return
    if not all(k in os.environ for k in _CLUSTER_ENV):
        return              # no cluster environment: a single process
    dist.init_process_group(backend, init_method="env://")


def num_slices() -> int:
    """Hosts in the world: the world size over the ranks a host
    (torchrun's ``LOCAL_WORLD_SIZE``); 1 with no group up or no launcher
    variable."""
    if not dist.is_initialized():
        return 1
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return max(world // max(local, 1), 1)


def make_hybrid_mesh(axis_names: tuple[str, ...] = ("factor", "date"),
                     dcn_axis: str | None = None, *, device=None):
    """A topology-aware mesh: ``dcn_axis`` (default: the first axis name)
    spans hosts, every other axis stays inside a host. One host gets the
    balanced mesh of :func:`~.mesh.make_mesh` with the same axis names.
    Ranks of one host are taken to be contiguous (as torchrun numbers
    them)."""
    from torch.distributed.device_mesh import DeviceMesh

    dcn_axis = dcn_axis or axis_names[0]
    if dcn_axis not in axis_names:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in {axis_names}")
    dev = resolve_device(device)
    ensure_world(dev)
    slices = num_slices()
    if slices <= 1:
        return make_mesh(axis_names, device=dev)
    world = dist.get_world_size()
    per_slice = world // slices
    others = [n for n in axis_names if n != dcn_axis]
    ici_shape = balanced_mesh_shape(per_slice, len(others)) if others else ()
    # hosts on the slowest dim, then each host's ranks over the other axes
    grid = torch.arange(world).reshape(slices, *(ici_shape or (per_slice,)))
    if others:
        order = [dcn_axis] + others
        grid = grid.permute([order.index(n) for n in axis_names])
    else:
        grid = grid.reshape(world)
    return DeviceMesh(dev.type, grid, mesh_dim_names=tuple(axis_names))
