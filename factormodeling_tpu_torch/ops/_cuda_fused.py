"""The composite normalization chain ``group_neutralize(cs_zscore(x), gids,
G)`` in one pass: the CUDA kernel ``csrc/zscore_group.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel ``factormodeling_tpu/ops/_pallas_fused.py::
zscore_group_neutralize_fused``. Semantics are the composition's:
- z-score: NaN-skipping mean and std with ddof=0 per row of assets; a
  constant row gives 0/0 -> NaN;
- group mean: NaN-skipping over the group's valid z-values; cells with
  ``gid < 0`` (or ``gid >= G``) -> NaN; a group with no valid member -> NaN.

Bound on an H100: bytes. Each cell is read and written once and the ids
``[D, N]`` are read once per date: 1.5 GB at ``[50, 1260, 3000]`` in
float32, ~0.46 ms at 3.35 TB/s. The kernel runs one thread block per row
with the row and its ids in shared memory (up to 16384 assets; a wider row
keeps its z-values in the output row, through L1/L2), so the moments, the
z-values and the per-group sums are taken from one load of the row; the
group sums come from per-warp tables added in a fixed order, so the result
is deterministic. The TPU kernel's padding of the asset axis to the 128-lane
multiple has no counterpart: the block loops over any N.

On a CUDA tensor :func:`zscore_group_neutralize_fused` launches the kernel
or raises; on a CPU tensor it runs :func:`zscore_group_neutralize_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from factormodeling_tpu_torch import _build

__all__ = ["MAX_FUSED_GROUPS", "zscore_group_neutralize_fused",
           "zscore_group_neutralize_plain"]

#: most groups the kernel takes (its per-warp tables are 32 wide)
MAX_FUSED_GROUPS = 32

#: kernel launches since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: "fm_zscore_group_f32",
          torch.float64: "fm_zscore_group_f64"}


def zscore_group_neutralize_plain(x: torch.Tensor, gids: torch.Tensor,
                                  num_groups: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch over ``x [..., D, N]`` with
    ``gids [D, N]`` (broadcast over the leading axes)."""
    valid = ~torch.isnan(x)
    cnt = valid.sum(-1, keepdim=True).to(x.dtype)
    mean = torch.where(valid, x, 0.0).sum(-1, keepdim=True) / cnt
    dev = torch.where(valid, x - mean, 0.0)
    sigma = torch.sqrt((dev * dev).sum(-1, keepdim=True) / cnt)
    z = (x - mean) / sigma
    zvalid = ~torch.isnan(z)
    z0 = torch.where(zvalid, z, 0.0)
    acc = torch.full_like(x, float("nan"))
    for g in range(num_groups):
        sel = gids == g
        s_g = torch.where(sel, z0, 0.0).sum(-1, keepdim=True)
        c_g = (sel & zvalid).to(x.dtype).sum(-1, keepdim=True)
        acc = torch.where(sel, s_g / c_g, acc)
    return z - acc


def _lib(dtype):
    fn = getattr(_build.load("zscore_group"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def zscore_group_neutralize_fused(x: torch.Tensor, gids: torch.Tensor,
                                  num_groups: int) -> torch.Tensor:
    """``group_neutralize(cs_zscore(x), gids, num_groups)`` in one pass over
    ``x [..., D, N]`` with ``gids [D, N]`` shared across the leading axes:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not 0 < num_groups <= MAX_FUSED_GROUPS:
        raise ValueError(f"num_groups must be in (0, {MAX_FUSED_GROUPS}], "
                         f"got {num_groups}")
    if x.ndim < 2 or tuple(gids.shape) != tuple(x.shape[-2:]):
        raise ValueError(f"zscore_group_neutralize takes x [..., D, N] and "
                         f"gids [D, N], got {tuple(x.shape)} and "
                         f"{tuple(gids.shape)}")
    if x.device.type == "cpu" and gids.device.type == "cpu":
        return zscore_group_neutralize_plain(x, gids, num_groups)
    if x.device.type != "cuda" or gids.device != x.device:
        raise ValueError(f"zscore_group_neutralize: inputs on {x.device} and "
                         f"{gids.device}; both must be on one CUDA device or "
                         "on the CPU")
    if x.dtype not in _ENTRY:
        raise TypeError(f"zscore_group kernel takes float32 or float64, got "
                        f"{x.dtype}")
    d, n = x.shape[-2:]
    if not x.is_contiguous():
        raise ValueError("zscore_group kernel takes a contiguous x")
    g32 = gids.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib(x.dtype)(x.data_ptr(), g32.data_ptr(), out.data_ptr(),
                           x.numel() // n, d, n, int(num_groups), stream)
    if rc != 0:
        raise RuntimeError(f"zscore_group kernel launch failed: CUDA error "
                           f"{rc}")
    global launches
    launches += 1
    return out
