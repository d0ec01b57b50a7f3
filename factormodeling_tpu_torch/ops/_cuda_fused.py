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
float32, ~0.46 ms at 3.35 TB/s (0.16 ms at path 4's ``[50, 1332, 1000]``).
Rows of up to :data:`REG_WIDTH` assets take the register form
(:func:`kernel_layout`): a team of warps owns a row and each thread keeps
its cells and their group ids in registers; the next row and its ids
arrive in shared memory by bulk copies (the TMA) while the current one is
reduced; each lane adds its cells into its own column of a per-warp group
table, so a cell costs the same for any number of groups; sums run in a
fixed order, so the result is deterministic; the grid is persistent and
walks the rows date-major. Wider rows, and rows whose staging buffers and
group tables would pass a block's opt-in shared memory (float64 with ~30
groups or more), keep the block-a-row forms: the row and its ids in shared
memory (up to :data:`SMEM_WIDTH`), else the z-values in the output row. The TPU kernel's padding of the asset axis to the
128-lane multiple has no counterpart.

On a CUDA tensor :func:`zscore_group_neutralize_fused` launches the kernel
or raises; on a CPU tensor it runs :func:`zscore_group_neutralize_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from factormodeling_tpu_torch import _build

__all__ = ["MAX_FUSED_GROUPS", "REG_WIDTH", "SMEM_WIDTH", "kernel_layout",
           "zscore_group_neutralize_fused", "zscore_group_neutralize_plain"]

#: most groups the kernel takes (lane g of a warp keeps group g's mean)
MAX_FUSED_GROUPS = 32
#: the widest row of the register form, and of the shared-memory form (the
#: source's ``REG_WIDTH``, ``SMEM_WIDTH``)
REG_WIDTH, SMEM_WIDTH = 8192, 16384
#: cells a thread of the register form, in the order tried (``ZG_CELLS``),
#: and the most warps a team (a block's, ``ZG_WARPS``)
CELLS, TEAM_MAX_WARPS = (8, 16, 24, 32), 8
#: a block's opt-in shared memory on sm_90 (``ZG_SMEM_OPTIN``)
SMEM_OPTIN = 232448

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


def _reg_static_bytes(itemsize: int) -> int:
    """The register form's static shared memory (``RegStatic``: the teams'
    mbarriers, two exchange slots of sums and of counts, two of valid
    counts), rounded up to the 128-byte start of the dynamic part."""
    w = TEAM_MAX_WARPS
    raw = 8 * w + 2 * 2 * w * (MAX_FUSED_GROUPS + 1) * itemsize + 2 * w * 4
    return -(-raw // 128) * 128


def kernel_layout(n: int, num_groups: int, itemsize: int) -> dict:
    """The form the kernel takes for rows of ``n`` assets, ``num_groups``
    groups and elements of ``itemsize`` bytes, as the source's
    ``reg_layout`` and ``launch`` choose it: ``registers`` (a team of
    ``team_warps`` warps a row, ``cells`` cells a thread, ``teams`` teams a
    block of 256 threads, ``smem_bytes`` of dynamic shared memory: each
    team's staging buffer for a row and its ids, each warp's group table of
    a sum and a count for every group and one for no group) for
    ``n <= REG_WIDTH`` where that and the static part fit
    :data:`SMEM_OPTIN`; else ``shared`` (the row in shared memory) up to
    ``SMEM_WIDTH``, else ``wide``."""
    warps = 1
    while warps <= TEAM_MAX_WARPS:
        for cells in CELLS:
            if 32 * warps * cells >= n:
                teams = TEAM_MAX_WARPS // warps
                smem = (teams * (-(-n // 4) * 4) * (itemsize + 4)
                        + TEAM_MAX_WARPS * (num_groups + 1) * 32
                        * 2 * itemsize)
                if _reg_static_bytes(itemsize) + smem <= SMEM_OPTIN:
                    return dict(form="registers", team_warps=warps,
                                cells=cells, teams=teams, smem_bytes=smem)
                return dict(form="shared", team_warps=8, cells=None, teams=1,
                            smem_bytes=None)
        warps *= 2
    return dict(form="shared" if n <= SMEM_WIDTH else "wide", team_warps=8,
                cells=None, teams=1, smem_bytes=None)


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
