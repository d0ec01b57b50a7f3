"""Rank-IC after the sort: the CUDA kernel ``csrc/rank_ic.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel
``factormodeling_tpu/metrics/_pallas_rank_ic.py::rank_ic_postsort``. The
sort itself stays outside (``torch.sort``, as ``lax.sort`` stays outside
Pallas in the JAX package); the kernel takes the sorted keys (NaN last) and
the co-sorted payload (0 at invalid cells) and returns per-row rank-IC and
valid count.

Bound on an H100: bytes — each ``[R, M]`` f32 input is read once and the
work is a few operations per element, so the least time is
``8 R M / 3.35 TB/s`` (0.16 ms at R = 66,600, M = 1000). A team of warps
owns a row (:func:`postsort_layout`: one warp up to M = 992, each lane a
contiguous odd-sized chunk of positions, so its reads from the row in
shared memory hit 32 distinct banks); the tie-run scans are warp shuffles
and the moment sums warp sums, with no block barrier in a one-warp row. The
grid is persistent and each team double-buffers its rows in shared memory,
loading the next by 1-D bulk copies (the TMA) while it ranks the current
one.

On a CUDA tensor :func:`rank_ic_postsort` launches the kernel or raises; on
a CPU tensor it runs :func:`rank_ic_postsort_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from factormodeling_tpu_torch import _build
from factormodeling_tpu_torch.ops._rank import sorted_avg_ranks

__all__ = ["MAX_SORTED_WIDTH", "postsort_layout", "rank_ic_postsort",
           "rank_ic_postsort_plain"]

#: widest row the kernel takes: one buffer of 8 B an element must fit the
#: 227 KB a block can use on Hopper
MAX_SORTED_WIDTH = 16384
#: positions a lane at most (``RIC_MAX_CHUNK``; ``RIC_WIDE_CHUNK`` for rows
#: that would take more lanes than the fused sort's block of
#: ``RIC_THREADS``), teams a block at most (``RIC_MAX_TEAMS``), and the
#: shared memory a block's row buffers may take (227 KB less the teams'
#: scratch and the barriers)
MAX_CHUNK, WIDE_CHUNK, NARROW_LANES, MAX_TEAMS = 31, 63, 256, 15
SMEM_BUDGET = 227 * 1024 - 1536 - 512

#: kernel launches since the count was last set to 0
launches = 0


def rank_ic_postsort_plain(s_key: torch.Tensor, r_s: torch.Tensor):
    """(rank_ic [R], n_valid [R]) in plain PyTorch: average-tie ranks of the
    sorted keys and the centered Pearson moments with the closed-form rank
    mean (n+1)/2."""
    vs = ~torch.isnan(s_key)
    cnt = vs.sum(-1).to(s_key.dtype)
    cs = torch.where(cnt > 0, cnt, float("nan"))
    mr = r_s.sum(-1) / cs
    dr = torch.where(vs, r_s - mr[..., None], 0.0)
    var_r = (dr * dr).sum(-1)
    ranks = sorted_avg_ranks(s_key, vs)
    mrank = (cs + 1.0) * 0.5
    drk = torch.where(vs, ranks - mrank[..., None], 0.0)
    cov = (drk * dr).sum(-1)
    var_rank = (drk * drk).sum(-1)
    return cov / torch.sqrt(var_rank * var_r), cnt


def postsort_layout(m: int) -> dict:
    """The kernel's block for rows of ``m`` (``row_layout`` and
    ``fm_rank_ic_layout`` in the sources): ``team_warps`` warps a row (the
    fewest whose lanes take at most :data:`MAX_CHUNK` positions, or
    :data:`WIDE_CHUNK` past :data:`NARROW_LANES` lanes), ``chunk``
    positions a lane (odd), ``buffers`` row buffers a team (two where they
    fit), ``teams`` a block and the block's dynamic ``smem_bytes``."""
    lanes = -(-m // MAX_CHUNK)
    if lanes > NARROW_LANES:
        lanes = -(-m // WIDE_CHUNK)
    tw = -(-lanes // 32) if lanes > 32 else 1
    chunk = -(-m // (32 * tw)) | 1
    per_buf = 8 * ((m + 3) & ~3)
    nbuf = 2 if 4 * per_buf <= SMEM_BUDGET else 1
    teams = max(1, min(SMEM_BUDGET // (nbuf * per_buf), 1024 // (32 * tw),
                       MAX_TEAMS))
    return dict(team_warps=tw, chunk=chunk, buffers=nbuf, teams=teams,
                smem_bytes=teams * nbuf * per_buf)


def _lib():
    lib = _build.load("rank_ic")
    fn = lib.fm_rank_ic_postsort
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rank_ic_postsort(s_key: torch.Tensor, r_s: torch.Tensor):
    """(rank_ic [R], n_valid [R]) from row-major sorted ``[R, M]`` arrays:
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if s_key.device.type == "cpu" and r_s.device.type == "cpu":
        return rank_ic_postsort_plain(s_key, r_s)
    if s_key.device.type != "cuda" or r_s.device != s_key.device:
        raise ValueError(f"rank_ic_postsort: inputs on {s_key.device} and "
                         f"{r_s.device}; both must be on one CUDA device or "
                         "on the CPU")
    if s_key.dtype != torch.float32 or r_s.dtype != torch.float32:
        raise TypeError(f"rank_ic_postsort kernel takes float32, got "
                        f"{s_key.dtype} and {r_s.dtype}")
    if s_key.ndim != 2 or r_s.shape != s_key.shape:
        raise ValueError(f"rank_ic_postsort takes two [R, M] arrays, got "
                         f"{tuple(s_key.shape)} and {tuple(r_s.shape)}")
    rows, m = s_key.shape
    if not 1 <= m <= MAX_SORTED_WIDTH:
        raise ValueError(f"rank_ic_postsort kernel takes 1 <= M <= "
                         f"{MAX_SORTED_WIDTH}, got M={m}")
    if not (s_key.is_contiguous() and r_s.is_contiguous()):
        raise ValueError("rank_ic_postsort takes contiguous inputs")
    ic = torch.empty(rows, dtype=torch.float32, device=s_key.device)
    cnt = torch.empty(rows, dtype=torch.float32, device=s_key.device)
    if rows == 0:
        return ic, cnt
    stream = torch.cuda.current_stream(s_key.device).cuda_stream
    with torch.cuda.device(s_key.device):
        rc = _lib()(s_key.data_ptr(), r_s.data_ptr(), ic.data_ptr(),
                    cnt.data_ptr(), rows, m, stream)
    if rc != 0:
        raise RuntimeError(f"rank_ic_postsort kernel launch failed: CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return ic, cnt
