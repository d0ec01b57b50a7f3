"""Rank-IC from unsorted rows in one pass (sort, average-tie ranks and
Pearson moments): the CUDA kernel ``csrc/rank_sort.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel
``factormodeling_tpu/metrics/_pallas_rank_sort.py::rank_ic_fused``, the
JAX package's opt-in route (``FM_RANK_IC_FUSED=1``) for float32 rows of
128 to 8192 cells. Its semantics are kept: keys map to monotone int32
(:func:`_key_i32`, bit for bit the JAX map: -0.0 and the denormals tie
+0.0, as the TPU and XLA's CPU flush denormals to zero; every NaN bit
pattern is one invalid key sorted last; +-inf are valid and ranked);
``n_valid`` counts the cells whose key is at most +inf's.

Bound on an H100: bytes — each row is read once (8 B per cell) and two
floats per row come back, 0.159 ms at R = 66,600, n = 1000. The kernel
sorts each row with a bitonic network over the padded width whose low
position bits live in registers (:func:`sort_layout`): a team of threads
holds the row, E words a thread, so the stages of the low bits are
compare-exchanges between a thread's registers, the next five are warp
shuffles, and only the bits above those (the team's warps) go through
shared memory. It then runs the post-sort kernel's own rank-and-moment
body (``csrc/rank_common.cuh``) over the sorted row in shared memory.

On a CUDA tensor :func:`rank_ic_fused` launches the kernel or raises; on a
CPU tensor it runs :func:`rank_ic_fused_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from factormodeling_tpu_torch import _build
from factormodeling_tpu_torch.metrics._cuda_rank_ic import rank_ic_postsort_plain

__all__ = ["MAX_WIDTH", "MIN_WIDTH", "rank_ic_fused", "rank_ic_fused_plain",
           "sort_layout"]

#: the row widths the kernel takes (the JAX package's routing range)
MIN_WIDTH, MAX_WIDTH = 1 << 7, 1 << 13
#: words a thread holds in registers (``RS_REG_WORDS`` in
#: ``csrc/rank_sort.cu``), within a team of one warp to one block
REG_WORDS = 8

_INF_KEY = 0x7F800000    # +inf: the largest valid key
_NAN_KEY = 0x7FC00000    # the one invalid key, sorted after +inf

#: kernel launches since the count was last set to 0
launches = 0


def _flush_zero(x: torch.Tensor) -> torch.Tensor:
    """-0.0 and the denormals as +0.0 (``x == 0`` on a denormal-flushing
    machine, which the JAX key map runs on)."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, 0.0, x)


def _key_i32(x: torch.Tensor) -> torch.Tensor:
    """Signed-monotone int32 sort key of a float32 tensor (the JAX
    package's ``_key_i32``): -0.0 and denormals -> +0.0, NaN -> one
    canonical key that sorts last, negative floats
    ``u -> u ^ 0x7fffffff``."""
    x = _flush_zero(x)
    u = x.view(torch.int32)
    k = torch.where(u < 0, u ^ 0x7FFFFFFF, u)
    return torch.where(torch.isnan(x), _NAN_KEY, k)


def rank_ic_fused_plain(key: torch.Tensor, rr: torch.Tensor):
    """(rank_ic [R], n_valid [R]) in plain PyTorch: sort the int keys, carry
    the canonical float keys (-0.0 and denormals as +0.0, NaN at invalid
    cells) and the payload along, then the post-sort moments."""
    k = _key_i32(key)
    _, idx = torch.sort(k, dim=-1)
    canon = torch.where(k <= _INF_KEY, _flush_zero(key), float("nan"))
    return rank_ic_postsort_plain(torch.gather(canon, -1, idx),
                                  torch.gather(rr, -1, idx))


def sort_layout(n: int) -> dict:
    """The kernel's layout for rows of ``n`` cells: the padded width ``w``,
    the words a thread holds ``e``, the threads that sort a row ``team``,
    the rows a block sorts, and the network's stages by where the bit they
    exchange lives (``register``: bits below log2(e); ``lane``: the next
    five; ``shared``: the rest)."""
    w = max(MIN_WIDTH, 1 << (int(n) - 1).bit_length())
    e = max(min(w // 32, REG_WORDS), w // 256)
    team = w // e
    log_w = w.bit_length() - 1
    kinds = {"register": 0, "lane": 0, "shared": 0}
    for s in range(1, log_w + 1):
        for b in range(s):
            j = 1 << b
            kinds["register" if j < e else "lane" if j < 32 * e
                  else "shared"] += 1
    return dict(w=w, e=e, team=team, rows_per_block=256 // team,
                stages=kinds)


def _lib():
    lib = _build.load("rank_sort")
    fn = lib.fm_rank_ic_fused
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rank_ic_fused(key: torch.Tensor, rr: torch.Tensor):
    """(rank_ic [R], n_valid [R]) from unsorted row-major ``[R, n]`` rows:
    ``key`` float32 with NaN at invalid cells, ``rr`` float32 with 0 there.
    The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if key.device.type == "cpu" and rr.device.type == "cpu":
        return rank_ic_fused_plain(key, rr)
    if key.device.type != "cuda" or rr.device != key.device:
        raise ValueError(f"rank_ic_fused: inputs on {key.device} and "
                         f"{rr.device}; both must be on one CUDA device or on "
                         "the CPU")
    if key.dtype != torch.float32 or rr.dtype != torch.float32:
        raise TypeError(f"rank_ic_fused kernel takes float32, got {key.dtype} "
                        f"and {rr.dtype}")
    if key.ndim != 2 or rr.shape != key.shape:
        raise ValueError(f"rank_ic_fused takes two [R, n] arrays, got "
                         f"{tuple(key.shape)} and {tuple(rr.shape)}")
    rows, n = key.shape
    if not MIN_WIDTH <= n <= MAX_WIDTH:
        raise ValueError(f"rank_ic_fused kernel takes {MIN_WIDTH} <= n <= "
                         f"{MAX_WIDTH}, got n={n}")
    if not (key.is_contiguous() and rr.is_contiguous()):
        raise ValueError("rank_ic_fused takes contiguous inputs")
    ic = torch.empty(rows, dtype=torch.float32, device=key.device)
    cnt = torch.empty(rows, dtype=torch.float32, device=key.device)
    if rows == 0:
        return ic, cnt
    stream = torch.cuda.current_stream(key.device).cuda_stream
    with torch.cuda.device(key.device):
        rc = _lib()(key.data_ptr(), rr.data_ptr(), ic.data_ptr(),
                    cnt.data_ptr(), rows, n, stream)
    if rc != 0:
        raise RuntimeError(f"rank_ic_fused kernel launch failed: CUDA error "
                           f"{rc}")
    global launches
    launches += 1
    return ic, cnt
