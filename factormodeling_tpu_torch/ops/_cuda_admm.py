"""One ADMM segment: the CUDA kernel ``csrc/admm_segment.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel ``factormodeling_tpu/ops/_pallas_admm.py::
admm_segment`` for ``anderson=0`` without iteration telemetry (the Anderson
variant is not ported yet). A segment is ``seg_len`` ADMM iterations of the
box/L1 QP at a fixed rho: the Woodbury x-step against the precomputed inner
inverse ``kinv``, the equality correction through ``ge``/``mt``/``xb``,
over-relaxation, the soft-threshold-then-clip z-step and the dual update.
The refactorization per rho stays outside, in
:func:`factormodeling_tpu_torch.solvers.admm_qp.segment_operands`.

The kernel comes in float32 and float64; the backtest solves its QP in
float64 (see :mod:`factormodeling_tpu_torch.backtest.mvo`).

Bound on an H100: neither bytes nor operations — a segment at T = 60,
N = 1000 moves ~0.3 MB (0.6 MB in float64) and does ~7 MFLOP, a fraction of
a microsecond at the card's rates. The time goes to the serial chain of dependent iterations,
which the plain version spends as ~15 small launches per iteration; the
kernel runs the whole segment in one launch, on one thread block, with the
iterates in registers and ``V`` kept hot in L1/L2 (see the source's note).

On a CUDA tensor :func:`admm_segment` launches the kernel or raises; on a
CPU tensor it runs :func:`admm_segment_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from factormodeling_tpu_torch import _build

__all__ = ["MAX_N", "admm_segment", "admm_segment_plain"]

#: widest problem the kernel takes (1024 threads x 4 coordinates each); the
#: solver routes wider problems to the reference loop
MAX_N = 4096
_MAX_K = 4

#: kernel launches since the count was last set to 0
launches = 0


def admm_segment_plain(d, V, kinv, minv_et_t, ge, xb, q, lo, hi, center,
                       thresh, z, u, rho, *, relax: float, seg_len: int):
    """``seg_len`` ADMM iterations in plain PyTorch; returns
    ``(x, z, u, dz)``: the last x-step iterate, the prox-exact exit (z, u)
    and the last iteration's max |z' - z|."""
    x = z
    dz = torch.zeros((), dtype=z.dtype, device=z.device)
    for _ in range(int(seg_len)):
        rd = (rho * (z - u) - q) / d
        t2 = (V @ rd) @ kinv
        xt = rd - (t2 @ V) / d
        x = xt - (ge @ xt) @ minv_et_t + xb
        xr = relax * x + (1.0 - relax) * z
        w = xr + u
        zs = w - center
        z_new = center + torch.sign(zs) * torch.clamp(zs.abs() - thresh, min=0.0)
        z_new = torch.clamp(z_new, lo, hi)
        u = w - z_new
        dz = torch.max(torch.abs(z_new - z))
        z = z_new
    return x, z, u, dz


_ENTRY = {torch.float32: "fm_admm_segment_f32",
          torch.float64: "fm_admm_segment_f64"}


def _lib(dtype):
    fn = getattr(_build.load("admm_segment"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 18
                       + [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def admm_segment(d, V, kinv, minv_et_t, ge, xb, q, lo, hi, center, thresh,
                 z, u, rho, *, relax: float, seg_len: int):
    """One ADMM segment at fixed ``rho`` (a 0-d tensor, read on the device).

    ``V`` is the ``[T, N]`` low-rank factor, ``kinv`` the ``[T, T]`` Woodbury
    inner inverse, ``minv_et_t``/``ge`` the ``[K, N]`` equality operators and
    the rest ``[N]`` vectors in the solver's scaled units. Returns
    ``(x, z, u, dz)``: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    vecs = (d, xb, q, lo, hi, center, thresh, z, u)
    args = (V, kinv, minv_et_t, ge) + vecs + (rho,)
    if all(a.device.type == "cpu" for a in args):
        return admm_segment_plain(d, V, kinv, minv_et_t, ge, xb, q, lo, hi,
                                  center, thresh, z, u, rho, relax=relax,
                                  seg_len=seg_len)
    dev = V.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("admm_segment: operands must all lie on one CUDA "
                         "device or all on the CPU")
    dtype = V.dtype
    if dtype not in _ENTRY or any(a.dtype != dtype for a in args):
        raise TypeError("admm_segment kernel takes float32 or float64 "
                        "operands of one dtype, got "
                        f"{sorted({str(a.dtype) for a in args})}")
    t, n = V.shape
    k = ge.shape[0]
    if n > MAX_N or k > _MAX_K:
        raise ValueError(f"admm_segment kernel takes N <= {MAX_N} and "
                         f"K <= {_MAX_K}, got N={n}, K={k}")
    if (kinv.shape != (t, t) or minv_et_t.shape != (k, n)
            or ge.shape != (k, n) or any(v.shape != (n,) for v in vecs)
            or rho.numel() != 1):
        raise ValueError("admm_segment: operand shapes do not match "
                         f"V [{t}, {n}] and K = {k}")
    smem = V.element_size() * (t * t + n + 2 * t)
    if smem > 227 * 1024:
        raise ValueError(f"admm_segment kernel needs {smem} B of shared "
                         f"memory at T={t}, N={n}; the limit is 227 KB")
    args = tuple(a.contiguous() for a in args)
    if any(a.data_ptr() % a.element_size() for a in args):
        raise ValueError("admm_segment takes aligned operands")
    (V, kinv, minv_et_t, ge, d, xb, q, lo, hi, center, thresh, z, u,
     rho) = args
    x_out = torch.empty(n, dtype=dtype, device=dev)
    z_out = torch.empty(n, dtype=dtype, device=dev)
    u_out = torch.empty(n, dtype=dtype, device=dev)
    dz_out = torch.empty((), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib(dtype)(d.data_ptr(), V.data_ptr(), kinv.data_ptr(),
                    minv_et_t.data_ptr(), ge.data_ptr(), xb.data_ptr(),
                    q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                    center.data_ptr(), thresh.data_ptr(), z.data_ptr(),
                    u.data_ptr(), rho.data_ptr(), x_out.data_ptr(),
                    z_out.data_ptr(), u_out.data_ptr(), dz_out.data_ptr(),
                    t, n, k, int(seg_len), float(relax), stream)
    if rc != 0:
        raise RuntimeError(f"admm_segment kernel launch failed: CUDA error "
                           f"{rc}")
    global launches
    launches += 1
    return x_out, z_out, u_out, dz_out
