"""One ADMM segment: the CUDA kernel ``csrc/admm_segment.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel ``factormodeling_tpu/ops/_pallas_admm.py::
admm_segment``, all of it: the plain iteration, the safeguarded Anderson
accelerator (``anderson > 0``), the iterations-to-converge tally
(``collect``) and the plain tail of a solve's ``last`` segment. A segment is
``seg_len`` ADMM iterations of the box/L1 QP at a fixed rho: the Woodbury
x-step against the precomputed inner inverse ``kinv``, the equality
correction through ``ge``/``mt``/``xb``, over-relaxation, the
soft-threshold-then-clip z-step and the dual update; under Anderson each
iteration then extrapolates the next ``(z, u)`` from the last ``anderson``
iterate/residual difference pairs (:func:`anderson_step`). The
refactorization per rho stays outside, in
:func:`factormodeling_tpu_torch.solvers.admm_qp.segment_operands`.

Operands come with a leading lane axis (``V [B, T, N]``, vectors
``[B, N]``, ``rho [B]``) or without one; one launch runs every lane (what
``jax.vmap`` of the ``pallas_call`` computes). The kernel comes in float32
and float64; the backtest solves its QP in float64 (see
:mod:`factormodeling_tpu_torch.backtest.mvo`).

Bound on an H100: neither bytes nor operations — a segment at T = 60,
N = 1000 moves ~0.6 MB in float64 and does ~7 MFLOP (plus ~1 MFLOP of
Anderson work at depth 5), a fraction of a microsecond at the card's rates.
The time goes to the serial chain: ``seg_len`` dependent iterations, each
of eight phases closed by a block barrier or an exchange with the lane's
other blocks (2-3 exchanges a plain iteration, 5 under Anderson). One lane
is one thread-block cluster of ``C`` blocks along the asset axis
(:func:`cluster_plan`: ``C`` from T, N and the dtype, never from B, so a
lane's arithmetic does not depend on the launch it shares). Each block
holds ``kinv``, its slice of ``V`` and its slice of the Anderson history in
its own shared memory; cross-block sums are pushed into every block's
shared memory (``st.async``, counted on the receiver's mbarrier) and added
in block-rank order, so that every block takes the same branch at every
gate (see the source's note). What does not fit is read from device
memory instead (the history from a per-block workspace); the plan says
which. :mod:`factormodeling_tpu_torch.segment_phases` prints the cycles of
each phase.

On a CUDA tensor :func:`admm_segment` launches the kernel or raises (a
cluster launch the card refuses raises too); on a CPU tensor it runs
:func:`admm_segment_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import torch

from factormodeling_tpu_torch import _build
from factormodeling_tpu_torch.ops._linalg import aa_mix

__all__ = ["MAX_ANDERSON", "MAX_N", "AndersonState", "ClusterPlan",
           "admm_segment", "admm_segment_plain", "anderson_init",
           "anderson_step", "cluster_plan", "segment_launcher"]

#: widest problem the kernel takes; the solver routes wider problems to the
#: reference loop
MAX_N = 4096
_MAX_K = 4
#: deepest Anderson history the kernel takes
MAX_ANDERSON = 8

# the kernel's block and shared-memory layout (csrc/admm_segment.cu)
_THREADS, _COLS = 256, 8         # a block's threads, coordinates per thread
_RED_MAX, _XCH_MIN = 4, 44       # values a reduction; exchange row floor
_ROW_GROUP = 4                   # lanes reading one row together
_MBAR_BYTES = 16                 # the exchange slots' two mbarriers
_SMEM_LIMIT = 232448             # 227 KB of dynamic shared memory a block
#: blocks per lane: the cluster size measured fastest at each of the
#: backtest's three segment shapes (``segment_phases``' sweep; PERF.md)
CLUSTER = 8

# The safeguarded Anderson accelerator's constants, the JAX package's
# (``factormodeling_tpu/solvers/admm_qp.py`` gives the measured rationale of
# each): residual growth over the best residual that triggers a rollback,
# unaccelerated iterations closing a solve, the extrapolation clamp in
# residuals, and the combined-residual grade at which the loop counts as
# converged (and acceleration stops).
_AA_SAFEGUARD = 2.0
_AA_PLAIN_TAIL = 5
_AA_STEP_CLAMP = 5.0
_CONV_TOL = 1e-3

#: kernel launches since the count was last set to 0 (one per lane batch)
launches = 0
#: of those, the launches of more than one lane (a lane-batched solve's
#: chunk; a solve of one lane, or a chunk of one date, counts in
#: ``launches`` alone)
lane_launches = 0


class AndersonState(NamedTuple):
    """Per-lane Anderson history over ``v = [z, u]`` (``2N`` wide): the
    difference rows ``s_h``/``y_h`` ``[B, m, 2N]`` (newest first), the
    previous iterate and residual ``vp``/``gp``, the best plain iterate
    ``vg`` (the rollback target), the history length ``hist`` and the best
    residual ``r_best``."""

    s_h: torch.Tensor
    y_h: torch.Tensor
    vp: torch.Tensor
    gp: torch.Tensor
    vg: torch.Tensor
    hist: torch.Tensor
    r_best: torch.Tensor


def anderson_init(z: torch.Tensor, u: torch.Tensor, m: int) -> AndersonState:
    """An empty history at ``(z, u)`` (``[B, N]``), as every segment starts."""
    b, n = z.shape
    h0 = torch.zeros((b, m, 2 * n), dtype=z.dtype, device=z.device)
    v0 = torch.zeros((b, 2 * n), dtype=z.dtype, device=z.device)
    return AndersonState(h0, h0, v0, v0, torch.cat([z, u], -1),
                         torch.zeros(b, dtype=torch.int32, device=z.device),
                         torch.full((b,), float("inf"), dtype=z.dtype,
                                    device=z.device))


def anderson_step(st: AndersonState, i: int, z, u, z_new, u_new, r_c, *,
                  tail: bool):
    """One safeguarded type-II Anderson step after the plain map took
    ``(z, u)`` to ``(z_new, u_new)`` at in-segment iteration ``i``, with
    ``r_c`` the combined residual ``max(|x - z_new|_inf, rho dz)``
    (``[B]``). ``tail`` marks an iteration inside the plain tail of a
    solve's last segment. Returns ``(state, z_next, u_next, accepted,
    rolled_back)``, the last two ``bool[B]``.

    The residual must stay within ``_AA_SAFEGUARD`` of the best residual so
    far; a breach drops the history and rolls back to the best plain
    iterate. A candidate is taken only on an improving residual, above the
    convergence grade, within ``_AA_STEP_CLAMP`` residuals of the plain
    step, all finite, and outside the plain tail."""
    n = z.shape[-1]
    m = st.s_h.shape[-2]
    v = torch.cat([z, u], -1)
    v_f = torch.cat([z_new, u_new], -1)
    g = v_f - v
    r = torch.sqrt((g * g).sum(-1))
    grew = (r > _AA_SAFEGUARD * st.r_best) & (i > 0)
    vg = torch.where((r <= st.r_best)[:, None], v_f, st.vg)
    r_best = torch.minimum(st.r_best, r)
    hist = torch.where(grew, 0, st.hist)
    s_h, y_h = st.s_h, st.y_h
    if i > 0:
        push = ~grew
        s_h = torch.where(push[:, None, None],
                          torch.cat([(v - st.vp)[:, None], s_h[:, :-1]], 1), s_h)
        y_h = torch.where(push[:, None, None],
                          torch.cat([(g - st.gp)[:, None], y_h[:, :-1]], 1), y_h)
        hist = torch.where(push, torch.clamp(hist + 1, max=m), hist)
    cand = aa_mix(v_f, g, s_h, y_h, hist)
    step = cand - v_f
    use = ((hist > 0) & ~grew & (r <= r_best) & (r_c > _CONV_TOL)
           & (torch.sqrt((step * step).sum(-1)) <= _AA_STEP_CLAMP * r)
           & torch.isfinite(cand).all(-1))
    if tail:
        use = use & False
    v_next = torch.where(use[:, None], cand, v_f)
    v_next = torch.where(grew[:, None], vg, v_next)
    state = AndersonState(s_h, y_h, v, g, vg, hist.to(torch.int32), r_best)
    return state, v_next[:, :n], v_next[:, n:], use, grew


def _lanes(V, vecs, mats, rho):
    """Add a lane axis of 1 to single-problem operands."""
    if V.ndim == 3:
        return False, V, vecs, mats, rho
    return (True, V[None], tuple(v[None] for v in vecs),
            tuple(a[None] for a in mats), rho.reshape(1))


def admm_segment_plain(d, V, kinv, minv_et_t, ge, xb, q, lo, hi, center,
                       thresh, z, u, rho, *, relax: float, seg_len: int,
                       last: bool = True, anderson: int = 0,
                       collect: bool = False):
    """``seg_len`` ADMM iterations in plain PyTorch; returns
    ``(x, z, u, dz, aa_accepted, aa_rejected, conv)``: the last plain x-step
    iterate, the exit (z, u), the last iteration's max |z' - z|, the
    Anderson tallies and, under ``collect``, the first 1-based iteration at
    which ``max(|x - z'|_inf, rho dz) <= _CONV_TOL`` (0 otherwise); the
    tallies are int32."""
    single, V, (d, xb, q, lo, hi, center, thresh, z, u), (kinv, mt, ge), rho = (
        _lanes(V, (d, xb, q, lo, hi, center, thresh, z, u),
               (kinv, minv_et_t, ge), rho))
    b = V.shape[0]
    rho_c = rho[:, None]
    x = z
    dz = torch.zeros(b, dtype=z.dtype, device=z.device)
    acc, rej, conv = (torch.zeros(b, dtype=torch.int32, device=z.device)
                      for _ in range(3))
    aa = anderson_init(z, u, anderson) if anderson else None
    seg_len = int(seg_len)
    for i in range(seg_len):
        rd = (rho_c * (z - u) - q) / d
        t2 = (rd[:, None, :] @ V.mT) @ kinv                    # [B, 1, T]
        xt = rd - (t2 @ V)[:, 0] / d
        x = xt - ((xt[:, None, :] @ ge.mT) @ mt)[:, 0] + xb
        xr = relax * x + (1.0 - relax) * z
        w = xr + u
        zs = w - center
        z_new = center + torch.sign(zs) * torch.clamp(zs.abs() - thresh, min=0.0)
        z_new = torch.clamp(z_new, lo, hi)
        u_new = w - z_new
        dz = torch.abs(z_new - z).amax(-1)
        if collect or anderson:
            r_c = torch.maximum(torch.abs(x - z_new).amax(-1), rho * dz)
        if collect:
            conv = torch.where((conv == 0) & (r_c <= _CONV_TOL), i + 1, conv)
        if anderson:
            aa, z_new, u_new, use, grew = anderson_step(
                aa, i, z, u, z_new, u_new, r_c,
                tail=last and i >= seg_len - _AA_PLAIN_TAIL)
            acc = acc + use.to(torch.int32)
            rej = rej + grew.to(torch.int32)
        z, u = z_new, u_new
    out = (x, z, u, dz, acc, rej, conv.to(torch.int32))
    return tuple(o[0] for o in out) if single else out


class ClusterPlan(NamedTuple):
    """How the kernel lays out one lane: ``cluster`` blocks of ``cols``
    coordinates each; whether ``kinv``, a block's slice of ``V`` and its
    slice of the Anderson history sit in its shared memory (else device
    memory, read through L2); the block's ``smem_bytes`` of dynamic shared
    memory."""

    cluster: int
    cols: int
    kinv_shared: bool
    v_shared: bool
    history_shared: bool
    smem_bytes: int


def _row_stride(n: int, ew: int) -> int:
    """``row_stride`` in the source: rows of ``n`` elements of ``ew``
    4-byte words padded so a warp's row groups read distinct banks."""
    w = 32 // ew
    return n + (_ROW_GROUP % w - n % w) % w


def _smem_elems(t: int, cols: int, m: int, c: int, ew: int,
                kinv_shared: bool, v_shared: bool,
                history_shared: bool) -> int:
    """A block's shared-memory elements, as ``smem_elems`` in the source:
    rd, t, t2 and the Gram totals, the warp partials, two exchange slots of
    ``c`` rows, gamma; then kinv, V's slice and the history's where they
    are placed."""
    x = max(t, _XCH_MIN)
    e = cols + t + x + _RED_MAX * (_THREADS // 32) + 2 * c * x + MAX_ANDERSON
    if kinv_shared:
        e += t * _row_stride(t, ew)
    if v_shared:
        e += t * _row_stride(cols, ew)
    if history_shared and m:
        e += (2 * m + 6) * 2 * cols
    return e


def cluster_plan(t: int, n: int, k: int, m: int,
                 dtype: torch.dtype) -> ClusterPlan:
    """The kernel's layout of one lane of ``T = t``, ``N = n``, ``K = k``
    and Anderson depth ``m`` in ``dtype`` — the same for every lane count:
    :data:`CLUSTER` blocks; ``kinv`` goes into shared memory first, then
    ``V``'s slice, then the history, each where it fits. Raises
    ``ValueError`` on what the kernel does not take."""
    return _plan(t, n, k, m, dtype, CLUSTER)


@functools.lru_cache(maxsize=None)
def _plan(t: int, n: int, k: int, m: int, dtype: torch.dtype,
          c: int) -> ClusterPlan:
    if n > MAX_N or k > _MAX_K or not 0 <= m <= MAX_ANDERSON:
        raise ValueError(f"admm_segment kernel takes N <= {MAX_N}, K <= "
                         f"{_MAX_K} and 0 <= anderson <= {MAX_ANDERSON}, got "
                         f"N={n}, K={k}, anderson={m}")
    cols = -(-n // c)
    if not 1 <= c <= 8 or cols > _THREADS * _COLS:
        raise ValueError(f"admm_segment kernel: a cluster of {c} blocks "
                         f"cannot take N={n}")
    size = torch.finfo(dtype).bits // 8
    for k_sh, v_sh, h_sh in itertools.product((True, False), (True, False),
                                              (bool(m), False)):
        nbytes = _MBAR_BYTES + size * _smem_elems(t, cols, m, c, size // 4,
                                                  k_sh, v_sh, h_sh)
        if nbytes <= _SMEM_LIMIT:
            return ClusterPlan(c, cols, k_sh, v_sh, h_sh, nbytes)
    raise ValueError(f"admm_segment kernel needs {nbytes} B of shared memory "
                     f"a block at T={t}, N={n}, C={c}; the limit is "
                     f"{_SMEM_LIMIT}")


_ENTRY = {torch.float32: "fm_admm_segment_f32",
          torch.float64: "fm_admm_segment_f64"}


def _lib(dtype):
    fn = getattr(_build.load("admm_segment"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
                       + [ctypes.c_double] + [ctypes.c_int] * 3
                       + [ctypes.c_double] * 2 + [ctypes.c_int]
                       + [ctypes.c_double] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def segment_launcher(d, V, kinv, minv_et_t, ge, xb, q, lo, hi, center,
                     thresh, z, u, rho, *, relax: float, seg_len: int,
                     last: bool = True, anderson: int = 0,
                     collect: bool = False):
    """Check CUDA operands (with the lane axis) once and allocate the
    outputs; returns ``(launch, plan)``. Each ``launch()`` runs the kernel
    once on those operands into the same outputs and returns the raw
    ``(x, z, u, stats)``, ``stats [B, 4]`` holding dz and the three tallies
    in the operands' dtype. :func:`admm_segment` is one launch of it; a
    caller timing the kernel alone calls ``launch`` many times."""
    args = (V, kinv, minv_et_t, ge, d, xb, q, lo, hi, center, thresh, z, u,
            rho)
    dev = V.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("admm_segment: operands must all lie on one CUDA "
                         "device or all on the CPU")
    dtype = V.dtype
    if dtype not in _ENTRY or any(a.dtype != dtype for a in args):
        raise TypeError("admm_segment kernel takes float32 or float64 "
                        "operands of one dtype, got "
                        f"{sorted({str(a.dtype) for a in args})}")
    b, t, n = V.shape
    k = ge.shape[1]
    m = int(anderson)
    plan = cluster_plan(t, n, k, m, dtype)
    if (kinv.shape != (b, t, t) or minv_et_t.shape != (b, k, n)
            or ge.shape != (b, k, n)
            or any(v.shape != (b, n) for v in (d, xb, q, lo, hi, center,
                                               thresh, z, u))
            or rho.shape != (b,)):
        raise ValueError("admm_segment: operand shapes do not match "
                         f"V [{b}, {t}, {n}] and K = {k}")
    ops = tuple(a.contiguous() for a in (d, V, kinv, minv_et_t, ge, xb, q,
                                         lo, hi, center, thresh, z, u, rho))
    if any(a.data_ptr() % a.element_size() for a in ops):
        raise ValueError("admm_segment takes aligned operands")
    x_out, z_out, u_out = (torch.empty((b, n), dtype=dtype, device=dev)
                           for _ in range(3))
    stats = torch.empty((b, 4), dtype=dtype, device=dev)
    # the Anderson history and scratch of each block, where shared memory
    # cannot hold them: S, Y [m, 2 cols] and six [2 cols] rows
    work = (torch.empty((b * plan.cluster, (2 * m + 6) * 2 * plan.cols),
                        dtype=dtype, device=dev)
            if m and not plan.history_shared else None)
    ptrs = [a.data_ptr() for a in ops] + [
        x_out.data_ptr(), z_out.data_ptr(), u_out.data_ptr(),
        stats.data_ptr(), None if work is None else work.data_ptr()]
    tail = (b, t, n, k, int(seg_len), float(relax), m, int(bool(collect)),
            int(bool(last)), _AA_SAFEGUARD, _AA_STEP_CLAMP, _AA_PLAIN_TAIL,
            _CONV_TOL, plan.cluster, int(plan.kinv_shared),
            int(plan.v_shared), int(plan.history_shared))
    fn = _lib(dtype)

    def launch():
        global launches, lane_launches
        with torch.cuda.device(dev):
            rc = fn(*ptrs, *tail, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"admm_segment kernel launch failed: CUDA "
                               f"error {rc} (cluster of {plan.cluster}, "
                               f"{plan.smem_bytes} B of shared memory a "
                               "block)")
        launches += 1
        lane_launches += b > 1
        return x_out, z_out, u_out, stats

    return launch, plan


def admm_segment(d, V, kinv, minv_et_t, ge, xb, q, lo, hi, center, thresh,
                 z, u, rho, *, relax: float, seg_len: int, last: bool = True,
                 anderson: int = 0, collect: bool = False):
    """One ADMM segment at fixed ``rho`` for every lane, read on the device.

    ``V`` is the ``[B, T, N]`` low-rank factor, ``kinv`` the ``[B, T, T]``
    Woodbury inner inverse, ``minv_et_t``/``ge`` the ``[B, K, N]`` equality
    operators, ``rho`` ``[B]`` and the rest ``[B, N]`` vectors in the
    solver's scaled units (or all without the lane axis, for one problem).
    Returns ``(x, z, u, dz, aa_accepted, aa_rejected, conv)`` as
    :func:`admm_segment_plain` does: the CUDA kernel on CUDA tensors (one
    launch for all lanes, a cluster of :func:`cluster_plan`'s blocks each),
    the plain version on CPU tensors."""
    vecs = (d, xb, q, lo, hi, center, thresh, z, u)
    kw = dict(relax=relax, seg_len=seg_len, last=last, anderson=anderson,
              collect=collect)
    if all(a.device.type == "cpu" for a in (V, kinv, minv_et_t, ge, rho)
           + vecs):
        return admm_segment_plain(d, V, kinv, minv_et_t, ge, xb, q, lo, hi,
                                  center, thresh, z, u, rho, **kw)
    single, V, vecs, (kinv, mt, ge), rho = _lanes(V, vecs, (kinv, minv_et_t,
                                                            ge), rho)
    d, xb, q, lo, hi, center, thresh, z, u = vecs
    launch, _ = segment_launcher(d, V, kinv, mt, ge, xb, q, lo, hi, center,
                                 thresh, z, u, rho, **kw)
    x_out, z_out, u_out, stats = launch()
    tallies = stats[:, 1:].to(torch.int32)
    out = (x_out, z_out, u_out, stats[:, 0], tallies[:, 0], tallies[:, 1],
           tallies[:, 2])
    return tuple(o[0] for o in out) if single else out
