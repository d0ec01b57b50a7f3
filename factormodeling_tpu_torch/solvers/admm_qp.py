"""Fixed-iteration ADMM for box-constrained QPs with equality rows and an
optional L1 (turnover) term (port of
``factormodeling_tpu/solvers/admm_qp.py``: the low-rank path).

Problem form::

    minimize   1/2 x'Px + q'x + sum_i l1[i] * |x[i] - center[i]|
    subject to lo <= x <= hi,   E x = b        (K small: the 2 leg rows)

with ``P = alpha I + V' diag(s) V`` (``V`` is ``[T, n]``, T << n), applied
through a Woodbury identity with one T x T Cholesky. The objective is
pre-scaled by mean(diag P); the iterations run in segments of
``_ADAPT_EVERY`` with residual-balanced adaptive rho between them; the exit
iterate goes through the guarded active-set polish. See the JAX module for
the measured rationale of every constant, which the port keeps as is.

Every ladder decision is a ``torch.where`` on the device: nothing here reads
a tensor back to the host, so a day loop over solves never synchronizes.
Failed factorizations surface as NaN (``cholesky_ex`` without its check),
as they do in JAX, for the caller's fallback ladder to catch.

``kernel="fused"`` runs each segment as one launch of the CUDA kernel
(:func:`factormodeling_tpu_torch.ops._cuda_admm.admm_segment`) against
explicit small inverses built here per rho (:func:`segment_operands`);
problems wider than ``_FUSED_SEGMENT_MAX_N`` take the reference loop, the
JAX package's one routing rule. Not ported yet: the dense-P solver and the
Anderson accelerator.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from factormodeling_tpu_torch.ops._cuda_admm import admm_segment

__all__ = ["ADMMResult", "ADMMWarmState", "BoxQPProblem",
           "admm_solve_lowrank", "first_segment_inputs", "segment_operands"]


@dataclasses.dataclass(frozen=True)
class BoxQPProblem:
    """One QP instance."""

    q: torch.Tensor          # [n] linear term
    lo: torch.Tensor         # [n] lower bounds (pin with lo == hi)
    hi: torch.Tensor         # [n] upper bounds
    E: torch.Tensor          # [K, n] equality rows
    b: torch.Tensor          # [K]
    l1: torch.Tensor | float  # [] or [n] L1 weight (0 disables)
    center: torch.Tensor     # [n] L1 center (e.g. yesterday's weights)


class ADMMResult(NamedTuple):
    x: torch.Tensor          # equality-exact iterate (polished when accepted)
    z: torch.Tensor          # box/L1-exact iterate (loop exit; warm carry)
    primal_residual: torch.Tensor  # max |x - z|; box/eq residual if polished
    u: torch.Tensor          # scaled dual at exit (warm carry)
    rho: torch.Tensor        # adapted penalty at exit (warm carry)
    polished: torch.Tensor   # bool: polish ran AND was accepted
    polish_pre_residual: torch.Tensor   # box/eq residual before polish (NaN
    polish_post_residual: torch.Tensor  # / after; NaN when polish disabled)

    @property
    def warm_state(self) -> "ADMMWarmState":
        """The loop-exit (z, u, rho) triple to seed the next related solve."""
        return ADMMWarmState(z=self.z, u=self.u, rho=self.rho)


class ADMMWarmState(NamedTuple):
    """Warm-start state from a previous related solve: ``z`` is clipped into
    the new box, ``u`` (the scaled dual) is re-scaled by
    ``rho_prev / rho_start``; NaN ``rho`` means cold."""

    z: torch.Tensor
    u: torch.Tensor
    rho: torch.Tensor


_ADAPT_EVERY = 25          # iterations per segment between rho updates
_FUSED_SEGMENT_MAX_N = 4096  # widest problem the fused segment kernel takes;
                           # wider problems run the reference loop
_RHO_STEP_CLIP = 5.0       # max per-update rho movement factor
_RHO_BOUNDS = (1e-4, 1e7)  # global rho clamp (scaled problem units)
_POLISH_DELTA = 1e-8       # polish KKT regularization (scaled units)
_POLISH_PASSES = 6         # active-set refinement passes
_POLISH_RES_TOL = 1e-6     # acceptance slack on the box/eq residual
_POLISH_OBJ_TOL = 1e-5     # relative acceptance slack on the objective
_POLISH_REL_TOL = 1e-6     # relative band for the release/keep dual tests
_POLISH_RELEASE_GATE = 5e-2  # candidate feasibility needed before releases
_POLISH_BLAST = 10.0       # box-violation factor marking a wrong L1 side


def _chol(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization failed (no host
    check, unlike ``torch.linalg.cholesky``)."""
    low, info = torch.linalg.cholesky_ex(a)
    return torch.where(info[..., None, None] == 0, low, float("nan"))


def _cho_solve(low: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve with a Cholesky factor; ``r`` is ``[m]`` or ``[m, k]``."""
    if r.ndim == 1:
        return torch.cholesky_solve(r[:, None], low)[:, 0]
    return torch.cholesky_solve(r, low)


def _soft(a, k):
    return torch.sign(a) * torch.clamp(torch.abs(a) - k, min=0.0)


def _box_eq_residual(prob: BoxQPProblem, v):
    """max(box violation, |E v - b|_inf): the polish feasibility metric."""
    box = torch.clamp(torch.maximum(prob.lo - v, v - prob.hi), min=0.0).max()
    return torch.maximum(box, torch.abs(prob.E @ v - prob.b).max())


def _qp_objective(mv, prob: BoxQPProblem, q, l1, v):
    """Scaled objective 1/2 v'Pv + q'v + sum l1 |v - center|."""
    return (0.5 * (v @ mv(v)) + q @ v
            + torch.sum(l1 * torch.abs(v - prob.center)))


def _reduced_kkt_solve(mv, masked_solver, prob: BoxQPProblem, q, m, xa, qt):
    """The reduced equality-constrained QP of one polish pass,
    ``min 1/2 y'(MPM)y + qt'y  s.t.  (EM) y = b - E xa``, with masked rows
    and one iterative-refinement step; returns ``(x_candidate, nu)``."""
    b_red = prob.b - prob.E @ xa
    em = prob.E * m                                  # [K, n] masked rows
    solve_h = masked_solver(m)
    minv_et = solve_h(em.T)                          # [n, K]
    g = em @ minv_et                                 # [K, K]
    g = g + _POLISH_DELTA * torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    g_lu, g_piv, _ = torch.linalg.lu_factor_ex(g)

    def kkt(r1, r2):
        y0 = solve_h(r1)
        nu = torch.linalg.lu_solve(g_lu, g_piv, (em @ y0 - r2)[:, None])[:, 0]
        return y0 - minv_et @ nu, nu

    y, nu = kkt(-qt, b_red)
    r1 = -qt - (m * mv(m * y) + (1.0 - m) * y) - em.T @ nu
    r2 = b_red - em @ y
    dy, dnu = kkt(r1, r2)
    return xa + m * (y + dy), nu + dnu


def _polish_candidate(mv, masked_solver, prob: BoxQPProblem, q, l1, z,
                      passes: int = _POLISH_PASSES):
    """Guarded active-set KKT refinement candidate, fixed-shape: the active
    set is read off the prox exit ``z`` by equality, then re-identified over
    ``passes`` passes from each candidate's KKT conditions; the best
    candidate (feasibility, then objective) is returned with its reduced
    equality multipliers ``nu``."""
    dtype = q.dtype
    l1v = torch.broadcast_to(l1, z.shape)
    pinned = prob.hi <= prob.lo
    at_lo = z <= prob.lo
    at_hi = z >= prob.hi
    kinkable = (prob.center >= prob.lo) & (prob.center <= prob.hi)
    at_kink = (l1v > 0) & kinkable & (z == prob.center) & ~at_lo & ~at_hi
    side = torch.sign(z - prob.center)
    one = torch.ones_like(z)
    smax_lo = torch.where(prob.lo >= prob.center, one, -one)
    smin_hi = torch.where(prob.hi <= prob.center, -one, one)
    big = torch.finfo(dtype).max
    tiny = torch.finfo(dtype).tiny
    b_scale = 1.0 + torch.abs(prob.b).max()
    box_scale = 1.0 + torch.maximum(torch.abs(prob.lo), torch.abs(prob.hi)).max()

    n, k = z.shape[-1], prob.b.shape[-1]
    best = (torch.full((), big, dtype=dtype, device=z.device),
            torch.full((), big, dtype=dtype, device=z.device),
            torch.zeros(n, dtype=dtype, device=z.device),
            torch.zeros(k, dtype=dtype, device=z.device))
    for _ in range(passes):
        active = at_lo | at_hi | at_kink
        m = (~active).to(dtype)
        x_fix = torch.where(at_kink, prob.center,
                            torch.where(at_hi, prob.hi, prob.lo))
        xa = torch.where(active, x_fix, 0.0)
        qt = (q + l1v * side + mv(xa)) * m
        x_p, nu = _reduced_kkt_solve(mv, masked_solver, prob, q, m, xa, qt)

        finite = torch.isfinite(x_p).all()
        f_p = torch.where(finite, _box_eq_residual(prob, x_p), big)
        o_p = torch.where(finite, _qp_objective(mv, prob, q, l1, x_p), big)
        better = (f_p < best[0] - _POLISH_RES_TOL) | (
            (f_p <= best[0] + _POLISH_RES_TOL) & (o_p < best[1]))
        best = (torch.where(better, f_p, best[0]),
                torch.where(better, o_p, best[1]),
                torch.where(better, x_p, best[2]),
                torch.where(better, nu, best[3]))

        # re-identify from the candidate's KKT conditions
        gtot = mv(x_p) + q + prob.E.T @ nu
        tol = _POLISH_REL_TOL * (l1v + torch.abs(gtot)) + tiny
        free = m > 0
        viol = torch.maximum(prob.lo - x_p, x_p - prob.hi)
        blast = free & (l1v > 0) & (viol > _POLISH_BLAST * box_scale)
        side = torch.where(blast, torch.sign(x_p - prob.center), side)
        crossed = (free & ~blast & (l1v > 0) & kinkable
                   & (side * (x_p - prob.center) < 0))
        join_lo = free & ~blast & ~crossed & (x_p < prob.lo)
        join_hi = free & ~blast & ~crossed & (x_p > prob.hi)
        may_release = finite & (f_p <= _POLISH_RELEASE_GATE * b_scale)
        rel_lo = at_lo & ~pinned & may_release & (-gtot - l1v * smax_lo > tol)
        rel_hi = at_hi & ~pinned & may_release & (-gtot - l1v * smin_hi < -tol)
        rel_kink = at_kink & may_release & (torch.abs(gtot) > l1v + tol)
        side = torch.where(rel_kink, -torch.sign(gtot), side)
        side = torch.where(rel_lo, smax_lo, side)
        side = torch.where(rel_hi, smin_hi, side)
        # deadlock breaker: an all-pinned leg with an unmet equality
        deficit = prob.b - prob.E @ x_p
        leg_dead = ((torch.abs(deficit) > _POLISH_RES_TOL * b_scale)
                    & ((prob.E * m).sum(-1) <= 0))
        need_up = (prob.E.T @ (leg_dead & (deficit > 0)).to(dtype)) > 0
        need_dn = (prob.E.T @ (leg_dead & (deficit < 0)).to(dtype)) > 0
        brk_lo = at_lo & ~pinned & need_up
        brk_hi = at_hi & ~pinned & need_dn
        brk_kink = at_kink & (need_up | need_dn)
        side = torch.where(brk_lo, smax_lo, side)
        side = torch.where(brk_hi, smin_hi, side)
        side = torch.where(brk_kink, torch.where(need_up, one, -one), side)
        at_lo = (at_lo & ~rel_lo & ~brk_lo) | join_lo
        at_hi = (at_hi & ~rel_hi & ~brk_hi) | join_hi
        at_kink = (((at_kink & ~rel_kink & ~brk_kink) | crossed)
                   & ~at_lo & ~at_hi)
    return best[2], best[3]


def _rho_start(prob: BoxQPProblem, l1, rho0: float):
    """Problem-aware initial penalty rho* ~ l1 * n_free / 20, clipped."""
    n_free = torch.clamp((prob.hi > prob.lo).sum(), min=1).to(prob.lo.dtype)
    return torch.clamp(torch.clamp(l1.max() * n_free / 20.0, min=rho0),
                       *_RHO_BOUNDS)


def _admm_iterations(make_solver, prob: BoxQPProblem, q, l1, rho0, iters,
                     relax, warm=None, polish_ops=None,
                     polish_passes: int = _POLISH_PASSES, fused_segment=None):
    """Shared ADMM loop with residual-balanced adaptive rho.

    ``make_solver(rho)`` returns a function applying (P + rho I)^{-1}; the
    equality-constrained x-step is ``x = xt - Minv_Et nu``,
    ``nu = G^{-1}(E xt - b)`` with ``xt = solve_m(rho (z - u) - q)``.
    ``polish_ops`` is ``None`` or ``(mv, masked_solver)``.
    ``fused_segment``: optional ``(z, u, rho, seg_len) -> (x, z, u, dz)``
    running one whole segment; the residual-balancing tail is shared.
    """
    n = q.shape[-1]
    dtype, dev = q.dtype, q.device

    def factor(rho):
        solve_m = make_solver(rho)
        minv_et = solve_m(prob.E.T)                  # [n, K]
        g_chol = _chol(prob.E @ minv_et)             # [K, K]
        return solve_m, minv_et, g_chol

    def x_step(fac, z, u, rho):
        solve_m, minv_et, g_chol = fac
        xt = solve_m(rho * (z - u) - q)
        nu = _cho_solve(g_chol, prob.E @ xt - prob.b)
        return xt - minv_et @ nu

    def z_step(v, rho):
        moved = prob.center + _soft(v - prob.center, l1 / rho)
        return torch.clamp(moved, prob.lo, prob.hi)

    def segment(x, z, u, rho, seg_len):
        if fused_segment is not None:
            x, z, u, dz = fused_segment(z, u, rho, seg_len)
        else:
            fac = factor(rho)
            dz = torch.zeros((), dtype=dtype, device=dev)
            for _ in range(seg_len):
                x = x_step(fac, z, u, rho)
                xr = relax * x + (1.0 - relax) * z   # over-relaxation
                z_new = z_step(xr + u, rho)
                u = u + xr - z_new
                dz = torch.max(torch.abs(z_new - z))
                z = z_new
        # residual balancing: move rho by sqrt(primal/dual), clipped, and
        # rescale the scaled dual
        r_prim = torch.max(torch.abs(x - z))
        r_dual = rho * dz
        ratio = (r_prim + 1e-30) / (r_dual + 1e-30)
        step = torch.clamp(torch.sqrt(ratio), 1.0 / _RHO_STEP_CLIP, _RHO_STEP_CLIP)
        rho_new = torch.clamp(rho * step, *_RHO_BOUNDS)
        done = (r_prim + r_dual) <= torch.finfo(dtype).eps
        rho_new = torch.where(done, rho, rho_new)
        return x, z, u * (rho / rho_new), rho_new

    rho = _rho_start(prob, l1, rho0)
    if warm is None:
        z = torch.clamp(torch.zeros(n, dtype=dtype, device=dev), prob.lo, prob.hi)
        u = torch.zeros(n, dtype=dtype, device=dev)
    else:
        # yesterday's iterates snapped into today's box; the scaled dual is
        # re-centered on today's starting rho; a non-finite carry resets
        rho_prev = torch.nan_to_num(warm.rho, nan=0.0)
        z = torch.clamp(torch.nan_to_num(warm.z), prob.lo, prob.hi)
        u = torch.nan_to_num(warm.u) * (rho_prev / rho)
    x = z
    iters = int(iters)
    schedule = ([min(_ADAPT_EVERY, iters - k * _ADAPT_EVERY)
                 for k in range(-(-iters // _ADAPT_EVERY))] or [0])
    for seg_len in schedule:
        x, z, u, rho = segment(x, z, u, rho, seg_len)
    x = x_step(factor(rho), z, u, rho)  # final equality-exact x-step
    prim = torch.max(torch.abs(x - z))

    nan = torch.full((), float("nan"), dtype=dtype, device=dev)
    if polish_ops is None:
        return ADMMResult(x=x, z=z, primal_residual=prim, u=u, rho=rho,
                          polished=torch.zeros((), dtype=torch.bool, device=dev),
                          polish_pre_residual=nan, polish_post_residual=nan)
    mv, masked_solver = polish_ops
    x_p, nu = _polish_candidate(mv, masked_solver, prob, q, l1, z,
                                passes=polish_passes)
    # guarded acceptance: no less feasible than the exit x, and no worse in
    # objective than the box-projected exit iterate (dual-scaled slack)
    pre_r = _box_eq_residual(prob, x)
    post_r = _box_eq_residual(prob, x_p)
    obj_ref = _qp_objective(mv, prob, q, l1, torch.clamp(x, prob.lo, prob.hi))
    slack = (_POLISH_OBJ_TOL * (1.0 + torch.abs(obj_ref))
             + torch.abs(nu).sum() * pre_r)
    accepted = (torch.isfinite(x_p).all()
                & (post_r <= pre_r + _POLISH_RES_TOL)
                & (_qp_objective(mv, prob, q, l1, x_p) <= obj_ref + slack))
    return ADMMResult(x=torch.where(accepted, x_p, x), z=z,
                      primal_residual=torch.where(accepted, post_r, prim),
                      u=u, rho=rho, polished=accepted,
                      polish_pre_residual=pre_r, polish_post_residual=post_r)


class _LowRank(NamedTuple):
    """Scaled low-rank operator P/scale = a I + V' diag(ss) V."""

    a: torch.Tensor        # [] scaled identity term
    V: torch.Tensor        # [T, n]
    ss: torch.Tensor       # [T] scaled row weights
    inv_ss: torch.Tensor   # [T, T] diag(1/ss), 1e12 where ss == 0
    vvt: torch.Tensor      # [T, T] V V'


def _lowrank_factor(op: _LowRank, rho):
    """(d, inner Cholesky) of (P + rho I) by Woodbury:
    (dI + V'SV)^-1 = I/d - V'(S^-1 + V V'/d)^-1 V / d^2."""
    d = op.a + rho
    return d, _chol(op.inv_ss + op.vvt / d)


def _lowrank_solver(op: _LowRank, d, inner):
    def solve_m(r):
        rd = r / d
        return rd - (op.V.T @ _cho_solve(inner, op.V @ rd)) / d
    return solve_m


def segment_operands(op: _LowRank, prob: BoxQPProblem, l1, rho):
    """The fused segment kernel's operands at ``rho``, built outside the
    kernel from the same one factorization the reference x-step uses:
    ``(d, V, kinv, minv_et_t, ge, xb, thresh)`` with ``kinv`` the Woodbury
    inner inverse, ``ge = G^{-1} E`` and ``xb = Minv_Et G^{-1} b``."""
    n = op.V.shape[-1]
    t = op.V.shape[0]
    dr, inner = _lowrank_factor(op, rho)
    solve_m = _lowrank_solver(op, dr, inner)
    eye_t = torch.eye(t, dtype=op.V.dtype, device=op.V.device)
    kinv = _cho_solve(inner, eye_t)                   # [T, T]
    minv_et = solve_m(prob.E.T)                       # [n, K]
    g = prob.E @ minv_et
    ginv = _cho_solve(_chol(g), torch.eye(g.shape[0], dtype=g.dtype,
                                          device=g.device))
    ge = ginv @ prob.E                                # [K, n]
    xb = minv_et @ (ginv @ prob.b)                    # [n]
    thresh = torch.broadcast_to(l1 / rho, (n,))
    return dr.expand(n), op.V, kinv, minv_et.T, ge, xb, thresh


def _scaled_lowrank(alpha, V, s, prob: BoxQPProblem, vvt=None):
    """The problem pre-scaled by mean(diag P): ``(op, q, l1)``."""
    alpha = torch.as_tensor(alpha, dtype=V.dtype, device=V.device)
    if alpha.ndim != 0:
        raise NotImplementedError(
            "a vector alpha (the risk-model covariance) is not ported yet")
    n = V.shape[-1]
    scale = torch.clamp(alpha + (s[:, None] * V * V).sum() / n, min=1e-12)
    ss = s / scale
    inv_ss = torch.diag(torch.where(ss > 0, 1.0 / torch.where(ss > 0, ss, 1.0),
                                    1e12))
    op = _LowRank(a=alpha / scale, V=V, ss=ss, inv_ss=inv_ss,
                  vvt=V @ V.T if vvt is None else vvt)
    return op, prob.q / scale, prob.l1 / scale


def first_segment_inputs(alpha, V, s, prob: BoxQPProblem, *, rho: float = 2.0):
    """The full argument tuple of
    :func:`~factormodeling_tpu_torch.ops._cuda_admm.admm_segment` for the
    first segment of a cold :func:`admm_solve_lowrank` solve — the operands
    the solver hands the kernel, for checking and timing it alone:
    ``(d, V, kinv, minv_et_t, ge, xb, q, lo, hi, center, thresh, z, u,
    rho)``."""
    op, q, l1 = _scaled_lowrank(alpha, V, s, prob)
    rho0 = _rho_start(prob, l1, rho)
    z = torch.clamp(torch.zeros_like(q), prob.lo, prob.hi)
    d, Vk, kinv, minv_et_t, ge, xb, thresh = segment_operands(op, prob, l1, rho0)
    return (d, Vk, kinv, minv_et_t, ge, xb, q, prob.lo, prob.hi, prob.center,
            thresh, z, torch.zeros_like(q), rho0)


def admm_solve_lowrank(alpha, V: torch.Tensor, s: torch.Tensor,
                       prob: BoxQPProblem, *, rho: float = 2.0,
                       iters: int = 500, relax: float = 1.7,
                       warm_start: ADMMWarmState | None = None,
                       polish: bool = True,
                       polish_passes: int | None = None,
                       vvt: torch.Tensor | None = None,
                       kernel: str = "reference") -> ADMMResult:
    """Low-rank path: ``P = alpha I + V' diag(s) V`` with scalar ``alpha``
    (a 0-d tensor or float) and ``V`` ``[T, n]``, ``T << n``.

    ``rho`` is the initial penalty; exactly ``iters`` iterations run in
    segments of ``_ADAPT_EVERY``. ``warm_start`` seeds (z, u, rho) from a
    previous related solve. ``polish`` runs the guarded active-set
    refinement at exit. ``vvt`` is an optional precomputed ``V @ V.T``.
    ``kernel``: ``"reference"`` runs the iteration loop in torch ops;
    ``"fused"`` runs each segment as one launch of the segment kernel (its
    plain version on a CPU tensor) for ``n <= _FUSED_SEGMENT_MAX_N``.
    """
    if kernel not in ("reference", "fused"):
        raise ValueError(f"unknown solver kernel {kernel!r}")
    n = V.shape[-1]
    op, q, l1 = _scaled_lowrank(alpha, V, s, prob, vvt)
    ss, inv_ss = op.ss, op.inv_ss

    def make_solver(rho):
        return _lowrank_solver(op, *_lowrank_factor(op, rho))

    def mv(v):
        return op.a * v + V.T @ (ss * (V @ v))

    def masked_solver(m):
        # M P M + diag(1 - m) + delta I keeps the Woodbury structure
        d = op.a * m + (1.0 - m) + _POLISH_DELTA
        vm = V * m
        inner = _chol(inv_ss + (vm / d) @ vm.T)

        def solve_m(r):
            dd = d[:, None] if r.ndim == 2 else d
            rd = r / dd
            return rd - (vm.T @ _cho_solve(inner, vm @ rd)) / dd

        return solve_m

    fused = None
    if kernel == "fused" and n <= _FUSED_SEGMENT_MAX_N:
        def fused(z, u, rho, seg_len):
            d, Vk, kinv, minv_et_t, ge, xb, thresh = segment_operands(
                op, prob, l1, rho)
            return admm_segment(d, Vk, kinv, minv_et_t, ge, xb, q, prob.lo,
                                prob.hi, prob.center, thresh, z, u, rho,
                                relax=float(relax), seg_len=int(seg_len))

    return _admm_iterations(make_solver, prob, q, l1, rho, iters, relax,
                            warm=warm_start,
                            polish_ops=(mv, masked_solver) if polish else None,
                            polish_passes=(_POLISH_PASSES if polish_passes
                                           is None else int(polish_passes)),
                            fused_segment=fused)
