"""Fixed-iteration ADMM for box-constrained QPs with equality rows and an
optional L1 (turnover) term (port of
``factormodeling_tpu/solvers/admm_qp.py``: the low-rank path).

Problem form::

    minimize   1/2 x'Px + q'x + sum_i l1[i] * |x[i] - center[i]|
    subject to lo <= x <= hi,   E x = b        (K small: the 2 leg rows)

with ``P = diag(alpha) + V' diag(s) V`` (``V`` is ``[T, n]``, T << n;
``alpha`` a scalar — the sample covariance's shrinkage identity — or an
``[n]`` vector — a statistical risk model's idiosyncratic variances),
applied through a Woodbury identity with one T x T Cholesky. The objective
is pre-scaled by mean(diag P); the iterations run in segments of
``_ADAPT_EVERY`` with residual-balanced adaptive rho between them; the exit
iterate goes through the guarded active-set polish. ``anderson > 0`` turns
on the safeguarded Anderson accelerator on the (z, u) fixed point
(:func:`factormodeling_tpu_torch.ops._cuda_admm.anderson_step`); its
history resets at every segment. See the JAX module for the measured
rationale of every constant, which the port keeps as is.

Lanes: :func:`admm_solve_lowrank` takes one problem or a batch of ``B``
independent ones stacked on a leading axis (``V [B, T, n]``, vectors
``[B, n]``, warm ``rho [B]``) — what ``jax.vmap`` of the JAX solver
computes. Every reduction is per lane and every ladder decision is a
``torch.where`` on the device: nothing here reads a tensor back to the
host, so a loop over solves never synchronizes. Failed factorizations
surface as NaN (``cholesky_ex`` without its check), as they do in JAX, for
the caller's fallback ladder to catch.

``kernel="fused"`` runs each segment, for all lanes, as one launch of the
CUDA kernel (:func:`factormodeling_tpu_torch.ops._cuda_admm.admm_segment`)
against explicit small inverses built here per rho
(:func:`segment_operands`); problems wider than ``_FUSED_SEGMENT_MAX_N``
take the reference loop, the JAX package's one routing rule.

:func:`admm_solve_dense` is the dense-P path for small n (the
factor-selection MVO): ``P [(B,) n, n]`` with one Cholesky of
``P + rho I`` per lane and rho, on the same lane-generic loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from factormodeling_tpu_torch.obs import probes as _obs_probes
from factormodeling_tpu_torch.ops._cuda_admm import (_CONV_TOL, admm_segment,
                                                     anderson_init,
                                                     anderson_step,
                                                     _AA_PLAIN_TAIL)

__all__ = ["ADMMResult", "ADMMWarmState", "BoxQPProblem", "admm_solve_dense",
           "admm_solve_lowrank", "first_segment_inputs", "segment_operands"]


@dataclasses.dataclass(frozen=True)
class BoxQPProblem:
    """One QP instance, or ``B`` lanes of them on a leading axis."""

    q: torch.Tensor          # [(B,) n] linear term
    lo: torch.Tensor         # [(B,) n] lower bounds (pin with lo == hi)
    hi: torch.Tensor         # [(B,) n] upper bounds
    E: torch.Tensor          # [(B,) K, n] equality rows
    b: torch.Tensor          # [(B,) K]
    l1: torch.Tensor | float  # L1 weight: [], [n] (one problem) or
                             # [], [B], [B, n] (lanes); 0 disables
    center: torch.Tensor     # [(B,) n] L1 center (e.g. yesterday's weights)


class ADMMResult(NamedTuple):
    x: torch.Tensor          # equality-exact iterate (polished when accepted)
    z: torch.Tensor          # box/L1-exact iterate (loop exit; warm carry)
    primal_residual: torch.Tensor  # max |x - z|; box/eq residual if polished
    u: torch.Tensor          # scaled dual at exit (warm carry)
    rho: torch.Tensor        # adapted penalty at exit (warm carry)
    polished: torch.Tensor   # bool: polish ran AND was accepted
    polish_pre_residual: torch.Tensor   # box/eq residual before polish (NaN
    polish_post_residual: torch.Tensor  # / after; NaN when polish disabled)
    aa_accepted: torch.Tensor  # int32: Anderson extrapolations taken
    aa_rejected: torch.Tensor  # int32: safeguard rollbacks
    # first 1-based iteration at which max(|x - z|, rho dz) <= _CONV_TOL,
    # 0 if never; None unless the solve collected it
    iters_to_converge: torch.Tensor | None = None
    # [(B,) n_segments, 3] per segment: primal residual, dual residual and
    # the adapted rho; None unless the solve collected it
    residual_traj: torch.Tensor | None = None

    @property
    def warm_state(self) -> "ADMMWarmState":
        """The loop-exit (z, u, rho) triple to seed the next related solve."""
        return ADMMWarmState(z=self.z, u=self.u, rho=self.rho)


class ADMMWarmState(NamedTuple):
    """Warm-start state from a previous related solve (per lane under a
    lane axis): ``z`` is clipped into the new box, ``u`` (the scaled dual)
    is re-scaled by ``rho_prev / rho_start``; NaN ``rho`` means cold."""

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


def _apply(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` per lane: ``a [B, m, n]`` on ``x [B, n]`` or ``[B, n, k]``
    (``bmm`` itself: ``matmul``'s broadcasting costs host time per call in
    a launch-bound day loop). On the CPU a vector ``x`` is a product and a
    sum over the last axis: there ``bmm`` of one lane takes the BLAS
    matrix-vector routine and of more lanes the matrix-matrix one, whose
    sums part in the last bit, and a lane computes its unbatched call's
    bits. On the card ``bmm`` stays: one launch, where the day loop pays
    for each, and the card's lanes are held to their single-lane solves at
    a tolerance."""
    if x.ndim == 2:
        if x.is_cuda:
            return torch.bmm(a, x.unsqueeze(-1)).squeeze(-1)
        return (a * x[:, None, :]).sum(-1)
    return torch.bmm(a, x)


def _chol(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization failed (no host
    check, unlike ``torch.linalg.cholesky``)."""
    low, info = torch.linalg.cholesky_ex(a)
    return torch.where(info[..., None, None] == 0, low, float("nan"))


def _cho_solve(low: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve with a ``[B, m, m]`` Cholesky factor; ``r`` is ``[B, m]`` or
    ``[B, m, k]``."""
    if r.ndim == low.ndim - 1:
        return torch.cholesky_solve(r[..., None], low)[..., 0]
    return torch.cholesky_solve(r, low)


def _soft(a, k):
    return torch.sign(a) * torch.clamp(torch.abs(a) - k, min=0.0)


def _box_eq_residual(prob: BoxQPProblem, v):
    """max(box violation, |E v - b|_inf) per lane: the polish feasibility
    metric."""
    box = torch.clamp(torch.maximum(prob.lo - v, v - prob.hi), min=0.0).amax(-1)
    return torch.maximum(box, torch.abs(_apply(prob.E, v) - prob.b).amax(-1))


def _qp_objective(mv, prob: BoxQPProblem, q, l1, v):
    """Scaled objective 1/2 v'Pv + q'v + sum l1 |v - center| per lane."""
    return (0.5 * (v * mv(v)).sum(-1) + (q * v).sum(-1)
            + (l1 * torch.abs(v - prob.center)).sum(-1))


def _reduced_kkt_solve(mv, masked_solver, prob: BoxQPProblem, q, m, xa, qt):
    """The reduced equality-constrained QP of one polish pass,
    ``min 1/2 y'(MPM)y + qt'y  s.t.  (EM) y = b - E xa``, with masked rows
    and one iterative-refinement step; returns ``(x_candidate, nu)``."""
    b_red = prob.b - _apply(prob.E, xa)
    em = prob.E * m[:, None, :]                      # [B, K, n] masked rows
    solve_h = masked_solver(m)
    minv_et = solve_h(em.mT)                         # [B, n, K]
    g = _apply(em, minv_et)                          # [B, K, K]
    g = g + _POLISH_DELTA * torch.eye(g.shape[-1], dtype=g.dtype,
                                      device=g.device)
    g_lu, g_piv, _ = torch.linalg.lu_factor_ex(g)

    def kkt(r1, r2):
        y0 = solve_h(r1)
        nu = torch.linalg.lu_solve(g_lu, g_piv,
                                   (_apply(em, y0) - r2)[..., None])[..., 0]
        return y0 - _apply(minv_et, nu), nu

    y, nu = kkt(-qt, b_red)
    r1 = -qt - (m * mv(m * y) + (1.0 - m) * y) - _apply(em.mT, nu)
    r2 = b_red - _apply(em, y)
    dy, dnu = kkt(r1, r2)
    return xa + m * (y + dy), nu + dnu


def _polish_candidate(mv, masked_solver, prob: BoxQPProblem, q, l1, z,
                      passes: int = _POLISH_PASSES):
    """Guarded active-set KKT refinement candidate per lane, fixed-shape:
    the active set is read off the prox exit ``z`` by equality, then
    re-identified over ``passes`` passes from each candidate's KKT
    conditions; the best candidate (feasibility, then objective) is
    returned with its reduced equality multipliers ``nu``."""
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
    b_scale = (1.0 + torch.abs(prob.b).amax(-1))[:, None]
    box_scale = (1.0 + torch.maximum(torch.abs(prob.lo),
                                     torch.abs(prob.hi)).amax(-1))[:, None]

    lanes, n, k = z.shape[0], z.shape[-1], prob.b.shape[-1]
    best = (torch.full((lanes,), big, dtype=dtype, device=z.device),
            torch.full((lanes,), big, dtype=dtype, device=z.device),
            torch.zeros((lanes, n), dtype=dtype, device=z.device),
            torch.zeros((lanes, k), dtype=dtype, device=z.device))
    for _ in range(passes):
        active = at_lo | at_hi | at_kink
        m = (~active).to(dtype)
        x_fix = torch.where(at_kink, prob.center,
                            torch.where(at_hi, prob.hi, prob.lo))
        xa = torch.where(active, x_fix, 0.0)
        qt = (q + l1v * side + mv(xa)) * m
        x_p, nu = _reduced_kkt_solve(mv, masked_solver, prob, q, m, xa, qt)

        finite = torch.isfinite(x_p).all(-1)
        f_p = torch.where(finite, _box_eq_residual(prob, x_p), big)
        o_p = torch.where(finite, _qp_objective(mv, prob, q, l1, x_p), big)
        better = (f_p < best[0] - _POLISH_RES_TOL) | (
            (f_p <= best[0] + _POLISH_RES_TOL) & (o_p < best[1]))
        best = (torch.where(better, f_p, best[0]),
                torch.where(better, o_p, best[1]),
                torch.where(better[:, None], x_p, best[2]),
                torch.where(better[:, None], nu, best[3]))

        # re-identify from the candidate's KKT conditions
        gtot = mv(x_p) + q + _apply(prob.E.mT, nu)
        tol = _POLISH_REL_TOL * (l1v + torch.abs(gtot)) + tiny
        free = m > 0
        viol = torch.maximum(prob.lo - x_p, x_p - prob.hi)
        blast = free & (l1v > 0) & (viol > _POLISH_BLAST * box_scale)
        side = torch.where(blast, torch.sign(x_p - prob.center), side)
        crossed = (free & ~blast & (l1v > 0) & kinkable
                   & (side * (x_p - prob.center) < 0))
        join_lo = free & ~blast & ~crossed & (x_p < prob.lo)
        join_hi = free & ~blast & ~crossed & (x_p > prob.hi)
        may_release = (finite[:, None]
                       & (f_p[:, None] <= _POLISH_RELEASE_GATE * b_scale))
        rel_lo = at_lo & ~pinned & may_release & (-gtot - l1v * smax_lo > tol)
        rel_hi = at_hi & ~pinned & may_release & (-gtot - l1v * smin_hi < -tol)
        rel_kink = at_kink & may_release & (torch.abs(gtot) > l1v + tol)
        side = torch.where(rel_kink, -torch.sign(gtot), side)
        side = torch.where(rel_lo, smax_lo, side)
        side = torch.where(rel_hi, smin_hi, side)
        # deadlock breaker: an all-pinned leg with an unmet equality
        deficit = prob.b - _apply(prob.E, x_p)
        leg_dead = ((torch.abs(deficit) > _POLISH_RES_TOL * b_scale)
                    & ((prob.E * m[:, None, :]).sum(-1) <= 0))
        need_up = _apply(prob.E.mT, (leg_dead & (deficit > 0)).to(dtype)) > 0
        need_dn = _apply(prob.E.mT, (leg_dead & (deficit < 0)).to(dtype)) > 0
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


def _collecting(collect) -> bool:
    """``collect``, or the probes gate where it is None."""
    if collect is None:
        return _obs_probes.collection_active()
    return bool(collect)


def _rho_start(prob: BoxQPProblem, l1, rho0: float):
    """Problem-aware initial penalty rho* ~ l1 * n_free / 20 per lane,
    clipped."""
    n_free = torch.clamp((prob.hi > prob.lo).sum(-1), min=1).to(prob.lo.dtype)
    return torch.clamp(torch.clamp(l1.amax(-1) * n_free / 20.0, min=rho0),
                       *_RHO_BOUNDS)


def _admm_iterations(make_solver, prob: BoxQPProblem, q, l1, rho0, iters,
                     relax, warm=None, polish_ops=None,
                     polish_passes: int = _POLISH_PASSES, anderson: int = 0,
                     collect: bool = False, fused_segment=None):
    """Shared ADMM loop with residual-balanced adaptive rho, over lanes.

    ``make_solver(rho)`` returns a function applying (P + rho I)^{-1}; the
    equality-constrained x-step is ``x = xt - Minv_Et nu``,
    ``nu = G^{-1}(E xt - b)`` with ``xt = solve_m(rho (z - u) - q)``.
    ``polish_ops`` is ``None`` or ``(mv, masked_solver)``. ``anderson``:
    history depth of the safeguarded Anderson accelerator (0 off).
    ``collect``: tally the first iteration reaching ``_CONV_TOL`` and keep
    the per-segment residual trajectory.
    ``fused_segment``: optional ``(z, u, rho, seg_len, last) -> (x, z, u,
    dz, acc, rej, conv)`` running one whole segment; the residual-balancing
    tail is shared.
    """
    lanes, n = q.shape
    dtype, dev = q.dtype, q.device

    def factor(rho):
        solve_m = make_solver(rho)
        minv_et = solve_m(prob.E.mT)                 # [B, n, K]
        g_chol = _chol(_apply(prob.E, minv_et))      # [B, K, K]
        return solve_m, minv_et, g_chol

    def x_step(fac, z, u, rho):
        solve_m, minv_et, g_chol = fac
        xt = solve_m(rho[:, None] * (z - u) - q)
        nu = _cho_solve(g_chol, _apply(prob.E, xt) - prob.b)
        return xt - _apply(minv_et, nu)

    def z_step(v, rho):
        moved = prob.center + _soft(v - prob.center, l1 / rho[:, None])
        return torch.clamp(moved, prob.lo, prob.hi)

    def segment(x, z, u, rho, seg_len, it_base, last, tallies):
        acc, rej, conv = tallies
        if fused_segment is not None:
            x, z, u, dz, acc2, rej2, conv2 = fused_segment(z, u, rho, seg_len,
                                                           last)
            acc, rej = acc + acc2, rej + rej2
            if collect:
                conv = torch.where((conv == 0) & (conv2 > 0), it_base + conv2,
                                   conv)
        else:
            fac = factor(rho)
            dz = torch.zeros(lanes, dtype=dtype, device=dev)
            aa = anderson_init(z, u, anderson) if anderson else None
            for i in range(seg_len):
                x = x_step(fac, z, u, rho)
                xr = relax * x + (1.0 - relax) * z   # over-relaxation
                z_new = z_step(xr + u, rho)
                u_new = u + xr - z_new
                dz = torch.abs(z_new - z).amax(-1)
                if collect or anderson:
                    r_c = torch.maximum(torch.abs(x - z_new).amax(-1), rho * dz)
                if collect:
                    conv = torch.where((conv == 0) & (r_c <= _CONV_TOL),
                                       it_base + i + 1, conv)
                if anderson:
                    aa, z_new, u_new, use, grew = anderson_step(
                        aa, i, z, u, z_new, u_new, r_c,
                        tail=last and i >= seg_len - _AA_PLAIN_TAIL)
                    acc = acc + use.to(torch.int32)
                    rej = rej + grew.to(torch.int32)
                z, u = z_new, u_new
        # residual balancing: move rho by sqrt(primal/dual), clipped, and
        # rescale the scaled dual
        r_prim = torch.abs(x - z).amax(-1)
        r_dual = rho * dz
        ratio = (r_prim + 1e-30) / (r_dual + 1e-30)
        step = torch.clamp(torch.sqrt(ratio), 1.0 / _RHO_STEP_CLIP, _RHO_STEP_CLIP)
        rho_new = torch.clamp(rho * step, *_RHO_BOUNDS)
        done = (r_prim + r_dual) <= torch.finfo(dtype).eps
        rho_new = torch.where(done, rho, rho_new)
        if collect:
            traj.append(torch.stack((r_prim, r_dual, rho_new), -1))
        return x, z, u * (rho / rho_new)[:, None], rho_new, (acc, rej, conv)

    rho = _rho_start(prob, l1, rho0)
    if warm is None:
        z = torch.clamp(torch.zeros((lanes, n), dtype=dtype, device=dev),
                        prob.lo, prob.hi)
        u = torch.zeros((lanes, n), dtype=dtype, device=dev)
    else:
        # yesterday's iterates snapped into today's box; the scaled dual is
        # re-centered on today's starting rho; a non-finite carry resets
        rho_prev = torch.nan_to_num(warm.rho, nan=0.0)
        z = torch.clamp(torch.nan_to_num(warm.z), prob.lo, prob.hi)
        u = torch.nan_to_num(warm.u) * (rho_prev / rho)[:, None]
    x = z
    traj: list = []
    tallies = tuple(torch.zeros(lanes, dtype=torch.int32, device=dev)
                    for _ in range(3))
    iters = int(iters)
    schedule = ([min(_ADAPT_EVERY, iters - k * _ADAPT_EVERY)
                 for k in range(-(-iters // _ADAPT_EVERY))] or [0])
    it_base = 0
    for si, seg_len in enumerate(schedule):
        x, z, u, rho, tallies = segment(x, z, u, rho, seg_len, it_base,
                                        si == len(schedule) - 1, tallies)
        it_base += seg_len
    x = x_step(factor(rho), z, u, rho)  # final equality-exact x-step
    prim = torch.abs(x - z).amax(-1)
    acc, rej, conv = tallies
    extras = dict(aa_accepted=acc, aa_rejected=rej,
                  iters_to_converge=conv if collect else None,
                  residual_traj=torch.stack(traj, 1) if collect else None)

    nan = torch.full((lanes,), float("nan"), dtype=dtype, device=dev)
    if polish_ops is None:
        return ADMMResult(x=x, z=z, primal_residual=prim, u=u, rho=rho,
                          polished=torch.zeros(lanes, dtype=torch.bool,
                                               device=dev),
                          polish_pre_residual=nan, polish_post_residual=nan,
                          **extras)
    mv, masked_solver = polish_ops
    x_p, nu = _polish_candidate(mv, masked_solver, prob, q, l1, z,
                                passes=polish_passes)
    # guarded acceptance: no less feasible than the exit x, and no worse in
    # objective than the box-projected exit iterate (dual-scaled slack)
    pre_r = _box_eq_residual(prob, x)
    post_r = _box_eq_residual(prob, x_p)
    obj_ref = _qp_objective(mv, prob, q, l1, torch.clamp(x, prob.lo, prob.hi))
    slack = (_POLISH_OBJ_TOL * (1.0 + torch.abs(obj_ref))
             + torch.abs(nu).sum(-1) * pre_r)
    accepted = (torch.isfinite(x_p).all(-1)
                & (post_r <= pre_r + _POLISH_RES_TOL)
                & (_qp_objective(mv, prob, q, l1, x_p) <= obj_ref + slack))
    return ADMMResult(x=torch.where(accepted[:, None], x_p, x), z=z,
                      primal_residual=torch.where(accepted, post_r, prim),
                      u=u, rho=rho, polished=accepted,
                      polish_pre_residual=pre_r, polish_post_residual=post_r,
                      **extras)


class _LowRank(NamedTuple):
    """Scaled low-rank operator per lane,
    P/scale = diag(a) + V' diag(ss) V."""

    a: torch.Tensor        # [B] scaled identity term, or [B, n] diagonal
    V: torch.Tensor        # [B, T, n]
    ss: torch.Tensor       # [B, T] scaled row weights
    inv_ss: torch.Tensor   # [B, T, T] diag(1/ss), 1e12 where ss == 0
    vvt: torch.Tensor | None  # [B, T, T] V V' (scalar a only)

    def diag(self, like: torch.Tensor) -> torch.Tensor:
        """``a`` broadcastable against ``like`` (``[B, n]`` or
        ``[B, n, k]``)."""
        a = self.a if self.a.ndim == 2 else self.a[:, None]
        return a if like.ndim == 2 else a[..., None]


def _lowrank_factor(op: _LowRank, rho):
    """(d, inner Cholesky) of (P + rho I) by Woodbury:
    (D + V'SV)^-1 = D^-1 - D^-1 V'(S^-1 + V D^-1 V')^-1 V D^-1. A scalar d
    reuses the cached V V'; a vector d rebuilds V D^-1 V' per refactor."""
    if op.vvt is None:
        d = op.a + rho[:, None]                      # [B, n]
        vdv = _apply(op.V / d[:, None, :], op.V.mT)
    else:
        d = op.a + rho                               # [B]
        vdv = op.vvt / d[:, None, None]
    return d, _chol(op.inv_ss + vdv)


def _div_d(r, d):
    """``r / d`` for ``r [B, n]`` or ``[B, n, k]`` and ``d [B]`` or
    ``[B, n]``."""
    dd = d if d.ndim == 2 else d[:, None]
    return r / (dd if r.ndim == 2 else dd[..., None])


def _lowrank_solver(op: _LowRank, d, inner):
    def solve_m(r):
        rd = _div_d(r, d)
        return rd - _div_d(_apply(op.V.mT, _cho_solve(inner, _apply(op.V, rd))), d)
    return solve_m


def segment_operands(op: _LowRank, prob: BoxQPProblem, l1, rho):
    """The fused segment kernel's operands at ``rho`` for every lane, built
    outside the kernel from the same one factorization the reference x-step
    uses: ``(d, V, kinv, minv_et_t, ge, xb, thresh)`` with ``kinv`` the
    Woodbury inner inverse, ``ge = G^{-1} E`` and
    ``xb = Minv_Et G^{-1} b``."""
    lanes, t, n = op.V.shape
    dr, inner = _lowrank_factor(op, rho)
    solve_m = _lowrank_solver(op, dr, inner)
    eye_t = torch.eye(t, dtype=op.V.dtype, device=op.V.device)
    kinv = _cho_solve(inner, eye_t.expand(lanes, t, t))   # [B, T, T]
    minv_et = solve_m(prob.E.mT)                          # [B, n, K]
    g = _apply(prob.E, minv_et)
    k = g.shape[-1]
    ginv = _cho_solve(_chol(g), torch.eye(k, dtype=g.dtype, device=g.device)
                      .expand(lanes, k, k))
    ge = _apply(ginv, prob.E)                             # [B, K, n]
    xb = _apply(minv_et, _apply(ginv, prob.b))            # [B, n]
    d = dr if dr.ndim == 2 else dr[:, None]
    return (d.expand(lanes, n), op.V, kinv, minv_et.mT, ge, xb,
            torch.broadcast_to(l1 / rho[:, None], (lanes, n)))


def _scaled_lowrank(alpha, V, s, prob: BoxQPProblem, vvt=None):
    """The problem pre-scaled by mean(diag P) per lane: ``(op, q, l1)``;
    ``alpha`` is ``[B]`` (scalar per lane) or ``[B, n]``."""
    n = V.shape[-1]
    vector = alpha.ndim == 2
    alpha_mean = alpha.mean(-1) if vector else alpha
    scale = torch.clamp(alpha_mean + (s[..., None] * V * V).sum((-2, -1)) / n,
                        min=1e-12)                         # [B]
    ss = s / scale[:, None]
    inv_ss = torch.diag_embed(
        torch.where(ss > 0, 1.0 / torch.where(ss > 0, ss, 1.0), 1e12))
    if not vector and vvt is None:
        vvt = _apply(V, V.mT)
    op = _LowRank(a=alpha / (scale[:, None] if vector else scale), V=V, ss=ss,
                  inv_ss=inv_ss, vvt=None if vector else vvt)
    return op, prob.q / scale[:, None], prob.l1 / scale[:, None]


def _on_device(a, dtype, dev) -> torch.Tensor:
    """``a`` as a tensor on ``dev``: a Python number becomes a fill on the
    device (a blocking host-to-device copy would make every solve wait for
    the card)."""
    if isinstance(a, (int, float)):
        return torch.full((), float(a), dtype=dtype, device=dev)
    return torch.as_tensor(a, dtype=dtype, device=dev)


def _problem_lanes(prob: BoxQPProblem, warm, single: bool, lanes: int,
                   dtype, dev):
    """Give one problem a lane axis of 1 (``single``) and normalize ``l1``
    to ``[B, 1]`` or ``[B, n]``. Returns ``(prob, warm)``."""
    l1 = _on_device(prob.l1, dtype, dev)
    if single:
        prob = BoxQPProblem(q=prob.q[None], lo=prob.lo[None], hi=prob.hi[None],
                            E=prob.E[None], b=prob.b[None],
                            l1=l1.reshape(1, -1), center=prob.center[None])
        if warm is not None:
            warm = ADMMWarmState(z=warm.z[None], u=warm.u[None],
                                 rho=torch.as_tensor(warm.rho).reshape(1))
        return prob, warm
    l1 = l1.reshape(1, 1) if l1.ndim == 0 else l1
    l1 = l1[:, None] if l1.ndim == 1 else l1
    return dataclasses.replace(prob, l1=l1.expand(lanes, l1.shape[-1])), warm


def _as_lanes(alpha, V, s, prob: BoxQPProblem, warm):
    """Give one problem a lane axis of 1 and normalize ``alpha`` to ``[B]``
    or ``[B, n]`` and ``l1`` to ``[B, 1]`` or ``[B, n]``. Returns
    ``(single, alpha, V, s, prob, warm)``."""
    dtype, dev = V.dtype, V.device
    alpha = _on_device(alpha, dtype, dev)
    single = V.ndim == 2
    if single:
        V, s, alpha = V[None], s[None], alpha[None]
    prob, warm = _problem_lanes(prob, warm, single, V.shape[0], dtype, dev)
    return single, alpha, V, s, prob, warm


def first_segment_inputs(alpha, V, s, prob: BoxQPProblem, *, rho: float = 2.0):
    """The full argument tuple of
    :func:`~factormodeling_tpu_torch.ops._cuda_admm.admm_segment` for the
    first segment of a cold :func:`admm_solve_lowrank` solve — the operands
    the solver hands the kernel, for checking and timing it alone:
    ``(d, V, kinv, minv_et_t, ge, xb, q, lo, hi, center, thresh, z, u,
    rho)``, with the lane axis when ``V`` has one."""
    single, alpha, V, s, prob, _ = _as_lanes(alpha, V, s, prob, None)
    op, q, l1 = _scaled_lowrank(alpha, V, s, prob)
    rho0 = _rho_start(prob, l1, rho)
    z = torch.clamp(torch.zeros_like(q), prob.lo, prob.hi)
    d, Vk, kinv, minv_et_t, ge, xb, thresh = segment_operands(op, prob, l1, rho0)
    out = (d, Vk, kinv, minv_et_t, ge, xb, q, prob.lo, prob.hi, prob.center,
           thresh, z, torch.zeros_like(q), rho0)
    return tuple(o[0] for o in out) if single else out


def admm_solve_lowrank(alpha, V: torch.Tensor, s: torch.Tensor,
                       prob: BoxQPProblem, *, rho: float = 2.0,
                       iters: int = 500, relax: float = 1.7,
                       warm_start: ADMMWarmState | None = None,
                       polish: bool = True,
                       polish_passes: int | None = None,
                       vvt: torch.Tensor | None = None,
                       anderson: int = 0, collect: bool | None = None,
                       kernel: str = "reference") -> ADMMResult:
    """Low-rank path: ``P = diag(alpha) + V' diag(s) V`` with ``V``
    ``[T, n]``, ``T << n``, or ``B`` lanes of such problems with ``V``
    ``[B, T, n]`` and every other operand on the same leading axis.

    ``alpha`` is a scalar (a float or 0-d tensor; ``[B]`` under lanes) or an
    ``[n]`` vector (``[B, n]``). ``rho`` is the initial penalty; exactly
    ``iters`` iterations run in segments of ``_ADAPT_EVERY``.
    ``warm_start`` seeds (z, u, rho) from a previous related solve.
    ``polish`` runs the guarded active-set refinement at exit. ``vvt`` is an
    optional precomputed ``V @ V.T`` (scalar alpha only). ``anderson`` is
    the Anderson history depth (0 off). ``collect`` fills
    ``iters_to_converge`` and ``residual_traj``; None reads
    :func:`~factormodeling_tpu_torch.obs.probes.collection_active` here,
    where the solve starts, as the JAX package reads it where the solve is
    traced.
    ``kernel``: ``"reference"`` runs the iteration loop in torch ops;
    ``"fused"`` runs each segment, all lanes at once, as one launch of the
    segment kernel (its plain version on a CPU tensor) for
    ``n <= _FUSED_SEGMENT_MAX_N``.
    """
    if kernel not in ("reference", "fused"):
        raise ValueError(f"unknown solver kernel {kernel!r}")
    single, alpha, V, s, prob, warm_start = _as_lanes(alpha, V, s, prob,
                                                      warm_start)
    collect = _collecting(collect)
    n = V.shape[-1]
    if vvt is not None and single:
        vvt = vvt[None]
    op, q, l1 = _scaled_lowrank(alpha, V, s, prob, vvt)
    ss, inv_ss = op.ss, op.inv_ss

    def make_solver(rho):
        return _lowrank_solver(op, *_lowrank_factor(op, rho))

    def mv(v):
        return op.diag(v) * v + _apply(V.mT, ss * _apply(V, v))

    def masked_solver(m):
        # M P M + diag(1 - m) + delta I keeps the Woodbury structure
        d = op.diag(m) * m + (1.0 - m) + _POLISH_DELTA
        vm = V * m[:, None, :]
        inner = _chol(inv_ss + _apply(vm / d[:, None, :], vm.mT))

        def solve_m(r):
            rd = _div_d(r, d)
            return rd - _div_d(_apply(vm.mT, _cho_solve(inner, _apply(vm, rd))), d)

        return solve_m

    fused = None
    if kernel == "fused" and n <= _FUSED_SEGMENT_MAX_N:
        def fused(z, u, rho, seg_len, last):
            d, Vk, kinv, minv_et_t, ge, xb, thresh = segment_operands(
                op, prob, l1, rho)
            return admm_segment(d, Vk, kinv, minv_et_t, ge, xb, q, prob.lo,
                                prob.hi, prob.center, thresh, z, u, rho,
                                relax=float(relax), seg_len=int(seg_len),
                                last=bool(last), anderson=int(anderson),
                                collect=bool(collect))

    res = _admm_iterations(make_solver, prob, q, l1, rho, iters, relax,
                           warm=warm_start,
                           polish_ops=(mv, masked_solver) if polish else None,
                           polish_passes=(_POLISH_PASSES if polish_passes
                                          is None else int(polish_passes)),
                           anderson=int(anderson), collect=bool(collect),
                           fused_segment=fused)
    if single:
        res = ADMMResult(*(None if f is None else f[0] for f in res))
    return res


def admm_solve_dense(P: torch.Tensor, prob: BoxQPProblem, *, rho: float = 2.0,
                     iters: int = 500, relax: float = 1.7,
                     warm_start: ADMMWarmState | None = None,
                     polish: bool = True,
                     polish_passes: int | None = None,
                     anderson: int = 0, collect: bool | None = None,
                     kernel: str = "reference") -> ADMMResult:
    """Dense-P path (small n: factor-selection MVO): ``P [n, n]`` symmetric
    PSD, or ``B`` lanes ``P [B, n, n]`` with every other operand on the
    same leading axis.

    The problem is scaled by ``trace(P) / n`` per lane; ``(P + rho I)`` is
    factored by Cholesky per lane and rho, and the polish's masked solve
    factors ``M P M + diag(1 - m) + delta I``. Other keywords as in
    :func:`admm_solve_lowrank`. ``kernel`` must stay ``"reference"``: the
    fused segment kernel consumes the low-rank operands only."""
    if kernel != "reference":
        raise ValueError("the fused segment kernel supports the low-rank "
                         "path only; admm_solve_dense takes "
                         "kernel='reference'")
    single = P.ndim == 2
    if single:
        P = P[None]
    prob, warm_start = _problem_lanes(prob, warm_start, single, P.shape[0],
                                      P.dtype, P.device)
    n = P.shape[-1]
    scale = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).sum(-1) / n,
                        min=1e-12)                         # [B]
    ps = P / scale[:, None, None]
    q = prob.q / scale[:, None]
    l1 = prob.l1 / scale[:, None]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)

    def make_solver(rho):
        low = _chol(ps + rho[:, None, None] * eye)
        return lambda r: _cho_solve(low, r)

    def mv(v):
        return _apply(ps, v)

    def masked_solver(m):
        h = (ps * (m[:, :, None] * m[:, None, :])
             + torch.diag_embed((1.0 - m) + _POLISH_DELTA))
        low = _chol(h)
        return lambda r: _cho_solve(low, r)

    res = _admm_iterations(make_solver, prob, q, l1, rho, iters, relax,
                           warm=warm_start,
                           polish_ops=(mv, masked_solver) if polish else None,
                           polish_passes=(_POLISH_PASSES if polish_passes
                                          is None else int(polish_passes)),
                           anderson=int(anderson),
                           collect=_collecting(collect))
    if single:
        res = ADMMResult(*(None if f is None else f[0] for f in res))
    return res
