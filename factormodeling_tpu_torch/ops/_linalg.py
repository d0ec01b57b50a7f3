"""Batched small-matrix linear algebra (port of
``factormodeling_tpu/ops/_linalg.py``).

:func:`spd_solve` keeps the JAX package's pivot-free Gauss-Jordan
elimination rather than ``torch.linalg.solve``: the Anderson accelerator's
accept/reject decisions compare residuals built from its solutions, and a
solver that associates the sums differently can flip one of them. The
statistical risk model's batched ``k x k`` normal equations go through it
too, as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["aa_mix", "spd_solve"]


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a @ x = b`` for stacked SPD ``a: [..., F, F]``, ``b: [..., F]``.

    Pivot-free Gauss-Jordan over the augmented ``[..., F, F+1]`` system: F
    elimination steps, each a broadcast rank-1 update over the whole batch.
    For well-conditioned (diagonally regularized) systems with small F;
    NaN/zero pivots propagate NaN."""
    f = a.shape[-1]
    aug = torch.cat([a, b[..., None]], dim=-1)          # [..., F, F+1]
    rows = torch.arange(f, device=a.device)
    for k in range(f):
        pivrow = aug[..., k:k + 1, :]                   # [..., 1, F+1]
        pivrow = pivrow / pivrow[..., k:k + 1]
        is_k = (rows == k)[:, None]
        fac = torch.where(is_k, 0.0, aug[..., :, k:k + 1])
        aug = torch.where(is_k, pivrow, aug - fac * pivrow)
    return aug[..., -1]


def aa_mix(v_f: torch.Tensor, g: torch.Tensor, s_hist: torch.Tensor,
           y_hist: torch.Tensor, hist_len, *, reg: float = 1e-8) -> torch.Tensor:
    """Type-II Anderson-acceleration candidate from difference histories::

        gamma = argmin || g - Y' gamma ||_2
        v_aa  = v_f - gamma @ (S + Y)

    over the first ``hist_len <= m`` rows of ``S``/``Y`` (newest first),
    through masked normal equations with a relative ridge
    (``reg * trace / hist_len``) solved by :func:`spd_solve`. Unused rows
    decouple to an identity block and get an exact-zero ``gamma``; at
    ``hist_len == 0`` the candidate is ``v_f``. Shapes: ``v_f``/``g``
    ``[..., n]``, ``s_hist``/``y_hist`` ``[..., m, n]``, ``hist_len`` an int
    or a ``[...]`` tensor."""
    m = s_hist.shape[-2]
    dtype = g.dtype
    hist = torch.as_tensor(hist_len, device=g.device)
    mask = (torch.arange(m, device=g.device) < hist[..., None]).to(dtype)
    ym = y_hist * mask[..., None]
    # products as elementwise sums along the last axis (not matmul), so a
    # lane's result does not depend on how many lanes share the call
    a = (ym[..., :, None, :] * ym[..., None, :, :]).sum(-1)   # [..., m, m]
    trace = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
    ridge = (reg * trace / torch.clamp(hist, min=1).to(dtype)
             + torch.finfo(dtype).tiny)
    eye = torch.eye(m, dtype=dtype, device=g.device)
    a = a + torch.diag_embed(1.0 - mask) + ridge[..., None, None] * eye
    gamma = spd_solve(a, (ym * g[..., None, :]).sum(-1))
    mixed = (gamma[..., :, None] * ((s_hist + y_hist) * mask[..., None])).sum(-2)
    return v_f - mixed
