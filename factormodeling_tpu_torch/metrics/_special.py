"""The regularized incomplete beta ``I_x(a, b)`` in plain PyTorch, for the
factor-return t-test's p-value (PyTorch has no ``betainc``; the JAX package
takes ``jax.scipy.special.betainc``).

Continued fraction of ``I_x(a, b)`` (Numerical Recipes' ``betacf``,
evaluated by the modified Lentz method), with the symmetry
``I_x(a, b) = 1 - I_{1-x}(b, a)`` for ``x > (a + 1) / (a + b + 2)``, where
the fraction converges fast. The prefactor ``x^a (1-x)^b / (a B(a, b))``
comes from ``torch.lgamma``. The iteration count is fixed and every branch
is a ``torch.where``, so a batch runs on the card with no host sync. The
fraction needs O(sqrt(max(a, b))) terms near the switch point; the path's
range is ``a = df / 2`` up to ~1000 (df = D - 2 over the full sample) with
``b = 1/2``, and ``_TERMS`` covers it to float64 rounding (tests).
"""

from __future__ import annotations

import torch

__all__ = ["betainc"]

#: continued-fraction terms evaluated (enough for a <= ~2000 at b = 1/2)
_TERMS = 200


def _betacf(a, b, x):
    """The continued fraction of ``I_x(a, b)`` by modified Lentz, a fixed
    number of terms (a converged fraction multiplies by 1 thereafter)."""
    tiny = torch.finfo(x.dtype).tiny * 1e10
    qab, qap, qam = a + b, a + 1.0, a - 1.0

    def floor(v):
        return torch.where(torch.abs(v) < tiny, tiny, v)

    c = torch.ones_like(x)
    d = 1.0 / floor(1.0 - qab * x / qap)
    h = d
    for m in range(1, _TERMS + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / floor(1.0 + aa * d)
        c = floor(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / floor(1.0 + aa * d)
        c = floor(1.0 + aa / c)
        h = h * d * c
    return h


def betainc(a: torch.Tensor, b, x: torch.Tensor) -> torch.Tensor:
    """Regularized incomplete beta ``I_x(a, b)`` elementwise (broadcasting),
    for ``a, b > 0`` and ``0 <= x <= 1``; NaN in any argument gives NaN,
    and ``x = 0`` / ``x = 1`` give exactly 0 / 1."""
    a, b, x = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=x.dtype,
                                                         device=x.device)
                                        for v in (a, b, x)))
    flip = x > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(flip, b, a), torch.where(flip, a, b)
    xx = torch.where(flip, 1.0 - x, x)
    log_front = (torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
                 + aa * torch.log(xx) + bb * torch.log1p(-xx))
    part = torch.exp(log_front) * _betacf(aa, bb, xx) / aa
    return torch.where(flip, 1.0 - part, part)
