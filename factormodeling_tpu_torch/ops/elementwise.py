"""Elementwise math pass-throughs (port of
``factormodeling_tpu/ops/elementwise.py``; reference ``operations.py:88-101``).

``jnp.sign`` keeps NaN where ``torch.sign`` gives 0, so :func:`sign` puts
the NaN back.
"""

from __future__ import annotations

import torch

__all__ = ["sign", "power", "log", "abs_", "clip"]


def sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x))


def power(x, exp):
    return torch.pow(x, exp)


def log(x):
    return torch.log(x)


def abs_(x):
    return torch.abs(x)


def clip(x, lower, upper):
    return torch.clamp(x, lower, upper)
