"""Carry the research step's inputs and static config into the port.

This system has no model weights: what a run carries across from the JAX
package is its numpy input panels and the plain config keywords of
``build_research_step``. :func:`convert` puts the panels on a device as
tensors (keeping their dtype unless one is given; the universe stays bool)
and gathers the config into a :class:`ResearchConfig`, so the same numpy
inputs can feed both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch._device import resolve_device

__all__ = ["ResearchConfig", "ResearchInputs", "convert"]


class ResearchInputs(NamedTuple):
    factors: torch.Tensor        # float[F, D, N]
    returns: torch.Tensor        # float[D, N]
    factor_ret: torch.Tensor     # float[D, F]
    cap_flag: torch.Tensor       # float[D, N]
    investability: torch.Tensor  # float[D, N]
    universe: torch.Tensor       # bool[D, N]


@dataclasses.dataclass(frozen=True)
class ResearchConfig:
    """The static config of :func:`build_research_step`, field for field."""

    names: tuple
    window: int
    select_method: str = "icir_top"
    select_kwargs: dict = dataclasses.field(default_factory=dict)
    blend_method: str = "zscore"
    sim_kwargs: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"

    def as_kwargs(self) -> dict[str, Any]:
        """Keywords for :func:`build_research_step`."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def convert(factors, returns, factor_ret, cap_flag, investability, universe,
            *, names, window: int, select_method: str = "icir_top",
            select_kwargs: dict | None = None, blend_method: str = "zscore",
            sim_kwargs: dict | None = None, device=None, dtype=None):
    """Numpy inputs and config -> ``(ResearchInputs, ResearchConfig)``.

    ``device=None`` is the card (raises with none present; pass
    ``device="cpu"`` for the CPU). ``dtype`` (e.g. ``torch.float32``) casts
    the float panels; by default they keep their numpy dtype."""
    dev = resolve_device(device)

    def put(x, is_mask=False):
        t = torch.tensor(np.asarray(x))   # a copy: numpy views may be read-only
        if is_mask:
            t = t.to(torch.bool)
        elif dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    inputs = ResearchInputs(put(factors), put(returns), put(factor_ret),
                            put(cap_flag), put(investability),
                            put(universe, is_mask=True))
    config = ResearchConfig(names=tuple(names), window=int(window),
                            select_method=select_method,
                            select_kwargs=dict(select_kwargs or {}),
                            blend_method=blend_method,
                            sim_kwargs=dict(sim_kwargs or {}),
                            device=str(dev))
    return inputs, config
