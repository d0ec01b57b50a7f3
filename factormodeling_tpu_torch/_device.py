"""Device resolution for the port's entry points, and host copies for its
host-side reports."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_device", "host_array", "resolve_device"]


def host_array(x) -> np.ndarray:
    """``x`` as a host numpy array: a tensor on any device, or anything
    ``np.asarray`` takes."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, else raise.
    The CPU is used only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run it on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def check_device(device, *tensors) -> torch.device:
    """:func:`resolve_device`, then require every tensor given (``None``s
    skipped) to lie on that device's type."""
    dev = resolve_device(device)
    for t in tensors:
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"entry point asked to run on {dev}, got an "
                             f"input on {t.device}")
    return dev
