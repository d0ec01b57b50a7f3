"""Named stage markers for profiler traces (port of
``factormodeling_tpu/obs/trace.py``).

``stage(name)`` wraps a block in ``torch.profiler.record_function``, so a
``torch.profiler`` trace groups the block's host work and the kernels it
launches under ``name``; outside a profiler the marker only records a
range and the block's results are unchanged. ``annotate(name)`` is the
decorator form.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["stage", "annotate"]


def stage(name: str):
    """A ``torch.profiler.record_function`` context manager for one
    pipeline stage::

        with obs.stage("selection/rolling"):
            sel = rolling_selection(...)
    """
    return torch.profiler.record_function(name)


def annotate(name: str):
    """Decorator form of :func:`stage`: the whole body of the wrapped
    function runs under ``name``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
