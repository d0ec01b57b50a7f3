"""Named stage markers for profiler traces (port of
``factormodeling_tpu/obs/trace.py``).

``stage(name)`` wraps a block in ``torch.profiler.record_function``, so a
``torch.profiler`` trace groups the block's host work and the kernels it
launches under ``name``; outside a profiler the marker only records a
range and the block's results are unchanged. ``annotate(name)`` is the
decorator form. The names of the stages open on this thread are kept in
order (:func:`active_stages`): the comms ledger and the device-time
attribution charge a collective or a kernel to the outermost of them that
they know (``obs/comms.py``, ``obs/devtime.py``).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

__all__ = ["active_stages", "stage", "annotate"]

_open = threading.local()


def active_stages() -> tuple:
    """The stage names open on this thread, outermost first."""
    return tuple(getattr(_open, "names", ()))


@contextlib.contextmanager
def stage(name: str):
    """A ``torch.profiler.record_function`` context manager for one
    pipeline stage::

        with obs.stage("selection/rolling"):
            sel = rolling_selection(...)
    """
    prev = getattr(_open, "names", [])
    _open.names = prev + [name]
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _open.names = prev


def annotate(name: str):
    """Decorator form of :func:`stage`: the whole body of the wrapped
    function runs under ``name``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with stage(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
