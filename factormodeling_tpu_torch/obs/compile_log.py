"""Entry-point tags (port of ``factormodeling_tpu/obs/compile_log.py``,
its ``entry_point_tag`` only). The rest of the JAX module, the jit
instrumentation and its compile statistics, has no counterpart yet: the
port compiles no jitted functions, and its entry-point call counts are
ROADMAP queue 1 item 6.
"""

from __future__ import annotations

import hashlib
import re

__all__ = ["entry_point_tag"]


def entry_point_tag(*parts) -> str:
    """A short, run-stable tag telling apart entry-point variants that
    share a human name (two serving buckets, two rungs of one bucket).

    The tag is built from stable identity only: callables contribute their
    ``__qualname__``, never their address, and the ``at 0x...`` address of
    a default object repr is stripped, so fresh lambdas or objects of one
    kind map to one tag. Tags of the port need not equal the JAX
    package's: the reprs of torch and numpy dtypes differ."""

    def stable(x):
        if isinstance(x, (tuple, list)):
            return "(" + ",".join(stable(v) for v in x) + ")"
        if callable(x):
            return getattr(x, "__qualname__", None) or type(x).__name__
        return re.sub(r" at 0x[0-9a-fA-F]+", "", repr(x))

    joined = ";".join(stable(p) for p in parts)
    return hashlib.blake2s(joined.encode()).hexdigest()[:6]
