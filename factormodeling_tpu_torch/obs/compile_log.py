"""Entry-point call statistics: per-entry-point "compile" seconds and
counts, a silent-retrace detector, and per-call latency (port of
``factormodeling_tpu/obs/compile_log.py``).

The JAX package counts XLA compilations through a ``jax.monitoring``
listener. The port compiles nothing at call time (its CUDA kernels are
built once by ``_build``), so a **"compile" is the first call of a
distinct argument signature under an entry point's name**, and its
``compile_s`` is that call's fenced wall. The rest follows the JAX module
field for field:

- :func:`instrument_jit` wraps one entry point under a name. Every call
  that "compiled" is recorded as a ``kind="compile"`` row on the active
  :class:`~factormodeling_tpu_torch.obs.report.RunReport` and checked by
  the retrace detector: an entry point whose cumulative compile count
  exceeds its *expected signature count* (by default the number of
  distinct (shape, dtype, device) call signatures seen; pass
  ``expected_signatures`` to pin it) is flagged ``retraced``, as is one
  whose signatures outgrow the detector's cap. Stats accumulate per NAME
  across wrappers (:data:`_REGISTRY`). Where the JAX package's fresh jit
  for a signature already seen compiles again (its "fresh jit per call"
  storm), the port rebuilds nothing, so a fresh wrapper's call of a known
  signature is no "compile" here: the port's detector flags callers whose
  shapes do not settle, not wrappers rebuilt per call.
- With ``RunReport(latency=True)`` every steady-state call's fenced wall
  (``torch.cuda.synchronize`` on the devices of the outputs, as the
  report's spans fence) is observed under the entry point's name; a call
  that "compiled" is left out, as in the JAX package.
- With ``RunReport(comms=True)`` a call that "compiled" contributes its
  placement rows (``RunReport.add_placement``'s comms, memory and sharding
  rows) from that same call, with no extra run.
- :func:`compile_stats`, :func:`compile_totals`,
  :func:`reset_compile_stats` and :func:`install` as in the JAX module;
  ``compile_totals()``' ``trace_s`` and ``lower_s`` stay 0.0 (nothing is
  traced or lowered) and :func:`install` has no listener to register.

The port's wrapped entry points are the JAX package's, under the same
names: the sharded research step (``parallel/research_step/<tag>``), the
asset-sharded step (``parallel/asset_research_step/<tag>``), the sharded
manager sweep (``parallel/manager_sweep/<tag>``), the streaming kernel
cache's entries (``streaming/<kind>/kernel/<tag>``), the scenario runners
(``scenarios/step/<family>``), the online engine's advance
(``online/engine/<tag>``) and the serving buckets (``serve/bucket/<tag>``,
``online/bucket/<tag>``). The JAX package's compat layer also wraps its
jit cache (``compat/jit/*``); the port's compat layer has no jit cache, so
it has no such entries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import time
from typing import Any

import torch

from factormodeling_tpu_torch.obs.memory import _fence
from factormodeling_tpu_torch.obs.report import active_report, record_stage

__all__ = ["InstrumentedJit", "compile_stats", "compile_totals",
           "entry_point_tag", "install", "instrument_jit",
           "reset_compile_stats"]

# process-wide aggregates; "compiles" counts first calls of a signature
_totals = {"compiles": 0, "compile_s": 0.0, "trace_s": 0.0, "lower_s": 0.0}
#: name -> accumulated per-entry-point stats. Holds stats only, never the
#: wrapped callables (an evicted cache entry stays collectable), and every
#: wrapper under one name mutates the same record.
_REGISTRY: "dict[str, _EntryPointStats]" = {}


class _EntryPointStats:
    """Mutable accumulator shared by every wrapper under one name."""

    __slots__ = ("calls", "compiles", "compile_s", "signatures",
                 "expected_signatures")

    def __init__(self):
        self.calls = 0
        self.compiles = 0
        self.compile_s = 0.0
        self.signatures: set = set()
        self.expected_signatures: "int | None" = None

    @property
    def retraces(self) -> int:
        expected = (self.expected_signatures
                    if self.expected_signatures is not None
                    else len(self.signatures))
        return max(self.compiles - expected, 0)

    def as_dict(self) -> dict:
        return {
            "calls": self.calls,
            "compiles": self.compiles,
            "compile_s": round(self.compile_s, 6),
            "signatures": len(self.signatures),
            "expected_signatures": self.expected_signatures,
            "retraces": self.retraces,
            "retraced": self.retraces > 0,
        }


def install() -> bool:
    """The JAX module registers its compile listener here; the port has
    none to register. Returns True (the statistics are always on)."""
    return True


def compile_totals() -> dict:
    """Process-wide aggregates since import: ``{"compiles", "compile_s",
    "trace_s", "lower_s"}`` (first calls of a signature and their fenced
    seconds; no tracing or lowering happens, so the last two stay 0)."""
    return {k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in _totals.items()}


def compile_stats() -> dict:
    """Per-entry-point snapshot: ``{name: {calls, compiles, compile_s,
    signatures, expected_signatures, retraces, retraced}}`` for every
    :func:`instrument_jit` entry point seen in this process."""
    return {name: st.as_dict() for name, st in _REGISTRY.items()}


def reset_compile_stats() -> None:
    """Forget every per-entry-point record. The process-wide totals keep
    counting; live wrappers keep mutating their (now detached) records,
    and newly created wrappers start fresh."""
    _REGISTRY.clear()


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


#: signature-set size cap: a caller whose every call is a new shape stops
#: growing the set here; compiles keep counting past it, so the storm still
#: flags as retraced
_MAX_SIGNATURES = 4096


def _leaf_sig(x):
    if isinstance(x, torch.Tensor):
        return ("arr", tuple(x.shape), str(x.dtype), str(x.device))
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:     # numpy arrays
        return ("arr", tuple(shape), str(dtype))
    if isinstance(x, (bool, int, float, complex)) or x is None:
        return ("scalar", type(x).__name__)
    try:
        hash(x)
        return ("val", x)
    except TypeError:
        return ("obj", type(x).__name__)


def _flatten(a, leaves: list) -> str:
    """The JAX package's pytree flattening over the containers the port's
    entry points take: tuples, lists, dicts (sorted keys), named tuples
    and dataclasses are nodes, anything else a leaf. Returns the
    structure's string and appends the leaves."""
    if isinstance(a, dict):
        keys = sorted(a, key=repr)
        return "{" + ",".join(f"{k!r}:{_flatten(a[k], leaves)}"
                              for k in keys) + "}"
    if isinstance(a, (tuple, list)):
        inner = ",".join(_flatten(v, leaves) for v in a)
        kind = (type(a).__name__ if hasattr(a, "_fields") else
                "[]" if isinstance(a, list) else "()")
        return f"{kind}({inner})"
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        inner = ",".join(f"{f.name}={_flatten(getattr(a, f.name), leaves)}"
                         for f in dataclasses.fields(a))
        return f"{type(a).__name__}({inner})"
    leaves.append(a)
    return "*"


def _tree_sig(a):
    leaves: list = []
    treedef = _flatten(a, leaves)
    return (tuple(_leaf_sig(leaf) for leaf in leaves), treedef)


def _signature(args, kwargs, static_argnums=(), static_argnames=()) -> tuple:
    """Hashable signature of a call: tensors by (shape, dtype, device),
    Python scalars by TYPE (as jit abstracts them), other hashables by
    value, unhashables by type name; arguments declared static
    (``static_argnums``/``static_argnames``) by value. The JAX module's
    rule, with the device added for tensors."""
    parts = []
    for i, a in enumerate(args):
        parts.append(("static", repr(a)) if i in static_argnums
                     else _tree_sig(a))
    for k in sorted(kwargs):
        parts.append((k, ("static", repr(kwargs[k]))
                      if k in static_argnames else _tree_sig(kwargs[k])))
    return tuple(parts)


class InstrumentedJit:
    """An entry point with call statistics (module docs).

    Transparent: calls forward to the wrapped callable and every other
    attribute resolves on it, so the wrapper drops into existing call
    sites. A steady-state call with no report installed adds one signature
    build and two set lookups."""

    def __init__(self, fn, name: str,
                 expected_signatures: int | None = None,
                 static_argnums=(), static_argnames=()):
        self._fn = fn
        self.name = name

        def norm(v):
            return (v,) if isinstance(v, (int, str)) else tuple(v or ())

        self._static_argnums = norm(static_argnums)
        self._static_argnames = norm(static_argnames)
        self._stats = _REGISTRY.setdefault(name, _EntryPointStats())
        if expected_signatures is not None:
            self._stats.expected_signatures = expected_signatures

    def __call__(self, *args, **kwargs) -> Any:
        try:
            sig = _signature(args, kwargs, self._static_argnums,
                             self._static_argnames)
            hash(sig)
        except Exception:   # exotic args never break the call path
            sig = ("unsignable",)
        st = self._stats
        new = sig not in st.signatures
        rep = active_report()
        recorder = getattr(rep, "latency", None) if rep is not None else None
        placement = new and rep is not None and getattr(rep, "comms", False)
        rows = None
        t0 = time.perf_counter()
        if placement:
            out, rows = rep._placement(
                self.name, self._fn, args, kwargs,
                declared_in_shardings=getattr(self, "declared_in_shardings",
                                              None),
                mesh=getattr(self, "mesh", None), stages=None, reraise=True)
        else:
            out = self._fn(*args, **kwargs)
        if new or recorder is not None:
            _fence(out)
        call_s = time.perf_counter() - t0
        st.calls += 1
        if not new:
            if recorder is not None:
                recorder.observe(self.name, call_s)
            return out
        if len(st.signatures) < _MAX_SIGNATURES:
            st.signatures.add(sig)
        st.compiles += 1
        st.compile_s += call_s
        _totals["compiles"] += 1
        _totals["compile_s"] += call_s
        record_stage(self.name, kind="compile", **st.as_dict())
        if rows:
            rep.rows.extend(rows)
        return out

    @property
    def calls(self) -> int:
        return self._stats.calls

    @property
    def compiles(self) -> int:
        return self._stats.compiles

    @property
    def compile_s(self) -> float:
        return self._stats.compile_s

    @property
    def expected_signatures(self) -> "int | None":
        return self._stats.expected_signatures

    @property
    def retraces(self) -> int:
        """"Compiles" beyond the expected signature count: with
        ``expected_signatures`` pinned, callers whose shapes do not
        settle; unpinned, only signatures past the detector's cap."""
        return self._stats.retraces

    @property
    def retraced(self) -> bool:
        return self._stats.retraces > 0

    def stats(self) -> dict:
        return self._stats.as_dict()

    def __getattr__(self, item):
        if item == "_fn":   # not set yet (unpickling, early failure)
            raise AttributeError(item)
        return getattr(self._fn, item)


def instrument_jit(fn, name: str,
                   expected_signatures: int | None = None,
                   static_argnums=(),
                   static_argnames=()) -> InstrumentedJit:
    """Wrap an entry point with call statistics under ``name``; see
    :class:`InstrumentedJit`. ``static_argnums``/``static_argnames``
    name arguments that key the signature by value."""
    return InstrumentedJit(fn, name, expected_signatures=expected_signatures,
                           static_argnums=static_argnums,
                           static_argnames=static_argnames)
