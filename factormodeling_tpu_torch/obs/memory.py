"""Device-memory telemetry: measured footprints and live watermarks (port
of ``factormodeling_tpu/obs/memory.py``).

Two sources, both optional per backend:

- **Measured footprint** (:func:`memory_summary`). The JAX package reads
  XLA's ``compiled.memory_analysis()``; the port has no compiled
  executable, so it measures one fenced call of the target between
  ``torch.cuda.reset_peak_memory_stats()`` and
  ``torch.cuda.max_memory_allocated()`` (the caching allocator's
  allocated bytes, not its reserved pool) and fills the JAX package's
  fields under ``source: "measured"``:

  - ``argument_bytes``: the CUDA tensors among the arguments (each
    storage once);
  - ``output_bytes``: the CUDA tensors among the outputs;
  - ``alias_bytes``: the outputs that share storage with an argument;
  - ``peak_bytes = argument_bytes + (max_allocated - allocated_before)``:
    the arguments plus what the call allocated at its high-water mark;
  - ``temp_bytes = peak_bytes - argument_bytes - output_bytes +
    alias_bytes``, so that the JAX package's identity ``peak = argument +
    output + temp - alias`` holds;
  - ``generated_code_bytes = 0`` (no executable).

  The call runs once more than the caller's own, and resets the card's
  peak counter. Without a card the summary is the JAX package's failure
  form, ``{"source": None, "reason": ...}``, and the target is not called.
- **Live watermarks** (:func:`live_watermark`): the allocator's gauges
  (``bytes_in_use`` / ``peak_bytes_in_use``) sampled at span exits. Without
  a card the first probe caches the reason (:func:`
  watermark_unavailable_reason`) and every later call is a cheap None.

``RunReport.add_placement`` writes the footprint as a ``kind="memory"``
row beside the comms ledger; ``tools/report_diff.py`` gates peak-byte
growth as it does for the JAX package's rows.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["live_watermark", "memory_summary", "peak_bytes",
           "watermark_unavailable_reason"]

# tri-state: None = not probed yet, "" = available, str = unavailable why
_WATERMARK_REASON: "str | None" = None

_NO_CARD = ("torch.cuda is not available: the caching allocator measures "
            "device memory only on a card")


def _tensors(obj, out: list) -> list:
    """Every tensor in a nest of tuples, lists, dicts, named tuples and
    dataclasses."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _tensors(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


def _storages(tensors) -> dict:
    """data pointer -> bytes of every distinct CUDA storage."""
    out = {}
    for t in tensors:
        if t.is_cuda:
            st = t.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
    return out


def _fence(out) -> None:
    """Wait for the CUDA devices of every tensor in ``out``."""
    for dev in {t.device for t in _tensors(out, []) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def measure(target, *args, **kwargs) -> tuple:
    """``(output, summary)`` of one call of ``target(*args, **kwargs)``:
    the summary is :func:`memory_summary`'s. Without a card the call still
    runs (the placement ledger needs its collectives) and the summary is
    the failure form. ``target``'s exceptions propagate."""
    if not torch.cuda.is_available():
        return target(*args, **kwargs), {"source": None, "reason": _NO_CARD}
    dev = torch.cuda.current_device()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = target(*args, **kwargs)
    _fence(out)
    torch.cuda.synchronize(dev)
    high = torch.cuda.max_memory_allocated(dev)
    arg = _storages(_tensors((args, kwargs), []))
    res = _storages(_tensors(out, []))
    arg_b, out_b = sum(arg.values()), sum(res.values())
    alias = sum(b for p, b in res.items() if p in arg)
    peak = arg_b + (high - before)
    return out, {"source": "measured", "argument_bytes": arg_b,
                 "output_bytes": out_b,
                 "temp_bytes": peak - arg_b - out_b + alias,
                 "alias_bytes": alias, "generated_code_bytes": 0,
                 "peak_bytes": peak}


def memory_summary(target, *args, **kwargs) -> dict:
    """JSON-ready footprint of one fenced call of ``target(*args,
    **kwargs)`` (module docs): the JAX package's fields under ``source:
    "measured"``, or ``{"source": None, "reason": ...}`` without a card.
    Never raises: a call that fails gives the failure form with its
    error."""
    if not torch.cuda.is_available():
        return {"source": None, "reason": _NO_CARD}
    try:
        return measure(target, *args, **kwargs)[1]
    except Exception as e:
        return {"source": None, "reason": f"measured call failed: {e}"}


def peak_bytes(target, *args, **kwargs) -> "int | None":
    """The peak-residency figure of one fenced call, or None without a
    card (:func:`memory_summary`'s ``peak_bytes``)."""
    return memory_summary(target, *args, **kwargs).get("peak_bytes")


def live_watermark() -> "dict | None":
    """Current device-memory gauges of the card, or None without one:
    ``{"bytes_in_use", "peak_bytes_in_use", "devices"}`` over the visible
    cards (``torch.cuda.memory_stats``: the caching allocator's allocated
    bytes, now and at their peak). The first unavailable probe caches its
    reason; later calls return None at once."""
    global _WATERMARK_REASON
    if _WATERMARK_REASON:   # cached "unavailable" verdict
        return None
    if not torch.cuda.is_available():
        _WATERMARK_REASON = ("backend 'cpu' reports no memory_stats (torch."
                             "cuda is not available)")
        return None
    in_use, peak, n = 0, 0, torch.cuda.device_count()
    for i in range(n):
        stats = torch.cuda.memory_stats(i)
        in_use += int(stats.get("allocated_bytes.all.current", 0))
        peak = max(peak, int(stats.get("allocated_bytes.all.peak", 0)))
    _WATERMARK_REASON = ""
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak, "devices": n}


def watermark_unavailable_reason() -> "str | None":
    """Why live watermarks are skipped (None until probed, and when they
    work): the skip reason the memory rows record on the CPU."""
    return _WATERMARK_REASON or None
