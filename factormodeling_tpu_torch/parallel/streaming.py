"""The bounded LRU of built step callables (port of the kernel cache of
``factormodeling_tpu/parallel/streaming.py``). The streaming functions of
that module (``streamed_factor_stats``, ``streamed_linear_research``,
``streamed_weighted_composite``, the chunk sources) are not ported yet
(ROADMAP queue 1 item 4).

The JAX package caches one jitted executable per (source, config); the
port has no jit, so an entry is the built callable (the serving layer's
per-(bucket, rung) dispatch and per-session online advance) and a miss is
one build. The cache is bounded: an entry holds its closures, and with
them whatever they captured. The counters read as the JAX package's: a
miss count that grows with every call means an unstable key is defeating
the cache; an eviction count that grows in steady state means the working
set exceeds ``capacity``.
"""

from __future__ import annotations

__all__ = ["clear_streaming_cache", "set_kernel_cache_size",
           "streaming_cache_stats"]

_KERNEL_CACHE_SIZE = 16
_kernel_cache: "dict[tuple, object]" = {}
_cache_stats = {"hits": 0, "misses": 0, "evictions": 0}


def clear_streaming_cache() -> None:
    """Drop every cached callable and reset the counters."""
    _kernel_cache.clear()
    _cache_stats.update(hits=0, misses=0, evictions=0)


def streaming_cache_stats() -> dict:
    """``{"hits", "misses", "evictions", "size", "capacity"}`` since the
    last :func:`clear_streaming_cache`."""
    return {**_cache_stats, "size": len(_kernel_cache),
            "capacity": _KERNEL_CACHE_SIZE}


def set_kernel_cache_size(n: int) -> int:
    """Rebound the LRU (default 16). Shrinking evicts the least recently
    used entries at once, counted as evictions. Returns the previous
    capacity."""
    global _KERNEL_CACHE_SIZE
    if n < 1:
        raise ValueError(f"kernel cache size must be >= 1, got {n}")
    prev, _KERNEL_CACHE_SIZE = _KERNEL_CACHE_SIZE, int(n)
    _evict_to_cap()
    return prev


def _evict_to_cap() -> None:
    """Drop least-recently-used entries until the cache fits the cap (dict
    order is recency: `_cached_kernel` re-inserts on every hit)."""
    while len(_kernel_cache) > _KERNEL_CACHE_SIZE:
        _kernel_cache.pop(next(iter(_kernel_cache)))
        _cache_stats["evictions"] += 1


def _cached_kernel(source, config, build):
    """``build()``'s callable for ``(source, config)``, LRU-bounded;
    ``source`` (None for the serving layer) takes part in the key by
    identity, ``config`` by value."""
    key = (source, config)
    fn = _kernel_cache.pop(key, None)
    if fn is None:
        fn = build()
        _cache_stats["misses"] += 1
    else:
        _cache_stats["hits"] += 1
    _kernel_cache[key] = fn  # (re)insert at the end: dict order is recency
    _evict_to_cap()
    return fn
