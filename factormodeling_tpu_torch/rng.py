"""The seeded-RNG lane registry (port of ``factormodeling_tpu/rng.py``).

Every deterministic random stream draws under a NAMED LANE with a
registry-unique integer id (``LANES``, checked at import). The ids are the
JAX package's, and so are the two derivations, one per RNG world:

- :func:`lane_key`: a threefry key (:mod:`factormodeling_tpu_torch.threefry`)
  for the draws the JAX package makes with ``jax.random`` (fault masks,
  scenario paths): ``seed_key(seed)`` folded with the caller's indices in
  order, then the lane id last, so a lane, seed and indices give the JAX
  package's bits on the CPU and on the card alike;
- :func:`lane_rng`: an ``np.random.default_rng`` generator for host-side
  draws (arrival traces, dispatch-fault plans), seeded on the tuple
  ``(lane_id, seed, *indices)``, the SeedSequence entropy-pool path, so
  distinct lanes are independent streams, not offsets of one stream.
"""

from __future__ import annotations

from factormodeling_tpu_torch import threefry

__all__ = ["LANES", "lane_id", "lane_key", "lane_rng", "lane_seed"]

#: every named lane and its registry-unique id. Fault-class lanes keep
#: their pre-registry values (bit-compat contract, module docs); new lanes
#: allocate from disjoint ranges so a future fault class (7919 + 31*6 =
#: 8105, ...) can keep extending its own run without collision.
LANES: dict[str, int] = {
    # resil.faults traced injection lanes — values frozen at the historic
    # 7919 + 31*i (declaration order matches faults.FAULT_CLASSES)
    "fault/nan_burst": 7919,
    "fault/inf_spike": 7950,
    "fault/outlier": 7981,
    "fault/stale_repeat": 8012,
    "fault/drop_day": 8043,
    "fault/universe_collapse": 8074,
    # serve.queue host-side traffic lanes (round 15 harnesses, namespaced
    # here in round 16 — fixes the poisson/bursty same-seed collision)
    "serve/arrivals/poisson": 9001,
    "serve/arrivals/bursty": 9002,
    "serve/dispatch_fault": 9003,
    # scenarios.* traced lanes (round 16): the per-path root key plus the
    # family-specific sub-draws folded under it
    "scenario/path": 9101,
    "scenario/bootstrap": 9102,
    "scenario/regime_break": 9103,
    "scenario/regime_intensity": 9104,
    "scenario/adv_window": 9105,
    "scenario/adv_stale": 9106,
    "scenario/adv_drop": 9107,
    "scenario/adv_collapse": 9108,
    "scenario/adv_nan": 9109,
    "scenario/adv_inf": 9110,
    "scenario/adv_outlier": 9111,
}

if len(set(LANES.values())) != len(LANES):  # pragma: no cover - build guard
    raise RuntimeError("rng.LANES ids are not unique — two lanes would "
                       "share a derived stream")


def lane_id(name: str) -> int:
    """The registry id of a lane; unknown names raise (a typo'd lane name
    must never silently mint a fresh stream)."""
    try:
        return LANES[name]
    except KeyError:
        raise ValueError(f"unknown RNG lane {name!r}; registered lanes: "
                         f"{sorted(LANES)}") from None


def lane_key(name: str, seed: int, *indices: int) -> tuple:
    """The threefry key of one lane: ``seed_key(seed)`` folded with each
    index in order, then the lane id last (the JAX package's
    ``lane_key``)."""
    key = threefry.seed_key(seed)
    for ix in indices:
        key = threefry.fold_in(key, ix)
    return threefry.fold_in(key, lane_id(name))


def lane_seed(name: str, seed: int, *indices: int) -> tuple:
    """The host-side entropy tuple of one lane — what :func:`lane_rng`
    seeds ``np.random.default_rng`` with. Exposed so the collision test
    can compare lanes without drawing."""
    return (lane_id(name), int(seed), *(int(i) for i in indices))


def lane_rng(name: str, seed: int, *indices: int):
    """A ``numpy`` Generator for one host-side lane (see module docs)."""
    import numpy as np

    return np.random.default_rng(lane_seed(name, seed, *indices))
