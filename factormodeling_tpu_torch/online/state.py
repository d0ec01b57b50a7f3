"""Online-advance state: the O(window) carry of the research step (port of
``factormodeling_tpu/online/state.py``).

The full research step is O(history) per arriving date. The online advance
carries this state instead, split in two:

- :class:`MarketState`: everything derived from the market alone: raw-input
  tail rings (the last ``stats_tail`` dates of exposures, returns, cap,
  investability and universe, enough to recompute one date's daily factor
  stats under the double exposure shift), the daily-stats ring and the
  factor-return ring sized to the selection window plus a margin, the
  left-aligned covariance-lookback returns ring the MVO schemes' trailing
  window slices from, and the current statistical risk model under
  ``covariance="risk_model"``;
- :class:`TenantState`: the per-tenant sequential carries: the previous
  pre-shift book (the turnover L1 center), the per-symbol shift carry, the
  previous traded row (the P&L turnover diff), the turnover scan's warm
  state, a ``mvo_batch``-slot ring of lane exit states for plain MVO (day
  ``t`` warm-starts from day ``t - mvo_batch``, as the full step's chunks
  of lanes do), and the running per-name P&L.

A session of ``C`` tenants advances their states stacked along a leading
lane axis (:func:`stack_tenant_states`; :func:`tenant_state_lane` takes one
back): every tensor gains the axis, the turnover scan's one-lane warm state
becomes ``C`` lanes and plain MVO's ring ``[C, mvo_batch, ...]``.

Every tensor lives on the engine's device. The date counters ``day`` and
``version`` are host integers: the host decides which date it advances, so
every choice that depends on the date alone (is a date ready, processed,
on the refit grid, in which warm slot) is a host branch and never a device
read. Ring ramp-up is NaN/False padding, whose contribution to every
NaN-aware reducer is the full step's edge padding. The books and warm
states of the QP schemes are kept in ``QP_DTYPE`` (float64), the type the
full step chains them in.

Over a mesh carrying the asset axis (``make_online_step(mesh=...)``,
``TenantServer(mesh=...)``'s online sessions) each rank holds its blocks
of the state (:func:`shard_online_state`), placed leaf by leaf by what the
leaf means (:func:`online_leaf_dims`): the market tails, the covariance
ring, the risk model's idiosyncratic variances and every per-name tenant
carry hold this rank's ``N/s`` columns; the stat rings, the factor-return
ring, the risk model's loadings and factor variances and the ADMM
``rho`` stay whole. That is the JAX package's rule
(``serve/frontend.py::_online_state_specs``, which shards a leaf whose LAST
dim has ``N`` entries) wherever no other dim of the state equals ``N``.
:func:`shard_date_slice` does the same for an arriving date.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch.backtest.mvo import QP_DTYPE
from factormodeling_tpu_torch.solvers.admm_qp import ADMMWarmState

__all__ = ["AdvanceOutputs", "DateSlice", "MarketState", "TenantState",
           "check_asset_divisible", "init_market_state", "init_tenant_state", "online_leaf_dims",
           "shard_date_slice", "shard_online_state", "stack_tenant_states",
           "tenant_state_lane"]


class DateSlice(NamedTuple):
    """One arriving date's raw inputs, the unit the online engine ingests
    (tensors or numpy arrays; ``universe`` None for a stream without
    one)."""

    factors: Any          # float[F, N] raw exposures for the date
    returns: Any          # float[N] asset returns
    factor_ret: Any       # float[F] precomputed factor returns
    cap_flag: Any         # float[N] cap tier
    investability: Any    # float[N]
    universe: Any = None  # bool[N] membership, or None


@dataclasses.dataclass(frozen=True)
class MarketState:
    """Market carry (module docs). ``day`` is the absolute index of the
    LAST ingested date (-1 before the first); an advance finalizes date
    ``day - 1``, since the last date of any full recompute is transient."""

    day: int                      # last ingested absolute index
    version: int                  # +1 per advance
    factors_tail: torch.Tensor    # [F, T, N] last T dates (NaN ramp pad)
    returns_tail: torch.Tensor    # [T, N]
    cap_tail: torch.Tensor        # [T, N]
    invest_tail: torch.Tensor     # [T, N]
    universe_tail: Any            # bool[T, N] (False ramp pad) or None
    stats_ring: dict              # stat -> [F, R] (NaN ramp pad)
    fr_ring: torch.Tensor         # [R, F] factor returns (NaN pad)
    lb_ring: Any                  # QP_DTYPE[LB, N] left-aligned, or None
    risk_model: Any               # (loadings [N,k], fvar [k], idio [N]) or None


@dataclasses.dataclass(frozen=True)
class TenantState:
    """Per-tenant sequential carry (module docs)."""

    w_prev: torch.Tensor            # QP_DTYPE[N] previous pre-shift book
    book_carry: torch.Tensor        # [N] last in-universe pre-shift weight
    traded_prev: torch.Tensor       # [N] previous traded (shifted) row
    warm: Any                       # ADMMWarmState of one lane, or None
    warm_ring: Any                  # ADMMWarmState of B lanes, or None
    long_pnl_by_name: torch.Tensor  # [N] running after-cost long P&L
    short_pnl_by_name: torch.Tensor  # [N] running after-cost short P&L


class AdvanceOutputs(NamedTuple):
    """The newly FINALIZED date's research-step row. ``ready`` is False for
    the very first ingested date (nothing to finalize; the other fields
    are then placeholders)."""

    ready: bool
    day: int                      # finalized absolute date index
    selection: torch.Tensor       # [F] daily factor weights
    signal: torch.Tensor          # [N] composite signal
    weights: torch.Tensor         # [N] traded (shifted) book
    long_count: torch.Tensor      # int[]
    short_count: torch.Tensor     # int[]
    log_return: torch.Tensor      # [] net daily return
    long_return: torch.Tensor     # []
    short_return: torch.Tensor    # []
    long_turnover: torch.Tensor   # []
    short_turnover: torch.Tensor  # []
    turnover: torch.Tensor        # []
    resid: torch.Tensor           # [] final ADMM primal residual (NaN = n/a)
    solver_ok: torch.Tensor       # bool[]


def _cold_warm(lanes: int, n: int, device) -> ADMMWarmState:
    """Cold ADMM state of ``lanes`` lanes (zeros; rho NaN, the solver's
    cold sentinel), as ``backtest.mvo._cold_state``."""
    z = torch.zeros((lanes, n), dtype=QP_DTYPE, device=device)
    return ADMMWarmState(z=z, u=torch.zeros_like(z),
                         rho=torch.full((lanes,), float("nan"),
                                        dtype=QP_DTYPE, device=device))


def init_market_state(*, n_factors: int, n_assets: int, dtype,
                      stats_needs: tuple, tail: int, ring: int,
                      lb: int | None, has_universe: bool,
                      risk_factors: int | None = None,
                      device=None) -> MarketState:
    """Empty market state on ``device``: NaN/False ramp padding."""
    f, n = int(n_factors), int(n_assets)

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    rm = None
    if risk_factors is not None:
        rm = (full((n, risk_factors), float("nan"), QP_DTYPE),
              full((risk_factors,), float("nan"), QP_DTYPE),
              full((n,), float("nan"), QP_DTYPE))
    return MarketState(
        day=-1, version=0,
        factors_tail=full((f, tail, n), float("nan")),
        returns_tail=full((tail, n), float("nan")),
        cap_tail=full((tail, n), 0.0),
        invest_tail=full((tail, n), 0.0),
        universe_tail=(full((tail, n), False, torch.bool) if has_universe
                       else None),
        stats_ring={k: full((f, ring), float("nan")) for k in stats_needs},
        fr_ring=full((ring, f), float("nan")),
        lb_ring=None if lb is None else full((lb, n), 0.0, QP_DTYPE),
        risk_model=rm)


def init_tenant_state(*, n_assets: int, dtype, method: str,
                      mvo_batch: int | None, warm_start: bool,
                      device=None) -> TenantState:
    """Cold tenant state on ``device``. The warm carries exist only for the
    scheme that consumes them: the turnover scan's one lane, plain MVO's
    ring of ``mvo_batch`` lanes."""
    n = int(n_assets)
    warm = warm_ring = None
    if method == "mvo_turnover" and warm_start:
        warm = _cold_warm(1, n, device)
    if method == "mvo" and warm_start and mvo_batch:
        warm_ring = _cold_warm(int(mvo_batch), n, device)
    return TenantState(
        w_prev=torch.zeros((n,), dtype=QP_DTYPE, device=device),
        book_carry=torch.full((n,), float("nan"), dtype=dtype, device=device),
        traded_prev=torch.full((n,), float("nan"), dtype=dtype,
                               device=device),
        warm=warm, warm_ring=warm_ring,
        long_pnl_by_name=torch.zeros((n,), dtype=dtype, device=device),
        short_pnl_by_name=torch.zeros((n,), dtype=dtype, device=device))


def stack_tenant_states(states) -> TenantState:
    """Per-tenant states stacked into one state of ``C`` lanes."""
    states = list(states)
    first = states[0]

    def pick(field, sub=None):
        vals = [getattr(t, field) for t in states]
        return vals if sub is None else [getattr(v, sub) for v in vals]

    def warm(field, join):
        if getattr(first, field) is None:
            return None
        return ADMMWarmState(*(join(pick(field, k))
                               for k in ADMMWarmState._fields))

    return TenantState(
        w_prev=torch.stack(pick("w_prev")),
        book_carry=torch.stack(pick("book_carry")),
        traded_prev=torch.stack(pick("traded_prev")),
        warm=warm("warm", torch.cat), warm_ring=warm("warm_ring", torch.stack),
        long_pnl_by_name=torch.stack(pick("long_pnl_by_name")),
        short_pnl_by_name=torch.stack(pick("short_pnl_by_name")))


def tenant_state_lane(ts: TenantState, lane: int) -> TenantState:
    """Lane ``lane`` of a stacked state, as one tenant's state (the
    turnover warm state keeps its lane axis of one)."""
    def warm(x, pick):
        return None if x is None else ADMMWarmState(*(pick(a) for a in x))

    return TenantState(
        w_prev=ts.w_prev[lane], book_carry=ts.book_carry[lane],
        traded_prev=ts.traded_prev[lane],
        warm=warm(ts.warm, lambda a: a[lane:lane + 1]),
        warm_ring=warm(ts.warm_ring, lambda a: a[lane]),
        long_pnl_by_name=ts.long_pnl_by_name[lane],
        short_pnl_by_name=ts.short_pnl_by_name[lane])


# ------------------------------------------------------ asset placement

#: the market fields whose last dim is the asset axis
_MARKET_ASSETS = ("factors_tail", "returns_tail", "cap_tail", "invest_tail",
                  "universe_tail", "lb_ring")
#: the per-name tenant carries (the ADMM warm states' ``z``/``u`` too)
_TENANT_ASSETS = ("w_prev", "book_carry", "traded_prev", "long_pnl_by_name",
                  "short_pnl_by_name")


def _map_leaves(state, fn):
    """``state`` with each tensor leaf replaced by ``fn(path, leaf,
    assets, lanes)``: ``assets`` whether its last dim is the asset axis,
    ``lanes`` whether its first is a session's lane axis (tenant
    leaves). ``state`` is a :class:`MarketState`, a :class:`TenantState`
    or a :class:`DateSlice`; ``None`` leaves stay ``None``."""
    def put(path, leaf, assets, lanes=False):
        return None if leaf is None else fn(path, leaf, assets, lanes)

    if isinstance(state, MarketState):
        rm = state.risk_model
        return dataclasses.replace(
            state,
            **{k: put(k, getattr(state, k), True) for k in _MARKET_ASSETS},
            stats_ring={k: put(f"stats_ring/{k}", v, False)
                        for k, v in state.stats_ring.items()},
            fr_ring=put("fr_ring", state.fr_ring, False),
            # (loadings [N, k], factor_var [k], idio [N])
            risk_model=None if rm is None else tuple(
                put(f"risk_model/{i}", a, i == 2) for i, a in enumerate(rm)))
    if isinstance(state, TenantState):
        def warm(name, w):
            return None if w is None else ADMMWarmState(*(
                put(f"{name}/{k}", getattr(w, k), k != "rho", True)
                for k in ADMMWarmState._fields))

        return dataclasses.replace(
            state,
            **{k: put(k, getattr(state, k), True, True)
               for k in _TENANT_ASSETS},
            warm=warm("warm", state.warm),
            warm_ring=warm("warm_ring", state.warm_ring))
    if isinstance(state, DateSlice):
        return DateSlice(*(put(k, v, k != "factor_ret")
                           for k, v in zip(DateSlice._fields, state)))
    raise TypeError(f"not an online state: {type(state).__name__}")


def online_leaf_dims(state, asset_axis: str = "assets",
                     config_axis: str | None = None) -> dict:
    """``{path: dims}`` for every tensor leaf of ``state`` (module docs):
    ``dims`` names the mesh axis each dim lies along (None: whole), the
    asset axis on an asset leaf's last dim and, for a stacked
    :class:`TenantState`, ``config_axis`` on the lane dim, the JAX
    package's ``_online_state_specs`` form. Paths are ``field``,
    ``field/key`` (a stat ring) and ``field/index`` (the risk model)."""
    out = {}

    def dims(path, leaf, assets, lanes):
        d = [None] * leaf.ndim
        if lanes and leaf.ndim:
            d[0] = config_axis
        if assets:
            d[-1] = asset_axis
        out[path] = tuple(d)
        return leaf

    _map_leaves(state, dims)
    return out


def check_asset_divisible(n_assets: int, mesh, asset_axis: str) -> int:
    """The asset axis's size; a ValueError when it does not divide
    ``n_assets``."""
    from factormodeling_tpu_torch.parallel.mesh import axis_size

    size = axis_size(mesh, asset_axis)
    if n_assets % size:
        raise ValueError(
            f"{n_assets} assets are not divisible by the mesh's "
            f"'{asset_axis}' axis ({size}); pad the asset axis or pick a "
            f"mesh whose asset axis divides N")
    return size


def shard_online_state(state, mesh, asset_axis: str = "assets"):
    """This rank's blocks of ``state`` (a :class:`MarketState`, stacked or
    single :class:`TenantState`, or :class:`DateSlice`, on any device;
    numpy leaves too): each asset leaf's ``N/s`` columns, every other leaf
    whole, on the mesh's device (module docs)."""
    from factormodeling_tpu_torch.parallel.mesh import (_block, axis_index,
                                                        mesh_device)

    dev = mesh_device(mesh)
    probe = state.returns if isinstance(state, DateSlice) else (
        state.returns_tail if isinstance(state, MarketState)
        else state.w_prev)
    n = int(np.shape(probe)[-1])
    size = check_asset_divisible(n, mesh, asset_axis)
    cols = _block(n, size, axis_index(mesh, asset_axis))

    def block(path, leaf, assets, lanes):
        t = torch.as_tensor(np.asarray(leaf) if not isinstance(
            leaf, torch.Tensor) else leaf).to(dev)
        if not assets:
            return t
        return t[..., cols].contiguous()

    return _map_leaves(state, block)


def shard_date_slice(date_slice: DateSlice, mesh,
                     asset_axis: str = "assets") -> DateSlice:
    """One arriving date's blocks: ``factors [F, N]``, ``returns``,
    ``cap_flag``, ``investability`` and ``universe`` as this rank's ``N/s``
    columns, ``factor_ret [F]`` whole (the JAX package's
    ``_shard_date_slice``)."""
    return shard_online_state(date_slice, mesh, asset_axis)

