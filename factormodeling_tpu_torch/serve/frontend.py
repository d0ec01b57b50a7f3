"""The serving front end: signature buckets, the pad ladder, cached step
callables and per-tenant demux (port of
``factormodeling_tpu/serve/frontend.py``).

``TenantServer`` holds the market panels on its device and answers
``serve(configs)``:

1. **validate**: every submitted :class:`TenantConfig` is checked on the
   host (:meth:`TenantConfig.validate`) before anything runs; an invalid
   config raises a ValueError naming its position.
2. **bucket**: configs partition by :meth:`TenantConfig.static_key`; a
   bucket shares one step.
3. **pad**: a bucket dispatches in chunks padded up a fixed ladder
   (default ``1/8/64/512``), chunks of the top rung when it holds more, so
   the set of (bucket, rung) entries stays finite as traffic moves. Pad
   lanes repeat the chunk's last config. The JAX package computes them in
   its vmap and drops them at demux; the port's tenant body runs on the
   real lanes only (the pad slots hold the last real lane's output), and
   they are still tallied as ``padded_lanes``.
4. **dispatch**: one callable per (bucket, rung), built on first use and
   kept in the bounded LRU of ``parallel/streaming.py``, so a 1000-tenant
   sweep holds one cache entry per bucket. The callable runs the batched
   step: the selection context once, then the tenant body once on the
   real lanes.
5. **demux**: one :class:`TenantResult` per submitted config, in
   submission order.

:meth:`TenantServer.serve_queued` runs the same pad and dispatch machinery
under the traffic layer (``serve/queue.py``), imported on first use, so a
server that never queues never loads it. :meth:`TenantServer.online_begin`
and :meth:`TenantServer.advance_all` advance many tenants a date at a time
over ``online/advance.py``: one market advance a session and date (K1 once
a date), then the tenant half once on the session's stacked lanes (one
lane-batched solve a date for the QP schemes).

``serve(lineage=...)`` records one provenance edge a served lane, and
``advance_all(meter=..., series=...)`` bills each session's fenced wall to
a cost meter and samples a health series; their obs modules are imported
only when asked.

``TenantServer(mesh=...)`` serves over a ``("configs", "assets")`` mesh,
one rank a device, every rank holding the same inputs and making the same
calls: the market panels are stored asset-sharded (each rank its ``N/S``
columns, ``parallel/asset_shard.asset_in_shardings``) and stay so through
a dispatch: the bucket's step runs on the blocks
(``serve/batched.make_sharded_batched_step``: the scoring, the blend and
the backtest form their rows under an all-``auto`` layout plan), its
signal and weights come back as asset blocks and are gathered for the
demux. A bucket's real lanes split over the ``"configs"`` axis (each
rank computes its block of lanes) and the lanes' outputs are gathered, so
every rank returns every tenant's result. An online session's lanes split
the same way, and its carried state is held as asset blocks too: each
rank keeps the session's market state and its own lanes' tenant states
as their ``N/S`` columns by the JAX package's leaf rule
(``online/state.shard_online_state``: the tails, the covariance ring, the
idiosyncratic variances and every per-name carry; the stat and
factor-return rings, the loadings and ``rho`` whole), ``advance_all``
cuts the arriving date's blocks once a call, each session advances on
them (``online/advance.py`` over the mesh: its seven ``online/*`` stages
form their rows under the all-``auto`` plan) and the rows' ``signal`` and
``weights`` are gathered over the asset axis, then the lanes over the
config axis, for the demux. The mesh joins the cache key
(``serve/tenant.mesh_key``), so two meshes never share a built step.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.composite import prefix_group_ids
from factormodeling_tpu_torch.obs import record_stage
from factormodeling_tpu_torch.obs.compile_log import entry_point_tag
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.parallel import streaming as _streaming
from factormodeling_tpu_torch.parallel.mesh import (all_gather, axis_index,
                                                    axis_size, mesh_device)
from factormodeling_tpu_torch.parallel.pipeline import ResearchOutput
from factormodeling_tpu_torch.serve.batched import (
    _stack, _tree_map, lane_count, make_batched_research_step,
    make_sharded_batched_step, tree_lane)
from factormodeling_tpu_torch.serve.tenant import (TenantConfig,
                                                   config_leaves, mesh_key,
                                                   stack_configs)

__all__ = ["DEFAULT_PAD_LADDER", "TenantAdvance", "TenantResult",
           "TenantServer"]

#: steady-state batch sizes: a bucket of C configs dispatches in chunks
#: padded up to the smallest rung >= C (chunks of the top rung when C
#: exceeds it), so a bucket has at most len(ladder) entries
DEFAULT_PAD_LADDER = (1, 8, 64, 512)


class TenantResult(NamedTuple):
    index: int              # position in the submitted config list
    config: TenantConfig    # the config as submitted (pre-normalization)
    output: ResearchOutput  # this tenant's lane (selection/signal/sim/summary)


class TenantAdvance(NamedTuple):
    """One tenant's lane of an :meth:`TenantServer.advance_all` call: the
    newly finalized date's row
    (:class:`~factormodeling_tpu_torch.online.state.AdvanceOutputs`)."""

    index: int
    config: TenantConfig
    output: object          # AdvanceOutputs


def _rung_for(count: int, ladder) -> int:
    for r in ladder:
        if count <= r:
            return r
    return ladder[-1]


class TenantServer:
    """Many-tenant serving over one fixed market panel set (module docs).

    Args:
      names: factor names (the composite's prefix/suffix convention).
      factors: ``[F, D, N]`` raw exposures; returns: ``[D, N]``;
        factor_ret: ``[D, F]``; cap_flag / investability: ``[D, N]``;
        universe: optional ``bool[D, N]``. Numpy arrays or tensors, moved
        to ``device`` once, here.
      pad_ladder: strictly ascending positive batch-size rungs (default
        ``1/8/64/512``).
      device: None is the card (it raises without one); ``"cpu"`` runs on
        the host. With a mesh the device is the mesh's.
      mesh: optional ``DeviceMesh`` with a ``config_axis`` and/or an
        ``asset_axis`` (module docs); either may be missing (a flat
        ``("assets",)`` mesh shards the panels only).
      config_axis / asset_axis: the mesh axis names (defaults
        ``"configs"`` / ``"assets"``).
    """

    def __init__(self, *, names, factors, returns, factor_ret, cap_flag,
                 investability, universe=None,
                 pad_ladder=DEFAULT_PAD_LADDER, device=None, mesh=None,
                 config_axis="configs", asset_axis="assets"):
        self.names = tuple(names)
        # validated, not normalized: a descending or duplicated ladder is a
        # typo, rejected with the reason before anything runs
        ladder = tuple(pad_ladder)
        if not ladder:
            raise ValueError("pad_ladder must hold at least one rung")
        if any(int(r) != r or int(r) < 1 for r in ladder):
            raise ValueError(f"pad_ladder rungs must be positive "
                             f"integers, got {pad_ladder!r}")
        ladder = tuple(int(r) for r in ladder)
        if any(b <= a for a, b in zip(ladder, ladder[1:])):
            raise ValueError(f"pad_ladder must be strictly ascending "
                             f"(no duplicate or out-of-order rungs), "
                             f"got {pad_ladder!r}")
        self.pad_ladder = ladder
        self.mesh = mesh
        self._config_axis = config_axis
        self._asset_axis = asset_axis
        self.device = (mesh_device(mesh) if mesh is not None
                       else resolve_device(device))
        self._panels = tuple(
            None if a is None else torch.as_tensor(a, device=self.device)
            for a in (factors, returns, factor_ret, cap_flag, investability,
                      universe))
        self.n_assets = int(self._panels[1].shape[-1])
        self._placements = None
        if mesh is not None:
            self._panels = self._shard_panels(self._panels)
        f, d, _ = self._panels[0].shape
        if len(self.names) != f:
            raise ValueError(f"{len(self.names)} names for a factor stack "
                             f"of {f}")
        self.n_dates = d
        _, prefixes = prefix_group_ids(self.names)
        self.n_groups = len(prefixes)
        self._dtype = np.dtype(str(self._panels[1].dtype).split(".")[-1])
        # dispatch_executions counts every call of a bucket's step (the
        # queue's poisoned-then-retried attempts included);
        # logical_dispatches counts scheduling decisions (one a serve()
        # chunk, a queued dispatch, an advance_all session)
        self._buckets_seen: set = set()
        self._executables_seen: set = set()
        self._stats = {"dispatch_executions": 0, "logical_dispatches": 0,
                       "configs_served": 0, "padded_lanes": 0,
                       "rejected_configs": 0}
        self._online: dict = {}
        self._advance_ordinal = 0   # advance_all's default date label

    # --------------------------------------------------------- sharding

    def _shard_panels(self, panels):
        """Keep this rank's asset block of every ``[..., N]`` panel
        (``asset_in_shardings`` with no date axis; ``factor_ret [D, F]``
        whole); a mesh without the asset axis keeps them whole."""
        from factormodeling_tpu_torch.parallel.asset_shard import \
            asset_in_shardings

        from factormodeling_tpu_torch.online.state import \
            check_asset_divisible

        if self._asset_axis not in tuple(self.mesh.mesh_dim_names):
            return panels
        check_asset_divisible(self.n_assets, self.mesh, self._asset_axis)
        self._placements = asset_in_shardings(self.mesh, None,
                                              self._asset_axis)
        return tuple(None if p is None else pl.shard(p, self.device)
                     for p, pl in zip(panels, self._placements))

    def _market_panels(self) -> tuple:
        """The whole market panels (an asset-sharded server gathers its
        blocks; only the fingerprint reads them whole)."""
        if self._placements is None:
            return self._panels
        with obs_stage("parallel/inputs"):
            return tuple(None if p is None else pl.gather(p)
                         for p, pl in zip(self._panels, self._placements))

    def _lanes_split(self) -> bool:
        """Whether the mesh has a config axis: then a dispatch's lanes are
        split over it (a size-1 axis too: this rank holds every lane)."""
        return (self.mesh is not None
                and self._config_axis in tuple(self.mesh.mesh_dim_names))

    def _config_share(self) -> tuple:
        """(size, index) of this rank along the config axis ((1, 0)
        without one)."""
        if not self._lanes_split():
            return 1, 0
        return (axis_size(self.mesh, self._config_axis),
                axis_index(self.mesh, self._config_axis))

    def _lane_block(self, n: int) -> tuple:
        """This rank's lanes of ``n`` real ones: ``(indices, per)`` with
        ``per`` lanes a rank; a rank past the real lanes gets the last
        real lane's index (its output is gathered and dropped)."""
        size, idx = self._config_share()
        per = -(-n // size)
        return [i for i in range(idx * per, min((idx + 1) * per, n))] \
            or [n - 1], per

    def _gather_lanes(self, tree, per: int):
        """Each leaf's ``[per, ...]`` lanes gathered over the config axis
        (``[size * per, ...]``, rank order)."""
        with obs_stage("serve/tenants"):
            return _tree_map(lambda a: all_gather(
                torch.cat([a] + [a[-1:]] * (per - a.shape[0]))
                if a.shape[0] < per else a,
                self.mesh, self._config_axis, dim=0), tree)

    # ------------------------------------------------------- executables

    def _entry_key(self, skey, rung: int) -> tuple:
        shapes = tuple(None if a is None else
                       (tuple(a.shape), str(a.dtype)) for a in self._panels)
        # the device too: a server on the card and one on the CPU over
        # equal panels are two entry points (two call signatures)
        key = ("serve", self.names, skey, rung, shapes, str(self.device))
        if self.mesh is not None:
            # another mesh runs other collectives on other groups: never
            # one cache entry for two meshes
            key += (mesh_key(self.mesh),)
        return key

    def entry_name(self, skey, rung: int) -> str:
        """The stable per-(bucket, rung) entry-point name, under which the
        serving queue's estimator seeds from a latency recorder."""
        return f"serve/bucket/{entry_point_tag(self._entry_key(skey, rung))}"

    def _executable(self, skey, rung: int, template: TenantConfig):
        """One step callable per (bucket, rung) through the bounded LRU;
        the key is value-based (static residue, rung, panel shapes and
        dtypes), so servers over equal-shaped markets share entries (the
        panels are arguments, not closures)."""
        config = self._entry_key(skey, rung)

        def build():
            if self._placements is not None:
                return make_sharded_batched_step(
                    names=self.names, template=template, mesh=self.mesh,
                    asset_axis=self._asset_axis)
            return make_batched_research_step(names=self.names,
                                              template=template)

        name = f"serve/bucket/{entry_point_tag(config)}"
        return name, _streaming._cached_kernel(None, config, build,
                                               name=name,
                                               expected_signatures=1)

    # ------------------------------------------------------------ serving

    def _normalize(self, c) -> TenantConfig:
        """Validate one config against this server's market (a clear
        ValueError) and return it normalized to the panels' dtype; shared
        by the synchronous path and the queue."""
        if not isinstance(c, TenantConfig):
            self._stats["rejected_configs"] += 1
            raise ValueError(f"config is not a TenantConfig "
                             f"(got {type(c).__name__})")
        try:
            c.validate(len(self.names), self.n_groups, self.n_dates)
        except ValueError:
            self._stats["rejected_configs"] += 1
            raise
        return c.normalized(len(self.names), self.n_groups,
                            dtype=self._dtype)

    def _normalize_all(self, configs) -> list:
        out = []
        for i, c in enumerate(configs):
            try:
                out.append(self._normalize(c))
            except ValueError as e:
                raise ValueError(f"config {i} rejected before compile: "
                                 f"{e}") from e
        return out

    def _dispatch_padded(self, skey, rung: int, lanes, template):
        """Pad ``lanes`` (normalized same-bucket configs) up to ``rung``,
        run the bucket's step on the real lanes and tally the serving
        stats. Returns ``(entry_name, stacked_output, padded_lanes)``; the
        demux stays with the caller. Tallies ``dispatch_executions``; the
        scheduling decision tallies ``logical_dispatches`` at its own
        site."""
        self._buckets_seen.add(skey)
        real = len(lanes)
        pad = rung - real
        name, step = self._executable(skey, rung, template)
        self._executables_seen.add(name)
        if self._lanes_split():
            mine, per = self._lane_block(real)
            stacked = stack_configs([lanes[i] for i in mine])
            out = self._gather_lanes(self._run(step, stacked), per)
            # the real lanes in order, then the pad lanes as the
            # unsharded step fills them: lane real-1's output
            out = _tree_map(lambda a: torch.cat(
                [a[:real]] + [a[real - 1:real]] * pad), out)
        else:
            stacked = stack_configs(list(lanes) + [lanes[-1]] * pad)
            out = self._run(step, stacked, lanes=real)
        self._stats["dispatch_executions"] += 1
        self._stats["configs_served"] += real
        self._stats["padded_lanes"] += pad
        return name, out, pad

    def _run(self, step, stacked, **kw):
        """The bucket's step on the stored panels; an asset-sharded
        server's signal and weights come back as asset blocks and are
        gathered whole."""
        out = step(stacked, *self._panels, **kw)
        if self._placements is None:
            return out
        with obs_stage("serve/tenants"):
            gather = (lambda a: all_gather(a, self.mesh, self._asset_axis,
                                           dim=-1))
            return out._replace(signal=gather(out.signal),
                                sim=out.sim._replace(
                                    weights=gather(out.sim.weights)))

    def _note_logical_dispatch(self) -> None:
        """One scheduling decision completed (the queue's hook)."""
        self._stats["logical_dispatches"] += 1

    def panels_fingerprint(self) -> str:
        """Content address of the market panels
        (``resil.checkpoint.fingerprint`` over the six panel slots, None
        slots hashed as absent), computed once."""
        fp = getattr(self, "_panels_fp", None)
        if fp is None:
            from factormodeling_tpu_torch.resil.checkpoint import fingerprint

            fp = self._panels_fp = fingerprint(*self._market_panels())
        return fp

    def serve(self, configs, *, lineage=None) -> list[TenantResult]:
        """Validate, bucket, pad, dispatch, demux (module docs). Returns
        one :class:`TenantResult` per submitted config, in order.

        ``lineage``: ``True`` or a
        :class:`~factormodeling_tpu_torch.obs.lineage.LineageLedger`
        records one edge a served lane, from the panels' and the config's
        fingerprints to the fingerprint of the lane's weight book, with the
        entry point (each dispatch copies its books to the host once). Its
        rows land on the active report under ``serve/sync``. Off by
        default; ``obs.lineage`` is not imported then."""
        configs = list(configs)
        if not configs:
            return []
        ledger = panels_id = None
        if lineage:
            from factormodeling_tpu_torch.obs.lineage import LineageLedger

            ledger = (lineage if isinstance(lineage, LineageLedger)
                      else LineageLedger())
            panels_id = ledger.source(self.panels_fingerprint(), "panels")
        normalized = self._normalize_all(configs)
        buckets: dict = {}
        for i, c in enumerate(normalized):
            buckets.setdefault(c.static_key(), []).append(i)

        results: list = [None] * len(configs)
        top = self.pad_ladder[-1]
        for skey, members in buckets.items():
            template = normalized[members[0]]
            for lo in range(0, len(members), top):
                chunk = members[lo:lo + top]
                rung = _rung_for(len(chunk), self.pad_ladder)
                name, out, pad = self._dispatch_padded(
                    skey, rung, [normalized[i] for i in chunk], template)
                self._note_logical_dispatch()
                record_stage("serve/dispatch", kind="stage",
                             entry_point=name, rung=rung,
                             configs=len(chunk), padded_lanes=pad,
                             bucket_count=len(self._buckets_seen))
                books = (out.sim.weights.cpu().numpy() if ledger is not None
                         else None)
                for lane, i in enumerate(chunk):
                    results[i] = TenantResult(index=i, config=configs[i],
                                              output=tree_lane(out, lane))
                    if ledger is not None:
                        self._lineage_edge(ledger, panels_id, normalized[i],
                                           books[lane], skey, name, rung, i)
        if ledger is not None:
            from factormodeling_tpu_torch.obs.report import active_report

            rep = active_report()
            if rep is not None:
                rep.rows.extend(ledger.rows("serve/sync"))
        return results

    def _lineage_edge(self, ledger, panels_id, config, book, skey, name,
                      rung, index) -> None:
        """One served lane's edge: the book's fingerprint from the panels
        and the config (the book, the artifact a consumer acts on, is
        hashed alone)."""
        from factormodeling_tpu_torch.resil.checkpoint import fingerprint

        cfg_id = ledger.source(fingerprint(*config_leaves(config)), "config")
        ledger.edge(fingerprint(book), "dispatch", [panels_id, cfg_id],
                    code={"static_key": repr(skey), "bucket": name,
                          "rung": int(rung), "mesh": self._mesh_shape()},
                    rid=int(index))

    def serve_queued(self, requests, **kwargs):
        """Drain :class:`~factormodeling_tpu_torch.serve.queue.Request`s
        through the traffic layer (``serve/queue.py``: admission,
        deadline-aware batching, shedding, retried dispatch,
        checkpoint/resume); returns its
        :class:`~factormodeling_tpu_torch.serve.queue.QueueResult`. The
        queue module is imported here, on first use."""
        from factormodeling_tpu_torch.serve.queue import run_queued

        return run_queued(self, requests, **kwargs)

    # ------------------------------------------------------ online advance

    def online_begin(self, configs, *, stats_tail: int = 8) -> dict:
        """Open a many-tenant online session: validate and bucket the
        configs as :meth:`serve` does and split each bucket into chunks of
        the top rung; each chunk (a session) holds one
        :class:`~factormodeling_tpu_torch.online.state.MarketState` and one
        :class:`~factormodeling_tpu_torch.online.state.TenantState` a real
        lane. Each session's advance is one callable in the shared LRU
        (built on the first :meth:`advance_all`). On an asset mesh the
        states are this rank's asset blocks (module docs). The online
        package is imported here, on first use.

        Returns ``{"buckets": ..., "tenants": ...}``."""
        from factormodeling_tpu_torch.online.advance import (lane_outputs,
                                                             online_step_parts)
        from factormodeling_tpu_torch.online.state import stack_tenant_states

        configs = list(configs)
        if not configs:
            raise ValueError("online_begin needs at least one config")
        normalized = self._normalize_all(configs)
        buckets: dict = {}
        for i, c in enumerate(normalized):
            buckets.setdefault(c.static_key(), []).append(i)

        has_universe = self._panels[5] is not None
        n_assets = self.n_assets
        dtype = self._panels[1].dtype
        self._online = {}
        self._online_configs = configs
        top = self.pad_ladder[-1]
        for skey, members in buckets.items():
            self._buckets_seen.add(skey)
            template = normalized[members[0]]
            im, it, am, at = online_step_parts(
                names=self.names, template=template, n_assets=n_assets,
                dtype=dtype, has_universe=has_universe,
                stats_tail=stats_tail, device=self.device,
                mesh=self.mesh if self._placements is not None else None,
                asset_axis=self._asset_axis)

            def batched(lanes, mstate, tstates, date_slice, _am=am,
                        _at=at.lanes):
                # the market half once, the tenant half once on the
                # session's real lanes
                mstate2, octx = _am(mstate, date_slice)
                tstates2, out = _at(lanes, tstates, octx)
                return mstate2, tstates2, [
                    lane_outputs(out, i) for i in range(lane_count(lanes))]

            # a bucket wider than the top rung becomes several sessions,
            # each advancing its own MarketState copy; over a config axis
            # each rank holds and advances its own block of the lanes
            for lo in range(0, len(members), top):
                chunk = members[lo:lo + top]
                rung = _rung_for(len(chunk), self.pad_ladder)
                mine, per = self._lane_block(len(chunk))
                self._online[(skey, lo)] = {
                    "members": chunk, "rung": rung,
                    "pad": rung - len(chunk),
                    "per": per,
                    "lanes": stack_configs([normalized[chunk[i]]
                                            for i in mine]),
                    "mstate": im(),
                    "tstates": stack_tenant_states([it() for _ in mine]),
                    "batched": batched,
                    "key": ("online", self.names, skey, rung, stats_tail,
                            str(self.device), self._entry_key(skey, rung)),
                }
        record_stage("online/begin", kind="stage", buckets=len(buckets),
                     sessions=len(self._online), tenants=len(configs))
        return {"buckets": len(buckets), "tenants": len(configs)}

    def _online_executable(self, session):
        config = session["key"]
        name = f"online/bucket/{entry_point_tag(config)}"
        return name, _streaming._cached_kernel(
            None, config, lambda: session["batched"], name=name,
            expected_signatures=1)

    def advance_all(self, date_slice, *, date=None, meter=None,
                    series=None) -> "list[TenantAdvance]":
        """Advance every tenant of every session by one arriving date
        (:class:`~factormodeling_tpu_torch.online.state.DateSlice`): one
        market advance a session, then the tenant half once on the
        session's lanes.
        Returns one :class:`TenantAdvance` per config given to
        :meth:`online_begin`, in its order; ``output.ready`` is False on
        the very first date. On an asset mesh the date's blocks are cut
        once a call and every row comes back whole.

        ``meter``: a
        :class:`~factormodeling_tpu_torch.obs.metering.CostMeter`; each
        session's fenced wall (``torch.cuda.synchronize`` inside the timed
        window on the card) is split across its rung's lanes into one
        account a (session, ``date``), pad lanes billed to
        ``overhead/pad``. ``date`` labels the account (default: the
        advance's ordinal). With ``meter=None`` no timer and no fence run.
        ``series``: a
        :class:`~factormodeling_tpu_torch.obs.reqtrace.HealthSeries`; each
        call appends one sample at ``t = date``: depth the session count,
        occupancy the mean real-lane share, shed rate 0."""
        if not self._online:
            raise RuntimeError("advance_all before online_begin — open an "
                               "online session first")
        if self._placements is not None:
            from factormodeling_tpu_torch.online.state import \
                shard_date_slice

            date_slice = shard_date_slice(date_slice, self.mesh,
                                          self._asset_axis)
        if date is None:
            date = self._advance_ordinal
        self._advance_ordinal += 1
        results: list = [None] * len(self._online_configs)
        for session in self._online.values():
            name, exe = self._online_executable(session)
            self._executables_seen.add(name)
            if meter is not None:
                self._fence()
                t0 = time.perf_counter()
            mstate2, tstates2, outs = exe(session["lanes"], session["mstate"],
                                          session["tstates"], date_slice)
            if meter is not None:
                # the fence inside the window: the launches return before
                # the card has run them
                self._fence()
                meter.charge([f"{name}@{date}"] * len(session["members"]),
                             session["rung"],
                             wall_s=time.perf_counter() - t0)
            session["mstate"], session["tstates"] = mstate2, tstates2
            if self._placements is not None or self._lanes_split():
                outs = self._gather_outputs(outs, session)
            self._stats["dispatch_executions"] += 1
            self._stats["logical_dispatches"] += 1
            self._stats["configs_served"] += len(session["members"])
            self._stats["padded_lanes"] += session["pad"]
            record_stage("online/advance", kind="stage",
                         entry_point=name, rung=session["rung"],
                         configs=len(session["members"]),
                         padded_lanes=session["pad"])
            for i, out in zip(session["members"], outs):
                results[i] = TenantAdvance(
                    index=i, config=self._online_configs[i], output=out)
        if series is not None:
            occ = [len(s["members"]) / s["rung"]
                   for s in self._online.values()]
            series.sample(t=float(date), depth=len(self._online),
                          occupancy=sum(occ) / len(occ), shed_rate=0.0)
        return results

    def _gather_outputs(self, outs, session) -> list:
        """Every member's whole advance row from each rank's own lanes and
        asset blocks: the rows are stacked, their ``signal`` and
        ``weights`` gathered over the asset axis, the lanes over the
        config axis, and split again (the date's ``ready``/``day`` are the
        market's, equal on every rank)."""
        own = list(outs)
        stacked = _stack(own, self.device)
        if self._placements is not None:
            from factormodeling_tpu_torch.online.advance import \
                gather_advance_outputs

            with obs_stage("serve/tenants"):
                stacked = gather_advance_outputs(stacked, self.mesh,
                                                 self._asset_axis)
        if self._lanes_split():
            stacked = self._gather_lanes(stacked, session["per"])
        return [tree_lane(stacked, i)._replace(ready=own[0].ready,
                                               day=own[0].day)
                for i in range(len(session["members"]))]

    def _mesh_shape(self):
        if self.mesh is None:
            return None
        return {n: int(s) for n, s in zip(self.mesh.mesh_dim_names,
                                          self.mesh.shape)}

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------------- stats

    def serving_stats(self) -> dict:
        """The serving tallies: ``bucket_count`` (distinct signature
        buckets seen), ``executables`` ((bucket, rung) entry points), the
        ``dispatch_executions`` / ``logical_dispatches`` pair (executions
        exceed logical dispatches by the queue's poisoned attempts, which
        reached the step; ``dispatch_error`` attempts reach neither), the
        config and pad counts, the ladder, ``mesh_shape`` (None without a
        mesh) and the shared LRU's counters."""
        return {"bucket_count": len(self._buckets_seen),
                "executables": len(self._executables_seen),
                **self._stats,
                "pad_ladder": self.pad_ladder,
                "mesh_shape": self._mesh_shape(),
                "kernel_cache": _streaming.streaming_cache_stats()}
