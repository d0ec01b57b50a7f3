"""Multi-process ``torch.distributed`` correctness check (worker and
launcher; port of ``factormodeling_tpu/parallel/_dist_check.py``).

The launcher spawns real processes on this host, one rank each; they
rendezvous through ``initialize_cluster("file://...")`` (a ``FileStore``
in a temporary directory: no port to race for), form a ``gloo`` world on
the CPU posing as two hosts (``LOCAL_WORLD_SIZE`` is half the world, so
``make_hybrid_mesh`` puts its first axis across them), and every rank
runs, on the same seeded float64 inputs:

- the factor x date sharded research step (``make_hybrid_mesh(("factor",
  "date"))``) for four selector/weight configurations, each held against
  the rank's own unsharded step at 1e-10 (Sharpe 1e-8), then prints
  ``DIST_OK <rank>``;
- the asset-sharded step on a ``("date", "assets")`` mesh and on a flat
  ``("assets",)`` mesh, for the ``equal``, ``linear``, ``mvo`` and
  ``mvo_turnover`` (scan and parallel) backtests, in each layout mode and
  under the JAX package's mixed plan (:data:`MIXED`), its outputs gathered
  (``step.gather_outputs``) and held the same way, each call's ledger
  kept, the equal step's first call under a ``RunReport(comms=True)``
  (the placement rows), then prints ``DIST_ASSET_OK <rank>``;
- the asset-sharded online advance (``make_online_step(mesh=)`` on a flat
  ``("assets",)`` mesh, every layout mode) for the JAX package's online
  ladder (:data:`ONLINE_LADDER`) on a NaN and a ragged market and a
  risk-model cell, each held against the rank's unsharded advance, with
  the state's held shapes and placements and each run's comms ledger,
  then prints ``DIST_ONLINE_OK <rank>``;
- then the comms ledgers, an ``all_reduce``, the layout chooser, the
  sharded sweep, date-sharded streaming, the sharded ``TenantServer`` on
  a ``("configs", "assets")`` and an ``("assets",)`` mesh (its
  dispatches on the stored blocks, counting whole-panel gathers, and its
  online sessions on their state's blocks) and the divisibility
  errors.

Each rank writes what it computed to ``<out_dir>/rank<r>.pt`` (numpy
arrays and plain values), which the tests compare with the JAX package's
sharded counterparts. The ranks import only the port: each asserts that
no ``jax`` and no ``factormodeling_tpu.`` module is loaded.

Worker entry: ``python -m factormodeling_tpu_torch.parallel._dist_check
<rank> <n_proc> <store_dir> <out_dir>``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_NPROC = 2

#: worker-log substrings that mean the installed torch cannot run the check
#: at all (no gloo backend), not that the code under test failed
UNSUPPORTED_MARKERS = (
    "Gloo is not available",
    "gloo backend is not available",
)

F, D, N, WINDOW = 8, 32, 16, 6
NAMES = ("a_eq", "a_flx", "b_long", "b_short",
         "c_eq", "c_flx", "d_long", "d_short")
#: the sharded step's configurations: (label, select_method, sim_kwargs)
STEP_CASES = (
    ("icir_top_equal", "icir_top", dict(method="equal", pct=0.3)),
    ("momentum_linear", "momentum", dict(method="linear", max_weight=0.3)),
    ("icir_top_mvo", "icir_top", dict(method="mvo", lookback_period=8,
                                      mvo_batch=8, qp_iters=60)),
    ("icir_top_mvo_turnover", "icir_top",
     dict(method="mvo_turnover", lookback_period=8, qp_iters=40)),
)
#: the asset step's backtests: (label, sim_kwargs); the first is the one
#: the placement rows, the chooser and the sharded server cases run
ASSET_SIMS = (
    ("equal", dict(method="equal", pct=0.3)),
    ("linear", dict(method="linear", max_weight=0.3)),
    ("mvo", dict(method="mvo", lookback_period=8, mvo_batch=4,
                 qp_iters=60, max_weight=0.5)),
    ("mvo_turnover", dict(method="mvo_turnover", lookback_period=8,
                          qp_iters=40, max_weight=0.5)),
    ("mvo_turnover_parallel", dict(method="mvo_turnover",
                                   turnover_mode="parallel",
                                   lookback_period=8, qp_iters=40,
                                   mvo_batch=4, max_weight=0.5)),
)
ASSET_SIM = ASSET_SIMS[0][1]
MODES = ("auto", "reshard", "gather")
#: the JAX package's mixed plan (``tests/test_asset_sharding.py``)
MIXED = {"metrics/rank_ic": "gather", "ops/rank": "gather",
         "backtest/weights": "reshard"}
PLANS = MODES + ("mixed",)

#: the online advance's cases: the JAX package's ladder
#: (``tests/test_asset_sharding.py``) on ``ONLINE_D`` dates of
#: ``ONLINE_N`` assets, and a risk-model turnover cell; ``F, T, R, LB, k``
#: all differ from ``N`` (the placement rule is the JAX package's there)
ONLINE_NAMES = ("a_eq", "a_flx", "b_long", "b_short")
ONLINE_D, ONLINE_N = 12, 16
ONLINE_LADDER = {
    "equal": dict(),
    "linear": dict(),
    "mvo": dict(sim_static=(("mvo_batch", 4), ("qp_iters", 40))),
    "mvo_turnover": dict(sim_static=(("qp_iters", 40),)),
}
ONLINE_RISK = dict(method="mvo_turnover", sim_static=(
    ("qp_iters", 40), ("covariance", "risk_model"), ("risk_factors", 3),
    ("risk_lookback", 8), ("risk_refit_every", 4)))
ONLINE_CELLS = tuple((m, mk) for m in ONLINE_LADDER
                     for mk in ("nan", "ragged")) + (("risk", "ragged"),)
#: a session's lanes (``advance_tenant.lanes``): knobs a lane, the lanes
#: split over the asset ranks under ``reshard`` (4 divides 2 and 4)
ONLINE_LANES = {"max_weight": (0.3, 0.4, 0.5, 0.6),
                "turnover_penalty": (0.05, 0.1, 0.2, 0.4)}
#: the cells whose held state shapes the ranks record: plain MVO's warm
#: ring, the turnover scan's warm state, the risk model
ONLINE_SHAPE_CELLS = (("mvo", "nan"), ("mvo_turnover", "ragged"),
                      ("risk", "ragged"))


class DistributedUnsupported(RuntimeError):
    """The installed torch cannot run multi-process collectives on the
    CPU: skip the check, don't fail it."""


def unsupported_reason(output: str) -> str | None:
    """The first worker-log line matching a known capability marker (None
    when the failure is a real one)."""
    for line in output.splitlines():
        if any(marker in line for marker in UNSUPPORTED_MARKERS):
            return line.strip()[-300:]
    return None


def market(seed: int = 7):
    """The seeded float64 inputs every rank builds alike."""
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(F, D, N))
    factors[rng.uniform(size=factors.shape) < 0.05] = np.nan
    returns = rng.normal(scale=0.02, size=(D, N))
    factor_ret = rng.normal(scale=0.01, size=(D, F))
    cap = rng.integers(1, 4, size=(D, N)).astype(float)
    invest = np.ones((D, N))
    universe = rng.uniform(size=(D, N)) > 0.05
    return factors, returns, factor_ret, cap, invest, universe


def online_market(ragged: bool, seed: int = 19):
    """The online cases' float64 market (the JAX package's
    ``tests/test_asset_sharding.py::_online_market``, seeded here):
    ``(factors [F, D, N], returns, factor_ret [D, F], cap, invest,
    universe)``."""
    rng = np.random.default_rng(seed + int(ragged))
    f, d, n = len(ONLINE_NAMES), ONLINE_D, ONLINE_N
    factors = rng.normal(size=(f, d, n))
    factors[rng.uniform(size=factors.shape) < 0.1] = np.nan
    returns = rng.normal(scale=0.02, size=(d, n))
    fr = rng.normal(scale=0.01, size=(d, f))
    cap = rng.integers(1, 4, size=(d, n)).astype(float)
    invest = np.ones((d, n))
    universe = np.ones((d, n), dtype=bool)
    if ragged:
        for j in range(0, n, 3):
            a = int(rng.integers(2, d - 4))
            universe[a:a + 2, j] = False
        returns = np.where(universe, returns, np.nan)
    return factors, returns, fr, cap, invest, universe


def online_config(method: str) -> dict:
    """The ``TenantConfig`` keywords of an online cell (``"risk"`` is the
    risk-model turnover cell)."""
    kw = ONLINE_RISK if method == "risk" else dict(method=method,
                                                    **ONLINE_LADDER[method])
    return dict(window=4, lookback_period=6, **kw)


#: the advance rows the cases compare: held to 1e-12 (expected bitwise),
#: equal, and the P&L scalars to 1e-12
ONLINE_ROWS = ("selection", "signal", "weights")
ONLINE_EXACT = ("long_count", "short_count", "solver_ok", "ready")
ONLINE_PNL = ("log_return", "turnover")


def _np(t):
    return t.detach().cpu().numpy()


def _out_arrays(out) -> dict:
    return {"selection": _np(out.selection), "signal": _np(out.signal),
            "log_return": _np(out.sim.result.log_return),
            "weights": _np(out.sim.weights),
            "sharpe": float(out.summary.sharpe)}


def _held(got: dict, want: dict, label: str, tol: float | None = None
          ) -> float:
    """Largest gap of ``got`` from ``want`` (NaN where both are NaN); raises
    past 1e-10 (Sharpe and weights 1e-8 unless ``tol`` is given)."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        bound = tol if tol is not None else (
            1e-8 if k in ("sharpe", "weights") else 1e-10)
        gap = float(np.nanmax(np.abs(np.asarray(g) - np.asarray(w)),
                              initial=0.0))
        if (np.isnan(g) != np.isnan(w)).any() or not gap <= bound:
            raise AssertionError(f"{label} {k}: gap {gap} (tol {bound})")
        worst = max(worst, gap)
    return worst


def _ops(ledger) -> list:
    return [op._asdict() for op in ledger.ops]


def _step_leg(raw, res: dict) -> None:
    import torch

    from factormodeling_tpu_torch.obs import comms
    from factormodeling_tpu_torch.parallel import (
        build_research_step, make_hybrid_mesh, make_sharded_research_step)

    full = [torch.as_tensor(a) for a in raw]
    mesh = make_hybrid_mesh(("factor", "date"), device="cpu")
    res["mesh_shape"] = tuple(mesh.shape)
    for label, select, sim in STEP_CASES:
        cfg = dict(names=NAMES, window=WINDOW, select_method=select,
                   sim_kwargs=sim)
        step, shard = make_sharded_research_step(mesh, **cfg)
        with comms.recording(mesh) as ledger:
            out = _out_arrays(step(*shard(*raw)))
        local = _out_arrays(build_research_step(**cfg, device="cpu")(*full))
        res[f"step/{label}"] = out
        res[f"step/{label}/err"] = _held(out, local, label)
        res[f"step/{label}/ledger"] = _ops(ledger)
    # faults, a policy, counters and probes read the whole stack: the step
    # gathers it, then scores and blends its blocks as before
    from factormodeling_tpu_torch import obs, resil

    cfg = dict(names=NAMES, window=WINDOW, sim_kwargs=ASSET_SIM,
               collect_counters=True, collect_probes=True,
               fault_spec=resil.FaultSpec.make(seed=1, nan_rate=0.01,
                                               drop_rate=0.05),
               policy=resil.DegradePolicy.make(min_universe=5,
                                               carry_fallback=True))
    step, shard = make_sharded_research_step(mesh, **cfg)
    got = step(*shard(*raw))
    local = build_research_step(**cfg, device="cpu")(*full)
    res["step/faulted/err"] = _held(_out_arrays(got), _out_arrays(local),
                                    "faulted")
    res["step/faulted/counters"] = (obs.summarize_counters(got.counters),
                                    obs.summarize_counters(local.counters))
    res["step/faulted/probes"] = sorted(got.probes)


def _asset_leg(raw, res: dict) -> None:
    import torch

    from factormodeling_tpu_torch.obs import RunReport, comms
    from factormodeling_tpu_torch.parallel import (
        AssetSpecPlan, build_research_step, make_asset_mesh, make_hybrid_mesh,
        make_asset_sharded_research_step)

    meshes = (("date_assets", make_hybrid_mesh(("date", "assets"),
                                               device="cpu")),
              ("assets", make_asset_mesh(device="cpu")))
    for sim_label, sim in ASSET_SIMS:
        cfg = dict(names=NAMES, window=WINDOW, sim_kwargs=sim)
        local = _out_arrays(build_research_step(**cfg, device="cpu")(
            *[torch.as_tensor(a) for a in raw]))
        res[f"asset/{sim_label}/local"] = local
        for label, mesh in meshes:
            res[f"asset/{label}/mesh_shape"] = tuple(mesh.shape)
            for mode in PLANS:
                plan = (AssetSpecPlan(mesh, modes=MIXED) if mode == "mixed"
                        else AssetSpecPlan(mesh, default=mode))
                step, shard = make_asset_sharded_research_step(
                    mesh, **cfg, plan=plan)
                # the step's first call "compiles" (obs.compile_log): under
                # a RunReport(comms=True) it lands its placement rows from
                # the same call
                rep = RunReport("placement", comms=True)
                with rep.activate(), comms.recording(mesh) as ledger:
                    got = step(*shard(*raw))
                out = _out_arrays(step.gather_outputs(got))
                key = (f"asset/{label}/{mode}" if sim_label == "equal"
                       else f"asset/{label}/{sim_label}/{mode}")
                res[key] = out
                if sim_label == "equal":
                    res[f"{key}/placement"] = rep.rows
                res[f"{key}/err"] = _held(out, local, f"{key}", tol=1e-10)
                res[f"{key}/ledger"] = _ops(ledger)


def _online_rows(outs) -> dict:
    """An advance's outputs over the dates as ``{field: [D, ...]}``."""
    return {k: np.stack([np.asarray(_np(getattr(o, k)) if not isinstance(
        getattr(o, k), bool) else getattr(o, k)) for o in outs])
        for k in ONLINE_ROWS + ONLINE_EXACT + ONLINE_PNL}


def _online_gap(got: dict, want: dict) -> dict:
    """Per field: the largest gap (NaN where both are NaN; inf where one
    is), whether the rows are bitwise equal."""
    out = {}
    for k, w in want.items():
        g = got[k]
        g64, w64 = np.asarray(g, dtype=float), np.asarray(w, dtype=float)
        nan = np.isnan(g64) | np.isnan(w64)
        gap = float(np.max(np.abs(np.where(nan, 0.0, g64 - w64)),
                           initial=0.0))
        if (np.isnan(g64) != np.isnan(w64)).any():
            gap = float("inf")
        out[k] = {"gap": gap, "bitwise": bool(np.array_equal(
            np.nan_to_num(g64, nan=7.0), np.nan_to_num(w64, nan=7.0)))}
    return out


def _shapes(state) -> dict:
    """``{path: shape}`` of an online state's tensor leaves."""
    from factormodeling_tpu_torch.online.state import _map_leaves

    out = {}

    def note(path, leaf, assets, lanes):
        out[path] = tuple(leaf.shape)
        return leaf

    _map_leaves(state, note)
    return out


def _online_leg(res: dict) -> None:
    """The asset-sharded online advance against the unsharded one (module
    docs): per cell and layout mode the rows' gaps, the ledger, and for
    :data:`ONLINE_SHAPE_CELLS` the held shapes and placements."""
    from factormodeling_tpu_torch.obs import comms
    from factormodeling_tpu_torch.online import DateSlice, make_online_step
    from factormodeling_tpu_torch.online.state import (online_leaf_dims,
                                                       stack_tenant_states)
    from factormodeling_tpu_torch.parallel import (AssetSpecPlan,
                                                   make_asset_mesh)
    from factormodeling_tpu_torch.serve import TenantConfig

    mesh = make_asset_mesh(device="cpu")
    res["online/mesh_shape"] = tuple(mesh.shape)
    f, n = len(ONLINE_NAMES), ONLINE_N
    _online_lanes(mesh, res)
    for method, mk in ONLINE_CELLS:
        raw = online_market(mk == "ragged")
        tmpl = TenantConfig(**online_config(method)).normalized(f, 2)
        slices = [DateSlice(raw[0][:, t], raw[1][t], raw[2][t], raw[3][t],
                            raw[4][t], raw[5][t]) for t in range(ONLINE_D)]
        cell = f"online/{method}/{mk}"

        def run(**kw):
            init, adv = make_online_step(
                names=ONLINE_NAMES, template=tmpl, n_assets=n,
                has_universe=True, stats_tail=8, device="cpu", **kw)
            mstate, tstate = init()
            outs, ops, sharded = [], [], "mesh" in kw
            for ds in slices:
                if sharded:
                    ds = adv.shard_date_slice(ds)
                # the advance's collectives (the outputs' gathers are the
                # caller's)
                with comms.recording(mesh) as ledger:
                    (mstate, tstate), out = adv(tmpl, mstate, tstate, ds)
                ops += ledger.ops
                outs.append(adv.gather_outputs(out) if sharded else out)
            return _online_rows(outs), ops, (mstate, tstate, adv)

        plain, ops, _ = run()
        res[f"{cell}/plain"] = plain
        res[f"{cell}/plain/ledger"] = [op._asdict() for op in ops]
        for mode in MODES:
            got, ops, (mstate, tstate, adv) = run(
                mesh=mesh, plan=AssetSpecPlan(mesh, default=mode))
            res[f"{cell}/{mode}"] = got
            res[f"{cell}/{mode}/gap"] = _online_gap(got, plain)
            res[f"{cell}/{mode}/ledger"] = [op._asdict() for op in ops]
            if mode == "auto" and (method, mk) in ONLINE_SHAPE_CELLS:
                stacked = stack_tenant_states([tstate, tstate])
                res[f"{cell}/held"] = {
                    "market": _shapes(mstate), "tenant": _shapes(stacked),
                    "slice": _shapes(adv.shard_date_slice(slices[0])),
                    "market_dims": online_leaf_dims(mstate, "assets",
                                                    "configs"),
                    "tenant_dims": online_leaf_dims(stacked, "assets",
                                                    "configs"),
                    "slice_dims": online_leaf_dims(slices[0], "assets")}


def _online_lanes(mesh, res: dict) -> None:
    """A session of :data:`ONLINE_LANES` lanes (plain MVO's warm ring and
    the turnover scan) on the ragged market, sharded in every mode against
    the unsharded lanes."""
    from factormodeling_tpu_torch.online import (DateSlice,
                                                 online_step_parts)
    from factormodeling_tpu_torch.online.advance import (
        gather_advance_outputs)
    from factormodeling_tpu_torch.online.state import (shard_date_slice,
                                                       stack_tenant_states)
    from factormodeling_tpu_torch.parallel import AssetSpecPlan
    from factormodeling_tpu_torch.serve import TenantConfig, stack_configs

    f = len(ONLINE_NAMES)
    raw = online_market(True)
    slices = [DateSlice(raw[0][:, t], raw[1][t], raw[2][t], raw[3][t],
                        raw[4][t], raw[5][t]) for t in range(ONLINE_D)]
    for method in ("mvo", "mvo_turnover"):
        kw = online_config(method)
        lanes = stack_configs([
            TenantConfig(**kw, max_weight=mw,
                         turnover_penalty=tp).normalized(f, 2)
            for mw, tp in zip(*ONLINE_LANES.values())])
        tmpl = TenantConfig(**kw).normalized(f, 2)

        def run(**kw):
            im, it, am, at = online_step_parts(
                names=ONLINE_NAMES, template=tmpl, n_assets=ONLINE_N,
                has_universe=True, stats_tail=8, device="cpu", **kw)
            mstate = im()
            tstates = stack_tenant_states(
                [it() for _ in ONLINE_LANES["max_weight"]])
            outs = []
            for ds in slices:
                if kw:
                    ds = shard_date_slice(ds, mesh)
                mstate, octx = am(mstate, ds)
                tstates, out = at.lanes(lanes, tstates, octx)
                outs.append(gather_advance_outputs(out, mesh) if kw
                            else out)
            return _online_rows(outs)

        plain = run()
        for mode in MODES:
            got = run(mesh=mesh, plan=AssetSpecPlan(mesh, default=mode))
            res[f"online/lanes/{method}/{mode}/gap"] = _online_gap(got,
                                                                   plain)


def _rest(raw, res: dict, tmp: str) -> None:
    import torch

    import factormodeling_tpu_torch as fmt
    from factormodeling_tpu_torch import io as tio
    from factormodeling_tpu_torch.online import DateSlice
    from factormodeling_tpu_torch.parallel import (
        choose_asset_specs, chunk_sharding, combo_weight_matrix,
        host_array_source, make_hybrid_mesh, make_mesh,
        make_asset_sharded_research_step, make_sharded_manager_sweep,
        make_sharded_research_step, manager_sweep, streamed_factor_stats,
        streamed_linear_research, streamed_weighted_composite)
    from factormodeling_tpu_torch.serve import TenantConfig, TenantServer

    factors, returns, factor_ret, cap, invest, universe = raw
    cfg = dict(names=NAMES, window=WINDOW, sim_kwargs=ASSET_SIM)

    # an all_reduce over each axis of the (factor, date) mesh
    from factormodeling_tpu_torch.parallel.mesh import all_reduce

    fmesh = make_hybrid_mesh(("factor", "date"), device="cpu")
    mine = torch.tensor([float(torch.distributed.get_rank() + 1)])
    res["all_reduce"] = {a: [float(all_reduce(mine, fmesh, a, op=o))
                             for o in ("sum", "max", "min")]
                         for a in ("factor", "date")}

    # the chooser on the 2-D asset mesh: shapes only
    amesh = make_hybrid_mesh(("date", "assets"), device="cpu")
    plan, ranking = choose_asset_specs(amesh, shapes=(F, D, N), **cfg)
    res["chooser/plan"] = plan.spec_table()
    res["chooser/ranking"] = ranking
    step, shard = make_asset_sharded_research_step(amesh, **cfg, plan=plan)
    res["chooser/run"] = _out_arrays(step.gather_outputs(step(*shard(*raw))))
    # the turnover scan's and the parallel scheme's backtest stages, whose
    # modes move other bytes
    for label, sim in ASSET_SIMS[3:]:
        _, res[f"chooser/ranking/{label}"] = choose_asset_specs(
            amesh, shapes=(F, D, N), names=NAMES, window=WINDOW,
            sim_kwargs=sim)

    # the sharded sweep
    cmesh = make_mesh(("combo",), device="cpu")
    rng = np.random.default_rng(4)
    combos = np.stack([rng.choice(F, 3, replace=False) for _ in range(8)])
    cw = combo_weight_matrix(combos, F, device="cpu")
    settings = fmt.SimulationSettings(
        returns=torch.as_tensor(returns), cap_flag=torch.as_tensor(cap),
        investability_flag=torch.as_tensor(invest),
        universe=torch.as_tensor(universe), method="equal", pct=0.3)
    fac = torch.as_tensor(factors)
    sharded = make_sharded_manager_sweep(cmesh, combo_batch=2)(fac, cw,
                                                               settings)
    plain = manager_sweep(fac, cw, settings, combo_batch=2, device="cpu")
    res["sweep"] = {k: _np(v) for k, v in sharded._asdict().items()}
    res["sweep/plain"] = {k: _np(v) for k, v in plain._asdict().items()}

    # date-sharded streaming: whole chunks, block chunks, a disk source
    dmesh = make_mesh(("date",), device="cpu")
    ret_t, uni_t = torch.as_tensor(returns), torch.as_tensor(universe)
    src, sl = host_array_source(factors, 3)
    bsrc, _ = host_array_source(factors, 3, sharding=chunk_sharding(dmesh))
    tio.save_factor_stack_chunks(os.path.join(tmp, "chunks"),
                                 [factors[s] for s in sl],
                                 factor_names=list(NAMES))
    dsrc, dsl, _ = tio.disk_chunk_source(os.path.join(tmp, "chunks"),
                                         sharding=chunk_sharding(dmesh))
    kw = dict(shift_periods=2, universe=uni_t)
    serial = streamed_factor_stats(src, len(sl), ret_t, device="cpu", **kw)
    res["stream/serial"] = {k: _np(v) for k, v in serial.items()}
    for label, source in (("whole", src), ("block", bsrc), ("disk", dsrc)):
        got = streamed_factor_stats(source, len(sl), ret_t, mesh=dmesh, **kw)
        res[f"stream/{label}"] = {k: _np(v) for k, v in got.items()}
    # the disk chunks are float32: their own unsharded run
    plain_disk, _, _ = tio.disk_chunk_source(os.path.join(tmp, "chunks"))
    res["stream/disk/plain"] = {k: _np(v) for k, v in streamed_factor_stats(
        plain_disk, len(sl), ret_t, device="cpu", **kw).items()}

    def momentum(stats):
        fr = torch.nan_to_num(stats["factor_return"])
        return torch.clamp(torch.cumsum(fr, dim=1), 0.0, 1.0)

    lin_kw = dict(chunk_weight_fn=momentum, universe=uni_t, shift_periods=2)
    res["stream/linear"] = {k: _np(v) for k, v in streamed_linear_research(
        bsrc, len(sl), ret_t, mesh=dmesh, **lin_kw).items()}
    res["stream/linear/plain"] = {k: _np(v) for k, v in
                                  streamed_linear_research(
                                      src, len(sl), ret_t, device="cpu",
                                      **lin_kw).items()}
    w = [np.full((s.stop - s.start, D), 0.5) for s in sl]
    res["stream/composite"] = _np(streamed_weighted_composite(
        bsrc, w, universe=uni_t, mesh=dmesh))
    res["stream/composite/plain"] = _np(streamed_weighted_composite(
        src, w, universe=uni_t, device="cpu"))

    # the sharded server: a rung-8 dispatch of 5 tenants, then 6 dates of
    # advance_all, against the unsharded server
    from factormodeling_tpu_torch.parallel import make_asset_mesh

    smesh = make_mesh(("configs", "assets"), device="cpu")
    panels = dict(factors=factors, returns=returns, factor_ret=factor_ret,
                  cap_flag=cap, investability=invest, universe=universe)
    turnover = dict(method="mvo_turnover", lookback_period=6,
                    max_weight=0.5, sim_static=(("qp_iters", 30),))
    configs = [TenantConfig(window=WINDOW, icir_threshold=-1.0, top_k=k,
                            pct=0.2 + 0.05 * k) for k in (1, 2, 3, 4)]
    configs.append(TenantConfig(window=WINDOW, icir_threshold=-1.0,
                                top_k=2, **turnover))
    servers = {"mesh": TenantServer(names=NAMES, pad_ladder=(1, 4, 8),
                                    mesh=smesh, **panels),
               "assets": TenantServer(names=NAMES, pad_ladder=(1, 4, 8),
                                      mesh=make_asset_mesh(device="cpu"),
                                      **panels),
               "plain": TenantServer(names=NAMES, pad_ladder=(1, 4, 8),
                                     device="cpu", **panels)}
    for label, server in servers.items():
        # a dispatch runs on the stored blocks: count whole-panel gathers
        calls = []
        whole = server._market_panels
        server._market_panels = lambda: calls.append(1) or whole()
        served = server.serve(configs)
        res[f"serve/{label}/market_panels_calls"] = len(calls)
        server._market_panels = whole
        res[f"serve/{label}/fingerprint"] = server.panels_fingerprint()
        res[f"serve/{label}"] = [_out_arrays(r.output) for r in served]
        res[f"serve/{label}/stats"] = server.serving_stats()["mesh_shape"]
        server.online_begin(configs)
        rows = []
        for t in range(6):
            adv = server.advance_all(DateSlice(
                factors[:, t], returns[t], factor_ret[t], cap[t], invest[t],
                universe[t]))
            rows.append([(bool(a.output.ready), _np(a.output.weights),
                          _np(a.output.signal), float(a.output.log_return),
                          float(a.output.turnover)) for a in adv])
        res[f"advance/{label}"] = rows
        res[f"advance/{label}/held"] = [
            (_shapes(sess["mstate"]), _shapes(sess["tstates"]))
            for sess in server._online.values()]

    # divisibility errors
    errors = {}
    bad = make_mesh(("factor", "date"), device="cpu")
    for label, call in (
            ("factors", lambda: make_sharded_research_step(
                bad, names=NAMES[:7], window=WINDOW)),
            ("dates", lambda: make_sharded_research_step(
                bad, names=NAMES, window=WINDOW)[1](
                    factors[:, :D - 1], returns[:D - 1], factor_ret[:D - 1],
                    cap[:D - 1], invest[:D - 1], universe[:D - 1])),
            ("assets", lambda: make_asset_sharded_research_step(
                make_mesh(("assets",), device="cpu"), **cfg)[1](
                    factors[..., :N - 1], returns[:, :N - 1], factor_ret,
                    cap[:, :N - 1], invest[:, :N - 1],
                    universe[:, :N - 1])),
            ("combos", lambda: make_sharded_manager_sweep(cmesh)(
                fac, cw[:7], settings))):
        try:
            call()
            errors[label] = None
        except ValueError as e:
            errors[label] = str(e)
    res["errors"] = errors


def worker(rank: int, n_proc: int, store_dir: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from factormodeling_tpu_torch.parallel import (initialize_cluster,
                                                   num_slices)

    torch.set_num_threads(1)
    if not dist.is_gloo_available():
        print("Gloo is not available in this torch build", flush=True)
        raise SystemExit(3)
    initialize_cluster(f"file://{os.path.join(store_dir, 'store')}", n_proc,
                       rank, backend="gloo")
    try:
        raw = market()
        res: dict = {"rank": rank, "world": n_proc, "slices": num_slices()}
        _step_leg(raw, res)
        print(f"DIST_OK {rank}", flush=True)
        _asset_leg(raw, res)
        print(f"DIST_ASSET_OK {rank}", flush=True)
        _online_leg(res)
        print(f"DIST_ONLINE_OK {rank}", flush=True)
        _rest(raw, res, tempfile.mkdtemp(dir=out_dir))
        res["modules"] = sorted(m for m in sys.modules
                                if m in ("jax", "factormodeling_tpu")
                                or m.startswith("jax.")
                                or m.startswith("factormodeling_tpu."))
        assert not res["modules"], res["modules"]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(timeout: float = 300.0, n_proc: int = _NPROC,
           out_dir: str | None = None) -> str:
    """Spawn ``n_proc`` worker processes and raise unless every one
    prints ``DIST_OK``, ``DIST_ASSET_OK`` and ``DIST_ONLINE_OK``; returns the directory the
    ranks wrote their results to (``out_dir``, or a fresh temporary
    one)."""
    out_dir = out_dir or tempfile.mkdtemp()
    store_dir = tempfile.mkdtemp(dir=out_dir)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               LOCAL_WORLD_SIZE=str(max(n_proc // 2, 1)))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    # output to files, not pipes: a rank dumping a long traceback would
    # fill a pipe and block until the timeout
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+")
            for r in range(n_proc)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "factormodeling_tpu_torch.parallel._dist_check",
         str(rank), str(n_proc), store_dir, out_dir],
        stdout=logs[rank], stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(n_proc)]
    deadline = time.monotonic() + timeout
    timed_out = False
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(
                p.returncode not in (None, 0) for p in procs):
            timed_out = time.monotonic() > deadline
            break
        time.sleep(0.2)
    outs = []
    for p, log in zip(procs, logs):
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
        log.flush()
        log.seek(0)
        outs.append(log.read())
        log.close()
    failed = [(r, p, out) for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0 or f"DIST_OK {r}" not in out
              or f"DIST_ASSET_OK {r}" not in out
              or f"DIST_ONLINE_OK {r}" not in out]
    if failed:
        for r, out in enumerate(outs):
            reason = unsupported_reason(out)
            if reason is not None:
                raise DistributedUnsupported(
                    f"distributed worker {r}: {reason}")
        # the rank that crashed on its own, not a killed survivor
        failed.sort(key=lambda t: (t[1].returncode is None
                                   or t[1].returncode < 0))
        rank, p, out = failed[0]
        raise RuntimeError(
            f"distributed worker {rank} failed (rc={p.returncode}, "
            f"timeout={timed_out}):\n" + out[-4000:])
    return out_dir


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
