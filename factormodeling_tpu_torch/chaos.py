"""The chaos matrix: fault classes x degradation policies over the port's
research step, serving queue, online engine and scenario engine.

The executable proof of the port's resilience layer, cell for cell the
JAX package's ``tools/chaos.py`` (its presets, flags, verdict JSON and
exit codes), run on the card by default:

- the **research matrix**: for every (fault class, policy) cell, the
  research step with the fault injected (``resil.faults``) under the
  policy (``resil.policy``), held to the production invariants — finite
  total log-return, no Inf weight, ``|weight| <= 1 + tol``, leg sums +1 /
  -1 and dollar neutrality on active days, daily turnover at most
  ``4 + tol`` — and the numerics watchdog, judged against the clean
  baseline's probe profile, naming exactly the stage the fault manifests
  at (``EXPECT_STAGE``). Every cell runs through one step, built once with
  counters and probes on; the cell's ``FaultSpec`` and ``DegradePolicy``
  are call arguments and the baseline is the zero-rate spec through the
  same step. Rows land as ``kind="degrade"`` report rows with the cell's
  counters;
- ``--serving``: dispatch-fault plan x admission policy over a loaded
  request queue on the virtual clock (constant service model): every
  request ends in exactly one verdict, clean cells fail none, the open
  policy sheds none, bounded policies shed or degrade, served books hold
  the invariants; the flight recorder's span trees and metering, the
  lineage ledger and the sentry's detection contract both ways;
- ``--online``: feed anomaly x engine guard over ``online.OnlineEngine``:
  every ingested date ends in exactly one of APPLIED | REPLAYED |
  REJECTED with the expected verdict and reason (``ONLINE_EXPECT``),
  restatements replay, a kill-after-apply stream resumes byte-equal (the
  cell records the final state's digest and content chain), tick traces
  complete, a metered two-tenant ``advance_all`` conserves, the lineage
  chain resolves and the sentry attributes (``ONLINE_SENTRY``);
- ``--scenarios``: scenario family x degrade policy, each cell a
  ``scenarios.run_scenarios`` sweep with finite VaR/ES/drawdown rows and
  the invariants on every path's book.

With ``--checkpoint`` each preset snapshots after every cell
(``resil.checkpoint``) and a rerun resumes byte-equal; a damaged snapshot
is rejected with exit 2. The ``_FMT_CHAOS_DIE_AFTER_CELL`` environment
hook exits 137 right after a cell's snapshot (``serve/queue.py``'s
``_FMT_SERVE_DIE_AFTER_DISPATCH`` and the online engine's
``_FMT_ONLINE_DIE_AFTER_DATE`` kill one level down).

Usage::

    python -m factormodeling_tpu_torch.chaos [--shape F,D,N] [--window 8]
        [--method mvo_turnover] [--faults all|csv] [--policies all|csv]
        [--rate 0.05] [--day-rate 0.2] [--seed 0] [--tol 0.05]
        [--report chaos_report.jsonl] [--checkpoint chaos.ckpt] [--json]
        [--serving] [--requests 24] [--load 1.5]
        [--scenarios] [--paths 6] [--online] [--device cuda|cpu]

``--device`` defaults to the card and raises without one; the CPU runs
only when asked for (``--device cpu``). Exit codes: 0 = every cell held
every invariant; 1 = at least one violation (each printed with its cell);
2 = bad usage or a corrupt checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import zlib

import numpy as np
import torch

from factormodeling_tpu_torch._device import host_array, resolve_device

__all__ = ["EXPECT_STAGE", "ONLINE_ANOMALIES", "ONLINE_EXPECT",
           "ONLINE_POLICIES", "ONLINE_SENTRY", "SCENARIO_FAMILIES",
           "SERVING_FAULTS", "SERVING_POLICIES", "SERVING_SENTRY", "CellLoop",
           "build_policies", "check_invariants", "main", "make_inputs",
           "matrix_step", "run_chaos", "run_online_chaos",
           "run_scenario_chaos", "run_serving_chaos"]

#: where the watchdog must attribute each fault class: value faults at
#: their injected boundary, staleness at the ``ops/factors_delta`` canary,
#: universe collapse at ``composite/blend`` where membership becomes NaN
EXPECT_STAGE = {
    "nan_burst": "ops/factors_raw",
    "inf_spike": "ops/factors_raw",
    "outlier": "ops/factors_raw",
    "stale_repeat": "ops/factors_delta",
    "drop_day": "ops/factors_raw",
    "universe_collapse": "composite/blend",
}

_DAY_CLASSES = ("stale_repeat", "drop_day", "universe_collapse")

#: test hook: die without cleanup right after checkpointing this 0-based
#: cell index (the mid-run kill of the resume differential)
_DIE_ENV = "_FMT_CHAOS_DIE_AFTER_CELL"

_PANEL_KEYS = ("factors", "returns", "factor_ret", "cap_flag",
               "investability", "universe")


class CellLoop:
    """The cell loop every preset shares: report-row marking, checkpointed
    done-cell resume with snapshot row replacement, per-cell save, and the
    kill hook.

    - rows recorded from ``mark`` on belong to this loop: a save
      serializes ``rep.rows[mark:]`` and a resume replaces that slice with
      the snapshot's, so a resumed report continues the killed run's rows
      (one baseline block) while rows a caller recorded before stay;
    - cell verdicts snapshot as sorted-key JSON strings, so identical runs
      give byte-equal snapshots;
    - ``die_env``: after the save of cell index ``int(os.environ[die_env])``
      the process exits 137 without cleanup.
    """

    def __init__(self, rep, *, label, n_cells, mark, ck_meta=None,
                 checkpoint_path=None, checkpoint_every=1, progress=print,
                 die_env=None):
        self.rep = rep
        self.label = label
        self.mark = mark
        self.ck_meta = ck_meta
        self.progress = progress
        self.die_env = die_env
        self.done: dict = {}
        self.ck = None
        if checkpoint_path is not None:
            from factormodeling_tpu_torch import resil

            self.ck = resil.Checkpointer(checkpoint_path,
                                         every=checkpoint_every)
            got = self.ck.resume(expect_meta=ck_meta)
            if got is not None:
                state, _ = got
                self.done = {k: json.loads(v)
                             for k, v in state["done"].items()}
                rep.rows[mark:] = [json.loads(row)
                                   for row in state.get("report_rows", [])]
                progress(f"{label}: resumed {len(self.done)}/{n_cells} "
                         f"cells from {checkpoint_path}")

    def skip(self, cell: str) -> bool:
        """True when the cell's verdict was resumed from the snapshot."""
        return cell in self.done

    def complete(self, idx: int, cell: str, result: dict) -> None:
        """Record one finished cell: the verdict kept, the snapshot saved on
        the checkpoint grid, then the kill hook (the snapshot a resumed run
        continues from includes this cell)."""
        self.done[cell] = result
        if self.ck is None:
            return
        self.ck.maybe_save(
            idx, {"done": {k: json.dumps(v, sort_keys=True)
                           for k, v in self.done.items()},
                  "report_rows": [json.dumps(r, sort_keys=True, default=str)
                                  for r in self.rep.rows[self.mark:]]},
            meta=self.ck_meta)
        if self.die_env is not None:
            die_after = os.environ.get(self.die_env)
            if die_after is not None and idx == int(die_after):
                self.progress(f"{self.label}: dying after cell {idx} "
                              f"({self.die_env} test hook)")
                os._exit(137)

    def verdict(self, cells) -> dict:
        """The preset's JSON-ready verdict over every done cell."""
        failures = {k: v for k, v in self.done.items() if not v["ok"]}
        return {"ok": not failures, "cells": len(cells),
                "failed": sorted(failures),
                "results": {k: self.done[k] for k in sorted(self.done)}}


def make_inputs(f: int, d: int, n: int, seed: int = 0):
    """The synthetic panel of the JAX package's matrix, drawn with numpy in
    its order: ``(names, (factors, returns, factor_ret, cap, invest,
    universe))``, float32 numpy arrays (universe bool, all in)."""
    rng = np.random.default_rng(seed)
    suffixes = ("_eq", "_flx", "_long", "_short")
    names = tuple(f"fac{i}{suffixes[i % 4]}" for i in range(f))
    factors = rng.normal(size=(f, d, n)).astype(np.float32)
    returns = rng.normal(scale=0.02, size=(d, n)).astype(np.float32)
    factor_ret = rng.normal(scale=0.01, size=(d, f)).astype(np.float32)
    cap = rng.integers(1, 4, size=(d, n)).astype(np.float32)
    invest = np.ones((d, n), np.float32)
    universe = np.ones((d, n), bool)
    return names, (factors, returns, factor_ret, cap, invest, universe)


def _market(shape, seed, market):
    """``(names, numpy arrays, (F, D, N))``: ``market`` (a ``(names,
    arrays)`` pair in :func:`make_inputs`' form) when given, else the
    synthetic panel at ``shape``."""
    names, arrays = (market if market is not None
                     else make_inputs(*shape, seed=seed))
    return tuple(names), tuple(arrays), tuple(arrays[0].shape)


def _check_known(kind: str, got, valid) -> list:
    got = list(got or valid)
    unknown = set(got) - set(valid)
    if unknown:
        raise ValueError(f"unknown {kind} {sorted(unknown)}; valid: "
                         f"{tuple(valid)}")
    return got


def build_policies(resil, clean_blend_absmax: float) -> dict:
    """The named policy presets of the matrix. ``clamp``'s threshold is
    keyed to the clean run's ``composite/blend`` probe absmax (x8: generous
    for healthy dispersion, decisive against 10^9 outliers)."""
    clamp_at = 8.0 * max(clean_blend_absmax, 1e-6)
    return {
        "default": resil.DegradePolicy.make(),
        "guard": resil.DegradePolicy.make(min_universe=4,
                                          carry_fallback=True,
                                          quarantine_nan_frac=0.3),
        "clamp": resil.DegradePolicy.make(clamp_absmax=clamp_at),
        "full": resil.DegradePolicy.make(min_universe=4,
                                         carry_fallback=True,
                                         quarantine_nan_frac=0.3,
                                         clamp_absmax=clamp_at),
    }


def check_invariants(out, *, tol: float) -> list[str]:
    """Violated-invariant messages for one cell's ``ResearchOutput`` (empty:
    the cell holds)."""
    bad: list[str] = []
    diag = out.sim.diagnostics
    active = host_array(diag.active).astype(bool)
    if not np.isfinite(float(host_array(out.summary.total_log_return))):
        bad.append("total_log_return is not finite")
    # NaN weight cells are legitimate (pre-trade days, out-of-universe);
    # Inf never is, and the magnitude bound judges the traded (NaN->0) book
    w = host_array(out.sim.weights)
    if np.isinf(w).any():
        bad.append("traded weights contain Inf")
    traded = np.nan_to_num(w)
    if np.max(np.abs(traded)) > 1.0 + tol:
        bad.append(f"|weight| {np.max(np.abs(traded)):.3g} > 1 + {tol}")
    long_sum = host_array(diag.long_sum)[active]
    short_sum = host_array(diag.short_sum)[active]
    if long_sum.size:
        # a NaN leg sum passes every > tol comparison (NaN compares
        # False), so a non-finite leg on an active day is judged first
        if not (np.isfinite(long_sum).all() and np.isfinite(short_sum).all()):
            bad.append("leg sums are not finite on an active day")
        else:
            if np.max(np.abs(long_sum - 1.0)) > tol:
                bad.append(f"long leg sum off by "
                           f"{np.max(np.abs(long_sum - 1.0)):.3g} > {tol}")
            if np.max(np.abs(short_sum + 1.0)) > tol:
                bad.append(f"short leg sum off by "
                           f"{np.max(np.abs(short_sum + 1.0)):.3g} > {tol}")
            if np.max(np.abs(long_sum + short_sum)) > 2 * tol:
                bad.append("dollar neutrality violated on an active day")
    turnover = np.nan_to_num(host_array(out.sim.result.turnover))
    if np.max(turnover, initial=0.0) > 4.0 + tol:
        bad.append(f"daily turnover {np.max(turnover):.3g} > 4 + {tol}")
    return bad


def matrix_step(*, names, window: int, method: str, n_dates: int,
                sim_kwargs=None, device=None):
    """The research matrix's step, built once with counters and probes on:
    every cell calls it with its ``fault_spec`` and ``policy``."""
    from factormodeling_tpu_torch.parallel import build_research_step

    return build_research_step(
        names=names, window=window,
        sim_kwargs=dict(method=method, lookback_period=min(8, n_dates),
                        max_weight=0.4, **(sim_kwargs or {})),
        collect_counters=True, collect_probes=True, device=device)


def run_chaos(*, shape=(6, 48, 16), window: int = 8,
              method: str = "mvo_turnover", faults=None, policies=None,
              rate: float = 0.05, day_rate: float = 0.2, seed: int = 0,
              tol: float = 0.05, report=None, checkpoint_path=None,
              checkpoint_every: int = 1, progress=print, device=None,
              market=None, sim_kwargs=None, on_cell=None) -> dict:
    """Run the research matrix; returns a JSON-ready verdict (see
    :func:`main`). ``device``: None is the card (raises without one).
    ``market``: a ``(names, arrays)`` pair that replaces the synthetic panel
    (its shape is the matrix's); ``sim_kwargs``: extra backtest options
    (``solver_kernel``, ...); ``on_cell(cell, out, spec, policy)``: called
    with each computed cell's output."""
    from factormodeling_tpu_torch import obs, resil
    from factormodeling_tpu_torch.obs import probes as obs_probes

    dev = resolve_device(device)
    names, arrays, shape = _market(shape, seed, market)
    f, d, n = shape
    args = tuple(torch.as_tensor(a).to(dev) for a in arrays)
    faults = _check_known("fault classes", faults, resil.FAULT_CLASSES)
    step = matrix_step(names=names, window=window, method=method, n_dates=d,
                       sim_kwargs=sim_kwargs, device=dev)

    rep = report if report is not None else obs.RunReport("chaos")
    with rep.activate():
        # rows recorded by this call start here: saves and resume
        # replacement slice from the mark, so a caller's rows stay
        mark = len(rep.rows)
        # clean baseline: the zero-rate spec through the same step
        with rep.span("chaos/baseline") as sp:
            clean = sp.add(step(*args, fault_spec=resil.FaultSpec.off(),
                                policy=resil.DegradePolicy.make()))
        profile = obs_probes.probe_profile(
            clean.probes, absmax_stages=("ops/factors_raw",
                                         "selection/rolling",
                                         "composite/blend"),
            nonzero_stages=("ops/factors_delta",))
        blend_absmax = float(profile["composite/blend"]["absmax"])
        all_policies = build_policies(resil, blend_absmax)
        policies = _check_known("policies", policies, all_policies)

        cells = [(fk, pk) for fk in faults for pk in policies]
        ck_meta = {"entry": "chaos",
                   "config": [list(shape), window, method, faults, policies,
                              float(rate), float(day_rate), int(seed),
                              # snapshotted verdicts were judged under tol:
                              # a stricter run must not resume them
                              float(tol)]}
        loop = CellLoop(rep, label="chaos", n_cells=len(cells), mark=mark,
                        ck_meta=ck_meta, checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every,
                        progress=progress, die_env=_DIE_ENV)
        for idx, (fault, pol_name) in enumerate(cells):
            cell = f"chaos/{fault}/{pol_name}"
            if loop.skip(cell):
                continue
            cell_rate = day_rate if fault in _DAY_CLASSES else rate
            spec = resil.FaultSpec.single(fault, rate=cell_rate,
                                          seed=seed + idx)
            policy = all_policies[pol_name]
            with rep.span(cell) as sp:
                out = sp.add(step(*args, fault_spec=spec, policy=policy))
            if on_cell is not None:
                on_cell(cell, out, spec, policy)
            violations = check_invariants(out, tol=tol)
            verdict = obs_probes.watchdog(out.probes, baseline=profile)
            expected = EXPECT_STAGE[fault]
            if verdict["first_bad_stage"] != expected:
                violations.append(
                    f"watchdog attributed {verdict['first_bad_stage']!r}, "
                    f"expected {expected!r}")
            c = out.counters
            degrade = {k: int(getattr(c, k)) for k in
                       ("quarantined_days", "held_days",
                        "carry_fallback_days", "clamped_cells",
                        "degrade_events")}
            result = {"fault": fault, "policy": pol_name, "ok": not violations,
                      "violations": violations,
                      "first_bad_stage": verdict["first_bad_stage"],
                      "solver_fallback_days": int(c.solver_fallback_days),
                      **degrade}
            rep.record(cell, kind="degrade", **result)
            rep.add_counters(cell, out.counters)
            progress(f"{cell}: {'ok' if result['ok'] else 'FAIL'} "
                     f"(events={degrade['degrade_events']}, "
                     f"watchdog={verdict['first_bad_stage']})")
            loop.complete(idx, cell, result)

    return loop.verdict(cells)


# ------------------------------------------------------ the serving preset

#: dispatch-fault plans of the serving matrix (``resil.DispatchFaultPlan``
#: rates; "none" is the clean column every policy must pass undegraded)
SERVING_FAULTS = ("none", "dispatch_error", "dispatch_poison",
                  "dispatch_flaky")

#: the sentry attribution table: per fault class, the signals at least one
#: of which must fire (expected) and the set that may fire (allowed).
#: ``dispatch_error`` raises before dispatching, so its symptom is the
#: retry burn (failures only when retries run out); poison and flaky
#: dispatches retry and fail. Clean cells fire nothing: an overloaded
#: clean drain sheds, it does not fail or retry.
SERVING_SENTRY = {
    "none": (frozenset(), frozenset()),
    "dispatch_error": (frozenset({"retry_rate"}),
                       frozenset({"retry_rate", "failure_rate"})),
    "dispatch_poison": (frozenset({"retry_rate", "failure_rate"}),
                        frozenset({"retry_rate", "failure_rate"})),
    "dispatch_flaky": (frozenset({"retry_rate", "failure_rate"}),
                       frozenset({"retry_rate", "failure_rate"})),
}

#: admission policies of the serving matrix: "open" is unbounded (it must
#: still verdict everything), "bounded" depth-capped pure shedding,
#: "degrade" the whole ladder (serve stale, cheapest method, reject new)
SERVING_POLICIES = ("open", "bounded", "degrade")


def _sentry_violations(fired, expected, allowed, cell: str) -> list:
    """The attribution judgment of both presets: a fault cell must fire
    (missed detection), one fired signal must be an expected symptom
    (misattribution), and nothing outside the allowed set may fire (false
    positive)."""
    fired = set(fired)
    if not expected:
        return ([f"sentry false positive(s) with no fault injected: "
                 f"{sorted(fired)}"] if fired else [])
    out = []
    if not fired:
        out.append(f"sentry fired no alert for injected fault ({cell})")
    else:
        if not fired & expected:
            out.append(f"sentry misattribution: fired {sorted(fired)}, "
                       f"expected one of {sorted(expected)}")
        extra = fired - allowed
        if extra:
            out.append(f"sentry fired outside the allowed set: "
                       f"{sorted(extra)} (allowed {sorted(allowed)})")
    return out


def _serving_fault_plan(resil, kind: str, seed: int):
    # rates sized so the default grid's seeded plans roll at least one
    # fault a cell (0.3 poison over 3 dispatches missed)
    rates = {"none": None,
             "dispatch_error": dict(error_rate=0.3),
             "dispatch_poison": dict(poison_rate=0.6),
             "dispatch_flaky": dict(error_rate=0.2, poison_rate=0.2)}[kind]
    return None if rates is None else resil.DispatchFaultPlan(seed=seed,
                                                              **rates)


def _serving_policy(admission, kind: str, depth: int):
    if kind == "open":
        return admission.AdmissionPolicy(max_depth=None)
    if kind == "bounded":
        return admission.AdmissionPolicy(max_depth=depth)
    return admission.AdmissionPolicy(
        max_depth=depth,
        ladder=("serve_stale", "cheap_fallback", "reject_new"))


def run_serving_chaos(*, shape=(5, 30, 10), window: int = 6,
                      method: str = "linear", faults=None, policies=None,
                      n_requests: int = 24, load_factor: float = 1.5,
                      seed: int = 0, tol: float = 0.05, report=None,
                      checkpoint_path=None, checkpoint_every: int = 1,
                      progress=print, device=None, market=None,
                      configs=None) -> dict:
    """The serving matrix (module docs): dispatch-fault plan x admission
    policy over a loaded queue. Returns :func:`run_chaos`'s verdict shape.
    ``market`` as :func:`run_chaos`'s; ``configs``: the ``n_requests``
    tenants' configs in place of the preset's."""
    from factormodeling_tpu_torch import obs, resil
    from factormodeling_tpu_torch.obs import lineage as obs_lineage
    from factormodeling_tpu_torch.obs import metering as obs_metering
    from factormodeling_tpu_torch.obs import sentry as obs_sentry
    from factormodeling_tpu_torch.serve import TenantConfig, TenantServer
    from factormodeling_tpu_torch.serve import admission as serve_admission
    from factormodeling_tpu_torch.serve.queue import (bursty_arrivals,
                                                      make_requests)

    dev = resolve_device(device)
    names, arrays, shape = _market(shape, seed, market)
    f, d, n = shape
    panels = dict(zip(_PANEL_KEYS, arrays))
    faults = _check_known("serving fault kinds", faults, SERVING_FAULTS)
    policies = _check_known("serving policies", policies, SERVING_POLICIES)

    ladder = (1, 4, 8)
    depth = 10
    service_s = 0.05  # virtual seconds per dispatch (constant model)
    rate_hz = load_factor * ladder[-1] / service_s
    # pct / max_weight sized so a leg can always normalize to +-1 on the
    # small panel: the leg-sum invariant judges the queue, not the sizing
    if configs is None:
        configs = [TenantConfig(top_k=1 + i % f, icir_threshold=-1.0,
                                method=method, window=window, max_weight=0.5,
                                pct=0.25 + 0.03 * (i % 3))
                   for i in range(n_requests)]
    if len(configs) != n_requests:
        raise ValueError(f"{len(configs)} configs for {n_requests} requests")

    rep = report if report is not None else obs.RunReport("chaos-serving")
    cells = [(fk, pk) for fk in faults for pk in policies]
    ck_meta = {"entry": "chaos-serving",
               "config": [list(shape), window, method, faults, policies,
                          int(n_requests), float(load_factor), int(seed),
                          float(tol)]}
    with rep.activate():
        loop = CellLoop(rep, label="chaos-serving", n_cells=len(cells),
                        mark=len(rep.rows), ck_meta=ck_meta,
                        checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every,
                        progress=progress)
        for idx, (fault, pol_name) in enumerate(cells):
            cell = f"serving/{fault}/{pol_name}"
            if loop.skip(cell):
                continue
            server = TenantServer(names=names, pad_ladder=ladder,
                                  device=dev, **panels)
            arrivals = bursty_arrivals(n_requests, rate_hz=rate_hz,
                                       burst=6, seed=seed + idx)
            requests = make_requests(configs, arrivals,
                                     deadline_s=8 * service_s)
            cell_ck = (None if checkpoint_path is None
                       else f"{checkpoint_path}.cell{idx}")
            res = server.serve_queued(
                requests,
                admission=_serving_policy(serve_admission, pol_name, depth),
                service_model=lambda _tag, _rung: service_s,
                fault_plan=_serving_fault_plan(resil, fault, seed + idx),
                retries=2, checkpoint_path=cell_ck,
                queue_name=f"chaos/{cell}", flight=True, lineage=True,
                sentry=True)

            c = res.counters
            violations: list[str] = []
            # the flight recorder: one closed span tree a submitted request
            # (a retried or failed dispatch still closes its spans), and
            # the per-tenant and overhead accounts sum to the dispatch totals
            trace_complete = res.flight.recorder.complete()
            if not trace_complete:
                violations.append(
                    "flight trace completeness: open or malformed span "
                    f"tree(s) ({res.flight.recorder.open_traces()[:4]})")
            conserve = obs_metering.conservation_errors(
                res.flight.meter.row(cell))
            if conserve:
                violations.extend(conserve[:4])
            # the provenance ledger: every input id an edge references
            # resolves, faults or not
            lin_errs = obs_lineage.ledger_errors(
                res.lineage.rows(f"chaos/{cell}"))
            if lin_errs:
                violations.extend(lin_errs[:4])
            # the sentry: a fault cell fires an alert of its class, a clean
            # cell none, and every incident bundle resolves in the cell's
            # own rows
            fired = set(res.sentry.fired_signals())
            expected, allowed = SERVING_SENTRY[fault]
            if fault != "none" and not c["dispatch_faults"]:
                # the seeded plan rolled no fault in this cell: detection
                # is vacuous, the false-positive half still holds
                expected = frozenset()
            sentry_violations = _sentry_violations(fired, expected,
                                                  allowed, cell)
            sentry_rows = res.sentry.rows(f"chaos/{cell}")
            s_errs = obs_sentry.sentry_errors(
                sentry_rows + res.flight.recorder.rows(f"chaos/{cell}")
                + res.lineage.rows(f"chaos/{cell}"))
            sentry_violations.extend(s_errs[:4])
            violations.extend(sentry_violations)
            by_rid = res.by_rid()
            if sorted(by_rid) != list(range(n_requests)):
                violations.append("verdict completeness: not every rid "
                                  "got exactly one verdict")
            total = (c["served"] + c["shed_count"]
                     + c["deadline_miss_count"] + c["failed_count"])
            if total != n_requests:
                violations.append(f"verdict counts sum {total} != "
                                  f"{n_requests} submissions")
            if fault == "none" and c["failed_count"]:
                violations.append(f"{c['failed_count']} FAILED requests "
                                  f"with no fault injected")
            if pol_name == "open" and c["shed_count"]:
                violations.append("the unbounded policy shed requests")
            if pol_name != "open" and not (
                    c["shed_count"] + c["stale_served"]
                    + c["cheap_fallbacks"]):
                violations.append("bounded policy neither shed nor "
                                  "degraded under overload")
            checked = 0
            for v in res.verdicts:
                if v["verdict"] != "SERVED" or v["dispatch"] is None \
                        or v["rid"] not in res.outputs:
                    # stale serves reuse a checked book, and a resumed
                    # cell's pre-kill outputs were judged by the killed
                    # process: verdicts are durable, outputs are not
                    continue
                violations.extend(
                    f"rid {v['rid']}: {msg}" for msg in
                    check_invariants(res.outputs[v["rid"]], tol=tol))
                checked += 1
                if checked >= 4:
                    break
            result = {"fault": fault, "policy": pol_name,
                      "ok": not violations, "violations": violations,
                      "trace_complete": bool(trace_complete),
                      "metering_conserved": not conserve,
                      "lineage_intact": not lin_errs,
                      "sentry_clean": not sentry_violations,
                      "alerts_fired": sorted(fired),
                      "incidents": sum(1 for r in sentry_rows
                                       if r.get("kind") == "incident"),
                      **{k: int(c[k]) for k in
                         ("submitted", "served", "shed_count",
                          "deadline_miss_count", "failed_count",
                          "retry_count", "rung_downgrades", "stale_served",
                          "cheap_fallbacks", "dispatches")}}
            rep.record(cell, kind="serving", **result)
            progress(f"{cell}: {'ok' if result['ok'] else 'FAIL'} "
                     f"(served={c['served']} shed={c['shed_count']} "
                     f"miss={c['deadline_miss_count']} "
                     f"failed={c['failed_count']} "
                     f"retries={c['retry_count']})")
            loop.complete(idx, cell, result)

    return loop.verdict(cells)


# ---------------------------------------------------- the scenarios preset

#: scenario families of the ``--scenarios`` grid, crossed with the four
#: policy presets of :func:`build_policies`
SCENARIO_FAMILIES = ("bootstrap", "regime", "adversarial")


def _scenario_spec(scenarios, family: str, seed: int, d: int):
    """The grid's stress spec a family: aggressive but survivable (every
    cell, the default policy's too, holds the invariants; the sustained
    adversarial window keeps ``collapse_keep`` at 1, where a collapsed date
    goes flat instead of stacking carried books over the recovery)."""
    if family == "bootstrap":
        return scenarios.BootstrapSpec.make(seed=seed,
                                            block_len=max(d // 5, 2))
    if family == "regime":
        return scenarios.RegimeSpec.make(seed=seed, vol_scale=3.0,
                                         mean_shift=-0.01,
                                         corr_tighten=0.6)
    if family == "adversarial":
        return scenarios.AdversarialSpec.make(
            seed=seed, window_len=max(d // 3, 4), nan_rate=0.15,
            inf_rate=0.05, outlier_rate=0.05, stale_rate=0.2,
            drop_rate=0.25, collapse_rate=0.3, collapse_keep=1)
    raise ValueError(f"unknown scenario family {family!r}; valid: "
                     f"{SCENARIO_FAMILIES}")


def run_scenario_chaos(*, shape=(6, 48, 16), window: int = 8,
                       method: str = "equal", families=None, policies=None,
                       n_paths: int = 6, seed: int = 0, tol: float = 0.05,
                       report=None, checkpoint_path=None,
                       checkpoint_every: int = 1, progress=print,
                       device=None, market=None) -> dict:
    """The scenario grid: family x degrade policy, each cell a
    :func:`~factormodeling_tpu_torch.scenarios.run_scenarios` sweep of
    ``n_paths`` stressed markets through one tenant config, with finite
    risk rows (``kind="scenario"`` rows on the report) and the invariants on
    every path's book. Returns :func:`run_chaos`'s verdict shape."""
    from factormodeling_tpu_torch import obs, resil, scenarios
    from factormodeling_tpu_torch.serve import TenantConfig

    dev = resolve_device(device)
    names, arrays, shape = _market(shape, seed, market)
    f, d, n = shape
    panels = dict(zip(_PANEL_KEYS, arrays))
    families = _check_known("scenario families", families, SCENARIO_FAMILIES)
    template = TenantConfig(top_k=max(f // 2, 1), icir_threshold=-1.0,
                            method=method, window=window, max_weight=0.5,
                            pct=0.25, lookback_period=min(8, d))

    rep = report if report is not None else obs.RunReport("chaos-scenarios")
    with rep.activate():
        mark = len(rep.rows)
        # one identity-regime path (the base market to the bit) keys the
        # clamp policy's threshold to the healthy composite absmax
        with rep.span("scenarios/baseline") as sp:
            clean = scenarios.run_scenarios(
                names=names, template=template,
                spec=scenarios.RegimeSpec.off(seed=seed), n_paths=1,
                chunk=1, return_books=True, device=dev, **panels)
            sp.add(clean.books.signal)
        blend_absmax = float(np.nanmax(np.abs(
            host_array(clean.books.signal))))
        all_policies = build_policies(resil, blend_absmax)
        policies = _check_known("policies", policies, all_policies)

        cells = [(fam, pk) for fam in families for pk in policies]
        ck_meta = {"entry": "chaos-scenarios",
                   "config": [list(shape), window, method, families,
                              policies, int(n_paths), int(seed),
                              float(tol)]}
        loop = CellLoop(rep, label="chaos-scenarios", n_cells=len(cells),
                        mark=mark, ck_meta=ck_meta,
                        checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every,
                        progress=progress, die_env=_DIE_ENV)
        # one runner a family: every policy cell of the family reuses it
        runners: dict = {}
        for idx, (family, pol_name) in enumerate(cells):
            cell = f"scenario/{family}/{pol_name}"
            if loop.skip(cell):
                continue
            # seeded from the cell's identity, not its position: risk rows
            # are compared by name across runs, and a position seed would
            # redraw a cell's paths whenever the grid changes
            cell_seed = seed + zlib.crc32(cell.encode()) % 100003
            spec = _scenario_spec(scenarios, family, cell_seed, d)
            if family not in runners:
                runners[family] = scenarios.make_scenario_runner(
                    names=names, template=template, family=family,
                    return_books=True)
            res = scenarios.run_scenarios(
                names=names, template=template, spec=spec,
                policy=all_policies[pol_name], n_paths=n_paths,
                chunk=n_paths, return_books=True, report=rep, tag=cell,
                runner=runners[family], device=dev, **panels)
            violations: list[str] = []
            if not res.finite_ok:
                violations.append(
                    f"non-finite path metrics: {res.nonfinite}")
            for row in res.rows:
                bad = [v for v in row["var"] + row["es"]
                       if not np.isfinite(v)]
                if bad:
                    violations.append(
                        f"{row['metric']}: non-finite VaR/ES {bad}")
            for p in range(n_paths):
                path_bad = check_invariants(res.book(p), tol=tol)
                violations.extend(f"path {p}: {msg}" for msg in path_bad)
                if len(violations) >= 8:
                    break
            result = {"family": family, "policy": pol_name,
                      "ok": not violations, "violations": violations,
                      "paths": int(n_paths),
                      # a broken path counts once, however many of its
                      # metrics went non-finite
                      "nonfinite_paths": res.nonfinite_path_count,
                      **{k: int(v) for k, v in sorted(res.degrade.items())}}
            rep.record(cell, kind="scenario_cell", **result)
            progress(f"{cell}: {'ok' if result['ok'] else 'FAIL'} "
                     f"(paths={n_paths}, degrade={res.degrade})")
            loop.complete(idx, cell, result)

    return loop.verdict(cells)


# ------------------------------------------------------ the online preset

#: feed-anomaly classes of the online preset: each cell injects one
#: anomaly into an otherwise clean date stream
ONLINE_ANOMALIES = ("late_date", "duplicate_date", "restated_date",
                    "nan_storm", "universe_collapse", "kill_after_apply")
ONLINE_POLICIES = ("open", "guarded")

#: the anomaly tick's terminal (status, reason) a cell; a None reason
#: accepts any. The kill cells' expectation is the exactly-once proof: the
#: re-fed, already applied date rejects as a duplicate.
ONLINE_EXPECT = {
    ("late_date", "open"): ("rejected", "out_of_order"),
    ("late_date", "guarded"): ("rejected", "out_of_order"),
    ("duplicate_date", "open"): ("rejected", "duplicate"),
    ("duplicate_date", "guarded"): ("rejected", "duplicate"),
    ("restated_date", "open"): ("replayed", "ring"),
    ("restated_date", "guarded"): ("replayed", "ring"),
    ("nan_storm", "open"): ("applied", None),
    ("nan_storm", "guarded"): ("rejected", "nan_storm"),
    ("universe_collapse", "open"): ("applied", None),
    ("universe_collapse", "guarded"): ("rejected", "universe_collapse"),
    ("kill_after_apply", "open"): ("rejected", "duplicate"),
    ("kill_after_apply", "guarded"): ("rejected", "duplicate"),
}

#: the online sentry attribution table (:data:`SERVING_SENTRY`'s shape):
#: every cell arms zero-budget reject and replay burns and CUSUM drift on
#: the guard gauges. An open engine applies the poisoned slice, so the
#: drift detector must catch it; a guarded engine rejects it, so the reject
#: burn fires (and the drift detector may: the rejected slice's gauges are
#: still observed).
ONLINE_SENTRY = {
    ("late_date", "open"): (frozenset({"reject_rate"}),
                            frozenset({"reject_rate"})),
    ("late_date", "guarded"): (frozenset({"reject_rate"}),
                               frozenset({"reject_rate"})),
    ("duplicate_date", "open"): (frozenset({"reject_rate"}),
                                 frozenset({"reject_rate"})),
    ("duplicate_date", "guarded"): (frozenset({"reject_rate"}),
                                    frozenset({"reject_rate"})),
    ("restated_date", "open"): (frozenset({"replay_rate"}),
                                frozenset({"replay_rate"})),
    ("restated_date", "guarded"): (frozenset({"replay_rate"}),
                                   frozenset({"replay_rate"})),
    ("nan_storm", "open"): (frozenset({"nan_frac"}),
                            frozenset({"nan_frac"})),
    ("nan_storm", "guarded"): (frozenset({"reject_rate"}),
                               frozenset({"reject_rate", "nan_frac"})),
    ("universe_collapse", "open"): (frozenset({"universe_count"}),
                                    frozenset({"universe_count"})),
    ("universe_collapse", "guarded"): (
        frozenset({"reject_rate"}),
        frozenset({"reject_rate", "universe_count"})),
    ("kill_after_apply", "open"): (frozenset({"reject_rate"}),
                                   frozenset({"reject_rate"})),
    ("kill_after_apply", "guarded"): (frozenset({"reject_rate"}),
                                      frozenset({"reject_rate"})),
}


def run_online_chaos(*, shape=(6, 48, 16), window: int = 8,
                     method: str = "equal", faults=None, policies=None,
                     seed: int = 0, tol: float = 0.05, report=None,
                     checkpoint_path=None, checkpoint_every: int = 1,
                     progress=print, device=None, market=None,
                     template=None) -> dict:
    """The online grid: feed anomaly x engine guard over
    :class:`~factormodeling_tpu_torch.online.OnlineEngine`. Each cell
    streams the panel date by date with one anomaly injected and holds:

    - verdict completeness: applied + replayed + rejected == ingested, and
      the anomaly's tick ends in the expected verdict and reason
      (:data:`ONLINE_EXPECT`);
    - finite served rows: every finalized date's log-return is finite and
      its book obeys the weight bound;
    - kill/resume (the ``kill_after_apply`` cells): the engine checkpoints
      every applied date, restarts from its snapshot mid-stream (the
      ``_FMT_ONLINE_DIE_AFTER_DATE`` hook kills the real CLI there), re-feeds
      the last applied date once (rejected as a duplicate), and records a
      digest of the final state and the content chain, so a killed and
      resumed run's ``--json`` output is byte-equal to a straight run's.

    ``market`` as :func:`run_chaos`'s; ``template``: the tenant config in
    place of the preset's. Returns :func:`run_chaos`'s verdict shape."""
    from factormodeling_tpu_torch import obs
    from factormodeling_tpu_torch.obs import lineage as obs_lineage
    from factormodeling_tpu_torch.obs import reqtrace as obs_reqtrace
    from factormodeling_tpu_torch.obs import sentry as obs_sentry
    from factormodeling_tpu_torch.online import (DateSlice, EngineGuards,
                                                 OnlineEngine)
    from factormodeling_tpu_torch.resil import fingerprint
    from factormodeling_tpu_torch.resil.checkpoint import tree_leaves
    from factormodeling_tpu_torch.serve import TenantConfig

    dev = resolve_device(device)
    names, arrays, shape = _market(shape, seed, market)
    f, d, n = shape
    if d < 12:
        raise ValueError(f"--online needs at least 12 dates, got {d}")
    factors, returns, factor_ret, cap_flag, invest, universe = arrays
    anomalies = _check_known("online anomalies", faults, ONLINE_ANOMALIES)
    policies = _check_known("online policies", policies, ONLINE_POLICIES)
    if template is None:
        template = TenantConfig(top_k=max(f // 2, 1), icir_threshold=-1.0,
                                method=method, window=window, max_weight=0.5,
                                pct=0.25, lookback_period=min(8, d))
    guards = {"open": EngineGuards.open(),
              "guarded": EngineGuards.guarded(nan_frac_max=0.5,
                                              min_universe=2)}

    def slice_at(t, fac=None, uni=None):
        fa = factors if fac is None else fac
        un = universe if uni is None else uni
        return DateSlice(factors=fa[:, t, :], returns=returns[t],
                         factor_ret=factor_ret[t], cap_flag=cap_flag[t],
                         investability=invest[t], universe=un[t])

    def check_rows(verdicts) -> list:
        bad = []
        for v in verdicts:
            for o in v.outputs:
                lr = float(o["log_return"])
                if not np.isfinite(lr):
                    bad.append(f"date {int(o['day'])}: non-finite "
                               f"log-return {lr}")
                w = np.nan_to_num(host_array(o["weights"]))
                if np.abs(w).max() > 1.0 + tol:
                    bad.append(f"date {int(o['day'])}: |weight| "
                               f"{np.abs(w).max():.3f} > 1 + {tol}")
        return bad[:8]

    meter_cache: list = []

    def metered_advance_errors() -> list:
        """The per-(bucket, date) metering conservation of a small metered
        two-tenant ``advance_all`` session: the bucket accounts plus the
        pad account sum to the measured dispatch walls. It depends only on
        the grid's fixtures, so it runs once and every cell reads it."""
        if meter_cache:
            return meter_cache[0]
        from factormodeling_tpu_torch.obs.metering import (
            CostMeter, conservation_errors)
        from factormodeling_tpu_torch.serve import TenantServer

        srv = TenantServer(names=names, pad_ladder=(1, 4), device=dev,
                           **dict(zip(_PANEL_KEYS, arrays)))
        srv.online_begin([template, template])  # rung 4 -> 2 pad lanes
        meter = CostMeter()
        for t in range(3):
            srv.advance_all(slice_at(t), date=t, meter=meter)
        row = meter.row("chaos/online/advance_metering")
        errs = list(conservation_errors(row))
        if meter.pad_lanes != 3 * 2:
            errs.append(f"advance metering: expected 6 pad lanes over 3 "
                        f"dates, got {meter.pad_lanes}")
        if row["pad_fraction"] is None or not (
                0.0 < row["pad_fraction"] < 1.0):
            errs.append(f"advance metering: pad fraction "
                        f"{row['pad_fraction']!r} not in (0, 1) despite "
                        f"padded lanes")
        meter_cache.append(errs[:4])
        return meter_cache[0]

    rep = report if report is not None else obs.RunReport("chaos-online")
    tmp_ctx = None
    if checkpoint_path is None:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="chaos-online-")
        engine_ck_base = os.path.join(tmp_ctx.name, "engine")
    else:
        engine_ck_base = f"{checkpoint_path}.online-engine"
    try:
        with rep.activate():
            mark = len(rep.rows)
            cells = [(a, pk) for a in anomalies for pk in policies]
            ck_meta = {"entry": "chaos-online",
                       "config": [list(shape), window, method, anomalies,
                                  policies, int(seed), float(tol)]}
            loop = CellLoop(rep, label="chaos-online", n_cells=len(cells),
                            mark=mark, ck_meta=ck_meta,
                            checkpoint_path=checkpoint_path,
                            checkpoint_every=checkpoint_every,
                            progress=progress, die_env=_DIE_ENV)
            anomaly_at = d - 4      # the anomalous tick's date
            restate_of = d - 3      # the restatement's date, in the ring
            kill_resume_at = d // 2
            for idx, (anomaly, pol_name) in enumerate(cells):
                cell = f"online/{anomaly}/{pol_name}"
                if loop.skip(cell):
                    continue
                is_kill = anomaly == "kill_after_apply"
                ck_file = (f"{engine_ck_base}.{pol_name}.snap"
                           if is_kill else None)

                def make_engine():
                    # the cell's sentry: zero-budget burns on the reject
                    # and replay verdicts, CUSUM drift on the guard gauges;
                    # a restarted engine restores its detectors from the
                    # checkpoint, so the alert log continues
                    from factormodeling_tpu_torch.obs.sentry import (
                        BurnRateDetector, CusumDetector, Sentry)

                    return OnlineEngine(
                        names=names, n_assets=n, template=template,
                        has_universe=True, horizon=6,
                        guards=guards[pol_name], checkpoint=ck_file,
                        retain_history=True, dtype=torch.float32,
                        device=dev,
                        progress=lambda msg: progress(f"{cell}: {msg}"),
                        flight=True, lineage=True,
                        sentry=Sentry(detectors=[
                            BurnRateDetector("reject_rate", bad="rejected",
                                             total="ingested", budget=0.0),
                            BurnRateDetector("replay_rate", bad="replayed",
                                             total="ingested", budget=0.0),
                            CusumDetector("nan_frac"),
                            CusumDetector("universe_count")]))

                eng = make_engine()
                # traces are per process: the final engine's trace count
                # is the ingestions it saw, not the restored total
                eng_birth_ingested = eng.counters["ingested_dates"]
                verdicts = []
                start = (eng.last_date + 1 if eng.last_date is not None
                         else 0)
                for t in range(start, d):
                    if is_kill and t == kill_resume_at and start == 0:
                        # a deterministic in-process restart mid-stream
                        # (the straight and the killed CLI runs both take
                        # it, so their streams stay the same)
                        eng = make_engine()
                        eng_birth_ingested = eng.counters["ingested_dates"]
                    fac, uni = None, None
                    if anomaly == "nan_storm" and t == anomaly_at:
                        fac = factors.copy()
                        storm = fac[:, t, :]
                        storm[np.random.default_rng(seed).uniform(
                            size=storm.shape) < 0.9] = np.nan
                    if anomaly == "universe_collapse" and t == anomaly_at:
                        uni = universe.copy()
                        uni[t, 1:] = False
                    verdicts.append(eng.ingest(t, slice_at(t, fac, uni)))
                # the anomaly's extra tick (ordering and restatement)
                if anomaly == "late_date":
                    verdicts.append(eng.ingest(-1, slice_at(0)))
                elif anomaly == "duplicate_date":
                    verdicts.append(eng.ingest(d - 1, slice_at(d - 1)))
                elif anomaly == "restated_date":
                    fac = factors.copy()
                    fac[:, restate_of, :] = np.where(
                        np.isnan(fac[:, restate_of, :]),
                        np.nan, fac[:, restate_of, :] * 1.5)
                    verdicts.append(eng.ingest(restate_of,
                                               slice_at(restate_of, fac),
                                               restate=True))
                elif anomaly == "kill_after_apply":
                    # exactly once: the last applied date re-fed rejects
                    verdicts.append(eng.ingest(d - 1, slice_at(d - 1)))

                violations = []
                if not eng.verdict_complete():
                    violations.append(
                        f"verdict counts do not sum to ingestions: "
                        f"{eng.counters}")
                expect = ONLINE_EXPECT.get((anomaly, pol_name))
                if expect is not None:
                    got = (verdicts[anomaly_at - start]
                           if anomaly in ("nan_storm", "universe_collapse")
                           else verdicts[-1])
                    if (got.status, got.reason) != expect and \
                            (got.status, None) != expect:
                        violations.append(
                            f"anomaly tick verdict ({got.status}, "
                            f"{got.reason}) != expected {expect}")
                violations.extend(check_rows(verdicts))
                # one closed span tree a tick the final engine ingested (a
                # restarted engine judges its own ticks), and the metering
                flight_rows = eng.flight_rows()
                trace_errors = obs_reqtrace.row_errors(flight_rows)
                expected_traces = (eng.counters["ingested_dates"]
                                   - eng_birth_ingested)
                trace_complete = (not trace_errors
                                  and len(flight_rows) == expected_traces)
                if not trace_complete:
                    violations.append(
                        f"flight trace completeness: {len(flight_rows)} "
                        f"trace(s) for {expected_traces} ingestion(s), "
                        f"errors {trace_errors[:2]}")
                meter_errors = metered_advance_errors()
                violations.extend(meter_errors)
                # the provenance chain: every applied or replayed date's
                # prior state and slice ids resolve, acyclic, across the
                # restart (the ledger rides the engine's checkpoint)
                lin_rows = eng.lineage_rows(f"chaos/{cell}/lineage")
                lin_errs = obs_lineage.ledger_errors(lin_rows)
                if lin_errs:
                    violations.extend(lin_errs[:4])
                # the sentry: the anomaly fires its class's signal, the
                # clean prefix nothing more, every incident resolves
                fired = set(eng._sentry.fired_signals())
                expected, allowed = ONLINE_SENTRY[(anomaly, pol_name)]
                sentry_violations = _sentry_violations(fired, expected,
                                                      allowed, cell)
                sentry_rows = eng.sentry_rows(f"chaos/{cell}/sentry")
                s_errs = obs_sentry.sentry_errors(sentry_rows + lin_rows)
                sentry_violations.extend(s_errs[:4])
                violations.extend(sentry_violations)
                # statuses from the engine's resumed counters, not the
                # verdicts this process saw, so a killed and resumed
                # cell's output equals a straight run's
                statuses = {"applied": eng.counters["applied_dates"],
                            "replayed": eng.counters["replayed_dates"],
                            "rejected": eng.counters["rejected_dates"]}
                result = {
                    "anomaly": anomaly, "policy": pol_name,
                    "ok": not violations, "violations": violations,
                    "trace_complete": bool(trace_complete),
                    "metering_conserved": not meter_errors,
                    "lineage_intact": not lin_errs,
                    "sentry_clean": not sentry_violations,
                    "alerts_fired": sorted(fired),
                    "incidents": sum(1 for r in sentry_rows
                                     if r.get("kind") == "incident"),
                    "statuses": statuses,
                    "counters": {k: int(v)
                                 for k, v in sorted(eng.counters.items())},
                    "rejected_reasons": dict(sorted(
                        eng.rejected_reasons.items())),
                    # the content hash of the final state: byte-equal
                    # across a straight and a killed-and-resumed run
                    "state_digest": fingerprint(*tree_leaves(eng._state)),
                    "chain": eng._chain[:16],
                }
                rep.record(f"chaos/{cell}", kind="online",
                           **eng.report_fields())
                rep.rows.extend(eng.flight_rows(f"chaos/{cell}/trace"))
                rep.rows.extend(lin_rows)
                rep.rows.extend(sentry_rows)
                progress(f"{cell}: "
                         f"{'ok' if result['ok'] else 'FAIL'} "
                         f"(statuses={statuses})")
                loop.complete(idx, cell, result)
    finally:
        if tmp_ctx is not None:
            tmp_ctx.cleanup()

    return loop.verdict(cells)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--shape", default="6,48,16",
                        help="F,D,N of the synthetic panel (default 6,48,16)")
    parser.add_argument("--window", type=int, default=8)
    parser.add_argument("--method", default="mvo_turnover",
                        choices=("equal", "linear", "mvo", "mvo_turnover"))
    parser.add_argument("--faults", default="all",
                        help="comma-separated fault classes, or 'all'")
    parser.add_argument("--policies", default="all",
                        help="comma-separated policy presets "
                             "(default/guard/clamp/full), or 'all'")
    parser.add_argument("--rate", type=float, default=0.05,
                        help="per-cell fault probability (value classes)")
    parser.add_argument("--day-rate", type=float, default=0.2,
                        help="per-date fault probability (day classes)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tol", type=float, default=0.05,
                        help="leg-sum / bound tolerance (default 0.05)")
    parser.add_argument("--report", default=None,
                        help="write the RunReport JSONL here")
    parser.add_argument("--checkpoint", default=None,
                        help="snapshot the matrix loop here (atomic; "
                             "rerunning resumes)")
    parser.add_argument("--checkpoint-every", type=int, default=1)
    parser.add_argument("--json", action="store_true",
                        help="emit the verdict as one JSON object")
    parser.add_argument("--serving", action="store_true",
                        help="run the SERVING preset: dispatch-fault x "
                             "admission-policy cells against a loaded "
                             "request queue (module docs)")
    parser.add_argument("--requests", type=int, default=24,
                        help="requests per serving cell (with --serving)")
    parser.add_argument("--load", type=float, default=1.5,
                        help="arrival rate as a multiple of queue "
                             "capacity (with --serving)")
    parser.add_argument("--scenarios", action="store_true",
                        help="run the SCENARIO preset: scenario family x "
                             "degrade-policy cells, each a stressed-market "
                             "sweep with risk rows (module docs). --faults "
                             "selects families (bootstrap/regime/"
                             "adversarial), --policies the matrix presets")
    parser.add_argument("--paths", type=int, default=6,
                        help="scenario paths per cell (with --scenarios)")
    parser.add_argument("--online", action="store_true",
                        help="run the ONLINE preset: feed-anomaly x "
                             "engine-guard cells over the online engine — "
                             "verdict completeness, explicit rejections, "
                             "restatement replay, checkpoint kill/resume "
                             "(module docs). --faults selects anomalies, "
                             "--policies open/guarded")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, which raises "
                             "without a card; cpu only when asked for)")
    args = parser.parse_args(argv)
    if sum((args.serving, args.scenarios, args.online)) > 1:
        print("chaos: --serving, --scenarios, and --online are mutually "
              "exclusive", file=sys.stderr)
        return 2

    try:
        shape = tuple(int(v) for v in args.shape.split(","))
        if len(shape) != 3:
            raise ValueError("--shape needs exactly F,D,N")
    except ValueError as e:
        print(f"chaos: bad --shape {args.shape!r}: {e}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)   # no card and no --device cpu: raise

    from factormodeling_tpu_torch import obs
    from factormodeling_tpu_torch.resil import SnapshotCorrupt

    rep = obs.RunReport("chaos-online" if args.online
                        else "chaos-scenarios" if args.scenarios
                        else "chaos-serving" if args.serving else "chaos")
    faults = None if args.faults == "all" else args.faults.split(",")
    policies = None if args.policies == "all" else args.policies.split(",")
    common = dict(shape=shape, window=args.window, method=args.method,
                  policies=policies, seed=args.seed, tol=args.tol,
                  report=rep, checkpoint_path=args.checkpoint,
                  checkpoint_every=args.checkpoint_every,
                  progress=lambda msg: print(msg, file=sys.stderr),
                  device=device)
    try:
        if args.online:
            verdict = run_online_chaos(faults=faults, **common)
        elif args.scenarios:
            verdict = run_scenario_chaos(families=faults,
                                         n_paths=args.paths, **common)
        elif args.serving:
            verdict = run_serving_chaos(faults=faults,
                                        n_requests=args.requests,
                                        load_factor=args.load, **common)
        else:
            verdict = run_chaos(faults=faults, rate=args.rate,
                                day_rate=args.day_rate, **common)
    except ValueError as e:
        print(f"chaos: {e}", file=sys.stderr)
        return 2
    except SnapshotCorrupt as e:
        # rejected, never half-resumed: delete the snapshot (or point
        # --checkpoint elsewhere) to start afresh
        print(f"chaos: refusing to resume from a corrupt checkpoint: {e}",
              file=sys.stderr)
        return 2
    if args.report:
        rep.write_jsonl(args.report)
        print(f"report: {args.report}", file=sys.stderr)
    if args.json:
        print(json.dumps(verdict, sort_keys=True))
    else:
        for name, res in verdict["results"].items():
            status = "ok" if res["ok"] else "FAIL " + "; ".join(
                res["violations"])
            print(f"{name}: {status}")
        print(f"chaos: {len(verdict['failed'])} failing cell(s) of "
              f"{verdict['cells']}")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
