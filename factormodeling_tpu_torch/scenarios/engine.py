"""The scenario engine: one tenant config, a batch of markets (port of
``factormodeling_tpu/scenarios/engine.py``).

The serving layer batches tenant configs over one market; this module
inverts the axes: the config is held fixed and the MARKET varies over a
path axis ``P``. Each path is a seeded transform of the base market
(resampled / regime-shifted / adversarial,
:mod:`~factormodeling_tpu_torch.scenarios.spec`) run through the serving
layer's per-tenant program
(:func:`~factormodeling_tpu_torch.serve.batched.tenant_step_parts`), so
strategy robustness (VaR/ES, drawdown tails) and system robustness (finite
outputs under a ``DegradePolicy``) are measured by the same engine.

**The hoist.** The sort-heavy per-date stats (``daily_factor_stats``: the
rank-IC over the whole ``[F, D, N]`` stack, one K1 launch on F·D rows on
the card) run once a dispatch on the base market; every path consumes them
by gather or mask, so no sort touches a per-path stack:

- **bootstrap** resamples the per-date joint observation, so a path's
  stats are a date gather of the hoisted ``[F, D]`` stats, re-windowed;
- **regime** transforms are per-date positive affine maps of the
  cross-section, under which IC and rank-IC are exactly invariant: the
  hoisted stats are exact, and with the factors and the universe the base
  market's, the selection context, the selection and the blend are the
  same on every path. They run once a dispatch (``tenant_body.prefix``)
  and the simulation runs once on the ``[P, D, N]`` stack of return views
  (``tenant_body.simulate``), as the JAX package's vmap leaves that prefix
  unbatched;
- **adversarial** day classes act on the stats by gather (stale) and NaN
  mask (drop); cell classes corrupt the ``[D, N]`` market surface the blend
  and the backtest consume (the per-path factor view and return panel).

The JAX package vmaps the paths; the port runs them as the lanes of the
serving layer's tenant body: each sub-batch of at most ``map_chunk`` paths
stacks its market views and per-path selection contexts along a path axis
and runs the tenant body once (the bootstrap and adversarial families),
so the backtest's day loop and its solves run once for all of them. The
draws are the JAX package's (:mod:`.spec`): the scalar and per-date ones on
the host, whose masks and indices move to the device, the cell draws on the
market's device.

**Chunking and resume**: paths dispatch in host-loop chunks; the per-chunk
path metrics fold into
:class:`~factormodeling_tpu_torch.scenarios.risk.RiskAccumulator` sketches,
which merge exactly, so after every chunk the accumulator snapshots through
``resil.checkpoint`` and a killed sweep resumes with rows equal to a
straight-through run.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from factormodeling_tpu_torch._device import check_device
from factormodeling_tpu_torch.metrics import daily_factor_stats, rolling_metrics
from factormodeling_tpu_torch.obs.compile_log import (entry_point_tag,
                                                      instrument_jit)
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.ops._window import shift
from factormodeling_tpu_torch.scenarios.risk import (DEFAULT_LEVELS,
                                                     RiskAccumulator)
from factormodeling_tpu_torch.scenarios.spec import (family_of, leaves,
                                                     path_key)
from factormodeling_tpu_torch.selection import (finish_selection_context,
                                                selection_metric_needs)
from factormodeling_tpu_torch.selection.selectors import SelectionContext
from factormodeling_tpu_torch.serve.batched import (one_lane,
                                                    tenant_step_parts,
                                                    tree_lane)
from factormodeling_tpu_torch.serve.tenant import _VALUE_LEAVES
from factormodeling_tpu_torch.threefry import numpy_dtype

__all__ = ["ScenarioResult", "make_scenario_runner", "make_scenario_step",
           "run_scenarios"]

#: test hook: return the partial (row-less) result right after
#: checkpointing this many chunks — the mid-sweep-kill seam of the resume
#: differential, as the JAX package's.
_STOP_ENV = "_FMT_SCEN_STOP_AFTER_CHUNK"


def _path_metrics(out) -> dict:
    """Per-path risk scalars off a ResearchOutput of ``P`` path lanes
    (``[P]`` tensors on the device; the names are
    :data:`~factormodeling_tpu_torch.scenarios.risk.RISK_METRICS`)."""
    lr = out.sim.result.log_return                       # [P, D]
    lr0 = torch.where(torch.isnan(lr), 0.0, lr)
    cum = torch.cumsum(lr0, -1)
    running_peak = torch.cummax(torch.clamp(cum, min=0.0), -1).values
    return {
        "pnl_total": out.summary.total_log_return,
        "max_drawdown": (running_peak - cum).amax(-1),
        "mean_turnover": out.summary.mean_turnover,
        "worst_day_loss": -lr0.amin(-1),
    }


def _lanes_of(tenant, p: int):
    """One normalized config as a batch of ``p`` identical lanes."""
    one = one_lane(tenant)
    return dataclasses.replace(one, **{
        name: np.repeat(getattr(one, name), p, axis=0)
        for name in _VALUE_LEAVES if getattr(one, name) is not None})


def _stack_contexts(ctxs) -> SelectionContext:
    """Per-path selection contexts stacked along a leading path axis."""
    first = ctxs[0]
    return SelectionContext(
        metrics_win={k: torch.stack([c.metrics_win[k] for c in ctxs])
                     for k in first.metrics_win},
        factor_ret=torch.stack([c.factor_ret for c in ctxs]),
        ret_win_sum=torch.stack([c.ret_win_sum for c in ctxs]),
        window=first.window)


def _policy_leaves(policy) -> list:
    """A DegradePolicy's leaves in the JAX package's pytree order and
    dtypes (what its fingerprint hashes)."""
    if policy is None:
        return []
    return [np.asarray(policy.min_universe, np.int32),
            np.asarray(policy.quarantine_nan_frac, np.float32),
            np.asarray(policy.clamp_absmax, np.float32),
            np.asarray(policy.carry_fallback, bool)]


def make_scenario_step(*, names, template, family: str,
                       return_books: bool = False, map_chunk=None):
    """Build the path-looped step for one scenario family.

    Returns ``step(tenant, spec, policy, path_ix, factors, returns,
    factor_ret, cap_flag, investability, universe=None)`` where ``tenant``
    is a normalized :class:`~factormodeling_tpu_torch.serve.TenantConfig`,
    ``spec`` the family's spec, ``policy`` an optional
    :class:`~factormodeling_tpu_torch.resil.DegradePolicy` (None runs no
    degradation code) and ``path_ix`` the path indices (a sequence of
    ints). Output leaves carry the leading path axis: the per-path metric
    dict (+ degrade tallies with a policy, + the stacked ResearchOutput
    when ``return_books``).

    ``map_chunk``: the bound on the paths resident at once: each
    sub-batch of at most that many paths (None: all of a call's) is one
    tenant-body call on their stacked views, as the JAX package maps
    vmapped sub-batches of that width; any width gives the same outputs.
    """
    if family not in ("bootstrap", "regime", "adversarial"):
        raise ValueError(f"unknown scenario family {family!r}")
    if map_chunk is not None and int(map_chunk) < 1:
        raise ValueError(f"map_chunk must be >= 1, got {map_chunk}")
    names = tuple(names)
    window = template.window
    select_static = dict(template.select_static)
    if template.select_method == "icir_top":
        select_static["use_rank_icir"] = template.use_rank_icir
    needs = selection_metric_needs(template.select_method, select_static)
    _, tenant_body = tenant_step_parts(names, template)

    def context(daily_p, fr_view, f_view, uni_view, policy):
        """The selection context of one market view, with the policy's
        quarantine on its stats (``tallies`` None without a policy)."""
        fr_ctx, tallies = fr_view, None
        if policy is not None:
            from factormodeling_tpu_torch.resil import policy as resil_policy

            # NaN-day quarantine at the stats level: protect the windowed
            # statistics, keep the day's own cross-section trading
            qday = resil_policy.quarantine_days(f_view, uni_view, policy)
            daily_p = {k: torch.where(qday[None, :], float("nan"), v)
                       for k, v in daily_p.items()}
            fr_ctx = torch.where(qday[:, None], float("nan"), fr_view)
            tallies = {"quarantined_days": qday.sum().to(torch.int32)}
        if daily_p:
            rm = rolling_metrics(daily_p, max(window - 1, 1))
            metrics_win = {k: shift(v, 1, axis=-1) for k, v in rm.items()}
        else:
            metrics_win = {}
        return finish_selection_context(metrics_win, fr_ctx, window), tallies

    def finish(out, tallies, policy):
        if policy is not None:
            hold = out.sim.degrade
            zero = torch.zeros(out.signal.shape[:1], dtype=torch.int32,
                               device=out.signal.device)
            tallies = dict(tallies,
                           held_days=(zero if hold is None
                                      else hold.held_days),
                           carry_days=(zero if hold is None
                                       else hold.carry_days))
        return out, tallies

    def view(spec, p, factors, returns, factor_ret, cap_flag, investability,
             universe):
        """One bootstrap or adversarial path's market view: ``(idx,
        stat_nan, f, r, fr, cap, inv, uni)``, ``idx``/``stat_nan`` None
        when the path keeps every date / masks none."""
        d, dev = returns.shape[0], returns.device
        key = path_key(spec, p)
        if family == "bootstrap":
            idx = torch.as_tensor(spec.day_index(key, d), device=dev)
            uni = None if universe is None else universe[idx]
            return (idx, None, factors[:, idx], returns[idx],
                    factor_ret[idx], cap_flag[idx], investability[idx], uni)
        in_win, stale, drop, collapse = spec.schedule(key, d)
        days = np.arange(d)
        idx = None
        take = lambda x, axis=0: x  # noqa: E731
        if stale.any():
            idx = torch.as_tensor(np.where(stale, np.maximum(days - 1, 0),
                                           days), device=dev)
            take = lambda x, axis=0: x.index_select(axis, idx)  # noqa: E731
        masks = tuple(None if m is None else torch.as_tensor(m, device=dev)
                      for m in spec.cell_masks(key, returns.shape, in_win,
                                               device=dev))
        f_view = spec.apply_cells(take(factors, 1), masks)
        # the RETURN panel takes only the NaN mask: a corrupt return
        # observation is a MISSING observation (the NaN-aware pnl path
        # skips it), while an Inf/outlier realized return would make every
        # book's pnl non-finite regardless of policy
        r_view = take(returns)
        if masks[0] is not None:
            r_view = torch.where(masks[0], float("nan"), r_view)
        fr_view = take(factor_ret)
        stat_nan = None
        if drop.any():
            stat_nan = torch.as_tensor(drop, device=dev)
            f_view = torch.where(stat_nan[None, :, None], float("nan"),
                                 f_view)
            r_view = torch.where(stat_nan[:, None], float("nan"), r_view)
            fr_view = torch.where(stat_nan[:, None], float("nan"), fr_view)
        uni = (torch.ones(returns.shape, dtype=torch.bool, device=dev)
               if universe is None else universe)
        uni_view = take(uni)
        if collapse.any():
            rank = torch.cumsum(uni_view.to(torch.int32), dim=1)
            collapsed = uni_view & (rank <= spec.collapse_keep)
            uni_view = torch.where(torch.as_tensor(collapse, device=dev)
                                   [:, None], collapsed, uni_view)
        return (idx, stat_nan, f_view, r_view, fr_view,
                take(cap_flag), take(investability), uni_view)

    def step(tenant, spec, policy, path_ix, factors, returns, factor_ret,
             cap_flag, investability, universe=None):
        d = returns.shape[0]
        if window >= d:
            raise ValueError(f"window {window} >= {d} dates: the "
                             f"processed range is empty, no path to run")
        if family_of(spec) != family:
            raise ValueError(f"step built for {family!r}, got a "
                             f"{family_of(spec)!r} spec")
        with obs_stage("scenarios/daily_stats"):
            # THE HOIST (module docs): the per-date stats once a dispatch
            daily = {}
            if needs:
                raw = daily_factor_stats(factors, returns, shift_periods=2,
                                         universe=universe, stats=needs)
                daily = {k: raw[k] for k in needs}          # [F, D] each
        path_ix = [int(p) for p in path_ix]
        width = len(path_ix) if map_chunk is None else int(map_chunk)
        batches = [path_ix[lo:lo + width]
                   for lo in range(0, len(path_ix), width)]
        outs, tallies = [], []
        with obs_stage("scenarios/paths"):
            if family == "regime":
                ctx, tal = context(daily, factor_ret, factors, universe,
                                   policy)
                sel, signal = tenant_body.prefix(one_lane(tenant), ctx,
                                                 factors, universe,
                                                 policy=policy)
                for ps in batches:
                    p = len(ps)
                    # every path's break and intensity in one host pass
                    breaks, intensity = spec.draws(path_key(spec, ps), d,
                                                   returns.dtype)
                    r_views = torch.stack([
                        spec.apply(returns, s, u)
                        for s, u in zip(breaks, intensity)])
                    out = tenant_body.simulate(
                        _lanes_of(tenant, p), sel.expand(p, *sel.shape[1:]),
                        signal.expand(p, *signal.shape[1:]), r_views,
                        cap_flag, investability, universe, policy=policy)
                    out, t = finish(out, None if tal is None else {
                        k: v.expand(p) for k, v in tal.items()}, policy)
                    outs.append(out)
                    tallies.append(t)
            else:
                for ps in batches:
                    views, ctxs, tals = [], [], []
                    for i in ps:
                        (idx, stat_nan, f_view, r_view, fr_view, cap_view,
                         inv_view, uni_view) = view(spec, i, factors, returns,
                                                    factor_ret, cap_flag,
                                                    investability, universe)
                        daily_p = {k: (v if idx is None
                                       else v.index_select(1, idx))
                                   for k, v in daily.items()}
                        if stat_nan is not None:
                            daily_p = {k: torch.where(stat_nan[None, :],
                                                      float("nan"), v)
                                       for k, v in daily_p.items()}
                        ctx, tal = context(daily_p, fr_view, f_view,
                                           uni_view, policy)
                        views.append((f_view, r_view, cap_view, inv_view,
                                      uni_view))
                        ctxs.append(ctx)
                        tals.append(tal)
                    f_v, r_v, cap_v, inv_v, uni_v = (
                        None if col[0] is None else torch.stack(col)
                        for col in zip(*views))
                    out = tenant_body(_lanes_of(tenant, len(ps)),
                                      _stack_contexts(ctxs), f_v, r_v, cap_v,
                                      inv_v, uni_v, policy=policy)
                    out, t = finish(out, None if policy is None else {
                        k: torch.stack([t[k] for t in tals])
                        for k in tals[0]}, policy)
                    outs.append(out)
                    tallies.append(t)
        per_batch = [_path_metrics(o) for o in outs]
        mets = {k: torch.cat([m[k] for m in per_batch])
                for k in ("pnl_total", "max_drawdown", "mean_turnover",
                          "worst_day_loss")}
        res = (mets,)
        if policy is not None:
            res += ({k: torch.cat([t[k] for t in tallies])
                     for k in tallies[0]},)
        if return_books:
            res += (_cat_trees(outs),)
        return res[0] if len(res) == 1 else res

    return step


class _Runner:
    """A scenario step with its build identity: ``scenario_build`` (what
    :func:`run_scenarios` checks a passed runner against) and
    ``entry_point_tag``."""

    def __init__(self, step, family: str, return_books: bool, map_chunk):
        self.name = f"scenarios/step/{family}"
        # call statistics (obs.compile_log) under the JAX package's name;
        # a runner takes one signature a path-batch width and policy
        # presence, so none is pinned
        self._step = instrument_jit(step, self.name)
        self.scenario_build = {"family": family,
                               "return_books": bool(return_books),
                               "map_chunk": map_chunk}
        self.entry_point_tag = entry_point_tag(self.name, bool(return_books),
                                               map_chunk)

    def __call__(self, *args, **kwargs):
        return self._step(*args, **kwargs)


def make_scenario_runner(*, names, template, family: str,
                         return_books: bool = False, map_chunk=None):
    """The scenario step for one family, built once: thread the same runner
    through many :func:`run_scenarios` calls (``runner=``) to build the
    tenant program once for a grid of specs and policies."""
    step = make_scenario_step(names=names, template=template, family=family,
                              return_books=return_books,
                              map_chunk=map_chunk)
    return _Runner(step, family, return_books, map_chunk)


@dataclasses.dataclass
class ScenarioResult:
    """One scenario sweep's artifact (see :func:`run_scenarios`)."""

    family: str
    n_paths: int
    rows: list                      # kind="scenario" report rows
    accumulator: RiskAccumulator    # mergeable per-metric sketches
    nonfinite: dict                 # metric -> paths whose scalar wasn't
    #: paths with AT LEAST one non-finite metric — the per-PATH failure
    #: count (summing `nonfinite` values would count one broken path once
    #: per metric)
    nonfinite_path_count: int
    degrade: dict                   # summed per-path policy tallies
    books: object = None            # stacked ResearchOutput (return_books)
    completed: bool = True          # False = stopped by the test seam

    @property
    def finite_ok(self) -> bool:
        """True when every path produced a finite value for every risk
        metric."""
        return not any(self.nonfinite.values())

    def book(self, path: int):
        """The path-th ResearchOutput slice (requires ``return_books``)."""
        if self.books is None:
            raise ValueError("run_scenarios(return_books=True) required")
        return tree_lane(self.books, path)


def _panel(x, dev: torch.device):
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=dev)


def run_scenarios(*, names, template, spec, policy=None, factors, returns,
                  factor_ret, cap_flag, investability, universe=None,
                  n_paths: int = 256, chunk: int = 64,
                  levels=DEFAULT_LEVELS, return_books: bool = False,
                  map_chunk=None, checkpoint_path=None,
                  checkpoint_every: int = 1, report=None, tag=None,
                  runner=None, progress=None, lineage=None,
                  device=None) -> ScenarioResult:
    """Run ``n_paths`` scenario paths of one family through the tenant
    step, chunked, and fold the per-path risk scalars into mergeable
    sketches (module docs). Returns a :class:`ScenarioResult`; with
    ``report`` (an ``obs.RunReport``) the ``kind="scenario"`` rows are
    recorded onto it.

    Panels are tensors on ``device`` (None: the card; ``"cpu"`` asks for
    the CPU) or host arrays, moved there once.

    ``checkpoint_path`` snapshots the accumulator and the chunk cursor
    after every ``checkpoint_every`` chunks (``resil.checkpoint``, guarded
    by a content fingerprint of panels, spec, policy and config): rerun
    the same call after a kill and the rows equal a straight-through run's.
    Incompatible with ``return_books`` (books are not snapshotted).

    ``lineage``: ``True`` or a shared
    :class:`~factormodeling_tpu_torch.obs.lineage.LineageLedger` records
    one ``scenario_chunk`` edge per chunk (the chunk's host risk metrics'
    fingerprint, derived from the spec's and the base market's). The
    ledger rides the checkpoint, so a resumed sweep's ledger is byte-equal
    to straight-through; rows land on ``report`` when the sweep completes.
    Off by default; ``obs.lineage`` is not imported when off.
    """
    from factormodeling_tpu_torch import resil
    from factormodeling_tpu_torch.composite import prefix_group_ids
    from factormodeling_tpu_torch.serve.tenant import config_leaves

    family = family_of(spec)
    if n_paths < 1:
        raise ValueError(f"n_paths must be >= 1, got {n_paths}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if return_books and checkpoint_path is not None:
        raise ValueError("return_books=True cannot be checkpointed: books "
                         "are not snapshotted, so a resumed sweep would "
                         "silently lose the killed run's paths")
    tensors = [x for x in (factors, returns, factor_ret, cap_flag,
                           investability, universe)
               if isinstance(x, torch.Tensor)]
    dev = check_device(device, *tensors)
    panels = tuple(_panel(x, dev) for x in (factors, returns, factor_ret,
                                            cap_flag, investability,
                                            universe))

    names = tuple(names)
    n_groups = len(prefix_group_ids(names)[1])
    dtype = numpy_dtype(panels[1].dtype)
    tenant = template.normalized(len(names), n_groups, dtype=dtype)
    tag = tag or f"scenarios/{family}"

    if runner is not None:
        want = {"family": family, "return_books": bool(return_books),
                "map_chunk": map_chunk}
        got = getattr(runner, "scenario_build", None)
        if got != want:
            raise ValueError(
                f"runner was built with {got}, this call needs {want} — "
                f"build it via make_scenario_runner with matching "
                f"family/return_books/map_chunk")
    else:
        runner = make_scenario_runner(
            names=names, template=template, family=family,
            return_books=return_books, map_chunk=map_chunk)

    acc = RiskAccumulator(levels)
    nonfinite: dict[str, int] = {}
    nonfinite_path_count = 0
    degrade: dict[str, int] = {}
    n_chunks = -(-n_paths // chunk)
    start_chunk = 0
    ledger = None
    if lineage:
        from factormodeling_tpu_torch.obs.lineage import LineageLedger

        ledger = (lineage if isinstance(lineage, LineageLedger)
                  else LineageLedger())
    present = []
    if checkpoint_path is not None or ledger is not None:
        # one host copy of the panels for both fingerprints
        present = [p.cpu().numpy() for p in panels if p is not None]
    ck = ck_meta = None
    if checkpoint_path is not None:
        ck_meta = {
            "entry": "scenarios",
            "config": [family, int(n_paths), int(chunk),
                       [float(v) for v in levels], repr(tenant.static_key()),
                       map_chunk if map_chunk is None else int(map_chunk)],
            # content guard: resuming sketches computed from other
            # panels/spec/policy/config silently corrupts the merged rows
            "fingerprint": resil.fingerprint(
                *present, *leaves(spec), *_policy_leaves(policy),
                *config_leaves(tenant)),
        }
        ck = resil.Checkpointer(checkpoint_path, every=checkpoint_every)
        got = ck.resume(expect_meta=ck_meta)
        if got is not None:
            state, _ = got
            start_chunk = int(state["next_chunk"])
            acc = RiskAccumulator.from_state(state["acc"])
            nonfinite = {k: int(v) for k, v in state["nonfinite"].items()}
            nonfinite_path_count = int(state["nonfinite_path_count"])
            degrade = {k: int(v) for k, v in state["degrade"].items()}
            if ledger is not None and "lineage" in state:
                ledger.load_state(str(state["lineage"]))
            if progress:
                progress(f"scenarios: resumed {start_chunk}/{n_chunks} "
                         f"chunks from {checkpoint_path}")
    spec_id = market_id = None
    if ledger is not None:
        # idempotent and after any resume: the restored ledger already
        # holds these sources, so it stays byte-equal to straight-through
        spec_id = ledger.source(resil.fingerprint(*leaves(spec)),
                                "path_spec", family=family)
        market_id = ledger.source(resil.fingerprint(*present),
                                  "base_market")

    stop_after = os.environ.get(_STOP_ENV)
    books_chunks = []
    for ci in range(start_chunk, n_chunks):
        lo, hi = ci * chunk, min((ci + 1) * chunk, n_paths)
        res = runner(tenant, spec, policy, range(lo, hi), *panels)
        if policy is not None and return_books:
            mets, tallies, outs = res
        elif policy is not None:
            mets, tallies = res
        elif return_books:
            mets, outs = res
        else:
            mets = res
        host = {k: v.cpu().numpy() for k, v in mets.items()}
        # a broken path counts ONCE here, however many of its metrics
        # went non-finite (the per-metric tallies feed the rows)
        nonfinite_path_count += int((~np.logical_and.reduce(
            [np.isfinite(v) for v in host.values()])).sum())
        for k in sorted(host):
            for v in host[k]:
                if np.isfinite(v):
                    acc.observe(k, float(v))
                else:
                    nonfinite[k] = nonfinite.get(k, 0) + 1
        if policy is not None:
            for k, v in tallies.items():
                degrade[k] = degrade.get(k, 0) + int(v.sum())
        if ledger is not None:
            ledger.edge(
                resil.fingerprint(*[host[k] for k in sorted(host)]),
                "scenario_chunk", [spec_id, market_id],
                code={"static_key": repr(tenant.static_key())},
                chunk=int(ci), paths=[int(lo), int(hi)])
        if return_books:
            books_chunks.append(outs)
        if progress:
            progress(f"{tag}: chunk {ci + 1}/{n_chunks} "
                     f"({hi}/{n_paths} paths)")
        if ck is not None:
            ck.maybe_save(ci, {"next_chunk": ci + 1, "acc": acc.state(),
                               "nonfinite": dict(nonfinite),
                               "nonfinite_path_count": nonfinite_path_count,
                               "degrade": dict(degrade),
                               **({"lineage": ledger.state()}
                                  if ledger is not None else {})},
                          meta=ck_meta)
            if stop_after is not None \
                    and ci - start_chunk + 1 >= int(stop_after):
                # the kill seam: checkpoint written, NO rows emitted —
                # exactly the state a killed sweep leaves behind
                return ScenarioResult(
                    family=family, n_paths=n_paths, rows=[],
                    accumulator=acc, nonfinite=dict(nonfinite),
                    nonfinite_path_count=nonfinite_path_count,
                    degrade=dict(degrade), completed=False)

    books = None
    if return_books:
        books = (books_chunks[0] if len(books_chunks) == 1 else
                 _cat_trees(books_chunks))
    rows = acc.rows(tag, family=family, n_paths=n_paths)
    for row in rows:
        row["nonfinite_paths"] = nonfinite.get(row["metric"], 0)
        if degrade:
            row["degrade"] = dict(degrade)
    if report is not None:
        for row in rows:
            fields = {k: v for k, v in row.items()
                      if k not in ("kind", "name")}
            report.record(row["name"], kind="scenario", **fields)
        if ledger is not None:
            report.rows.extend(ledger.rows(tag))
    return ScenarioResult(family=family, n_paths=n_paths, rows=rows,
                          accumulator=acc, nonfinite=dict(nonfinite),
                          nonfinite_path_count=nonfinite_path_count,
                          degrade=dict(degrade), books=books)


def _cat_trees(trees):
    """Concatenate equal-structured output trees along their path axis."""
    from factormodeling_tpu_torch.serve.batched import _tree_map

    return _tree_map(lambda *xs: torch.cat(xs), *trees)
