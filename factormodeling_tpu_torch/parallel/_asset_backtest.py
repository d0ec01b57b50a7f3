"""The asset-sharded step's backtest under the layout plan
(``ops/_assetspec.py``'s ``backtest/weights`` and ``solver/iterates``
stages).

The panels arrive as this rank's ``[D/d, N/s]`` blocks and the signal as
the blend's rows. Each stage forms the rows its mode leaves the rank,
whole along the assets, and computes on them:

- ``solver/iterates`` (plain ``mvo``, the ``mvo_turnover`` scan and
  parallel scheme): the signal's, investability's and universe's rows,
  and the returns rows with a halo of the rows before them that the
  covariance window (or the risk model's fits) reads
  (:func:`~factormodeling_tpu_torch.backtest.mvo.block_ret0`), handed on
  from block to block (``parallel/mesh.permute``). The row blocks solve
  in date order where a date reads the one before: the turnover scan's
  day ``t`` needs day ``t-1``'s weights and exit state, and a plain-MVO
  date warm-starts from the exit state of the date ``mvo_batch`` before
  it, so the rank holding a block solves it on the carry the block
  before handed it and hands its own on: one hand-off a block boundary.
  The days run in order as on one device, and each block computes the
  bits it would there. Without warm starts plain MVO's dates are
  independent and no carry moves. The parallel scheme's seed and sweeps
  are independent dates: every block sweeps at once, a sweep taking the
  trajectory row before the block (one row, handed on) and one largest
  move a lane over the blocks (``all_reduce``), so every rank stops a
  lane at the same sweep; its suffix then runs the blocks in date order
  as the scan's does. The risk model's fits are made on the block's own
  halo'd rows.
- ``backtest/weights``: the weights' rows (the equal and linear schemes'
  leg ranks run here; the QP schemes' weights move here from the
  solver's rows) with the returns, cap and universe rows. The one-day
  masked shift needs each name's last weight on a present date before
  the block: each block's last present row (and whether it has one) is
  gathered, one ``[2, N]`` row a block (:func:`block_masked_shift`). The
  P&L's turnover needs the shifted row before the block: a halo of one
  row from the block before. The daily series are gathered along the
  dates (``AssetSpecPlan.gather_rows``), the per-name P&L summed over
  the blocks (``all_reduce``), and the shifted weights go back to this
  rank's ``[D/d, N/s]`` block.

The chooser's form (``shapes_only``, on ``meta`` tensors) issues the same
collectives with the solves replaced by empty results of their shapes
(the parallel scheme's as if every lane ran ``turnover_sweeps`` sweeps,
its most).
"""

from __future__ import annotations

import dataclasses

import torch

from factormodeling_tpu_torch.backtest import mvo as _mvo
from factormodeling_tpu_torch.backtest.diagnostics import (SchemeStats,
                                                           SolverDiagnostics)
from factormodeling_tpu_torch.backtest.engine import SimulationOutput
from factormodeling_tpu_torch.backtest.pnl import (DailyResult,
                                                   daily_portfolio_returns)
from factormodeling_tpu_torch.backtest.settings import SimulationSettings
from factormodeling_tpu_torch.backtest.weights import (equal_weights,
                                                       linear_weights)
from factormodeling_tpu_torch.obs.trace import stage as obs_stage
from factormodeling_tpu_torch.ops._assetspec import AssetSpecPlan
from factormodeling_tpu_torch.ops._window import (compaction_order,
                                                  masked_shift)
from factormodeling_tpu_torch.parallel.mesh import (all_gather, all_reduce,
                                                    axis_size, block_count,
                                                    block_index, permute)
from factormodeling_tpu_torch.solvers.admm_qp import ADMMWarmState

__all__ = ["block_masked_shift", "sharded_simulation"]

_W, _S = "backtest/weights", "solver/iterates"


class _Blocks:
    """A stage's row blocks over ``n`` dates: the mesh axes they lie
    along, their count, this rank's index and its rows."""

    def __init__(self, plan, stage: str, n: int, batch_axis):
        self.plan, self.stage, self.n, self.da = plan, stage, n, batch_axis
        self.axes = plan.row_axes(stage, n, batch_axis)
        self.count = block_count(plan.mesh, self.axes)
        self.index = block_index(plan.mesh, self.axes)
        self.span = plan.row_span(stage, n, batch_axis)
        self.size = self.span.stop - self.span.start

    def rows(self, x):
        """This rank's rows of the ``[k, D/d, N/s]`` block ``x``."""
        return self.plan.rows(x, self.stage, batch_dim=-2,
                              batch_axis=self.da)

    def relayout(self, y, src: str):
        return self.plan.relayout(y, src, self.stage, self.n,
                                  batch_axis=self.da)

    def gather(self, y):
        """Every date of this rank's ``[..., rows]`` series, on every
        rank."""
        return self.plan.gather_rows(y, self.stage, self.n, dim=-1,
                                     batch_axis=self.da)

    def hand_on(self, x, pairs):
        return permute(x, self.plan.mesh, self.axes, pairs)

    def halo(self, x, count: int):
        """The ``count`` rows (dim -2) before this rank's first, fewer at
        the run's start, from the blocks before: a hop a block, each block
        handing on what it received the hop before."""
        # every block takes part in each hop, up to ``count`` rows; the
        # first hop moves only the rows the block after reads
        hops = min(-(-count // self.size), self.count - 1)
        got, cur = [], x[..., x.shape[-2] - min(count, self.size):, :]
        count = min(count, self.span.start)
        for hop in range(hops):
            cur = self.hand_on(x if cur is None else cur,
                               [(b, b + 1) for b in
                                range(hop, self.count - 1)])
            if cur is not None:
                got.insert(0, cur)
        if not count:
            return x[..., :0, :]
        return torch.cat(got, -2)[..., -count:, :]


class _Comm:
    """The parallel scheme's sweeps joined over the row blocks
    (``backtest.mvo.turnover_parallel_blocks``)."""

    def __init__(self, blocks: _Blocks):
        self.blocks = blocks

    def prev_row(self, x):
        """The row before this block of the pass's trajectory (zeros
        before the run)."""
        b = self.blocks
        got = b.hand_on(x, [(i, i + 1) for i in range(b.count - 1)])
        return torch.zeros_like(x) if got is None else got

    def _reduce(self, x, op: str):
        for a in self.blocks.axes:
            x = all_reduce(x, self.blocks.plan.mesh, a, op=op)
        return x

    def max(self, x):
        return self._reduce(x, "max")

    def min(self, x):
        return self._reduce(x, "min")


def _leaves(carry) -> list:
    if isinstance(carry, ADMMWarmState):
        return list(carry)
    return [carry[0], *carry[1]]


def _from_leaves(leaves, like):
    if isinstance(like, ADMMWarmState):
        return ADMMWarmState(*leaves)
    return (leaves[0], ADMMWarmState(*leaves[1:]))


def _packed(carry) -> torch.Tensor:
    """A carry's tensors flattened past the lane axis and joined: one
    hand-off."""
    leaves = _leaves(carry)
    c = leaves[0].shape[0]
    return torch.cat([t.reshape(c, -1) for t in leaves], 1)


def _unpacked(flat: torch.Tensor, like):
    out, at = [], 0
    for t in _leaves(like):
        k = t[0].numel()
        out.append(flat[:, at:at + k].reshape(t.shape))
        at += k
    return _from_leaves(out, like)


def _carry_like(s: SimulationSettings, c: int, n: int, d_total: int, dev):
    """Zeros of the carry a block hands the next: the scan's day-before
    weights and exit state, or plain MVO's ``[C, mvo_batch, ...]`` warm
    history."""
    dt = _mvo.QP_DTYPE
    lead = (c,) if s.method == "mvo_turnover" else (
        c, min(s.mvo_batch, d_total))
    z = torch.zeros(lead + (n,), dtype=dt, device=dev)
    warm = ADMMWarmState(z, z, torch.zeros(lead, dtype=dt, device=dev))
    return (z, warm) if s.method == "mvo_turnover" else warm


def _empty_scheme(signal, c: int):
    """The chooser's stand-in for a QP scheme's outputs: empty tensors of
    their shapes on ``signal``'s (``meta``) device."""
    d, dev = signal.shape[-2], signal.device
    f = torch.empty((c, d), dtype=signal.dtype, device=dev)
    i = torch.empty((c, d), dtype=torch.int32, device=dev)
    b = torch.empty((c, d), dtype=torch.bool, device=dev)
    n = torch.empty((c, d), dtype=torch.int64, device=dev)
    stats = SchemeStats(*(torch.empty(c, dtype=torch.int32, device=dev)
                          for _ in range(4)))
    return (torch.empty_like(signal), n, n, f, b, (b, f, f, i, i, i), stats)


def _solve_rows(blocks: _Blocks, signal, s: SimulationSettings, returns,
                universe, shapes_only: bool):
    """The QP scheme on this rank's solver rows (``signal [C, rows, N]``),
    block after block along the carry (module docs): its seven outputs on
    the rows, the stats the run's."""
    n, c = blocks.n, signal.shape[0]
    parallel = s.method == "mvo_turnover" and s.turnover_mode == "parallel"
    fn = _mvo.mvo_weights if s.method == "mvo" else _mvo.mvo_turnover_weights
    t0 = blocks.span.start
    ret0 = _mvo.block_ret0(s, t0, n)
    # every block takes part in each hop of the halo, up to the most rows
    # any block reads
    need = max(b * blocks.size - _mvo.block_ret0(s, b * blocks.size, n)
               for b in range(blocks.count))
    halo = blocks.halo(returns, need)
    rets = torch.cat([halo[..., halo.shape[-2] - (t0 - ret0):, :], returns],
                     -2)
    s_rows = dataclasses.replace(s, returns=rets, universe=universe)
    rows = _mvo.DateRows(t0, ret0, n)
    like = _carry_like(s, c, signal.shape[-1], n, signal.device)

    if blocks.count > 1 and parallel:
        # the seed and the sweeps, every block at once
        comm = _Comm(blocks)
        if shapes_only:
            for _ in range(s.turnover_sweeps):
                comm.max(comm.prev_row(like[0])[:, 0])
            comm.min(torch.empty(c, dtype=torch.int64,
                                 device=signal.device))
        else:
            fn = _mvo.turnover_parallel_blocks(signal, s_rows, rows, comm)

    def run(carry):
        if shapes_only:
            return _empty_scheme(signal, c), like
        if blocks.count == 1:
            return fn(signal, s_rows), None
        if parallel:
            return fn(carry)
        return fn(signal, s_rows, rows, carry)

    if blocks.count == 1 or not (s.method == "mvo_turnover"
                                 or s.qp_warm_start):
        return run(None)[0]
    carry = out = None
    for b in range(blocks.count):
        if b == blocks.index:
            out, carry = run(carry)
        if b + 1 < blocks.count:
            got = blocks.hand_on(_packed(carry if b == blocks.index
                                         else like), [(b, b + 1)])
            if got is not None:
                carry = _unpacked(got, like)
    return out


def _last_present(x, present, periods: int):
    """Each name's last ``periods`` present values along dim -2, oldest
    first, and which of them exist: ``[..., periods, N]`` each."""
    order, _ = compaction_order(present, axis=-2)
    compact = torch.take_along_dim(x, order, dim=-2)
    pos = (present.sum(-2, keepdim=True) - periods
           + torch.arange(periods, device=x.device)[:, None])
    val = torch.take_along_dim(compact, torch.clamp(pos, min=0), dim=-2)
    return torch.where(pos >= 0, val, float("nan")), pos >= 0


def block_masked_shift(x, present, periods: int, mesh, axes):
    """``masked_shift(x, present, periods)`` along dim -2 of this rank's
    row block of a run cut into row blocks along ``axes``
    (``parallel/mesh.block_index``): a name's values move to its
    ``periods``-th next present date, and the block's first ones come
    from the blocks before: each block's last ``periods`` present values
    a name (``[..., 2 periods, N]``) are gathered and folded in date
    order. Bitwise the shift of the whole run's rows."""
    present = present.expand(x.shape)
    if block_count(mesh, axes) == 1:
        return masked_shift(x, present, periods, axis=-2)
    val, has = _last_present(x, present, periods)
    summary = torch.stack([val, has.to(x.dtype)])[None]
    for a in reversed(axes):
        summary = all_gather(summary, mesh, a, dim=0)
    lead = torch.full_like(val, float("nan"))
    lead_has = torch.zeros_like(has)
    for b in range(block_index(mesh, axes)):
        lead, lead_has = _last_present(
            torch.cat([lead, summary[b, 0]], -2),
            torch.cat([lead_has, summary[b, 1] > 0], -2), periods)
    return masked_shift(torch.cat([lead, x], -2),
                        torch.cat([lead_has, present], -2), periods,
                        axis=-2)[..., periods:, :]


def _pnl(blocks: _Blocks, shifted, s: SimulationSettings):
    """The P&L of this rank's shifted rows and how many leading rows to
    drop: the row before the block (a halo of one row) comes first, on a
    zero-return row."""
    prev = None
    if blocks.count > 1:
        prev = blocks.hand_on(shifted[..., -1, :],
                              [(b, b + 1) for b in range(blocks.count - 1)])
    if prev is None:
        return daily_portfolio_returns(shifted, s), 0
    s_ext = dataclasses.replace(
        s, returns=torch.cat([torch.zeros_like(s.returns[..., :1, :]),
                              s.returns], -2),
        cap_flag=torch.cat([s.cap_flag[..., :1, :], s.cap_flag], -2))
    return daily_portfolio_returns(
        torch.cat([prev[..., None, :], shifted], -2), s_ext), 1


def _stacked_rows(blocks: _Blocks, panels):
    """This rank's rows of the ``[D/d, N/s]`` panel blocks (None stays
    None), in one collective."""
    live = [p for p in panels if p is not None]
    dt = next(p.dtype for p in live if p.dtype != torch.bool)
    got = blocks.rows(torch.stack([p.to(dt) for p in live]))
    out, i = [], 0
    for p in panels:
        if p is not None:
            out.append(got[i] > 0 if p.dtype == torch.bool else got[i])
            i += 1
        else:
            out.append(None)
    return out


def _tree(fn, t):
    if t is None:
        return None
    if isinstance(t, tuple):
        fields = [_tree(fn, x) for x in t]
        return type(t)(*fields) if hasattr(t, "_fields") else tuple(fields)
    return fn(t)


def sharded_simulation(plan: AssetSpecPlan, batch_axis, signal,
                       sig_stage: str, returns, cap_flag, investability,
                       universe, sim_kwargs: dict,
                       shapes_only: bool = False) -> SimulationOutput:
    """The backtest of the blend's rows ``signal`` (``[..., rows, N]`` in
    stage ``sig_stage``'s layout; a leading axis is the lanes, ``[C]``
    knobs in ``sim_kwargs``) on the ``[D/d, N/s]`` panel blocks (module
    docs). Its outputs are the unsharded backtest's, the daily series and
    diagnostics whole on every rank and the shifted weights this rank's
    ``[..., D/d, N/s]`` block."""
    n = returns.shape[-2] * axis_size(plan.mesh, batch_axis)
    s = SimulationSettings(returns=None, cap_flag=None,
                           investability_flag=None, **sim_kwargs)
    if s.degrade is not None:
        raise ValueError("the asset-sharded backtest runs no DegradePolicy "
                         "hold pass; the step gathers its inputs for one")
    lanes = signal.ndim == 3
    sig = signal if lanes else signal[None]
    c = sig.shape[0]
    qp = s.method in ("mvo", "mvo_turnover")
    wb = _Blocks(plan, _W, n, batch_axis)
    if qp:
        sb = _Blocks(plan, _S, n, batch_axis)
        with obs_stage("solver/admm"):
            rets, inv, uni = _stacked_rows(sb, (returns, investability,
                                                universe))
            sig_s = sb.relayout(sig, sig_stage) * inv
            w_s, lc, sc, resid, ok, tele, stats = _solve_rows(
                sb, sig_s, s, rets, uni, shapes_only)
            count_dt = lc.dtype
            series = sb.gather(torch.stack(
                [x.to(torch.float64) for x in (lc, sc, resid, ok, *tele)]))
        with obs_stage(_W):
            rets, cap, uni = _stacked_rows(wb, (returns, cap_flag, universe))
            w = plan.relayout(w_s, _S, _W, n, batch_axis=batch_axis)
    else:
        with obs_stage(_W):
            rets, cap, inv, uni = _stacked_rows(
                wb, (returns, cap_flag, investability, universe))
            sig_w = wb.relayout(sig, sig_stage) * inv
            if s.method == "equal":
                w, lc, sc = equal_weights(sig_w, s.pct)
            else:
                w, lc, sc = linear_weights(sig_w, s.max_weight)
            count_dt = lc.dtype
            stats = SchemeStats(*(torch.zeros(c, dtype=torch.int32,
                                              device=sig.device)
                                  for _ in range(4)))
    with obs_stage(_W):
        present = (torch.ones_like(w, dtype=torch.bool) if uni is None
                   else uni)
        shifted = block_masked_shift(w, present, 1, plan.mesh, wb.axes)
        res, skip = _pnl(wb, shifted, dataclasses.replace(
            s, returns=rets, cap_flag=cap, universe=uni))
        daily = [res.log_return, res.long_return, res.short_return,
                 res.long_turnover, res.short_turnover, res.turnover]
        sums = [torch.clamp(w, min=0.0).sum(-1),
                torch.clamp(w, max=0.0).sum(-1)]
        extra = [] if qp else [lc.to(w.dtype), sc.to(w.dtype)]
        daily = wb.gather(torch.stack([x[..., skip:] for x in daily]
                                      + sums + extra))
        by_name = torch.stack([res.long_pnl_by_name, res.short_pnl_by_name])
        for a in wb.axes:
            by_name = all_reduce(by_name, plan.mesh, a)
        weights = plan.to_block(shifted, _W, n, batch_axis=batch_axis)
    if qp:
        lc, sc, resid, ok = series[0], series[1], series[2], series[3] > 0
        tele = (series[4] > 0, series[5], series[6],
                *(x.to(torch.int32) for x in series[7:10]))
    else:
        lc, sc = daily[8], daily[9]
        resid = torch.full_like(daily[0], float("nan"))
        ok = torch.ones_like(daily[0], dtype=torch.bool)
        zero_i = torch.zeros_like(daily[0], dtype=torch.int32)
        tele = (torch.zeros_like(ok), resid, resid, zero_i, zero_i, zero_i)
    lc, sc = lc.to(count_dt), sc.to(count_dt)
    dt = returns.dtype
    diag = SolverDiagnostics(
        primal_residual=resid.to(dt), solver_ok=ok, long_sum=daily[6],
        short_sum=daily[7], active=(lc > 0) & (sc > 0), polished=tele[0],
        polish_pre_residual=tele[1].to(dt),
        polish_post_residual=tele[2].to(dt), qp_solves=stats.qp_solves,
        sweeps=stats.sweeps, converged_days=stats.converged_days,
        suffix_len=stats.suffix_len, anderson_accepted=tele[3],
        anderson_rejected=tele[4], iters_to_converge=tele[5])
    out = SimulationOutput(
        weights=weights, long_count=lc, short_count=sc,
        result=DailyResult(*daily[:6], by_name[0], by_name[1]),
        diagnostics=diag, degrade=None)
    return out if lanes else _tree(lambda a: a[0], out)
