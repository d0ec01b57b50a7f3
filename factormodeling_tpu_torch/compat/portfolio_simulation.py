"""The reference ``portfolio_simulation.py`` surface (port of
``factormodeling_tpu/compat/portfolio_simulation.py``): ``SimulationSettings``
and ``Simulation`` over pandas panels, computed by the port's engine.

The class keeps the reference's constructor, ``run()`` side effects
(registering the signal into the shared ``factors_df``, ``:72``; summary /
contributor prints; the dashboard plot) and the "private" methods
multi_manager reaches into (``_daily_trade_list``,
``_daily_portfolio_returns``). ``use_cvxpy`` / ``mvo_solver`` are accepted
for signature parity and ignored: there is one solver (the batched ADMM QP).
The settings' ``device`` (a compat extra; ``None`` is the card,
``"cpu"`` asks for the CPU) says where the engine runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd
import torch

from factormodeling_tpu_torch._device import host_array, resolve_device
from factormodeling_tpu_torch.analytics import PortfolioAnalyzer as _DenseAnalyzer
from factormodeling_tpu_torch.analytics.plots import plot_full_performance
from factormodeling_tpu_torch.backtest import (
    SimulationSettings as _DenseSettings,
    daily_trade_list as _dense_trade_list,
)
from factormodeling_tpu_torch.backtest.diagnostics import (SolverDiagnostics,
                                                           anderson_stats,
                                                           check_anomalies,
                                                           polish_stats,
                                                           sweep_stats)
from factormodeling_tpu_torch.backtest.pnl import (
    daily_portfolio_returns as _dense_pnl,
    signal_metrics as _dense_signal_metrics,
)
from factormodeling_tpu_torch.compat._convert import (PanelVocab,
                                                      _IdentityCache,
                                                      level_values)
from factormodeling_tpu_torch.obs.report import active_report, cost_estimate

__all__ = ["SimulationSettings", "Simulation"]

_RESULT_COLUMNS = ("log_return", "long_return", "short_return",
                   "long_turnover", "short_turnover", "turnover")

# device copies of densified panels, one cache a device, keyed on (series,
# its backing values, vocab) identity: several Simulations over the same
# market Series reuse one upload. ``_values`` is the mutation token (pandas
# copy-on-write swaps the backing array on any in-place write); the small
# maxsize bounds the pinned device memory.
_DEVICE_PANELS: dict[str, _IdentityCache] = {}
# run()'s signal * investability product, keyed on both operands. Consumers
# get a copy (:func:`_cow_safe`): run() assigns the cached product to
# ``self.custom_feature``, and an in-place mutation by one consumer must not
# corrupt the value served to later Simulations over the same inputs.
_MASKED_SIGNALS = _IdentityCache(maxsize=8)


def _panels(dev: torch.device) -> _IdentityCache:
    return _DEVICE_PANELS.setdefault(str(dev), _IdentityCache(maxsize=32))


def _pandas_cow_enabled() -> bool:
    """Whether pandas copy-on-write is active: always from pandas 3 (whose
    option is deprecated), else the ``mode.copy_on_write`` option."""
    if int(pd.__version__.split(".")[0]) >= 3:
        return True
    try:
        return pd.options.mode.copy_on_write is True
    except (AttributeError, KeyError, pd.errors.OptionError):
        return True


def _cow_safe(series: pd.Series) -> pd.Series:
    """A copy the caller may mutate without poisoning the cache it came
    from: shallow under copy-on-write (any write swaps the backing array
    first), deep otherwise. Either way the original index object is kept,
    so the identity-keyed vocab and code caches stay warm."""
    if _pandas_cow_enabled():
        return series.copy(deep=False)
    copy = series.copy(deep=True)
    copy.index = series.index
    return copy


def _device_panel(vocab: PanelVocab, series: pd.Series,
                  dev: torch.device) -> torch.Tensor:
    return _panels(dev).get(
        (series, series._values, vocab),
        lambda: torch.from_numpy(vocab.densify(series)[0]).to(dev))


def _record_sim(name: str, method: str, diag: SolverDiagnostics,
                n_anomalies: int, cost: dict | None) -> None:
    """Contribute one Simulation's counters (and cost row) to the active
    RunReport; the span row is recorded by the caller."""
    rep = active_report()
    if rep is None:
        return
    active = np.asarray(diag.active, bool)
    ok = np.asarray(diag.solver_ok, bool)
    rep.add_counters(f"compat/sim/{name}", {
        "method": method,
        "days": int(active.size),
        "active_days": int(active.sum()),
        "solver_fallback_days": int((active & ~ok).sum()),
        "anomalies": n_anomalies,
        "polish": polish_stats(diag),
        "solver": {**sweep_stats(diag), **anderson_stats(diag)},
    })
    if cost is not None:
        rep.record(f"compat/sim/{name}", kind="cost", **cost)


def _fused_run(sig, uni, s: _DenseSettings, s_full: _DenseSettings):
    """run()'s whole pass as the two-stage compat composition: the trade
    list on the signal's universe, then the P&L on the universe-masked
    weights under the full-grid settings (the arrays the pandas weights
    round trip would rebuild). Everything the host reads per run lands in
    one packed ``[22, D]`` array of the signal's type: counts, the six
    result columns, ten per-day diagnostics and four broadcast
    scheme-telemetry scalars, fetched in one copy."""
    w, lc, sc, diag = _dense_trade_list(sig, s)
    wv = torch.where(uni, w, float("nan"))
    res = _dense_pnl(wv, s_full)
    d = sig.shape[0]

    def row(v):
        return torch.as_tensor(v, device=sig.device).to(sig.dtype).expand(d)

    packed = torch.stack(
        [getattr(res, c) for c in _RESULT_COLUMNS]
        + [row(v) for v in (
            lc, sc, diag.primal_residual, diag.solver_ok, diag.long_sum,
            diag.short_sum, diag.active, diag.polished,
            diag.polish_pre_residual, diag.polish_post_residual,
            diag.qp_solves, diag.sweeps, diag.converged_days,
            diag.suffix_len, diag.anderson_accepted,
            diag.anderson_rejected)])
    return w, res, packed


def _finalize_result(frame: pd.DataFrame, res, symbols: pd.Index,
                     contributor: bool):
    """Shared result-boundary tail of both run paths: the reference's
    date-descending frame (``portfolio_simulation.py:783-790``) and, when
    enabled, the top-10 per-leg contributors (``:792-795``)."""
    frame = (frame.rename_axis("date").reset_index()
             .sort_values("date", ascending=False).reset_index(drop=True))
    if contributor:
        longs = pd.Series(host_array(res.long_pnl_by_name), index=symbols)
        shorts = pd.Series(host_array(res.short_pnl_by_name), index=symbols)
        return frame, longs.nlargest(10), shorts.nlargest(10)
    return frame, None, None


def _unpack(packed: np.ndarray):
    """(result columns dict, lc, sc, SolverDiagnostics) from the packed
    ``[22, D]`` host array."""
    cols = {c: packed[i] for i, c in enumerate(_RESULT_COLUMNS)}
    lc, sc = packed[6], packed[7]

    def scal(r):  # broadcast scheme-telemetry rows back to int scalars
        return int(r[0]) if r.size else 0

    diag = SolverDiagnostics(
        primal_residual=packed[8], solver_ok=packed[9] > 0.5,
        long_sum=packed[10], short_sum=packed[11], active=packed[12] > 0.5,
        polished=packed[13] > 0.5, polish_pre_residual=packed[14],
        polish_post_residual=packed[15],
        qp_solves=scal(packed[16]), sweeps=scal(packed[17]),
        converged_days=scal(packed[18]), suffix_len=scal(packed[19]),
        anderson_accepted=packed[20].astype(np.int64),
        anderson_rejected=packed[21].astype(np.int64))
    return cols, lc, sc, diag


@dataclasses.dataclass
class SimulationSettings:
    """Reference settings dataclass (``portfolio_simulation.py:10-33``),
    pandas panels + identical knobs/defaults, plus the JAX package's compat
    extras and ``device``."""

    returns: pd.Series
    cap_flag: pd.Series
    investability_flag: pd.Series
    factors_df: pd.DataFrame
    method: str = "equal"
    transaction_cost: bool = True
    max_weight: float = 0.03
    pct: float = 0.1
    min_universe: int = 1000    # parity only; the reference never uses it
    contributor: bool = False
    output_summary: bool = False
    output_returns: bool = False
    plot: bool = True
    lookback_period: int = 60
    use_cvxpy: bool = True      # parity only; one solver
    mvo_solver: str = "OSQP"    # parity only
    shrinkage_intensity: float = 0.1
    turnover_penalty: float = 0.1
    return_weight: float = 0.0
    # solver knobs (compat extras; qp_iters=None resolves per scheme)
    qp_iters: int | None = None
    qp_polish: bool = True
    mvo_batch: int = 32
    # mvo_turnover execution scheme: "scan" (the reference's day loop) or
    # "parallel" (the fixed-point sweeps)
    turnover_mode: str = "scan"
    turnover_sweeps: int = 4
    turnover_tol: float = 1e-6
    # MVO covariance source (the reference is sample-only)
    covariance: str = "sample"
    risk_factors: int = 10
    risk_lookback: int = 252
    risk_refit_every: int = 21
    # where the engine runs: None is the card, "cpu" asks for the CPU
    device: str | None = None


class Simulation:
    """Daily long/short simulation of one signal
    (reference ``Simulation``, ``portfolio_simulation.py:35-154``)."""

    def __init__(self, name: str, custom_feature: pd.Series,
                 settings: SimulationSettings):
        self.name = name
        self.custom_feature = custom_feature
        self.settings = settings
        for field in dataclasses.fields(settings):
            setattr(self, field.name, getattr(settings, field.name))
        self._dev = resolve_device(self.device)
        self._vocab = PanelVocab.from_indexes(self.returns.index,
                                              custom_feature.index)

    # ------------------------------------------------------------ internals

    def _dense_settings(self, signal_universe, vocab: PanelVocab | None = None,
                        cache: bool = True) -> _DenseSettings:
        """``cache=False`` for one-off vocabs (the slow path's weights-dates
        grid): their panels are never served again, and inserting them
        would evict the live market panels."""
        vocab = vocab if vocab is not None else self._vocab
        dev = self._dev

        def put(series):
            if cache:
                return _device_panel(vocab, series, dev)
            return torch.from_numpy(vocab.densify(series)[0]).to(dev)

        return _DenseSettings(
            returns=put(self.returns),
            cap_flag=put(self.cap_flag),
            investability_flag=put(self.investability_flag),
            universe=torch.as_tensor(signal_universe).to(dev),
            method=self.method, transaction_cost=self.transaction_cost,
            max_weight=self.max_weight, pct=self.pct,
            min_universe=self.min_universe, contributor=self.contributor,
            lookback_period=self.lookback_period,
            shrinkage_intensity=self.shrinkage_intensity,
            turnover_penalty=self.turnover_penalty,
            return_weight=self.return_weight,
            qp_iters=self.qp_iters, qp_polish=self.qp_polish,
            mvo_batch=self.mvo_batch,
            turnover_mode=self.turnover_mode,
            turnover_sweeps=self.turnover_sweeps,
            turnover_tol=self.turnover_tol,
            covariance=self.covariance, risk_factors=self.risk_factors,
            risk_lookback=self.risk_lookback,
            risk_refit_every=self.risk_refit_every)

    def _signal_dense(self):
        return self._vocab.densify(self.custom_feature)

    # ----------------------------------------------------------- public API

    def run(self):
        """Full backtest (``portfolio_simulation.py:71-94``): registers the
        signal into the shared factors_df (reference side effect),
        simulates, prints/plots per the toggles, returns the result frame
        when ``output_returns`` is set."""
        if self.factors_df is not None:
            self.factors_df[self.name] = self.custom_feature
        raw, inv = self.custom_feature, self.investability_flag
        masked = _MASKED_SIGNALS.get(
            (raw, raw._values, inv, inv._values), lambda: raw * inv)
        # the public attribute gets a mutation-safe copy; the cached object
        # itself feeds densify and the device-panel cache below
        self.custom_feature = _cow_safe(masked)
        sig, uni = self._vocab.densify(masked)
        weights = None
        if bool(uni.any(axis=1).all()):
            # fast path (every vocab date carries a universe cell, so the
            # two-stage pandas weights round trip is the identity): one
            # pass, pandas only at the result boundary
            counts, result, top_longs, top_shorts, w_dense = \
                self._run_fused(sig, uni, masked)
        else:
            weights, counts = self._daily_trade_list()
            result, top_longs, top_shorts = \
                self._daily_portfolio_returns(weights)
            w_dense = None
        analyzer = _DenseAnalyzer(
            {c: result[c].to_numpy() for c in _RESULT_COLUMNS},
            result["date"].to_numpy())

        if self.output_summary:
            if weights is None:
                weights = self._vocab.to_series(host_array(w_dense), uni,
                                                name="weight")
            metrics = self._calculate_metrics(weights, counts)
            summary_df = (pd.DataFrame.from_dict(analyzer.summary(),
                                                 orient="index",
                                                 columns=["Value"])
                          .reset_index().rename(columns={"index": "Metric"}))
            print(metrics.to_string(index=False))
            print(summary_df.to_string(index=False))
        if self.contributor:
            print("Top 10 long leg contributors:", top_longs)
            print("Top 10 short leg contributors:", top_shorts)
        if self.plot:
            plot_full_performance(analyzer,
                                  (counts.index.to_numpy(),
                                   counts["long_count"].to_numpy(),
                                   counts["short_count"].to_numpy()))
        if self.output_returns:
            return result
        return None

    def _run_fused(self, sig: np.ndarray, uni: np.ndarray,
                   masked: pd.Series):
        """One-pass run() body (see :func:`_fused_run`). Valid only when
        every vocab date has a universe cell: then the weights' date set
        equals the vocab's and the pandas round trip between the two stages
        is the identity. ``masked`` is the cached signal * investability
        product (not the copy on ``self.custom_feature``), so the
        device-panel key survives across Simulations."""
        vocab, dev = self._vocab, self._dev
        s = self._dense_settings(uni)
        ones = _panels(dev).get(
            (vocab,),
            lambda: torch.ones(vocab.shape, dtype=torch.bool, device=dev))
        s_full = dataclasses.replace(s, universe=ones)
        sig_dev = _panels(dev).get(
            (masked, masked._values, vocab),
            lambda: torch.from_numpy(sig).to(dev))
        rep = active_report()
        if rep is not None:
            with rep.span(f"compat/sim/{self.name}",
                          method=self.method) as sp:
                w, res, packed = _fused_run(sig_dev, s.universe, s, s_full)
                sp.add(packed)
        else:
            w, res, packed = _fused_run(sig_dev, s.universe, s, s_full)
        cols, lc, sc, diag = _unpack(packed.cpu().numpy())
        msgs = check_anomalies(diag, name=self.name)
        _record_sim(self.name, self.method, diag, len(msgs),
                    cost_estimate(_fused_run) if rep is not None else None)
        dates = pd.Index(vocab.dates, name="date")
        counts = pd.DataFrame({"long_count": lc.astype(int),
                               "short_count": sc.astype(int)}, index=dates)
        result, top_longs, top_shorts = _finalize_result(
            pd.DataFrame(cols, index=dates), res, vocab.symbols,
            self.contributor)
        return counts, result, top_longs, top_shorts, w

    def _daily_trade_list(self):
        """(shifted weights Series, counts DataFrame)
        (``portfolio_simulation.py:96-154``). Weights cover the signal's own
        (date, symbol) cells, already lagged one day per symbol.

        Like the reference, the investability mask is not applied here:
        only ``run()`` pre-masks (``:73``); direct callers (multi_manager)
        trade the raw signal."""
        sig, uni = self._vocab.densify(self.custom_feature)
        s = self._dense_settings(uni)
        w, lc, sc, diag = _dense_trade_list(
            torch.from_numpy(sig).to(self._dev), s)
        # replay the reference's runtime warnings (portfolio_simulation.py:
        # 448-449 leg sums, :452-459 solver fallback) after the pass
        msgs = check_anomalies(diag, name=self.name)
        if active_report() is not None:
            diag_host = SolverDiagnostics(*(host_array(a) for a in diag))
            _record_sim(self.name, self.method, diag_host, len(msgs), None)
        weights = self._vocab.to_series(host_array(w), uni, name="weight")
        sig_dates = pd.Index(
            level_values(self.custom_feature.index, "date", 0).unique())
        date_mask = self._vocab.dates.isin(sig_dates)
        counts = pd.DataFrame(
            {"long_count": host_array(lc)[date_mask].astype(int),
             "short_count": host_array(sc)[date_mask].astype(int)},
            index=pd.Index(self._vocab.dates[date_mask], name="date"))
        return weights, counts

    def _daily_portfolio_returns(self, weights: pd.Series):
        """Result frame sorted date-desc + top-10 contributors when enabled
        (``portfolio_simulation.py:748-797``).

        The turnover diff runs over the dates present in the weights index
        (the reference unstacks the long weights, so a date whose rows were
        all dropped, e.g. an all-zero multimanager day, is skipped by
        ``.diff()`` rather than traded through). The result frame spans the
        union of weight dates and return dates, with 0.0 leg returns and
        NaN turnover where no weights exist (``:763-775``)."""
        w_dates = pd.Index(
            level_values(weights.index, "date", 0).unique()).sort_values()
        vocab = PanelVocab(w_dates, self._vocab.symbols)
        wv, _ = vocab.densify(weights)
        s = self._dense_settings(np.ones(vocab.shape, dtype=bool), vocab,
                                 cache=False)
        res = _dense_pnl(torch.from_numpy(wv).to(self._dev), s)
        result = pd.DataFrame({c: host_array(getattr(res, c))
                               for c in _RESULT_COLUMNS},
                              index=pd.Index(vocab.dates, name="date"))
        r_dates = pd.Index(level_values(self.returns.index, "date",
                                        0).unique())
        all_dates = w_dates.union(r_dates).sort_values()
        if not all_dates.equals(pd.Index(vocab.dates)):
            result = result.reindex(all_dates)
            ret_cols = ["log_return", "long_return", "short_return"]
            result[ret_cols] = result[ret_cols].fillna(0.0)
        return _finalize_result(result, res, vocab.symbols, self.contributor)

    def _calculate_metrics(self, weights: pd.Series,
                           counts: pd.DataFrame) -> pd.DataFrame:
        """Daily-IC / turnover summary frame, in the reference's
        percent-scaled, 2-decimal schema (``portfolio_simulation.py:799-819``)."""
        sig, uni = self._vocab.densify(self.custom_feature)
        wv, _ = self._vocab.densify(weights)
        s = self._dense_settings(uni)
        m = _dense_signal_metrics(torch.from_numpy(sig).to(self._dev),
                                  torch.from_numpy(wv).to(self._dev), s)
        metrics = pd.DataFrame({
            "IC (%)": [float(m["IC"]) * 100],
            "IC_IR (%)": [float(m["IC_IR"]) * 100],
            "IC_Std (%)": [float(m["IC_Std"]) * 100],
            "Avg Turnover (%)": [float(m["Avg Turnover"]) * 100],
        })
        return round(metrics, 2)
