"""The port's host-side backtest reports and analytics against the JAX
package's, on the CPU in float64 with seeded numpy inputs: the diagnostics
reports (``sweep_stats``, ``polish_stats``, ``anderson_stats``,
``check_anomalies``; dicts key for key, messages and warnings string for
string), ``signal_metrics``, ``composite_static``,
``finish_selection_context``, ``quantile_backtest_log``,
``PortfolioAnalyzer``, the matplotlib dashboards under Agg (axes and line
data), and the compat ``composite_factor`` / ``portfolio_analyzer``
modules on the same long-format frames. Values within 1e-12 (the same
float64 arithmetic, reassociated) or exactly.
"""

import warnings

import jax.numpy as jnp
import matplotlib
import numpy as np
import pandas as pd
import pytest
import torch
from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_x64 import torch_float64_module  # noqa: F401

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from factormodeling_tpu import analytics as jax_an  # noqa: E402
from factormodeling_tpu import backtest as jax_bt  # noqa: E402
from factormodeling_tpu.composite import composite_static as jax_static  # noqa: E402
from factormodeling_tpu.compat import composite_factor as jax_cf  # noqa: E402
from factormodeling_tpu.compat import portfolio_analyzer as jax_pa  # noqa: E402
from factormodeling_tpu.selection import (  # noqa: E402
    finish_selection_context as jax_finish)
from factormodeling_tpu_torch import analytics as an  # noqa: E402
from factormodeling_tpu_torch import backtest as bt  # noqa: E402
from factormodeling_tpu_torch.compat import composite_factor as cf  # noqa: E402
from factormodeling_tpu_torch.compat import portfolio_analyzer as pa  # noqa: E402
from factormodeling_tpu_torch.composite import composite_static  # noqa: E402
from factormodeling_tpu_torch.selection import finish_selection_context  # noqa: E402

TOL = 1e-12


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got).astype(float),
                               _np(want).astype(float), atol=tol, rtol=0,
                               equal_nan=True, err_msg=msg)


def _same_dict(got: dict, want: dict, tol=TOL):
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, str):
            assert g == w, k
        elif isinstance(w, (int, np.integer)) and not isinstance(w, bool):
            assert isinstance(g, int) and g == w, k
        else:
            _close(g, w, tol, k)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# ----------------------------------------------------------- diagnostics


def _diag_arrays(seed, d=40, **over):
    rng = np.random.default_rng(seed)
    resid = np.abs(rng.normal(scale=1e-4, size=d))
    resid[:2] = np.nan                               # short-history days
    pre = np.abs(rng.normal(scale=1e-3, size=d))
    pre[rng.uniform(size=d) < 0.3] = np.nan          # no polish attempted
    post = np.where(np.isfinite(pre), pre * rng.uniform(size=d), np.nan)
    post[5] = np.nan                                 # a non-finite candidate
    polished = np.isfinite(post) & (rng.uniform(size=d) < 0.8)
    active = rng.uniform(size=d) > 0.1
    ok = rng.uniform(size=d) > 0.05
    long_sum = 1.0 + rng.normal(scale=1e-7, size=d)
    short_sum = -1.0 + rng.normal(scale=1e-7, size=d)
    long_sum[7] = 0.9                                # a broken leg
    resid[9] = 5e-3                                  # an unconverged day
    active[7] = active[9] = ok[7] = ok[9] = True
    active[10], ok[10] = True, False                 # a fallback day
    arrays = dict(
        primal_residual=resid, solver_ok=ok, long_sum=long_sum,
        short_sum=short_sum, active=active, polished=polished,
        polish_pre_residual=pre, polish_post_residual=post,
        qp_solves=np.int32(3 * d - 7), sweeps=np.int32(2),
        converged_days=np.int32(7), suffix_len=np.int32(d - 7),
        anderson_accepted=rng.integers(0, 5, size=d).astype(np.int32),
        anderson_rejected=rng.integers(0, 2, size=d).astype(np.int32),
        iters_to_converge=np.zeros(d, np.int32))
    arrays.update(over)
    return arrays


def _both_diags(arrays):
    port = bt.SolverDiagnostics(**{k: torch.from_numpy(np.asarray(v))
                                   for k, v in arrays.items()})
    jax = jax_bt.SolverDiagnostics(**{k: jnp.asarray(v)
                                      for k, v in arrays.items()})
    return port, jax


def _anomalies(fn, diag, **kw):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        msgs = fn(diag, **kw)
    return msgs, [str(w.message) for w in seen]


@pytest.mark.parametrize("case", ["mixed", "nothing_attempted", "all_nan",
                                  "empty", "clean"])
def test_diagnostics_reports_match_jax(case):
    d = 40
    nan = np.full(d, np.nan)
    over = {
        "mixed": {},
        # polish off: nothing attempted, accelerator never engaged
        "nothing_attempted": dict(polish_pre_residual=nan,
                                  polish_post_residual=nan,
                                  polished=np.zeros(d, bool),
                                  anderson_accepted=np.zeros(d, np.int32),
                                  anderson_rejected=np.zeros(d, np.int32)),
        # every candidate non-finite, every residual NaN
        "all_nan": dict(polish_post_residual=nan, primal_residual=nan,
                        polished=np.zeros(d, bool)),
        "clean": dict(solver_ok=np.ones(d, bool),
                      long_sum=np.ones(d), short_sum=-np.ones(d),
                      primal_residual=np.full(d, 1e-9)),
    }
    if case == "empty":
        arrays = {k: (v[:0] if np.ndim(v) else v)
                  for k, v in _diag_arrays(0).items()}
        arrays.update(converged_days=np.int32(0))
    else:
        arrays = _diag_arrays(1, d, **over[case])
    port, jax = _both_diags(arrays)
    _same_dict(bt.sweep_stats(port), jax_bt.sweep_stats(jax))
    _same_dict(bt.polish_stats(port), jax_bt.polish_stats(jax))
    _same_dict(bt.anderson_stats(port), jax_bt.anderson_stats(jax))
    for kw in (dict(), dict(name="sig", leg_tol=1e-3, residual_tol=1e-2)):
        got, got_w = _anomalies(bt.check_anomalies, port, **kw)
        want, want_w = _anomalies(jax_bt.check_anomalies, jax, **kw)
        assert got == want and got_w == want_w
        assert bt.check_anomalies(port, warn=False, **kw) == want
    fired = jax_bt.check_anomalies(jax, warn=False)
    assert len(fired) == {"mixed": 3, "clean": 0}.get(case, len(fired))


def test_diagnostics_reports_read_a_port_run(rng):
    """The reports over a real run's record (tensors, the scheme stats as
    0-d tensors) equal the JAX reports over the same arrays."""
    d, n = 20, 10
    returns = rng.normal(scale=0.02, size=(d, n))
    signal = rng.normal(size=(d, n))
    s = bt.SimulationSettings(
        returns=torch.from_numpy(returns),
        cap_flag=torch.ones((d, n), dtype=torch.float64),
        investability_flag=torch.ones((d, n), dtype=torch.float64),
        method="mvo_turnover", lookback_period=6, max_weight=0.5,
        turnover_mode="parallel", mvo_batch=8)
    diag = bt.run_simulation(torch.from_numpy(signal), s).diagnostics
    _, jax = _both_diags({k: v.numpy() for k, v in diag._asdict().items()})
    for fn, jfn in ((bt.sweep_stats, jax_bt.sweep_stats),
                    (bt.polish_stats, jax_bt.polish_stats),
                    (bt.anderson_stats, jax_bt.anderson_stats)):
        _same_dict(fn(diag), jfn(jax))
    assert (bt.check_anomalies(diag, warn=False)
            == jax_bt.check_anomalies(jax, warn=False))


# -------------------------------------------------------- signal_metrics


def test_signal_metrics_matches_jax(rng):
    d, n = 50, 30
    returns = rng.normal(scale=0.02, size=(d, n))
    returns[rng.uniform(size=(d, n)) < 0.05] = np.nan
    signal = rng.normal(size=(d, n)) + 20.0 * returns
    signal[rng.uniform(size=(d, n)) < 0.05] = np.nan
    signal[3] = np.nan                              # a day with no pairs
    weights = rng.normal(scale=0.05, size=(d, n))
    weights[0] = np.nan
    kw = dict(cap_flag=np.ones((d, n)), investability_flag=np.ones((d, n)))
    s = bt.SimulationSettings(returns=torch.from_numpy(returns),
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    j = jax_bt.SimulationSettings(returns=jnp.asarray(returns),
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
    got = bt.signal_metrics(torch.from_numpy(signal),
                            torch.from_numpy(weights), s)
    want = jax_bt.signal_metrics(jnp.asarray(signal), jnp.asarray(weights), j)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], msg=k)
    assert abs(float(got["IC"])) > 0.1


# ------------------------------------------------------ composite_static

_NAMES = ("alpha_eq", "alpha_flx", "beta_long", "beta_short", "gamma_eq",
          "gamma", "delta_flx")


def _stack(rng, f, d, n):
    x = rng.normal(size=(f, d, n))
    x[rng.uniform(size=x.shape) < 0.05] = np.nan
    x[1, 4] = 2.0                                   # a degenerate column-day
    x[4, 6] = np.nan                                # a column-day of no data
    x[2] = np.round(x[2] * 2.0)                     # heavy ties
    return x


@pytest.mark.parametrize("method", ["zscore", "rank"])
@pytest.mark.parametrize("with_universe", [False, True])
def test_composite_static_matches_jax(rng, method, with_universe):
    f, d, n = len(_NAMES), 12, 25
    x = _stack(rng, f, d, n)
    uni = rng.uniform(size=(d, n)) > 0.1 if with_universe else None
    got = composite_static(torch.from_numpy(x), _NAMES, method,
                           None if uni is None else torch.from_numpy(uni))
    want = jax_static(jnp.asarray(x), _NAMES, method,
                      None if uni is None else jnp.asarray(uni))
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    _close(got, want)
    assert np.isfinite(got.numpy()).any()


def test_composite_static_rejects_unknown_method():
    with pytest.raises(ValueError, match="zscore"):
        composite_static(torch.zeros((1, 2, 3)), ("a_eq",), "mean")


# ------------------------------------------------ finish_selection_context


def test_finish_selection_context_matches_jax(rng):
    d, f, window = 40, 6, 10
    fr = rng.normal(scale=0.01, size=(d, f))
    fr[rng.uniform(size=(d, f)) < 0.1] = np.nan
    mw = {k: rng.normal(size=(f, d)) for k in ("IC_IR", "rank_IC_IR")}
    got = finish_selection_context({k: torch.from_numpy(v)
                                    for k, v in mw.items()},
                                   torch.from_numpy(fr), window)
    want = jax_finish({k: jnp.asarray(v) for k, v in mw.items()},
                      jnp.asarray(fr), window)
    assert got.window == want.window == window
    assert list(got.metrics_win) == list(want.metrics_win)
    for k in mw:
        _close(got.metrics_win[k], want.metrics_win[k])
    _close(got.factor_ret, want.factor_ret)
    _close(got.ret_win_sum, want.ret_win_sum)


# ------------------------------------------------------------- quantiles


@pytest.mark.parametrize("n_groups", [5, 3])
@pytest.mark.parametrize("with_universe", [False, True])
def test_quantile_backtest_log_matches_jax(rng, n_groups, with_universe):
    f, d, n = 3, 30, 23
    feat = rng.normal(size=(f, d, n))
    feat[0] = np.round(feat[0])                    # ties, broken by position
    feat[rng.uniform(size=feat.shape) < 0.08] = np.nan
    feat[1, 5] = np.nan                            # a day with no ranks
    rets = rng.normal(scale=0.02, size=(d, n))
    rets[rng.uniform(size=(d, n)) < 0.05] = np.nan
    uni = None
    if with_universe:
        uni = rng.uniform(size=(d, n)) > 0.15      # a ragged universe
    t_uni = None if uni is None else torch.from_numpy(uni)
    j_uni = None if uni is None else jnp.asarray(uni)
    # the leading factor axis, and each factor alone
    for got_in, want_in in ((feat, feat), (feat[2], feat[2])):
        got = an.quantile_backtest_log(torch.from_numpy(got_in),
                                       torch.from_numpy(rets), n_groups,
                                       universe=t_uni)
        want = jax_an.quantile_backtest_log(jnp.asarray(want_in),
                                            jnp.asarray(rets), n_groups,
                                            universe=j_uni)
        for field in want._fields:
            g, w = getattr(got, field), getattr(want, field)
            assert g.shape == w.shape, field
            assert np.array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(w)))
            _close(g, w, msg=field)


# -------------------------------------------------------------- analyzer


def _result(rng, d=300):
    cols = {k: rng.normal(scale=s, size=d) for k, s in (
        ("log_return", 0.01), ("long_return", 0.007), ("short_return", 0.007),
        ("long_turnover", 0.3), ("short_turnover", 0.3))}
    cols["long_turnover"] = np.abs(cols["long_turnover"])
    cols["short_turnover"] = np.abs(cols["short_turnover"])
    cols["turnover"] = cols["long_turnover"] + cols["short_turnover"]
    cols["turnover"][10] = 2.0                     # masked in the dashboard
    dates = pd.bdate_range("2019-12-02", periods=d).to_numpy()
    order = rng.permutation(d)                     # any order; sorted inside
    return {k: v[order] for k, v in cols.items()}, dates[order]


_METRICS = ("average_return", "daily_volatility", "yearly_volatility",
            "annualized_return", "sharpe_ratio", "sortino_ratio",
            "max_drawdown", "max_daily_return", "min_daily_return")


def _same_analyzer(got, want):
    for m in _METRICS:
        g, w = getattr(got, m)(), getattr(want, m)()
        assert isinstance(g, float), m
        _close(g, w, msg=m)
    _close(got.sharpe_ratio(0.02), want.sharpe_ratio(0.02))
    _close(got.sortino_ratio(0.02), want.sortino_ratio(0.02))
    _close(got.max_drawdown_curve(), want.max_drawdown_curve())
    _close(got.cumulative_return, want.cumulative_return)
    for m in ("monthly_return", "yearly_return"):
        (gk, gv), (wk, wv) = getattr(got, m)(), getattr(want, m)()
        np.testing.assert_array_equal(gk, wk)
        _close(gv, wv, msg=m)
    assert got.summary() == want.summary()
    np.testing.assert_array_equal(got.dates, want.dates)


def test_portfolio_analyzer_matches_jax(rng):
    cols, dates = _result(rng)
    # a DailyResult of tensors (the port's) against the JAX package's own
    t_res = bt.DailyResult(**{k: torch.from_numpy(cols.get(k, np.zeros(300)))
                              for k in bt.DailyResult._fields})
    j_res = jax_bt.DailyResult(**{k: jnp.asarray(cols.get(k, np.zeros(300)))
                                  for k in jax_bt.DailyResult._fields})
    _same_analyzer(an.PortfolioAnalyzer(t_res, dates),
                   jax_an.PortfolioAnalyzer(j_res, dates))
    # a mapping, and another year length
    _same_analyzer(an.PortfolioAnalyzer(cols, dates, 260),
                   jax_an.PortfolioAnalyzer(cols, dates, 260))


# ----------------------------------------------------------------- plots


def _figure_data(fig):
    """Per axes: its lines' data and its bars' heights."""
    out = []
    for ax in fig.axes:
        lines = [np.asarray(line.get_xydata(), float) for line in ax.get_lines()]
        bars = [p.get_height() for p in ax.patches]
        out.append((lines, np.asarray(bars, float), ax.get_title()))
    return out


def _same_figures(got, want):
    g, w = _figure_data(got), _figure_data(want)
    assert len(g) == len(w) > 0
    for (gl, gb, gt), (wl, wb, wt) in zip(g, w):
        assert gt == wt
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            _close(a, b)
        _close(gb, wb)


def test_plots_match_jax(rng):
    cols, dates = _result(rng)
    counts = (np.sort(dates), rng.integers(40, 60, size=300),
              rng.integers(40, 60, size=300))
    got = an.plot_full_performance(an.PortfolioAnalyzer(cols, dates), counts)
    want = jax_an.plot_full_performance(jax_an.PortfolioAnalyzer(cols, dates),
                                        counts)
    assert len(got.axes) == 7
    _same_figures(got, want)
    without = {k: cols[k] for k in ("log_return",)}
    _same_figures(an.plot_full_performance(an.PortfolioAnalyzer(without,
                                                                dates)),
                  jax_an.plot_full_performance(
                      jax_an.PortfolioAnalyzer(without, dates)))

    x = _stack(rng, len(_NAMES), 12, 25)
    _same_figures(an.plot_factor_distributions(torch.from_numpy(x), _NAMES,
                                               exclude=["gamma"], ncols=2),
                  jax_an.plot_factor_distributions(x, _NAMES,
                                                   exclude=["gamma"], ncols=2))

    feat = rng.normal(size=(2, 30, 23))
    rets = rng.normal(scale=0.02, size=(30, 23))
    qdates = pd.bdate_range("2021-01-04", periods=30).to_numpy()
    got_q = {f"f{i}": an.quantile_backtest_log(torch.from_numpy(feat[i]),
                                               torch.from_numpy(rets), 4)
             for i in range(2)}
    want_q = {f"f{i}": jax_an.quantile_backtest_log(jnp.asarray(feat[i]),
                                                    jnp.asarray(rets), 4)
              for i in range(2)}
    _same_figures(an.plot_quantile_backtests(got_q, qdates, n_groups=4,
                                             ncols=3),
                  jax_an.plot_quantile_backtests(want_q, qdates, n_groups=4,
                                                 ncols=3))

    periods = (1, 5, 10, 25)
    r = rng.normal(scale=0.01, size=(4, 60))
    ann, sharpe = rng.normal(size=4), rng.normal(size=4)
    sens = an.DecaySensitivity(periods, torch.from_numpy(ann),
                               torch.from_numpy(sharpe), torch.from_numpy(r),
                               torch.zeros((4, 60, 3)))
    j_sens = jax_an.DecaySensitivity(periods, jnp.asarray(ann),
                                     jnp.asarray(sharpe), jnp.asarray(r))
    fig, out = an.plot_decay_sensitivity(None, None, show=False,
                                         sensitivity=sens)
    j_fig, _ = jax_an.plot_decay_sensitivity(None, None, show=False,
                                             sensitivity=j_sens)
    assert out is sens
    _same_figures(fig, j_fig)


# ---------------------------------------------------------------- compat


def _frames(rng, d=30, n=12):
    dates = pd.date_range("2021-01-04", periods=d, freq="B")
    syms = [f"S{i:02d}" for i in range(n)]
    idx = pd.MultiIndex.from_product([dates, syms], names=["date", "symbol"])
    idx = idx[rng.uniform(size=len(idx)) > 0.08]     # a ragged universe
    fac = pd.DataFrame(rng.normal(size=(len(idx), len(_NAMES))), index=idx,
                       columns=list(_NAMES))
    fac = fac.mask(rng.uniform(size=fac.shape) < 0.05)
    ret = pd.Series(rng.normal(scale=0.02, size=len(idx)), index=idx)
    sel = pd.DataFrame(np.abs(rng.normal(size=(d, len(_NAMES)))), index=dates,
                       columns=list(_NAMES))
    sel = sel.where(rng.uniform(size=sel.shape) > 0.3, 0.0).iloc[3:-2]
    return fac, ret, sel


def _same_series(got: pd.Series, want: pd.Series):
    assert got.name == want.name
    assert got.index.equals(want.index)
    _close(got.to_numpy(dtype=float), want.to_numpy(dtype=float))


@pytest.mark.parametrize("method", ["zscore", "rank"])
def test_compat_composite_factor_matches_jax(rng, method):
    fac, ret, sel = _frames(rng)
    chosen = ["alpha_eq", "beta_long", "gamma", "delta_flx"]
    _same_series(cf.composite_factor_calculation(fac, chosen, method,
                                                 device="cpu"),
                 jax_cf.composite_factor_calculation(fac, chosen, method))
    _same_series(cf.weighted_composite_factor(fac, sel, method, device="cpu"),
                 jax_cf.weighted_composite_factor(fac, sel, method))
    if method == "zscore":
        _same_figures(cf.plot_factor_distributions(fac, exclude=["gamma"]),
                      jax_cf.plot_factor_distributions(fac, exclude=["gamma"]))
        _same_figures(cf.plot_quantile_backtests_log(fac[chosen], ret,
                                                     device="cpu"),
                      jax_cf.plot_quantile_backtests_log(fac[chosen], ret))


def test_compat_portfolio_analyzer_matches_jax(rng):
    cols, dates = _result(rng)
    df = pd.DataFrame(dict(cols, date=dates))
    got, want = pa.PortfolioAnalyzer(df), jax_pa.PortfolioAnalyzer(df)
    _same_analyzer(got, want)
    indexed = pd.DataFrame(cols, index=pd.DatetimeIndex(dates))
    _same_analyzer(pa.PortfolioAnalyzer(indexed),
                   jax_pa.PortfolioAnalyzer(indexed))
    counts = pd.DataFrame({"long_count": np.arange(300) % 7,
                           "short_count": np.arange(300) % 5},
                          index=pd.DatetimeIndex(np.sort(dates)))
    _same_figures(got.plot_full_performance(counts),
                  want.plot_full_performance(counts))
    with pytest.raises(ValueError, match="log_return"):
        pa.PortfolioAnalyzer(df.drop(columns="log_return"))

