"""The port's compat ``Simulation`` against the JAX package's compat layer,
on the CPU in float64 on the same pandas inputs: ``run()`` for ``equal``,
``linear``, ``mvo`` and ``mvo_turnover`` on the fast path (every vocab date
carries a universe cell: one pass) and on a ragged panel that takes the
slow path (a returns date no signal cell covers: the two-stage pandas round
trip), with ``output_returns``, ``output_summary`` (the metrics frame),
``contributor`` (top 10) and the ``factors_df`` side effect; the masked-
signal cache under a consumer's in-place mutation; and
``compat.decay.decay_sensitivity``. Tolerances are
``tests/test_compat_pipeline.py``'s: 1e-10 where both sides run the same
float64 arithmetic reassociated, 1e-8 on results of the QP schemes (their
weights hold to the JAX package's 1e-6 solver pin).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from factormodeling_tpu.compat import decay as jax_decay
from factormodeling_tpu.compat import portfolio_simulation as jax_ps
from factormodeling_tpu_torch.compat import decay as port_decay
from factormodeling_tpu_torch.compat import portfolio_simulation as port_ps

D, N = 30, 24
METHODS = {
    "equal": dict(pct=0.3),
    "linear": dict(max_weight=0.25),
    "mvo": dict(lookback_period=8, max_weight=0.4, qp_iters=80),
    "mvo_turnover": dict(lookback_period=8, max_weight=0.4),
}
TOL = {"equal": 1e-10, "linear": 1e-10, "mvo": 1e-8, "mvo_turnover": 1e-8}
W_TOL = {"equal": 1e-10, "linear": 1e-10, "mvo": 1e-6, "mvo_turnover": 1e-6}


def _long(arr, keep, dates, syms):
    idx = pd.MultiIndex.from_product([dates, syms], names=["date", "symbol"])
    return pd.Series(arr.ravel(), index=idx)[keep.ravel()]


def _market(seed, ragged: bool):
    """(returns, cap, invest, signal) long Series. ``ragged`` drops one date
    from the signal and the investability flag, so the returns carry a date
    with no universe cell (the slow path)."""
    rng = np.random.default_rng(seed)
    dates = pd.date_range("2021-01-04", periods=D, freq="B")
    syms = [f"S{i:02d}" for i in range(N)]
    keep = rng.uniform(size=(D, N)) > 0.1
    keep[:, :2] = True
    ret = _long(rng.normal(scale=0.02, size=(D, N)), keep, dates, syms)
    cap = _long(rng.integers(1, 4, size=(D, N)).astype(float), keep, dates,
                syms)
    inv = _long(np.where(rng.uniform(size=(D, N)) < 0.05, 0.0, 1.0), keep,
                dates, syms)
    sig_vals = rng.normal(size=(D, N))
    sig_vals[rng.uniform(size=(D, N)) < 0.06] = np.nan
    sig = _long(sig_vals, keep, dates, syms).rename("sig")
    if ragged:
        gone = sig.index.get_level_values("date") == dates[13]
        sig, inv = sig[~gone], inv[~gone]
    return ret, cap, inv, sig


def _settings(mod, market, method, factors_df=None, **extra):
    ret, cap, inv, _ = market
    if mod is port_ps:
        extra["device"] = "cpu"
    return mod.SimulationSettings(
        returns=ret, cap_flag=cap, investability_flag=inv,
        factors_df=factors_df, method=method, plot=False,
        output_returns=True, **METHODS[method], **extra)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float), atol=tol,
                               rtol=0, equal_nan=True, err_msg=what)


def _same_series(got: pd.Series, want: pd.Series, tol, what):
    assert got.index.equals(want.index), what
    assert got.name == want.name, what
    _close(got.to_numpy(), want.to_numpy(), tol, what)


def _run(mod, market, method, ragged, capsys):
    """One Simulation.run() with every output toggle, and what it leaves:
    (result frame, printed text, factors_df, sim)."""
    factors_df = pd.DataFrame({"other": market[3] * 2.0})
    settings = _settings(mod, market, method, factors_df=factors_df,
                         output_summary=True, contributor=True)
    sim = mod.Simulation("sig2", market[3], settings)
    fast = bool(sim._vocab.densify(market[3] * market[2])[1]
                .any(axis=1).all())
    assert fast is not ragged
    capsys.readouterr()
    result = sim.run()
    return result, capsys.readouterr().out, factors_df, sim


@pytest.mark.parametrize("ragged", [False, True], ids=["fast", "slow"])
@pytest.mark.parametrize("method", list(METHODS))
def test_simulation_run_matches_jax_compat(method, ragged, capsys):
    market = _market(0 if method in ("equal", "linear") else 1, ragged)
    got, out_p, fdf_p, sim_p = _run(port_ps, market, method, ragged, capsys)
    want, out_j, fdf_j, sim_j = _run(jax_ps, market, method, ragged, capsys)
    tol = TOL[method]

    # output_returns: the reference's date-descending frame
    assert list(got.columns) == list(want.columns)
    assert got["date"].tolist() == want["date"].tolist()
    for col in got.columns[1:]:
        _close(got[col], want[col], tol, col)
    assert np.isfinite(got["log_return"].to_numpy()).all()
    if ragged:   # the uncovered date trades nothing
        assert (got["log_return"] == 0.0).sum() >= 1

    # the factors_df side effect: the raw signal under the sim's name
    assert list(fdf_p.columns) == list(fdf_j.columns) == ["other", "sig2"]
    _same_series(fdf_p["sig2"], fdf_j["sig2"], 0.0, "factors_df")

    # the weights, counts, metrics frame and contributors behind the prints
    w_p, c_p = sim_p._daily_trade_list()
    w_j, c_j = sim_j._daily_trade_list()
    _same_series(w_p, w_j, W_TOL[method], "weights")
    assert c_p.index.equals(c_j.index)
    np.testing.assert_array_equal(c_p.to_numpy(), c_j.to_numpy())
    m_p = sim_p._calculate_metrics(w_p, c_p)
    m_j = sim_j._calculate_metrics(w_j, c_j)
    assert list(m_p.columns) == list(m_j.columns)
    _close(m_p.to_numpy(), m_j.to_numpy(), 0.0 if tol < 1e-9 else 0.011,
           "metrics frame")
    assert "IC (%)" in out_p and "Sharpe Ratio" in out_p
    assert "Top 10 long leg contributors" in out_p
    _, tl_p, ts_p = sim_p._daily_portfolio_returns(w_p)
    _, tl_j, ts_j = sim_j._daily_portfolio_returns(w_j)
    assert len(tl_p) == min(10, N)
    _same_series(tl_p, tl_j, tol, "top longs")
    _same_series(ts_p, ts_j, tol, "top shorts")
    assert len(out_p.splitlines()) == len(out_j.splitlines())


def test_consumer_mutation_does_not_poison_a_second_simulation():
    ret, cap, inv, sig = _market(2, ragged=False)
    market = (ret, cap, inv, sig)
    sim1 = port_ps.Simulation("a", sig, _settings(port_ps, market, "equal"))
    out1 = sim1.run()
    sim1.custom_feature.iloc[:] = 123.0          # in place, through the copy
    sim2 = port_ps.Simulation("b", sig, _settings(port_ps, market, "equal"))
    out2 = sim2.run()
    assert not np.allclose(sim2.custom_feature.to_numpy(float), 123.0,
                           equal_nan=True)
    np.testing.assert_array_equal(out1["log_return"].to_numpy(),
                                  out2["log_return"].to_numpy())
    assert (sim1.custom_feature.to_numpy(float) == 123.0).all()


def test_decay_sensitivity_matches_jax_compat():
    market = _market(3, ragged=False)
    periods = [1, 3, 6]
    got = port_decay.decay_sensitivity(
        market[3], _settings(port_ps, market, "equal"), periods)
    want = jax_decay.decay_sensitivity(
        market[3], _settings(jax_ps, market, "equal"), periods)
    assert list(got.index) == periods and got.index.name == "decay_window"
    assert list(got.columns) == list(want.columns)
    _close(got.to_numpy(), want.to_numpy(), 1e-10, "decay sensitivity")


def test_compat_simulation_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error; a card is present")
    market = _market(4, ragged=False)
    settings = _settings(port_ps, market, "equal")
    settings.device = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ps.Simulation("x", market[3], settings)
