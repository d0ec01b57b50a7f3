"""The port's multi-manager layer and manager sweep against the JAX
package's, on the CPU in float64 with the same seeded numpy inputs:

- dense ``compute_multimanager_weights`` / ``run_multimanager_backtest``
  (the managers a loop of ``[D, N]`` passes where the JAX package vmaps
  them) with a ragged universe (NaN book cells), a NaN factor weight (0 in
  the book, NaN in that date's counts) and a date without weights;
- the compat ``run_multimanager_backtest`` against the JAX compat's on pandas
  frames, with a factor missing from ``factors_df`` and a factor-weights
  date no manager covers;
- ``manager_sweep`` with C not a multiple of ``combo_batch``, and each combo
  against its own multi-manager backtest with the combo's row as constant
  daily factor weights.

Tolerances: 1e-12 where both sides run the same float64 arithmetic
reassociated (the einsum against a per-manager sum), 1e-10 on the compat
frames (``tests/test_compat_pipeline.py`` holds them at 1e-9 to the oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from factormodeling_tpu import multimanager as jmm
from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu.compat import multi_manager as jax_cmm
from factormodeling_tpu.compat import portfolio_simulation as jax_ps
from factormodeling_tpu.parallel import sweep as jsweep
from factormodeling_tpu_torch import multimanager as tmm
from factormodeling_tpu_torch.backtest import SimulationSettings
from factormodeling_tpu_torch.compat import multi_manager as port_cmm
from factormodeling_tpu_torch.compat import portfolio_simulation as port_ps
from factormodeling_tpu_torch.parallel import sweep as tsweep
from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_x64 import torch_float64_module  # noqa: F401

F, D, N = 4, 30, 16
TOL = 1e-12


def _dense(seed=0):
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(F, D, N))
    factors[rng.uniform(size=factors.shape) < 0.05] = np.nan
    returns = rng.normal(scale=0.02, size=(D, N))
    cap = rng.integers(1, 4, size=(D, N)).astype(float)
    universe = rng.uniform(size=(D, N)) > 0.1
    fw = rng.uniform(size=(D, F))
    fw /= fw.sum(1, keepdims=True)
    fw[7, 2] = np.nan                 # poisons day 7's counts only
    fw[3] = 0.0                       # a date without weights
    return factors, returns, cap, universe, fw


def _settings(arrays, method, **kw):
    _, returns, cap, universe, _ = arrays
    t = SimulationSettings(
        returns=torch.from_numpy(returns), cap_flag=torch.from_numpy(cap),
        investability_flag=torch.ones(D, N, dtype=torch.float64),
        universe=torch.from_numpy(universe), method=method, **kw)
    j = JaxSettings(returns=jnp.asarray(returns), cap_flag=jnp.asarray(cap),
                    investability_flag=jnp.ones((D, N)),
                    universe=jnp.asarray(universe), method=method, **kw)
    return t, j


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float), atol=tol,
                               rtol=0, equal_nan=True, err_msg=what)


@pytest.mark.parametrize("method,kw", [("equal", dict(pct=0.3)),
                                       ("linear", dict(max_weight=0.3))])
def test_dense_multimanager_matches_jax(method, kw):
    arrays = _dense()
    factors, _, _, universe, fw = arrays
    t, j = _settings(arrays, method, **kw)
    got = tmm.run_multimanager_backtest(torch.from_numpy(factors),
                                        torch.from_numpy(fw), t,
                                        device="cpu")
    want = jax.jit(jmm.run_multimanager_backtest)(jnp.asarray(factors),
                                                  jnp.asarray(fw), j)
    _close(got.weights, want.weights, what="weights")
    _close(got.long_count, want.long_count, what="long_count")
    _close(got.short_count, want.short_count, what="short_count")
    for f in got.result._fields:
        _close(getattr(got.result, f), getattr(want.result, f), what=f)
    # the reference's NaN rules
    books, _, _ = tmm.compute_manager_weights(torch.from_numpy(factors), t,
                                              device="cpu")
    assert torch.isnan(books).any()                    # NaN book cells
    assert torch.isfinite(got.weights).all()
    assert bool(torch.isnan(got.long_count[7]))        # the NaN weight
    assert int(torch.isnan(got.long_count).sum()) == 1
    assert float(got.weights[3].abs().sum()) == 0.0    # no weights that day
    # the combined book is the factor-weighted sum of the manager books
    parts = sum(torch.nan_to_num(torch.from_numpy(fw[:, m]))[:, None]
                * torch.nan_to_num(books[m]) for m in range(F))
    _close(got.weights, parts, what="combined vs per-manager sum")


def _compat_frames(seed=1):
    rng = np.random.default_rng(seed)
    dates = pd.date_range("2022-01-03", periods=D, freq="B")
    syms = [f"S{i:02d}" for i in range(N)]
    idx = pd.MultiIndex.from_product([dates, syms], names=["date", "symbol"])
    keep = rng.uniform(size=len(idx)) > 0.1
    idx = idx[keep]
    returns = pd.Series(rng.normal(scale=0.02, size=len(idx)), index=idx)
    cap = pd.Series(rng.integers(1, 4, size=len(idx)).astype(float),
                    index=idx)
    inv = pd.Series(1.0, index=idx)
    names = [f"f{i}" for i in range(F)]
    factors = pd.DataFrame(rng.normal(size=(len(idx), F)), index=idx,
                           columns=names)
    factors = factors.mask(rng.uniform(size=factors.shape) < 0.05)
    extra = dates[-1] + pd.offsets.BDay(1)          # a date no manager covers
    fw = pd.DataFrame(rng.uniform(size=(D + 1, 3)),
                      index=pd.Index(list(dates) + [extra], name="date"),
                      columns=["f0", "f2", "missing"])
    fw.iloc[5, 0] = np.nan
    fw = fw.div(fw.sum(axis=1), axis=0)
    return factors, returns, cap, inv, fw, extra


def test_compat_multimanager_matches_jax_compat(caplog):
    factors, returns, cap, inv, fw, extra = _compat_frames()

    def run(mod, ps, **extra_kw):
        settings = ps.SimulationSettings(
            returns=returns, cap_flag=cap, investability_flag=inv,
            factors_df=factors, method="equal", pct=0.3, plot=False,
            contributor=True, **extra_kw)
        return mod.run_multimanager_backtest(factors, returns, cap, fw,
                                             settings)

    got = run(port_cmm, port_ps, device="cpu")
    assert "Factor missing not in factors_df" in caplog.text
    want = run(jax_cmm, jax_ps)
    res_p, tl_p, ts_p, counts_p = got
    res_j, tl_j, ts_j, counts_j = want
    assert list(res_p.columns) == list(res_j.columns)
    assert res_p["date"].tolist() == res_j["date"].tolist()
    for col in res_p.columns[1:]:
        _close(res_p[col], res_j[col], 1e-10, col)
    for a, b in ((tl_p, tl_j), (ts_p, ts_j)):
        assert a.index.equals(b.index)
        _close(a, b, 1e-10, "contributors")
    assert counts_p.index.equals(counts_j.index)
    _close(counts_p.to_numpy(), counts_j.to_numpy(), 1e-10, "counts")
    assert counts_p.loc[extra].tolist() == [0.0, 0.0]
    assert np.isnan(counts_p.iloc[5]["long_count"])


def _combos(c, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, F, size=(c, 3))


def test_manager_sweep_matches_jax():
    arrays = _dense(3)
    factors = arrays[0]
    t, j = _settings(arrays, "equal", pct=0.3)
    combos = _combos(11)                            # 11 = 2 * 4 + 3
    cw_t = tsweep.combo_weight_matrix(combos, F, device="cpu")
    cw_j = jsweep.combo_weight_matrix(combos, F)
    assert cw_t.dtype == torch.float32
    np.testing.assert_array_equal(cw_t.numpy(), np.asarray(cw_j))
    got = tsweep.manager_sweep(torch.from_numpy(factors), cw_t, t,
                               combo_batch=4, device="cpu")
    want = jax.jit(lambda f, w, s: jsweep.manager_sweep(f, w, s,
                                                        combo_batch=4))(
        jnp.asarray(factors), cw_j, j)
    for f in got._fields:
        _close(getattr(got, f), getattr(want, f), what=f)
    assert got.log_return.shape == (11, D)
    assert got.log_return.dtype == torch.float64    # the books' type


def test_each_combo_equals_its_own_multimanager_backtest():
    arrays = _dense(4)
    factors = torch.from_numpy(arrays[0])
    t, _ = _settings(arrays, "equal", pct=0.3)
    combos = _combos(7, seed=5)
    cw = tsweep.combo_weight_matrix(combos, F, device="cpu")
    out = tsweep.manager_sweep(factors, cw, t, combo_batch=3, device="cpu")
    for c in range(len(combos)):
        fw = cw[c].to(torch.float64).expand(D, F)
        one = tmm.run_multimanager_backtest(factors, fw, t, device="cpu")
        _close(out.log_return[c], one.result.log_return, what=f"combo {c}")
        _close(out.turnover[c], one.result.turnover, what=f"combo {c}")


def test_dense_entry_points_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error; a card is present")
    arrays = _dense()
    t, _ = _settings(arrays, "equal")
    factors = torch.from_numpy(arrays[0])
    fw = torch.from_numpy(arrays[4])
    for call in (lambda: tmm.run_multimanager_backtest(factors, fw, t),
                 lambda: tsweep.combo_weight_matrix(_combos(3), F),
                 lambda: tsweep.manager_sweep(factors, fw.T[:2], t)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="input on cpu"):
        tmm.run_multimanager_backtest(factors, fw, t, device="meta")
