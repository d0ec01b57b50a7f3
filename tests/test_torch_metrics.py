"""The port's metric table and its incomplete beta against the JAX package
(and scipy), on the CPU in float64 with seeded numpy inputs.

``betainc`` is held over a grid of a in [0.5, 1000] (the t-test's a = df/2
up to ~1000 at D = 2000 dates), b in {1/2, 1, 2.5} and x in [0, 1] with
both ends, at rtol 1e-10 where the value is above 1e-300 (the two
references agree with each other to 3.5e-11 on this grid). The
metric-table functions agree with the JAX ones at 1e-10: the same float64
sums in orders that differ by reassociation and by the order of tied
payloads after a sort.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
from jax.scipy.special import betainc as jax_betainc

from factormodeling_tpu.metrics import daily_factor_stats as jax_daily_stats
from factormodeling_tpu.metrics.factor_metrics import \
    aggregate_metrics as jax_aggregate
from factormodeling_tpu.metrics.factor_metrics import \
    rolling_metrics as jax_rolling_metrics
from factormodeling_tpu.metrics.factor_metrics import \
    single_factor_metrics as jax_single
from factormodeling_tpu_torch.metrics import (METRIC_COLUMNS,
                                              aggregate_metrics,
                                              daily_factor_stats,
                                              rolling_metrics,
                                              single_factor_metrics)
from factormodeling_tpu_torch.metrics._special import betainc
from tests.torch_threads import torch_one_thread  # noqa: F401

TOL = 1e-10


def _grid():
    a = np.concatenate([np.linspace(0.5, 10.0, 12), np.geomspace(10.0, 1000.0,
                                                                 12)])
    x = np.concatenate([np.linspace(0.0, 1.0, 11),
                        np.geomspace(1e-12, 0.1, 5),
                        1.0 - np.geomspace(1e-12, 0.1, 5)])
    aa, xx = np.meshgrid(a, x)
    return aa.ravel(), xx.ravel()


@pytest.mark.parametrize("b", [0.5, 1.0, 2.5])
def test_betainc_matches_jax_and_scipy(b):
    a, x = _grid()
    assert a.size >= 200 and {0.0, 1.0} <= set(x)
    got = betainc(torch.from_numpy(a), b, torch.from_numpy(x)).numpy()
    for want in (scipy.special.betainc(a, b, x),
                 np.asarray(jax_betainc(jnp.asarray(a), b, jnp.asarray(x)))):
        big = want > 1e-300
        np.testing.assert_allclose(got[big], want[big], rtol=TOL, atol=0)
        np.testing.assert_allclose(got[~big], want[~big], rtol=0, atol=1e-300)
    assert np.all(got[x == 0.0] == 0.0) and np.all(got[x == 1.0] == 1.0)


def test_betainc_passes_nan_and_broadcasts():
    x = torch.tensor([0.5, float("nan"), 0.5, 0.25], dtype=torch.float64)
    a = torch.tensor([2.0, 2.0, float("nan"), 665.0], dtype=torch.float64)
    got = betainc(a, 0.5, x)
    assert torch.isnan(got[1:3]).all() and torch.isfinite(got[[0, 3]]).all()
    np.testing.assert_allclose(got[[0, 3]].numpy(),
                               scipy.special.betainc([2.0, 665.0], 0.5,
                                                     [0.5, 0.25]),
                               rtol=TOL)
    assert betainc(torch.tensor(3.0), 0.5, x[:1]).shape == (1,)


def _stack(seed, f=4, d=30, n=25):
    rng = np.random.default_rng(seed)
    ret = rng.normal(scale=0.02, size=(d, n))
    fac = rng.normal(size=(f, d, n))
    fac[:2] += 2.0 * np.roll(ret, 1, axis=0)[None]   # factors that predict
    fac[rng.uniform(size=fac.shape) < 0.08] = np.nan
    fac[3, :, :22] = np.nan                          # few pairs: NaN dates
    ret[rng.uniform(size=ret.shape) < 0.05] = np.nan
    uni = rng.uniform(size=(d, n)) > 0.1
    return fac, ret, uni


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=TOL, equal_nan=True,
                                   err_msg=k)


@pytest.mark.parametrize("with_universe", [False, True])
def test_single_factor_metrics_and_aggregate_match_jax(with_universe):
    fac, ret, uni = _stack(0)
    kw_t = dict(universe=torch.from_numpy(uni)) if with_universe else {}
    kw_j = dict(universe=jnp.asarray(uni)) if with_universe else {}
    got = single_factor_metrics(torch.from_numpy(fac), torch.from_numpy(ret),
                                **kw_t)
    want = jax_single(jnp.asarray(fac), jnp.asarray(ret), **kw_j)
    assert tuple(got) == METRIC_COLUMNS
    _close(got, want)
    assert torch.isfinite(got["factor_return_pvalue"][:3]).all()
    # along the other axis of a [D, F] layout
    daily_t = daily_factor_stats(torch.from_numpy(fac), torch.from_numpy(ret))
    daily_j = jax_daily_stats(jnp.asarray(fac), jnp.asarray(ret))
    _close(aggregate_metrics({k: v.T for k, v in daily_t.items()
                              if k != "n_pairs"}, axis=0),
           jax_aggregate({k: v.T for k, v in daily_j.items()
                          if k != "n_pairs"}, axis=0))


@pytest.mark.parametrize("window", [2, 7, 30])
def test_rolling_metrics_factor_return_group_matches_jax(window):
    fac, ret, uni = _stack(1)
    daily_t = daily_factor_stats(torch.from_numpy(fac), torch.from_numpy(ret),
                                 universe=torch.from_numpy(uni),
                                 stats=("factor_return",))
    daily_j = jax_daily_stats(jnp.asarray(fac), jnp.asarray(ret),
                              universe=jnp.asarray(uni),
                              stats=("factor_return",))
    got = rolling_metrics(daily_t, window)
    assert set(got) == {"factor_return_tstat", "factor_return_pvalue",
                        "pct_pos_factor_return"}
    _close(got, jax_rolling_metrics(daily_j, window))
