"""The port's window/rank primitives, rolling selection and composite blend
against the JAX package, on the CPU in float64 with seeded numpy inputs.

Tolerance 1e-10 throughout: both sides compute the same float64 sums, in
orders that differ only by reassociation (and by the order of tied payloads
after a sort).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.composite import composite_weighted as jax_blend
from factormodeling_tpu.ops._rank import avg_rank as jax_avg_rank
from factormodeling_tpu.ops._rank import masked_quantile as jax_quantile
from factormodeling_tpu.ops._window import masked_shift as jax_masked_shift
from factormodeling_tpu.ops._window import rolling_count as jax_rolling_count
from factormodeling_tpu.ops._window import rolling_sum as jax_rolling_sum
from factormodeling_tpu.ops._window import shift as jax_shift
from factormodeling_tpu.selection import rolling_selection as jax_selection
from factormodeling_tpu_torch.composite import composite_weighted
from factormodeling_tpu_torch.ops._rank import avg_rank, masked_quantile
from factormodeling_tpu_torch.ops._window import (masked_shift, rolling_count,
                                                  rolling_sum, shift)
from factormodeling_tpu_torch.selection import (rolling_selection,
                                                selection_metric_needs)
from tests.torch_threads import torch_one_thread  # noqa: F401

TOL = 1e-10
_PREFIXES = ("alpha", "beta", "gamma")
_SUFFIXES = ("_eq", "_flx", "_long", "_short")


def _names(f):
    return tuple(f"{_PREFIXES[i % 3]}{i // 3}{_SUFFIXES[i % 4]}"
                 for i in range(f))


def _panel(seed, shape, nan=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    x[rng.uniform(size=shape) < nan] = np.nan
    return x


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0, equal_nan=True)


@pytest.mark.parametrize("window", [1, 3, 7])
def test_window_primitives_match_jax(window):
    x = _panel(0, (3, 20, 9))
    present = np.random.default_rng(1).uniform(size=(20, 9)) > 0.2
    xt = torch.from_numpy(x)
    _close(rolling_sum(torch.nan_to_num(xt), window),
           jax_rolling_sum(jnp.nan_to_num(jnp.asarray(x)), window))
    np.testing.assert_array_equal(
        rolling_count(~torch.isnan(xt), window).numpy(),
        np.asarray(jax_rolling_count(~jnp.isnan(jnp.asarray(x)), window)))
    for periods in (1, 2, -1, 25):
        _close(shift(xt, periods), jax_shift(jnp.asarray(x), periods))
        _close(masked_shift(xt, torch.from_numpy(present), periods),
               jax_masked_shift(jnp.asarray(x), jnp.asarray(present), periods))


def test_rank_and_quantile_match_jax():
    x = _panel(2, (6, 40))
    x[0] = np.round(x[0])
    x[1] = np.nan
    x[2, ::2] = -0.0
    _close(avg_rank(torch.from_numpy(x)), jax_avg_rank(jnp.asarray(x)))
    qs = [0.02, 0.1, 0.5, 0.9, 0.98]
    _close(masked_quantile(torch.from_numpy(x), qs),
           jax_quantile(jnp.asarray(x), jnp.asarray(qs)))


def _selection_inputs(seed, f=9, d=40, n=25):
    rng = np.random.default_rng(seed)
    ret = rng.normal(scale=0.02, size=(d, n))
    fac = rng.normal(size=(f, d, n))
    fac[:4] += 3.0 * np.roll(ret, 2, axis=0)[None]   # some predictive factors
    fac[rng.uniform(size=fac.shape) < 0.05] = np.nan
    fr = rng.normal(scale=0.01, size=(d, f))
    uni = rng.uniform(size=(d, n)) > 0.1
    return fac, ret, fr, uni


@pytest.mark.parametrize("method,kwargs", [
    ("icir_top", {}),
    ("icir_top", {"use_rank_icir": False, "top_x": 3}),
    ("icir_top", {"icir_threshold": -1.0, "top_x": 2}),
    ("momentum", {"max_weight": 0.01}),
])
def test_rolling_selection_matches_jax(method, kwargs):
    fac, ret, fr, uni = _selection_inputs(3)
    got = rolling_selection(torch.from_numpy(fac), torch.from_numpy(ret),
                            torch.from_numpy(fr), 8, method=method,
                            method_kwargs=kwargs,
                            universe=torch.from_numpy(uni))
    want = jax_selection(jnp.asarray(fac), jnp.asarray(ret), jnp.asarray(fr),
                         8, method=method, method_kwargs=kwargs,
                         universe=jnp.asarray(uni))
    assert np.asarray(want).sum() > 0     # the case selects something
    _close(got, want)


def test_selection_edge_cases():
    fac, ret, fr, uni = _selection_inputs(4, d=8)
    out = rolling_selection(torch.from_numpy(fac), torch.from_numpy(ret),
                            torch.from_numpy(fr), 8)
    assert out.shape == (8, 9) and not out.any()   # window >= D: nothing runs
    assert selection_metric_needs("icir_top") == ("rank_ic",)
    assert selection_metric_needs("icir_top", {"use_rank_icir": False}) == ("ic",)
    with pytest.raises(ValueError, match="Unknown"):
        selection_metric_needs("nope")


@pytest.mark.parametrize("method", ["zscore", "rank"])
@pytest.mark.parametrize("with_universe", [False, True])
def test_composite_weighted_matches_jax(method, with_universe):
    fac, ret, fr, uni = _selection_inputs(5, f=10)
    names = _names(10)
    rng = np.random.default_rng(6)
    sel = np.where(rng.uniform(size=(40, 10)) < 0.4, rng.uniform(size=(40, 10)),
                   0.0)
    sel[:5] = 0.0                           # days without a selection
    if method == "rank":
        fac = np.nan_to_num(fac)            # scipy-style NaN propagation aside
    u_t = torch.from_numpy(uni) if with_universe else None
    u_j = jnp.asarray(uni) if with_universe else None
    got = composite_weighted(torch.from_numpy(fac), names,
                             torch.from_numpy(sel), method=method, universe=u_t)
    want = jax_blend(jnp.asarray(fac), names, jnp.asarray(sel), method=method,
                     universe=u_j)
    _close(got, want)
