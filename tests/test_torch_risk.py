"""The port's statistical risk model against the JAX package, on the CPU in
float64 with seeded numpy inputs.

``eigh``, ``qr`` and ``svd`` may pick other column signs in the two
packages, so the comparisons are on sign-invariant quantities: the factor
covariance ``B diag(f) B'``, ``factor_var``, ``idio_var``, and PCA's
``components' diag(ev) components``. Randomized PCA draws the JAX
package's sketch (threefry at the same seed), so it runs as it is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu import risk as jax_risk
from factormodeling_tpu_torch import risk
from tests.torch_threads import torch_one_thread  # noqa: F401


def _panel(seed, d=40, n=60, missing=0.1, dead_rows=5):
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=0.01, size=(d, 3)) @ rng.normal(size=(3, n))
    r = base + rng.normal(scale=0.02, size=(d, n))
    r[rng.uniform(size=r.shape) < missing] = np.nan
    r[:dead_rows] = np.nan          # the NaN-padded head of a partial window
    return r


def _cov(b, f):
    return b @ np.diag(f) @ b.T


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("method", ["eigh", "randomized"])
def test_statistical_risk_model_matches_jax(method, refine):
    r = _panel(0)
    got = risk.statistical_risk_model(torch.from_numpy(r), 4, method=method,
                                      refine=refine)
    want = jax_risk.statistical_risk_model(jnp.asarray(r), 4, method=method,
                                           refine=refine)
    np.testing.assert_allclose(
        _cov(got.loadings.numpy(), got.factor_var.numpy()),
        _cov(np.asarray(want.loadings), np.asarray(want.factor_var)),
        atol=1e-9, rtol=0)
    for name in ("factor_var", "idio_var", "mean"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-9, rtol=0, err_msg=name)
    # loadings up to column sign
    gb, wb = got.loadings.numpy(), np.asarray(want.loadings)
    signs = np.sign((gb * wb).sum(0))
    np.testing.assert_allclose(gb * signs, wb, atol=1e-9, rtol=0)


@pytest.mark.parametrize("shape", [(40, 60), (60, 30)])   # dual and primal
def test_pca_matches_jax(shape):
    r = _panel(1, *shape)
    for method in ("eigh", "randomized", "auto"):
        got = risk.pca(torch.from_numpy(r), 3, method=method)
        want = jax_risk.pca(jnp.asarray(r), 3, method=method)
        gc, wc = got.components.numpy(), np.asarray(want.components)
        np.testing.assert_allclose(
            gc.T @ np.diag(got.explained_variance.numpy()) @ gc,
            wc.T @ np.diag(np.asarray(want.explained_variance)) @ wc,
            atol=1e-9, rtol=0, err_msg=method)
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                                   atol=1e-12, rtol=0)


def test_empty_window_gives_the_floor_model():
    """Block 0 of the rolling refits is fit on no rows at all."""
    r = np.full((12, 8), np.nan)
    got = risk.statistical_risk_model(torch.from_numpy(r), 3)
    want = jax_risk.statistical_risk_model(jnp.asarray(r), 3)
    assert torch.isfinite(got.loadings).all()
    np.testing.assert_allclose(got.idio_var.numpy(), np.asarray(want.idio_var))
    assert float(got.factor_var.abs().max()) == 0.0


def test_sketch_is_seeded_and_device_independent():
    a = risk._sketch(50, 7, 3, torch.float64, "cpu")
    b = risk._sketch(50, 7, 3, torch.float32, "cpu")
    assert torch.equal(a, risk._sketch(50, 7, 3, torch.float64, "cpu"))
    assert not torch.equal(a, risk._sketch(50, 7, 4, torch.float64, "cpu"))
    assert a.dtype == torch.float64 and b.dtype == torch.float32
    # the JAX package's draw at each width, to a few ulp (the normal's log
    # is torch's): held in float64 units. The card's draw is held to the
    # CPU's at path 3's sketch shape by chip_smoke.py's draw phase and
    # tests/test_torch_threefry.py::test_card_draws_are_the_cpu_s
    for got, dt in ((a, jnp.float64), (b, jnp.float32)):
        want = np.asarray(jax.random.normal(jax.random.key(3), (50, 7),
                                            dtype=dt))
        eps = np.finfo(want.dtype).eps
        np.testing.assert_allclose(got.numpy(), want, rtol=4 * eps,
                                   atol=4 * eps)


# ------------------------------------------- the rest of the risk module


def _factor_returns(seed, d=40, f=6, missing=0.15):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.01, size=(d, f)) + rng.normal(
        scale=0.005, size=(d, 1))
    x[rng.uniform(size=x.shape) < missing] = np.nan
    x[:3, 1] = np.nan
    return x


def test_ewma_weights_match_jax():
    for d, hl in ((1, 5.0), (30, 10.0), (47, 3.5)):
        got = risk.ewma_weights(d, hl, dtype=torch.float64)
        want = jax_risk.ewma_weights(d, hl, dtype=jnp.float64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-15,
                                   rtol=0)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ddof=0),
    dict(shrinkage=0.3),
    dict(method="ledoit_wolf"),
    dict(method="ledoit_wolf", shrinkage=0.5),
    dict(halflife=10.0),
    dict(halflife=4.0, shrinkage=0.2),
])
def test_factor_covariance_matches_jax(kw):
    x = _factor_returns(3)
    kw = dict(kw)
    hl = kw.pop("halflife", None)
    tw = jw = None
    if hl is not None:
        tw = risk.ewma_weights(x.shape[0], hl, dtype=torch.float64)
        jw = jax_risk.ewma_weights(x.shape[0], hl, dtype=jnp.float64)
    got = risk.factor_covariance(torch.from_numpy(x), weights=tw, **kw)
    want = jax_risk.factor_covariance(jnp.asarray(x), weights=jw, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10,
                               rtol=0, equal_nan=True)


def test_factor_covariance_rejects_what_jax_rejects():
    x = torch.from_numpy(_factor_returns(4))
    with pytest.raises(ValueError, match="observation weights"):
        risk.factor_covariance(x, method="ledoit_wolf",
                               weights=risk.ewma_weights(40, 10.0,
                                                         torch.float64))
    with pytest.raises(ValueError, match="unknown covariance"):
        risk.factor_covariance(x, method="bogus")
    # too few joint observations: NaN, as pandas
    few = np.full((5, 3), np.nan)
    few[0, 0], few[1, 1] = 1.0, 2.0
    got = risk.factor_covariance(torch.from_numpy(few)).numpy()
    want = np.asarray(jax_risk.factor_covariance(jnp.asarray(few)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def _model_pair(seed):
    r = _panel(seed, d=50, n=30, missing=0.05, dead_rows=0)
    got = risk.statistical_risk_model(torch.from_numpy(r), 4, method="eigh")
    want = jax_risk.statistical_risk_model(jnp.asarray(r), 4, method="eigh")
    # the same model on both sides (column signs from eigh may differ):
    # hang the JAX model's arrays on the port's type
    same = risk.RiskModel(*(torch.from_numpy(np.array(a)) for a in want))
    return got, want, same


def test_factored_products_match_jax():
    _, want, same = _model_pair(5)
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 30)) / 30
    np.testing.assert_allclose(
        risk.risk_matvec(same, torch.from_numpy(w)).numpy(),
        np.asarray(jax_risk.risk_matvec(want, jnp.asarray(w))),
        atol=1e-10, rtol=0)
    np.testing.assert_allclose(
        risk.portfolio_variance(same, torch.from_numpy(w)).numpy(),
        np.asarray(jax_risk.portfolio_variance(want, jnp.asarray(w))),
        atol=1e-10, rtol=0)
    full = risk.full_covariance(same).numpy()
    np.testing.assert_allclose(full, np.asarray(jax_risk.full_covariance(want)),
                               atol=1e-10, rtol=0)
    # the factored forms are the dense ones
    np.testing.assert_allclose(
        risk.risk_matvec(same, torch.from_numpy(w)).numpy(), w @ full.T,
        atol=1e-10, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(max_weight=0.2),
    dict(max_weight=0.2, turnover_penalty=0.05, return_weight=0.01,
         prev=True),
    dict(max_weight=0.05),          # infeasible legs: the equal fallback
])
def test_optimal_weights_matches_jax(kw):
    _, want, same = _model_pair(6)
    rng = np.random.default_rng(6)
    signal = rng.normal(size=30)
    signal[[2, 7]] = 0.0
    kw = dict(kw)
    prev = rng.normal(size=30) / 30 if kw.pop("prev", False) else None
    got = risk.optimal_weights(
        same, torch.from_numpy(signal), qp_iters=300,
        prev_weights=None if prev is None else torch.from_numpy(prev), **kw)
    ref = jax_risk.optimal_weights(
        want, jnp.asarray(signal), qp_iters=300,
        prev_weights=None if prev is None else jnp.asarray(prev), **kw)
    assert bool(got[2]) == bool(ref[2])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-10,
                               rtol=0)
    if bool(got[2]):
        w = got[0].numpy()
        assert abs(w[w > 0].sum() - 1.0) < 1e-6
        assert abs(w[w < 0].sum() + 1.0) < 1e-6
        assert np.all(w[[2, 7]] == 0.0)
