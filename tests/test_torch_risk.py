"""The port's statistical risk model against the JAX package, on the CPU in
float64 with seeded numpy inputs.

``eigh``, ``qr`` and ``svd`` may pick other column signs in the two
packages, so the comparisons are on sign-invariant quantities: the factor
covariance ``B diag(f) B'``, ``factor_var``, ``idio_var``, and PCA's
``components' diag(ev) components``. Randomized PCA's sketch is
``jax.random`` in the JAX package, which torch cannot reproduce; the tests
swap the JAX draw into the port's one sketch function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu import risk as jax_risk
from factormodeling_tpu_torch import risk


def _panel(seed, d=40, n=60, missing=0.1, dead_rows=5):
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=0.01, size=(d, 3)) @ rng.normal(size=(3, n))
    r = base + rng.normal(scale=0.02, size=(d, n))
    r[rng.uniform(size=r.shape) < missing] = np.nan
    r[:dead_rows] = np.nan          # the NaN-padded head of a partial window
    return r


@pytest.fixture
def jax_sketch(monkeypatch):
    """Replace the port's sketch with the JAX package's draw."""
    def sketch(n, l, seed, dtype, device):
        q = jax.random.normal(jax.random.key(seed), (n, l), dtype=jnp.float64)
        return torch.tensor(np.asarray(q), dtype=dtype, device=device)
    monkeypatch.setattr(risk, "_sketch", sketch)


def _cov(b, f):
    return b @ np.diag(f) @ b.T


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("method", ["eigh", "randomized"])
def test_statistical_risk_model_matches_jax(method, refine, jax_sketch):
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
def test_pca_matches_jax(shape, jax_sketch):
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
    assert torch.equal(a.float(), b)
