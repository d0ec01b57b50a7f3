"""The port's covariance-based factor selection against the JAX package, on
the CPU in float64 with seeded numpy inputs: the Ledoit-Wolf shrinkage and
the pairwise-complete covariance, the dense ADMM QP, and the mvo, pca and
regression selectors through ``rolling_selection``.

Tolerance 1e-10 throughout: the same float64 arithmetic in orders that
differ by reassociation (the QP's 100-500 iterations contract, so its
rounding does not grow). The selectors take no warm start, so their
weights do not depend on ``batch_size`` (held at 1e-12: only the batched
linear algebra's blocking changes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.selection import rolling_selection as jax_selection
from factormodeling_tpu.selection.shrinkage import \
    ledoit_wolf_shrinkage as jax_lw
from factormodeling_tpu.selection.shrinkage import \
    masked_pairwise_cov as jax_pairwise
from factormodeling_tpu.solvers import BoxQPProblem as JaxProblem
from factormodeling_tpu.solvers import admm_solve_dense as jax_dense
from factormodeling_tpu_torch.selection import (ledoit_wolf_shrinkage,
                                                masked_pairwise_cov,
                                                rolling_selection,
                                                selection_metric_needs)
from factormodeling_tpu_torch.solvers import BoxQPProblem, admm_solve_dense

TOL = 1e-10


def _returns(seed, t=30, f=7, nan=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.01, size=(t, f)) + 0.002 * rng.normal(size=(t, 1))
    x[rng.uniform(size=x.shape) < nan] = np.nan
    return x


def test_ledoit_wolf_matches_jax_one_window_and_batched():
    wins = np.stack([_returns(s) for s in range(3)])
    wins[2, :, 3] = 0.0                  # a zero-variance column
    got = ledoit_wolf_shrinkage(torch.from_numpy(wins)).numpy()
    for i in range(3):
        want = np.asarray(jax_lw(jnp.asarray(wins[i])))
        np.testing.assert_allclose(got[i], want, atol=TOL, rtol=0)
        np.testing.assert_allclose(
            ledoit_wolf_shrinkage(torch.from_numpy(wins[i])).numpy(), want,
            atol=TOL, rtol=0)


def test_masked_pairwise_cov_matches_jax():
    x = _returns(4, t=25, nan=0.2)
    x[:-1, 5] = np.nan                  # one observation: NaN pairs
    got = masked_pairwise_cov(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_pairwise(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0, equal_nan=True)
    assert np.isnan(got[5]).all()
    batched = masked_pairwise_cov(torch.from_numpy(np.stack([x, x])))
    np.testing.assert_array_equal(np.isnan(batched[1].numpy()), np.isnan(got))


def _qp(seed, f=8):
    rng = np.random.default_rng(seed)
    r = _returns(seed, f=f)
    p = 2.0 * np.cov(r.T)
    kw = dict(q=-r.mean(0) - 0.001 * rng.normal(size=f), lo=np.zeros(f),
              hi=np.full(f, 0.35), E=np.ones((1, f)), b=np.ones(1),
              center=np.full(f, 1.0 / f))
    return p, kw


@pytest.mark.parametrize("l1,polish", [(0.0, True), (0.02, True),
                                       (0.02, False)])
def test_admm_solve_dense_matches_jax(l1, polish):
    p, kw = _qp(int(l1 * 100) + polish)
    want = jax_dense(jnp.asarray(p), JaxProblem(
        **{k: jnp.asarray(v) for k, v in kw.items()}, l1=jnp.asarray(l1)),
        iters=150, polish=polish)
    got = admm_solve_dense(torch.from_numpy(p), BoxQPProblem(
        **{k: torch.from_numpy(v) for k, v in kw.items()}, l1=l1),
        iters=150, polish=polish)
    # the iterates; not the exit dual and rho: once converged, the residual
    # balancing reads residuals at rounding level, so those two part at
    # ~1e-8 relative while x and z agree
    for name in ("x", "z"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=TOL,
                                   rtol=0, err_msg=name)
    assert bool(got.polished) == bool(want.polished)
    # the same problem as lane 1 of a batch beside another
    p2, kw2 = _qp(9)
    lanes = admm_solve_dense(
        torch.from_numpy(np.stack([p2, p])),
        BoxQPProblem(**{k: torch.from_numpy(np.stack([kw2[k], v]))
                        for k, v in kw.items()}, l1=l1),
        iters=150, polish=polish)
    np.testing.assert_allclose(lanes.x[1].numpy(), got.x.numpy(), atol=1e-12,
                               rtol=0)


def test_admm_solve_dense_takes_the_reference_kernel_only():
    p, kw = _qp(0)
    prob = BoxQPProblem(**{k: torch.from_numpy(v) for k, v in kw.items()},
                        l1=0.0)
    with pytest.raises(ValueError, match="low-rank"):
        admm_solve_dense(torch.from_numpy(p), prob, kernel="fused")


def _inputs(seed, f=7, d=36, n=20):
    rng = np.random.default_rng(seed)
    ret = rng.normal(scale=0.02, size=(d, n))
    fac = rng.normal(size=(f, d, n))
    fr = rng.normal(scale=0.01, size=(d, f)) + 0.002 * rng.normal(size=(d, 1))
    fr[:, :3] += 0.003
    fr[5, 2] = np.nan                   # a hole: NaN windows fall back to 0
    uni = rng.uniform(size=(d, n)) > 0.1
    return fac, ret, fr, uni


def _select(method, kw, module="torch", seed=5):
    fac, ret, fr, uni = _inputs(seed)
    if module == "torch":
        return rolling_selection(torch.from_numpy(fac), torch.from_numpy(ret),
                                 torch.from_numpy(fr), 8, method=method,
                                 method_kwargs=kw,
                                 universe=torch.from_numpy(uni)).numpy()
    return np.asarray(jax_selection(jnp.asarray(fac), jnp.asarray(ret),
                                    jnp.asarray(fr), 8, method=method,
                                    method_kwargs=kw,
                                    universe=jnp.asarray(uni)))


@pytest.mark.parametrize("method,kw", [
    ("mvo", {"qp_iters": 100}),
    ("mvo", {"qp_iters": 100, "use_shrinkage": False, "max_weight": 0.3}),
    ("pca", {}),
    ("pca", {"use_shrinkage": False}),
    ("regression", {}),
    ("regression", {"use_shrinkage": False, "ridge": 1e-2}),
])
def test_covariance_selectors_match_jax(method, kw):
    got = _select(method, kw)
    want = _select(method, kw, module="jax")
    assert want.sum() > 0
    if kw.get("use_shrinkage", True):
        assert not got[8:14].any()   # windows holding the NaN give 0
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert selection_metric_needs(method, kw) == ()


@pytest.mark.parametrize("method,extra", [("mvo", {"qp_iters": 60}),
                                          ("pca", {}), ("regression", {})])
def test_covariance_selectors_do_not_depend_on_batch_size(method, extra):
    runs = [_select(method, dict(extra, batch_size=b)) for b in (1, 7, 64)]
    for other in runs[1:]:
        np.testing.assert_allclose(other, runs[0], atol=1e-12, rtol=0)
