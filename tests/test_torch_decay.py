"""The port's decay-window sensitivity sweep against the JAX package's, on the
CPU in float64 with seeded numpy inputs: the decayed signals, the daily
returns of each window's equal-weight backtest, and the annualized return
and Sharpe with their edge cases; on the card (marker ``cuda``), the sweep's
launches of the window-streaming kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu.analytics import batched_ts_decay as jax_batched
from factormodeling_tpu.analytics import decay_sensitivity as jax_sweep
from factormodeling_tpu.analytics.decay import (
    DEFAULT_DECAY_PERIODS as JAX_PERIODS,
)
from factormodeling_tpu.backtest import SimulationSettings as JaxSettings
from factormodeling_tpu_torch.analytics.decay import _annualize
from factormodeling_tpu_torch.ops import _cuda_window as cw
from tests.torch_threads import torch_one_thread  # noqa: F401

WINDOWS = (1, 3, 5, 10)
TOL = 1e-9


def _market(seed, d=60, n=30):
    rng = np.random.default_rng(seed)
    returns = rng.normal(scale=0.02, size=(d, n))
    returns[rng.uniform(size=(d, n)) < 0.03] = np.nan
    signal = rng.normal(size=(d, n))
    signal[rng.uniform(size=(d, n)) < 0.05] = np.nan
    cap = rng.integers(0, 4, size=(d, n)).astype(float)
    invest = np.where(rng.uniform(size=(d, n)) < 0.05, 0.0, 1.0)
    universe = rng.uniform(size=(d, n)) > 0.1
    return returns, signal, cap, invest, universe


def _settings(lib, arrays, device="cpu", **kw):
    returns, _, cap, invest, universe = arrays
    conv = ((lambda a: torch.from_numpy(a).to(device)) if lib is fmt
            else jnp.asarray)
    cls = fmt.SimulationSettings if lib is fmt else JaxSettings
    return cls(returns=conv(returns), cap_flag=conv(cap),
               investability_flag=conv(invest), universe=conv(universe), **kw)


@pytest.mark.parametrize("with_universe", [False, True])
def test_decay_sensitivity_matches_jax(with_universe):
    arrays = _market(0)
    signal, universe = arrays[1], arrays[4]
    kw = dict(method="equal", pct=0.2)
    got = fmt.analytics.decay_sensitivity(
        torch.from_numpy(signal), _settings(fmt, arrays, **kw), WINDOWS,
        universe=torch.from_numpy(universe) if with_universe else None)
    want = jax_sweep(jnp.asarray(signal), _settings(None, arrays, **kw),
                     WINDOWS,
                     universe=jnp.asarray(universe) if with_universe else None)
    assert got.decay_periods == want.decay_periods == WINDOWS
    for name in ("log_return", "annualized_return", "sharpe"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=TOL,
                                   rtol=0, equal_nan=True, err_msg=name)
    assert np.isfinite(got.sharpe.numpy()).all()
    want_decayed = jax_batched(
        jnp.asarray(signal), WINDOWS,
        jnp.asarray(universe) if with_universe else None)
    np.testing.assert_allclose(got.decayed.numpy(), np.asarray(want_decayed),
                               atol=TOL, rtol=0, equal_nan=True)


def test_batched_ts_decay_matches_jax_on_a_stack():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 12))
    x[rng.uniform(size=x.shape) < 0.1] = np.nan
    uni = rng.uniform(size=(40, 12)) > 0.2
    got = fmt.analytics.batched_ts_decay(torch.from_numpy(x), (0, 2, 7),
                                         torch.from_numpy(uni))
    want = jax_batched(jnp.asarray(x), (0, 2, 7), jnp.asarray(uni))
    assert got.shape == (3, 2, 40, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=0, equal_nan=True)


def test_default_decay_periods_match_jax():
    assert fmt.analytics.DEFAULT_DECAY_PERIODS == tuple(JAX_PERIODS)


@pytest.mark.parametrize("d", [252, 126, 300])
def test_annualize_edge_cases_follow_the_numpy_expression(d):
    """A zero product gives -1; a negative product gives a real power for an
    integer exponent 252 / D and NaN for a fractional one; long horizons do
    not overflow."""
    rng = np.random.default_rng(d)
    r = rng.normal(scale=0.01, size=(4, d))
    r[1, 5] = -1.0                      # 1 + r == 0: the product is 0
    r[2, 7] = -1.5                      # one negative factor
    r[3] = 0.05                         # (1.05)**d stays finite in log space
    ann, sharpe = _annualize(torch.from_numpy(r))
    e = 252.0 / d
    with np.errstate(invalid="ignore"):
        want = np.prod(1.0 + r, axis=1) ** e - 1.0
    np.testing.assert_allclose(ann.numpy(), want, rtol=1e-10, equal_nan=True)
    np.testing.assert_allclose(
        sharpe.numpy()[:3],
        r[:3].mean(1) / r[:3].std(1, ddof=1) * np.sqrt(252.0), rtol=1e-12)


@pytest.mark.cuda
def test_decay_sensitivity_on_card_launches_window_kernel():
    """Every window of at least 2 decays through the kernel once; window 1
    takes the op's own path, as in the JAX package; the result equals the
    CPU sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    arrays = _market(2, d=120, n=64)
    kw = dict(method="equal", pct=0.2)
    cpu = fmt.analytics.decay_sensitivity(torch.from_numpy(arrays[1]),
                                          _settings(fmt, arrays, **kw),
                                          WINDOWS)
    before = cw.launches
    card = fmt.analytics.decay_sensitivity(
        torch.from_numpy(arrays[1]).cuda(),
        _settings(fmt, arrays, device="cuda", **kw), WINDOWS)
    assert cw.launches == before + sum(w >= 2 for w in WINDOWS)
    torch.testing.assert_close(card.sharpe.cpu(), cpu.sharpe, atol=1e-9,
                               rtol=0, equal_nan=True)
