"""The port's threefry streams (``factormodeling_tpu_torch.threefry``) and
its seeded draws against ``jax.random`` and the JAX package, on the CPU.

The suite runs JAX with x64 on, so the draws here are float64/int64 (the
float32/int32 ones are held in the x64-off child of
``tests/test_torch_f32_jax.py``); the module runs torch at the float64
default, the port's counterpart of that flag. Bitwise means equal bit
patterns, NaN included.

- keys: ``seed_key``, ``fold_in``, ``split`` and ``lane_key`` (every lane);
- ``random_bits`` (32 and 64), ``uniform`` with and without bounds,
  ``randint`` (spans 1, 3, 1332), each bitwise on seeds 0, 1, 7, 2**31 - 1
  and one above 2**32, shapes ``()`` to one odd size above 2**16, a
  chunked draw against the unchunked one, and a batch of keys against each
  key's own draw (on the card: its draws against the CPU's);
- ``normal`` within ``NORMAL_ULP`` of ``jax.random.normal`` (its ``log``
  above ``log1p``'s rational range is torch's);
- end to end at the same seed, with no seam: ``inject`` and
  ``inject_universe`` under every fault class, the scenario families'
  draws (bootstrap indices, the regime break and intensity, one path's
  and a dispatch's, the adversarial schedule and masks), randomized PCA
  and a risk model whose ``method="auto"`` picks the randomized form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu import resil as jresil
from factormodeling_tpu import risk as jrisk
from factormodeling_tpu import rng as jrng
from factormodeling_tpu import scenarios as jsc
from factormodeling_tpu_torch import resil, risk, rng, scenarios
from factormodeling_tpu_torch import threefry as tf
from factormodeling_tpu_torch.resil import faults
from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_x64 import torch_float64_module  # noqa: F401

SEEDS = (0, 1, 7, 2**31 - 1, 2**33 + 5)
#: the last is odd and above 2**16 elements
SHAPES = ((), (1,), (7,), (5, 7, 3), (263, 257))
SPANS = (1, 3, 1332)
BOUNDS = ((0.0, 1.0), (-2.5, 3.7))
#: the most ulps a normal draw may part from JAX's
NORMAL_ULP = 4


def _keys(seed):
    return tf.seed_key(seed), jax.random.PRNGKey(seed)


def _key_tuple(jkey) -> tuple:
    return tuple(int(v) for v in np.asarray(jkey).astype(np.int64))


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def ulps(got, want) -> int:
    """The largest distance in units in the last place between two float
    arrays of one type."""
    got, want = np.asarray(got), np.asarray(want)
    it = {4: np.int32, 8: np.int64}[got.dtype.itemsize]
    a = got.view(it).astype(np.int64)
    b = want.view(it).astype(np.int64)
    # the sign-magnitude bits onto one ordered line
    a = np.where(a < 0, np.iinfo(it).min - a, a)
    b = np.where(b < 0, np.iinfo(it).min - b, b)
    return int(np.abs(a - b).max(initial=0))


# ------------------------------------------------------------------ keys


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_key_fold_in_and_split_are_jax_s(seed):
    key, jkey = _keys(seed)
    assert key == _key_tuple(jkey)
    for data in (0, 1, 7919, 2**32 - 1):
        assert tf.fold_in(key, data) == _key_tuple(
            jax.random.fold_in(jkey, data))
    for num in (2, 3):
        assert list(tf.split(key, num)) == [
            _key_tuple(k) for k in jax.random.split(jkey, num)]


@pytest.mark.parametrize("name", sorted(jrng.LANES))
def test_lane_key_is_jax_s_for_every_lane(name):
    assert rng.LANES == jrng.LANES
    for seed in SEEDS[:4]:
        for ix in ((), (2,), (0, 5)):
            assert rng.lane_key(name, seed, *ix) == _key_tuple(
                jrng.lane_key(name, seed, *ix))


# ----------------------------------------------------------------- draws


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_are_jax_s(seed, shape):
    key, jkey = _keys(seed)
    b32 = tf.random_bits(key, 32, shape, device="cpu")
    assert np.array_equal(b32.numpy(), np.asarray(
        jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64))
    b64 = tf.random_bits(key, 64, shape, device="cpu")
    assert b64.numpy().tobytes() == np.asarray(
        jax.random.bits(jkey, shape, jnp.uint64)).tobytes()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_randint_are_jax_s(seed, shape):
    key, jkey = _keys(seed)
    for lo, hi in BOUNDS:
        got = tf.uniform(key, shape, None, lo, hi, device="cpu")
        assert got.dtype == torch.float64
        assert _same_bits(got, jax.random.uniform(jkey, shape, minval=lo,
                                                  maxval=hi))
    for span in SPANS:
        got = tf.randint(key, shape, 5, 5 + span, device="cpu")
        assert got.dtype == torch.int64
        assert _same_bits(got, jax.random.randint(jkey, shape, 5, 5 + span))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_is_within_ulps_of_jax(seed, dtype):
    key, jkey = _keys(seed)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    for shape in SHAPES:
        got = tf.normal(key, shape, dtype, device="cpu")
        want = np.asarray(jax.random.normal(jkey, shape, dtype=jdt))
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
        assert np.isfinite(got.numpy()).all()
        assert ulps(got.numpy(), want) <= NORMAL_ULP


def test_erf_inv_is_xla_s_within_ulps():
    rng_ = np.random.default_rng(0)
    for dt in (np.float64, np.float32):
        x = rng_.uniform(-1, 1, 20000).astype(dt)
        x[:200] = (1 - rng_.uniform(0, 1e-5, 200)).astype(dt)   # the tails
        x = np.clip(x, np.nextafter(dt(-1), dt(0)), np.nextafter(dt(1),
                                                                 dt(0)))
        x[-2:] = [-1.0, 1.0]                                     # +-inf
        got = tf.erf_inv(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert ulps(got[fin], want[fin]) <= NORMAL_ULP


def test_a_chunked_draw_is_the_unchunked_one():
    key = tf.seed_key(123456)
    shape = (263, 257)
    for fn in (lambda c: tf.random_bits(key, 32, shape, device="cpu",
                                        chunk=c),
               lambda c: tf.random_bits(key, 64, shape, device="cpu",
                                        chunk=c),
               lambda c: tf.uniform(key, shape, torch.float32, device="cpu",
                                    chunk=c),
               lambda c: tf.randint(key, shape, 0, 1332, device="cpu",
                                    chunk=c)):
        whole = fn(263 * 257)
        assert whole.numpy().tobytes() == fn(1000).numpy().tobytes()
        assert whole.numpy().tobytes() == fn(4099).numpy().tobytes()


@pytest.mark.parametrize("shape", ((), (9,)), ids=str)
def test_a_batch_of_keys_draws_each_key_s_stream(shape):
    paths = np.array([0, 3, 2**32 - 1, 17])
    keys = tf.fold_in(tf.seed_key(7), paths)
    singles = [tf.fold_in(tf.seed_key(7), int(p)) for p in paths]
    assert [(int(hi), int(lo)) for hi, lo in zip(*keys)] == singles
    for draw in (lambda k: tf.random_bits(k, 64, shape, device="cpu"),
                 lambda k: tf.uniform(k, shape, device="cpu"),
                 lambda k: tf.uniform(k, shape, torch.float32, -2.5, 3.7,
                                      device="cpu"),
                 lambda k: tf.randint(k, shape, 0, 1332, device="cpu"),
                 lambda k: tf.randint(k, shape, 0, 1332, torch.int32,
                                      device="cpu"),
                 lambda k: tf.normal(k, shape, torch.float32, device="cpu")):
        got = draw(keys)
        want = torch.stack([draw(k) for k in singles])
        assert got.shape == (len(paths),) + shape
        assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.cuda
def test_card_draws_are_the_cpu_s():
    """The card's hash and samplers: bits, a unit and a bounded uniform
    (whose span is no power of two, so its multiply-add is emulated) and
    a ``randint`` bitwise the CPU's; a normal at path 3's sketch shape
    within ``NORMAL_ULP`` of the CPU's in both widths (the ``log`` is each
    device's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the draws are held card to CPU")
    key = tf.seed_key(2**31 - 1)
    for draw in (lambda d: tf.random_bits(key, 64, (263, 257), device=d),
                 lambda d: tf.uniform(key, (263, 257), torch.float32,
                                      device=d),
                 lambda d: tf.uniform(key, (263, 257), torch.float64, -2.5,
                                      3.7, device=d),
                 lambda d: tf.uniform(key, (263, 257), torch.float32, -2.5,
                                      3.7, device=d),
                 lambda d: tf.randint(key, (263, 257), 0, 1332, device=d)):
        assert draw("cuda").cpu().numpy().tobytes() == draw(
            "cpu").numpy().tobytes()
    for dtype in (torch.float64, torch.float32):
        got = tf.normal(key, (1000, 28), dtype, device="cuda").cpu()
        assert ulps(got.numpy(), tf.normal(key, (1000, 28), dtype,
                                           device="cpu").numpy()) <= NORMAL_ULP


def test_default_widths_follow_torch_default_dtype():
    key = tf.seed_key(3)
    assert tf.uniform(key, (2,), device="cpu").dtype == torch.float64
    assert tf.randint(key, (2,), 0, 5, device="cpu").dtype == torch.int64
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        assert tf.uniform(key, (2,), device="cpu").dtype == torch.float32
        assert tf.randint(key, (2,), 0, 5, device="cpu").dtype == torch.int32
        assert tf.normal(key, (2,), device="cpu").dtype == torch.float32
    finally:
        torch.set_default_dtype(prev)
    with pytest.raises(ValueError, match="span"):
        tf.randint(key, (2,), 0, 2**31, device="cpu")


# ------------------------------------------------ end to end, same seed

CHAOS = dict(seed=11, nan_rate=0.05, inf_rate=0.05, outlier_rate=0.05,
             outlier_mag=6.0, stale_rate=0.2, drop_rate=0.2,
             collapse_rate=0.3, collapse_keep=3)
STAGES = ((0, (5, 40, 16), 1), (1, (40, 5), 0), (2, (40, 16), 0))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("stage_idx,shape,axis", STAGES)
def test_inject_is_jax_s_at_the_same_seed(stage_idx, shape, axis, dtype):
    x = np.random.default_rng(stage_idx).normal(size=shape).astype(dtype)
    stage = faults.INJECT_STAGES[stage_idx]
    got = faults.inject(stage, torch.from_numpy(x.copy()),
                        resil.FaultSpec.make(**CHAOS), date_axis=axis)
    want = jresil.inject(stage, jnp.asarray(x), jresil.FaultSpec.make(
        **CHAOS), date_axis=axis)
    assert _same_bits(got, want)
    assert np.isnan(got.numpy()).any() and np.isinf(got.numpy()).any()


def test_inject_universe_is_jax_s_at_the_same_seed():
    uni = np.random.default_rng(3).uniform(size=(40, 16)) > 0.2
    got = faults.inject_universe(torch.from_numpy(uni),
                                 resil.FaultSpec.make(**CHAOS))
    want = jresil.inject_universe(jnp.asarray(uni),
                                  jresil.FaultSpec.make(**CHAOS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != uni).any()


D, N = 120, 40
RETURNS = np.random.default_rng(20261018).normal(scale=0.02, size=(D, N))


@pytest.mark.parametrize("path", range(3))
def test_scenario_draws_are_jax_s_at_the_same_seed(path):
    boot = dict(seed=5, block_len=10)
    spec, jspec = (scenarios.BootstrapSpec.make(**boot),
                   jsc.BootstrapSpec.make(**boot))
    assert scenarios.path_key(spec, path) == _key_tuple(
        jsc.path_key(jspec, path))
    got = spec.day_index(scenarios.path_key(spec, path), D)
    want = np.asarray(jspec.day_index(jsc.path_key(jspec, path), D))
    assert got.dtype == want.dtype and np.array_equal(got, want)

    reg = dict(seed=7, vol_scale=2.0, mean_shift=-0.005, corr_tighten=0.4)
    spec, jspec = (scenarios.RegimeSpec.make(**reg),
                   jsc.RegimeSpec.make(**reg))
    got = spec.transform_returns(scenarios.path_key(spec, path),
                                 torch.from_numpy(RETURNS)).numpy()
    want = np.asarray(jspec.transform_returns(jsc.path_key(jspec, path),
                                              jnp.asarray(RETURNS)))
    # the cross-sectional mean sums in another order (the seam's tolerance
    # in tests/test_torch_scenarios.py)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-16)
    assert not np.array_equal(got, RETURNS)

    adv = dict(seed=3, window_len=20, nan_rate=0.05, inf_rate=0.02,
               outlier_rate=0.05, stale_rate=0.3, drop_rate=0.2,
               collapse_rate=0.2)
    spec, jspec = (scenarios.AdversarialSpec.make(**adv),
                   jsc.AdversarialSpec.make(**adv))
    key, jkey = scenarios.path_key(spec, path), jsc.path_key(jspec, path)
    sched = spec.schedule(key, D)
    jsched = [np.asarray(m) for m in jspec.schedule(jkey, D)]
    for g, w in zip(sched, jsched):
        np.testing.assert_array_equal(g, w)
    masks = spec.cell_masks(key, (D, N), sched[0], device="cpu")
    jmasks = jspec.cell_masks(jkey, (D, N), jnp.asarray(jsched[0]))
    for g, w in zip(masks, jmasks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert masks[0].any()


def _panel(seed, d, n):
    r = np.random.default_rng(seed)
    base = r.normal(scale=0.01, size=(d, 3)) @ r.normal(size=(3, n))
    out = base + r.normal(scale=0.02, size=(d, n))
    out[r.uniform(size=out.shape) < 0.1] = np.nan
    return out


def test_regime_draws_of_a_dispatch_are_each_path_s():
    reg = dict(seed=7, vol_scale=2.0, mean_shift=-0.005, corr_tighten=0.4)
    spec, jspec = (scenarios.RegimeSpec.make(**reg),
                   jsc.RegimeSpec.make(**reg))
    paths = list(range(6))
    for dtype in (torch.float64, torch.float32):
        breaks, intensity = spec.draws(scenarios.path_key(spec, paths), D,
                                       dtype)
        assert (breaks, intensity) == tuple(map(list, zip(*(
            spec.draws(scenarios.path_key(spec, p), D, dtype)
            for p in paths))))
    for p, s, u in zip(paths, breaks, intensity):
        k = jsc.path_key(jspec, p)
        lane = lambda name: jax.random.fold_in(  # noqa: E731
            k, jrng.lane_id(name))
        assert s == int(jax.random.randint(lane("scenario/regime_break"),
                                           (), 0, D))
        assert u == float(jax.random.uniform(
            lane("scenario/regime_intensity"), (), dtype=jnp.float32))


def test_sketch_is_jax_s_normal():
    q = risk._sketch(60, 11, 3, torch.float64, "cpu").numpy()
    want = np.asarray(jax.random.normal(jax.random.key(3), (60, 11),
                                        dtype=jnp.float64))
    assert ulps(q, want) <= NORMAL_ULP


def test_randomized_pca_is_jax_s_at_the_same_seed():
    r = _panel(1, 40, 60)
    for seed in (0, 5):
        got = risk.pca(torch.from_numpy(r), 3, method="randomized",
                       seed=seed)
        want = jrisk.pca(jnp.asarray(r), 3, method="randomized", seed=seed)
        gc, wc = got.components.numpy(), np.asarray(want.components)
        # sign-invariant: components' diag(ev) components
        np.testing.assert_allclose(
            gc.T @ np.diag(got.explained_variance.numpy()) @ gc,
            wc.T @ np.diag(np.asarray(want.explained_variance)) @ wc,
            atol=1e-9, rtol=0)
        np.testing.assert_allclose(got.explained_variance.numpy(),
                                   np.asarray(want.explained_variance),
                                   atol=1e-9, rtol=0)


def test_auto_risk_model_takes_the_randomized_form_and_is_jax_s():
    # k + oversample < min(D, N) // 4: method="auto" picks "randomized"
    r = _panel(2, 120, 80)
    k = 3
    assert k + 8 < min(r.shape) // 4
    got = risk.statistical_risk_model(torch.from_numpy(r), k, method="auto",
                                      seed=4)
    want = jrisk.statistical_risk_model(jnp.asarray(r), k, method="auto",
                                        seed=4)
    cov = lambda b, f: b @ np.diag(f) @ b.T  # noqa: E731
    np.testing.assert_allclose(
        cov(got.loadings.numpy(), got.factor_var.numpy()),
        cov(np.asarray(want.loadings), np.asarray(want.factor_var)),
        atol=1e-9, rtol=0)
    for name in ("factor_var", "idio_var", "mean"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-9, rtol=0, err_msg=name)
    # one pass of the subspace iteration leaves the components far from
    # converged, so they show the sketch: the same seed is JAX's, another
    # seed is not
    kw = dict(method="randomized", iters=1)
    one = risk.statistical_risk_model(torch.from_numpy(r), k, seed=4, **kw)
    jone = jrisk.statistical_risk_model(jnp.asarray(r), k, seed=4, **kw)
    other = risk.statistical_risk_model(torch.from_numpy(r), k, seed=5, **kw)
    np.testing.assert_allclose(one.factor_var.numpy(),
                               np.asarray(jone.factor_var), atol=1e-9, rtol=0)
    assert not np.allclose(other.factor_var.numpy(), one.factor_var.numpy(),
                           atol=1e-7, rtol=0)
