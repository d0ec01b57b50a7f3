"""The port's rank-IC post-sort stage and factor scoring against the JAX
package, on the CPU in float64 with seeded numpy inputs.

The plain post-sort is held against the Pallas kernel run by its interpreter
(``rank_ic_postsort(..., interpret=True)``) on the same sorted rows, and the
port's ``daily_factor_stats`` against the JAX one, with exact ties, NaNs,
-0.0 next to +0.0, an all-invalid row and a single giant tie run. The CUDA
kernel against its plain version needs the card (marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import rankdata

from factormodeling_tpu.metrics import daily_factor_stats as jax_daily_stats
from factormodeling_tpu.metrics._pallas_rank_ic import \
    rank_ic_postsort as jax_rank_ic_postsort
from factormodeling_tpu.metrics.factor_metrics import \
    rolling_metrics as jax_rolling_metrics
from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
from factormodeling_tpu_torch.metrics import daily_factor_stats, rolling_metrics
from factormodeling_tpu_torch.ops._rank import sorted_avg_ranks

# f64 throughout: both sides sum the same products in different orders
TOL = 1e-12


def _rows(seed, rows=40, m=48):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(rows, m))
    f[rng.uniform(size=f.shape) < 0.1] = np.nan
    f[1] = np.round(f[1])           # heavy exact ties
    f[2, :] = 1.5                   # one giant tie run: zero rank variance
    f[3] = np.nan                   # all invalid
    f[4, 3:] = np.nan               # fewer than 3 valid
    f[5] = np.where(np.arange(m) % 2 == 0, -0.0, 0.0)  # -0.0 ties with +0.0
    f[5, :4] = np.array([1.0, -1.0, 2.0, np.nan])[:m]
    r = rng.normal(scale=0.02, size=(rows, m))
    return f, r


def _sorted(f, r):
    """Rows sorted by key with NaN last (numpy's order), payload 0 at NaN."""
    valid = ~np.isnan(f)
    rr = np.where(valid, r, 0.0)
    order = np.argsort(f, axis=-1, kind="stable")
    return (np.take_along_axis(f, order, -1),
            np.take_along_axis(rr, order, -1))


def test_torch_sort_sends_nan_last_and_ties_signed_zero():
    x = torch.tensor([[0.0, float("nan"), -0.0, -1.0, 0.0, float("nan"), 2.0]],
                     dtype=torch.float64)
    s, _ = torch.sort(x, dim=-1)
    assert torch.isnan(s[0, -2:]).all() and not torch.isnan(s[0, :-2]).any()
    ranks = sorted_avg_ranks(s, ~torch.isnan(s))
    # the three zeros (two of them -0.0) share one average rank
    np.testing.assert_array_equal(ranks[0, :5].numpy(),
                                  rankdata([-1.0, 0.0, 0.0, 0.0, 2.0]))
    assert torch.isnan(ranks[0, 5:]).all()


def test_plain_postsort_matches_pallas_interpret():
    f, r = _rows(0)
    s_key, r_s = _sorted(f, r)
    ic_j, cnt_j = jax_rank_ic_postsort(jnp.asarray(s_key), jnp.asarray(r_s),
                                       interpret=True)
    ic_t, cnt_t = rk.rank_ic_postsort(torch.from_numpy(s_key),
                                      torch.from_numpy(r_s))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(ic_t.numpy(), np.asarray(ic_j), atol=TOL,
                               rtol=0, equal_nan=True)
    # and both agree with scipy where the rank-IC is defined
    for i in range(f.shape[0]):
        v = ~np.isnan(f[i])
        if v.sum() >= 2 and np.unique(f[i][v]).size >= 2:
            exp = np.corrcoef(rankdata(f[i][v]), r[i][v])[0, 1]
            np.testing.assert_allclose(ic_t[i].item(), exp, atol=1e-12)


def test_postsort_wrapper_on_cpu_runs_plain_and_counts_nothing():
    f, r = _rows(1, rows=6, m=20)
    s_key, r_s = (torch.from_numpy(a) for a in _sorted(f, r))
    before = rk.launches
    got = rk.rank_ic_postsort(s_key, r_s)
    want = rk.rank_ic_postsort_plain(s_key, r_s)
    assert rk.launches == before
    for a, b in zip(got, want):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _stack(seed, f=4, d=12, n=30):
    rng = np.random.default_rng(seed)
    fac = rng.normal(size=(f, d, n))
    fac[rng.uniform(size=fac.shape) < 0.08] = np.nan
    fac[0] = np.round(fac[0] * 2.0)          # ties through the whole sort
    fac[1, :, ::3] = -0.0
    fac[1, :, 1::3] = 0.0
    ret = rng.normal(scale=0.02, size=(d, n))
    ret[rng.uniform(size=ret.shape) < 0.05] = np.nan
    uni = rng.uniform(size=(d, n)) > 0.1
    return fac, ret, uni


@pytest.mark.parametrize("shift_periods", [0, 1, 2])
@pytest.mark.parametrize("with_universe", [False, True])
def test_daily_factor_stats_match_jax(shift_periods, with_universe):
    fac, ret, uni = _stack(2)
    kw = dict(shift_periods=shift_periods,
              stats=("ic", "rank_ic", "factor_return"))
    got = daily_factor_stats(torch.from_numpy(fac), torch.from_numpy(ret),
                             universe=torch.from_numpy(uni) if with_universe
                             else None, **kw)
    want = jax_daily_stats(jnp.asarray(fac), jnp.asarray(ret),
                           universe=jnp.asarray(uni) if with_universe
                           else None, **kw)
    np.testing.assert_array_equal(got["n_pairs"].numpy(),
                                  np.asarray(want["n_pairs"]))
    for k in ("ic", "rank_ic", "factor_return"):
        # 1e-10: the two sorts order tied payloads differently
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-10, rtol=0, equal_nan=True,
                                   err_msg=k)


def test_rolling_metrics_match_jax_and_factor_return_group_raises():
    """All three groups of ``rolling_metrics`` against the JAX function.
    (The name is kept from when the factor-return group raised for want of
    betainc; it now matches the JAX group, p-values included.)"""
    fac, ret, uni = _stack(3, d=30)
    stats = ("ic", "rank_ic", "factor_return")
    daily_t = daily_factor_stats(torch.from_numpy(fac), torch.from_numpy(ret),
                                 universe=torch.from_numpy(uni), stats=stats)
    daily_j = jax_daily_stats(jnp.asarray(fac), jnp.asarray(ret),
                              universe=jnp.asarray(uni), stats=stats)
    got = rolling_metrics(daily_t, 7)
    want = jax_rolling_metrics(daily_j, 7)
    assert set(got) == set(want) and "factor_return_pvalue" in got
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-10, rtol=0, equal_nan=True,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 37, 1000, 4096, rk.MAX_SORTED_WIDTH])
def test_rank_ic_kernel_matches_plain_on_card(m):
    """Ragged widths, one element, m = 4096 (48 KB of dynamic shared
    memory, past the default once the static shared memory is added) and
    the widest row (196 KB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    f, r = _rows(4, rows=300, m=m)
    key = torch.from_numpy(f.astype(np.float32)).cuda()
    payload = torch.where(torch.isnan(key), 0.0,
                          torch.from_numpy(r.astype(np.float32)).cuda())
    s_key, idx = torch.sort(key, dim=-1)
    r_s = torch.gather(payload, -1, idx)
    before = rk.launches
    ic, cnt = rk.rank_ic_postsort(s_key, r_s)
    assert rk.launches == before + 1
    ic0, cnt0 = rk.rank_ic_postsort_plain(s_key, r_s)
    assert torch.equal(cnt, cnt0)
    # f32 moment sums in two orders
    torch.testing.assert_close(ic, ic0, atol=1e-5, rtol=0, equal_nan=True)


@pytest.mark.cuda
def test_rank_ic_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    x = torch.zeros(3, 8, device="cuda")
    with pytest.raises(TypeError):
        rk.rank_ic_postsort(x.double(), x.double())
    wide = torch.zeros(2, rk.MAX_SORTED_WIDTH + 1, device="cuda")
    with pytest.raises(ValueError, match="M <="):
        rk.rank_ic_postsort(wide, wide)
    with pytest.raises(ValueError, match="contiguous"):
        rk.rank_ic_postsort(x.T, x.T)
