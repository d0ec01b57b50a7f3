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
from tests.torch_threads import torch_one_thread  # noqa: F401

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
@pytest.mark.parametrize("m", [1, 31, 33, 37, 992, 993, 1000, 1001, 4096,
                               7936, 7937, 8192, rk.MAX_SORTED_WIDTH])
def test_rank_ic_kernel_matches_plain_on_card(m):
    """Ragged widths and one element (4-byte copies), each side of one warp
    -> two (992, 993) and of 31 -> 63 positions a lane (7936, 7937), m =
    4096 and 8192 (teams of 5 warps; one buffer a team at 8192) and the
    widest row (a team of 9 warps, one 128 KB buffer)."""
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


def _header_define(name):
    import re
    from factormodeling_tpu_torch import _build

    src = (_build.CSRC / "rank_common.cuh").read_text()
    return int(re.search(rf"^#define {name} (\d+)", src, re.M).group(1))


def test_postsort_layout_covers_every_width():
    """The wrapper's mirror of the kernel's block (``row_layout`` and
    ``fm_rank_ic_layout``) at every width the kernel takes: the fewest
    warps whose lanes hold at most ``RIC_MAX_CHUNK`` positions, an odd
    chunk (so the lanes' reads at an odd stride hit 32 distinct banks) that
    covers the row, whole teams within 1024 threads, and row buffers within
    the block's shared memory. The constants are the source's."""
    assert _header_define("RIC_MAX_CHUNK") == rk.MAX_CHUNK
    assert _header_define("RIC_WIDE_CHUNK") == rk.WIDE_CHUNK
    assert _header_define("RIC_THREADS") == rk.NARROW_LANES
    assert _header_define("RIC_MAX_TEAMS") == rk.MAX_TEAMS
    banks = np.arange(32)
    for m in range(1, rk.MAX_SORTED_WIDTH + 1):
        lay = rk.postsort_layout(m)
        tw, ch = lay["team_warps"], lay["chunk"]
        cap = rk.MAX_CHUNK if m <= rk.NARROW_LANES * rk.MAX_CHUNK \
            else rk.WIDE_CHUNK
        assert ch % 2 == 1 and ch <= cap
        assert 32 * tw * ch >= m
        assert tw == 1 or 32 * (tw - 1) * cap < m
        if m <= 8192:   # the fused sort's widths: a team fits its block
            assert 32 * tw <= rk.NARROW_LANES
        assert lay["teams"] * 32 * tw <= 1024
        assert 1 <= lay["teams"] <= rk.MAX_TEAMS
        assert lay["smem_bytes"] <= rk.SMEM_BUDGET
        assert lay["buffers"] in (1, 2)
        assert len(set((banks * ch) % 32)) == 32
    assert rk.postsort_layout(992)["team_warps"] == 1
    assert rk.postsort_layout(993)["team_warps"] == 2
    assert rk.postsort_layout(1000)["buffers"] == 2


@pytest.mark.cuda
def test_postsort_layout_mirror_equals_the_source_on_card():
    """The built library's own block (``fm_rank_ic_layout``) equals the
    wrapper's mirror at every width the kernel takes."""
    import ctypes

    from factormodeling_tpu_torch import _build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    fn = _build.load("rank_ic").fm_rank_ic_layout
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 6)()
    for m in range(1, rk.MAX_SORTED_WIDTH + 1):
        fn(m, out)
        lay = rk.postsort_layout(m)
        assert (out[0], out[1], out[2], out[3], out[5]) == (
            lay["team_warps"], lay["chunk"], lay["buffers"], lay["teams"],
            lay["smem_bytes"]), m


def _team_sum(p):
    """A team's total of per-lane partials ``p [..., TW, 32]`` as the
    kernel adds them: each warp by an xor butterfly (lane l adds lane
    l ^ o's value to its own, o = 16 .. 1), then the warps in order."""
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., np.arange(32) ^ o]
    tot = p[..., 0, 0]
    for q in range(1, p.shape[-2]):
        tot = tot + p[..., q, 0]
    return tot


def _team_body_emulated(s_key, r_s):
    """The post-sort body (``rank_ic_team_row`` in ``csrc/rank_common.cuh``)
    over sorted rows ``[R, M]``, emulated in float32 in its order: lane t of
    the team holds positions t * ch .. t * ch + ch - 1; the payload sum and
    the three moments run over a lane's positions in order, then the warp's
    xor butterfly and the team's warps in order (``_team_sum``); multiply
    and add round apart. Returns (ic, n_valid)."""
    s_key = np.asarray(s_key, np.float32)
    r_s = np.asarray(r_s, np.float32)
    r, m = s_key.shape
    lay = rk.postsort_layout(m)
    tw, ch = lay["team_warps"], lay["chunk"]
    pos = np.arange(32 * tw)[:, None] * ch + np.arange(ch)[None, :]
    live = pos < m
    at = np.minimum(pos, m - 1)
    idx = np.arange(m)
    start = np.ones((r, m), bool)
    start[:, 1:] = ~(s_key[:, 1:] == s_key[:, :-1])
    f = np.maximum.accumulate(np.where(start, idx, -1), axis=1)
    nxt = np.minimum.accumulate(np.where(start, idx, m)[:, ::-1],
                                axis=1)[:, ::-1]
    last = np.concatenate([nxt[:, 1:], np.full((r, 1), m)], 1) - 1
    rank = (np.float32(0.5) * (f + last).astype(np.float32)
            + np.float32(1.0))
    valid = ~np.isnan(s_key)

    def team(p):
        return _team_sum(p.reshape(r, tw, 32))

    with np.errstate(invalid="ignore", divide="ignore"):
        sum_r = np.zeros((r, 32 * tw), np.float32)
        for j in range(ch):
            sum_r = np.where(live[:, j], sum_r + r_s[:, at[:, j]], sum_r)
        cnt = valid.sum(1)
        cs = np.where(cnt > 0, cnt, np.nan).astype(np.float32)
        mr = team(sum_r) / cs
        mrank = (cs + np.float32(1.0)) * np.float32(0.5)
        acc = [np.zeros((r, 32 * tw), np.float32) for _ in range(3)]
        for j in range(ch):
            p = at[:, j]
            ok = live[:, j] & valid[:, p]
            drk = rank[:, p] - mrank[:, None]
            dr = r_s[:, p] - mr[:, None]
            for k, term in enumerate((drk * dr, drk * drk, dr * dr)):
                acc[k] = np.where(ok, acc[k] + term, acc[k])
        cov, var_rank, var_r = (team(a) for a in acc)
        ic = cov / np.sqrt(var_rank * var_r)
    return ic, cnt.astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 31, 33, 48, 992, 1000, 4096, 7937])
def test_team_body_summation_order_matches_plain(m):
    """The post-sort body's order (a lane's odd chunk of positions, the
    warp's xor butterfly, the team's warps in order), emulated in float32
    for one warp and teams of 2 and 5 warps, agrees with the plain version
    within the chip gate's ``RANK_IC_TOL`` (1e-5), with ``n_valid`` exact
    and NaN at the same rows: exact ties, a giant tie run, an all-invalid
    row, fewer than 3 valid cells, -0.0 beside +0.0."""
    f, r = _rows(40 + m, rows=24, m=m)
    s_key, r_s = (a.astype(np.float32) for a in _sorted(f, r))
    ic, cnt = _team_body_emulated(s_key, r_s)
    ic0, cnt0 = rk.rank_ic_postsort_plain(torch.from_numpy(s_key),
                                          torch.from_numpy(r_s))
    np.testing.assert_array_equal(cnt, cnt0.numpy())
    assert np.array_equal(np.isnan(ic), np.isnan(ic0.numpy()))
    np.testing.assert_allclose(ic, ic0.numpy(), atol=1e-5, rtol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 31, 33, 992, 993, 999, 1000, 4096, 7936,
                               7937, rk.MAX_SORTED_WIDTH])
def test_rank_ic_kernel_bitwise_equals_emulation_on_card(m):
    """On the card the kernel gives the emulated order's bits at the
    boundaries of its layouts (one position a lane, one warp -> two, 31
    positions a lane -> 63 past 7936, a team of 9 warps with one buffer)
    and in both load forms (M = 999: 4-byte copies; M = 1000: bulk
    copies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    f, r = _rows(50, rows=64, m=m)
    key = torch.from_numpy(f.astype(np.float32)).cuda()
    payload = torch.where(torch.isnan(key), 0.0,
                          torch.from_numpy(r.astype(np.float32)).cuda())
    s_key, idx = torch.sort(key, dim=-1)
    r_s = torch.gather(payload, -1, idx)
    ic, cnt = rk.rank_ic_postsort(s_key, r_s)
    want_ic, want_cnt = _team_body_emulated(s_key.cpu().numpy(),
                                            r_s.cpu().numpy())
    assert np.array_equal(cnt.cpu().numpy(), want_cnt)
    got = ic.cpu().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want_ic))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want_ic))
