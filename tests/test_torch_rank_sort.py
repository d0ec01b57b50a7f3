"""The port's fused rank-IC sort (K3) against the JAX package, on the CPU.

The plain version (``rank_ic_fused_plain``: the int32 key map, ``torch.sort``
and the post-sort moments) is held against the Pallas kernel run by its
interpreter (``rank_ic_fused(..., interpret=True)``) in float32 on the JAX
test's own panel, the key map against the JAX map bit for bit, and the
``FM_RANK_IC_FUSED=1`` route of ``daily_factor_stats`` against the JAX
function. The CUDA kernel against its plain version needs the card (marker
``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu.metrics import daily_factor_stats as jax_daily_stats
from factormodeling_tpu.metrics._pallas_rank_sort import _key_i32 as jax_key
from factormodeling_tpu.metrics._pallas_rank_sort import \
    rank_ic_fused as jax_rank_ic_fused
from factormodeling_tpu_torch import _build
from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
from factormodeling_tpu_torch.metrics import _cuda_rank_sort as rs
from factormodeling_tpu_torch.metrics import daily_factor_stats

# float32 moments over a few hundred terms summed in two orders: the JAX
# test's own tolerance for its fused kernel
TOL = 2e-5


def _panel(seed, rows, n):
    """The JAX test's panel (tests/test_pallas_rank_ic.py) plus +-inf,
    denormals and NaNs with other payload bits: ties, a constant row, an
    all-NaN row, -0.0 beside +0.0."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(rows, n)).astype(np.float32)
    f[rng.uniform(size=f.shape) < 0.1] = np.nan
    f[3] = np.round(f[3])
    f[4, :] = 2.5
    f[5] = np.nan
    f[6, :10] = 0.0
    f[6, 10:15] = -0.0
    f[6, 15:17] = (1e-40, -1e-40)     # denormals tie the zeros
    f[7, :4] = (np.inf, -np.inf, np.inf, -np.inf)
    f.view(np.uint32)[8, :3] = (0xFFC00000, 0x7FC00001, 0xFFFFFFFF)
    r = rng.normal(scale=0.02, size=(rows, n)).astype(np.float32)
    valid = ~np.isnan(f)
    return f, np.where(valid, r, 0.0).astype(np.float32)


def test_key_map_is_bit_equal_to_jax():
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-39,
                        -1e-39, 3.4e38, -3.4e38, 1.0, -1.0], dtype=np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7FC00001, 0x7F800001,
                     0xFFFFFFFF, 0xFF800001], dtype=np.uint32).view(np.float32)
    x = np.concatenate([special, nans,
                        np.random.default_rng(0).normal(size=64)
                        .astype(np.float32)])
    got = rs._key_i32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_key(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and np.all(got[len(special):][:6]
                                            == rs._NAN_KEY)
    # monotone over the valid keys; -0.0 and the denormals tied with +0.0
    order = np.argsort(special, kind="stable")
    assert np.all(np.diff(got[:len(special)][order]) >= 0)
    assert np.all(got[[1, 4, 5, 6, 7]] == got[0])


@pytest.mark.parametrize("rows,n", [(24, 300), (16, 128)])
def test_plain_matches_pallas_interpret(rows, n):
    f, r = _panel(rows + n, rows, n)
    ic_j, cnt_j = jax_rank_ic_fused(jnp.asarray(f), jnp.asarray(r),
                                    interpret=True, block_b=8)
    ic_t, cnt_t = rs.rank_ic_fused_plain(torch.from_numpy(f),
                                         torch.from_numpy(r))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(np.isfinite(ic_t.numpy()),
                                  np.isfinite(np.asarray(ic_j)))
    np.testing.assert_allclose(ic_t.numpy(), np.asarray(ic_j), atol=TOL,
                               rtol=0, equal_nan=True)
    assert not np.isfinite(ic_t[[4, 5]].numpy()).any()   # constant, all-NaN


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    f, r = _panel(1, 12, 130)
    key, rr = torch.from_numpy(f), torch.from_numpy(r)
    before = rs.launches
    got = rs.rank_ic_fused(key, rr)
    want = rs.rank_ic_fused_plain(key, rr)
    assert rs.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def _stack(seed, f=3, d=10, n=140):
    rng = np.random.default_rng(seed)
    fac = rng.normal(size=(f, d, n)).astype(np.float32)
    fac[rng.uniform(size=fac.shape) < 0.08] = np.nan
    fac[0] = np.round(fac[0] * 2.0)
    ret = rng.normal(scale=0.02, size=(d, n)).astype(np.float32)
    ret[rng.uniform(size=ret.shape) < 0.05] = np.nan
    uni = rng.uniform(size=(d, n)) > 0.1
    return fac, ret, uni


@pytest.mark.parametrize("switch", ["1", "0"])
def test_fused_route_of_daily_stats_matches_jax_in_f32(monkeypatch, switch):
    """With the switch on, float32 rows of 128..8192 cells take
    ``rank_ic_fused`` (its plain version on the CPU); the JAX function,
    whose fused kernel needs a TPU, takes its sort route on the CPU."""
    monkeypatch.setenv("FM_RANK_IC_FUSED", switch)
    fac, ret, uni = _stack(2)
    calls = []
    plain = rs.rank_ic_fused_plain
    monkeypatch.setattr(rs, "rank_ic_fused_plain",
                        lambda *a: calls.append(1) or plain(*a))
    got = daily_factor_stats(torch.from_numpy(fac), torch.from_numpy(ret),
                             universe=torch.from_numpy(uni),
                             stats=("rank_ic",))
    want = jax_daily_stats(jnp.asarray(fac), jnp.asarray(ret),
                           universe=jnp.asarray(uni), stats=("rank_ic",))
    assert len(calls) == (1 if switch == "1" else 0)
    assert got["rank_ic"].dtype == torch.float32
    np.testing.assert_allclose(got["rank_ic"].numpy(),
                               np.asarray(want["rank_ic"], dtype=np.float32),
                               atol=TOL, rtol=0, equal_nan=True)


def test_fused_route_keeps_other_types_and_widths_on_the_sort(monkeypatch):
    monkeypatch.setenv("FM_RANK_IC_FUSED", "1")
    monkeypatch.setattr(rs, "rank_ic_fused_plain",
                        lambda *a: pytest.fail("fused route taken"))
    fac, ret, uni = _stack(3, n=40)                  # n < 128
    daily_factor_stats(torch.from_numpy(fac), torch.from_numpy(ret),
                       stats=("rank_ic",))
    fac, ret, uni = _stack(3)
    daily_factor_stats(torch.from_numpy(fac).double(),
                       torch.from_numpy(ret).double(), stats=("rank_ic",))


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited shared header names a new library, so a stale one is
    never loaded."""
    for name in ("rank_sort.cu", "rank_ic.cu", "rank_common.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in ("rank_sort", "rank_ic")}
    with open(tmp_path / "rank_common.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {n: _build._lib_path(n) for n in ("rank_sort", "rank_ic")}
    assert all(before[n] != after[n] for n in before)
    assert set(_build.KERNEL_SOURCES) >= {"rank_sort", "fp32_probe"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1000, 4096, rs.MAX_WIDTH])
def test_kernel_matches_plain_and_post_sort_route_on_card(n):
    """n = 4096: 48 KB of dynamic shared memory, past the default once the
    static shared memory is added; n = 8192: 96 KB."""
    _card()
    f, r = _panel(n, 300, n)
    key, rr = torch.from_numpy(f).cuda(), torch.from_numpy(r).cuda()
    before = rs.launches
    ic, cnt = rs.rank_ic_fused(key, rr)
    assert rs.launches == before + 1
    ic0, cnt0 = rs.rank_ic_fused_plain(key, rr)
    # the post-sort route as daily_factor_stats takes it: NaNs made the
    # canonical NaN first (torch.sort on the card puts sign-bit NaNs first)
    s_key, idx = torch.sort(torch.where(torch.isnan(key), float("nan"), key),
                            dim=-1)
    ic1, cnt1 = rk.rank_ic_postsort(s_key, torch.gather(rr, -1, idx))
    assert torch.equal(cnt, cnt0) and torch.equal(cnt, cnt1)
    torch.testing.assert_close(ic, ic0, atol=TOL, rtol=0, equal_nan=True)
    # the post-sort route ranks the denormals of row 6 apart from the
    # zeros; the fused kernel ties them, as the JAX key map does
    rows = torch.arange(ic.numel(), device="cuda") != 6
    torch.testing.assert_close(ic[rows], ic1[rows], atol=TOL, rtol=0,
                               equal_nan=True)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    _card()
    x = torch.zeros(3, 200, device="cuda")
    with pytest.raises(TypeError):
        rs.rank_ic_fused(x.double(), x.double())
    for n in (rs.MIN_WIDTH - 1, rs.MAX_WIDTH + 1):
        y = torch.zeros(2, n, device="cuda")
        with pytest.raises(ValueError, match="n <="):
            rs.rank_ic_fused(y, y)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.zeros(200, 3, device="cuda").T
        rs.rank_ic_fused(z, z)
