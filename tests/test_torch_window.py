"""The port's window-streaming kernel (K4) and fused z-score/group-neutralize
kernel (K5): their plain PyTorch versions against the Pallas kernels run by
their interpreter, on the CPU in float32 at the JAX tests' shapes; the
wrappers' routing and refusals; and, under the ``cuda`` marker, each CUDA
kernel against its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu import ops as jops
from factormodeling_tpu.ops import _pallas_fused as jpf
from factormodeling_tpu.ops import _pallas_window as jpw
from factormodeling_tpu_torch import ops
from factormodeling_tpu_torch.ops import _cuda_fused as cf
from factormodeling_tpu_torch.ops import _cuda_window as cw
from tests.torch_threads import torch_one_thread  # noqa: F401

FORMS = {"decay": (cw.decay_streaming, jpw.decay_streaming),
         "rank": (cw.ts_rank_streaming, jpw.ts_rank_streaming),
         "std": (cw.ts_std_streaming, jpw.ts_std_streaming),
         "zscore": (cw.ts_zscore_streaming, jpw.ts_zscore_streaming)}
PLAIN = {"decay": cw.decay_streaming_plain, "rank": cw.ts_rank_streaming_plain,
         "std": cw.ts_std_streaming_plain,
         "zscore": cw.ts_zscore_streaming_plain}
PUBLIC = {"decay": ops.ts_decay, "rank": ops.ts_rank, "std": ops.ts_std,
          "zscore": ops.ts_zscore}
# float32, the same lag loop in two implementations: decay agrees to rounding,
# rank to one unit in the last place (XLA turns the division by the constant
# window into a reciprocal product), std and zscore to the float32 rounding
# of a mean and a sum of squares (zscore divides by a std that can be small)
TOL = {"decay": dict(atol=1e-6, rtol=0), "rank": dict(atol=1.2e-7, rtol=0),
       "std": dict(atol=1e-6, rtol=1e-5), "zscore": dict(atol=1e-5, rtol=1e-4)}


def _panel(seed, shape, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.uniform(size=shape) < nan_frac] = np.nan
    return x


def _edges(x):
    """Constant, +-inf, signed-zero and tied windows in the first panel."""
    x = x.reshape(-1, *x.shape[-2:])
    x[0, 10:40, 3] = 7.25                     # constant: std 0, zscore NaN
    x[0, 5:35, 4] = np.inf                    # constant +inf: std NaN
    x[0, 20:25, 5] = -np.inf
    x[0, :, 6] = np.where(np.arange(x.shape[1]) % 2, 0.0, -0.0)
    x[0, :, 7] = np.round(x[0, :, 7])         # heavy ties
    return x


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("window", [1, 2, 9, 45])
def test_plain_twin_matches_pallas_interpret(form, window):
    x = _panel(window, (3, 60, 20))
    _edges(x)
    want = np.asarray(FORMS[form][1](jnp.asarray(x), window, interpret=True))
    got = PLAIN[form](torch.from_numpy(x), window).numpy()
    np.testing.assert_allclose(got, want, equal_nan=True, err_msg=form,
                               **TOL[form])


def test_plain_twins_match_pallas_across_date_tiles():
    """A panel of three 512-row date tiles: windows straddle the TPU
    kernel's tile boundaries (its carried history) and W = 100 reaches
    across them."""
    x = _panel(7, (1040, 130), nan_frac=0.05)
    xj = jnp.asarray(x)
    for form, window in (("decay", 16), ("rank", 100), ("zscore", 100)):
        want = np.asarray(FORMS[form][1](xj, window, interpret=True))
        got = PLAIN[form](torch.from_numpy(x), window).numpy()
        np.testing.assert_allclose(got, want, equal_nan=True, err_msg=form,
                                   **TOL[form])


def test_plain_twins_window_beyond_panel_is_all_nan():
    x = torch.from_numpy(_panel(8, (2, 12, 5), nan_frac=0.0))
    for form, plain in PLAIN.items():
        assert torch.isnan(plain(x, 13)).all(), form
        assert not torch.isnan(plain(x, 12)[:, -1]).all(), form


def test_plain_moments_exact_zero_on_constant_windows():
    x = np.full((8, 3), 1.5e6, dtype=np.float64)
    x[0, 1] = 2.0e6                  # column 1 changes inside its first window
    x[:, 2] = np.inf                 # constant infinity: NaN (inf - inf)
    std = cw.ts_std_streaming_plain(torch.from_numpy(x), 3).numpy()
    z = cw.ts_zscore_streaming_plain(torch.from_numpy(x), 3).numpy()
    assert (std[2:, 0] == 0.0).all() and np.isnan(z[2:, 0]).all()
    assert std[2, 1] > 0.0 and (std[3:, 1] == 0.0).all()
    assert np.isnan(std[:, 2]).all() and np.isnan(z[:, 2]).all()


@pytest.mark.parametrize("form", list(FORMS))
def test_public_op_on_cpu_keeps_the_xla_form_and_counts_nothing(form):
    """On the CPU the public op is the JAX package's own CPU formulation, and
    the wrappers run their plain versions without counting a launch."""
    x = _panel(9, (2, 30, 11))
    before = cw.launches
    got = PUBLIC[form](torch.from_numpy(x).double(), 5).numpy()
    want = np.asarray(getattr(jops, f"ts_{form}")(jnp.asarray(x, jnp.float64),
                                                  5))
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0, equal_nan=True)
    FORMS[form][0](torch.from_numpy(x), 5)
    assert cw.launches == before


def test_window_wrapper_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="window >= 1"):
        cw.decay_streaming(torch.zeros(4, 3), 0)
    with pytest.raises(ValueError, match="window >= 1"):
        cw.ts_rank_streaming(torch.zeros(4), 2)


def _walk_tile(x, t0, window, rows):
    """One thread-tile of the kernel's date walk (``csrc/window_stream.cu``:
    ``walk_long`` with ``middle_block``, or ``walk_short`` when the window
    is shorter than the tile), emulated step for step in float32 over a
    [D, N] panel: the dates and the outputs each one feeds, the weights as
    the kernel forms them (no per-lag conversion) and its two-integer (or
    bit-mask) NaN rule. Returns each output's decay value (NaN where the
    rule says so) and the lags each output received, in order."""
    d, n = x.shape
    f32 = np.float32
    acc = [np.zeros(n, f32) for _ in range(rows)]
    lags = [[] for _ in range(rows)]

    def load(s):
        return x[s] if 0 <= s < d else np.full(n, np.nan, f32)

    def take(k, w, s, v):
        j = t0 + k - s
        assert w.dtype == f32 and w == f32(window - j)   # (T)(W - j)
        lags[k].append(j)
        acc[k] = acc[k] + w * np.where(np.isnan(v), f32(0), v)

    if window >= rows:
        top_bad = np.full(n, rows)
        wj = [f32(window) - f32(j) for j in range(rows - 1)]
        for i in range(rows - 1):                       # top ramp
            s = t0 + rows - 1 - i
            v = load(s)
            top_bad = np.where(np.isnan(v), rows - 1 - i, top_bad)
            for k in range(rows - 1 - i, rows):
                take(k, wj[k - (rows - 1 - i)], s, v)
        lo_nan = np.full(n, t0 - window)
        mid = window - rows + 1
        base, d0 = f32(window), 0
        while d0 < mid:                                 # middle blocks
            w = [base - f32(o) for o in range(2 * rows - 1)]
            for u in range(min(rows, mid - d0)):
                s = t0 - d0 - u
                v = load(s)
                lo_nan = np.where(np.isnan(v), np.maximum(lo_nan, s), lo_nan)
                for k in range(rows):
                    take(k, w[u + k], s, v)
            base, d0 = base - f32(rows), d0 + rows
        for m in range(rows - 1):                       # bottom ramp
            s = t0 - mid - m
            v = load(s)
            lo_nan = np.where(np.isnan(v), np.maximum(lo_nan, s), lo_nan)
            for k in range(rows - 1 - m):
                take(k, f32(rows - 1 - m - k), s, v)
        cut = lo_nan - t0 + window - 1
        bad = [(k >= top_bad) | (k <= cut) for k in range(rows)]
    else:
        badm = np.zeros(n, np.uint64)
        wmask = np.uint64((1 << window) - 1)
        b = f32(window + rows - 1)
        for i in range(rows + window - 1):
            s = t0 + rows - 1 - i
            v = load(s)
            badm = np.where(np.isnan(v),
                            badm | (wmask << np.uint64(rows + window - 2 - i)),
                            badm)
            for k in range(rows):
                if 0 <= k + i - (rows - 1) < window:
                    take(k, b - f32(k), s, v)
            b = b - f32(1)
        bad = [((badm >> np.uint64(k + window - 1)) & np.uint64(1)) == 1
               for k in range(rows)]
    denom = f32(window * (window + 1) / 2.0)
    out = [np.where(bad[k], np.nan, acc[k] / denom) for k in range(rows)]
    return out, lags


def _kernel_tile_rows():
    """``WIN_ROWS`` as the kernel source defines it."""
    import re
    from factormodeling_tpu_torch import _build

    src = _build.source_path("window_stream").read_text()
    return int(re.search(r"^#define WIN_ROWS (\d+)", src, re.M).group(1))


@pytest.mark.parametrize("rows", [8, 16, 32])
@pytest.mark.parametrize("window", [2, 3, 7, 15, 16, 17, 33, 40, 70])
def test_split_walk_summation_order_matches_plain(rows, window):
    """The kernel's split walk (top ramp, unconditional middle in blocks of
    the tile's rows plus a tail, bottom ramp; the short walk for windows
    below the tile), emulated on the CPU for tiles of 8, 16 and 32 dates:
    every output receives its lags in the order j = 0 .. W - 1 with the
    weight W - j, and the decay values equal ``decay_streaming_plain`` bit
    for bit, NaN at the same cells (D = 45 is no multiple of any tile, so
    the last tile is ragged; W = 70 is past D)."""
    assert _kernel_tile_rows() in (8, 16, 32)
    x = _panel(window + rows, (45, 6), nan_frac=0.04)
    x[30:33, 2] = np.nan
    x[1, 3] = np.nan
    got = np.empty_like(x)
    for t0 in range(0, x.shape[0], rows):
        out, lags = _walk_tile(x, t0, window, rows)
        for k in range(min(rows, x.shape[0] - t0)):
            assert lags[k] == list(range(window)), (t0, k)
            got[t0 + k] = out[k]
    want = cw.decay_streaming_plain(torch.from_numpy(x), window).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))


def _group_case(seed, f=2, d=600, n=256, g=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(f, d, n)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.1] = np.nan
    x[0, 3, :] = 7.5          # constant date -> sigma 0 -> NaN everywhere
    x[1, 4, :] = np.nan       # all-NaN date
    gid = rng.integers(-1, g, size=(d, n)).astype(np.int32)
    gid[5, :] = 4             # one group takes a whole date: the others empty
    gid[6, :128] = -1         # a big ungrouped block
    gid[7, :] = 0
    gid[7, 9] = 3             # a single-member group
    gid[8, 11] = g + 2        # an id past the counted groups -> NaN
    return x, gid, g


def test_fused_plain_twin_matches_pallas_interpret():
    """Multi-tile date axis (d_blk=256 of 600 rows) and a ragged asset
    width, as the JAX package's own test of the Pallas kernel."""
    x, gid, g = _group_case(0)
    for n in (256, 200):
        xs, gs = x[..., :n], gid[:, :n]
        want = np.asarray(jpf.zscore_group_neutralize_fused(
            jnp.asarray(xs), jnp.asarray(gs), g, interpret=True, d_blk=256))
        got = cf.zscore_group_neutralize_plain(
            torch.from_numpy(np.ascontiguousarray(xs)),
            torch.from_numpy(np.ascontiguousarray(gs)), g).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0,
                                   equal_nan=True)
        assert np.isnan(got[0, 3]).all() and np.isnan(got[1, 4]).all()
        assert np.isnan(got[:, 8, 11]).all()


def test_fused_wrapper_and_public_dispatch_on_cpu():
    """On the CPU the wrapper runs its plain version, and the public op with
    ``use_kernel=True`` keeps the composition, as the JAX package does off
    the TPU; both equal the composition."""
    x, gid, g = _group_case(1, d=40, n=64)
    xt, gt = torch.from_numpy(x).double(), torch.from_numpy(gid)
    comp = ops.group_neutralize(ops.cs_zscore(xt), gt, g)
    before = cf.launches
    fused = cf.zscore_group_neutralize_fused(xt, gt, g)
    via = ops.cs_zscore_group_neutralize(xt, gt, g, use_kernel=True)
    assert cf.launches == before
    torch.testing.assert_close(fused, comp, atol=1e-12, rtol=0,
                               equal_nan=True)
    torch.testing.assert_close(via, comp, atol=0, rtol=0, equal_nan=True)
    with pytest.raises(ValueError, match="num_groups"):
        cf.zscore_group_neutralize_fused(xt, gt, cf.MAX_FUSED_GROUPS + 1)
    with pytest.raises(ValueError, match="gids"):
        cf.zscore_group_neutralize_fused(xt, gt[:, :5], g)


def test_fused_wrapper_takes_rows_of_any_width_on_cpu():
    """No width limit: a row wider than the kernel's shared-memory tile
    (16384 assets) goes through the wrapper and the public op alike."""
    x, gid, g = _group_case(2, d=12, n=20000)
    xt, gt = torch.from_numpy(x).double(), torch.from_numpy(gid)
    comp = ops.group_neutralize(ops.cs_zscore(xt), gt, g)
    torch.testing.assert_close(cf.zscore_group_neutralize_fused(xt, gt, g),
                               comp, atol=1e-12, rtol=0, equal_nan=True)
    torch.testing.assert_close(
        ops.cs_zscore_group_neutralize(xt, gt, g, use_kernel=True), comp,
        atol=0, rtol=0, equal_nan=True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,window", [((2, 1040, 130), 16),
                                          ((1040, 130), 100),
                                          ((300, 70), 350),
                                          ((3, 40, 33), 100)]
                         + [((1332, 1000), w) for w in (2, 3, 7, 8, 9, 15,
                                                        16, 17, 31, 32, 33)])
def test_window_kernel_matches_plain_on_card(dtype, shape, window):
    """Several date tiles, windows longer than any tile, D < W, constant and
    +-inf windows, signed zeros and ties, and at the decay sweep's panel
    shape windows of 2 and 3 and just below, at and above tiles of 8, 16
    and 32 dates (the short walk, and the long walk with a middle of 0, 1
    and 2 dates): the public op launches the kernel once per call and
    agrees with the plain version (rank exactly)."""
    _card()
    x = _panel(10, shape, nan_frac=0.02)
    _edges(x)
    xt = torch.from_numpy(x.reshape(shape)).to("cuda", dtype)
    for form, plain in PLAIN.items():
        before = cw.launches
        got = PUBLIC[form](xt, window)
        assert cw.launches == before + 1
        want = plain(xt, window)
        torch.cuda.synchronize()
        if form == "rank":
            assert torch.equal(got.nan_to_num(-9.0), want.nan_to_num(-9.0))
        else:
            tol = TOL[form] if dtype == torch.float32 else dict(atol=1e-12,
                                                                rtol=1e-12)
            torch.testing.assert_close(got, want, equal_nan=True, **tol)


@pytest.mark.cuda
def test_window_kernel_on_ragged_universe_matches_cpu_op():
    """The compaction of ``_over_universe`` feeds the kernel columns with
    trailing NaN; the card's op equals the CPU op."""
    _card()
    x = _panel(11, (300, 200), nan_frac=0.02).astype(np.float64)
    uni = np.random.default_rng(11).uniform(size=x.shape) > 0.15
    xt, ut = torch.from_numpy(x), torch.from_numpy(uni)
    for form, op in PUBLIC.items():
        want = op(xt, 20, universe=ut)
        got = op(xt.cuda(), 20, universe=ut.cuda()).cpu()
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-10,
                                   equal_nan=True, msg=form)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 200, 256, 257, 1024, 1025, 3000, 8192,
                               8193, 16384, 16385, 40000])
def test_fused_kernel_matches_plain_on_card(n, dtype):
    """Rows in registers (N <= 8192; each side of 8 -> 16 cells and of one
    warp -> two), rows in shared memory (N <= 16384) and rows kept in the
    output row (wider): the public op launches the kernel once at every
    width."""
    _card()
    x, gid, g = _group_case(12, f=2, d=16 if n > 3000 else 64, n=max(n, 256))
    xt = torch.from_numpy(np.ascontiguousarray(x[..., :n])).to("cuda", dtype)
    gt = torch.from_numpy(np.ascontiguousarray(gid[:, :n])).cuda()
    before = cf.launches
    got = ops.cs_zscore_group_neutralize(xt, gt, g, use_kernel=True)
    assert cf.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, cf.zscore_group_neutralize_plain(xt, gt, g),
                               atol=tol, rtol=0, equal_nan=True)
    again = cf.zscore_group_neutralize_fused(xt, gt, g)
    assert torch.equal(got.nan_to_num(), again.nan_to_num())  # deterministic


def _kernel_defines(name, *keys):
    """The ``#define``s ``keys`` of the kernel source ``name``, as text."""
    import re
    from factormodeling_tpu_torch import _build

    src = _build.source_path(name).read_text()
    return [re.search(rf"^#define {k} (.+?)(\s*//.*)?$", src, re.M).group(1)
            for k in keys]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("g", [1, 11, 29, 30, 31, 32])
def test_fused_layout_covers_every_width(g, itemsize):
    """The wrapper's mirror of the source's layout (``reg_layout`` and the
    launcher's form by N, G and the type) at every width from 1 to 20,000:
    the register form up to ``REG_WIDTH`` with the smallest team, then the
    fewest cells, that cover the row and a block of whole teams, wherever
    its shared memory fits a block's opt-in; else the shared-memory form up
    to ``SMEM_WIDTH``; the wide form past it. In float32, and in float64 up
    to 29 groups, every row up to ``REG_WIDTH`` takes the register form; in
    float64 at 31 or more groups, the rows at the top of each team's range
    do not. The constants are the source's."""
    reg, smem, cells, threads, optin = _kernel_defines(
        "zscore_group", "REG_WIDTH", "SMEM_WIDTH", "ZG_CELLS", "ZG_THREADS",
        "ZG_SMEM_OPTIN")
    assert (int(reg), int(smem)) == (cf.REG_WIDTH, cf.SMEM_WIDTH)
    assert tuple(int(c) for c in cells.strip("{}").split(",")) == cf.CELLS
    assert int(threads) == 32 * cf.TEAM_MAX_WARPS
    assert int(optin) == cf.SMEM_OPTIN
    order = [(w, c) for w in (1, 2, 4, 8) for c in cf.CELLS]
    shared = []
    for n in range(1, 20001):
        lay = cf.kernel_layout(n, g, itemsize)
        if lay["form"] == "registers":
            assert n <= cf.REG_WIDTH
            k = order.index((lay["team_warps"], lay["cells"]))
            assert 32 * lay["team_warps"] * lay["cells"] >= n
            assert all(32 * w * c < n for w, c in order[:k])
            assert lay["teams"] * lay["team_warps"] == cf.TEAM_MAX_WARPS
            stage = -(-n // 4) * 4 * (itemsize + 4)
            assert lay["smem_bytes"] == (lay["teams"] * stage
                                         + 8 * (g + 1) * 64 * itemsize)
            assert lay["smem_bytes"] + 128 + 1056 * itemsize <= cf.SMEM_OPTIN
        elif n <= cf.REG_WIDTH:
            shared.append(n)
            assert lay["form"] == "shared"
        else:
            assert lay["form"] == ("shared" if n <= cf.SMEM_WIDTH else "wide")
    if itemsize == 4 or g <= 29:
        assert shared == []
    if itemsize == 8 and g >= 31:
        assert {1000, 1024, 2048, 4096, 8192} <= set(shared)
        assert 800 not in shared
    assert cf.kernel_layout(1000, 11, 4)["team_warps"] == 1
    assert (cf.kernel_layout(3000, 11, 4)["team_warps"],
            cf.kernel_layout(3000, 11, 4)["cells"]) == (4, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1000, 1024, 2048, 4096, 8192])
def test_fused_kernel_takes_the_most_groups_on_card(n, dtype):
    """At 32 groups, at the top of each team's range, the kernel launches
    and agrees with the plain version: in float64 these rows' register-form
    tables would pass a block's shared memory, so they take the
    shared-memory form."""
    _card()
    g = cf.MAX_FUSED_GROUPS
    rng = np.random.default_rng(40 + n)
    x = rng.normal(size=(2, 8, n))
    x[rng.uniform(size=x.shape) < 0.03] = np.nan
    gid = rng.integers(-1, g, size=(8, n)).astype(np.int32)
    gid[0, :3] = g          # an id past the groups
    x[1, 2] = 4.0           # a constant date
    xt = torch.from_numpy(x).to("cuda", dtype)
    gt = torch.from_numpy(gid).cuda()
    lay = cf.kernel_layout(n, g, xt.element_size())
    assert lay["form"] == ("shared" if dtype == torch.float64 else
                           "registers")
    before = cf.launches
    got = cf.zscore_group_neutralize_fused(xt, gt, g)
    assert cf.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, cf.zscore_group_neutralize_plain(xt, gt, g),
                               atol=tol, rtol=0, equal_nan=True)
    again = cf.zscore_group_neutralize_fused(xt, gt, g)
    assert torch.equal(got.nan_to_num(), again.nan_to_num())


@pytest.mark.cuda
def test_fused_layout_mirror_equals_the_source_on_card():
    """The built library's own layout (``fm_zscore_group_layout``) equals
    the wrapper's mirror at every width from 1 to 20,000."""
    import ctypes

    from factormodeling_tpu_torch import _build

    _card()
    fn = _build.load("zscore_group").fm_zscore_group_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 4)()
    forms = ("registers", "shared", "wide")
    for g in (1, 11, 30, 31, 32):
        for itemsize in (4, 8):
            for n in range(1, 20001):
                fn(n, g, itemsize, out)
                lay = cf.kernel_layout(n, g, itemsize)
                assert forms[out[0]] == lay["form"], (n, g, itemsize)
                if lay["form"] == "registers":
                    assert (out[1], out[2], out[3]) == (
                        lay["team_warps"], lay["cells"], lay["smem_bytes"]), n


def _team_sum(p):
    """A team's total of per-thread partials ``p [..., TW, 32]`` as the
    kernels add them: each warp by an xor butterfly (lane l adds lane
    l ^ o's value to its own, o = 16 .. 1), then the warps in order."""
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., np.arange(32) ^ o]
    tot = p[..., 0, 0]
    for q in range(1, p.shape[-2]):
        tot = tot + p[..., q, 0]
    return tot


def _table_sum(p, grp):
    """Group ``grp``'s total of per-lane table entries ``p [..., TW, 32]``
    as K5 adds them: lane ``grp`` of each warp adds the warp's 32 entries
    from lane ``grp`` on (grp, grp + 1, .., 31, 0, .., grp - 1), then the
    team adds its warps in order."""
    part = np.zeros(p.shape[:-1], p.dtype)
    for q in range(32):
        part = part + p[..., (q + grp) & 31]
    tot = part[..., 0]
    for w in range(1, part.shape[-1]):
        tot = tot + part[..., w]
    return tot


def _register_form_emulated(x, gid, g):
    """K5's register form (``zscore_group_regs`` in ``csrc/zscore_group.cu``)
    on rows ``x [R, N]`` with their ids ``gid [R, N]``, emulated step for
    step in ``x``'s type: thread t of a team of TW warps holds cells
    c * 32 TW + t; the moments run over a thread's cells in order, then
    :func:`_team_sum`; z multiplies by the reciprocal of sigma; each group's
    sum and count run over a lane's cells in order into its table column,
    then :func:`_table_sum`; counts are exact; multiply and add round
    apart."""
    r, n = x.shape
    lay = cf.kernel_layout(n, g, x.itemsize)
    assert lay["form"] == "registers"
    tw, c = lay["team_warps"], lay["cells"]
    tt = 32 * tw
    idx = np.arange(c)[:, None] * tt + np.arange(tt)[None, :]   # [C, TT]
    live = idx < n
    dt = x.dtype.type
    v = np.where(live, x[:, np.minimum(idx, n - 1)], dt(np.nan))  # [R, C, TT]
    gi = np.where(live, gid[:, np.minimum(idx, n - 1)], -1)

    def team(p):
        return _team_sum(p.reshape(r, tw, 32))

    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.zeros((r, tt), dt)
        cnt = np.zeros(r, np.int64)
        for k in range(c):
            ok = ~np.isnan(v[:, k])
            s = np.where(ok, s + v[:, k], s)
            cnt += ok.sum(-1)
        mean = (team(s) / cnt.astype(dt))[:, None]
        ss = np.zeros((r, tt), dt)
        for k in range(c):
            dv = v[:, k] - mean
            ss = np.where(np.isnan(v[:, k]), ss, ss + dv * dv)
        rsig = dt(1) / np.sqrt(team(ss) / cnt.astype(dt))
        z = (v - mean[:, :, None]) * rsig[:, None, None]
        gi = np.where(np.isnan(z), -1, gi)
        gmean = np.full((r, 32), np.nan, dt)
        for grp in range(g):
            # each lane's column of the warp's table, its cells in order
            sg = np.zeros((r, tt), dt)
            cg = np.zeros((r, tt), dt)
            for k in range(c):
                hit = gi[:, k] == grp
                sg = np.where(hit, sg + z[:, k], sg)
                cg = np.where(hit, cg + dt(1), cg)
            gmean[:, grp] = (_table_sum(sg.reshape(r, tw, 32), grp)
                             / _table_sum(cg.reshape(r, tw, 32), grp))
        gm = np.take_along_axis(gmean, (gi & 31).reshape(r, -1), 1)
        res = np.where((gi >= 0) & (gi < g), z - gm.reshape(gi.shape),
                       dt(np.nan))
    out = np.empty_like(x)
    out[:, idx[live]] = res[:, live]
    return out


@pytest.mark.parametrize("n", [1, 37, 200, 1000, 1025, 3000, 5000])
def test_register_form_summation_order_matches_plain(n):
    """The register form's summation order (a thread's cells, the warp's
    xor butterfly or its table read from the group's lane on, the team's
    warps in order), emulated in float32 on one
    warp of 8 or 32 cells and teams of 2 and 4 warps of 24, agrees with the
    plain version within the chip gate's ``K5_TOL`` (2e-5) and leaves NaN
    at the same cells: a constant and an all-NaN date, ids -1 and past G,
    an empty and a one-member group."""
    x, gid, g = _group_case(20 + n, f=2, d=10, n=max(n, 256))
    x, gid = np.ascontiguousarray(x[..., :n]), np.ascontiguousarray(
        gid[:, :n])
    rows = x.reshape(-1, n)
    want = cf.zscore_group_neutralize_plain(torch.from_numpy(x),
                                            torch.from_numpy(gid), g).numpy()
    got = _register_form_emulated(rows, np.tile(gid, (2, 1)), g)
    got = got.reshape(x.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, equal_nan=True)
    if n >= 10:
        assert np.isnan(got[0, 3]).all() and np.isnan(got[1, 4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [256, 257, 1000, 1024, 1025, 3000, 8192])
def test_register_form_bitwise_equals_emulation_on_card(n, dtype):
    """On the card the register form gives the emulated order's bits, at
    the boundaries of its layouts (8 -> 16 cells, one warp -> two, the
    widest register row)."""
    _card()
    x, gid, g = _group_case(30, f=2, d=12, n=max(n, 256))
    x = np.ascontiguousarray(x[..., :n]).astype(dtype == torch.float64
                                                and np.float64 or np.float32)
    gid = np.ascontiguousarray(gid[:, :n])
    got = cf.zscore_group_neutralize_fused(
        torch.from_numpy(x).cuda(), torch.from_numpy(gid).cuda(), g).cpu()
    want = _register_form_emulated(x.reshape(-1, n), np.tile(gid, (2, 1)),
                                   g).reshape(x.shape)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got.numpy()), np.nan_to_num(want))
