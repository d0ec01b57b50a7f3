"""Trailing-window streaming ops: the CUDA kernel ``csrc/window_stream.cu``
and its plain PyTorch versions.

Replaces the Pallas kernel ``factormodeling_tpu/ops/_pallas_window.py::
_streaming_call`` in its four forms (``decay_streaming``,
``ts_rank_streaming``, ``ts_std_streaming``, ``ts_zscore_streaming``): the
linear-decay mean, the fractional average-tie rank of the last element, and
the ddof=1 std and z-score from two passes over the window, each with
``min_periods = window`` (a cell is defined only when all ``window``
trailing observations are non-NaN; rows above date 0 read as NaN).

The kernel computes what the TPU kernel computes, in its order: per output
cell a loop over the W lags from the newest (``j = 0``, weight W in the
decay) to the oldest. Each ``*_plain`` twin repeats that arithmetic in
PyTorch (the lag loop over a NaN-padded history, the two-pass moments), and
the kernel multiplies, adds and divides with round-to-nearest intrinsics and
no fused multiply-add, so on the card the decay, rank, std and z-score
agree with their twins to the last bit wherever both round the same way
(the tests and ``chip_smoke.py`` state their tolerances).

Bound on an H100: operations. A ``[D, N]`` float32 panel is read once and
written once (8 B per cell), but every cell does 2-6 operations per lag
over W lags (the decay a multiply and an add): at D = 5040, N = 5000,
W = 150 that is ~7.6-23 GFLOP against 0.2 GB of traffic. The kernel gives
each thread one column (consecutive threads on consecutive columns, so
every load is coalesced) and a tile of consecutive dates; it walks the
dates from the newest down to W - 1 above its first, loading each value
once into a register and applying it to all the tile's outputs whose
window holds it. The walk is split into two unrolled ramps and a middle
that every output takes, so no lag is range-tested, no weight converted
from an integer and no count kept per lag: the valid test runs once per
loaded date. Each block loads its own W - 1 rows of history above its
tile (a halo, through L1/L2) instead of carrying it from the previous
tile as the TPU's sequential grid does, so there is no shared memory to
size against W and any window length runs.

On a CUDA tensor each function launches the kernel or raises; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from factormodeling_tpu_torch import _build

__all__ = ["decay_streaming", "decay_streaming_plain", "ts_rank_streaming",
           "ts_rank_streaming_plain", "ts_std_streaming",
           "ts_std_streaming_plain", "ts_zscore_streaming",
           "ts_zscore_streaming_plain"]

#: kernel launches since the count was last set to 0
launches = 0

_FORMS = {"decay": 0, "rank": 1, "std": 2, "zscore": 3}
_ENTRY = {torch.float32: "fm_window_stream_f32",
          torch.float64: "fm_window_stream_f64"}


def _lags(x: torch.Tensor, window: int):
    """``(x3, padded, lag)``: the panel as ``[R, D, N]``, the panel with
    ``window - 1`` NaN dates above date 0, and a function giving the
    ``[R, D, N]`` view of a ``padded``-shaped tensor ``j`` dates back."""
    d, n = x.shape[-2:]
    x3 = x.reshape(-1, d, n)
    padded = F.pad(x3, (0, 0, window - 1, 0), value=float("nan"))

    def lag(j, t=padded):
        return t[:, window - 1 - j:window - 1 - j + d]

    return x3, padded, lag


def _window_count(valid: torch.Tensor, window: int, d: int) -> torch.Tensor:
    """Valid cells in each trailing window of a padded ``bool[R, D+W-1, N]``
    mask, as ``x``'s dtype: an integer count, so equal to a per-lag sum in
    any order."""
    cs = F.pad(torch.cumsum(valid, dim=1, dtype=torch.int32),
               (0, 0, 1, 0))
    return cs[:, window:window + d] - cs[:, :d]


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true division on every device: PyTorch's CUDA kernel
    multiplies by the reciprocal of a Python-number divisor, which can round
    one bit away from the kernel's division."""
    return a / a.new_tensor(b)


def decay_streaming_plain(x: torch.Tensor, window: int) -> torch.Tensor:
    """Linear-decay trailing mean, weights ``window - j`` on lag ``j``
    (added lag by lag from lag 0, the kernel's order)."""
    x3, padded, lag = _lags(x, window)
    valid = ~torch.isnan(padded)
    zeroed = torch.where(valid, padded, 0.0)
    acc = torch.zeros_like(x3)
    for j in range(window):
        acc = acc + (window - j) * lag(j, zeroed)
    cnt = _window_count(valid, window, x3.shape[1])
    denom = window * (window + 1) / 2.0
    return torch.where(cnt == window, _div(acc, denom), float("nan")).reshape(x.shape)


def ts_rank_streaming_plain(x: torch.Tensor, window: int) -> torch.Tensor:
    """Fractional average-tie rank of each cell within its trailing window
    (NaN compares false; -0.0 ties with +0.0). The counts are integers,
    exact in any order."""
    x3, padded, lag = _lags(x, window)
    less = torch.zeros_like(x3)
    eq = torch.zeros_like(x3)
    for j in range(window):
        sl = lag(j)
        less += sl < x3
        eq += sl == x3
    cnt = _window_count(~torch.isnan(padded), window, x3.shape[1])
    pct = _div(less + 0.5 * (eq + 1.0), window)
    return torch.where(cnt == window, pct, float("nan")).reshape(x.shape)


def _moments_plain(x: torch.Tensor, window: int, zscore: bool) -> torch.Tensor:
    """ddof=1 std (or z-score) from two passes over the window: the mean,
    then the centered sum of squares, each added lag by lag from lag 0 (the
    kernel's order); a constant finite window has std exactly 0 (and
    z-score NaN)."""
    x3, padded, lag = _lags(x, window)
    nan = torch.isnan(padded)
    zeroed = torch.where(nan, 0.0, padded)
    s1 = torch.zeros_like(x3)
    for j in range(window):
        s1 = s1 + lag(j, zeroed)
    cnt = _window_count(~nan, window, x3.shape[1])
    # min and max are exact in any order: over the window axis at once
    wins = torch.where(nan, float("inf"), padded).unfold(1, window, 1)
    mn = wins.amin(-1)
    mx = torch.where(nan, float("-inf"), padded).unfold(1, window, 1).amax(-1)
    del wins
    mean = _div(s1, window)
    if window <= 1:   # ddof=1 with one observation: pandas std is NaN
        var = torch.full_like(x3, float("nan"))
    else:
        s2 = torch.zeros_like(x3)
        for j in range(window):
            dev = torch.where(lag(j, nan), 0.0, lag(j) - mean)
            s2 = s2 + dev * dev
        var = _div(s2, window - 1)
        constant = (mn == mx) & torch.isfinite(mn) & torch.isfinite(mx)
        var = torch.where(constant, 0.0, var)
    std = torch.sqrt(var)
    out = ((x3 - mean) / torch.where(std == 0.0, float("nan"), std)
           if zscore else std)
    return torch.where(cnt == window, out, float("nan")).reshape(x.shape)


def ts_std_streaming_plain(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing ddof=1 std, two-pass."""
    return _moments_plain(x, window, zscore=False)


def ts_zscore_streaming_plain(x: torch.Tensor, window: int) -> torch.Tensor:
    """(x - rolling mean) / rolling std, std == 0 -> NaN, two-pass."""
    return _moments_plain(x, window, zscore=True)


_PLAIN = {"decay": decay_streaming_plain, "rank": ts_rank_streaming_plain,
          "std": ts_std_streaming_plain, "zscore": ts_zscore_streaming_plain}


def _lib(dtype):
    fn = getattr(_build.load("window_stream"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _streaming(form: str, x: torch.Tensor, window: int) -> torch.Tensor:
    """One form over a ``[..., D, N]`` panel (leading axes flattened): the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    window = int(window)
    if x.ndim < 2 or window < 1:
        raise ValueError(f"window streaming takes a [..., D, N] panel and "
                         f"window >= 1, got shape {tuple(x.shape)}, window "
                         f"{window}")
    if x.device.type == "cpu":
        return _PLAIN[form](x, window)
    if x.device.type != "cuda":
        raise ValueError(f"window streaming: input on {x.device}; it runs on "
                         "a CUDA device or on the CPU")
    if x.dtype not in _ENTRY:
        raise TypeError(f"window_stream kernel takes float32 or float64, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("window_stream kernel takes a contiguous panel")
    d, n = x.shape[-2:]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib(x.dtype)(x.data_ptr(), out.data_ptr(), _FORMS[form],
                           x.numel() // (d * n), d, n, window, stream)
    if rc != 0:
        raise RuntimeError(f"window_stream kernel ({form}) launch failed: "
                           f"CUDA error {rc}")
    global launches
    launches += 1
    return out


def decay_streaming(x: torch.Tensor, window: int) -> torch.Tensor:
    """Linear-decay trailing mean (``ts_decay``'s kernel form)."""
    return _streaming("decay", x, window)


def ts_rank_streaming(x: torch.Tensor, window: int) -> torch.Tensor:
    """Fractional rank of the last window element (``ts_rank``'s kernel form)."""
    return _streaming("rank", x, window)


def ts_std_streaming(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing ddof=1 std (``ts_std``'s kernel form)."""
    return _streaming("std", x, window)


def ts_zscore_streaming(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing z-score, std == 0 -> NaN (``ts_zscore``'s kernel form)."""
    return _streaming("zscore", x, window)
