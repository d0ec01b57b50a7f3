"""The FP32 probe (K6) on the CPU: its plain version against a numpy float32
recurrence of the same expression (equal to the bit: both round the
multiply and the add in float32), the wrapper's CPU route, and the
measurement refusing to run without a card. On the card (marker ``cuda``)
the kernel against its plain version, within k float32 roundings of the
final magnitude (the FMA rounds once where the plain version rounds
twice).
"""

import numpy as np
import pytest
import torch

from factormodeling_tpu_torch import fp32_probe as fp


@pytest.mark.parametrize("k", [0, 1, 64])
def test_plain_matches_numpy_float32_recurrence(k):
    x = np.random.default_rng(k).normal(size=(3, 40, 17)).astype(np.float32)
    want = x.copy()
    for _ in range(k):
        want = want * np.float32(1.0000001) + np.float32(0.5)
    got = fp.probe_plain(torch.from_numpy(x), k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    x = torch.randn(5, 7)
    before = fp.launches
    assert torch.equal(fp.probe(x, 16), fp.probe_plain(x, 16))
    assert fp.launches == before
    assert fp.plain_tolerance(torch.full((2,), 40.0), 64) == pytest.approx(
        64 * 40.0 * 2.0 ** -23)


def test_measure_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error; a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fp.measure()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((4, 1000, 129), 64), ((3, 5), 256),
                                     ((0,), 8)])
def test_kernel_matches_plain_on_card(shape, k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    x = torch.randn(shape, device="cuda")
    before = fp.launches
    got = fp.probe(x, k)
    assert fp.launches == before + 1
    want = fp.probe_plain(x, k)
    tol = fp.plain_tolerance(want, k) if want.numel() else 0.0
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
    with pytest.raises(TypeError):
        fp.probe(x.double(), k)
