"""FP32 throughput probe for the card: k dependent
``x = fma(x, 1.0000001, 0.5)`` steps over a float32 array, the CUDA kernel
``csrc/fp32_probe.cu`` and its plain PyTorch version.

The counterpart of ``tools/vpu_probe.py::probe``, which measured the TPU
vector unit's elementwise rate. Run it on a machine with the card::

    python -m factormodeling_tpu_torch.fp32_probe

It times [64, 50400, 128] at k = 64 and 256, as the JAX probe did, and
reports ms per launch, FMA/s with an FMA counted as one operation (as
the JAX probe counts it) and the share of the H100's data-sheet 33.5 T
FMA/s (67 TFLOP/s float32 at 700 W). At [64, 50400, 128] (1.65 GB) k = 64
is bytes-bound (3.3 GB moved, 0.99 ms at 3.35 TB/s, against 0.79 ms of
FMAs), so the rate is read at k >= 256 (3.2 ms of FMAs). Nothing is
measured at import.

On a CUDA tensor :func:`probe` launches the kernel or raises; on a CPU
tensor it runs :func:`probe_plain`, whose multiply and add round twice
where the kernel's FMA rounds once (:func:`plain_tolerance`).
"""

from __future__ import annotations

import ctypes
import json

import torch

from factormodeling_tpu_torch import _build

__all__ = ["PEAK_FMA_PER_S", "measure", "plain_tolerance", "probe",
           "probe_plain"]

#: H100 SXM float32 peak outside the tensor cores (data sheet, 700 W)
PEAK_FMA_PER_S = 33.5e12
_HBM_BYTES_PER_S = 3.35e12
#: the JAX probe's shape and step counts
SHAPE = (64, 50400, 128)
STEPS = (64, 256)
_REPS = 5

#: kernel launches since the count was last set to 0
launches = 0


def probe_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """k steps of ``x * 1.0000001 + 0.5`` in PyTorch (two roundings per
    step)."""
    for _ in range(k):
        x = x * 1.0000001 + 0.5
    return x


def plain_tolerance(want: torch.Tensor, k: int) -> float:
    """|probe - probe_plain| allowed: one float32 rounding per step that the
    FMA skips, each at most an ulp of the final magnitude (about 0.5 k plus
    the start), k of them."""
    return k * torch.finfo(torch.float32).eps * float(want.abs().max())


def _lib():
    lib = _build.load("fp32_probe")
    fn = lib.fm_fp32_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def probe(x: torch.Tensor, k: int) -> torch.Tensor:
    """k dependent FMA steps on every element of float32 ``x``: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return probe_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"probe: input on {x.device}, not CUDA or the CPU")
    if x.dtype != torch.float32:
        raise TypeError(f"probe kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("probe takes a contiguous input")
    if k < 0:
        raise ValueError(f"probe takes k >= 0, got {k}")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib()(x.data_ptr(), y.data_ptr(), x.numel(), int(k), stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return y


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(_REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / _REPS


def measure():
    """Time :func:`probe` on the card at ``SHAPE`` for each k in ``STEPS``
    (one warm-up launch, then the mean of 5 launches by CUDA events).
    Returns one dict per k: ``ms``, ``fma_per_s``, ``share_of_peak`` and
    the bound (``bound_ms``, ``bound_by``). Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("fp32_probe measures the card; no CUDA device is "
                           "available")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda", dtype=torch.float32)
    out = []
    for k in STEPS:
        probe(x, k)
        ms = _event_ms(lambda: probe(x, k))
        fmas = float(x.numel()) * k
        t_bytes = 8.0 * x.numel() / _HBM_BYTES_PER_S * 1e3
        t_ops = fmas / PEAK_FMA_PER_S * 1e3
        out.append(dict(k=k, shape=list(SHAPE), ms=ms,
                        fma_per_s=fmas / (ms * 1e-3),
                        share_of_peak=fmas / (ms * 1e-3) / PEAK_FMA_PER_S,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations"))
    return out


def main() -> None:
    rows = measure()
    print(f"card: {torch.cuda.get_device_name(0)}")
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
