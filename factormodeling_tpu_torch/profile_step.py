"""Profile the research step on the card: where the wall time of the
mvo_turnover day loop goes.

    python -m factormodeling_tpu_torch.profile_step [--dates 200] [--seed 0]

Runs the step once to warm up, then once under ``torch.profiler`` (CPU and
CUDA activities) at F=50 factors, N=1000 assets and ``--dates`` dates, with
``solver_kernel="fused"``, and prints: the wall time per date, the device's
busy share (the union of kernel intervals over the wall time), the host
syncs the run made, the operators with the most host time, and the kernels
with the most device time. Needs one card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import factormodeling_tpu_torch as fmt

_PREFIXES = ("alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta")
_SUFFIXES = ("_eq", "_flx", "_long", "_short")
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _inputs(f, d, n, seed):
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(f, d, n)).astype(np.float32)
    factors[rng.uniform(size=factors.shape) < 0.03] = np.nan
    returns = rng.normal(scale=0.02, size=(d, n)).astype(np.float32)
    factor_ret = rng.normal(scale=0.01, size=(d, f)).astype(np.float32)
    cap = rng.integers(1, 4, size=(d, n)).astype(np.float32)
    return (factors, returns, factor_ret, cap, np.ones((d, n), np.float32),
            np.ones((d, n), bool))


def _busy_ms(events) -> float:
    """Union of the device kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dates", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    f, n = 50, 1000
    names = tuple(f"{_PREFIXES[i % 8]}{i // 8}{_SUFFIXES[i % 4]}"
                  for i in range(f))
    inputs, cfg = fmt.convert(
        *_inputs(f, args.dates, n, args.seed), names=names, window=60,
        sim_kwargs=dict(method="mvo_turnover", lookback_period=60,
                        max_weight=0.03, turnover_penalty=0.1,
                        solver_kernel="fused"))
    step = fmt.build_research_step(**cfg.as_kwargs())
    step(*inputs)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    syncs = sum(1 for e in events if e.name in _SYNC_CALLS)
    d2h = sum(1 for e in events if e.name == "cudaMemcpyAsync")
    busy = _busy_ms(events)
    print(f"card: {torch.cuda.get_device_name(0)}; dates {args.dates}, "
          f"F={f}, N={n}")
    print(f"wall {wall:.3f} s under the profiler, {wall / args.dates * 1e3:.2f}"
          f" ms/date; device busy {busy:.1f} ms = "
          f"{busy / (wall * 1e3):.3%} of wall")
    print(f"host sync calls {syncs}, cudaMemcpyAsync calls {d2h}, "
          f"launches {sum(1 for e in events if e.name == 'cudaLaunchKernel')}")
    table = prof.key_averages()
    print("top host operators by self CPU time:")
    print(table.table(sort_by="self_cpu_time_total", row_limit=15,
                      max_name_column_width=48))
    print("top device kernels by self CUDA time:")
    print(table.table(sort_by="self_cuda_time_total", row_limit=12,
                      max_name_column_width=48))


if __name__ == "__main__":
    main()
