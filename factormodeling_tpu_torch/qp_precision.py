"""Measure how the turnover backtest's weights depend on the QP's working
precision and on the solver kernel.

    python -m factormodeling_tpu_torch.qp_precision [--dates 1332] [--assets 1000] [--device cuda]

Runs ``run_simulation(method="mvo_turnover")`` on ``bench.py``'s synthetic
market recipe (float32 panels: returns N(0, 0.02), cap tiers 1-3, signal
N(0, 1), seed 0; lookback 60, max_weight 0.03, turnover penalty 0.1) with
the QP solved in float32 and in float64 (``backtest.mvo.QP_DTYPE``, set for
the duration of each run) and each solver kernel, then prints, for pairs of
runs, the max |dw| and the share of days whose max |dw| exceeds 1e-4.
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from factormodeling_tpu_torch._device import resolve_device
from factormodeling_tpu_torch.backtest import SimulationSettings, mvo, run_simulation


def _run(returns, cap, signal, qp_dtype, kernel):
    d, n = returns.shape
    s = SimulationSettings(returns=returns, cap_flag=cap,
                           investability_flag=torch.ones_like(returns),
                           method="mvo_turnover", lookback_period=60,
                           max_weight=0.03, turnover_penalty=0.1,
                           solver_kernel=kernel)
    saved, mvo.QP_DTYPE = mvo.QP_DTYPE, qp_dtype
    try:
        t0 = time.perf_counter()
        out = run_simulation(signal, s)
        w = out.weights.nan_to_num().double()
        if w.is_cuda:
            torch.cuda.synchronize()
        return w, time.perf_counter() - t0
    finally:
        mvo.QP_DTYPE = saved


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dates", type=int, default=1332)
    ap.add_argument("--assets", type=int, default=1000)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    shape = (args.dates, args.assets)
    returns = torch.tensor(rng.normal(scale=0.02, size=shape), dtype=torch.float32, device=dev)
    cap = torch.tensor(rng.integers(1, 4, size=shape), dtype=torch.float32, device=dev)
    signal = torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"device {name}; {args.dates} dates x {args.assets} assets")
    runs = {}
    for qp in (torch.float32, torch.float64):
        for kernel in ("reference", "fused"):
            runs[(qp, kernel)], secs = _run(returns, cap, signal, qp, kernel)
            print(f"qp {qp} kernel {kernel}: {secs:.3f} s")
    for a, b in itertools.combinations(runs, 2):
        day = (runs[a] - runs[b]).abs().max(-1).values
        bad = day > 1e-4
        first = int(bad.nonzero()[0]) if bool(bad.any()) else -1
        print(f"{a[0]} {a[1]} vs {b[0]} {b[1]}: max |dw| {float(day.max()):.3e}, "
              f"days > 1e-4: {float(bad.double().mean()):.4f}, first such day {first}")


if __name__ == "__main__":
    main()
