#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``factormodeling_tpu_torch``) on one NVIDIA
card and check it. Run from the repository root: ``python3 chip_smoke.py``.

Phases, in order (any failure exits non-zero before the last line):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the build: both CUDA kernels compiled from ``factormodeling_tpu_torch/
   csrc`` in parallel (one ``nvcc`` each), with their build seconds and the
   ``ptxas`` register / shared-memory report;
3. one kernel phase per kernel at the research step's shapes: the kernel
   against its plain PyTorch version on the same inputs, within a stated
   tolerance, with CUDA-event times per launch;
4. the path phase: ``build_research_step`` at F=50 factors, D=1332 dates,
   N=1000 assets (data from ``--seed``), icir_top selection, zscore blend,
   mvo_turnover backtest with ``solver_kernel="fused"``: launch counts,
   leg-sum and weight-cap invariants, a finite summary; then the same step
   with ``solver_kernel="reference"``, held against the fused run;
5. one ``kernels`` JSON line; then the last line
   ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero, printing no result, without one or
without the package beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks used for the bound (NVIDIA data sheet, dense, 700 W); the
# float64 rate is the CUDA-core one (34 TFLOP/s), not the tensor-core one
_HBM_BYTES_PER_S = 3.35e12
_FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}

F, D, N = 50, 1332, 1000
WINDOW = 60
MAX_WEIGHT = 0.03
T_LOOKBACK, K_LEGS, SEG_LEN = 60, 2, 25

RANK_IC_TOL = 1e-5   # |ic| <= 1; f32 moment sums over 1000 terms in two orders
ADMM_TOL = {"float32": 1e-5,     # scaled iterates; reassociation over 25
            "float64": 1e-12}    # dependent iterations
LEG_TOL = 1e-4       # leg sums after the f32 post-solve renorm
CAP_TOL = 1e-3       # |w| above max_weight on unpolished days: the box
                     # violation the primal residual allows
DW_TOL, DW_SHARE = 1e-4, 0.01   # fused vs reference: per-day max |dw|, share


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, dtype: str = "float32"):
    t_bytes = nbytes / _HBM_BYTES_PER_S * 1e3
    t_ops = flops / _FLOPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean CUDA-event time per call of ``fn`` over ``reps`` calls, after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_inputs(f: int, d: int, n: int, seed: int):
    """The research step's numpy inputs (float32; universe all in)."""
    rng = np.random.default_rng(seed)
    factors = rng.normal(size=(f, d, n)).astype(np.float32)
    factors[rng.uniform(size=factors.shape) < 0.03] = np.nan
    returns = rng.normal(scale=0.02, size=(d, n)).astype(np.float32)
    factor_ret = rng.normal(scale=0.01, size=(d, f)).astype(np.float32)
    cap = rng.integers(1, 4, size=(d, n)).astype(np.float32)
    invest = np.ones((d, n), dtype=np.float32)
    universe = np.ones((d, n), dtype=bool)
    return factors, returns, factor_ret, cap, invest, universe


def factor_names(f: int):
    prefixes = ("alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta")
    suffixes = ("_eq", "_flx", "_long", "_short")
    return tuple(f"{prefixes[i % len(prefixes)]}{i // len(prefixes)}"
                 f"{suffixes[i % len(suffixes)]}" for i in range(f))


def rank_ic_phase(torch, rk, seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    rows, m = F * D, N
    f = rng.normal(size=(rows, m)).astype(np.float32)
    f[rng.uniform(size=f.shape) < 0.03] = np.nan
    f[:500] = np.round(f[:500] * 2.0)            # heavy exact ties
    f[500, :] = 0.0
    f[500, ::2] = -0.0                           # -0.0 ties with +0.0
    f[501] = np.nan                              # all-invalid row
    r = rng.normal(scale=0.02, size=(rows, m)).astype(np.float32)
    key = torch.from_numpy(f).cuda()
    payload = torch.where(torch.isnan(key), 0.0, torch.from_numpy(r).cuda())
    s_key, idx = torch.sort(key, dim=-1)
    r_s = torch.gather(payload, -1, idx)
    ic, cnt = rk.rank_ic_postsort(s_key, r_s)
    ic0, cnt0 = rk.rank_ic_postsort_plain(s_key, r_s)
    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(ic), torch.isnan(ic0)):
        raise AssertionError("rank_ic_postsort: NaN pattern differs from plain")
    if not torch.equal(cnt, cnt0):
        raise AssertionError("rank_ic_postsort: n_valid differs from plain")
    err = float((ic - ic0).abs().nan_to_num().max())
    if not err <= RANK_IC_TOL:
        raise AssertionError(f"rank_ic_postsort: max |err| {err} > {RANK_IC_TOL}")
    ms = cuda_ms(torch, lambda: rk.rank_ic_postsort(s_key, r_s), 20)
    plain_ms = cuda_ms(torch, lambda: rk.rank_ic_postsort_plain(s_key, r_s), 5)
    # each input read once, two floats out per row; ~12 operations per element
    b_ms, b_by = bound(8.0 * rows * m + 8.0 * rows, 12.0 * rows * m)
    log(f"kernel rank_ic_postsort R={rows} M={m}: max_abs_err {err:.3e} "
        f"(tol {RANK_IC_TOL}), {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name="rank_ic_postsort", route="cuda",
                source="factormodeling_tpu_torch/csrc/rank_ic.cu",
                replaces="factormodeling_tpu/metrics/_pallas_rank_ic.py:106",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def admm_phase(torch, seed: int) -> dict:
    """The segment kernel in both instantiations against its plain version;
    the float64 one (what the backtest's QP runs) goes into the JSON line."""
    from factormodeling_tpu_torch.backtest.mvo import (_shrunk_terms,
                                                       _window_factors)
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.solvers.admm_qp import (BoxQPProblem,
                                                          first_segment_inputs)
    from factormodeling_tpu_torch.solvers.portfolio import (equal_leg_fallback,
                                                            leg_constraints)

    rng = np.random.default_rng(seed + 2)
    returns = rng.normal(scale=0.02, size=(200, N))
    signal = rng.normal(size=N)
    entry = None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        r0 = torch.tensor(returns, dtype=dtype, device="cuda")
        sig = torch.tensor(signal, dtype=dtype, device="cuda")
        c, t_used = _window_factors(r0, 150, T_LOOKBACK)
        alpha, s_row = _shrunk_terms(c, t_used, 0.1)
        s_vec = torch.full((T_LOOKBACK,), s_row, dtype=dtype, device="cuda")
        lo, hi, E, b = leg_constraints(sig, MAX_WEIGHT, dtype)
        prob = BoxQPProblem(q=torch.zeros_like(sig), lo=lo, hi=hi, E=E, b=b,
                            l1=0.1, center=equal_leg_fallback(sig))
        ops = first_segment_inputs(2.0 * alpha, c, 2.0 * s_vec, prob)
        assert ops[1].shape == (T_LOOKBACK, N) and ops[4].shape == (K_LEGS, N)
        out = ak.admm_segment(*ops, relax=1.7, seg_len=SEG_LEN)
        ref = ak.admm_segment_plain(*ops, relax=1.7, seg_len=SEG_LEN)
        torch.cuda.synchronize()
        err = max(float((a - b_).abs().max()) for a, b_ in zip(out, ref))
        tol = ADMM_TOL[dname]
        if not err <= tol:
            raise AssertionError(f"admm_segment {dname}: max |err| {err} > {tol}")
        ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, relax=1.7,
                                                    seg_len=SEG_LEN), 50)
        plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(
            *ops, relax=1.7, seg_len=SEG_LEN), 5)
        t, n, k = T_LOOKBACK, N, K_LEGS
        size = out[0].element_size()
        nbytes = size * ((t * n + t * t + 2 * k * n + 10 * n + 1)
                         + (3 * n + 1))
        flops = SEG_LEN * (4.0 * t * n + 2.0 * t * t + 4.0 * k * n + 20.0 * n)
        b_ms, b_by = bound(nbytes, flops, dname)
        log(f"kernel admm_segment {dname} T={t} N={n} K={k} seg_len={SEG_LEN}: "
            f"max_abs_err {err:.3e} (tol {tol}), {ms:.4f} ms/launch, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        entry = dict(name="admm_segment", route="cuda",
                     source="factormodeling_tpu_torch/csrc/admm_segment.cu",
                     replaces="factormodeling_tpu/ops/_pallas_admm.py:188",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None)
    return entry


def run_step(torch, fmt, arrays, kernel: str):
    sim_kwargs = dict(method="mvo_turnover", lookback_period=T_LOOKBACK,
                      max_weight=MAX_WEIGHT, turnover_penalty=0.1,
                      solver_kernel=kernel)
    inputs, cfg = fmt.convert(*arrays, names=factor_names(arrays[0].shape[0]),
                              window=WINDOW, select_method="icir_top",
                              blend_method="zscore", sim_kwargs=sim_kwargs,
                              device="cuda")
    step = fmt.build_research_step(**cfg.as_kwargs())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*inputs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def path_phase(torch, seed: int, kernels: dict) -> None:
    import factormodeling_tpu_torch as fmt
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.solvers.admm_qp import _ADAPT_EVERY

    arrays = make_inputs(F, D, N, seed)
    # warm-up at a cut date range (library handles, allocator, kernel loads)
    run_step(torch, fmt, tuple(a[:, :130] if a.ndim == 3 else a[:130]
                               for a in arrays), "fused")

    rk.launches = ak.launches = 0
    out, secs = run_step(torch, fmt, arrays, "fused")
    launches = {"rank_ic_postsort": rk.launches, "admm_segment": ak.launches}
    log(f"path fused: F={F} D={D} N={N} step {secs:.3f} s wall; launches "
        f"{json.dumps(launches)}")

    summ = {k: float(v) for k, v in out.summary._asdict().items()}
    log("path fused summary " + json.dumps(summ))
    if not all(np.isfinite(v) for v in summ.values()):
        raise AssertionError(f"non-finite summary {summ}")
    diag = out.sim.diagnostics
    traded = (diag.active & diag.solver_ok).cpu().numpy()
    leg_dev = float(torch.maximum((diag.long_sum - 1.0).abs(),
                                  (diag.short_sum + 1.0).abs())
                    .cpu().numpy()[traded].max())
    w = out.sim.weights.nan_to_num()
    cap_excess = float((w.abs() - MAX_WEIGHT).max())
    polished = int(diag.polished.sum())
    log(f"path fused invariants: {int(traded.sum())} traded days, max leg-sum "
        f"deviation {leg_dev:.3e} (tol {LEG_TOL}), max |w| - max_weight "
        f"{cap_excess:.3e} (tol {CAP_TOL}), polish accepted on {polished} days")
    if not leg_dev <= LEG_TOL:
        raise AssertionError(f"leg sums off by {leg_dev}")
    if not cap_excess <= CAP_TOL:
        raise AssertionError(f"|w| exceeds max_weight by {cap_excess}")
    iters = fmt.SimulationSettings(
        returns=None, cap_flag=None, investability_flag=None,
        method="mvo_turnover").resolved_qp_iters(turnover=True)
    want = D * -(-iters // _ADAPT_EVERY)   # every date solves, warm or not
    if launches["rank_ic_postsort"] < 1:
        raise AssertionError("rank_ic_postsort never launched on the path")
    if launches["admm_segment"] != want:
        raise AssertionError(f"admm_segment launched {launches['admm_segment']}"
                             f" times, the schedule implies {want}")
    kernels["rank_ic_postsort"]["launches"] = launches["rank_ic_postsort"]
    kernels["admm_segment"]["launches"] = launches["admm_segment"]

    ref, ref_secs = run_step(torch, fmt, arrays, "reference")
    log(f"path reference: step {ref_secs:.3f} s wall")
    dw = (out.sim.weights.nan_to_num() - ref.sim.weights.nan_to_num()).abs()
    day_dw = dw.max(-1).values
    share = float((day_dw > DW_TOL).double().mean())
    log(f"path fused vs reference: max |dw| {float(dw.max()):.3e}, share of "
        f"days with |dw| > {DW_TOL}: {share:.4f} (limit {DW_SHARE})")
    if not share <= DW_SHARE:
        raise AssertionError(f"fused and reference weights differ on "
                             f"{share:.2%} of days")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from factormodeling_tpu_torch import _build
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall")
    for lib, info in built.items():
        log(f"build {lib}: {info['seconds']:.2f} s")
        for line in info["ptxas"]:
            log(f"  {line}")

    kernels = {"rank_ic_postsort": rank_ic_phase(torch, rk, args.seed),
               "admm_segment": admm_phase(torch, args.seed)}
    path_phase(torch, args.seed, kernels)

    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in order}
                                for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
