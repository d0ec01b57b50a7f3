#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``factormodeling_tpu_torch``) on one NVIDIA
card and check it. Run from the repository root: ``python3 chip_smoke.py``.

Phases, in order (any failure exits non-zero before the last line):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the build: both CUDA kernels compiled from ``factormodeling_tpu_torch/
   csrc`` in parallel (one ``nvcc`` each), with their build seconds and the
   ``ptxas`` register / shared-memory report;
3. the kernel phases at the research step's shapes, each kernel against its
   plain PyTorch version on the same inputs, within a stated tolerance,
   with CUDA-event times per launch: rank-IC; the ADMM segment; its
   Anderson form (depth 5, the conv tally, a last segment) in float64 and
   float32; and its lane form, 32 lanes in one launch against 32 separate
   plain calls;
4. three paths of ``build_research_step`` at F=50 factors, D=1332 dates,
   N=1000 assets (data from ``--seed``), icir_top selection, zscore blend,
   ``solver_kernel="fused"``: (1) mvo_turnover with the sample covariance,
   (2) plain mvo in lanes of ``mvo_batch``, (3) mvo_turnover with the
   statistical risk model (20 factors, 252-day lookback, refit every 21
   days) and the Anderson accelerator. Each: the kernels' launch counts
   against the path's schedule, leg-sum and weight-cap invariants, a finite
   summary; then the same step with ``solver_kernel="reference"``, held
   against the fused run;
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
AA_DEPTH, AA_SEG_LEN, LANES = 5, 20, 32
AA_TOL = {"float32": 1e-4,   # float32 rounding of the reassociated sums over
                             # 20 dependent iterations, which each accepted
                             # extrapolation (gamma up to ~1e2) amplifies
          "float64": 1e-10}  # the same at float64 rounding; tallies equal
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


def segment_ops(torch, dtype, seed: int, lanes: int, l1: float):
    """The first-segment operands of ``lanes`` MVO days (days 150, 151, ...
    of a random 200 x N panel) at T=60, N=1000, as the solver builds them:
    plain-MVO days for ``l1 = 0``, turnover days around equal leg weights
    otherwise. Lane axis kept for ``lanes > 1``."""
    from factormodeling_tpu_torch.backtest.mvo import (_shrunk_terms,
                                                       _window_factors)
    from factormodeling_tpu_torch.solvers.admm_qp import (BoxQPProblem,
                                                          first_segment_inputs)
    from factormodeling_tpu_torch.solvers.portfolio import (equal_leg_fallback,
                                                            leg_constraints)

    rng = np.random.default_rng(seed + 2)
    returns = torch.tensor(rng.normal(scale=0.02, size=(200, N)), dtype=dtype,
                           device="cuda")
    sig = torch.tensor(rng.normal(size=(lanes, N)), dtype=dtype, device="cuda")
    todays = torch.arange(150, 150 + lanes, device="cuda")
    c, t_used = _window_factors(returns, todays, T_LOOKBACK)
    alpha, s_row = _shrunk_terms(c, t_used, 0.1)
    s_vec = s_row[:, None].expand(lanes, T_LOOKBACK)
    lo, hi, E, b = leg_constraints(sig, MAX_WEIGHT, dtype)
    center = equal_leg_fallback(sig) if l1 else torch.zeros_like(sig)
    prob = BoxQPProblem(q=torch.zeros_like(sig), lo=lo, hi=hi, E=E, b=b,
                        l1=l1, center=center)
    ops = first_segment_inputs(2.0 * alpha, c, 2.0 * s_vec, prob)
    return tuple(o[0] for o in ops) if lanes == 1 else ops


def segment_bound(ops, seg_len: int, anderson: int, dname: str):
    """The least time of one segment launch: each operand read once, each
    output written once; the iteration's operations, with the Anderson
    Gram, right-hand sides, mixing and tests at depth ``anderson``."""
    lanes = ops[1].shape[0] if ops[1].ndim == 3 else 1
    t, n = ops[1].shape[-2:]
    k = ops[4].shape[-2]
    size = ops[1].element_size()
    nbytes = lanes * size * ((t * n + t * t + 2 * k * n + 10 * n + 1)
                             + (3 * n + 4))
    m = anderson
    aa = (2.0 * (m * (m + 1) / 2 + m) + 3.0 * m + 10.0) * 2 * n if m else 0.0
    flops = lanes * seg_len * (4.0 * t * n + 2.0 * t * t + 4.0 * k * n
                               + 20.0 * n + aa)
    return bound(nbytes, flops, dname)


def admm_phase(torch, seed: int) -> dict:
    """The segment kernel in both instantiations against its plain version;
    the float64 one (what the backtest's QP runs) goes into the JSON line."""
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    entry = None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        ops = segment_ops(torch, dtype, seed, 1, 0.1)
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
        b_ms, b_by = segment_bound(ops, SEG_LEN, 0, dname)
        log(f"kernel admm_segment {dname} T={T_LOOKBACK} N={N} K={K_LEGS} "
            f"seg_len={SEG_LEN}: max_abs_err {err:.3e} (tol {tol}), "
            f"{ms:.4f} ms/launch, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
        entry = dict(name="admm_segment", route="cuda",
                     source="factormodeling_tpu_torch/csrc/admm_segment.cu",
                     replaces="factormodeling_tpu/ops/_pallas_admm.py:188",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None)
    return entry


def anderson_phase(torch, seed: int) -> dict:
    """The Anderson form (depth 5, the conv tally, a last segment) on a
    plain-MVO day in both types, then the lane form: 32 lanes in one launch
    against 32 separate plain calls. The float64 single-lane numbers go into
    the JSON line."""
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    kw = dict(relax=1.7, seg_len=AA_SEG_LEN, last=True, anderson=AA_DEPTH,
              collect=True)
    entry = None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        ops = segment_ops(torch, dtype, seed, 1, 0.0)
        out = ak.admm_segment(*ops, **kw)
        ref = ak.admm_segment_plain(*ops, **kw)
        torch.cuda.synchronize()
        err = max(float((a - b_).abs().max()) for a, b_ in zip(out[:4], ref[:4]))
        tallies = [int(a) for a in out[4:]], [int(a) for a in ref[4:]]
        tol = AA_TOL[dname]
        if not err <= tol:
            raise AssertionError(f"admm_segment anderson {dname}: max |err| "
                                 f"{err} > {tol}")
        if dname == "float64" and tallies[0] != tallies[1]:
            raise AssertionError(f"admm_segment anderson: tallies (acc, rej, "
                                 f"conv) {tallies[0]} vs plain {tallies[1]}")
        if tallies[0][0] < 1:
            raise AssertionError("admm_segment anderson: no extrapolation taken")
        ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, **kw), 50)
        plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(*ops, **kw), 3)
        b_ms, b_by = segment_bound(ops, AA_SEG_LEN, AA_DEPTH, dname)
        log(f"kernel admm_segment anderson={AA_DEPTH} {dname} T={T_LOOKBACK} "
            f"N={N} K={K_LEGS} seg_len={AA_SEG_LEN} last collect: max_abs_err "
            f"{err:.3e} (tol {tol}), tallies (acc, rej, conv) {tallies[0]} vs "
            f"plain {tallies[1]}, {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by})")
        entry = dict(name="admm_segment_anderson", route="cuda",
                     source="factormodeling_tpu_torch/csrc/admm_segment.cu",
                     replaces="factormodeling_tpu/ops/_pallas_admm.py:188",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None)

    ops = segment_ops(torch, torch.float64, seed + 1, LANES, 0.0)
    out = ak.admm_segment(*ops, **kw)
    err, same = 0.0, True
    for i in range(LANES):
        ref = ak.admm_segment_plain(*(o[i] for o in ops), **kw)
        err = max(err, max(float((a[i] - b_).abs().max())
                           for a, b_ in zip(out[:4], ref[:4])))
        same = same and all(int(a[i]) == int(b_) for a, b_ in zip(out[4:],
                                                                   ref[4:]))
    torch.cuda.synchronize()
    if not (err <= AA_TOL["float64"] and same):
        raise AssertionError(f"admm_segment lanes: max |err| {err}, tallies "
                             f"equal {same}")
    ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(*ops, **kw), 3)
    b_ms, b_by = segment_bound(ops, AA_SEG_LEN, AA_DEPTH, "float64")
    log(f"kernel admm_segment lanes B={LANES} anderson={AA_DEPTH} float64: "
        f"max_abs_err {err:.3e} vs {LANES} single-lane plain calls (tol "
        f"{AA_TOL['float64']}), tallies equal; {ms:.4f} ms/launch, plain "
        f"(one {LANES}-lane call) {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by})")
    return entry


#: the three paths' backtest settings (beside max_weight and the kernel)
PATHS = {
    "turnover": dict(method="mvo_turnover", lookback_period=T_LOOKBACK,
                     turnover_penalty=0.1),
    "mvo": dict(method="mvo", lookback_period=T_LOOKBACK),
    # the JAX package's bench.py risk-model configuration
    "turnover_risk_anderson": dict(method="mvo_turnover",
                                   turnover_penalty=0.1,
                                   covariance="risk_model", risk_factors=20,
                                   risk_lookback=252, risk_refit_every=21,
                                   qp_anderson=AA_DEPTH),
}


def run_step(torch, fmt, arrays, path: str, kernel: str):
    sim_kwargs = dict(PATHS[path], max_weight=MAX_WEIGHT, solver_kernel=kernel)
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


def segment_launches(fmt, path: str) -> int:
    """The segment kernel's launches the path's schedule implies: one per
    segment of every solve, a solve being one date (turnover) or one chunk
    of ``mvo_batch`` dates (plain mvo)."""
    from factormodeling_tpu_torch.solvers.admm_qp import _ADAPT_EVERY

    s = fmt.SimulationSettings(returns=None, cap_flag=None,
                               investability_flag=None, **PATHS[path])
    turnover = s.method == "mvo_turnover"
    solves = D if turnover else -(-D // s.mvo_batch)
    return solves * -(-s.resolved_qp_iters(turnover) // _ADAPT_EVERY)


def path_phase(torch, seed: int, path: str, kernels: dict,
               warm_up: bool) -> dict:
    """One path at full size with the fused kernel, its checks, and the
    same step with the reference kernel held against it. Returns the
    kernels' launches in the fused run."""
    import factormodeling_tpu_torch as fmt
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    arrays = make_inputs(F, D, N, seed)
    if warm_up:   # library handles, allocator, kernel loads: a cut date range
        run_step(torch, fmt, tuple(a[:, :130] if a.ndim == 3 else a[:130]
                                   for a in arrays), path, "fused")

    rk.launches = ak.launches = 0
    out, secs = run_step(torch, fmt, arrays, path, "fused")
    launches = {"rank_ic_postsort": rk.launches, "admm_segment": ak.launches}
    log(f"path {path} fused: F={F} D={D} N={N} step {secs:.3f} s wall; "
        f"launches {json.dumps(launches)}")

    summ = {k: float(v) for k, v in out.summary._asdict().items()}
    log(f"path {path} fused summary " + json.dumps(summ))
    if not all(np.isfinite(v) for v in summ.values()):
        raise AssertionError(f"{path}: non-finite summary {summ}")
    diag = out.sim.diagnostics
    traded = (diag.active & diag.solver_ok).cpu().numpy()
    leg_dev = float(torch.maximum((diag.long_sum - 1.0).abs(),
                                  (diag.short_sum + 1.0).abs())
                    .cpu().numpy()[traded].max())
    w = out.sim.weights.nan_to_num()
    cap_excess = float((w.abs() - MAX_WEIGHT).max())
    polished = int(diag.polished.sum())
    aa_acc = diag.anderson_accepted.cpu().numpy()
    log(f"path {path} fused invariants: {int(traded.sum())} traded days, max "
        f"leg-sum deviation {leg_dev:.3e} (tol {LEG_TOL}), max |w| - "
        f"max_weight {cap_excess:.3e} (tol {CAP_TOL}), polish accepted on "
        f"{polished} days, Anderson extrapolations {int(aa_acc.sum())} on "
        f"{int((aa_acc > 0).sum())} days, rollbacks "
        f"{int(diag.anderson_rejected.sum())}, qp_solves "
        f"{int(diag.qp_solves)}")
    if not leg_dev <= LEG_TOL:
        raise AssertionError(f"{path}: leg sums off by {leg_dev}")
    if not cap_excess <= CAP_TOL:
        raise AssertionError(f"{path}: |w| exceeds max_weight by {cap_excess}")
    if int(diag.qp_solves) != D:
        raise AssertionError(f"{path}: {int(diag.qp_solves)} QP solves, not {D}")
    if PATHS[path].get("qp_anderson") and not aa_acc.sum() > 0:
        raise AssertionError(f"{path}: the Anderson accelerator never engaged")
    want = segment_launches(fmt, path)
    if launches["rank_ic_postsort"] < 1:
        raise AssertionError(f"{path}: rank_ic_postsort never launched")
    if launches["admm_segment"] != want:
        raise AssertionError(f"{path}: admm_segment launched "
                             f"{launches['admm_segment']} times, the schedule "
                             f"implies {want}")

    ref, ref_secs = run_step(torch, fmt, arrays, path, "reference")
    log(f"path {path} reference: step {ref_secs:.3f} s wall")
    dw = (out.sim.weights.nan_to_num() - ref.sim.weights.nan_to_num()).abs()
    day_dw = dw.max(-1).values
    share = float((day_dw > DW_TOL).double().mean())
    log(f"path {path} fused vs reference: max |dw| {float(dw.max()):.3e}, "
        f"share of days with |dw| > {DW_TOL}: {share:.4f} (limit {DW_SHARE})")
    if not share <= DW_SHARE:
        raise AssertionError(f"{path}: fused and reference weights differ on "
                             f"{share:.2%} of days")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

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
               "admm_segment": admm_phase(torch, args.seed),
               "admm_segment_anderson": anderson_phase(torch, args.seed)}
    launches = {path: path_phase(torch, args.seed, path, kernels,
                                 warm_up=path == "turnover")
                for path in PATHS}
    # each kernel's launches on the path that runs its form
    kernels["rank_ic_postsort"]["launches"] = (
        launches["turnover"]["rank_ic_postsort"])
    kernels["admm_segment"]["launches"] = launches["turnover"]["admm_segment"]
    kernels["admm_segment_anderson"]["launches"] = (
        launches["turnover_risk_anderson"]["admm_segment"])

    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s wall")
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
