#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``factormodeling_tpu_torch``) on one NVIDIA
card and check it. Run from the repository root: ``python3 chip_smoke.py``.

Phases, in order (any failure exits non-zero before the last line):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the build: the six CUDA kernel libraries compiled from
   ``factormodeling_tpu_torch/csrc`` in parallel (one ``nvcc`` each), with
   their build seconds and the ``ptxas`` register / shared-memory report;
3. the kernel phases at the research step's shapes, each kernel against its
   plain PyTorch version on the same inputs, within a stated tolerance,
   with CUDA-event times per launch: rank-IC; the ADMM segment; its
   Anderson form (depth 5, the conv tally, a last segment) in float64 and
   float32; and its lane form, 32 lanes in one launch against 32 separate
   plain calls; then, at the JAX package's ``bench.py`` shapes, the
   window-streaming kernel's four forms (decay, rank, std, zscore) called
   through the public ops at D=5040, N=5000, W=150 with an edge panel
   (windows past every tile, D < W, constant and +-inf windows, float64, a
   ragged universe) and the ``conv1d`` time of the decay's weighted sum; and
   the fused z-score/group-neutralize kernel at [50, 1260, 3000], G=11, held
   against its plain version and the composition, with an edge panel and
   rows wider than its shared-memory tile; the fused rank-IC sort (K3) at
   the research step's 66,600 rows of 1000 against its plain version, the
   post-sort route (``torch.sort`` + K1) and an edge panel of widths 128 to
   8192; the FP32 probe (K6) against its plain version, then its rate at
   [64, 50400, 128] through ``fp32_probe.measure``;
4. three paths of ``build_research_step`` at F=50 factors, D=1332 dates,
   N=1000 assets (data from ``--seed``), icir_top selection, zscore blend,
   ``solver_kernel="fused"``: (1) mvo_turnover with the sample covariance,
   (2) plain mvo in lanes of ``mvo_batch``, (3) mvo_turnover with the
   statistical risk model (20 factors, 252-day lookback, refit every 21
   days) and the Anderson accelerator. Each: the kernels' launch counts
   against the path's schedule, leg-sum and weight-cap invariants, a finite
   summary; then the same step with ``solver_kernel="reference"``, held
   against the fused run;
5. path 4, the notebook's decay-window sensitivity sweep at F=50, D=1332,
   N=1000: ``fmt.ops.cs_zscore_group_neutralize(..., use_kernel=True)`` on
   the factor stack with an 11-industry map, the equal-weight static zscore
   composite, and ``fmt.analytics.decay_sensitivity`` over the 18 default
   windows with the equal-weight backtest; one fused-kernel launch and 17
   window launches; the neutralized stack and the timed run's decayed
   signals held against the plain versions, and the sweep's daily returns,
   annualized returns and Sharpes against the same sweep on the CPU;
6. path 5, factor scoring and selection at F=50, D=1332, N=1000 with
   ``FM_RANK_IC_FUSED=1``: ``fmt.metrics.single_factor_metrics`` (one K3
   launch; held against the post-sort route with the switch unset), then
   ``build_research_step`` with ``icir_top`` (K3 again), ``mvo``, ``pca``
   and ``regression`` selection at window 60, each blended and backtested
   with equal weights; two K3 launches in all; then the same path on the
   CPU from the same inputs, held against the card;
7. one ``kernels`` JSON line; then the last line
   ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero, printing no result, without one or
without the package beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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

# the window-streaming kernel at bench.py's rolling_ops shape
K4_D, K4_N, K4_W, K4_NAN = 5040, 5000, 150, 0.002
# kernel vs plain: the same operations in the same order, all rounded to
# nearest (no contracted multiply-add), so equal to the bit where PyTorch's
# division and square root are correctly rounded; rank is held exactly (its
# counts are exact, only the last division rounds); the others allow a few
# units in the last place of values of order 1-10
K4_TOL = {"float32": {"decay": 1e-6, "rank": 0.0, "std": 1e-6,
                      "zscore": 1e-5},
          "float64": {"decay": 1e-12, "rank": 0.0, "std": 1e-12,
                      "zscore": 1e-11}}
# operations per lag and cell, for the bound: decay valid test, select,
# multiply, add, count; rank two compares, two adds, valid test, count;
# std / zscore pass 1 valid test, add, count, min, max and pass 2 valid
# test, subtract, multiply, add
K4_OPS = {"decay": 5, "rank": 6, "std": 9, "zscore": 9}
# the fused z-score/group-neutralize kernel at bench.py's composite_ops shape
K5_F, K5_D, K5_N, K5_G, K5_NAN = 50, 1260, 3000, 11, 0.03
K5_TOL = 2e-5   # the JAX package's own tolerance for its fused kernel: f32
                # row moments and group sums over ~3000 / ~270 terms summed
                # in another order
K5_WIDE = 20000  # a row wider than the kernel's shared-memory tile (16384)
# the fused rank-IC sort (K3): the JAX package's tolerance for its fused
# kernel (tests/test_pallas_rank_ic.py), f32 moment sums in two orders
K3_TOL = 2e-5
K3_EDGE_WIDTHS = (128, 300, 4096, 4097, 8192)
# the FP32 probe (K6) against its plain version at a small shape
K6_SMALL, K6_K = (4, 1000, 129), 64
# path 5 on the card against the same path on the CPU, |d| / (1 + |v|):
# per-date correlations and factor returns carry float32 rounding of ~1e-6,
# which the IR ratios (std ~0.03) amplify to ~3e-5; the t-test p-value's
# prefactor is exp of three float32 lgamma terms of ~3.7e3 at df/2 ~ 665,
# each rounded to ~2e-4, so |d p| reaches ~7e-4 (float32 against float64:
# 4.8e-4 on a 50 x 400 CPU draw; card against CPU at the path's shape:
# 2.0e-4)
P5_METRIC_TOL = {"factor_return_pvalue": 1e-3}
P5_METRIC_TOL_REST = 1e-4
# pca: the leading eigenvector moves by ~ |dC| / (l1 - l2) with |dC| up to
# F * sqrt(T) * eps * l1 (float32 windows of T = 60 returns, F = 50
# factors; ~400 eps l1), and the row normalization divides it by the sum S
# of the clipped loadings (down to ~2e-4 on some dates) and at most doubles
# it besides: per date |dw| <= K * eps * l1 / ((l1 - l2) S) of the card's
# covariance. That worst case (K ~ 1e3) assumes every rounding aligns; the
# card against the CPU at the path's shape reads K ~ 11 on its worst date,
# so the gate holds K = 1e2;
# regression: a ridge solve, 6.8e-8 float32 against float64 on a 50 x 400
# draw
P5_PCA_GAP_K = 1e2
P5_W_TOL = {"regression": 1e-5}
# icir_top and mvo: a score within rounding of a threshold or a top-x
# boundary, or a near-degenerate QP, can move one date's weights; the form
# of the fused-vs-reference gate
P5_DW_TOL, P5_DW_SHARE = 1e-4, 0.01
P5_SELECTORS = {"icir_top": {}, "mvo": {"qp_iters": 500}, "pca": {},
                "regression": {}}

# path 4 on the card against the same sweep on the CPU (the XLA formulation
# of ts_decay, the same backtest): a decayed value that rounds the other way
# at a leg's quantile boundary swaps one name on one day, which moves that
# day's return by ~1e-4 and a Sharpe by ~1e-3
SWEEP_R_TOL, SWEEP_R_SHARE = 1e-6, 0.01   # per-(window, day) |dr|, share
SWEEP_SHARPE_TOL, SWEEP_ANN_TOL = 1e-2, 1e-3


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


def _held(torch, name: str, got, want, tol: float) -> float:
    """Max |got - want| over the cells where both are defined, after
    checking that both are NaN at the same cells; raises beyond ``tol``."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{name}: NaN pattern differs from its reference")
    err = float((got - want).abs().nan_to_num().max()) if got.numel() else 0.0
    if not err <= tol:
        raise AssertionError(f"{name}: max |err| {err} > {tol}")
    return err


def window_edge_panel(rng, shape, dtype):
    """A panel with NaNs, a constant window, constant +inf and -inf runs,
    alternating signed zeros and heavy ties in its first columns."""
    x = rng.normal(size=shape)
    x[rng.uniform(size=shape) < 0.02] = np.nan
    x2 = x.reshape(-1, *shape[-2:])
    x2[0, 10:400, 3] = 7.25
    x2[0, 5:380, 4] = np.inf
    x2[0, 20:25, 5] = -np.inf
    x2[0, :, 6] = np.where(np.arange(shape[-2]) % 2, 0.0, -0.0)
    x2[0, :, 7] = np.round(x2[0, :, 7])
    return x.astype(dtype)


def window_phase(torch, fmt, seed: int) -> dict:
    """The window-streaming kernel's four forms through the public ops at
    D=5040, N=5000, W=150 (float32, 0.2% NaN): one launch each, held against
    the plain versions; then the edge panel. Returns the JSON entries."""
    import torch.nn.functional as tF

    from factormodeling_tpu_torch.ops import _cuda_window as cw

    ops = {"decay": fmt.ops.ts_decay, "rank": fmt.ops.ts_rank,
           "std": fmt.ops.ts_std, "zscore": fmt.ops.ts_zscore}
    plain = {"decay": cw.decay_streaming_plain,
             "rank": cw.ts_rank_streaming_plain,
             "std": cw.ts_std_streaming_plain,
             "zscore": cw.ts_zscore_streaming_plain}
    wrapper = {"decay": cw.decay_streaming, "rank": cw.ts_rank_streaming,
               "std": cw.ts_std_streaming, "zscore": cw.ts_zscore_streaming}
    rng = np.random.default_rng(seed + 3)
    x = rng.normal(size=(K4_D, K4_N)).astype(np.float32)
    x[rng.uniform(size=x.shape) < K4_NAN] = np.nan
    x = torch.from_numpy(x).cuda()
    cells = K4_D * K4_N
    entries = {}
    for form, op in ops.items():
        before = cw.launches
        out = op(x, K4_W)
        torch.cuda.synchronize()
        if cw.launches != before + 1:
            raise AssertionError(f"fmt.ops.ts_{form} launched the window "
                                 f"kernel {cw.launches - before} times, not 1")
        tol = K4_TOL["float32"][form]
        err = _held(torch, f"window {form}", out, plain[form](x, K4_W), tol)
        ms = cuda_ms(torch, lambda: wrapper[form](x, K4_W), 20)
        plain_ms = cuda_ms(torch, lambda: plain[form](x, K4_W), 2)
        b_ms, b_by = bound(8.0 * cells, float(K4_OPS[form]) * cells * K4_W)
        lib_ms = None
        if form == "decay":
            # the weighted sum as one convolution along the date axis, on
            # the zero-filled panel (no full-window mask)
            xz = tF.pad(x.nan_to_num(0.0).T.contiguous()[:, None, :],
                        (K4_W - 1, 0))
            w = (torch.arange(1, K4_W + 1, dtype=x.dtype, device=x.device)
                 / (K4_W * (K4_W + 1) / 2.0)).view(1, 1, K4_W)
            conv = tF.conv1d(xz, w)[:, 0, :].T
            full = ~torch.isnan(out)
            conv_err = float((conv[full] - out[full]).abs().max())
            lib_ms = cuda_ms(torch, lambda: tF.conv1d(xz, w), 20)
            log(f"library conv1d (zero-filled, no window mask) {lib_ms:.4f} "
                f"ms; max |conv1d - kernel| on full windows {conv_err:.3e}")
        log(f"kernel window_stream {form} float32 D={K4_D} N={K4_N} W={K4_W}: "
            f"max_abs_err {err:.3e} (tol {tol}), {ms:.4f} ms/launch, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        entries[form] = dict(
            name=f"window_{form}", route="cuda",
            source="factormodeling_tpu_torch/csrc/window_stream.cu",
            replaces="factormodeling_tpu/ops/_pallas_window.py:169",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
    del x

    # edge panel: several 8-row tiles, windows past every tile, D < W,
    # constant and +-inf windows, signed zeros, ties; float32 and float64
    worst = 0.0
    for shape, dname, windows in (((2, 1040, 130), "float32", (16, 100, 350)),
                                  ((1040, 130), "float64", (100,)),
                                  ((3, 40, 33), "float32", (100,))):
        xe = torch.from_numpy(window_edge_panel(rng, shape, dname)).cuda()
        for w in windows:
            for form in ops:
                got = wrapper[form](xe, w)
                worst = max(worst, _held(torch, f"window {form} edge {dname} "
                                         f"{shape} W={w}", got,
                                         plain[form](xe, w),
                                         K4_TOL[dname][form]))
                if shape[-2] < w and not torch.isnan(got).all():
                    raise AssertionError(f"window {form}: W={w} > D gave a "
                                         "defined cell")
    # a ragged universe: the compacted columns end in NaN; the card's public
    # op against the CPU op (the XLA formulation) in float64
    xr = window_edge_panel(rng, (300, 200), "float64")
    uni = rng.uniform(size=xr.shape) > 0.15
    xr_t, uni_t = torch.from_numpy(xr), torch.from_numpy(uni)
    worst_r = 0.0
    for form, op in ops.items():
        worst_r = max(worst_r, _held(torch, f"ts_{form} ragged universe",
                        op(xr_t.cuda(), 20, universe=uni_t.cuda()).cpu(),
                        op(xr_t, 20, universe=uni_t), 1e-10))
    log(f"kernel window_stream edge panel (W=16/100/350 over 8-row tiles, "
        f"D < W, constant and +-inf windows, float64): max_abs_err vs plain "
        f"{worst:.3e}; ragged universe vs the CPU op (float64) max_abs_err "
        f"{worst_r:.3e} (tol 1e-10)")
    return entries


def group_phase(torch, fmt, seed: int) -> dict:
    """The fused z-score/group-neutralize kernel through
    ``cs_zscore_group_neutralize(..., use_kernel=True)`` at [50, 1260,
    3000], G=11, against its plain version and the composition; then an
    edge panel at N=200."""
    from factormodeling_tpu_torch.ops import _cuda_fused as cf

    rng = np.random.default_rng(seed + 4)
    x = rng.normal(size=(K5_F, K5_D, K5_N)).astype(np.float32)
    x[rng.uniform(size=x.shape) < K5_NAN] = np.nan
    gid = rng.integers(0, K5_G, size=(K5_D, K5_N)).astype(np.int32)
    gid[rng.uniform(size=gid.shape) < 0.01] = -1
    x, gid = torch.from_numpy(x).cuda(), torch.from_numpy(gid).cuda()
    op = fmt.ops.cs_zscore_group_neutralize
    before = cf.launches
    out = op(x, gid, K5_G, use_kernel=True)
    torch.cuda.synchronize()
    if cf.launches != before + 1:
        raise AssertionError("cs_zscore_group_neutralize(use_kernel=True) "
                             f"launched {cf.launches - before} times, not 1")
    err = _held(torch, "zscore_group plain", out,
                cf.zscore_group_neutralize_plain(x, gid, K5_G), K5_TOL)
    err_c = _held(torch, "zscore_group composition", out, op(x, gid, K5_G),
                  K5_TOL)
    if not torch.equal(out.nan_to_num(), cf.zscore_group_neutralize_fused(
            x, gid, K5_G).nan_to_num()):
        raise AssertionError("zscore_group: two runs differ")
    ms = cuda_ms(torch, lambda: cf.zscore_group_neutralize_fused(x, gid, K5_G),
                 20)
    plain_ms = cuda_ms(torch, lambda: cf.zscore_group_neutralize_plain(
        x, gid, K5_G), 3)
    comp_ms = cuda_ms(torch, lambda: op(x, gid, K5_G), 3)
    cells = K5_F * K5_D * K5_N
    b_ms, b_by = bound(8.0 * cells + 4.0 * K5_D * K5_N,
                       (10.0 + 2.0 * K5_G) * cells)
    log(f"kernel zscore_group float32 F={K5_F} D={K5_D} N={K5_N} G={K5_G}: "
        f"max_abs_err {err:.3e} vs plain, {err_c:.3e} vs the composition "
        f"(tol {K5_TOL}), bitwise equal over two runs; {ms:.4f} ms/launch, "
        f"plain {plain_ms:.4f} ms, composition {comp_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    del x, gid, out

    # edge panel: gid -1 rows, a constant date, an all-NaN date, an empty
    # group, a single-member group, an id past the groups
    xe = rng.normal(size=(2, 600, 200)).astype(np.float32)
    xe[rng.uniform(size=xe.shape) < 0.1] = np.nan
    xe[0, 3, :] = 7.5
    xe[1, 4, :] = np.nan
    ge = rng.integers(-1, 4, size=(600, 200)).astype(np.int32)  # group 4 empty
    ge[6, :128] = -1
    ge[7, :] = 0
    ge[7, 9] = 3
    ge[8, 11] = K5_G + 2
    xe, ge = torch.from_numpy(xe).cuda(), torch.from_numpy(ge).cuda()
    got = op(xe, ge, 5, use_kernel=True)
    e1 = _held(torch, "zscore_group edge plain", got,
               cf.zscore_group_neutralize_plain(xe, ge, 5), K5_TOL)
    e2 = _held(torch, "zscore_group edge composition", got, op(xe, ge, 5),
               K5_TOL)
    if not (torch.isnan(got[0, 3]).all() and torch.isnan(got[1, 4]).all()
            and torch.isnan(got[:, 8, 11]).all()):
        raise AssertionError("zscore_group edge: constant / all-NaN date or "
                             "an id past the groups not NaN")
    log(f"kernel zscore_group edge panel N=200: max_abs_err {e1:.3e} vs "
        f"plain, {e2:.3e} vs the composition")
    # rows wider than the shared-memory tile keep their z-values in the
    # output row: the same kernel, the same fixed-order sums
    xw = rng.normal(size=(2, 24, K5_WIDE)).astype(np.float32)
    xw[rng.uniform(size=xw.shape) < K5_NAN] = np.nan
    gw = rng.integers(-1, K5_G, size=(24, K5_WIDE)).astype(np.int32)
    gw = torch.from_numpy(gw).cuda()
    wide = []
    for dtype, tol in ((torch.float32, K5_TOL), (torch.float64, 1e-12)):
        xt = torch.from_numpy(xw).to("cuda", dtype)
        before = cf.launches
        got = op(xt, gw, K5_G, use_kernel=True)
        torch.cuda.synchronize()
        if cf.launches != before + 1:
            raise AssertionError(f"zscore_group N={K5_WIDE}: the public op "
                                 "did not launch the kernel")
        wide.append(_held(torch, f"zscore_group N={K5_WIDE} {dtype}", got,
                          cf.zscore_group_neutralize_plain(xt, gw, K5_G),
                          tol))
        if not torch.equal(got.nan_to_num(), cf.zscore_group_neutralize_fused(
                xt, gw, K5_G).nan_to_num()):
            raise AssertionError(f"zscore_group N={K5_WIDE}: two runs differ")
    log(f"kernel zscore_group wide rows N={K5_WIDE} (past the "
        f"shared-memory tile): max_abs_err vs plain {wide[0]:.3e} float32 "
        f"(tol {K5_TOL}), {wide[1]:.3e} float64 (tol 1e-12); bitwise equal "
        f"over two runs")
    return dict(name="zscore_group_neutralize", route="cuda",
                source="factormodeling_tpu_torch/csrc/zscore_group.cu",
                replaces="factormodeling_tpu/ops/_pallas_fused.py:79",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def decay_path(torch, fmt, seed: int) -> dict:
    """Path 4: the notebook's decay-window sensitivity sweep. The factor
    stack is z-scored and industry-neutralized by the fused kernel, blended
    into the static equal-weight zscore composite, and swept over the 18
    default decay windows with the equal-weight backtest. Returns the
    kernels' launches in the timed run."""
    from factormodeling_tpu_torch.composite import composite_weighted
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.ops import _cuda_fused as cf
    from factormodeling_tpu_torch.ops import _cuda_window as cw

    factors, returns, _, cap, invest, universe = make_inputs(F, D, N, seed)
    rng = np.random.default_rng(seed + 5)
    ind = rng.integers(0, 11, size=(D, N))
    ind[rng.uniform(size=ind.shape) < 0.01] = -1
    t = {k: torch.from_numpy(v).cuda() for k, v in dict(
        factors=factors, returns=returns, cap=cap, invest=invest,
        universe=universe, ind=ind.astype(np.int32)).items()}
    names = factor_names(F)
    periods = fmt.analytics.DEFAULT_DECAY_PERIODS

    def sweep(d):
        settings = fmt.SimulationSettings(
            returns=t["returns"][:d], cap_flag=t["cap"][:d],
            investability_flag=t["invest"][:d], universe=t["universe"][:d],
            method="equal")
        neutral = fmt.ops.cs_zscore_group_neutralize(
            t["factors"][:, :d], t["ind"][:d], 11,
            universe=t["universe"][:d], use_kernel=True)
        composite = composite_weighted(
            neutral, names, torch.full((d, F), 1.0 / F,
                                       device=t["factors"].device),
            method="zscore", universe=t["universe"][:d])
        sens = fmt.analytics.decay_sensitivity(composite, settings, periods,
                                               universe=t["universe"][:d])
        return neutral, composite, sens

    sweep(130)   # warm-up: library handles, allocator, kernel loads
    torch.cuda.synchronize()
    rk.launches = ak.launches = cw.launches = cf.launches = 0
    t0 = time.perf_counter()
    neutral, composite, sens = sweep(D)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"window_stream": cw.launches, "zscore_group": cf.launches,
                "rank_ic_postsort": rk.launches, "admm_segment": ak.launches}
    log(f"path decay_sensitivity: F={F} D={D} N={N} G=11, "
        f"{len(periods)} windows: {secs:.3f} s wall; launches "
        f"{json.dumps(launches)}")
    want_k4 = sum(w >= 2 for w in periods)
    if launches["zscore_group"] != 1 or launches["window_stream"] != want_k4:
        raise AssertionError(f"decay path: launches {launches}, expected 1 "
                             f"zscore_group and {want_k4} window_stream")
    ann = sens.annualized_return.cpu().numpy()
    sharpe = sens.sharpe.cpu().numpy()
    log("path decay_sensitivity windows " + json.dumps(list(periods)))
    log("path decay_sensitivity sharpe " + json.dumps(
        [round(float(v), 6) for v in sharpe]))
    log("path decay_sensitivity annualized_return " + json.dumps(
        [round(float(v), 6) for v in ann]))
    if not (np.isfinite(ann).all() and np.isfinite(sharpe).all()):
        raise AssertionError("decay path: non-finite annualized return or "
                             "Sharpe")
    # hold every stage against the plain versions (outside the counted run)
    masked = torch.where(t["universe"], t["factors"], float("nan"))
    err_n = _held(torch, "decay path neutralized stack", neutral,
                  cf.zscore_group_neutralize_plain(masked, t["ind"], 11),
                  K5_TOL)
    err_d = max(_held(torch, f"decay path window {w}", sens.decayed[k],
                      cw.decay_streaming_plain(composite, w),
                      K4_TOL["float32"]["decay"])
                for k, w in enumerate(periods))
    log(f"path decay_sensitivity held: neutralized stack vs plain max_abs_err "
        f"{err_n:.3e} (tol {K5_TOL}); the timed run's 18 decayed signals vs "
        f"plain max_abs_err {err_d:.3e} (tol {K4_TOL['float32']['decay']})")
    # the whole sweep again on the CPU from the same composite
    cpu = {k: v.cpu() for k, v in t.items()}
    t0 = time.perf_counter()
    ref = fmt.analytics.decay_sensitivity(
        composite.cpu(), fmt.SimulationSettings(
            returns=cpu["returns"], cap_flag=cpu["cap"],
            investability_flag=cpu["invest"], universe=cpu["universe"],
            method="equal"), periods, universe=cpu["universe"])
    cpu_secs = time.perf_counter() - t0
    r_card = sens.log_return.cpu()
    dr = (r_card - ref.log_return).abs()
    r_share = float(((dr > SWEEP_R_TOL)
                     | (r_card.isnan() != ref.log_return.isnan()))
                    .double().mean())
    dr = dr.nan_to_num(0.0)
    d_sh = float((sens.sharpe.cpu() - ref.sharpe).abs().max())
    d_ann = float((sens.annualized_return.cpu()
                   - ref.annualized_return).abs().max())
    log(f"path decay_sensitivity vs the CPU sweep ({cpu_secs:.1f} s): max "
        f"|d sharpe| {d_sh:.3e} (tol {SWEEP_SHARPE_TOL}), max |d annualized "
        f"return| {d_ann:.3e} (tol {SWEEP_ANN_TOL}), max |d daily return| "
        f"{float(dr.max()):.3e}, share of (window, day) with |dr| > "
        f"{SWEEP_R_TOL}: {r_share:.5f} (limit {SWEEP_R_SHARE})")
    if not (d_sh <= SWEEP_SHARPE_TOL and d_ann <= SWEEP_ANN_TOL
            and r_share <= SWEEP_R_SHARE):
        raise AssertionError("decay path: the card's sweep and the CPU's "
                             "differ")
    return launches


def rank_sort_edge(rng, rows: int, n: int):
    """Rows with NaNs and, in its first rows, heavy ties, a constant row, an
    all-NaN row, signed zeros and denormals (tied with 0), +-inf, NaNs with
    other payload bits (one of them negative) and a single valid cell."""
    f = rng.normal(size=(rows, n)).astype(np.float32)
    f[rng.uniform(size=f.shape) < 0.05] = np.nan
    f[0] = np.round(f[0] * 2.0)
    f[1] = 3.0
    f[2] = np.nan
    f[3, ::2] = -0.0
    f[3, 1::2] = 0.0
    f[3, :5] = (1.0, -1.0, np.inf, 1e-40, -1e-40)
    f[4, :5] = (np.inf, -np.inf, np.inf, -np.inf, 0.0)
    f.view(np.uint32)[5, :4] = (0xFFC00000, 0x7FC00001, 0xFFFFFFFF,
                                0x7F800001)
    f[6, 1:] = np.nan
    return f


def rank_sort_phase(torch, rk, seed: int) -> dict:
    """K3 at the research step's rows (F*D rows of N) against its plain
    version and the post-sort route (``torch.sort`` + gather + K1), then an
    edge panel of widths 128 to 8192 (8192: 96 KB of dynamic shared
    memory)."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_sort as rs

    rng = np.random.default_rng(seed + 6)
    worst = 0.0
    for n in K3_EDGE_WIDTHS:
        f = rank_sort_edge(rng, 600, n)
        key = torch.from_numpy(f).cuda()
        rr = torch.where(torch.isnan(key), 0.0, torch.from_numpy(
            rng.normal(scale=0.02, size=f.shape).astype(np.float32)).cuda())
        ic, cnt = rs.rank_ic_fused(key, rr)
        ic0, cnt0 = rs.rank_ic_fused_plain(key, rr)
        torch.cuda.synchronize()
        want_cnt = torch.from_numpy((~np.isnan(f)).sum(-1).astype(np.float32))
        if not (torch.equal(cnt.cpu(), want_cnt) and torch.equal(cnt, cnt0)):
            raise AssertionError(f"rank_ic_fused n={n}: n_valid not exact")
        if not torch.equal(torch.isfinite(ic), torch.isfinite(ic0)):
            raise AssertionError(f"rank_ic_fused n={n}: finite pattern "
                                 "differs from plain")
        if torch.isfinite(ic[[1, 2, 6]]).any() or not torch.isfinite(
                ic[[0, 3, 4, 5]]).all():
            raise AssertionError(f"rank_ic_fused n={n}: a constant, all-NaN "
                                 "or one-cell row is finite, or a tied, "
                                 "signed-zero, inf or NaN-payload row is not")
        err = float((ic - ic0).abs().nan_to_num().max())
        if not err <= K3_TOL:
            raise AssertionError(f"rank_ic_fused n={n}: max |err| {err} > "
                                 f"{K3_TOL}")
        worst = max(worst, err)
    log(f"kernel rank_ic_fused edge panel n={list(K3_EDGE_WIDTHS)} (ties, a "
        f"constant row, all-NaN, +-0.0 and denormals, +-inf, NaN payload "
        f"bits, one valid cell): n_valid exact, max_abs_err vs plain "
        f"{worst:.3e} (tol {K3_TOL})")

    rows, n = F * D, N
    f = rng.normal(size=(rows, n)).astype(np.float32)
    f[rng.uniform(size=f.shape) < 0.03] = np.nan
    f[:500] = np.round(f[:500] * 2.0)            # heavy exact ties
    key = torch.from_numpy(f).cuda()
    rr = torch.where(torch.isnan(key), 0.0, torch.from_numpy(
        rng.normal(scale=0.02, size=f.shape).astype(np.float32)).cuda())
    ic, cnt = rs.rank_ic_fused(key, rr)
    ic0, cnt0 = rs.rank_ic_fused_plain(key, rr)

    def post_sort_route():
        s_key, idx = torch.sort(key, dim=-1)
        return rk.rank_ic_postsort(s_key, torch.gather(rr, -1, idx))

    ic1, cnt1 = post_sort_route()
    s_key, _ = torch.sort(key, dim=-1)
    tie_free = ~(s_key[:, 1:] == s_key[:, :-1]).any(-1)
    torch.cuda.synchronize()
    if not (torch.equal(cnt, cnt0) and torch.equal(cnt, cnt1)):
        raise AssertionError("rank_ic_fused: n_valid differs from plain or "
                             "the post-sort route")
    err = _held(torch, "rank_ic_fused vs plain", ic, ic0, K3_TOL)
    err1 = _held(torch, "rank_ic_fused vs torch.sort + K1", ic, ic1, K3_TOL)
    # the same post-sort body: rows without ties sum in the same order
    if not torch.equal(ic[tie_free].nan_to_num(), ic1[tie_free].nan_to_num()):
        raise AssertionError("rank_ic_fused: a tie-free row differs from the "
                             "post-sort route")
    ms = cuda_ms(torch, lambda: rs.rank_ic_fused(key, rr), 20)
    plain_ms = cuda_ms(torch, lambda: rs.rank_ic_fused_plain(key, rr), 3)
    route_ms = cuda_ms(torch, post_sort_route, 20)
    sort_ms = cuda_ms(torch, lambda: torch.sort(key, dim=-1), 20)
    w = max(rs.MIN_WIDTH, 1 << (n - 1).bit_length())
    stages = w.bit_length() - 1
    exchanges = stages * (stages + 1) // 2 * (w // 2) * rows
    # each input read once, two floats out per row; the ranks and moments'
    # ~12 operations per element (the sort's compares are integer work)
    b_ms, b_by = bound(8.0 * rows * n + 8.0 * rows, 12.0 * rows * n)
    log(f"kernel rank_ic_fused R={rows} n={n} (W={w}, "
        f"{exchanges:.4g} compare-exchanges, {16.0 * exchanges / 1e9:.1f} GB "
        f"of shared-memory loads): max_abs_err {err:.3e} vs plain, {err1:.3e} "
        f"vs torch.sort + K1 (tol {K3_TOL}), {int(tie_free.sum())} tie-free "
        f"rows bitwise equal to it; {ms:.4f} ms/launch, plain {plain_ms:.4f} "
        f"ms, torch.sort + gather + K1 {route_ms:.4f} ms (torch.sort alone "
        f"{sort_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by})")
    return dict(name="rank_ic_fused", route="cuda",
                source="factormodeling_tpu_torch/csrc/rank_sort.cu",
                replaces="factormodeling_tpu/metrics/_pallas_rank_sort.py:222",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def fp32_probe_phase(torch) -> dict:
    """K6 against its plain version at a small ragged shape, then its rate
    through the probe's entry point, ``fp32_probe.measure``, at
    [64, 50400, 128] with k = 64 and 256; returns the JSON entry with the
    launches of that run."""
    from factormodeling_tpu_torch import fp32_probe as fp

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(K6_SMALL, generator=gen, device="cuda")
    got, want = fp.probe(x, K6_K), fp.probe_plain(x, K6_K)
    torch.cuda.synchronize()
    tol = fp.plain_tolerance(want, K6_K)
    err = float((got - want).abs().max())
    if not err <= tol:
        raise AssertionError(f"fp32_probe: max |err| {err} > {tol}")
    log(f"kernel fp32_probe {list(K6_SMALL)} k={K6_K}: max_abs_err {err:.3e} "
        f"vs plain (tol {tol:.3e}: k float32 roundings of the final "
        f"magnitude that the FMA skips)")

    fp.launches = 0
    rows = fp.measure()
    launches = fp.launches
    for row in rows:
        log(f"kernel fp32_probe {row['shape']} k={row['k']}: {row['ms']:.4f} "
            f"ms/launch, {row['fma_per_s'] / 1e12:.2f} T FMA/s (FMA counted "
            f"as one), {row['share_of_peak']:.1%} of the data-sheet "
            f"{fp.PEAK_FMA_PER_S / 1e12} T FMA/s, bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']})")
    rate = rows[-1]
    xb = torch.randn(fp.SHAPE, generator=gen, device="cuda")
    plain_ms = cuda_ms(torch, lambda: fp.probe_plain(xb, rate["k"]), 1)
    log(f"kernel fp32_probe plain k={rate['k']}: {plain_ms:.4f} ms")
    return dict(name="fp32_probe", route="cuda",
                source="factormodeling_tpu_torch/csrc/fp32_probe.cu",
                replaces="tools/vpu_probe.py:16", launches=launches,
                max_abs_err=err, ms=rate["ms"], plain_ms=plain_ms,
                bound_ms=rate["bound_ms"], bound_by=rate["bound_by"],
                library_ms=None)


def _scoring_run(torch, fmt, inputs, dev: str):
    """Path 5 once on ``dev``: the metric table, then one research step per
    selector with equal-weight backtests. Returns (table, outputs, seconds
    per piece)."""
    names = factor_names(inputs.factors.shape[0])
    secs = {}
    t0 = time.perf_counter()
    table = fmt.metrics.single_factor_metrics(inputs.factors, inputs.returns,
                                              universe=inputs.universe)
    if dev == "cuda":
        torch.cuda.synchronize()
    secs["single_factor_metrics"] = time.perf_counter() - t0
    outs = {}
    for method, kw in P5_SELECTORS.items():
        step = fmt.build_research_step(names=names, window=WINDOW,
                                       select_method=method, select_kwargs=kw,
                                       sim_kwargs=dict(method="equal"),
                                       device=dev)
        t0 = time.perf_counter()
        outs[method] = step(*inputs)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[method] = time.perf_counter() - t0
    return table, outs, secs


@contextlib.contextmanager
def rank_ic_switch(on: bool):
    """``FM_RANK_IC_FUSED`` set to 1 (on) or removed (off) inside the block,
    whatever the caller's environment held, and restored after it."""
    prev = os.environ.pop("FM_RANK_IC_FUSED", None)
    if on:
        os.environ["FM_RANK_IC_FUSED"] = "1"
    try:
        yield
    finally:
        os.environ.pop("FM_RANK_IC_FUSED", None)
        if prev is not None:
            os.environ["FM_RANK_IC_FUSED"] = prev


def scoring_path(torch, fmt, seed: int) -> dict:
    """Path 5: the metric table and rolling selection by icir_top, mvo, pca
    and regression, each blended and backtested with equal weights, with
    the fused rank-IC kernel switched on. Returns the kernels' launches in
    the timed run."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.metrics import _cuda_rank_sort as rs
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    arrays = make_inputs(F, D, N, seed)
    names = factor_names(F)
    card = fmt.convert(*arrays, names=names, window=WINDOW, device="cuda")[0]
    host = fmt.convert(*arrays, names=names, window=WINDOW, device="cpu")[0]
    cut = type(card)(*(a[:, :130] if a.ndim == 3 else a[:130] for a in card))
    with rank_ic_switch(True):
        _scoring_run(torch, fmt, cut, "cuda")   # warm-up on a cut range
        torch.cuda.synchronize()
        rs.launches = rk.launches = ak.launches = 0
        t0 = time.perf_counter()
        table, outs, secs = _scoring_run(torch, fmt, card, "cuda")
        total = time.perf_counter() - t0
        launches = {"rank_ic_fused": rs.launches,
                    "rank_ic_postsort": rk.launches,
                    "admm_segment": ak.launches}
        t0 = time.perf_counter()
        table_h, outs_h, secs_h = _scoring_run(torch, fmt, host, "cpu")
        total_h = time.perf_counter() - t0
    log(f"path scoring_selection: F={F} D={D} N={N} window {WINDOW}: "
        f"{total:.3f} s wall on the card ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"); launches {json.dumps(launches)}")
    if launches != {"rank_ic_fused": 2, "rank_ic_postsort": 0,
                    "admm_segment": 0}:
        raise AssertionError(f"scoring path: launches {launches}, expected 2 "
                             "rank_ic_fused and nothing else")

    # the metric table: finite, and against the post-sort route (switch
    # unset, outside the counted run): rank-IC columns close, the rest equal
    cols = fmt.metrics.METRIC_COLUMNS
    tab = torch.stack([table[c] for c in cols])            # [7, F]
    if not torch.isfinite(tab).all():
        raise AssertionError("scoring path: non-finite metric table")
    before = rs.launches, rk.launches
    with rank_ic_switch(False):
        unset = fmt.metrics.single_factor_metrics(card.factors, card.returns,
                                                  universe=card.universe)
    if rs.launches != before[0] or rk.launches == before[1]:
        raise AssertionError("scoring path: the switch-unset table did not "
                             "take torch.sort + K1")
    err_rank = max(float((table[c] - unset[c]).abs().max())
                   for c in ("rank_IC", "rank_IC_IR"))
    same = all(torch.equal(table[c], unset[c]) for c in cols
               if c not in ("rank_IC", "rank_IC_IR"))
    log(f"path scoring_selection metric table {len(cols)} x {F}: finite; vs "
        f"torch.sort + K1 (switch unset) rank columns max |d| "
        f"{err_rank:.3e} (tol {RANK_IC_TOL}), other columns identical "
        f"{same}")
    if not (err_rank <= RANK_IC_TOL and same):
        raise AssertionError("scoring path: the fused and post-sort routes' "
                             "tables differ")
    err_tab = {c: float(((table[c].cpu() - table_h[c]).abs()
                         / (1.0 + table_h[c].abs())).max()) for c in cols}

    errs = {}
    for method, out in outs.items():
        sel = out.selection
        rowsum = sel.sum(1)
        if not (bool((sel >= 0).all())
                and bool(((rowsum - 1.0).abs() <= 1e-5)
                         .logical_or(rowsum == 0).all())
                and bool((rowsum > 0).any())):
            raise AssertionError(f"scoring path {method}: weights negative, "
                                 "a row summing to neither 1 nor 0, or no "
                                 "date selected")
        summ = {k: float(v) for k, v in out.summary._asdict().items()}
        if not all(np.isfinite(v) for v in summ.values()):
            raise AssertionError(f"scoring path {method}: non-finite summary "
                                 f"{summ}")
        dw = (sel.cpu() - outs_h[method].selection).abs().max(-1).values
        share = float((dw > P5_DW_TOL).double().mean())
        errs[method] = (float(dw.max()), share)
        summ_h = {k: float(v)
                  for k, v in outs_h[method].summary._asdict().items()}
        log(f"path scoring_selection {method}: {int((rowsum > 0).sum())} "
            f"dates selected; summary {json.dumps(summ)}; vs the CPU: max "
            f"|dw| {errs[method][0]:.3e}, share of dates with |dw| > "
            f"{P5_DW_TOL}: {share:.4f}, max |d sharpe| "
            f"{abs(summ['sharpe'] - summ_h['sharpe']):.3e}")
    log(f"path scoring_selection on the CPU: {total_h:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs_h.items())
        + "); metric table vs the card max |d| / (1 + |v|) per column "
        + json.dumps({c: float(f"{v:.3e}") for c, v in err_tab.items()})
        + f" (tol {P5_METRIC_TOL_REST}, p-value "
        f"{P5_METRIC_TOL['factor_return_pvalue']})")
    if not all(v <= P5_METRIC_TOL.get(c, P5_METRIC_TOL_REST)
               for c, v in err_tab.items()):
        raise AssertionError("scoring path: the card's and the CPU's metric "
                             "tables differ")
    # pca against a per-date bound from the card's own eigenvalue gaps
    from factormodeling_tpu_torch.selection.selectors import (
        SelectionContext, _windowed_moments)
    ctx = SelectionContext(metrics_win={}, factor_ret=card.factor_ret,
                           ret_win_sum=card.factor_ret, window=WINDOW)
    mu, cov = _windowed_moments(ctx, torch.arange(D, device="cuda"),
                                use_shrinkage=True)
    finite = torch.isfinite(cov).all(-1).all(-1) & torch.isfinite(mu).all(-1)
    ev, vec = torch.linalg.eigh(torch.where(finite[:, None, None], cov,
                                            torch.eye(F, device="cuda")))
    lead = vec[..., -1]
    dot = (lead * mu).sum(-1)
    lead = lead * torch.sign(torch.where(dot == 0.0, 1.0, dot))[:, None]
    clipped_sum = lead.clamp(min=0.0).sum(-1)
    bound_t = (P5_PCA_GAP_K * torch.finfo(torch.float32).eps * ev[:, -1]
               / ((ev[:, -1] - ev[:, -2]) * clipped_sum)).cpu()
    dw_pca = (outs["pca"].selection.cpu()
              - outs_h["pca"].selection).abs().max(-1).values
    ratio = float((dw_pca / bound_t)[finite.cpu()].nan_to_num().max())
    log(f"path scoring_selection pca: max over dates of |dw| / "
        f"({P5_PCA_GAP_K:g} eps l1 / ((l1 - l2) S)) {ratio:.3e} (limit 1); "
        f"smallest relative gap "
        f"{float(((ev[:, -1] - ev[:, -2]) / ev[:, -1])[finite].min()):.3e}, "
        f"smallest S {float(clipped_sum[finite].min()):.3e}")
    if not ratio <= 1.0:
        raise AssertionError("scoring path pca: the card's and the CPU's "
                             "weights differ beyond the eigenvalue-gap bound")
    for method, (dw_max, share) in errs.items():
        if method == "pca":
            continue
        ok = (dw_max <= P5_W_TOL[method] if method in P5_W_TOL
              else share <= P5_DW_SHARE)
        if not ok:
            raise AssertionError(f"scoring path {method}: the card's and the "
                                 f"CPU's weights differ (max |dw| {dw_max}, "
                                 f"share {share})")
    return launches


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

    import factormodeling_tpu_torch as fmt

    torch.backends.cudnn.allow_tf32 = False         # full f32 convolution
    kernels = {"rank_ic_postsort": rank_ic_phase(torch, rk, args.seed),
               "admm_segment": admm_phase(torch, args.seed),
               "admm_segment_anderson": anderson_phase(torch, args.seed)}
    t0 = time.perf_counter()
    window = window_phase(torch, fmt, args.seed)
    kernels.update({f"window_{form}": e for form, e in window.items()})
    kernels["zscore_group_neutralize"] = group_phase(torch, fmt, args.seed)
    log(f"ops kernel phases: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    kernels["rank_ic_fused"] = rank_sort_phase(torch, rk, args.seed)
    kernels["fp32_probe"] = fp32_probe_phase(torch)
    log(f"rank-sort and probe kernel phases: {time.perf_counter() - t0:.1f} s "
        f"wall")
    launches = {path: path_phase(torch, args.seed, path, kernels,
                                 warm_up=path == "turnover")
                for path in PATHS}
    t0 = time.perf_counter()
    decay_launches = decay_path(torch, fmt, args.seed)
    log(f"decay path phase (warm-up, run, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    scoring_launches = scoring_path(torch, fmt, args.seed)
    log(f"scoring path phase (warm-up, run, CPU run, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    # each kernel's launches on the path that runs its form
    kernels["rank_ic_postsort"]["launches"] = (
        launches["turnover"]["rank_ic_postsort"])
    kernels["admm_segment"]["launches"] = launches["turnover"]["admm_segment"]
    kernels["admm_segment_anderson"]["launches"] = (
        launches["turnover_risk_anderson"]["admm_segment"])
    # the decay path runs the decay form only; the rank, std and zscore
    # forms run in the kernel phase alone
    for form in window:
        kernels[f"window_{form}"]["launches"] = (
            decay_launches["window_stream"] if form == "decay" else 0)
    kernels["zscore_group_neutralize"]["launches"] = (
        decay_launches["zscore_group"])
    kernels["rank_ic_fused"]["launches"] = scoring_launches["rank_ic_fused"]
    # fp32_probe's launches are those of its own entry point's run

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
