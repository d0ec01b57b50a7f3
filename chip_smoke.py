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
   with CUDA-event times per launch: rank-IC; the ADMM segment (one lane a
   cluster of C blocks; its C, shared memory and ``ptxas`` line printed),
   timed as back-to-back launches of its C entry on preallocated operands
   beside the wrapper's time per call: plain (path 1's shape) in float64
   and float32; its lane form, 32 lanes in one launch (path 2's shape)
   against 32 separate plain calls and bitwise against the kernel's own
   single-lane launches; its Anderson form (depth 5, the conv tally, a
   last segment) on a plain-MVO day at T=60, in both types and as 32 lanes
   (no path launches these; the accelerated path is stable there, so they
   hold the tight gates); and the launches path 3 itself makes on the last
   days of a short run (T=20, the L1 term on, warm-started), each day's
   plain form and Anderson form against the plain version; then, at the
   JAX package's ``bench.py`` shapes, the
   window-streaming kernel's four forms (decay, rank, std, zscore) called
   through the public ops at D=5040, N=5000, W=150 with an edge panel
   (windows past every tile, D < W, constant and +-inf windows, float64, a
   ragged universe) and the ``conv1d`` time of the decay's weighted sum;
   the decay form again at path 4's own 17 launches (D=1332, N=1000),
   summed, with the SASS of its middle loop (``cuobjdump``); and
   the fused z-score/group-neutralize kernel at [50, 1260, 3000], G=11, held
   against its plain version and the composition, with an edge panel and
   rows wider than its shared-memory tile; the fused rank-IC sort (K3) at
   the research step's 66,600 rows of 1000 against its plain version, the
   post-sort route (``torch.sort`` + K1) and an edge panel of widths 128 to
   8192 that takes every layout of its sort network; the FP32 probe (K6)
   against its plain version, then its rate at [64, 50400, 128] through
   ``fp32_probe.measure``;
4. three paths of ``build_research_step`` at F=50 factors, D=1332 dates,
   N=1000 assets (data from ``--seed``), icir_top selection, zscore blend,
   ``solver_kernel="fused"``: (1) mvo_turnover with the sample covariance,
   (2) plain mvo in lanes of ``mvo_batch``, (3) mvo_turnover with the
   statistical risk model (20 factors, 252-day lookback, refit every 21
   days) and the Anderson accelerator. Each: the kernels' launch counts
   against the path's schedule, leg-sum and weight-cap invariants, a finite
   summary; then the same step with ``solver_kernel="reference"``, held
   against the fused run (paths 1 and 3: the reference kernel's backtest of
   the fused run's signal over its first ``REF_DATES`` dates, against the
   full run's first days on path 1 and the fused kernel's backtest of the
   same dates on path 3). Then path 1 with ``turnover_mode="parallel"``:
   (6) at its penalty 0.1, held against path 1's own fused output (suffix
   days within ``DW_TOL`` on all but ``DW_SHARE``, certified days both
   polished or neither attempted within ``CERT_TOL``), and (7) at penalty
   0, fused and reference, every day certified, held against the scan of
   its first ``P7_SCAN_DATES`` dates; each with ``sweep_stats``' coverage
   and QP count, and the segment kernel's single-lane and lane-batch
   launches, as its wrapper counts them, each against its term of the
   scheme's schedule;
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
7. path 8, the multi-manager layer: (8a) the notebook's multi-manager
   backtest at F=50, D=1332, N=1000 — icir_top daily factor weights (one K1
   launch), the 50 equal-weight manager books (``pct=0.1``) combined by
   them and backtested with costs through
   ``fmt.multimanager.run_multimanager_backtest`` — held against the
   factor-weighted sum of the books recomputed apart and against the same
   path on the CPU (the books bitwise, the factor weights at path 5's
   icir_top gate, the daily returns where the weights agree); (8b) the
   JAX package's ``bench.py`` config-4 sweep, 1000 combos of 5 of 50
   managers at D=2520, N=1000 in float32, through
   ``fmt.parallel.manager_sweep`` in chunks of 16, with its walls, memory
   peak and share of ``bench.py``'s traffic bound, 8 combos held against
   their own multi-manager backtest and the first 32 against the CPU;
8. one ``kernels`` JSON line; then the last line
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
# path 3's days (turnover, L1 on, warm-started): the accept/reject chain of
# the accelerated path is chaotic, and the kernel parts from the plain
# version by up to ~1e-3 on iterates of size ~2e-2 with one block a lane as
# with eight (segment_phases.py); a quarter of the iterates' size catches
# what is not that chaos (a wrong sign, a lost slice), while each day's
# plain form is held within ADMM_TOL
AA_PATH_TOL = 5e-3
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
# operations the inputs need, for the bound: (per lag and cell, per input
# cell). Per lag the form's arithmetic: decay a multiply and an add; rank
# two compares and two adds; std / zscore an add, a min and a max, then a
# subtract, a multiply and an add. Per input cell one valid test (decay:
# and the select of 0); the walk needs no test, select or count per lag
K4_OPS = {"decay": (2, 2), "rank": (4, 1), "std": (6, 1), "zscore": (6, 1)}
# the fused z-score/group-neutralize kernel at bench.py's composite_ops shape
K5_F, K5_D, K5_N, K5_G, K5_NAN = 50, 1260, 3000, 11, 0.03
K5_TOL = 2e-5   # the JAX package's own tolerance for its fused kernel: f32
                # row moments and group sums over ~3000 / ~270 terms summed
                # in another order
K5_WIDE = 20000  # a row wider than the kernel's shared-memory tile (16384)
# each side of the kernel's forms: one warp of 8 -> 16 cells, one warp ->
# two, the widest register row, the shared-memory form's ends
K5_FORM_WIDTHS = (256, 257, 1024, 1025, 8192, 8193, 16384)
# the most groups the kernel takes, at the top of each team's range
K5_MAX_G, K5_GROUP_WIDTHS = 32, (1000, 1024, 2048, 4096, 8192)
# the fused rank-IC sort (K3): the JAX package's tolerance for its fused
# kernel (tests/test_pallas_rank_ic.py), f32 moment sums in two orders
K3_TOL = 2e-5
# the rank-IC post-sort kernel's edge panel: one position a lane (1, 31),
# three (33), a team of two warps of 17 (1000), five warps (4096) and the
# widest row, a team of 9 warps (57 positions a lane, 64-bit masks) with
# one buffer (16384); 1, 31 and 33 take the 4-byte copies, the others the
# bulk copies
K1_EDGE_WIDTHS = (1, 31, 33, 1000, 4096, 16384)
K3_EDGE_WIDTHS = (128, 300, 4096, 4097, 8192)
# with those, every layout of the sort network: one warp a row with 4 and
# 8 words a thread, then teams of 2, 4 and 8 warps with 8, 16 and 32
# (their own generator, so the phase's rows stay those of earlier runs)
K3_LAYOUT_WIDTHS = (129, 1000, 1025, 2048)
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
# with the same equal-weight leg members on every day, the card's and the
# CPU's backtests differ only by float32 rounding of the daily returns
# (~1e-7 relative), far inside this
P5_SAME_LEGS_SHARPE_TOL = 1e-4
# a day whose members (and the day before's, which set its turnover cost)
# agree: its return is a float32 sum of ~100 weights times returns of
# ~0.02, ~1e-9 apart in two orders; one swapped name moves it by ~4e-4
P5_SAME_LEGS_RET_TOL = 1e-6
# a signal cell this close to 0 has its sign from rounding (the demeaned
# composite's values are O(1))
P5_SIGN_NOISE = 1e-6
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
    log(f"kernel rank_ic_postsort R={rows} M={m} ({json.dumps(rk.postsort_layout(m))}): "
        f"max_abs_err {err:.3e} (tol {RANK_IC_TOL}), {ms:.4f} ms/launch, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del key, payload, s_key, r_s
    # edge panel: every team layout's boundary, both load forms (M % 4)
    worst = 0.0
    for m_e in K1_EDGE_WIDTHS:
        fe = rng.normal(size=(300, m_e)).astype(np.float32)
        fe[rng.uniform(size=fe.shape) < 0.05] = np.nan
        fe[:30] = np.round(fe[:30] * 2.0)        # heavy exact ties
        fe[30] = 0.0
        fe[30, ::2] = -0.0                       # -0.0 ties with +0.0
        fe[31] = np.nan                          # all-invalid row
        fe[32] = 1.5                             # one giant tie run
        ke = torch.from_numpy(fe).cuda()
        pe = torch.where(torch.isnan(ke), 0.0, torch.from_numpy(
            rng.normal(scale=0.02, size=fe.shape).astype(np.float32)).cuda())
        sk, ie = torch.sort(ke, dim=-1)
        re_ = torch.gather(pe, -1, ie)
        got, got_cnt = rk.rank_ic_postsort(sk, re_)
        want, want_cnt = rk.rank_ic_postsort_plain(sk, re_)
        if not torch.equal(got_cnt, want_cnt):
            raise AssertionError(f"rank_ic_postsort M={m_e}: n_valid differs "
                                 "from plain")
        worst = max(worst, _held(torch, f"rank_ic_postsort M={m_e}", got,
                                 want, RANK_IC_TOL))
    log(f"kernel rank_ic_postsort edge panel M={list(K1_EDGE_WIDTHS)} (ties, "
        f"+-0.0, all-invalid and constant rows): n_valid exact, max_abs_err "
        f"vs plain {worst:.3e} (tol {RANK_IC_TOL})")
    return dict(name="rank_ic_postsort", route="cuda",
                source="factormodeling_tpu_torch/csrc/rank_ic.cu",
                replaces="factormodeling_tpu/metrics/_pallas_rank_ic.py:106",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


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


def _lane_axis(ops):
    return ops if ops[1].ndim == 3 else tuple(o[None] for o in ops)


def segment_device_ms(torch, ak, ops, reps: int, **kw):
    """The kernel's device time per launch: ``reps`` back-to-back launches
    of the C entry on operands checked and outputs allocated once (no
    wrapper work between them), CUDA events around all of them."""
    launch, plan = ak.segment_launcher(*_lane_axis(ops), **kw)
    return cuda_ms(torch, launch, reps), plan


def segment_ptxas() -> str:
    """The segment library's ``ptxas`` lines from this run's build."""
    from factormodeling_tpu_torch import _build

    lines = _build.BUILD_LOG.get("admm_segment", {}).get("ptxas", [])
    return " | ".join(lines) or "(built before this run: no report)"


def lanes_vs_single(torch, ak, ops, kw, tol: float, label: str):
    """``LANES`` lanes in one launch against ``LANES`` single-lane plain
    calls (within ``tol``, float64 tallies equal) and against the kernel's
    own single-lane launches of the same lanes, bit for bit."""
    out = ak.admm_segment(*ops, **kw)
    err, same = 0.0, True
    for i in range(LANES):
        lane = tuple(o[i] for o in ops)
        ref = ak.admm_segment_plain(*lane, **kw)
        err = max(err, max(float((a[i] - b_).abs().max())
                           for a, b_ in zip(out[:4], ref[:4])))
        same = same and all(int(a[i]) == int(b_) for a, b_ in zip(out[4:],
                                                                   ref[4:]))
        one = ak.admm_segment(*lane, **kw)
        if not all(torch.equal(a[i], b_) for a, b_ in zip(out, one)):
            raise AssertionError(f"admm_segment {label}: lane {i} of the "
                                 f"{LANES}-lane launch differs from its "
                                 "single-lane launch")
    torch.cuda.synchronize()
    if not (err <= tol and same):
        raise AssertionError(f"admm_segment {label}: max |err| {err} "
                             f"(tol {tol}), tallies equal {same}")
    return err


def admm_phase(torch, seed: int) -> tuple:
    """The segment kernel in both instantiations against its plain version,
    its device time (the C entry alone) beside the wrapper's time, then the
    plain lane form: 32 lanes in one launch (path 2's shape) against 32
    plain calls and bitwise against the kernel's single-lane launches.
    Returns the float64 entries (what the backtest's QP runs)."""
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.segment_phases import sample_day_operands

    kw = dict(relax=1.7, seg_len=SEG_LEN)
    log("kernel admm_segment ptxas: " + segment_ptxas())
    entry = None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        ops = sample_day_operands(dtype, seed + 2, 1, 0.1)
        assert ops[1].shape == (T_LOOKBACK, N) and ops[4].shape == (K_LEGS, N)
        out = ak.admm_segment(*ops, **kw)
        ref = ak.admm_segment_plain(*ops, **kw)
        torch.cuda.synchronize()
        err = max(float((a - b_).abs().max()) for a, b_ in zip(out, ref))
        tol = ADMM_TOL[dname]
        if not err <= tol:
            raise AssertionError(f"admm_segment {dname}: max |err| {err} > {tol}")
        ms, plan = segment_device_ms(torch, ak, ops, 200, **kw)
        wrap_ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, **kw), 50)
        plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(*ops, **kw), 5)
        entry = _segment_entry("admm_segment", ak, ops, kw, err, ms, wrap_ms,
                               plain_ms, dname)
        log(f"kernel admm_segment {dname} T={T_LOOKBACK} N={N} K={K_LEGS} "
            f"seg_len={SEG_LEN}: cluster C={plan.cluster}, "
            f"{plan.smem_bytes} B shared memory a block (V shared "
            f"{plan.v_shared}); max_abs_err {err:.3e} (tol {tol}), device "
            f"{ms:.4f} ms/launch, wrapper {wrap_ms:.4f} ms/call, plain "
            f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.6f} ms "
            f"({entry['bound_by']})")

    # path 2's shape: 32 plain-MVO lanes in one launch
    ops = sample_day_operands(torch.float64, seed + 3, LANES, 0.0)
    err = lanes_vs_single(torch, ak, ops, kw, ADMM_TOL["float64"],
                          "plain lanes")
    ms, _ = segment_device_ms(torch, ak, ops, 100, **kw)
    wrap_ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(*ops, **kw), 3)
    lanes = _segment_entry("admm_segment_lanes", ak, ops, kw, err, ms,
                           wrap_ms, plain_ms, "float64")
    log(f"kernel admm_segment lanes B={LANES} plain float64 seg_len={SEG_LEN}"
        f": max_abs_err {err:.3e} vs {LANES} single-lane plain calls (tol "
        f"{ADMM_TOL['float64']}), bitwise equal to the kernel's single-lane "
        f"launches; device {ms:.4f} ms/launch, wrapper {wrap_ms:.4f} ms/call, "
        f"plain (one {LANES}-lane call) {plain_ms:.4f} ms, bound "
        f"{lanes['bound_ms']:.6f} ms ({lanes['bound_by']})")

    # path 6's sweep chunks: 32 turnover lanes, the L1 term on
    ops = sample_day_operands(torch.float64, seed + 4, LANES, 0.1)
    err = lanes_vs_single(torch, ak, ops, kw, ADMM_TOL["float64"],
                          "turnover lanes")
    ms, _ = segment_device_ms(torch, ak, ops, 100, **kw)
    plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(*ops, **kw), 3)
    b_ms, b_by = segment_bound(ops, SEG_LEN, 0, "float64")
    lanes.update(path_max_abs_err=err, path_ms=ms, path_plain_ms=plain_ms,
                 path_bound_ms=b_ms, path_library_ms=None)
    log(f"kernel admm_segment lanes B={LANES} turnover (L1 on) float64, path "
        f"6's sweep chunks: max_abs_err {err:.3e} vs {LANES} single-lane "
        f"plain calls (tol {ADMM_TOL['float64']}), bitwise equal to the "
        f"kernel's single-lane launches; device {ms:.4f} ms/launch, plain "
        f"(one {LANES}-lane call) {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by})")
    return entry, lanes


def _segment_entry(name: str, ak, ops, kw, err: float, ms: float,
                   wrap_ms: float, plain_ms: float, dname: str) -> dict:
    """The JSON line's entry of one segment phase."""
    b_ms, b_by = segment_bound(ops, kw["seg_len"], kw.get("anderson", 0),
                               dname)
    plan = ak.cluster_plan(ops[1].shape[-2], ops[1].shape[-1],
                           ops[4].shape[-2], kw.get("anderson", 0),
                           ops[1].dtype)
    return dict(name=name, route="cuda",
                source="factormodeling_tpu_torch/csrc/admm_segment.cu",
                replaces="factormodeling_tpu/ops/_pallas_admm.py:188",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, wrapper_ms=wrap_ms,
                cluster=plan.cluster, smem_bytes=plan.smem_bytes)


def risk_path_phase(torch, seed: int) -> dict:
    """The Anderson form at path 3's shape: the launches the backtest
    itself makes on the last days of a short path 3 run (T = 20 risk
    factors, the L1 term on, warm-started, depth 5, a last segment). Each
    day's plain form is held within ``ADMM_TOL``; its Anderson form within
    ``AA_PATH_TOL`` (finite, and some extrapolation taken), since the
    accelerated path of a turnover day is chaotic. The last day's numbers
    go into the JSON line."""
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.segment_phases import risk_days

    errs, accepted = [], 0
    for ops, kw in risk_days(seed):
        plain_kw = dict(kw, anderson=0)
        out = ak.admm_segment(*ops, **plain_kw)
        ref = ak.admm_segment_plain(*ops, **plain_kw)
        p_err = max(float((a - b_).abs().max()) for a, b_ in zip(out, ref))
        if not p_err <= ADMM_TOL["float64"]:
            raise AssertionError(f"admm_segment path 3 day, plain form: max "
                                 f"|err| {p_err} > {ADMM_TOL['float64']}")
        out = ak.admm_segment(*ops, **kw)
        ref = ak.admm_segment_plain(*ops, **kw)
        if not all(bool(torch.isfinite(o).all()) for o in out):
            raise AssertionError("admm_segment path 3 day: non-finite output")
        err = max(float((a - b_).abs().max()) for a, b_ in zip(out[:4],
                                                               ref[:4]))
        accepted += int(out[4].sum())
        errs.append(err)
        log(f"kernel admm_segment path 3 day: plain form max_abs_err "
            f"{p_err:.3e} (tol {ADMM_TOL['float64']}); anderson={kw['anderson']}"
            f" max_abs_err {err:.3e} (tol {AA_PATH_TOL}), tallies (acc, rej, "
            f"conv) {[int(a) for a in out[4:]]} vs plain "
            f"{[int(a) for a in ref[4:]]}")
    if not max(errs) <= AA_PATH_TOL:
        raise AssertionError(f"admm_segment path 3 days: max |err| "
                             f"{max(errs)} > {AA_PATH_TOL}")
    if accepted < 1:
        raise AssertionError("admm_segment path 3 days: no extrapolation taken")
    ms, plan = segment_device_ms(torch, ak, ops, 200, **kw)
    wrap_ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, **kw), 50)
    plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(*ops, **kw), 3)
    entry = _segment_entry("admm_segment_anderson", ak, ops, kw, max(errs),
                           ms, wrap_ms, plain_ms, "float64")
    t, n = ops[1].shape[-2:]
    log(f"kernel admm_segment anderson={kw['anderson']} float64 path 3 day "
        f"T={t} N={n} K={ops[4].shape[-2]} seg_len={kw['seg_len']} last: "
        f"cluster C={plan.cluster}, {plan.smem_bytes} B shared memory a "
        f"block (V shared {plan.v_shared}, history shared "
        f"{plan.history_shared}); {len(errs)} days max_abs_err "
        f"{max(errs):.3e} (tol {AA_PATH_TOL}), {accepted} extrapolations; "
        f"device {ms:.4f} ms/launch, wrapper {wrap_ms:.4f} ms/call, plain "
        f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.6f} ms "
        f"({entry['bound_by']})")
    return entry


def anderson_phase(torch, seed: int) -> dict:
    """The Anderson form (depth 5, the conv tally, a last segment) on a
    plain-MVO day at T=60 in both types, where the accelerated path is
    stable (no path launches it: path 3's shape is ``risk_path_phase``'s),
    then its lane form: 32 lanes in one launch against 32 separate plain
    calls and bitwise against the kernel's single-lane launches. The
    float64 single-lane numbers go into the JSON line."""
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.segment_phases import sample_day_operands

    kw = dict(relax=1.7, seg_len=AA_SEG_LEN, last=True, anderson=AA_DEPTH,
              collect=True)
    entry = None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        ops = sample_day_operands(dtype, seed + 2, 1, 0.0)
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
        ms, plan = segment_device_ms(torch, ak, ops, 200, **kw)
        wrap_ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, **kw), 50)
        plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(*ops, **kw), 3)
        entry = _segment_entry("admm_segment_anderson_mvo_day", ak, ops, kw,
                               err, ms, wrap_ms, plain_ms, dname)
        log(f"kernel admm_segment anderson={AA_DEPTH} {dname} T={T_LOOKBACK} "
            f"N={N} K={K_LEGS} seg_len={AA_SEG_LEN} last collect, plain-MVO "
            f"day (no path): cluster C={plan.cluster}, {plan.smem_bytes} B "
            f"shared memory a block (V shared {plan.v_shared}, history shared "
            f"{plan.history_shared}); max_abs_err {err:.3e} (tol {tol}), "
            f"tallies (acc, rej, conv) {tallies[0]} vs plain {tallies[1]}, "
            f"device {ms:.4f} ms/launch, wrapper {wrap_ms:.4f} ms/call, plain "
            f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.6f} ms "
            f"({entry['bound_by']})")

    ops = sample_day_operands(torch.float64, seed + 3, LANES, 0.0)
    err = lanes_vs_single(torch, ak, ops, kw, AA_TOL["float64"],
                          "anderson lanes")
    ms, _ = segment_device_ms(torch, ak, ops, 100, **kw)
    wrap_ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: ak.admm_segment_plain(*ops, **kw), 3)
    b_ms, b_by = segment_bound(ops, AA_SEG_LEN, AA_DEPTH, "float64")
    log(f"kernel admm_segment lanes B={LANES} anderson={AA_DEPTH} float64, "
        f"plain-MVO days (no path): max_abs_err {err:.3e} vs {LANES} "
        f"single-lane plain calls (tol {AA_TOL['float64']}), tallies equal, "
        f"bitwise equal to the kernel's single-lane launches; device "
        f"{ms:.4f} ms/launch, wrapper {wrap_ms:.4f} ms/call, plain (one "
        f"{LANES}-lane call) {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
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


def window_bound(cells: int, w: int, form: str):
    """The least time of one window launch over ``cells`` float32 cells."""
    per_lag, per_cell = K4_OPS[form]
    return bound(8.0 * cells, float(per_lag) * cells * w
                 + float(per_cell) * cells)


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
        b_ms, b_by = window_bound(cells, K4_W, form)
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

    # edge panel: several date tiles, windows past every tile, D < W,
    # constant and +-inf windows, signed zeros, ties; float32 and float64;
    # windows of 2 and around the tile (the short walk, a middle of 0-2
    # dates)
    worst = 0.0
    for shape, dname, windows in (((2, 1040, 130), "float32",
                                   (16, 100, 350, 2, 15, 17)),
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
    log(f"kernel window_stream edge panel (W=2/15/16/17/100/350 over the "
        f"kernel's date tiles, D < W, constant and +-inf windows, float64): "
        f"max_abs_err vs plain {worst:.3e}; ragged universe vs the CPU op (float64) max_abs_err "
        f"{worst_r:.3e} (tol 1e-10)")
    return entries


def window_path_shape(torch, seed: int) -> dict:
    """The decay form at path 4's own launches: a [D, N] float32 panel (0.2%
    NaN) and each window of ``DEFAULT_DECAY_PERIODS`` from 2 on, one launch
    each held against its plain version at ``K4_TOL`` and timed beside it
    and beside ``F.conv1d`` of the zero-filled panel; returns the sums over
    the launches as the decay entry's ``path_*`` fields. Then the SASS of
    the decay form's float instantiation: its middle loop's instructions."""
    import torch.nn.functional as tF

    from factormodeling_tpu_torch import _build
    from factormodeling_tpu_torch.analytics import DEFAULT_DECAY_PERIODS
    from factormodeling_tpu_torch.ops import _cuda_window as cw
    from factormodeling_tpu_torch.tile_sweep import sass_middle_loop

    rng = np.random.default_rng(seed + 7)
    x = rng.normal(size=(D, N)).astype(np.float32)
    x[rng.uniform(size=x.shape) < K4_NAN] = np.nan
    x = torch.from_numpy(x).cuda()
    xt = x.nan_to_num(0.0).T.contiguous()[:, None, :]
    tol = K4_TOL["float32"]["decay"]
    windows = [w for w in DEFAULT_DECAY_PERIODS if w >= 2]
    sums = dict(path_max_abs_err=0.0, path_ms=0.0, path_plain_ms=0.0,
                path_bound_ms=0.0, path_library_ms=0.0)
    by = {"bytes": 0, "operations": 0}
    per_launch = []
    for w in windows:
        err = _held(torch, f"window decay D={D} N={N} W={w}",
                    cw.decay_streaming(x, w), cw.decay_streaming_plain(x, w),
                    tol)
        sums["path_max_abs_err"] = max(sums["path_max_abs_err"], err)
        per_launch.append(cuda_ms(torch, lambda: cw.decay_streaming(x, w), 20))
        sums["path_ms"] += per_launch[-1]
        sums["path_plain_ms"] += cuda_ms(
            torch, lambda: cw.decay_streaming_plain(x, w), 2)
        b_ms, b_by = window_bound(D * N, w, "decay")
        sums["path_bound_ms"] += b_ms
        by[b_by] += 1
        xz = tF.pad(xt, (w - 1, 0))
        wt = (torch.arange(1, w + 1, dtype=x.dtype, device=x.device)
              / (w * (w + 1) / 2.0)).view(1, 1, w)
        sums["path_library_ms"] += cuda_ms(torch, lambda: tF.conv1d(xz, wt),
                                           20)
    log(f"kernel window_stream decay float32 D={D} N={N}, the {len(windows)} "
        f"windows of path 4 (W={windows[0]}..{windows[-1]}): max_abs_err "
        f"{sums['path_max_abs_err']:.3e} (tol {tol}); summed over the "
        f"launches {sums['path_ms']:.4f} ms, plain "
        f"{sums['path_plain_ms']:.4f} ms, bound {sums['path_bound_ms']:.4f} "
        f"ms ({by['bytes']} launches bytes-bound, {by['operations']} "
        f"operations-bound), conv1d {sums['path_library_ms']:.4f} ms; per "
        f"launch (back-to-back wrapper calls: a launch shorter than the "
        f"host's launch interval reads that interval) "
        + json.dumps(dict(zip(windows, (round(v, 4) for v in per_launch)))))
    sass = sass_middle_loop(_build._lib_path("window_stream"))
    log("kernel window_stream decay<float> SASS middle loop (cuobjdump): "
        + json.dumps(sass))
    return sums


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
    log(f"kernel zscore_group float32 F={K5_F} D={K5_D} N={K5_N} G={K5_G} "
        f"({json.dumps(cf.kernel_layout(K5_N, K5_G, 4))}): "
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
    # each side of the forms' boundaries (their own generator, so the rows
    # above stay those of earlier runs)
    rng_b = np.random.default_rng(seed + 10)
    forms = {}
    for n_b in K5_FORM_WIDTHS:
        xb = rng_b.normal(size=(2, 8, n_b))
        xb[rng_b.uniform(size=xb.shape) < K5_NAN] = np.nan
        gb = torch.from_numpy(rng_b.integers(-1, K5_G, size=(8, n_b))
                              .astype(np.int32)).cuda()
        for dtype, tol in ((torch.float32, K5_TOL), (torch.float64, 1e-12)):
            xt = torch.from_numpy(xb).to("cuda", dtype)
            got = cf.zscore_group_neutralize_fused(xt, gb, K5_G)
            form = cf.kernel_layout(n_b, K5_G, xt.element_size())["form"]
            key = f"{n_b} {form} {str(dtype)[6:]}"
            forms[key] = _held(torch, f"zscore_group N={key}", got,
                               cf.zscore_group_neutralize_plain(xt, gb, K5_G),
                               tol)
    log("kernel zscore_group form boundaries, max_abs_err vs plain (tol "
        f"{K5_TOL} float32, 1e-12 float64): "
        + json.dumps({k: float(f"{v:.3e}") for k, v in forms.items()}))
    # the most groups: in float64 the register form's group tables pass a
    # block's shared memory, and those rows take the shared-memory form
    rng_g = np.random.default_rng(seed + 11)
    most = {}
    for n_b in K5_GROUP_WIDTHS:
        xb = rng_g.normal(size=(2, 8, n_b))
        xb[rng_g.uniform(size=xb.shape) < K5_NAN] = np.nan
        gb = torch.from_numpy(rng_g.integers(-1, K5_MAX_G, size=(8, n_b))
                              .astype(np.int32)).cuda()
        for dtype, tol in ((torch.float32, K5_TOL), (torch.float64, 1e-12)):
            xt = torch.from_numpy(xb).to("cuda", dtype)
            got = cf.zscore_group_neutralize_fused(xt, gb, K5_MAX_G)
            form = cf.kernel_layout(n_b, K5_MAX_G, xt.element_size())["form"]
            key = f"{n_b} {form} {str(dtype)[6:]}"
            most[key] = _held(torch, f"zscore_group G={K5_MAX_G} N={key}",
                              got, cf.zscore_group_neutralize_plain(
                                  xt, gb, K5_MAX_G), tol)
    log(f"kernel zscore_group G={K5_MAX_G}, max_abs_err vs plain (tol "
        f"{K5_TOL} float32, 1e-12 float64): "
        + json.dumps({k: float(f"{v:.3e}") for k, v in most.items()}))
    return dict(name="zscore_group_neutralize", route="cuda",
                source="factormodeling_tpu_torch/csrc/zscore_group.cu",
                replaces="factormodeling_tpu/ops/_pallas_fused.py:79",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def group_path_shape(torch, seed: int) -> dict:
    """The fused kernel at path 4's own launch: [F, D, N] float32 (3% NaN)
    with an 11-industry map (1% of ids -1), held against its plain version
    at ``K5_TOL`` and timed beside it and its bound; returns the entry's
    ``path_*`` fields."""
    from factormodeling_tpu_torch.ops import _cuda_fused as cf

    rng = np.random.default_rng(seed + 9)
    x = rng.normal(size=(F, D, N)).astype(np.float32)
    x[rng.uniform(size=x.shape) < K5_NAN] = np.nan
    gid = rng.integers(0, K5_G, size=(D, N)).astype(np.int32)
    gid[rng.uniform(size=gid.shape) < 0.01] = -1
    x, gid = torch.from_numpy(x).cuda(), torch.from_numpy(gid).cuda()
    err = _held(torch, f"zscore_group [{F}, {D}, {N}]",
                cf.zscore_group_neutralize_fused(x, gid, K5_G),
                cf.zscore_group_neutralize_plain(x, gid, K5_G), K5_TOL)
    ms = cuda_ms(torch, lambda: cf.zscore_group_neutralize_fused(x, gid, K5_G),
                 20)
    plain_ms = cuda_ms(torch, lambda: cf.zscore_group_neutralize_plain(
        x, gid, K5_G), 3)
    cells = F * D * N
    b_ms, b_by = bound(8.0 * cells + 4.0 * D * N, (10.0 + 2.0 * K5_G) * cells)
    log(f"kernel zscore_group float32 at path 4's launch F={F} D={D} N={N} "
        f"G={K5_G} ({json.dumps(cf.kernel_layout(N, K5_G, 4))}): max_abs_err "
        f"{err:.3e} vs plain (tol {K5_TOL}); {ms:.4f} ms/launch, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(path_max_abs_err=err, path_ms=ms, path_plain_ms=plain_ms,
                path_bound_ms=b_ms, path_library_ms=None)


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
    version and the post-sort route (``torch.sort`` + gather + K1), after
    an edge panel of widths 128 to 8192 that takes every layout of the sort
    network (8192: 96 KB of dynamic shared memory)."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_sort as rs

    rng = np.random.default_rng(seed + 6)
    rng_layout = np.random.default_rng(seed + 8)
    worst = 0.0
    for n, rng_n in ([(n, rng) for n in K3_EDGE_WIDTHS]
                     + [(n, rng_layout) for n in K3_LAYOUT_WIDTHS]):
        f = rank_sort_edge(rng_n, 600, n)
        key = torch.from_numpy(f).cuda()
        rr = torch.where(torch.isnan(key), 0.0, torch.from_numpy(
            rng_n.normal(scale=0.02, size=f.shape).astype(np.float32)).cuda())
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
    log(f"kernel rank_ic_fused edge panel n="
        f"{list(K3_EDGE_WIDTHS + K3_LAYOUT_WIDTHS)} (ties, a "
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
    lay = rs.sort_layout(n)
    # each input read once, two floats out per row; the ranks and moments'
    # ~12 operations per element (the sort's compares are integer work)
    b_ms, b_by = bound(8.0 * rows * n + 8.0 * rows, 12.0 * rows * n)
    log(f"kernel rank_ic_fused R={rows} n={n} (W={lay['w']}, {lay['e']} "
        f"words a thread, {lay['team']} threads a row, "
        f"{lay['rows_per_block']} rows a block; stages "
        f"{json.dumps(lay['stages'])}): max_abs_err {err:.3e} vs plain, "
        f"{err1:.3e} "
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


def leg_differences(torch, out, out_h) -> dict:
    """The equal-weight legs of two research-step outputs (the card's and
    the CPU's) side by side: the (date, asset) cells long on one side and
    not on the other, or short on one and not on the other (``flips``), on
    how many days and at most how many a day, the legs' sizes, how many of
    the flipped days blend another set of factors (the blend takes a factor
    in whenever its weight is > 0, as the JAX package's does, so a weight
    of ~1e-9 on one side and 0 on the other changes a group's proxy and
    whole legs; trade weights are the signal's shifted one day), the
    flipped memberships on the other days, how many of those days have a
    signal whose sign is rounding (a nonzero cell within ``P5_SIGN_NOISE`` of
    0 on either side: a composite of one ``_eq`` factor takes three values,
    and its demeaned middle class sits at ~1e-9, long candidates on one
    side and short on the other) and the memberships on the days left, the
    days flat on one side only, and the largest daily-return gap overall
    and on the calm days, where neither the day nor the one before (its
    turnover cost) has a flipped member."""
    sim, sim_h = out.sim, out_h.sim
    w_c = sim.weights.nan_to_num().cpu()
    w_h = sim_h.weights.nan_to_num()
    flip = (((w_c > 0) != (w_h > 0)).sum(-1)
            + ((w_c < 0) != (w_h < 0)).sum(-1))               # [D]
    flip_day = flip > 0
    act = ((out.selection.cpu() > 0) != (out_h.selection > 0)).any(-1)
    act = torch.cat([act.new_zeros(1), act[:-1]])
    same = flip_day & ~act

    def noisy(sig):
        return ((sig.abs() <= P5_SIGN_NOISE) & (sig != 0)).any(-1)

    noise = noisy(out.signal.cpu()) | noisy(out_h.signal)
    noise = torch.cat([noise.new_zeros(1), noise[:-1]])
    rest = same & ~noise
    legs = (sim.long_count + sim.short_count).cpu()
    flat = (sim.long_count == 0).cpu() != (sim_h.long_count == 0)
    calm = ~(flip_day | torch.cat([flip_day.new_zeros(1), flip_day[:-1]]))
    d_ret = (sim.result.log_return.cpu() - sim_h.result.log_return).abs()
    return dict(
        flips=int(flip.sum()), flip_days=int(flip_day.sum()),
        most_a_day=int(flip.max()),
        leg_names=[int(legs.min()), int(legs.max())],
        flip_days_other_factors=int((flip_day & act).sum()),
        flips_same_factors=int(flip[same].sum()),
        flip_days_same_factors=int(same.sum()),
        most_a_day_same_factors=int(flip[same].max()) if bool(same.any())
        else 0,
        flip_days_same_factors_sign_at_rounding=int((same & noise).sum()),
        flips_rest=int(flip[rest].sum()),
        most_a_day_rest=int(flip[rest].max()) if bool(rest.any()) else 0,
        days_flat_one_side=int(flat.sum()),
        max_d_trade_weight=float((w_c - w_h).abs().max()),
        max_d_return=float(d_ret.max()),
        calm_days=int(calm.sum()),
        calm_max_d_return=float(d_ret[calm].max()) if bool(calm.any())
        else 0.0)


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
        # the equal-weight legs: (date, asset) cells long on one side and
        # not on the other, or short on one and not on the other
        legs = leg_differences(torch, out, outs_h[method])
        d_sharpe = abs(summ["sharpe"] - summ_h["sharpe"])
        log(f"path scoring_selection {method}: {int((rowsum > 0).sum())} "
            f"dates selected; summary {json.dumps(summ)}; vs the CPU: max "
            f"|dw| {errs[method][0]:.3e}, share of dates with |dw| > "
            f"{P5_DW_TOL}: {share:.4f}, max |d sharpe| {d_sharpe:.3e}; legs "
            + json.dumps(legs) + f" (tol {P5_SAME_LEGS_RET_TOL} on "
            "calm_max_d_return)")
        flips, d_calm = legs["flips"], legs["calm_max_d_return"]
        if flips == 0 and not d_sharpe <= P5_SAME_LEGS_SHARPE_TOL:
            raise AssertionError(f"scoring path {method}: the Sharpe differs "
                                 f"by {d_sharpe} between the card and the CPU "
                                 "with the same leg members")
        if not d_calm <= P5_SAME_LEGS_RET_TOL:
            raise AssertionError(f"scoring path {method}: a daily return "
                                 f"differs by {d_calm} between the card and "
                                 "the CPU with the same leg members")
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


# path 8a: the notebook's multi-manager backtest (cells 53-56) on dense
# arrays at the research step's width, equal books of the top decile
P8_PCT = 0.1
# the combined book against the factor-weighted sum of the manager books,
# recomputed apart: float32 sums over 50 managers of weights <= 1 times
# book cells of ~0.02 in two orders, ~50 * 6e-8 * 0.02 apart; one manager
# off by a name moves a cell by ~1e-3
P8_BOOK_TOL = 1e-6
# the card's daily returns against the CPU's on days whose factor weights
# (and the day before's, which set the day's turnover cost) agree within
# P8_FW_AGREE: the books are bitwise equal, so the combined cells differ by
# the float32 contraction order and ~1e-6 * 0.02 of weight, and a day's
# return sums ~200 of them times returns of ~0.02
P8_FW_AGREE = 1e-6
P8_RET_TOL = 1e-6
# path 8b: bench.py's config-4 manager sweep (bench_sweep): C combos of K
# factors from default_rng(4), F managers, D dates, N assets, float32
SWEEP_C, SWEEP_K, SWEEP_F, SWEEP_D, SWEEP_N = 1000, 5, 50, 2520, 1000
SWEEP_BATCH = 16
SWEEP_CHECKED = 8        # combos held against their own backtest
SWEEP_CPU_COMBOS = 32    # combos run again on the CPU
# a combo's log returns against its own multi-manager backtest (constant
# daily factor weights) and against the CPU's: the same float32 books
# contracted in another order (a [B, F] x [F, D*N] product against a
# per-date weighted sum over the managers; cuBLAS against the CPU's), so
# cells differ by ~F * eps * 0.02 ~ 6e-8 and a day's return, a sum of ~200
# cells times returns of ~0.02, by far less than 1e-6; a swapped name moves
# it by ~4e-4
SWEEP_RET_TOL = 1e-6


def _multimanager_run(torch, fmt, arrays, dev: str):
    """Path 8a once on ``dev``: icir_top daily factor weights, then the
    equal-weight manager books combined by them and backtested. Returns
    (factor weights, MultiManagerOutput, settings)."""
    factors, returns, factor_ret, cap, invest, universe = (
        torch.from_numpy(a).to(dev) for a in arrays)
    settings = fmt.SimulationSettings(
        returns=returns, cap_flag=cap, investability_flag=invest,
        universe=universe, method="equal", pct=P8_PCT)
    fw = fmt.selection.rolling_selection(factors, returns, factor_ret, WINDOW,
                                         method="icir_top", universe=universe)
    out = fmt.multimanager.run_multimanager_backtest(factors, fw, settings,
                                                     device=dev)
    return fw, out, settings


def multimanager_path(torch, fmt, seed: int) -> dict:
    """Path 8a: the notebook's multi-manager backtest at F=50, D=1332,
    N=1000: daily factor weights from the icir_top rolling selection (K1's
    one launch), the 50 equal-weight manager books combined by them, the
    P&L with costs. Held against the factor-weighted sum of the books
    recomputed apart, and against the same path on the CPU. Returns the
    kernels' launches in the timed run."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.metrics import _cuda_rank_sort as rs

    arrays = make_inputs(F, D, N, seed)
    _multimanager_run(torch, fmt, tuple(a[:, :130] if a.ndim == 3
                                        else a[:130] for a in arrays), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rk.launches = rs.launches = 0
    t0 = time.perf_counter()
    fw, out, settings = _multimanager_run(torch, fmt, arrays, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"rank_ic_postsort": rk.launches, "rank_ic_fused": rs.launches}
    summ = {k: float(v) for k, v in
            fmt.result_summary(out.result)._asdict().items()}
    log(f"path multimanager: F={F} D={D} N={N} window {WINDOW}, equal books "
        f"pct {P8_PCT}: {secs:.3f} s wall on the card, device memory peak "
        f"{peak / 2**20:.1f} MiB; launches {json.dumps(launches)}; summary "
        + json.dumps(summ))
    if launches != {"rank_ic_postsort": 1, "rank_ic_fused": 0}:
        raise AssertionError(f"multimanager path: launches {launches}, "
                             "expected one rank_ic_postsort")
    if not all(np.isfinite(v) for v in summ.values()):
        raise AssertionError(f"multimanager path: non-finite summary {summ}")

    # the combined book against the weighted sum of the books, apart
    books, _, _ = fmt.multimanager.compute_manager_weights(
        torch.from_numpy(arrays[0]).cuda(), settings, device="cuda")
    parts = torch.zeros_like(out.weights)
    for m in range(F):
        parts += fw[:, m:m + 1].nan_to_num() * books[m].nan_to_num()
    err_book = float((out.weights - parts).abs().max())
    active = int((fw.sum(1) > 0).sum())
    log(f"path multimanager combined book vs the weighted sum of the {F} "
        f"books: max |d| {err_book:.3e} (tol {P8_BOOK_TOL}); {active} dates "
        f"weighted")
    if not (err_book <= P8_BOOK_TOL and active > 0):
        raise AssertionError("multimanager path: the combined book is not "
                             "the factor-weighted sum of the manager books")

    # the same path on the CPU from the same inputs
    t0 = time.perf_counter()
    fw_h, out_h, settings_h = _multimanager_run(torch, fmt, arrays, "cpu")
    books_h, _, _ = fmt.multimanager.compute_manager_weights(
        torch.from_numpy(arrays[0]), settings_h, device="cpu")
    secs_h = time.perf_counter() - t0
    same_books = bool(torch.equal(books.cpu().nan_to_num(nan=7.0),
                                  books_h.nan_to_num(nan=7.0)))
    dw = (fw.cpu() - fw_h).abs().max(-1).values
    share = float((dw > P5_DW_TOL).double().mean())
    agree = dw <= P8_FW_AGREE
    agree = agree & torch.cat([agree.new_ones(1), agree[:-1]])
    d_ret = (out.result.log_return.cpu() - out_h.result.log_return).abs()
    d_agree = float(d_ret[agree].max())
    log(f"path multimanager on the CPU: {secs_h:.1f} s (the path and the "
        f"books again); books bitwise equal {same_books}; factor weights "
        f"max |dw| {float(dw.max()):.3e}, share of dates with |dw| > "
        f"{P5_DW_TOL}: {share:.4f} (limit {P5_DW_SHARE}); daily returns on "
        f"the {int(agree.sum())} days whose weights agree within "
        f"{P8_FW_AGREE}: max |d| {d_agree:.3e} (tol {P8_RET_TOL}), on all "
        f"days {float(d_ret.max()):.3e}")
    if not same_books:
        raise AssertionError("multimanager path: the card's equal books "
                             "differ from the CPU's")
    if not (share <= P5_DW_SHARE and d_agree <= P8_RET_TOL):
        raise AssertionError("multimanager path: the card's factor weights "
                             "or daily returns differ from the CPU's")
    return launches


def sweep_inputs(torch, fmt, dev: str):
    """bench.py's config-4 inputs (its generator and draw order) on
    ``dev``: (factors [F, D, N], combo weights [C, F], settings)."""
    rng = np.random.default_rng(4)
    factors = rng.normal(size=(SWEEP_F, SWEEP_D, SWEEP_N)).astype(np.float32)
    rets = rng.normal(scale=0.02, size=(SWEEP_D, SWEEP_N)).astype(np.float32)
    cap = rng.integers(1, 4, size=(SWEEP_D, SWEEP_N)).astype(np.float32)
    combos = rng.integers(0, SWEEP_F, size=(SWEEP_C, SWEEP_K))
    cw = fmt.parallel.combo_weight_matrix(combos, SWEEP_F, device=dev)
    settings = fmt.SimulationSettings(
        returns=torch.from_numpy(rets).to(dev),
        cap_flag=torch.from_numpy(cap).to(dev),
        investability_flag=torch.ones((SWEEP_D, SWEEP_N), device=dev),
        pct=P8_PCT)
    return torch.from_numpy(factors).to(dev), cw, settings


def sweep_path(torch, fmt) -> dict:
    """Path 8b: the 1000-combo manager sweep at bench.py's config-4 shape:
    one book pass over the 50 managers, then every combo's contraction and
    P&L in chunks of 16. Held against each of 8 combos' own multi-manager
    backtest and against the first 32 combos on the CPU. Returns the wall
    times, the bound and the memory peak."""
    factors, cw, settings = sweep_inputs(torch, fmt, "cuda")

    def sweep(weights):
        out = fmt.parallel.manager_sweep(factors, weights, settings,
                                         combo_batch=SWEEP_BATCH,
                                         device="cuda")
        torch.cuda.synchronize()
        return out

    sweep(cw[:SWEEP_BATCH])     # warm-up: allocator, library handles
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = sweep(cw)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    c, f, d, n = SWEEP_C, SWEEP_F, SWEEP_D, SWEEP_N
    # bench.py's traffic model: the books stream once per combo batch
    # through the contraction, and each combo's [D, N] book and ~3 P&L
    # passes write or read once; the contraction's 2 C F D N operations
    batches = -(-c // SWEEP_BATCH)
    nbytes = 4.0 * (batches * f * d * n + 4 * c * d * n)
    b_ms, b_by = bound(nbytes, 2.0 * c * f * d * n)
    wall_ms = min(walls) * 1e3
    sharpe = out.sharpe.cpu()
    total = out.total_log_return.cpu()
    log(f"path manager_sweep: C={c} combos of {SWEEP_K}, F={f} D={d} N={n} "
        f"float32, combo_batch {SWEEP_BATCH}: walls "
        + ", ".join(f"{w:.4f}" for w in walls)
        + f" s after a warm-up; device memory peak {peak / 2**20:.1f} MiB "
        f"(books {4 * f * d * n / 2**20:.1f} MiB, a chunk "
        f"{4 * SWEEP_BATCH * d * n / 2**20:.1f} MiB); bench.py's model "
        f"{nbytes / 1e9:.2f} GB and {2.0 * c * f * d * n:.3e} FLOP: bound "
        f"{b_ms:.3f} ms ({b_by}), {100.0 * b_ms / wall_ms:.2f}% of it; "
        f"sharpe range [{float(sharpe.min()):.4f}, "
        f"{float(sharpe.max()):.4f}]")
    if not (torch.isfinite(sharpe).all() and torch.isfinite(total).all()):
        raise AssertionError("manager sweep: non-finite sharpe or total "
                             "log return")

    # combos spread over the chunks, the last among them, against their own
    # multi-manager backtest with the combo's row as daily factor weights
    picks = np.linspace(0, c - 1, SWEEP_CHECKED).round().astype(int)
    err_own = 0.0
    for k in picks:
        one = fmt.multimanager.run_multimanager_backtest(
            factors, cw[k].expand(d, f), settings, device="cuda")
        err_own = max(err_own, float((out.log_return[k]
                                      - one.result.log_return).abs().max()))
    # the first combos again on the CPU, books and all
    t0 = time.perf_counter()
    factors_h, cw_h, settings_h = sweep_inputs(torch, fmt, "cpu")
    host = fmt.parallel.manager_sweep(factors_h, cw_h[:SWEEP_CPU_COMBOS],
                                      settings_h, combo_batch=SWEEP_BATCH,
                                      device="cpu")
    secs_h = time.perf_counter() - t0
    err_cpu = float((out.log_return[:SWEEP_CPU_COMBOS].cpu()
                     - host.log_return).abs().max())
    log(f"path manager_sweep held: combos {picks.tolist()} against their own "
        f"multi-manager backtest max |d log return| {err_own:.3e}; the first "
        f"{SWEEP_CPU_COMBOS} combos on the CPU ({secs_h:.1f} s) max |d log "
        f"return| {err_cpu:.3e} (tol {SWEEP_RET_TOL} each)")
    if not (err_own <= SWEEP_RET_TOL and err_cpu <= SWEEP_RET_TOL):
        raise AssertionError("manager sweep: a combo differs from its own "
                             "backtest or from the CPU's")
    return dict(walls_s=walls, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / wall_ms, peak_bytes=peak)


#: the paths' backtest settings (beside max_weight and the kernel)
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
#: paths 6-7: path 1 in the fixed-point scheme, at the reference's penalty
#: and at penalty 0 (the contractive limit)
PARALLEL_PATHS = {
    "turnover_parallel": dict(PATHS["turnover"], turnover_mode="parallel"),
    "turnover_parallel_decoupled": dict(PATHS["turnover"],
                                        turnover_mode="parallel",
                                        turnover_penalty=0.0),
}
# paths 1 and 3 hold the reference kernel's backtest of the fused run's own
# signal over its first REF_DATES dates only (cut to keep the script's time
# as path 8 grew it). Path 1's backtest is causal to the bit, so its fused
# side is the full run's first days; path 3's is not (its risk-model fits
# round differently with fewer dates, and the Anderson chain carries that
# far), so its fused side runs over the same dates again
REF_DATES = 666
REF_CUT = {"turnover": "full run", "turnover_risk_anderson": "rerun"}
# certified days against the scan: the QP is float64 (the JAX package's
# bench.py holds 1e-4 at float32)
CERT_TOL = 1e-5
# path 7 against the scan on every day, and the scan's cut
P7_ALL_TOL, P7_SCAN_DATES = 1e-4, 333


def run_step(torch, fmt, arrays, sim: dict, kernel: str):
    sim_kwargs = dict(sim, max_weight=MAX_WEIGHT, solver_kernel=kernel)
    inputs, cfg = fmt.convert(*arrays, names=factor_names(arrays[0].shape[0]),
                              window=WINDOW, select_method="icir_top",
                              blend_method="zscore", sim_kwargs=sim_kwargs,
                              device="cuda")
    step = fmt.build_research_step(**cfg.as_kwargs())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*inputs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, inputs


def segment_launches(fmt, sim: dict, stats: dict | None = None):
    """The segment kernel's launches the path's schedule implies, one per
    segment of every solve: ``(single-lane, lane-batch)`` launches, as the
    wrapper counts them (``launches - lane_launches``, ``lane_launches``).
    A solve is one date (the turnover scan, the parallel scheme's
    sequential suffix) or one chunk of ``mvo_batch`` dates, the ragged tail
    a chunk too (plain mvo; the parallel scheme's seed and each executed
    sweep, by its ``stats``); a chunk of one date is a single-lane
    launch."""
    from factormodeling_tpu_torch.solvers.admm_qp import _ADAPT_EVERY

    s = fmt.SimulationSettings(returns=None, cap_flag=None,
                               investability_flag=None, **sim)

    def segs(iters):
        return -(-iters // _ADAPT_EVERY)

    lone = int(D % s.mvo_batch == 1)           # a tail chunk of one date
    chunks = D // s.mvo_batch + int(D % s.mvo_batch > 1)
    if s.method == "mvo":
        per = segs(s.resolved_qp_iters(False))
        return lone * per, chunks * per
    qp = segs(s.resolved_qp_iters(True))
    if s.turnover_mode == "scan":
        return D * qp, 0
    per = (segs(s.resolved_seed_iters())
           + stats["sweeps"] * segs(s.resolved_sweep_iters()))
    return stats["suffix_len"] * qp + lone * per, chunks * per


def check_invariants(torch, path: str, out) -> None:
    """Leg sums and the weight cap on the traded days; prints them with the
    polish and Anderson tallies."""
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


def segment_counts(rk, ak) -> dict:
    """The path run's launches as the wrappers counted them: K1's, and K2's
    single-lane and lane-batch launches apart."""
    return {"rank_ic_postsort": rk.launches,
            "admm_segment": ak.launches - ak.lane_launches,
            "admm_segment_lanes": ak.lane_launches}


def check_launches(path: str, launches: dict, want) -> None:
    """K1 launched; K2's single-lane and lane-batch launches each equal
    their term of the schedule ``want``."""
    if launches["rank_ic_postsort"] < 1:
        raise AssertionError(f"{path}: rank_ic_postsort never launched")
    got = (launches["admm_segment"], launches["admm_segment_lanes"])
    if got != tuple(want):
        raise AssertionError(f"{path}: admm_segment launched {got[0]} times "
                             f"on one lane and {got[1]} on lane batches, the "
                             f"schedule implies {tuple(want)}")


def check_fused_vs_reference(torch, path: str, w_fused, w_ref) -> None:
    dw = (w_fused.nan_to_num() - w_ref.nan_to_num()).abs()
    day_dw = dw.max(-1).values
    share = float((day_dw > DW_TOL).double().mean())
    log(f"path {path} fused vs reference: max |dw| {float(dw.max()):.3e}, "
        f"share of days with |dw| > {DW_TOL}: {share:.4f} (limit {DW_SHARE})")
    if not share <= DW_SHARE:
        raise AssertionError(f"{path}: fused and reference weights differ on "
                             f"{share:.2%} of days")


def path_phase(torch, seed: int, path: str, warm_up: bool):
    """One path at full size with the fused kernel, its checks, and the
    same step with the reference kernel held against it. Returns the
    kernels' launches in the fused run, its output and its seconds."""
    import factormodeling_tpu_torch as fmt
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    arrays = make_inputs(F, D, N, seed)
    if warm_up:   # library handles, allocator, kernel loads: a cut date range
        run_step(torch, fmt, tuple(a[:, :130] if a.ndim == 3 else a[:130]
                                   for a in arrays), PATHS[path], "fused")

    rk.launches = ak.launches = ak.lane_launches = 0
    out, secs, inputs = run_step(torch, fmt, arrays, PATHS[path], "fused")
    launches = segment_counts(rk, ak)
    log(f"path {path} fused: F={F} D={D} N={N} step {secs:.3f} s wall; "
        f"launches {json.dumps(launches)}")

    summ = {k: float(v) for k, v in out.summary._asdict().items()}
    log(f"path {path} fused summary " + json.dumps(summ))
    if not all(np.isfinite(v) for v in summ.values()):
        raise AssertionError(f"{path}: non-finite summary {summ}")
    check_invariants(torch, path, out)
    diag = out.sim.diagnostics
    if int(diag.qp_solves) != D:
        raise AssertionError(f"{path}: {int(diag.qp_solves)} QP solves, not {D}")
    if PATHS[path].get("qp_anderson") and not diag.anderson_accepted.sum() > 0:
        raise AssertionError(f"{path}: the Anderson accelerator never engaged")
    check_launches(path, launches, segment_launches(fmt, PATHS[path]))

    if path not in REF_CUT:
        ref, ref_secs, _ = run_step(torch, fmt, arrays, PATHS[path],
                                    "reference")
        log(f"path {path} reference: step {ref_secs:.3f} s wall")
        check_fused_vs_reference(torch, path, out.sim.weights,
                                 ref.sim.weights)
        return launches, out, secs
    cut = REF_DATES
    _, returns, _, cap, invest, universe = (a[:cut] for a in inputs)

    def backtest(kernel):
        settings = fmt.SimulationSettings(
            returns=returns, cap_flag=cap, investability_flag=invest,
            universe=universe, **dict(PATHS[path], max_weight=MAX_WEIGHT,
                                      solver_kernel=kernel))
        t0 = time.perf_counter()
        sim = fmt.run_simulation(out.signal[:cut], settings)
        torch.cuda.synchronize()
        log(f"path {path} {kernel}: the backtest of the fused run's signal "
            f"over its first {cut} dates {time.perf_counter() - t0:.3f} s "
            "wall")
        return sim.weights

    fused = (out.sim.weights[:cut] if REF_CUT[path] == "full run"
             else backtest("fused"))
    check_fused_vs_reference(torch, path, fused, backtest("reference"))
    return launches, out, secs


def day_dw(torch, a, b):
    """Per-day max |dw| of two runs' trade weights: entry t is day t's
    weights (row t + 1 of the panels shifted one day; the universe is whole,
    so the shift is plain); the last day has no row."""
    return (a.sim.weights.nan_to_num()
            - b.sim.weights.nan_to_num()).abs().max(-1).values[1:]


def polish_both(torch, da, db, days: int):
    """The days (of the first ``days``) whose polish both runs' diagnostics
    ``da``, ``db`` accepted or neither attempted."""
    both = da.polished[:days] & db.polished[:days]
    neither = (torch.isnan(da.polish_pre_residual[:days])
               & torch.isnan(db.polish_pre_residual[:days]))
    return both | neither


def parallel_run(torch, fmt, arrays, path: str, kernel: str):
    """One fused or reference run of a parallel path, with the schedule's
    gates: returns ``(out, secs, stats, launches, inputs)``."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    sim = PARALLEL_PATHS[path]
    rk.launches = ak.launches = ak.lane_launches = 0
    out, secs, inputs = run_step(torch, fmt, arrays, sim, kernel)
    launches = segment_counts(rk, ak)
    diag = out.sim.diagnostics
    stats = fmt.backtest.sweep_stats(diag)
    log(f"path {path} {kernel}: F={F} D={D} N={N} step {secs:.3f} s wall; "
        f"launches {json.dumps(launches)}; sweep_stats {json.dumps(stats)}; "
        f"polish_stats {json.dumps(fmt.backtest.polish_stats(diag))}")
    summ = {k: float(v) for k, v in out.summary._asdict().items()}
    if not all(np.isfinite(v) for v in summ.values()):
        raise AssertionError(f"{path}: non-finite summary {summ}")
    s = fmt.SimulationSettings(returns=None, cap_flag=None,
                               investability_flag=None, **sim)
    if stats["converged_days"] + stats["suffix_len"] != D:
        raise AssertionError(f"{path}: converged days and suffix do not "
                             f"cover the run: {stats}")
    if not 1 <= stats["sweeps"] <= s.turnover_sweeps:
        raise AssertionError(f"{path}: {stats['sweeps']} sweeps")
    if stats["qp_solves"] != D + stats["sweeps"] * D + stats["suffix_len"]:
        raise AssertionError(f"{path}: {stats['qp_solves']} QP solves, not "
                             "the seed, the sweeps and the suffix")
    if kernel == "fused":
        check_launches(path, launches, segment_launches(fmt, sim, stats))
    return out, secs, stats, launches, inputs


def turnover_parallel_path(torch, seed: int, scan_out, scan_secs: float):
    """Path 6: path 1 in the fixed-point scheme, fused, held against path
    1's own fused output (the scan, same inputs): equal weights on the
    suffix days, within ``CERT_TOL`` on certified days that both polished
    or neither attempted. Returns its launches."""
    import factormodeling_tpu_torch as fmt

    path = "turnover_parallel"
    arrays = make_inputs(F, D, N, seed)
    out, secs, stats, launches, _ = parallel_run(torch, fmt, arrays, path,
                                                 "fused")
    check_invariants(torch, path, out)
    start = stats["converged_days"]
    dw = day_dw(torch, out, scan_out)
    suffix = dw[start:]
    share = float((suffix > DW_TOL).double().mean()) if len(suffix) else 0.0
    bitwise = bool(torch.equal(out.sim.weights[start + 1:].nan_to_num(),
                               scan_out.sim.weights[start + 1:].nan_to_num()))
    cert = polish_both(torch, out.sim.diagnostics, scan_out.sim.diagnostics,
                       D - 1)[:start]
    cert_dw = float(dw[:start][cert].max()) if bool(cert.any()) else 0.0
    # entry t + 1 of the weights is day t's: the certified days that hold
    # a position (the days before the selection window are flat), and the
    # hand-over, the first suffix day, entered from the last certified
    # day's weights and exit state
    held = torch.nonzero((out.sim.weights[1:start + 1].nan_to_num() != 0)
                         .any(-1)).flatten().tolist()
    hand_dw = float(dw[start]) if 0 < start < D - 1 else 0.0
    log(f"path {path} vs path 1 (the scan): suffix days {start}-{D - 1}: max "
        f"|dw| {float(suffix.max()) if len(suffix) else 0.0:.3e}, share of "
        f"days > {DW_TOL}: {share:.4f} (limit {DW_SHARE}), bitwise {bitwise}; "
        f"certified days {start}, those holding a position {held}, "
        f"{int(cert.sum())} both polished or neither attempted: max |dw| "
        f"{cert_dw:.3e} (tol {CERT_TOL}); hand-over day {start} from day "
        f"{start - 1} ({'holding a position' if start - 1 in held else 'flat'}"
        f"): |dw| {hand_dw:.3e} (tol {DW_TOL})")
    log(f"path {path}: {secs:.3f} s wall, {secs / scan_secs:.3f}x path 1's "
        f"fused {scan_secs:.3f} s in this call")
    if not share <= DW_SHARE:
        raise AssertionError(f"{path}: suffix weights differ from the scan's "
                             f"on {share:.2%} of days")
    if not cert_dw <= CERT_TOL:
        raise AssertionError(f"{path}: certified days {cert_dw} from the scan")
    if not hand_dw <= DW_TOL:
        raise AssertionError(f"{path}: the hand-over day {hand_dw} from the "
                             "scan")
    return launches


def turnover_decoupled_path(torch, seed: int):
    """Path 7: penalty 0, fused and reference, both parallel: every day
    certified, the kernels within ``DW_TOL``/``DW_SHARE``, and the scan over
    the first ``P7_SCAN_DATES`` dates of the same composite (the backtest is
    causal, so its first days are the full scan's) within ``CERT_TOL`` on
    days both polished and ``P7_ALL_TOL`` on every day. Returns the fused
    run's launches."""
    import factormodeling_tpu_torch as fmt

    path = "turnover_parallel_decoupled"
    arrays = make_inputs(F, D, N, seed)
    out, secs, stats, launches, inputs = parallel_run(torch, fmt, arrays,
                                                      path, "fused")
    check_invariants(torch, path, out)
    if stats["suffix_len"] != 0 or not 1 <= stats["sweeps"] <= 4:
        raise AssertionError(f"{path}: not certified within 4 sweeps: {stats}")
    ref, ref_secs, ref_stats, _, _ = parallel_run(torch, fmt, arrays, path,
                                                     "reference")
    if ref_stats["suffix_len"] != 0:
        raise AssertionError(f"{path} reference: suffix {ref_stats}")
    check_fused_vs_reference(torch, path, out.sim.weights, ref.sim.weights)

    cut = P7_SCAN_DATES
    sim = dict(PARALLEL_PATHS[path], turnover_mode="scan",
               max_weight=MAX_WEIGHT, solver_kernel="fused")
    _, returns, _, cap, invest, universe = inputs
    s = fmt.SimulationSettings(returns=returns[:cut], cap_flag=cap[:cut],
                               investability_flag=invest[:cut],
                               universe=universe[:cut], **sim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan = fmt.run_simulation(out.signal[:cut], s)
    torch.cuda.synchronize()
    scan_secs = time.perf_counter() - t0
    dw = (out.sim.weights[1:cut].nan_to_num()
          - scan.weights[1:].nan_to_num()).abs().max(-1).values
    pol = polish_both(torch, out.sim.diagnostics, scan.diagnostics, cut - 1)
    pol_dw = float(dw[pol].max()) if bool(pol.any()) else 0.0
    log(f"path {path}: fused {secs:.3f} s, reference {ref_secs:.3f} s wall; "
        f"vs the scan of its first {cut} dates ({scan_secs:.3f} s): max |dw| "
        f"{float(dw.max()):.3e} (tol {P7_ALL_TOL}), on the {int(pol.sum())} "
        f"days both polished or neither attempted {pol_dw:.3e} (tol "
        f"{CERT_TOL})")
    if not float(dw.max()) <= P7_ALL_TOL:
        raise AssertionError(f"{path}: {float(dw.max())} from the scan")
    if not pol_dw <= CERT_TOL:
        raise AssertionError(f"{path}: polished days {pol_dw} from the scan")
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
    kernels = {"rank_ic_postsort": rank_ic_phase(torch, rk, args.seed)}
    kernels["admm_segment"], kernels["admm_segment_lanes"] = admm_phase(
        torch, args.seed)
    kernels["admm_segment_anderson_mvo_day"] = anderson_phase(torch,
                                                              args.seed)
    t0 = time.perf_counter()
    kernels["admm_segment_anderson"] = risk_path_phase(torch, args.seed)
    log(f"path 3 days' segments: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    window = window_phase(torch, fmt, args.seed)
    kernels.update({f"window_{form}": e for form, e in window.items()})
    kernels["window_decay"].update(window_path_shape(torch, args.seed))
    kernels["zscore_group_neutralize"] = group_phase(torch, fmt, args.seed)
    kernels["zscore_group_neutralize"].update(group_path_shape(torch,
                                                               args.seed))
    log(f"ops kernel phases: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    kernels["rank_ic_fused"] = rank_sort_phase(torch, rk, args.seed)
    kernels["fp32_probe"] = fp32_probe_phase(torch)
    log(f"rank-sort and probe kernel phases: {time.perf_counter() - t0:.1f} s "
        f"wall")
    launches = {}
    for path in PATHS:
        launches[path], out, secs = path_phase(torch, args.seed, path,
                                               warm_up=path == "turnover")
        if path == "turnover":   # path 6 is held against it
            scan_out, scan_secs = out, secs
        del out
    t0 = time.perf_counter()
    launches["turnover_parallel"] = turnover_parallel_path(
        torch, args.seed, scan_out, scan_secs)
    log(f"path 6 phase (run, checks): {time.perf_counter() - t0:.1f} s wall")
    del scan_out
    t0 = time.perf_counter()
    launches["turnover_parallel_decoupled"] = turnover_decoupled_path(
        torch, args.seed)
    log(f"path 7 phase (fused, reference, scan, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    decay_launches = decay_path(torch, fmt, args.seed)
    log(f"decay path phase (warm-up, run, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    scoring_launches = scoring_path(torch, fmt, args.seed)
    log(f"scoring path phase (warm-up, run, CPU run, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["multimanager"] = multimanager_path(torch, fmt, args.seed)
    log(f"path 8a phase (warm-up, run, checks, CPU run): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    sweep_path(torch, fmt)
    log(f"path 8b phase (warm-up, two runs, checks, CPU run): "
        f"{time.perf_counter() - t0:.1f} s wall")
    # each kernel's launches on the paths that run its form: K1 once in each
    # of paths 1-3 and in path 8a's icir_top selection
    k1 = {p: launches[p]["rank_ic_postsort"] for p in
          (*PATHS, "multimanager")}
    kernels["rank_ic_postsort"]["launches"] = sum(k1.values())
    kernels["rank_ic_postsort"]["launches_by_path"] = k1
    # the segment's single-lane launches: path 1, and the sequential
    # suffixes of paths 6-7; its lane launches: path 2's chunks, and the
    # seed and sweep chunks of paths 6-7 (each as the wrapper counted it)
    single = {p: launches[p]["admm_segment"] for p in
              ("turnover", "turnover_parallel", "turnover_parallel_decoupled")}
    lanes = {p: launches[p]["admm_segment_lanes"] for p in
             ("mvo", "turnover_parallel", "turnover_parallel_decoupled")}
    kernels["admm_segment"]["launches"] = sum(single.values())
    kernels["admm_segment"]["launches_by_path"] = single
    kernels["admm_segment_lanes"]["launches"] = sum(lanes.values())
    kernels["admm_segment_lanes"]["launches_by_path"] = lanes
    kernels["admm_segment_anderson"]["launches"] = (
        launches["turnover_risk_anderson"]["admm_segment"])
    kernels["admm_segment_anderson_mvo_day"]["launches"] = 0   # no path
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
    log(f"card (again, for a reader of the output's end): {smi}")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "wrapper_ms", "cluster", "smem_bytes", "launches_by_path",
             "path_max_abs_err",
             "path_ms", "path_plain_ms", "path_bound_ms", "path_library_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in order if k in kern}
                                for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
