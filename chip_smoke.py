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
   ``fp32_probe.measure``; then the seeded draws (``threefry``, the JAX
   package's streams): a float32 uniform and a 64-bit ``randint`` at the
   research step's [50, 1332, 1000] on the card, timed, each bitwise the
   CPU's draw of its first 2**20 counters and the card's draw made in
   chunks of 2**20 counters; a bounded uniform (a span no power of two,
   whose multiply-add is emulated) bitwise the CPU's and path 3's
   [1000, 28] risk sketch (``normal``) within 4 ulp of the CPU's, in
   float32 and float64;
4. three paths of ``build_research_step`` at F=50 factors, D=1332 dates,
   N=1000 assets (data from ``--seed``), icir_top selection, zscore blend,
   ``solver_kernel="fused"``: (1) mvo_turnover with the sample covariance,
   (2) plain mvo in lanes of ``mvo_batch``, (3) mvo_turnover with the
   statistical risk model (20 factors, 252-day lookback, refit every 21
   days) and the Anderson accelerator, on its first 333 dates
   (``PATH_DATES``). Each: the kernels' launch counts against the path's
   schedule, leg-sum and weight-cap invariants, a finite summary; then the
   same step with ``solver_kernel="reference"``, held against the fused
   run (paths 1 and 3: the reference kernel's backtest of the fused run's
   signal over its first ``REF_DATES`` dates, 333, against the full run's
   first days on path 1 and path 3's whole run; depth cut to make room
   for path 10, from path 3's 1332 dates with a reference over 666 and
   path 1's reference over 666). Then path 1 with
   ``turnover_mode="parallel"``:
   (6) at its penalty 0.1 on its first ``P6_DATES`` dates (666, cut from
   1332 to make room for path 13), held against path 1's own fused output
   on those days (suffix days within ``DW_TOL`` on all but ``DW_SHARE``,
   certified days both polished or neither attempted within
   ``CERT_TOL``), and (7) at penalty
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
   CPU on its first 333 dates (cut from 1332 for path 12), held against
   the card's run of those dates;
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
   (8c) ``fmt.parallel.checkpointed_manager_sweep`` at 8b's shape in
   chunks of 64, interrupted inside its second chunk and resumed from the
   snapshot, every output bitwise 8b's;
8. path 9, the resilience layer and the online advance on the first 333
   dates of path 1's inputs (F=50, N=1000, mvo_turnover, fused): (9a) the
   step clean, with ``FaultSpec.off()`` and ``DegradePolicy.make()`` (held
   bitwise to the clean run), and one chaos cell (NaN and Inf cells,
   dropped dates and collapsed universe dates at every stage, under a
   policy with every guard on: finite P&L, leg sums and the weight cap on
   active unheld days, its ``DegradeStats`` equal to a host recount from
   the drawn masks (the JAX package's draws at the seed), the same cell on
   the host CPU, its masks bitwise the card's, at path 1's weight
   gate), K1 once and K2 two segments a date in each run; (9b) an
   ``OnlineEngine`` for path 1's tenant fed the first 166 of those dates
   one at a time (cut from 333 to make room for path 12),
   held against 9a's clean step (selection rows bitwise, signal rows
   within ``P9_SIG_TOL``, weights at path 1's gate, leg counts and solver
   acceptance exact where the weights agree, daily P&L where the books
   agree), K1 once a date and K2 as on path 1, a fresh engine resumed from
   its snapshot at date 140 and a restatement of date 155 replayed, both
   byte-equal; with the per-date advance wall p50/p99 and the
   synchronizing reads of a date by calling line;
9. path 10, the serving layer at path 1's market (F=50, N=1000, float32,
   window 60, icir_top, zscore): (10a) ``TenantServer.serve`` of 64
   equal-weight tenants (``bench.py``'s ``bench_tenant_sweep`` knob draw)
   at D=1332, one rung-64 dispatch cold and warm, then 5 of them (rung 8,
   3 pad lanes), one K1 launch and one simulation of all the real lanes
   a dispatch (the tenant body runs once on the lanes), 4 lanes bitwise
   the single-tenant step (the leaves that part are named) and held to
   the same configs on the host CPU at path 5's icir_top gate,
   ``serving_stats()`` against the host's count and one cache entry a
   (bucket, rung); (10b) an ``mvo_turnover`` bucket of 3 tenants (path
   1's own first) on path 9's first 166 dates, rung 8 with 5 pad lanes
   not computed: K1 once, one simulation, K2 one lane launch of the 3
   tenants a segment a date (one day loop for the bucket), each tenant's
   invariants, tenant 0 held to 9a's clean step on those dates
   (selection bitwise, weights at path 1's gate), tenants 1 and 2 to
   their own single-tenant steps on the first 16 traded dates (the same
   gates), the bucket's wall against 9a's clean step; (10e) 10b's
   tenants with ``turnover_mode="parallel"`` on 166 dates: one
   simulation, K1 once, K2's single-lane and lane launches those the
   lanes' own sweep counts and starts imply, each lane's ``sweep_stats``
   its single-tenant run's, its selection bitwise and its weights at
   path 1's gate, the bucket's wall against the three single runs';
   (10c) ``serve_queued`` on 10a's
   bucket (``bench.py``'s ``bench_serving_under_load`` recipe: 48
   requests, ladder 1/4/8, the service time of a warm rung-8 dispatch, a
   Poisson trace at twice its capacity, deadlines 40 service times,
   ``max_depth`` 8 on a virtual clock, a dispatch fault plan): one verdict
   a request, the delivered outputs bitwise ``serve()``'s, shed verdicts
   with their reason, executions = delivered dispatches + poisoned
   attempts; (10d) ``online_begin`` + ``advance_all`` for 10b's tenants 0
   and 2 over path 9b's first 166 dates: K1 once a date, K2 one lane
   launch of the session's 2 tenants a segment a date, tenant 0's rows
   held to 9b's at 9b's gates, the wall a date
   p50/p99 and the synchronizing reads of a date by calling line;
10. path 11, the obs layer at the same widths: (11a) path 9a's inert and
   chaos runs built with ``collect_probes=True`` (the chaos run with the
   staleness canary): the inert run bitwise its clean, unprobed run; the
   chaos run's frames through ``RunReport.add_probes`` with the inert
   run's ``numerics_baseline``, the watchdog naming ``ops/factors_raw``;
   ``iters_to_converge`` within the budget and equal to the CPU chaos
   run's on all but ``DW_SHARE`` of days; K1 1 and K2 666 a run; then a
   run of the first 90 dates at 200 iterations, unprobed and probed on the
   card under torch's sync debug mode (the reads the probes add) and
   probed on the CPU, the tally firing and equal to the CPU's; (11b) the
   segment kernel's ``collect=1`` form at T=60, N=1000, float64, the tally
   exact against its plain version; (11c) 9b's tenant as an
   ``OnlineEngine(flight=True, lineage=True, sentry=...)`` over 32 dates
   (cut from 64 for path 12), a checkpoint a date, a restatement, a kill
   at date 16 and a resume: its
   rows bitwise an unhooked engine's, the resumed ledger and alert log
   byte-equal to straight through, the checkers clean, one finished span
   tree a tick, the wall a date beside 9b's and one state hash timed;
   (11d) 10c's drain with ``flight``, ``lineage``, ``sentry`` and an
   ``on_alert`` collector (its verdict log 10c's line for line, the
   conservation, trace, traffic, ledger and sentry checkers clean),
   ``serve(lineage=True)`` on 10a's rung-8 bucket and
   ``advance_all(meter=, series=)`` over 16 of 10d's dates, each bitwise
   its unhooked run; path 8c runs with ``lineage=`` on, its resumed
   ledger byte-equal to a straight-through checkpointed run's;
11. path 12, the scenario engine and out-of-core streaming: (12a)
   ``scenarios.run_scenarios`` on 10a's market and equal tenant, the
   regime (``bench.py``'s knobs), bootstrap (blocks of D // 12) and
   adversarial (window 20, NaN, Inf, outlier, stale, drop and collapse
   draws, the default ``DegradePolicy``) families, 32 paths each in chunks
   of 16, a chunk's paths the lanes of one simulation: K1 once a
   dispatch (the hoist), the ``off()`` specs' paths
   bitwise the plain tenant step, bootstrap indices in range, adversarial
   draws inside their windows, every path finite, paths/s and one path
   against one tenant step, 2 adversarial paths against the host CPU on
   the first 166 dates at path 5's gates; (12b) the regime
   family killed after 2 of 4 chunks through ``_FMT_SCEN_STOP_AFTER_CHUNK``
   and resumed, rows and ``lineage=`` ledger byte-equal to straight
   through; (12c) 10b's ``mvo_turnover`` tenant under the regime family, 2
   paths over the first 166 dates as lanes, K2 one lane launch a segment
   a date; (12d) ``bench.py``'s
   north star, 200 x 5040 x 5000 float32 in chunks of 10 from a device
   source, ``streamed_linear_research`` and the equal backtest: K1 20
   times, the first 2 chunks' stats bitwise the one-shot stats, the
   one-pass composite against the two-pass flow, the wall and the memory
   peak, K1 timed at 50,400 rows of 5000; (12e) its host form, 16 factors
   (1.6 GB) streamed from host memory serially, prefetched and from chunk
   files through the pinned copy stream, bitwise equal, with each wall and
   host-to-device rate;
12. path 13, the mesh layer on ``torch.distributed`` as a world of one
   over NCCL (an in-process store; one card holds one NCCL rank, so more
   ranks run only as the CPU tests' ``gloo`` worlds), formed by the first
   mesh and destroyed at the end, every sharded run held against its
   unsharded twin at ``P13_TOL``: (13a) ``make_sharded_research_step`` on
   a (1, 1) ``("factor", "date")`` mesh at path 1's width on its first
   166 dates, K1 once and K2 332 times, its wall beside the unsharded
   step's, bitwise or not, and the comms ledger's collectives a stage
   (none in the backtest); (13b) ``make_sharded_manager_sweep`` on a
   ``("combo",)`` mesh at 8b's 1000 combos; (13c) the asset-sharded step
   (icir_top / equal, 1332 x 1000) under each layout mode and under
   ``choose_asset_specs``' plan (its five stages, the JAX package's, run
   on ``meta`` tensors), then plain mvo (1332 dates) and the turnover
   scan (166) under each mode, every run bitwise or within ``P13_TOL``
   of the unsharded step, K1 once a run and K2 as the unsharded runs;
   (13d) ``TenantServer(mesh=...)`` on a (1, 1) ``("configs",
   "assets")`` mesh: 10a's rung-8 dispatch of 5 tenants on the stored
   blocks (no whole-panel gather) and 10d's two turnover tenants over 16
   dates on their state's asset blocks, bitwise the unsharded server (K2
   a lane launch a segment a date), then 9b's tenant through
   ``make_online_step(mesh=)`` on an ``("assets",)`` world of one over
   the same 16 dates, bitwise the unsharded advance with K1 and K2 as its
   schedule; the held blocks' shapes and the comms ledger by ``online/*``
   stage (0 bytes in a world of one) printed;
   (13e) ``streamed_factor_stats(mesh=)``
   from 12e's host stack through a date-block source, bitwise 12e's
   serial run, K1 once a chunk;
13. path 14, the telemetry: (14a) 13a's run is the sharded step's first
   call, under a ``RunReport(comms=True)``, so it lands its placement
   rows: the comms rows (their collectives 13a's ledger's), the memory row
   measured by ``obs.memory`` (its identity ``peak = argument + output +
   temp - alias``, its peak at least the arguments) and a clean sharding
   verdict; (12d takes its peak through ``obs.memory.peak_bytes`` too);
   (14b) ``RunReport.add_devtime`` of path 1's step on its first
   ``P14_DATES`` dates after a warm-up: the exported Kineto trace's device
   time by ``obs.stage``, device tracks present, the stages and the
   unattributed bucket summing to the device time within ``P14_SUM_TOL``,
   device time within the wall, and the trace's K1 and K2 kernel events
   equal to the wrappers' launches for that call; (14d)
   ``obs.cost_estimate`` of path 8a's equal-weight step at full shape,
   finite and positive, and the failure form for the parallel turnover
   step, whose sweeps read the host; (14c) ``obs.compile_stats()`` of every
   instrumented entry point the script called, none retraced;
14. path 15, the chaos matrix (``python -m factormodeling_tpu_torch.chaos``'s
   presets, called in process on the card) at F=50, N=1000 on the
   matrix's own panel (no NaN cells; its attribution tables assume none):
   (15a) every fault class x every policy with equal weights over
   all 1332 dates, then the ``mvo_turnover`` column under ``full`` on the
   first 32 dates, fused, each cell's invariants and watchdog stage held,
   two turnover cells against the same cell on the host CPU (the degrade
   counters exact, the weights at path 1's gate); (15b) the serving preset
   (``linear``, 10a's tenants at rung 8, the first 333 dates); (15c) the
   online preset (9b's tenant with the matrix's window and lookback of 8,
   16 dates a cell); (15d) the scenario preset
   (``equal``, 4 paths a family, the first 166 dates); a line a cell with
   its verdict, wall and launches; then the CLI with ``--device cuda``
   killed after cell 1 (``_FMT_CHAOS_DIE_AFTER_CELL``) and resumed, its
   verdict byte-equal to a straight run's;
15. one ``kernels`` JSON line; then the last line
   ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero, printing no result, without one or
without the package beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
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
# the CPU reference runs the path's first P5_CPU_DATES dates, beside the
# card's run of the same dates (cut from 1332 to make room for path 12)
P5_CPU_DATES = 333

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


def collect_phase(torch, seed: int) -> dict:
    """Path 11b: the segment kernel's ``collect=1``, ``anderson=0`` form
    (the iterations-to-converge tally the probed step launches) at path
    1's shape (T=60, N=1000, K=2, float64), on a turnover day (L1 on, the
    timed one) and a plain-MVO day, against its plain version: the tally
    exact, x, z, u and dz within ADMM_TOL. Returns its JSON entry."""
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.segment_phases import sample_day_operands

    kw = dict(relax=1.7, seg_len=SEG_LEN, collect=True)
    tol = ADMM_TOL["float64"]
    entry = None
    for l1 in (0.1, 0.0):
        ops = sample_day_operands(torch.float64, seed + 2, 1, l1)
        out = ak.admm_segment(*ops, **kw)
        ref = ak.admm_segment_plain(*ops, **kw)
        torch.cuda.synchronize()
        err = max(float((a - b_).abs().max()) for a, b_ in zip(out[:4],
                                                               ref[:4]))
        conv, conv_ref = int(out[6]), int(ref[6])
        log(f"kernel admm_segment collect=1 float64 T={T_LOOKBACK} N={N} "
            f"K={K_LEGS} seg_len={SEG_LEN} l1={l1}: max_abs_err {err:.3e} "
            f"(tol {tol}) on x, z, u, dz; conv tally {conv} (plain "
            f"{conv_ref}); tallies {[int(v) for v in out[4:]]}")
        if not (err <= tol and [int(v) for v in out[4:]]
                == [int(v) for v in ref[4:]]):
            raise AssertionError(f"admm_segment collect=1 l1={l1}: max "
                                 f"|err| {err} (tol {tol}) or a tally apart")
        if entry is None:
            ms, _ = segment_device_ms(torch, ak, ops, 200, **kw)
            wrap_ms = cuda_ms(torch, lambda: ak.admm_segment(*ops, **kw), 50)
            plain_ms = cuda_ms(torch,
                               lambda: ak.admm_segment_plain(*ops, **kw), 5)
            entry = _segment_entry("admm_segment_collect", ak, ops, kw, err,
                                   ms, wrap_ms, plain_ms, "float64")
            log(f"kernel admm_segment collect=1 float64: device {ms:.4f} "
                f"ms/launch, wrapper {wrap_ms:.4f} ms/call, plain "
                f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.6f} ms "
                f"({entry['bound_by']})")
    return entry


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


# the seeded-draw phase: the research step's [F, D, N] on the card, the
# CPU's draw of its first DRAW_PREFIX counters, chunks of DRAW_PREFIX
DRAW_PREFIX, DRAW_SPAN = 1 << 20, 1332
# a bounded uniform whose span is no power of two (the emulated fused
# multiply-add); path 3's sketch: N names by its 20 risk factors plus the
# default oversampling of 8, within DRAW_NORMAL_ULP of the CPU's (the
# normal's log is each device's)
DRAW_BOUNDS, DRAW_SKETCH, DRAW_NORMAL_ULP = (-2.5, 3.7), (N, 20 + 8), 4


def _ulps(torch, a, b) -> int:
    """The largest distance in units in the last place between two float
    tensors of one type (on the CPU)."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    lo = torch.iinfo(it).min

    def line(x):   # the sign-magnitude bits onto one ordered line
        x = x.contiguous().view(it).to(torch.int64)
        return torch.where(x < 0, lo - x, x)

    return int((line(a) - line(b)).abs().max())


def draw_phase(torch, fmt, smi: str) -> dict:
    """JAX's threefry streams on the card (``fmt.threefry``): a float32
    uniform and a 64-bit ``randint`` in [0, DRAW_SPAN) at [F, D, N] under
    path 9a's first fault lane, timed; each bitwise the CPU's draw of its
    first DRAW_PREFIX counters (the counters are the flat index, whatever
    the shape) and the card's draw made in chunks of DRAW_PREFIX counters;
    a uniform on DRAW_BOUNDS bitwise the CPU's and path 3's sketch within
    DRAW_NORMAL_ULP of the CPU's, in float32 and float64. Returns the
    milliseconds of each timed draw."""
    tf = fmt.threefry
    key = fmt.rng.lane_key("fault/nan_burst", R_FAULTS["seed"], 0)
    shape = (F, D, N)

    def uniform(**kw):
        return tf.uniform(key, shape, torch.float32, device="cuda", **kw)

    def randint(**kw):
        return tf.randint(key, shape, 0, DRAW_SPAN, torch.int64,
                          device="cuda", **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    tf.uniform(key, (1 << 16,), torch.float32, device="cuda")   # warm-up
    u, u_ms = timed(uniform)
    r, r_ms = timed(randint)
    u_h = tf.uniform(key, (DRAW_PREFIX,), torch.float32, device="cpu")
    r_h = tf.randint(key, (DRAW_PREFIX,), 0, DRAW_SPAN, torch.int64,
                     device="cpu")
    prefix = (_bytes_equal(u.reshape(-1)[:DRAW_PREFIX], u_h)
              and _bytes_equal(r.reshape(-1)[:DRAW_PREFIX], r_h))
    chunked = (torch.equal(u.view(torch.int32),
                           uniform(chunk=DRAW_PREFIX).view(torch.int32))
               and torch.equal(r, randint(chunk=DRAW_PREFIX)))
    in_range = (float(u.min()) >= 0.0 and float(u.max()) < 1.0
                and int(r.min()) >= 0 and int(r.max()) < DRAW_SPAN)
    bounded = all(_bytes_equal(
        tf.uniform(key, (DRAW_PREFIX,), dt, *DRAW_BOUNDS, device="cuda"),
        tf.uniform(key, (DRAW_PREFIX,), dt, *DRAW_BOUNDS, device="cpu"))
        for dt in (torch.float32, torch.float64))
    sketch = tf.seed_key(0)   # the risk model's default seed, path 3's
    normal_ulps = {str(dt).split(".")[-1]: _ulps(
        torch, tf.normal(sketch, DRAW_SKETCH, dt, device="cuda").cpu(),
        tf.normal(sketch, DRAW_SKETCH, dt, device="cpu"))
        for dt in (torch.float32, torch.float64)}
    log(f"phase draws ({smi}): uniform float32 {list(shape)} "
        f"{u_ms:.2f} ms, randint int64 [0, {DRAW_SPAN}) {r_ms:.2f} ms "
        f"(chunks of {tf.CHUNK} counters); the first {DRAW_PREFIX} counters "
        f"bitwise the CPU's: {prefix}; bitwise the card's draw in chunks of "
        f"{DRAW_PREFIX}: {chunked}; in range: {in_range}; a uniform on "
        f"{list(DRAW_BOUNDS)} (float32, float64) bitwise the CPU's: "
        f"{bounded}; normal {list(DRAW_SKETCH)} (path 3's sketch) ulps from "
        f"the CPU's: {json.dumps(normal_ulps)} (limit {DRAW_NORMAL_ULP})")
    if not (prefix and chunked and in_range and bounded):
        raise AssertionError("draws: the card's threefry draws part from "
                             "the CPU's or from their chunked form")
    if max(normal_ulps.values()) > DRAW_NORMAL_ULP:
        raise AssertionError(f"draws: the card's normal parts from the "
                             f"CPU's by {normal_ulps} ulps")
    return dict(uniform_ms=u_ms, randint_ms=r_ms)


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
        # the CPU reference on the first P5_CPU_DATES dates, beside the
        # card's run of the same dates (the table aggregates every date)
        card_c, host_c = (type(x)(*(a[:, :P5_CPU_DATES] if a.ndim == 3
                                    else a[:P5_CPU_DATES] for a in x))
                          for x in (card, host))
        table_c, outs_c, _ = _scoring_run(torch, fmt, card_c, "cuda")
        t0 = time.perf_counter()
        table_h, outs_h, secs_h = _scoring_run(torch, fmt, host_c, "cpu")
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
    err_tab = {c: float(((table_c[c].cpu() - table_h[c]).abs()
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
        # against the CPU: the card's run of the CPU reference's dates
        out_c = outs_c[method]
        dw = (out_c.selection.cpu()
              - outs_h[method].selection).abs().max(-1).values
        share = float((dw > P5_DW_TOL).double().mean())
        errs[method] = (float(dw.max()), share)
        summ_c = {k: float(v) for k, v in out_c.summary._asdict().items()}
        summ_h = {k: float(v)
                  for k, v in outs_h[method].summary._asdict().items()}
        # the equal-weight legs: (date, asset) cells long on one side and
        # not on the other, or short on one and not on the other
        legs = leg_differences(torch, out_c, outs_h[method])
        d_sharpe = abs(summ_c["sharpe"] - summ_h["sharpe"])
        log(f"path scoring_selection {method}: {int((rowsum > 0).sum())} "
            f"dates selected; summary {json.dumps(summ)}; vs the CPU on the "
            f"first {P5_CPU_DATES} dates: max "
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
    ctx = SelectionContext(metrics_win={}, factor_ret=card_c.factor_ret,
                           ret_win_sum=card_c.factor_ret, window=WINDOW)
    mu, cov = _windowed_moments(ctx, torch.arange(P5_CPU_DATES,
                                                  device="cuda"),
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
    dw_pca = (outs_c["pca"].selection.cpu()
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
                share_of_bound=b_ms / wall_ms, peak_bytes=peak, out=out,
                inputs=(factors, cw, settings))


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
# depth cuts that keep the script's time as paths are added (never width:
# F, N and every shape a kernel sees stay the paths'). Path 3's fused run
# covers its first 333 dates (PATH_DATES); paths 1 and 3 hold the reference
# kernel's backtest of the fused run's own signal over the first
# REF_DATES[path] dates: 333 for path 1, whose backtest is causal to the
# bit, so its fused side is the full run's first days; path 3's whole run
# (its risk-model fits are not causal to the bit: they round differently
# with fewer dates, and the Anderson chain carries that far)
PATH_DATES = {"turnover": D, "mvo": D, "turnover_risk_anderson": 333}
REF_DATES = {"turnover": 333, "turnover_risk_anderson": 333}
# certified days against the scan: the QP is float64 (the JAX package's
# bench.py holds 1e-4 at float32)
CERT_TOL = 1e-5
# path 7 against the scan on every day, and the scan's cut (333 until PR
# 15, then 166 to make room for path 13)
P7_ALL_TOL, P7_SCAN_DATES = 1e-4, 166
# path 6 runs the first P6_DATES dates (cut from 1332 to make room for
# path 13), held against path 1's first days (its backtest is causal)
P6_DATES = 666


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


def segment_launches(fmt, sim: dict, stats: dict | None = None,
                     d: int = D):
    """The segment kernel's launches the path's schedule implies, one per
    segment of every solve: ``(single-lane, lane-batch)`` launches, as the
    wrapper counts them (``launches - lane_launches``, ``lane_launches``).
    A solve is one date (the turnover scan, the parallel scheme's
    sequential suffix) or one chunk of ``mvo_batch`` dates, the ragged tail
    a chunk too (plain mvo; the parallel scheme's seed and each executed
    sweep, by its ``stats``); a chunk of one date is a single-lane
    launch. ``d``: the run's dates."""
    from factormodeling_tpu_torch.solvers.admm_qp import _ADAPT_EVERY

    s = fmt.SimulationSettings(returns=None, cap_flag=None,
                               investability_flag=None, **sim)

    def segs(iters):
        return -(-iters // _ADAPT_EVERY)

    lone = int(d % s.mvo_batch == 1)           # a tail chunk of one date
    chunks = d // s.mvo_batch + int(d % s.mvo_batch > 1)
    if s.method == "mvo":
        per = segs(s.resolved_qp_iters(False))
        return lone * per, chunks * per
    qp = segs(s.resolved_qp_iters(True))
    if s.turnover_mode == "scan":
        return d * qp, 0
    per = (segs(s.resolved_seed_iters())
           + stats["sweeps"] * segs(s.resolved_sweep_iters()))
    return stats["suffix_len"] * qp + lone * per, chunks * per


def check_invariants(torch, path: str, out,
                     max_weight: float = MAX_WEIGHT) -> None:
    """Leg sums and the weight cap on the traded days; prints them with the
    polish and Anderson tallies."""
    diag = out.sim.diagnostics
    traded = (diag.active & diag.solver_ok).cpu().numpy()
    leg_dev = float(torch.maximum((diag.long_sum - 1.0).abs(),
                                  (diag.short_sum + 1.0).abs())
                    .cpu().numpy()[traded].max())
    w = out.sim.weights.nan_to_num()
    cap_excess = float((w.abs() - max_weight).max())
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

    d = PATH_DATES[path]
    arrays = tuple(a[:, :d] if a.ndim == 3 else a[:d]
                   for a in make_inputs(F, D, N, seed))
    if warm_up:   # library handles, allocator, kernel loads: a cut date range
        run_step(torch, fmt, tuple(a[:, :130] if a.ndim == 3 else a[:130]
                                   for a in arrays), PATHS[path], "fused")

    rk.launches = ak.launches = ak.lane_launches = 0
    out, secs, inputs = run_step(torch, fmt, arrays, PATHS[path], "fused")
    launches = segment_counts(rk, ak)
    log(f"path {path} fused: F={F} D={d} N={N} step {secs:.3f} s wall; "
        f"launches {json.dumps(launches)}")

    summ = {k: float(v) for k, v in out.summary._asdict().items()}
    log(f"path {path} fused summary " + json.dumps(summ))
    if not all(np.isfinite(v) for v in summ.values()):
        raise AssertionError(f"{path}: non-finite summary {summ}")
    check_invariants(torch, path, out)
    diag = out.sim.diagnostics
    if int(diag.qp_solves) != d:
        raise AssertionError(f"{path}: {int(diag.qp_solves)} QP solves, not {d}")
    if PATHS[path].get("qp_anderson") and not diag.anderson_accepted.sum() > 0:
        raise AssertionError(f"{path}: the Anderson accelerator never engaged")
    check_launches(path, launches, segment_launches(fmt, PATHS[path], d=d))

    if path not in REF_DATES:
        ref, ref_secs, _ = run_step(torch, fmt, arrays, PATHS[path],
                                    "reference")
        log(f"path {path} reference: step {ref_secs:.3f} s wall")
        check_fused_vs_reference(torch, path, out.sim.weights,
                                 ref.sim.weights)
        return launches, out, secs
    cut = REF_DATES[path]
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

    check_fused_vs_reference(torch, path, out.sim.weights[:cut],
                             backtest("reference"))
    return launches, out, secs


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
    d = arrays[1].shape[0]
    rk.launches = ak.launches = ak.lane_launches = 0
    out, secs, inputs = run_step(torch, fmt, arrays, sim, kernel)
    launches = segment_counts(rk, ak)
    diag = out.sim.diagnostics
    stats = fmt.backtest.sweep_stats(diag)
    log(f"path {path} {kernel}: F={F} D={d} N={N} step {secs:.3f} s wall; "
        f"launches {json.dumps(launches)}; sweep_stats {json.dumps(stats)}; "
        f"polish_stats {json.dumps(fmt.backtest.polish_stats(diag))}")
    summ = {k: float(v) for k, v in out.summary._asdict().items()}
    if not all(np.isfinite(v) for v in summ.values()):
        raise AssertionError(f"{path}: non-finite summary {summ}")
    s = fmt.SimulationSettings(returns=None, cap_flag=None,
                               investability_flag=None, **sim)
    if stats["converged_days"] + stats["suffix_len"] != d:
        raise AssertionError(f"{path}: converged days and suffix do not "
                             f"cover the run: {stats}")
    if not 1 <= stats["sweeps"] <= s.turnover_sweeps:
        raise AssertionError(f"{path}: {stats['sweeps']} sweeps")
    if stats["qp_solves"] != d + stats["sweeps"] * d + stats["suffix_len"]:
        raise AssertionError(f"{path}: {stats['qp_solves']} QP solves, not "
                             "the seed, the sweeps and the suffix")
    if kernel == "fused":
        check_launches(path, launches, segment_launches(fmt, sim, stats,
                                                        d=d))
    return out, secs, stats, launches, inputs


def turnover_parallel_path(torch, seed: int, scan_out, scan_secs: float):
    """Path 6: path 1 in the fixed-point scheme over its first P6_DATES
    dates, fused, held against path 1's own fused output on those days
    (the scan, same inputs; causal): equal weights on the suffix days,
    within ``CERT_TOL`` on certified days that both polished or neither
    attempted. Returns its launches."""
    import factormodeling_tpu_torch as fmt

    path = "turnover_parallel"
    d = P6_DATES
    arrays = tuple(a[:, :d] if a.ndim == 3 else a[:d]
                   for a in make_inputs(F, D, N, seed))
    out, secs, stats, launches, _ = parallel_run(torch, fmt, arrays, path,
                                                 "fused")
    check_invariants(torch, path, out)
    start = stats["converged_days"]
    scan_w = scan_out.sim.weights[:d]
    # entry t is day t's weights (row t + 1 of the panels shifted one day;
    # the universe is whole, so the shift is plain); the last day has none
    dw = (out.sim.weights.nan_to_num()
          - scan_w.nan_to_num()).abs().max(-1).values[1:]
    suffix = dw[start:]
    share = float((suffix > DW_TOL).double().mean()) if len(suffix) else 0.0
    bitwise = bool(torch.equal(out.sim.weights[start + 1:].nan_to_num(),
                               scan_w[start + 1:].nan_to_num()))
    cert = polish_both(torch, out.sim.diagnostics, scan_out.sim.diagnostics,
                       d - 1)[:start]
    cert_dw = float(dw[:start][cert].max()) if bool(cert.any()) else 0.0
    # entry t + 1 of the weights is day t's: the certified days that hold
    # a position (the days before the selection window are flat), and the
    # hand-over, the first suffix day, entered from the last certified
    # day's weights and exit state
    held = torch.nonzero((out.sim.weights[1:start + 1].nan_to_num() != 0)
                         .any(-1)).flatten().tolist()
    hand_dw = float(dw[start]) if 0 < start < d - 1 else 0.0
    log(f"path {path} vs path 1 (the scan): suffix days {start}-{d - 1}: max "
        f"|dw| {float(suffix.max()) if len(suffix) else 0.0:.3e}, share of "
        f"days > {DW_TOL}: {share:.4f} (limit {DW_SHARE}), bitwise {bitwise}; "
        f"certified days {start}, those holding a position {held}, "
        f"{int(cert.sum())} both polished or neither attempted: max |dw| "
        f"{cert_dw:.3e} (tol {CERT_TOL}); hand-over day {start} from day "
        f"{start - 1} ({'holding a position' if start - 1 in held else 'flat'}"
        f"): |dw| {hand_dw:.3e} (tol {DW_TOL})")
    log(f"path {path}: {d} dates {secs:.3f} s wall; path 1's fused run of "
        f"{D} dates {scan_secs:.3f} s in this call")
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

# paths 9a and 9b: the first R_DATES dates of path 1's inputs
R_DATES = 333
# path 9a's chaos cell: every stage gated on (the factors, the selection and
# the signal), NaN and Inf cells, dropped dates, collapsed universe dates
# of R_KEEP names, under a policy with every guard on
R_FAULTS = dict(seed=10, nan_rate=1e-4, inf_rate=1e-4, drop_rate=0.02,
                collapse_rate=0.02, collapse_keep=5)
R_POLICY = dict(min_universe=50, quarantine_nan_frac=0.5, clamp_absmax=5.0,
                carry_fallback=True)
#: path 11a: the probes of 9a's inert and chaos runs
P11_PROBED = dict(collect_probes=True)
P11_STAGES = ["ops/factors_raw", "ops/factors_delta", "selection/rolling",
              "composite/blend", "solver/admm", "backtest/weights",
              "backtest/pnl"]
# path 9b against path 9a's clean step: a signal row whose largest cell
# difference exceeds this (float32 z-scores of order 1) counts as parted
P9_SIG_TOL = 1e-5
# the online engine's snapshot and restatement dates
# 9b: the online advance over the first P9B_DATES dates (cut from 333 to
# make room for path 12; 10d reads its rows), the resume and restatement
# inside them
P9B_DATES = 166
P9_RESUME_DATE, P9_RESTATE_DATE = 140, 155


def _bytes_equal(a, b) -> bool:
    return a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()


def _run_resil_step(torch, fmt, inputs, cfg, build=None, **kw):
    """One call of the research step built from ``cfg`` with counters on
    (and the build options ``build``); returns (output, seconds)."""
    step = fmt.build_research_step(**dict(cfg.as_kwargs(),
                                          collect_counters=True,
                                          **(build or {})))
    if inputs[0].is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*inputs, **kw)
    if inputs[0].is_cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _resil_recount(fmt, arrays, spec, pol, out) -> dict:
    """DegradeStats recounted on the host from the drawn masks (the lanes'
    threefry draws, the JAX package's, made on the card at the default
    width) and the run's diagnostics: quarantined dates from the faulted
    factors' in-universe NaN share, held dates from the collapsed
    universe's counts, carried dates from the run's solver acceptance,
    clamped cells from the clamped signal."""
    factors, _, _, _, _, universe = arrays
    f, d, n = factors.shape

    def draw(kind, size):
        return fmt.threefry.uniform(fmt.rng.lane_key(f"fault/{kind}",
                                                     spec.seed, 0),
                                    size, device="cuda").cpu().numpy()

    nan = np.isnan(factors) | (draw("nan_burst", factors.shape)
                               < np.float32(spec.nan_rate))
    nan &= ~(draw("inf_spike", factors.shape) < np.float32(spec.inf_rate))
    dropped = draw("drop_day", (d,)) < np.float32(spec.drop_rate)
    nan[:, dropped] = True
    collapsed = (draw("universe_collapse", (d,))
                 < np.float32(spec.collapse_rate))
    uni = universe.copy()
    rank = np.cumsum(uni, axis=1)
    uni[collapsed] &= rank[collapsed] <= spec.collapse_keep
    # the step's float32 division of the two counts
    frac = ((nan & uni[None]).sum((0, 2)).astype(np.float32)
            / np.maximum(uni.sum(1) * f, 1).astype(np.float32))
    quarantined = int((frac > np.float32(pol.quarantine_nan_frac)).sum())
    held_mu = uni.sum(1) < pol.min_universe
    ok = out.sim.diagnostics.solver_ok.cpu().numpy()
    carried = ~ok & ~held_mu
    clamped = np.abs(out.signal.cpu().numpy()) == np.float32(pol.clamp_absmax)
    days = int(clamped.any(1).sum())
    return dict(quarantined_days=quarantined, held_days=int(held_mu.sum()),
                carry_fallback_days=int(carried.sum()),
                clamped_cells=int(clamped.sum()),
                degrade_events=quarantined + int(held_mu.sum())
                + int(carried.sum()) + days,
                held_mask=held_mu | carried, dropped=int(dropped.sum()),
                collapsed=int(collapsed.sum()))


def resil_path(torch, fmt, seed: int) -> dict:
    """Path 9a: the research step on the first R_DATES dates of path 1's
    inputs at full width (F=50, N=1000, mvo_turnover, fused): the clean
    step; the same with ``FaultSpec.off()`` and ``DegradePolicy.make()``,
    held bitwise to it; then one chaos cell (R_FAULTS under R_POLICY), with
    finite P&L, the leg sums and the weight cap on active unheld days, its
    DegradeStats against a host recount from the drawn masks, and the same
    cell on the host CPU (the same masks: the CPU's threefry draws are the
    card's) at path 1's weight gate. Returns the clean output, its seconds, and the kernels'
    launches in each card run."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    arrays = tuple(a[:, :R_DATES] if a.ndim == 3 else a[:R_DATES]
                   for a in make_inputs(F, D, N, seed))
    sim = dict(PATHS["turnover"], max_weight=MAX_WEIGHT,
               solver_kernel="fused")
    inputs, cfg = fmt.convert(*arrays, names=factor_names(F), window=WINDOW,
                              select_method="icir_top", blend_method="zscore",
                              sim_kwargs=sim, device="cuda")
    spec = fmt.resil.FaultSpec.make(**R_FAULTS)
    pol = fmt.resil.DegradePolicy.make(**R_POLICY)
    segs = segment_launches(fmt, PATHS["turnover"], d=1)[0]
    want = {"rank_ic_postsort": 1, "admm_segment": R_DATES * segs,
            "admm_segment_lanes": 0}
    runs = {}
    # path 11a: the inert and chaos runs are built with the probes on (the
    # chaos run with the staleness canary), which adds no run
    for name, build, kw in (
            ("clean", {}, {}),
            ("inert", P11_PROBED, dict(fault_spec=fmt.resil.FaultSpec.off(),
                                       policy=fmt.resil.DegradePolicy.make())),
            ("chaos", dict(P11_PROBED, probe_canary=True),
             dict(fault_spec=spec, policy=pol))):
        rk.launches = ak.launches = ak.lane_launches = 0
        out, secs = _run_resil_step(torch, fmt, inputs, cfg, build, **kw)
        launches = segment_counts(rk, ak)
        runs[name] = (out, secs, launches)
        log(f"path resil {name}: F={F} D={R_DATES} N={N} step {secs:.3f} s "
            f"wall; launches {json.dumps(launches)}")
        if launches != want:
            raise AssertionError(f"resil {name}: launches {launches}, the "
                                 f"schedule implies {want}")
    clean, inert = runs["clean"][0], runs["inert"][0]
    leaves = (("selection", lambda o: o.selection),
              ("signal", lambda o: o.signal),
              ("weights", lambda o: o.sim.weights),
              ("long_count", lambda o: o.sim.long_count),
              ("short_count", lambda o: o.sim.short_count),
              *((f"result.{k}", lambda o, k=k: getattr(o.sim.result, k))
                for k in clean.sim.result._fields),
              ("solver_ok", lambda o: o.sim.diagnostics.solver_ok),
              ("primal_residual",
               lambda o: o.sim.diagnostics.primal_residual))
    parted = [k for k, get in leaves if not _bytes_equal(get(clean),
                                                         get(inert))]
    log(f"path resil inert (FaultSpec.off, DegradePolicy.make, probes on) "
        f"vs clean (probes off): {len(leaves) - len(parted)} of "
        f"{len(leaves)} outputs bitwise equal; parted {parted}")
    if parted:
        raise AssertionError(f"resil: the inert run parts from the clean "
                             f"step in {parted}")

    chaos = runs["chaos"][0]
    diag = chaos.sim.diagnostics
    pnl = chaos.sim.result.log_return
    recount = _resil_recount(fmt, arrays, spec, pol, chaos)
    held = torch.from_numpy(recount.pop("held_mask")).cuda()
    unheld_active = (diag.active & ~held).cpu().numpy()
    leg_dev = float(torch.maximum((diag.long_sum - 1.0).abs(),
                                  (diag.short_sum + 1.0).abs())
                    .cpu().numpy()[unheld_active].max(initial=0.0))
    cap_excess = float((chaos.sim.weights.nan_to_num().abs()
                        - MAX_WEIGHT).max())
    stats = fmt.obs.summarize_counters(chaos.counters)
    got = {k: stats[k] for k in ("quarantined_days", "held_days",
                                 "carry_fallback_days", "clamped_cells",
                                 "degrade_events")}
    want_stats = {k: recount[k] for k in got}
    log(f"path resil chaos {json.dumps(R_FAULTS)} under "
        f"{json.dumps(R_POLICY)}: {recount['dropped']} dropped dates, "
        f"{recount['collapsed']} collapsed; DegradeStats {json.dumps(got)}, "
        f"host recount {json.dumps(want_stats)}; finite P&L "
        f"{bool(torch.isfinite(pnl).all())}; {int(unheld_active.sum())} "
        f"active unheld days, max leg-sum deviation {leg_dev:.3e} (tol "
        f"{LEG_TOL}); max |w| - max_weight {cap_excess:.3e} (tol {CAP_TOL})")
    if not bool(torch.isfinite(pnl).all()):
        raise AssertionError("resil chaos: non-finite P&L")
    if not (leg_dev <= LEG_TOL and cap_excess <= CAP_TOL
            and unheld_active.any()):
        raise AssertionError("resil chaos: leg sums or the weight cap off, "
                             "or no active unheld day")
    if got != want_stats:
        raise AssertionError(f"resil chaos: DegradeStats {got} against the "
                             f"host recount {want_stats}")
    if not (got["quarantined_days"] and got["held_days"]
            and got["carry_fallback_days"] and got["clamped_cells"]):
        raise AssertionError(f"resil chaos: a guard never engaged: {got}")

    # the same chaos cell on the host CPU: the same masks (threefry draws
    # the card's bits on the CPU)
    inputs_h, cfg_h = fmt.convert(*arrays, names=factor_names(F),
                                  window=WINDOW, select_method="icir_top",
                                  blend_method="zscore", sim_kwargs=sim,
                                  device="cpu")
    host, secs_h = _run_resil_step(torch, fmt, inputs_h, cfg_h,
                                   dict(P11_PROBED, probe_canary=True),
                                   fault_spec=spec, policy=pol)
    dw = (chaos.sim.weights.cpu().nan_to_num()
          - host.sim.weights.nan_to_num()).abs().max(-1).values
    share = float((dw > DW_TOL).double().mean())
    sel_rows = int(((chaos.selection.cpu() - host.selection).abs()
                    .max(-1).values > 0).sum())
    host_stats = fmt.obs.summarize_counters(host.counters)
    log(f"path resil chaos on the CPU: {secs_h:.1f} s; selection rows "
        f"differing {sel_rows}; weights max |dw| {float(dw.max()):.3e}, share "
        f"of days > {DW_TOL}: {share:.4f} (limit {DW_SHARE}); DegradeStats "
        f"on the CPU {json.dumps({k: host_stats[k] for k in got})}")
    if not share <= DW_SHARE:
        raise AssertionError(f"resil chaos: card and CPU weights differ on "
                             f"{share:.2%} of days")
    t0 = time.perf_counter()
    tally = probes_path(torch, fmt, runs["inert"][0], chaos, host, arrays,
                        sim)
    log(f"path 11a phase (watchdog, tallies, sync counts, CPU tally run): "
        f"{time.perf_counter() - t0:.1f} s wall")
    return dict(clean=runs["clean"][0], clean_secs=runs["clean"][1],
                launches={k: v[2] for k, v in runs.items()}, tally=tally)


# 9a's runs take the default budget (40 warm iterations), within which no
# day of path 1's market reaches the tally's 1e-3 grade (the polish does
# the rest); the tally is held firing on a run of the first P11_TALLY_DATES
# dates at P11_TALLY_ITERS iterations, on the card and on the CPU
P11_TALLY_DATES, P11_TALLY_ITERS = 90, 200


def probes_path(torch, fmt, inert, chaos, host, arrays, sim) -> dict:
    """Path 11a: the probes of 9a's runs. The inert run's frames through
    ``RunReport.add_probes`` give the baseline
    (``regression.numerics_baseline``); the chaos run's watchdog must name
    ``ops/factors_raw``, the first stage R_FAULTS injects into, and the
    inert run's none. ``iters_to_converge`` of the chaos run in
    ``[0, qp_iters]`` every day and equal to the CPU chaos run's on all
    but DW_SHARE of days. Then the tally run: the first P11_TALLY_DATES
    dates at P11_TALLY_ITERS iterations, unprobed and probed on the card
    under the sync debug mode (the reads the probes add), and probed on
    the CPU: the tally firing on some solved day, equal to the CPU's on
    all but DW_SHARE of days, bitwise the unprobed run's outputs.
    Returns the probed runs' K2 launches."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    for name, out in (("inert", inert), ("chaos", chaos), ("cpu", host)):
        if list(out.probes) != P11_STAGES:
            raise AssertionError(f"11a: the {name} run's probes "
                                 f"{list(out.probes)}, not {P11_STAGES}")
    base = fmt.obs.RunReport("path 11a inert")
    base.add_probes("resil/inert", inert.probes)
    baseline = fmt.obs.regression.numerics_baseline(base.all_rows())
    rep = fmt.obs.RunReport("path 11a chaos")
    verdict = rep.add_probes("resil/chaos", chaos.probes, baseline=baseline)
    clean_verdict = fmt.obs.watchdog(inert.probes, baseline=baseline)
    host_verdict = fmt.obs.watchdog(host.probes, baseline=baseline)
    frames = fmt.obs.summarize_probes(chaos.probes)
    counts = {k: [v["nan_count"], v["inf_count"]] for k, v in frames.items()}
    log(f"path 11a watchdog on the chaos run (baseline: the inert run's "
        f"numerics rows): first_bad_stage {verdict['first_bad_stage']!r}, "
        f"dropped {verdict['dropped']}; on the inert run "
        f"{clean_verdict['first_bad_stage']!r}; on the CPU chaos run "
        f"{host_verdict['first_bad_stage']!r}; chaos finite_frac "
        f"{json.dumps(verdict['finite_frac'])}; nan/inf counts "
        f"{json.dumps(counts)}")
    if not (verdict["first_bad_stage"] == "ops/factors_raw"
            and clean_verdict["first_bad_stage"] is None
            and host_verdict["first_bad_stage"] == "ops/factors_raw"):
        raise AssertionError("11a: the watchdog does not name the first "
                             "injected stage")
    iters = fmt.SimulationSettings(
        returns=None, cap_flag=None, investability_flag=None,
        **sim).resolved_qp_iters(turnover=True)
    itc = chaos.sim.diagnostics.iters_to_converge.cpu()
    itc_h = host.sim.diagnostics.iters_to_converge
    same = float((itc == itc_h).double().mean())
    log(f"path 11a iters_to_converge of the chaos run: range "
        f"[{int(itc.min())}, {int(itc.max())}] (budget {iters}), days > 0: "
        f"{int((itc > 0).sum())} of {int(chaos.sim.diagnostics.active.sum())} "
        f"active; equal to the CPU's on {same:.4f} of days (limit "
        f"{1 - DW_SHARE})")
    if not (int(itc.min()) >= 0 and int(itc.max()) <= iters
            and same >= 1 - DW_SHARE):
        raise AssertionError("11a: iters_to_converge out of range or apart "
                             "from the CPU's")

    cut = P11_TALLY_DATES
    sub = tuple(a[:, :cut] if a.ndim == 3 else a[:cut] for a in arrays)
    tsim = dict(sim, qp_iters=P11_TALLY_ITERS)
    runs = {}
    for dev in ("cuda", "cpu"):
        inputs, cfg = fmt.convert(*sub, names=factor_names(F), window=WINDOW,
                                  select_method="icir_top",
                                  blend_method="zscore", sim_kwargs=tsim,
                                  device=dev)
        for probed in ((False, True) if dev == "cuda" else (True,)):
            build = P11_PROBED if probed else {}
            if dev == "cuda":
                rk.launches = ak.launches = ak.lane_launches = 0
                (out, secs), syncs = _sync_reads(
                    torch, lambda: _run_resil_step(torch, fmt, inputs, cfg,
                                                   build))
                runs[(dev, probed)] = (out, secs, syncs,
                                       segment_counts(rk, ak))
            else:
                out, secs = _run_resil_step(torch, fmt, inputs, cfg, build)
                runs[(dev, probed)] = (out, secs, {}, None)
    plain, probed_out = runs[("cuda", False)][0], runs[("cuda", True)][0]
    cpu = runs[("cpu", True)][0]
    n_plain = sum(runs[("cuda", False)][2].values())
    n_probed = sum(runs[("cuda", True)][2].values())
    sites_plain, sites_probed = runs[("cuda", False)][2], runs[("cuda",
                                                               True)][2]
    added = {k: sites_probed.get(k, 0) - sites_plain.get(k, 0)
             for k in sorted(set(sites_plain) | set(sites_probed))
             if sites_probed.get(k, 0) != sites_plain.get(k, 0)}
    itc = probed_out.sim.diagnostics.iters_to_converge.cpu()
    itc_h = cpu.sim.diagnostics.iters_to_converge
    same = float((itc == itc_h).double().mean())
    parted = [k for k, a, b in (
        ("selection", plain.selection, probed_out.selection),
        ("signal", plain.signal, probed_out.signal),
        ("weights", plain.sim.weights, probed_out.sim.weights),
        ("log_return", plain.sim.result.log_return,
         probed_out.sim.result.log_return))
        if not _bytes_equal(a, b)]
    launches = runs[("cuda", True)][3]
    log(f"path 11a tally run: first {cut} dates at qp_iters "
        f"{P11_TALLY_ITERS}: unprobed {runs[('cuda', False)][1]:.3f} s, "
        f"probed {runs[('cuda', True)][1]:.3f} s on the card (sync debug "
        f"mode on), {runs[('cpu', True)][1]:.1f} s on the CPU; launches "
        f"{json.dumps(launches)}; iters_to_converge > 0 on "
        f"{int((itc > 0).sum())} days (max {int(itc.max())}), equal to the "
        f"CPU's on {same:.4f} of days; probed outputs bitwise the "
        f"unprobed: parted {parted}; synchronizing reads: unprobed "
        f"{n_plain}, probed {n_probed}, the difference by calling line "
        f"{json.dumps(added)}")
    if not (int((itc > 0).sum()) > 0 and int(itc.max()) <= P11_TALLY_ITERS
            and same >= 1 - DW_SHARE and not parted):
        raise AssertionError("11a: the tally run's iters_to_converge never "
                             "fires, parts from the CPU's, or the probes "
                             "move an output")
    return launches





def _sync_reads(torch, fn):
    """``fn()`` under torch's CUDA sync debug mode: the synchronizing
    operations it warns of, counted by the line of the port that called
    them (``{"file:line": count}``)."""
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return result, dict(sites.most_common())


def online_path(torch, fmt, seed: int, clean) -> dict:
    """Path 9b: an ``OnlineEngine`` for path 1's tenant (icir_top top 5,
    zscore, mvo_turnover, penalty 0.1, max_weight 0.03, lookback and
    window 60, fused) ingests dates 0..P9B_DATES-1 of path 1's inputs one at
    a time on the card, held against path 9a's clean step: the selection
    and signal rows (bitwise, or the rows the card's reductions part
    counted), the traded weights at DW_TOL/DW_SHARE, the leg counts and
    solver acceptance where the weights agree, the daily P&L where the
    books agree; K1 once a date and K2 as on path 1; a fresh engine
    resumed from the snapshot at P9_RESUME_DATE byte-equal to straight
    through; a restatement of P9_RESTATE_DATE with the same content
    REPLAYED byte-equal. Prints the per-date advance wall p50/p99 and the
    synchronizing reads a date. Returns the straight run's launches and its
    rows by finalized day."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.online import DateSlice, OnlineEngine
    from factormodeling_tpu_torch.serve import TenantConfig

    arrays = tuple(a[:, :P9B_DATES] if a.ndim == 3 else a[:P9B_DATES]
                   for a in make_inputs(F, D, N, seed))
    factors, returns, factor_ret, cap, invest, universe = arrays
    tmpl = TenantConfig(method="mvo_turnover", window=WINDOW,
                        lookback_period=T_LOOKBACK, top_k=5,
                        icir_threshold=0.03, max_weight=MAX_WEIGHT, pct=0.1,
                        turnover_penalty=0.1,
                        sim_static={"solver_kernel": "fused"})
    ck_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(ck_dir, exist_ok=True)
    ck = os.path.join(ck_dir, "online.ckpt")
    if os.path.exists(ck):
        os.unlink(ck)

    def engine(**kw):
        return OnlineEngine(names=factor_names(F), n_assets=N, template=tmpl,
                            has_universe=True, horizon=16,
                            dtype=torch.float32, device="cuda", **kw)

    def date_slice(t):
        return DateSlice(factors=factors[:, t], returns=returns[t],
                         factor_ret=factor_ret[t], cap_flag=cap[t],
                         investability=invest[t], universe=universe[t])

    # warm-up on a few dates: library handles, allocator
    warm = engine()
    for t in range(4):
        warm.ingest(t, date_slice(t))
    del warm

    straight = engine(checkpoint=ck, checkpoint_every=P9_RESUME_DATE + 1)
    rk.launches = ak.launches = ak.lane_launches = 0
    rows, walls = {}, []
    for t in range(P9B_DATES):
        t0 = time.perf_counter()
        if t == P9B_DATES - 1:    # the last date counts its synchronizing reads
            v, syncs = _sync_reads(torch, lambda: straight.ingest(
                t, date_slice(t)))
        else:
            v = straight.ingest(t, date_slice(t))
            walls.append(time.perf_counter() - t0)
        if v.status != "applied":
            raise AssertionError(f"online: date {t} {v.status} {v.reason}")
        rows.update({int(o["day"]): o for o in v.outputs})
    launches = segment_counts(rk, ak)
    segs = segment_launches(fmt, PATHS["turnover"], d=1)[0]
    want = {"rank_ic_postsort": P9B_DATES,
            "admm_segment": (P9B_DATES - 1) * segs, "admm_segment_lanes": 0}
    ms = np.asarray(walls[1:]) * 1e3
    log(f"path online: {P9B_DATES} dates ingested one at a time, F={F} N={N}, "
        f"float32 panels: advance wall per date p50 "
        f"{np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} "
        f"ms, max {ms.max():.3f} ms, total {sum(walls):.3f} s; launches "
        f"{json.dumps(launches)} (schedule {json.dumps(want)}); "
        f"synchronizing reads in the last date's advance: "
        f"{sum(syncs.values())}, by calling line {json.dumps(syncs)}")
    if launches != want:
        raise AssertionError(f"online: launches {launches}, the schedule "
                             f"implies {want}")
    days = sorted(rows)
    if days != list(range(P9B_DATES - 1)):
        raise AssertionError(f"online: finalized days {days[:3]}..")

    def stack(key):
        return torch.from_numpy(np.stack([rows[d][key] for d in days]))

    cut = P9B_DATES - 1
    d_sel = (stack("selection") - clean.selection[:cut].cpu()).abs()
    d_sig = (stack("signal").nan_to_num()
             - clean.signal[:cut].cpu().nan_to_num()).abs().max(-1).values
    sel_rows = int((d_sel.max(-1).values > 0).sum())
    sig_rows = int((d_sig > 0).sum())
    sig_parted = int((d_sig > P9_SIG_TOL).sum())
    w_on = stack("weights").nan_to_num()
    w_full = clean.sim.weights[:cut].cpu().nan_to_num()
    dw = (w_on - w_full).abs().max(-1).values
    share = float((dw > DW_TOL).double().mean())
    agree = dw <= DW_TOL
    lc_bad = int(((stack("long_count") != clean.sim.long_count[:cut].cpu())
                  & agree).sum())
    ok_bad = int(((stack("solver_ok")
                   != clean.sim.diagnostics.solver_ok[:cut].cpu())
                  & agree).sum())
    same = (w_on == w_full).all(-1)
    books = same & torch.cat([same.new_ones(1), same[:-1]])
    d_pnl = (stack("log_return")
             - clean.sim.result.log_return[:cut].cpu()).abs()
    pnl_agree = float(d_pnl[books].max()) if bool(books.any()) else 0.0
    log(f"path online vs path 9a's clean step (days 0-{cut - 1}): selection "
        f"rows differing {sel_rows} (max |d| {float(d_sel.max()):.3e}); "
        f"signal rows differing {sig_rows}, beyond {P9_SIG_TOL}: {sig_parted} "
        f"(max |d| {float(d_sig.max()):.3e}); weights max |dw| "
        f"{float(dw.max()):.3e}, share of days > {DW_TOL}: {share:.4f} "
        f"(limit {DW_SHARE}), days bitwise {int(same.sum())}; leg counts and "
        f"solver_ok where the weights agree: {lc_bad} and {ok_bad} differ; "
        f"daily P&L on the {int(books.sum())} days whose books (and the day "
        f"before's) are equal: max |d| {pnl_agree:.3e} (tol {P8_RET_TOL}), "
        f"on all days {float(d_pnl.max()):.3e}")
    if not (share <= DW_SHARE and sig_parted <= DW_SHARE * cut):
        raise AssertionError("online: weights or signal rows part from the "
                             "research step")
    if lc_bad or ok_bad or not pnl_agree <= P8_RET_TOL:
        raise AssertionError("online: leg counts, solver acceptance or P&L "
                             "differ where the books agree")

    # a fresh engine resumed from the snapshot at P9_RESUME_DATE
    resumed = engine(checkpoint=ck, checkpoint_every=P9_RESUME_DATE + 1)
    if resumed.last_date != P9_RESUME_DATE:
        raise AssertionError(f"online: resumed at {resumed.last_date}")
    dup = resumed.ingest(P9_RESUME_DATE, date_slice(P9_RESUME_DATE))
    res_rows = {}
    for t in range(P9_RESUME_DATE + 1, P9B_DATES):
        res_rows.update({int(o["day"]): o for o in
                         resumed.ingest(t, date_slice(t)).outputs})
    res_equal = all(
        all(np.asarray(res_rows[d][k]).tobytes()
            == np.asarray(rows[d][k]).tobytes() for k in rows[d])
        for d in res_rows) and sorted(res_rows) == days[P9_RESUME_DATE:]
    # a restatement with the same content replays the first application
    v = straight.ingest(P9_RESTATE_DATE, date_slice(P9_RESTATE_DATE),
                        restate=True)
    rep_equal = v.status == "replayed" and all(
        all(np.asarray(o[k]).tobytes()
            == np.asarray(rows[int(o["day"])][k]).tobytes() for k in o)
        for o in v.outputs)
    log(f"path online resume from the snapshot at date {P9_RESUME_DATE}: "
        f"re-sent date {dup.status} ({dup.reason}); {len(res_rows)} rows "
        f"byte-equal to straight through: {res_equal}; restatement of date "
        f"{P9_RESTATE_DATE}: {v.status} ({v.reason}), {len(v.outputs)} rows "
        f"re-finalized, byte-equal: {rep_equal}; verdicts complete "
        f"{straight.verdict_complete() and resumed.verdict_complete()} "
        f"{json.dumps(straight.counters)}")
    if not (dup.reason == "duplicate" and res_equal and rep_equal
            and straight.verdict_complete() and resumed.verdict_complete()):
        raise AssertionError("online: resume or replay not byte-equal")
    return launches, rows, ms


# path 11c: 9b's tenant with every engine hook on, over 9b's first
# P11C_DATES dates, a checkpoint every date (horizon P11C_HORIZON: each
# save holds the ring's states, ~2.2 MB each at this width), the kill at
# P11C_KILL and a restatement of P11C_RESTATE inside the horizon, re-sent
# after the last date
P11C_DATES, P11C_HORIZON, P11C_KILL, P11C_RESTATE = 32, 4, 16, 30


def engine_sentry(fmt):
    """The engine's sentry: zero-budget burns over rejected and replayed
    dates and a CUSUM on the slice's NaN share."""
    from factormodeling_tpu_torch.obs import sentry as sn

    return sn.Sentry(detectors=[
        sn.BurnRateDetector("reject_rate", bad="rejected", total="ingested",
                            budget=0.0),
        sn.BurnRateDetector("replay_rate", bad="replayed", total="ingested",
                            budget=0.0),
        sn.CusumDetector("nan_frac", k=0.5, h=5.0, warmup=5)])


def hooked_online_path(torch, fmt, seed: int, ms9b) -> None:
    """Path 11c: an ``OnlineEngine(flight=True, lineage=True, sentry=...)``
    for 9b's tenant over the first P11C_DATES dates, checkpointed every
    date, with a restatement of P11C_RESTATE: its rows bitwise those of an
    unhooked engine fed the same stream; ``ledger_errors``, ``row_errors``
    and ``sentry_errors`` empty, one finished span tree a tick; a run
    killed after P11C_KILL and resumed from its snapshot ends with a
    ledger and an alert log byte-equal to the straight run's. Prints the
    wall a date p50/p99 beside 9b's and the cost of one state hash."""
    from factormodeling_tpu_torch.obs.lineage import ledger_errors
    from factormodeling_tpu_torch.obs.reqtrace import row_errors
    from factormodeling_tpu_torch.obs.sentry import sentry_errors
    from factormodeling_tpu_torch.online import DateSlice, OnlineEngine
    from factormodeling_tpu_torch.online import engine as engine_mod
    from factormodeling_tpu_torch.resil.checkpoint import fingerprint
    from factormodeling_tpu_torch.serve import TenantConfig

    cut = P11C_DATES
    arrays = tuple(a[:, :cut] if a.ndim == 3 else a[:cut]
                   for a in make_inputs(F, D, N, seed))
    factors, returns, factor_ret, cap, invest, universe = arrays
    tmpl = TenantConfig(method="mvo_turnover", window=WINDOW,
                        lookback_period=T_LOOKBACK, top_k=5,
                        icir_threshold=0.03, max_weight=MAX_WEIGHT, pct=0.1,
                        turnover_penalty=0.1,
                        sim_static={"solver_kernel": "fused"})
    ck_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(ck_dir, exist_ok=True)

    def engine(ck=None, hooked=True):
        kw = dict(flight=True, lineage=True,
                  sentry=engine_sentry(fmt)) if hooked else {}
        if ck is not None:
            kw.update(checkpoint=ck, checkpoint_every=1)
        return OnlineEngine(names=factor_names(F), n_assets=N, template=tmpl,
                            has_universe=True, horizon=P11C_HORIZON,
                            dtype=torch.float32, device="cuda", **kw)

    def date_slice(t, scale=1.0):
        return DateSlice(factors=factors[:, t] * np.float32(scale),
                         returns=returns[t], factor_ret=factor_ret[t],
                         cap_flag=cap[t], investability=invest[t],
                         universe=universe[t])

    def feed(eng, dates, walls=None):
        rows = []
        for t in dates:
            t0 = time.perf_counter()
            v = eng.ingest(t, date_slice(t))
            if walls is not None:
                walls.append(time.perf_counter() - t0)
            if v.status != "applied":
                raise AssertionError(f"11c: date {t} {v.status}")
            rows.extend(v.outputs)
        return rows

    def restate(eng):
        v = eng.ingest(P11C_RESTATE, date_slice(P11C_RESTATE, 1.5),
                       restate=True)
        if v.status != "replayed":
            raise AssertionError(f"11c: restatement {v.status} {v.reason}")
        return list(v.outputs)

    def cks(name):
        path = os.path.join(ck_dir, name)
        if os.path.exists(path):
            os.unlink(path)
        return path

    plain = engine(hooked=False)
    walls_plain = []
    rows_plain = feed(plain, range(cut), walls_plain) + restate(plain)
    walls = []
    # the straight and the killed runs write the same snapshot path in
    # turn: an incident cites the checkpoint, so the paths must agree
    straight = engine(cks("hooked.ckpt"))
    rows_hooked = feed(straight, range(cut), walls) + restate(straight)
    killed = engine(cks("hooked.ckpt"))
    feed(killed, range(P11C_KILL + 1))
    del killed
    resumed = engine(os.path.join(ck_dir, "hooked.ckpt"))
    if resumed.last_date != P11C_KILL:
        raise AssertionError(f"11c: resumed at {resumed.last_date}")
    feed(resumed, range(P11C_KILL + 1, cut))
    restate(resumed)

    bitwise = len(rows_plain) == len(rows_hooked) and all(
        all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
            for k in a) for a, b in zip(rows_plain, rows_hooked))
    rows = (straight.flight_rows() + straight.lineage_rows()
            + straight.sentry_rows())
    errors = (ledger_errors(rows) + row_errors(rows) + sentry_errors(rows))
    ticks = straight.counters["ingested_dates"]
    traces = [r for r in straight.flight_rows()]
    finished = sum(1 for r in traces if r["complete"])
    led_equal = resumed._lineage.state() == straight._lineage.state()
    alerts_equal = resumed._sentry.state() == straight._sentry.state()
    # the lineage hash of one state on the card: the copy to the host and
    # the sha256 pass, timed alone
    hash_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fingerprint(*engine_mod._jax_leaves(straight._state))
        hash_s.append(time.perf_counter() - t0)
    nbytes = sum(a.nbytes for a in engine_mod._jax_leaves(straight._state))
    ms = np.asarray(walls[1:]) * 1e3
    ms_plain = np.asarray(walls_plain[1:]) * 1e3
    kinds = [r["edge_kind"] for r in straight.lineage_rows()]
    alerts = straight._sentry.alerts
    log(f"path 11c: {cut} dates, every hook on, a checkpoint every date "
        f"(horizon {P11C_HORIZON}), restatement of {P11C_RESTATE}: wall "
        f"per date p50 {np.percentile(ms, 50):.3f} ms, p99 "
        f"{np.percentile(ms, 99):.3f} ms; the same dates unhooked "
        f"without checkpoints p50 {np.percentile(ms_plain, 50):.3f} ms, p99 "
        f"{np.percentile(ms_plain, 99):.3f} ms (9b, hooks off, one "
        f"checkpoint in {P9B_DATES} dates: p50 {np.percentile(ms9b, 50):.3f} "
        f"ms, p99 {np.percentile(ms9b, 99):.3f} ms); one state hash "
        f"{np.median(hash_s) * 1e3:.3f} ms ({nbytes / 1e6:.1f} MB to the "
        f"host and sha256); rows bitwise the unhooked engine's: {bitwise} "
        f"({len(rows_hooked)} rows); lineage edges "
        f"{json.dumps({k: kinds.count(k) for k in sorted(set(kinds))})}; "
        f"alerts {[(a['detector'], a['signal']) for a in alerts]}, incidents "
        f"{len(straight._sentry.incidents)}; traces {len(traces)} for "
        f"{ticks} ticks, finished {finished}; findings {errors}; resumed "
        f"after the kill at {P11C_KILL}: ledger byte-equal {led_equal}, "
        f"alert log byte-equal {alerts_equal}")
    if not (bitwise and not errors and len(traces) == ticks
            and finished == ticks and led_equal and alerts_equal):
        raise AssertionError("11c: the hooked engine parts from the "
                             "unhooked one, a checker has findings, or the "
                             "resumed ledger or alert log differs")


def checkpointed_sweep_path(torch, fmt, out, inputs) -> None:
    """Path 8c: ``checkpointed_manager_sweep`` at path 8b's shape with the
    provenance ledger on (``lineage=``), killed inside its second chunk and
    resumed from the snapshot: every output bitwise equal to 8b's
    ``manager_sweep``, and the resumed ledger byte-equal to the ledger of a
    straight-through checkpointed run, with no referential finding."""
    from factormodeling_tpu_torch.obs.lineage import (LineageLedger,
                                                      ledger_errors)
    from factormodeling_tpu_torch.parallel import sweep as sweep_mod

    factors, cw, settings = inputs
    ck_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(ck_dir, exist_ok=True)
    ck = os.path.join(ck_dir, "sweep.ckpt")
    if os.path.exists(ck):
        os.unlink(ck)
    real = sweep_mod._combine_and_pnl
    calls = {"n": 0}

    class Interrupted(Exception):
        pass

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise Interrupted("path 8c: interrupted in chunk 2")
        return real(*a, **kw)

    sweep_mod._combine_and_pnl = dying
    t0 = time.perf_counter()
    try:
        fmt.parallel.checkpointed_manager_sweep(
            factors, cw, settings, combo_batch=SWEEP_BATCH,
            checkpoint=fmt.resil.Checkpointer(ck), lineage=LineageLedger(),
            device="cuda")
        raise AssertionError("path 8c: the interrupt did not fire")
    except Interrupted:
        pass
    finally:
        sweep_mod._combine_and_pnl = real
    first = time.perf_counter() - t0
    state, _ = fmt.resil.load_snapshot(ck)
    t0 = time.perf_counter()
    ledger = LineageLedger()
    resumed = fmt.parallel.checkpointed_manager_sweep(
        factors, cw, settings, combo_batch=SWEEP_BATCH,
        checkpoint=fmt.resil.Checkpointer(ck), lineage=ledger,
        device="cuda")
    torch.cuda.synchronize()
    second = time.perf_counter() - t0
    ck2 = os.path.join(ck_dir, "sweep_straight.ckpt")
    if os.path.exists(ck2):
        os.unlink(ck2)
    straight = LineageLedger()
    t0 = time.perf_counter()
    fmt.parallel.checkpointed_manager_sweep(
        factors, cw, settings, combo_batch=SWEEP_BATCH,
        checkpoint=fmt.resil.Checkpointer(ck2), lineage=straight,
        device="cuda")
    third = time.perf_counter() - t0
    kinds = [e["edge_kind"] for e in ledger.edges]
    led_equal = ledger.state() == straight.state()
    led_errors = ledger_errors(ledger.rows("parallel/sweep"))
    parted = [f for f in resumed._fields
              if not _bytes_equal(getattr(resumed, f), getattr(out, f))]
    log(f"path checkpointed_sweep: C={SWEEP_C} combos in chunks of "
        f"{4 * SWEEP_BATCH}, interrupted in chunk 2 after {first:.3f} s "
        f"(snapshot: {state['next_chunk']} chunk); resumed {second:.3f} s; "
        f"outputs bitwise equal to path 8b's manager_sweep: "
        f"{len(resumed) - len(parted)} of {len(resumed)}, parted {parted}; "
        f"lineage: {kinds.count('sweep_chunk')} sweep_chunk edges and "
        f"{kinds.count('source')} source, the resumed ledger byte-equal to "
        f"a straight-through checkpointed run's ({third:.3f} s): "
        f"{led_equal}, ledger_errors {led_errors}")
    if state["next_chunk"] != 1 or parted:
        raise AssertionError(f"path 8c: resumed sweep parts from "
                             f"manager_sweep in {parted}")
    n_chunks = -(-SWEEP_C // (4 * SWEEP_BATCH))
    if not (led_equal and not led_errors
            and kinds.count("sweep_chunk") == n_chunks):
        raise AssertionError("path 8c: the resumed ledger parts from the "
                             "straight-through run's")



# path 10: serving at path 1's market (F=50, N=1000, float32 panels, window
# 60, icir_top, zscore). 10a: an equal-weight bucket of S_TENANTS tenants at
# D=1332 with bench.py::bench_tenant_sweep's knob draw, served once cold,
# once warm, then S_PROBE of them (rung 8, 3 pad lanes), S_CHECKED lanes
# held bitwise to the single-tenant step and against the host CPU
S_TENANTS, S_PROBE, S_CHECKED = 64, 5, 4
# 10c: bench.py::bench_serving_under_load's recipe at path 1's market: the
# service time of one warm rung-8 dispatch, a Poisson trace at S_LOAD x
# that capacity, deadlines S_DEADLINE_X x the service time
S_REQUESTS, S_LADDER, S_LOAD, S_DEADLINE_X, S_DEPTH = 48, (1, 4, 8), 2.0, 40, 8
S_FAULTS = dict(seed=36, error_rate=0.05, poison_rate=0.05)
# 10d: advance_all over path 9b's first S_ONLINE_DATES dates
S_ONLINE_DATES = 166
# 10b: the first P10B_DATES of path 9's dates (333 until 10e came: a
# depth cut, PERF.md section 4); tenants 1 and 2 held to their
# single-tenant steps on the first P10B_HELD traded dates
P10B_DATES, P10B_HELD = 166, 16


def serving_configs(fmt, n: int):
    """bench.py::bench_tenant_sweep's knob draw, in its order: one
    signature bucket (equal weights, window 60), every value leaf
    varied."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(n):
        mix = rng.uniform(0.2, 1.0, size=F)
        out.append(fmt.serve.TenantConfig(
            top_k=1 + i % F, icir_threshold=-1.0, manager_mix=mix,
            max_weight=float(0.05 + 0.2 * rng.uniform()),
            pct=float(0.1 + 0.2 * rng.uniform()),
            tcost_scale=float(rng.uniform(0.5, 2.0)),
            method="equal", window=WINDOW))
    return out


def turnover_configs(fmt):
    """Path 10b's bucket: path 1's own tenant (9b's), then two tenants
    with other penalties, caps and cost scales."""
    import dataclasses

    t0 = fmt.serve.TenantConfig(
        method="mvo_turnover", window=WINDOW, lookback_period=T_LOOKBACK,
        top_k=5, icir_threshold=0.03, max_weight=MAX_WEIGHT, pct=0.1,
        turnover_penalty=0.1, sim_static={"solver_kernel": "fused"})
    return [t0,
            dataclasses.replace(t0, turnover_penalty=0.05, max_weight=0.02,
                                tcost_scale=0.5),
            dataclasses.replace(t0, turnover_penalty=0.2, max_weight=0.05,
                                tcost_scale=2.0)]


def _panels(arrays) -> dict:
    return dict(zip(("factors", "returns", "factor_ret", "cap_flag",
                     "investability", "universe"), arrays))


class _SimCount:
    """Counts the tenant body's ``run_simulation`` calls (one a dispatch,
    chunk or date for every lane at once) while it is entered."""

    def __enter__(self):
        from factormodeling_tpu_torch.serve import batched

        self.calls, self._mod = [], batched
        self._real = batched.run_simulation

        def counted(signal, settings):
            self.calls.append(tuple(signal.shape[:-2]))
            return self._real(signal, settings)

        batched.run_simulation = counted
        return self

    def __exit__(self, *exc):
        self._mod.run_simulation = self._real


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _tree_equal(fmt, a, b) -> bool:
    """Every leaf of two output trees equal to the bit (shapes and bytes of
    the host copies)."""
    from factormodeling_tpu_torch._device import host_array

    la = fmt.resil.checkpoint.tree_leaves(a)
    lb = fmt.resil.checkpoint.tree_leaves(b)
    return len(la) == len(lb) and all(
        host_array(x).shape == host_array(y).shape
        and host_array(x).tobytes() == host_array(y).tobytes()
        for x, y in zip(la, lb))


def _tree_parted(a, b, path: str = "") -> list:
    """The dotted names of the tensor leaves of two output trees that are
    not equal to the bit."""
    import torch

    if a is None or not isinstance(a, (tuple, list, torch.Tensor)):
        return []
    if isinstance(a, torch.Tensor):
        x, y = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        same = (x.shape == y.shape and x.dtype == y.dtype
                and x.tobytes() == y.tobytes())
        return [] if same else [path]
    names = getattr(a, "_fields", range(len(a)))
    return sum((_tree_parted(x, y, f"{path}.{k}" if path else str(k))
                for k, x, y in zip(names, a, b)), [])


def serve_path(torch, fmt, seed: int) -> dict:
    """Path 10a: ``TenantServer.serve`` of S_TENANTS equal-weight tenants
    at F=50, D=1332, N=1000 (one rung-64 dispatch, cold then warm), then
    S_PROBE of them (rung 8, 3 pad lanes): one K1 launch a dispatch;
    S_CHECKED lanes bitwise the single-tenant step on the card and held to
    the same configs served on the host CPU at path 5's icir_top gate;
    ``serving_stats()`` against the host's count of the calls; one cache
    entry a (bucket, rung). Returns the launches of the three dispatches
    and the configs."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.parallel import streaming

    arrays = make_inputs(F, D, N, seed)
    names = factor_names(F)
    configs = serving_configs(fmt, S_TENANTS)
    streaming.clear_streaming_cache()
    server = fmt.serve.TenantServer(names=names, **_panels(arrays),
                                    device="cuda")
    rk.launches = ak.launches = ak.lane_launches = 0
    k1, walls = [], []
    with _SimCount() as sims:
        for batch in (configs, configs, configs[:S_PROBE]):
            before = rk.launches
            res, secs = _timed(torch, lambda b=batch: server.serve(b))
            k1.append(rk.launches - before)
            walls.append(secs)
    launches = segment_counts(rk, ak)
    stats = server.serving_stats()
    cache = streaming.streaming_cache_stats()
    rung = min(r for r in server.pad_ladder if r >= S_TENANTS)
    log(f"path serve (10a): {S_TENANTS} equal tenants, F={F} D={D} N={N}: "
        f"rung-{rung} dispatch {walls[0]:.3f} s cold (the bucket's "
        f"step built), {walls[1]:.3f} s warm, {S_TENANTS / walls[1]:.2f} "
        f"configs/s; {S_PROBE} tenants (rung 8, 3 pad lanes) "
        f"{walls[2]:.3f} s; K1 launches a dispatch {k1}; simulations a "
        f"dispatch (their lanes) {sims.calls}; launches "
        f"{json.dumps(launches)}; serving_stats "
        f"{json.dumps({k: v for k, v in stats.items() if k != 'kernel_cache'})}"
        f"; kernel cache {json.dumps(cache)}")
    if k1 != [1, 1, 1] or launches["admm_segment"] or \
            launches["admm_segment_lanes"]:
        raise AssertionError(f"serve: K1 launches a dispatch {k1}, not one; "
                             f"launches {launches}")
    if sims.calls != [(S_TENANTS,), (S_TENANTS,), (S_PROBE,)]:
        raise AssertionError(f"serve: simulations {sims.calls}, not one a "
                             "dispatch on its real lanes")
    want = {"bucket_count": 1, "executables": 2, "dispatch_executions": 3,
            "logical_dispatches": 3, "configs_served": 2 * S_TENANTS + S_PROBE,
            "padded_lanes": 2 * (rung - S_TENANTS) + 8 - S_PROBE,
            "rejected_configs": 0}
    got = {k: stats[k] for k in want}
    if got != want or (cache["size"], cache["misses"], cache["hits"],
                       cache["evictions"]) != (2, 2, 1, 0):
        raise AssertionError(f"serve: serving_stats {got}, the host count "
                             f"{want}; cache {cache}")
    for r in res:
        summ = r.output.summary
        sel_sum = r.output.selection.sum(1)
        if not (all(bool(torch.isfinite(v)) for v in summ)
                and bool(((sel_sum - 1).abs() <= 1e-5)
                         .logical_or(sel_sum == 0).all())):
            raise AssertionError(f"serve: tenant {r.index}: non-finite "
                                 "summary or a selection row off 1 and 0")

    # the lanes against the single-tenant step on the card (outside the
    # counted run), then the same configs served on the host CPU
    step = fmt.serve.make_tenant_research_step(names=names,
                                               template=configs[0])
    card_panels = [torch.as_tensor(a, device="cuda") for a in arrays]
    parted = [_tree_parted(res[i].output, step(
        configs[i].normalized(F, server.n_groups, dtype=np.float32),
        *card_panels)) for i in range(S_CHECKED)]
    bitwise = [not p for p in parted]
    host = fmt.serve.TenantServer(names=names, **_panels(arrays),
                                  device="cpu")
    t0 = time.perf_counter()
    res_h = host.serve(configs[:S_CHECKED])
    secs_h = time.perf_counter() - t0
    log(f"path serve (10a): lanes 0-{S_CHECKED - 1} of the rung-8 dispatch "
        f"bitwise the single-tenant step on the card: {bitwise} (leaves "
        f"parted: {parted}); the same "
        f"{S_CHECKED} configs on the host CPU: {secs_h:.1f} s")
    if not all(bitwise):
        raise AssertionError("serve: a lane parts from the single-tenant "
                             "step")
    for i in range(S_CHECKED):
        out, out_h = res[i].output, res_h[i].output
        dw = (out.selection.cpu() - out_h.selection).abs().max(-1).values
        share = float((dw > P5_DW_TOL).double().mean())
        legs = leg_differences(torch, out, out_h)
        d_sharpe = abs(float(out.summary.sharpe) - float(out_h.summary.sharpe))
        log(f"path serve (10a) tenant {i} vs the CPU: selection max |dw| "
            f"{float(dw.max()):.3e}, share of dates > {P5_DW_TOL}: "
            f"{share:.4f} (limit {P5_DW_SHARE}); |d sharpe| {d_sharpe:.3e}; "
            f"legs {json.dumps(legs)} (tol {P5_SAME_LEGS_RET_TOL} on "
            "calm_max_d_return)")
        if not (share <= P5_DW_SHARE
                and legs["calm_max_d_return"] <= P5_SAME_LEGS_RET_TOL
                and (legs["flips"] or d_sharpe <= P5_SAME_LEGS_SHARPE_TOL)):
            raise AssertionError(f"serve: tenant {i} differs between the "
                                 "card and the CPU")
    # path 11d: serve(lineage=True) on the rung-8 bucket: the lanes bitwise
    # the unhooked dispatch's, one edge a lane, no referential finding
    from factormodeling_tpu_torch.obs.lineage import (LineageLedger,
                                                      ledger_errors)

    ledger = LineageLedger()
    # the panels' fingerprint (every panel to the host and sha256) is taken
    # once a server: timed apart from the dispatch's own books
    _, secs_fp = _timed(torch, server.panels_fingerprint)
    res_l, secs_l = _timed(torch, lambda: server.serve(configs[:S_PROBE],
                                                       lineage=ledger))
    same = [_tree_equal(fmt, a.output, b.output) for a, b in zip(res_l, res)]
    kinds = [e["edge_kind"] for e in ledger.edges]
    errors = ledger_errors(ledger.rows("serve/sync"))
    log(f"path 11d serve(lineage=True), {S_PROBE} tenants (rung 8): "
        f"{secs_l:.3f} s ({walls[2]:.3f} s without), after the panels' "
        f"fingerprint, once a server, {secs_fp:.3f} s; lanes bitwise the "
        f"unhooked dispatch's: {same}; edges "
        f"{json.dumps({k: kinds.count(k) for k in sorted(set(kinds))})}; "
        f"findings {errors}")
    if not (all(same) and kinds.count("dispatch") == S_PROBE and not errors):
        raise AssertionError("11d: serve(lineage=True) parts from serve() "
                             "or its ledger has findings")
    return dict(launches=launches, configs=configs, arrays=arrays)


def turnover_serve_path(torch, fmt, seed: int, clean, clean_secs: float):
    """Path 10b: an mvo_turnover bucket of 3 tenants (turnover_configs) on
    the first P10B_DATES dates of path 1's inputs, default ladder (rung 8,
    5 pad lanes, not computed): K1 once, one simulation of the 3 lanes,
    K2 one lane launch of the 3 tenants a segment a date; the invariants
    of every tenant; tenant 0 held to path 9a's clean step on those dates
    (causal; selection bitwise but for the cut run's last row, which the
    processed range zeroes; weights at DW_TOL/DW_SHARE), tenants 1 and 2
    to their own single-tenant steps on the first P10B_HELD traded dates;
    the bucket's wall against 9a's clean step. Returns the launches and
    the configs."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    d = P10B_DATES
    arrays = tuple(a[:, :d] if a.ndim == 3 else a[:d]
                   for a in make_inputs(F, D, N, seed))
    configs = turnover_configs(fmt)
    server = fmt.serve.TenantServer(names=factor_names(F),
                                    **_panels(arrays), device="cuda")
    rk.launches = ak.launches = ak.lane_launches = 0
    with _SimCount() as sims:
        res, secs = _timed(torch, lambda: server.serve(configs))
    launches = segment_counts(rk, ak)
    segs = segment_launches(fmt, PATHS["turnover"], d=1)[0]
    # one day loop for the bucket: a lane launch of its 3 tenants a segment
    # a date
    want = {"rank_ic_postsort": 1, "admm_segment": 0,
            "admm_segment_lanes": d * segs}
    stats = server.serving_stats()
    log(f"path serve_turnover (10b): {len(configs)} mvo_turnover tenants, "
        f"F={F} D={d} N={N}, rung 8 ({stats['padded_lanes']} pad "
        f"lanes): {secs:.3f} s wall = {secs / clean_secs:.3f}x one "
        f"tenant's step (path 9a's clean step, {clean_secs:.3f} s for "
        f"{R_DATES} dates, in this call); simulations (their lanes) "
        f"{sims.calls}; launches {json.dumps(launches)} (schedule "
        f"{json.dumps(want)})")
    if launches != want or stats["padded_lanes"] != 5 \
            or sims.calls != [(len(configs),)]:
        raise AssertionError(f"serve_turnover: launches {launches}, the "
                             f"schedule implies {want}; simulations "
                             f"{sims.calls}")
    for i, (c, r) in enumerate(zip(configs, res)):
        out = r.output
        check_invariants(torch, f"serve_turnover[{i}]", out,
                         max_weight=float(c.max_weight))
        if int(out.sim.diagnostics.qp_solves) != d or not all(
                bool(torch.isfinite(v)) for v in out.summary):
            raise AssertionError(f"serve_turnover: tenant {i}: QP solves "
                                 "or summary off")
    out = res[0].output
    sel_equal = bool(torch.equal(out.selection[:d - 1],
                                 clean.selection[:d - 1]))
    dw = (out.sim.weights.nan_to_num()
          - clean.sim.weights[:d].nan_to_num()).abs().max(-1).values
    share = float((dw > DW_TOL).double().mean())
    w_bitwise = _bytes_equal(out.sim.weights, clean.sim.weights[:d])
    tenant = configs[0].normalized(F, server.n_groups, dtype=np.float32)
    log(f"path serve_turnover (10b) tenant 0 vs path 9a's clean step: "
        f"selection bitwise {sel_equal}; weights bitwise {w_bitwise}, max "
        f"|dw| {float(dw.max()):.3e}, share of days > {DW_TOL}: {share:.4f} "
        f"(limit {DW_SHARE}), days bitwise "
        f"{int((dw == 0).sum())} of {d}; the server's knobs are the "
        f"panels' float32 (max_weight {float(tenant.max_weight)!r}, "
        f"turnover_penalty {float(tenant.turnover_penalty)!r}), the step's "
        f"Python floats")
    if not (sel_equal and share <= DW_SHARE):
        raise AssertionError("serve_turnover: tenant 0 parts from path 9a's "
                             "clean step")
    # tenants 1 and 2 against their own single-tenant steps on the first
    # P10B_HELD traded dates (the causal cut: the window's dates, the held
    # ones and the cut run's last, which its processed range zeroes)
    cut_d = WINDOW + P10B_HELD + 1
    cut = [torch.as_tensor(a[:, :cut_d] if a.ndim == 3 else a[:cut_d],
                           device="cuda") for a in arrays]
    step = fmt.serve.make_tenant_research_step(names=factor_names(F),
                                               template=configs[0])
    for i in (1, 2):
        one = step(configs[i].normalized(F, server.n_groups,
                                         dtype=np.float32), *cut)
        held = cut_d - 1
        dw_i = (res[i].output.sim.weights[:held].nan_to_num()
                - one.sim.weights[:held].nan_to_num()).abs().max(-1).values
        share_i = float((dw_i > DW_TOL).double().mean())
        sel_i = bool(torch.equal(res[i].output.selection[:held],
                                 one.selection[:held]))
        log(f"path serve_turnover (10b) tenant {i} vs its single-tenant "
            f"step on the first {held} dates ({P10B_HELD} traded): "
            f"selection bitwise {sel_i}; weights max |dw| "
            f"{float(dw_i.max()):.3e}, share of days > {DW_TOL}: "
            f"{share_i:.4f} (limit {DW_SHARE}), days bitwise "
            f"{int((dw_i == 0).sum())} of {held}")
        if not (sel_i and share_i <= DW_SHARE):
            raise AssertionError(f"serve_turnover: tenant {i} parts from "
                                 "its single-tenant step")
    return launches, configs


# 10e: 10b's three tenants in turnover_mode="parallel" on the first
# P10E_DATES of path 1's dates
P10E_DATES = 166


def parallel_configs(fmt):
    """Path 10e's bucket: 10b's three tenants in the fixed-point scheme."""
    import dataclasses

    return [dataclasses.replace(c, sim_static=dict(
        c.sim_static, turnover_mode="parallel"))
        for c in turnover_configs(fmt)]


def lane_schedule(fmt, sim: dict, lanes: list, d: int) -> tuple:
    """K2's ``(single-lane, lane-batch)`` launches of a parallel bucket
    from its lanes' own ``sweep_stats``: the seed's chunks of every lane,
    each sweep's chunks of the lanes still sweeping, then a solve a date of
    the lanes at or past their own start; one launch a segment of a solve,
    a solve of one lane a single-lane launch."""
    from factormodeling_tpu_torch.solvers.admm_qp import _ADAPT_EVERY

    s = fmt.SimulationSettings(returns=None, cap_flag=None,
                               investability_flag=None, **sim)
    batch = min(s.mvo_batch, d)
    counts = [min(batch, d - first) for first in range(0, d, batch)]
    out = [0, 0]

    def solve(width: int, iters: int):
        if width:
            out[width > 1] += -(-iters // _ADAPT_EVERY)

    for count in counts:
        solve(len(lanes) * count, s.resolved_seed_iters())
    for k in range(1, max(st["sweeps"] for st in lanes) + 1):
        running = sum(st["sweeps"] >= k for st in lanes)
        for count in counts:
            solve(running * count, s.resolved_sweep_iters())
    for t in range(d):
        solve(sum(st["converged_days"] <= t for st in lanes),
              s.resolved_qp_iters(True))
    return tuple(out)


def parallel_serve_path(torch, fmt, seed: int) -> dict:
    """Path 10e: 10b's three tenants with ``turnover_mode="parallel"``
    (one bucket) on the first P10E_DATES dates of path 1's inputs: one
    simulation of the 3 lanes; K1 once; K2's single-lane and lane-batch
    launches those the lanes' own sweep counts and starts imply
    (``lane_schedule``); each lane's ``sweep_stats`` its own single-tenant
    parallel run's, its selection bitwise and its weights within
    ``DW_TOL``/``DW_SHARE`` of that run's; the bucket's wall against the
    three single runs'."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    d = P10E_DATES
    arrays = tuple(a[:, :d] if a.ndim == 3 else a[:d]
                   for a in make_inputs(F, D, N, seed))
    configs = parallel_configs(fmt)
    server = fmt.serve.TenantServer(names=factor_names(F),
                                    **_panels(arrays), device="cuda")
    rk.launches = ak.launches = ak.lane_launches = 0
    with _SimCount() as sims:
        res, secs = _timed(torch, lambda: server.serve(configs))
    launches = segment_counts(rk, ak)
    stats = [fmt.backtest.sweep_stats(r.output.sim.diagnostics) for r in res]
    single, multi = lane_schedule(fmt, PARALLEL_PATHS["turnover_parallel"],
                                  stats, d)
    want = {"rank_ic_postsort": 1, "admm_segment": single,
            "admm_segment_lanes": multi}
    log(f"path serve_parallel (10e): {len(configs)} mvo_turnover tenants in "
        f"the parallel scheme, F={F} D={d} N={N}: {secs:.3f} s wall; "
        f"simulations (their lanes) {sims.calls}; sweep_stats by lane "
        f"{json.dumps(stats)}; launches {json.dumps(launches)} (schedule "
        f"{json.dumps(want)})")
    if launches != want or sims.calls != [(len(configs),)]:
        raise AssertionError(f"serve_parallel: launches {launches}, the "
                             f"lanes' schedule implies {want}; simulations "
                             f"{sims.calls}")
    cut = [torch.as_tensor(a, device="cuda") for a in arrays]
    step = fmt.serve.make_tenant_research_step(names=factor_names(F),
                                               template=configs[0])
    walls = []
    for i, (c, r) in enumerate(zip(configs, res)):
        one, t = _timed(torch, lambda c=c: step(
            c.normalized(F, server.n_groups, dtype=np.float32), *cut))
        walls.append(t)
        check_invariants(torch, f"serve_parallel[{i}]", r.output,
                         max_weight=float(c.max_weight))
        own = fmt.backtest.sweep_stats(one.sim.diagnostics)
        dw = (r.output.sim.weights.nan_to_num()
              - one.sim.weights.nan_to_num()).abs().max(-1).values
        share = float((dw > DW_TOL).double().mean())
        sel = bool(torch.equal(r.output.selection, one.selection))
        log(f"path serve_parallel (10e) tenant {i} vs its single-tenant "
            f"parallel run ({t:.3f} s): sweep_stats {json.dumps(own)}; "
            f"selection bitwise {sel}; weights max |dw| "
            f"{float(dw.max()):.3e}, share of days > {DW_TOL}: {share:.4f} "
            f"(limit {DW_SHARE}), days bitwise {int((dw == 0).sum())} of "
            f"{d}")
        if own != stats[i] or not sel or not share <= DW_SHARE:
            raise AssertionError(f"serve_parallel: tenant {i} parts from "
                                 f"its single-tenant run")
    log(f"path serve_parallel (10e): the bucket {secs:.3f} s against the "
        f"three single runs' {sum(walls):.3f} s "
        f"({secs / sum(walls):.3f}x)")
    return launches


def queue_path(torch, fmt, served) -> None:
    """Path 10c: ``serve_queued`` on 10a's bucket (bench.py::
    bench_serving_under_load's recipe): S_REQUESTS requests on the ladder
    S_LADDER, the service time of one warm rung-8 dispatch, a Poisson
    trace at S_LOAD x its capacity (seed 31), deadlines S_DEADLINE_X x the
    service time, AdmissionPolicy(max_depth=S_DEPTH) on a VirtualClock,
    the fault plan S_FAULTS. Every request one verdict, the served outputs
    bitwise serve()'s, shed verdicts with their reason, and the step's
    executions equal to the delivered dispatches plus the poisoned
    attempts."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.serve import queue as q

    configs = served["configs"][:S_REQUESTS]
    server = fmt.serve.TenantServer(names=factor_names(F),
                                    **_panels(served["arrays"]),
                                    pad_ladder=S_LADDER, device="cuda")
    warm = configs[:S_LADDER[-1]]
    server.serve(warm)
    _, service_s = _timed(torch, lambda: server.serve(warm))
    rate = S_LOAD * S_LADDER[-1] / service_s
    reqs = q.make_requests(configs, q.poisson_arrivals(S_REQUESTS,
                                                       rate_hz=rate, seed=31),
                           deadline_s=S_DEADLINE_X * service_s)
    plan = fmt.resil.DispatchFaultPlan(**S_FAULTS)
    stats0 = server.serving_stats()
    before = rk.launches
    res, secs = _timed(torch, lambda: server.serve_queued(
        reqs, admission=fmt.serve.AdmissionPolicy(max_depth=S_DEPTH),
        service_model=lambda _t, _r: service_s, clock=q.VirtualClock(),
        fault_plan=plan))
    k1 = rk.launches - before
    stats = server.serving_stats()
    c = res.counters
    executions = (stats["dispatch_executions"]
                  - stats0["dispatch_executions"])
    logical = stats["logical_dispatches"] - stats0["logical_dispatches"]
    poisoned = sum(plan.roll(k) == "dispatch_poison"
                   for k in range(c["dispatches"] + c["retry_count"]))
    failed = {v["dispatch"] for v in res.verdicts
              if v["verdict"] == q.FAILED and v["dispatch"] is not None}
    by_rid = res.by_rid()
    delivered = sorted(res.outputs)
    ref = server.serve([configs[rid] for rid in delivered])
    bitwise = [_tree_equal(fmt, res.outputs[rid], r.output)
               for rid, r in zip(delivered, ref)]
    shed = [v for v in res.verdicts if v["verdict"] == q.SHED]
    log(f"path serve_queued (10c): {S_REQUESTS} requests, ladder {S_LADDER}, "
        f"service {service_s:.4f} s (one warm rung-8 dispatch), Poisson at "
        f"{rate:.2f} Hz ({S_LOAD}x capacity), deadline "
        f"{S_DEADLINE_X * service_s:.3f} s, max_depth {S_DEPTH}, faults "
        f"{json.dumps(S_FAULTS)}: {secs:.3f} s wall; counters "
        f"{json.dumps(c)}; step executions {executions}, logical dispatches "
        f"{logical}, poisoned attempts {poisoned}, failed dispatches "
        f"{len(failed)}; K1 launches {k1}; shed reasons "
        f"{sorted({v['detail'] for v in shed})}; {sum(bitwise)} of "
        f"{len(bitwise)} delivered outputs bitwise serve()'s")
    if sorted(by_rid) != list(range(S_REQUESTS)) or (
            c["served"] + c["shed_count"] + c["deadline_miss_count"]
            + c["failed_count"]) != S_REQUESTS:
        raise AssertionError("serve_queued: a request without exactly one "
                             "verdict")
    if not (all(bitwise) and bitwise and all(v["detail"] for v in shed)):
        raise AssertionError("serve_queued: a delivered output parts from "
                             "serve(), or a shed verdict has no reason")
    if not (logical == c["dispatches"]
            and executions == c["dispatches"] - len(failed) + poisoned
            and k1 == executions):
        raise AssertionError("serve_queued: executions, logical dispatches "
                             "and poisoned attempts do not add up")

    # path 11d: the same drain with every queue hook on and an on_alert
    # collector: the verdict log line for line 10c's, the checkers clean
    from factormodeling_tpu_torch.obs.lineage import (ledger_errors,
                                                      traffic_errors)
    from factormodeling_tpu_torch.obs.metering import conservation_errors
    from factormodeling_tpu_torch.obs.reqtrace import row_errors
    from factormodeling_tpu_torch.obs.sentry import sentry_errors

    seen = []
    _, secs_fp = _timed(torch, server.panels_fingerprint)
    rep = fmt.obs.RunReport("path 11d")
    with rep.activate():
        hooked, secs_h = _timed(torch, lambda: server.serve_queued(
            reqs, admission=fmt.serve.AdmissionPolicy(max_depth=S_DEPTH,
                                                      on_alert=seen.append),
            service_model=lambda _t, _r: service_s, clock=q.VirtualClock(),
            fault_plan=plan, flight=True, lineage=True, sentry=True))
    rows = rep.all_rows()
    metering = [r for r in rows if r["kind"] == "metering"]
    errors = (sum((conservation_errors(r) for r in metering), [])
              + row_errors(rows) + traffic_errors(rows) + ledger_errors(rows)
              + sentry_errors(rows))
    same_log = hooked.log_lines() == res.log_lines()
    alerts = [(a["detector"], a["signal"]) for a in hooked.sentry.alerts]
    kinds = sorted({r["kind"] for r in rows})
    log(f"path 11d serve_queued with flight, lineage, sentry and an "
        f"on_alert collector: {secs_h:.3f} s wall ({secs:.3f} s without); "
        f"verdict log line for line 10c's: {same_log} "
        f"({len(hooked.verdicts)} lines); report kinds {kinds}; traces "
        f"{len(hooked.flight.recorder.traces)}, dispatch edges "
        f"{sum(e['edge_kind'] == 'dispatch' for e in hooked.lineage.edges)}, "
        f"alerts {alerts} (on_alert saw {len(seen)}), incidents "
        f"{len(hooked.sentry.incidents)}; metering accounts "
        f"{len(hooked.flight.meter.accounts)}; findings {errors}; the "
        f"panels' fingerprint, taken before the drain, {secs_fp:.3f} s")
    if not (same_log and not errors and len(seen) == len(hooked.sentry.alerts)
            and len(hooked.flight.recorder.traces) == S_REQUESTS):
        raise AssertionError("11d: the hooked drain parts from 10c's, or a "
                             "checker has findings")


def advance_all_path(torch, fmt, seed: int, configs, rows9b) -> dict:
    """Path 10d: ``online_begin`` for 10b's tenants 0 and 2 (one session,
    rung 8) and ``advance_all`` over the first S_ONLINE_DATES dates of path
    9b's inputs, one at a time: K1 once a date, K2 one lane launch of
    the two tenants a segment a date;
    tenant 0's rows held to 9b's engine rows at 9b's gates (the server
    normalizes the knobs to the panels' float32, the engine to float64).
    Prints the wall a date (each date fenced) and the synchronizing reads
    of the last date by calling line. Returns the launches."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.online import DateSlice
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    arrays = tuple(a[:, :R_DATES] if a.ndim == 3 else a[:R_DATES]
                   for a in make_inputs(F, D, N, seed))
    factors, returns, factor_ret, cap, invest, universe = arrays
    server = fmt.serve.TenantServer(names=factor_names(F),
                                    **_panels(arrays), device="cuda")
    server.online_begin([configs[0], configs[2]])

    def date_slice(t):
        return DateSlice(factors=factors[:, t], returns=returns[t],
                         factor_ret=factor_ret[t], cap_flag=cap[t],
                         investability=invest[t], universe=universe[t])

    rk.launches = ak.launches = ak.lane_launches = 0
    rows, walls = [], []
    for t in range(S_ONLINE_DATES):
        if t == S_ONLINE_DATES - 1:
            adv, syncs = _sync_reads(torch, lambda: server.advance_all(
                date_slice(t)))
        else:
            adv, secs = _timed(torch, lambda: server.advance_all(
                date_slice(t)))
            walls.append(secs)
        rows.append(adv)
    launches = segment_counts(rk, ak)
    segs = segment_launches(fmt, PATHS["turnover"], d=1)[0]
    # the session's two tenants in one lane launch a segment a date
    want = {"rank_ic_postsort": S_ONLINE_DATES, "admm_segment": 0,
            "admm_segment_lanes": (S_ONLINE_DATES - 1) * segs}
    ms = np.asarray(walls[1:]) * 1e3
    stats = server.serving_stats()
    log(f"path advance_all (10d): tenants 0 and 2 of 10b, one session "
        f"(rung 8, {stats['padded_lanes'] // S_ONLINE_DATES} pad lanes), "
        f"{S_ONLINE_DATES} dates one at a time, F={F} N={N}, float32 "
        f"panels: wall per date (fenced) p50 {np.percentile(ms, 50):.3f} "
        f"ms, p99 {np.percentile(ms, 99):.3f} ms, max {ms.max():.3f} ms, "
        f"total {sum(walls):.3f} s; launches {json.dumps(launches)} "
        f"(schedule {json.dumps(want)}); synchronizing reads in the last "
        f"date's advance: {sum(syncs.values())}, by calling line "
        f"{json.dumps(syncs)}")
    if launches != want:
        raise AssertionError(f"advance_all: launches {launches}, the "
                             f"schedule implies {want}")

    days = list(range(S_ONLINE_DATES - 1))
    mine = [rows[t + 1][0].output for t in days]
    if [int(o.day) for o in mine] != days or not all(o.ready for o in mine):
        raise AssertionError("advance_all: finalized days out of order")

    def stack(key):
        return torch.stack([getattr(o, key) for o in mine]).cpu()

    def engine(key):
        return torch.from_numpy(np.stack([rows9b[d][key] for d in days]))

    d_sel = (stack("selection") - engine("selection")).abs().max(-1).values
    d_sig = (stack("signal").nan_to_num()
             - engine("signal").nan_to_num()).abs().max(-1).values
    w_on, w_eng = stack("weights").nan_to_num(), engine("weights").nan_to_num()
    dw = (w_on - w_eng).abs().max(-1).values
    share = float((dw > DW_TOL).double().mean())
    agree = dw <= DW_TOL
    lc_bad = int(((stack("long_count") != engine("long_count")) & agree)
                 .sum())
    ok_bad = int(((stack("solver_ok") != engine("solver_ok")) & agree).sum())
    same = (w_on == w_eng).all(-1)
    books = same & torch.cat([same.new_ones(1), same[:-1]])
    d_pnl = (stack("log_return") - engine("log_return")).abs()
    pnl_agree = float(d_pnl[books].max()) if bool(books.any()) else 0.0
    other = [rows[t + 1][1].output for t in days]
    finite = all(bool(torch.isfinite(o.log_return)) for o in other)
    cut = len(days)
    log(f"path advance_all (10d) tenant 0 vs path 9b's engine rows (days "
        f"0-{cut - 1}): selection rows differing {int((d_sel > 0).sum())} "
        f"(max |d| {float(d_sel.max()):.3e}); signal rows differing "
        f"{int((d_sig > 0).sum())}, beyond {P9_SIG_TOL}: "
        f"{int((d_sig > P9_SIG_TOL).sum())}; weights max |dw| "
        f"{float(dw.max()):.3e}, share of days > {DW_TOL}: {share:.4f} "
        f"(limit {DW_SHARE}), days bitwise {int(same.sum())}; leg counts and "
        f"solver_ok where the weights agree: {lc_bad} and {ok_bad} differ; "
        f"daily P&L on the {int(books.sum())} days whose books (and the day "
        f"before's) are equal: max |d| {pnl_agree:.3e} (tol {P8_RET_TOL}), "
        f"on all days {float(d_pnl.max()):.3e}; tenant 2's P&L finite "
        f"{finite}")
    if not (share <= DW_SHARE and int((d_sel > 0).sum()) == 0
            and int((d_sig > P9_SIG_TOL).sum()) <= DW_SHARE * cut):
        raise AssertionError("advance_all: tenant 0's selection, signal or "
                             "weights part from path 9b's rows")
    if lc_bad or ok_bad or not pnl_agree <= P8_RET_TOL or not finite:
        raise AssertionError("advance_all: leg counts, solver acceptance or "
                             "P&L differ where the books agree")

    # path 11d: advance_all(meter=, series=) over the first P11D_DATES
    # dates in a fresh session: the rows bitwise the unmetered run's, the
    # meter's accounts conserved, one health sample a date
    from factormodeling_tpu_torch.obs.metering import (CostMeter,
                                                       conservation_errors)
    from factormodeling_tpu_torch.obs.reqtrace import HealthSeries

    metered = fmt.serve.TenantServer(names=factor_names(F),
                                     **_panels(arrays), device="cuda")
    metered.online_begin([configs[0], configs[2]])
    meter, series = CostMeter(), HealthSeries()
    same = True
    for t in range(P11D_DATES):
        adv = metered.advance_all(date_slice(t), date=t, meter=meter,
                                  series=series)
        same = same and all(_tree_equal(fmt, a.output, b.output)
                            for a, b in zip(adv, rows[t]))
    row = meter.row("online/advance_all/metering")
    errors = conservation_errors(row)
    log(f"path 11d advance_all(meter=, series=) over {P11D_DATES} dates: "
        f"rows bitwise the unmetered run's: {same}; {len(meter.accounts)} "
        f"accounts, conservation findings {errors}; fenced wall a date, "
        f"mean {meter.totals.get('wall_s', 0.0) / P11D_DATES * 1e3:.3f} "
        f"ms; health samples {series.count}")
    if not (same and not errors and series.count == P11D_DATES):
        raise AssertionError("11d: the metered advance parts from the "
                             "unmetered one or its meter is not conserved")
    return launches


#: path 11d: advance_all with the meter and the health series
P11D_DATES = 16

# path 12a: the scenario engine at path 1's width (10a's market and its
# equal tenant knobs), SC_PATHS paths a family in chunks of SC_CHUNK; the
# regime knobs are bench.py's (:2540-2542), the bootstrap's blocks D // 12
SC_PATHS, SC_CHUNK = 32, 16
SC_REGIME = dict(seed=7, vol_scale=2.0, mean_shift=-0.005, corr_tighten=0.4)
SC_ADV = dict(seed=11, window_len=20, nan_rate=0.01, inf_rate=0.005,
              outlier_rate=0.005, stale_rate=0.2, drop_rate=0.1,
              collapse_rate=0.1, collapse_keep=50)
# 2 adversarial paths on the first SC_CPU_DATES dates, card against the
# host CPU from the same draws (the CPU's threefry bits are the card's), at
# path 5's gates
# (``_scenario_cpu_check``); 333 until the sharded online session joined
# 13d, then 166 to keep the script's time
SC_CPU_PATHS, SC_CPU_DATES = 2, 166
# 12b: the regime family, chunks of SC_KILL_CHUNK, killed after 2
SC_KILL_CHUNK, SC_KILL_AFTER = 8, 2
# 12c: path 9's turnover tenant under the regime family
SC_TURNOVER_PATHS, SC_TURNOVER_DATES = 2, 166
# 12d: bench.py's north star (:1296-1390) at full size, streamed from a
# device source; 12e: its host-resident form (:1408)
NS_F, NS_D, NS_N, NS_CHUNK, NS_WINDOW = 200, 5040, 5000, 10, 60
NS_HOST_F, NS_HOST_CHUNK = 16, 4
# the one-pass composite against the two-pass flow: float32 sums over 200
# factors of weights x z-scores (|z| <~ 5), normalized before (two-pass)
# or after (one-pass) the sum: ~200 float32 roundings of values <~ 5
NS_COMPOSITE_TOL = 1e-4


def _scenario_template(fmt):
    """10a's first tenant: equal weights, window 60, icir_top."""
    return serving_configs(fmt, 1)[0]


def _legs(w):
    """The long and short memberships of a book's weights."""
    w = w.nan_to_num()
    return w > 0, w < 0


def _adversarial_host_check(spec, d: int, n: int) -> None:
    """Every day and cell draw of every path lies inside the path's
    window."""
    from factormodeling_tpu_torch.scenarios import path_key

    for p in range(SC_PATHS):
        key = path_key(spec, p)
        in_win, stale, drop, collapse = spec.schedule(key, d)
        if (stale | drop | collapse)[~in_win].any():
            raise AssertionError(f"scenarios: path {p} day draws outside "
                                 "its window")
        for m in spec.cell_masks(key, (d, n), in_win, device="cuda"):
            if m is not None and bool(m.cpu().numpy()[~in_win].any()):
                raise AssertionError(f"scenarios: path {p} cell draws "
                                     "outside its window")


def scenario_path(torch, fmt, seed: int) -> dict:
    """Path 12a: ``run_scenarios`` of the regime, bootstrap and adversarial
    families at F=50, D=1332, N=1000 (float32, 10a's equal tenant),
    SC_PATHS paths each in chunks of SC_CHUNK (the adversarial family under
    the default ``DegradePolicy``): K1 once a dispatch (the hoist); the
    ``off()`` specs' paths bitwise the tenant's plain step; bootstrap day
    indices in range; adversarial draws inside their windows; finite
    metrics on every path; 2 adversarial paths held against the host CPU
    on the first SC_CPU_DATES dates. Prints paths/s a family and one path
    against one tenant step. Returns the K1 launches."""
    from factormodeling_tpu_torch import scenarios
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.serve.batched import (
        make_tenant_research_step)

    arrays = make_inputs(F, D, N, seed)
    names = factor_names(F)
    tpl = _scenario_template(fmt)
    panels = {k: torch.from_numpy(v).cuda()
              for k, v in _panels(arrays).items()}
    tenant = tpl.normalized(F, len(fmt.composite.prefix_group_ids(names)[1]),
                            dtype=np.float32)
    step = make_tenant_research_step(names=names, template=tpl)
    base, step_secs = _timed(torch, lambda: step(tenant, *panels.values()))
    base, step_secs = _timed(torch, lambda: step(tenant, *panels.values()))
    k1 = 0

    def run(spec, n_paths, chunk, **kw):
        nonlocal k1
        before = rk.launches
        res, secs = _timed(torch, lambda: scenarios.run_scenarios(
            names=names, template=tpl, spec=spec, n_paths=n_paths,
            chunk=chunk, device="cuda", **panels, **kw))
        got = rk.launches - before
        if got != -(-n_paths // chunk):
            raise AssertionError(f"scenarios: {got} K1 launches for "
                                 f"{-(-n_paths // chunk)} dispatches")
        k1 += got
        return res, secs

    # the identity specs: every path bitwise the plain step
    for spec in (scenarios.RegimeSpec.off(seed=3),
                 scenarios.AdversarialSpec.off(seed=4)):
        res, _ = run(spec, 2, 2, return_books=True)
        for p in range(2):
            book = res.book(p)
            if not all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                       for a, b in ((book.signal, base.signal),
                                    (book.sim.weights, base.sim.weights),
                                    (book.sim.result.log_return,
                                     base.sim.result.log_return))):
                raise AssertionError(f"scenarios: {type(spec).__name__}.off "
                                     f"path {p} is not the plain step")
    families = {
        "regime": (scenarios.RegimeSpec.make(**SC_REGIME), None),
        "bootstrap": (scenarios.BootstrapSpec.make(seed=5,
                                                   block_len=D // 12), None),
        "adversarial": (scenarios.AdversarialSpec.make(**SC_ADV),
                        fmt.resil.DegradePolicy.make()),
    }
    boot = families["bootstrap"][0]
    for p in range(SC_PATHS):
        idx = boot.day_index(scenarios.path_key(boot, p), D)
        if not ((idx >= 0) & (idx < D)).all():
            raise AssertionError(f"scenarios: bootstrap path {p} day index "
                                 "out of range")
    _adversarial_host_check(families["adversarial"][0], D, N)
    for family, (spec, policy) in families.items():
        runner = scenarios.make_scenario_runner(names=names, template=tpl,
                                                family=family)
        with _SimCount() as sims:
            res, secs = run(spec, SC_PATHS, SC_CHUNK, policy=policy,
                            runner=runner)
        if sims.calls != [(SC_CHUNK,)] * (SC_PATHS // SC_CHUNK):
            raise AssertionError(f"scenarios: {family} simulations "
                                 f"{sims.calls}, not one a chunk of paths")
        pnl = next(r for r in res.rows if r["metric"] == "pnl_total")
        log(f"path scenarios (12a) {family}: {SC_PATHS} paths in "
            f"{-(-SC_PATHS // SC_CHUNK)} dispatches, {secs:.3f} s, "
            f"{SC_PATHS / secs:.2f} paths/s (a simulation of {SC_CHUNK} path "
            f"lanes a chunk), one path {secs / SC_PATHS:.4f} s "
            f"= {secs / SC_PATHS / step_secs:.3f}x one tenant step "
            f"({step_secs:.4f} s); pnl VaR {pnl['var']} ES {pnl['es']} "
            f"p50 {pnl['p50']}; nonfinite paths {res.nonfinite_path_count}; "
            f"degrade {json.dumps(res.degrade)}")
        if res.nonfinite_path_count or not res.finite_ok:
            raise AssertionError(f"scenarios: {family} non-finite paths "
                                 f"{res.nonfinite}")
    _scenario_cpu_check(torch, fmt, arrays, names, tpl,
                        families["adversarial"])
    return {"rank_ic_postsort": k1}


def _scenario_cpu_check(torch, fmt, arrays, names, tpl, family) -> None:
    """12a's adversarial paths 0..SC_CPU_PATHS-1 on the first SC_CPU_DATES
    dates, card against host CPU, at path 5's gates: the selection rows at
    P5_DW_TOL on all but P5_DW_SHARE of the dates; the daily return on a
    calm day (no leg member flipped that day or the day before) within
    P5_SAME_LEGS_RET_TOL. Legs flip where rounding decides them
    (``leg_differences``: a selection weight of ~1e-9 against 0, a signal
    whose sign is rounding, and here the blasted rows of ~1e9 cells, whose
    z-scores are float32 rounding); the flips inside the corruption window
    (or the day after it) are counted apart."""
    from factormodeling_tpu_torch import scenarios

    spec, policy = family
    cut = tuple(a[:, :SC_CPU_DATES] if a.ndim == 3 else a[:SC_CPU_DATES]
                for a in arrays)
    books = {}
    for dev in ("cuda", "cpu"):
        books[dev] = scenarios.run_scenarios(
            names=names, template=tpl, spec=spec, policy=policy,
            n_paths=SC_CPU_PATHS, chunk=SC_CPU_PATHS, return_books=True,
            device=dev, **{k: torch.from_numpy(v).to(dev)
                           for k, v in _panels(cut).items()}).books
    for p in range(SC_CPU_PATHS):
        card = fmt.serve.batched.tree_lane(books["cuda"], p)
        host = fmt.serve.batched.tree_lane(books["cpu"], p)
        dsel = (card.selection.cpu() - host.selection).abs().max(-1).values
        share = float((dsel > P5_DW_TOL).double().mean())
        legs = leg_differences(torch, card, host)
        in_win = spec.schedule(scenarios.path_key(spec, p), SC_CPU_DATES)[0]
        window = torch.from_numpy(in_win | np.roll(in_win, 1))
        w_c = card.sim.weights.nan_to_num().cpu()
        w_h = host.sim.weights.nan_to_num()
        flip_day = (((w_c > 0) != (w_h > 0)) | ((w_c < 0) != (w_h < 0))
                    ).any(-1)
        log(f"path scenarios (12a) adversarial path {p}, {SC_CPU_DATES} "
            f"dates, card vs CPU: selection share beyond {P5_DW_TOL} "
            f"{share:.4f}; legs " + json.dumps(legs)
            + f"; flipped days inside the window or after it "
            f"{int((flip_day & window).sum())}; pnl "
            f"{float(card.summary.total_log_return):.6f} / "
            f"{float(host.summary.total_log_return):.6f} (tol "
            f"{P5_SAME_LEGS_RET_TOL} on calm_max_d_return)")
        if (share > P5_DW_SHARE
                or not legs["calm_max_d_return"] <= P5_SAME_LEGS_RET_TOL
                or not np.isfinite(float(card.summary.total_log_return))):
            raise AssertionError(f"scenarios: adversarial path {p} card vs "
                                 "CPU beyond path 5's gates")


def scenario_resume_path(torch, fmt, seed: int) -> dict:
    """Path 12b: the regime family, SC_PATHS paths in chunks of
    SC_KILL_CHUNK, stopped after SC_KILL_AFTER chunks through the
    ``_FMT_SCEN_STOP_AFTER_CHUNK`` seam and resumed from its checkpoint:
    rows and ``lineage=`` ledger byte-equal to a straight-through run."""
    from factormodeling_tpu_torch import scenarios
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.obs.lineage import LineageLedger
    from factormodeling_tpu_torch.scenarios import engine as sc_engine

    panels = {k: torch.from_numpy(v).cuda()
              for k, v in _panels(make_inputs(F, D, N, seed)).items()}
    kw = dict(names=factor_names(F), template=_scenario_template(fmt),
              spec=scenarios.RegimeSpec.make(**SC_REGIME), n_paths=SC_PATHS,
              chunk=SC_KILL_CHUNK, device="cuda", **panels)
    ck = os.path.join(ROOT, "build", "chip_smoke", "scenarios.ckpt")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    if os.path.exists(ck):
        os.unlink(ck)
    before = rk.launches
    straight_ledger = LineageLedger()
    straight, s_secs = _timed(torch, lambda: scenarios.run_scenarios(
        lineage=straight_ledger, **kw))
    os.environ[sc_engine._STOP_ENV] = str(SC_KILL_AFTER)
    try:
        part, p_secs = _timed(torch, lambda: scenarios.run_scenarios(
            checkpoint_path=ck, lineage=LineageLedger(), **kw))
    finally:
        del os.environ[sc_engine._STOP_ENV]
    ledger = LineageLedger()
    resumed, r_secs = _timed(torch, lambda: scenarios.run_scenarios(
        checkpoint_path=ck, lineage=ledger, **kw))
    n_chunks = -(-SC_PATHS // SC_KILL_CHUNK)
    k1 = rk.launches - before
    log(f"path scenarios (12b): regime, {SC_PATHS} paths in {n_chunks} "
        f"chunks: straight {s_secs:.3f} s, killed after {SC_KILL_AFTER} "
        f"chunks {p_secs:.3f} s, resumed {r_secs:.3f} s; rows equal "
        f"{resumed.rows == straight.rows}, ledgers byte-equal "
        f"{ledger.state() == straight_ledger.state()}; K1 {k1}")
    if part.completed or part.rows:
        raise AssertionError("scenarios: the stop seam did not stop the run")
    if resumed.rows != straight.rows \
            or ledger.state() != straight_ledger.state():
        raise AssertionError("scenarios: the resumed run is not the "
                             "straight-through run")
    if k1 != 2 * n_chunks:
        raise AssertionError(f"scenarios (12b): {k1} K1 launches for "
                             f"{2 * n_chunks} dispatches")
    return {"rank_ic_postsort": k1}


def scenario_turnover_path(torch, fmt, seed: int) -> dict:
    """Path 12c: 10b's first tenant (``mvo_turnover``, path 1's knobs) under
    the regime family, SC_TURNOVER_PATHS paths over the first
    SC_TURNOVER_DATES dates as lanes: K1 once, K2 one lane launch of the
    paths a segment a date (two a date), finite metrics."""
    from factormodeling_tpu_torch import scenarios
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    cut = tuple(a[:, :SC_TURNOVER_DATES] if a.ndim == 3
                else a[:SC_TURNOVER_DATES] for a in make_inputs(F, D, N, seed))
    rk.launches = ak.launches = ak.lane_launches = 0
    res, secs = _timed(torch, lambda: scenarios.run_scenarios(
        names=factor_names(F), template=turnover_configs(fmt)[0],
        spec=scenarios.RegimeSpec.make(**SC_REGIME),
        n_paths=SC_TURNOVER_PATHS, chunk=SC_TURNOVER_PATHS, device="cuda",
        **{k: torch.from_numpy(v).cuda() for k, v in _panels(cut).items()}))
    launches = segment_counts(rk, ak)
    segs = segment_launches(fmt, PATHS["turnover"], d=1)[0]
    # the paths as lanes: one lane launch a segment a date
    want = {"rank_ic_postsort": 1, "admm_segment": 0,
            "admm_segment_lanes": SC_TURNOVER_DATES * segs}
    log(f"path scenarios (12c): mvo_turnover under the regime family, "
        f"{SC_TURNOVER_PATHS} paths x {SC_TURNOVER_DATES} dates, {secs:.3f} "
        f"s ({secs / SC_TURNOVER_PATHS:.3f} s a path); launches "
        f"{json.dumps(launches)}; nonfinite paths {res.nonfinite_path_count}")
    if launches != want:
        raise AssertionError(f"scenarios (12c): launches {launches}, the "
                             f"schedule implies {want}")
    if not res.finite_ok:
        raise AssertionError("scenarios (12c): non-finite path metrics")
    return launches


def _north_star_market(torch, seed: int):
    """bench.py's north-star panels on the card: returns, cap flags, all
    investable (from ``seed``)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rets = 0.02 * torch.randn((NS_D, NS_N), generator=g, device="cuda")
    cap = torch.randint(1, 4, (NS_D, NS_N), generator=g,
                        device="cuda").float()
    return rets, cap


def _north_star_source(torch, rets, seed: int):
    """The device source: chunk ``i`` regenerated on the card from a seeded
    generator, ``0.02 * returns + N(0, 1)`` (bench.py's)."""
    g = torch.Generator(device="cuda")

    def source(i):
        g.manual_seed(seed * 100_003 + i)
        return 0.02 * rets[None] + torch.randn((NS_CHUNK, NS_D, NS_N),
                                               generator=g, device="cuda")

    return source


def _momentum_fn(torch):
    """bench.py's factorwise momentum weights of a chunk (a stable callable:
    the streaming LRU keys on it)."""
    from factormodeling_tpu_torch.ops._window import rolling_sum, shift

    i = torch.arange(NS_D, device="cuda")
    processed = ((i >= NS_WINDOW) & (i <= NS_D - 2))[None, :]

    def chunk_momentum(stats_d):
        fr = stats_d["factor_return"]                    # [C, D]
        sums = rolling_sum(torch.where(torch.isnan(fr), 0.0, fr), NS_WINDOW,
                           axis=1)
        mom = torch.clamp(shift(sums, 1, axis=1, fill_value=0.0), min=0.0)
        return torch.where(processed, mom, 0.0)

    return chunk_momentum


def north_star_path(torch, fmt, seed: int) -> tuple:
    """Path 12d: bench.py's north star at full size, 200 x 5040 x 5000
    float32 in chunks of 10 from a device source:
    ``streamed_linear_research`` (z-score, shift 2, rank-IC and factor
    returns, momentum weights), then the equal backtest at pct 0.1. Gates:
    the first 2 chunks' streamed stats bitwise the one-shot
    ``daily_factor_stats`` of the same 20 factors; the one-pass composite
    against the two-pass flow within NS_COMPOSITE_TOL; K1 20 times. Times
    K1 at the chunk's 50,400 rows of 5000 beside its plain version, its
    bound and ``torch.sort`` + gather + K1. Returns ``(launches, K1's
    north-star fields)``."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.metrics import daily_factor_stats
    from factormodeling_tpu_torch.parallel import streaming

    rets, cap = _north_star_market(torch, seed + 6)
    source = _north_star_source(torch, rets, seed + 6)
    momentum = _momentum_fn(torch)
    n_chunks = NS_F // NS_CHUNK
    stats = ("rank_ic", "factor_return")
    kw = dict(transform="zscore", shift_periods=2, stats=stats,
              fuse_source=True, device="cuda")
    settings = fmt.SimulationSettings(
        returns=rets, cap_flag=cap,
        investability_flag=torch.ones_like(rets), method="equal", pct=0.1)

    def one_pass(rets, cap, inv):
        res = streaming.streamed_linear_research(
            source, n_chunks, rets, chunk_weight_fn=momentum, **kw)
        return res, fmt.run_simulation(res["composite"], settings)

    # a warm-up over two chunks (allocator, the library handles)
    streaming.streamed_linear_research(source, 2, rets,
                                       chunk_weight_fn=momentum, **kw)
    rk.launches = 0
    (res, sim), secs = _timed(torch, lambda: one_pass(
        rets, cap, settings.investability_flag))
    k1 = rk.launches
    # the device-memory peak of one more pass, measured by obs.memory: the
    # panels it takes plus what it allocates at its high-water mark; the
    # allocator's high-water mark of that pass counts every live tensor
    # (the cuBLAS workspace too)
    peak = fmt.obs.memory.peak_bytes(one_pass, rets, cap,
                                     settings.investability_flag) / 2**30
    high = torch.cuda.max_memory_allocated() / 2**30
    # the two-pass flow: stats, per-date normalized weights, composite
    (two, comp2), secs2 = _timed(torch, lambda: _two_pass(
        torch, streaming, source, n_chunks, rets, momentum, stats))
    d_comp = float((res["composite"] - comp2).abs().max())
    # the first two chunks one-shot
    first = torch.cat([source(0), source(1)])
    one = daily_factor_stats(first, rets, shift_periods=2, stats=stats)
    bitwise = all(torch.equal(res[k][:2 * NS_CHUNK].nan_to_num(7.0),
                              one[k].nan_to_num(7.0)) for k in stats)
    total = float(sim.result.log_return.nansum())
    log(f"path north star (12d): {NS_F} x {NS_D} x {NS_N} float32 in "
        f"{n_chunks} chunks of {NS_CHUNK} from a device source, one pass "
        f"(stats, momentum, z-score blend) + equal backtest: {secs:.3f} s "
        f"wall, peak {peak:.2f} GiB (obs.memory; the allocator's "
        f"high-water mark {high:.2f} GiB); K1 {k1} launches; two-pass flow "
        f"{secs2:.3f} s; composite one-pass vs two-pass max |d| {d_comp:.3e} "
        f"(tol {NS_COMPOSITE_TOL}); first 2 chunks bitwise one-shot "
        f"{bitwise}; total log return {total:.6f}")
    del first, one
    if k1 != n_chunks:
        raise AssertionError(f"north star: {k1} K1 launches, {n_chunks} "
                             "chunks")
    if not bitwise:
        raise AssertionError("north star: streamed stats are not the "
                             "one-shot stats")
    if not d_comp <= NS_COMPOSITE_TOL or not np.isfinite(total) \
            or not bool(torch.isfinite(res["composite"]).all()):
        raise AssertionError("north star: composite or P&L off")
    return {"rank_ic_postsort": k1}, _north_star_k1(torch, rk, source, rets)


def _two_pass(torch, streaming, source, n_chunks, rets, momentum, stats):
    daily = streaming.streamed_factor_stats(source, n_chunks, rets,
                                            shift_periods=2, stats=stats,
                                            fuse_source=True, device="cuda")
    u = momentum(daily)
    norm = u.sum(0)
    w = torch.where(norm > 0, u / torch.where(norm > 0, norm, 1.0), 0.0)
    comp = streaming.streamed_weighted_composite(
        source, [w[s] for s in streaming.chunk_slices(NS_F, NS_CHUNK)],
        fuse_source=True, device="cuda")
    return daily, comp


def _north_star_k1(torch, rk, source, rets) -> dict:
    """K1 at a north-star chunk's 50,400 rows of 5000: per launch, its plain
    version, its bound (each input read once) and the post-sort route
    (``torch.sort`` + gather + K1) on the same keys."""
    fac = source(0)
    key = fac.reshape(-1, NS_N)                # the chunk's C * D rows
    payload = rets.expand(fac.shape).reshape(-1, NS_N)
    rows = key.shape[0]

    def route():
        s, idx = torch.sort(key, dim=-1)
        return rk.rank_ic_postsort(s, torch.gather(payload, -1, idx))

    s_key, idx = torch.sort(key, dim=-1)
    r_s = torch.gather(payload, -1, idx)
    got, _ = rk.rank_ic_postsort(s_key, r_s)
    want, _ = rk.rank_ic_postsort_plain(s_key, r_s)
    err = _held(torch, f"rank_ic_postsort R={rows} M={NS_N}", got, want,
                RANK_IC_TOL)
    ms = cuda_ms(torch, lambda: rk.rank_ic_postsort(s_key, r_s), 10)
    plain = cuda_ms(torch, lambda: rk.rank_ic_postsort_plain(s_key, r_s), 2)
    route_ms = cuda_ms(torch, route, 3)
    b_ms, b_by = bound(8.0 * rows * NS_N + 8.0 * rows, 12.0 * rows * NS_N)
    log(f"kernel rank_ic_postsort at the north-star chunk R={rows} "
        f"M={NS_N}: max_abs_err {err:.3e}, {ms:.4f} ms/launch, plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), torch.sort + "
        f"gather + K1 {route_ms:.4f} ms")
    return {"north_star_rows": rows, "north_star_ms": ms,
            "north_star_plain_ms": plain, "north_star_bound_ms": b_ms,
            "north_star_max_abs_err": err,
            "north_star_sort_gather_k1_ms": route_ms}


def north_star_host_path(torch, fmt, seed: int) -> dict:
    """Path 12e: bench.py's ``north_star_host`` shape, NS_HOST_F factors at
    5040 x 5000 float32 in host memory (1.6 GB), chunks of NS_HOST_CHUNK:
    ``streamed_factor_stats`` from the host stack serially, prefetched, and
    from chunk files (``io.save_factor_stack_chunks`` to a temporary
    directory, then ``io.disk_chunk_source``, a warm read), each through
    the pinned copy stream: bitwise equal. Prints each wall and the
    achieved host-to-device rate."""
    import tempfile

    from factormodeling_tpu_torch import io as fio
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.parallel import streaming

    rets, _ = _north_star_market(torch, seed + 6)
    source = _north_star_source(torch, rets, seed + 7)
    stack = torch.cat([source(i)[:NS_HOST_CHUNK]
                       for i in range(NS_HOST_F // NS_HOST_CHUNK)]).cpu()
    host = stack.numpy()
    nbytes = host.nbytes
    src, slices = streaming.host_array_source(host, NS_HOST_CHUNK)
    kw = dict(shift_periods=2, stats=("rank_ic", "factor_return"),
              device="cuda")
    runs, walls = {}, {}
    before = rk.launches
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        runs["warm"], _ = _timed(torch, lambda: streaming.streamed_factor_stats(
            src, 1, rets, **kw))
        for name, s, pre in (("serial", src, 0), ("prefetched", src, 1)):
            runs[name], walls[name] = _timed(
                torch, lambda s=s, pre=pre: streaming.streamed_factor_stats(
                    s, len(slices), rets, prefetch=pre, **kw))
        t0 = time.perf_counter()
        fio.save_factor_stack_chunks(tmp, (host[s] for s in slices),
                                     factor_names=[f"f{i}" for i in
                                                   range(NS_HOST_F)])
        write = time.perf_counter() - t0
        dsrc, dslices, _ = fio.disk_chunk_source(tmp)
        runs["disk"], walls["disk"] = _timed(
            torch, lambda: streaming.streamed_factor_stats(
                dsrc, len(dslices), rets, prefetch=1, **kw))
    k1 = rk.launches - before - 1
    same = all(torch.equal(runs["serial"][k].nan_to_num(7.0),
                           runs[o][k].nan_to_num(7.0))
               for o in ("prefetched", "disk") for k in runs["serial"])
    rates = {k: nbytes / v / 1e9 for k, v in walls.items()}
    log(f"path north star host (12e): {NS_HOST_F} x {NS_D} x {NS_N} float32 "
        f"({nbytes / 1e9:.2f} GB) in chunks of {NS_HOST_CHUNK}: walls "
        + ", ".join(f"{k} {walls[k]:.3f} s ({rates[k]:.2f} GB/s host to "
                    f"device)" for k in walls)
        + f"; chunk files written in {write:.3f} s (read warm); bitwise "
        f"equal {same}; K1 {k1}")
    if not same:
        raise AssertionError("north star host: serial, prefetched and disk "
                             "runs differ")
    if k1 != 3 * len(slices):
        raise AssertionError(f"north star host: {k1} K1 launches")
    return {"rank_ic_postsort": k1 + 1}, dict(host=host, rets=rets,
                                              serial=runs["serial"])


# path 13: the mesh layer as a world of one over NCCL. 13a runs path 1's
# first P13_DATES dates; every sharded run is held to its unsharded twin
# at P13_TOL (a world of one runs the same operations, so it is bitwise)
P13_DATES = 166
P13_TOL = 1e-10
P13_ONLINE_DATES = 16


def _max_diff(torch, a, b) -> float:
    """max |a - b| with NaN where both are NaN (a NaN against a number is
    inf)."""
    a, b = a.double(), b.double()
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, 0.0, (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() \
        else 0.0


def _tree_diff(torch, fmt, a, b) -> float:
    """The largest :func:`_max_diff` over two output trees' tensor
    leaves."""
    from factormodeling_tpu_torch.serve.batched import _tree_map

    diffs = []
    _tree_map(lambda x, y: diffs.append(
        _max_diff(torch, x, y) if isinstance(x, torch.Tensor)
        and x.is_floating_point() else
        (0.0 if not isinstance(x, torch.Tensor) or torch.equal(x, y)
         else float("inf"))), a, b)
    return max(diffs)


def _held13(what: str, err: float) -> None:
    if not err <= P13_TOL:
        raise AssertionError(f"path 13 {what}: {err} from the unsharded run "
                             f"(tol {P13_TOL})")


def mesh_step_path(torch, fmt, seed: int, refs: dict) -> dict:
    """13a: ``make_sharded_research_step`` on a (1, 1) ``("factor",
    "date")`` mesh at path 1's width on its first P13_DATES dates, held
    against the unsharded step: K1 once, K2 two segments a date; the
    walls and the ledger's collectives a stage."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.obs import comms
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.parallel import (make_mesh,
                                                   make_sharded_research_step)

    d = P13_DATES
    arrays = tuple(a[:, :d] if a.ndim == 3 else a[:d]
                   for a in make_inputs(F, D, N, seed))
    sim = dict(PATHS["turnover"], max_weight=MAX_WEIGHT,
               solver_kernel="fused")
    inputs, cfg = fmt.convert(*arrays, names=factor_names(F), window=WINDOW,
                              select_method="icir_top", blend_method="zscore",
                              sim_kwargs=sim, device="cuda")
    kw = cfg.as_kwargs()
    kw.pop("device")
    ref, ref_secs = _timed(torch, lambda: fmt.build_research_step(
        **kw, device="cuda")(*inputs))
    refs["turnover"] = (ref, ref_secs)     # 13c's scan holds to it too
    mesh = make_mesh(("factor", "date"), device="cuda")
    step, shard = make_sharded_research_step(mesh, **kw)
    blocks = shard(*inputs)
    rk.launches = ak.launches = ak.lane_launches = 0
    # 14a: the step's first call "compiles" (obs.compile_log), so under a
    # RunReport(comms=True) this same run lands its placement rows
    rep = fmt.obs.RunReport("path 14a", comms=True)
    with rep.activate(), comms.recording(mesh) as ledger:
        out, secs = _timed(torch, lambda: step(*blocks))
    launches = segment_counts(rk, ak)
    placement_rows(rep, step.name, blocks, len(ledger.ops))
    want = segment_launches(fmt, PATHS["turnover"], d=d)
    fields = {"selection": (out.selection, ref.selection),
              "signal": (out.signal, ref.signal),
              "weights": (out.sim.weights, ref.sim.weights),
              "log_return": (out.sim.result.log_return,
                             ref.sim.result.log_return)}
    errs = {k: _max_diff(torch, a, b) for k, (a, b) in fields.items()}
    bitwise = all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                  for a, b in fields.values())
    by_stage = {s: {k: v["count"] for k, v in agg["collectives"].items()}
                for s, agg in ledger.by_stage().items()}
    log(f"path 13a sharded step: (1, 1) ('factor', 'date') mesh over "
        f"{torch.distributed.get_backend()}, F={F} D={d} N={N} "
        f"mvo_turnover fused: {secs:.3f} s wall, the unsharded step "
        f"{ref_secs:.3f} s ({secs / ref_secs:.3f}x); max |diff| "
        f"{json.dumps(errs)} (tol {P13_TOL}), bitwise {bitwise}; launches "
        f"{json.dumps(launches)} (schedule K1 1, K2 {want}); ledger "
        f"collectives a stage {json.dumps(by_stage)}, bytes moved "
        f"{ledger.totals()['bytes_moved']}")
    for k, e in errs.items():
        _held13(f"13a {k}", e)
    if (launches["rank_ic_postsort"] != 1
            or (launches["admm_segment"], launches["admm_segment_lanes"])
            != tuple(want)):
        raise AssertionError(f"path 13a: launches {launches}, schedule K1 1, "
                             f"K2 {want}")
    if any(s.startswith(("backtest/", "solver/")) for s in by_stage):
        raise AssertionError(f"path 13a: a collective in the backtest: "
                             f"{by_stage}")
    return launches


def mesh_sweep_path(torch, fmt) -> dict:
    """13b: ``make_sharded_manager_sweep`` on a ``("combo",)`` world of one
    at 8b's 1000 combos, held against 8b's ``manager_sweep``."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.parallel import (make_mesh,
                                                   make_sharded_manager_sweep)

    factors, cw, settings = sweep_inputs(torch, fmt, "cuda")
    want, want_secs = _timed(torch, lambda: fmt.parallel.manager_sweep(
        factors, cw, settings, combo_batch=SWEEP_BATCH, device="cuda"))
    sweep = make_sharded_manager_sweep(make_mesh(("combo",), device="cuda"),
                                       combo_batch=SWEEP_BATCH)
    rk.launches = ak.launches = ak.lane_launches = 0
    got, secs = _timed(torch, lambda: sweep(factors, cw, settings))
    launches = segment_counts(rk, ak)
    err = max(_max_diff(torch, a, b) for a, b in zip(got, want))
    log(f"path 13b sharded sweep: {cw.shape[0]} combos, {SWEEP_F} x "
        f"{SWEEP_D} x {SWEEP_N} float32 on a ('combo',) world of one: "
        f"{secs:.4f} s wall, 8b's sweep {want_secs:.4f} s; max |diff| "
        f"{err:.3e} (tol {P13_TOL}); launches {json.dumps(launches)}")
    _held13("13b", err)
    return launches


#: the JAX package's five asset-layout plan stages
#: (``factormodeling_tpu/ops/_assetspec.py``), the port's too
P13_STAGES = ("metrics/rank_ic", "ops/rank", "ops/quantile",
              "backtest/weights", "solver/iterates")


def _asset_runs(torch, fmt, mesh, arrays, sim: dict, plans: dict,
                ref=None) -> tuple:
    """The asset-sharded step under each plan on ``arrays`` with ``sim``,
    each run held against the unsharded step at ``P13_TOL`` (its gathered
    outputs; bitwise or not printed): ``(rows by plan, the unsharded
    wall)``. ``ref``: the unsharded step's ``(output, wall)`` from an
    earlier path on the same inputs (else it runs here)."""
    from factormodeling_tpu_torch.obs import comms
    from factormodeling_tpu_torch.parallel import \
        make_asset_sharded_research_step

    inputs, cfg = fmt.convert(*arrays, names=factor_names(F), window=WINDOW,
                              select_method="icir_top", blend_method="zscore",
                              sim_kwargs=sim, device="cuda")
    kw = cfg.as_kwargs()
    kw.pop("device")
    ref, ref_secs = ref or _timed(torch, lambda: fmt.build_research_step(
        **kw, device="cuda")(*inputs))
    rows = {}
    for label, plan in plans.items():
        step, shard = make_asset_sharded_research_step(mesh, **kw, plan=plan)
        blocks = shard(*inputs)
        with comms.recording(mesh) as ledger:
            out, secs = _timed(torch, lambda: step(*blocks))
        out = step.gather_outputs(out)
        pairs = ((out.selection, ref.selection), (out.signal, ref.signal),
                 (out.sim.weights, ref.sim.weights),
                 (out.sim.result.log_return, ref.sim.result.log_return))
        err = max(_max_diff(torch, a, b) for a, b in pairs)
        rows[label] = {"secs": round(secs, 3), "max_abs_err": err,
                       "bitwise": all(_bytes_equal(a, b) for a, b in pairs),
                       "collectives": ledger.totals()["collectives"]}
        _held13(f"13c {sim['method']} {label}", err)
    return rows, ref_secs


def mesh_asset_path(torch, fmt, seed: int, refs: dict) -> dict:
    """13c: the asset-sharded step on a (1, 1) ``("date", "assets")`` mesh
    at path 1's width: icir_top / equal at full depth under each layout
    mode and under ``choose_asset_specs``' plan (its stages, the
    backtest's included, run on ``meta`` tensors; its plan lists the five
    JAX stages); then the QP schemes (fused) under each mode, plain mvo
    at full depth held against path 2's own run and the mvo_turnover scan
    on path 1's first P13_DATES dates held against 13a's unsharded step;
    each run held against the unsharded step. K1 once a run; K2 as the
    unsharded runs of the two schemes launch it."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.ops._assetspec import ASSET_SORT_STAGES
    from factormodeling_tpu_torch.parallel import (AssetSpecPlan,
                                                   choose_asset_specs,
                                                   make_asset_mesh)

    arrays = make_inputs(F, D, N, seed)
    equal = dict(method="equal", pct=P8_PCT)
    mesh = make_asset_mesh(("date", "assets"), device="cuda")
    kw = dict(names=factor_names(F), window=WINDOW, select_method="icir_top",
              blend_method="zscore")
    t0 = time.perf_counter()
    chosen, ranking = choose_asset_specs(mesh, shapes=(F, D, N),
                                         dtype=torch.float32,
                                         sim_kwargs=equal, **kw)
    choose_secs = time.perf_counter() - t0
    if (tuple(ASSET_SORT_STAGES) != P13_STAGES
            or tuple(chosen.spec_table()) != P13_STAGES
            or set(ranking) != set(P13_STAGES) | {"__total__"}):
        raise AssertionError(f"path 13c: plan stages "
                             f"{list(chosen.spec_table())}, not the JAX "
                             f"package's {list(P13_STAGES)}")
    modes = {m: AssetSpecPlan(mesh, default=m) for m in ("auto", "reshard",
                                                        "gather")}
    rk.launches = ak.launches = ak.lane_launches = 0
    rows, ref_secs = _asset_runs(torch, fmt, mesh, arrays, equal,
                                 dict(modes, chosen=chosen))
    qp = {}
    for path, d in (("mvo", D), ("turnover", P13_DATES)):
        cut = tuple(a[:, :d] if a.ndim == 3 else a[:d] for a in arrays)
        sim = dict(PATHS[path], max_weight=MAX_WEIGHT, solver_kernel="fused")
        qp[path] = _asset_runs(torch, fmt, mesh, cut, sim, modes,
                               ref=refs.get(path))
    launches = segment_counts(rk, ak)
    log(f"path 13c asset-sharded step: (1, 1) ('date', 'assets') mesh, "
        f"icir_top / equal, F={F} D={D} N={N}: the unsharded step "
        f"{ref_secs:.3f} s; by plan {json.dumps(rows)} (tol {P13_TOL}); the "
        f"chooser {choose_secs:.3f} s on meta tensors, plan "
        f"{json.dumps(chosen.spec_table())}, total bytes by mode "
        f"{json.dumps(ranking['__total__']['ranked'])}")
    for path, (r, secs) in qp.items():
        log(f"path 13c {path} ({PATHS[path]['method']}, "
            f"{D if path == 'mvo' else P13_DATES} dates): the unsharded "
            f"step {secs:.3f} s; by mode {json.dumps(r)}")
    runs = len(modes) * 3 + 2 + sum(refs.get(p) is None for p in qp)
    s_mvo = segment_launches(fmt, PATHS["mvo"])
    s_turn = segment_launches(fmt, PATHS["turnover"], d=P13_DATES)
    r_mvo = len(modes) + (refs.get("mvo") is None)
    r_turn = len(modes) + (refs.get("turnover") is None)
    want = {"rank_ic_postsort": runs,
            "admm_segment": r_mvo * s_mvo[0] + r_turn * s_turn[0],
            "admm_segment_lanes": r_mvo * s_mvo[1] + r_turn * s_turn[1]}
    log(f"path 13c launches {json.dumps(launches)} (schedule "
        f"{json.dumps(want)})")
    if launches != want:
        raise AssertionError(f"path 13c: launches {launches}, the runs "
                             f"imply {want}")
    return launches


def _held_shapes(state) -> dict:
    """``{leaf: shape}`` of an online state's tensors (the blocks a rank
    holds)."""
    from factormodeling_tpu_torch.online.state import _map_leaves

    out = {}

    def note(path, leaf, assets, lanes):
        out[path] = list(leaf.shape)
        return leaf

    _map_leaves(state, note)
    return out


def _ledger_by_stage(ledger) -> dict:
    """The comms ledger by stage: ``{stage: [collectives, bytes]}``."""
    return {st: [sum(c["count"] for c in v["collectives"].values()),
                 v["bytes_moved"]] for st, v in ledger.by_stage().items()}


def mesh_online_path(torch, fmt, arrays, date_slice) -> tuple:
    """13d's single tenant: 9b's turnover tenant through
    ``make_online_step(mesh=)`` on an ``("assets",)`` world of one over
    P13_ONLINE_DATES dates (its state held as asset blocks), held bitwise
    against the unsharded advance on the same dates, the K1 and K2
    launches of each run equal to the unsharded schedule. Returns the
    sharded run's launches and its log line."""
    from factormodeling_tpu_torch.composite import prefix_group_ids
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.obs import comms
    from factormodeling_tpu_torch.online import make_online_step
    from factormodeling_tpu_torch.online.advance import ONLINE_STAGES
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.parallel import make_asset_mesh

    names = factor_names(F)
    tmpl = turnover_configs(fmt)[0].normalized(
        F, len(prefix_group_ids(names)[1]), dtype=np.float64)
    mesh = make_asset_mesh(device="cuda")
    runs, launches, walls = {}, {}, {}
    ledger = held = None
    for label, kw in (("plain", dict(device="cuda")), ("mesh",
                                                        dict(mesh=mesh))):
        init, adv = make_online_step(names=names, template=tmpl,
                                     n_assets=N, dtype=torch.float32,
                                     has_universe=True, **kw)
        mstate, tstate = init()
        rows = []
        torch.cuda.synchronize()
        rk.launches = ak.launches = ak.lane_launches = 0
        ops = []
        t0 = time.perf_counter()
        for t in range(P13_ONLINE_DATES):
            ds = date_slice(t)
            if label == "mesh":
                ds = adv.shard_date_slice(ds)
            # the advance's collectives (the rows' gathers are the caller's)
            with comms.recording(mesh) as lg:
                (mstate, tstate), out = adv(tmpl, mstate, tstate, ds)
            ops += lg.ops
            rows.append(adv.gather_outputs(out) if label == "mesh"
                        else out)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launches[label] = segment_counts(rk, ak)
        runs[label] = rows
        if label == "mesh":
            ledger = _ledger_by_stage(comms.CommsLedger(ops))
            held = {"market": _held_shapes(mstate),
                    "tenant": _held_shapes(tstate)}
        elif ops:
            raise AssertionError(f"path 13d: the unsharded advance issued "
                                 f"{len(ops)} collectives")
    err = max(_tree_diff(torch, fmt, a, b)
              for a, b in zip(runs["mesh"], runs["plain"]))
    segs = segment_launches(fmt, PATHS["turnover"], d=1)[0]
    want = {"rank_ic_postsort": P13_ONLINE_DATES,
            "admm_segment": (P13_ONLINE_DATES - 1) * segs,
            "admm_segment_lanes": 0}
    line = (f"path 13d single tenant: 9b's turnover tenant through "
            f"make_online_step(mesh=) on an ('assets',) world of one, "
            f"{P13_ONLINE_DATES} dates: walls "
            f"{json.dumps({k: round(v, 3) for k, v in walls.items()})} s; "
            f"max |diff| from the unsharded advance {err:.3e} (bitwise "
            f"{err == 0.0}); launches {json.dumps(launches)} (schedule "
            f"{json.dumps(want)}); held blocks {json.dumps(held)}; comms by "
            f"stage [collectives, bytes] {json.dumps(ledger)}")
    if err != 0.0:
        raise AssertionError(f"path 13d single tenant: {err} from the "
                             f"unsharded advance (bitwise asked)")
    if launches["plain"] != want or launches["mesh"] != want:
        raise AssertionError(f"path 13d single tenant: launches {launches}, "
                             f"schedule {want}")
    if set(ledger) - set(ONLINE_STAGES):
        raise AssertionError(f"path 13d single tenant: collectives outside "
                             f"the online stages: {ledger}")
    return launches["mesh"], line


def mesh_serve_path(torch, fmt, seed: int) -> dict:
    """13d: ``TenantServer(mesh=...)`` on a (1, 1) ``("configs",
    "assets")`` mesh: 10a's rung-8 dispatch of 5 tenants (on the stored
    asset blocks: no call of ``_market_panels``), and 10d's two turnover
    tenants advanced over P13_ONLINE_DATES dates on their state's asset
    blocks, held bitwise against the unsharded server; K1 once a dispatch
    and once a date; then 9b's tenant through ``make_online_step(mesh=)``
    (:func:`mesh_online_path`)."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.obs import comms
    from factormodeling_tpu_torch.online import DateSlice
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.parallel import make_mesh

    arrays = make_inputs(F, D, N, seed)
    factors, returns, factor_ret, cap, invest, universe = arrays
    configs = serving_configs(fmt, S_TENANTS)[:S_PROBE]
    t_cfgs = turnover_configs(fmt)
    t_cfgs = [t_cfgs[0], t_cfgs[2]]
    mesh = make_mesh(("configs", "assets"), device="cuda")
    servers = {"plain": fmt.serve.TenantServer(
        names=factor_names(F), **_panels(arrays), device="cuda"),
        "mesh": fmt.serve.TenantServer(
            names=factor_names(F), **_panels(arrays), mesh=mesh)}

    def date_slice(t):
        return DateSlice(factors=factors[:, t], returns=returns[t],
                         factor_ret=factor_ret[t], cap_flag=cap[t],
                         investability=invest[t], universe=universe[t])

    got, walls = {}, {}
    whole = []
    ledger = held = None
    for label, server in servers.items():
        if label == "mesh":
            rk.launches = ak.launches = ak.lane_launches = 0
            # a dispatch runs on the stored blocks: count whole gathers
            gather = server._market_panels
            server._market_panels = lambda: whole.append(1) or gather()
        served, walls[f"{label} serve"] = _timed(
            torch, lambda s=server: s.serve(configs))
        server.online_begin(t_cfgs)
        rows = []
        t0 = time.perf_counter()
        with comms.recording(mesh) as lg:
            for t in range(P13_ONLINE_DATES):
                rows.append(server.advance_all(date_slice(t)))
        torch.cuda.synchronize()
        walls[f"{label} advance"] = time.perf_counter() - t0
        got[label] = (served, rows)
        if label == "mesh":
            ledger = _ledger_by_stage(lg)
            sess = next(iter(server._online.values()))
            held = {"market": _held_shapes(sess["mstate"]),
                    "tenants": _held_shapes(sess["tstates"])}
    launches = segment_counts(rk, ak)
    serve_err = max(_tree_diff(torch, fmt, a.output, b.output)
                    for a, b in zip(got["mesh"][0], got["plain"][0]))
    adv_err = max(_tree_diff(torch, fmt, a.output, b.output)
                  for ra, rb in zip(got["mesh"][1], got["plain"][1])
                  for a, b in zip(ra, rb))
    segs = segment_launches(fmt, PATHS["turnover"], d=1)[0]
    want = {"rank_ic_postsort": 1 + P13_ONLINE_DATES, "admm_segment": 0,
            "admm_segment_lanes": (P13_ONLINE_DATES - 1) * segs}
    log(f"path 13d sharded server: (1, 1) ('configs', 'assets') mesh: "
        f"{S_PROBE} equal tenants (rung 8) and 2 turnover tenants over "
        f"{P13_ONLINE_DATES} dates; walls "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})} s; max "
        f"|diff| serve {serve_err:.3e}, advance {adv_err:.3e} (tol "
        f"{P13_TOL}; advance bitwise {adv_err == 0.0}); mesh_shape "
        f"{json.dumps(servers['mesh'].serving_stats()['mesh_shape'])}; "
        f"whole-panel gathers {len(whole)}; launches {json.dumps(launches)} "
        f"(schedule {json.dumps(want)}); the session's held blocks "
        f"{json.dumps(held)}; advance_all's comms by stage [collectives, "
        f"bytes] {json.dumps(ledger)}")
    _held13("13d serve", serve_err)
    if adv_err != 0.0:
        raise AssertionError(f"path 13d advance_all: {adv_err} from the "
                             f"unsharded server (bitwise asked)")
    if whole:
        raise AssertionError(f"path 13d: {len(whole)} whole-panel gathers "
                             f"(_market_panels) in a dispatch")
    if launches != want:
        raise AssertionError(f"path 13d: launches {launches}, schedule "
                             f"{want}")
    if held["market"]["factors_tail"][-1] != N or any(
            shape[-1] != N for leaf, shape in held["tenants"].items()
            if not leaf.endswith("rho")):
        raise AssertionError(f"path 13d: held blocks {held} on a world of "
                             f"one")
    single, line = mesh_online_path(torch, fmt, arrays, date_slice)
    log(line)
    return {k: launches[k] + single[k] for k in launches}


def mesh_stream_path(torch, fmt, ns_host: dict) -> dict:
    """13e: ``streamed_factor_stats(mesh=...)`` on 12e's host stack from a
    date-block source (``chunk_sharding``) on a ``("date",)`` world of one,
    bitwise 12e's serial run; K1 once a chunk."""
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.parallel import make_mesh, streaming

    mesh = make_mesh(("date",), device="cuda")
    src, slices = streaming.host_array_source(
        ns_host["host"], NS_HOST_CHUNK,
        sharding=streaming.chunk_sharding(mesh))
    rk.launches = ak.launches = ak.lane_launches = 0
    got, secs = _timed(torch, lambda: streaming.streamed_factor_stats(
        src, len(slices), ns_host["rets"], shift_periods=2,
        stats=("rank_ic", "factor_return"), mesh=mesh))
    launches = segment_counts(rk, ak)
    serial = ns_host["serial"]
    bitwise = all(torch.equal(got[k].nan_to_num(7.0),
                              serial[k].nan_to_num(7.0)) for k in serial)
    log(f"path 13e date-sharded streaming: {NS_HOST_F} x {NS_D} x {NS_N} "
        f"float32 from host memory in chunks of {NS_HOST_CHUNK} on a "
        f"('date',) world of one: {secs:.3f} s wall; bitwise 12e's serial "
        f"run {bitwise}; launches {json.dumps(launches)}")
    if not bitwise:
        raise AssertionError("path 13e: the date-sharded stats differ from "
                             "12e's serial run")
    if launches["rank_ic_postsort"] != len(slices):
        raise AssertionError(f"path 13e: {launches['rank_ic_postsort']} K1 "
                             f"launches for {len(slices)} chunks")
    return launches


def mesh_paths(torch, fmt, seed: int, ns_host: dict,
               refs: dict | None = None) -> dict:
    """Path 13 in a world of one over NCCL (an in-process store), formed
    by the first mesh and destroyed at the end; a world that fails to
    form or a collective that fails fails the run. Returns each part's
    launches."""
    from factormodeling_tpu_torch.parallel import release_world

    out, refs = {}, dict(refs or {})
    try:
        for key, label, fn in (
                ("mesh_step", "13a", lambda: mesh_step_path(torch, fmt, seed,
                                                            refs)),
                ("mesh_sweep", "13b", lambda: mesh_sweep_path(torch, fmt)),
                ("mesh_asset", "13c", lambda: mesh_asset_path(torch, fmt,
                                                              seed, refs)),
                ("mesh_serve", "13d", lambda: mesh_serve_path(torch, fmt,
                                                              seed)),
                ("mesh_stream", "13e", lambda: mesh_stream_path(
                    torch, fmt, ns_host))):
            t0 = time.perf_counter()
            out[key] = fn()
            log(f"path {label} phase: {time.perf_counter() - t0:.1f} s wall")
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("path 13 ran on "
                                 f"{torch.distributed.get_backend()}, not "
                                 "nccl")
    finally:
        release_world()
    return out


# path 14: the telemetry (obs.memory, obs.devtime, obs.compile_log and the
# cost rows). 14b profiles path 1's step on its first P14_DATES dates, the
# fewest over which it reaches the rank-IC (K1) with its 60-date window:
# the exported trace holds ~2,270 kernel events and ~17,000 events in all
# a date (267 MiB at 64 dates), and the profiler's first start on the card
# takes ~12 s
P14_DATES = 64
P14_SUM_TOL = 1e-6   # the stages and the unattributed bucket sum to
#                      device_s (each rounded to the nanosecond)
#: the kernels' symbols in the trace's kernel events
P14_SYMBOLS = {"rank_ic_postsort": "rank_ic_postsort_kernel",
               "admm_segment": "admm_cluster_kernel"}


def placement_rows(rep, name: str, blocks, n_ops: int) -> None:
    """14a: the placement rows 13a's run landed under ``name``: the comms
    rows (their collectives the ``n_ops`` of 13a's own ledger), the memory
    row (its identity ``peak = argument + output + temp - alias``, its peak
    at least the arguments) and the sharding verdict."""
    rows = [r for r in rep.rows if r["name"] == name]
    comms = {r["stage"]: r for r in rows if r["kind"] == "comms"}
    mem = [r for r in rows if r["kind"] == "memory"]
    lint = [r for r in rows if r["kind"] == "sharding"]
    if "total" not in comms or len(mem) != 1 or len(lint) != 1 or any(
            "error" in r for r in rows):
        raise AssertionError(f"path 14a: placement rows {rows}")
    total, mem, lint = comms["total"], mem[0], lint[0]
    kinds = {k: v["count"] for k, v in total["collectives"].items()}
    args = sum(b.numel() * b.element_size() for b in blocks
               if b is not None)
    log(f"path 14a placement of 13a's run: comms rows "
        f"{json.dumps({s: {k: v['count'] for k, v in r['collectives'].items()} for s, r in comms.items() if s != 'total'})}, "
        f"total {json.dumps(kinds)}, {total['bytes_moved']} bytes, mesh "
        f"{json.dumps(total['mesh_shape'])}; memory ({mem['source']}) "
        f"argument {mem['argument_bytes']} B, output {mem['output_bytes']} "
        f"B, temp {mem['temp_bytes']} B, alias {mem['alias_bytes']} B, peak "
        f"{mem['peak_bytes'] / 2**30:.3f} GiB, device_stats "
        f"{json.dumps(mem['device_stats'])}; sharding clean {lint['clean']} "
        f"({lint['checked_inputs']} inputs, flags {lint['flags']}, notes "
        f"{lint['notes']})")
    if mem["source"] != "measured" or mem["peak_bytes"] != (
            mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"]) or mem["argument_bytes"] != args \
            or not mem["peak_bytes"] >= args:
        raise AssertionError(f"path 14a: memory row {mem} (arguments "
                             f"{args} B)")
    if not lint["clean"] or sum(kinds.values()) != n_ops:
        raise AssertionError(f"path 14a: sharding verdict {lint}, "
                             f"collectives {kinds} against 13a's {n_ops}")


def devtime_path(torch, fmt, seed: int) -> dict:
    """14b: ``RunReport.add_devtime`` of path 1's step on its first
    P14_DATES dates after a warm-up: per-stage device seconds from the
    exported Kineto trace. Gates: device tracks; the stages plus the
    unattributed bucket equal device_s within P14_SUM_TOL; device_s <=
    wall_s; the trace's K1 and K2 kernel events equal the launches the
    wrappers counted for the profiled call. Returns those launches."""
    import shutil
    import tempfile

    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak

    d = P14_DATES
    arrays = tuple(a[:, :d] if a.ndim == 3 else a[:d]
                   for a in make_inputs(F, D, N, seed))
    sim = dict(PATHS["turnover"], max_weight=MAX_WEIGHT,
               solver_kernel="fused")
    inputs, cfg = fmt.convert(*arrays, names=factor_names(F), window=WINDOW,
                              select_method="icir_top", blend_method="zscore",
                              sim_kwargs=sim, device="cuda")
    step = fmt.build_research_step(**cfg.as_kwargs())
    _, warm = _timed(torch, lambda: step(*inputs))
    tdir = tempfile.mkdtemp(prefix="fm_path14b_")
    try:
        rk.launches = ak.launches = ak.lane_launches = 0
        rep = fmt.obs.RunReport("path 14b")
        t0 = time.perf_counter()
        total = rep.add_devtime("research_step", step, *inputs,
                                trace_dir=tdir)
        phase = time.perf_counter() - t0
        launches = segment_counts(rk, ak)
        if "skipped" in total:
            raise AssertionError(f"path 14b: device time skipped: "
                                 f"{total['skipped']}")
        # the kernel events by name, read off the exported text (a JSON
        # parse of it takes as long again as the capture's own)
        t0 = time.perf_counter()
        with open(total["trace_path"]) as fh:
            text = fh.read()
        size = len(text)
        kernels = re.findall(r'"cat":\s*"kernel",\s*"name":\s*"([^"]*)"',
                             text)
        del text
        seen = {k: sum(sym in n for n in kernels)
                for k, sym in P14_SYMBOLS.items()}
        parse = time.perf_counter() - t0
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    stages = {r["stage"]: r["device_s"] for r in rep.rows
              if r["kind"] == "devtime" and r["stage"] != "total"}
    ranked = sorted(stages.items(), key=lambda kv: -kv[1])
    dev = total["device_s"]
    log(f"path 14b device time of path 1's step, F={F} D={d} N={N} "
        f"(warm-up {warm:.3f} s): profiled wall {total['wall_s']:.3f} s, "
        f"device {dev:.6f} s, host_overhead_frac "
        f"{total['host_overhead_frac']:.4f}, {total['device_tracks']} "
        f"device track(s); by stage (s, share of device) "
        + json.dumps({k: [v, round(v / dev, 4)] for k, v in ranked})
        + f", unattributed {total['unattributed_s']:.6f} s; "
        f"{len(kernels)} kernel events, K1 {seen['rank_ic_postsort']} / "
        f"launches {launches['rank_ic_postsort']}, K2 "
        f"{seen['admm_segment']} / launches "
        f"{launches['admm_segment'] + launches['admm_segment_lanes']}; "
        f"trace {size / 2**20:.1f} MiB, capture {phase:.1f} s, kernel "
        f"count {parse:.1f} s")
    if total["device_tracks"] < 1:
        raise AssertionError("path 14b: the trace has no device track")
    if abs(sum(stages.values()) + total["unattributed_s"] - dev) \
            > P14_SUM_TOL:
        raise AssertionError(f"path 14b: stages {stages} + unattributed "
                             f"{total['unattributed_s']} != {dev}")
    if not dev <= total["wall_s"]:
        raise AssertionError(f"path 14b: device {dev} s > wall "
                             f"{total['wall_s']} s")
    want = {"rank_ic_postsort": launches["rank_ic_postsort"],
            "admm_segment": (launches["admm_segment"]
                             + launches["admm_segment_lanes"])}
    if seen != want or want["rank_ic_postsort"] < 1 \
            or want["admm_segment"] < 1:
        raise AssertionError(f"path 14b: kernel events {seen}, the "
                             f"wrappers' launches {want}")
    return launches


def cost_path(torch, fmt, seed: int) -> None:
    """14d: ``obs.cost_estimate`` of path 8a's equal-weight step at its full
    shape (finite and positive) and of the turnover step in the parallel
    scheme (path 6's) on P14_DATES dates, whose sweeps read max |dw| on the
    host: the failure form."""
    arrays = make_inputs(F, D, N, seed)

    def built(sim, arrs):
        inputs, cfg = fmt.convert(
            *arrs, names=factor_names(F), window=WINDOW,
            select_method="icir_top", blend_method="zscore",
            sim_kwargs=sim, device="cuda")
        return fmt.build_research_step(**cfg.as_kwargs()), inputs

    t0 = time.perf_counter()
    step, inputs = built(dict(method="equal", pct=P8_PCT), arrays)
    eq = fmt.obs.cost_estimate(step, *inputs)
    eq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, inputs = built(dict(PARALLEL_PATHS["turnover_parallel"],
                              max_weight=MAX_WEIGHT, solver_kernel="fused"),
                         tuple(a[:, :P14_DATES] if a.ndim == 3
                               else a[:P14_DATES] for a in arrays))
    par = fmt.obs.cost_estimate(step, *inputs)
    par_s = time.perf_counter() - t0
    log(f"path 14d cost: the equal-weight step at F={F} D={D} N={N} "
        f"{json.dumps(eq)} ({eq_s:.1f} s); the parallel turnover step on "
        f"{P14_DATES} dates {json.dumps(par)} ({par_s:.1f} s)")
    if "error" in eq or not all(np.isfinite(v) and v > 0
                                for v in eq.values()):
        raise AssertionError(f"path 14d: equal-weight cost {eq}")
    if not (np.isnan(par["flops"]) and "host" in par.get("error", "")):
        raise AssertionError(f"path 14d: the turnover step's cost {par} is "
                             "not the failure form")


def compile_stats_path() -> None:
    """14c: ``compile_stats()`` of every instrumented entry point the script
    called; none may be retraced."""
    from factormodeling_tpu_torch.obs import compile_stats

    stats = compile_stats()
    log("path 14c entry points (calls, compiles, compile_s, retraced): "
        + json.dumps({k: [v["calls"], v["compiles"], v["compile_s"],
                          v["retraced"]] for k, v in sorted(stats.items())}))
    bad = {k: v for k, v in stats.items() if v["retraced"]}
    if not stats or bad:
        raise AssertionError(f"path 14c: entry points {sorted(stats)}, "
                             f"retraced {bad}")


# path 15: the chaos matrix (factormodeling_tpu_torch.chaos) at full width
# on the matrix's own panel (chaos.make_inputs at F x D x N). 15a: every
# fault class x policy with equal weights on all D dates, then the
# mvo_turnover column under "full" on the first P15_TURNOVER_DATES, fused
# (cut in depth from 64: ~2.5-3 s a turnover cell on 64 dates, against
# ~0.2 s an equal cell on 1332); 15b: serving (linear, 10a's tenants) on
# the first P15_SERVE_DATES; 15c: online (9b's tenant), P15_ONLINE_DATES a
# cell; 15d: scenarios (equal), P15_SCEN_PATHS paths a family on the first
# P15_SCEN_DATES. The matrix's own window and lookback (8) everywhere but
# 15b, whose tenants bring theirs (60).
P15_WINDOW = 8
P15_TURNOVER_DATES = 32
P15_SERVE_DATES = 333
P15_ONLINE_DATES = 16
P15_SCEN_DATES, P15_SCEN_PATHS = 166, 4
#: the turnover cells held against the same cell on the host CPU (the same
#: threefry masks): counters exact, weights at path 1's DW_TOL / DW_SHARE
P15_CPU_CELLS = ("chaos/nan_burst/full", "chaos/universe_collapse/full")
P15_COUNTERS = ("quarantined_days", "held_days", "carry_fallback_days",
                "clamped_cells", "degrade_events", "solver_fallback_days")
#: the card's kill/resume: the CLI's equal matrix of 4 cells at full width
#: on P15_KILL_DATES dates (cut from 333), killed right after cell 1's
#: snapshot; two interpreters' start-ups are most of its wall
P15_KILL_DATES = 166
P15_KILL_GRID = dict(faults=["nan_burst", "universe_collapse"],
                     policies=["default", "guard"])


class _CellLog:
    """Path 15's progress callback: each message (a cell's verdict line) on
    a line of its own with the wall and the K1 / K2 single-lane / K2 lane
    launches since the previous line."""

    def __init__(self, torch, rk, ak, tag: str):
        self.torch, self.rk, self.ak, self.tag = torch, rk, ak, tag
        torch.cuda.synchronize()
        self.t, self.seen = time.perf_counter(), segment_counts(rk, ak)

    def __call__(self, msg: str) -> None:
        self.torch.cuda.synchronize()
        now, counts = time.perf_counter(), segment_counts(self.rk, self.ak)
        delta = {k: counts[k] - self.seen[k] for k in counts}
        log(f"path 15{self.tag} {msg}; {now - self.t:.3f} s; launches "
            f"{json.dumps(delta)}")
        self.t, self.seen = now, counts


def _degrade_counts(counters) -> dict:
    return {k: int(getattr(counters, k)) for k in P15_COUNTERS}


def chaos_path(torch, fmt, seed: int) -> dict:
    """Path 15: ``factormodeling_tpu_torch.chaos``'s four presets on the card
    at F=50, N=1000 on path 1's inputs (15a-15d above): every cell must hold
    its invariants and, in the research matrix, the watchdog's
    ``EXPECT_STAGE``; K1 launches in every preset and K2 in the turnover
    column; the ``P15_CPU_CELLS`` turnover cells equal their CPU runs
    (counters exact, weights at ``DW_TOL`` on all but ``DW_SHARE`` of
    days); then the CLI on the card (``python -m
    factormodeling_tpu_torch.chaos --device cuda``) killed after cell 1
    and resumed, its verdict byte-equal to a straight run's. Returns the
    presets' launches."""
    import dataclasses
    import tempfile

    from factormodeling_tpu_torch import chaos
    from factormodeling_tpu_torch.metrics import _cuda_rank_ic as rk
    from factormodeling_tpu_torch.ops import _cuda_admm as ak
    from factormodeling_tpu_torch.serve import TenantConfig

    # the matrix's own panel at full width, not path 1's: its tables
    # (EXPECT_STAGE, ONLINE_SENTRY) hold on a panel with no NaN cell. On
    # path 1's 3% NaN cells a stale date also moves NaN cells, which the
    # watchdog names at ops/factors_raw before the staleness canary, and a
    # collapsed universe moves the NaN-share gauge the sentry watches: in
    # both packages alike (tests/test_torch_chaos.py holds that)
    names, arrays = chaos.make_inputs(F, D, N, seed)

    def cut(d):
        return names, tuple(a[:, :d] if a.ndim == 3 else a[:d]
                            for a in arrays)

    held = {}

    def keep(cell, out, spec, policy):
        if cell in P15_CPU_CELLS:
            held[cell] = (out.sim.weights.cpu(), _degrade_counts(out.counters),
                          spec, policy)

    configs = [dataclasses.replace(c, method="linear")
               for c in serving_configs(fmt, 24)]
    # 9b's tenant with the matrix's window and lookback: a 60-date window
    # leaves nothing to serve on P15_ONLINE_DATES dates
    tenant_9b = TenantConfig(method="mvo_turnover", window=P15_WINDOW,
                             lookback_period=P15_WINDOW, top_k=5,
                             icir_threshold=0.03, max_weight=MAX_WEIGHT,
                             pct=0.1, turnover_penalty=0.1,
                             sim_static={"solver_kernel": "fused"})
    runs = (
        ("a", f"research matrix, equal, {D} dates", chaos.run_chaos,
         dict(market=(names, arrays), method="equal", window=P15_WINDOW)),
        ("a", f"mvo_turnover under full, {P15_TURNOVER_DATES} dates",
         chaos.run_chaos,
         dict(market=cut(P15_TURNOVER_DATES), method="mvo_turnover",
              window=P15_WINDOW, policies=["full"],
              sim_kwargs=dict(solver_kernel="fused"), on_cell=keep)),
        ("b", f"serving, linear, 10a's tenants, {P15_SERVE_DATES} dates",
         chaos.run_serving_chaos,
         dict(market=cut(P15_SERVE_DATES), method="linear",
              n_requests=len(configs), configs=configs)),
        ("c", f"online, 9b's tenant, {P15_ONLINE_DATES} dates a cell",
         chaos.run_online_chaos,
         dict(market=cut(P15_ONLINE_DATES), template=tenant_9b)),
        ("d", f"scenarios, equal, {P15_SCEN_PATHS} paths a family, "
              f"{P15_SCEN_DATES} dates", chaos.run_scenario_chaos,
         dict(market=cut(P15_SCEN_DATES), method="equal",
              window=P15_WINDOW, n_paths=P15_SCEN_PATHS)))
    rk.launches = ak.launches = ak.lane_launches = 0
    by_run = []
    for tag, what, run, kw in runs:
        before = segment_counts(rk, ak)
        t0 = time.perf_counter()
        verdict = run(device="cuda", progress=_CellLog(torch, rk, ak, tag),
                      **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = segment_counts(rk, ak)
        got = {k: after[k] - before[k] for k in after}
        by_run.append((what, got))
        log(f"path 15{tag} {what}: {verdict['cells']} cells, "
            f"{len(verdict['failed'])} failing, {wall:.1f} s wall; launches "
            f"{json.dumps(got)}")
        if not verdict["ok"]:
            raise AssertionError(
                f"path 15{tag} {what}: failing cells " + "; ".join(
                    f"{c}: {verdict['results'][c]['violations'][:3]}"
                    for c in verdict["failed"]))
        if got["rank_ic_postsort"] < verdict["cells"]:
            raise AssertionError(f"path 15{tag} {what}: K1 launched "
                                 f"{got['rank_ic_postsort']} times for "
                                 f"{verdict['cells']} cells")
    launches = segment_counts(rk, ak)
    if not by_run[1][1]["admm_segment"]:
        raise AssertionError("path 15a: the turnover column never launched "
                             "K2")

    # the held turnover cells on the host CPU: the same masks and policy
    t0 = time.perf_counter()
    step = chaos.matrix_step(names=names, window=P15_WINDOW,
                             method="mvo_turnover",
                             n_dates=P15_TURNOVER_DATES,
                             sim_kwargs=dict(solver_kernel="fused"),
                             device="cpu")
    host_args = tuple(torch.from_numpy(a) for a in cut(P15_TURNOVER_DATES)[1])
    for cell in P15_CPU_CELLS:
        w, counts, spec, policy = held[cell]
        host = step(*host_args, fault_spec=spec, policy=policy)
        host_counts = _degrade_counts(host.counters)
        dw = (w.nan_to_num() - host.sim.weights.nan_to_num()).abs() \
            .max(-1).values
        share = float((dw > DW_TOL).double().mean())
        log(f"path 15a {cell} on the CPU: counters {json.dumps(host_counts)} "
            f"(card {json.dumps(counts)}); weights max |dw| "
            f"{float(dw.max()):.3e}, share of days > {DW_TOL}: {share:.4f} "
            f"(limit {DW_SHARE})")
        if host_counts != counts:
            raise AssertionError(f"path 15a {cell}: card counters {counts}, "
                                 f"CPU {host_counts}")
        if not share <= DW_SHARE:
            raise AssertionError(f"path 15a {cell}: card and CPU weights "
                                 f"differ on {share:.2%} of days")
    log(f"path 15a CPU cells: {time.perf_counter() - t0:.1f} s wall")

    # the CLI on the card, killed after cell 1's snapshot and resumed
    t0 = time.perf_counter()
    straight = json.dumps(chaos.run_chaos(
        shape=(F, P15_KILL_DATES, N), method="equal", device="cuda",
        progress=lambda _m: None, **P15_KILL_GRID), sort_keys=True) + "\n"
    with tempfile.TemporaryDirectory(prefix="chaos15-") as tmp:
        ck = os.path.join(tmp, "chaos.ckpt")
        cli = [sys.executable, "-m", "factormodeling_tpu_torch.chaos",
               "--device", "cuda", "--json", "--shape",
               f"{F},{P15_KILL_DATES},{N}", "--method", "equal",
               "--faults", ",".join(P15_KILL_GRID["faults"]),
               "--policies", ",".join(P15_KILL_GRID["policies"]),
               "--checkpoint", ck]
        env = {k: v for k, v in os.environ.items()
               if k != "_FMT_CHAOS_DIE_AFTER_CELL"}
        killed = subprocess.run(cli, cwd=ROOT, capture_output=True,
                                text=True, timeout=300,
                                env={**env, "_FMT_CHAOS_DIE_AFTER_CELL": "1"})
        resumed = subprocess.run(cli, cwd=ROOT, capture_output=True,
                                 text=True, timeout=300, env=env)
    log(f"path 15 kill/resume on the card ({F} x {P15_KILL_DATES} x {N}, "
        f"4 cells): killed rc {killed.returncode}, resumed rc "
        f"{resumed.returncode}, resumed verdict byte-equal to straight "
        f"{resumed.stdout == straight}; {time.perf_counter() - t0:.1f} s "
        f"wall")
    if killed.returncode != 137 or "dying after cell 1" not in killed.stderr:
        raise AssertionError(f"path 15 kill: rc {killed.returncode}\n"
                             f"{killed.stderr[-2000:]}")
    if resumed.returncode != 0 or "resumed 2/4 cells" not in resumed.stderr:
        raise AssertionError(f"path 15 resume: rc {resumed.returncode}\n"
                             f"{resumed.stderr[-2000:]}")
    if resumed.stdout != straight:
        raise AssertionError(f"path 15 resume: verdict {resumed.stdout!r} "
                             f"against straight {straight!r}")
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
    kernels["admm_segment_collect"] = collect_phase(torch, args.seed)
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
    t0 = time.perf_counter()
    draw_phase(torch, fmt, smi)
    log(f"draw phase: {time.perf_counter() - t0:.1f} s wall")
    launches = {}
    for path in PATHS:
        launches[path], out, secs = path_phase(torch, args.seed, path,
                                               warm_up=path == "turnover")
        if path == "turnover":   # path 6 is held against it
            scan_out, scan_secs = out, secs
        if path == "mvo":        # 13c's plain-MVO runs are held to it
            mvo_ref = (out, secs)
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
    swept = sweep_path(torch, fmt)
    log(f"path 8b phase (warm-up, two runs, checks, CPU run): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    checkpointed_sweep_path(torch, fmt, swept["out"], swept["inputs"])
    del swept
    log(f"path 8c phase (interrupted run, resume, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    resil = resil_path(torch, fmt, args.seed)
    launches["resil"] = resil["launches"]["clean"]
    collect = {"resil_inert": resil["launches"]["inert"]["admm_segment"],
               "resil_chaos": resil["launches"]["chaos"]["admm_segment"],
               "tally": resil["tally"]["admm_segment"]}
    log(f"path 9a phase (clean, inert and chaos runs, checks, CPU run): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["online"], rows9b, ms9b = online_path(torch, fmt, args.seed,
                                                   resil["clean"])
    log(f"path 9b phase (warm-up, {P9B_DATES} dates, checks, resume, "
        f"replay): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    hooked_online_path(torch, fmt, args.seed, ms9b)
    log(f"path 11c phase (unhooked, hooked, killed and resumed runs of "
        f"{P11C_DATES} dates, checks): {time.perf_counter() - t0:.1f} s "
        f"wall")
    t0 = time.perf_counter()
    served = serve_path(torch, fmt, args.seed)
    launches["serve"] = served["launches"]
    log(f"path 10a phase (three dispatches, checks, single-tenant steps, "
        f"CPU run): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["serve_turnover"], s_configs = turnover_serve_path(
        torch, fmt, args.seed, resil["clean"], resil["clean_secs"])
    del resil
    log(f"path 10b phase (run, checks): {time.perf_counter() - t0:.1f} s "
        "wall")
    t0 = time.perf_counter()
    launches["serve_parallel"] = parallel_serve_path(torch, fmt, args.seed)
    log(f"path 10e phase (bucket, three single runs, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    queue_path(torch, fmt, served)
    del served
    log(f"path 10c phase (service time, queue, re-serve, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["advance_all"] = advance_all_path(torch, fmt, args.seed,
                                               s_configs, rows9b)
    del rows9b
    log(f"path 10d phase ({S_ONLINE_DATES} dates, checks): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t12 = time.perf_counter()
    t0 = time.perf_counter()
    launches["scenarios"] = scenario_path(torch, fmt, args.seed)
    log(f"path 12a phase (identity runs, three families, CPU check): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["scenarios_resume"] = scenario_resume_path(torch, fmt, args.seed)
    log(f"path 12b phase (straight, killed, resumed): "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["scenarios_turnover"] = scenario_turnover_path(torch, fmt,
                                                            args.seed)
    log(f"path 12c phase: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["north_star"], k1_north = north_star_path(torch, fmt, args.seed)
    log(f"path 12d phase (warm-up, one pass, two-pass flow, one-shot check, "
        f"K1 timing): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["north_star_host"], ns_host = north_star_host_path(
        torch, fmt, args.seed)
    log(f"path 12e phase (serial, prefetched, disk): "
        f"{time.perf_counter() - t0:.1f} s wall")
    log(f"path 12: {time.perf_counter() - t12:.1f} s wall")
    t0 = time.perf_counter()
    launches.update(mesh_paths(torch, fmt, args.seed, ns_host,
                               {"mvo": mvo_ref}))
    del ns_host, mvo_ref
    log(f"path 13: {time.perf_counter() - t0:.1f} s wall")
    t14 = time.perf_counter()
    launches["devtime"] = devtime_path(torch, fmt, args.seed)
    log(f"path 14b phase (warm-up, profiled run, export, parses, checks): "
        f"{time.perf_counter() - t14:.1f} s wall")
    t0 = time.perf_counter()
    cost_path(torch, fmt, args.seed)
    log(f"path 14d phase: {time.perf_counter() - t0:.1f} s wall")
    compile_stats_path()
    log(f"path 14 (14a within 13a): {time.perf_counter() - t14:.1f} s wall")
    t0 = time.perf_counter()
    launches["chaos"] = chaos_path(torch, fmt, args.seed)
    log(f"path 15 (15a-15d, CPU cells, kill/resume): "
        f"{time.perf_counter() - t0:.1f} s wall")
    # each kernel's launches on the paths that run its form: K1 once in each
    # of paths 1-3, in path 8a's icir_top selection and in path 9a's clean
    # step, once a date in path 9b's online advance, once a dispatch in
    # paths 10a, 10b and 10e, once a date in path 10d's session, once a
    # dispatch in paths 12a-12c, once a chunk in 12d-12e, once in 13a, once
    # a run in 13c, once a dispatch and a date in 13d's server and once a
    # date in its single-tenant sharded advance, once a chunk in 13e,
    # once in 14b's profiled run, and once a step, dispatch, date or
    # scenario dispatch in path 15's presets
    k1 = {p: launches[p]["rank_ic_postsort"] for p in
          (*PATHS, "multimanager", "resil", "online", "serve",
           "serve_turnover", "serve_parallel", "advance_all", "scenarios",
           "scenarios_resume",
           "scenarios_turnover", "north_star", "north_star_host",
           "mesh_step", "mesh_asset", "mesh_serve", "mesh_stream",
           "devtime", "chaos")}
    kernels["rank_ic_postsort"]["launches"] = sum(k1.values())
    kernels["rank_ic_postsort"]["launches_by_path"] = k1
    kernels["rank_ic_postsort"].update(k1_north)
    # the segment's single-lane launches: path 1, the sequential suffixes
    # of paths 6-7 and 10e (a date with one lane past its start), path 9a's
    # clean step, path 9b's advance, paths 13a, 13c (the scan's runs), 13d's
    # single-tenant sharded advance, 14b and path 15a's turnover column;
    # its collect=1 form: path 9a's probed inert and chaos steps and
    # path 11a's probed tally run; its lane launches: path 2's chunks and
    # 13c's plain-MVO runs, the seed and sweep chunks of paths 6-7 and 10e,
    # and the lane-batched day loops: path 10b's bucket (its real tenants,
    # never a pad lane), 10e's suffix, the sessions of 10d and 13d and
    # 12c's regime paths (each as the wrapper counted it)
    single = {p: launches[p]["admm_segment"] for p in
              ("turnover", "turnover_parallel", "turnover_parallel_decoupled",
               "serve_parallel", "resil", "online", "mesh_step",
               "mesh_asset", "mesh_serve", "devtime", "chaos")}
    lanes = {p: launches[p]["admm_segment_lanes"] for p in
             ("mvo", "turnover_parallel", "turnover_parallel_decoupled",
              "serve_turnover", "serve_parallel", "advance_all",
              "scenarios_turnover", "mesh_asset", "mesh_serve", "chaos")}
    kernels["admm_segment"]["launches"] = sum(single.values())
    kernels["admm_segment"]["launches_by_path"] = single
    kernels["admm_segment_lanes"]["launches"] = sum(lanes.values())
    kernels["admm_segment_lanes"]["launches_by_path"] = lanes
    kernels["admm_segment_collect"]["launches"] = sum(collect.values())
    kernels["admm_segment_collect"]["launches_by_path"] = collect
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
             "path_ms", "path_plain_ms", "path_bound_ms", "path_library_ms",
             "north_star_rows", "north_star_max_abs_err", "north_star_ms",
             "north_star_plain_ms", "north_star_bound_ms",
             "north_star_sort_gather_k1_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in order if k in kern}
                                for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
