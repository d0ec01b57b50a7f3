"""Where a segment launch spends its time, measured on the card, at the
shapes the backtest's three QP paths give the ADMM segment kernel
(``csrc/admm_segment.cu``):

- path 1, ``mvo_turnover``: the plain form, a T=60 sample window, the L1
  turnover term on, 25 iterations, one lane (:func:`sample_day_operands`);
- path 2, plain ``mvo``: the plain form, 32 plain-MVO days in one launch;
- path 3, ``mvo_turnover`` with the risk model and Anderson: depth 5, the
  T=20 risk factors, the L1 term on, 20 iterations, a last segment,
  warm-started from the day before — the operands the backtest itself
  hands the kernel on the last days of a short run (:func:`risk_days`).

Prints, in float64 at N=1000:

1. the clock cycles per iteration of each phase of a launch on the path 1
   and path 3 days, from the kernel built once more with
   ``-DFM_SEG_PHASES`` (into ``build/kernels/`` beside the ordinary
   build; the first block's thread 0 reads the SM clock at each phase
   boundary), with the launch's device time (CUDA events) of the
   instrumented and of the ordinary build. A phase ends at the block
   barrier or exchange wait that closes it, so its cycles include the wait
   for the block's slowest warp;
2. the device time per launch of each path's case for the cluster sizes
   of :data:`SWEEP`, and their sum weighted by each path's launches
   (:data:`PATH_LAUNCHES`) — what chose ``_cuda_admm.CLUSTER``; each run is
   held against the plain version: the plain form within
   :data:`PLAIN_TOL`, while the Anderson form's max |kernel - plain| on
   each of the last :data:`RISK_TAIL` path 3 days is printed (the
   accelerated path of a turnover day is chaotic: it parts from the plain
   version as far with C = 1, one block a lane, as with C = 8);
3. one ``cluster.sync()`` of a cluster of each size, timed alone.

Needs the card::

    python -m factormodeling_tpu_torch.segment_phases
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess

import numpy as np
import torch

from factormodeling_tpu_torch import _build
from factormodeling_tpu_torch.ops import _cuda_admm as ak

#: the phase each mark closes, as numbered in the source
PHASES = {1: "rd (after an exchange of residuals, where one ran)",
          2: "V rd partials, pushed", 3: "wait for t", 4: "t totals",
          5: "t kinv", 6: "xt and e partials", 7: "e exchange",
          8: "prox and dual update", 9: "residual exchange (Anderson)",
          10: "history push", 11: "Gram partials, pushed",
          12: "wait for the Gram", 13: "Gram totals and the m x m solve",
          14: "extrapolation and step partials", 15: "step exchange"}

T, N, MAX_WEIGHT, LANES = 60, 1000, 0.03, 32
#: path 3's backtest settings (the JAX package's bench.py risk model)
RISK_PATH = dict(method="mvo_turnover", turnover_penalty=0.1,
                 covariance="risk_model", risk_factors=20, risk_lookback=252,
                 risk_refit_every=21, qp_anderson=5)
#: days of the path 3 run, and the last days whose launches are kept: the
#: last refit (day 252) sees a full lookback
RISK_DAYS, RISK_TAIL = 260, 8
#: each path's segment launches in one research step at D = 1332
#: (chip_smoke.py checks them): 1332 dates x 2 segments, 42 lane batches x
#: 8 segments, 1332 dates x 1 segment
PATH_LAUNCHES = {"path 1": 2664, "path 2": 336, "path 3": 1332}
#: cluster sizes swept: one block a lane, and the portable clusters
SWEEP = (1, 2, 4, 8)
SEED, REPS, BARRIER_REPS = 0, 50, 20000
PLAIN_TOL = 1e-12   # float64, reassociation over 25 dependent iterations


def sample_day_operands(dtype, seed: int, lanes: int, l1: float):
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

    rng = np.random.default_rng(seed)
    returns = torch.tensor(rng.normal(scale=0.02, size=(200, N)), dtype=dtype,
                           device="cuda")
    sig = torch.tensor(rng.normal(size=(lanes, N)), dtype=dtype, device="cuda")
    todays = torch.arange(150, 150 + lanes, device="cuda")
    c, t_used = _window_factors(returns, todays, T)
    alpha, s_row = _shrunk_terms(c, t_used, 0.1)
    s_vec = s_row[:, None].expand(lanes, T)
    lo, hi, E, b = leg_constraints(sig, MAX_WEIGHT, dtype)
    center = equal_leg_fallback(sig) if l1 else torch.zeros_like(sig)
    prob = BoxQPProblem(q=torch.zeros_like(sig), lo=lo, hi=hi, E=E, b=b,
                        l1=l1, center=center)
    ops = first_segment_inputs(2.0 * alpha, c, 2.0 * s_vec, prob)
    return tuple(o[0] for o in ops) if lanes == 1 else ops


@contextlib.contextmanager
def _launches(keep: int):
    """Inside the block the solver's segment launches go through; yields a
    list that holds the last ``keep`` ones' ``(operands, keywords)``."""
    from factormodeling_tpu_torch.solvers import admm_qp

    seen = []
    launch = admm_qp.admm_segment

    def record(*ops, **kw):
        seen.append((tuple(o.clone() for o in ops), kw))
        del seen[:-keep]
        return launch(*ops, **kw)

    admm_qp.admm_segment = record
    try:
        yield seen
    finally:
        admm_qp.admm_segment = launch


def risk_days(seed: int) -> list:
    """``(operands, keywords)`` of the segment launches path 3 makes on the
    last :data:`RISK_TAIL` days of a :data:`RISK_DAYS`-day ``mvo_turnover``
    run with the risk model and Anderson (float32 returns and signal at
    N=1000 from ``seed``; the QP in float64): T = 20 factor rows, the L1
    term around the day before's weights, warm-started from its exit state;
    the operands with a lane axis of 1."""
    from factormodeling_tpu_torch.backtest.mvo import mvo_turnover_weights
    from factormodeling_tpu_torch.backtest.settings import SimulationSettings

    rng = np.random.default_rng(seed)
    returns = torch.tensor(rng.normal(scale=0.02, size=(RISK_DAYS, N)),
                           dtype=torch.float32, device="cuda")
    signal = torch.tensor(rng.normal(size=(RISK_DAYS, N)),
                          dtype=torch.float32, device="cuda")
    s = SimulationSettings(returns=returns, cap_flag=None,
                           investability_flag=None, max_weight=MAX_WEIGHT,
                           solver_kernel="fused", **RISK_PATH)
    with _launches(RISK_TAIL) as seen:
        mvo_turnover_weights(signal, s)
    return seen


def _lane_axis(ops):
    return ops if ops[1].ndim == 3 else tuple(o[None] for o in ops)


def _device_ms(launch, reps: int) -> float:
    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_instrumented() -> ctypes.CDLL:
    """The segment library built with ``-DFM_SEG_PHASES``."""
    src = _build.source_path("admm_segment")
    out = _build._lib_path("admm_segment").with_name(
        _build._lib_path("admm_segment").stem + "-phases.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS,
                        "-DFM_SEG_PHASES", "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def _library(lib):
    """The wrapper's launches go to ``lib`` inside the block."""
    plain_lib = ak._lib

    def entry(dtype):
        fn = getattr(lib, ak._ENTRY[dtype])
        fn.argtypes, fn.restype = plain_lib(dtype).argtypes, ctypes.c_int
        return fn

    ak._lib = entry
    try:
        yield
    finally:
        ak._lib = plain_lib


@contextlib.contextmanager
def _cluster(c: int):
    """The wrapper lays lanes out as clusters of ``c`` inside the block."""
    kept = ak.CLUSTER
    ak.CLUSTER = c
    try:
        yield
    finally:
        ak.CLUSTER = kept


def path_cases(risk_day) -> dict:
    """Each path's ``(operands with a lane axis, keywords)``, float64, path
    3's the launch ``risk_day``."""
    f64 = torch.float64
    plain = dict(relax=1.7, seg_len=25)
    return {"path 1": (_lane_axis(sample_day_operands(f64, SEED, 1, 0.1)),
                       plain),
            "path 2": (sample_day_operands(f64, SEED + 1, LANES, 0.0), plain),
            "path 3": risk_day}


def max_err(ops, kw) -> float:
    """Max |kernel - plain| over x, z, u and dz of one launch; the plain
    form's held within :data:`PLAIN_TOL`."""
    out = ak.admm_segment(*ops, **kw)
    ref = ak.admm_segment_plain(*ops, **kw)
    err = max(float((a - b).abs().max()) for a, b in zip(out[:4], ref[:4]))
    if not (kw.get("anderson") or err <= PLAIN_TOL):
        raise AssertionError(f"admm_segment: max |err| {err} > {PLAIN_TOL}")
    return err


def phases(cases: dict, lib) -> dict:
    """Cycles per iteration of each phase on the path 1 and path 3 days,
    with the device ms per launch of the instrumented and the ordinary
    build."""
    read = lib.fm_segment_phases
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    rows = {}
    for name in ("path 1", "path 3"):
        ops, kw = cases[name]
        launch, plan = ak.segment_launcher(*ops, **kw)
        ordinary_ms = _device_ms(launch, REPS)
        with _library(lib):
            launch = ak.segment_launcher(*ops, **kw)[0]
            launch()
            torch.cuda.synchronize()
            read(buf)                  # drop the warm-up's cycles
            ms = _device_ms(launch, REPS)
            if read(buf):
                raise RuntimeError("fm_segment_phases failed")
        per_it = {i: buf[i] / ((REPS + 1) * kw["seg_len"]) for i in PHASES
                  if buf[i]}
        rows[name] = dict(cluster=plan.cluster, t=ops[1].shape[1],
                          seg_len=kw["seg_len"], cycles=per_it,
                          total=sum(per_it.values()), ms=ms,
                          ordinary_ms=ordinary_ms)
    return rows


def sweep(cases: dict, days: list) -> dict:
    """Device ms per launch of each path's case at each cluster size of
    :data:`SWEEP`, their sum weighted by the paths' launches, and the
    Anderson form's max |kernel - plain| on each of path 3's ``days``."""
    rows = {}
    for c in SWEEP:
        with _cluster(c):
            row = {}
            for name, (ops, kw) in cases.items():
                max_err(ops, kw)
                launch, plan = ak.segment_launcher(*ops, **kw)
                row[name] = _device_ms(launch, REPS)
            row["weighted ms"] = sum(PATH_LAUNCHES[k] * row[k]
                                     for k in PATH_LAUNCHES)
            row["smem_bytes path 3"] = plan.smem_bytes
            row["path 3 days' max |err|"] = [max_err(*day) for day in days]
        rows[c] = row
    return rows


def barrier_us(lib) -> dict:
    """Microseconds per ``cluster.sync()`` of one cluster of each size of
    :data:`SWEEP` (blocks of 256 threads, :data:`BARRIER_REPS` in a row)."""
    fn = lib.fm_cluster_barrier
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def run(c):
        rc = fn(1, c, BARRIER_REPS, stream)
        if rc:
            raise RuntimeError(f"cluster barrier launch failed: {rc}")

    return {c: _device_ms(lambda: run(c), 5) * 1e3 / BARRIER_REPS
            for c in SWEEP}


def measure() -> dict:
    """The phase cycles, the cluster sweep and the barrier times."""
    if not torch.cuda.is_available():
        raise RuntimeError("segment_phases measures the card: no CUDA device")
    lib = build_instrumented()
    days = risk_days(SEED)
    cases = path_cases(days[-1])
    return dict(phases=phases(cases, lib), sweep=sweep(cases, days),
                barrier_us=barrier_us(lib))


def main() -> None:
    print(torch.cuda.get_device_name(0))
    res = measure()
    for name, row in res["phases"].items():
        print(f"{name}: T={row['t']}, C={row['cluster']}, {row['total']:.0f} "
              f"cycles an iteration over {row['seg_len']} iterations; device "
              f"{row['ms']:.4f} ms/launch instrumented, "
              f"{row['ordinary_ms']:.4f} ms ordinary")
        for i, cyc in row["cycles"].items():
            print(f"  {i:2d} {PHASES[i]:<45s} {cyc:9.1f}")
    for c, row in res["sweep"].items():
        print(f"sweep C={c}: device ms/launch " + json.dumps(row))
    for c, us in res["barrier_us"].items():
        print(f"cluster barrier C={c}: {us:.4f} us per cluster.sync()")
    print(json.dumps({"phases": {name: {str(i): round(v, 1)
                                        for i, v in row["cycles"].items()}
                                 for name, row in res["phases"].items()}}))


if __name__ == "__main__":
    main()
