"""On-device numerics probes with provenance: where was a NaN born? (port
of ``factormodeling_tpu/obs/probes.py``).

``probe(name, x)`` collects a small per-tensor summary
(:class:`ProbeFrame`: finite fraction, NaN/Inf counts, absmax, mean/std
and a log2-magnitude histogram) as tensors on ``x``'s device, in the
order the stages run; the frames ride ``ResearchOutput.probes`` like the
stage counters ride ``ResearchOutput.counters``. Nothing in
:func:`probe` reads a value back: the host views
(:func:`summarize_probes`, :func:`watchdog`) fetch every frame in one
copy when asked.

Gating: the JAX package decides at trace time; the port decides at call
time. With no :func:`capture` open (the default), :func:`probe` returns
its argument and runs nothing, so a step built without probes runs
exactly the launches of a build without this module.
``build_research_step(collect_probes=True)`` opens a capture for the
duration of each step call; solvers read :func:`collection_active` where
each solve starts (the iterations-to-converge tally and the per-segment
residual trajectory of ``ADMMResult``, threaded out through the result
rather than probed inside the day loop).

Provenance comes from order: every frame carries a ``seq`` index, so
:func:`watchdog` answers "which stage's finite fraction dropped first?".
Pass a clean run's profile as the ``baseline`` (``obs.regression.
numerics_baseline`` or :func:`probe_profile`) to flag drops against a
known good run; without one, the watchdog flags the first stage below
its own declared ``expect_finite`` (stages probed with
``expect_finite=None``, whose NaN share is legitimate, are skipped).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["ProbeFrame", "capture", "collection_active", "enable_probes",
           "frame_of", "probe", "probe_profile", "probing",
           "probes_enabled", "summarize_frame", "summarize_probes",
           "watchdog"]

_ENABLED = False
_ACTIVE: "ProbeCapture | None" = None

#: log2-magnitude histogram: 8 bins of width 4 covering |x| in
#: [2^-16, 2^16); underflow and overflow clip into the edge bins
_HIST_BINS = 8
_HIST_LO = -16  # log2 of the smallest resolved magnitude
_HIST_WIDTH = 4


def enable_probes(flag: bool = True) -> None:
    """Globally enable or disable probe collection (read when a step
    function is built, as ``obs.counters.enable_counters``)."""
    global _ENABLED
    _ENABLED = bool(flag)


def probes_enabled() -> bool:
    return _ENABLED


def collection_active() -> bool:
    """True when probe data is being collected at this point: the global
    :func:`enable_probes` gate or an open :func:`capture` (which
    ``build_research_step(collect_probes=True)`` opens without touching the
    global). The solvers key their extra telemetry on this."""
    return _ENABLED or _ACTIVE is not None


@contextlib.contextmanager
def probing(flag: bool = True):
    """Scoped :func:`enable_probes`: probes collected by steps built inside
    the block."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    try:
        yield
    finally:
        _ENABLED = prev


class ProbeFrame(NamedTuple):
    """One probed tensor's summary, as 0-d tensors (``log2_hist`` ``[8]``)
    on the probed tensor's device.

    seq: int32, the stage's order. finite_frac: float32 fraction of finite
    cells (1 for an empty tensor). nan_count / inf_count: int32 exact
    counts. absmax / mean / std: float32 over the finite cells (0 when
    none). log2_hist: int32 counts of finite non-zero cells by
    ``floor(log2 |x|)`` in width-4 bins from 2^-16 up (edge bins absorb
    under- and overflow). expect_finite: float32 declared healthy finite
    fraction (NaN: no expectation).
    """

    seq: torch.Tensor
    finite_frac: torch.Tensor
    nan_count: torch.Tensor
    inf_count: torch.Tensor
    absmax: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor
    log2_hist: torch.Tensor
    expect_finite: torch.Tensor


class ProbeCapture:
    """Ordered frame collection for one step call (see :func:`capture`)."""

    def __init__(self):
        self._frames: dict[str, ProbeFrame] = {}

    def add(self, name: str, frame: ProbeFrame) -> None:
        base, k = name, 2
        while name in self._frames:  # repeated stage: suffix, keep both
            name = f"{base}#{k}"
            k += 1
        self._frames[name] = frame

    def frames(self) -> dict[str, ProbeFrame]:
        """The collected frames (each frame's ``seq`` keeps the order)."""
        return dict(self._frames)


@contextlib.contextmanager
def capture():
    """Open a :class:`ProbeCapture`::

        with probes.capture() as cap:
            ... stages call probe(name, x) ...
            frames = cap.frames()   # -> ResearchOutput.probes
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = cap = ProbeCapture()
    try:
        yield cap
    finally:
        _ACTIVE = prev


def frame_of(x, *, seq: int = 0,
             expect_finite: float | None = 1.0) -> ProbeFrame:
    """The summary of one tensor, cell for cell the JAX package's: the
    non-finite cells zeroed, then the cast to float32 (a finite float64
    value beyond the float32 range becomes inf: absmax inf, top bin), the
    histogram from the float32 exponent bits, ``nan_count`` derived as
    ``size - finite - inf``, the moments from one sum and one sum of
    squares. Every value is computed on ``x``'s device; scalars are filled
    there, never copied from the host."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)  # bool/int probes: summarize as values
    dev, f32, i32 = x.device, torch.float32, torch.int32
    exp = torch.full((), float("nan") if expect_finite is None
                     else float(expect_finite), dtype=f32, device=dev)
    seq_t = torch.full((), int(seq), dtype=i32, device=dev)
    if x.numel() == 0:  # a zero-size tensor is trivially clean
        zero_i = torch.zeros((), dtype=i32, device=dev)
        zero_f = torch.zeros((), dtype=f32, device=dev)
        return ProbeFrame(
            seq=seq_t, finite_frac=torch.ones((), dtype=f32, device=dev),
            nan_count=zero_i, inf_count=zero_i, absmax=zero_f, mean=zero_f,
            std=zero_f, log2_hist=torch.zeros(_HIST_BINS, dtype=i32,
                                              device=dev),
            expect_finite=exp)
    n = x.numel()
    finite = torch.isfinite(x)
    n_finite = finite.sum(dtype=i32)
    inf_count = torch.isinf(x).sum(dtype=i32)
    xf = torch.where(finite, x, 0.0).to(f32)
    cnt = torch.clamp(n_finite, min=1).to(f32)
    mean = xf.sum() / cnt
    var = torch.clamp((xf * xf).sum() / cnt - mean * mean, min=0.0)
    # biased exponent: (bits >> 23) & 0xff - 127 is floor(log2 |x|) for
    # float32 normals; values that are float32 denormals land in the
    # underflow bin, overflow in the top bin, and non-finite or zero cells
    # are masked out. A denormal of x's own dtype counts as zero, as the
    # JAX package counts it (its CPU and TPU backends flush denormals)
    e = ((xf.view(i32) >> 23) & 0xFF) - 127
    idx = torch.clamp(torch.div(e - _HIST_LO, _HIST_WIDTH,
                                rounding_mode="floor"), 0, _HIST_BINS - 1)
    valid = finite & (torch.abs(x) >= torch.finfo(x.dtype).tiny)
    hist = torch.zeros(_HIST_BINS, dtype=torch.int64, device=dev)
    hist.scatter_add_(0, idx.reshape(-1).long(),
                      valid.reshape(-1).long())
    return ProbeFrame(
        seq=seq_t,
        finite_frac=n_finite.to(f32) / float(n),
        nan_count=(n - n_finite - inf_count).to(i32),
        inf_count=inf_count,
        absmax=torch.abs(xf).amax(),
        mean=mean,
        std=torch.sqrt(var),
        log2_hist=hist.to(i32),
        expect_finite=exp,
    )


def probe(name: str, x, *, expect_finite: float | None = 1.0):
    """Summarize ``x`` into the open capture and return ``x`` unchanged.

    With no :func:`capture` open (the default) this returns ``x`` and runs
    nothing. With one, a :class:`ProbeFrame` named ``name`` is collected in
    order. ``expect_finite`` declares the healthy finite fraction (None
    for tensors that legitimately carry NaN, which the absolute-mode
    watchdog then skips). A None value passes through unrecorded."""
    cap = _ACTIVE
    if cap is None or x is None:
        return x
    cap.add(name, frame_of(x, seq=len(cap._frames),
                           expect_finite=expect_finite))
    return x


# --------------------------------------------------------- host-side views

_SCALARS = ("seq", "finite_frac", "nan_count", "inf_count", "absmax", "mean",
            "std", "expect_finite")


def _host_rows(frames: list) -> np.ndarray:
    """Every frame's fields as one float64 host array ``[len, 16]`` (the
    eight scalars, then the histogram), fetched in one copy per device;
    float32 and int32 values are exact in float64."""
    out = np.empty((len(frames), len(_SCALARS) + _HIST_BINS), np.float64)
    by_dev: dict = {}
    for i, f in enumerate(frames):
        by_dev.setdefault(f.seq.device, []).append(i)
    for dev, idx in by_dev.items():
        packed = torch.stack([
            torch.cat([torch.stack([getattr(frames[i], k).double()
                                    for k in _SCALARS]),
                       frames[i].log2_hist.double()]) for i in idx])
        out[idx] = packed.cpu().numpy()
    return out


def _summary(row: np.ndarray) -> dict:
    c = dict(zip(_SCALARS, row[:len(_SCALARS)]))
    exp = float(c["expect_finite"])
    return {
        "seq": int(c["seq"]),
        "finite_frac": float(c["finite_frac"]),
        "nan_count": int(c["nan_count"]),
        "inf_count": int(c["inf_count"]),
        "absmax": float(c["absmax"]),
        "mean": float(c["mean"]),
        "std": float(c["std"]),
        "log2_hist": [int(v) for v in row[len(_SCALARS):]],
        "expect_finite": None if np.isnan(exp) else exp,
    }


def summarize_frame(frame: ProbeFrame) -> dict:
    """JSON-ready dict of one frame (one copy to the host)."""
    return _summary(_host_rows([frame])[0])


def summarize_probes(frames: dict) -> dict:
    """Per-stage JSON-ready summaries, ordered by ``seq``; every frame
    that is not a summary already comes to the host in one copy."""
    todo = [k for k, f in frames.items() if not isinstance(f, dict)]
    rows = _host_rows([frames[k] for k in todo]) if todo else []
    done = {k: _summary(r) for k, r in zip(todo, rows)}
    items = [(k, done[k] if k in done else f) for k, f in frames.items()]
    return dict(sorted(items, key=lambda kv: kv[1]["seq"]))


def probe_profile(frames: dict, *, absmax_stages=(),
                  nonzero_stages=()) -> dict:
    """A clean run's per-stage baseline for :func:`watchdog`'s extended
    checks: every stage contributes its ``finite_frac``; stages named in
    ``absmax_stages`` also pin their ``absmax`` (outlier-class corruption
    leaves the finite fraction intact) and stages in ``nonzero_stages``
    their finite non-zero cell count (the ``log2_hist`` total: stale or
    duplicated dates move neither finite fraction nor absmax; the
    ``ops/factors_delta`` canary exists for this check)."""
    summaries = summarize_probes(frames)
    profile = {}
    for name, s in summaries.items():
        entry: dict = {"finite_frac": s["finite_frac"]}
        if name in absmax_stages:
            entry["absmax"] = s["absmax"]
        if name in nonzero_stages:
            entry["nonzero"] = int(sum(s["log2_hist"]))
        profile[name] = entry
    return profile


def watchdog(frames: dict, baseline: dict | None = None,
             tol: float = 1e-6, absmax_ratio: float = 100.0,
             nonzero_tol: int = 0) -> dict:
    """Pinpoint the FIRST stage (by ``seq``) whose summary degraded.

    ``frames``: ``{name: ProbeFrame}`` or summaries (a report's numerics
    rows). ``baseline``: optional ``{name: finite_frac}`` or
    ``{name: {finite_frac, absmax, nonzero}}`` (:func:`probe_profile`)
    from a known good run; a stage is bad when its finite fraction dropped
    more than ``tol`` below it, its absmax exceeds ``absmax_ratio`` x the
    baseline's, or its finite non-zero count dropped more than
    ``nonzero_tol``. Stages absent from the baseline, and every stage
    without one, are judged by their own ``expect_finite``.

    Returns a JSON-ready dict: ``mode``, ``first_bad_stage`` (None when
    clean), ``dropped`` (every offending stage in order) and the per-stage
    ``finite_frac`` map."""
    ordered = sorted(summarize_probes(frames).items(),
                     key=lambda kv: kv[1].get("seq", 0))
    dropped = []
    for name, s in ordered:
        frac = float(s["finite_frac"])
        if baseline is not None and name in baseline:
            base = baseline[name]
            if not isinstance(base, dict):
                base = {"finite_frac": base}
            bad = (base.get("finite_frac") is not None
                   and frac < float(base["finite_frac"]) - tol)
            if not bad and base.get("absmax") is not None:
                floor = max(float(base["absmax"]), 1e-12)
                bad = float(s["absmax"]) > floor * absmax_ratio
            if not bad and base.get("nonzero") is not None:
                nz = int(sum(s["log2_hist"]))
                bad = nz < int(base["nonzero"]) - int(nonzero_tol)
            if bad:
                dropped.append(name)
        else:
            expect = s.get("expect_finite", 1.0)
            if expect is not None and frac < float(expect) - tol:
                dropped.append(name)
    return {
        "mode": "baseline" if baseline is not None else "absolute",
        "first_bad_stage": dropped[0] if dropped else None,
        "dropped": dropped,
        "finite_frac": {name: float(s["finite_frac"])
                        for name, s in ordered},
    }
