"""Simulation settings (port of ``factormodeling_tpu/backtest/settings.py``).

Market data panels are dense ``[D, N]`` tensors plus an optional universe
mask; every knob keeps the JAX package's name, default and validation (see
that module for the rationale behind each default). ``degrade`` takes a
:class:`~factormodeling_tpu_torch.resil.policy.DegradePolicy`: the engine
then passes the pre-shift weights through the policy's hold pass.

Lanes: the tenant value knobs (:data:`LANE_KNOBS`) may be ``[C]`` tensors,
one value a lane, what ``jax.vmap`` of the JAX engine traces; the engine
then takes a ``[C, D, N]`` signal and panels that are ``[D, N]`` (shared)
or ``[C, D, N]`` (one a lane). :func:`lane_knobs` makes such leaves from
host values, validated as the scalars are. Where a knob meets a tensor,
:func:`knob` casts it to the type the Python number would have been
computed in (the tensor's own, the default float type against integer
counts), so a lane computes the bits of the scalar call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from factormodeling_tpu_torch.resil.policy import DegradePolicy

__all__ = ["LANE_KNOBS", "SimulationSettings", "TCOST_RATES", "knob",
           "lane_knobs"]

# per-cap-tier one-way transaction-cost rates; index = cap_flag 0..3
TCOST_RATES = (0.0, 0.0025, 0.0015, 0.0010)

#: the knobs that may carry a lane axis (the tenant value leaves)
LANE_KNOBS = ("max_weight", "pct", "shrinkage_intensity", "turnover_penalty",
              "return_weight", "tcost_scale")
#: the knobs whose values must be >= 0 (tcost_scale: None disables)
_NONNEGATIVE = ("tcost_scale",)


def knob(v, like: torch.Tensor, dtype=None, ndim: int | None = None):
    """A knob against an operand whose leading axis is the lanes: a Python
    number stays as it is; a ``[C]`` tensor becomes ``[C, 1, ...]`` of
    ``like``'s rank (or ``ndim``: a shared operand without the lane axis),
    in ``dtype`` (default ``like``'s: a Python float meets a tensor in the
    tensor's type; pass ``torch.get_default_dtype()`` against integer
    counts)."""
    if not isinstance(v, torch.Tensor):
        return v
    v = v.to(like.dtype if dtype is None else dtype)
    rank = like.ndim if ndim is None else ndim
    return v.reshape(v.shape + (1,) * (rank - v.ndim))


def lane_knobs(values: dict, device) -> dict:
    """``{name: [C] float64 tensor on device}`` from host values (numbers or
    arrays, one a lane), checked as :class:`SimulationSettings` checks its
    scalars; float64 holds each value exactly as the Python float it
    replaces."""
    out = {}
    for name, v in values.items():
        if name not in LANE_KNOBS:
            raise ValueError(f"{name} is not a lane knob ({LANE_KNOBS})")
        a = np.asarray(v, dtype=np.float64).reshape(-1)
        if name in _NONNEGATIVE and (a < 0).any():
            raise ValueError(f"{name} must be >= 0 (None disables), got "
                             f"{a.tolist()}")
        out[name] = torch.as_tensor(a, device=device)
    return out


@dataclasses.dataclass(frozen=True)
class SimulationSettings:
    # market data (dense panels)
    returns: torch.Tensor              # float[D, N] daily log-returns
    cap_flag: torch.Tensor             # float/int[D, N] cap tier 1/2/3
    investability_flag: torch.Tensor   # float[D, N] 0/1 (NaN allowed)
    universe: torch.Tensor | None = None  # bool[D, N] membership
    degrade: DegradePolicy | None = None   # pre-shift hold pass

    # simulation parameters (the LANE_KNOBS: a number, or a [C] tensor
    # from lane_knobs)
    method: str = "equal"
    transaction_cost: bool = True
    max_weight: float = 0.03
    pct: float = 0.1
    min_universe: int = 1000           # parity only; unused
    contributor: bool = False          # parity only
    tcost_scale: float | None = None

    # MVO knobs
    lookback_period: int = 60
    shrinkage_intensity: float = 0.1
    turnover_penalty: float = 0.1
    return_weight: float = 0.0
    covariance: str = "sample"
    risk_factors: int = 10
    risk_lookback: int = 252
    risk_refit_every: int = 21

    # ADMM solver knobs
    qp_iters: int | None = None
    qp_rho: float = 2.0
    qp_anderson: int = 0
    solver_kernel: str = "reference"
    qp_polish: bool = True
    mvo_batch: int = 32
    qp_warm_start: bool = True

    # mvo_turnover execution scheme
    turnover_mode: str = "scan"
    turnover_sweeps: int = 4
    turnover_tol: float = 1e-6
    turnover_sweep_iters: int | None = None
    turnover_seed_iters: int | None = None
    turnover_polish_passes: int = 2

    def resolved_qp_iters(self, turnover: bool) -> int:
        if self.qp_iters is not None:
            return self.qp_iters
        if turnover:
            if self.qp_polish:
                if self.qp_anderson > 0:
                    return 20 if self.qp_warm_start else 40
                return 40 if self.qp_warm_start else 80
            return 60 if self.qp_warm_start else 100
        return 200

    def resolved_sweep_iters(self) -> int:
        """Per-sweep ADMM budget of the turnover-parallel scheme."""
        if self.turnover_sweep_iters is not None:
            return self.turnover_sweep_iters
        return self.resolved_qp_iters(turnover=True)

    def resolved_seed_iters(self) -> int:
        """Plain-MVO seed budget of the turnover-parallel scheme."""
        if self.turnover_seed_iters is not None:
            return self.turnover_seed_iters
        return self.resolved_qp_iters(turnover=True)

    def __post_init__(self):
        if self.method not in ("equal", "linear", "mvo", "mvo_turnover"):
            raise ValueError(f"Unknown method {self.method}")
        if self.covariance not in ("sample", "risk_model"):
            raise ValueError(f"Unknown covariance {self.covariance}")
        if self.turnover_mode not in ("scan", "parallel"):
            raise ValueError(f"Unknown turnover_mode {self.turnover_mode}")
        if self.solver_kernel not in ("reference", "fused"):
            raise ValueError(f"Unknown solver_kernel {self.solver_kernel}")
        if self.degrade is not None and not isinstance(self.degrade,
                                                       DegradePolicy):
            raise TypeError(f"degrade must be a DegradePolicy or None, got "
                            f"{type(self.degrade).__name__}")
        if self.qp_anderson < 0:
            raise ValueError(
                f"qp_anderson must be >= 0 (0 disables), got {self.qp_anderson}")
        if isinstance(self.tcost_scale, (int, float, np.floating, np.integer)) \
                and self.tcost_scale < 0:
            raise ValueError(
                f"tcost_scale must be >= 0 (None disables), got "
                f"{self.tcost_scale}")
        self.lanes()

    def lanes(self) -> int | None:
        """The lane count of the ``[C]`` knobs, None when every knob is a
        number. Lane knobs come from :func:`lane_knobs` (values checked on
        the host there); here only their shapes are, so no device value is
        read."""
        sizes = {name: tuple(v.shape) for name in LANE_KNOBS
                 if isinstance(v := getattr(self, name), torch.Tensor)}
        if not sizes:
            return None
        if any(len(s) != 1 for s in sizes.values()) \
                or len(set(sizes.values())) != 1:
            raise ValueError(f"lane knobs must be [C] tensors of one C, got "
                             f"{sizes}")
        return next(iter(sizes.values()))[0]

    def lane_view(self, lane_ix: torch.Tensor) -> "SimulationSettings":
        """These settings with every ``[C]`` knob gathered at ``lane_ix``
        (``[B]``: the lane of each solve lane); number knobs stay."""
        return dataclasses.replace(self, **{
            name: getattr(self, name)[lane_ix] for name in LANE_KNOBS
            if isinstance(getattr(self, name), torch.Tensor)})

    def lane(self, i: int, c: int) -> "SimulationSettings":
        """Lane ``i`` of ``c`` as an unbatched call's settings: its knobs as
        Python numbers, its panels where they carry the lane axis."""
        repl = {name: float(getattr(self, name)[i]) for name in LANE_KNOBS
                if isinstance(getattr(self, name), torch.Tensor)}
        for name in ("returns", "cap_flag", "investability_flag",
                     "universe"):
            v = getattr(self, name)
            if v is not None and v.ndim == 3 and v.shape[0] == c:
                repl[name] = v[i]
        return dataclasses.replace(self, **repl)

    def cost_rates(self) -> torch.Tensor:
        """Per-cell one-way cost rates from the cap tier (missing tier -> 0),
        rescaled by ``tcost_scale`` when one is set: ``[D, N]``, or
        ``[C, D, N]`` under lane knobs or lane panels (the table is built
        once a call)."""
        table = torch.as_tensor(TCOST_RATES, dtype=self.returns.dtype).to(
            self.returns.device)
        flags = torch.nan_to_num(self.cap_flag.to(self.returns.dtype)).to(torch.int64)
        rates = table[torch.clamp(flags, 0, len(TCOST_RATES) - 1)]
        if self.tcost_scale is not None:
            rates = rates * knob(self.tcost_scale, rates, ndim=3)
        return rates
