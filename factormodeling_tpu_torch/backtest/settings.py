"""Simulation settings (port of ``factormodeling_tpu/backtest/settings.py``).

Market data panels are dense ``[D, N]`` tensors plus an optional universe
mask; every knob keeps the JAX package's name, default and validation (see
that module for the rationale behind each default). The fields stay even
where the port has not implemented the option yet: the engine raises
``NotImplementedError`` for those (``method="mvo"``,
``covariance="risk_model"``, ``turnover_mode="parallel"``,
``qp_anderson > 0``, a ``degrade`` policy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SimulationSettings", "TCOST_RATES"]

# per-cap-tier one-way transaction-cost rates; index = cap_flag 0..3
TCOST_RATES = (0.0, 0.0025, 0.0015, 0.0010)


@dataclasses.dataclass(frozen=True)
class SimulationSettings:
    # market data (dense panels)
    returns: torch.Tensor              # float[D, N] daily log-returns
    cap_flag: torch.Tensor             # float/int[D, N] cap tier 1/2/3
    investability_flag: torch.Tensor   # float[D, N] 0/1 (NaN allowed)
    universe: torch.Tensor | None = None  # bool[D, N] membership
    degrade: object | None = None      # resilience policy (not ported)

    # simulation parameters
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

    def __post_init__(self):
        if self.method not in ("equal", "linear", "mvo", "mvo_turnover"):
            raise ValueError(f"Unknown method {self.method}")
        if self.covariance not in ("sample", "risk_model"):
            raise ValueError(f"Unknown covariance {self.covariance}")
        if self.turnover_mode not in ("scan", "parallel"):
            raise ValueError(f"Unknown turnover_mode {self.turnover_mode}")
        if self.solver_kernel not in ("reference", "fused"):
            raise ValueError(f"Unknown solver_kernel {self.solver_kernel}")
        if self.qp_anderson < 0:
            raise ValueError(
                f"qp_anderson must be >= 0 (0 disables), got {self.qp_anderson}")
        if isinstance(self.tcost_scale, (int, float, np.floating, np.integer)) \
                and self.tcost_scale < 0:
            raise ValueError(
                f"tcost_scale must be >= 0 (None disables), got "
                f"{self.tcost_scale}")

    def cost_rates(self) -> torch.Tensor:
        """Per-cell one-way cost rates from the cap tier (missing tier -> 0),
        rescaled by ``tcost_scale`` when one is set."""
        table = torch.as_tensor(TCOST_RATES, dtype=self.returns.dtype).to(
            self.returns.device)
        flags = torch.nan_to_num(self.cap_flag.to(self.returns.dtype)).to(torch.int64)
        rates = table[torch.clamp(flags, 0, len(TCOST_RATES) - 1)]
        if self.tcost_scale is not None:
            rates = rates * self.tcost_scale
        return rates
