"""Backtest engine: settings, weight schemes, P&L and diagnostics."""

from factormodeling_tpu_torch.backtest.diagnostics import (SchemeStats,
                                                           SolverDiagnostics)
from factormodeling_tpu_torch.backtest.engine import (SimulationOutput,
                                                      daily_trade_list,
                                                      run_simulation)
from factormodeling_tpu_torch.backtest.pnl import (DailyResult,
                                                   daily_portfolio_returns)
from factormodeling_tpu_torch.backtest.settings import (TCOST_RATES,
                                                        SimulationSettings)

__all__ = ["DailyResult", "SchemeStats", "SimulationOutput",
           "SimulationSettings", "SolverDiagnostics", "TCOST_RATES",
           "daily_portfolio_returns", "daily_trade_list", "run_simulation"]
