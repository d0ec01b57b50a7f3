"""Backtest engine: settings, weight schemes, P&L and diagnostics."""

from factormodeling_tpu_torch.backtest.diagnostics import (SchemeStats,
                                                           SolverDiagnostics,
                                                           anderson_stats,
                                                           check_anomalies,
                                                           polish_stats,
                                                           sweep_stats)
from factormodeling_tpu_torch.backtest.engine import (SimulationOutput,
                                                      daily_trade_list,
                                                      run_simulation)
from factormodeling_tpu_torch.backtest.pnl import (DailyResult,
                                                   daily_portfolio_returns,
                                                   signal_metrics)
from factormodeling_tpu_torch.backtest.settings import (TCOST_RATES,
                                                        SimulationSettings,
                                                        lane_knobs)

__all__ = ["DailyResult", "SchemeStats", "SimulationOutput",
           "SimulationSettings", "SolverDiagnostics", "TCOST_RATES",
           "anderson_stats", "check_anomalies", "daily_portfolio_returns",
           "daily_trade_list", "lane_knobs", "polish_stats",
           "run_simulation",
           "signal_metrics", "sweep_stats"]
