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
from factormodeling_tpu_torch.backtest.mvo import (mvo_turnover_weights,
                                                   mvo_weights)
from factormodeling_tpu_torch.backtest.pnl import (DailyResult,
                                                   daily_portfolio_returns,
                                                   signal_metrics)
from factormodeling_tpu_torch.backtest.settings import (TCOST_RATES,
                                                        SimulationSettings,
                                                        lane_knobs)
from factormodeling_tpu_torch.backtest.weights import (cap_and_redistribute,
                                                       equal_weights,
                                                       linear_weights,
                                                       normalize_legs)

__all__ = ["DailyResult", "SchemeStats", "SimulationOutput",
           "SimulationSettings", "SolverDiagnostics", "TCOST_RATES",
           "anderson_stats", "cap_and_redistribute", "check_anomalies",
           "daily_portfolio_returns", "daily_trade_list", "equal_weights",
           "lane_knobs", "linear_weights", "mvo_turnover_weights",
           "mvo_weights", "normalize_legs", "polish_stats", "run_simulation",
           "signal_metrics", "sweep_stats"]
