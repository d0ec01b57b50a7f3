"""The box/L1 QP solver and the MVO leg constraints."""

from factormodeling_tpu_torch.solvers.admm_qp import (ADMMResult,
                                                      ADMMWarmState,
                                                      BoxQPProblem,
                                                      admm_solve_dense,
                                                      admm_solve_lowrank)
from factormodeling_tpu_torch.solvers.portfolio import (equal_leg_fallback,
                                                        leg_constraints,
                                                        legs_feasible)

__all__ = ["ADMMResult", "ADMMWarmState", "BoxQPProblem", "admm_solve_dense",
           "admm_solve_lowrank", "equal_leg_fallback", "leg_constraints",
           "legs_feasible"]
