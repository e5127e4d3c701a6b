"""`easydist_tpu_torch.resilience`: the port of easydist_tpu/resilience/.

  faultinject   named fault points + `arm()` / `fault_plan()` schedules;
                zero-overhead no-ops when disarmed
  breaker       serving circuit breaker (consecutive-failure / p99 trips)
  guard         NaN/Inf skip-and-hold step guard with a skip budget
  preempt       SIGTERM -> flag -> final checkpoint -> PreemptedError
"""

from . import faultinject  # noqa: F401
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker  # noqa: F401
from .faultinject import (FAULT_POINTS, FaultPlanError,  # noqa: F401
                          InjectedFault, fault_plan)
from .guard import (GuardBudgetExceededError, GuardedStep,  # noqa: F401
                    all_finite, guard_train_step, init_guard_state,
                    poison_batch)
from .preempt import PreemptedError, PreemptionHandler  # noqa: F401

__all__ = ["faultinject", "FAULT_POINTS", "FaultPlanError", "InjectedFault",
           "fault_plan", "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
           "GuardBudgetExceededError", "GuardedStep", "all_finite",
           "guard_train_step", "init_guard_state", "poison_batch",
           "PreemptedError", "PreemptionHandler"]
