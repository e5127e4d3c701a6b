"""`easydist_tpu_torch.resilience`: the fault-injection harness and the
serving circuit breaker (port of the serving half of
easydist_tpu/resilience/; the training guard and the preemption handler
are not ported yet).

  faultinject   named fault points + `arm()` / `fault_plan()` schedules;
                zero-overhead no-ops when disarmed
  breaker       serving circuit breaker (consecutive-failure / p99 trips)
"""

from . import faultinject  # noqa: F401
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker  # noqa: F401
from .faultinject import (FAULT_POINTS, FaultPlanError,  # noqa: F401
                          InjectedFault, fault_plan)

__all__ = ["faultinject", "FAULT_POINTS", "FaultPlanError", "InjectedFault",
           "fault_plan", "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]
