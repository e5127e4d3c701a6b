"""Runtime services of the port: the persistent op-performance store,
measured op times, checkpoints, the elastic training loop and its token
loader, profiling and calibration.

  perfdb / op_profile   the PerfDB and the per-node CUDA-event times
  checkpoint            atomic save / verify / restore
  data                  `TokenLoader` over the native prefetching loader
  elastic               `run_training`, `DataStallError`,
                        `multihost_setup`
  profiler              cost and memory analysis, `profile_compiled`,
                        `measure_collective_overlap`
  calibrate             datasheet constants and measured alpha / beta
"""

from .perfdb import PerfDB  # noqa: F401
from .op_profile import backend_key, load_op_times  # noqa: F401
