"""Memory planning (reference: easydist/torch/schedule/): buffer lifetimes
over the MetaGraph's op schedule under the solved placements, a skyline
packing that bounds what any allocator could achieve, and a
lifetime-overlap validator.  The loops run in the native C++ planner
(easydist_tpu_torch/native).  `remat.py` plans and applies
compiler-chosen rematerialization over a traced FX program under a
memory cap."""

from .memory_planner import plan_graph_memory, MemoryPlan  # noqa: F401
from .remat import (RematPlan, apply_remat, plan_remat,  # noqa: F401
                    resolve_memory_cap)
