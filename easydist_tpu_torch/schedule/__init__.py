"""Memory planning (reference: easydist/torch/schedule/): buffer lifetimes
over the MetaGraph's op schedule under the solved placements, a skyline
packing that bounds what any allocator could achieve, and a
lifetime-overlap validator.  The loops run in the native C++ planner
(easydist_tpu_torch/native)."""

from .memory_planner import plan_graph_memory, MemoryPlan  # noqa: F401
