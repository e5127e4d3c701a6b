"""Auto-parallel strategy solver (reference: easydist/autoflow/)."""

from .cost_model import MeshAxisSpec, resharding_cost, placement_bytes  # noqa: F401
from .solver import SpmdSolver  # noqa: F401
