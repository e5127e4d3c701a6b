"""Framework-neutral ShardCombine core (reference: easydist/metashard/).

The conceptual heart of the framework: discover per-operator SPMD sharding
rules by *executing* the op with sharded inputs and checking whether the
sharded outputs recombine into the global output.
"""

from .annotation import DimSharding, ShardSpace, HaloSpec  # noqa: F401
from .combination import Recombine, Reduction, match_recombine, HaloHint  # noqa: F401
from .metaop import MetaOp  # noqa: F401
from .view_propagation import view_rule, view_rule_for_space  # noqa: F401
