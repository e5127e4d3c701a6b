"""Runtime services of the port: the persistent op-performance store and
the measured op times the solver reads."""

from .perfdb import PerfDB  # noqa: F401
from .op_profile import backend_key, load_op_times  # noqa: F401
