"""Measured per-op runtime costs feeding the solver: the read half
(reference: the on-device per-node profiling pass + persistent DB,
easydist/torch/passes/runtime_prof.py:35-150 and
utils/graph_profile_db.py:24-48).

The PerfDB holds median seconds per op signature under `backend_key()`;
`SpmdSolver` prices compute redundancy with the measured time wherever a
node's signature hits and with its roofline proxy otherwise.  The write
half (profiling every op of a traced step on the card) keys ops by the
aten node's signature and comes with the multi-device frontend.
"""

from __future__ import annotations

from typing import Dict

OP_TIMES_KEY = "op_times"


def backend_key() -> str:
    return f"{OP_TIMES_KEY}:cuda"


def load_op_times() -> Dict[str, float]:
    """All measured op times for the card ({signature: s})."""
    from .perfdb import PerfDB

    try:
        return dict(PerfDB().snapshot().get(backend_key(), {}))
    except Exception:
        return {}
