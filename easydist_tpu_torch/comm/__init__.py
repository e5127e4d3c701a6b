"""Gradient collectives of the manual parallel modes: the port of
easydist_tpu/comm/, default path only.

  reduce.py    the gradient entry points (DDP tree reduce, ZeRO leaf
               all_reduce / reduce_scatter) as functional collectives
  overlap.py   K-microbatch gradient accumulation (sequential fold)
  counters.py  bytes / launch accounting with the ring closed forms

Quantized, bucketed and overlapped reduction (`quant.py`, `bucketer.py`,
the overlapped flush) come with ROADMAP queue A item 7; their knobs
raise NotImplementedError.
"""

from .counters import (CommCounters, comm_counters,  # noqa: F401
                       ring_all_gather_bytes, ring_all_reduce_bytes,
                       ring_reduce_scatter_bytes)
from .overlap import accumulate_gradients  # noqa: F401
from .reduce import (all_gather_dim0, all_reduce_grad,  # noqa: F401
                     all_reduce_sum, check_comm_knobs, group_name,
                     reduce_gradients, reduce_scatter_grad,
                     reduce_scatter_sum)
