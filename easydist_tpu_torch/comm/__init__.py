"""Gradient collectives of the manual parallel modes and the solver's
reduction fences: the port of easydist_tpu/comm/.

  quant.py     block-scaled int8 and bf16 reductions over a process group
  bucketer.py  fixed-size gradient buckets grouped by (dtype, quantize)
  reduce.py    the gradient entry points (DDP tree reduce, ZeRO leaf
               all_reduce / reduce_scatter) and the fences of the
               emitted programs
  overlap.py   emission-ordered flushes issued from the backward, and
               K-microbatch accumulation (sequential or overlapped)
  counters.py  bytes / launch accounting with the ring closed forms
"""

from .bucketer import (Bucket, bucketed_reduce, pack,  # noqa: F401
                       plan_buckets, unpack)
from .counters import (CommCounters, comm_counters,  # noqa: F401
                       ring_all_gather_bytes, ring_all_reduce_bytes,
                       ring_reduce_scatter_bytes)
from .overlap import (accumulate_gradients, chain_leaf_reduces,  # noqa: F401
                      grad_emission_order, issue_tree,
                      overlapped_leaf_grads, overlapped_reduce_gradients,
                      overlapped_value_and_grad,
                      schedulable_overlap_fraction)
from .quant import (bf16_psum, bf16_psum_scatter, comm_enabled,  # noqa: F401
                    dequantize_blockwise, int8_payload_bytes,
                    int8_wire_bytes, leaf_quantizable, quant_mode,
                    quantize_blockwise, quantized_psum,
                    quantized_psum_scatter)
from .reduce import (all_gather_dim0, all_reduce_grad,  # noqa: F401
                     all_reduce_sum, fence_plan, fence_psum,
                     fence_psum_scatter, group_name, issue_bucket,
                     keyed_leaves, reduce_bucket_collective,
                     reduce_gradients, reduce_scatter_grad,
                     reduce_scatter_sum, wire_bytes)
