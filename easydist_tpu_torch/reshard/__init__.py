"""Portable chunked tensor redistribution (arXiv:2112.01075): the port of
easydist_tpu/reshard.

One substrate for restoring a checkpoint onto another world size
(`reshard.restore` + runtime/checkpoint.py) and for moving a live tensor
between two (mesh, spec) layouts (`redistribute`), with a host gather
for export (`fetch_chunked`).  Every plan keeps a rank's live bytes
within O(max(src_shard, dst_shard) + chunk), never the global tensor.
"""

from .exec import ReshardOOMError, fetch_chunked, redistribute
from .plan import (HOST, ChunkOp, MeshDesc, ReshardPlan, chunk_spans,
                   chunk_waves, device_windows, normalize_spec,
                   plan_redistribute, sharding_desc, state_fingerprint,
                   topology_shifted)
from .restore import RestorePlan, plan_restore

__all__ = [
    "HOST", "ChunkOp", "MeshDesc", "ReshardPlan", "RestorePlan",
    "ReshardOOMError", "chunk_spans", "chunk_waves", "device_windows",
    "fetch_chunked", "normalize_spec", "plan_redistribute",
    "plan_restore", "redistribute", "sharding_desc", "state_fingerprint",
    "topology_shifted",
]
