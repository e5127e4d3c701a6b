"""Manual parallelism: the port of easydist_tpu/parallel/.

Each mode runs as one program per rank over a DeviceMesh axis's process
group: functional collectives for data parallel and ZeRO (`dp`), the
ring's permutes and Ulysses' all_to_alls for attention across ranks
(`ring_attention`, `ulysses`), P2P between neighbouring stages for the
pipelines (`pipeline`, `auto_pipeline`), all_to_all on the expert axis
for mixture-of-experts (`moe`).
"""

from .auto_pipeline import pipeline_forward, split_point
from .dp import (ddp_step, dp_state_layout, zero2_step, zero3_step,
                 zero_shard_params)
from .pipeline import (LocalStages, PipelineConfig, spmd_pipeline,
                       spmd_pipeline_grad)
from .ring_attention import ring_attention, ring_attention_local
from .ulysses import ulysses_attention, ulysses_attention_local

__all__ = ["LocalStages", "PipelineConfig", "ddp_step", "dp_state_layout",
           "pipeline_forward",
           "ring_attention", "ring_attention_local", "split_point",
           "spmd_pipeline", "spmd_pipeline_grad", "ulysses_attention",
           "ulysses_attention_local", "zero2_step", "zero3_step",
           "zero_shard_params"]
