"""Parallel attention programs over a DeviceMesh axis: the port of
easydist_tpu/parallel/{ring_attention,ulysses}.py.  The other parallel
modes (data parallel, ZeRO, pipelines, MoE) are not ported yet."""

from .ring_attention import ring_attention, ring_attention_local
from .ulysses import ulysses_attention, ulysses_attention_local

__all__ = ["ring_attention", "ring_attention_local", "ulysses_attention",
           "ulysses_attention_local"]
