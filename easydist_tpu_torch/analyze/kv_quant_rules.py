"""Layer 13: quantized/tiered-KV sanitizer (the port of
easydist_tpu/analyze/kv_quant_rules.py).

The block-scaled int8 KV arena (`ops.kv_quantize` / `kv_dequantize`, the
GPT and llama paged forwards) and the host memory tier (kv/tier.py) both
fail the same way the paged layout does: silently.  A payload page whose
scales went missing dequantizes into garbage; a decode program that
forgot the dequant computes logits on raw int8 codes; a host-tier entry
whose bytes rotted serves a corrupt prefix to every request sharing it.
Three audits:

  * KVQ001 `audit_quant_arena` — structural payload/scale consistency
    over a live arena dict: an int8 payload implies a float32 scale leaf
    whose shape is the payload's with the feature axis divided into
    blocks; scale leaves over a non-int8 payload are equally a desync;
  * KVQ002 `audit_quant_program` — a lint over the traced paged step: no
    matmul (`aten.mm` / `bmm` / `matmul` / `einsum` / `baddbmm` /
    `addmm`) or SDPA may consume an int8 operand.  The paged quant decode
    kernel (B6's custom op) is exempt: it dequantizes on chip, as the
    Pallas call is exempt in the JAX package;
  * KVQ003 `audit_tier_roundtrip` — wraps `HostTier.check_invariants`
    (per-entry sha256 manifest re-verification + byte accounting).
"""

from __future__ import annotations

from typing import List

import torch

from .findings import Finding, make_finding

_MATMUL_NAMES = (
    "mm", "bmm", "matmul", "einsum", "baddbmm", "addmm", "addbmm", "dot",
    "mv", "scaled_dot_product_attention",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    "_scaled_dot_product_cudnn_attention")
_MATMULS = {getattr(torch.ops.aten, n).default for n in _MATMUL_NAMES
            if hasattr(torch.ops.aten, n)}


def audit_quant_arena(arena, node: str = "kv.quant") -> List[Finding]:
    """KVQ001 over an arena dict ({"k","v"[,"k_scale","v_scale"]})."""
    findings: List[Finding] = []
    for name in ("k", "v"):
        payload = arena.get(name)
        if payload is None:
            findings.append(make_finding(
                "KVQ001", node, f"arena has no {name!r} payload leaf"))
            continue
        scales = arena.get(f"{name}_scale")
        quantized = payload.dtype == torch.int8
        if quantized and scales is None:
            findings.append(make_finding(
                "KVQ001", node,
                f"{name!r} payload is int8 but the arena carries no "
                f"{name}_scale leaf — pages cannot be dequantized"))
            continue
        if not quantized and scales is not None:
            findings.append(make_finding(
                "KVQ001", node,
                f"arena carries {name}_scale over a {payload.dtype} "
                f"payload — the exact path must stay scale-free"))
            continue
        if not quantized:
            continue
        if scales.dtype != torch.float32:
            findings.append(make_finding(
                "KVQ001", node,
                f"{name}_scale dtype is {scales.dtype}, expected float32"))
        d = int(payload.shape[-1])
        nb = int(scales.shape[-1])
        if tuple(scales.shape[:-1]) != tuple(payload.shape[:-1]) \
                or nb < 1 or d % nb != 0:
            findings.append(make_finding(
                "KVQ001", node,
                f"{name}_scale shape {tuple(scales.shape)} does not "
                f"block-partition payload shape {tuple(payload.shape)} "
                f"(leading dims must match; head_dim {d} must divide "
                f"into {nb} blocks) — dequant would broadcast scales "
                f"onto the wrong pages"))
    return findings


def int8_matmul_operands(gm) -> List[str]:
    """Descriptions of every matmul / SDPA node of `gm` (a GraphModule or
    fx Graph whose nodes carry `meta["val"]`) consuming an int8 operand."""
    graph = getattr(gm, "graph", gm)
    hits: List[str] = []
    for n in graph.nodes:
        if n.op != "call_function" or n.target not in _MATMULS:
            continue
        for i, a in enumerate(n.all_input_nodes):
            v = a.meta.get("val")
            if isinstance(v, torch.Tensor) and v.dtype == torch.int8:
                hits.append(f"{n.target} ({n.name}) operand {i} has dtype "
                            f"int8 (shape {tuple(v.shape)})")
    return hits


def audit_quant_program(result, node: str = "decode.quant") -> List[Finding]:
    """KVQ002 over a compiled paged step (a `CompileResult`, or a
    GraphModule): int8 K/V reaching a matmul without dequantization."""
    gm = getattr(result, "traced", result)
    return [make_finding(
        "KVQ002", node,
        f"{hit} — int8 K/V reached attention without dequantization "
        f"(kv_dequantize / the quant kernel's in-loop scale multiply "
        f"must run before the score matmul)")
        for hit in int8_matmul_operands(gm)]


def audit_tier_roundtrip(tier, node: str = "kv.tier") -> List[Finding]:
    """KVQ003 over a live `HostTier`: re-verify every entry's sha256
    manifest and the byte accounting."""
    return [make_finding("KVQ003", node, problem)
            for problem in tier.check_invariants()]
