#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`easydist_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each raising on failure (exit code != 0, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA kernel from `csrc/`, one nvcc per source, all
     started together; ptxas's register and spill report, which must
     show no spills for the tensor-core kernels and B4-B6;
  3. each kernel against its plain PyTorch version on the card: the
     decode kernel (B4) at the serving shape, with head_dim 128, lengths
     around the split boundaries, a cache length that is no multiple of
     the split and a non-default block_k, then two launches that must be
     bitwise equal and leave every arrival counter at 0; the paged
     decode kernels (B5 exact pages, B6 int8 pages) at the paged serving
     shape, with a GQA case, head_dim 128 and lengths around the split
     boundaries; the training kernels (B1 forward, B2 dQ, B3 dK/dV) at
     the training shape; in float32 and bfloat16, with times of the
     kernel (CUDA events, and device time per launch from
     torch.profiler), the plain version, one library call (SDPA, a
     yardstick only; B4's also by the profiler) and the card's least
     possible time (bound).  B1-B3 have two routes: bfloat16 runs
     the bf16 tensor-core kernels (their times fill the kernels line),
     float32 the three-product TF32 tensor-core kernels, whose times are
     printed on lines of their own and added to the entries.  One line
     per dtype holds the B2 + B3 pair against SDPA's whole backward (the
     one library call that computes dQ, dK and dV), and its times go
     into both entries;
  4. serving: GPT-2 small at full width (random weights from a seeded
     generator) through `GenerationSession.for_gpt`, bucketed layout.
     In float32 every request's greedy ids must equal the uncached
     re-forward through `gpt_apply`, one decode signature must serve
     all, the prefix cache must hit, and B4 must have launched 12 x
     decode rounds.  A bfloat16 run of the same traffic must finish with
     finite logits; its tokens/s, id agreement with float32 and a
     profiled decode window are printed;
  5. paged serving: the same weights, traffic and config with
     kv_layout="paged".  In float32 the ids must equal the uncached
     re-forward and the bucketed ids, one decode and one prefill
     signature must serve all, prefix restores must map pages instead
     of copying them, B5 must launch 12 x rounds (B4 never), and the
     page-table audit must be clean after the drain; then bfloat16 as in
     phase 4;
  6. int8 paged serving (kv_quant_dtype="int8", float32): an int8 arena
     with f32 scales, B6 launched 12 x rounds, identical ids on a rerun,
     `kv_quant_bytes_saved` > 0, and the teacher-forced logit drift
     against the exact paged arm within 0.25 x the logit spread;
  7. training: GPT-2 small at full width (vocab 50304, batch 8, seq
     1024, Adam lr 1e-4) through `make_gpt_train_step` and
     `fxfront.easydist_compile`.  In float32 with flash attention, 3
     compiled steps must match 3 uncompiled steps from the same state
     at rtol 1e-4, from one compiled signature, with B1, B2 and B3 each
     launched 12 x 3 times; then one more compiled step under
     torch.profiler (device busy, B1-B3's share).  In bfloat16, 4 flash
     steps must stay
     within 2e-2 (relative) of 4 einsum steps from the same weights, with
     B1, B2 and B3 each launched 12 x 4 times in those flash steps (on
     their tensor-core route).
     Then profiled bfloat16 steps: ms per step, tokens/s, device busy
     share, top kernels, peak memory, trace time, the einsum step;
  8. the sharding engine (no kernel of its own): (a) the 17 ops of the
     platform micro-API on CUDA tensors against the numpy backend
     (`BACKEND_CASES`); (b) ShardCombine discovery
     (`MetaOp.discover()`, float32, TF32 off) on the aten ops a GPT-2
     small train step spends its time in, at full width (batch 8, seq
     1024, dim 768, 12 heads, vocab 50304), inputs uniform [0.5, 1.5];
     every rule must equal the literal table `GPT2_SMALL_RULES` (the CPU
     tests hold the same table against the JAX package), and each op's
     seconds and probe calls are printed, on the CPU as well for the ops
     under `config.discovery_hint_numel`; (c) on the card's host, one
     GPT-2 MLP block (x -> c_fc -> gelu -> c_proj -> residual) wired
     from (b)'s rules and solved for a virtual NVLink axis of 4 and of
     8: the ILP and beam
     search must reach the same communication cost, the ILP the
     zero-communication batch sharding, and the memory plan must
     validate with the native library's peaks equal to Python's;
  9. the multi-device frontend on phase 7's f32 workload: every aten
     node of the step timed on the card (`profile_ops`, CUDA events)
     into a PerfDB that prices the solves; (a) against
     torch's fake process group of 8 ranks (structure only), compiled
     for a (8,) "dp" mesh and a (4, 2) "dp" x "tp" mesh of NVLink axes
     (trace, discovery on the card with the presets cross-checked on the
     first, per-axis ILP, per-rank emission): per axis, the collectives
     emitted must match what the solver priced, at least one mm must be
     sharded, nothing may replicate because discovery failed; seconds
     by stage, the analyzer's counts, the solver's cost per axis, the
     replicated-FLOPs fraction and the collectives by kind with their
     bytes are printed; (b) rank 0's (4, 2) program run once on the card
     (B1-B3 launched 12 times each; peak memory beside the planner's);
     (c) a real one-rank mesh on NCCL: 3 steps bitwise equal to phase
     7's compiled f32 losses.  One card cannot run a multi-rank program
     on NCCL: the CPU tests hold its numbers on gloo;
 10. attention across ranks (`attention_phase`): the attention
     composite's picks on phase 9's meshes and GPT-2 small at seq 8192
     on an (8,) "sp" mesh lowered to the ring, rank 0's and rank n-1's
     programs run on the card;
 11. speculative decoding (`spec_phase`, speculate_k=4, f32): phase 4's
     config and prompt lengths, each prompt ending with a repeat of its
     own 16-token span: (a) bucketed with the n-gram drafter, (b) paged
     with the n-gram drafter, (c) bucketed with the target as its own
     draft model.  Ids must equal the uncached re-forward and a plain
     session's; verify rounds must run, with one verify signature; B4
     (a, c) / B5 (b) must launch 12 x the plain decode rounds (plus the
     drafter's feeds in c, every proposal accepted); the page-table
     audit runs after every paged rollback and no page leaks; bf16
     tokens/s with and without speculation are printed;
 12. the host tier and the session lifecycle (`tier_phase`, paged, f32
     and int8): a 32-page arena with a 256 MiB host tier under three
     waves (8 prompts sharing a 512-token prefix, 8 without, the first 8
     again): demotions and promotions, each promoted page bitwise equal
     to its export before demotion, ids equal to the uncached
     re-forward, the corrupt-fetch drill; `drain()`'s hot pages imported
     by a fresh session, and `evacuate()` resumed elsewhere, both with
     equal ids;
 13. `ServeEngine` (`engine_phase`) over `gpt_apply` with flash attention
     (B1), compiled with the params as state and warmed over 3 x 2
     buckets: 6 client threads x 4 requests, every result within rtol
     1e-4 / atol 1e-5 of the request alone, B1 launched 12 x the
     batches; the deadline, OOM-bucket and watchdog drills;
 14. the manual parallel modes (`pipeline_phase`) on GPT-2 small's f32
     flash workload (TF32 off): (a) `make_gpt_pipeline_step` with 4
     stages of 3 blocks chained on the card (`LocalStages(4)`, 1f1b,
     batch 8 as 4 microbatches of 2): the loss and every gradient equal
     the one-device ones at rtol 1e-4 / atol 1e-5; (b) one step of each
     rank's program on fake groups, gpipe / remat / 1f1b on (4,) "pp"
     (M=8) and 1f1b with n_virtual=2 on (2,) "pp": P2P messages and
     bytes, and B1-B3 launches, equal what the tables and the rank's
     blocks give; rank 0's peak at M=16 lower under 1f1b than gpipe;
     (c) `easydist_compile(pp_stages=4)` of the loss on (4, 2) "pp" x
     "dp" (fake group of 8): the split equals the CPU's trace of the
     same graph, each stage's launches its flash nodes x M, one packed
     row all_gather and one reduce_scatter a step of the row's bytes;
     (d) ddp / zero2 / zero3 rank 0 on (8,) "dp" (fake group of 8): B1-B3
     12 launches each, collectives by kind (zero3: the forward's gather
     of every leaf and the backward's of the weights, norm scales and
     wte it reads) and state bytes equal to the leaves' formulas,
     zero3's peak below zero2's; a one-rank NCCL mesh
     per mode within rtol 1e-4 of the step written eagerly; (e) MoE at
     d_model 768 / d_ff 3072, 16 experts, top-1 and top-2, 8 x 1024
     tokens on (8,) "ep": rank 0's all_to_all bytes equal the capacity
     formula; on a one-rank NCCL mesh one rank's 1024 tokens equal
     `moe_reference` at rtol 1e-4 / atol 1e-5;
 15. the rest of the parallel modes and sessions over a mesh
     (`tail_phase`), on phase 14's f32 flash workload (TF32 off, batch
     8): (a) the one-device train step uncapped and under a cap midway
     between the planner's floor (its plan at a cap of 1 byte) and the
     uncapped model peak: a plan with base peak > cap >= planned peak,
     the capped step's measured peak (above its inputs) below the
     uncapped one and, with its inputs, within the cap the user gave,
     the 3 losses equal at rtol 1e-5, B1-B3 12 launches a step in both;
     rank 0 of (8,) "dp" (fake group of 8) capped the same way: a plan,
     emitted collectives equal the priced ones; (b) GPTConfig(remat=)
     "none", "full", "dots" and "full" with scan_layers: losses equal
     none's at rtol 1e-5, the stacked layout bitwise the list layout,
     B1 24 launches a step under "full" and "dots" (B2, B3 12), their
     peaks below none's; the remat'd step's collectives on (8,) "dp"
     equal its twin's (einsum attention, as the JAX test); (c) easydist_compile(pp_stages=2, tp_axes=("tp",),
     n_microbatches=4) of the loss on (2, 2, 2) "pp" x "dp" x "tp" (fake
     group of 8), ranks 0 and 4: the tp plan shards, each rank's tp
     collectives equal its plan's conversions x M, B1-B3 launches equal
     its stage's flash nodes x M, rank 0's peak below the same loss
     without tp_axes on (2, 2) "pp" x "dp"; (d) phase 4's bucketed and
     paged f32 sessions on a one-rank NCCL (1,) "tp" mesh: ids equal the
     one-device session's and the uncached re-forward, B4 / B5 12 x
     decode rounds; rank 0's decode programs on (2,) "tp" (fake group of
     2): the cache placement picked, emitted collectives equal the
     priced ones;
 16. comm, runtime and resilience (`runtime_phase`) on phase 14's f32
     flash workload (TF32 off, batch 8): (a) ddp / zero2 / zero3 rank 0
     on (8,) "dp" (fake group of 8) under int8 (block 256, 1 MiB
     buckets), bf16 and the overlapped flush (256 KiB buckets, no
     quantization): collectives by kind, the counters' wire bytes and
     quantized launches equal the closed forms over the bucket plan, the
     quantizable leaves are wte, wpe and four weight matrices a block,
     the overlapped step's first collective comes before its last
     backward product and its schedulable overlap is > 0; on a one-rank
     NCCL mesh the int8 and overlapped losses are bitwise the exact
     ones; (b) easydist_compile(mesh=) of the train step on (8,) "dp"
     under int8: emitted collectives equal the priced ones in kind,
     count and wire bytes, and rank 0's program sends at run time what
     was priced; (c) `run_training` on the card over a 2^24-token file
     read by `TokenLoader`, the compiled step (donate_state=False) with
     the guard on, 6 steps, checkpoints every 2 (1.49 GB of params and
     Adam each, keep 2): B1-B3 12 launches a step; SIGTERM at step 4
     resumed bitwise with no batch drawn twice, a torn write invisible,
     a corrupt committed step and a corrupt checkpoint found at restore
     falling back and ending bitwise, a NaN loss scale holding the state
     bitwise with one skip, a data stall raising `DataStallError`;
     save / restore seconds and GB/s, the sha256 share, the guard's and
     the loader's ms; (d) the step's FLOPs beside 6 N T, its modeled
     memory peak beside the measured one, the card's datasheet row;
 17. a Llama at Llama-3-8B's published widths and full depth (`llama_phase`;
     vocab 128256, dim 4096, 32 query heads over 8 KV heads at head_dim
     128, ffn 14336, 32 layers, rope_theta 500000; random f32 weights from
     a seeded generator) through `GenerationSession.for_llama` on phase
     4's traffic and config: (a) bucketed f32, ids equal the
     teacher-forced `llama_apply` reference, B4 32 x rounds; (b) paged
     f32, ids equal (a)'s, B5 32 x rounds, the audit clean; (c) int8
     pages, B6 32 x rounds, identical rerun, drift within 0.25 x spread;
     (d) bf16 on both layouts with profiled decode windows and the GQA
     repeat's ms; (e) speculate_k=4 on both layouts, with a 2-layer llama
     drafter and with the target drafting for itself (drafts accepted),
     ids equal (a)'s; (f) `make_llama_train_step` with 2 layers,
     batch 2, seq 1024: compiled equals uncompiled at rtol 1e-4.  Phase 3
     holds B4-B6 at this decode shape (B4 on the repeated caches
     [8,32,1024,128], B5 / B6 over pages [144,8,64,128]) in f32 and bf16;
 18. restore across a topology change (`reshard_phase`): phase 16's
     GPT-2 small f32 Adam state saved by gloo CPU ranks spawned from the
     script (zero2 on 4, zero3 on 2), restored on the card as one rank:
     bitwise the one-device state of the same seed, the memory above the
     restored state within the plan's chunked bound; the
     `elastic.restore.oom` drill halves the chunk and stays bitwise;
 19. a `{"kernels": [...]}` line (B1-B6, each with its launches in its
     path's run; B4-B6 also with `llama` (phase 3's Llama-shape checks
     and times) and `launches_llama` (17a-c), B4 and B5 with
     `launches_llama_spec` (17e); B1-B3 also with `launches_bf16`,
     their launches in the
     bfloat16 flash steps; B1 with `launches_engine` (phase 13), B4 and
     B5 with `launches_spec` (phase 11 a and b), B5 and B6 with
     `launches_tier` (phase 12); B1-B3 with `launches_pp`, per schedule
     a list by rank (14b, and "compile" for 14c's stages), and
     `launches_dp`, per mode (14d); B1-B3 with `launches_remat`, by run
     of 15a and 15b, and `launches_pp_tp`, by rank of 15c; B4 and B5 with
     `launches_mesh` (15d); B1-B3 with `launches_runtime`, their launches
     in 16c's uninterrupted run), then the `{"ok": true, ...}` line.

Each serving run sets every decode kernel's launch count to 0 just
before it and reads the counts just after; launches made to compare or
time a kernel are not counted.

Needs a CUDA device and the repository around it; imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SERVE_SHAPE = (8, 12, 1024, 64)          # slots, heads, bucket, head_dim
TRAIN_SHAPE = (8, 12, 1024, 64)          # batch, heads, seq, head_dim
# one ring block of phase 10b: GPT-2 small's heads at seq 8192 over 8 ranks
SHARD_SHAPE = (1, 12, 1024, 64)
HBM_BYTES_PER_S = 3.35e12                # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12                  # H100 SXM, float32 off the tensor cores
TF32_FLOPS_PER_S = 495e12                # H100 SXM, TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12                # H100 SXM, bf16 tensor cores, dense
TIMED_COPIES = 4                         # input copies rotated past the 50 MB L2
KERNEL_SOURCES = ("flash_decode", "paged_decode", "flash_attn_fwd",
                  "flash_attn_bwd")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_kernels():
    """Every source under csrc/, one nvcc each, all started together."""
    from easydist_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = list(pool.map(_build.build, KERNEL_SOURCES))
    secs = time.perf_counter() - t0
    spills = {}
    for name, lib in zip(KERNEL_SOURCES, libs):
        print(f"build: {name}.cu -> {lib.name}")
        log = lib.with_suffix(".log")
        if log.exists():
            text = log.read_text()
            print(text.strip())
            spills.update(ptxas_spills(text))
    print(f"build: {len(libs)} sources in {secs:.2f} s; functions that "
          f"spill: {spills or 'none'}")
    bad = {fn: n for fn, n in spills.items()
           if any(k in fn for k in NO_SPILL_KERNELS)}
    if bad:
        raise AssertionError(f"ptxas spills in {bad}")


# kernels whose registers are planned to the last one: a spill is a fault
NO_SPILL_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
                    "flash_bwd_dkv_sm90_kernel", "flash_fwd_tf32_kernel",
                    "flash_bwd_dq_tf32_kernel", "flash_bwd_dkv_tf32_kernel",
                    "flash_decode_kernel", "paged_decode_kernel",
                    "paged_decode_quant_kernel")


def ptxas_spills(log: str):
    """{function: spill store + load bytes} for each function of a
    `ptxas -v` report that spills."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            n = int(m.group(1)) + int(m.group(2))
            if n:
                out[fn] = n
            fn = None
    return out


def time_ms(fn, n: int = 50) -> float:
    """Mean device time of `fn(i)` over n launches, by CUDA events."""
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def profiled_ms(fn, kernel: str, n: int = 20):
    """(ms, seen): device time per launch of the kernel whose name holds
    `kernel`, from torch.profiler over n calls of `fn(i)` (after a
    warm-up), and the number of its launches the profiler recorded.  The
    tracer may drop some launch records, so the time is averaged over the
    launches it saw; ms is None when it saw none.  The host's issue rate
    does not enter it."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and kernel in e.key]
    seen = sum(e.count for e in hits)
    if seen > n:
        raise AssertionError(f"profiler saw {seen} launches of {kernel!r} "
                             f"in {n} calls: {[e.key for e in hits]}")
    if seen == 0:
        return None, 0
    return sum(e.self_device_time_total for e in hits) / 1e3 / seen, seen


def profiled_call_ms(fn, n: int = 20) -> float:
    """Device time per call of `fn(i)`: the time of every kernel it
    launches, from torch.profiler over n calls (after a warm-up), over n.
    For a library call whose kernels are not ours to name."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n


def profiled_text(prof_ms, seen: int, n: int = 20) -> str:
    if prof_ms is None:
        return f"profiler: not measured (0 of {n} launches recorded)"
    return (f"profiler {prof_ms:.4f} ms per launch over {seen} of {n} "
            f"launches recorded")


def decode_bound_ms(lengths, shape, itemsize: int):
    """(ms, "bytes"|"operations"): the larger of the bytes the function
    must move — q and out once, lengths, and K and V up to each row's
    live length — over HBM rate, and its f32 operations (2*d for q.k and
    2*d for p.v per live key) over the card's f32 rate."""
    b, h, t, d = shape
    live = sum(min(int(x), t) for x in lengths)
    nbytes = 2 * b * h * d * itemsize + 4 * b + 2 * h * d * itemsize * live
    flops = 4 * h * d * live
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# lengths on both sides of the decode kernels' 256-token split
# boundaries, and an empty row (0 from the kernels, as from the TPU
# kernels; the plain version gives mean(v) there, so the comparison takes
# 0 for it); at head_dim 128, f32 (B4's cache, B5's pages) splits at 128
# tokens
SPLIT_LENGTHS = (0, 1, 255, 256, 257, 511, 513, 1024)
SPLIT_LENGTHS_128 = (0, 1, 127, 128, 129, 255, 257, 1024)


def decode_inputs(dev, rs, t: int, d: int, b: int = 8, h: int = 12):
    """f32 q [b, h, d] and k/v [b, h, t, d] on the card, from numpy."""
    return [torch.as_tensor(rs.standard_normal(s), dtype=torch.float32,
                            device=dev)
            for s in ((b, h, d), (b, h, t, d), (b, h, t, d))]


def kernel_phase(dev):
    """flash_decode (B4) vs `_decode_attention_xla` on the card, in f32
    and bf16: the serving shape, lengths around the split boundaries at
    head_dim 64 and 128, a cache of 1000 tokens (a partial last split)
    and block_k 100 (100-token splits); then two launches bitwise equal
    with every arrival counter back at 0.  Tolerances as B5's.  Returns
    the kernels-line entry (without `launches`)."""
    import torch.nn.functional as F

    from easydist_tpu_torch.ops import flash_attention as fa
    from easydist_tpu_torch.ops.flash_attention import (
        _decode_attention_xla, flash_decode_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, h, t, d = SERVE_SHAPE
    scale = 1.0 / np.sqrt(d)
    rs = np.random.RandomState(0)
    q32, k32, v32 = decode_inputs(dev, rs, t, d)
    inputs = {(t, d): (q32, k32, v32),
              (t, 128): decode_inputs(dev, rs, t, 128),
              (1000, d): decode_inputs(dev, rs, 1000, d)}
    # name -> (cache length, head_dim, lengths, block_k)
    cases = {
        "len 1": (t, d, [1] * b, None),
        "len 1024": (t, d, [t] * b, None),
        "len 300 (not a split multiple)": (t, d, [300] * b, None),
        "mixed": (t, d, [1, t, 300, 77, 513, 256, 999, 5], None),
        "splits": (t, d, SPLIT_LENGTHS, None),
        "splits d128": (t, 128, SPLIT_LENGTHS_128, None),
        "T 1000": (1000, d, [0, 1, 255, 256, 257, 743, 999, 1000], None),
        "block_k 100": (t, d, [0, 1, 99, 100, 101, 201, 999, 1024], 100),
    }
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        rounded = dtype == torch.bfloat16
        for name, (tk, dd, lens, block_k) in cases.items():
            q, k, v = (x.to(dtype) for x in inputs[tk, dd])
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = flash_decode_attention(q, k, v, L, block_k=block_k)
            torch.cuda.synchronize()
            # the plain version in float32 on the same (rounded) inputs
            ref = _decode_attention_xla(q.float(), k.float(), v.float(), L,
                                        1.0 / np.sqrt(dd))
            ref[L == 0] = 0.0
            err = check_close(f"flash_decode {str(dtype)[6:]:9s} {name}",
                              out, ref, 0.0, 1e-5, rounded)
            worst[dtype] = max(worst.get(dtype, 0.0), err)

    # determinism: the same call twice, bitwise equal, counters back at 0
    for dtype, dd, lens in ((torch.bfloat16, d, SPLIT_LENGTHS),
                            (torch.float32, 128, SPLIT_LENGTHS_128)):
        q, k, v = (x.to(dtype) for x in inputs[t, dd])
        L = torch.tensor(lens, dtype=torch.int32, device=dev)
        first = flash_decode_attention(q, k, v, L)
        again = flash_decode_attention(q, k, v, L)
        torch.cuda.synchronize()
        stale = sum(int(c.abs().sum()) for c in fa._SPLIT_COUNTERS.values())
        ok = torch.equal(first, again) and stale == 0
        print(f"kernel flash_decode {str(dtype)[6:]} d {dd} two launches "
              f"bitwise equal: {torch.equal(first, again)}; arrival "
              f"counters left non-zero: {stale} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_decode is not deterministic or "
                                 "left stale arrival counters")

    # times at the serving shape, bf16, every row at the full bucket
    lens = [t] * b
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < L[:, None])[:, None, None]
    q = q32.to(torch.bfloat16)
    ks = [torch.randn(b, h, t, d, device=dev, dtype=torch.bfloat16)
          for _ in range(TIMED_COPIES)]
    vs = [torch.randn(b, h, t, d, device=dev, dtype=torch.bfloat16)
          for _ in range(TIMED_COPIES)]
    launches_before = flash_decode_attention.launches
    kernel_ms = time_ms(lambda i: flash_decode_attention(
        q, ks[i % TIMED_COPIES], vs[i % TIMED_COPIES], L))
    plain_ms = time_ms(lambda i: _decode_attention_xla(
        q, ks[i % TIMED_COPIES], vs[i % TIMED_COPIES], L, scale))

    def library(i):
        return F.scaled_dot_product_attention(
            q[:, :, None], ks[i % TIMED_COPIES], vs[i % TIMED_COPIES],
            attn_mask=mask)

    library_ms = time_ms(library)
    library_prof_ms = profiled_call_ms(library)
    kernel_ms_2 = time_ms(lambda i: flash_decode_attention(
        q, ks[i % TIMED_COPIES], vs[i % TIMED_COPIES], L))
    prof_ms, seen = profiled_ms(lambda i: flash_decode_attention(
        q, ks[i % TIMED_COPIES], vs[i % TIMED_COPIES], L),
        "flash_decode_kernel")
    flash_decode_attention.launches = launches_before  # timing runs don't count
    bound_ms, bound_by = decode_bound_ms(lens, SERVE_SHAPE, 2)
    print(f"time flash_decode bf16 {list(SERVE_SHAPE)} lengths {t}: kernel "
          f"{kernel_ms:.4f} ms (again {kernel_ms_2:.4f}; "
          f"{profiled_text(prof_ms, seen)}), plain "
          f"{plain_ms:.4f} ms, library (SDPA, masked) {library_ms:.4f} ms "
          f"(profiler {library_prof_ms:.4f} ms a call), bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_decode", "route": "cuda",
            "source": "easydist_tpu_torch/ops/csrc/flash_decode.cu",
            "replaces": "easydist_tpu/ops/flash_attention.py:409",
            "shape": f"q [{b},{h},{d}] k/v {list(SERVE_SHAPE)} bfloat16, "
                     f"lengths {t}",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_f32": worst[torch.float32],
            "ms": kernel_ms, "kernel_ms": kernel_ms, "profiled_ms": prof_ms,
            "profiled_launches": seen,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_profiled_ms": library_prof_ms}


# ------------------------------------------------- paged decode B5, B6

# rows, heads, page_tokens, head_dim, max_pages, arena pages: the paged
# serving shape (8 slots; 1024 / 64 windows; the session's default arena
# of (8 + 1) x 16 pages)
PAGED_SHAPE = (8, 12, 64, 64, 16, 144)
# row 0 is dead: an all-sentinel table row at length 1, as the session's
# idle slots decode
PAGED_LENGTHS = (1, 1, 63, 64, 65, 300, 700, 1024)
PAGED_KERNELS = {
    "paged_decode": ("paged_decode_kernel",
                     "easydist_tpu/ops/flash_attention.py:644"),
    "paged_decode_quant": ("paged_decode_quant_kernel",
                           "easydist_tpu/ops/flash_attention.py:754"),
}
PAGED_SOURCE = "easydist_tpu_torch/ops/csrc/paged_decode.cu"


def paged_inputs(dev, rs, heads: int, kv_heads: int, d: int,
                 lengths=PAGED_LENGTHS, shape=PAGED_SHAPE, dead=(0,)):
    """f32 q [b, heads, d], K/V arenas [n_pages, kv_heads, pt, d], and a
    table whose rows take pages from a shuffled permutation of the arena
    (live windows only; sentinel `n_pages` elsewhere, and everywhere on
    the `dead` rows)."""
    b, _, pt, _, mp, n_pages = shape
    perm = rs.permutation(n_pages)
    table = np.full((b, mp), n_pages, np.int32)
    for i, n in enumerate(lengths):
        if i not in dead:
            live = -(-n // pt)
            table[i, :live] = perm[i * mp:i * mp + live]

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return (t(rs.standard_normal((b, heads, d))),
            t(rs.standard_normal((n_pages, kv_heads, pt, d))),
            t(rs.standard_normal((n_pages, kv_heads, pt, d))),
            t(table, torch.int32), t(np.asarray(lengths), torch.int32))


def paged_bound_ms(lengths, shape, heads: int, kv_heads: int, d: int,
                   kv_itemsize: float, q_itemsize: int):
    """(ms, "bytes"|"operations") for one paged decode call: the larger
    of its bytes — q and out once, table and lengths, and each row's live
    K and V rows (per kv head; `kv_itemsize` bytes an element, scales
    included) — over HBM rate, and its f32 operations (2*d for q.k and
    2*d for p.v per live key and head) over the card's f32 rate."""
    b, _, pt, _, mp, _ = shape
    live = sum(min(int(x), mp * pt) for x in lengths)
    nbytes = (2 * b * heads * d * q_itemsize + 4 * b * mp + 4 * b
              + 2 * kv_heads * d * kv_itemsize * live)
    flops = 4 * heads * d * live
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_kernel_phase(dev):
    """B5 and B6 against their plain versions on the same inputs at the
    paged serving shape (f32 and bf16 q; B6 with 1 and 4 scale blocks;
    bf16 pages under an f32 q), plus a GQA case (12 heads over 4 kv
    heads), head_dim 128 and lengths around the split boundaries (256
    tokens; 128 for B5's f32 pages at head_dim 128).
    Tolerances: f32 atol 1e-5 (the JAX bar,
    tests/test_ops/test_paged_decode_attention.py:132); a bf16 output
    adds half an ulp, 2^-8 |ref|, as B4's.  Then the times at the serving
    shape.  Returns the kernels-line entries (without `launches`)."""
    from easydist_tpu_torch.ops import flash_attention as fa

    b, h, pt, d, mp, n_pages = PAGED_SHAPE
    rs = np.random.RandomState(2)
    worst = {name: {} for name in PAGED_KERNELS}
    for case, heads, kvh, dd, lens in (
            ("serve", h, h, d, PAGED_LENGTHS), ("gqa 12/4", h, 4, d,
                                                PAGED_LENGTHS),
            ("d128", h, h, 128, PAGED_LENGTHS),
            ("splits", h, h, d, SPLIT_LENGTHS),
            ("splits d128", h, h, 128, SPLIT_LENGTHS_128)):
        q32, k32, v32, table, L = paged_inputs(dev, rs, heads, kvh, dd,
                                               lengths=lens)
        scale = 1.0 / np.sqrt(dd)
        empty = L == 0
        quant = {nb: fa.kv_quantize(k32, nb) + fa.kv_quantize(v32, nb)
                 for nb in (1, 4)}
        for q_dt, kv_dt in ((torch.float32, torch.float32),
                            (torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.bfloat16)):
            if case != "serve" and q_dt != kv_dt:
                continue
            q, k, v = q32.to(q_dt), k32.to(kv_dt), v32.to(kv_dt)
            rounded = q_dt == torch.bfloat16
            out = fa.flash_paged_decode_attention(q, k, v, table, L)
            torch.cuda.synchronize()
            ref = fa._paged_decode_attention_xla(q.float(), k.float(),
                                                 v.float(), table, L, scale)
            ref[empty] = 0.0
            tag = (f"paged_decode {case:11s} q {str(q_dt)[6:]:8s} pages "
                   f"{str(kv_dt)[6:]}")
            err = check_close(tag, out, ref, 0.0, 1e-5, rounded)
            key = "bf16" if rounded else "f32"
            worst["paged_decode"][key] = max(
                worst["paged_decode"].get(key, 0.0), err)
            if kv_dt != q_dt:
                continue
            for nb, (kq, ks, vq, vs) in quant.items():
                out = fa.flash_paged_decode_quant_attention(q, kq, vq, ks,
                                                            vs, table, L)
                torch.cuda.synchronize()
                ref = fa._paged_decode_attention_quant_xla(
                    q.float(), kq, vq, ks, vs, table, L, scale)
                ref[empty] = 0.0
                err = check_close(f"paged_decode_quant {case:11s} q "
                                  f"{str(q_dt)[6:]:8s} n_blocks {nb}",
                                  out, ref, 0.0, 1e-5, rounded)
                worst["paged_decode_quant"][key] = max(
                    worst["paged_decode_quant"].get(key, 0.0), err)
    return paged_kernel_times(dev, worst)


def paged_kernel_times(dev, worst):
    """Times at the serving shape, bf16 q, every row at length 1024 (all
    16 windows of every table row live): B5 over bf16 pages, B6 over int8
    pages with one scale per row.  Kernel (CUDA events over rotated arena
    copies, and the profiler's device time per launch), plain version,
    bound, and a yardstick: no single PyTorch call computes paged
    attention, so SDPA runs on the cache already gathered (and, for B6,
    dequantized) into contiguous [8, 12, 1024, 64] — the gather excluded.
    Each wrapper call launches one kernel (B5 and B6 merge their splits
    inside their own launch), so the profiled symbol is the call's whole
    device time."""
    import torch.nn.functional as F

    from easydist_tpu_torch.ops import flash_attention as fa

    b, h, pt, d, mp, n_pages = PAGED_SHAPE
    scale = 1.0 / np.sqrt(d)
    lens = [mp * pt] * b
    rs = np.random.RandomState(3)
    copies = []
    for _ in range(TIMED_COPIES):
        q, k, v, table, L = paged_inputs(dev, rs, h, h, d, lengths=lens,
                                         dead=())
        kq, ks = fa.kv_quantize(k, 1)
        vq, vs = fa.kv_quantize(v, 1)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        gathered = [fa.gather_pages(x, table).contiguous() for x in (k, v)]
        dequant = [fa.kv_dequantize(fa.gather_pages(x, table),
                                    fa.gather_pages(sc, table),
                                    torch.bfloat16).contiguous()
                   for x, sc in ((kq, ks), (vq, vs))]
        copies.append((q, k, v, table, L, kq, ks, vq, vs, gathered,
                       dequant))
    calls = {
        "paged_decode": (
            lambda c: fa.flash_paged_decode_attention(*c[:5]),
            lambda c: fa._paged_decode_attention_xla(*c[:5], scale),
            lambda c: F.scaled_dot_product_attention(c[0][:, :, None],
                                                     *c[9]),
            "SDPA on the gathered contiguous cache, gather excluded", 2),
        "paged_decode_quant": (
            lambda c: fa.flash_paged_decode_quant_attention(
                c[0], c[5], c[7], c[6], c[8], c[3], c[4]),
            lambda c: fa._paged_decode_attention_quant_xla(
                c[0], c[5], c[7], c[6], c[8], c[3], c[4], scale),
            lambda c: F.scaled_dot_product_attention(c[0][:, :, None],
                                                     *c[10]),
            "SDPA on the gathered, dequantized bf16 cache, gather and "
            "dequantization excluded", 1 + 4 / d),
    }
    counters = decode_counters()
    before = {name: c.launches for name, c in counters.items()}
    entries = []
    for name, (kernel, plain, library, library_call, kv_size) in \
            calls.items():
        symbol, replaces = PAGED_KERNELS[name]

        def at(fn):
            return lambda i: fn(copies[i % TIMED_COPIES])

        kernel_ms = time_ms(at(kernel))
        plain_ms = time_ms(at(plain), n=10)
        library_ms = time_ms(at(library))
        kernel_ms_2 = time_ms(at(kernel))
        prof_ms, seen = profiled_ms(at(kernel), symbol)
        bound_ms, bound_by = paged_bound_ms(lens, PAGED_SHAPE, h, h, d,
                                            kv_size, 2)
        pages = "bf16" if name == "paged_decode" else "int8, 1 scale a row"
        print(f"time {name} q bf16, pages {pages}, {list(PAGED_SHAPE)} "
              f"lengths {mp * pt}: kernel {kernel_ms:.4f} ms (again "
              f"{kernel_ms_2:.4f}; {profiled_text(prof_ms, seen)}), plain "
              f"{plain_ms:.4f} ms, library ({library_call}) "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        entries.append({
            "name": name, "route": "cuda", "source": PAGED_SOURCE,
            "replaces": replaces,
            "shape": f"q [{b},{h},{d}] bfloat16, {pages} pages "
                     f"[{n_pages},{h},{pt},{d}], table [{b},{mp}], lengths "
                     f"{mp * pt}",
            "max_abs_err": worst[name]["bf16"],
            "max_abs_err_f32": worst[name]["f32"],
            "ms": kernel_ms, "kernel_ms": kernel_ms, "profiled_ms": prof_ms,
            "profiled_launches": seen, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_call": library_call})
    for name, c in counters.items():
        c.launches = before[name]  # timing runs don't count
    return entries


# -------------------------------- B4-B6 at the Llama decode shape (phase 3)

# slots, query heads, bucket, head_dim of Llama-3-8B's decode (phase 17):
# B4 reads the caches repeated to the 32 query heads
LLAMA_DECODE_SHAPE = (8, 32, 1024, 128)
LLAMA_KV_HEADS = 8
# rows, query heads, page_tokens, head_dim, max_pages, arena pages: the
# paged session's default arena, pages [144, 8, 64, 128]
LLAMA_PAGED_SHAPE = (8, 32, 64, 128, 16, 144)
LLAMA_LENGTHS = (1, 5, 77, 128, 300, 513, 999, 1024)


def llama_kernel_phase(dev):
    """B4, B5 and B6 at Llama-3-8B's decode shape against their plain
    versions, in f32 and bf16: B4 over caches already repeated to the 32
    query heads (the bucketed path's operands), B5 / B6 with 32 query
    heads over 8 KV heads (the kernels' GQA head map), at the lengths of
    a mixed batch and around the 128-token splits; the bars of the
    serving shape.  Then each one's times per dtype at every row's full
    length (CUDA events over rotated copies, the profiler's device time,
    the plain version, SDPA: on the repeated cache for B4, with
    enable_gqa on the gathered (and dequantized) kv_heads cache for
    B5 / B6, the gather excluded) and bounds: B4's bytes of its operands;
    B5 / B6 both the unique bytes (each KV row once) and the bytes the
    kernels read (each KV head's rows once per query head, 4x).  Returns
    {kernel name: the fields the kernels line adds as "llama"}."""
    import torch.nn.functional as F

    from easydist_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, t, d = LLAMA_DECODE_SHAPE
    kvh = LLAMA_KV_HEADS
    scale = 1.0 / np.sqrt(d)
    rs = np.random.RandomState(4)
    worst = {}

    def keep(name, key, err):
        worst.setdefault(name, {})
        worst[name][key] = max(worst[name].get(key, 0.0), err)

    q32, k32, v32 = decode_inputs(dev, rs, t, d, b=b, h=h)
    for dtype in (torch.float32, torch.bfloat16):
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        for lens in (LLAMA_LENGTHS, SPLIT_LENGTHS_128):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = fa.flash_decode_attention(q, k, v, L)
            torch.cuda.synchronize()
            ref = fa._decode_attention_xla(q.float(), k.float(), v.float(),
                                           L, scale)
            ref[L == 0] = 0.0
            keep("flash_decode", key, check_close(
                f"flash_decode llama {key} lengths {lens[:3]}...", out, ref,
                0.0, 1e-5, dtype == torch.bfloat16))
    del q32, k32, v32
    for lens in (PAGED_LENGTHS, SPLIT_LENGTHS_128):
        q32, kp, vp, table, L = paged_inputs(dev, rs, h, kvh, d, lengths=lens,
                                             shape=LLAMA_PAGED_SHAPE)
        empty = L == 0
        kq, ks = fa.kv_quantize(kp, 1)
        vq, vs = fa.kv_quantize(vp, 1)
        for dtype in (torch.float32, torch.bfloat16):
            key = "bf16" if dtype == torch.bfloat16 else "f32"
            q, k, v = q32.to(dtype), kp.to(dtype), vp.to(dtype)
            out = fa.flash_paged_decode_attention(q, k, v, table, L)
            torch.cuda.synchronize()
            ref = fa._paged_decode_attention_xla(q.float(), k.float(),
                                                 v.float(), table, L, scale)
            ref[empty] = 0.0
            keep("paged_decode", key, check_close(
                f"paged_decode llama 32/8 {key} lengths {lens[:3]}...", out,
                ref, 0.0, 1e-5, dtype == torch.bfloat16))
            out = fa.flash_paged_decode_quant_attention(q, kq, vq, ks, vs,
                                                        table, L)
            torch.cuda.synchronize()
            ref = fa._paged_decode_attention_quant_xla(q.float(), kq, vq, ks,
                                                       vs, table, L, scale)
            ref[empty] = 0.0
            keep("paged_decode_quant", key, check_close(
                f"paged_decode_quant llama 32/8 q {key} lengths "
                f"{lens[:3]}...", out, ref, 0.0, 1e-5,
                dtype == torch.bfloat16))
    return llama_kernel_times(dev, worst)


def llama_kernel_times(dev, worst):
    """The times of `llama_kernel_phase`, every row at length 1024."""
    import torch.nn.functional as F

    from easydist_tpu_torch.ops import flash_attention as fa

    b, h, t, d = LLAMA_DECODE_SHAPE
    kvh = LLAMA_KV_HEADS
    _, _, pt, _, mp, n_pages = LLAMA_PAGED_SHAPE
    scale = 1.0 / np.sqrt(d)
    lens = [t] * b
    rs = np.random.RandomState(5)
    counters = decode_counters()
    before = {name: c.launches for name, c in counters.items()}
    out = {name: {"shape": shape, "max_abs_err": worst[name]["bf16"],
                  "max_abs_err_f32": worst[name]["f32"]}
           for name, shape in (
               ("flash_decode", f"q [{b},{h},{d}] k/v [{b},{h},{t},{d}] "
                                f"(repeated from {kvh} KV heads), lengths "
                                f"{t}"),
               ("paged_decode", f"q [{b},{h},{d}], pages [{n_pages},{kvh},"
                                f"{pt},{d}], table [{b},{mp}], lengths "
                                f"{t}"),
               ("paged_decode_quant", f"q [{b},{h},{d}], int8 pages "
                                      f"[{n_pages},{kvh},{pt},{d}] + 1 scale "
                                      f"a row, table [{b},{mp}], lengths "
                                      f"{t}"))}
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < L[:, None])[:, None, None]
    for dtype in (torch.float32, torch.bfloat16):
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        itemsize = torch.finfo(dtype).bits // 8
        # B4 on caches repeated to the query heads
        qs = [torch.randn(b, h, d, device=dev, dtype=dtype)
              for _ in range(TIMED_COPIES)]
        ks = [torch.randn(b, h, t, d, device=dev, dtype=dtype)
              for _ in range(TIMED_COPIES)]
        vs = [torch.randn(b, h, t, d, device=dev, dtype=dtype)
              for _ in range(TIMED_COPIES)]

        def b4(i):
            j = i % TIMED_COPIES
            return fa.flash_decode_attention(qs[j], ks[j], vs[j], L)

        def sdpa(i):
            j = i % TIMED_COPIES
            return F.scaled_dot_product_attention(qs[j][:, :, None], ks[j],
                                                  vs[j], attn_mask=mask)

        kernel_ms = time_ms(b4)
        plain_ms = time_ms(lambda i: fa._decode_attention_xla(
            qs[i % TIMED_COPIES], ks[i % TIMED_COPIES], vs[i % TIMED_COPIES],
            L, scale), n=10)
        library_ms = time_ms(sdpa)
        prof_ms, seen = profiled_ms(b4, "flash_decode_kernel")
        bound_ms, bound_by = decode_bound_ms(lens, LLAMA_DECODE_SHAPE,
                                             itemsize)
        print(f"time flash_decode llama {key} {list(LLAMA_DECODE_SHAPE)} "
              f"lengths {t}: kernel {kernel_ms:.4f} ms "
              f"({profiled_text(prof_ms, seen)}), plain {plain_ms:.4f} ms, "
              f"library (SDPA, masked) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        out["flash_decode"][key] = {
            "ms": kernel_ms, "profiled_ms": prof_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
        del qs, ks, vs
        # B5 / B6 over kv_heads pages
        copies = []
        for _ in range(TIMED_COPIES):
            q, k, v, table, Lp = paged_inputs(
                dev, rs, h, kvh, d, lengths=lens, shape=LLAMA_PAGED_SHAPE,
                dead=())
            kq, ksc = fa.kv_quantize(k, 1)
            vq, vsc = fa.kv_quantize(v, 1)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            gathered = [fa.gather_pages(x, table).contiguous()
                        for x in (k, v)]
            dequant = [fa.kv_dequantize(fa.gather_pages(x, table),
                                        fa.gather_pages(sc, table),
                                        dtype).contiguous()
                       for x, sc in ((kq, ksc), (vq, vsc))]
            copies.append((q, k, v, table, Lp, kq, ksc, vq, vsc, gathered,
                           dequant))
        calls = {
            "paged_decode": (
                lambda c: fa.flash_paged_decode_attention(*c[:5]),
                lambda c: fa._paged_decode_attention_xla(*c[:5], scale),
                lambda c: F.scaled_dot_product_attention(
                    c[0][:, :, None], *c[9], enable_gqa=True),
                "paged_decode_kernel", itemsize),
            "paged_decode_quant": (
                lambda c: fa.flash_paged_decode_quant_attention(
                    c[0], c[5], c[7], c[6], c[8], c[3], c[4]),
                lambda c: fa._paged_decode_attention_quant_xla(
                    c[0], c[5], c[7], c[6], c[8], c[3], c[4], scale),
                lambda c: F.scaled_dot_product_attention(
                    c[0][:, :, None], *c[10], enable_gqa=True),
                "paged_decode_quant_kernel", 1 + 4 / d),
        }
        for name, (kernel, plain, library, symbol, kv_size) in \
                calls.items():
            def at(fn):
                return lambda i: fn(copies[i % TIMED_COPIES])

            kernel_ms = time_ms(at(kernel))
            plain_ms = time_ms(at(plain), n=10)
            library_ms = time_ms(at(library))
            prof_ms, seen = profiled_ms(at(kernel), symbol)
            bound_ms, bound_by = paged_bound_ms(lens, LLAMA_PAGED_SHAPE, h,
                                                kvh, d, kv_size, itemsize)
            read_ms, read_by = paged_bound_ms(lens, LLAMA_PAGED_SHAPE, h, h,
                                              d, kv_size, itemsize)
            print(f"time {name} llama 32/8 q {key}: kernel {kernel_ms:.4f} "
                  f"ms ({profiled_text(prof_ms, seen)}), plain "
                  f"{plain_ms:.4f} ms, library (SDPA enable_gqa on the "
                  f"gathered cache) {library_ms:.4f} ms, bound {bound_ms:.4f}"
                  f" ms ({bound_by}, unique KV bytes), {read_ms:.4f} ms "
                  f"({read_by}, the bytes the kernel reads: each KV head "
                  f"once per query head)")
            out[name][key] = {
                "ms": kernel_ms, "profiled_ms": prof_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_read_ms": read_ms,
                "bound_read_by": read_by}
        del copies
    for name, c in counters.items():
        c.launches = before[name]  # timing runs don't count
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- training kernels B1-B3

# name -> (bfloat16 kernel symbol, float32 kernel symbol, TPU kernel it
# replaces, source)
TRAIN_KERNELS = {
    "flash_fwd": ("flash_fwd_sm90_kernel", "flash_fwd_tf32_kernel",
                  "easydist_tpu/ops/flash_attention.py:78",
                  "easydist_tpu_torch/ops/csrc/flash_attn_fwd.cu"),
    "flash_bwd_dq": ("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_tf32_kernel",
                     "easydist_tpu/ops/flash_attention.py:164",
                     "easydist_tpu_torch/ops/csrc/flash_attn_bwd.cu"),
    "flash_bwd_dkv": ("flash_bwd_dkv_sm90_kernel",
                      "flash_bwd_dkv_tf32_kernel",
                      "easydist_tpu/ops/flash_attention.py:197",
                      "easydist_tpu_torch/ops/csrc/flash_attn_bwd.cu"),
}


def train_counters():
    from easydist_tpu_torch.ops import flash_attention as fa

    return {name: getattr(fa, name) for name in TRAIN_KERNELS}


def train_bound_ms(kernel: str, shape, causal: bool, itemsize: int):
    """(ms, "bytes"|"operations") for one training kernel: the larger of
    its bytes (each input read once, each output written once: the
    [b,h,t,d] tensors and the f32 per-row lse/delta) over HBM rate, and
    its products over the tensor cores' dense rate for the inputs' type
    (bf16; f32 at the TF32 rate, the card's fastest way to f32 products,
    which the f32 kernels take).  The function's products only: the hi/lo
    splits' extra products are not counted.  Causal products count the
    visible (query, key) pairs only."""
    b, h, t, d = shape
    pairs = t * (t + 1) // 2 if causal else t * t
    tensors, rows, products = {"flash_fwd": (4, 1, 2),
                               "flash_bwd_dq": (5, 2, 3),
                               "flash_bwd_dkv": (6, 2, 4)}[kernel]
    nbytes = tensors * b * h * t * d * itemsize + rows * b * h * t * 4
    flops = products * 2 * b * h * pairs * d
    rate = BF16_FLOPS_PER_S if itemsize == 2 else TF32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(tag: str, got, ref, rtol: float, atol: float,
                rounded: bool) -> float:
    """Per element |got - ref| <= atol + rtol |ref|, plus 2^-8 |ref| when
    `got` was rounded to bf16 (half an ulp); raises when any element is
    over.  Returns the largest absolute error."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    tol = atol + (rtol + (2.0 ** -8 if rounded else 0.0)) * ref.abs()
    ratio = (diff / tol).max().item()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
    tol_text = (f"{atol:g} + {rtol:g}|ref|"
                + (" + 2^-8|ref|" if rounded else ""))
    print(f"kernel {tag:52s} max_abs_err {err:.3e} (tol {tol_text}; worst "
          f"err/tol {ratio:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} disagrees with its plain version: "
                             f"err/tol {ratio} > 1")
    return err


def train_kernel_phase(dev, shape=TRAIN_SHAPE, ragged_t: int = 1000,
                       shard_shape=SHARD_SHAPE):
    """B1, B2 and B3 against their plain versions on the same inputs:
    float32 and bfloat16 (the plain version in f32 on the same rounded
    inputs); causal, full, a ragged causal length and a backward with a
    nonzero lse cotangent; the f32 forward also at head_dim 128 and a
    ragged length, and the f32 kernels at head_dim 128 (a ragged length
    and one row past a tile); all three, causal and full, f32 and bf16,
    at `shard_shape`, the ring's block on phase 10b's path (its key
    blocks T/n: 1024 at n = 8, seq 8192).  Tolerances: the JAX tests' f32 bars
    (forward rtol 1e-4 / atol 1e-5, backward rtol 2e-4 / atol 2e-5); a
    bf16 output adds half an ulp of its rounding, 2^-8 |ref|, since the
    kernels round once: the f32 B1-B3 take three TF32 products of hi/lo
    halves for each product (about 2^-21 of each product lost), and the
    bf16 B1-B3 take exact bf16 products summed in f32 with P and dS split
    into bf16 hi + lo halves.  On the card, also the times
    (causal, at `shape`).  Returns the kernels-line entries (without
    `launches`)."""
    from easydist_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, h, t, d = shape
    scale = 1.0 / np.sqrt(d)
    cases = [("causal", True, shape, False), ("full", False, shape, False),
             (f"causal T={ragged_t}", True, (b, h, ragged_t, d), False),
             ("causal, g_lse", True, shape, True),
             ("shard causal", True, shard_shape, False),
             ("shard full", False, shard_shape, False)]
    worst = {name: {} for name in TRAIN_KERNELS}
    rs = np.random.RandomState(0)
    for case, causal, shp, with_glse in cases:
        t_case = shp[2]
        base = [torch.as_tensor(rs.standard_normal(shp), dtype=torch.float32,
                                device=dev) for _ in range(4)]
        g_lse = (torch.as_tensor(rs.standard_normal((shp[0] * shp[1],
                                                     t_case)),
                                 dtype=torch.float32, device=dev)
                 if with_glse else None)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (x.to(dtype) for x in base)
            qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
            rounded = dtype == torch.bfloat16
            tag = f"{str(dtype)[6:]:8s} {case:16s}"
            out, lse = fa.flash_fwd(q, k, v, causal, scale)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ref_out, ref_lse = fa._flash_forward_xla(qf, kf, vf, causal,
                                                     scale)
            errs = {"flash_fwd": max(
                check_close(f"flash_fwd {tag} out", out, ref_out, 1e-4,
                            1e-5, rounded),
                check_close(f"flash_fwd {tag} lse", lse, ref_lse, 1e-4,
                            1e-5, False))}
            # both backward versions get the plain forward's out and lse
            delta = fa._flash_delta(ref_out, dof, g_lse)
            dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal,
                                      scale)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            r_dq = fa._flash_bwd_dq_xla(qf, kf, vf, dof, ref_lse, delta,
                                        causal, scale)
            r_dk, r_dv = fa._flash_bwd_dkv_xla(qf, kf, vf, dof, ref_lse,
                                               delta, causal, scale)
            errs["flash_bwd_dq"] = check_close(
                f"flash_bwd_dq {tag} dq", dq, r_dq, 2e-4, 2e-5, rounded)
            errs["flash_bwd_dkv"] = max(
                check_close(f"flash_bwd_dkv {tag} dk", dk, r_dk, 2e-4, 2e-5,
                            rounded),
                check_close(f"flash_bwd_dkv {tag} dv", dv, r_dv, 2e-4, 2e-5,
                            rounded))
            for name, err in errs.items():
                worst[name][dtype] = max(worst[name].get(dtype, 0.0), err)
            del out, lse, ref_out, ref_lse, delta, dq, dk, dv, r_dq, r_dk, r_dv
    # the f32 kernels' other tiles: head_dim 128 (B1 and B2 64-query
    # blocks, B3 16-query tiles) at the ragged length and one row past a
    # tile
    f32 = torch.float32
    for t_case in (ragged_t, 129):
        q, k, v, do = (torch.as_tensor(
            rs.standard_normal((b, h, t_case, 128)), dtype=f32, device=dev)
            for _ in range(4))
        s128 = 1.0 / np.sqrt(128)
        out, lse = fa.flash_fwd(q, k, v, True, s128)
        ref_out, ref_lse = fa._flash_forward_xla(q, k, v, True, s128)
        delta = fa._flash_delta(ref_out, do)
        dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, True, s128)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, True, s128)
        r_dq = fa._flash_bwd_dq_xla(q, k, v, do, ref_lse, delta, True, s128)
        r_dk, r_dv = fa._flash_bwd_dkv_xla(q, k, v, do, ref_lse, delta, True,
                                           s128)
        tag = f"float32  causal T={t_case} d128"
        worst["flash_fwd"][f32] = max(
            worst["flash_fwd"][f32],
            check_close(f"flash_fwd {tag} out", out, ref_out, 1e-4, 1e-5,
                        False),
            check_close(f"flash_fwd {tag} lse", lse, ref_lse, 1e-4, 1e-5,
                        False))
        worst["flash_bwd_dq"][f32] = max(
            worst["flash_bwd_dq"][f32],
            check_close(f"flash_bwd_dq {tag} dq", dq, r_dq, 2e-4, 2e-5,
                        False))
        worst["flash_bwd_dkv"][f32] = max(
            worst["flash_bwd_dkv"][f32],
            check_close(f"flash_bwd_dkv {tag} dk", dk, r_dk, 2e-4, 2e-5,
                        False),
            check_close(f"flash_bwd_dkv {tag} dv", dv, r_dv, 2e-4, 2e-5,
                        False))
        del q, k, v, do, out, lse, ref_out, ref_lse, delta, dq, dk, dv
        del r_dq, r_dk, r_dv
    if dev.type != "cuda":
        return []
    entries = train_kernel_times(dev, shape, worst)
    shard = shard_kernel_times(dev, shard_shape)
    for e in entries:
        e["shard"] = shard[e["name"]]
    return entries


def shard_kernel_times(dev, shape):
    """B1-B3 at a ring block's shape, causal (the diagonal block) and full
    (the blocks below it), f32 and bf16: kernel ms (CUDA events over 50
    launches, profiler device ms per launch), plain version ms, bound.
    Returns {kernel: {"<dtype> <mask>": {...}}}."""
    from easydist_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / np.sqrt(shape[-1])
    counters = train_counters()
    before = {name: c.launches for name, c in counters.items()}
    out = {name: {} for name in TRAIN_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        copies = [[torch.randn(shape, device=dev, dtype=dtype)
                   for _ in range(4)] for _ in range(TIMED_COPIES)]
        saved = {}
        for causal in (True, False):
            saved[causal] = []
            for q, k, v, do in copies:
                o, lse = fa.flash_fwd(q, k, v, causal, scale)
                saved[causal].append((lse, fa._flash_delta(o, do)))
        for causal in (True, False):
            def at(i, causal=causal):
                j = i % TIMED_COPIES
                return copies[j] + list(saved[causal][j])

            calls = {
                "flash_fwd": (
                    lambda i: fa.flash_fwd(*at(i)[:3], causal, scale),
                    lambda i: fa._flash_forward_xla(*at(i)[:3], causal,
                                                    scale)),
                "flash_bwd_dq": (
                    lambda i: fa.flash_bwd_dq(*at(i), causal, scale),
                    lambda i: fa._flash_bwd_dq_xla(*at(i), causal, scale)),
                "flash_bwd_dkv": (
                    lambda i: fa.flash_bwd_dkv(*at(i), causal, scale),
                    lambda i: fa._flash_bwd_dkv_xla(*at(i), causal, scale))}
            key = f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
            for name, (kernel, plain) in calls.items():
                symbol = TRAIN_KERNELS[name][0 if dtype == torch.bfloat16
                                             else 1]
                ms = time_ms(kernel)
                prof_ms, seen = profiled_ms(kernel, symbol)
                plain_ms = time_ms(plain, n=10)
                bound, by = train_bound_ms(name, shape, causal,
                                           dtype.itemsize)
                print(f"time {name} {key} {list(shape)} (ring block, "
                      f"{symbol}): kernel {ms:.4f} ms "
                      f"({profiled_text(prof_ms, seen)}), plain "
                      f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
                out[name][key] = {"ms": ms, "profiled_ms": prof_ms,
                                  "plain_ms": plain_ms, "bound_ms": bound,
                                  "bound_by": by}
        del copies, saved
    for name, c in counters.items():
        c.launches = before[name]  # timing runs don't count
    return out


def timed_calls(copies, scale: float):
    """name -> (kernel, plain version, library yardstick, its call) of
    B1-B3 on `copies` of (q, k, v, dO), each a function of the launch
    index (the copies rotate past the L2).  lse and delta come from the
    kernels' own forward."""
    import torch.nn.functional as F

    from easydist_tpu_torch.ops import flash_attention as fa

    saved = []
    for q, k, v, do in copies:
        out, lse = fa.flash_fwd(q, k, v, True, scale)
        saved.append((lse, fa._flash_delta(out, do)))
    sdpa_in = [[x.detach().requires_grad_() for x in c[:3]] for c in copies]
    sdpa_out = [F.scaled_dot_product_attention(*xs, is_causal=True)
                for xs in sdpa_in]

    def at(i):
        return copies[i % TIMED_COPIES] + list(saved[i % TIMED_COPIES])

    def sdpa_bwd(i):
        j = i % TIMED_COPIES
        return torch.autograd.grad(sdpa_out[j], sdpa_in[j], copies[j][3],
                                   retain_graph=True)

    return {
        "flash_fwd": (
            lambda i: fa.flash_fwd(*at(i)[:3], True, scale),
            lambda i: fa._flash_forward_xla(*at(i)[:3], True, scale),
            lambda i: F.scaled_dot_product_attention(
                *copies[i % TIMED_COPIES][:3], is_causal=True),
            "F.scaled_dot_product_attention(is_causal=True)"),
        "flash_bwd_dq": (
            lambda i: fa.flash_bwd_dq(*at(i), True, scale),
            lambda i: fa._flash_bwd_dq_xla(*at(i), True, scale),
            sdpa_bwd, "SDPA backward (dQ, dK and dV together)"),
        "flash_bwd_dkv": (
            lambda i: fa.flash_bwd_dkv(*at(i), True, scale),
            lambda i: fa._flash_bwd_dkv_xla(*at(i), True, scale),
            sdpa_bwd, "SDPA backward (dQ, dK and dV together)"),
    }


def train_kernel_times(dev, shape, worst):
    """Times of B1-B3 at `shape`, bf16, causal: kernel (CUDA events, and
    the profiler's device time per launch), plain version, library
    yardstick (SDPA forward; SDPA's autograd backward for B2 and B3
    together), bound.  For each kernel whose float32 route is another
    kernel (all three), also that kernel's time (CUDA events and
    profiler), its plain version's and the library's on float32 copies
    of the same inputs, printed on a line of its own."""
    b, h, t, d = shape
    scale = 1.0 / np.sqrt(d)
    bf16 = torch.bfloat16
    counters = train_counters()
    before = {name: c.launches for name, c in counters.items()}
    copies = [[torch.randn(shape, device=dev, dtype=bf16) for _ in range(4)]
              for _ in range(TIMED_COPIES)]  # q, k, v, dO
    calls = timed_calls(copies, scale)
    f32_calls = timed_calls([[x.float() for x in c] for c in copies], scale)
    entries = []
    for name, (kernel, plain, library, library_call) in calls.items():
        symbol, f32_symbol, replaces, source = TRAIN_KERNELS[name]
        kernel_ms = time_ms(kernel)
        plain_ms = time_ms(plain, n=10)
        library_ms = time_ms(library)
        kernel_ms_2 = time_ms(kernel)
        prof_ms, seen = profiled_ms(kernel, symbol)
        bound_ms, bound_by = train_bound_ms(name, shape, True, 2)
        print(f"time {name} bf16 causal {list(shape)} ({symbol}): kernel "
              f"{kernel_ms:.4f} ms (again {kernel_ms_2:.4f}; "
              f"{profiled_text(prof_ms, seen)}), plain {plain_ms:.4f} ms, "
              f"library ({library_call}) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        f32 = {}
        if f32_symbol != symbol:
            kernel32, plain32, library32, _ = f32_calls[name]
            f32_ev = time_ms(kernel32)
            f32_ms, f32_seen = profiled_ms(kernel32, f32_symbol)
            f32_plain = time_ms(plain32, n=10)
            f32_library = time_ms(library32)
            f32_bound, f32_by = train_bound_ms(name, shape, True, 4)
            print(f"time {name} f32 causal {list(shape)} ({f32_symbol}): "
                  f"kernel {f32_ev:.4f} ms ({profiled_text(f32_ms, f32_seen)}"
                  f"), plain {f32_plain:.4f} ms, library ({library_call}) "
                  f"{f32_library:.4f} ms, bound {f32_bound:.4f} ms "
                  f"({f32_by})")
            f32 = {"f32_symbol": f32_symbol, "f32_ms": f32_ev,
                   "f32_profiled_ms": f32_ms, "f32_plain_ms": f32_plain,
                   "f32_library_ms": f32_library, "f32_bound_ms": f32_bound,
                   "f32_bound_by": f32_by}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "shape": f"q/k/v/dO {list(shape)} bfloat16, causal",
            "max_abs_err": worst[name][bf16],
            "max_abs_err_f32": worst[name][torch.float32],
            "ms": kernel_ms, "kernel_ms": kernel_ms, "profiled_ms": prof_ms,
            "profiled_launches": seen,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_call": library_call,
            "symbol": symbol, **f32})
    add_pair_times(entries, shape)
    for name, c in counters.items():
        c.launches = before[name]  # timing runs don't count
    return entries


def add_pair_times(entries, shape):
    """B2 + B3 against SDPA's whole backward (dQ, dK and dV in one call):
    one line per dtype, and the pair's times (profiler where it recorded
    both kernels, else events) and the library's into both entries."""
    by_name = {e["name"]: e for e in entries}
    pair = [by_name["flash_bwd_dq"], by_name["flash_bwd_dkv"]]
    for dtype, pre in (("bf16", ""), ("f32", "f32_")):
        prof = [e[f"{pre}profiled_ms"] for e in pair]
        events = [e[f"{pre}ms"] for e in pair]
        times, source = ((prof, "profiler") if None not in prof
                         else (events, "events"))
        pair_ms = sum(times)
        library = pair[0][f"{pre}library_ms"]
        print(f"pair B2 + B3 {dtype} causal {list(shape)}: {source} "
              f"{times[0]:.4f} + {times[1]:.4f} = {pair_ms:.4f} ms (events "
              f"{sum(events):.4f}), library (SDPA backward, dQ, dK and dV "
              f"together) {library:.4f} ms: {pair_ms / library:.2f}x")
        for e in pair:
            e.update({f"{pre}pair_ms": pair_ms, f"{pre}pair_source": source,
                      f"{pre}pair_library_ms": library})


# ------------------------------------------------------------ training


def train_phase(dev, cfg_kw=None, batch: int = 8, steps: int = 3,
                bf16_steps: int = 4, seed: int = 0):
    """Phase 7; returns each training kernel's launches in the compiled
    f32 run and in the bf16 flash steps, and the compiled f32 losses.
    The arguments shrink it for a rehearsal on the CPU."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models.gpt import GPTConfig, make_gpt_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"
    cfg = GPTConfig(**{**dict(vocab=50304, seq=1024, dim=768, heads=12,
                              layers=12, attention="flash"),
                       **(cfg_kw or {})})
    rs = np.random.RandomState(seed + 1)
    tokens = torch.as_tensor(rs.randint(0, cfg.vocab, (batch, cfg.seq)),
                             device=dev)
    targets = torch.as_tensor(rs.randint(0, cfg.vocab, (batch, cfg.seq)),
                              device=dev)

    def fresh(cfg_):
        step_, init_ = make_gpt_train_step(cfg_, lr=1e-4)
        state_ = init_(torch.Generator(device=dev).manual_seed(seed),
                       device=dev)
        return step_, state_

    # f32, flash: compiled against uncompiled from the same state
    step, state = fresh(cfg)
    eager_state = pytree.tree_map(torch.clone, state)
    compiled = easydist_compile(step, mesh=dev)
    counters = train_counters()
    for c in counters.values():
        c.launches = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = compiled(state, tokens, targets)
        losses.append(float(loss))
    secs = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    eager = []
    for _ in range(steps):
        eager_state, loss = step(eager_state, tokens, targets)
        eager.append(float(loss))
    print(f"train f32 flash: compiled losses {losses}, uncompiled {eager} "
          f"({secs:.2f} s for {steps} steps incl. tracing); launches "
          f"{launches}")
    np.testing.assert_allclose(losses, eager, rtol=1e-4,
                               err_msg="compiled train step != uncompiled")
    if compiled.cache_stats()["size"] != 1:
        raise AssertionError(f"signatures {compiled.cache_stats()}")
    expect = cfg.layers * steps if on_card else 0
    if any(n != expect for n in launches.values()):
        raise AssertionError(f"training kernels launched {launches}, "
                             f"expected {cfg.layers} x {steps} each")
    print(f"train f32 flash: compiled equals uncompiled at rtol 1e-4 over "
          f"{steps} steps (bitwise: {losses == eager}); 1 signature; B1 = B2 "
          f"= B3 = {expect} launches")
    if on_card:
        profile_f32_step(compiled, state, tokens, targets)
    del state, eager_state, compiled

    # bf16: flash against einsum from the same weights
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    runs = {}
    for attention in ("flash", "einsum"):
        step16, state16 = fresh(dataclasses.replace(cfg16,
                                                    attention=attention))
        comp16 = easydist_compile(step16, mesh=dev)
        t0 = time.perf_counter()
        comp16.get_compiled(state16, tokens, targets)
        trace_s = time.perf_counter() - t0
        for c in counters.values():
            c.launches = 0
        ls = []
        for _ in range(bf16_steps):
            state16, loss = comp16(state16, tokens, targets)
            ls.append(float(loss))
        if attention == "flash":
            bf16_launches = {name: c.launches for name, c in counters.items()}
        runs[attention] = (comp16, state16, ls, trace_s)
    ls_fl, ls_ei = runs["flash"][2], runs["einsum"][2]
    gaps = [abs(a - b_) / max(abs(b_), 1e-9) for a, b_ in zip(ls_fl, ls_ei)]
    print(f"train bf16: flash losses {ls_fl}, einsum {ls_ei}, relative "
          f"gaps {[f'{g:.2e}' for g in gaps]}")
    if not all(np.isfinite(ls_fl + ls_ei)) or max(gaps) > 2e-2:
        raise AssertionError("bf16 flash losses are not finite or are more "
                             "than 2e-2 from einsum's")
    expect16 = cfg.layers * bf16_steps if on_card else 0
    if any(n != expect16 for n in bf16_launches.values()):
        raise AssertionError(f"bf16 flash steps launched {bf16_launches}, "
                             f"expected {cfg.layers} x {bf16_steps} each")
    print(f"train bf16 flash: B1 = B2 = B3 = {expect16} launches in "
          f"{bf16_steps} steps (on the tensor-core route)")
    if on_card:
        profile_train(runs, tokens, targets, batch * cfg.seq)
    return launches, bf16_launches, losses


def step_ms(comp, state, tokens, targets, steps: int = 3):
    """Host-clock ms per step over `steps` compiled steps ending in a
    synchronize, after one untimed step; returns (ms, state)."""
    state, _ = comp(state, tokens, targets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = comp(state, tokens, targets)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, state


def profile_f32_step(comp, state, tokens, targets):
    """One f32 flash step (after an untimed one) under torch.profiler:
    host ms, device busy ms and share, and B1-B3's device ms (their f32
    symbols) and share of the busy time.  Its launches are not counted
    (the caller has read the counters)."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = comp(state, tokens, targets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = comp(state, tokens, targets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != "easydist_compile.state_copy"]
    busy = sum(ms for _, ms, _ in kernels)
    attn = {name: [(ms, n) for key, ms, n in kernels if sym[1] in key]
            for name, sym in TRAIN_KERNELS.items()}
    attn_ms = {name: sum(ms for ms, _ in hits) for name, hits in attn.items()}
    total = sum(attn_ms.values())
    print(f"profile f32 flash step: {wall_ms:.3f} ms under the profiler, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%); B1-B3 "
          f"f32 {total:.3f} ms ({100 * total / busy:.1f}% of busy): "
          + ", ".join(f"{name} {attn_ms[name]:.3f} ms over "
                      f"{sum(n for _, n in attn[name])} launches recorded"
                      for name in TRAIN_KERNELS))
    ranked = sorted(kernels, key=lambda x: -x[1])
    for name, ms, count in ranked[:8]:
        print(f"  {ms:9.4f} ms/step  {count:5d}/step  {name[:80]}")


def profile_train(runs, tokens, targets, tokens_per_step: int,
                  steps: int = 3):
    """bf16 steady-state steps: flash and einsum ms per step (host clock),
    then flash under torch.profiler: device busy share, top kernels, the
    state copy, peak memory, trace time."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree

    copy_range = "easydist_compile.state_copy"
    comp, state, _, trace_s = runs["flash"]
    comp_ei, state_ei, _, trace_ei = runs["einsum"]
    ms_ei, _ = step_ms(comp_ei, state_ei, tokens, targets, steps)
    del state_ei, comp_ei
    runs.pop("einsum")
    torch.cuda.empty_cache()
    ms_fl, state = step_ms(comp, state, tokens, targets, steps)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = comp(state, tokens, targets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    avgs = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count)
               for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != copy_range]
    busy = sum(ms for _, ms, _ in kernels)
    copy_ms = sum(e.device_time_total for e in avgs
                  if e.key == copy_range
                  and e.device_type == torch.autograd.DeviceType.CPU
                  ) / 1e3 / steps
    leaves = pytree.tree_leaves(state)
    state_bytes = sum(x.numel() * x.element_size() for x in leaves)
    # the same copies as the compiled step's state threading, by events
    spare = [x.clone() for x in leaves]
    copy_ev_ms = time_ms(lambda i: [d.copy_(x) for d, x in
                                    zip(leaves, spare)], n=5)
    del spare
    n_ops = sum(n.op == "call_function"
                for r in comp._cache.values()
                for n in r.graph_module.graph.nodes)
    print(f"train bf16 flash step: {ms_fl:.3f} ms on the host clock "
          f"({tokens_per_step / ms_fl * 1e3:.1f} tokens/s); einsum step "
          f"{ms_ei:.3f} ms ({tokens_per_step / ms_ei * 1e3:.1f} tokens/s); "
          f"trace {trace_s:.2f} s flash, {trace_ei:.2f} s einsum")
    print(f"profile bf16 flash steps: {wall_ms:.3f} ms per step under the "
          f"profiler, device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%)"
          f"; peak memory {peak_gb:.2f} GB; the step graph replays {n_ops} "
          f"aten calls; state copy {copy_ms:.3f} ms per step in the "
          f"profiled range, {copy_ev_ms:.3f} ms by events over its "
          f"{len(leaves)} leaves ({2 * state_bytes / 1e9:.2f} GB read + "
          f"written)")
    ranked = sorted(kernels, key=lambda x: -x[1])
    # the 16 largest, then the port's own kernels below them
    for name, ms, count in ranked[:16] + [k for k in ranked[16:]
                                          if "flash_train" in k[0]]:
        print(f"  {ms:9.4f} ms/step  {count // steps:5d}/step  {name[:80]}")



def make_prompts(vocab: int, seed: int = 0):
    """12 prompts of 5..700 tokens; prompts 0 and 8 share a 128-token
    prefix (prompt 8 waits for a free slot, so prompt 0 has committed
    its prefix by the time it is admitted)."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, vocab, 128).tolist()
    lengths = [0, 5, 37, 700, 64, 300, 451, 65, 0, 16, 513, 129]
    prompts = [rs.randint(0, vocab, n).tolist() for n in lengths]
    prompts[0] = shared + rs.randint(0, vocab, 250).tolist()
    prompts[8] = shared + rs.randint(0, vocab, 60).tolist()
    return prompts


def uncached_greedy(params, cfg, prompt, n_new: int, apply=None):
    """Greedy ids by re-running the whole sequence through `apply`
    (default gpt_apply) for every token (no KV cache)."""
    from easydist_tpu_torch.models.gpt import gpt_apply

    apply = apply or gpt_apply
    dev = params["wte"].device
    cur = list(prompt)
    out = []
    with torch.no_grad():
        for _ in range(n_new):
            logits = apply(params, cfg, torch.tensor([cur], device=dev))
            nxt = int(torch.argmax(logits[0, len(cur) - 1]))
            out.append(nxt)
            cur.append(nxt)
    return out


# the serving kernels' wrappers, by kernel-line name: B4, B5, B6
DECODE_KERNELS = {"flash_decode": "flash_decode_attention",
                  "paged_decode": "flash_paged_decode_attention",
                  "paged_decode_quant": "flash_paged_decode_quant_attention"}


def decode_counters():
    from easydist_tpu_torch.ops import flash_attention as fa

    return {name: getattr(fa, fn) for name, fn in DECODE_KERNELS.items()}


def serve(params, cfg, prompts, n_new: int, serve_cfg, dev, factory=None,
          **session_kw):
    """Drive a session over `prompts`, every decode kernel's launch count
    set to 0 just before and read just after; returns (ids, session,
    launches by kernel, decode_rounds, seconds) for this run alone.
    `factory` is the session constructor (default
    `GenerationSession.for_gpt`); `session_kw` goes to it
    (`draft_model=`)."""
    from easydist_tpu_torch.serve import GenerationSession

    factory = factory or GenerationSession.for_gpt
    sess = factory(params, cfg, config=serve_cfg, device=dev, **session_kw)
    counters = decode_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    futs = [sess.submit(p, max_new_tokens=n_new) for p in prompts]
    sess.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    rounds = sess.metrics.counter("decode_steps")
    ids = [f.result(timeout=0)["ids"] for f in futs]
    return ids, sess, launches, rounds, secs


def check_launches(tag: str, launches, kernel: str, layers: int,
                   rounds: int, dev):
    """`kernel` launched layers x rounds times in the run (0 off the
    card) and every other decode kernel not at all."""
    on_card = dev.type == "cuda"
    want = {name: (layers * rounds if name == kernel and on_card else 0)
            for name in DECODE_KERNELS}
    if launches != want or (on_card and launches[kernel] <= 0):
        raise AssertionError(f"{tag}: decode kernel launches {launches}, "
                             f"expected {want}")


SERVE_KW = dict(decode_buckets=(1024,), max_decode_slots=8,
                prefill_chunk=64, prefill_batch=4)


def serve_phase(dev, cfg_kw=None, n_new: int = 32, serve_kw=None,
                prompts=None, seed: int = 0):
    """Phase 4; returns what the paged phases reuse: B4's launches in
    the f32 run, the weights, prompts, the uncached reference ids and the
    f32 session's ids.  The arguments shrink it for a rehearsal on the
    CPU."""
    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_apply, gpt_init
    from easydist_tpu_torch.serve import ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_kw = cfg_kw or {}
    cfg = GPTConfig.small(**cfg_kw)
    serve_kw = serve_kw or SERVE_KW
    serve_cfg = ServeConfig(**serve_kw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = gpt_init(cfg, gen, device=dev)
    prompts = prompts or make_prompts(cfg.vocab, seed)

    ids, sess, launches, rounds, secs = serve(params, cfg, prompts, n_new,
                                              serve_cfg, dev)
    stats = sess.stats()
    n_tok = sum(len(x) for x in ids)
    print(f"serve f32: {len(prompts)} requests, {n_tok} tokens, {rounds} "
          f"decode rounds, {secs:.2f} s incl. tracing; decode kernel "
          f"launches {launches}")
    ref = [uncached_greedy(params, cfg, p, n_new) for p in prompts]
    bad = [i for i, (a, r) in enumerate(zip(ids, ref)) if a != r]
    if bad:
        i = bad[0]
        first = next(j for j, (a, r) in enumerate(zip(ids[i], ref[i]))
                     if a != r)
        raise AssertionError(f"f32 greedy ids differ from the uncached "
                             f"re-forward in requests {bad}; request {i} "
                             f"first at token {first}")
    if stats["decode_signatures"]["size"] != 1:
        raise AssertionError(f"decode signatures {stats['decode_signatures']}")
    hits = prefix_hits(stats)
    if hits <= 0:
        raise AssertionError("the prefix cache never hit")
    check_launches("serve f32", launches, "flash_decode", cfg.layers,
                   rounds, dev)
    print(f"serve f32: ids equal the uncached re-forward for all "
          f"{len(prompts)} requests; 1 decode signature; prefix cache hits "
          f"{hits}; launches {launches['flash_decode']} = {cfg.layers} x "
          f"{rounds} rounds")
    serve_bf16("serve", params, GPTConfig.small(**{**cfg_kw,
                                                  "dtype": "bfloat16"}),
               prompts, n_new, serve_cfg, ids, "flash_decode", dev)
    return {"launches": launches["flash_decode"], "params": params,
            "cfg_kw": cfg_kw, "serve_kw": serve_kw,
            "prompts": prompts, "n_new": n_new, "ref": ref, "ids": ids}


def prefix_hits(stats) -> int:
    return sum(b["prefix_cache"]["hits"] for b in stats["buckets"].values()
               if b["prefix_cache"])


def serve_bf16(tag: str, params, cfg16, prompts, n_new: int, serve_cfg,
               ids32, kernel: str, dev, factory=None, apply=None):
    """The same weights and traffic with bf16 compute (`cfg16`): one
    warm-up request traces first; the kernel's launches, finite logits
    (of `apply`, default gpt_apply), tokens/s and the id agreement with
    f32; then a profiled decode window.  Returns the printed numbers."""
    from easydist_tpu_torch.models.gpt import gpt_apply

    apply = apply or gpt_apply
    serve(params, cfg16, prompts[1:2], 2, serve_cfg, dev, factory)
    ids16, _, launches16, rounds16, secs16 = serve(
        params, cfg16, prompts, n_new, serve_cfg, dev, factory)
    check_launches(f"{tag} bf16", launches16, kernel, cfg16.layers,
                   rounds16, dev)
    with torch.no_grad():
        for p, out in zip(prompts, ids16):
            seq = torch.tensor([p + out[:-1]], device=dev)
            if not torch.isfinite(apply(params, cfg16, seq)).all():
                raise AssertionError("bf16 logits are not finite")
    n16 = sum(len(x) for x in ids16)
    same = sum(a == b for x, y in zip(ids32, ids16) for a, b in zip(x, y))
    print(f"{tag} bf16: {n16} tokens in {secs16:.3f} s = "
          f"{n16 / secs16:.1f} tokens/s ({rounds16} decode rounds, "
          f"traced beforehand); logits finite; ids equal to f32 at "
          f"{same} of {n16} positions")
    out = {"tokens_per_s": n16 / secs16, "agreement": same / n16}
    if dev.type == "cuda":
        out["profile"] = profile_decode(params, cfg16, serve_cfg, dev,
                                        prompts, n_new, tag, factory=factory)
    return out


def paged_serve_phase(dev, ctx):
    """Phase 6: phase 4's weights and traffic with kv_layout="paged" in
    f32 — every request's ids equal the uncached re-forward and the
    bucketed session's, one decode and one prefill-chunk signature, the
    prefix cache hits through zero-copy restores, B5 launches 12 x decode
    rounds (B4 none), and the page-table audit is clean after the drain;
    then bf16 paged for tokens/s and a profiled decode window.  Returns
    (B5's launches, the f32 ids)."""
    from easydist_tpu_torch.kv import audit_page_table
    from easydist_tpu_torch.models.gpt import GPTConfig
    from easydist_tpu_torch.serve import ServeConfig

    cfg = GPTConfig.small(**ctx["cfg_kw"])
    serve_cfg = ServeConfig(**{**ctx["serve_kw"], "kv_layout": "paged"})
    prompts, n_new = ctx["prompts"], ctx["n_new"]
    ids, sess, launches, rounds, secs = serve(ctx["params"], cfg, prompts,
                                              n_new, serve_cfg, dev)
    stats = sess.stats()
    pool = next(iter(sess._pools.values()))
    print(f"paged f32: {len(prompts)} requests, {sum(map(len, ids))} "
          f"tokens, {rounds} decode rounds, {secs:.2f} s incl. tracing; "
          f"launches {launches}; pool {stats['buckets'][pool.bucket]['kv_pool']}")
    bad = [i for i, (a, r, bk) in enumerate(zip(ids, ctx["ref"], ctx["ids"]))
           if a != r or a != bk]
    if bad:
        raise AssertionError(f"paged f32 ids differ from the uncached "
                             f"re-forward or the bucketed ids in requests "
                             f"{bad}")
    sigs = (stats["decode_signatures"]["size"],
            stats["prefill_signatures"]["size"])
    if sigs != (1, 1):
        raise AssertionError(f"paged decode/prefill signatures {sigs}")
    hits = prefix_hits(stats)
    saved = sess.metrics.counter("copy_on_restore_bytes_saved")
    if hits <= 0 or saved <= 0:
        raise AssertionError(f"prefix hits {hits}, zero-copy restore bytes "
                             f"{saved}")
    check_launches("paged f32", launches, "paged_decode", cfg.layers, rounds,
                   dev)
    problems = audit_page_table(pool.pool, pool.table, trie=pool.trie)
    if problems or pool.table.n_mapped(0) or pool.jobs or pool.slots:
        raise AssertionError(f"page table after drain: {problems}")
    print(f"paged f32: ids equal the uncached re-forward and the bucketed "
          f"ids for all {len(prompts)} requests; 1 decode and 1 prefill "
          f"signature; prefix hits {hits}, {saved} bytes mapped instead of "
          f"copied; launches {launches['paged_decode']} = {cfg.layers} x "
          f"{rounds} rounds, B4 0; page-table audit clean; gauges "
          f"{ {k: v for k, v in stats['metrics']['gauges'].items() if k.startswith('kv_')} }")
    serve_bf16("paged", ctx["params"],
               GPTConfig.small(**{**ctx["cfg_kw"], "dtype": "bfloat16"}),
               prompts, n_new, serve_cfg, ids, "paged_decode", dev)
    return launches["paged_decode"], ids


def int8_serve_phase(dev, ctx, exact_ids):
    """Phase 7: the same traffic with kv_quant_dtype="int8" in f32 — an
    int8 arena with f32 scales, B6 launches 12 x rounds (B4 and B5
    none), a rerun gives identical ids, `kv_quant_bytes_saved` > 0, and
    the teacher-forced logit drift against the exact paged arm stays
    within 0.25 x the logit spread (tests/test_serve/test_kv_quant.py's
    bar).  The id agreement with the exact f32 ids is printed, not gated:
    random GPT-2 weights have near-tied logits.  Returns B6's launches."""
    from easydist_tpu_torch.models import gpt
    from easydist_tpu_torch.serve import ServeConfig

    cfg = gpt.GPTConfig.small(**ctx["cfg_kw"])
    serve_cfg = ServeConfig(**{**ctx["serve_kw"], "kv_layout": "paged",
                               "kv_quant_dtype": "int8"})
    prompts, n_new = ctx["prompts"], ctx["n_new"]
    ids, sess, launches, rounds, secs = serve(ctx["params"], cfg, prompts,
                                              n_new, serve_cfg, dev)
    pool = next(iter(sess._pools.values()))
    dtypes = {k: t.dtype for k, t in pool.arena.items()}
    print(f"int8 f32: {sum(map(len, ids))} tokens, {rounds} decode rounds, "
          f"{secs:.2f} s incl. tracing; launches {launches}; arena "
          f"{dtypes}; page bytes {pool.page_bytes} (model precision "
          f"{pool.model_page_bytes})")
    if dtypes != {"k": torch.int8, "v": torch.int8,
                  "k_scale": torch.float32, "v_scale": torch.float32}:
        raise AssertionError(f"int8 arena dtypes {dtypes}")
    check_launches("int8 f32", launches, "paged_decode_quant", cfg.layers,
                   rounds, dev)
    saved = sess.metrics.snapshot()["gauges"].get("kv_quant_bytes_saved", 0)
    if saved <= 0:
        raise AssertionError(f"kv_quant_bytes_saved {saved}")
    again, *_ = serve(ctx["params"], cfg, prompts, n_new, serve_cfg, dev)
    if again != ids:
        raise AssertionError("an int8 rerun gave other ids")
    drift, spread = int8_drift(ctx["params"], cfg, prompts[3], n_new, dev,
                               serve_cfg.prefill_chunk, gpt.init_kv_pages,
                               gpt.gpt_prefill_chunk_paged,
                               gpt.gpt_decode_step_paged)
    print(f"int8 f32: rerun ids identical; kv_quant_bytes_saved {saved}; "
          f"teacher-forced drift {drift:.4e} against logit spread "
          f"{spread:.4e} (bar 0.25 x spread = {0.25 * spread:.4e})")
    if not drift <= 0.25 * spread:
        raise AssertionError(f"int8 drift {drift} > 0.25 x {spread}")
    n = sum(map(len, ids))
    same = sum(a == b for x, y in zip(exact_ids, ids) for a, b in zip(x, y))
    print(f"int8 f32: ids equal the exact f32 ids at {same} of {n} "
          f"positions ({same / n:.3f}); launches "
          f"{launches['paged_decode_quant']} = {cfg.layers} x {rounds} "
          f"rounds, B4 and B5 0")
    return launches["paged_decode_quant"]


def int8_drift(params, cfg, prompt, n_new: int, dev, pt: int, init_pages,
               prefill_chunk_paged, decode_step_paged):
    """Teacher-forced paged run, exact arena against int8 arena, at the
    model level, through the model's own `init_kv_pages`, paged chunk
    prefill and paged decode step: prefill `prompt` in page-sized chunks,
    then decode n_new - 1 steps feeding the exact arm's greedy tokens to
    both.  Returns (max |logit difference| over all steps, max logit
    spread of the exact arm)."""
    n_pages = -(-(len(prompt) + n_new) // pt)
    table = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
    logits = {}
    forced = None
    with torch.no_grad():
        for quant in (None, "int8"):
            pages = init_pages(cfg, n_pages, pt, quant_dtype=quant,
                               device=dev)
            toks = list(prompt) + [0] * pt
            for c0 in range(0, len(prompt), pt):
                pages, lg = prefill_chunk_paged(
                    params, cfg, pages, table,
                    torch.tensor([toks[c0:c0 + pt]], device=dev),
                    torch.tensor([c0], device=dev),
                    torch.tensor([len(prompt)], device=dev))
            steps = [lg[0]]
            cur = [int(torch.argmax(lg[0]))] if forced is None else forced
            for i in range(n_new - 1):
                pages, lg = decode_step_paged(
                    params, cfg, pages, table,
                    torch.tensor([cur[i]], device=dev),
                    torch.tensor([len(prompt) + i], device=dev))
                steps.append(lg[0])
                if forced is None:
                    cur.append(int(torch.argmax(lg[0])))
            forced = cur
            logits[quant] = torch.stack(steps)
    exact = logits[None]
    drift = (exact - logits["int8"]).abs().max().item()
    spread = (exact.amax(dim=-1) - exact.amin(dim=-1)).max().item()
    return drift, spread


def profile_decode(params, cfg, serve_cfg, dev, prompts, n_new: int,
                   tag: str, rounds: int = 8, factory=None):
    """Device time of decode-only rounds (all 8 slots live, prefills
    done) under torch.profiler: ms per round on the host clock, device
    busy ms per round (sum of kernel times), and the largest kernels.
    Returns (host ms, busy ms) a round."""
    from torch.profiler import ProfilerActivity, profile

    from easydist_tpu_torch.serve import GenerationSession

    factory = factory or GenerationSession.for_gpt
    sess = factory(params, cfg, config=serve_cfg, device=dev)
    for p in prompts[:serve_cfg.max_decode_slots]:
        sess.submit(p, max_new_tokens=n_new)
    while sess._pending or any(p.jobs for p in sess._pools.values()):
        sess.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            sess.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    kernels = [(e.key, e.self_device_time_total / 1e3 / rounds)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != "easydist_compile.state_copy"]
    busy = sum(ms for _, ms in kernels)
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    program = sess._program("decode") if sess._paged else sess._decode_c
    n_ops = sum(n.op == "call_function"
                for r in program._cache.values()
                for n in r.graph_module.graph.nodes)
    print(f"profile {tag} bf16 decode rounds (8 live slots): {wall_ms:.3f} "
          f"ms per round on the host clock, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%); the decode graph replays "
          f"{n_ops} aten calls per round")
    for name, ms in top:
        print(f"  {ms:8.4f} ms/round  {name[:90]}")
    sess.run_until_drained()
    return wall_ms, busy


# ------------------------------------------------ speculation (phase 11)

SPEC_K = 4


def make_spec_prompts(vocab: int, seed: int = 0):
    """Phase 4's prompts (`make_prompts`), each of 32 tokens or more
    ending with a repeat of an earlier 16-token span of itself, so the
    n-gram drafter has something to propose."""
    rs = np.random.RandomState(seed + 11)
    out = []
    for p in make_prompts(vocab, seed):
        p = list(p)
        if len(p) >= 32:
            j = int(rs.randint(0, len(p) - 31))
            p[-16:] = p[j:j + 16]
        out.append(p)
    return out


def check_ids(tag: str, ids, *refs):
    """Every request's ids equal each reference's."""
    for name, ref in refs:
        bad = [i for i, (a, r) in enumerate(zip(ids, ref)) if a != r]
        if bad or len(ids) != len(ref):
            raise AssertionError(f"{tag}: ids differ from {name} in "
                                 f"requests {bad}")


@contextlib.contextmanager
def drafter_b4_launches():
    """Counts B4's launches made inside `SmallModelDrafter._feed` (the
    draft model's decode steps) while the block runs; yields a
    one-element list that the count accumulates in."""
    from easydist_tpu_torch.ops import flash_attention as fa
    from easydist_tpu_torch.serve import speculate

    feed = speculate.SmallModelDrafter._feed
    count = [0]

    def counted_feed(self, st, token, pos):
        before = fa.flash_decode_attention.launches
        try:
            return feed(self, st, token, pos)
        finally:
            count[0] += fa.flash_decode_attention.launches - before

    speculate.SmallModelDrafter._feed = counted_feed
    try:
        yield count
    finally:
        speculate.SmallModelDrafter._feed = feed


def spec_counts(sess):
    c = sess.metrics.snapshot()["counters"]
    steps = c.get("verify_steps", 0)
    return {"verify_rounds": steps,
            "proposed": c.get("draft_tokens_proposed", 0),
            "accepted": c.get("draft_tokens_accepted", 0),
            "committed": c.get("verify_tokens_committed", 0),
            "host_ms_per_verify_round": (c.get("verify_host_us", 0) / 1e3
                                         / steps if steps else None)}


def bf16_pass(params, cfg, prompts, n_new: int, serve_cfg, dev):
    """One timed pass of `prompts` through a fresh session, with the host
    time of each plain decode round and each bucketed verify round (both
    end in the host copy of their ids, so no extra synchronisation).
    Returns (tokens, seconds, {"decode"/"verify": (rounds, seconds)})."""
    from easydist_tpu_torch.serve import GenerationSession

    sess = GenerationSession.for_gpt(params, cfg, config=serve_cfg,
                                     device=dev)
    spent = {"decode": [0, 0.0], "verify": [0, 0.0]}
    for name, key in (("_decode_round", "decode"),
                      ("_verify_round_bucketed", "verify")):
        def timed(*args, _fn=getattr(sess, name), _key=key):
            t0 = time.perf_counter()
            try:
                return _fn(*args)
            finally:
                spent[_key][0] += 1
                spent[_key][1] += time.perf_counter() - t0
        setattr(sess, name, timed)
    t0 = time.perf_counter()
    futs = [sess.submit(p, max_new_tokens=n_new) for p in prompts]
    sess.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = sum(len(f.result(timeout=0)["ids"]) for f in futs)
    return n, secs, {k: tuple(v) for k, v in spent.items()}


def spec_phase(dev, cfg_kw=None, n_new: int = 32, serve_kw=None,
               seed: int = 0, n_prompts: int = 12, bf16: bool = True):
    """Phase 11: speculative decoding (speculate_k=4) on phase 4's
    config, weights and prompt lengths, each prompt of 32 tokens or more
    ending with a repeat of its own 16-token span.  (a) bucketed, n-gram
    drafter: ids equal the uncached re-forward and a plain session's, at
    least one verify round, one verify signature for the bucket, B4
    launched 12 x the plain decode rounds.  (b) paged, n-gram drafter:
    ids equal, a verify round, one verify signature, B5 launched 12 x the
    plain rounds, the page-table audit run after every rollback, and
    every arena page free once the trie is emptied after the drain.  (c)
    bucketed, the target drafting for itself: ids equal, every proposal
    accepted, one draft signature, the drafter's B4 launches 12 x its
    feeds (and all B4 launches 12 x (plain rounds + feeds)).  Prints the
    proposed / accepted / committed tokens, the host ms of a verify
    round, and bf16 tokens/s with and without speculation on (a)'s
    traffic (timed passes in the order plain, spec, spec, plain, with the
    host ms of a decode round and of a verify round).  Returns B4's
    launches in (a) and B5's in (b)."""
    from easydist_tpu_torch.kv import audit_page_table
    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_init
    from easydist_tpu_torch.serve import ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg_kw = cfg_kw or {}
    cfg = GPTConfig.small(**cfg_kw)
    serve_kw = serve_kw or SERVE_KW
    params = gpt_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    prompts = make_spec_prompts(cfg.vocab, seed)[:n_prompts]
    ref = [uncached_greedy(params, cfg, p, n_new) for p in prompts]
    plain, *_ = serve(params, cfg, prompts, n_new, ServeConfig(**serve_kw),
                      dev)
    check_ids("spec plain", plain, ("the uncached re-forward", ref))
    refs = (("the uncached re-forward", ref), ("the plain session", plain))
    on_card = dev.type == "cuda"
    out = {}

    # (a) bucketed, n-gram drafter
    spec_cfg = ServeConfig(**{**serve_kw, "speculate_k": SPEC_K})
    ids, sess, launches, rounds, secs = serve(params, cfg, prompts, n_new,
                                              spec_cfg, dev)
    counts = spec_counts(sess)
    check_ids("spec 11a", ids, *refs)
    sigs = sess.stats()["verify_signatures"]
    if counts["verify_rounds"] < 1 or sigs["size"] != 1:
        raise AssertionError(f"spec 11a: {counts}, verify signatures {sigs}")
    check_launches("spec 11a", launches, "flash_decode", cfg.layers, rounds,
                   dev)
    out["a"] = launches["flash_decode"]
    print(f"spec 11a bucketed ngram f32: ids equal the uncached re-forward "
          f"and the plain session for all {len(prompts)} requests; {counts}; "
          f"1 verify signature; {rounds} plain decode rounds, B4 launches "
          f"{launches['flash_decode']} = {cfg.layers} x {rounds}; "
          f"{secs:.2f} s incl. tracing")

    # (b) paged, n-gram drafter
    paged_cfg = ServeConfig(**{**serve_kw, "speculate_k": SPEC_K,
                               "kv_layout": "paged"})
    ids, sess, launches, rounds, secs = serve(params, cfg, prompts, n_new,
                                              paged_cfg, dev)
    counts = spec_counts(sess)
    check_ids("spec 11b", ids, *refs)
    st = sess.stats()
    c = st["metrics"]["counters"]
    if counts["verify_rounds"] < 1 or st["verify_signatures"]["size"] != 1:
        raise AssertionError(f"spec 11b: {counts}, verify signatures "
                             f"{st['verify_signatures']}")
    if c.get("speculative_rollback_audits") != counts["verify_rounds"]:
        raise AssertionError(f"spec 11b: {c.get('speculative_rollback_audits')}"
                             f" rollback audits for {counts['verify_rounds']} "
                             f"verify rounds")
    check_launches("spec 11b", launches, "paged_decode", cfg.layers, rounds,
                   dev)
    pool = next(iter(sess._pools.values()))
    problems = audit_page_table(pool.pool, pool.table, trie=pool.trie)
    trie_pages = pool.pool.in_use
    while pool.trie is not None and pool.trie.evict_lru():
        pass
    if problems or pool.pool.n_free != pool.pool.n_pages:
        raise AssertionError(f"spec 11b: audit {problems}; {pool.pool.n_free}"
                             f" of {pool.pool.n_pages} pages free after the "
                             f"drain and the trie's eviction")
    out["b"] = launches["paged_decode"]
    print(f"spec 11b paged ngram f32: ids equal for all {len(prompts)} "
          f"requests; {counts}; 1 verify signature; page-table audit clean "
          f"after each of {c['speculative_rollback_audits']} rollbacks "
          f"({c.get('speculative_rollback_pages_released', 0)} spill pages "
          f"released); after the drain the trie held {trie_pages} pages and "
          f"all {pool.pool.n_pages} were free once it was emptied; {rounds} "
          f"plain rounds, B5 launches {launches['paged_decode']} = "
          f"{cfg.layers} x {rounds}; {secs:.2f} s incl. tracing")
    del sess, pool

    # (c) bucketed, the target's own weights as the draft model
    draft_cfg = ServeConfig(**{**serve_kw, "speculate_k": SPEC_K,
                               "speculate_drafter": "draft_model"})
    with drafter_b4_launches() as drafter_launches:
        ids, sess, launches, rounds, secs = serve(
            params, cfg, prompts, n_new, draft_cfg, dev,
            draft_model=(params, cfg))
    counts = spec_counts(sess)
    drafter = sess._drafter
    check_ids("spec 11c", ids, *refs)
    if counts["proposed"] < 1 or counts["accepted"] != counts["proposed"]:
        raise AssertionError(f"spec 11c: not every proposal accepted: "
                             f"{counts}")
    if drafter.cache_stats()["size"] != 1 or drafter.n_states:
        raise AssertionError(f"spec 11c: draft signatures "
                             f"{drafter.cache_stats()}, {drafter.n_states} "
                             f"draft caches left after the drain")
    want = cfg.layers * drafter.feeds if on_card else 0
    if drafter_launches[0] != want:
        raise AssertionError(f"spec 11c: the drafter launched B4 "
                             f"{drafter_launches[0]} times, expected {want}")
    check_launches("spec 11c", launches, "flash_decode", cfg.layers,
                   rounds + drafter.feeds, dev)
    print(f"spec 11c bucketed self-draft f32: ids equal for all "
          f"{len(prompts)} requests; every proposal accepted {counts}; 1 "
          f"draft signature; drafter B4 launches {drafter_launches[0]} = "
          f"{cfg.layers} x {drafter.feeds} feeds; all B4 launches "
          f"{launches['flash_decode']} = {cfg.layers} x ({rounds} plain "
          f"rounds + {drafter.feeds} feeds); {secs:.2f} s incl. tracing")
    del sess, drafter

    if bf16:
        cfg16 = GPTConfig.small(**{**cfg_kw, "dtype": "bfloat16"})
        configs = {"plain": ServeConfig(**serve_kw), "spec": spec_cfg}
        for sc in configs.values():
            # an untimed pass first traces every program the timed passes
            # run (the verify step only traces once a draft appears)
            serve(params, cfg16, prompts, n_new, sc, dev)
        for tag in ("plain", "spec", "spec", "plain"):
            n16, secs16, rounds16 = bf16_pass(params, cfg16, prompts, n_new,
                                              configs[tag], dev)
            per_round = {k: f"{1e3 * s / n:.3f} ms x {n}"
                         for k, (n, s) in rounds16.items() if n}
            print(f"spec bf16 {tag}: {n16} tokens in {secs16:.3f} s = "
                  f"{n16 / secs16:.1f} tokens/s, traced beforehand; host "
                  f"clock a round: {per_round}")
    print(f"spec phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------- host tier, lifecycle (phase 12)

# two full-length sequences of 64-token pages (4.7 MB a page at GPT-2
# small in f32); a trie budget above the arena's, so the arena binds
TIER_KW = dict(kv_layout="paged", kv_arena_pages=32,
               kv_host_tier_bytes=256 * 2**20, prefix_cache_bytes=2**30)


def tier_waves(vocab: int, seed: int = 0):
    """Wave 1: 8 prompts sharing a 512-token prefix; wave 2: 8 prompts
    with no shared prefix (200-330 tokens), whose pages push wave 1's
    trie pages to the host; wave 3: wave 1's prompts again."""
    rs = np.random.RandomState(seed + 12)
    shared = rs.randint(0, vocab, 512).tolist()
    wave1 = [shared + rs.randint(0, vocab, n).tolist()
             for n in (40, 70, 9, 100, 64, 33, 1, 150)]
    wave2 = [rs.randint(0, vocab, n).tolist()
             for n in (260, 200, 330, 240, 300, 210, 280, 250)]
    return wave1, wave2, shared


def watch_promotions(sess, tier):
    """Record each page's digest at demotion (of the export the tier is
    handed) and, right after each promotion's import, compare the arena
    page exported again with it.  Returns the list of (key, equal)."""
    from easydist_tpu_torch.kv.tier import page_digest

    put_digest, seen, last = {}, [], {}
    put, get, imp = tier.put, tier.get, sess._import_arena_page

    def watched_put(key, arrays):
        put_digest[key] = page_digest({k: v.cpu() for k, v in arrays.items()})
        return put(key, arrays)

    def watched_get(key):
        last["key"] = key
        return get(key)

    def watched_import(pool, kv, pid):
        imp(pool, kv, pid)
        key = last.pop("key", None)
        if key is not None:
            back = sess._export_arena_page(pool, pid)
            seen.append((key, page_digest({k: v.cpu() for k, v in
                                           back.items()}) == put_digest[key]))

    tier.put, tier.get = watched_put, watched_get
    sess._import_arena_page = watched_import
    return seen


def run_waves(sess, waves, n_new: int):
    ids = []
    for wave in waves:
        futs = [sess.submit(p, max_new_tokens=n_new) for p in wave]
        sess.run_until_drained()
        ids.append([f.result(timeout=0)["ids"] for f in futs])
    return ids


def tier_run(tag, params, cfg, waves, n_new, serve_cfg, dev, kernel,
             plan=""):
    """One tiered session over the three waves, every decode kernel's
    count set to 0 just before and read just after; the demotion and
    promotion gates.  Returns (ids by wave, session, launches)."""
    from easydist_tpu_torch.kv import audit_page_table
    from easydist_tpu_torch.resilience import faultinject
    from easydist_tpu_torch.serve import GenerationSession

    sess = GenerationSession.for_gpt(params, cfg, config=serve_cfg,
                                     device=dev)
    bucket = max(serve_cfg.decode_buckets)
    sess._pool_for(bucket)
    pool = sess._pools[bucket]
    seen = watch_promotions(sess, pool.tier)
    counters = decode_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with faultinject.fault_plan(plan):
        ids = run_waves(sess, waves, n_new)
        unfired = faultinject.unfired()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    rounds = sess.metrics.counter("decode_steps")
    check_launches(tag, launches, kernel, cfg.layers, rounds, dev)
    ts = pool.tier.stats()
    problems = audit_page_table(pool.pool, pool.table, trie=pool.trie,
                                tier=pool.tier)
    if unfired or ts["demotions"] < 1 or ts["promotions"] < 1 or problems:
        raise AssertionError(f"{tag}: unfired {unfired}, tier {ts}, audit "
                             f"{problems}")
    if not seen or not all(ok for _, ok in seen):
        raise AssertionError(f"{tag}: promoted pages not bitwise equal to "
                             f"their export before demotion: {seen}")
    reused = sess.metrics.counter("prefix_tokens_reused")
    print(f"{tag}: {sum(len(w) for w in waves)} requests in 3 waves, "
          f"{secs:.2f} s incl. tracing; tier {ts}; {len(seen)} promoted "
          f"pages bitwise equal (digests{', scales included' if 'k_scale' in pool.arena else ''})"
          f" to their export before demotion; page-table audit clean; "
          f"prefix tokens reused {reused}; demote "
          f"{1e3 * pool.demote_s / ts['demotions']:.3f} ms a page, promote "
          f"{1e3 * pool.promote_s / ts['promotions']:.3f} ms a page (host "
          f"clock); {kernel} launches {launches[kernel]} = {cfg.layers} x "
          f"{rounds} rounds")
    return ids, sess, launches


def tier_phase(dev, cfg_kw=None, n_new: int = 32, serve_kw=None,
               seed: int = 0, tier_kw=None):
    """Phase 12: the host tier and the session lifecycle, paged, f32 and
    int8, on three waves of traffic (`tier_waves`).  Tier gates: ids
    equal the uncached re-forward (f32; int8: wave 3 equals wave 1), at
    least one demotion and one promotion, every promoted page bitwise
    equal to its export before demotion (digests; scales included on
    int8), a clean page-table and tier audit, and B5 (f32) / B6 (int8)
    launched 12 x the rounds.  The f32 run is a fault drill too:
    `kv.tier.fetch_corrupt` armed once gives fetch_retries 1.
    Lifecycle gates: `drain()`'s hot pages imported by a fresh session
    make a prompt with the shared prefix hit its prefix cache with equal
    ids; `evacuate()` after 8 steps returns descriptors whose prompt +
    ids, resubmitted to a fresh session with the remaining budget, give
    the uninterrupted ids.  Returns B5's and B6's launches."""
    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_init
    from easydist_tpu_torch.serve import GenerationSession, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg_kw = cfg_kw or {}
    cfg = GPTConfig.small(**cfg_kw)
    serve_kw = {**(serve_kw or SERVE_KW), **(tier_kw or TIER_KW)}
    params = gpt_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    wave1, wave2, shared = tier_waves(cfg.vocab, seed)
    ref1 = [uncached_greedy(params, cfg, p, n_new) for p in wave1]
    ref2 = [uncached_greedy(params, cfg, p, n_new) for p in wave2]
    f32_cfg = ServeConfig(**serve_kw)
    ids, sess, launches = tier_run(
        "tier f32", params, cfg, (wave1, wave2, wave1), n_new, f32_cfg, dev,
        "paged_decode", plan="kv.tier.fetch_corrupt@1")
    for k, (got, ref) in enumerate(zip(ids, (ref1, ref2, ref1))):
        check_ids(f"tier f32 wave {k + 1}", got,
                  ("the uncached re-forward", ref))
    retries = next(iter(sess._pools.values())).tier.stats()["fetch_retries"]
    if retries != 1:
        raise AssertionError(f"tier f32: fetch_retries {retries} with "
                             f"kv.tier.fetch_corrupt armed once")
    print(f"tier f32: ids equal the uncached re-forward in all 3 waves; "
          f"the corrupt-fetch drill refetched once (fetch_retries 1)")
    out = {"paged_decode": launches["paged_decode"]}

    # drain -> hot pages -> a fresh session imports them
    pages = sess.drain()
    n_paths = sum(len(v) for v in pages.values())
    del sess
    fresh = GenerationSession.for_gpt(params, cfg, config=f32_cfg,
                                      device=dev)
    imported = fresh.import_hot_pages(pages)
    del pages
    rs = np.random.RandomState(seed + 120)
    probe = shared + rs.randint(0, cfg.vocab, 90).tolist()
    affinity = fresh.prefix_affinity(probe)
    fut = fresh.submit(probe, max_new_tokens=n_new)
    fresh.run_until_drained()
    reused = fresh.metrics.counter("prefix_tokens_reused")
    check_ids("drain import", [fut.result(timeout=0)["ids"]],
              ("the uncached re-forward",
               [uncached_greedy(params, cfg, probe, n_new)]))
    if imported < 1 or reused < len(shared):
        raise AssertionError(f"drain import: {imported} chunks imported, "
                             f"{reused} prefix tokens reused")
    print(f"lifecycle drain: {n_paths} hot paths exported, {imported} "
          f"chunks imported by a fresh session; a prompt with the shared "
          f"prefix had affinity {affinity}, reused {reused} prefix tokens "
          f"and gave the uncached re-forward's ids")
    del fresh

    # evacuate after 8 steps -> resume elsewhere
    sess = GenerationSession.for_gpt(params, cfg, config=f32_cfg,
                                     device=dev)
    futs = [sess.submit(p, max_new_tokens=n_new) for p in wave1]
    for _ in range(8):
        sess.step()
    descs = sess.evacuate()
    partial = [f.result(timeout=0) for f in futs]
    if len(descs) != len(wave1) or not any(d["ids"] for d in descs) \
            or any(p["finish_reason"] != "evacuated" for p in partial):
        raise AssertionError(f"evacuate: {len(descs)} descriptors, partial "
                             f"lengths {[len(d['ids']) for d in descs]}")
    del sess
    resumed = GenerationSession.for_gpt(params, cfg, config=f32_cfg,
                                        device=dev)
    rfuts = [resumed.submit(d["prompt"] + d["ids"],
                            max_new_tokens=d["max_new"] - len(d["ids"]))
             for d in descs]
    resumed.run_until_drained()
    joined = {tuple(d["prompt"]): d["ids"] + f.result(timeout=0)["ids"]
              for d, f in zip(descs, rfuts)}
    check_ids("evacuate resume", [joined[tuple(p)] for p in wave1],
              ("the uncached re-forward", ref1))
    print(f"lifecycle evacuate: {len(descs)} descriptors after 8 steps "
          f"(partial ids {[len(d['ids']) for d in descs]}); resubmitted "
          f"with the remaining budget they give the uninterrupted ids")
    del resumed

    # int8 pages with the tier
    int8_cfg = ServeConfig(**{**serve_kw, "kv_quant_dtype": "int8"})
    ids8, sess, launches = tier_run(
        "tier int8", params, cfg, (wave1, wave2, wave1), n_new, int8_cfg, dev,
        "paged_decode_quant")
    check_ids("tier int8 wave 3", ids8[2], ("wave 1", ids8[0]))
    n = sum(map(len, ref1 + ref2))
    same = sum(a == b for x, y in zip(ids8[0] + ids8[1], ref1 + ref2)
               for a, b in zip(x, y))
    print(f"tier int8: wave 3 ids equal wave 1's; ids equal the exact f32 "
          f"re-forward at {same} of {n} positions")
    out["paged_decode_quant"] = launches["paged_decode_quant"]
    del sess
    print(f"tier phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------- ServeEngine (phase 13)

ENGINE_KW = dict(batch_buckets=(1, 4, 8), seq_buckets=(256, 1024),
                 max_wait_ms=10, max_queue=64)


def engine_phase(dev, cfg_kw=None, engine_kw=None, seed: int = 0,
                 clients: int = 6, per_client: int = 4,
                 lengths=(16, 1024), exec_timeout_ms: float = 500.0):
    """Phase 13: `ServeEngine` over `gpt_apply` with attention="flash"
    (B1 once per layer per batch), compiled by
    `fxfront.easydist_compile(infer, state_io={})` with the params as
    `state`, warmed over batch buckets (1, 4, 8) x seq buckets (256,
    1024).  6 client threads x 4 requests of 16-1024 tokens (numpy seed
    7).  Gates: every result within rtol 1e-4 / atol 1e-5 of the same
    compiled function on the request alone at its seq bucket; 6
    executables and 6 cache misses, both in the engine's counters and in
    the compiled function's own signature cache (6 entries, 6 traces,
    the reference calls included), 24 completed, none failed; B1
    launched 12 x the batches executed; a request with deadline_ms=0
    raises DeadlineExceededError and the engine serves on;
    `serve.oom_bucket` armed once disables the bucket and its requests
    are re-packed and answered; `serve.exec_timeout` with
    `exec_timeout_ms` set raises ExecTimeoutError and the next batch is
    served.  Prints e2e p50 / p99 and the batch occupancy.  Returns B1's
    launches in the traffic."""
    import threading

    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_apply, gpt_init
    from easydist_tpu_torch.ops import flash_attention as fa
    from easydist_tpu_torch.resilience import faultinject
    from easydist_tpu_torch.serve import (DeadlineExceededError,
                                          ExecTimeoutError, ServeConfig,
                                          ServeEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = GPTConfig.small(**{**(cfg_kw or {}), "attention": "flash"})
    engine_kw = engine_kw or ENGINE_KW
    params = gpt_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                      device=dev)

    def infer(params, tokens):
        return gpt_apply(params, cfg, tokens)

    comp = easydist_compile(infer, state_io={})
    eng = ServeEngine(comp, ServeConfig(**engine_kw), state=params,
                      device=dev)
    t0 = time.perf_counter()
    warmed = eng.warmup([np.zeros(lengths[0], np.int32)])
    n_buckets = len(engine_kw["batch_buckets"]) * len(engine_kw["seq_buckets"])
    if warmed != n_buckets:
        raise AssertionError(f"engine: warmed {warmed} of {n_buckets}")
    print(f"engine: warmed {warmed} executables in "
          f"{time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(7)
    reqs = [rs.randint(0, cfg.vocab, int(rs.randint(lengths[0],
                                                    lengths[1] + 1)))
            .astype(np.int32) for _ in range(clients * per_client)]
    results, errors = {}, []

    def client(cid):
        try:
            for j in range(per_client):
                k = cid * per_client + j
                results[k] = eng.infer(reqs[k], timeout=600)
        except Exception as e:  # surfaced below
            errors.append((cid, repr(e)))

    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    with eng:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        b1 = fa.flash_fwd.launches
        st = eng.stats()
        c = st["counters"]
        batches = c.get("batches_executed", 0)
        if errors or len(results) != len(reqs):
            raise AssertionError(f"engine: client errors {errors}")
        if (st["distinct_executables"], c.get("compile_cache_misses"),
                c.get("requests_completed"), c.get("requests_failed", 0)) \
                != (n_buckets, n_buckets, len(reqs), 0):
            raise AssertionError(f"engine: stats {st}")
        want = cfg.layers * batches if dev.type == "cuda" else 0
        if b1 != want:
            raise AssertionError(f"engine: B1 launched {b1} times, expected "
                                 f"{cfg.layers} x {batches} batches")
        worst, bitwise = 0.0, 0
        pad = engine_kw.get("pad_value", 0)
        with torch.no_grad():
            for k, r in enumerate(reqs):
                s = min(b for b in engine_kw["seq_buckets"] if b >= len(r))
                alone = np.full((1, s), pad, np.int32)
                alone[0, :len(r)] = r
                ref = comp(params, torch.from_numpy(alone).to(dev))
                ref = ref[0, :len(r)].cpu().numpy()
                got = results[k]
                if got.shape != ref.shape or not np.allclose(
                        got, ref, rtol=1e-4, atol=1e-5):
                    raise AssertionError(
                        f"engine: request {k} ({len(r)} tokens) differs from "
                        f"the compiled function on it alone: max "
                        f"{np.abs(got - ref).max()}")
                worst = max(worst, float(np.abs(got - ref).max()))
                bitwise += bool(np.array_equal(got, ref))
        # the engine's counters key on the packed shapes; the compiled
        # function's own signature cache says how often it really traced
        bc = eng.stats()["backend_cache"]
        if (bc["size"], bc["misses"]) != (n_buckets, n_buckets):
            raise AssertionError(
                f"engine: the compiled function holds {bc['size']} "
                f"signatures after {bc['misses']} traces, expected "
                f"{n_buckets} of each")
        e2e = st["latency"]["e2e"]
        print(f"engine f32 flash: {len(reqs)} requests from {clients} "
              f"threads in {secs:.2f} s, {batches} batches, B1 launches {b1}"
              f" = {cfg.layers} x {batches}; {st['distinct_executables']} "
              f"executables, cache misses {c['compile_cache_misses']}, hits "
              f"{c.get('compile_cache_hits', 0)}; compiled function's "
              f"signature cache {bc}; every result within rtol "
              f"1e-4 / atol 1e-5 of the request alone (largest difference "
              f"{worst:.3e}; bitwise equal {bitwise} of {len(reqs)}); e2e "
              f"p50 {e2e.get('p50_s')} s, p99 {e2e.get('p99_s')} s (bucket "
              f"upper bounds), mean {e2e.get('mean_s')} s; batch occupancy "
              f"{st['batch_occupancy']}")

        # drills: deadline, OOM bucket
        try:
            eng.infer(reqs[0], deadline_ms=0, timeout=60)
            raise AssertionError("engine: deadline_ms=0 was served")
        except DeadlineExceededError:
            pass
        np.testing.assert_allclose(eng.infer(reqs[0], timeout=60),
                                   results[0], rtol=1e-4, atol=1e-5)
        big = max(engine_kw["batch_buckets"])
        n = min(len(reqs), big // 2 + 1)
        with faultinject.fault_plan("serve.oom_bucket@1"):
            futs = [eng.submit(reqs[k]) for k in range(n)]
            outs = [f.result(timeout=600) for f in futs]
            unfired = faultinject.unfired()
        for k, o in enumerate(outs):
            np.testing.assert_allclose(o, results[k], rtol=1e-4, atol=1e-5)
        h = eng.health()
        if unfired or h["disabled_batch_buckets"] != [big] \
                or h["oom_degradations"] != 1:
            raise AssertionError(f"engine: OOM drill {h}, unfired {unfired}")
    print(f"engine drills: deadline_ms=0 raised DeadlineExceededError and "
          f"the next request was served; serve.oom_bucket disabled bucket "
          f"{big} and its {n} requests were re-packed and answered; health "
          f"{h}")

    # watchdog drill on a second engine over the same compiled function
    eng2 = ServeEngine(comp, ServeConfig(**engine_kw,
                                         exec_timeout_ms=exec_timeout_ms),
                       state=params, device=dev)
    short = next(r for r in reqs if len(r) <= min(engine_kw["seq_buckets"]))
    with eng2:
        with faultinject.fault_plan("serve.exec_timeout@1"):
            try:
                eng2.infer(short, timeout=60)
                raise AssertionError("engine: the wedged dispatch was served")
            except ExecTimeoutError:
                pass
        served = eng2.infer(short, timeout=60)
        # let the abandoned dispatch finish before the engine stops
        time.sleep(3 * exec_timeout_ms / 1e3)
    h2 = eng2.health()
    if h2["exec_timeouts"] != 1 or served.shape != (len(short), cfg.vocab):
        raise AssertionError(f"engine: watchdog drill {h2}")
    print(f"engine watchdog: serve.exec_timeout raised ExecTimeoutError "
          f"after {exec_timeout_ms:.0f} ms and the next batch was served; "
          f"engine phase {time.perf_counter() - t_phase:.1f} s")
    return b1


# ------------------------------------------------ sharding engine, solver


# The rule table of phase 8b and the platform cases of phase 8a.  The
# CPU tests (tests/test_torch_metashard.py, tests/test_torch_platform.py)
# import them from here and run them at narrow widths on the CPU, and hold
# the same table against the JAX package.

aten = torch.ops.aten


def F(*shape):
    """A float32 argument of this shape, uniform in [0.5, 1.5]."""
    return ("f", shape)


def I(*shape):
    """An int64 argument of this shape, uniform in [1, 8)."""
    return ("i", shape)


# name: (aten op, positional args at GPT-2 small's full width (batch 8,
# seq 1024, dim 768, 12 heads, vocab 50304), the same at a narrow width,
# keyword args).  "view" is not executed: its rule is `view_rule`'s.
RULE_CASES = {
    "addmm_c_attn": (aten.addmm.default, [F(2304), F(8192, 768), F(768, 2304)],
                     [F(24), F(16, 8), F(8, 24)], {}),
    "addmm_c_fc": (aten.addmm.default, [F(3072), F(8192, 768), F(768, 3072)],
                   [F(32), F(16, 8), F(8, 32)], {}),
    "addmm_c_proj": (aten.addmm.default, [F(768), F(8192, 3072), F(3072, 768)],
                     [F(8), F(16, 32), F(32, 8)], {}),
    "mm_lm_head": (aten.mm.default, [F(8192, 768), F(768, 50304)],
                   [F(16, 8), F(8, 40)], {}),
    "bmm_attn": (aten.bmm.default, [F(96, 1024, 64), F(96, 64, 1024)],
                 [F(6, 16, 4), F(6, 4, 16)], {}),
    "softmax": (aten._softmax.default, [F(8, 12, 1024, 1024), -1, False],
                [F(2, 6, 16, 16), -1, False], {}),
    "layer_norm": (aten.native_layer_norm.default,
                   [F(8, 1024, 768), [768], F(768), F(768), 1e-5],
                   [F(2, 16, 8), [8], F(8), F(8), 1e-5], {}),
    "gelu": (aten.gelu.default, [F(8192, 3072)], [F(16, 32)],
             {"approximate": "tanh"}),
    "add_bcast": (aten.add.Tensor, [F(8, 1024, 768), F(1024, 768)],
                  [F(2, 16, 8), F(16, 8)], {}),
    "add_residual": (aten.add.Tensor, [F(8192, 768), F(8192, 768)],
                     [F(16, 8), F(16, 8)], {}),
    "embedding": (aten.embedding.default, [F(50304, 768), I(8, 1024)],
                  [F(40, 8), I(2, 16)], {}),
    "log_softmax": (aten._log_softmax.default, [F(8192, 50304), -1, False],
                    [F(16, 40), -1, False], {}),
    "view": (aten.view.default, [F(8, 1024, 768), [8, 1024, 12, 64]],
             [F(2, 16, 8), [2, 16, 2, 4]], {}),
}

C0, C1, C2 = ("concat", 0), ("concat", 1), ("concat", 2)
SUM = ("reduce", "sum")

# name: (group of each dim of each tensor argument, 0 = not shardable;
# {group: recombine of the output, a list for an op with several
# outputs}).  A dim with a block or halo would show as (group, block,
# (halo width, halo dim)); none of these ops has one.
GPT2_SMALL_RULES = {
    # bias + x @ w: the bias blocks the contraction (sum of parts = 2 bias)
    "addmm_c_attn": ([[1], [2, 0], [0, 1]], {1: C1, 2: C0}),
    "addmm_c_fc": ([[1], [2, 0], [0, 1]], {1: C1, 2: C0}),
    "addmm_c_proj": ([[1], [2, 0], [0, 1]], {1: C1, 2: C0}),
    "mm_lm_head": ([[1, 2], [2, 3]], {1: C0, 2: SUM, 3: C1}),
    "bmm_attn": ([[1, 2, 3], [1, 3, 4]], {1: C0, 2: C1, 3: SUM, 4: C2}),
    "softmax": ([[1, 2, 3, 0]], {1: C0, 2: C1, 3: C2}),
    # outputs: normalized x, mean, rstd
    "layer_norm": ([[1, 2, 0], [0], [0]], {1: [C0, C0, C0], 2: [C1, C1, C1]}),
    "gelu": ([[1, 2]], {1: C0, 2: C1}),
    "add_bcast": ([[1, 2, 3], [2, 3]], {1: C0, 2: C1, 3: C2}),
    "add_residual": ([[1, 2], [1, 2]], {1: C0, 2: C1}),
    # weight [vocab, dim], ids [batch, seq]: the vocab rows do not split
    "embedding": ([[0, 1], [2, 3]], {1: C2, 2: C0, 3: C1}),
    "log_softmax": ([[1, 0]], {1: C0}),
    "view": ([[1, 2, 3]], {1: C0, 2: C1, 3: C2}),
}


def case_args(specs, rand_float, rand_int):
    """The positional args of a case: `rand_float(shape)` and
    `rand_int(shape)` make the tensors, the other entries pass as they
    are."""
    out = []
    for s in specs:
        if isinstance(s, tuple) and s[:1] == ("f",):
            out.append(rand_float(s[1]))
        elif isinstance(s, tuple) and s[:1] == ("i",):
            out.append(rand_int(s[1]))
        else:
            out.append(s)
    return out


def recombine_summary(fn):
    """A recombine partial (or a list of them) in plain values:
    ("concat", dim) with any non-default halo/block, ("reduce", op),
    ("identity",).  Works on the partials of both packages."""
    if isinstance(fn, (list, tuple)):
        return [recombine_summary(f) for f in fn]
    name = fn.func.__name__
    kw = dict(fn.keywords)
    if name == "concat":
        extra = tuple(sorted((k, v) for k, v in kw.items()
                             if k != "dim" and v != {"halo": 0, "block": 1}[k]))
        return ("concat", kw.get("dim", 0)) + extra
    if name == "reduce":
        return ("reduce", kw["op"].value if "op" in kw else "sum")
    return (name,)


def rule_summary(space, recombines):
    """A discovered rule in plain values, as `GPT2_SMALL_RULES` writes it.
    Works on the rules of both packages."""
    def dim(d):
        if d.block == 1 and d.halo is None:
            return d.group
        return (d.group, d.block,
                None if d.halo is None else (d.halo.width, d.halo.dim))

    return ([[dim(d) for d in row] for row in space.table],
            {g: recombine_summary(fn) for g, fn in sorted(recombines.items())})


def _backends():
    """The port's torch and numpy platform backends."""
    from easydist_tpu_torch.platform import numpy_backend, torch_backend

    return torch_backend, numpy_backend


@contextlib.contextmanager
def _raises(exc):
    """Fails unless the block raises `exc`."""
    try:
        yield
    except exc:
        return
    raise AssertionError(f"{exc.__name__} not raised")


# Each case checks one op of the platform micro-API
# (`easydist_tpu_torch.platform._API`): the torch backend on tensors of
# `device` against the numpy backend on the same seeded inputs.  It
# raises on a mismatch.


def _inputs(seed, *shapes):
    rs = np.random.default_rng(seed)
    return [rs.uniform(0.5, 1.5, s).astype(np.float32) for s in shapes]


def _on(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _same(got, want):
    """Exact agreement of a torch result with a numpy one."""
    tb, _ = _backends()
    np.testing.assert_array_equal(tb.to_numpy(got), np.asarray(want))


def case_tensor(device):
    tb, nb = _backends()
    x, = _inputs(0, (3, 4))
    t, = _on(device, x)
    assert isinstance(t, tb.Tensor) and not isinstance(x, tb.Tensor)
    assert isinstance(x, nb.Tensor) and not isinstance(t, nb.Tensor)


def case_add(device):
    tb, nb = _backends()
    x, y = _inputs(1, (3, 4), (3, 4))
    _same(tb.add(*_on(device, x, y)), nb.add(x, y))


def case_equal(device):
    tb, nb = _backends()
    x, y = _inputs(2, (3, 4), (3, 4))
    tx, ty = _on(device, x, y)
    for a, b, ta, tb_ in ((x, x.copy(), tx, tx.clone()), (x, y, tx, ty),
                          (x, x[:2], tx, tx[:2])):
        assert tb.equal(ta, tb_) == nb.equal(a, b)
    assert tb.equal(tx, tx.clone()) and not tb.equal(tx, ty)


def case_allclose(device):
    tb, nb = _backends()
    x, = _inputs(3, (3, 4))
    from easydist_tpu_torch import config

    rtol = config.allclose_rtol
    near = x * np.float32(1 + 0.5 * rtol)
    far = x * np.float32(1 + 4 * rtol)
    tx, tnear, tfar = _on(device, x, near, far)
    got = [tb.allclose(tx, tnear), tb.allclose(tx, tfar),
           tb.allclose(tx, tx[:2])]
    assert got == [nb.allclose(x, near), nb.allclose(x, far),
                   nb.allclose(x, x[:2])] == [True, False, False]
    ints = np.arange(12).reshape(3, 4)
    ti = torch.from_numpy(ints).to(device)
    assert tb.allclose(ti, ti + 1) == nb.allclose(ints, ints + 1) is False
    assert tb.allclose(ti, ti.clone()) == nb.allclose(ints, ints) is True
    nan = np.where(x > 1, np.float32("nan"), x)
    tnan, = _on(device, nan)
    assert [tb.allclose(tnan, tnan), tb.allclose(tnan, tnan, equal_nan=True),
            tb.allclose(tnan, tx, equal_nan=True)] == [
        nb.allclose(nan, nan), nb.allclose(nan, nan, equal_nan=True),
        nb.allclose(nan, x, equal_nan=True)] == [False, True, False]


def case_zeros_like(device):
    tb, nb = _backends()
    x, = _inputs(4, (2, 5))
    got = tb.zeros_like(*_on(device, x))
    assert got.device.type == torch.device(device).type
    _same(got, nb.zeros_like(x))


def case_minimum(device):
    tb, nb = _backends()
    x, y = _inputs(5, (3, 4), (3, 4))
    _same(tb.minimum(*_on(device, x, y)), nb.minimum(x, y))


def case_maximum(device):
    tb, nb = _backends()
    x, y = _inputs(6, (3, 4), (3, 4))
    _same(tb.maximum(*_on(device, x, y)), nb.maximum(x, y))


def case_concatenate(device):
    tb, nb = _backends()
    x, y = _inputs(7, (2, 4), (2, 4))
    tx, ty = _on(device, x, y)
    for dim in (0, 1):
        _same(tb.concatenate([tx, ty], dim=dim),
              nb.concatenate([x, y], dim=dim))


def case_chunk(device):
    """Equal parts as `np.split` gives them; an uneven split raises in
    both backends (`jnp.split` raises too)."""
    tb, nb = _backends()
    x, = _inputs(8, (4, 6))
    tx, = _on(device, x)
    for chunks, dim in ((2, 0), (3, 1), (2, 1)):
        got = tb.chunk(tx, chunks, dim)
        want = nb.chunk(x, chunks, dim)
        assert len(got) == len(want) == chunks
        for g, w in zip(got, want):
            _same(g, w)
    for backend, t in ((tb, tx), (nb, x)):
        with _raises(ValueError):
            backend.chunk(t, 4, 1)


def case_narrow(device):
    tb, nb = _backends()
    x, = _inputs(9, (5, 6))
    tx, = _on(device, x)
    for dim, start, length in ((0, 1, 3), (1, 0, 6), (1, 4, 2)):
        _same(tb.narrow(tx, dim, start, length),
              nb.narrow(x, dim, start, length))


def case_clone(device):
    """A real copy: writing the clone leaves the original as it was."""
    tb, nb = _backends()
    x, = _inputs(10, (3, 4))
    tx, = _on(device, x)
    for backend, t in ((tb, tx), (nb, x)):
        c = backend.clone(t)
        c[0, 0] = -1.0
        assert float(t[0, 0]) == float(x[0, 0]) != float(c[0, 0])


def case_from_numpy(device):
    """New tensors go to `discovery_device`, dtype and values kept."""
    tb, nb = _backends()
    x, = _inputs(11, (3, 4))
    ids = np.arange(6, dtype=np.int64).reshape(2, 3)
    from easydist_tpu_torch import config

    saved, config.discovery_device = config.discovery_device, device
    try:
        for a in (x, ids, x[:, ::2]):
            t = tb.from_numpy(a)
            assert t.device.type == torch.device(device).type
            assert t.dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
            _same(t, nb.from_numpy(a))
    finally:
        config.discovery_device = saved


def case_to_numpy(device):
    """float32 exactly; bfloat16 (which numpy lacks) as float32, exactly
    the bfloat16 values."""
    tb, nb = _backends()
    x, = _inputs(12, (3, 4))
    tx, = _on(device, x)
    got = tb.to_numpy(tx)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, nb.to_numpy(x))
    bf = tx.to(torch.bfloat16)
    got = tb.to_numpy(bf)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bf.float().cpu().numpy())
    assert np.abs(got - x).max() <= np.abs(x).max() * 2.0 ** -8


def case_tree_flatten(device):
    """Same leaves in the same order as the numpy backend, and a round
    trip through `tree_unflatten` (its argument order is (leaves, spec))."""
    tb, nb = _backends()
    x, y = _inputs(13, (2,), (3,))
    tx, ty = _on(device, x, y)
    ttree = ((tx, [1, ty]), {"a": "tanh", "b": 2.0})
    ntree = ((x, [1, y]), {"a": "tanh", "b": 2.0})
    tleaves, tspec = tb.tree_flatten(ttree)
    nleaves, nspec = nb.tree_flatten(ntree)
    assert len(tleaves) == len(nleaves) == 5
    for t, n in zip(tleaves, nleaves):
        if isinstance(t, torch.Tensor):
            _same(t, n)
        else:
            assert t == n
    back = tb.tree_unflatten(tleaves, tspec)
    assert back[1] == ttree[1] and back[0][1][0] == 1
    assert back[0][0] is tx and back[0][1][1] is ty


def case_tree_unflatten(device):
    """New leaves into an old structure, as `MetaOp` swaps shards in."""
    tb, nb = _backends()
    x, y, z = _inputs(14, (2, 3), (2, 3), (4,))
    tx, ty, tz = _on(device, x, y, z)
    _, tspec = tb.tree_flatten(((tx, 3), {"k": tx}))
    _, nspec = nb.tree_flatten(((x, 3), {"k": x}))
    got = tb.tree_unflatten([ty, 3, tz], tspec)
    want = nb.tree_unflatten([y, 3, z], nspec)
    _same(got[0][0], want[0][0])
    _same(got[1]["k"], want[1]["k"])
    assert got[0][1] == want[0][1] == 3


def case_stack(device):
    tb, nb = _backends()
    x, y = _inputs(15, (2, 3), (2, 3))
    tx, ty = _on(device, x, y)
    for dim in (0, 1, 2):
        _same(tb.stack([tx, ty], dim=dim), nb.stack([x, y], dim=dim))


def case_batched_call(device):
    """One vmapped call equals the per-shard loop (bitwise for an
    elementwise op, at 1e-6 for a product); an op without a batching rule
    (`histc`) and an op that writes an input (`add_`) raise, and so does
    the numpy backend, so that `MetaOp` falls back to its loop."""
    tb, nb = _backends()
    x, w, m = _inputs(16, (2, 3, 4), (3, 4), (4, 5))
    tx, tw, tm = _on(device, x, w, m)

    def elementwise(a, b):
        return torch.tanh(a) * b

    got = tb.batched_call(elementwise, [tx, tw], (0, None))
    for s in range(2):
        assert torch.equal(got[s], elementwise(tx[s], tw))
    matmul = torch.backends.cuda.matmul
    saved, matmul.allow_tf32 = matmul.allow_tf32, False
    try:
        got = tb.batched_call(torch.matmul, [tx, tm], (0, None))
    finally:
        matmul.allow_tf32 = saved
    loop = [np.matmul(x[s], m) for s in range(2)]
    np.testing.assert_allclose(tb.to_numpy(got), np.stack(loop), rtol=1e-6)
    with _raises(RuntimeError):
        tb.batched_call(aten.histc.default, [tx], (0,))
    assert torch._C._functorch._is_vmap_fallback_enabled()
    with _raises(RuntimeError):
        tb.batched_call(aten.add_.Tensor, [tx.clone(), tx], (0, 0))
    with _raises(RuntimeError):
        nb.batched_call(np.matmul, [x, m], (0, None))


BACKEND_CASES = {
    "Tensor": case_tensor, "add": case_add, "equal": case_equal,
    "allclose": case_allclose, "zeros_like": case_zeros_like,
    "minimum": case_minimum, "maximum": case_maximum,
    "concatenate": case_concatenate, "chunk": case_chunk,
    "narrow": case_narrow, "clone": case_clone,
    "from_numpy": case_from_numpy, "to_numpy": case_to_numpy,
    "tree_flatten": case_tree_flatten, "tree_unflatten": case_tree_unflatten,
    "stack": case_stack, "batched_call": case_batched_call,
}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _numel(op, args, kwargs) -> int:
    """Elements of an op's tensor arguments and outputs, as the frontend
    counts them against `config.discovery_hint_numel`; the outputs'
    shapes come from a run on the meta device."""
    from torch.utils import _pytree as pytree

    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    outs = pytree.tree_leaves(op(*meta, **kwargs))
    return sum(t.numel() for t in list(args) + outs
               if isinstance(t, torch.Tensor))


def timed_discovery(name, args, kwargs, dev):
    """(rule, (space, recombines), seconds, probe calls) of one case."""
    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.metashard import MetaOp, metaop, view_rule

    op = RULE_CASES[name][0]
    _sync(dev)
    metaop.reset_probe_calls()
    t0 = time.perf_counter()
    if op is torch.ops.aten.view.default:
        rule = view_rule(list(args[0].shape), list(args[1]),
                         world_size=edconfig.discovery_nshards)
        found = rule["space"], rule["recombines"]
    else:
        found = MetaOp(op, args, kwargs=kwargs, name=name).discover()
    _sync(dev)
    secs = time.perf_counter() - t0
    return (rule_summary(*found), found, secs, metaop.probe_calls())


def discovery_phase(dev):
    """Phase 8b: `MetaOp.discover()` on each case of `RULE_CASES` at GPT-2
    small's full width, inputs uniform [0.5, 1.5] (ids in [1, 8)) on
    `dev`, float32 with TF32 off; each rule must equal
    `GPT2_SMALL_RULES`'.  Cases under `config.discovery_hint_numel`
    (the frontend discovers larger ops on shrunk shapes) run on the CPU
    too, on the same inputs.  Returns {case: (space, recombines)}."""
    from easydist_tpu_torch import config as edconfig

    gen = torch.Generator(device=dev).manual_seed(0)
    rules = {}
    for name, (op, full, _, kwargs) in RULE_CASES.items():
        args = case_args(
            full,
            lambda shape: torch.rand(shape, generator=gen, device=dev) + 0.5,
            lambda shape: torch.randint(1, 8, shape, generator=gen,
                                        device=dev))
        shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
        got, found, secs, probes = timed_discovery(name, args, kwargs, dev)
        line = (f"discovery {name} {shapes}: {dev.type} {secs:.3f} s, "
                f"{probes} probe calls")
        numel = (0 if op is torch.ops.aten.view.default
                 else _numel(op, args, kwargs))
        if dev.type == "cuda" and 0 < numel <= edconfig.discovery_hint_numel:
            cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a
                        for a in args]
            cpu_got, _, cpu_secs, cpu_probes = timed_discovery(
                name, cpu_args, kwargs, torch.device("cpu"))
            line += f"; cpu {cpu_secs:.3f} s, {cpu_probes} probe calls"
            if cpu_got != got:
                raise AssertionError(f"{name}: cpu rule {cpu_got} != card "
                                     f"rule {got}")
        print(f"{line}; {numel} elements; rule {got}")
        if got != GPT2_SMALL_RULES[name]:
            raise AssertionError(f"{name}: discovered {got}, table "
                                 f"{GPT2_SMALL_RULES[name]}")
        rules[name] = found
        del args
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"discovery: {len(rules)} rules equal the table")
    return rules


def mlp_block_graph(rules, axis_size: int):
    """The MetaGraph of one GPT-2 small MLP block (8192 tokens, dim 768,
    hidden 3072), x -> c_fc addmm -> gelu -> c_proj addmm -> residual
    add, wired by hand from discovered rules ({case: (space,
    recombines)}), placeholders by `view_rule`."""
    from easydist_tpu_torch.metashard import view_rule
    from easydist_tpu_torch.metashard.metair import MetaGraph, MetaNode, MetaVar

    tokens, dim, hidden = 8192, 768, 3072
    g = MetaGraph("gpt2_mlp_block")

    def placeholder(name, shape):
        var = MetaVar(name, shape, "float32")
        rule = view_rule(list(shape), list(shape), world_size=axis_size)
        g.add_input(MetaNode(name=name, op_key="placeholder", invars=[],
                             outvars=[var], space=rule["space"],
                             recombines=rule["recombines"], is_input=True))
        return var

    def op(name, op_key, case, invars, shape, flops=None):
        out = MetaVar(f"{name}.out", shape, "float32")
        space, recombines = rules[case]
        node = MetaNode(name=name, op_key=op_key, invars=invars,
                        outvars=[out], space=space, recombines=recombines)
        node.flops = flops
        g.add_op(node)
        return out

    x = placeholder("x", (tokens, dim))
    b_fc, w_fc = placeholder("c_fc.b", (hidden,)), placeholder(
        "c_fc.w", (dim, hidden))
    b_proj, w_proj = placeholder("c_proj.b", (dim,)), placeholder(
        "c_proj.w", (hidden, dim))
    h = op("c_fc", "addmm", "addmm_c_fc", [b_fc, x, w_fc], (tokens, hidden),
           2.0 * tokens * dim * hidden)
    a = op("gelu", "gelu", "gelu", [h], (tokens, hidden))
    o = op("c_proj", "addmm", "addmm_c_proj", [b_proj, a, w_proj],
           (tokens, dim), 2.0 * tokens * hidden * dim)
    g.outputs.append(op("residual", "add", "add_residual", [x, o],
                        (tokens, dim)))
    return g


def solve_mlp_block(rules, axis_size: int):
    """Phase 8c for one axis: the MLP block solved by the ILP and by beam
    search for an NVLink axis of `axis_size` (a virtual size: no second
    card is needed), then its memory plan.  Raises unless both solvers
    reach the same communication cost, the ILP picks the zero-communication
    batch sharding, the plan validates and the native planner's peaks
    equal the Python versions'.  Returns the printed numbers."""
    from easydist_tpu_torch import native
    from easydist_tpu_torch.autoflow import MeshAxisSpec, SpmdSolver
    from easydist_tpu_torch.metashard.metair import Placement
    from easydist_tpu_torch.schedule import plan_graph_memory

    if not native.available():
        raise AssertionError("the native library did not build (g++)")
    axis = MeshAxisSpec("tp", axis_size, kind="nvlink")
    graph, chosen, secs, cost = {}, {}, {}, {}
    for backend in ("milp", "beam"):
        g = graph[backend] = mlp_block_graph(rules, axis_size)
        t0 = time.perf_counter()
        g.coarsen(axis_size, level=1)
        solver = SpmdSolver(g, axis)
        chosen[backend] = (solver._ilp_solve() if backend == "milp"
                           else solver.beam_search())
        secs[backend] = time.perf_counter() - t0
        cost[backend] = solver.assignment_comm_cost(chosen[backend])
    if abs(cost["milp"] - cost["beam"]) > 1e-9 * max(abs(cost["milp"]),
                                                     1e-30):
        raise AssertionError(f"axis {axis_size}: milp cost {cost['milp']} "
                             f"!= beam cost {cost['beam']}")
    pick = chosen["milp"]
    s0, r = Placement.shard(0), Placement.replicate()
    want = {"x": ([], [s0]), "c_fc": ([r, s0, r], [s0]),
            "gelu": ([s0], [s0]), "c_proj": ([r, s0, r], [s0]),
            "residual": ([s0, s0], [s0])}
    got = {n: (pick[n].in_placements, pick[n].out_placements) for n in want}
    if got != want or cost["milp"] != 0.0:
        raise AssertionError(f"axis {axis_size}: not the batch sharding: "
                             f"{got}, comm cost {cost['milp']}")
    plan = plan_graph_memory(graph["milp"], [pick], [axis_size])
    bad = plan.validate()
    offsets_py, peak_py = native.skyline_plan_py(plan.starts, plan.ends,
                                                 plan.sizes)
    live_py = native.peak_live_py(plan.starts, plan.ends, plan.sizes)
    if bad or native.check_plan_py(plan.starts, plan.ends, plan.sizes,
                                   plan.offsets):
        raise AssertionError(f"axis {axis_size}: memory plan overlaps {bad}")
    if (peak_py, live_py) != (plan.peak_bytes, plan.peak_live_bytes) \
            or not np.array_equal(offsets_py, plan.offsets):
        raise AssertionError(
            f"axis {axis_size}: native peaks {plan.peak_bytes}, "
            f"{plan.peak_live_bytes} != Python {peak_py}, {live_py}")
    print(f"solver nvlink axis {axis_size}: milp {secs['milp']:.3f} s, beam "
          f"{secs['beam']:.3f} s (coarsen + solve, host); comm cost milp "
          f"{cost['milp']} = beam {cost['beam']}; batch sharding (x S(0), "
          f"weights R); memory plan {len(plan.var_names)} buffers, peak "
          f"{plan.peak_bytes} B = Python {peak_py}, live peak "
          f"{plan.peak_live_bytes} B = Python {live_py}, no overlap")
    return {"secs": secs, "cost": cost, "peak": plan.peak_bytes,
            "live_peak": plan.peak_live_bytes}


def sharding_phase(dev):
    """Phase 8: (a) the 17 platform ops on CUDA tensors against the numpy
    backend (`BACKEND_CASES`), (b) discovery at full width, (c) solver and
    memory planner on the card's host."""
    t0 = time.perf_counter()
    for case in BACKEND_CASES.values():
        case(dev.type)
    print(f"platform: {len(BACKEND_CASES)} ops on {dev.type} tensors agree "
          f"with the numpy backend")
    rules = discovery_phase(dev)
    for size in (4, 8):
        solve_mlp_block(rules, size)
    print(f"sharding phase: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ frontend

# the meshes users run a GPT-2 small train step on: one host of eight
# cards, data parallel, and a (data, tensor) split of it; NVLink axes
FRONTEND_MESHES = (((8,), ("dp",)), ((4, 2), ("dp", "tp")))


def moved_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes one rank sends for a collective over `nbytes` held across a
    group of `n` (ring algorithms; no penalty factor; a ppermute's
    `nbytes` is what each rank sends)."""
    share = nbytes * (n - 1) / n
    return {"all_gather": share, "reduce_scatter": share,
            "all_reduce": 2 * share, "all_to_all": share / n,
            "ppermute": nbytes}[kind]


def check_priced(result, tag: str):
    """Per axis, the wire bytes the solver priced for its picks against
    those of the collectives emission inserted, both by the solver's
    formulas on the solver's sizes (rel 1e-9).  Raises on a mismatch;
    returns {axis: {kind: [count, priced MB, moved MB]}}, where moved is
    what the rank sends at the emitted program's local shapes."""
    from easydist_tpu_torch.autoflow.cost_model import collective_wire_bytes

    table = {}
    for a, spec in enumerate(result.axis_specs):
        if spec.size == 1:
            continue
        n = spec.size
        priced = sum(collective_wire_bytes(k, b, n)
                     for k, _, b in result.priced[a])
        emitted = [c for c in result.collectives if c.axis == spec.name]
        got = sum(collective_wire_bytes(c.kind, c.priced_bytes, n)
                  for c in emitted)
        if len(emitted) != len(result.priced[a]) \
                or abs(got - priced) > 1e-9 * max(priced, 1.0):
            from collections import Counter

            e = Counter((c.kind, c.var) for c in emitted)
            q = Counter((k, v) for k, v, _ in result.priced[a])
            raise AssertionError(
                f"{tag} axis {spec.name}: emitted {len(emitted)} "
                f"collectives, {got} wire bytes; the solver priced "
                f"{len(result.priced[a])}, {priced}; emitted only "
                f"{dict(e - q)}, priced only {dict(q - e)}")
        rows = table[spec.name] = {}
        for c in emitted:
            row = rows.setdefault(c.kind, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += collective_wire_bytes(c.kind, c.priced_bytes, n) / 1e6
            row[2] += moved_bytes(c.kind, c.group_bytes, n) / 1e6
    return table


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def frontend_phase(dev, f32_losses, cfg_kw=None, batch: int = 8,
                   steps: int = 3, seed: int = 0, world: int = 8,
                   meshes=FRONTEND_MESHES):
    """Phase 9: the multi-device frontend on GPT-2 small's f32 train step
    (phase 7's workload).  First `profile_ops` times every aten node of
    the step on `dev` into a PerfDB under `.easydist_cache/`, which prices
    the solves.  (a) Against torch's fake process group of `world` ranks
    (torch.testing; structure only, values meaningless): compile for
    each mesh of `meshes` (trace, discovery on `dev` with the
    presets cross-checked on the first mesh, per-axis solve, emission);
    the emitted collectives must match what the solver priced
    (`check_priced`), at least one mm must be sharded, nothing may
    replicate because discovery failed.  (b) Rank 0's program of the
    last mesh run once on `dev`: B1-B3 launch `layers` times each; its
    peak memory beside the planner's.  (c) A real one-rank mesh (NCCL on
    the card, gloo on the CPU): `steps` losses bitwise equal to
    `f32_losses` (phase 7's compiled ones).  The arguments shrink it for
    a rehearsal on the CPU.  Returns the printed numbers."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.fxfront import (easydist_compile,
                                            make_device_mesh,
                                            set_device_mesh)
    from easydist_tpu_torch.models.gpt import GPTConfig, make_gpt_train_step
    from easydist_tpu_torch.runtime.op_profile import profile_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"
    cfg = GPTConfig(**{**dict(vocab=50304, seq=1024, dim=768, heads=12,
                              layers=12, attention="flash"),
                       **(cfg_kw or {})})
    rs = np.random.RandomState(seed + 1)
    tokens = torch.as_tensor(rs.randint(0, cfg.vocab, (batch, cfg.seq)),
                             device=dev)
    targets = torch.as_tensor(rs.randint(0, cfg.vocab, (batch, cfg.seq)),
                              device=dev)

    def fresh():
        step_, init_ = make_gpt_train_step(cfg, lr=1e-4)
        return step_, init_(torch.Generator(device=dev).manual_seed(seed),
                            device=dev)

    saved = (edconfig.discovery_device, edconfig.discovery_crosscheck,
             edconfig.prof_db_path)
    edconfig.discovery_device = dev.type
    out = {}
    step, state = fresh()
    # every aten node of the step timed on `dev` into a PerfDB inside the
    # checkout, which then prices the solves below
    edconfig.prof_db_path = os.path.join(".easydist_cache", "perf.db")
    if os.path.exists(edconfig.prof_db_path):
        os.remove(edconfig.prof_db_path)
    t0 = time.perf_counter()
    times = profile_ops(step, state, tokens, targets, trials=3)
    secs = time.perf_counter() - t0
    print(f"frontend profile_ops on {dev.type}: {len(times)} aten node "
          f"signatures in {secs:.2f} s; their medians sum to "
          f"{sum(times.values()) * 1e3:.3f} ms (one launch each, "
          f"{'CUDA events' if on_card else 'host clock'})")
    if not times:
        raise AssertionError("profile_ops measured no op")
    out["profile"] = dict(n=len(times), secs=secs,
                          sum_ms=sum(times.values()) * 1e3)
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        for shape, names in meshes:
            mesh = make_device_mesh(shape, names, device_type=dev.type)
            edconfig.discovery_crosscheck = (shape, names) == meshes[0]
            t0 = time.perf_counter()
            res = easydist_compile(step, mesh=mesh, compile_only=True)(
                state, tokens, targets)
            secs = time.perf_counter() - t0
            c = res.counters
            tag = f"frontend {shape}"
            table = check_priced(res, tag)
            mm = [n for chosen in res.strategies for n, s in chosen.items()
                  if n.startswith("mm") and not s.is_all_replicate()]
            print(f"{tag}: compile {secs:.2f} s (trace "
                  f"{res.timings['trace']:.2f}, discovery "
                  f"{res.timings['discovery']:.2f}, solve "
                  f"{res.timings['solve']:.2f}, emit "
                  f"{res.timings['emit']:.2f}); {c['rules_preset']} preset, "
                  f"{c['rules_from_group']} grouped, {c['rules_from_cache']} "
                  f"cached, {c['rules_discovered']} discovered, "
                  f"{c['probes_compiled']} probes, cross-checked "
                  f"{c['crosscheck_checked']} ({c['crosscheck_failures']} "
                  f"failed); solver comm cost per axis "
                  f"{res.solver_costs} s; replicated FLOPs "
                  f"{res.replicated_flops_fraction:.4f}; {len(mm)} mm nodes "
                  f"sharded")
            print_table(tag, table)
            by_producer = gathers_by_producer(res)
            print(f"{tag}: all_gather MB per rank per step by producer "
                  f"{producer_text(by_producer)}")
            if res.replicated_on_failure or c["crosscheck_failures"]:
                raise AssertionError(
                    f"{tag}: replicated on failed discovery "
                    f"{res.replicated_on_failure[:3]}, cross-check "
                    f"failures {c['crosscheck_failures']}")
            if not mm:
                raise AssertionError(f"{tag}: no mm is sharded (the pick "
                                     f"is all-replicate)")
            if (shape, names) == meshes[0]:
                import operator

                from easydist_tpu_torch.fxfront.interpreter import \
                    node_signature

                step_ms = 1e3 * sum(
                    times.get(node_signature(n), 0.0)
                    for n in res.traced.graph.nodes
                    if n.op == "call_function"
                    and n.target is not operator.getitem)
                out["profile"]["step_ms"] = step_ms
                n_calls = sum(1 for n in res.traced.graph.nodes
                              if n.op == "call_function")
                print(f"frontend profile_ops: the step's {n_calls} nodes "
                      f"at their signatures' medians sum to "
                      f"{step_ms:.3f} ms (one device, unsharded)")
            out[shape] = dict(secs=secs, timings=dict(res.timings),
                              counters=dict(c), costs=res.solver_costs,
                              replicated=res.replicated_flops_fraction,
                              table=table, sharded_mm=len(mm),
                              gathers=by_producer)
        out["run"] = run_rank0(dev, res, (state, tokens, targets),
                               {name: cfg.layers if on_card else 0
                                for name in TRAIN_KERNELS})
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()
        (edconfig.discovery_device, edconfig.discovery_crosscheck,
         edconfig.prof_db_path) = saved
    del res, state
    if on_card:
        torch.cuda.empty_cache()

    # (c) a real one-rank mesh
    step, state = fresh()
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_device_mesh((1,), ("dp",), device_type=dev.type)
        compiled = easydist_compile(step, mesh=mesh)
        losses = []
        for _ in range(steps):
            state, loss = compiled(state, tokens, targets)
            losses.append(float(loss))
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()
    print(f"frontend one-rank mesh ({backend}): losses {losses}, phase 7 "
          f"compiled {list(f32_losses)}")
    if losses != list(f32_losses):
        raise AssertionError("one-rank mesh losses are not bitwise equal to "
                             "the one-device compiled losses")
    out["one_rank_losses"] = losses
    return out


def print_table(tag: str, table):
    for axis, rows in table.items():
        print(f"{tag} axis {axis}: " + "; ".join(
            f"{k} x{r[0]}: priced {r[1]:.3f} MB, moved {r[2]:.3f} MB"
            for k, r in sorted(rows.items())) + " (per rank, step)")


def gathers_by_producer(res):
    """{target of the node that made the value: MB one rank sends} over
    the all_gathers of every axis, at the emitted program's shapes."""
    nodes = {n.name: n for n in res.traced.graph.nodes}
    sizes = {s.name: s.size for s in res.axis_specs}
    out = {}
    for c in res.collectives:
        if c.kind != "all_gather":
            continue
        node = nodes[c.var.split(".")[0]]
        key = str(node.target) if node.op == "call_function" else node.op
        out[key] = out.get(key, 0.0) + moved_bytes(
            c.kind, c.group_bytes, sizes[c.axis]) / 1e6
    return out


def producer_text(by_producer) -> str:
    total = sum(by_producer.values())
    return f"{total:.1f} in all: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(by_producer.items(),
                                          key=lambda kv: -kv[1]))


def run_rank0(dev, res, args, expect, coords=None, label="rank 0"):
    """Phase 9b / 10b: one rank's emitted program once on `dev` (the fake
    group answers its collectives): rank 0's, or the rank's at mesh
    `coords`.  Its B1-B3 launches must equal `expect`; returns them, the
    ring's permutes and the peaks (measured and planned)."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront.bridge import fx_to_metagraph
    from easydist_tpu_torch.parallel.ring_attention import ring_hop
    from easydist_tpu_torch.schedule import plan_graph_memory

    on_card = dev.type == "cuda"
    program = res.graph_module if coords is None else \
        res.program_for(coords)[0]
    flat = pytree.tree_leaves((args, {}))
    counters = train_counters()
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    local = [res.local_shard(x, p, coords).clone()
             for x, p in zip(flat, res.in_placements)]
    for c in counters.values():
        c.launches = 0
    ring_hop.permutes = ring_hop.bytes = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = program(*local)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    hops = (ring_hop.permutes, ring_hop.bytes)
    peak = torch.cuda.max_memory_allocated() - base if on_card else None
    del outs, local, program
    sizes = [s.size for s in res.axis_specs]
    graph = fx_to_metagraph(res.traced, {}, {}, world_size=min(sizes))
    plan = plan_graph_memory(graph, res.strategies, sizes)
    print(f"frontend {label} of {tuple(sizes)} on {dev.type}: one step "
          f"{secs:.2f} s (fake group, values meaningless); launches "
          f"{launches}; ring permutes {hops[0]} ({hops[1] / 1e6:.3f} MB); "
          f"peak {peak} B measured (inputs included), planner "
          f"{plan.peak_bytes} B skyline, {plan.peak_live_bytes} B live")
    if launches != expect:
        raise AssertionError(f"{label} launched {launches}, expected "
                             f"{expect}")
    return {"secs": secs, "launches": launches, "permutes": hops[0],
            "permute_bytes": hops[1], "peak": peak,
            "plan_peak": plan.peak_bytes,
            "plan_live_peak": plan.peak_live_bytes}


# ------------------------------------------------ attention across ranks

def attention_picks(res):
    """Per mesh axis, {pick: count} over the attention composite's nodes:
    "R", "S(d)", or "S(2):ring" / "S(2):ulysses"."""
    out = []
    for spec, chosen in zip(res.axis_specs, res.strategies):
        counts = {}
        for name, s in chosen.items():
            if "ed_attention" not in name:
                continue
            meta = getattr(s, "meta", None) or {}
            pick = "R" if s.is_all_replicate() else \
                f"S({s.out_placements[0].dim})" + (
                    f":{meta['variant']}" if meta.get("variant") else "")
            counts[pick] = counts.get(pick, 0) + 1
        out.append((spec.name, counts))
    return out


def pin_qkv(step, axis: str):
    """`step` with block 0's qkv weight pinned column-sharded on `axis`
    (`fix_sharding(w, None, axis)`), inside the step."""
    from easydist_tpu_torch.fxfront import fix_sharding

    def pinned(state, tokens, targets):
        params, opt = state
        blk = params["blocks"][0]
        qkv = {**blk["attn"]["qkv"],
               "w": fix_sharding(blk["attn"]["qkv"]["w"], None, axis)}
        blocks = [{**blk, "attn": {**blk["attn"], "qkv": qkv}},
                  *params["blocks"][1:]]
        return step(({**params, "blocks": blocks}, opt), tokens, targets)

    return pinned


def compile_report(tag, step, args, mesh):
    """Compile `step` on `mesh` (compile_only), gate emitted == priced,
    print the stages, picks, tables and all_gathers by producer."""
    from easydist_tpu_torch.fxfront import easydist_compile

    t0 = time.perf_counter()
    res = easydist_compile(step, mesh=mesh, compile_only=True)(*args)
    secs = time.perf_counter() - t0
    table = check_priced(res, tag)
    picks = attention_picks(res)
    gathers = gathers_by_producer(res)
    print(f"{tag}: compile {secs:.2f} s (trace {res.timings['trace']:.2f}, "
          f"discovery {res.timings['discovery']:.2f}, solve "
          f"{res.timings['solve']:.2f}, emit {res.timings['emit']:.2f}); "
          f"attention picks {picks}; solver comm cost per axis "
          f"{res.solver_costs} s; replicated FLOPs "
          f"{res.replicated_flops_fraction:.4f}")
    print_table(tag, table)
    print(f"{tag}: all_gather MB per rank per step by producer "
          f"{producer_text(gathers)}")
    if res.replicated_on_failure:
        raise AssertionError(f"{tag}: replicated on failed discovery "
                             f"{res.replicated_on_failure[:3]}")
    return res, dict(secs=secs, timings=dict(res.timings), picks=picks,
                     table=table, gathers=gathers,
                     costs=res.solver_costs)


def attention_phase(dev, flash_out, cfg_kw=None, long_kw=None,
                    batch: int = 8, seed: int = 0, world: int = 8,
                    meshes=FRONTEND_MESHES):
    """Phase 10: the attention composite (GPTConfig(attention="auto"))
    across ranks, against torch's fake group of `world` (structure only).

    (a) Phase 9's f32 step with attention="auto" on its meshes, after
    `profile_ops` timed its nodes: the pick of every attention node, the
    all_gather MB per rank per step by producer beside phase 9's
    (`flash_out`, flash kernels replicated), emitted equal to priced.  A
    `fix_sharding` pin on block 0's qkv weight, column on "tp", on the
    last mesh: the pin's strategy is the pinned one on every axis, and
    the collectives emitted around it are those priced with it.
    (b) GPT-2 small's widths at seq 8192, batch 1 on an (8,) "sp" mesh:
    neither batch 1 nor 12 heads divides 8, so every attention node must
    pick the seq strategy, ring (Ulysses needs heads % 8 == 0); emitted
    equal to priced, permutes included; rank 0's program, then rank
    n-1's, run once on `dev`: B1-B3 on [1, 12, T/8, 64] blocks, launches
    equal to the derived counts, the ring's permutes equal to the
    emitted ones.  The arguments shrink it for a rehearsal on the CPU."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.fxfront import make_device_mesh, set_device_mesh
    from easydist_tpu_torch.models.gpt import GPTConfig, make_gpt_train_step
    from easydist_tpu_torch.runtime.op_profile import profile_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"
    base = dict(vocab=50304, seq=1024, dim=768, heads=12, layers=12,
                attention="auto")

    def fresh(cfg, b):
        rs = np.random.RandomState(seed + 1)
        tokens = torch.as_tensor(rs.randint(0, cfg.vocab, (b, cfg.seq)),
                                 device=dev)
        targets = torch.as_tensor(rs.randint(0, cfg.vocab, (b, cfg.seq)),
                                  device=dev)
        step_, init_ = make_gpt_train_step(cfg, lr=1e-4)
        state_ = init_(torch.Generator(device=dev).manual_seed(seed),
                       device=dev)
        return step_, (state_, tokens, targets)

    saved = (edconfig.discovery_device, edconfig.prof_db_path)
    edconfig.discovery_device = dev.type
    edconfig.prof_db_path = os.path.join(".easydist_cache", "perf.db")
    out = {}
    cfg = GPTConfig(**{**base, **(cfg_kw or {})})
    step, args = fresh(cfg, batch)
    t0 = time.perf_counter()
    times = profile_ops(step, *args, trials=3)
    print(f"attention (a) profile_ops: {len(times)} signatures in "
          f"{time.perf_counter() - t0:.2f} s")
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        for shape, names in meshes:
            mesh = make_device_mesh(shape, names, device_type=dev.type)
            tag = f"attention (a) {shape}"
            res, out[shape] = compile_report(tag, step, args, mesh)
            flash = flash_out[shape]["gathers"]
            print(f"{tag}: all_gather MB per rank per step, auto "
                  f"{sum(out[shape]['gathers'].values()):.1f} against "
                  f"phase 9's flash (kernels replicated) "
                  f"{sum(flash.values()):.1f} ({producer_text(flash)})")
        # the pin, on the last mesh
        shape, names = meshes[-1]
        axis = names[-1]
        tag = f"attention (a) {shape} pinned"
        pinned, out["pinned"] = compile_report(tag, pin_qkv(step, axis),
                                               args, mesh)
        pin = [(spec.name, [repr(s.out_placements[0])
                            for n, s in chosen.items()
                            if n.startswith("fix_sharding")])
               for spec, chosen in zip(pinned.axis_specs,
                                       pinned.strategies)]
        want = [(spec.name, ["S(1)" if spec.name == axis else "R"])
                for spec in pinned.axis_specs]

        def on_axis(r):
            return sorted((c.kind, c.var) for c in r.collectives
                          if c.axis == axis)
        changed = on_axis(pinned) != on_axis(res)
        at_pin = [(c.axis, c.kind, c.var) for c in pinned.collectives
                  if c.var.startswith("fix_sharding")]
        print(f"{tag}: the pin's strategy per axis {pin} (want {want}); "
              f"emitted equal to priced with the pin; {axis} collectives "
              f"differ from the unpinned compile's: {changed}; "
              f"collectives of the pinned value {at_pin}")
        if pin != want:
            raise AssertionError(f"{tag}: the pin did not hold")
        out["pinned"]["pin"] = pin
        del res, pinned
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()
    del step, args

    # (b) long context
    cfg = GPTConfig(**{**base, "seq": 8192, **(long_kw or {})})
    step, args = fresh(cfg, 1)
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        mesh = make_device_mesh((world,), ("sp",), device_type=dev.type)
        tag = f"attention (b) ({world},) seq {cfg.seq}"
        res, out["long"] = compile_report(tag, step, args, mesh)
        picks = out["long"]["picks"][0][1]
        if picks != {"S(2):ring": 2 * cfg.layers}:
            raise AssertionError(f"{tag}: picks {picks}, want every "
                                 f"attention node on the ring")
        permutes = out["long"]["table"]["sp"]["ppermute"][0]
        if permutes != 6 * (world - 1) * cfg.layers:
            raise AssertionError(f"{tag}: {permutes} permutes emitted")
        runs = {}
        for r in (0, world - 1):
            # causal: rank r computes blocks 0..r; its backward recomputes
            # the forward, then B2 and B3 once a block
            expect = ({"flash_fwd": 2 * cfg.layers * (r + 1),
                       "flash_bwd_dq": cfg.layers * (r + 1),
                       "flash_bwd_dkv": cfg.layers * (r + 1)} if on_card
                      else {name: 0 for name in TRAIN_KERNELS})
            runs[r] = run_rank0(dev, res, args, expect,
                                coords=None if r == 0 else [r],
                                label=f"rank {r}")
            if runs[r]["permutes"] != permutes:
                raise AssertionError(f"rank {r} permuted "
                                     f"{runs[r]['permutes']} times, "
                                     f"{permutes} emitted")
        out["long"]["runs"] = runs
        del res
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()
        edconfig.discovery_device, edconfig.prof_db_path = saved
    del step, args
    if on_card:
        torch.cuda.empty_cache()
    return out



# ------------------------------------- manual parallel modes (phase 14)

PP_KW = dict(vocab=50304, seq=1024, dim=768, heads=12, layers=12,
             attention="flash")
COLLECTIVE_KINDS = ("all_reduce", "reduce_scatter_tensor",
                    "all_gather_into_tensor", "all_to_all_single")


class CollectiveLog:
    """Counts the functional collectives issued inside it by kind:
    {kind: [count, bytes of the inputs]}, also by process group in
    `by_group` (a TorchDispatchMode, so an eager run is counted as it
    goes; P2P is counted by the pipeline itself)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        log = self.log = {}
        by_group = self.by_group = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.__name__.split(".")[0]
                if func.namespace == "_c10d_functional" \
                        and name in COLLECTIVE_KINDS:
                    x = args[0]
                    group = args[-1] if isinstance(args[-1], str) else None
                    for table in (log, by_group.setdefault(group, {})):
                        c = table.setdefault(name, [0, 0])
                        c[0] += 1
                        c[1] += x.numel() * x.element_size()
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


@contextlib.contextmanager
def fake_group(world: int, rank: int):
    """torch's fake process group as rank `rank` of `world` (structure
    only: collectives copy their input, P2P moves nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch.fxfront import set_device_mesh

    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_group(dev):
    """A real one-rank process group: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist

    from easydist_tpu_torch.fxfront import set_device_mesh

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield backend
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()


def _tokens(dev, cfg, shape, seed):
    rs = np.random.RandomState(seed)
    return (torch.as_tensor(rs.randint(0, cfg.vocab, shape), device=dev),
            torch.as_tensor(rs.randint(0, cfg.vocab, shape), device=dev))


def p2p_expect(S: int, V: int, M: int, stage: int):
    """Messages one rank sends (and receives) a step by the tables: an
    activation per forward unit whose global stage has a successor, a
    gradient per backward unit whose stage has a predecessor."""
    js = [k * S + stage for k in range(V)]
    return M * sum(j != S * V - 1 for j in js) + M * sum(j != 0 for j in js)


def _launch_counts():
    return {name: c.launches for name, c in train_counters().items()}


def _zero_launches():
    for c in train_counters().values():
        c.launches = 0


def pp_rank_step(dev, cfg, world, rank, M, schedule, V=1, mb=2, seed=0):
    """One step of `make_gpt_pipeline_step` as rank `rank` of a fake
    (world,) "pp" group: its launches, P2P traffic, host seconds and peak
    memory (None on the CPU)."""
    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.models.gpt import make_gpt_pipeline_step

    on_card = dev.type == "cuda"
    with fake_group(world, rank):
        mesh = make_device_mesh((world,), ("pp",), device_type=dev.type)
        step, init = make_gpt_pipeline_step(cfg, mesh, M, lr=1e-4,
                                            schedule=schedule, n_virtual=V)
        state = init(torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
        tokens, targets = _tokens(dev, cfg, (M, mb, cfg.seq), seed + 1)
        _sync(dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        state, loss = step(state, tokens, targets)
        _sync(dev)
        secs = time.perf_counter() - t0
        out = dict(launches=_launch_counts(), stats=step.pipe.stats[0],
                   secs=secs, blocks=len(step.layers),
                   peak=torch.cuda.max_memory_allocated() if on_card
                   else None)
    del state, loss
    if on_card:
        torch.cuda.empty_cache()
    return out


def pp_split_phase(dev, cfg, batch, seed):
    """14a: make_gpt_pipeline_step's four stages chained on one device
    (LocalStages(4), 1f1b, M=4) against the one-device loss and
    gradients."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.models.gpt import (gpt_init, gpt_loss,
                                               make_gpt_pipeline_step)
    from easydist_tpu_torch.models.optim import value_and_grad
    from easydist_tpu_torch.parallel import LocalStages

    M = 4
    params = gpt_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    t0 = time.perf_counter()
    loss, grads = value_and_grad(
        lambda p: gpt_loss(p, cfg, tokens, targets), params)
    _sync(dev)
    one_s = time.perf_counter() - t0
    step, _ = make_gpt_pipeline_step(cfg, LocalStages(4), M, lr=1e-4,
                                     schedule="1f1b")
    shape = (M, batch // M, cfg.seq)
    t0 = time.perf_counter()
    p_loss, p_grads = step.loss_and_grads(params, tokens.reshape(shape),
                                          targets.reshape(shape))
    _sync(dev)
    chain_s = time.perf_counter() - t0
    got, want = pytree.tree_leaves(p_grads), pytree.tree_leaves(grads)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    bitwise = float(p_loss) == float(loss) and all(
        torch.equal(g, w) for g, w in zip(got, want))
    print(f"pipeline 14a (split at full width, 4 stages chained, 1f1b, "
          f"M={M}): loss {float(p_loss)!r} vs one-device {float(loss)!r}; "
          f"largest gradient difference {worst:.3e} over {len(got)} leaves; "
          f"bitwise {bitwise}; one-device {one_s:.2f} s, chained "
          f"{chain_s:.2f} s (host clock)")
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-4,
                               err_msg="chained pipeline loss != one-device")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    return dict(loss=float(p_loss), ref=float(loss), worst=worst,
                bitwise=bitwise)


def pp_schedule_phase(dev, cfg, seed):
    """14b: rank programs on fake groups: (4,) "pp" for gpipe, remat and
    1f1b (M=8), (2,) "pp" for 1f1b with n_virtual=2; rank 0 at M=16
    under gpipe and 1f1b for the peak."""
    on_card = dev.type == "cuda"
    act_bytes = 2 * cfg.seq * cfg.dim * 4
    launches, runs = {}, {}
    for schedule, world, V in (("gpipe", 4, 1), ("remat", 4, 1),
                               ("1f1b", 4, 1), ("1f1b", 2, 2)):
        key = schedule if V == 1 else f"{schedule}_v{V}"
        M = 8
        launches[key] = []
        for rank in range(world):
            r = pp_rank_step(dev, cfg, world, rank, M, schedule, V,
                             seed=seed)
            n = p2p_expect(world, V, M, rank)
            st = r["stats"]
            fwd = r["blocks"] * M * (2 if schedule == "remat" else 1)
            bwd = r["blocks"] * M
            expect = ({"flash_fwd": fwd, "flash_bwd_dq": bwd,
                       "flash_bwd_dkv": bwd} if on_card
                      else {name: 0 for name in TRAIN_KERNELS})
            print(f"pipeline 14b {key} rank {rank}/{world}: {r['blocks']} "
                  f"blocks, launches {r['launches']}, sends "
                  f"{st['sends']} ({st['send_bytes'] / 1e6:.2f} MB), recvs "
                  f"{st['recvs']} ({st['recv_bytes'] / 1e6:.2f} MB), live "
                  f"residual sets {st['max_live']}, host {r['secs'] * 1e3:.1f}"
                  f" ms a step (fake group)")
            if (st["sends"], st["recvs"]) != (n, n) or \
                    st["send_bytes"] != st["recv_bytes"] or \
                    st["send_bytes"] != n * act_bytes:
                raise AssertionError(f"14b {key} rank {rank}: P2P {st}, "
                                     f"the tables give {n} messages of "
                                     f"{act_bytes} B each way")
            if r["launches"] != expect:
                raise AssertionError(f"14b {key} rank {rank}: launches "
                                     f"{r['launches']}, expected {expect}")
            launches[key].append(r["launches"])
            runs[(key, rank)] = r
    peaks = {}
    for schedule in ("gpipe", "1f1b"):
        r = pp_rank_step(dev, cfg, 4, 0, 16, schedule, seed=seed)
        peaks[schedule] = r
        print(f"pipeline 14b rank 0 of 4 at M=16, {schedule}: peak "
              f"{r['peak']} B, live residual sets {r['stats']['max_live']}, "
              f"host {r['secs'] * 1e3:.1f} ms a step")
    if on_card and not peaks["1f1b"]["peak"] < peaks["gpipe"]["peak"]:
        raise AssertionError(f"1f1b peak {peaks['1f1b']['peak']} is not "
                             f"below gpipe's {peaks['gpipe']['peak']}")
    return launches, {k: v["peak"] for k, v in peaks.items()}


def _flash_nodes(nodes) -> int:
    return sum(1 for n in nodes
               if getattr(n.target, "__name__", "") == "flash_fwd.default")


def pp_compile_phase(dev, cfg, batch, seed, M=4):
    """14c: easydist_compile(pp_stages=4) of GPT-2 small's f32 loss on a
    (4, 2) "pp" x "dp" mesh of a fake group of 8, one step as each
    stage's dp-0 rank; the split against the CPU's trace of the same
    graph."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models.gpt import gpt_init, gpt_loss
    from easydist_tpu_torch.parallel.auto_pipeline import StagePlan, trace

    on_card = dev.type == "cuda"

    def loss_fn(params, tokens, targets):
        return gpt_loss(params, cfg, tokens, targets)

    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    launches, splits = [], []
    for rank in (0, 2, 4, 6):
        with fake_group(8, rank):
            mesh = make_device_mesh((4, 2), ("pp", "dp"),
                                    device_type=dev.type)
            compiled = easydist_compile(loss_fn, mesh=mesh, pp_stages=4,
                                        n_microbatches=M)
            params = gpt_init(cfg, torch.Generator(device=dev).manual_seed(
                seed), device=dev)
            t0 = time.perf_counter()
            state = compiled.init_state(params, tokens, targets)
            build_s = time.perf_counter() - t0
            del params
            _zero_launches()
            with CollectiveLog() as log:
                t0 = time.perf_counter()
                state, loss = compiled(state, tokens, targets)
                _sync(dev)
                secs = time.perf_counter() - t0
            got = _launch_counts()
            plan, prep = compiled.stage_plan, compiled.pipe.prep
            s = rank // 2
            flash = _flash_nodes(plan.stage_nodes[s])
            expect = {name: flash * M if on_card else 0
                      for name in TRAIN_KERNELS}
            rows = {"all_gather_into_tensor": [1, prep.row_elems * 4 // 2],
                    "reduce_scatter_tensor": [1, prep.row_elems * 4]}
            stats = compiled.pipe.stats[0]
            print(f"pipeline 14c rank {rank} (stage {s}): build "
                  f"{build_s:.2f} s, step {secs * 1e3:.1f} ms (fake group); "
                  f"{flash} flash nodes, launches {got}; collectives {log.log}"
                  f"; P2P sends {stats['sends']} "
                  f"({stats['send_bytes'] / 1e6:.2f} MB)")
            if got != expect:
                raise AssertionError(f"14c rank {rank}: launches {got}, "
                                     f"expected {expect}")
            for kind, want in rows.items():
                if log.log.get(kind) != want:
                    raise AssertionError(
                        f"14c rank {rank}: {kind} {log.log.get(kind)}, the "
                        f"packed row ({prep.row_elems} f32) gives {want}")
            launches.append(got)
            splits.append((plan.ends, plan.stage_flops,
                           [_flash_nodes(n) for n in plan.stage_nodes]))
            del state, compiled
        if on_card:
            torch.cuda.empty_cache()
    if any(sp != splits[0] for sp in splits):
        raise AssertionError(f"the ranks split differently: {splits}")
    # the same loss traced on the CPU at the same local shape
    cpu_params = gpt_init(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
    leaves, spec = pytree.tree_flatten(cpu_params)
    local = (batch // M // 2, cfg.seq)
    mb = (torch.zeros(local, dtype=tokens.dtype),
          torch.zeros(local, dtype=targets.dtype))
    gm, n_p, _, _ = trace(
        lambda p, b: loss_fn(pytree.tree_unflatten(p, spec), *b), leaves, mb)
    cpu_ends = StagePlan(gm, 4, n_p).ends
    del cpu_params, leaves, gm
    ends, flops, flash = splits[0]
    print(f"pipeline 14c split: node ends {ends} (CPU trace {cpu_ends}), "
          f"stage FLOPs {[f'{f:.4g}' for f in flops]}, flash nodes a stage "
          f"{flash}")
    if cpu_ends != ends:
        raise AssertionError(f"the card split {ends}, the CPU {cpu_ends}")
    return launches, dict(ends=ends, flops=flops, flash=flash)


def _leaf_bytes(tree):
    from torch.utils import _pytree as pytree

    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def dp_phase(dev, cfg, batch, seed, world=8, steps=3):
    """14d: ddp, zero2 and zero3 of the f32 flash train step on (8,) "dp":
    rank 0's step once on a fake group of 8 (launches, collectives by
    kind and state bytes against their formulas, peaks), then a one-rank
    mesh per mode against the same step written eagerly."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.models.gpt import gpt_init, gpt_loss
    from easydist_tpu_torch.models.optim import (adam_init, adam_update,
                                                 value_and_grad)
    from easydist_tpu_torch.parallel import ddp_step, zero2_step, zero3_step

    on_card = dev.type == "cuda"

    def loss_fn(params, tokens, targets):
        return gpt_loss(params, cfg, tokens, targets)

    def build(mode, mesh, params):
        if mode == "ddp":
            return ddp_step(loss_fn, mesh), params
        if mode == "zero2":
            step, init_opt = zero2_step(loss_fn, mesh)
            return step, (params, init_opt(params), torch.zeros(
                (), dtype=torch.int32, device=dev))
        step, init = zero3_step(loss_fn, mesh)
        return step, init(params)

    def fresh():
        return gpt_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        device=dev)

    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    params = fresh()
    leaves = pytree.tree_leaves(params)
    P = sum(t.numel() * 4 for t in leaves)
    L = len(leaves)
    shard = [t.numel() * 4 for t in leaves if t.shape[0] % world == 0]
    repl = [t.numel() * 4 for t in leaves if t.shape[0] % world]
    blocks = sum(shard) // world + sum(repl)
    # what zero3's backward reads of the params, so gathers again: every
    # matmul weight, every norm's scale and the tied head (wte)
    read = [params["wte"], params["ln_f"]["g"]] + [
        t for blk in params["blocks"] for t in (
            blk["ln1"]["g"], blk["attn"]["qkv"]["w"], blk["attn"]["proj"]["w"],
            blk["ln2"]["g"], blk["mlp"]["fc"]["w"], blk["mlp"]["proj"]["w"])]
    again = [t.numel() * 4 for t in read if t.shape[0] % world == 0]
    del leaves, params, read
    want = {
        "ddp": ({"all_reduce": [L + 1, P + 4]}, P),
        "zero2": ({"reduce_scatter_tensor": [len(shard), sum(shard)],
                   "all_gather_into_tensor": [len(shard), sum(shard) // world],
                   "all_reduce": [len(repl) + 1, sum(repl) + 4]},
                  P + 2 * blocks + 4),
        "zero3": ({"all_gather_into_tensor": [
            len(shard) + len(again), (sum(shard) + sum(again)) // world],
                   "reduce_scatter_tensor": [len(shard), sum(shard)],
                   "all_reduce": [len(repl) + 1, sum(repl) + 4]},
                  3 * blocks + 4)}
    launches, peaks, out = {}, {}, {}
    for mode in ("ddp", "zero2", "zero3"):
        with fake_group(world, 0):
            mesh = make_device_mesh((world,), ("dp",), device_type=dev.type)
            step, state = build(mode, mesh, fresh())
            state_bytes = _leaf_bytes(state)
            _sync(dev)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            with CollectiveLog() as log:
                t0 = time.perf_counter()
                state, loss = step(state, tokens, targets)
                _sync(dev)
                secs = time.perf_counter() - t0
            launches[mode] = _launch_counts()
            peaks[mode] = torch.cuda.max_memory_allocated() if on_card \
                else None
            del state, loss, step
        if on_card:
            torch.cuda.empty_cache()
        coll = {k: v for k, v in log.log.items()}
        print(f"dp 14d {mode} rank 0 of ({world},): launches "
              f"{launches[mode]}, collectives {coll}, state {state_bytes} B,"
              f" peak {peaks[mode]} B, host {secs * 1e3:.1f} ms a step "
              f"(fake group)")
        expect = {name: cfg.layers if on_card else 0
                  for name in TRAIN_KERNELS}
        if launches[mode] != expect:
            raise AssertionError(f"14d {mode}: launches {launches[mode]}, "
                                 f"expected {expect}")
        if coll != want[mode][0] or state_bytes != want[mode][1]:
            raise AssertionError(f"14d {mode}: collectives {coll} and state "
                                 f"{state_bytes} B, the leaves give "
                                 f"{want[mode][0]} and {want[mode][1]} B")
    if on_card and not peaks["zero3"] < peaks["zero2"]:
        raise AssertionError(f"zero3 peak {peaks['zero3']} is not below "
                             f"zero2's {peaks['zero2']}")

    # a real one-rank mesh per mode against the step written eagerly
    for mode in ("ddp", "zero2", "zero3"):
        with one_rank_group(dev) as backend:
            mesh = make_device_mesh((1,), ("dp",), device_type=dev.type)
            step, state = build(mode, mesh, fresh())
            params = fresh()
            opt = adam_init(params) if mode != "ddp" else None
            got, ref = [], []
            for _ in range(steps):
                state, loss = step(state, tokens, targets)
                got.append(float(loss))
                loss_e, grads = value_and_grad(
                    lambda p: loss_fn(p, tokens, targets), params)
                ref.append(float(loss_e))
                if mode == "ddp":
                    params = pytree.tree_map(lambda p, g: p - 1e-2 * g,
                                             params, grads)
                else:
                    params, opt = adam_update(params, grads, opt, lr=1e-2)
            final = state if mode == "ddp" else state[0]
            worst = max(float((a - b).abs().max()) for a, b in zip(
                pytree.tree_leaves(final), pytree.tree_leaves(params)))
            print(f"dp 14d {mode} one-rank mesh ({backend}): losses {got}, "
                  f"eager {ref}, bitwise {got == ref}; largest parameter "
                  f"difference after {steps} steps {worst:.3e}")
            np.testing.assert_allclose(got, ref, rtol=1e-4,
                                       err_msg=f"{mode} one-rank != eager")
            out[mode] = dict(losses=got, eager=ref, worst=worst)
            del state, params, opt, step
        if on_card:
            torch.cuda.empty_cache()
    return launches, peaks, out


def moe_phase(dev, seed, world=8, tokens_per_rank=1024):
    """14e: MoE at GPT-2 small's widths (16 experts, top-1 and top-2) on
    (8,) "ep": rank 0's all_to_all bytes against the capacity formula on
    a fake group of 8, and one rank's share of the tokens on a one-rank
    mesh against moe_reference."""
    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.parallel.moe import (MoEConfig, capacity_of,
                                                 moe_init, moe_layer,
                                                 moe_reference)

    out = {}
    for top_k in (1, 2):
        cfg = MoEConfig(n_experts=16, d_model=768, d_ff=3072, top_k=top_k)
        params = moe_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
        x = torch.randn((world * tokens_per_rank, cfg.d_model),
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 1), device=dev)
        cap = capacity_of(cfg, tokens_per_rank)
        want = [2, 2 * cfg.n_experts * cap * cfg.d_model * 4]
        with fake_group(world, 0):
            mesh = make_device_mesh((world,), ("ep",), device_type=dev.type)
            with torch.no_grad(), CollectiveLog() as log:
                y, aux = moe_layer(params, x, mesh, cfg)
                _sync(dev)
        got = log.log.get("all_to_all_single")
        with one_rank_group(dev) as backend:
            mesh = make_device_mesh((1,), ("ep",), device_type=dev.type)
            x1 = x[:tokens_per_rank]
            with torch.no_grad():
                y1, aux1 = moe_layer(params, x1, mesh, cfg)
                y_ref, aux_ref = moe_reference(params, x1, cfg, 1)
        worst = float((y1 - y_ref).abs().max())
        print(f"moe 14e top-{top_k}: capacity {cap}, rank 0's all_to_all "
              f"{got} (formula {want}); one-rank mesh ({backend}) vs "
              f"moe_reference over {tokens_per_rank} tokens: largest "
              f"difference {worst:.3e}, aux {float(aux1)!r} vs "
              f"{float(aux_ref)!r}")
        if got != want:
            raise AssertionError(f"14e top-{top_k}: all_to_all {got}, the "
                                 f"capacity formula gives {want}")
        torch.testing.assert_close(y1, y_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(aux1), float(aux_ref), rtol=1e-4)
        out[f"top{top_k}"] = dict(capacity=cap, a2a=got, worst=worst)
        del params, x, y, y1, y_ref
    return out


# ------------------------ remat, tp inside stages, sessions over a mesh
# (phase 15)

def _peak_run(dev, comp, state, tokens, targets, steps: int = 3):
    """`steps` compiled steps from `state` (traced first, untimed): the
    losses, B1-B3's launches over the steps, ms a step (host clock, each
    step ending in the loss's read; the first step, which meets the
    first launches, left out), and the peak allocated above what was
    allocated before (None off the card)."""
    comp.get_compiled(state, tokens, targets)
    on_card = dev.type == "cuda"
    _sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    _zero_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = comp(state, tokens, targets)
        losses.append(float(loss))  # synchronises
        times.append(time.perf_counter() - t0)
    ms = 1e3 * sum(times[1:]) / max(len(times) - 1, 1)
    above = torch.cuda.max_memory_allocated() - before if on_card else None
    return dict(losses=losses, launches=_launch_counts(), ms=ms,
                above=above)


def _midway_cap(result):
    """(base peak, planner's floor, cap midway, the cap a user gives for
    it) of `result`'s program under the port's liveness model; the
    floor is the plan at a cap of 1 byte."""
    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.schedule.remat import plan_remat, program_peak

    prog = result.planning_program()
    base = program_peak(prog)
    floor = plan_remat(prog, 1).predicted_peak
    cap = (base + floor) // 2
    return base, floor, cap, int(cap / edconfig.memory_ratio) + 1


def _bitwise(a, b) -> bool:
    return list(a) == list(b)


def remat_cap_phase(dev, cfg, batch, seed, steps=3):
    """15a: compiler-chosen remat of GPT-2 small's f32 train step under a
    cap midway between the planner's floor and the uncapped peak, on the
    card, then rank 0 of (8,) "dp" against a fake group of 8."""
    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models.gpt import make_gpt_train_step

    on_card = dev.type == "cuda"
    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    step, init = make_gpt_train_step(cfg, lr=1e-4)

    def state():
        return init(torch.Generator(device=dev).manual_seed(seed),
                    device=dev)

    saved = edconfig.per_device_memory_cap
    try:
        edconfig.per_device_memory_cap = 0
        c0 = easydist_compile(step, mesh=dev)
        s0 = state()
        in_bytes = _leaf_bytes((s0, tokens, targets))
        base, floor, cap, user_cap = _midway_cap(
            c0.get_compiled(s0, tokens, targets))
        uncapped = _peak_run(dev, c0, s0, tokens, targets, steps)
        del s0, c0
        edconfig.per_device_memory_cap = user_cap
        c1 = easydist_compile(step, mesh=dev)
        s1 = state()
        t0 = time.perf_counter()
        res = c1.get_compiled(s1, tokens, targets)
        compile_s = time.perf_counter() - t0
        plan = res.remat_plan
        capped = _peak_run(dev, c1, s1, tokens, targets, steps)
        del s1, c1
    finally:
        edconfig.per_device_memory_cap = saved
    if on_card:
        torch.cuda.empty_cache()
    n_clones = sum(1 for n in res.graph_module.graph.nodes
                   if "remat_of" in n.meta)
    print(f"remat 15a (one device): model peak {base} B uncapped, planner "
          f"floor {floor} B, cap {cap} B (user cap {user_cap} B); plan "
          f"{'none' if plan is None else plan.n_remat_vars} values, "
          f"{n_clones} recomputed nodes, planned peak "
          f"{None if plan is None else plan.predicted_peak} B, priced "
          f"recompute {0 if plan is None else plan.recompute_seconds * 1e3:.3f}"
          f" ms; planning {res.timings.get('remat', 0.0):.2f} s of "
          f"{compile_s:.2f} s compile")
    print(f"remat 15a: measured peak above the inputs ({in_bytes} B) "
          f"{uncapped['above']} B uncapped, {capped['above']} B capped; "
          f"step {uncapped['ms']:.1f} ms uncapped, {capped['ms']:.1f} ms "
          f"capped (host clock); losses {uncapped['losses']} / "
          f"{capped['losses']} (bitwise {_bitwise(uncapped['losses'], capped['losses'])}); "
          f"launches {uncapped['launches']} / {capped['launches']}")
    if plan is None or not plan.base_peak > cap >= plan.predicted_peak:
        raise AssertionError(f"15a: no plan with base > cap >= planned "
                             f"({plan and plan.base_peak}, {cap}, "
                             f"{plan and plan.predicted_peak})")
    np.testing.assert_allclose(capped["losses"], uncapped["losses"],
                               rtol=1e-5, err_msg="15a capped losses")
    expect = {name: cfg.layers * steps if on_card else 0
              for name in TRAIN_KERNELS}
    for run in (uncapped, capped):
        if run["launches"] != expect:
            raise AssertionError(f"15a launches {run['launches']}, "
                                 f"expected {expect}")
    if on_card and not (capped["above"] < uncapped["above"]
                        and capped["above"] + in_bytes <= user_cap):
        raise AssertionError(
            f"15a: capped peak {capped['above']} B (+{in_bytes} B inputs) "
            f"not below the uncapped {uncapped['above']} B and within the "
            f"user cap {user_cap} B")
    out = dict(base=base, floor=floor, cap=cap, user_cap=user_cap,
               plan_peak=plan.predicted_peak, values=plan.n_remat_vars,
               nodes=n_clones, in_bytes=in_bytes, uncapped=uncapped,
               capped=capped, planning_s=res.timings.get("remat"))
    del res, plan

    # rank 0 of (8,) "dp", capped the same way; the solver's own liveness
    # cap on the inputs alone (liveness_only_input), so that it keeps its
    # picks and the activations are left to the remat planner
    s8 = state()
    saved_only = edconfig.liveness_only_input
    with fake_group(8, 0):
        mesh = make_device_mesh((8,), ("dp",), device_type=dev.type)
        try:
            edconfig.per_device_memory_cap = 0
            r0 = easydist_compile(step, mesh=mesh, compile_only=True,
                                  liveness_only_input=True)(
                s8, tokens, targets)
            base8, floor8, cap8, user8 = _midway_cap(r0)
            edconfig.per_device_memory_cap = user8
            t0 = time.perf_counter()
            r1 = easydist_compile(step, mesh=mesh, compile_only=True,
                                  liveness_only_input=True)(
                s8, tokens, targets)
            secs = time.perf_counter() - t0
        finally:
            edconfig.per_device_memory_cap = saved
            edconfig.liveness_only_input = saved_only
        table = check_priced(r1, "remat 15a (8,) dp")
        plan8 = r1.remat_plan

        print(f"remat 15a rank 0 of (8,) dp: model peak {base8} B, floor "
              f"{floor8} B, cap {cap8} B; plan "
              f"{None if plan8 is None else plan8.n_remat_vars} values, "
              f"planned peak {None if plan8 is None else plan8.predicted_peak}"
              f" B; compile {secs:.2f} s ({ {k: round(v, 2) for k, v in r1.timings.items()} }); "
              f"emitted collectives equal the priced ones")
        print_table("remat 15a (8,) dp", table)
        if plan8 is None or not plan8.base_peak > cap8 >= plan8.predicted_peak:
            raise AssertionError("15a (8,) dp: no plan under the cap")
        out["dp8"] = dict(base=base8, floor=floor8, cap=cap8,
                          plan_peak=plan8.predicted_peak,
                          values=plan8.n_remat_vars)
        del r0, r1
    del s8
    return out


REMAT_MODES = (("none", False), ("full", False), ("dots", False),
               ("full", True))


def remat_config_phase(dev, cfg, batch, seed, steps=3):
    """15b: GPTConfig(remat=) "none", "full", "dots" and "full" with
    scan_layers on the one-device step, then the remat'd step's emitted
    collectives against its twin's on (8,) "dp" (fake group of 8)."""
    import dataclasses

    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models.gpt import make_gpt_train_step

    on_card = dev.type == "cuda"
    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    saved = edconfig.per_device_memory_cap
    edconfig.per_device_memory_cap = 0
    runs = {}
    try:
        for remat, scan in REMAT_MODES:
            key = remat + ("_scan" if scan else "")
            c = dataclasses.replace(cfg, remat=remat, scan_layers=scan)
            step, init = make_gpt_train_step(c, lr=1e-4)
            state = init(torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
            comp = easydist_compile(step, mesh=dev)
            t0 = time.perf_counter()
            comp.get_compiled(state, tokens, targets)
            trace_s = time.perf_counter() - t0
            run = runs[key] = _peak_run(dev, comp, state, tokens, targets,
                                        steps)
            run["trace_s"] = trace_s
            del state, comp
            if on_card:
                torch.cuda.empty_cache()
            print(f"remat 15b {key}: losses {run['losses']}, launches "
                  f"{run['launches']}, peak above the inputs {run['above']} "
                  f"B, step {run['ms']:.1f} ms (host clock), trace "
                  f"{trace_s:.2f} s")
    finally:
        edconfig.per_device_memory_cap = saved
    none = runs["none"]
    for key, run in runs.items():
        np.testing.assert_allclose(run["losses"], none["losses"], rtol=1e-5,
                                   err_msg=f"15b {key} losses")
    bitwise = {k: _bitwise(r["losses"], none["losses"])
               for k, r in runs.items()}
    print(f"remat 15b: losses equal none's at rtol 1e-5; bitwise {bitwise}")
    if not _bitwise(runs["full_scan"]["losses"], runs["full"]["losses"]):
        raise AssertionError("15b: the stacked layout's losses are not "
                             "bitwise the list layout's")
    per = cfg.layers * steps if on_card else 0
    want_full = {"flash_fwd": 2 * per, "flash_bwd_dq": per,
                 "flash_bwd_dkv": per}
    # "dots" keeps the matmuls' outputs only: the flash forward, no
    # matmul, is recomputed in the backward as under "full"
    for key in ("full", "full_scan", "dots"):
        if runs[key]["launches"] != want_full:
            raise AssertionError(f"15b {key}: launches "
                                 f"{runs[key]['launches']}, expected "
                                 f"{want_full}")
    if on_card and not (runs["full"]["above"] < none["above"]
                        and runs["dots"]["above"] < none["above"]):
        raise AssertionError(f"15b: peaks {[r['above'] for r in runs.values()]}"
                             f" B: full's and dots' are not below none's")

    # the remat'd step against its twin on (8,) "dp", with the einsum
    # attention of the JAX test: the flash kernels' ops stay replicated
    # on the mesh, so a recomputed flash forward gathers q, k, v again
    colls, timings = {}, {}
    with fake_group(8, 0):
        mesh = make_device_mesh((8,), ("dp",), device_type=dev.type)
        edconfig.per_device_memory_cap = 0
        try:
            for remat in ("none", "full"):
                step, init = make_gpt_train_step(
                    dataclasses.replace(cfg, remat=remat,
                                        attention="einsum"), lr=1e-4)
                state = init(torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
                t0 = time.perf_counter()
                r = easydist_compile(step, mesh=mesh, compile_only=True)(
                    state, tokens, targets)
                timings[remat] = dict(r.timings,
                                      total=time.perf_counter() - t0)
                colls[remat] = [(c.kind, c.group_bytes)
                                for c in r.collectives]
                del r, state
        finally:
            edconfig.per_device_memory_cap = saved
    print(f"remat 15b (8,) dp, einsum attention: {len(colls['none'])} "
          f"collectives "
          f"({sum(b for _, b in colls['none']) / 1e6:.3f} MB) un-remat'd, "
          f"{len(colls['full'])} remat'd; compile seconds by stage "
          f"{ {k: {s: round(v, 2) for s, v in t.items()} for k, t in timings.items()} }")
    if sorted(colls["full"]) != sorted(colls["none"]):
        raise AssertionError("15b: the remat'd step's collectives differ "
                             "from its twin's")
    return {k: dict(r) for k, r in runs.items()}, timings


def pp_tp_phase(dev, cfg, batch, seed, M=4):
    """15c: easydist_compile(gpt_loss, pp_stages=2, tp_axes=("tp",)) on
    (2, 2, 2) "pp" x "dp" x "tp", one step as rank 0 (stage 0) and rank 4
    (stage 1) of a fake group of 8; rank 0's peak against the same loss
    without tp_axes on (2, 2) "pp" x "dp" (the same local microbatch)."""
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models.gpt import gpt_init, gpt_loss

    on_card = dev.type == "cuda"

    def loss_fn(params, tokens, targets):
        return gpt_loss(params, cfg, tokens, targets)

    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    launches, out = [], {}
    for world, rank, shape, names, tp in (
            (8, 0, (2, 2, 2), ("pp", "dp", "tp"), ("tp",)),
            (8, 4, (2, 2, 2), ("pp", "dp", "tp"), ("tp",)),
            (4, 0, (2, 2), ("pp", "dp"), None)):
        with fake_group(world, rank):
            mesh = make_device_mesh(shape, names, device_type=dev.type)
            compiled = easydist_compile(loss_fn, mesh=mesh, pp_stages=2,
                                        n_microbatches=M, tp_axes=tp)
            params = gpt_init(cfg, torch.Generator(device=dev).manual_seed(
                seed), device=dev)
            t0 = time.perf_counter()
            state = compiled.init_state(params, tokens, targets)
            build_s = time.perf_counter() - t0
            del params
            prep = compiled.pipe.prep
            group = prep.tp[1].group.group_name if tp else None
            _sync(dev)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            with CollectiveLog() as log:
                t0 = time.perf_counter()
                state, loss = compiled(state, tokens, targets)
                _sync(dev)
                secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() if on_card else None
            s = prep.pp.index
            flash = _flash_nodes(compiled.stage_plan.stage_nodes[s])
            if tp and flash == 0:
                raise AssertionError(f"15c rank {rank}: stage {s} holds no "
                                     f"flash attention node, so its gate "
                                     f"would check no kernel")
            got = _launch_counts()
            key = f"rank{rank}" + ("" if tp else "_no_tp")
            out[key] = dict(peak=peak, build_s=build_s, secs=secs,
                            launches=got)
            if tp:
                summary = compiled.tp_summary()
                want = {k: [c * M, b * M]
                        for k, (c, b) in prep.tp_collectives(s).items()}
                seen = log.by_group.get(group, {})
                print(f"pp_tp 15c rank {rank} (stage {s}): build "
                      f"{build_s:.2f} s, step {secs * 1e3:.1f} ms (fake "
                      f"group); tp plan {summary}; tp collectives {seen}, "
                      f"the plan's conversions x M give {want}; {flash} "
                      f"flash nodes, launches {got}; peak {peak} B")
                if not summary["sharded"]:
                    raise AssertionError("15c: the tp plan shards nothing")
                if seen != want:
                    raise AssertionError(f"15c rank {rank}: tp collectives "
                                         f"{seen}, the plan gives {want}")
                expect = {name: flash * M if on_card else 0
                          for name in TRAIN_KERNELS}
                if got != expect:
                    raise AssertionError(f"15c rank {rank}: launches {got}, "
                                         f"expected {expect}")
                launches.append(got)
                out[key].update(summary=summary, tp=seen)
            else:
                print(f"pp_tp 15c without tp_axes, rank 0 of (2, 2): build "
                      f"{build_s:.2f} s, step {secs * 1e3:.1f} ms, peak "
                      f"{peak} B")
            del state, compiled
        if on_card:
            torch.cuda.empty_cache()
    if on_card and not out["rank0"]["peak"] < out["rank0_no_tp"]["peak"]:
        raise AssertionError(f"15c: rank 0's peak {out['rank0']['peak']} B "
                             f"with tp is not below "
                             f"{out['rank0_no_tp']['peak']} B without")
    return launches, out


def mesh_serve_phase(dev, ctx):
    """15d: phase 4's bucketed and paged f32 sessions on a one-rank NCCL
    (1,) "tp" mesh, then rank 0's decode programs compiled for (2,) "tp"
    against a fake group of 2.  Returns B4's and B5's launches."""
    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.models.gpt import (GPTConfig, init_kv_cache,
                                               init_kv_pages)
    from easydist_tpu_torch.serve import GenerationSession, ServeConfig

    cfg = GPTConfig.small(**ctx["cfg_kw"])
    params, prompts, n_new = ctx["params"], ctx["prompts"], ctx["n_new"]
    layouts = (("bucketed", "flash_decode", ctx["ids"]),
               ("paged", "paged_decode", ctx["paged_ids"]))
    launches = {}
    with one_rank_group(dev) as backend:
        mesh = make_device_mesh((1,), ("tp",), device_type=dev.type)
        for layout, kernel, one_ids in layouts:
            serve_cfg = ServeConfig(**{**ctx["serve_kw"],
                                       "kv_layout": layout})
            ids, sess, got, rounds, secs = serve(params, cfg, prompts, n_new,
                                                 serve_cfg, dev, mesh=mesh)
            bad = [i for i, (a, r, o) in enumerate(zip(ids, ctx["ref"],
                                                        one_ids))
                   if a != r or a != o]
            if bad:
                raise AssertionError(f"15d {layout}: ids differ from the "
                                     f"one-device session or the uncached "
                                     f"re-forward in requests {bad}")
            check_launches(f"15d {layout}", got, kernel, cfg.layers, rounds,
                           dev)
            launches[kernel] = got[kernel]
            print(f"mesh serve 15d {layout} on a one-rank {backend} (1,) tp "
                  f"mesh: {len(prompts)} requests, {rounds} decode rounds, "
                  f"{secs:.2f} s incl. tracing; ids equal the one-device "
                  f"session's and the uncached re-forward; launches {got}")
            del sess
    # rank 0's decode programs on (2,) "tp"
    slots = ctx["serve_kw"]["max_decode_slots"]
    bucket = max(ctx["serve_kw"]["decode_buckets"])
    chunk = ctx["serve_kw"]["prefill_chunk"]
    token = torch.zeros(slots, dtype=torch.int32, device=dev)
    out = {}
    with fake_group(2, 0):
        mesh = make_device_mesh((2,), ("tp",), device_type=dev.type)
        for layout in ("bucketed", "paged"):
            sess = GenerationSession.for_gpt(
                params, cfg, device=dev, mesh=mesh,
                config=ServeConfig(**{**ctx["serve_kw"],
                                      "kv_layout": layout}))
            t0 = time.perf_counter()
            if layout == "bucketed":
                cache = init_kv_cache(cfg, slots, bucket, device=dev)
                res = sess._decode_c.get_compiled(cache, params, token, token)
            else:
                pages = bucket // chunk
                cache = init_kv_pages(cfg, (slots + 1) * pages, chunk,
                                      device=dev)
                table = torch.zeros((slots, pages), dtype=torch.int32,
                                    device=dev)
                res = sess._program("decode").get_compiled(
                    cache, params, table, token, token)
            secs = time.perf_counter() - t0
            picks = {k: [repr(q) for q in pl]
                     for k, pl in zip(("k", "v"), res.in_placements[:2])}
            table_ = check_priced(res, f"15d {layout} (2,) tp")
            print(f"mesh serve 15d rank 0 of (2,) tp, {layout} decode: "
                  f"compile {secs:.2f} s; the solver places the cache "
                  f"{picks}; replicated FLOPs "
                  f"{res.replicated_flops_fraction:.3f}; emitted "
                  f"collectives equal the priced ones {table_}")
            out[layout] = dict(picks=picks, table=table_, secs=secs)
            del sess, cache, res
    return launches, out


def tail_phase(dev, ctx, cfg_kw=None, remat_kw=None, batch: int = 8,
               seed: int = 0):
    """Phase 15: compiler-chosen remat under a cap (15a), GPTConfig.remat
    and scan_layers (15b), tp_axes inside pipeline stages (15c) on GPT-2
    small's f32 flash workload, and sessions over a mesh (15d) on phase
    4's.  `remat_kw` overrides the config of 15a-b alone (a cut of their
    depth; 15c's two stages each need flash blocks).  Returns the B1-B3
    launches by run and B4 / B5's in 15d.  The arguments shrink it for a
    rehearsal on the CPU."""
    from easydist_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**PP_KW, **(cfg_kw or {})})
    remat_cfg = GPTConfig(**{**PP_KW, **(cfg_kw or {}), **(remat_kw or {})})
    t_phase = time.perf_counter()
    t = time.perf_counter()
    cap = remat_cap_phase(dev, remat_cfg, batch, seed)
    times = {"15a": time.perf_counter() - t}
    t = time.perf_counter()
    modes, _ = remat_config_phase(dev, remat_cfg, batch, seed)
    times["15b"] = time.perf_counter() - t
    t = time.perf_counter()
    launches_tp, tp = pp_tp_phase(dev, cfg, batch, seed)
    times["15c"] = time.perf_counter() - t
    t = time.perf_counter()
    launches_mesh, mesh = mesh_serve_phase(dev, ctx)
    times["15d"] = time.perf_counter() - t
    print(f"tail phase: {time.perf_counter() - t_phase:.1f} s "
          f"{ {k: round(v, 1) for k, v in times.items()} }")
    remat = {"uncapped": cap["uncapped"]["launches"],
             "capped": cap["capped"]["launches"],
             **{k: r["launches"] for k, r in modes.items()}}
    return dict(remat=remat, pp_tp=launches_tp, mesh=launches_mesh,
                out=dict(cap=cap, modes=modes, tp=tp, mesh=mesh))


def pipeline_phase(dev, cfg_kw=None, batch: int = 8, seed: int = 0):
    """Phase 14: the manual parallel modes on GPT-2 small's f32 flash
    workload (14a split, 14b schedules, 14c easydist_compile(pp_stages=),
    14d ddp / zero2 / zero3) and MoE at its widths (14e).  Returns the
    B1-B3 launches of the pipeline runs (per schedule, per rank) and of
    the dp runs (per mode), and the printed numbers.  The arguments
    shrink it for a rehearsal on the CPU."""
    from easydist_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**PP_KW, **(cfg_kw or {})})
    t_phase = time.perf_counter()
    out = {"split": pp_split_phase(dev, cfg, batch, seed)}
    launches_pp, out["peaks_pp"] = pp_schedule_phase(dev, cfg, seed)
    launches_pp["compile"], out["compile"] = pp_compile_phase(dev, cfg,
                                                              batch, seed)
    launches_dp, out["peaks_dp"], out["dp"] = dp_phase(dev, cfg, batch,
                                                       seed)
    out["moe"] = moe_phase(dev, seed)
    print(f"pipeline phase: {time.perf_counter() - t_phase:.1f} s")
    return launches_pp, launches_dp, out


# ------------------------------- comm, runtime and resilience (phase 16)

COMM_SETTINGS = {
    # bench.py:663-664: int8, block 256, 1 MiB buckets
    "int8": dict(comm_quant_dtype="int8", comm_quant_block=256,
                 comm_bucket_bytes=1 << 20, comm_overlap=False),
    "bf16": dict(comm_quant_dtype="bf16", comm_quant_block=256,
                 comm_bucket_bytes=1 << 20, comm_overlap=False),
    # bench.py:757-761: the overlapped flush, quantization off
    "overlap": dict(comm_quant_dtype="none", comm_bucket_bytes=256 << 10,
                    comm_overlap=True),
}
COMM_KNOBS = ("comm_quant_dtype", "comm_quant_block", "comm_bucket_bytes",
              "comm_overlap", "comm_quant_min_numel")


@contextlib.contextmanager
def comm_config(**knobs):
    """The comm knobs set for the block, restored after it."""
    from easydist_tpu_torch import config as edconfig

    saved = {k: getattr(edconfig, k) for k in COMM_KNOBS}
    try:
        for k, v in knobs.items():
            setattr(edconfig, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(edconfig, k, v)


def gpt2_quantizable(cfg):
    """The keystr paths of GPT-2's leaves that stay quantizable under the
    default `comm_quant_skip` and `comm_quant_min_numel`: the embeddings
    and the four weight matrices of every block (the CPU tests hold the
    same set against the JAX package's)."""
    return {"['wte']", "['wpe']"} | {
        f"['blocks'][{i}]['{m}']['{w}']['w']" for i in range(cfg.layers)
        for m, w in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc"),
                     ("mlp", "proj"))}


def comm_expect(mode, setting, params, world):
    """What rank 0's step of `mode` must issue under `setting`, from the
    leaves and the bucket plan: ({kind: count} of the functional
    collectives, counters' bytes_on_wire, quantized launches)."""
    from easydist_tpu_torch import comm
    from easydist_tpu_torch import config as edconfig

    leaves, paths, _, order = comm.keyed_leaves(params)
    q = comm.quant_mode()
    n = world
    kinds, wire, nq = {}, 0.0, 0

    def add(kind, k=1):
        kinds[kind] = kinds.get(kind, 0) + k

    add("all_reduce")  # the loss's mean over the axis
    if mode == "ddp":
        ordered = [leaves[i] for i in order]
        flags = [comm.leaf_quantizable(paths[i], leaves[i].numel())
                 for i in order]
        for b in comm.plan_buckets(ordered, edconfig.comm_bucket_bytes,
                                   flags):
            numel = sum(ordered[j].numel() for j in b.indices)
            quant = b.quantize and q != "none"
            wire += comm.wire_bytes("all_reduce", numel, 4, n, q, quant)
            nq += quant
            if quant and q == "int8":
                add("all_to_all_single", 2)
                add("all_gather_into_tensor", 2)
            else:
                add("all_reduce")
        return kinds, wire, nq
    for leaf, path in zip(leaves, paths):
        kind = "reduce_scatter" if leaf.shape[0] % n == 0 else "all_reduce"
        quant = comm.leaf_quantizable(path, leaf.numel())
        wire += comm.wire_bytes(kind, leaf.numel(), 4, n, q, quant)
        nq += quant
        if quant and q == "int8":
            add("all_to_all_single", 2)
            if kind == "all_reduce":
                add("all_gather_into_tensor", 2)
        else:
            add("reduce_scatter_tensor" if kind == "reduce_scatter"
                else "all_reduce")
    return kinds, wire, nq


def sent_bytes(kind: str, input_bytes: float, n: int) -> float:
    """Bytes one rank sends for a functional collective given
    `input_bytes` (what `CollectiveLog` records): ring all_reduce
    2 (n-1)/n, reduce_scatter and equal-split all_to_all (n-1)/n, an
    all_gather its block to n-1 peers."""
    return input_bytes * {"all_reduce": 2.0 * (n - 1) / n,
                          "all_gather_into_tensor": n - 1.0}.get(
                              kind, (n - 1) / n)


def _is_backward_mm(node) -> bool:
    name = getattr(node.target, "__name__", "")
    return node.op == "call_function" and name.startswith(
        ("mm.", "flash_bwd_dkv."))


def overlap_trace(step, state, tokens, targets):
    """make_fx of rank 0's overlapped ddp step (fake tensors): the index
    of the first collective and of the backward's last product."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(state)

    def flat(*xs):
        return pytree.tree_leaves(step(pytree.tree_unflatten(
            list(xs[:len(leaves)]), spec), *xs[len(leaves):]))

    gm = make_fx(flat, tracing_mode="fake")(*leaves, tokens, targets)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    first = next(i for i, n in enumerate(nodes)
                 if getattr(n.target, "__name__", "").startswith(
                     "all_reduce."))
    last = max(i for i, n in enumerate(nodes) if _is_backward_mm(n))
    return first, last, len(nodes)


def comm_phase(dev, cfg, batch, seed, world=8, steps=3):
    """16a: ddp / zero2 / zero3 rank 0 on (8,) "dp" (fake group of 8)
    under int8, bf16 and the overlapped flush: collectives by kind, the
    counters' wire bytes and quantized launches against the closed forms
    over the bucket plan; the overlapped step's first collective before
    its last backward product.  Then a one-rank NCCL mesh per mode and
    setting: int8 and overlap losses bitwise the exact mode's (at n = 1
    the int8 collectives are the identity), bf16 within 1e-2."""
    from easydist_tpu_torch import comm
    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.models.gpt import gpt_init, gpt_loss
    from easydist_tpu_torch.parallel import ddp_step, zero2_step, zero3_step

    on_card = dev.type == "cuda"

    def loss_fn(params, tokens, targets):
        return gpt_loss(params, cfg, tokens, targets)

    def fresh():
        return gpt_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        device=dev)

    def build(mode, mesh, params):
        if mode == "ddp":
            return ddp_step(loss_fn, mesh), params
        if mode == "zero2":
            step, init_opt = zero2_step(loss_fn, mesh)
            return step, (params, init_opt(params), torch.zeros(
                (), dtype=torch.int32, device=dev))
        step, init = zero3_step(loss_fn, mesh)
        return step, init(params)

    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    leaves, paths, _, _ = comm.keyed_leaves(fresh())
    with comm_config(comm_quant_dtype="int8"):
        got = {p for p, x in zip(paths, leaves)
               if comm.leaf_quantizable(p, x.numel())}
    del leaves
    if got != gpt2_quantizable(cfg):
        raise AssertionError(f"16a quantizable leaves {sorted(got)}")
    print(f"comm 16a: {len(got)} of {len(paths)} leaves quantizable "
          f"(wte, wpe and 4 weight matrices a block)")
    out = {"quantizable": len(got)}
    for setting, knobs in COMM_SETTINGS.items():
        for mode in ("ddp", "zero2", "zero3"):
            with comm_config(**knobs), fake_group(world, 0):
                mesh = make_device_mesh((world,), ("dp",),
                                        device_type=dev.type)
                params = fresh()
                if setting != "overlap":
                    want = comm_expect(mode, setting, params, world)
                step, state = build(mode, mesh, params)
                comm.comm_counters.reset()
                _zero_launches()
                with CollectiveLog() as log:
                    t0 = time.perf_counter()
                    state, loss = step(state, tokens, targets)
                    _sync(dev)
                    secs = time.perf_counter() - t0
                snap = comm.comm_counters.snapshot()
                launches = _launch_counts()
                kinds = {k: v[0] for k, v in log.log.items()}
                row = dict(kinds=kinds, ratio=snap["compression_ratio"],
                           wire_mb=snap["bytes_on_wire"] / 1e6,
                           fp32_mb=snap["bytes_fp32_equiv"] / 1e6,
                           quantized=snap["quantized_launches"],
                           launches=launches, ms=secs * 1e3)
                if setting == "overlap" and mode == "ddp":
                    first, last, n_nodes = overlap_trace(step, state,
                                                         tokens, targets)
                    frac = comm.schedulable_overlap_fraction(
                        loss_fn, params, tokens[:batch // world],
                        targets[:batch // world])
                    row.update(first=first, last=last, nodes=n_nodes,
                               schedulable=frac)
                    if not (first < last and frac > 0):
                        raise AssertionError(
                            f"16a overlap: first collective at node {first}"
                            f", last backward product at {last}, "
                            f"schedulable fraction {frac}")
                del state, loss, step, params
            if on_card:
                torch.cuda.empty_cache()
            print(f"comm 16a {setting} {mode} rank 0 of ({world},): "
                  f"collectives {kinds}, wire {row['wire_mb']:.3f} MB of "
                  f"{row['fp32_mb']:.3f} MB f32 (ratio {row['ratio']:.4f})"
                  f", {row['quantized']} quantized launches, host "
                  f"{row['ms']:.1f} ms (fake group)"
                  + (f"; first collective at node {row['first']} of "
                     f"{row['nodes']}, last backward product at "
                     f"{row['last']}, schedulable overlap "
                     f"{row['schedulable']:.4f}" if "first" in row else ""))
            expect = {name: cfg.layers if on_card else 0
                      for name in TRAIN_KERNELS}
            if launches != expect:
                raise AssertionError(f"16a {setting} {mode}: launches "
                                     f"{launches}, expected {expect}")
            if setting != "overlap":
                kinds_w, wire_w, nq_w = want
                if mode != "ddp":
                    # ZeRO's exact parameter gathers are phase 14d's gate
                    kinds = {k: v for k, v in kinds.items()
                             if k != "all_gather_into_tensor"}
                    kinds_w = {k: v for k, v in kinds_w.items()
                               if k != "all_gather_into_tensor"}
                if kinds != kinds_w or abs(snap["bytes_on_wire"] - wire_w) \
                        > 1e-6 * wire_w or snap["quantized_launches"] != nq_w:
                    raise AssertionError(
                        f"16a {setting} {mode}: collectives {kinds}, wire "
                        f"{snap['bytes_on_wire']}, {snap['quantized_launches']}"
                        f" quantized; the plan gives {kinds_w}, {wire_w}, "
                        f"{nq_w}")
            out[f"{setting}_{mode}"] = row

    # a real one-rank mesh: the comm knobs leave the losses as they were
    for mode in ("ddp", "zero2", "zero3"):
        runs = {}
        for setting in ("exact", *COMM_SETTINGS):
            knobs = COMM_SETTINGS.get(setting, {})
            with comm_config(**knobs), one_rank_group(dev) as backend:
                mesh = make_device_mesh((1,), ("dp",), device_type=dev.type)
                step, state = build(mode, mesh, fresh())
                ls = []
                for _ in range(steps):
                    state, loss = step(state, tokens, targets)
                    ls.append(float(loss))
                runs[setting] = ls
                del state, step
            if on_card:
                torch.cuda.empty_cache()
        print(f"comm 16a {mode} one-rank mesh ({backend}): {runs}")
        for setting in ("int8", "overlap"):
            if on_card and runs[setting] != runs["exact"]:
                raise AssertionError(f"16a {mode} {setting} one-rank losses "
                                     f"{runs[setting]} != exact "
                                     f"{runs['exact']}")
            # (a CPU rehearsal: the CPU's matmuls are not bitwise from
            # run to run, so there the bar is rtol 1e-5)
            np.testing.assert_allclose(runs[setting], runs["exact"],
                                       rtol=1e-5)
        np.testing.assert_allclose(runs["bf16"], runs["exact"], rtol=1e-2,
                                   err_msg=f"16a {mode} bf16 one-rank")
        out[f"one_rank_{mode}"] = runs
    return out


def fence_phase(dev, cfg, batch, seed, world=8):
    """16b: easydist_compile(mesh=) of the f32 train step on (8,) "dp"
    under int8 (fake group of 8): per axis the emitted collectives equal
    the priced ones in kind, count and wire bytes, and rank 0's program
    run once sends, at run time, the bytes it was priced at."""
    from collections import Counter

    from easydist_tpu_torch import comm
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models.gpt import make_gpt_train_step

    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    step, init = make_gpt_train_step(cfg, lr=1e-4)
    with comm_config(comm_quant_dtype="int8"), fake_group(world, 0):
        mesh = make_device_mesh((world,), ("dp",), device_type=dev.type)
        state = init(torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
        comm.comm_counters.reset()
        t0 = time.perf_counter()
        res = easydist_compile(step, mesh=mesh, compile_only=True)(
            state, tokens, targets)
        compile_s = time.perf_counter() - t0
        snap = comm.comm_counters.snapshot()
        table = {}
        for a, spec in enumerate(res.axis_specs):
            emitted = Counter((c.kind, c.var, round(c.wire_bytes, 3))
                              for c in res.collectives
                              if c.axis == spec.name)
            priced = Counter((k, v, round(b, 3))
                             for k, v, b in res.priced_wire[a])
            if emitted != priced:
                raise AssertionError(
                    f"16b axis {spec.name}: emitted only "
                    f"{dict(emitted - priced)}, priced only "
                    f"{dict(priced - emitted)}")
            for (k, _, b), c in emitted.items():
                row = table.setdefault(k, [0, 0.0])
                row[0] += c
                row[1] += b * c / 1e6
        routes = Counter(c.route for c in res.collectives)
        # rank 0's program once, its collectives' bytes taken at run time
        flat = torch.utils._pytree.tree_leaves((state, tokens, targets))
        local = [res.local_shard(x, pl).clone()
                 for x, pl in zip(flat, res.in_placements)]
        del state
        with CollectiveLog() as log, torch.no_grad():
            outs = res.graph_module(*local)
            _sync(dev)
        sent = sum(sent_bytes(k, b, world) for k, (_, b) in log.log.items())
        priced_mb = sum(b for _, _, b in res.priced_wire[0]) / 1e6
        del outs, local, res
    print(f"fence 16b int8 ({world},) \"dp\": compiled in {compile_s:.1f} s;"
          f" routes {dict(routes)}; emitted = priced by kind "
          f"{ {k: [v[0], round(v[1], 3)] for k, v in table.items()} } "
          f"(count, MB a rank sends); {priced_mb:.3f} MB priced, "
          f"{sent / 1e6:.3f} MB sent at run time; counters "
          f"{snap['quantized_launches']} quantized launches, ratio "
          f"{snap['compression_ratio']:.4f}")
    if abs(sent / 1e6 - priced_mb) > 1e-6 * max(priced_mb, 1.0):
        raise AssertionError(f"16b: rank 0 sent {sent} B, priced "
                             f"{priced_mb * 1e6} B")
    return dict(table=table, routes=dict(routes), priced_mb=priced_mb,
                sent_mb=sent / 1e6, compile_s=compile_s)


def gpt_scaled_step(cfg, lr=1e-4):
    """Phase 7's train step with a float loss scale beside the batch: the
    `step.nan_grad` drill poisons the first float argument, and GPT-2's
    batch is int tokens (scale 1.0 leaves the step bitwise as it was)."""
    from easydist_tpu_torch.models.gpt import gpt_loss
    from easydist_tpu_torch.models.optim import adam_update, value_and_grad

    def step(state, tokens, targets, scale):
        params, opt = state
        loss, grads = value_and_grad(
            lambda p: gpt_loss(p, cfg, tokens, targets) * scale, params)
        new_params, new_opt = adam_update(params, grads, opt, lr=lr)
        return (new_params, new_opt), loss

    return step


def _bitwise_tree(a, b) -> bool:
    from torch.utils import _pytree as pytree

    return all(torch.equal(x, y) for x, y in zip(pytree.tree_leaves(a),
                                                  pytree.tree_leaves(b)))


def _du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def training_run_phase(dev, cfg, batch, seed, steps=6, every=2, keep=2,
                       n_tokens=1 << 24):
    """16c: `run_training` on one card: a token file of `n_tokens` uint16
    tokens from the seed, read by `TokenLoader`; the one-device compiled
    step (donate_state=False, the guard holds the pre-step state) for
    `steps` steps with the guard on, checkpoints every `every` steps,
    `keep` kept.  The drills, each from a fresh directory: SIGTERM,
    a torn write, a corrupt committed step, a corrupt checkpoint found at
    restore (the uninterrupted run's last one), a NaN through the loss
    scale, a data stall.  Returns the B1-B3 launches of the
    uninterrupted run and the printed numbers."""
    import shutil
    import tempfile

    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models.gpt import make_gpt_train_step
    from easydist_tpu_torch.resilience import (GuardedStep, InjectedFault,
                                               PreemptedError, fault_plan)
    from easydist_tpu_torch.runtime import checkpoint as ck
    from easydist_tpu_torch.runtime.data import TokenLoader
    from easydist_tpu_torch.runtime.elastic import (DataStallError,
                                                    run_training)

    on_card = dev.type == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    # bitwise resume needs a step that is bitwise from run to run: the
    # embedding's index backward accumulates in a nondeterministic order
    # unless deterministic algorithms are asked for
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        path = os.path.join(root, "tokens.bin")
        np.random.RandomState(seed + 2).randint(
            0, cfg.vocab, n_tokens).astype(np.uint16).tofile(path)
        _, init = make_gpt_train_step(cfg, lr=1e-4)
        compiled = easydist_compile(gpt_scaled_step(cfg), mesh=dev,
                                    donate_state=False)

        def init_state():
            return init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)

        def prepare(b, device):
            return (torch.as_tensor(b[0], dtype=torch.int64).to(device),
                    torch.as_tensor(b[1], dtype=torch.int64).to(device),
                    torch.ones((), dtype=torch.float32, device=device))

        def run(name, total=steps, **kw):
            losses = []
            loader = TokenLoader(path, batch=batch, seq=cfg.seq, seed=seed)
            if not loader.native:
                raise AssertionError("16c: the token loader is not native")
            try:
                state = run_training(
                    compiled, init_state, loader, os.path.join(root, name),
                    total, checkpoint_every=every, keep=keep, device=dev,
                    prepare_batch=prepare, step_guard=True,
                    on_step=lambda s, l: losses.append((s, float(l))), **kw)
            finally:
                loader.close()
            return state, losses

        # the uninterrupted run: the reference every drill ends on
        _zero_launches()
        t0 = time.perf_counter()
        base, base_losses = run("base")
        _sync(dev)
        base_s = time.perf_counter() - t0
        launches = _launch_counts()
        expect = {name: cfg.layers * steps if on_card else 0
                  for name in TRAIN_KERNELS}
        if launches != expect:
            raise AssertionError(f"16c launches {launches}, expected "
                                 f"{expect}")
        save = dict(ck.last_save_report())
        disk = _du(os.path.join(root, "base"))
        guard = ck.checkpoint_meta(os.path.join(root, "base"),
                                   steps)["guard"]
        if guard["skips"] != 0 or guard["steps"] != steps:
            raise AssertionError(f"16c guard {guard}")
        out = dict(base_s=base_s, losses=base_losses, save=save, disk=disk)
        ck.load_checkpoint(os.path.join(root, "base"), init_state())
        out["restore"] = dict(ck.last_restore_report())
        _sync(dev)

        def same(tag, state, losses=None):
            if not _bitwise_tree(state, base):
                raise AssertionError(f"16c {tag}: final state differs from "
                                     f"the uninterrupted run's")
            if losses is not None and losses != base_losses[-len(losses):]:
                raise AssertionError(f"16c {tag}: losses {losses}, the "
                                     f"uninterrupted run's {base_losses}")

        # SIGTERM at the 4th step boundary: final checkpoint, resume
        with fault_plan("preempt.sigterm@4"):
            try:
                run("preempt")
                raise AssertionError("16c: preempt.sigterm did not preempt")
            except PreemptedError as e:
                stopped, final_s = e.step, e.checkpoint_s
        meta = ck.checkpoint_meta(os.path.join(root, "preempt"), stopped)
        state, losses = run("preempt")
        same("preempt", state, losses)
        if meta["batches_consumed"] != stopped or \
                [s for s, _ in losses] != list(range(stopped, steps)):
            raise AssertionError(f"16c preempt: cursor {meta}, resumed "
                                 f"steps {losses}")
        out["preempt"] = dict(step=stopped, final_ckpt_s=final_s)

        # a torn write: latest_step stays where it was
        with fault_plan("ckpt.write.partial@2"):
            try:
                run("partial")
                raise AssertionError("16c: ckpt.write.partial did not fire")
            except InjectedFault:
                pass
        latest = ck.latest_step(os.path.join(root, "partial"))
        if latest != every:
            raise AssertionError(f"16c partial: latest step {latest}")

        # bit rot in the committed preemption checkpoint: resume falls
        # back to the step before and replays
        with fault_plan("ckpt.manifest.corrupt@2,preempt.sigterm@4"):
            try:
                run("corrupt")
            except PreemptedError:
                pass
        if ck.verify_checkpoint(os.path.join(root, "corrupt",
                                             f"step_{stopped}")) == []:
            raise AssertionError("16c corrupt: the manifest missed the rot")
        same("manifest.corrupt", run("corrupt")[0])

        # the uninterrupted run's last checkpoint found corrupt at restore:
        # resume from the one before, replay its last steps
        with fault_plan("elastic.restore.chunk_corrupt@1"):
            state, losses = run("base")
        if [s for s, _ in losses] != list(range(steps - every, steps)):
            raise AssertionError(f"16c chunk_corrupt: resumed steps "
                                 f"{losses}")
        same("restore.chunk_corrupt", state, losses)
        del state

        # a NaN through the loss scale: the state held bitwise, one skip
        loader = TokenLoader(path, batch=batch, seq=cfg.seq, seed=seed)
        w = loader.next_batch()
        loader.close()
        tokens, targets, scale = prepare((w[:, :-1], w[:, 1:]), dev)
        state0 = init_state()
        guarded = GuardedStep(compiled, device=dev)
        held = torch.utils._pytree.tree_map(torch.clone, state0)
        with fault_plan("step.nan_grad@1"):
            state1, loss = guarded(state0, tokens, targets, scale)
        if not (_bitwise_tree(state1, held) and guarded.stats()["skips"] == 1
                and not np.isfinite(float(loss))):
            raise AssertionError(f"16c nan: held {_bitwise_tree(state1, held)}"
                                 f", stats {guarded.stats()}, loss {loss}")
        # the guard's cost: guarded against unguarded steps
        times = {}
        for tag, fn in (("plain", compiled), ("guarded", guarded)):
            s = state1
            s, _ = fn(s, tokens, targets, scale)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(3):
                s, _ = fn(s, tokens, targets, scale)
            _sync(dev)
            times[tag] = (time.perf_counter() - t0) * 1e3 / 3
            del s
        out["guard_ms"] = times
        del state0, state1, held, guarded

        # a data stall past the watchdog
        with fault_plan("data.stall@2"):
            try:
                run("stall", data_timeout_s=1.0)
                raise AssertionError("16c: data.stall did not raise")
            except DataStallError as e:
                out["stall_s"] = e.elapsed_s
        loader = TokenLoader(path, batch=batch, seq=cfg.seq, seed=seed)
        loader.next_batch()
        t0 = time.perf_counter()
        for _ in range(20):
            loader.next_batch()
        out["loader_ms"] = (time.perf_counter() - t0) * 1e3 / 20
        loader.close()
        del base
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        shutil.rmtree(root, ignore_errors=True)
        if on_card:
            torch.cuda.empty_cache()
    gb = out["save"]["bytes"] / 1e9
    r = out["restore"]
    print(f"runtime 16c: {steps} guarded steps, checkpoints every {every} "
          f"(keep {keep}): {out['base_s']:.1f} s; losses "
          f"{[l for _, l in base_losses]}; launches {launches}")
    print(f"runtime 16c checkpoint: {gb:.3f} GB a save, "
          f"{out['save']['total_s']:.2f} s ({gb / out['save']['total_s']:.2f}"
          f" GB/s; write {out['save']['write_s']:.2f} s, sha256 "
          f"{out['save']['hash_s']:.2f} s = "
          f"{out['save']['hash_s'] / out['save']['total_s']:.0%}); restore "
          f"{r['verify_s'] + r['load_s']:.2f} s "
          f"({gb / (r['verify_s'] + r['load_s']):.2f} GB/s; verify "
          f"{r['verify_s']:.2f} s = "
          f"{r['verify_s'] / (r['verify_s'] + r['load_s']):.0%}); disk "
          f"{out['disk'] / 1e9:.3f} GB for {keep} kept steps")
    print(f"runtime 16c drills: preempted at step {out['preempt']['step']} "
          f"(final checkpoint {out['preempt']['final_ckpt_s']:.2f} s), "
          f"resumed bitwise; torn write invisible; corrupt manifest and "
          f"corrupt restore fell back, resumed bitwise; NaN step held "
          f"bitwise, 1 "
          f"skip; stall raised after {out['stall_s']:.2f} s; guard "
          f"{out['guard_ms']['guarded']:.1f} ms a step against "
          f"{out['guard_ms']['plain']:.1f} ms unguarded; loader "
          f"{out['loader_ms']:.3f} ms a batch")
    return launches, out


def profiler_phase(dev, cfg, batch, seed):
    """16d: `op_cost_analysis` of the compiled f32 step (FLOPs beside
    6 N T), `memory_analysis` beside the measured peak, and
    `detect_device_constants()` for the card."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models.gpt import make_gpt_train_step
    from easydist_tpu_torch.runtime.calibrate import detect_device_constants
    from easydist_tpu_torch.runtime.profiler import (memory_analysis,
                                                     op_cost_analysis)

    on_card = dev.type == "cuda"
    tokens, targets = _tokens(dev, cfg, (batch, cfg.seq), seed + 1)
    step, init = make_gpt_train_step(cfg, lr=1e-4)
    state = init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    compiled = easydist_compile(step, mesh=dev, donate_state=False)
    res = compiled.get_compiled(state, tokens, targets)
    cost = op_cost_analysis(res)
    mem = memory_analysis(res)
    n_params = sum(t.numel() for t in pytree.tree_leaves(state[0]))
    six_nt = 6.0 * n_params * batch * cfg.seq
    if on_card:
        _sync(dev)
        torch.cuda.reset_peak_memory_stats()
    out_state, _ = compiled(state, tokens, targets)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del out_state, state
    consts = detect_device_constants() if on_card else None
    print(f"profiler 16d: {cost['flops'] / 1e12:.3f} TFLOP a step on the "
          f"tensor-core ops ({cost['flops_total'] / 1e12:.3f} with the "
          f"rest), 6 N T = {six_nt / 1e12:.3f} TFLOP (N = {n_params}); "
          f"{cost['bytes accessed'] / 1e9:.2f} GB accessed; memory model "
          f"peak {mem['peak_bytes'] / 1e9:.3f} GB, planner "
          f"{mem['planner_peak_bytes'] / 1e9:.3f} GB, measured "
          f"{peak / 1e9 if peak else 0:.3f} GB; device constants {consts}")
    if not 0.5 * six_nt < cost["flops"] < 2.0 * six_nt:
        raise AssertionError(f"16d: {cost['flops']} FLOPs against 6 N T "
                             f"{six_nt}")
    if on_card and consts is None:
        raise AssertionError(f"16d: no datasheet row for "
                             f"{torch.cuda.get_device_name(0)}")
    return dict(cost=cost, mem=mem, peak=peak, six_nt=six_nt, consts=consts)


def runtime_phase(dev, cfg_kw=None, batch: int = 8, seed: int = 0,
                  world: int = 8, n_tokens: int = 1 << 24):
    """Phase 16: comm on (8,) "dp" (16a), the repaired fence (16b),
    `run_training` with its drills (16c), profiler and device constants
    (16d), on GPT-2 small's f32 flash workload (TF32 off).  Returns the
    B1-B3 launches of 16c's uninterrupted run and the printed numbers.
    The arguments shrink it for a rehearsal on the CPU."""
    from easydist_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**PP_KW, **(cfg_kw or {})})
    t_phase = time.perf_counter()
    times, out = {}, {}
    t = time.perf_counter()
    out["comm"] = comm_phase(dev, cfg, batch, seed, world)
    times["16a"] = time.perf_counter() - t
    t = time.perf_counter()
    out["fence"] = fence_phase(dev, cfg, batch, seed, world)
    times["16b"] = time.perf_counter() - t
    t = time.perf_counter()
    launches, out["run"] = training_run_phase(dev, cfg, batch, seed,
                                              n_tokens=n_tokens)
    times["16c"] = time.perf_counter() - t
    t = time.perf_counter()
    out["profiler"] = profiler_phase(dev, cfg, batch, seed)
    times["16d"] = time.perf_counter() - t
    print(f"runtime phase: {time.perf_counter() - t_phase:.1f} s "
          f"{ {k: round(v, 1) for k, v in times.items()} }")
    return launches, out


# ------------------------------------------------ Llama-3-8B (phase 17)

# Meta's config.json for meta-llama/Meta-Llama-3-8B, typed in (nothing is
# downloaded): 32 query heads over 8 KV heads at head_dim 128.  The JAX
# model's RMSNorm eps (1e-5) is Llama-3's; its LM head is tied to wte, so
# this is 7.50 B parameters, 30.0 GB in f32
LLAMA3_8B = dict(vocab=128256, seq=8192, dim=4096, heads=32, kv_heads=8,
                 layers=32, ffn_dim=14336, rope_theta=500000.0)
# 17e: the small draft model, the same widths at 2 layers (another seed);
# the self-drafting arms serve only the prompts of this many tokens or
# fewer, since the drafter catches up on a prompt one token at a time
# (a 32-layer step each)
LLAMA_DRAFT_LAYERS = 2
SELF_DRAFT_MAX_PROMPT = 128
# 17f: the same widths with 2 layers, Adam
LLAMA_TRAIN = dict(layers=2, batch=2, seq=1024, steps=3)


def llama_forced_check(tag: str, params, cfg, prompts, ids, dev):
    """Every request's ids against one teacher-forced `llama_apply` over
    prompt + ids: the argmax at each position must be the next id.  On a
    mismatch the top-2 gap there is printed and the request is re-checked
    by growing forwards (`uncached_greedy`), which must then equal it.
    Returns the requests re-checked."""
    from easydist_tpu_torch.models.llama import llama_apply

    regrown = []
    with torch.no_grad():
        for i, (p, out) in enumerate(zip(prompts, ids)):
            seq = torch.tensor([p + out[:-1]], device=dev)
            logits = llama_apply(params, cfg, seq)[0, len(p) - 1:]
            want = logits.argmax(-1).tolist()
            if want == out:
                continue
            j = next(k for k, (a, b) in enumerate(zip(want, out)) if a != b)
            top = logits[j].topk(2).values
            print(f"{tag}: request {i} leaves the teacher-forced argmax at "
                  f"token {j} (top-2 gap {float(top[0] - top[1]):.3e}); "
                  f"re-checking by growing forwards")
            grown = uncached_greedy(params, cfg, p, len(out),
                                    apply=llama_apply)
            if grown != out:
                raise AssertionError(f"{tag}: request {i}'s ids differ from "
                                     f"the uncached reference")
            regrown.append(i)
    return regrown


def llama_spec_launches(tag, launches, rounds, feeds, drafter_launches,
                        layers: int, draft_layers: int, paged: bool, dev):
    """Phase 11's formula with a draft model of other depth: the target's
    kernel launches layers x plain rounds (B4 bucketed, B5 paged), the
    drafter's B4 draft_layers x feeds, nothing else."""
    on_card = dev.type == "cuda"
    want = {name: 0 for name in DECODE_KERNELS}
    if on_card:
        want["paged_decode" if paged else "flash_decode"] += layers * rounds
        want["flash_decode"] += draft_layers * feeds
    if launches != want or drafter_launches != (draft_layers * feeds
                                                if on_card else 0):
        raise AssertionError(f"{tag}: launches {launches} (drafter "
                             f"{drafter_launches}), expected {want}")


def llama_phase(dev, cfg_kw=None, n_new: int = 32, serve_kw=None,
                seed: int = 0, prompts=None, train_kw=None):
    """Phase 17: a Llama at Llama-3-8B's published widths and full depth
    (random f32 weights from a seeded generator) through
    `GenerationSession.for_llama`, phase 4's traffic and config.  (a)
    bucketed f32: ids equal the teacher-forced reference, one decode
    signature, the prefix cache hits, B4 32 x rounds (B5, B6 none), then
    a profiled f32 decode window on the card; (b)
    paged f32: ids equal (a)'s, one decode and one prefill signature, B5
    32 x rounds, the page-table audit clean after the drain; (c) int8
    pages f32: B6 32 x rounds, a rerun gives identical ids,
    `kv_quant_bytes_saved` > 0, teacher-forced drift against exact pages
    within 0.25 x the logit spread; (d) bf16 on both layouts: finite
    logits, tokens/s, host ms and device busy share of a profiled decode
    window, the id agreement with f32, and the ms of the GQA repeat the
    bucketed step pays; (e) speculate_k=4 on both layouts, with a 2-layer
    llama of the same widths (another seed) as the draft model, and with
    the target drafting for itself on the prompts of at most
    SELF_DRAFT_MAX_PROMPT tokens (at least one draft accepted): ids equal
    (a)'s, one verify signature, launches by phase 11's formula; (f)
    `make_llama_train_step` at the same widths with 2 layers, batch 2,
    seq 1024: 3 compiled steps equal 3 uncompiled at rtol 1e-4.  The
    arguments shrink it for a rehearsal on the CPU.  Returns the launches
    of (a)-(c), (e)'s, and the printed numbers."""
    import dataclasses
    import gc
    import itertools

    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.kv import audit_page_table
    from easydist_tpu_torch.models import llama
    from easydist_tpu_torch.serve import GenerationSession, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    times, out = {}, {}
    cfg_kw = {**LLAMA3_8B, **(cfg_kw or {})}
    cfg = llama.LlamaConfig(**cfg_kw, dtype="float32")
    serve_kw = serve_kw or SERVE_KW
    factory = GenerationSession.for_llama
    params = llama.llama_init(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = sum(x.numel() for x in pytree.tree_leaves(params))
    prompts = prompts or make_prompts(cfg.vocab, seed)
    print(f"llama: {n_params / 1e9:.3f} B parameters "
          f"({4 * n_params / 1e9:.2f} GB f32), {cfg}")

    # (a) bucketed, f32
    t = time.perf_counter()
    ids, sess, launches, rounds, secs = serve(
        params, cfg, prompts, n_new, ServeConfig(**serve_kw), dev, factory)
    stats = sess.stats()
    t_ref = time.perf_counter()
    regrown = llama_forced_check("llama 17a", params, cfg, prompts, ids, dev)
    ref_s = time.perf_counter() - t_ref
    if stats["decode_signatures"]["size"] != 1:
        raise AssertionError(f"llama 17a decode signatures "
                             f"{stats['decode_signatures']}")
    hits = prefix_hits(stats)
    if hits <= 0:
        raise AssertionError("llama 17a: the prefix cache never hit")
    check_launches("llama 17a", launches, "flash_decode", cfg.layers, rounds,
                   dev)
    out["flash_decode"] = launches["flash_decode"]
    print(f"llama 17a bucketed f32: {len(prompts)} requests, "
          f"{sum(map(len, ids))} tokens, {rounds} decode rounds, {secs:.2f} s "
          f"incl. tracing; ids equal the teacher-forced reference for all "
          f"{len(prompts)} requests ({ref_s:.2f} s; re-checked by growing "
          f"forwards: {regrown}); 1 decode signature; prefix hits {hits}; "
          f"B4 {launches['flash_decode']} = {cfg.layers} x {rounds} rounds, "
          f"B5 and B6 0")
    del sess
    if on_card:
        out["profile_f32"] = profile_decode(
            params, cfg, ServeConfig(**serve_kw), dev, prompts, n_new,
            "llama bucketed f32", factory=factory)
    times["17a"] = time.perf_counter() - t

    # (b) paged, f32
    t = time.perf_counter()
    paged_cfg = ServeConfig(**{**serve_kw, "kv_layout": "paged"})
    ids_b, sess, launches, rounds, secs = serve(params, cfg, prompts, n_new,
                                                paged_cfg, dev, factory)
    check_ids("llama 17b", ids_b, ("17a's ids", ids))
    stats = sess.stats()
    sigs = (stats["decode_signatures"]["size"],
            stats["prefill_signatures"]["size"])
    if sigs != (1, 1):
        raise AssertionError(f"llama 17b decode/prefill signatures {sigs}")
    check_launches("llama 17b", launches, "paged_decode", cfg.layers, rounds,
                   dev)
    pool = next(iter(sess._pools.values()))
    problems = audit_page_table(pool.pool, pool.table, trie=pool.trie)
    if problems or pool.table.n_mapped(0) or pool.jobs or pool.slots:
        raise AssertionError(f"llama 17b page table after drain: {problems}")
    out["paged_decode"] = launches["paged_decode"]
    print(f"llama 17b paged f32: ids equal 17a's for all {len(prompts)} "
          f"requests; 1 decode and 1 prefill signature; B5 "
          f"{launches['paged_decode']} = {cfg.layers} x {rounds} rounds, B4 "
          f"0; page-table audit clean; arena "
          f"{tuple(pool.arena['k'].shape)}; {secs:.2f} s incl. tracing")
    del sess, pool
    times["17b"] = time.perf_counter() - t

    # (c) int8 pages, f32
    t = time.perf_counter()
    q_cfg = ServeConfig(**{**serve_kw, "kv_layout": "paged",
                           "kv_quant_dtype": "int8"})
    ids_c, sess, launches, rounds, secs = serve(params, cfg, prompts, n_new,
                                                q_cfg, dev, factory)
    pool = next(iter(sess._pools.values()))
    dtypes = {k: x.dtype for k, x in pool.arena.items()}
    if dtypes != {"k": torch.int8, "v": torch.int8,
                  "k_scale": torch.float32, "v_scale": torch.float32}:
        raise AssertionError(f"llama 17c arena dtypes {dtypes}")
    check_launches("llama 17c", launches, "paged_decode_quant", cfg.layers,
                   rounds, dev)
    saved = sess.metrics.snapshot()["gauges"].get("kv_quant_bytes_saved", 0)
    if saved <= 0:
        raise AssertionError(f"llama 17c kv_quant_bytes_saved {saved}")
    del sess, pool
    again, *_ = serve(params, cfg, prompts, n_new, q_cfg, dev, factory)
    if again != ids_c:
        raise AssertionError("llama 17c: an int8 rerun gave other ids")
    drift, spread = int8_drift(params, cfg, prompts[3], n_new, dev,
                               serve_kw["prefill_chunk"], llama.init_kv_pages,
                               llama.llama_prefill_chunk_paged,
                               llama.llama_decode_step_paged)
    if not drift <= 0.25 * spread:
        raise AssertionError(f"llama 17c int8 drift {drift} > 0.25 x "
                             f"{spread}")
    out["paged_decode_quant"] = launches["paged_decode_quant"]
    n = sum(map(len, ids_c))
    same = sum(a == b for x, y in zip(ids, ids_c) for a, b in zip(x, y))
    print(f"llama 17c int8 f32: rerun ids identical; kv_quant_bytes_saved "
          f"{saved}; teacher-forced drift {drift:.4e} against logit spread "
          f"{spread:.4e} (bar {0.25 * spread:.4e}); B6 "
          f"{launches['paged_decode_quant']} = {cfg.layers} x {rounds} "
          f"rounds, B4 and B5 0; ids equal the exact ones at {same} of {n} "
          f"positions")
    times["17c"] = time.perf_counter() - t

    # (d) bf16, both layouts, and the GQA repeat the bucketed step pays
    t = time.perf_counter()
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    out["bf16"] = {}
    for layout, kernel in (("bucketed", "flash_decode"),
                           ("paged", "paged_decode")):
        sc = ServeConfig(**{**serve_kw, "kv_layout": layout})
        out["bf16"][layout] = serve_bf16(
            f"llama {layout}", params, cfg16, prompts, n_new, sc, ids,
            kernel, dev, factory=factory, apply=llama.llama_apply)
    if on_card:
        b, s_, t_ = SERVE_KW["max_decode_slots"], cfg.kv_heads, 1024
        hd = cfg.dim // cfg.heads
        rep = cfg.heads // cfg.kv_heads
        out["repeat_ms"] = {}
        for dtype in (torch.float32, torch.bfloat16):
            cache = [torch.randn(b, s_, t_, hd, device=dev, dtype=dtype)
                     for _ in range(TIMED_COPIES)]
            ms = time_ms(lambda i: cache[i % TIMED_COPIES].repeat_interleave(
                rep, dim=1))
            out["repeat_ms"][str(dtype)[6:]] = ms
            nbytes = b * s_ * t_ * hd * (torch.finfo(dtype).bits // 8) \
                * (1 + rep)
            print(f"llama 17d GQA repeat {str(dtype)[6:]} [{b},{s_},{t_},"
                  f"{hd}] -> {rep}x: {ms:.4f} ms a tensor, {2 * ms:.4f} ms "
                  f"a layer (K and V), {2 * cfg.layers * ms:.3f} ms a decode "
                  f"round; bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms a "
                  f"tensor (bytes)")
            del cache
    times["17d"] = time.perf_counter() - t

    # (e) speculation: a 2-layer llama of the same widths as drafter, and
    # the target drafting for itself so that drafts are accepted
    t = time.perf_counter()
    dcfg = dataclasses.replace(cfg, layers=LLAMA_DRAFT_LAYERS)
    dparams = llama.llama_init(
        dcfg, torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    short = [i for i, p in enumerate(prompts)
             if len(p) <= SELF_DRAFT_MAX_PROMPT]
    out["spec"] = {"bucketed": {}, "paged": {}}
    for layout, drafter in itertools.product(out["spec"], ("small", "self")):
        if drafter == "small":
            dp, dc, arm = dparams, dcfg, range(len(prompts))
        else:
            dp, dc, arm = params, cfg, short
        sc = ServeConfig(**{**serve_kw, "kv_layout": layout,
                            "speculate_k": SPEC_K,
                            "speculate_drafter": "draft_model"})
        with drafter_b4_launches() as drafter_launches:
            ids_e, sess, launches, rounds, secs = serve(
                params, cfg, [prompts[i] for i in arm], n_new, sc, dev,
                factory, draft_model=(dp, dc))
        tag = f"llama 17e {layout} {drafter}-draft"
        check_ids(tag, ids_e, ("17a's ids", [ids[i] for i in arm]))
        counts = spec_counts(sess)
        sigs = sess.stats()["verify_signatures"]
        if counts["verify_rounds"] < 1 or sigs["size"] != 1:
            raise AssertionError(f"{tag}: {counts}, verify signatures "
                                 f"{sigs}")
        if drafter == "self" and counts["accepted"] < 1:
            raise AssertionError(f"{tag}: no draft accepted {counts}")
        feeds = sess._drafter.feeds
        llama_spec_launches(tag, launches, rounds, feeds,
                            drafter_launches[0], cfg.layers, dc.layers,
                            layout == "paged", dev)
        out["spec"][layout][drafter] = launches
        print(f"{tag} ({dc.layers} layers): ids equal 17a's for all "
              f"{len(arm)} requests; {counts}; 1 verify signature; "
              f"{rounds} plain rounds, {feeds} draft feeds, launches "
              f"{launches} (drafter's B4 {drafter_launches[0]} = "
              f"{dc.layers} x {feeds}); {secs:.2f} s incl. tracing")
        del sess
    del dparams, params, dp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        print(f"llama: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
              f"allocated after the serving arms")
    times["17e"] = time.perf_counter() - t

    t = time.perf_counter()
    out["train"] = llama_train_phase(dev, cfg_kw, seed,
                                     **{**LLAMA_TRAIN, **(train_kw or {})})
    times["17f"] = time.perf_counter() - t
    print(f"llama phase: {time.perf_counter() - t_phase:.1f} s "
          f"{ {k: round(v, 1) for k, v in times.items()} }")
    return out


def llama_train_phase(dev, cfg_kw, seed: int, layers: int, batch: int,
                      seq: int, steps: int):
    """17f: `make_llama_train_step` (f32, TF32 off) at `cfg_kw`'s widths
    with `layers` layers: `steps` compiled steps against as many
    uncompiled ones from the same state, rtol 1e-4.  Returns the losses
    and the compiled step's ms."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models.llama import (LlamaConfig,
                                                 make_llama_train_step)

    cfg = LlamaConfig(**{**cfg_kw, "layers": layers, "dtype": "float32"})
    step, init = make_llama_train_step(cfg, lr=1e-4)
    state = init(torch.Generator(device=dev).manual_seed(seed + 2),
                 device=dev)
    n_params = sum(x.numel() for x in pytree.tree_leaves(state[0]))
    rs = np.random.RandomState(seed + 3)
    tokens = torch.as_tensor(rs.randint(0, cfg.vocab, (batch, seq)),
                             device=dev)
    targets = torch.as_tensor(rs.randint(0, cfg.vocab, (batch, seq)),
                              device=dev)
    eager_state = pytree.tree_map(torch.clone, state)
    compiled = easydist_compile(step, mesh=dev)
    losses = []
    t0 = time.perf_counter()
    state, loss = compiled(state, tokens, targets)
    losses.append(float(loss))
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, loss = compiled(state, tokens, targets)
        losses.append(float(loss))
    step_ms = (time.perf_counter() - t0) * 1e3 / max(1, steps - 1)
    del state
    eager = []
    for _ in range(steps):
        eager_state, loss = step(eager_state, tokens, targets)
        eager.append(float(loss))
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    print(f"llama 17f train f32 ({layers} layers, {n_params / 1e9:.3f} B "
          f"parameters with Adam, batch {batch}, seq {seq}): compiled losses "
          f"{losses}, uncompiled {eager}; first step {trace_s:.2f} s incl. "
          f"tracing, then {step_ms:.1f} ms a step; peak "
          f"{peak if peak is None else round(peak, 2)} GB")
    np.testing.assert_allclose(losses, eager, rtol=1e-4,
                               err_msg="llama compiled train step != "
                                       "uncompiled")
    if compiled.cache_stats()["size"] != 1:
        raise AssertionError(f"llama 17f signatures {compiled.cache_stats()}")
    print(f"llama 17f: compiled equals uncompiled at rtol 1e-4 over {steps} "
          f"steps (bitwise: {losses == eager}); 1 signature")
    return {"losses": losses, "eager": eager, "step_ms": step_ms}


# ------------------------------ restore across a topology change (phase 18)

# (mode, world) of the gloo CPU ranks that save phase 16's GPT-2 small
# f32 Adam state
RESHARD_SAVES = (("zero2", 4), ("zero3", 2))


def reshard_full_state(cfg, seed: int):
    """GPT-2 small's f32 Adam state, whole, from a seed, on the CPU:
    (params, {"mu", "nu"}, count) with params from `gpt_init`, moments
    made from them (mu = 0.1 p, nu = p^2: one draw, distinct values),
    count 7."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.models.gpt import gpt_init

    params = gpt_init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return (params, {"mu": pytree.tree_map(lambda p: p * 0.1, params),
                     "nu": pytree.tree_map(torch.square, params)},
            torch.tensor(7, dtype=torch.int32))


def reshard_rank_state(full, mode: str, world: int, rank: int):
    """This rank's blocks of the whole state under `mode` on `world`
    ranks, with the layout `parallel.dp.dp_state_layout` states (zero2's
    moment blocks as [1, d0/n, ...])."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.parallel import dp_state_layout
    from easydist_tpu_torch.reshard import device_windows
    from easydist_tpu_torch.reshard.plan import flatten_layout

    layout = dp_state_layout(full[0], mode, world)
    leaves, spec = pytree.tree_flatten(full)
    local = []
    for x, lay in zip(leaves, flatten_layout(layout, spec)):
        if len(lay) > 2:
            (lo, hi), *_ = device_windows(lay[2], lay[0], lay[1])[rank]
            x = x[lo:hi]
            x = x[None] if mode == "zero2" else x
        local.append(x.clone())
    return pytree.tree_unflatten(local, spec), layout


def _reshard_save_rank(rank: int, world: int, mode: str, root: str,
                       cfg_kw, seed: int, port: int):
    """A gloo CPU rank of phase 18: its blocks of the seeded state, saved
    with their layout through one commit."""
    import torch.distributed as dist

    from easydist_tpu_torch.models.gpt import GPTConfig
    from easydist_tpu_torch.runtime.checkpoint import save_checkpoint

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        full = reshard_full_state(GPTConfig(**cfg_kw), seed)
        local, layout = reshard_rank_state(full, mode, world, rank)
        del full
        save_checkpoint(root, local, step=1, layout=layout)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def reshard_phase(dev, cfg_kw=None, seed: int = 0, root=None):
    """Phase 18: phase 16's GPT-2 small f32 Adam state (params and
    moments from a seed) saved by gloo CPU ranks spawned here, under zero2
    on 4 ranks and under zero3 on 2, each restored on the card as one
    rank: every leaf bitwise the one-device state of the same seed, the
    device memory allocated above the restored state (and the template)
    within the plan's `chunked_bound()`; restore seconds, GB/s,
    `peak_live_bytes`.  Then the `elastic.restore.oom` drill: the chunk
    halves and the restore stays bitwise.  The arguments shrink it for a
    rehearsal on the CPU."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.models.gpt import GPTConfig
    from easydist_tpu_torch.resilience import fault_plan
    from easydist_tpu_torch.runtime import checkpoint as ck

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    cfg_kw = {**PP_KW, **(cfg_kw or {})}
    cfg_kw.pop("attention", None)
    base = root or tempfile.mkdtemp(prefix="reshard_", dir=".")
    full = reshard_full_state(GPTConfig(**cfg_kw), seed)
    ref = pytree.tree_map(lambda x: x.to(dev), full)
    del full
    nbytes = sum(x.numel() * x.element_size()
                 for x in pytree.tree_leaves(ref))
    out = {}
    try:
        # both worlds save at once (6 gloo processes on the host's cores)
        t = time.perf_counter()
        saves = [mp.spawn(_reshard_save_rank,
                          args=(world, mode, os.path.join(
                              base, f"{mode}_w{world}"), cfg_kw, seed,
                              _free_port()), nprocs=world, join=False)
                 for mode, world in RESHARD_SAVES]
        for save in saves:
            while not save.join():
                pass
        save_s = time.perf_counter() - t
        print(f"reshard 18: the gloo ranks of both worlds saved in "
              f"{save_s:.2f} s incl. spawning")
        for mode, world in RESHARD_SAVES:
            root_m = os.path.join(base, f"{mode}_w{world}")
            like = pytree.tree_map(torch.zeros_like, ref)
            if on_card:
                torch.cuda.synchronize()
                floor = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            back = ck.load_checkpoint(root_m, like)
            rep = dict(ck.last_restore_report())
            above = (torch.cuda.max_memory_allocated(dev) - floor - nbytes
                     if on_card else None)
            same = _bitwise_tree(back, ref)
            gbps = nbytes / rep["load_s"] / 1e9
            print(f"reshard 18 {mode} saved on {world} gloo ranks -> 1 "
                  f"rank on {dev.type}: "
                  f"bitwise the one-device state {same}; restore "
                  f"{rep['verify_s'] + rep['load_s']:.2f} s (verify "
                  f"{rep['verify_s']:.2f}, load {rep['load_s']:.2f}: "
                  f"{gbps:.3f} GB/s for {nbytes / 1e9:.3f} GB); "
                  f"{rep['files_opened']} files, {rep['n_planned']} leaves "
                  f"planned, topology shift {rep['topology_shift']}; plan "
                  f"peak_live_bytes {rep['peak_live_bytes']}, chunked_bound "
                  f"{rep['chunked_bound']}, chunk {rep['chunk_bytes']}; "
                  f"allocated above the restored state {above}")
            if not same or not rep["topology_shift"]:
                raise AssertionError(f"reshard 18 {mode}: bitwise {same}, "
                                     f"shift {rep['topology_shift']}")
            if on_card and above > rep["chunked_bound"]:
                raise AssertionError(f"reshard 18 {mode}: {above} B above "
                                     f"the restored state, over the bound "
                                     f"{rep['chunked_bound']}")
            out[mode] = {"save_s": save_s, "verify_s": rep["verify_s"],
                         "load_s": rep["load_s"], "gb_per_s": gbps,
                         "above": above,
                         "peak_live_bytes": rep["peak_live_bytes"],
                         "chunked_bound": rep["chunked_bound"]}
            del back, like
        like = pytree.tree_map(torch.zeros_like, ref)
        with fault_plan("elastic.restore.oom@1"):
            back = ck.load_checkpoint(os.path.join(base, "zero2_w4"), like,
                                      verify=False)
        rep = ck.last_restore_report()
        halved = (rep["chunk_bytes"] == edconfig.reshard_chunk_bytes // 2
                  and [a["outcome"] for a in rep["attempts"]]
                  == ["oom", "landed"])
        same = _bitwise_tree(back, ref)
        print(f"reshard 18 elastic.restore.oom drill: attempts "
              f"{rep['attempts']}; chunk halved {halved}; bitwise {same}")
        if not (halved and same):
            raise AssertionError("reshard 18: the oom drill did not halve "
                                 "the chunk or lost bits")
    finally:
        if root is None:
            shutil.rmtree(base, ignore_errors=True)
    print(f"reshard phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# Phases 11-13, 15a-b and 16 run GPT-2 small's widths at 6 layers in the
# whole script (their gates follow cfg.layers; phase 14's 4-stage splits,
# 15c's two stages, each of which must hold blocks, and 15d's use of phase
# 4's sessions keep 12): phases 17-18 would otherwise take the script past
# 800 s of its 1200 s limit
CUT_DEPTH = dict(layers=6)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def mark(phase: str):
        print(f"chip_smoke: {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s")

    print(card_line())
    build_kernels()
    entry = kernel_phase(dev)
    paged_entries = paged_kernel_phase(dev)
    train_entries = train_kernel_phase(dev)
    llama_kernels = llama_kernel_phase(dev)
    for e in (entry, *paged_entries):
        e["llama"] = llama_kernels[e["name"]]
    mark("phases 1-3")
    ctx = serve_phase(dev)
    entry["launches"] = ctx["launches"]
    paged_entries[0]["launches"], paged_ids = paged_serve_phase(dev, ctx)
    paged_entries[1]["launches"] = int8_serve_phase(dev, ctx, paged_ids)
    mesh_ctx = {k: ctx[k] for k in ("params", "cfg_kw", "serve_kw",
                                    "prompts", "n_new", "ref", "ids")}
    mesh_ctx["paged_ids"] = paged_ids
    del ctx
    torch.cuda.empty_cache()
    mark("phases 4-6")
    launches, bf16_launches, f32_losses = train_phase(dev)
    for e in train_entries:
        e["launches"] = launches[e["name"]]
        e["launches_bf16"] = bf16_launches[e["name"]]
    mark("phase 7")
    torch.cuda.empty_cache()
    sharding_phase(dev)
    flash_out = frontend_phase(dev, f32_losses)
    ring = attention_phase(dev, flash_out)["long"]["runs"][0]["launches"]
    for e in train_entries:
        e["launches_ring_rank0"] = ring[e["name"]]
    mark("phases 8-10")
    torch.cuda.empty_cache()
    spec = spec_phase(dev, cfg_kw=CUT_DEPTH)
    entry["launches_spec"] = spec["a"]
    paged_entries[0]["launches_spec"] = spec["b"]
    torch.cuda.empty_cache()
    tier = tier_phase(dev, cfg_kw=CUT_DEPTH)
    paged_entries[0]["launches_tier"] = tier["paged_decode"]
    paged_entries[1]["launches_tier"] = tier["paged_decode_quant"]
    torch.cuda.empty_cache()
    train_entries[0]["launches_engine"] = engine_phase(dev,
                                                      cfg_kw=CUT_DEPTH)
    mark("phases 11-13")
    torch.cuda.empty_cache()
    launches_pp, launches_dp, _ = pipeline_phase(dev)
    for e in train_entries:
        e["launches_pp"] = {sched: [r[e["name"]] for r in ranks]
                            for sched, ranks in launches_pp.items()}
        e["launches_dp"] = {mode: r[e["name"]]
                            for mode, r in launches_dp.items()}
    mark("phase 14")
    torch.cuda.empty_cache()
    tail = tail_phase(dev, mesh_ctx, remat_kw=CUT_DEPTH)
    for e in train_entries:
        e["launches_remat"] = {run: r[e["name"]]
                               for run, r in tail["remat"].items()}
        e["launches_pp_tp"] = [r[e["name"]] for r in tail["pp_tp"]]
    entry["launches_mesh"] = tail["mesh"]["flash_decode"]
    paged_entries[0]["launches_mesh"] = tail["mesh"]["paged_decode"]
    mark("phase 15")
    torch.cuda.empty_cache()
    launches_runtime, _ = runtime_phase(dev, cfg_kw=CUT_DEPTH)
    for e in train_entries:
        e["launches_runtime"] = launches_runtime[e["name"]]
    mark("phase 16")
    torch.cuda.empty_cache()
    llama = llama_phase(dev)
    for e in (entry, *paged_entries):
        e["launches_llama"] = llama[e["name"]]
    entry["launches_llama_spec"] = {
        f"{layout} {drafter}": launches["flash_decode"]
        for layout, arms in llama["spec"].items()
        for drafter, launches in arms.items()}
    paged_entries[0]["launches_llama_spec"] = {
        drafter: launches["paged_decode"]
        for drafter, launches in llama["spec"]["paged"].items()}
    mark("phase 17")
    torch.cuda.empty_cache()
    reshard_phase(dev)
    mark("phase 18")
    print(card_line())
    print(json.dumps({"kernels": [entry, *paged_entries, *train_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
