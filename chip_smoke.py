#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`easydist_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each raising on failure (exit code != 0, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA kernel of the serving path from `csrc/` (nvcc);
  3. each kernel against its plain PyTorch version on the card, at the
     serving shape, in float32 and bfloat16, with times of the kernel,
     the plain version, one library call (SDPA, a yardstick only) and
     the card's least possible time (bound);
  4. serving: GPT-2 small at full width (random weights from a seeded
     generator) through `GenerationSession.for_gpt`.  In float32 every
     request's greedy ids must equal the uncached re-forward through
     `gpt_apply`, one decode signature must serve all, the prefix cache
     must hit, and the decode kernel must have launched 12 x decode
     rounds.  A bfloat16 run of the same traffic must finish with finite
     logits; its tokens/s and id agreement with float32 are printed;
  5. a `{"kernels": [...]}` line, then the `{"ok": true, ...}` line.

Needs a CUDA device and the repository around it; imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SERVE_SHAPE = (8, 12, 1024, 64)          # slots, heads, bucket, head_dim
HBM_BYTES_PER_S = 3.35e12                # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12                  # H100 SXM, float32 off the tensor cores
TIMED_COPIES = 4                         # K/V copies rotated past the 50 MB L2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_kernels():
    from easydist_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build("flash_decode")
    secs = time.perf_counter() - t0
    print(f"build: flash_decode.cu -> {lib.name} in {secs:.2f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())


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


def kernel_phase(dev):
    """flash_decode vs `_decode_attention_xla` on the card; returns the
    kernels-line entry (without `launches`)."""
    import torch.nn.functional as F

    from easydist_tpu_torch.ops.flash_attention import (
        _decode_attention_xla, flash_decode_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, h, t, d = SERVE_SHAPE
    scale = 1.0 / np.sqrt(d)
    rs = np.random.RandomState(0)
    q32 = torch.as_tensor(rs.standard_normal((b, h, d)), dtype=torch.float32,
                          device=dev)
    k32 = torch.as_tensor(rs.standard_normal((b, h, t, d)),
                          dtype=torch.float32, device=dev)
    v32 = torch.as_tensor(rs.standard_normal((b, h, t, d)),
                          dtype=torch.float32, device=dev)
    cases = {
        "len 1": [1] * b,
        "len 1024": [t] * b,
        "len 300 (not a tile multiple)": [300] * b,
        "mixed": [1, t, 300, 77, 513, 256, 999, 5],
    }
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        for name, lens in cases.items():
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = flash_decode_attention(q, k, v, L)
            torch.cuda.synchronize()
            # the plain version in float32 on the same (rounded) inputs
            ref = _decode_attention_xla(q.float(), k.float(), v.float(), L,
                                        scale)
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            if dtype == torch.float32:
                tol = torch.full_like(ref, 1e-5)
                tol_text = "atol 1e-5"
            else:
                # per element: rounding the output to bf16 costs at most
                # half an ulp, <= 2^-8 |x|; 1e-5 covers f32 summation order
                tol = 2.0 ** -8 * ref.abs() + 1e-5
                tol_text = "2^-8 |ref| + 1e-5 per element"
            worst_ratio = (diff / tol).max().item()
            ok = bool(torch.isfinite(out).all()) and worst_ratio <= 1.0
            print(f"kernel flash_decode {str(dtype)[6:]:9s} {name:31s} "
                  f"max_abs_err {err:.3e} (tol {tol_text}; worst err/tol "
                  f"{worst_ratio:.3f}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"flash_decode disagrees with its plain version: "
                    f"{dtype} {name} err/tol {worst_ratio} > 1")
            worst[dtype] = max(worst.get(dtype, 0.0), err)

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
    library_ms = time_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None], ks[i % TIMED_COPIES], vs[i % TIMED_COPIES],
        attn_mask=mask))
    kernel_ms_2 = time_ms(lambda i: flash_decode_attention(
        q, ks[i % TIMED_COPIES], vs[i % TIMED_COPIES], L))
    flash_decode_attention.launches = launches_before  # timing runs don't count
    bound_ms, bound_by = decode_bound_ms(lens, SERVE_SHAPE, 2)
    print(f"time flash_decode bf16 {list(SERVE_SHAPE)} lengths {t}: kernel "
          f"{kernel_ms:.4f} ms (again {kernel_ms_2:.4f}), plain "
          f"{plain_ms:.4f} ms, library (SDPA, masked) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_decode", "route": "cuda",
            "source": "easydist_tpu_torch/ops/csrc/flash_decode.cu",
            "replaces": "easydist_tpu/ops/flash_attention.py:409",
            "shape": f"q [{b},{h},{d}] k/v {list(SERVE_SHAPE)} bfloat16, "
                     f"lengths {t}",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_f32": worst[torch.float32],
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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


def uncached_greedy(params, cfg, prompt, n_new: int):
    """Greedy ids by re-running the whole sequence through gpt_apply for
    every token (no KV cache)."""
    from easydist_tpu_torch.models.gpt import gpt_apply

    dev = params["wte"].device
    cur = list(prompt)
    out = []
    with torch.no_grad():
        for _ in range(n_new):
            logits = gpt_apply(params, cfg,
                               torch.tensor([cur], device=dev))
            nxt = int(torch.argmax(logits[0, len(cur) - 1]))
            out.append(nxt)
            cur.append(nxt)
    return out


def serve(params, cfg, prompts, n_new: int, serve_cfg, dev):
    """Drive the session over `prompts`; returns (ids, stats, launches,
    decode_rounds, seconds) for this run alone."""
    from easydist_tpu_torch.ops.flash_attention import flash_decode_attention
    from easydist_tpu_torch.serve import GenerationSession

    sess = GenerationSession.for_gpt(params, cfg, config=serve_cfg,
                                     device=dev)
    rounds0 = sess.metrics.counter("decode_steps")
    flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    futs = [sess.submit(p, max_new_tokens=n_new) for p in prompts]
    sess.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = flash_decode_attention.launches
    rounds = sess.metrics.counter("decode_steps") - rounds0
    ids = [f.result(timeout=0)["ids"] for f in futs]
    return ids, sess.stats(), launches, rounds, secs


def serve_phase(dev, cfg_kw=None, n_new: int = 32, serve_kw=None,
                prompts=None, seed: int = 0):
    """Phase 4; returns the decode kernel's launches in the f32 run.
    The arguments shrink it for a rehearsal on the CPU."""
    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_apply, gpt_init
    from easydist_tpu_torch.serve import ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.small(**(cfg_kw or {}))
    serve_cfg = ServeConfig(**(serve_kw or dict(
        decode_buckets=(1024,), max_decode_slots=8, prefill_chunk=64,
        prefill_batch=4)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = gpt_init(cfg, gen, device=dev)
    prompts = prompts or make_prompts(cfg.vocab, seed)

    ids, stats, launches, rounds, secs = serve(params, cfg, prompts, n_new,
                                               serve_cfg, dev)
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
    hits = sum(b["prefix_cache"]["hits"] for b in stats["buckets"].values()
               if b["prefix_cache"])
    if hits <= 0:
        raise AssertionError("the prefix cache never hit")
    expect = cfg.layers * rounds if dev.type == "cuda" else 0
    if launches != expect or (dev.type == "cuda" and launches <= 0):
        raise AssertionError(f"decode kernel launched {launches} times, "
                             f"expected {cfg.layers} x {rounds} rounds")
    print(f"serve f32: ids equal the uncached re-forward for all "
          f"{len(prompts)} requests; 1 decode signature; prefix cache hits "
          f"{hits}; launches {launches} = {cfg.layers} x {rounds} rounds")

    # bf16: same weights and traffic; one warm-up request traces first
    cfg16 = GPTConfig.small(**{**(cfg_kw or {}), "dtype": "bfloat16"})
    serve(params, cfg16, prompts[1:2], 2, serve_cfg, dev)
    ids16, _, launches16, rounds16, secs16 = serve(params, cfg16, prompts,
                                                   n_new, serve_cfg, dev)
    if launches16 != (cfg.layers * rounds16 if dev.type == "cuda" else 0):
        raise AssertionError(f"bf16 decode kernel launches {launches16} "
                             f"!= {cfg.layers} x {rounds16}")
    with torch.no_grad():
        for p, out in zip(prompts, ids16):
            seq = torch.tensor([p + out[:-1]], device=dev)
            if not torch.isfinite(gpt_apply(params, cfg16, seq)).all():
                raise AssertionError("bf16 logits are not finite")
    n16 = sum(len(x) for x in ids16)
    same = sum(a == b for x, y in zip(ids, ids16) for a, b in zip(x, y))
    print(f"serve bf16: {n16} tokens in {secs16:.3f} s = "
          f"{n16 / secs16:.1f} tokens/s ({rounds16} decode rounds, "
          f"traced beforehand); logits finite; ids equal to f32 at "
          f"{same} of {n16} positions")
    if dev.type == "cuda":
        profile_decode(params, cfg16, serve_cfg, dev, prompts, n_new)
    return launches


def profile_decode(params, cfg, serve_cfg, dev, prompts, n_new: int,
                   rounds: int = 8):
    """Device time of decode-only rounds (all 8 slots live, prefills
    done) under torch.profiler: ms per round on the host clock, device
    busy ms per round (sum of kernel times), and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from easydist_tpu_torch.serve import GenerationSession

    sess = GenerationSession.for_gpt(params, cfg, config=serve_cfg,
                                     device=dev)
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
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, ms in kernels)
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    n_ops = sum(n.op == "call_function"
                for r in sess._decode_c._cache.values()
                for n in r.graph_module.graph.nodes)
    print(f"profile bf16 decode rounds (8 live slots): {wall_ms:.3f} ms per "
          f"round on the host clock, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%); the decode graph replays "
          f"{n_ops} aten calls per round")
    for name, ms in top:
        print(f"  {ms:8.4f} ms/round  {name[:90]}")
    sess.run_until_drained()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(card_line())
    build_kernels()
    entry = kernel_phase(dev)
    entry["launches"] = serve_phase(dev)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
