"""Serve a GPT model with continuous batching on the PyTorch/CUDA port
(the torch twin of examples/serve_gpt.py).

Demonstrates `easydist_tpu_torch.serve.ServeEngine` end to end: the GPT
forward compiled once per shape bucket by `easydist_compile`, the
buckets warmed, then concurrent synthetic clients, and the serving
metrics printed (throughput, batch occupancy, cache hit rate, p50 / p95
/ p99 latency).  Attention is "flash": on the card the forward runs B1,
at the tiny config's head_dim 8 on its SIMT kernel
(ops/csrc/flash_attn_simt.cuh) and at GPT-2 small's 64 on the tensor
cores; on the CPU its plain version.

    python examples/torch/serve_gpt.py [--clients 8] [--requests 12]
                                       [--small] [--device cuda]
"""

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def run(device="cuda", small=False, clients=8, requests=12,
        max_wait_ms=8.0, export=True):
    """Serve `clients` x `requests` requests of random lengths and return
    the metrics the example prints, with the errors clients saw and the
    B1 launches of the traffic."""
    from easydist_tpu_torch import easydist_compile
    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_apply, gpt_init
    from easydist_tpu_torch.ops import flash_attention as fa
    from easydist_tpu_torch.serve import ServeConfig, ServeEngine

    dev = torch.device(device)
    cfg = (GPTConfig.small(attention="flash") if small
           else GPTConfig.tiny(attention="flash"))
    seq_buckets = (cfg.seq // 4, cfg.seq // 2, cfg.seq) if small \
        else (16, 32)
    params = gpt_init(cfg, torch.Generator(device=dev.type).manual_seed(0),
                      device=dev)

    def infer(p, tokens):
        return gpt_apply(p, cfg, tokens)

    compiled = easydist_compile(infer, state_io={})
    engine = ServeEngine(
        compiled,
        ServeConfig(batch_buckets=(4, 8), seq_buckets=seq_buckets,
                    max_wait_ms=max_wait_ms, max_queue=512,
                    default_deadline_ms=60_000.0),
        state=params, device=dev)

    print(f"# warming {2 * len(seq_buckets)} buckets "
          f"(batch 4,8 x seq {seq_buckets}) ...", file=sys.stderr)
    t0 = time.time()
    warmed = engine.warmup((np.zeros((seq_buckets[0],), np.int32),))
    print(f"# warmed {warmed} bucket shapes in {time.time() - t0:.1f}s",
          file=sys.stderr)

    errors = []

    def client(cid):
        rng = np.random.RandomState(cid)
        try:
            for _ in range(requests):
                n = int(rng.randint(4, max(seq_buckets) + 1))
                toks = rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
                logits = engine.infer(toks, timeout=120)
                assert logits.shape == (n, cfg.vocab)
                # open-loop-ish think time so batches interleave
                time.sleep(float(rng.uniform(0, 0.01)))
        except Exception as e:  # noqa: BLE001 - demo reporting
            errors.append((cid, repr(e)))

    launches = fa.flash_fwd.launches
    t0 = time.time()
    with engine:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        stats = engine.stats()
        if export:
            engine.export_metrics(sub_key="serve_gpt_example")

    done = stats["counters"].get("requests_completed", 0)
    lat = stats["latency"]["e2e"]
    return {
        "requests_completed": done,
        "errors": errors,
        "throughput_req_s": round(done / wall, 2),
        "batch_occupancy": round(stats["batch_occupancy"] or 0.0, 3),
        "compile_cache_hit_rate": round(
            stats["compile_cache_hit_rate"] or 0.0, 3),
        "distinct_executables": stats["distinct_executables"],
        "p50_ms": round(1e3 * (lat.get("p50_s") or 0.0), 2),
        "p95_ms": round(1e3 * (lat.get("p95_s") or 0.0), 2),
        "p99_ms": round(1e3 * (lat.get("p99_s") or 0.0), 2),
        "device": str(dev),
        "head_dim": cfg.dim // cfg.heads,
        "flash_fwd_launches": fa.flash_fwd.launches - launches,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=12,
                    help="requests per client")
    ap.add_argument("--small", action="store_true",
                    help="GPT-2 small instead of the tiny smoke config")
    ap.add_argument("--max-wait-ms", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from easydist_tpu_torch import easydist_setup

    easydist_setup(device=args.device)
    out = run(args.device, args.small, args.clients, args.requests,
              args.max_wait_ms)
    print(json.dumps(out, indent=1))
    if out["errors"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
