"""Pipeline-parallel transformer-style blocks over a "pp" mesh axis on
the PyTorch/CUDA port (the torch twin of examples/jax/pipeline_gpt.py).

    torchrun --nproc-per-node 8 examples/torch/pipeline_gpt.py
    python examples/torch/pipeline_gpt.py [--device cpu] [--small]

4 stages: on 4 x k ranks a (4, k) ("pp", "dp") mesh with the
microbatches' batch split over "dp"; in one process every stage runs
here (`LocalStages(4)`).
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402


def run(device="cuda", small=False):
    import torch.distributed as dist

    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.parallel import (LocalStages, PipelineConfig,
                                             spmd_pipeline)
    from easydist_tpu_torch.parallel.pipeline import stack_stage_params

    dev = torch.device(device)
    S, M, mb, d = 4, 8, 4, 32 if small else 128
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world >= S and world % S == 0:
        dp = world // S
        mesh = make_device_mesh((S, dp), ("pp", "dp"), device_type=dev.type)
        data_axis = "dp" if dp > 1 else None
    else:
        mesh, data_axis = LocalStages(S), None

    def stage_fn(p, x):
        h = torch.tanh(x @ p["w1"])
        return x + h @ p["w2"]

    gen = torch.Generator().manual_seed(0)
    stages = [{"w1": torch.randn(d, 4 * d, generator=gen) / math.sqrt(d),
               "w2": torch.randn(4 * d, d, generator=gen) / math.sqrt(4 * d)}
              for _ in range(S)]
    stacked = {k: v.to(dev) for k, v in stack_stage_params(stages).items()}
    x = torch.randn(M, mb, d, generator=gen).to(dev)
    out = spmd_pipeline(stage_fn, mesh,
                        PipelineConfig(S, M, data_axis=data_axis))(stacked, x)
    want = x
    for s in range(S):
        want = stage_fn({k: v[s] for k, v in stacked.items()}, want)
    return {"shape": tuple(out.shape),
            "finite": bool(torch.isfinite(out).all()),
            "max_err": float((out - want[:, :out.shape[1]]).abs().max())
            if data_axis is None else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)

    from easydist_tpu_torch import easydist_setup

    easydist_setup(device=args.device)
    r = run(args.device, args.small)
    print("pipeline output:", r["shape"], "finite:", r["finite"])


if __name__ == "__main__":
    main()
