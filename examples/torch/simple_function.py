"""Smallest end-to-end example of the PyTorch/CUDA port: one decorator
auto-parallelizes an unmodified function (the torch twin of
examples/jax/simple_function.py).

    python examples/torch/simple_function.py [--device cpu] [--small]
    torchrun --nproc-per-node 4 examples/torch/simple_function.py

One process compiles for its one device; under `torchrun` (or any
initialised process group of several ranks) the function is solved over
a (world,) "dp" mesh and each rank runs its emitted program.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402


def run(device="cuda", small=False):
    import torch.distributed as dist

    from easydist_tpu_torch import easydist_compile
    from easydist_tpu_torch.fxfront import make_device_mesh

    dev = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = (make_device_mesh((world,), ("dp",), device_type=dev.type)
            if world > 1 else dev)

    @easydist_compile(mesh=mesh)
    def step(w, x):
        return torch.tanh(x @ w).sum()

    m, k, n = (64, 32, 16) if small else (1024, 512, 256)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(k, n, generator=gen).to(dev)
    x = torch.randn(m, k, generator=gen).to(dev)
    out = step(w, x)
    out = out.full_tensor() if hasattr(out, "full_tensor") else out
    result = step.get_compiled(w, x)
    placements = ([[str(p) for p in pl] for pl in result.in_placements]
                  if result.in_placements is not None else None)
    return {"result": float(out), "want": float(torch.tanh(x @ w).sum()),
            "placements": placements}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)

    from easydist_tpu_torch import easydist_setup

    easydist_setup(device=args.device)
    res = run(args.device, args.small)
    print("result:", res["result"])
    print("input placements:", res["placements"])


if __name__ == "__main__":
    main()
