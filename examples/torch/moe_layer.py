"""Expert-parallel MoE layer over an "ep" mesh axis on the PyTorch/CUDA
port (the torch twin of examples/jax/moe_layer.py).

    torchrun --nproc-per-node 4 examples/torch/moe_layer.py
    python examples/torch/moe_layer.py [--device cpu] [--small]

Every rank passes the same tokens and keeps its block of the output;
the experts are sharded over the axis and tokens reach them by
all_to_all.  One process runs a one-rank group.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402


def one_rank_group(device) -> None:
    """A process group of this process alone, when none is initialised
    (NCCL on a card, gloo on the CPU)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)


def run(device="cuda", small=False):
    import torch.distributed as dist

    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.parallel.moe import (MoEConfig, moe_init,
                                                 moe_layer)

    dev = torch.device(device)
    n = dist.get_world_size()
    mesh = make_device_mesh((n,), ("ep",), device_type=dev.type)
    cfg = MoEConfig(n_experts=2 * n, d_model=16 if small else 64,
                    d_ff=32 if small else 256, capacity_factor=1.5)
    gen = torch.Generator().manual_seed(0)
    params = moe_init(cfg, gen, device=dev)
    tokens = torch.randn(64 * n, cfg.d_model, generator=gen).to(dev)
    y, aux = moe_layer(params, tokens, mesh, cfg)
    return {"n": n, "experts": cfg.n_experts, "shape": tuple(y.shape),
            "aux": float(aux), "finite": bool(torch.isfinite(y).all())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)

    from easydist_tpu_torch import easydist_setup

    easydist_setup(device=args.device)
    one_rank_group(args.device)
    r = run(args.device, args.small)
    print(f"MoE over {r['n']} ranks, {r['experts']} experts: "
          f"out {r['shape']}, load-balance aux {r['aux']:.4f}")


if __name__ == "__main__":
    main()
