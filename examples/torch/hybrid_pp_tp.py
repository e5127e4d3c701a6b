"""One-decorator hybrid on the PyTorch/CUDA port: auto-split pipeline
stages x data parallel x solver-chosen tensor parallelism, from an
UNMODIFIED loss function (the torch twin of examples/jax/hybrid_pp_tp.py).

    torchrun --nproc-per-node 8 examples/torch/hybrid_pp_tp.py
    torchrun --nproc-per-node 4 examples/torch/hybrid_pp_tp.py --small

A ("pp", "dp", "tp") mesh of (2, world // 4, 2): pp pipelines the depth,
dp splits the batch, tp splits the wide matmuls inside each stage (the
per-axis ILP decides which ones pay).  Needs 4 or 8 ranks.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402


def run(device="cuda", small=False, steps=5):
    import torch.distributed as dist

    from easydist_tpu_torch import easydist_compile
    from easydist_tpu_torch.fxfront import make_device_mesh

    dev = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world not in (4, 8):
        raise ValueError(f"hybrid_pp_tp needs 4 or 8 ranks, has {world}")
    mesh = make_device_mesh((2, world // 4, 2), ("pp", "dp", "tp"),
                            device_type=dev.type)
    D = 128 if small else 1024
    gen = torch.Generator().manual_seed(0)
    params = {f"w{i}": (torch.randn(D, D, generator=gen) * 0.02).to(dev)
              for i in range(6)}

    def loss_fn(params, x, y):       # plain torch — no sharding anywhere
        h = x
        for i in range(6):
            h = torch.tanh(h @ params[f"w{i}"])
        return torch.mean((h - y) ** 2)

    step = easydist_compile(loss_fn, mesh=mesh, pp_stages=2,
                            n_microbatches=4, lr=1e-3,
                            tp_axes=("tp",), schedule="1f1b")
    x = torch.randn(32, D, generator=gen).to(dev)
    y = torch.randn(32, D, generator=gen).to(dev)
    state = step.init_state(params, x, y)
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, y)
        losses.append(float(loss))
    return {"losses": losses, "tp": step.tp_summary()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)

    from easydist_tpu_torch import easydist_setup

    easydist_setup(device=args.device)
    r = run(args.device, args.small, args.steps)
    print(f"solver tensor-sharded {r['tp']['sharded']} ops inside the "
          f"stages")
    for i, loss in enumerate(r["losses"]):
        print(f"step {i}: loss {loss:.5f}")


if __name__ == "__main__":
    main()
