"""1F1B pipelined GPT training with interleaved virtual stages on the
PyTorch/CUDA port (the torch twin of examples/jax/pipeline_1f1b_gpt.py):
O(n_stages) live microbatches instead of GPipe's O(M).

    torchrun --nproc-per-node 4 examples/torch/pipeline_1f1b_gpt.py
    python examples/torch/pipeline_1f1b_gpt.py [--device cpu] [--small]

4 stages, each rank running two virtual chunks (8 chunks in all): on 4
ranks a (4,) "pp" mesh, in one process every stage runs here
(`LocalStages(4)`).  `--small` trains `GPTConfig.tiny(layers=8)`; without
it GPT-2 small's widths at 8 layers.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402


def run(device="cuda", small=False, steps=5):
    import torch.distributed as dist

    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.models import GPTConfig
    from easydist_tpu_torch.models.gpt import make_gpt_pipeline_step
    from easydist_tpu_torch.parallel import LocalStages

    dev = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = (make_device_mesh((4,), ("pp",), device_type=dev.type)
            if world == 4 else LocalStages(4))
    cfg = GPTConfig.tiny(layers=8) if small else GPTConfig(layers=8)
    M = 8  # microbatches
    step, init_state = make_gpt_pipeline_step(
        cfg, mesh, n_microbatches=M, schedule="1f1b", n_virtual=2, lr=1e-3)
    state = init_state(torch.Generator(device=dev.type).manual_seed(0),
                       device=dev)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (M, 2, cfg.seq),
                           generator=gen).to(dev)
    losses = []
    for _ in range(steps):
        state, loss = step(state, tokens, tokens)
        losses.append(float(loss))
    return {"losses": losses, "layers": list(step.layers)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)

    from easydist_tpu_torch import easydist_setup

    easydist_setup(device=args.device)
    for i, loss in enumerate(run(args.device, args.small,
                                 args.steps)["losses"]):
        print(f"step {i}: loss {loss:.4f}")


if __name__ == "__main__":
    main()
