"""GPT training with automatic parallelization and elastic checkpointing
on the PyTorch/CUDA port (the torch twin of examples/jax/train_gpt.py).

    python examples/torch/train_gpt.py [--steps 10] [--device cpu] [--small]

`make_gpt_train_step` compiled by `easydist_compile` and driven by
`runtime.run_training`, which checkpoints every 5 steps under `--ckpt`
and resumes from the newest committed one.  `--small` trains
`GPTConfig.tiny()`; without it GPT-2 small.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402


def run(device="cuda", small=False, steps=10, ckpt=None, batch=8):
    from easydist_tpu_torch import easydist_compile
    from easydist_tpu_torch.models import GPTConfig, make_gpt_train_step
    from easydist_tpu_torch.runtime.elastic import run_training

    dev = torch.device(device)
    cfg = GPTConfig.tiny() if small else GPTConfig()
    step, init_state = make_gpt_train_step(cfg, lr=1e-3)
    compiled = easydist_compile(step, mesh=dev)

    def data():
        gen = torch.Generator().manual_seed(0)
        while True:
            toks = torch.randint(0, cfg.vocab, (batch, cfg.seq),
                                 generator=gen)
            yield toks, toks  # predict-same toy objective

    losses = []
    ckpt = ckpt or tempfile.mkdtemp(prefix="easydist_gpt_ckpt_")
    run_training(compiled,
                 lambda: init_state(torch.Generator(device=dev.type)
                                    .manual_seed(0), device=dev),
                 data(), ckpt, total_steps=steps, checkpoint_every=5,
                 device=dev, on_step=lambda s, l: losses.append(float(l)))
    return {"losses": losses, "ckpt": ckpt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)

    from easydist_tpu_torch import easydist_setup

    easydist_setup(device=args.device)
    losses = run(args.device, args.small, args.steps, args.ckpt)["losses"]
    if losses:
        print(f"trained {len(losses)} steps; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print(f"checkpoint already at step {args.steps}; nothing to do "
              f"(state restored OK)")


if __name__ == "__main__":
    main()
