"""Llama-style training on the PyTorch/CUDA port: `make_llama_train_step`
compiled by `easydist_compile` on one device, fed by the native
prefetching `TokenLoader`.

python examples/torch/train_llama.py [--steps 5] [--device cpu]

The card is the default device; `--device cpu` runs `LlamaConfig.tiny()`
on the CPU.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models import LlamaConfig, make_llama_train_step
    from easydist_tpu_torch.runtime.data import TokenLoader

    device = torch.device(args.device)
    cfg = LlamaConfig.tiny()
    step, init_state = make_llama_train_step(cfg, lr=3e-4)
    compiled = easydist_compile(step, mesh=device)
    state = init_state(torch.Generator(device=device).manual_seed(0),
                       device=device)

    # a synthetic token file fed through the native prefetching loader
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tokens.bin")
        np.random.default_rng(0).integers(
            0, cfg.vocab, 100_000).astype(np.uint16).tofile(path)
        loader = TokenLoader(path, batch=8, seq=cfg.seq)
        for i, (x, y) in zip(range(args.steps), loader):
            x = torch.as_tensor(x).to(device)
            y = torch.as_tensor(y).to(device)
            state, loss = compiled(state, x, y)
            print(f"step {i}: loss {float(loss):.4f}")
        loader.close()


if __name__ == "__main__":
    main()
