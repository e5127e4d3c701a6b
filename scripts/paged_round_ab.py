#!/usr/bin/env python3
"""Time a paged bf16 decode round of Llama-3-8B's widths (the window
`chip_smoke.py` phase 17d profiles: `LLAMA_CUT_DEPTH` layers, 8 live
slots of phase 4's traffic, B5 once a layer) for several trees in
alternating turns, each turn a process of its own started from its
tree's root, so that each tree runs its own package and kernels.

    python3 scripts/paged_round_ab.py --tree parent=_archive/parent \\
        --pairs 3

"cur" is this checkout; `--tree NAME=DIR` adds another (e.g. a
`git archive` of another commit unpacked under `_archive/`).  Every tree
builds its kernels first, all in parallel.  The turns run cur, parent,
parent, cur, ... (`--pairs` of each order); each turn profiles `--reps`
windows of 8 rounds (`chip_smoke.profile_decode`: host ms a round under
the profiler, device busy ms a round) and reads B5's device ms a round
from its table of the six largest kernels.  The summary gives every
tree's values, median and range, with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import dataclasses, sys, torch
import chip_smoke as c
from easydist_tpu_torch.models import llama
from easydist_tpu_torch.serve import GenerationSession, ServeConfig
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg = llama.LlamaConfig(**{**c.LLAMA3_8B, **c.LLAMA_CUT_DEPTH},
                        dtype="float32")
params = llama.llama_init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
prompts = c.make_prompts(cfg.vocab, 0)
sc = ServeConfig(**{**c.SERVE_KW, "kv_layout": "paged"})
factory = GenerationSession.for_llama
c.serve(params, cfg16, prompts[1:2], 2, sc, dev, factory)
for _ in range(int(sys.argv[1])):
    c.profile_decode(params, cfg16, sc, dev, prompts, 32, "llama paged",
                     factory=factory)
"""
ROUND = re.compile(r"profile llama paged bf16 decode rounds .*?: ([0-9.]+) "
                   r"ms per round on the host clock, device busy ([0-9.]+)")
BUILD = "import chip_smoke as c; c.build_kernels()"
B5 = re.compile(r"^\s*([0-9.]+) ms/round\s.*paged_decode\w*_kernel")


def run(cmd, cwd: Path, timeout: int) -> str:
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout,
                          env={"PYTHONPATH": str(cwd), **_env()})
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise SystemExit(f"{cmd[:3]} in {cwd} exited {proc.returncode}")
    return proc.stdout


def _env() -> dict:
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def spread(xs, digits: int = 3) -> str:
    if not xs:
        return "not in the profile's top 6"
    each = ", ".join(f"{x:.{digits}f}" for x in xs)
    return (f"median {statistics.median(xs):.{digits}f}, range "
            f"{min(xs):.{digits}f}-{max(xs):.{digits}f} ({each})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    trees = {"cur": ROOT}
    for spec in args.tree:
        name, root = spec.split("=", 1)
        trees[name] = Path(root).resolve()
    card = ["nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader"]
    print(subprocess.run(card, capture_output=True, text=True).stdout.strip())
    builds = []
    for root in trees.values():
        log = tempfile.TemporaryFile(mode="w+")
        builds.append((log, subprocess.Popen(
            [sys.executable, "-c", BUILD],
            cwd=root, env={"PYTHONPATH": str(root), **_env()},
            stdout=log, stderr=subprocess.STDOUT, text=True)))
    for name, (log, proc) in zip(trees, builds):
        if proc.wait(timeout=900) != 0:
            log.seek(0)
            raise SystemExit(f"{name}: build failed\n{log.read()[-5000:]}")
        log.close()
    names = list(trees)
    order = [n for i in range(args.pairs)
             for n in (names if i % 2 == 0 else names[::-1])]
    got = {n: {"host": [], "busy": [], "b5": []} for n in names}
    for turn, name in enumerate(order):
        out = run([sys.executable, "-c", CHILD, str(args.reps)],
                  trees[name], 900)
        rounds = ROUND.findall(out)
        b5 = [float(m.group(1)) for line in out.splitlines()
              if (m := B5.match(line))]
        if len(rounds) != args.reps:
            raise SystemExit(f"turn {turn} ({name}): {len(rounds)} windows"
                             f"\n{out[-3000:]}")
        for host, busy in rounds:
            got[name]["host"].append(float(host))
            got[name]["busy"].append(float(busy))
        got[name]["b5"] += b5
        print(f"turn {turn} {name}: host ms a round "
              f"{', '.join(h for h, _ in rounds)}; busy "
              f"{', '.join(b for _, b in rounds)}; B5 "
              f"{', '.join(f'{x:.4f}' for x in b5) or 'not in the top 6'}",
              flush=True)
    for name in names:
        g = got[name]
        print(f"{name}: host ms a round {spread(g['host'])}; device busy "
              f"{spread(g['busy'])}; B5 ms a round {spread(g['b5'], 4)}")
    print(subprocess.run(card, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
