#!/usr/bin/env python3
"""Rank 0's program of a GPT-2 small f32 flash train step, compiled on a
fake process group as `chip_smoke.py`'s phase 9 compiles it, run node by
node on the card, with the memory each node holds beside the port's
liveness model of the same program (`schedule.remat._Liveness`).

For every node: the bytes allocated above the base while it runs (its
inputs, its output and whatever it allocates inside), and the model's
live bytes at its index.  Prints the nodes where the measurement is
furthest above the model, the peaks of both, and the analyzer's
`predicted_peak_bytes`.

    python3 scripts/peak_by_node.py --mesh 8 --top 25

Needs a card (`--tiny` rehearses it on the CPU); from the repository root.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class Memory:
    """The caching allocator's counters on the card; zeros on the CPU."""

    def __init__(self, dev):
        self.on_card = dev.type == "cuda"

    def allocated(self) -> int:
        if not self.on_card:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def reset(self):
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        if not self.on_card:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="8",
                    help="mesh shape, e.g. 8 or 4,2 (axes dp[,tp])")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--tiny", action="store_true",
                    help="a 2-layer, 64-wide model on the CPU (memory "
                         "reads as 0): checks that the script runs")
    ap.add_argument("--profile", action="store_true",
                    help="time the step's ops into a PerfDB first, so the "
                         "solve is priced from card timings")
    args = ap.parse_args()
    if not args.tiny and not torch.cuda.is_available():
        sys.exit("needs a card")
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.fxfront import (easydist_compile,
                                            make_device_mesh,
                                            set_device_mesh)
    from easydist_tpu_torch.models.gpt import GPTConfig, make_gpt_train_step
    from easydist_tpu_torch.schedule.remat import _Liveness

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu" if args.tiny else "cuda")
    mem = Memory(dev)
    if not args.tiny:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    shape = tuple(int(s) for s in args.mesh.split(","))
    names = ("dp", "tp")[:len(shape)]
    cfg = GPTConfig(**(dict(vocab=256, seq=64, dim=64, heads=2, layers=2)
                       if args.tiny else
                       dict(vocab=50304, seq=1024, dim=768, heads=12,
                            layers=12)), attention="flash")
    rs = np.random.RandomState(1)
    tokens = torch.as_tensor(rs.randint(0, cfg.vocab, (args.batch, cfg.seq)),
                             device=dev)
    targets = torch.as_tensor(rs.randint(0, cfg.vocab,
                                         (args.batch, cfg.seq)), device=dev)
    step, init = make_gpt_train_step(cfg, lr=1e-4)
    state = init(torch.Generator(device=dev).manual_seed(0), device=dev)
    edconfig.discovery_device = dev.type
    if args.profile:
        import os

        from easydist_tpu_torch.runtime.op_profile import profile_ops

        edconfig.prof_db_path = os.path.join(".easydist_cache", "perf.db")
        profile_ops(step, state, tokens, targets, trials=3)
    dist.init_process_group("fake", rank=0, world_size=int(np.prod(shape)),
                            store=FakeStore())
    try:
        mesh = make_device_mesh(shape, names, device_type=dev.type)
        compiled = easydist_compile(step, mesh=mesh, compile_only=True)
        res = compiled(state, tokens, targets)
        res.analyze(include_program=False)
        program = res.graph_module
        flat = pytree.tree_leaves(((state, tokens, targets), {}))
        base = mem.allocated()
        mem.reset()
        local = [res.local_shard(x, p, None).clone()
                 for x, p in zip(flat, res.in_placements)]
        rows = []
        # bytes of the distinct storages the program's values reference
        # after each node (the Python side of what is alive)
        env_bytes = []

        def storages(env):
            seen = {}
            for v in list(env.values()) + local:
                for t in pytree.tree_leaves(v):
                    if isinstance(t, torch.Tensor):
                        st = t.untyped_storage()
                        seen[st.data_ptr()] = st.nbytes()
            return sum(seen.values())

        class Probe(torch.fx.Interpreter):
            def run_node(self, n):
                before = mem.allocated() - base
                mem.reset()
                out = super().run_node(n)
                held = mem.peak() - base
                rows.append((n.name, str(n.target), before, held))
                return out

        probe = Probe(program)
        orig = probe.run_node

        def run_node(n):
            out = orig(n)
            env = dict(probe.env)
            env[n] = out
            for gone in probe.user_to_last_uses.get(n, []):
                env.pop(gone, None)
            env_bytes.append(storages(env))
            return out

        probe.run_node = run_node

        with torch.no_grad():
            outs = probe.run(*local)
        after = [r[2] for r in rows[1:]] + [mem.allocated() - base]
        del outs, local
        gm = res.planning_program()
        lv = _Liveness(gm)
        prof = lv.profile()
        model = {n.name: int(prof[i]) for i, n in enumerate(lv.nodes)}
        vals = {n.name: n.meta.get("val") for n in gm.graph.nodes}
        peak_meas = max(r[3] for r in rows)
        peak_model = int(prof.max())
        print(f"mesh {shape}: {len(rows)} nodes; measured peak {peak_meas} "
              f"B above the base; liveness model {peak_model} B; analyzer "
              f"predicted {res.predicted_peak_bytes} B (graph plan "
              f"{res.memory_plan.peak_bytes} B)")
        at = max(rows, key=lambda r: r[3])
        print(f"measured peak at {at[0]} ({at[1]}): held {at[3]}, model "
              f"{model.get(at[0])}")
        # live bytes after each node under the model: started, not ended
        alive = np.zeros(lv.n + 1, dtype=np.int64)
        ok = lv.end > lv.start
        np.add.at(alive, lv.start[ok], lv.size[ok])
        np.add.at(alive, lv.end[ok], -lv.size[ok])
        alive = np.cumsum(alive[:-1])
        model_after = {n.name: int(alive[i]) for i, n in enumerate(lv.nodes)}
        print("where the gaps move (after each node; allocator - model, "
              "allocator - referenced storages, storages - model):")
        last = (0, 0, 0)
        for (name, target, _, _), a, e in zip(rows, after, env_bytes):
            if name not in model_after:
                continue
            g = (a - model_after[name], a - e, e - model_after[name])
            if any(abs(x - y) > (1 << 20) for x, y in zip(g, last)):
                v = vals.get(name)
                desc = (f"{tuple(v.shape)} {v.dtype}"
                        if isinstance(v, torch.Tensor) else
                        type(v).__name__)
                print(f"  {name:28s} {target:44s} {g[0]:>12d} {g[1]:>12d} "
                      f"{g[2]:>12d} out {desc}")
                last = g
        gaps = []
        for name, target, before, held in rows:
            if name not in model:
                continue
            gaps.append((held - model[name], name, target, before, held))
        gaps.sort(reverse=True)
        for gap, name, target, before, held in gaps[:args.top]:
            v = vals.get(name)
            desc = (f"{tuple(v.shape)} {v.dtype}"
                    if isinstance(v, torch.Tensor) else type(v).__name__)
            print(f"  {name:28s} {target:48s} held {held:>12d} model "
                  f"{model[name]:>12d} above {gap:>11d} (in-node "
                  f"{held - before:>11d}) out {desc}")
        transient = sorted(((r[3] - r[2], r[0], r[1]) for r in rows),
                           reverse=True)[:args.top]
        print("largest rise inside one node (output + scratch):")
        for rise, name, target in transient:
            v = vals.get(name)
            out_b = (int(v.numel()) * v.element_size()
                     if isinstance(v, torch.Tensor) else 0)
            print(f"  {name:28s} {target:48s} rise {rise:>11d} output "
                  f"{out_b:>11d} scratch {rise - out_b:>11d}")
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
