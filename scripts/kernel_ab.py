#!/usr/bin/env python3
"""Compare versions of the training attention kernels (B1 forward, B2 dQ,
B3 dK/dV) on one card, in one process.

Each version is a copy of `easydist_tpu_torch/ops/csrc/`: the package's
own sources ("cur"), another tree's (`--tree NAME=DIR`, e.g. a
`git archive` of another commit unpacked under `_archive/`, whose
`easydist_tpu_torch/ops/csrc` is taken), or the package's sources with
literal edits (`--edit NAME:FILE:OLD=>NEW`, applied to a copy, several
per version).  Every version is built by `nvcc` from its own sources
(`ops/_build`, libraries named by the sources' hash, so they coexist),
checked against the plain PyTorch versions at each shape
(`chip_smoke.check_train_case`: phase 3's bars), then timed in turns,
forward and back (v1, v2, ..., v2, v1), by CUDA events and by the
profiler's device time a launch, beside one SDPA call (its causal
forward, and its whole backward for B2 and B3).  Numbers are printed with the
card's name and power limit.

    python3 scripts/kernel_ab.py --shape 2,32,2048,80 --dtype f32 \\
        --tree parent=_archive/parent \\
        --edit "1wg:flash_attn_fwd.cu:kWG = DP < 128 ?=>kWG = DP == 64 ?"

Needs a card; from the repository root.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from easydist_tpu_torch.ops import _build  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
KERNELS = {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
           "dkv": "flash_bwd_dkv"}


def versions(args, scratch: Path) -> dict:
    """name -> csrc directory of every version, in the order given."""
    out = {"cur": _build.CSRC}
    for spec in args.tree:
        name, root = spec.split("=", 1)
        out[name] = (Path(root) / "easydist_tpu_torch/ops/csrc").resolve()
    edits: dict = {}
    for spec in args.edit:
        name, fname, change = spec.split(":", 2)
        old, new = change.split("=>", 1)
        edits.setdefault(name, []).append((fname, old, new))
    for name, changes in edits.items():
        dst = scratch / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(_build.CSRC, dst)
        for fname, old, new in changes:
            text = (dst / fname).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"edit {name}: {old!r} occurs "
                                 f"{text.count(old)} times in {fname}")
            (dst / fname).write_text(text.replace(old, new))
        out[name] = dst
    return out


def use(csrc: Path):
    _build.CSRC = csrc
    _build._LOADED.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--edit", action="append", default=[])
    ap.add_argument("--shape", action="append", required=True,
                    help="b,h,t,d (causal); repeat for more shapes")
    ap.add_argument("--dtype", action="append", choices=sorted(DTYPES),
                    required=True)
    ap.add_argument("--kernels", default="fwd,dq,dkv")
    ap.add_argument("--only", action="store_true",
                    help="time the versions only (no SDPA)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(c.card_line())
    vers = versions(args, ROOT / "_archive" / "kernel_ab")
    for name, csrc in vers.items():
        use(csrc)
        t0 = time.perf_counter()
        spills = {}
        for lib in ("flash_attn_fwd", "flash_attn_bwd"):
            log = _build.build(lib).with_suffix(".log").read_text()
            spills.update(c.ptxas_spills(log))
        print(f"{name}: {csrc} built in {time.perf_counter() - t0:.1f} s, "
              f"spills {spills or 'none'}")
        if spills:
            raise SystemExit(f"{name} spills: {spills}")
    order = list(vers) + list(vers)[::-1]
    kernels = [KERNELS[k] for k in args.kernels.split(",")]
    for spec in args.shape:
        shape = tuple(int(x) for x in spec.split(","))
        scale = 1.0 / np.sqrt(shape[-1])
        for key in args.dtype:
            dtype = DTYPES[key]
            copies = [[torch.randn(shape, device=dev, dtype=dtype)
                       for _ in range(4)] for _ in range(c.TIMED_COPIES)]
            for name, csrc in vers.items():
                use(csrc)
                c.check_train_case(f"{name} {key} {list(shape)}", *copies[0],
                                   True, scale)
            for name in order:
                use(vers[name])
                calls = c.timed_calls(copies, scale)
                for kn in kernels:
                    kernel = calls[kn][0]
                    # any route's symbol: another tree may route elsewhere
                    stem = f"{kn}_"
                    ms = c.time_ms(kernel, n=20)
                    pm, seen = c.profiled_ms(kernel, stem)
                    print(f"ab {name} {kn} {key} {list(shape)} causal "
                          f"({stem}*): events {ms:.4f} ms, "
                          f"{c.profiled_text(pm, seen)}")
                del calls
            if not args.only:
                use(vers["cur"])
                calls = c.timed_calls(copies, scale)
                print(f"sdpa {key} {list(shape)} causal: forward "
                      f"{c.time_ms(calls['flash_fwd'][2], n=20):.4f} ms, "
                      f"whole backward "
                      f"{c.time_ms(calls['flash_bwd_dkv'][2], n=20):.4f} "
                      f"ms")
                del calls
            del copies
            torch.cuda.empty_cache()
    print(c.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
