#!/usr/bin/env python3
"""Compare versions of the port's attention kernels on one card, in one
process: the training kernels (B1 forward, B2 dQ, B3 dK/dV) at causal
shapes, and the paged decode kernels (B5 exact pages, B6 int8 pages) at a
grouped-query decode shape.

Each version is a copy of `easydist_tpu_torch/ops/csrc/`: the package's
own sources ("cur"), another tree's (`--tree NAME=DIR`, e.g. a
`git archive` of another commit unpacked under `_archive/`, whose
`easydist_tpu_torch/ops/csrc` is taken), or the package's sources with
literal edits (`--edit NAME:FILE:OLD=>NEW`, applied to a copy, several
per version).  Every version is built by `nvcc` from its own sources
(`ops/_build`, libraries named by the sources' hash, so they coexist),
one `nvcc` a (version, source) in parallel, and what spills is printed
(`chip_smoke.py` fails on any spill; this script only reports it);
`--sass LIB:REGEX` prints, for every function of LIB
whose name matches REGEX, whether its SASS (`cuobjdump -sass`) equals
"cur"'s.

B1-B3 (`--shape`, `--kernels fwd,dq,dkv`): each version is checked
against the plain PyTorch versions at each shape
(`chip_smoke.check_train_case`: phase 3's bars), then timed in turns,
forward and back (v1, v2, ..., v2, v1), by CUDA events and by the
profiler's device time a launch, beside one SDPA call (its causal
forward, and its whole backward for B2 and B3).

B5 / B6 (`--kernels b5,b6`, `--paged HEADS,KV_HEADS,D`, default
Llama-3-8B's 32,8,128 over `chip_smoke.LLAMA_PAGED_SHAPE`'s pages, every
row at the table's full length, 4 rotated copies): each version is held
against the plain version on phase 3's inputs (lengths of a mixed batch,
f32 atol 1e-5, bf16 plus 2^-8 |ref|; a version other than "cur" that
fails is flagged and still timed, so an edit may take a part of the
kernel out to time the rest), then timed in turns by events and
by the profiler, beside the plain version, SDPA with `enable_gqa` on the
gathered (and, for B6, dequantized) cache, and two bounds: the unique KV
bytes (each KV head's rows once) and the bytes a block per query head
reads (each KV head's rows once per query head).  A tree without the
grouped route (no `decode_group.cuh`) is driven with the split body's
chunk (`_split_tokens`), as its own wrapper did.  Numbers are printed
with the card's name and power limit.

    python3 scripts/kernel_ab.py --shape 2,32,2048,80 --dtype f32 \\
        --tree parent=_archive/parent \\
        --edit "1wg:flash_attn_fwd.cu:kWG = DP < 128 ?=>kWG = DP == 64 ?"
    python3 scripts/kernel_ab.py --kernels b5,b6 --dtype bf16 --dtype f32 \\
        --tree parent=_archive/parent \\
        --sass "paged_decode:paged_decode(_quant)?_kernel"
    python3 scripts/kernel_ab.py --kernels b5,b6 --dtype bf16 \\
        --paged 12,12,64 --route g1=group \\
        --edit "g1:decode_group.cuh:if (group < 2)=>if (group < 1)"

Needs a card; from the repository root.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from easydist_tpu_torch.ops import _build  # noqa: E402
from easydist_tpu_torch.ops import flash_attention as fa  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
KERNELS = {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
           "dkv": "flash_bwd_dkv", "b5": "paged_decode",
           "b6": "paged_decode_quant"}
TRAIN = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_PAGED_ROUTE = fa._paged_route
PAGED_LIBS = ("paged_decode", "paged_decode_group", "paged_decode_quant_group")


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


def use(csrc: Path, route=None):
    """Load the kernels from `csrc`; the paged wrappers take `route`
    ("split" or "group") at every ratio, or by heads / kv_heads where it
    is None, and the split body everywhere in a tree without the grouped
    route (no decode_group.cuh), as that tree's own wrapper did."""
    _build.CSRC = csrc
    _build._LOADED.clear()
    if not (csrc / "decode_group.cuh").exists():
        route = "split"
    fa._paged_route = _PAGED_ROUTE if route is None else (
        lambda heads, kv_heads: route)


def sass(lib: Path) -> dict:
    """{function: SASS instructions without addresses or encodings} of a
    built library."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # the anonymous namespace's name carries the source's hash
            fn = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                        "ANON", m.group(1))
            out[fn] = []
        elif fn is not None:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "",
                         line).strip()
            if ins:
                out[fn].append(ins)
    return out


def build_all(vers: dict, libs, sass_specs) -> None:
    """Build `libs` for every version that has their source (no spill
    allowed); compare the SASS of `sass_specs` [(lib, regex)] against
    "cur"."""
    jobs = [(name, lib) for name, csrc in vers.items() for lib in libs
            if (csrc / f"{lib}.cu").exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:  # one nvcc a (version, source)
        paths = list(pool.map(lambda job: _build.build(job[1],
                                                       vers[job[0]]), jobs))
    built = dict(zip(jobs, paths))
    for name, csrc in vers.items():
        spills = {}
        for (n, lib), path in built.items():
            if n == name:
                spills.update(c.ptxas_spills(path.with_suffix(".log")
                                             .read_text()))
        print(f"{name}: {csrc} built, spills {spills or 'none'}")
    print(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")
    for lib, pattern in sass_specs:
        cur = sass(built["cur", lib])
        for name in vers:
            if name == "cur":
                continue
            if (name, lib) not in built:
                continue
            other = sass(built[name, lib])
            fns = sorted(f for f in set(cur) | set(other)
                         if re.search(pattern, f))
            same = [f for f in fns if cur.get(f) == other.get(f)]
            print(f"sass {lib} cur vs {name} /{pattern}/: {len(same)} of "
                  f"{len(fns)} functions identical")
            for f in fns:
                if f not in same:
                    what = ("only in cur" if f not in other else
                            f"only in {name}" if f not in cur else
                            f"DIFFERS ({len(cur[f])} vs {len(other[f])} "
                            f"instructions)")
                    print(f"  {f[:120]}: {what}")


def train_ab(args, vers, dev, kernels) -> None:
    order = list(vers) + list(vers)[::-1]
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


def paged_ab(args, vers, dev, kernels) -> None:
    """B5 / B6 at `--paged`'s heads over pages of LLAMA_PAGED_SHAPE."""
    import torch.nn.functional as F

    routes = dict(r.split("=", 1) for r in args.route)
    h, kvh, d = (int(x) for x in args.paged.split(","))
    b, _, pt, _, mp, n_pages = c.LLAMA_PAGED_SHAPE
    shape = (b, h, pt, d, mp, n_pages)
    scale = 1.0 / np.sqrt(d)
    lens = [mp * pt] * b
    order = list(vers) + list(vers)[::-1]
    rs = np.random.RandomState(7)
    counters = c.decode_counters()
    before = {name: k.launches for name, k in counters.items()}
    # phase 3's inputs of a mixed batch for the checks
    q32, kp, vp, table, L = c.paged_inputs(dev, rs, h, kvh, d,
                                           lengths=c.LLAMA_LENGTHS,
                                           shape=shape)
    kq, ks = fa.kv_quantize(kp, 1)
    vq, vs = fa.kv_quantize(vp, 1)
    for key in args.dtype:
        dtype = DTYPES[key]
        itemsize = torch.finfo(dtype).bits // 8
        q, k, v = q32.to(dtype), kp.to(dtype), vp.to(dtype)
        for name, csrc in vers.items():
            use(csrc, routes.get(name))
            for kn in kernels:
                if kn == "paged_decode":
                    out = fa.flash_paged_decode_attention(q, k, v, table, L)
                    ref = fa._paged_decode_attention_xla(
                        q.float(), k.float(), v.float(), table, L, scale)
                else:
                    out = fa.flash_paged_decode_quant_attention(
                        q, kq, vq, ks, vs, table, L)
                    ref = fa._paged_decode_attention_quant_xla(
                        q.float(), kq, vq, ks, vs, table, L, scale)
                torch.cuda.synchronize()
                ref[L == 0] = 0.0
                try:
                    c.check_close(f"{name} {kn} {h}/{kvh} d {d} {key}", out,
                                  ref, 0.0, 1e-5, dtype == torch.bfloat16)
                except AssertionError as e:
                    if name == "cur":
                        raise
                    # an edit that takes part of the kernel out, to time
                    # what is left: timed, flagged
                    print(f"{name} {kn} {key}: FAILS its check ({e})")
        copies = []
        for _ in range(c.TIMED_COPIES):
            qc, kc, vc, tc, Lc = c.paged_inputs(dev, rs, h, kvh, d,
                                                lengths=lens, shape=shape,
                                                dead=())
            kqc, ksc = fa.kv_quantize(kc, 1)
            vqc, vsc = fa.kv_quantize(vc, 1)
            qc, kc, vc = (x.to(dtype) for x in (qc, kc, vc))
            gathered = [fa.gather_pages(x, tc).contiguous() for x in (kc, vc)]
            dequant = [fa.kv_dequantize(fa.gather_pages(x, tc),
                                        fa.gather_pages(sc, tc),
                                        dtype).contiguous()
                       for x, sc in ((kqc, ksc), (vqc, vsc))]
            copies.append((qc, kc, vc, tc, Lc, kqc, ksc, vqc, vsc, gathered,
                           dequant))

        def at(fn):
            return lambda i: fn(copies[i % c.TIMED_COPIES])

        calls = {
            "paged_decode": (
                at(lambda x: fa.flash_paged_decode_attention(*x[:5])),
                at(lambda x: fa._paged_decode_attention_xla(*x[:5], scale)),
                at(lambda x: F.scaled_dot_product_attention(
                    x[0][:, :, None], *x[9], enable_gqa=True)),
                "quant", itemsize),
            "paged_decode_quant": (
                at(lambda x: fa.flash_paged_decode_quant_attention(
                    x[0], x[5], x[7], x[6], x[8], x[3], x[4])),
                at(lambda x: fa._paged_decode_attention_quant_xla(
                    x[0], x[5], x[7], x[6], x[8], x[3], x[4], scale)),
                at(lambda x: F.scaled_dot_product_attention(
                    x[0][:, :, None], *x[10], enable_gqa=True)),
                None, 1 + 4 / d),
        }
        for name in order:
            use(vers[name], routes.get(name))
            for kn in kernels:
                kernel, _, _, exclude, _ = calls[kn]
                ms = c.time_ms(kernel, n=50)
                pm, seen = c.profiled_ms(kernel, kn, exclude=exclude)
                print(f"ab {name} {kn} {h}/{kvh} d {d} {key} {list(shape)} "
                      f"lengths {mp * pt}: events {ms:.4f} ms, "
                      f"{c.profiled_text(pm, seen)}")
        if not args.only:
            use(vers["cur"], routes.get("cur"))
            for kn in kernels:
                _, plain, library, _, kv_size = calls[kn]
                plain_ms = c.time_ms(plain, n=10)
                lib_ms = c.time_ms(library, n=50)
                lib_text = c.call_text(*c.profiled_call_ms(library))
                bound, bound_by = c.paged_bound_ms(lens, shape, h, kvh, d,
                                                   kv_size, itemsize)
                read, read_by = c.paged_bound_ms(lens, shape, h, h, d,
                                                 kv_size, itemsize)
                print(f"ref {kn} {h}/{kvh} d {d} {key}: plain {plain_ms:.4f} "
                      f"ms, SDPA enable_gqa on the gathered cache events "
                      f"{lib_ms:.4f} ms ({lib_text}), "
                      f"bound {bound:.4f} ms ({bound_by}, unique KV bytes), "
                      f"{read:.4f} ms ({read_by}, each KV head's rows once "
                      f"per query head)")
        del copies, calls
        torch.cuda.empty_cache()
    for name, k in counters.items():
        k.launches = before[name]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--edit", action="append", default=[])
    ap.add_argument("--shape", action="append", default=[],
                    help="b,h,t,d (causal) of B1-B3; repeat for more shapes")
    ap.add_argument("--paged", default="32,8,128",
                    help="heads,kv_heads,head_dim of B5 / B6")
    ap.add_argument("--dtype", action="append", choices=sorted(DTYPES),
                    required=True)
    ap.add_argument("--kernels", default="fwd,dq,dkv")
    ap.add_argument("--sass", action="append", default=[],
                    help="LIB:REGEX, functions whose SASS is compared")
    ap.add_argument("--route", action="append", default=[],
                    help="NAME=split|group: the paged wrappers' route at "
                         "every ratio for version NAME (group at G = 1 "
                         "with an --edit of decode_group.cuh's "
                         "`if (group < 2)`)")
    ap.add_argument("--only", action="store_true",
                    help="time the versions only (no SDPA, no plain)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(c.card_line())
    kernels = [KERNELS[k] for k in args.kernels.split(",")]
    train = [k for k in kernels if k in TRAIN]
    paged = [k for k in kernels if k not in TRAIN]
    if train and not args.shape:
        raise SystemExit("B1-B3 need --shape")
    sass_specs = [tuple(s.split(":", 1)) for s in args.sass]
    libs = sorted(({"flash_attn_fwd", "flash_attn_bwd"} if train else set())
                  | (set(PAGED_LIBS) if paged else set())
                  | {lib for lib, _ in sass_specs})
    vers = versions(args, ROOT / "_archive" / "kernel_ab")
    build_all(vers, libs, sass_specs)
    if train:
        train_ab(args, vers, dev, train)
    if paged:
        paged_ab(args, vers, dev, paged)
    use(vers["cur"])
    print(c.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
