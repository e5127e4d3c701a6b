"""Build and load the port's CUDA kernels.

Each source under `csrc/` has a plain C interface (it may include the
`*.cuh` headers beside it).  It is compiled with
`nvcc` for `sm_90a` into a shared library and loaded with `ctypes` —
no PyTorch headers, so a build takes seconds.  Libraries go to `_build/`
beside this file (listed in `.gitignore`), named by the hash of the
source and flags, so an edited source rebuilds at its next first use.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# `-Xptxas -v` reports registers, shared memory and spills per kernel; the
# report is kept beside the library (`<lib>.log`)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """`nvcc` from PATH, else from CUDA_HOME, else the toolkit's default
    install prefix.  Raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def build(name: str, csrc: Path = None) -> Path:
    """Compile `<csrc>/<name>.cu` (`csrc` defaults to `CSRC`) unless a
    library for this exact source, the headers beside it and the flag set
    exists; return the library's path."""
    csrc = CSRC if csrc is None else csrc
    src = csrc / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
