"""Native (C++) helpers of the solver and the memory planner, built at
first use.

`csrc/beam.cpp` (the beam-search core) and `csrc/memplan.cpp` (skyline
packing, lifetime-overlap check, live-bytes peak) have a plain C
interface.  At first use they are compiled with `g++` into one shared
library under `_build/` beside this file (listed in `.gitignore`), named
by the hash of the sources and flags, and bound with `ctypes`.  Nothing is
built when the module is imported.  Every function has a Python version
(`*_py`, the same algorithm), used when no compiler is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[Path]:
    """Compile the sources unless a library for these exact sources and
    flags exists; the library's path, or None when there is no compiler
    or the build fails."""
    srcs = sorted(_SRC.glob("*.cpp"))
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in srcs)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libed_native-{digest}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        logger.warning("no g++ on PATH; using the Python versions")
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, srcs)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        logger.warning("native build failed (%s); using the Python "
                       "versions", e)
        return None
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        so = _build()
        if so is not None:
            lib = ctypes.CDLL(str(so))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.ed_skyline_plan.restype = ctypes.c_int64
            lib.ed_skyline_plan.argtypes = [ctypes.c_int64, i64p, i64p, i64p,
                                            i64p]
            lib.ed_check_plan.restype = ctypes.c_int64
            lib.ed_check_plan.argtypes = [ctypes.c_int64, i64p, i64p, i64p,
                                          i64p, ctypes.c_int64, i64p]
            lib.ed_peak_live.restype = ctypes.c_int64
            lib.ed_peak_live.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
            lib.ed_beam_search.restype = ctypes.c_double
            lib.ed_beam_search.argtypes = [
                ctypes.c_int64, i64p, f64p, i64p, ctypes.c_int64, i64p, i64p,
                f64p, i64p, ctypes.c_int64, i32p]
            _LIB = lib
    return _LIB


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def available() -> bool:
    return get_lib() is not None


# ----------------------------------------------------------- memory planner

def skyline_plan(starts: Sequence[int], ends: Sequence[int],
                 sizes: Sequence[int]) -> Tuple[np.ndarray, int]:
    """Assign non-overlapping offsets to buffers live over [start, end];
    returns (offsets, peak_bytes)."""
    n = len(starts)
    lib = get_lib()
    if lib is None or not n:
        return skyline_plan_py(starts, ends, sizes)
    s, e, z = _i64(starts), _i64(ends), _i64(sizes)
    offsets = np.zeros(n, dtype=np.int64)
    peak = lib.ed_skyline_plan(n, _ptr(s, ctypes.c_int64),
                               _ptr(e, ctypes.c_int64),
                               _ptr(z, ctypes.c_int64),
                               _ptr(offsets, ctypes.c_int64))
    return offsets, int(peak)


def skyline_plan_py(starts, ends, sizes) -> Tuple[np.ndarray, int]:
    """`skyline_plan` in Python: the identical greedy best-fit."""
    n = len(starts)
    s, e, z = _i64(starts), _i64(ends), _i64(sizes)
    offsets = np.zeros(n, dtype=np.int64)
    order = sorted(range(n), key=lambda i: (-z[i], s[i]))
    placed: List[Tuple[int, int, int, int]] = []
    peak = 0
    for i in order:
        blocked = sorted((off, off + size) for (bs, be, off, size) in placed
                         if bs <= e[i] and s[i] <= be)
        off = 0
        for lo, hi in blocked:
            if off + z[i] <= lo:
                break
            if off < hi:
                off = hi
        placed.append((int(s[i]), int(e[i]), off, int(z[i])))
        offsets[i] = off
        peak = max(peak, off + int(z[i]))
    return offsets, int(peak)


def check_plan(starts, ends, sizes, offsets, max_report: int = 16):
    """Verify lifetime/address disjointness; returns list of violating index
    pairs (empty = valid)."""
    lib = get_lib()
    if lib is None:
        return check_plan_py(starts, ends, sizes, offsets)
    n = len(starts)
    s, e, z, o = _i64(starts), _i64(ends), _i64(sizes), _i64(offsets)
    report = np.zeros(2 * max_report, dtype=np.int64)
    count = lib.ed_check_plan(n, _ptr(s, ctypes.c_int64),
                              _ptr(e, ctypes.c_int64),
                              _ptr(z, ctypes.c_int64),
                              _ptr(o, ctypes.c_int64),
                              max_report, _ptr(report, ctypes.c_int64))
    return [(int(report[2 * i]), int(report[2 * i + 1]))
            for i in range(min(count, max_report))]


def check_plan_py(starts, ends, sizes, offsets):
    """`check_plan` in Python: every violating pair."""
    n = len(starts)
    s, e, z, o = _i64(starts), _i64(ends), _i64(sizes), _i64(offsets)
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            if s[i] <= e[j] and s[j] <= e[i] and \
                    o[i] < o[j] + z[j] and o[j] < o[i] + z[i]:
                out.append((i, j))
    return out


def live_profile(starts, ends, sizes) -> np.ndarray:
    """Sum-of-live-sizes per schedule step (length max(ends)+1) — the full
    curve behind `peak_live`."""
    n = len(starts)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    s, e, z = _i64(starts), _i64(ends), _i64(sizes)
    max_t = int(e.max())
    delta = np.zeros(max_t + 2, dtype=np.int64)
    np.add.at(delta, s, z)
    np.add.at(delta, e + 1, -z)
    return np.cumsum(delta[:-1])


def peak_live(starts, ends, sizes) -> int:
    """Sum-of-live-sizes peak — the allocator-independent lower bound."""
    n = len(starts)
    lib = get_lib()
    if lib is None or n == 0:
        return peak_live_py(starts, ends, sizes)
    s, e, z = _i64(starts), _i64(ends), _i64(sizes)
    return int(lib.ed_peak_live(n, _ptr(s, ctypes.c_int64),
                                _ptr(e, ctypes.c_int64),
                                _ptr(z, ctypes.c_int64)))


def peak_live_py(starts, ends, sizes) -> int:
    """`peak_live` in Python."""
    prof = live_profile(starts, ends, sizes)
    return int(prof.max()) if prof.size else 0


# ------------------------------------------------------------- beam search

def beam_search_native(strat_count, y_cost_list, edges, beam_width: int):
    """Run the C++ beam core.

    strat_count: [n_clusters]; y_cost_list: list of per-cluster cost arrays;
    edges: list of (up, down, cost_matrix[up_s, down_s]).
    Returns (assign array, cost) or None when the native lib is missing.
    The Python version of the same beam is `SpmdSolver.beam_search`'s loop.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(strat_count)
    sc = _i64(strat_count)
    y_off = np.zeros(n, dtype=np.int64)
    total = 0
    for i, c in enumerate(strat_count):
        y_off[i] = total
        total += int(c)
    y_cost = np.zeros(total, dtype=np.float64)
    for i, costs in enumerate(y_cost_list):
        y_cost[y_off[i]:y_off[i] + len(costs)] = costs

    n_e = len(edges)
    up = _i64([e[0] for e in edges])
    down = _i64([e[1] for e in edges])
    e_off = np.zeros(max(n_e, 1), dtype=np.int64)
    tot = 0
    mats = []
    for i, (u, d, m) in enumerate(edges):
        e_off[i] = tot
        m = np.ascontiguousarray(m, dtype=np.float64)
        mats.append(m.ravel())
        tot += m.size
    edge_cost = np.concatenate(mats) if mats else np.zeros(1)

    assign = np.zeros(n, dtype=np.int32)
    cost = lib.ed_beam_search(
        n, _ptr(sc, ctypes.c_int64), _ptr(y_cost, ctypes.c_double),
        _ptr(y_off, ctypes.c_int64), n_e, _ptr(up, ctypes.c_int64),
        _ptr(down, ctypes.c_int64), _ptr(edge_cost, ctypes.c_double),
        _ptr(e_off, ctypes.c_int64), beam_width,
        _ptr(assign, ctypes.c_int32))
    return assign, float(cost)
