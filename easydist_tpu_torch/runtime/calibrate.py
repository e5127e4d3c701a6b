"""Measured cost-model constants: the port of
easydist_tpu/runtime/calibrate.py.

`detect_device_constants` gives the card's datasheet `peak_flops` (dense
bf16 tensor cores) and `hbm_bandwidth`, keyed on
`torch.cuda.get_device_name()`; `apply_device_constants` writes them
into the config unless an env override names the knob; unknown kinds
(the CPU) change nothing.  `calibrate(group)` measures the memory rate
and an all_reduce's alpha (seconds a launch) and beta (bytes a second)
over a process group into the NVLink (or InfiniBand) constants;
`calibrate_overlap(group)` measures the overlap fraction the solver's
overlap discount reads.  Both persist in the PerfDB, and
`apply_calibration` (called by `easydist_compile` when
`auto_calibration` is set) loads them.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

from easydist_tpu_torch import config as edconfig

logger = logging.getLogger(__name__)

_CAL_KEY = "cost_model_calibration"
# None = unchecked, False = checked and absent, True = applied
_applied = None
# the same for the datasheet swap
_device_applied = None

# NVIDIA datasheet constants by device-name prefix (lowercased; first
# match wins, so the more specific prefixes come first): dense bf16
# tensor-core FLOP/s and HBM bytes/s
_DEVICE_DATASHEET = (
    ("nvidia h100 nvl", {"peak_flops": 835e12, "hbm_bandwidth": 3.9e12}),
    ("nvidia h100 pcie", {"peak_flops": 756e12, "hbm_bandwidth": 2.0e12}),
    ("nvidia h100", {"peak_flops": 989e12, "hbm_bandwidth": 3.35e12}),
    ("nvidia h200", {"peak_flops": 989e12, "hbm_bandwidth": 4.8e12}),
    ("nvidia a100-sxm4-80gb", {"peak_flops": 312e12,
                               "hbm_bandwidth": 2.039e12}),
    ("nvidia a100", {"peak_flops": 312e12, "hbm_bandwidth": 1.555e12}),
    ("nvidia l40s", {"peak_flops": 362e12, "hbm_bandwidth": 8.64e11}),
    ("nvidia l4", {"peak_flops": 121e12, "hbm_bandwidth": 3.0e11}),
)
_ENV = {"peak_flops": "EASYDIST_PEAK_FLOPS",
        "hbm_bandwidth": "EASYDIST_HBM_BANDWIDTH"}


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _backend_key() -> str:
    kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    return f"{kind}:{_world()}"


def detect_device_constants(device_kind: Optional[str] = None
                            ) -> Optional[Dict[str, float]]:
    """Datasheet constants for `device_kind` (default: the first card's
    name), or None for an unknown kind or no card."""
    if device_kind is None:
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    kind = str(device_kind).lower()
    for prefix, consts in _DEVICE_DATASHEET:
        if kind.startswith(prefix):
            return dict(consts)
    return None


def apply_device_constants(force: bool = False) -> bool:
    """Write the card's datasheet `peak_flops` / `hbm_bandwidth` into the
    config; an env override of a knob wins, unknown kinds change nothing.
    True when a value was applied."""
    global _device_applied
    if _device_applied is not None and not force:
        return _device_applied
    if not edconfig.auto_device_constants:
        _device_applied = False
        return False
    consts = detect_device_constants()
    applied = False
    for name, value in (consts or {}).items():
        if _ENV[name] in os.environ:
            continue
        setattr(edconfig, name, float(value))
        applied = True
    _device_applied = applied
    if applied:
        logger.info("device constants from the datasheet: %s", consts)
    return applied


def _persist_calibration(result: Dict[str, float]) -> None:
    """Merge `result` into this backend's PerfDB calibration entry."""
    from .perfdb import PerfDB

    db = PerfDB()
    entry = dict(db.get_op_perf(_CAL_KEY, _backend_key()) or {})
    entry.update(result)
    db.record_op_perf(_CAL_KEY, _backend_key(), entry)
    try:
        db.persist()
    except OSError:
        logger.warning("could not persist the calibration")


def calibrate(group=None, link: str = "nvlink", persist: bool = True,
              device=None, big_elems: int = 1 << 22,
              hbm_elems: int = 1 << 24) -> Dict[str, float]:
    """Measure and (optionally) persist cost-model constants: the memory
    rate of an elementwise op over `hbm_elems` f32 (`hbm_bandwidth`) and,
    over `group`
    when it has two or more ranks, an all_reduce's alpha (one element a
    rank) and beta (a `big_elems` f32 vector; all_reduce wire bytes
    2 * size * (n-1)/n) as `<link>_latency` / `<link>_bandwidth`.  Every
    rank of the group calls it."""
    from easydist_tpu_torch.comm.reduce import group_name

    from .profiler import two_point_time

    global _applied
    if link not in ("nvlink", "ib"):
        raise ValueError(f"link={link!r}; expected nvlink|ib")
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    n = hbm_elems
    x = torch.ones(n, dtype=torch.float32, device=device)
    t = two_point_time(lambda a: a * 1.000001, (x,), device=device)
    result = {"hbm_bandwidth": float(2 * 4 * n / t)}
    world = 1
    if group is not None:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        world = dist.get_world_size(_resolve_process_group(group_name(
            group)))
    if world > 1:
        c10d = torch.ops._c10d_functional
        name = group_name(group)

        def ar(v):
            return c10d.wait_tensor(c10d.all_reduce(v, "sum", name))

        big = torch.ones(big_elems, dtype=torch.float32, device=device)
        small = torch.ones(1, dtype=torch.float32, device=device)
        t_big = two_point_time(ar, (big,), device=device)
        alpha = two_point_time(ar, (small,), device=device)
        result[f"{link}_latency"] = float(alpha)
        if t_big > 1.25 * alpha:
            wire = 2 * 4 * big_elems * (world - 1) / world
            # a noisy denominator must not persist a near-free wire
            result[f"{link}_bandwidth"] = float(
                min(wire / (t_big - alpha), 1e13))
        else:
            logger.warning("collective timing is launch-bound (t_big "
                           "%.3es ~ alpha %.3es): keeping the configured "
                           "%s_bandwidth", t_big, alpha, link)
    if persist:
        _persist_calibration(result)
    for name, value in result.items():
        if value > 0:
            setattr(edconfig, name, value)
    _applied = True
    logger.info("calibration (%s): %s", _backend_key(), result)
    return result


def calibrate_overlap(group, persist: bool = True,
                      n_elems: int = 1 << 22, device=None
                      ) -> Dict[str, float]:
    """Measure the overlap fraction over `group`
    (`runtime.profiler.measure_collective_overlap`) and persist it as
    `comm_overlap_ratio_measured`, which the solver's overlap discount
    reads (`autoflow.cost_model.overlap_discount_ratio`)."""
    from .profiler import measure_collective_overlap

    global _applied
    measured = measure_collective_overlap(group, n_elems=n_elems,
                                          device=device)
    frac = measured["overlap_fraction"]
    result = {"comm_overlap_ratio_measured": float(frac),
              "overlap_t_comm": measured["t_comm"],
              "overlap_t_compute": measured["t_compute"],
              "overlap_t_both": measured["t_both"]}
    if persist:
        _persist_calibration(result)
    edconfig.comm_overlap_ratio_measured = float(frac)
    _applied = True
    return result


def apply_calibration(force: bool = False) -> bool:
    """Load this backend's stored calibration into the config (datasheet
    constants first, so a measured `hbm_bandwidth` still wins).  True
    when values were applied; the lookup is cached after the first."""
    global _applied
    apply_device_constants(force=force)
    if _applied is not None and not force:
        return _applied
    from .perfdb import PerfDB

    entry = PerfDB().get_op_perf(_CAL_KEY, _backend_key())
    if not entry:
        _applied = False
        return False
    for name in ("hbm_bandwidth", "nvlink_bandwidth", "nvlink_latency",
                 "ib_bandwidth", "ib_latency"):
        if entry.get(name, 0) > 0:
            setattr(edconfig, name, entry[name])
    if entry.get("comm_overlap_ratio_measured") is not None:
        # 0.0 is a valid measurement (nothing overlapped): keep it
        edconfig.comm_overlap_ratio_measured = float(
            entry["comm_overlap_ratio_measured"])
    _applied = True
    logger.info("applied cost-model calibration for %s", _backend_key())
    return True
