"""Collective cost model parameterized by mesh-axis topology.

The reference's closed forms (autoflow/solver.py:49-56) assume one flat
device count; on H100s each mesh axis has its own interconnect — NVLink
within a host, InfiniBand across hosts — so costs here are seconds on the
wire: bytes-transferred(collective, axis size) / axis bandwidth, plus a
launch latency.  The solver only compares costs, but real bandwidths make a
hybrid NVLink x InfiniBand mesh put the heavy collectives on NVLink.
"""

from __future__ import annotations

from dataclasses import dataclass

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.metashard.metair import Placement


@dataclass
class MeshAxisSpec:
    """One axis of the device mesh as the solver sees it.

    bandwidth/latency keep their sentinel until READ (resolved_*): meshes
    are usually built before a calibration run updates the config, so
    latching config values at construction would silently discard measured
    constants."""

    name: str
    size: int
    bandwidth: float = 0.0  # bytes/s; 0 -> per-kind config value at use
    kind: str = "nvlink"  # "nvlink" (within a host) | "ib" (across hosts)
    latency: float = -1.0  # seconds/launch; <0 -> per-kind config at use

    def __post_init__(self):
        if self.kind not in ("nvlink", "ib"):
            raise ValueError(f"mesh axis kind must be 'nvlink' or 'ib', "
                             f"got {self.kind!r}")

    def resolved_bandwidth(self) -> float:
        if self.bandwidth > 0.0:
            return self.bandwidth
        return (edconfig.ib_bandwidth if self.kind == "ib"
                else edconfig.nvlink_bandwidth)

    def resolved_latency(self) -> float:
        if self.latency >= 0.0:
            return self.latency
        return (edconfig.ib_latency if self.kind == "ib"
                else edconfig.nvlink_latency)


def _all_gather(x: float, n: int) -> float:
    return x * (n - 1) / n


def _all_reduce(x: float, n: int) -> float:
    return 2 * x * (n - 1) / n


def _reduce_scatter(x: float, n: int) -> float:
    return x * (n - 1) / n


def _all_to_all(x: float, n: int) -> float:
    factor = edconfig.all_to_all_punish_factor if n > 2 else 1.0
    return factor * x * (n - 1) / (n * n)


def overlap_ratio_is_measured() -> bool:
    """True when a runtime-measured overlap fraction is available for this
    backend (`comm_overlap_ratio_measured` was set by a calibration run)."""
    return edconfig.comm_overlap_ratio_measured is not None


def overlap_discount_ratio() -> float:
    """The comm/compute overlap fraction the solver may discount
    reduction-edge costs by, resolved per `comm_overlap_ratio_source`:

      "auto"      the MEASURED fraction when one exists for this backend,
                  else the configured `comm_overlap_ratio` guess;
      "measured"  only a measured fraction — 0.0 (discount off) until a
                  calibration run has recorded one, so an uncalibrated
                  compile never trades real bytes for imagined overlap;
      "config"    always the configured `comm_overlap_ratio` (the
                  reference's flat-guess behavior).
    """
    source = (edconfig.comm_overlap_ratio_source or "auto").lower()
    measured = edconfig.comm_overlap_ratio_measured
    if source == "config":
        ratio = edconfig.comm_overlap_ratio
    elif source == "measured":
        ratio = measured if measured is not None else 0.0
    else:  # "auto"
        ratio = measured if measured is not None \
            else edconfig.comm_overlap_ratio
    return float(min(max(ratio, 0.0), 1.0))


def quantize_compute_cost(var_bytes: float) -> float:
    """Seconds of quantize/dequantize compute a compressed reduction pays:
    block-amax + scale + round + dequant is a handful of memory-bound
    passes over the buffer — priced as 4 HBM round-trips."""
    return 4.0 * var_bytes / edconfig.hbm_bandwidth


def reduction_wire(kind: str, var_bytes: float, n: int,
                   itemsize: int = 4) -> tuple:
    """(wire bytes a rank sends, quantized) for a reduction edge ("all_reduce"
    for P -> R, "reduce_scatter" for P -> S) of a sum, as the emitted fence
    sends it (`comm.reduce.fence_plan`): under `comm_quant_dtype` the value
    is quantized when `comm.quant.leaf_quantizable("", numel)` passes (size
    alone decides, the JAX fence's rule), and then moves the int8 or bf16
    wire bytes; otherwise the exact ring bytes."""
    from easydist_tpu_torch.comm.quant import leaf_quantizable, quant_mode
    from easydist_tpu_torch.comm.reduce import wire_bytes

    mode = quant_mode()
    numel = int(var_bytes // itemsize)
    quantized = leaf_quantizable("", numel, mode)
    return wire_bytes(kind, numel, itemsize, n, mode, quantized), quantized


def _sums(p: Placement) -> bool:
    from easydist_tpu_torch.metashard.combination import Reduction

    return p.reduction in (Reduction.SUM, Reduction.AVG)


def edge_wire_bytes(up: Placement, down: Placement, var_bytes: float,
                    n: int, itemsize: int = 4, punish: bool = False) -> float:
    """Wire bytes a rank sends for the up -> down edge of one value: the
    ring closed forms, a sum's reduction edges as `reduction_wire`.
    `punish` scales an all_to_all by `all_to_all_punish_factor` (the
    solver's price; the bytes themselves are without it)."""
    if n <= 1 or up is None or down is None:
        return 0.0
    if up.is_shard():
        if down.is_shard():
            if up.dim == down.dim:
                return 0.0
            return (_all_to_all(var_bytes, n) if punish
                    else var_bytes * (n - 1) / (n * n))
        return _all_gather(var_bytes, n)
    if up.is_partial() and not down.is_partial():
        kind = "reduce_scatter" if down.is_shard() else "all_reduce"
        if _sums(up):
            return reduction_wire(kind, var_bytes, n, itemsize)[0]
        return (_reduce_scatter if down.is_shard() else _all_reduce)(
            var_bytes, n)
    return 0.0


def resharding_cost(var_bytes: float, up: Placement, down: Placement,
                    axis: MeshAxisSpec, itemsize: int = 4) -> float:
    """Seconds to reshard one tensor from `up` to `down` along `axis`.

    `up` is what the producer emits, `down` what the consumer needs.
    Replicate -> anything is free (slicing is local); the collective cases
    mirror reference solver.py:58-72 plus the reduce_scatter case it lacks.

    Under `comm_quant_dtype` a sum's reduction edges (P -> R all_reduce,
    P -> S reduce_scatter) are priced as the emitted fence sends them:
    the compressed wire bytes plus the quantize passes whenever the fence
    quantizes (`reduction_wire`), so the ILP's price and the bytes the
    emitted program moves agree edge by edge.
    """
    n = axis.size
    if n <= 1:
        return 0.0
    bytes_wire = edge_wire_bytes(up, down, var_bytes, n, itemsize,
                                 punish=True)
    if bytes_wire == 0.0:
        return 0.0
    # alpha-beta model: a collective pays a fixed launch/synchronization
    # latency on top of wire time.  Without the alpha term, sharding a tiny
    # bias is bytes-equal to replicating it (reduce_scatter + all_gather ==
    # all_reduce) and the memory tie-break scatters small params across the
    # mesh, emitting dozens of sub-KB collectives that cost pure latency.
    cost = axis.resolved_latency() + bytes_wire / axis.resolved_bandwidth()
    if up.is_partial() and not down.is_partial() and _sums(up) \
            and reduction_wire("all_reduce", var_bytes, n, itemsize)[1]:
        cost += quantize_compute_cost(var_bytes)
    return cost


def collective_wire_bytes(kind: str, var_bytes: float, n: int) -> float:
    """Wire bytes of one collective family over `n` participants — the
    closed forms above, keyed by the kind labels a `reshard` plan's
    ChunkOps carry.  "local"/"slice" move nothing; unknown kinds price
    as a full point-to-point copy (pessimistic, never free)."""
    if n <= 1 or kind in ("local", "slice"):
        return 0.0
    if kind == "all_gather":
        return _all_gather(var_bytes, n)
    if kind == "all_reduce":
        return _all_reduce(var_bytes, n)
    if kind == "reduce_scatter":
        return _reduce_scatter(var_bytes, n)
    if kind == "all_to_all":
        return _all_to_all(var_bytes, n)
    return var_bytes


def redistribution_cost(wire_bytes: float, n_chunks: int,
                        axis: MeshAxisSpec) -> float:
    """Alpha-beta seconds of a chunked redistribution plan along `axis`:
    every chunk that moves bytes pays one collective launch latency on
    top of its share of the wire time (the same model `resharding_cost`
    applies to solver edges — a reshard plan is just N of those edges,
    so the solver and the elastic path price redistribution with one
    vocabulary)."""
    if wire_bytes <= 0.0:
        return 0.0
    return (max(1, n_chunks) * axis.resolved_latency()
            + wire_bytes / axis.resolved_bandwidth())


def placement_bytes(var_bytes: float, p: Placement, axis_size: int) -> float:
    """Per-device bytes held for a tensor under placement `p`."""
    if p is not None and p.is_shard():
        return var_bytes / axis_size
    return var_bytes
