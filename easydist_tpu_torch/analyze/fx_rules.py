"""Layer 2: collective-program linter over emitted FX programs and comm
plans (the port of easydist_tpu/analyze/jaxpr_rules.py).

Works on the program that actually ships: a rank's `make_fx`
GraphModule as `fxfront.emit` writes it (functional collectives,
`torch.ops._c10d_functional.*`, on the DeviceMesh's groups; the comm
layer's quantized and bf16 fences and the ring / Ulysses attention
programs as helper calls that carry their own collectives), plus the
bucketer's packing plans.  Rules:

  COLL001  every collective names a process group of the mesh;
  COLL002  the ranks of every group post the same sequence of
           collectives (kind, reduce op, element count, dtype).  A
           `make_fx` graph has no `cond`: the port's deadlock shape is
           two rank programs that disagree, since a collective one
           member posts and another does not hangs the group
           (`lint_rank_programs`);
  COLL003  a bucket plan's slices tile the flat buffer exactly: every
           leaf in exactly one bucket, no overlap/gap, byte counts
           consistent, dtypes uniform per bucket;
  COLL004  a reducing collective (all_reduce, reduce_scatter) never sees
           an int8/uint8 operand — the quantized scheme moves int8 by
           all_to_all / all_gather and sums in f32 after dequantizing;
  COLL005  (a collective inside a `while` predicate) has no counterpart:
           `make_fx` unrolls every loop, so the graph holds no `while`.
           The rule stays in the catalog and this lint emits none.

Operand dtypes and element counts come from `node.meta["val"]`;
`lint_fn` traces with `make_fx`, which fills them, and an emitted rank
program is sized with fake tensors first (`fake_propagate`).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .findings import Finding, make_finding

# functional collectives that do arithmetic on the wire (int8 operands
# overflow)
_REDUCING = frozenset(("all_reduce", "all_reduce_",
                       "reduce_scatter_tensor", "all_reduce_coalesced",
                       "reduce_scatter_tensor_coalesced"))
# functional collectives that carry data without reducing
_MOVING = frozenset(("all_gather_into_tensor", "all_gather_into_tensor_out",
                     "all_to_all_single", "broadcast", "broadcast_",
                     "all_gather_into_tensor_coalesced", "permute_tensor"))

# collective-bearing helpers the emitter and the comm layer call, by
# (module suffix, name) -> index of their process-group argument
_HELPERS = {
    ("comm.quant", "quantized_psum"): 1,
    ("comm.quant", "quantized_psum_scatter"): 1,
    ("comm.quant", "bf16_psum"): 1,
    ("comm.quant", "bf16_psum_scatter"): 1,
    ("parallel.ring_attention", "ring_attention_local"): -5,
    ("parallel.ring_attention", "ring_attention_local_vjp"): -5,
    ("parallel.ulysses", "ulysses_attention_local"): -4,
    ("parallel.ulysses", "ulysses_attention_local_vjp"): -4,
}

_INT8 = (torch.int8, torch.uint8)


def _functional_name(target) -> Optional[str]:
    """The op name of a functional collective target, else None."""
    if isinstance(target, torch._ops.OpOverload) \
            and target.namespace == "_c10d_functional":
        name = target._schema.name.split("::")[-1]
        return name if name in _REDUCING or name in _MOVING else None
    return None


def _helper_key(target):
    mod = getattr(target, "__module__", "") or ""
    name = getattr(target, "__name__", None)
    for (suffix, fn), idx in _HELPERS.items():
        if name == fn and mod.endswith(suffix):
            return fn, idx
    return None


def _val(x):
    if isinstance(x, torch.fx.Node):
        return x.meta.get("val")
    return x if isinstance(x, torch.Tensor) else None


def collective_of(node) -> Optional[dict]:
    """{kind, reducing, op, group, numel, dtype} of a collective node (a
    functional collective or a collective-bearing helper), else None.
    `numel` / `dtype` are those of its first tensor operand, None where
    the node carries no `meta["val"]` there."""
    if node.op != "call_function":
        return None
    name = _functional_name(node.target)
    if name is not None:
        group = node.kwargs.get("group_name")
        if group is None:
            strs = [a for a in node.args if isinstance(a, str)]
            group = strs[-1] if strs else None
        op = None
        if name in _REDUCING:
            op = node.args[1] if len(node.args) > 1 else \
                node.kwargs.get("reduce_op")
        reducing = name in _REDUCING
    else:
        helper = _helper_key(node.target)
        if helper is None:
            return None
        name, idx = helper
        group = node.kwargs.get("group")
        if group is None and len(node.args) > abs(idx):
            group = node.args[idx]
        op, reducing = None, False
    first = node.args[0] if node.args else None
    val = _val(first)
    return {"kind": name, "reducing": reducing, "op": op,
            "group": group if isinstance(group, str) else None,
            "numel": int(val.numel()) if isinstance(val, torch.Tensor)
            else None,
            "dtype": val.dtype if isinstance(val, torch.Tensor) else None}


def mesh_groups(mesh) -> Dict[str, str]:
    """{process-group name: axis name} of a DeviceMesh (or of a plain
    {group name: axis} mapping)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
    return {mesh.get_group(i).group_name: str(names[i])
            for i in range(mesh.ndim)}


def lint_program(gm, mesh=None, node: str = "program") -> List[Finding]:
    """COLL001 and COLL004 over one rank program (`gm` a GraphModule or
    an fx Graph) against `mesh` (a DeviceMesh or a {group name: axis}
    mapping; None checks no group names, as for a one-device program,
    which has no mesh to name)."""
    graph = getattr(gm, "graph", gm)
    groups = mesh_groups(mesh)
    findings: List[Finding] = []
    for idx, n in enumerate(graph.nodes):
        c = collective_of(n)
        if c is None:
            continue
        loc = f"{node}:node{idx}:{c['kind']}"
        if mesh is not None and c["group"] not in groups:
            findings.append(make_finding(
                "COLL001", loc,
                f"collective {c['kind']!r} names process group "
                f"{c['group']!r}; the mesh has "
                f"{sorted(groups.values()) or 'no axes'}"))
        if c["reducing"] and c["dtype"] in _INT8:
            findings.append(make_finding(
                "COLL004", loc,
                f"{c['kind']!r} accumulates an {c['dtype']} operand on the "
                f"wire — quantized reductions must dequantize to f32 "
                f"before summing (two-pass scale)"))
    return findings


def collective_sequence(gm) -> List[Tuple]:
    """Ordered (kind, reduce op, element count, dtype, group) of every
    collective in a rank program: what must agree across a group's
    members."""
    graph = getattr(gm, "graph", gm)
    out = []
    for n in graph.nodes:
        c = collective_of(n)
        if c is not None:
            out.append((c["kind"], c["op"], c["numel"],
                        str(c["dtype"]) if c["dtype"] is not None else None,
                        c["group"]))
    return out


def lint_rank_programs(programs: Dict[tuple, object], mesh,
                       node: str = "programs") -> List[Finding]:
    """COLL002 over every rank's program (`programs`: {mesh coordinates:
    GraphModule}; `mesh` a DeviceMesh or {group name: axis} in mesh
    order).  For each group of the mesh (the ranks that share every
    coordinate but one axis's), its members must post the same sequence
    of that group's collectives: a member that posts another kind, op,
    element count or dtype, or one collective more or fewer, leaves the
    others waiting."""
    groups = mesh_groups(mesh)
    axis_group = {ax: g for g, ax in groups.items()}
    axes = list(groups.values())
    seqs = {c: collective_sequence(p) for c, p in programs.items()}
    findings: List[Finding] = []
    for a, ax in enumerate(axes):
        gname = axis_group.get(ax)
        members: Dict[tuple, List[tuple]] = {}
        for coords in sorted(seqs):
            rest = tuple(coords[:a]) + tuple(coords[a + 1:])
            members.setdefault(rest, []).append(coords)
        for rest, ranks in members.items():
            per = {c: [s[:4] for s in seqs[c] if s[4] == gname]
                   for c in ranks}
            first = per[ranks[0]]
            for c in ranks[1:]:
                if per[c] == first:
                    continue
                at = next((i for i, (x, y) in enumerate(zip(first, per[c]))
                           if x != y), min(len(first), len(per[c])))
                findings.append(make_finding(
                    "COLL002", f"{node}[{ax}]",
                    f"ranks {list(ranks[0])} and {list(c)} of axis {ax!r} "
                    f"post different collective programs ({len(first)} vs "
                    f"{len(per[c])} collectives, first difference at #{at}: "
                    f"{first[at] if at < len(first) else 'none'} vs "
                    f"{per[c][at] if at < len(per[c]) else 'none'}) — the "
                    f"group deadlocks"))
    return findings


def collective_program(gm):
    """A copy of the program `gm` cut to its collectives and the nodes
    they read (and any in-place op): what layer 2 lints, without the
    rest of the program (a train step's optimizer update, say) to size.
    Placeholders stay, so it takes `gm`'s inputs."""
    graph = torch.fx.Graph()
    env: dict = {}
    graph.graph_copy(gm.graph, env)
    keep = [env[n] for n in gm.graph.nodes if collective_of(n) is not None]
    graph.output(tuple(keep))
    graph.eliminate_dead_code()
    return torch.fx.GraphModule(gm, graph)


def fake_propagate(gm, fakes: Sequence) -> None:
    """Fill `meta["val"]` of every node of `gm` by running it on fake
    tensors (`fakes`: fake or meta-shaped inputs in placeholder order)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.passes.fake_tensor_prop import FakeTensorProp

    mode = None
    for f in fakes:
        mode = getattr(f, "fake_mode", None)
        if mode is not None:
            break
    FakeTensorProp(gm, mode or FakeTensorMode(allow_non_fake_inputs=True)) \
        .propagate_dont_convert_inputs(*fakes)


def lint_compiled(result, node: str = "emitted-program"
                  ) -> Tuple[List[Finding], Dict[str, float]]:
    """Layer 2 over a `CompileResult`.  On one device, COLL004 over the
    traced program.  On a mesh, every rank's program
    (`result.program_for(coords)` for every coordinate), cut to its
    collectives and what they read (`collective_program`) and sized with
    fake tensors at the rank's shapes: COLL001/COLL004 over each, and
    COLL002 across them.  Returns (findings, stats) with
    the lint's seconds, the number of rank programs compared and the
    collectives of rank 0's."""
    import itertools

    t0 = time.perf_counter()
    stats = {"rank_programs": 0.0}
    if result.in_placements is None:  # one device: the traced program
        findings = lint_program(result.graph_module, None, node=node)
    else:
        mesh = dict(zip(result.group_names(),
                        (s.name for s in result.axis_specs)))
        fakes = result.rank_fakes()
        programs = {}
        findings = []
        sizes = [s.size for s in result.axis_specs]
        for coords in itertools.product(*(range(n) for n in sizes)):
            gm = collective_program(result.program_for(list(coords))[0])
            fake_propagate(gm, fakes)
            programs[tuple(coords)] = gm
            findings.extend(lint_program(
                gm, mesh, node=f"{node}{list(coords)}"))
        findings.extend(lint_rank_programs(programs, mesh,
                                           node=f"{node}:ranks"))
        stats["rank_programs"] = float(len(programs))
        stats["collectives"] = float(len(collective_sequence(
            programs[(0,) * len(sizes)])))
    stats["seconds"] = time.perf_counter() - t0
    return findings, stats


def lint_fn(fn, *example_args, mesh=None, **example_kwargs
            ) -> List[Finding]:
    """Trace `fn` with `make_fx` (fake tensors) and lint the result — the
    entry point for the dp / zero / pipeline paths, whose programs exist
    only as callables."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(lambda *a: fn(*a, **example_kwargs),
                 tracing_mode="fake")(*example_args)
    return lint_program(gm, mesh)


# --------------------------------------------------------------- bucket lint

def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.size) * leaf.dtype.itemsize


def lint_bucket_plan(leaves: Sequence, buckets: Iterable) -> List[Finding]:
    """COLL003: verify a `comm.bucketer` plan tiles the flat leaf set
    exactly.  `leaves` are the tensors handed to `plan_buckets`; `buckets`
    the resulting plan.  Checks (one finding per violation kind/site):

      * every leaf index in range and in exactly one bucket (a duplicate
        is an overlapping slice; missing indices are a gap);
      * each bucket's `nbytes` equals the sum of its leaves' bytes (an
        off-by-one slice shows up here);
      * one dtype per bucket (pack/unpack are cast-free by contract).
    """
    findings: List[Finding] = []
    seen: Dict[int, int] = {}
    for b_idx, b in enumerate(buckets):
        loc = f"bucket{b_idx}"
        nbytes = 0
        dtypes = set()
        for i in b.indices:
            if i < 0 or i >= len(leaves):
                findings.append(make_finding(
                    "COLL003", loc,
                    f"leaf index {i} out of range (have {len(leaves)} "
                    f"leaves)"))
                continue
            if i in seen:
                findings.append(make_finding(
                    "COLL003", loc,
                    f"leaf {i} already packed by bucket{seen[i]} — "
                    f"overlapping slices"))
            else:
                seen[i] = b_idx
            leaf = leaves[i]
            nbytes += _nbytes(leaf)
            dtypes.add(str(leaf.dtype).replace("torch.", ""))
        if len(dtypes) > 1:
            findings.append(make_finding(
                "COLL003", loc,
                f"mixed dtypes {sorted(dtypes)} in one bucket (packing "
                f"must be cast-free)"))
        if nbytes != b.nbytes:
            findings.append(make_finding(
                "COLL003", loc,
                f"bucket claims {b.nbytes} bytes but its leaves hold "
                f"{nbytes} — slice offsets will not tile the flat buffer"))
    missing = [i for i in range(len(leaves)) if i not in seen]
    if missing:
        findings.append(make_finding(
            "COLL003", "plan",
            f"{len(missing)} leaf/leaves never packed (gap): indices "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}"))
    return findings
