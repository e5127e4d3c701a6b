"""Debug dumps: graphviz DOT of the MetaIR graph with solved placements
(the port of easydist_tpu/utils/dump.py without `dump_hlo`: the port
dumps each rank's emitted FX program code instead, `fxfront.api.
_dump_strategies`).

Reference analog: fx graph pdf/graphviz dumps (`DUMP_FX_GRAPH`,
torch/compile_auto.py:487-508) and per-pp-submodule `save_graphviz_dot`
(torch/experimental/pp/utils.py).  The artifact to reach for when a
100-layer plan goes sideways is the placement-annotated dataflow graph
(which op chose which sharding, where the reshards happen); it lands in
`edconfig.dump_dir`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def _fmt_strategy(per_axis: Sequence[Dict], axis_names, name: str) -> str:
    parts = []
    for ax, chosen in zip(axis_names, per_axis):
        s = chosen.get(name)
        if s is None:
            continue
        outs = ",".join(repr(p) for p in s.out_placements)
        parts.append(f"{ax}:{outs}")
    return " ".join(parts)


def _resharded_edges(graph, per_axis) -> set:
    """(producer_name, consumer_name) pairs whose placements differ on any
    axis — where a collective/reshape lands in the emitted program."""
    hot = set()
    for chosen in per_axis:
        for node in graph.ops:
            s = chosen.get(node.name)
            if s is None:
                continue
            for idx, v in enumerate(node.invars):
                if v is None or v.producer is None:
                    continue
                up = chosen.get(v.producer.name)
                if up is None:
                    continue
                p_up = up.out_placements[v.producer_idx] \
                    if v.producer_idx < len(up.out_placements) else None
                p_dn = s.in_placements[idx] \
                    if idx < len(s.in_placements) else None
                rep_up = p_up is None or p_up.is_replicate()
                rep_dn = p_dn is None or p_dn.is_replicate()
                if rep_up != rep_dn or (not rep_up and p_up != p_dn):
                    hot.add((v.producer.name, node.name))
    return hot


def metagraph_to_dot(graph, per_axis: Sequence[Dict], axis_names) -> str:
    """Graphviz DOT of the dataflow graph: one box per op annotated with
    its op_key and chosen out-placements per axis; edges that reshard
    (producer/consumer placement mismatch) are red and bold."""
    lines: List[str] = [
        "digraph metair {",
        "  rankdir=TB;",
        '  node [shape=box, fontname="monospace", fontsize=9];',
    ]
    hot = _resharded_edges(graph, per_axis)
    for node in list(graph.inputs) + list(graph.ops):
        strat = _fmt_strategy(per_axis, axis_names, node.name)
        shape = ""
        if node.outvars and node.outvars[0] is not None:
            shape = "x".join(str(d) for d in node.outvars[0].shape)
        label = f"{node.name}\\n{node.op_key} [{shape}]"
        if strat:
            label += f"\\n{strat}"
        color = ' style=filled fillcolor="lightyellow"' if node.is_input \
            else ""
        lines.append(f'  "{node.name}" [label="{label}"{color}];')
    for node in graph.ops:
        for v in node.invars:
            if v is None or v.producer is None:
                continue
            attr = ' [color=red, penwidth=2.0]' \
                if (v.producer.name, node.name) in hot else ""
            lines.append(f'  "{v.producer.name}" -> "{node.name}"{attr};')
    lines.append("}")
    return "\n".join(lines)
