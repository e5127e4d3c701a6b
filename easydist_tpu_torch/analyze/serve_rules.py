"""Layer 5: serving auditor (the port of
easydist_tpu/analyze/serve_rules.py).  Where the JAX package donates a
cache so XLA updates it in place, the port's programs write it in place
themselves; "donated" becomes "written in place".

SERVE001 — the decode step's in-place cache lint.  The economics of
token-level serving rest on the cache being updated in place: a decode
step's cost is one row write plus attention reads.  Each paired cache
output of the compiled step must be its input's own storage (the traced
program returns the placeholder it wrote, or an in-place op on it);
otherwise `fxfront.api`'s state copy writes the whole cache back every
round — correct, silent and slow.

SERVE002 — the chunked-prefill contract lint: (a) the staging cache is
written in place by every chunk call (warning: slow, not wrong); (b) the
chunk program's attention over the full bucket window is LENGTH-MASKED —
a `where` / `masked_fill` whose mask derives from a comparison with an
`arange` ancestor — because staging rows carry restored prefixes, stale
tails and idle-row garbage, and only the mask keeps them out of live
logits (error); (c) the prefix trie's refcount / byte accounting stays
consistent (`audit_prefix_cache`).

SERVE003 — the speculative-rewind contract lint, three arms: (a) the
verify program writes its cache in place and length-masks attention to
`key_pos <= query_pos`; (b) the host accept walk never commits past the
first draft/target mismatch; (c) a paged rollback leaves no table row
pointing at a released spill page (KV001's page-table audit, re-tagged).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .findings import SEV_WARNING, Finding, make_finding

_aten = torch.ops.aten


def _children(spec):
    kids = getattr(spec, "children", None)
    if callable(kids):
        try:
            return list(kids())
        except TypeError:
            pass
    return list(spec.children_specs)


def _arg_leaf_ranges(in_spec) -> List[tuple]:
    """[(start, stop)) flat-leaf index ranges of each positional arg in a
    CompileResult's input spec (structured ((args...), {kwargs}))."""
    ranges = []
    base = 0
    for child in _children(_children(in_spec)[0]):
        n = child.num_leaves
        ranges.append((base, base + n))
        base += n
    return ranges


def _mutated_base(n):
    """The node an in-place op (one whose schema writes its first
    argument, as `index_put_`, `copy_`) wrote and returned, else None."""
    if n.op != "call_function" or not isinstance(
            n.target, torch._ops.OpOverload):
        return None
    args = n.target._schema.arguments
    if args and args[0].alias_info is not None \
            and args[0].alias_info.is_write:
        return n.args[0]
    return None


def in_place_outputs(program, state_pairs) -> dict:
    """{flat output index: bool} over `state_pairs` ({out: in}): True when
    the program returns input `in`'s own placeholder there (directly or
    through an in-place op on it)."""
    graph = getattr(program, "graph", program)
    places = [n for n in graph.nodes if n.op == "placeholder"]
    out = next(n for n in graph.nodes if n.op == "output")
    from torch.utils import _pytree as pytree

    leaves = pytree.tree_leaves(out.args[0])
    res = {}
    for o, i in state_pairs.items():
        node = leaves[o] if o < len(leaves) else None
        while isinstance(node, torch.fx.Node):
            base = _mutated_base(node)
            if base is None:
                break
            node = base
        res[o] = (isinstance(node, torch.fx.Node) and i < len(places)
                  and node is places[i])
    return res


def _in_place_findings(result, cache_arg: int, node: str, rule_id: str,
                       what: str, severity=None) -> List[Finding]:
    """Shared walk for SERVE001-003: every flat leaf of positional arg
    `cache_arg` must be paired with an output the program writes in
    place."""
    ranges = _arg_leaf_ranges(result.in_spec)
    if cache_arg >= len(ranges):
        return [make_finding(
            rule_id, node,
            f"cache arg index {cache_arg} out of range: the compiled "
            f"step has {len(ranges)} positional args", severity=severity)]
    start, stop = ranges[cache_arg]
    by_input = {i: o for o, i in result.state_pairs.items()}
    program = result.graph_module
    written = in_place_outputs(program, result.state_pairs) \
        if getattr(result, "donate_state", True) else {}
    missing = [i for i in range(start, stop)
               if i not in by_input or not written.get(by_input[i])]
    if not missing:
        return []
    return [make_finding(
        rule_id, node,
        f"{len(missing)}/{stop - start} cache leaves (flat input indices "
        f"{missing[:8]}{'...' if len(missing) > 8 else ''}) are not "
        f"written in place; {what}", severity=severity)]


def audit_decode_donation(result, cache_arg: int = 0,
                          node: str = "decode") -> List[Finding]:
    """SERVE001: every flat leaf of positional arg `cache_arg` of a
    compiled step (a `CompileResult`) is written in place.  One finding
    for the step; [] when the whole cache is."""
    return _in_place_findings(
        result, cache_arg, node, "SERVE001",
        "the step copies the full KV cache back every round "
        "(donate_state off, the cache not threaded as paired state, or a "
        "model that returns a new cache)")


_COMPARE = {_aten.le.Tensor, _aten.le.Scalar, _aten.lt.Tensor,
            _aten.lt.Scalar, _aten.ge.Tensor, _aten.ge.Scalar,
            _aten.gt.Tensor, _aten.gt.Scalar, _aten.eq.Tensor,
            _aten.eq.Scalar, _aten.ne.Tensor, _aten.ne.Scalar}
# (op, index of its mask argument)
_SELECTS = {_aten.where.self: 0, _aten.where.ScalarSelf: 0,
            _aten.where.ScalarOther: 0, _aten.where.Scalar: 0,
            _aten.masked_fill.Scalar: 1, _aten.masked_fill.Tensor: 1,
            _aten.masked_fill_.Scalar: 1, _aten.masked_fill_.Tensor: 1}


def _is_arange(n) -> bool:
    return isinstance(n.target, torch._ops.OpOverload) and \
        n.target.overloadpacket is _aten.arange


def has_masked_select(program, max_depth: int = 24) -> bool:
    """True iff some `where` / `masked_fill` mask derives (within
    `max_depth` producer hops) from a comparison with an `arange`
    ancestor — the `where(key_pos <= query_pos, scores, -inf)` shape the
    chunked-prefill and verify attention must carry."""
    graph = getattr(program, "graph", program)
    for n in graph.nodes:
        if n.op != "call_function" or n.target not in _SELECTS:
            continue
        mask = n.args[_SELECTS[n.target]]
        if not isinstance(mask, torch.fx.Node):
            continue
        seen, stack = set(), [(mask, max_depth)]
        compare = arange = False
        while stack:
            v, d = stack.pop()
            if d <= 0 or v in seen or v.op != "call_function":
                continue
            seen.add(v)
            compare |= v.target in _COMPARE
            arange |= _is_arange(v)
            stack.extend((a, d - 1) for a in v.all_input_nodes)
        if compare and arange:
            return True
    return False


def audit_chunked_prefill(result, cache_arg: int = 0,
                          node: str = "prefill_chunk") -> List[Finding]:
    """SERVE002 over a compiled chunked-prefill step: (a) the staging
    cache (positional arg `cache_arg`) is written in place — warning,
    slow not wrong; (b) the program carries a length-masked select over
    an arange-derived comparison — error, because an unmasked full-window
    attention lets restored-prefix tails, recycled-row garbage and
    idle-row writes leak into live rows' logits."""
    findings = _in_place_findings(
        result, cache_arg, node, "SERVE002",
        "every prefill chunk copies the whole staging cache back",
        severity=SEV_WARNING)
    if not has_masked_select(result.graph_module):
        findings.append(make_finding(
            "SERVE002", node,
            "no length-masked select found in the chunked-prefill "
            "program: the attention window over the staging cache is not "
            "masked to `key_pos <= query_pos`, so stale rows (restored "
            "prefix tails, recycled staging rows, idle-row garbage) can "
            "leak into live logits"))
    return findings


def audit_speculative_rewind(result=None, *, cache_arg: int = 0,
                             node: str = "verify",
                             draft=None, target=None,
                             n_accepted: Optional[int] = None,
                             pool=None, table=None,
                             trie=None) -> List[Finding]:
    """SERVE003 over whichever speculative artifact is supplied (the
    three arms compose — pass any subset):

    * `result` (a compiled verify step): the cache / arena (positional arg
      `cache_arg`) is written in place (warning) and the program carries
      a length-masked select over an arange-derived comparison (error —
      without `key_pos <= query_pos`, the rows the step writes above the
      committed positions leak into the logits that decide acceptance).
    * `draft` / `target` / `n_accepted` (one slot's accept walk):
      `n_accepted` must not exceed the longest matching prefix of draft
      and target.
    * `pool` / `table` (a paged layout after rollback): the KV001
      page-table / refcount audit, re-tagged SERVE003.
    """
    findings: List[Finding] = []
    if result is not None:
        findings.extend(_in_place_findings(
            result, cache_arg, node, "SERVE003",
            "every verify step copies the whole KV cache back",
            severity=SEV_WARNING))
        if not has_masked_select(result.graph_module):
            findings.append(make_finding(
                "SERVE003", node,
                "no length-masked select found in the verify program: "
                "attention is not masked to `key_pos <= query_pos`, so "
                "the speculative rows the step writes above the "
                "committed positions (including rejected drafts) leak "
                "into the logits that decide acceptance"))
    if draft is not None and target is not None and n_accepted is not None:
        match = 0
        for d, t in zip(draft, target):
            if int(d) != int(t):
                break
            match += 1
        if n_accepted > match:
            findings.append(make_finding(
                "SERVE003", node,
                f"accepted-prefix bookkeeping advanced past the first "
                f"draft/target mismatch: n_accepted={n_accepted} but "
                f"draft {list(map(int, draft))} matches target "
                f"{list(map(int, target))[:len(list(draft))]} only "
                f"through index {match} — the committed stream diverges "
                f"from plain greedy"))
    if pool is not None and table is not None:
        from .kv_rules import audit_page_table

        findings.extend(
            make_finding("SERVE003", node,
                         f"paged rollback left inconsistent "
                         f"page-table/refcount state: {f.message}")
            for f in audit_page_table(pool, table, trie=trie, node=node))
    return findings


def audit_prefix_cache(trie, node: str = "prefix_cache") -> List[Finding]:
    """SERVE002 over a live `serve.prefix_cache.PrefixCache`: one error
    finding per refcount / byte-accounting invariant violation."""
    return [make_finding("SERVE002", node, problem)
            for problem in trie.check_invariants()]
