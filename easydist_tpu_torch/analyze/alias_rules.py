"""Layer 11: the donation/aliasing sanitizer (the port of
easydist_tpu/analyze/alias_rules.py).  Where the JAX package donates a
buffer so XLA updates it in place, the port's programs write paired
state in place themselves (`fxfront.api`), so a "donated" input is a
paired input its program writes.

ALIAS001 — a stale alias.  Two forms: (a) over a traced program
    (`audit_program_aliases`): a view of a paired input taken before an
    in-place write to that input and read after it — the reader sees the
    write it was not ordered after, the counterpart of reading a donated
    buffer after its dispatch; (b) the `ast` host-code lint
    (`lint_host_donation`): a retained Python reference to a donated
    argument loaded after the donating call without an intervening
    rebind.  The rebind idiom — `pool.cache, tok = self._decode_c(
    pool.cache, ...)` — is the clean shape.

ALIAS002 — double pairing: one input paired with two outputs (two state
    writes land in one storage, the second clobbers the first), or one
    storage passed through two paired input positions
    (`audit_donation_pairs`, with the call's inputs when given).

ALIAS003 — a pair whose input and output differ in shape or dtype, so
    the state write `copy_` would broadcast or cast silently
    (`audit_donation_pairs`).

ALIAS004 — a paired device buffer still reachable from a live host
    reference across a step boundary (`audit_host_aliases`, by storage
    overlap): a prefix-trie node must hold a copy (bucketed layout) or a
    page reference (paged layout), never the cache, staging or arena
    the next step writes.

The AST lint reasons per function scope and in source-line order (no
interprocedural or loop-carried dataflow): the donation convention is
strictly local — compiled callables named `*_c` (or bound from
`easydist_compile(...)`) donate positional arg 0 — so a scope-local
"donate, then load without rebind" walk catches the bug class without
drowning the driver's baseline in speculative flow analysis.
`protocol_rules` reuses `_expr_key`; the driver's `ast` target runs
`lint_file_donation` on every file.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from .findings import Finding, make_finding

# a callee is "donating" when its terminal name matches this (the
# session's compiled-callable convention: _decode_c, _prefill_chunk_c,
# _paged_c("decode")(...), ...) or when it is a name bound from
# easydist_compile(...) in the same scope
_DONATING_NAME_RE = re.compile(r"^_[a-z0-9_]*_c$")
_COMPILE_FACTORIES = {"easydist_compile", "compile_step"}


def _callee_name(func_node) -> Optional[str]:
    if isinstance(func_node, ast.Attribute):
        return func_node.attr
    if isinstance(func_node, ast.Name):
        return func_node.id
    return None


def _expr_key(node) -> Optional[str]:
    """Stable identity of a Name/Attribute-chain expression (`buf`,
    `pool.cache`, `self.pool.staging`); None for anything else — only
    plain reference chains participate in the retained-reference walk."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_key(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


class _ScopeLint(ast.NodeVisitor):
    """One function scope's donate/store/load event streams, in source
    order.  Nested defs get their own scope (their bodies are skipped
    here and visited separately)."""

    def __init__(self):
        self.donates: List[Tuple[int, int, str]] = []  # (line, end, expr)
        self.stores: Dict[str, List[int]] = {}         # expr -> lines
        self.loads: Dict[str, List[Tuple[int, str]]] = {}
        self.compiled_names: set = set()

    # a nested def is its own scope (collected and visited separately);
    # class bodies stay in the enclosing stream so class-level wiring
    # still participates
    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        # x = easydist_compile(...) binds a donating callable
        if isinstance(node.value, ast.Call):
            name = _callee_name(node.value.func)
            if name in _COMPILE_FACTORIES:
                for tgt in node.targets:
                    key = _expr_key(tgt)
                    if key:
                        self.compiled_names.add(key)
        self.generic_visit(node)

    def _is_donating_call(self, call: ast.Call) -> bool:
        name = _callee_name(call.func)
        if name is not None:
            return (_DONATING_NAME_RE.match(name) is not None
                    or _expr_key(call.func) in self.compiled_names
                    or name in self.compiled_names)
        if isinstance(call.func, ast.Call):
            # self._paged_c("decode")(arena, ...): the factory matched,
            # the returned callable donates
            inner = _callee_name(call.func.func)
            return (inner is not None
                    and _DONATING_NAME_RE.match(inner) is not None)
        return False

    def visit_Call(self, call):
        if self._is_donating_call(call) and call.args:
            key = _expr_key(call.args[0])
            if key is not None:
                end = getattr(call, "end_lineno", None) or call.lineno
                self.donates.append((call.lineno, end, key))
        self.generic_visit(call)

    def visit_Name(self, node):
        self._record(node, node.lineno)

    def visit_Attribute(self, node):
        key = _expr_key(node)
        if key is not None:
            self._record_key(node, key, node.lineno)
            return  # the chain is one event, not one per attribute hop
        self.generic_visit(node)

    def _record(self, node, line):
        key = _expr_key(node)
        if key is not None:
            self._record_key(node, key, line)

    def _record_key(self, node, key, line):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.stores.setdefault(key, []).append(line)
        else:
            self.loads.setdefault(key, []).append((line, key))


def _scope_findings(scope: _ScopeLint, path: str,
                    node_label: str) -> List[Finding]:
    findings: List[Finding] = []
    for don_line, don_end, key in scope.donates:
        # the donation is live until the first rebind at or after the
        # donating statement (same-line rebind = the clean idiom); loads
        # inside the donating call's own line span ARE the call's
        # arguments, not stale reads
        rebinds = [ln for ln in scope.stores.get(key, ())
                   if ln >= don_line]
        first_rebind = min(rebinds) if rebinds else None
        stale = [ln for ln, _ in scope.loads.get(key, ())
                 if ln > don_end
                 and (first_rebind is None or ln < first_rebind)]
        if stale:
            line = min(stale)
            findings.append(make_finding(
                "ALIAS001", node_label,
                f"`{key}` is read after being donated on line "
                f"{don_line} with no intervening rebind — on donating "
                f"backends that storage is already invalid",
                path=path, line=line))
    return findings


def lint_file_donation(path: str, rel: Optional[str] = None,
                       source: Optional[str] = None) -> List[Finding]:
    """AST ALIAS001 host lint over one Python file.  Returns [] for
    unparsable files (the lint must never be the thing that fails)."""
    rel = rel or path
    if source is None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
        except OSError:
            return []
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError:
        return []
    findings: List[Finding] = []
    # module scope + every function scope, each analyzed independently
    scopes: List[Tuple[ast.AST, str]] = [(tree, "<module>")]
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append((n, n.name))
    for scope_node, label in scopes:
        lint = _ScopeLint()
        for stmt in scope_node.body:
            lint.visit(stmt)
        findings.extend(_scope_findings(lint, rel, f"{rel}:{label}"))
    return findings


def lint_host_donation(root: str,
                       subdirs: Iterable[str] = ("easydist_tpu_torch",
                                                 "examples/torch"),
                       ) -> List[Finding]:
    """The ALIAS001 host lint over every .py file beneath
    `root/<subdir>` (repo-relative paths on the findings, so baselines
    travel)."""
    findings: List[Finding] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root)
                findings.extend(lint_file_donation(full, rel=rel))
    return findings


# --------------------------------------------------------- program pass


def _write_target(n):
    """The tensor node an in-place op writes (its first argument, where
    its schema marks it written), else None."""
    import torch

    if n.op != "call_function" or not isinstance(
            n.target, torch._ops.OpOverload):
        return None
    args = n.target._schema.arguments
    if args and args[0].alias_info is not None \
            and args[0].alias_info.is_write:
        return n.args[0] if isinstance(n.args[0], torch.fx.Node) else None
    return None


def _view_base(n):
    """The node a view op (an output aliasing its first argument without
    writing it: select, slice, view, transpose, ...) aliases, else None."""
    import torch

    if n.op != "call_function" or not isinstance(
            n.target, torch._ops.OpOverload):
        return None
    rets = n.target._schema.returns
    if rets and rets[0].alias_info is not None \
            and not rets[0].alias_info.is_write \
            and isinstance(n.args[0], torch.fx.Node):
        return n.args[0]
    return None


def _chain(n, root):
    """[n, its base, ..., root] through view ops; None when `n` is no
    view of `root`."""
    out = [n]
    while out[-1] is not root:
        base = _view_base(out[-1])
        if base is None:
            return None
        out.append(base)
    return out


def _disjoint(chain_a, chain_b) -> bool:
    """Two views of one root are disjoint when their first steps below
    the root select different indices of one dim."""
    import torch

    a, b = chain_a[-2] if len(chain_a) > 1 else None, \
        chain_b[-2] if len(chain_b) > 1 else None
    if a is None or b is None:
        return False
    sel = torch.ops.aten.select.int
    if a.target is sel and b.target is sel:
        return a.args[1] == b.args[1] and a.args[2] != b.args[2]
    return False


def audit_program_aliases(program, state_pairs: Dict[int, int],
                          node: str = "program") -> List[Finding]:
    """ALIAS001 over one traced program (a GraphModule or fx Graph) whose
    paired inputs are `state_pairs.values()` (flat placeholder indices):
    a view V of a paired input taken before an in-place write W to that
    input (through another alias, or the input itself) and read after W.
    Writes through V itself, and views that provably cover disjoint
    slices (different indices of one `select` dim), are clean.  One
    finding per (view, write)."""
    graph = getattr(program, "graph", program)
    nodes = list(graph.nodes)
    pos = {n: k for k, n in enumerate(nodes)}
    places = [n for n in nodes if n.op == "placeholder"]
    root_of = {}
    for n in nodes:
        base = _view_base(n)
        root_of[n] = n if base is None else root_of.get(base, base)
    paired = {places[i]: i for i in set(state_pairs.values())
              if i < len(places)}
    views: Dict[object, list] = {}
    for n in nodes:
        r = root_of[n]
        if r in paired and n is not r:
            views.setdefault(r, []).append((n, _chain(n, r)))
    findings: List[Finding] = []
    for w in nodes:
        tgt = _write_target(w)
        root = root_of.get(tgt)
        if root not in paired:
            continue
        w_chain = _chain(tgt, root)
        for v, v_chain in views.get(root, ()):
            if pos[v] >= pos[w] or v in w_chain \
                    or _disjoint(v_chain, w_chain):
                continue
            late = [u for u in v.users if pos[u] > pos[w]
                    and _write_target(u) is not v]
            if late:
                findings.append(make_finding(
                    "ALIAS001", node,
                    f"view {v.name} of paired input {root.name} (flat "
                    f"input {paired[root]}) is taken before the in-place "
                    f"write {w.name} ({w.target}) and read after it by "
                    f"{late[0].name}: the read sees the write it was not "
                    f"ordered after"))
    return findings


def _sig(v):
    import torch

    return ((tuple(v.shape), str(v.dtype)) if isinstance(v, torch.Tensor)
            else None)


def _storage(t):
    try:
        return t.untyped_storage().data_ptr()
    except Exception:  # a tensor without storage (fake, meta)
        return None


def audit_donation_pairs(result, inputs=None,
                         node: str = "state-io") -> List[Finding]:
    """ALIAS002/003 over a CompileResult's state pairing (`state_pairs`:
    flat output index -> flat input index), for a result that writes its
    state in place (`donate_state`):

    * ALIAS002 — two outputs claim one input; or, given the call's flat
      `inputs`, one storage passed through two paired input positions;
    * ALIAS003 — a pair whose input and output shape or dtype differ, or
      whose indices fall outside the signature."""
    from torch.utils import _pytree as pytree

    pairs: Dict[int, int] = dict(getattr(result, "state_pairs", None) or {})
    if not pairs or not getattr(result, "donate_state", True):
        return []
    findings: List[Finding] = []
    by_input: Dict[int, List[int]] = {}
    for out_idx, in_idx in pairs.items():
        by_input.setdefault(in_idx, []).append(out_idx)
    for in_idx, outs in sorted(by_input.items()):
        if len(outs) > 1:
            findings.append(make_finding(
                "ALIAS002", node,
                f"outputs {sorted(outs)} all claim paired input {in_idx}: "
                f"both state writes land in one storage and the second "
                f"clobbers the first"))
    if inputs is not None:
        owner: Dict[int, int] = {}
        for in_idx in sorted(by_input):
            x = inputs[in_idx] if in_idx < len(inputs) else None
            ptr = _storage(x) if hasattr(x, "untyped_storage") else None
            if ptr is None:
                continue
            if ptr in owner:
                findings.append(make_finding(
                    "ALIAS002", node,
                    f"paired inputs {owner[ptr]} and {in_idx} share one "
                    f"storage: each state write clobbers the other"))
            else:
                owner[ptr] = in_idx
    graph = result.traced.graph
    in_vals = [n.meta.get("val") for n in graph.nodes
               if n.op == "placeholder"]
    out = next(n for n in graph.nodes if n.op == "output")
    out_vals = [a.meta.get("val") if hasattr(a, "meta") else a
                for a in pytree.tree_leaves(out.args[0])]
    for out_idx, in_idx in sorted(pairs.items()):
        if in_idx >= len(in_vals) or out_idx >= len(out_vals):
            findings.append(make_finding(
                "ALIAS003", node,
                f"state pair out[{out_idx}] <- in[{in_idx}] indexes "
                f"outside the signature ({len(out_vals)} outputs, "
                f"{len(in_vals)} inputs): the state can never be written "
                f"in place"))
            continue
        i_sig, o_sig = _sig(in_vals[in_idx]), _sig(out_vals[out_idx])
        if i_sig != o_sig:
            findings.append(make_finding(
                "ALIAS003", node,
                f"state pair out[{out_idx}] {o_sig} <- in[{in_idx}] "
                f"{i_sig}: shape/dtype mismatch, so the state write would "
                f"broadcast or cast silently"))
    return findings


def audit_host_aliases(donated, holders,
                       node: str = "session") -> List[Finding]:
    """ALIAS004: storage overlap between the buffers the next step writes
    in place and live host-held references.  `donated` maps a label
    ("cache", "staging", "arena") to a tree whose tensor leaves the next
    step writes; `holders` maps a holder label ("trie", "snapshot",
    "hot_pages") to a tree the host retains across the step boundary.  A
    holder leaf that shares storage with a donated leaf fires one
    aggregated finding per holder."""
    import torch
    from torch.utils import _pytree as pytree

    def tensors(tree):
        return [t for t in pytree.tree_leaves(tree)
                if isinstance(t, torch.Tensor)]

    donated_ptrs: Dict[int, str] = {}
    for label, tree in donated.items():
        for t in tensors(tree):
            ptr = _storage(t)
            if ptr:
                donated_ptrs.setdefault(ptr, label)
    if not donated_ptrs:
        return []
    findings: List[Finding] = []
    for holder, tree in holders.items():
        hit = sorted({donated_ptrs[p] for p in map(_storage, tensors(tree))
                      if p in donated_ptrs})
        if hit:
            findings.append(make_finding(
                "ALIAS004", node,
                f"host holder {holder!r} retains storage of the in-place "
                f"buffer(s) {hit} across the step boundary — the next "
                f"step overwrites what the host still reads (hold a copy "
                f"or a page reference, not the tensor)"))
    return findings
