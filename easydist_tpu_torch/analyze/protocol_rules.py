"""Analyze layer 12c: host-code concurrency sanitizer (PROTO004/005);
the port of easydist_tpu/analyze/protocol_rules.py.

ROADMAP item 4 moves replicas out of this process; the day that lands,
every direct reach into another component's private state becomes a
data race (or simply impossible — the attribute lives across a wire).
The live protocols already publish observer-safe surfaces — the
router's `stats()` / `live_decode_snapshot()` / `inflight_count`, the
health monitor's `snapshot()`, `ServeMetrics.export()` — and the
Autoscaler's MetricsView consumes exactly those.  This lint enforces
that snapshot-only contract repo-wide, statically, the same way the
layer-11 AST lint enforces the donation discipline:

PROTO004 — a *read* of private fleet state through another object:
    `router._inflight`, `self.router._decode_replicas()`,
    `monitor._replicas`, ... from observer code.  `self._x` is the
    owning class touching its own state and never flags; the receiver
    must be a different object (`self.router._x` flags: the private
    segment is ONE HOP past the boundary).

PROTO005 — a *mutation* of a shared fleet structure from outside the
    owning class: assignment/del/augmented-assignment targeting such a
    chain, subscript stores through it, or a mutator-method call on it
    (`router._inflight.pop(...)`, `fleet._handoffs.append(...)`).
    Single-writer is the property the RouterSpec/TransportSpec
    exploration relies on; an outside writer invalidates the model.

The lint fires only on fleet-shaped reaches — the attribute is one of
the known shared structures, or the receiver's terminal name is fleet
vocabulary (`router`, `monitor`, `transport`, ...) — so private
attributes in unrelated subsystems (torch internals, trie nodes inside
their own module) stay out of scope.  Per-file entry point
`lint_file_concurrency` mirrors `alias_rules.lint_file_donation` and
rides the same driver cache/suppression/baseline machinery.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional

from .findings import Finding, make_finding
from .alias_rules import _expr_key

# the shared fleet structures the specs model — reaching these by name
# flags regardless of the receiver's spelling
_SHARED_FLEET_ATTRS = {
    "_inflight", "_handoffs", "_replicas", "_ring", "_prefill_ring",
    "_committed", "_next_request_id", "_decode_replicas",
    "_prefill_replicas", "_eligible", "_last_probe_t", "_rng",
}

# receivers whose private attributes are fleet state even when the
# attribute itself is not in the curated set (`self.router._anything`)
_FLEET_RECEIVERS = {
    "router", "fleet", "monitor", "health", "transport", "replica",
    "rep", "breaker",
}

# method names that mutate their receiver in place: a call through a
# private fleet chain is a write, not a read
_MUTATORS = {
    "append", "pop", "clear", "add", "remove", "update", "extend",
    "insert", "setdefault", "popitem", "discard",
}

_OWN_ROOTS = ("self", "cls")


def _is_private(attr: str) -> bool:
    return attr.startswith("_") and not attr.startswith("__")


def _receiver_terminal(key: str) -> str:
    return key.rsplit(".", 1)[-1]


def _is_fleet_reach(receiver_key: str, attr: str) -> bool:
    if attr in _SHARED_FLEET_ATTRS:
        return True
    return _receiver_terminal(receiver_key).lower() in _FLEET_RECEIVERS


class _ConcurrencyLint(ast.NodeVisitor):
    """Collect private cross-object fleet reaches with read/write
    classification.  Needs parent context for three shapes —
    `x._a.append(...)` (mutator call), `x._a[k] = v` (subscript store),
    `x._a += v` (augmented target) — so the visitor threads a small
    amount of ancestry instead of a full parent map."""

    def __init__(self, rel: str):
        self.rel = rel
        self.findings: List[Finding] = []
        self._reported: set = set()  # (line, key) — one finding per site

    # -- helpers ------------------------------------------------------
    def _flag(self, rule: str, node: ast.AST, chain: str, how: str):
        site = (node.lineno, chain, rule)
        if site in self._reported:
            return
        self._reported.add(site)
        if rule == "PROTO004":
            msg = (f"`{chain}` reads private fleet state across an "
                   f"object boundary ({how}) — observers must consume "
                   f"a snapshot surface (stats()/snapshot()/"
                   f"live_decode_snapshot()), not live structures that "
                   f"move out-of-process with ROADMAP item 4")
        else:
            msg = (f"`{chain}` mutates a shared fleet structure from "
                   f"outside its owning class ({how}) — single-writer "
                   f"is the invariant the layer-12 model checker "
                   f"verifies; route the change through the owner's "
                   f"methods")
        self.findings.append(make_finding(
            rule, f"{self.rel}:{node.lineno}", msg,
            path=self.rel, line=node.lineno))

    def _private_reach(self, node: ast.AST):
        """(attribute node, receiver key, full chain) when `node` is a
        private cross-object fleet reach; None otherwise."""
        if not isinstance(node, ast.Attribute) or not _is_private(node.attr):
            return None
        receiver = _expr_key(node.value)
        if receiver is None or receiver in _OWN_ROOTS:
            return None  # self._x / cls._x: the owner touching itself
        if not _is_fleet_reach(receiver, node.attr):
            return None
        return node, receiver, f"{receiver}.{node.attr}"

    # -- write shapes -------------------------------------------------
    def visit_Assign(self, node):
        for tgt in node.targets:
            self._visit_store_target(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node):
        self._visit_store_target(node.target)
        self.visit(node.value)

    def visit_Delete(self, node):
        for tgt in node.targets:
            self._visit_store_target(tgt)

    def _visit_store_target(self, tgt):
        hit = self._private_reach(tgt)
        if hit is not None:
            _n, _r, chain = hit
            self._flag("PROTO005", tgt, chain, "assignment target")
            return
        if isinstance(tgt, ast.Subscript):
            hit = self._private_reach(tgt.value)
            if hit is not None:
                _n, _r, chain = hit
                self._flag("PROTO005", tgt.value, chain,
                           "subscript store")
                return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._visit_store_target(el)
            return
        self.visit(tgt)

    def visit_Call(self, node):
        # x._shared.append(...): mutator through a private fleet chain
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            hit = self._private_reach(f.value)
            if hit is not None:
                _n, _r, chain = hit
                self._flag("PROTO005", f.value, chain,
                           f".{f.attr}() mutator call")
                for arg in node.args:
                    self.visit(arg)
                for kw in node.keywords:
                    self.visit(kw.value)
                return
        self.generic_visit(node)

    # -- read shape ---------------------------------------------------
    def visit_Attribute(self, node):
        hit = self._private_reach(node)
        if hit is not None:
            _n, _r, chain = hit
            self._flag("PROTO004", node, chain, "private-state read")
            return  # the chain is one event, not one per hop
        self.generic_visit(node)


def lint_file_concurrency(path: str, rel: Optional[str] = None,
                          source: Optional[str] = None) -> List[Finding]:
    """PROTO004/005 over one Python file.  Returns [] for unparsable
    files (the lint must never be the thing that fails)."""
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
    lint = _ConcurrencyLint(rel)
    lint.visit(tree)
    return lint.findings


def lint_host_concurrency(root: str,
                          subdirs: Iterable[str] = ("easydist_tpu_torch",
                                                    "examples/torch"),
                          ) -> List[Finding]:
    """The PROTO004/005 lint over every .py file beneath
    `root/<subdir>` (repo-relative paths, so baselines travel)."""
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
                findings.extend(lint_file_concurrency(full, rel=rel))
    return findings
