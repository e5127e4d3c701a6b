"""Layer 11, host form: the donation/aliasing `ast` lint (the `ast` half
of easydist_tpu/analyze/alias_rules.py; its jaxpr half, ALIAS001-004
over traced programs, is not ported yet).

ALIAS001 (host form) — a retained Python reference to a donated argument
    loaded after the donating call without an intervening rebind.  The
    rebind idiom — `pool.cache, tok = self._decode_c(pool.cache, ...)` —
    is the clean shape: the Store on the call's own statement retires
    the stale reference immediately.  In the port a compiled function
    writes paired state into its inputs (`fxfront.api`'s state copy), so
    a stale reference reads the new values, not freed storage; the lint
    keeps the JAX package's discipline so the two packages' host code
    stays checkable by one rule.

The lint reasons per function scope and in source-line order (no
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
