"""Rule pack: lock-discipline.

For every class that owns a `threading.Lock`/`RLock` (an attribute
assigned `threading.Lock()` in any of its methods), find instance
attributes that are mutated at least once inside a `with self.<lock>:`
block — those are the lock-protected ones — and flag every OTHER
mutation of the same attribute that happens outside the lock.

The bug class: a cache maintained under `_lock` in one method but
also written directly from a fallback path. Same semantics as the JAX
package's pack, over the port's sources.

Scope rules:
- `__init__` mutations are exempt (the object isn't shared yet).
- Mutations counted: `self.a = ...`, `self.a += ...`, `self.a[k] = ...`,
  `del self.a[...]`, and mutating method calls
  (`self.a.append/pop/clear/update/...`).
- A nested function defined inside a method is analyzed as NOT holding
  the enclosing `with` lock — it typically runs later on another thread
  (warmup closures), which is the dangerous case.
- Suppress with `# tpulint: lock-ok(<reason>)`.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Package, dotted

_LOCK_CTORS = {"Lock", "RLock"}
_MUTATING_METHODS = {
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "setdefault", "move_to_end", "add", "remove", "discard", "sort",
    "reverse", "appendleft", "popleft",
}


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' when node is `self.x`."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


@dataclasses.dataclass
class _Mutation:
    attr: str
    line: int
    under_lock: bool
    method: str            # function qual
    kind: str              # "assign" | "call:<name>" | "del"


class _MethodScanner(ast.NodeVisitor):
    def __init__(self, lock_attrs: Set[str], method_qual: str) -> None:
        self.lock_attrs = lock_attrs
        self.method = method_qual
        self.depth = 0
        self.mutations: List[_Mutation] = []

    # -- lock context ----------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        holds = any(_self_attr(item.context_expr) in self.lock_attrs
                    for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if holds:
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self.depth -= 1

    def visit_FunctionDef(self, node) -> None:
        # a closure runs later, possibly on another thread: the lock the
        # enclosing method holds is NOT held when it executes
        saved = self.depth
        self.depth = 0
        for stmt in node.body:
            self.visit(stmt)
        self.depth = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- mutations -------------------------------------------------------
    def _record(self, attr: Optional[str], node: ast.AST, kind: str) -> None:
        if attr is None or attr in self.lock_attrs:
            return
        self.mutations.append(_Mutation(attr, node.lineno, self.depth > 0,
                                        self.method, kind))

    def _target_attr(self, target: ast.AST) -> Optional[str]:
        if isinstance(target, ast.Subscript):
            return self._target_attr(target.value)
        return _self_attr(target)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record(self._target_attr(t), node, "assign")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record(self._target_attr(node.target), node, "assign")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(self._target_attr(node.target), node, "assign")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record(self._target_attr(t), node, "del")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATING_METHODS:
            self._record(_self_attr(node.func.value), node,
                         f"call:{node.func.attr}")
        self.generic_visit(node)


def _class_methods(pkg: Package) -> Dict[Tuple[str, str], List[str]]:
    """(rel, class) -> [method quals] (top-level methods only)."""
    out: Dict[Tuple[str, str], List[str]] = {}
    for qual, fi in pkg.functions.items():
        if fi.cls is not None and "." not in fi.name:
            out.setdefault((fi.rel, fi.cls), []).append(qual)
    return out


def _lock_attrs(pkg: Package, method_quals: List[str]) -> Set[str]:
    attrs: Set[str] = set()
    for q in method_quals:
        fi = pkg.functions[q]
        for node in pkg.walk(fi.node):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                fd = dotted(node.value.func)
                if fd is not None and fd.split(".")[-1] in _LOCK_CTORS:
                    for t in node.targets:
                        a = _self_attr(t)
                        if a is not None:
                            attrs.add(a)
    return attrs


def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    for (rel, cls), methods in sorted(_class_methods(pkg).items()):
        lock_attrs = _lock_attrs(pkg, methods)
        if not lock_attrs:
            continue
        sf = pkg.files[rel]
        mutations: List[_Mutation] = []
        for q in sorted(methods):
            fi = pkg.functions[q]
            scan = _MethodScanner(lock_attrs, q)
            for stmt in fi.node.body:
                scan.visit(stmt)
            mutations.extend(scan.mutations)
        guarded = {m.attr for m in mutations if m.under_lock}
        for m in mutations:
            if m.attr not in guarded or m.under_lock:
                continue
            if m.method.endswith(".__init__"):
                continue
            if sf.pragma_at(m.line, "lock-ok"):
                continue
            findings.append(Finding(
                "lock-discipline", rel, m.line, m.method,
                f"{cls}.{m.attr}:{m.kind}",
                f"`self.{m.attr}` is mutated under `with self.<lock>` "
                f"elsewhere in {cls} but {m.kind.replace('call:', '.')} "
                "here runs without the lock"))
    return findings
