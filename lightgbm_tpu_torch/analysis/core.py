"""The port's linter core: package model, pragmas, call graph, findings.

The analyzer is a plain-`ast` static pass over the package's own
sources: it imports none of the analyzed code and no torch, so it runs
in seconds and can't be confused by import-time side effects. It is
the port's own copy of the JAX package's analysis core; it recognises
`torch` and `numpy` as the import roots where that one recognises
`jax` / `jax.numpy`.

Model
-----
- `SourceFile`: one parsed module + its `# tpulint:` pragma lines.
- `FunctionInfo`: every function/method, keyed by a stable qualname
  `<relpath>::<Class.>name` (nested functions append `.name`).
- `Package`: the file set, a symbol index, per-module import aliases,
  and a name-resolved call graph with a simple-name fallback for
  `obj.method(...)` calls whose receiver type is unknown. The fallback
  OVER-approximates reachability on purpose: a sync point wrongly
  classified hot is a pragma away from quiet, one wrongly classified
  setup is a silent regression. Unlike the JAX package's core, it never
  matches a nested function (`x.t()` is a tensor's transpose, not a
  closure named `t`), a receiver bound by an import from outside the
  package (`subprocess.run` is not a package `run`) or the linter's own
  functions: on the port those three turned the whole package hot.
- `Package.walk` / `Package.memo`: a function body's nodes and the
  models several packs share (capture reach, sync inventory), computed
  once per package.

Pragmas
-------
`# tpulint: <kind>(<reason>)` on the offending line, or alone on the
line directly above it (the JAX package's syntax, so both packages'
rule packs read the same annotations). Kinds: `sync-ok`, `lock-ok`,
`thread-ok`, `mesh-ok`, `tile-ok`, `dtype-ok` (kept from the JAX
package), and the port's `capture-ok` (capture-safety), `build-ok` /
`graph-ok` (recompile-hazard) and `life-ok` (buffer-lifetime). The
reason is mandatory: a bare pragma is itself a finding.

Findings & baseline
-------------------
A `Finding` is keyed WITHOUT its line number (rule, file, function,
site code), so pure line drift doesn't churn the baseline. The baseline
maps key -> allowed count; a new occurrence of an already-baselined
site kind in the same function still fails once it exceeds the count.
The baseline only ever shrinks.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PRAGMA_RE = re.compile(r"#\s*tpulint:\s*([a-z-]+)\s*(?:\(\s*([^)]*?)\s*\))?")
PRAGMA_KINDS = ("sync-ok", "lock-ok", "thread-ok", "mesh-ok", "tile-ok",
                "dtype-ok", "capture-ok", "build-ok", "graph-ok", "life-ok")

# numpy / torch module spellings recognized as import roots
_NUMPY_MODULES = ("numpy",)
_TORCH_MODULES = ("torch",)


@dataclasses.dataclass(frozen=True)
class Pragma:
    kind: str
    reason: str
    line: int


@dataclasses.dataclass
class Finding:
    rule: str          # "capture-safety" | "sync-point" | ... (RULE_PACKS)
    path: str          # repo-relative file path
    line: int
    func: str          # qualname of the enclosing function ("" = module level)
    code: str          # short stable site descriptor, e.g. "np.asarray"
    message: str

    @property
    def key(self) -> str:
        """Line-independent baseline key."""
        return f"{self.rule}|{self.path}|{self.func}|{self.code}"

    def __str__(self) -> str:
        where = f"{self.path}:{self.line}"
        fn = f" [{self.func}]" if self.func else ""
        return f"{where}: {self.rule}: {self.message}{fn}"


class SourceFile:
    def __init__(self, rel: str, text: str) -> None:
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        self.pragmas: Dict[int, List[Pragma]] = {}
        for i, line in enumerate(self.lines, start=1):
            if "tpulint" not in line:
                continue
            for m in PRAGMA_RE.finditer(line):
                self.pragmas.setdefault(i, []).append(
                    Pragma(m.group(1), (m.group(2) or "").strip(), i))

    def pragma_at(self, line: int, kind: str) -> Optional[Pragma]:
        """Pragma of `kind` covering `line`: same line, or alone on the
        line above (a standalone-comment pragma)."""
        for p in self.pragmas.get(line, ()):
            if p.kind == kind:
                return p
        above = line - 1
        if above in self.pragmas and above <= len(self.lines):
            src = self.lines[above - 1].strip()
            if src.startswith("#"):
                for p in self.pragmas[above]:
                    if p.kind == kind:
                        return p
        return None


@dataclasses.dataclass
class FunctionInfo:
    qual: str                       # "<rel>::<Class.>name"
    rel: str
    cls: Optional[str]
    name: str
    node: ast.AST                   # FunctionDef | AsyncFunctionDef | Lambda
    params: List[str]
    lineno: int


def _func_params(node: ast.AST) -> List[str]:
    a = node.args
    params = [p.arg for p in getattr(a, "posonlyargs", [])] + \
        [p.arg for p in a.args]
    if a.vararg:
        params.append(a.vararg.arg)
    params += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        params.append(a.kwarg.arg)
    return params


class _FunctionCollector(ast.NodeVisitor):
    def __init__(self, rel: str) -> None:
        self.rel = rel
        self.funcs: List[FunctionInfo] = []
        self.class_bases: Dict[str, List[str]] = {}
        self._cls: List[str] = []
        self._fn: List[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        bases = []
        for b in node.bases:
            if isinstance(b, ast.Name):
                bases.append(b.id)
            elif isinstance(b, ast.Attribute):
                bases.append(b.attr)
        self.class_bases[node.name] = bases
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()

    def _visit_func(self, node) -> None:
        name = ".".join(self._fn + [node.name])
        cls = self._cls[-1] if self._cls else None
        qual = f"{self.rel}::{cls + '.' if cls else ''}{name}"
        self.funcs.append(FunctionInfo(
            qual, self.rel, cls, name, node, _func_params(node), node.lineno))
        self._fn.append(node.name)
        self.generic_visit(node)
        self._fn.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


class ModuleImports:
    """Import aliases of one module, resolved against the package."""

    def __init__(self, rel: str, tree: ast.Module, pkg_rels: Set[str],
                 pkg_name: str) -> None:
        self.numpy: Set[str] = set()
        # names bound to torch or one of its submodules
        # (`import torch`, `import torch.nn.functional as F`,
        # `from torch import nn`)
        self.torch: Set[str] = set()
        # torch alias -> the module it names ("dist" -> "torch.distributed")
        self.torch_modules: Dict[str, str] = {}
        # names bound by imports from outside the package (json, os,
        # subprocess, ...): `subprocess.run(...)` is never package code
        self.external: Set[str] = set()
        # alias -> package-relative module path ("ops/histogram.py")
        self.modules: Dict[str, str] = {}
        # imported symbol -> (module rel, symbol name)
        self.symbols: Dict[str, Tuple[str, str]] = {}
        base_dir = os.path.dirname(rel)

        def rel_of(module: Optional[str], level: int) -> Optional[str]:
            if level == 0:
                if module and (module == pkg_name
                               or module.startswith(pkg_name + ".")):
                    parts = module.split(".")[1:]
                else:
                    return None
            else:
                d = base_dir
                for _ in range(level - 1):
                    d = os.path.dirname(d)
                parts = ([p for p in d.split(os.sep) if p]
                         + (module.split(".") if module else []))
            cand = os.path.join(*parts) + ".py" if parts else None
            if cand and cand in pkg_rels:
                return cand
            cand = os.path.join(*(parts + ["__init__.py"])) if parts else None
            return cand if cand in pkg_rels else None

        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    root = al.name.split(".")[0]
                    if al.name in _NUMPY_MODULES:
                        self.numpy.add(al.asname or al.name)
                    elif root in _TORCH_MODULES:
                        self.torch.add(al.asname or root)
                        self.torch_modules[al.asname or root] = \
                            al.name if al.asname else root
                    elif root != pkg_name:
                        self.external.add(al.asname or root)
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module is not None \
                        and node.module.split(".")[0] in _TORCH_MODULES:
                    for al in node.names:
                        if al.name[:1].islower():   # a submodule or fn
                            self.torch.add(al.asname or al.name)
                            self.torch_modules[al.asname or al.name] = \
                                f"{node.module}.{al.name}"
                    continue
                mod_rel = rel_of(node.module, node.level)
                for al in node.names:
                    asname = al.asname or al.name
                    if mod_rel is None:
                        # maybe importing a submodule: from ..ops import histogram
                        sub = rel_of((node.module + "." if node.module else "")
                                     + al.name, node.level)
                        if sub is not None:
                            self.modules[asname] = sub
                        elif node.level == 0 and node.module is not None \
                                and node.module.split(".")[0] != pkg_name:
                            self.external.add(asname)
                        continue
                    sub = rel_of((node.module + "." if node.module else "")
                                 + al.name, node.level)
                    if sub is not None:
                        self.modules[asname] = sub
                    else:
                        self.symbols[asname] = (mod_rel, al.name)


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Package:
    """The analyzed file set plus derived indices."""

    def __init__(self, root: str, rels: Sequence[str],
                 pkg_name: str = "lightgbm_tpu_torch") -> None:
        self.root = root
        self.pkg_name = pkg_name
        self.files: Dict[str, SourceFile] = {}
        for rel in rels:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                self.files[rel] = SourceFile(rel, fh.read())
        rel_set = set(self.files)
        self.imports: Dict[str, ModuleImports] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.class_bases: Dict[str, Dict[str, List[str]]] = {}
        # simple name -> quals (for receiver-unknown method calls); the
        # linter's own functions never match a receiver-unknown call
        # (`spec.check(...)` is not a rule pack's `check`), and neither
        # does a nested function (`x.t()` is not a closure named `t`)
        self.by_name: Dict[str, List[str]] = {}
        analysis_dir = os.path.join(pkg_name, "analysis") + os.sep
        for rel, sf in self.files.items():
            self.imports[rel] = ModuleImports(rel, sf.tree, rel_set, pkg_name)
            col = _FunctionCollector(rel)
            col.visit(sf.tree)
            self.class_bases[rel] = col.class_bases
            for fi in col.funcs:
                self.functions[fi.qual] = fi
                if rel.startswith(analysis_dir) or "." in fi.name:
                    continue     # the linter, and nested functions: never
                    #              reached through an attribute
                self.by_name.setdefault(fi.name.split(".")[-1], []).append(
                    fi.qual)
        self._call_graph: Optional[Dict[str, Set[str]]] = None
        self._memo: Dict[str, object] = {}
        self._by_rel: Optional[Dict[str, List[FunctionInfo]]] = None

    def walk(self, node: ast.AST) -> List[ast.AST]:
        """`ast.walk(node)` as a list, cached per node: the packs walk
        every function body several times."""
        cache = self._memo.setdefault("walk", {})
        out = cache.get(id(node))
        if out is None:
            out = cache[id(node)] = list(ast.walk(node))
        return out

    def memo(self, key: str, build):
        """`build()` once per package: derived models several packs
        share (the capture reach, the sync inventory)."""
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    @classmethod
    def load(cls, root: Optional[str] = None,
             subdir: str = "lightgbm_tpu_torch") -> "Package":
        """Package rooted at the repo checkout (default: the parent of
        this package's own directory)."""
        if root is None:
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        rels = []
        for dirpath, dirnames, filenames in os.walk(
                os.path.join(root, subdir)):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for f in sorted(filenames):
                if f.endswith(".py"):
                    rels.append(os.path.relpath(os.path.join(dirpath, f),
                                                root))
        return cls(root, rels, subdir)

    # -- resolution -----------------------------------------------------
    def _method_in_class(self, rel: str, cls: str, name: str
                         ) -> Optional[str]:
        """Resolve Class.name in `rel`, walking base classes by name
        (package-wide for bases imported from another module)."""
        seen: Set[Tuple[str, str]] = set()
        stack = [(rel, cls)]
        while stack:
            r, c = stack.pop()
            if (r, c) in seen:
                continue
            seen.add((r, c))
            q = f"{r}::{c}.{name}"
            if q in self.functions:
                return q
            for base in self.class_bases.get(r, {}).get(c, ()):
                if base in self.class_bases.get(r, {}):
                    stack.append((r, base))
                else:
                    imp = self.imports[r].symbols.get(base)
                    if imp is not None:
                        stack.append((imp[0], imp[1]))
                    else:
                        for r2, classes in self.class_bases.items():
                            if base in classes:
                                stack.append((r2, base))
        return None

    def resolve_call(self, rel: str, caller: Optional[FunctionInfo],
                     func_expr: ast.AST, fallback: bool = True) -> Set[str]:
        """Possible callee qualnames for one Call.func expression.
        Empty set = external / unresolvable.

        `fallback=False` disables the unknown-receiver simple-name
        matching: only confident resolutions (self methods, module
        aliases, imported symbols) are returned. Reachability analyses
        want the over-approximation; taint analyses don't — `s.add(x)`
        on a set must not taint every function named `add`."""
        imps = self.imports[rel]
        out: Set[str] = set()
        if isinstance(func_expr, ast.Name):
            name = func_expr.id
            if name in imps.symbols:
                mod, sym = imps.symbols[name]
                q = f"{mod}::{sym}"
                if q in self.functions:
                    return {q}
                # imported class: constructor
                q = f"{mod}::{sym}.__init__"
                if q in self.functions:
                    return {q}
                return set()
            q = f"{rel}::{name}"
            if q in self.functions:
                return {q}
            if name in self.class_bases.get(rel, {}):
                q = f"{rel}::{name}.__init__"
                return {q} if q in self.functions else set()
            # nested function visible from the caller's scope: its own
            # children first, then each enclosing function scope (a
            # sibling closure like `body` next to a shard_map-wrapped
            # `fn_args`). Stops above the outermost function — a bare
            # name can't reach class scope.
            if caller is not None:
                path = caller.qual.split("::", 1)[1].split(".")
                floor = 1 if caller.cls else 0
                for i in range(len(path), floor, -1):
                    q = f"{rel}::{'.'.join(path[:i] + [name])}"
                    if q in self.functions:
                        return {q}
            return set()
        if isinstance(func_expr, ast.Attribute):
            attr = func_expr.attr
            base = func_expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and caller is not None and caller.cls:
                    q = self._method_in_class(rel, caller.cls, attr)
                    if q is not None:
                        return {q}
                    return set(self.by_name.get(attr, ())) if fallback \
                        else set()
                if base.id in imps.modules:
                    q = f"{imps.modules[base.id]}::{attr}"
                    if q in self.functions:
                        return {q}
                    return set()
                if base.id in (imps.numpy | imps.torch | imps.external):
                    return set()
            if isinstance(base, ast.Call) and isinstance(base.func, ast.Name) \
                    and base.func.id == "super" and caller is not None \
                    and caller.cls:
                for b in self.class_bases.get(rel, {}).get(caller.cls, ()):
                    q = self._method_in_class(rel, b, attr)
                    if q is not None:
                        out.add(q)
                return out
            md = dotted(func_expr)
            if md is not None:
                root = md.split(".")[0]
                if root in (imps.numpy | imps.torch):
                    return set()
            # unknown receiver: fall back to simple-name matching
            return set(self.by_name.get(attr, ())) if fallback else set()
        return out

    # -- call graph -----------------------------------------------------
    def call_graph(self) -> Dict[str, Set[str]]:
        if self._call_graph is not None:
            return self._call_graph
        graph: Dict[str, Set[str]] = {}
        for qual, fi in self.functions.items():
            edges: Set[str] = set()
            for node in self.walk(fi.node):
                if isinstance(node, ast.Call):
                    edges |= self.resolve_call(fi.rel, fi, node.func)
            graph[qual] = edges
        self._call_graph = graph
        return graph

    def reachable(self, roots: Iterable[str]) -> Set[str]:
        graph = self.call_graph()
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(graph.get(q, ()) - seen)
        return seen

    def enclosing_function(self, rel: str, node: ast.AST
                           ) -> Optional[FunctionInfo]:
        if self._by_rel is None:
            self._by_rel = {}
            for fi in self.functions.values():
                self._by_rel.setdefault(fi.rel, []).append(fi)
        best: Optional[FunctionInfo] = None
        for fi in self._by_rel.get(rel, ()):
            end = getattr(fi.node, "end_lineno", fi.lineno)
            if fi.lineno <= node.lineno <= end:
                if best is None or fi.lineno >= best.lineno:
                    best = fi
        return best


# -- baseline ------------------------------------------------------------
BASELINE_VERSION = 1


def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("entries", {})
    return {str(k): int(v) for k, v in entries.items()}


def save_baseline(path: str, findings: Sequence[Finding]) -> Dict[str, int]:
    entries: Dict[str, int] = {}
    for f in findings:
        entries[f.key] = entries.get(f.key, 0) + 1
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": BASELINE_VERSION,
                   "entries": {k: entries[k] for k in sorted(entries)}},
                  fh, indent=1, sort_keys=False)
        fh.write("\n")
    return entries


def apply_baseline(findings: Sequence[Finding], baseline: Dict[str, int]
                   ) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined): each baseline key absorbs up to its count."""
    budget = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
