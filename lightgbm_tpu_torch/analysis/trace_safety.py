"""Rule pack: capture-safety (the JAX package's trace-safety, for CUDA
graphs).

A CUDA graph records the kernels a region launches once and replays
them with no Python in between. Whatever the region did on the host is
baked into the graph as the value it had at capture: a read of the card
breaks capture (or, outside it, replays a stale value), a copy from the
host records the source's pageable address once, and an RNG draw
replays the same numbers every time. The port captures its split step
(`treelearner/fused.py` `_replay_steps`); this pack keeps that step
free of such calls.

Roots: every function called in the body of a
`with torch.cuda.graph(...)` block. Flags in the functions the roots
reach (name-resolved calls, class attributes that wrap a function, as
`_partition_dev = staticmethod(obs.instrument_kernel(...))`):

- (a) reads of a captured value: `.item()`, `.cpu()`, `.tolist()`,
  `.numpy()`, `device_get`, `np.asarray` / `np.array`, and
  `int()` / `float()` / `bool()` of a tensor (`capture-read`);
- (b) `if` / `while` / `assert` on a captured value (`if-captured`);
- (c) data-dependent shapes: `nonzero`, `argwhere`, `unique`,
  `masked_select`, boolean-mask indexing (`dynamic-shape`);
- (d) copies from the host: `torch.tensor` / `torch.as_tensor` of a
  host value onto a device, `.to(<device>)` / `.cuda()` of a host
  value (`h2d-copy`);
- (e) RNG draws: `torch.rand*` / `randn` / `randint` / `randperm` /
  `bernoulli` / `multinomial` / `normal`, the in-place `.uniform_()`
  family, `np.random.*`, `random.*` (`rng-draw`).

"Captured value" is a taint: the root's parameters but `self` and
those annotated as host scalars (`int`, `float`, `bool`, `str`),
propagated through assignments and into name-resolved callees to a
fixpoint, as the JAX pack propagates traced values. Shape and
metadata reads (`x.shape`, `x.dtype`, `x.is_cuda`, `x.dim()`,
`len(x)`, `x is None`) are exempt. A graph is captured only on the
card, so the branch of an `if <tensor>.is_cuda:` that runs for CPU
tensors is not part of the capture and is not scanned.

Suppress a deliberate site with `# tpulint: capture-ok(<reason>)`.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from .core import Finding, FunctionInfo, Package, dotted
from .sync_points import _META_METHODS, _SHAPE_OPS, torch_path

RULE = "capture-safety"

_SHAPE_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                "layout", "T"}
_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
_BUILTIN_READS = {"float", "int", "bool", "complex"}
_RNG_TORCH = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "bernoulli", "multinomial",
              "normal", "poisson"}
_RNG_METHODS = {"uniform_", "normal_", "random_", "bernoulli_",
                "exponential_", "geometric_", "log_normal_", "cauchy_"}
_HOST_ANNOTATIONS = {"int", "float", "bool", "str"}


def _is_graph_ctx(pkg: Package, rel: str, node: ast.AST) -> bool:
    """`torch.cuda.graph(...)` in any alias spelling."""
    if not isinstance(node, ast.Call):
        return False
    fd = dotted(node.func)
    if fd is None:
        return False
    full = torch_path(pkg.imports[rel], fd)
    return full == "torch.cuda.graph" or fd.endswith("cuda.graph")


def graph_blocks(pkg: Package) -> List[tuple]:
    """(rel, With node, enclosing FunctionInfo) of every
    `with torch.cuda.graph(...)` block."""
    return pkg.memo("graph_blocks", lambda: _graph_blocks(pkg))


def _graph_blocks(pkg: Package) -> List[tuple]:
    out = []
    for rel, sf in pkg.files.items():
        for node in pkg.walk(sf.tree):
            if isinstance(node, ast.With) and any(
                    _is_graph_ctx(pkg, rel, it.context_expr)
                    for it in node.items):
                out.append((rel, node, pkg.enclosing_function(rel, node)))
    return out


def _cuda_branch(test: ast.AST) -> Optional[bool]:
    """True when `test` holds only for card tensors (`x.is_cuda`,
    `x.device.type == "cuda"`), False for its negation, else None."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _cuda_branch(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        return True
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Attribute) \
            and test.left.attr == "type" \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value == "cuda":
        if isinstance(test.ops[0], ast.Eq):
            return True
        if isinstance(test.ops[0], ast.NotEq):
            return False
    return None


def captured_statements(body: List[ast.stmt]) -> Iterator[ast.stmt]:
    """The statements of `body` a capture on the card runs: every
    statement but nested defs and the CPU-only arm of an
    `if <tensor>.is_cuda` test (with what follows the test when its card
    arm returns)."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(stmt, ast.If):
            arm = _cuda_branch(stmt.test)
            if arm is True:
                yield from captured_statements(stmt.body)
                if stmt.body and isinstance(stmt.body[-1],
                                            (ast.Return, ast.Raise)):
                    return          # the rest runs for CPU tensors only
                continue
            if arm is False:
                yield from captured_statements(stmt.orelse)
                continue
        yield stmt


def _class_attrs(pkg: Package, rel: str, cls: str) -> Dict[str, ast.AST]:
    """Class-level `name = value` assignments of one class."""
    def build():
        out: Dict[str, ast.AST] = {}
        for node in pkg.walk(pkg.files[rel].tree):
            if isinstance(node, ast.ClassDef) and node.name == cls:
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign):
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                out.setdefault(t.id, stmt.value)
        return out
    return pkg.memo(f"class_attrs:{rel}:{cls}", build)


def _class_attr_targets(pkg: Package, fi: FunctionInfo, attr: str
                        ) -> Set[str]:
    """Functions a class attribute `attr = wrapper(fn, ...)` of the
    caller's class wraps (`staticmethod(obs.instrument_kernel(fn))`)."""
    if fi.cls is None:
        return set()
    v = _class_attrs(pkg, fi.rel, fi.cls).get(attr)
    while isinstance(v, ast.Call) and v.args:
        v = v.args[0]
    if v is None:
        return set()
    return pkg.resolve_call(fi.rel, fi, v, fallback=False)


def callees(pkg: Package, fi: FunctionInfo, call: ast.Call) -> Set[str]:
    """Confident callees of one call, with class-attribute wrappers."""
    out = pkg.resolve_call(fi.rel, fi, call.func, fallback=False)
    f = call.func
    if not out and isinstance(f, ast.Attribute) \
            and isinstance(f.value, ast.Name) and f.value.id == "self":
        out = _class_attr_targets(pkg, fi, f.attr)
    return out


def _expr_tainted(node: ast.AST, tainted: Set[str]) -> bool:
    """True when `node` reads a tainted name OUTSIDE the shape/metadata
    exemptions."""
    if isinstance(node, ast.Attribute):
        if node.attr in _SHAPE_ATTRS:
            return False
        return _expr_tainted(node.value, tainted)
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Call):
        fd = dotted(node.func)
        if fd is not None and (fd.split(".")[0] in ("len", "isinstance")
                               or fd.split(".")[-1].startswith("is_")):
            return False          # metadata predicates
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr.startswith("lgbt_"):
            return False          # a ctypes export returns a host int
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _META_METHODS:
            return False
        parts = [node.func] if not isinstance(node.func, ast.Name) else []
        sub = parts + list(node.args) + [kw.value for kw in node.keywords]
        return any(_expr_tainted(c, tainted) for c in sub)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False          # `x is None` style checks are static
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.Load, ast.Store, ast.Del, ast.operator,
                              ast.cmpop, ast.boolop, ast.unaryop)):
            continue
        if _expr_tainted(child, tainted):
            return True
    return False


class _BodyChecker(ast.NodeVisitor):
    """Scan one captured function body with a known tainted-name set,
    updating taint through assignments in source order."""

    def __init__(self, pkg: Package, fi: FunctionInfo, tainted: Set[str],
                 findings: List[Finding],
                 call_taints: Dict[str, Set[str]]) -> None:
        self.pkg = pkg
        self.fi = fi
        self.rel = fi.rel
        self.sf = pkg.files[fi.rel]
        self.imps = pkg.imports[fi.rel]
        self.tainted = set(tainted)
        self.findings = findings
        self.call_taints = call_taints      # callee qual -> tainted params

    def run(self) -> None:
        for stmt in captured_statements(getattr(self.fi.node, "body", [])):
            self.visit(stmt)

    # -- taint bookkeeping ---------------------------------------------
    def _taint_targets(self, target: ast.AST) -> None:
        # `self.x = tainted` must not taint `self` wholesale
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._taint_targets(e)
        elif isinstance(target, (ast.Starred, ast.Subscript)):
            self._taint_targets(target.value)
        elif isinstance(target, ast.Name):
            self.tainted.add(target.id)

    def _assigned(self, value: ast.AST, targets) -> None:
        # a torch op's result lives on the card even when no argument
        # is captured (`torch.full_like(best, L)` of a captured `best`
        # is caught by the argument rule; `torch.zeros(..)` is not)
        if _expr_tainted(value, self.tainted) or self._torch_result(value):
            for t in targets:
                self._taint_targets(t)

    def _torch_result(self, value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        fd = dotted(value.func)
        full = torch_path(self.imps, fd) if fd else None
        return full is not None and full.count(".") == 1 \
            and full.split(".")[1] not in ("tensor", "as_tensor",
                                           "from_numpy", "device") \
            and not full.split(".")[1].startswith("is_")

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        self._assigned(node.value, node.targets)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        self._assigned(node.value, [node.target])

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._assigned(node.value, [node.target])

    def _comprehension(self, node) -> None:
        for gen in node.generators:
            if _expr_tainted(gen.iter, self.tainted):
                self._taint_targets(gen.target)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_GeneratorExp = _comprehension
    visit_DictComp = _comprehension

    def visit_For(self, node: ast.For) -> None:
        if _expr_tainted(node.iter, self.tainted):
            self._taint_targets(node.target)
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        arm = _cuda_branch(node.test)
        if arm is not None:
            for stmt in captured_statements([node]):
                self.visit(stmt)
            return
        # `if torch.is_tensor(x): ... return`: past it x is a host value
        t = node.test
        if isinstance(t, ast.Call) and (dotted(t.func) or "").endswith(
                "is_tensor") and t.args and isinstance(t.args[0], ast.Name) \
                and node.body and isinstance(node.body[-1], ast.Return):
            self.generic_visit(node)
            self.tainted.discard(t.args[0].id)
            return
        if _expr_tainted(node.test, self.tainted):
            self._emit(node, "if-captured",
                       "Python `if` on a captured value reads the card "
                       "(and bakes the branch into the graph)")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if _expr_tainted(node.test, self.tainted):
            self._emit(node, "while-captured",
                       "Python `while` on a captured value reads the card")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        if _expr_tainted(node.test, self.tainted):
            self._emit(node, "assert-captured",
                       "assert on a captured value reads the card")
        self.generic_visit(node)

    # nested defs are separate functions; don't descend
    def visit_FunctionDef(self, node):  # noqa: D102
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):  # noqa: D102
        pass

    # -- checks ---------------------------------------------------------
    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        if self.sf.pragma_at(node.lineno, "capture-ok"):
            return
        self.findings.append(Finding(RULE, self.rel, node.lineno,
                                     self.fi.qual, code, message))

    def visit_Subscript(self, node: ast.Subscript) -> None:
        self.generic_visit(node)
        idx = node.slice
        if isinstance(idx, (ast.Compare, ast.BoolOp)) \
                or (isinstance(idx, ast.UnaryOp)
                    and isinstance(idx.op, ast.Invert)):
            if _expr_tainted(idx, self.tainted):
                self._emit(node, "dynamic-shape:mask-index",
                           "boolean-mask indexing of a captured value has "
                           "a data-dependent shape (a read of the count)")

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        fd = dotted(node.func)
        args_tainted = any(_expr_tainted(a, self.tainted) for a in node.args)
        if fd is not None:
            parts = fd.split(".")
            root, leaf = parts[0], parts[-1]
            full = torch_path(self.imps, fd)
            if root in self.imps.numpy and leaf in ("asarray", "array") \
                    and args_tainted:
                self._emit(node, f"capture-read:np.{leaf}",
                           f"np.{leaf}() reads a captured value")
                return
            if leaf == "device_get":
                self._emit(node, "capture-read:device_get",
                           "device_get() inside a captured region reads "
                           "the card")
                return
            if len(parts) == 1 and leaf in _BUILTIN_READS and args_tainted:
                self._emit(node, f"capture-read:{leaf}()",
                           f"{leaf}() of a captured value reads the card")
                return
            if (root in self.imps.numpy and "random" in parts) \
                    or root == "random" \
                    or (full is not None and full.count(".") == 1
                        and leaf in _RNG_TORCH):
                self._emit(node, f"rng-draw:{leaf}",
                           "an RNG draw inside a captured region replays "
                           "the same numbers every time; draw outside "
                           "the graph")
                return
            if full is not None and full.count(".") == 1:
                if leaf in _SHAPE_OPS and args_tainted:
                    self._emit(node, f"dynamic-shape:{leaf}",
                               f"torch.{leaf} has a data-dependent shape "
                               "(a read of the count)")
                    return
                dev = next((kw.value for kw in node.keywords
                            if kw.arg == "device"), None)
                if leaf in ("tensor", "as_tensor") and dev is not None \
                        and not (isinstance(dev, ast.Constant)
                                 and dev.value == "cpu") \
                        and not args_tainted:
                    self._emit(node, f"h2d-copy:torch.{leaf}",
                               f"torch.{leaf} copies host data to the card "
                               "inside a captured region (captured once, "
                               "from a pageable address)")
                    return
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            recv_tainted = _expr_tainted(node.func.value, self.tainted)
            if attr in _READ_METHODS and recv_tainted:
                self._emit(node, f"capture-read:.{attr}()",
                           f".{attr}() reads a captured value")
                return
            if attr in _SHAPE_OPS and recv_tainted:
                self._emit(node, f"dynamic-shape:.{attr}()",
                           f".{attr}() has a data-dependent shape")
                return
            if attr in _RNG_METHODS:
                self._emit(node, f"rng-draw:.{attr}()",
                           "an RNG draw inside a captured region replays "
                           "the same numbers every time")
                return
            if attr == "cuda" or (attr == "to" and not recv_tainted and (
                    any(kw.arg == "device" for kw in node.keywords)
                    or any(_devicelike(a) for a in node.args))):
                if not recv_tainted:
                    self._emit(node, f"h2d-copy:.{attr}()",
                               f".{attr}() of a host value copies it to "
                               "the card inside a captured region")
                    return
        # propagate taint into the callees
        for q in callees(self.pkg, self.fi, node):
            fi = self.pkg.functions.get(q)
            if fi is None:
                continue
            params = fi.params
            off = 1 if (fi.cls and params and params[0] in ("self", "cls")
                        and isinstance(node.func, ast.Attribute)) else 0
            newly: Set[str] = set()
            for i, a in enumerate(node.args):
                if i + off < len(params) and _expr_tainted(a, self.tainted):
                    newly.add(params[i + off])
            bound = set(params[off:off + len(node.args)])
            for kw in node.keywords:
                if not _expr_tainted(kw.value, self.tainted):
                    continue
                if kw.arg in params:
                    newly.add(kw.arg)
                elif kw.arg is None:        # **tainted mapping
                    newly |= set(params[off:]) - bound
            args = fi.node.args
            newly -= {a.arg for a in args.posonlyargs + args.args
                      + args.kwonlyargs if _host_annotation(a.annotation)}
            if q not in self.call_taints:
                self.call_taints[q] = set()
            self.call_taints[q].update(newly)


def _devicelike(node: ast.AST) -> bool:
    d = dotted(node) or ""
    leaf = d.split(".")[-1]
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    return "device" in leaf or leaf == "dev"


def _host_annotation(node: Optional[ast.AST]) -> bool:
    """An annotation naming only host types (`int`, `Sequence[int]`,
    `Optional[float]`, ...)."""
    if node is None:
        return False
    names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
    return bool(names) and names <= _HOST_ANNOTATIONS | {
        "Sequence", "List", "Tuple", "Optional", "Iterable"}


def root_taints(pkg: Package) -> Dict[str, Set[str]]:
    """qual -> tainted params of every function called in a
    `with torch.cuda.graph(...)` body."""
    roots: Dict[str, Set[str]] = {}
    for rel, block, caller in graph_blocks(pkg):
        if caller is None:
            continue
        for stmt in block.body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                for q in callees(pkg, caller, node):
                    fi = pkg.functions[q]
                    args = fi.node.args
                    host = {a.arg for a in args.posonlyargs + args.args
                            + args.kwonlyargs if _host_annotation(
                                a.annotation)}
                    roots.setdefault(q, set()).update(
                        p for p in fi.params
                        if p not in ("self", "cls") and p not in host)
    return roots


def captured_functions(pkg: Package) -> Dict[str, Set[str]]:
    """qual -> tainted params, for every function a captured region
    reaches (fixpoint over the pruned call graph)."""
    return pkg.memo("captured_functions", lambda: _captured(pkg))


def _captured(pkg: Package) -> Dict[str, Set[str]]:
    taints = root_taints(pkg)
    for _ in range(8):
        before = {q: set(s) for q, s in taints.items()}
        sink: List[Finding] = []
        for q in list(taints):
            fi = pkg.functions.get(q)
            if fi is not None:
                _BodyChecker(pkg, fi, taints[q], sink, taints).run()
        if taints == before:
            break
    return taints


def check(pkg: Package) -> List[Finding]:
    taints = captured_functions(pkg)
    findings: List[Finding] = []
    for q, tainted in sorted(taints.items()):
        fi = pkg.functions.get(q)
        if fi is None:
            continue
        _BodyChecker(pkg, fi, tainted, findings, dict(taints)).run()
    return findings
