"""Rule pack: dtype-flow.

Tracks the float32 -> int16 levels -> packed int32 -> float32
conversions of the quantized histogram pipeline (`ops/quantize.py`:
`quantize_gradients`, `pack_gh` / `unpack_gh`,
`pairs_to_packed_hist` / `packed_hist_to_pairs`) through each function
body and flags the orderings that silently lose precision. The JAX
package's four rules, in torch spellings:

- **narrow-sum**: `x.sum()` / `torch.sum(x)` (and `cumsum`, `prod`) of
  a value known to be int8/int16/uint8/uint16/bfloat16/float16 without
  a `dtype=`: the accumulator and the result dtype are left to
  promotion rules (bfloat16 and float16 round the result; integers
  widen only by torch's default), so the intent must be written down.
- **packed-as-float**: `.float()` / `.to(torch.float32)` of a packed gh
  word: a *value* cast of bit-packed fields is meaningless; unpack
  first (`unpack_gh` / `packed_hist_to_pairs`), or `.view()` for the
  raw bits.
- **dequant-before-subtract**: both operands of a subtraction were
  separately converted int -> float before the subtract: the sibling
  histogram trick is exact only in int32 (`parent - sibling` THEN
  dequantize).
- **accum-downcast**: `acc.index_add_(dim, idx, v)` /
  `acc.scatter_add_(dim, idx, v)` where `acc` is known narrow
  (int16/int8) and `v` known wider (int32/float32): every add rounds
  through the narrow dtype.

Tracking is per-function and syntactic: dtypes come from `.to(T)`,
the dtype methods (`.float()`, `.int()`, `.short()`, ...), factories'
`dtype=` (`torch.zeros(..., dtype=T)`), and the quantize-pipeline
producers. A dtype the pack can't prove is not flagged.

Suppress a deliberate site with `# tpulint: dtype-ok(<reason>)`.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .core import Finding, Package, dotted

_NARROW = {"int16", "uint16", "int8", "uint8", "bfloat16", "float16"}
_WIDE = {"int32", "uint32", "int64", "float32", "float64"}
_FLOAT = {"float32", "float64", "bfloat16", "float16"}
_INT = {"int8", "uint8", "int16", "uint16", "int32", "uint32", "int64"}

# quantize-pipeline producers -> dtype marker of their result
_PRODUCERS = {
    "pack_gh": "packed",
    "pairs_to_packed_hist": "packed",
    "packed_hist_to_pairs": "int32",
    "unpack_gh": "int16",            # (qg, qh) int16 pair
    "quantize_gradients": "int16",
}

_ZERO_MAKERS = {"zeros", "ones", "full", "empty", "zeros_like", "ones_like",
                "full_like", "empty_like", "tensor", "as_tensor", "arange"}

# dtype methods of a tensor -> the dtype they convert to
_DTYPE_METHODS = {"float": "float32", "double": "float64", "half": "float16",
                  "bfloat16": "bfloat16", "int": "int32", "long": "int64",
                  "short": "int16", "char": "int8", "byte": "uint8"}


def _walk_local(fn_node: ast.AST):
    """ast.walk (breadth-first, so same-level statements keep source
    order — assignment recording depends on it) without descending
    into nested function/class defs: those are separate FunctionInfos
    and get their own checker."""
    from collections import deque
    queue = deque(ast.iter_child_nodes(fn_node))
    while queue:
        node = queue.popleft()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        queue.extend(ast.iter_child_nodes(node))


def _conversion(call: ast.Call) -> Optional[str]:
    """The dtype a conversion call produces: `x.to(T)`, `x.to(dtype=T)`,
    `x.float()` and the other dtype methods; else None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in _DTYPE_METHODS and not call.args:
        return _DTYPE_METHODS[attr]
    if attr == "to":
        for a in call.args:
            dt = _dtype_leaf(a)
            if dt is not None:
                return dt
        for kw in call.keywords:
            if kw.arg == "dtype":
                return _dtype_leaf(kw.value)
    return None


def _dtype_leaf(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in _NARROW | _WIDE else None
    d = dotted(node)
    if d is not None:
        leaf = d.split(".")[-1]
        if leaf in _NARROW | _WIDE or leaf in ("float32", "int32"):
            return leaf
    return None


class _FnChecker:
    """One function body: assignment-ordered dtype map + checks."""

    def __init__(self, pkg: Package, rel: str, qual: str,
                 fn_node: ast.AST, findings: List[Finding]) -> None:
        self.pkg = pkg
        self.rel = rel
        self.sf = pkg.files[rel]
        self.qual = qual
        self.fn = fn_node
        self.findings = findings
        self.dtype: Dict[str, str] = {}

    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        if self.sf.pragma_at(node.lineno, "dtype-ok"):
            return
        self.findings.append(Finding("dtype-flow", self.rel, node.lineno,
                                     self.qual, code, message))

    # -- dtype of an expression, from the map + producing calls ---------
    def _dtype_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return self.dtype.get(expr.id)
        if isinstance(expr, ast.Call):
            dst = _conversion(expr)
            if dst is not None:
                return dst
            d = dotted(expr.func)
            leaf = d.split(".")[-1] if d else None
            if leaf in _PRODUCERS:
                return _PRODUCERS[leaf]
            if leaf in _ZERO_MAKERS:
                for kw in expr.keywords:
                    if kw.arg == "dtype":
                        return _dtype_leaf(kw.value)
        if isinstance(expr, ast.Subscript):
            return self._dtype_of(expr.value)
        return None

    def _was_int(self, expr: ast.AST) -> bool:
        """Did `expr` convert an int value to float right here
        (`<int>.float()`), or is it a name assigned that way?"""
        if isinstance(expr, ast.Name):
            return self.dtype.get(expr.id) == "float-from-int"
        if isinstance(expr, ast.Call) and _conversion(expr) is not None \
                and isinstance(expr.func, ast.Attribute):
            dst = _conversion(expr)
            src = self._dtype_of(expr.func.value)
            return dst in _FLOAT and (src in _INT or src == "packed")
        return False

    # -- per-statement walk ---------------------------------------------
    def _record_assign(self, node: ast.Assign) -> None:
        if len(node.targets) != 1:
            return
        tgt = node.targets[0]
        dt = self._dtype_of(node.value)
        if self._was_int(node.value):
            dt = "float-from-int"
        if dt is None:
            return
        if isinstance(tgt, ast.Name):
            self.dtype[tgt.id] = dt
        elif isinstance(tgt, ast.Tuple) and dt in ("int16",):
            # qg, qh = unpack_gh(w) / quantize_gradients(...)
            for e in tgt.elts:
                if isinstance(e, ast.Name):
                    self.dtype[e.id] = dt

    def _check_call(self, node: ast.Call) -> None:
        d = dotted(node.func)
        leaf = d.split(".")[-1] if d else None
        # narrow-sum: torch.sum(x) / x.sum() without dtype=
        if leaf in ("sum", "cumsum", "prod"):
            has_dtype = any(kw.arg == "dtype" for kw in node.keywords)
            operand: Optional[ast.AST] = None
            if isinstance(node.func, ast.Attribute):
                root = d.split(".")[0] if d else None
                imps = self.pkg.imports[self.rel]
                if root in (imps.torch | imps.numpy):
                    operand = node.args[0] if node.args else None
                else:
                    operand = node.func.value      # x.sum()
            if operand is not None and not has_dtype:
                dt = self._dtype_of(operand)
                if dt in _NARROW:
                    self._emit(node, f"narrow-sum:{dt}",
                               f"{leaf}() over a {dt} value leaves its "
                               "accumulator to promotion rules; pass "
                               "dtype=torch.int32/int64/float32")
        # packed-as-float: <packed>.float() / .to(torch.float32)
        if isinstance(node.func, ast.Attribute) \
                and _conversion(node) is not None:
            dst = _conversion(node)
            src = self._dtype_of(node.func.value)
            if src == "packed" and dst in _FLOAT:
                self._emit(node, "packed-as-float",
                           "value-cast of a packed gh word to float — "
                           "unpack first (packed_hist_to_pairs/unpack_gh) "
                           "or .view() for raw bits")
        # accum-downcast: acc.index_add_(dim, idx, v) /
        # acc.scatter_add_(dim, idx, v)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("index_add_", "scatter_add_",
                                       "index_add", "scatter_add") \
                and len(node.args) >= 3:
            acc_dt = self._dtype_of(node.func.value)
            val_dt = self._dtype_of(node.args[2])
            if acc_dt in _NARROW and val_dt in _WIDE:
                self._emit(node, f"accum-downcast:{acc_dt}<-{val_dt}",
                           f".{node.func.attr}() of a {val_dt} value into "
                           f"a {acc_dt} accumulator rounds through the "
                           "narrow dtype on every update")

    def _check_binop(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.Sub) \
                and self._was_int(node.left) and self._was_int(node.right):
            self._emit(node, "dequant-before-subtract",
                       "both operands were dequantized to float before "
                       "the subtract — histogram subtraction is exact "
                       "only in int32: subtract first, then convert")

    def run(self) -> None:
        nodes = list(_walk_local(self.fn))
        for node in nodes:
            if isinstance(node, ast.Assign):
                self._record_assign(node)
        # second pass with the full map (walk order is not source order;
        # per-function maps are tiny, so two passes beat bookkeeping)
        for node in nodes:
            if isinstance(node, ast.Call):
                self._check_call(node)
            elif isinstance(node, ast.BinOp):
                self._check_binop(node)


def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    for qual in sorted(pkg.functions):
        fi = pkg.functions[qual]
        _FnChecker(pkg, fi.rel, qual, fi.node, findings).run()
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings
