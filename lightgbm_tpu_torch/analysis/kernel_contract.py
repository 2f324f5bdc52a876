"""Rule pack: kernel-contract.

The port's kernels are CUDA C++ (`csrc/*.cu`) built into plain-C
libraries and called through `ctypes` (`ops/cuda.py`). Nothing checks
a ctypes call against the C function it reaches: a wrong argument
count or an int passed where a pointer is expected corrupts memory
without an error, and a bad launch configuration fails only on the
card. Four checks, on a regex model of the `.cu` sources and the `ast`
of the Python side:

1. **abi-signature**: every `extern "C"` export of `csrc/<lib>.cu`
   against its row in `ops/cuda.py` `_SIGNATURES[<lib>]`: arity, the
   kind of each position (pointer / `int` / `long long`) and the return
   type. An export without a row, and a row without an export, are
   findings too.
2. **abi-call**: each `<lib>.lgbt_*(...)` call passes the row's arity
   (a local list splatted with `*` is expanded), a `.data_ptr()`,
   `None` or the stream (or a name or helper that yields one) in every
   pointer position and no pointer in an integer position; and each
   tensor whose `.data_ptr()` it passes has its dtype and contiguity
   settled in the same function (a `.dtype` test with an
   `.is_contiguous()` test or a `.contiguous()` copy, possibly in a
   checking helper it calls, or a torch factory with its dtype).
3. **launch-config**: each `kernel<<<grid, block, smem, stream>>>`
   needs a block size that resolves (literals, `constexpr` constants,
   `32 * x` with `x` bounded by a `std::min` over a constant) to a
   multiple of 32 and at most 1024, and within the kernel's
   `__launch_bounds__`; dynamic shared memory that is not a literal
   under 48 KiB needs `cudaFuncSetAttribute(<kernel>,
   cudaFuncAttributeMaxDynamicSharedMemorySize, ...)` (directly or
   through a helper that takes the kernel); and the fourth argument
   must be the stream passed in (a `cudaStream_t` variable), not the
   legacy default stream, which breaks capture and stream order.
   `launch_inventory` hands these configurations to the card's
   runtime check.
4. **bitcast-width**: `Tensor.view(dtype)` of a value whose dtype is
   evident (`.to(T)`, a factory's `dtype=`, or a name assigned so) into
   a dtype of another bit width: the last dimension grows or shrinks.

The JAX pack's `memspace` has no counterpart (no TPU memory spaces).
Suppress a deliberate site with `# tpulint: tile-ok(<reason>)` (in a
`.cu` file: `// tpulint: tile-ok(<reason>)`).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, FunctionInfo, Package, dotted

RULE = "kernel-contract"
_CUDA_REL = "lightgbm_tpu_torch/ops/cuda.py"
_CU_PRAGMA_RE = re.compile(r"//\s*tpulint:\s*([a-z-]+)\s*\(\s*([^)]*?)\s*\)")
_SMEM_DEFAULT = 48 * 1024
_MAX_BLOCK = 1024

_DTYPE_BITS = {
    "float64": 64, "double": 64, "int64": 64, "long": 64,
    "float32": 32, "float": 32, "int32": 32, "int": 32, "uint32": 32,
    "float16": 16, "half": 16, "bfloat16": 16, "int16": 16, "short": 16,
    "uint16": 16, "int8": 8, "uint8": 8, "bool": 8,
}


# -- the .cu model --------------------------------------------------------

@dataclasses.dataclass
class Export:
    lib: str
    name: str
    line: int
    params: List[str]          # "ptr" | "int" | "long"
    ret: Optional[str]         # "int" | "long" | None (void)


@dataclasses.dataclass
class Launch:
    rel: str
    line: int
    kernel: str
    block: str                 # the block expression as written
    smem: str
    stream: str
    block_max: Optional[int]   # resolved upper bound (None: unresolved)
    block_mult32: bool
    smem_max: Optional[int]    # literal bound, else the file's budget
    launch_bounds: Optional[int]


def _strip_comments(text: str) -> str:
    """Comments blanked out, line structure kept."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def _ctype_kind(decl: str) -> str:
    d = decl.strip()
    if "*" in d or "cudaStream_t" in d:
        return "ptr"
    if "long long" in d or "int64_t" in d or "size_t" in d:
        return "long"
    return "int"


def _split_top(s: str) -> List[str]:
    """Split on commas outside brackets."""
    out, depth, cur = [], 0, ""
    for ch in s:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur)
    return [x.strip() for x in out]


class CudaSource:
    """One `.cu` file: constants, kernels, exports, launches."""

    def __init__(self, rel: str, text: str) -> None:
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.code = _strip_comments(text)
        self.lib = os.path.basename(rel)[:-3]
        self.pragmas: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            for m in _CU_PRAGMA_RE.finditer(line):
                if m.group(2):
                    self.pragmas.setdefault(i, set()).add(m.group(1))
        self.consts: Dict[str, str] = {}
        for m in re.finditer(r"constexpr\s+(?:static\s+)?[\w ]+?\s+(\w+)\s*"
                             r"=\s*([^;]+);", self.code):
            self.consts[m.group(1)] = m.group(2).strip()
        self.kernels: Dict[str, Optional[str]] = {}
        for m in re.finditer(r"__global__\s+void\s*(?:__launch_bounds__\s*"
                             r"\(([^)]*)\))?\s*(\w+)\s*\(", self.code):
            lb = _split_top(m.group(1))[0] if m.group(1) else None
            self.kernels[m.group(2)] = lb

    def line_of(self, pos: int) -> int:
        return self.code.count("\n", 0, pos) + 1

    def pragma_at(self, line: int, kind: str) -> bool:
        if kind in self.pragmas.get(line, ()):
            return True
        above = line - 1
        return above >= 1 and kind in self.pragmas.get(above, ()) \
            and self.lines[above - 1].strip().startswith("//")

    # -- constant evaluation -------------------------------------------
    def value(self, expr: str, depth: int = 0) -> Optional[int]:
        """Integer value of a constant expression, else None."""
        if depth > 12:
            return None
        e = expr.strip()
        e = re.sub(r"\(\s*(?:int|long long|unsigned)\s*\)", "", e)
        e = re.sub(r"(\d+)(?:LL|ll|L|u|U)\b", r"\1", e)
        names = set(re.findall(r"[A-Za-z_]\w*", e))
        for n in names:
            src = self.consts.get(n)
            if src is None:
                return None
            v = self.value(src, depth + 1)
            if v is None:
                return None
            e = re.sub(rf"\b{n}\b", str(v), e)
        if not re.fullmatch(r"[\d\s+\-*/%()<]+", e):
            return None
        try:
            return int(eval(e.replace("/", "//"), {"__builtins__": {}}))
        except Exception:
            return None

    def bound(self, expr: str, body: str) -> Tuple[Optional[int], bool]:
        """(upper bound, multiple of 32) of a block-size expression in
        the function text `body`."""
        v = self.value(expr)
        if v is not None:
            return v, v % 32 == 0
        parts = [p.strip() for p in expr.split("*")]
        if len(parts) == 2:
            for a, b in (parts, parts[::-1]):
                va = self.value(a)
                if va is not None and re.fullmatch(r"\w+", b):
                    bmax = self._local_bound(b, body)
                    return (va * bmax if bmax is not None else None,
                            va % 32 == 0)
        return None, False

    def _local_bound(self, name: str, body: str) -> Optional[int]:
        """Upper bound of a local `name = std::min(...)` (the least
        constant among its arguments)."""
        m = re.search(rf"\b{name}\s*=\s*\(?[\w ]*\)?\s*std::min"
                      rf"(?:<[^>]*>)?\s*\((.*?)\);", body, re.S)
        if m is None:
            return None
        args = _split_top(m.group(1).strip().strip("{}"))
        vals = [self.value(a) for a in args]
        known = [v for v in vals if v is not None]
        return min(known) if known else None

    def smem_budget(self) -> Optional[int]:
        vals = [self.value(v) for k, v in self.consts.items()
                if "Smem" in k or "Bytes" in k]
        known = [v for v in vals if v is not None]
        return max(known) if known else None

    # -- exports -------------------------------------------------------
    def extern_spans(self) -> List[Tuple[int, int]]:
        spans = []
        for m in re.finditer(r'extern\s+"C"\s*\{', self.code):
            depth, i = 1, m.end()
            while i < len(self.code) and depth:
                depth += {"{": 1, "}": -1}.get(self.code[i], 0)
                i += 1
            spans.append((m.end(), i))
        return spans

    def exports(self) -> List[Export]:
        out = []
        for a, b in self.extern_spans():
            seg = self.code[a:b]
            for m in re.finditer(
                    r"(^|[;}\n])\s*([A-Za-z_][\w \*]*?)\s+(\w+)\s*\("
                    r"([^()]*)\)\s*\{", seg):
                ret, name, params = m.group(2), m.group(3), m.group(4)
                if ret.strip() in ("return", "else", "if"):
                    continue
                plist = [p for p in _split_top(params) if p and p != "void"]
                out.append(Export(
                    self.lib, name, self.line_of(a + m.start(3)),
                    [_ctype_kind(p) for p in plist],
                    None if ret.strip() == "void" else _ctype_kind(ret)))
        return out

    # -- launches ------------------------------------------------------
    def _enclosing_body(self, pos: int) -> str:
        """Text of the function around `pos` (from the previous
        top-level `{` at column 0's function header)."""
        start = self.code.rfind("\n}", 0, pos)
        end = self.code.find("\n}", pos)
        return self.code[start if start >= 0 else 0:
                         end if end >= 0 else len(self.code)]

    def launches(self) -> List[Launch]:
        out = []
        budget = self.smem_budget()
        for m in re.finditer(r"(\w+)\s*(?:<[^<>;]*>)?\s*<<<(.*?)>>>",
                             self.code, re.S):
            kernel = m.group(1)
            cfg = _split_top(m.group(2))
            body = self._enclosing_body(m.start())
            block = cfg[1] if len(cfg) > 1 else ""
            smem = cfg[2] if len(cfg) > 2 else "0"
            stream = cfg[3] if len(cfg) > 3 else ""
            bmax, mult = self.bound(block, body)
            sv = self.value(smem)
            lb = self.kernels.get(kernel)
            out.append(Launch(
                self.rel, self.line_of(m.start()), kernel, block, smem,
                stream, bmax, mult, sv if sv is not None else budget,
                self.value(lb) if lb else None))
        return out

    def smem_allowed(self) -> Set[str]:
        """Kernels given the opt-in dynamic shared memory limit."""
        helpers: Set[str] = set()
        allowed: Set[str] = set()
        attr = r"cudaFuncSetAttribute\s*\(\s*([\w<>, ]+?)\s*,\s*" \
               r"cudaFuncAttributeMaxDynamicSharedMemorySize"
        for m in re.finditer(attr, self.code):
            target = m.group(1).split("<")[0].strip()
            if target in self.kernels:
                allowed.add(target)
            else:
                # a helper taking the kernel as a parameter
                head = self.code.rfind("\n", 0, self.code.rfind(
                    "{", 0, m.start()))
                hm = re.search(r"(\w+)\s*\(([^)]*)\)\s*\{",
                               self.code[head:m.start()])
                if hm and re.search(rf"\b{target}\b", hm.group(2)):
                    helpers.add(hm.group(1))
        for h in helpers:
            for m in re.finditer(rf"\b{h}\s*\(\s*(\w+)", self.code):
                allowed.add(m.group(1))
        return allowed


def cuda_sources(pkg: Package) -> List[CudaSource]:
    csrc = os.path.join(pkg.root, pkg.pkg_name, "csrc")
    out = []
    if os.path.isdir(csrc):
        for f in sorted(os.listdir(csrc)):
            if f.endswith(".cu"):
                with open(os.path.join(csrc, f), encoding="utf-8") as fh:
                    out.append(CudaSource(f"{pkg.pkg_name}/csrc/{f}",
                                          fh.read()))
    return out


def launch_inventory(pkg: Package) -> List[Launch]:
    """Every kernel launch of the `.cu` sources, with its resolved
    block bound and its dynamic shared memory bound."""
    return [ln for src in cuda_sources(pkg) for ln in src.launches()]


# -- the Python side -------------------------------------------------------

_CTYPES_KIND = {"c_void_p": "ptr", "c_char_p": "ptr", "c_int": "int",
                "c_int32": "int", "c_uint": "int", "c_bool": "int",
                "c_longlong": "long", "c_int64": "long", "c_long": "long",
                "c_size_t": "long", "c_ulonglong": "long"}


def _kind_of(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Constant) and node.value is None:
        return None
    d = dotted(node) or ""
    leaf = d.split(".")[-1]
    return aliases.get(leaf) or _CTYPES_KIND.get(leaf, "?")


def signature_rows(pkg: Package) -> Dict[str, Tuple[str, List[str],
                                                    Optional[str], int]]:
    """export name -> (lib, arg kinds, return kind, line) from
    ops/cuda.py `_SIGNATURES`."""
    sf = pkg.files.get(_CUDA_REL)
    rows: Dict[str, Tuple[str, List[str], Optional[str], int]] = {}
    if sf is None:
        return rows
    aliases: Dict[str, str] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            leaf = (dotted(node.value) or "").split(".")[-1]
            if leaf in _CTYPES_KIND:
                aliases[node.targets[0].id] = _CTYPES_KIND[leaf]
    for node in sf.tree.body:
        if not (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_SIGNATURES"
                for t in node.targets) and isinstance(node.value, ast.Dict)):
            continue
        for lk, lv in zip(node.value.keys, node.value.values):
            if not (isinstance(lk, ast.Constant) and isinstance(lv, ast.Dict)):
                continue
            for ek, ev in zip(lv.keys, lv.values):
                if not (isinstance(ek, ast.Constant)
                        and isinstance(ev, ast.Tuple) and len(ev.elts) == 2
                        and isinstance(ev.elts[0], ast.List)):
                    continue
                rows[ek.value] = (lk.value,
                                  [_kind_of(e, aliases) or "?"
                                   for e in ev.elts[0].elts],
                                  _kind_of(ev.elts[1], aliases), ek.lineno)
    return rows


def _check_signatures(pkg: Package, out: List[Finding]) -> None:
    rows = signature_rows(pkg)
    sf = pkg.files.get(_CUDA_REL)
    exported: Set[str] = set()
    for src in cuda_sources(pkg):
        for ex in src.exports():
            exported.add(ex.name)

            def emit(code: str, msg: str, ex=ex, src=src) -> None:
                if not src.pragma_at(ex.line, "tile-ok"):
                    out.append(Finding(RULE, src.rel, ex.line, "",
                                       f"abi-signature:{ex.name}:{code}",
                                       msg))
            row = rows.get(ex.name)
            if row is None:
                emit("no-row", f"export {ex.name} has no row in "
                     "ops/cuda.py _SIGNATURES: ctypes would call it with "
                     "int arguments and an int result")
                continue
            lib, args, ret, _ = row
            if lib != src.lib:
                emit("lib", f"{ex.name} is exported by {src.lib}.cu but "
                     f"its row sits under _SIGNATURES[{lib!r}]")
            if len(args) != len(ex.params):
                emit("arity", f"{ex.name} takes {len(ex.params)} "
                     f"arguments; its _SIGNATURES row lists {len(args)}")
            else:
                for i, (a, p) in enumerate(zip(args, ex.params)):
                    if a != p:
                        emit(f"arg{i}", f"{ex.name} argument {i} is a "
                             f"{p} in C but {a} in _SIGNATURES")
            if ret != ex.ret:
                emit("return", f"{ex.name} returns {ex.ret or 'void'} in "
                     f"C but {ret or 'None'} in _SIGNATURES")
    for name, (lib, _a, _r, line) in sorted(rows.items()):
        if name not in exported and sf is not None \
                and not sf.pragma_at(line, "tile-ok"):
            out.append(Finding(RULE, _CUDA_REL, line, "",
                               f"abi-signature:{name}:no-export",
                               f"_SIGNATURES row {name} names no export "
                               f"of csrc/{lib}.cu"))


# pointer-position expressions: .data_ptr(), None, the stream
def _ptr_ok(pkg: Package, fi: FunctionInfo, node: ast.AST,
            depth: int = 0) -> bool:
    if depth > 3:
        return False
    if isinstance(node, ast.Constant):
        return node.value is None
    if isinstance(node, ast.IfExp):
        return _ptr_ok(pkg, fi, node.body, depth) \
            and _ptr_ok(pkg, fi, node.orelse, depth)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "data_ptr":
            return True
        # a helper whose every return is pointer-like
        for q in pkg.resolve_call(fi.rel, fi, node.func, fallback=False):
            rets = [n.value for n in pkg.walk(pkg.functions[q].node)
                    if isinstance(n, ast.Return) and n.value is not None]
            if rets and all(_ptr_ok(pkg, pkg.functions[q], r, depth + 1)
                            for r in rets):
                return True
        return False
    if isinstance(node, ast.Attribute):
        return node.attr == "cuda_stream"
    if isinstance(node, ast.Name):
        if "stream" in node.id:
            return True
        return _name_ptr_ok(pkg, fi, node.id, depth)
    return False


def _name_ptr_ok(pkg: Package, fi: FunctionInfo, name: str,
                 depth: int) -> bool:
    """Every binding of `name` in the function is pointer-like
    (tuple-unpacked from a helper: that position of its returns)."""
    seen = False
    for n in pkg.walk(fi.node):
        if not isinstance(n, ast.Assign):
            continue
        for t in n.targets:
            if isinstance(t, ast.Name) and t.id == name:
                seen = True
                if not _ptr_ok(pkg, fi, n.value, depth + 1):
                    return False
            elif isinstance(t, ast.Tuple) and any(
                    isinstance(e, ast.Name) and e.id == name
                    for e in t.elts):
                i = [isinstance(e, ast.Name) and e.id == name
                     for e in t.elts].index(True)
                seen = True
                if isinstance(n.value, ast.Tuple):
                    if not _ptr_ok(pkg, fi, n.value.elts[i], depth + 1):
                        return False
                    continue
                if not isinstance(n.value, ast.Call):
                    return False
                ok = False
                for q in pkg.resolve_call(fi.rel, fi, n.value.func,
                                          fallback=False):
                    cf = pkg.functions[q]
                    rets = [r.value for r in pkg.walk(cf.node)
                            if isinstance(r, ast.Return)
                            and isinstance(r.value, ast.Tuple)]
                    ok = bool(rets) and all(
                        len(r.elts) > i and _ptr_ok(pkg, cf, r.elts[i],
                                                    depth + 1)
                        for r in rets)
                if not ok:
                    return False
    return seen


def _int_bad(node: ast.AST) -> bool:
    """A pointer (or None) where C takes an integer."""
    if isinstance(node, ast.Constant):
        return node.value is None
    return isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
        and node.func.attr == "data_ptr"


_FACTORIES = {"empty", "zeros", "ones", "full", "arange", "empty_like",
              "zeros_like", "ones_like", "full_like"}


def _settled(pkg: Package, fi: FunctionInfo, name: str) -> bool:
    """The tensor bound to `name` has its dtype and contiguity settled
    in `fi` (or in a checking helper `fi` passes it to, or a helper it
    is unpacked from)."""
    dtype, contig = _settled_flags(pkg, fi, name, 0)
    return dtype and contig


def _made(pkg: Package, fi: FunctionInfo, v: ast.AST) -> Tuple[bool, bool]:
    """(dtype, contiguity) an assigned value settles by construction."""
    dtype = contig = False
    for c in ast.walk(v):
        if isinstance(c, ast.Call):
            leaf = c.func.attr if isinstance(c.func, ast.Attribute) \
                else (dotted(c.func) or "").split(".")[-1]
            if leaf in _FACTORIES and any(kw.arg == "dtype"
                                          for kw in c.keywords):
                return True, True
            if leaf == "contiguous":
                contig = True
            if leaf == "to" and c.args:
                dtype = True
    return dtype, contig


def _settled_flags(pkg: Package, fi: FunctionInfo, name: str,
                   depth: int) -> Tuple[bool, bool]:
    dtype = contig = False
    for n in pkg.walk(fi.node):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                and n.value.id == name:
            if n.attr == "dtype":
                dtype = True
            elif n.attr == "is_contiguous":
                contig = True
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    d, c = _made(pkg, fi, n.value)
                    dtype, contig = dtype or d, contig or c
                elif isinstance(t, ast.Tuple) and any(
                        isinstance(e, ast.Name) and e.id == name
                        for e in t.elts):
                    i = [isinstance(e, ast.Name) and e.id == name
                         for e in t.elts].index(True)
                    if isinstance(n.value, ast.Tuple) \
                            and len(n.value.elts) > i:
                        d, c = _made(pkg, fi, n.value.elts[i])
                        dtype, contig = dtype or d, contig or c
                    elif isinstance(n.value, ast.Call) and depth < 2:
                        for q in pkg.resolve_call(fi.rel, fi, n.value.func,
                                                  fallback=False):
                            cf = pkg.functions[q]
                            for r in pkg.walk(cf.node):
                                if isinstance(r, ast.Return) \
                                        and isinstance(r.value, ast.Tuple) \
                                        and len(r.value.elts) > i:
                                    e = r.value.elts[i]
                                    d, c = (_settled_flags(
                                        pkg, cf, e.id, depth + 1)
                                        if isinstance(e, ast.Name)
                                        else _made(pkg, cf, e))
                                    dtype, contig = dtype or d, contig or c
        if isinstance(n, ast.Call) and depth < 1:
            pos = [i for i, a in enumerate(n.args)
                   if isinstance(a, ast.Name) and a.id == name]
            if pos:
                for q in pkg.resolve_call(fi.rel, fi, n.func,
                                          fallback=False):
                    cf = pkg.functions[q]
                    off = 1 if cf.params[:1] == ["self"] else 0
                    if pos[0] + off < len(cf.params):
                        d, c = _settled_flags(pkg, cf,
                                              cf.params[pos[0] + off],
                                              depth + 1)
                        dtype, contig = dtype or d, contig or c
    return dtype, contig


def _expand(fi: FunctionInfo, args: List[ast.AST]) -> Optional[List[ast.AST]]:
    """Call arguments with `*name` of a local list/tuple literal
    expanded (None when a splat can't be expanded)."""
    lits: Dict[str, List[ast.AST]] = {}
    for n in ast.walk(fi.node):
        if isinstance(n, ast.Assign) and isinstance(n.value, (ast.List,
                                                              ast.Tuple)):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    lits[t.id] = list(n.value.elts)
    out: List[ast.AST] = []
    for a in args:
        if isinstance(a, ast.Starred):
            if isinstance(a.value, ast.Name) and a.value.id in lits:
                out.extend(lits[a.value.id])
            else:
                return None
        else:
            out.append(a)
    return out


def _check_calls(pkg: Package, out: List[Finding]) -> None:
    rows = signature_rows(pkg)
    exported = {ex.name for src in cuda_sources(pkg)
                for ex in src.exports()}
    for q in sorted(pkg.functions):
        fi = pkg.functions[q]
        sf = pkg.files[fi.rel]
        for node in pkg.walk(fi.node):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith("lgbt_")):
                continue
            if pkg.enclosing_function(fi.rel, node) is not fi:
                continue
            name = node.func.attr

            def emit(code: str, msg: str) -> None:
                if not sf.pragma_at(node.lineno, "tile-ok"):
                    out.append(Finding(RULE, fi.rel, node.lineno, q,
                                       f"abi-call:{name}:{code}", msg))
            row = rows.get(name)
            if row is None:
                if name in exported:
                    emit("no-row", f"{name} has no _SIGNATURES row")
                continue            # another library's export
            args = _expand(fi, node.args)
            if args is None:
                continue
            kinds = row[1]
            if len(args) != len(kinds):
                emit("arity", f"{name} called with {len(args)} arguments; "
                     f"its signature takes {len(kinds)}")
                continue
            for i, (a, k) in enumerate(zip(args, kinds)):
                if k == "ptr" and not _ptr_ok(pkg, fi, a):
                    emit(f"arg{i}", f"{name} argument {i} is a pointer: "
                         "pass a tensor's .data_ptr(), None or the stream")
                elif k != "ptr" and _int_bad(a):
                    emit(f"arg{i}", f"{name} argument {i} is an integer "
                         "but a pointer is passed")
                if k == "ptr" and isinstance(a, ast.Call) \
                        and isinstance(a.func, ast.Attribute) \
                        and a.func.attr == "data_ptr" \
                        and isinstance(a.func.value, ast.Name) \
                        and not _settled(pkg, fi, a.func.value.id):
                    emit(f"unchecked:{a.func.value.id}",
                         f"`{a.func.value.id}` reaches {name} without a "
                         "dtype and contiguity check in this function")


def _check_launches(pkg: Package, out: List[Finding]) -> None:
    for src in cuda_sources(pkg):
        allowed = src.smem_allowed()
        for ln in src.launches():
            def emit(code: str, msg: str, ln=ln) -> None:
                if not src.pragma_at(ln.line, "tile-ok"):
                    out.append(Finding(RULE, src.rel, ln.line, "",
                                       f"launch-config:{ln.kernel}:{code}",
                                       msg))
            if ln.block_max is None:
                emit("block-unresolved",
                     f"block size `{ln.block}` of {ln.kernel} does not "
                     "resolve to a bounded constant")
            else:
                if not ln.block_mult32:
                    emit("block-warp", f"block size `{ln.block}` of "
                         f"{ln.kernel} is not a multiple of 32")
                if ln.block_max > _MAX_BLOCK:
                    emit("block-max", f"block size `{ln.block}` of "
                         f"{ln.kernel} can reach {ln.block_max} > 1024")
                if ln.launch_bounds is not None \
                        and ln.block_max > ln.launch_bounds:
                    emit("launch-bounds", f"{ln.kernel} is launched with up "
                         f"to {ln.block_max} threads but declares "
                         f"__launch_bounds__({ln.launch_bounds})")
            sv = src.value(ln.smem)
            if (sv is None or sv > _SMEM_DEFAULT) \
                    and ln.kernel not in allowed:
                emit("smem-optin", f"{ln.kernel} takes dynamic shared "
                     f"memory `{ln.smem}` that may pass 48 KiB without "
                     "cudaFuncSetAttribute(MaxDynamicSharedMemorySize)")
            if not re.fullmatch(r"[A-Za-z_]\w*", ln.stream) or ln.stream in (
                    "cudaStreamLegacy", "cudaStreamPerThread", "nullptr",
                    "NULL") or not re.search(
                        rf"cudaStream_t\s+{re.escape(ln.stream)}\b",
                        src.code):
                emit("stream", f"{ln.kernel} is launched on `{ln.stream or 'the default stream'}`, "
                     "not the stream passed in: it breaks capture and "
                     "stream order")


def _view_dtype(node: ast.AST) -> Optional[str]:
    d = dotted(node) or ""
    leaf = d.split(".")[-1]
    return leaf if leaf in _DTYPE_BITS else None


def _evident_dtype(fi: FunctionInfo, expr: ast.AST, before: int
                   ) -> Optional[str]:
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        if expr.func.attr == "to" and expr.args:
            return _view_dtype(expr.args[0])
        if expr.func.attr in ("contiguous", "clone", "reshape", "flatten"):
            return _evident_dtype(fi, expr.func.value, before)
        if expr.func.attr == "view" and expr.args:
            return _view_dtype(expr.args[0]) or _evident_dtype(
                fi, expr.func.value, before)
    if isinstance(expr, ast.Call):
        for kw in expr.keywords:
            if kw.arg == "dtype":
                return _view_dtype(kw.value)
    if isinstance(expr, ast.Name):
        best: Optional[Tuple[int, Optional[str]]] = None
        for n in ast.walk(fi.node):
            if isinstance(n, ast.Assign) and n.lineno < before and any(
                    isinstance(t, ast.Name) and t.id == expr.id
                    for t in n.targets):
                if best is None or n.lineno > best[0]:
                    best = (n.lineno, _evident_dtype(fi, n.value, n.lineno))
        return best[1] if best else None
    return None


def _check_bitcasts(pkg: Package, out: List[Finding]) -> None:
    for q in sorted(pkg.functions):
        fi = pkg.functions[q]
        sf = pkg.files[fi.rel]
        for node in pkg.walk(fi.node):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "view" and len(node.args) == 1):
                continue
            dst = _view_dtype(node.args[0])
            if dst is None or pkg.enclosing_function(fi.rel, node) is not fi:
                continue
            src = _evident_dtype(fi, node.func.value, node.lineno)
            if src is None or _DTYPE_BITS[src] == _DTYPE_BITS[dst]:
                continue
            if sf.pragma_at(node.lineno, "tile-ok"):
                continue
            out.append(Finding(
                RULE, fi.rel, node.lineno, q, f"bitcast-width:{src}->{dst}",
                f".view({dst}) of a {src} tensor ({_DTYPE_BITS[src]}b -> "
                f"{_DTYPE_BITS[dst]}b) changes the last dimension"))


def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    _check_signatures(pkg, findings)
    _check_calls(pkg, findings)
    _check_launches(pkg, findings)
    _check_bitcasts(pkg, findings)
    return findings
