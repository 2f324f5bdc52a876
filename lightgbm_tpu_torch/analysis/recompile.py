"""Rule pack: recompile-hazard.

The port compiles twice: nvcc builds the kernels' libraries
(`ops/cuda.py`, named by a hash of sources, headers and flags) and a
CUDA graph captures the split step (`treelearner/fused.py`
`_replay_steps`, keyed by `_graph_signature`). Each sub-rule keeps one
of them honest:

1. **build-unmanaged**: `ctypes.CDLL` / `LoadLibrary`, an `nvcc`
   command, `torch.utils.cpp_extension` or `torch.compile` outside
   `ops/cuda.py`. Such a build dodges the build counters and the hashed
   library names (a stale library would be loaded). `# tpulint:
   build-ok(<reason>)` where a build is deliberate (the host binning
   library of `native/`).
2. **capture-unmanaged**: a `torch.cuda.graph` / `CUDAGraph` /
   `make_graphed_callables` in a function that does not count
   `graph_captures` (`compile/manager.count`).
3. **graph-key**: a learner attribute or config field read as a host
   value inside the captured region (capture-safety's reach, the
   capturing class's own methods) that is neither in the graph's key
   (read in the class's `*_signature` method) nor fixed at the
   learner's construction (assigned only in `__init__`). Such a value
   is baked into every replay. Also the JAX package's check of
   `compile/signature.py` `_IGNORED_CONFIG_FIELDS`: every entry must
   name a Config field (`stale-ignored`).
4. **build-key**: every header a `csrc/*.cu` source includes must be
   hashed into the library's name by `ops/cuda.py` `_lib_path`, or an
   edit of it reuses a stale library.

The JAX package's `switch-ladder` has no counterpart: the port has no
capacity ladder. `# tpulint: graph-ok(<reason>)` suppresses 2 and 3.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set

from .core import Finding, FunctionInfo, Package, dotted
from .sync_points import torch_path
from .trace_safety import captured_functions, graph_blocks

RULE = "recompile-hazard"
_MANAGED = "lightgbm_tpu_torch/ops/cuda.py"
_SIGNATURE_REL = "lightgbm_tpu_torch/compile/signature.py"
_CONFIG_REL = "lightgbm_tpu_torch/config.py"
_GRAPH_CTORS = ("torch.cuda.graph", "torch.cuda.CUDAGraph",
                "torch.cuda.make_graphed_callables")
_INCLUDE_RE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _finding(pkg, rel, node, code, msg) -> Finding:
    fi = pkg.enclosing_function(rel, node)
    return Finding(RULE, rel, node.lineno, fi.qual if fi else "", code, msg)


def _build_call(pkg: Package, rel: str, node: ast.Call) -> Optional[str]:
    """The build this call performs, or None."""
    fd = dotted(node.func) or ""
    leaf = fd.split(".")[-1]
    if leaf in ("CDLL", "LoadLibrary"):
        return leaf
    full = torch_path(pkg.imports[rel], fd) if fd else None
    if full is not None and (full.startswith("torch.utils.cpp_extension")
                             or full == "torch.compile"):
        return full
    if leaf in ("Popen", "run", "call", "check_call", "check_output") \
            and node.args:
        for n in ast.walk(node.args[0]):
            if (isinstance(n, ast.Constant) and n.value == "nvcc") or (
                    isinstance(n, ast.Call)
                    and (dotted(n.func) or "").endswith("nvcc")):
                return "nvcc"
    return None


def _check_builds(pkg: Package, out: List[Finding]) -> None:
    for rel in sorted(pkg.files):
        if rel == _MANAGED:
            continue
        sf = pkg.files[rel]
        for node in pkg.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _build_call(pkg, rel, node)
            if kind is None or sf.pragma_at(node.lineno, "build-ok"):
                continue
            out.append(_finding(
                pkg, rel, node, f"build-unmanaged:{kind}",
                f"{kind} outside ops/cuda.py dodges the build counters "
                "and the hashed library names; build through ops/cuda.py "
                "or annotate `# tpulint: build-ok(<reason>)`"))


def _counts_captures(fi: FunctionInfo) -> bool:
    for n in ast.walk(fi.node):
        if isinstance(n, ast.Call) and n.args \
                and isinstance(n.args[0], ast.Constant) \
                and n.args[0].value == "graph_captures":
            return True
    return False


def _check_captures(pkg: Package, out: List[Finding]) -> None:
    for rel in sorted(pkg.files):
        sf = pkg.files[rel]
        for node in pkg.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fd = dotted(node.func) or ""
            full = torch_path(pkg.imports[rel], fd) if fd else None
            if full not in _GRAPH_CTORS:
                continue
            fi = pkg.enclosing_function(rel, node)
            if fi is not None and _counts_captures(fi):
                continue
            if sf.pragma_at(node.lineno, "graph-ok"):
                continue
            out.append(_finding(
                pkg, rel, node, "capture-unmanaged",
                f"{full} in a function that does not count "
                "`graph_captures`: an uncounted capture hides "
                "re-captures; count it through compile/manager or "
                "annotate `# tpulint: graph-ok(<reason>)`"))


def _self_reads(fi: FunctionInfo) -> List[ast.Attribute]:
    """`self.<a>` and `self.config.<a>` loads in one function body."""
    out = []
    for n in ast.walk(fi.node):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
            v = n.value
            if isinstance(v, ast.Name) and v.id == "self":
                out.append(n)
            elif isinstance(v, ast.Attribute) and v.attr in ("config",
                                                              "cfg") \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id == "self":
                out.append(n)
    return out


def _attr_name(n: ast.Attribute) -> str:
    return ("config." if isinstance(n.value, ast.Attribute) else "") + n.attr


def _class_info(pkg: Package, rel: str, cls: str):
    """(methods by name, class-level names, attr -> assigning methods)."""
    methods: Dict[str, FunctionInfo] = {}
    for q, fi in pkg.functions.items():
        if fi.rel == rel and fi.cls == cls and "." not in fi.name:
            methods[fi.name] = fi
    class_names: Set[str] = set()
    for node in pkg.walk(pkg.files[rel].tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for stmt in node.body:
                for t in getattr(stmt, "targets", []):
                    if isinstance(t, ast.Name):
                        class_names.add(t.id)
    assigns: Dict[str, Set[str]] = {}
    for q, fi in pkg.functions.items():
        if fi.rel != rel or fi.cls != cls:
            continue
        for n in pkg.walk(fi.node):
            targets = []
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Attribute) \
                            and isinstance(e.value, ast.Name) \
                            and e.value.id == "self":
                        assigns.setdefault(e.attr, set()).add(
                            fi.name.split(".")[0])
    return methods, class_names, assigns


def _check_graph_key(pkg: Package, out: List[Finding]) -> None:
    captured = captured_functions(pkg)
    for rel, block, caller in graph_blocks(pkg):
        if caller is None or caller.cls is None:
            continue
        methods, class_names, assigns = _class_info(pkg, rel, caller.cls)
        key: Set[str] = set()
        for name, fi in methods.items():
            if name.endswith("_signature"):
                key |= {_attr_name(n) for n in _self_reads(fi)}
        sf = pkg.files[rel]
        seen: Set[tuple] = set()
        for q in sorted(captured):
            fi = pkg.functions[q]
            if fi.rel != rel or fi.cls != caller.cls:
                continue
            for n in _self_reads(fi):
                name = _attr_name(n)
                if name.startswith("config."):
                    fixed = assigns.get("config", set()) <= {"__init__"}
                    # the config object is the construction's; a field
                    # the key leaves out is baked in unless the
                    # learner never sees another config
                    if name in key or (fixed and not _config_mutated(
                            pkg, n.attr)):
                        continue
                else:
                    if n.attr in methods or n.attr in class_names \
                            or name in key:
                        continue
                    if assigns.get(n.attr, set()) <= {"__init__"}:
                        continue
                    if _is_tensor_attr(pkg, rel, caller.cls, n.attr):
                        continue     # read by address: buffer-lifetime
                if (fi.qual, name) in seen:
                    continue
                seen.add((fi.qual, name))
                if sf.pragma_at(n.lineno, "graph-ok"):
                    continue
                out.append(Finding(
                    RULE, rel, n.lineno, fi.qual, f"graph-key:{name}",
                    f"`self.{name}` is read on the host inside the "
                    "captured split step but is neither in the graph's "
                    "key nor fixed at construction: a change replays a "
                    "stale graph. Add it to the key or annotate "
                    "`# tpulint: graph-ok(<reason>)`"))


_TENSOR_FACTORIES = {"zeros", "ones", "full", "empty", "as_tensor",
                     "tensor", "arange", "zeros_like", "full_like",
                     "empty_like", "stack", "cat"}


def _is_tensor_attr(pkg: Package, rel: str, cls: str, attr: str) -> bool:
    """Every assignment of `self.<attr>` in the class is a torch
    factory (or None): a device buffer, not a host value."""
    imps = pkg.imports[rel]
    seen = False
    for fi in pkg.functions.values():
        if fi.rel != rel or fi.cls != cls:
            continue
        for n in pkg.walk(fi.node):
            if not isinstance(n, ast.Assign):
                continue
            for t in n.targets:
                if not (isinstance(t, ast.Attribute) and t.attr == attr
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                v = n.value
                if isinstance(v, ast.Constant) and v.value is None:
                    continue
                fd = dotted(v.func) if isinstance(v, ast.Call) else None
                full = torch_path(imps, fd) if fd else None
                if full is None or full.split(".")[-1] \
                        not in _TENSOR_FACTORIES:
                    return False
                seen = True
    return seen


def _config_mutated(pkg: Package, field: str) -> bool:
    """Any `<x>.config.<field> = ...` / `cfg.<field> = ...` in the
    package (a config changed in place after construction)."""
    return field in pkg.memo("config_mutated", lambda: _mutated(pkg))


def _mutated(pkg: Package) -> Set[str]:
    names: Set[str] = set()
    for sf in pkg.files.values():
        for n in pkg.walk(sf.tree):
            if not isinstance(n, (ast.Assign, ast.AugAssign)):
                continue
            for t in (n.targets if isinstance(n, ast.Assign)
                      else [n.target]):
                if isinstance(t, ast.Attribute) and (
                        (isinstance(t.value, ast.Attribute)
                         and t.value.attr in ("config", "cfg"))
                        or (isinstance(t.value, ast.Name)
                            and t.value.id in ("config", "cfg"))):
                    names.add(t.attr)
    return names


def _config_fields(pkg: Package) -> Set[str]:
    sf = pkg.files.get(_CONFIG_REL)
    fields: Set[str] = set()
    if sf is None:
        return fields
    for node in pkg.walk(sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    fields.add(stmt.target.id)
    return fields


def _check_ignored(pkg: Package, out: List[Finding]) -> None:
    sf = pkg.files.get(_SIGNATURE_REL)
    if sf is None:
        return
    fields = _config_fields(pkg)
    for node in pkg.walk(sf.tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_IGNORED_CONFIG_FIELDS"
                for t in node.targets):
            vals = {n.value for n in ast.walk(node.value)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
            for stale in sorted(vals - fields):
                out.append(Finding(
                    RULE, _SIGNATURE_REL, node.lineno, "",
                    f"stale-ignored:{stale}",
                    f"_IGNORED_CONFIG_FIELDS entry '{stale}' is not a "
                    "Config field; remove it"))


def hashed_headers(pkg: Package) -> Optional[Set[str]]:
    """Header names `_lib_path` hashes into a library's name: every
    file of `csrc/` with one of the suffixes its `endswith` test names
    (None when `_lib_path` is missing or takes no such test)."""
    fi = pkg.functions.get(f"{_MANAGED}::_lib_path")
    if fi is None:
        return None
    suffixes: Set[str] = set()
    for n in pkg.walk(fi.node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "endswith" and n.args:
            suffixes |= {c.value for c in ast.walk(n.args[0])
                         if isinstance(c, ast.Constant)
                         and isinstance(c.value, str)}
    if not suffixes:
        return None
    csrc = os.path.join(pkg.root, pkg.pkg_name, "csrc")
    if not os.path.isdir(csrc):
        return set()
    return {f for f in os.listdir(csrc) if f.endswith(tuple(suffixes))}


def _check_build_key(pkg: Package, out: List[Finding]) -> None:
    csrc = os.path.join(pkg.root, pkg.pkg_name, "csrc")
    if not os.path.isdir(csrc):
        return
    hashed = hashed_headers(pkg)
    if hashed is None:
        return
    for fname in sorted(os.listdir(csrc)):
        if not fname.endswith(".cu"):
            continue
        with open(os.path.join(csrc, fname), encoding="utf-8") as fh:
            text = fh.read()
        for m in _INCLUDE_RE.finditer(text):
            header = m.group(1)
            if header in hashed:
                continue
            line = text.count("\n", 0, m.start()) + 1
            out.append(Finding(
                RULE, f"{pkg.pkg_name}/csrc/{fname}", line, "",
                f"build-key:{header}",
                f"{fname} includes \"{header}\", which ops/cuda.py "
                "_lib_path does not hash into the library's name: an "
                "edit of the header would load a stale library"))


def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    _check_builds(pkg, findings)
    _check_captures(pkg, findings)
    _check_graph_key(pkg, findings)
    _check_ignored(pkg, findings)
    _check_build_key(pkg, findings)
    return findings
