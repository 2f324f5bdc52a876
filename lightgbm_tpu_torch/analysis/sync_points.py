"""Rule pack: sync-point budget.

Builds an inventory of every host<->device synchronization site in the
package and classifies each as **hot-loop** (reachable from the
per-iteration training roots) or **setup**. The channels:

- explicit: calls of `utils/device.py` `device_get` (a `PendingRead`
  wait included) and of the learners' counting `_read` wrappers around
  it, `block_until_ready`, `torch.cuda.synchronize`,
  `Event.synchronize` / `Stream.synchronize` (`.synchronize()`). The
  channel's own bodies are not sites: the runtime attributes their
  syncs to the calling line, and so does the inventory;
- implicit reads: `.item()`, `.tolist()` and `.cpu()` (always: on the
  port's hot paths they read the card), and on a device value
  `.numpy()`, `int()` / `float()` / `bool()`, `np.asarray` /
  `np.array`;
- data-dependent shapes on a device value: `nonzero` /
  `argwhere` / `unique` / `masked_select`, boolean-mask indexing
  (a subscript by a device comparison);
- uploads: `torch.tensor` / `torch.as_tensor` with a `device=` that is
  not the CPU, `.to(<device>)` of a host value, `.cuda()`. A copy from
  pageable host memory waits for the stream, so CUDA's sync debug mode
  counts it; the runtime cross-check (runtime_check.py) holds every
  site the card reports against this inventory. A `.to(...,
  non_blocking=True)` waits for nothing and is no site: it is how
  `utils/device.py` `upload` copies from pinned memory.

Hot roots: `GBDT.train_one_iter` / `GBDT.eval_at_iter` (plus subclass
overrides) and `engine._telemetry_end_iteration`. Reachability uses the
package call graph, whose unknown-receiver fallback deliberately
over-approximates: a sync wrongly marked hot costs one pragma, one
wrongly marked setup is a silent per-iteration regression.

"Device value" is a local, per-function taint that over-approximates:
parameters annotated `torch.Tensor`, results of `torch.*` calls
without a CPU device, tensor methods of device values, attributes and
subscripts of those, and names assigned from any of those. `np.*`
results, `device_get` and `.cpu()` / `.numpy()` / `.tolist()` /
`.item()` results are host values, and so are the results of package
functions whose every `return` is one (`returns_host`).

Only HOT sites lacking a `# tpulint: sync-ok(<reason>)` pragma become
findings. New hot syncs therefore fail the gate until annotated or
batched.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set

from .core import Finding, FunctionInfo, Package, Pragma, dotted

# qual suffixes of the per-iteration hot roots
_HOT_ROOT_SUFFIXES = (".train_one_iter", ".eval_at_iter")
_HOT_ROOT_FILES = ("lightgbm_tpu_torch/boosting/",
                   "lightgbm_tpu_torch/engine.py")
_HOT_ROOT_EXACT = ("lightgbm_tpu_torch/engine.py::_telemetry_end_iteration",)

# tensor metadata: reading it never touches the card
_META_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
               "layout", "requires_grad", "T"}
_META_METHODS = {"dim", "numel", "size", "element_size", "data_ptr",
                 "is_contiguous", "stride", "get_device", "nelement",
                 "is_floating_point", "storage_offset"}
# calls whose result is host data
_HOST_METHODS = {"cpu", "numpy", "tolist", "item", "device_get", "_read"}
_HOST_BUILTINS = {"int", "float", "bool", "len", "str", "isinstance",
                  "range", "repr", "tuple", "list", "dict", "set",
                  "enumerate", "zip", "min", "max", "sorted", "hash"}
_SHAPE_OPS = {"nonzero", "argwhere", "unique", "unique_consecutive",
              "masked_select"}
_UPLOAD_FACTORIES = {"tensor", "as_tensor"}
# torch calls that return host values (flags, handles, metadata)
_TORCH_HOST_MODULES = ("torch.cuda", "torch.distributed", "torch.backends",
                       "torch.utils", "torch.autograd", "torch.profiler",
                       "torch.multiprocessing", "torch.testing")
_TORCH_HOST_FNS = {"device", "dtype", "finfo", "iinfo", "Size", "Generator",
                   "manual_seed", "set_grad_enabled", "no_grad",
                   "inference_mode", "equal", "numel", "result_type",
                   "promote_types", "can_cast", "get_default_dtype",
                   "set_default_dtype", "get_num_threads", "set_num_threads"}


def torch_path(imps, fd: str) -> Optional[str]:
    """The full torch spelling of a dotted name rooted at a torch alias
    ("dist.all_reduce" -> "torch.distributed.all_reduce"), else None."""
    parts = fd.split(".")
    mod = imps.torch_modules.get(parts[0])
    if mod is None:
        return None
    return ".".join([mod] + parts[1:])


def torch_returns_tensor(imps, fd: str) -> bool:
    """A torch call whose result is (assumed) a tensor."""
    full = torch_path(imps, fd)
    if full is None:
        return False
    leaf = full.split(".")[-1]
    if full.startswith(_TORCH_HOST_MODULES) or leaf in _TORCH_HOST_FNS \
            or leaf.startswith(("is_", "get_", "set_")):
        return False
    return True


def _is_cpu_device(node: ast.AST) -> bool:
    """A literal CPU device: "cpu" or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args \
            and (dotted(node.func) or "").endswith("device"):
        return _is_cpu_device(node.args[0])
    return False


def _device_kw(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _non_blocking(call: ast.Call) -> bool:
    """`non_blocking=True` given literally: the copy does not wait."""
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


@dataclasses.dataclass
class SyncSite:
    rel: str
    line: int
    end: int           # last line of the call (a runtime frame may name it)
    func: str          # enclosing function qual ("" at module level)
    code: str          # stable site descriptor ("device_get", ".item()", ...)
    hot: bool
    pragma: Optional[Pragma]

    @property
    def annotated(self) -> bool:
        return self.pragma is not None


def hot_roots(pkg: Package) -> List[str]:
    roots = [q for q in _HOT_ROOT_EXACT if q in pkg.functions]
    for q in pkg.functions:
        if q.startswith(_HOT_ROOT_FILES) and q.endswith(_HOT_ROOT_SUFFIXES):
            roots.append(q)
    return sorted(set(roots))


def _tensor_annotation(node: Optional[ast.AST]) -> bool:
    d = dotted(node) if node is not None else None
    return d is not None and d.split(".")[-1] == "Tensor"


class _DeviceTaint(ast.NodeVisitor):
    """Names bound to likely-device values inside one function body."""

    def __init__(self, pkg: Package, rel: str,
                 fn_node: Optional[ast.AST] = None,
                 fi: Optional[FunctionInfo] = None) -> None:
        self.pkg = pkg
        self.fi = fi
        self.imps = pkg.imports[rel]
        self.devicey: Set[str] = set()
        self.host: Set[str] = set()
        args = getattr(fn_node, "args", None)
        if args is not None:
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                if _tensor_annotation(a.annotation):
                    self.devicey.add(a.arg)

    def is_host(self, node: ast.AST) -> bool:
        """Provably host data (a numpy result or a read's result)."""
        if isinstance(node, ast.Name):
            return node.id in self.host
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self.is_host(node.value)
        if isinstance(node, ast.BinOp):
            return all(self.is_host(x) or isinstance(x, ast.Constant)
                       for x in (node.left, node.right))
        if isinstance(node, ast.Call):
            fd = dotted(node.func)
            if fd is not None:
                root, leaf = fd.split(".")[0], fd.split(".")[-1]
                if root in self.imps.numpy or leaf in _HOST_METHODS:
                    return True
                if root in self.imps.torch and (
                        leaf == "from_numpy"
                        or (leaf in _UPLOAD_FACTORIES
                            and _device_kw(node) is None)):
                    return True
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_METHODS:
                return True
            if self.fi is not None:
                qs = self.pkg.resolve_call(self.fi.rel, self.fi, node.func,
                                           fallback=False)
                if qs and all(returns_host(self.pkg, q) for q in qs):
                    return True
        if isinstance(node, (ast.List, ast.Tuple, ast.Constant,
                             ast.ListComp)):
            return True
        return False

    def is_devicey(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.devicey
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.is_devicey(node.value)
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return False
            d = dotted(node)
            if d is not None and d in self.devicey:
                return True
            return self.is_devicey(node.value)
        if isinstance(node, ast.Call):
            if self.is_host(node):
                return False
            fd = dotted(node.func)
            if fd is not None:
                root = fd.split(".")[0]
                if len(fd.split(".")) == 1 and root in _HOST_BUILTINS:
                    return False
                if root in self.imps.torch:
                    if not torch_returns_tensor(self.imps, fd):
                        return False
                    dev = _device_kw(node)
                    return dev is None or not _is_cpu_device(dev)
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _META_METHODS:
                    return False
                if attr == "cuda":
                    return True
                if attr == "to":
                    if node.args and _is_cpu_device(node.args[0]):
                        return False
                    if (node.args and not _is_dtype(node.args[0])) \
                            or _device_kw(node) is not None:
                        return True         # .to(<device>)
                if self.is_devicey(node.func.value):
                    return True
            return any(self.is_devicey(a) for a in node.args)
        if isinstance(node, ast.BinOp):
            return self.is_devicey(node.left) or self.is_devicey(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_devicey(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_devicey(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.is_devicey(v)
                       for v in [node.left] + node.comparators)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_devicey(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.is_devicey(node.body) or self.is_devicey(node.orelse)
        return False

    def _bind(self, target: ast.AST, devicey: bool) -> None:
        # bind whole targets only ("x", "leaf.hist"), never the names
        # INSIDE a target: `self.a, b = dev, dev` must not taint `self`.
        # A host-valued rebind KILLS the taint: after
        # `x, y = device_get((x, y))` the names hold host data.
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, devicey)
            return
        if isinstance(target, ast.Starred):
            self._bind(target.value, devicey)
            return
        if isinstance(target, ast.Subscript):
            if devicey:
                self._bind(target.value, devicey)
            return
        d = dotted(target)
        if d is not None:
            if devicey:
                self.devicey.add(d)
            else:
                self.devicey.discard(d)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        dev = self.is_devicey(node.value)
        for t in node.targets:
            self._bind(t, dev)
            if isinstance(t, ast.Name):
                if not dev and self.is_host(node.value):
                    self.host.add(t.id)
                else:
                    self.host.discard(t.id)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._bind(node.target, self.is_devicey(node.value))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if self.is_devicey(node.value):
            self._bind(node.target, True)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        self._bind(node.target, self.is_devicey(node.iter))
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_FunctionDef(self, node):  # nested: separate scope
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef


def returns_host(pkg: Package, qual: str) -> bool:
    """Every `return` of the function yields host data (a read's
    result, numpy, a constant): a one-level summary, memoized."""
    memo = pkg.memo("returns_host", dict)
    if qual in memo:
        return memo[qual]
    memo[qual] = False                   # recursion guard
    fi = pkg.functions[qual]
    taint = _DeviceTaint(pkg, fi.rel, fi.node, fi)
    for stmt in getattr(fi.node, "body", []):
        taint.visit(stmt)
    rets = [n.value for n in pkg.walk(fi.node)
            if isinstance(n, ast.Return) and n.value is not None]
    memo[qual] = bool(rets) and all(taint.is_host(r) for r in rets)
    return memo[qual]


# the counted channel itself: its callers are the sites
_CHANNEL = ("lightgbm_tpu_torch/utils/device.py::device_get",
            "lightgbm_tpu_torch/utils/device.py::block_until_ready")


def _read_wrappers(pkg: Package) -> Set[str]:
    """Quals of the counting read wrappers: functions named `_read`
    that call `device_get` (the runtime attribution skips their frames,
    so their CALLERS are the sites)."""
    out: Set[str] = set()
    for q, fi in pkg.functions.items():
        if fi.name.split(".")[-1] != "_read":
            continue
        for node in pkg.walk(fi.node):
            if isinstance(node, ast.Call) \
                    and (dotted(node.func) or "").endswith("device_get"):
                out.add(q)
                break
    return out


_TRIGGERS = ({"device_get", "block_until_ready", "synchronize", "asarray",
              "array", "float", "int", "bool", "item", "tolist", "cpu",
              "numpy", "cuda", "to", "_read"} | _SHAPE_OPS
             | _UPLOAD_FACTORIES)


def _may_sync(pkg: Package, fi: FunctionInfo) -> bool:
    """A cheap prefilter: the body names a call that can be a site, or
    indexes by a comparison."""
    for n in pkg.walk(fi.node):
        if isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in _TRIGGERS:
                return True
        elif isinstance(n, ast.Subscript) \
                and isinstance(n.slice, (ast.Compare, ast.UnaryOp)):
            return True
    return False


def _sites_in_function(pkg: Package, qual: str, hot: bool,
                       wrappers: Set[str]) -> List[SyncSite]:
    fi = pkg.functions[qual]
    if not _may_sync(pkg, fi):
        return []
    sf = pkg.files[fi.rel]
    imps = pkg.imports[fi.rel]
    taint = _DeviceTaint(pkg, fi.rel, fi.node, fi)
    body = getattr(fi.node, "body", [])
    # two passes: bind device names first (source order suffices for the
    # package's straight-line hot loops), then collect sites
    for stmt in body:
        taint.visit(stmt)
    out: List[SyncSite] = []

    def add(node: ast.AST, code: str) -> None:
        out.append(SyncSite(fi.rel, node.lineno,
                            getattr(node, "end_lineno", node.lineno),
                            qual, code, hot,
                            sf.pragma_at(node.lineno, "sync-ok")))

    class V(ast.NodeVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            self.generic_visit(node)
            fd = dotted(node.func)
            if fd is not None:
                parts = fd.split(".")
                root, leaf = parts[0], parts[-1]
                if leaf == "device_get":
                    add(node, "device_get")
                    return
                if leaf == "block_until_ready":
                    add(node, "block_until_ready")
                    return
                if torch_path(imps, fd) == "torch.cuda.synchronize":
                    add(node, "torch.cuda.synchronize")
                    return
                if root in imps.numpy and leaf in ("asarray", "array") \
                        and node.args and taint.is_devicey(node.args[0]):
                    add(node, f"np.{leaf}")
                    return
                if len(parts) == 1 and leaf in ("float", "int", "bool") \
                        and node.args and taint.is_devicey(node.args[0]):
                    add(node, f"{leaf}()")
                    return
                if torch_path(imps, fd) in {f"torch.{x}" for x in
                                            _SHAPE_OPS | _UPLOAD_FACTORIES}:
                    if leaf in _SHAPE_OPS and node.args \
                            and taint.is_devicey(node.args[0]):
                        add(node, f"torch.{leaf}")
                        return
                    if leaf in _UPLOAD_FACTORIES:
                        dev = _device_kw(node)
                        if dev is not None and not _is_cpu_device(dev) \
                                and not (node.args and taint.is_devicey(
                                    node.args[0])):
                            add(node, f"upload:torch.{leaf}")
                        return
            if not isinstance(node.func, ast.Attribute):
                return
            attr = node.func.attr
            recv = node.func.value
            if attr == "synchronize":
                add(node, ".synchronize()")
            elif attr in ("item", "tolist", "cpu") \
                    and not taint.is_host(recv):
                add(node, f".{attr}()")
            elif attr == "numpy" and taint.is_devicey(recv):
                add(node, ".numpy()")
            elif attr in _SHAPE_OPS and taint.is_devicey(recv):
                add(node, f".{attr}()")
            elif attr == "cuda":
                add(node, "upload:.cuda()")
            elif attr == "to" and taint.is_host(recv) \
                    and not _non_blocking(node) and (
                        _device_kw(node) is not None
                        or (node.args and not _is_dtype(node.args[0]))):
                add(node, "upload:.to()")
            elif wrappers & pkg.resolve_call(fi.rel, fi, node.func):
                add(node, "device_get")

        def visit_Subscript(self, node: ast.Subscript) -> None:
            self.generic_visit(node)
            idx = node.slice
            if isinstance(node.ctx, ast.Load) \
                    and isinstance(idx, (ast.Compare, ast.UnaryOp)) \
                    and taint.is_devicey(idx) \
                    and not isinstance(getattr(idx, "op", None), ast.USub):
                add(node, "mask-index")

        def visit_FunctionDef(self, node):  # nested fns: own qual
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_ClassDef = visit_FunctionDef

    v = V()
    for stmt in body:
        v.visit(stmt)
    return out


def _is_dtype(node: ast.AST) -> bool:
    d = dotted(node)
    return d is not None and (d.split(".")[-1] in (
        "float32", "float64", "float16", "bfloat16", "int8", "int16",
        "int32", "int64", "uint8", "bool", "long", "int", "float",
        "dtype", "double", "acc") or "dtype" in d.split(".")[-1])


def inventory(pkg: Package) -> List[SyncSite]:
    """Every sync site in the package, classified hot vs. setup."""
    return pkg.memo("sync_inventory", lambda: _inventory(pkg))


def _inventory(pkg: Package) -> List[SyncSite]:
    hot = pkg.reachable(hot_roots(pkg))
    wrappers = _read_wrappers(pkg)
    sites: List[SyncSite] = []
    for qual in sorted(pkg.functions):
        if qual in _CHANNEL or qual in wrappers:
            continue        # the runtime attributes these to their callers
        sites.extend(_sites_in_function(pkg, qual, qual in hot, wrappers))
    return sites


def hot_sites(pkg: Package) -> List[SyncSite]:
    return [s for s in inventory(pkg) if s.hot]


def is_trailing_fetch(site: SyncSite) -> bool:
    """A `# tpulint: sync-ok(trailing-fetch: ...)` site: the read
    resolves one pipeline step BEHIND its dispatch (a `start_read`
    handle), so in steady state the value is already on the host and
    the call does not block. Such sites stay in the inventory (and in
    the runtime cross-check) but are excluded from the blocking-sync
    budget."""
    return site.pragma is not None and \
        site.pragma.reason.strip().startswith("trailing-fetch")


def hot_sync_count(pkg: Package) -> int:
    """Hot-loop sites that BLOCK the host: the number the port's bench
    records as `hot_loop_syncs`. Trailing-fetch sites (see
    is_trailing_fetch) are excluded: their readback overlaps the next
    dispatch."""
    return len([s for s in hot_sites(pkg) if not is_trailing_fetch(s)])


def hot_site_lines(pkg: Package) -> Dict[str, Set[int]]:
    """rel -> every line a hot sync site's call spans (for the runtime
    cross-check: a frame inside a multi-line call names one of them)."""
    out: Dict[str, Set[int]] = {}
    for s in hot_sites(pkg):
        out.setdefault(s.rel, set()).update(range(s.line, s.end + 1))
    return out


def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    for s in inventory(pkg):
        if s.hot and not s.annotated:
            findings.append(Finding(
                "sync-point", s.rel, s.line, s.func, s.code,
                f"{s.code} on the hot path (reachable from the training "
                "iteration loop); batch it or annotate "
                "`# tpulint: sync-ok(<reason>)`"))
    return findings
