"""Rule pack: buffer-lifetime (the JAX package's donation half, for
CUDA graphs, streams and pending reads).

A CUDA graph reads and writes the addresses it captured. The port keeps
its captured split step (`treelearner/fused.py` `_replay_steps`)
across trees, so every tensor the graph touches must stay where it
was: written in place (`copy_`, slice assignment, `out=`), never
rebound to a new tensor, unless its address is part of the graph's key
(`_graph_signature` holds `data.data_ptr()`). A rebound buffer leaves
the graph reading freed memory: on the CPU tier nothing shows, on the
card the replays read garbage. And the pipelined loop lets a device ->
host copy (`utils/device.py` `start_read`, a `PendingRead`) trail its
dispatch by a step, which is safe only while someone waits for it.

What is checked
---------------
1. **graph-rebind**: the buffers a kept graph reads are the `self.`
   attributes its captured functions read (capture-safety's reach,
   the capturing class's methods) and the captured call's arguments
   (followed one call level up to a memoized getter, as
   `st = self._tree_state()` returns `self._st`). Such an attribute
   may be assigned only in `__init__`, in a memo (`if self.x is None:
   self.x = ...`, or after `if self.x is not None: return self.x`),
   or set to None in a method that also drops the graph (assigns the
   graph's holder attribute). Any other assignment is a finding,
   unless the key holds the buffer's `data_ptr()`.
2. **escape-checkpoint / escape-flight / escape-telemetry**: device
   values (the sync-point pack's device taint) must not be stored into
   checkpoint state (`checkpoint_state` methods: checkpoints are
   written after the iteration, and must be device-ref-free), flight
   recorder dump payloads, or telemetry gauges / counters. Launder
   through `device_get`, `.cpu()`, `.item()`, `.tolist()`, `int()` /
   `float()` / `bool()` first.
3. **fetch-no-drain / fetch-ckpt-live**: a class that parks
   `start_read` handles on an instance attribute must own a drain (a
   method that resets the attribute), and its `checkpoint_state` must
   reach that drain: a checkpoint must never carry a copy in flight.

The JAX pack's `use-after-donate` is graph-rebind's counterpart; its
`donate-escape-closure` has none (the port donates no buffer).
Suppress with `# tpulint: life-ok(<reason>)` on the offending line or
the line above.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, FunctionInfo, Package, dotted
from .sync_points import _DeviceTaint
from .trace_safety import callees, captured_functions, graph_blocks

RULE = "buffer-lifetime"

# conversions that launder a device value into host data
_LAUNDER_CALLS = {"asarray", "array", "device_get", "int", "float",
                  "bool", "str", "len", "list", "tuple", "dict", "cpu",
                  "item", "tolist", "numpy"}
_CKPT_METHOD_NAMES = ("checkpoint_state",)
_FLIGHT_DUMP_ATTR = "dump"
_TELEMETRY_CALLS = ("set_gauge", "inc", "observe", "add_time",
                    "observe_latency")
_FETCH_STARTERS = ("start_read",)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


# -- rule 1: graph-rebind -------------------------------------------------

def _memo_getter_attr(fi: FunctionInfo) -> Optional[str]:
    """`x` when every return of the method is `self.x` (a getter)."""
    rets = [n.value for n in ast.walk(fi.node) if isinstance(n, ast.Return)]
    attrs = {_self_attr(r) for r in rets if r is not None}
    if len(attrs) == 1 and None not in attrs and len(rets) >= 1:
        return attrs.pop()
    return None


def graph_buffers(pkg: Package) -> Dict[Tuple[str, str], Dict[str, object]]:
    """(rel, class) -> {"attrs": buffer attrs, "holders": graph holder
    attrs, "key_ptrs": names whose data_ptr() the key holds, "site":
    capture line} for every class that captures a graph."""
    captured = captured_functions(pkg)
    out: Dict[Tuple[str, str], Dict[str, object]] = {}
    for rel, block, caller in graph_blocks(pkg):
        if caller is None or caller.cls is None:
            continue
        cls = caller.cls
        info = out.setdefault((rel, cls), {"attrs": set(), "holders": set(),
                                           "key_ptrs": set(),
                                           "site": block.lineno})
        attrs: Set[str] = info["attrs"]          # type: ignore[assignment]
        methods = {fi.name: fi for fi in pkg.functions.values()
                   if fi.rel == rel and fi.cls == cls and "." not in fi.name}
        # self attributes the captured methods read
        for q in captured:
            fi = pkg.functions[q]
            if fi.rel != rel or fi.cls != cls:
                continue
            for n in pkg.walk(fi.node):
                a = _self_attr(n)
                if a is not None and isinstance(n.ctx, ast.Load) \
                        and a not in methods:
                    attrs.add(a)
        # the captured call's arguments, one call level up
        params = set(caller.params)
        arg_names: Set[str] = set()
        for stmt in block.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    for a in list(n.args) + [k.value for k in n.keywords]:
                        for sub in ast.walk(a):
                            if isinstance(sub, ast.Name):
                                arg_names.add(sub.id)
                            sa = _self_attr(sub)
                            if sa is not None:
                                attrs.add(sa)
        for fi in methods.values():
            for n in pkg.walk(fi.node):
                if not isinstance(n, ast.Call) or caller.qual not in \
                        callees(pkg, fi, n):
                    continue
                for i, a in enumerate(n.args):
                    pi = i + 1           # self
                    if pi < len(caller.params) \
                            and caller.params[pi] in arg_names & params \
                            and isinstance(a, ast.Name):
                        attrs |= _origin_attrs(pkg, fi, a.id)
        # the graph's holders: attributes the capturing method assigns
        for n in pkg.walk(caller.node):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    a = _self_attr(t)
                    if a is not None:
                        info["holders"].add(a)   # type: ignore[union-attr]
        # names whose address the key holds
        for fi in methods.values():
            if fi.name.endswith("_signature"):
                for n in pkg.walk(fi.node):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and n.func.attr == "data_ptr" \
                            and isinstance(n.func.value, ast.Name):
                        info["key_ptrs"].add(  # type: ignore[union-attr]
                            n.func.value.id)
        attrs -= info["holders"]                 # type: ignore[operator]
    return out


def _origin_attrs(pkg: Package, fi: FunctionInfo, name: str) -> Set[str]:
    """Attributes a local `name` of `fi` is bound to: `self.x`, or a
    memo getter's `self.x`."""
    out: Set[str] = set()
    for n in pkg.walk(fi.node):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in n.targets):
            a = _self_attr(n.value)
            if a is not None:
                out.add(a)
            elif isinstance(n.value, ast.Call):
                for q in callees(pkg, fi, n.value):
                    g = _memo_getter_attr(pkg.functions[q])
                    if g is not None:
                        out.add(g)
    return out


def _memo_guarded(fi: FunctionInfo, attr: str, node: ast.AST) -> bool:
    """`node` (an assignment of self.attr) sits under
    `if self.attr is None:`, or follows `if self.attr is not None:
    return ...` in the same function."""
    def tests_none(test: ast.AST, op) -> bool:
        return isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.ops[0], op) \
            and _self_attr(test.left) == attr \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None
    for n in ast.walk(fi.node):
        if isinstance(n, ast.If):
            if tests_none(n.test, ast.Is) and any(
                    node is s for b in n.body for s in ast.walk(b)):
                return True
            if tests_none(n.test, ast.IsNot) and n.body \
                    and isinstance(n.body[-1], ast.Return) \
                    and n.lineno < node.lineno:
                return True
    return False


def _check_graph_rebind(pkg: Package, findings: List[Finding]) -> None:
    for (rel, cls), info in sorted(graph_buffers(pkg).items()):
        attrs: Set[str] = info["attrs"]          # type: ignore[assignment]
        holders: Set[str] = info["holders"]      # type: ignore[assignment]
        keyed: Set[str] = info["key_ptrs"]       # type: ignore[assignment]
        sf = pkg.files[rel]
        for fi in pkg.functions.values():
            if fi.rel != rel or fi.cls != cls \
                    or fi.name.split(".")[0] == "__init__":
                continue
            drops_graph = any(
                isinstance(n, ast.Assign) and any(
                    _self_attr(t) in holders for t in n.targets)
                and isinstance(n.value, ast.Constant) and n.value.value is None
                for n in pkg.walk(fi.node))
            for n in pkg.walk(fi.node):
                if not isinstance(n, (ast.Assign, ast.AugAssign,
                                      ast.AnnAssign)):
                    continue
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                        a = _self_attr(e)
                        if a is None or a not in attrs or a in keyed:
                            continue
                        if isinstance(n, ast.AugAssign):
                            continue     # in place (+= on a tensor)
                        v = n.value
                        if isinstance(v, ast.Constant) and v.value is None \
                                and drops_graph:
                            continue
                        if _memo_guarded(fi, a, n):
                            continue
                        if sf.pragma_at(n.lineno, "life-ok"):
                            continue
                        findings.append(Finding(
                            RULE, rel, n.lineno, fi.qual,
                            f"graph-rebind:{cls}.{a}",
                            f"`self.{a}` is read by the captured graph "
                            f"(captured at line {info['site']}) but is "
                            "rebound here: the replays keep reading the "
                            "old address. Write it in place (copy_, "
                            "slice assignment, out=), drop the graph with "
                            "it, or put its data_ptr() in the key"))


# -- rule 2: device refs escaping into durable payloads -------------------

def _devicey_unlaundered(taint: _DeviceTaint, node: ast.AST) -> bool:
    """Device value NOT passed through a laundering conversion."""
    if isinstance(node, ast.Call):
        fd = dotted(node.func)
        leaf = fd.split(".")[-1] if fd else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        if leaf in _LAUNDER_CALLS:
            return False
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_devicey_unlaundered(taint, e) for e in node.elts)
    if isinstance(node, ast.Dict):
        return any(_devicey_unlaundered(taint, v)
                   for v in node.values if v is not None)
    if isinstance(node, ast.ListComp):
        return _devicey_unlaundered(taint, node.elt)
    return taint.is_devicey(node)


def _check_escapes(pkg: Package, fi: FunctionInfo,
                   findings: List[Finding]) -> None:
    is_ckpt = fi.name.split(".")[-1] in _CKPT_METHOD_NAMES
    if not is_ckpt and not any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in _TELEMETRY_CALLS + (_FLIGHT_DUMP_ATTR,)
            for n in pkg.walk(fi.node)):
        return
    sf = pkg.files[fi.rel]
    taint = _DeviceTaint(pkg, fi.rel, fi.node)
    for stmt in getattr(fi.node, "body", []):
        taint.visit(stmt)

    def flag(node: ast.AST, code: str, msg: str) -> None:
        if sf.pragma_at(node.lineno, "life-ok"):
            return
        findings.append(Finding(RULE, fi.rel, node.lineno, fi.qual,
                                code, msg))

    for node in pkg.walk(fi.node):
        if is_ckpt:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) \
                            and _devicey_unlaundered(taint, node.value):
                        flag(node, "escape-checkpoint",
                             "device value stored into checkpoint state "
                             "— checkpoints must be device-ref-free "
                             "(device_get / .cpu() first)")
            if isinstance(node, ast.Dict):
                for v in node.values:
                    if v is not None and _devicey_unlaundered(taint, v):
                        flag(v, "escape-checkpoint",
                             "device value in a checkpoint_state payload "
                             "— checkpoints must be device-ref-free")
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        if attr == _FLIGHT_DUMP_ATTR and len(node.args) >= 2 \
                and _devicey_unlaundered(taint, node.args[1]):
            flag(node, "escape-flight",
                 "device value in a flight-recorder dump payload — the "
                 "bundle serializes after the iteration; convert to host "
                 "data first")
        elif attr in _TELEMETRY_CALLS and len(node.args) >= 2 \
                and _devicey_unlaundered(taint, node.args[1]):
            flag(node, "escape-telemetry",
                 f"device value passed to {attr}() — telemetry payloads "
                 "outlive the iteration that produced them; convert with "
                 "float() / .item() first")


# -- rule 3: pending-read drains -------------------------------------------

def _pending_fetch_attrs(pkg: Package, methods: List[str]
                         ) -> Dict[str, int]:
    """attr -> first store line, for attrs holding start_read handles."""
    out: Dict[str, int] = {}
    for q in methods:
        fi = pkg.functions[q]
        refs: Set[str] = set()

        def starts(node: ast.AST) -> bool:
            return any(isinstance(n, ast.Call)
                       and (dotted(n.func) or "").split(".")[-1]
                       in _FETCH_STARTERS for n in ast.walk(node))

        def mentions(node: ast.AST) -> bool:
            return starts(node) or any(
                isinstance(n, ast.Name) and n.id in refs
                for n in ast.walk(node))
        for node in pkg.walk(fi.node):
            if isinstance(node, ast.Assign) and starts(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        refs.add(t.id)
        for node in pkg.walk(fi.node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("append", "add", "extend"):
                a = _self_attr(node.func.value)
                if a is not None and any(mentions(x) for x in node.args):
                    out.setdefault(a, node.lineno)
            elif isinstance(node, ast.Assign) and mentions(node.value):
                for t in node.targets:
                    a = _self_attr(t)
                    if a is not None:
                        out.setdefault(a, node.lineno)
    return out


def _resets_attr(pkg: Package, qual: str, attr: str) -> bool:
    fi = pkg.functions[qual]
    for node in pkg.walk(fi.node):
        if isinstance(node, ast.Assign) and \
                any(_self_attr(t) == attr for t in node.targets):
            return True
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "clear" \
                and _self_attr(node.func.value) == attr:
            return True
    return False


def _check_fetch_drains(pkg: Package, findings: List[Finding]) -> None:
    classes: Dict[Tuple[str, str], List[str]] = {}
    for qual, fi in pkg.functions.items():
        if fi.cls is not None and "." not in fi.name:
            classes.setdefault((fi.rel, fi.cls), []).append(qual)
    for (rel, cls), methods in sorted(classes.items()):
        pending = _pending_fetch_attrs(pkg, sorted(methods))
        if not pending:
            continue
        sf = pkg.files[rel]
        for attr, line in sorted(pending.items()):
            if sf.pragma_at(line, "life-ok"):
                continue
            fetchers = {m for m in methods
                        if attr in _pending_fetch_attrs(pkg, [m])}
            drains = [q for q in methods
                      if not q.endswith("__init__") and q not in fetchers
                      and _resets_attr(pkg, q, attr)]
            if not drains:
                findings.append(Finding(
                    RULE, rel, line, "", f"fetch-no-drain:{cls}.{attr}",
                    f"`self.{attr}` parks start_read handles but no "
                    f"method of {cls} ever drains it — a copy in flight "
                    "needs a drain on the finish/checkpoint paths"))
                continue
            for cq in [q for q in methods
                       if pkg.functions[q].name in _CKPT_METHOD_NAMES]:
                reach = pkg.reachable([cq])
                if not any(d in reach for d in drains):
                    findings.append(Finding(
                        RULE, rel, pkg.functions[cq].lineno, cq,
                        f"fetch-ckpt-live:{cls}.{attr}",
                        f"{cls}.checkpoint_state does not drain the "
                        f"pending reads in `self.{attr}` — a checkpoint "
                        "must not carry a copy in flight"))


# -- pack entry point -----------------------------------------------------

def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    _check_graph_rebind(pkg, findings)
    for qual in sorted(pkg.functions):
        fi = pkg.functions[qual]
        if "." in fi.name:
            continue        # nested functions are scanned with their parent
        _check_escapes(pkg, fi, findings)
    _check_fetch_drains(pkg, findings)
    seen: Set[Tuple[str, int, str]] = set()
    out: List[Finding] = []
    for f in findings:
        k = (f.path, f.line, f.code)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out
