"""Rule pack: thread-shared-state (threading half of the lifetime packs).

The port runs real concurrency: the watchdog deadman
(`robust/watchdog.py`), the background nvcc warm-up
(`compile/warmup.py`, thread `lgbm-cuda-warmup`), the observability
HTTP server (`obs/httpd.ObsServer`, its `do_GET` on per-request
threads) and the bring-up barrier (`network.py`,
`lgbm-startup-barrier`). locks.py checks that attributes mutated under
a class's lock are never mutated outside it, but says nothing about
classes whose methods RUN on more than one thread without any lock at
all. Same semantics as the JAX package's pack.

This pack closes that gap with thread-reachability:

1. **spawn inventory** — every `threading.Thread(target=...)` site,
   every `ThreadPoolExecutor` `.map`/`.submit` dispatch, and HTTP
   handler `do_*` methods (they run on the server's per-request
   threads). The inventory (`spawn_inventory`) also feeds the runtime
   shadow-check: live `lgbm-*` thread names must be a subset of the
   statically declared ones.
2. **shared-attr discipline** — close over the call graph from the
   spawn roots. A method reachable from a spawn site runs off the
   main thread, so for each class: a mutation of an instance
   attribute in a thread-reachable method, or a mutation anywhere of
   an attribute that a thread-reachable method also touches, must
   happen under a `with self.<lock>` — or carry a pragma.

   The closure deliberately does NOT use the package call graph's
   over-approximating simple-name fallback: `manifest.update(...)`
   (a dict) would match `MonotoneState.update` and drag the entire
   single-threaded learner stack into "thread-reachable", burying the
   real concurrency surface under hundreds of false findings. The
   thread graph follows confident resolutions plus a restricted
   fallback: unknown-receiver method calls match only instance
   methods (`def f(self, ...)` inside a class), never names that are
   also builtin container/str/sync-primitive/file verbs, and never
   receivers bound by a non-package import (`json.dump` is not the
   flight recorder's dump).

Exemptions: `__init__` (the object is not shared yet), attributes that
ARE synchronization primitives (`threading.Event` / `Lock` / queues —
self-synchronized by contract), and `# tpulint: thread-ok(<reason>)`
on the mutation line, the line above, or the `class` line (class-level
suppression, for types like the metrics registry whose whole contract
is GIL-atomic single-op writes).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, FunctionInfo, Package, dotted
from .locks import (_MethodScanner, _Mutation, _class_methods,
                    _lock_attrs, _self_attr)

RULE = "thread-shared-state"

# attribute types that synchronize themselves: assigning/mutating them
# without the class lock is the normal pattern
_SELF_SYNC_CTORS = {"Lock", "RLock", "Event", "Condition", "Semaphore",
                    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
                    "LifoQueue", "PriorityQueue"}

# HTTP handler entry points: run on the server's per-request threads
_HANDLER_METHODS = ("do_GET", "do_POST", "do_HEAD", "handle",
                    "log_message")
_HANDLER_BASES = ("BaseHTTPRequestHandler", "SimpleHTTPRequestHandler")

# Attribute names the thread call graph never follows by simple-name
# fallback: verbs of builtin containers/str plus sync-primitive,
# executor, queue, and file-object methods. `d.update(x)` must not
# reach every package method named `update`. Deliberately NOT listed:
# `write` (the jsonl sink is genuinely written from worker threads
# through untyped receivers) and `acquire` (the warmup pool reaches
# the compile manager only through `mgr.acquire`).
_GENERIC_ATTRS = (frozenset(dir(dict)) | frozenset(dir(list))
                  | frozenset(dir(set)) | frozenset(dir(str))
                  | frozenset(dir(tuple)) | frozenset(dir(bytes))
                  | frozenset({
                      "wait", "notify", "notify_all", "is_set", "locked",
                      "release", "start", "submit", "map", "shutdown",
                      "result", "cancel", "done", "add_done_callback",
                      "put", "put_nowait", "get_nowait", "task_done",
                      "qsize", "empty", "full",
                      "close", "flush", "seek", "tell", "read",
                      "readline", "readlines", "writelines", "truncate",
                      "fileno",
                  }))


@dataclasses.dataclass
class SpawnSite:
    """One statically-discovered thread creation."""
    rel: str
    line: int
    func: str                  # enclosing function qual
    kind: str                  # "thread" | "pool" | "handler"
    name: str                  # literal name= kwarg ("" when absent)
    roots: Tuple[str, ...]     # resolved in-package target quals


def _thread_name(call: ast.Call) -> str:
    for kw in call.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return ""


def _resolve_target(pkg: Package, rel: str, caller: Optional[FunctionInfo],
                    target: ast.AST) -> Set[str]:
    """Quals a thread-target expression can run: a function reference
    resolves directly; a lambda contributes every call in its body."""
    if isinstance(target, ast.Lambda):
        out: Set[str] = set()
        for node in ast.walk(target.body):
            if isinstance(node, ast.Call):
                out |= pkg.resolve_call(rel, caller, node.func)
        return out
    return pkg.resolve_call(rel, caller, target)


def spawn_inventory(pkg: Package) -> List[SpawnSite]:
    """Every thread-spawn site in the package."""
    sites: List[SpawnSite] = []
    for qual in sorted(pkg.functions):
        fi = pkg.functions[qual]
        if "." in fi.name:
            continue           # nested fns walk with their parent
        # names bound from ThreadPoolExecutor(...) in this function
        pools: Set[str] = set()
        for node in pkg.walk(fi.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    c = item.context_expr
                    if isinstance(c, ast.Call):
                        fd = dotted(c.func) or ""
                        if fd.split(".")[-1] == "ThreadPoolExecutor" \
                                and isinstance(item.optional_vars,
                                               ast.Name):
                            pools.add(item.optional_vars.id)
            if not isinstance(node, ast.Call):
                continue
            fd = dotted(node.func) or ""
            leaf = fd.split(".")[-1]
            if leaf == "Thread":
                target = next((kw.value for kw in node.keywords
                               if kw.arg == "target"), None)
                roots = _resolve_target(pkg, fi.rel, fi, target) \
                    if target is not None else set()
                sites.append(SpawnSite(
                    fi.rel, node.lineno, qual, "thread",
                    _thread_name(node), tuple(sorted(roots))))
            elif leaf in ("map", "submit") \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in pools and node.args:
                roots = _resolve_target(pkg, fi.rel, fi, node.args[0])
                sites.append(SpawnSite(
                    fi.rel, node.lineno, qual, "pool", "",
                    tuple(sorted(roots))))
    # HTTP handler methods: per-request threads of the obs server
    for qual, fi in sorted(pkg.functions.items()):
        if fi.cls is None or fi.name not in _HANDLER_METHODS:
            continue
        bases = pkg.class_bases.get(fi.rel, {}).get(fi.cls, [])
        if any(b in _HANDLER_BASES for b in bases):
            sites.append(SpawnSite(fi.rel, fi.lineno, qual, "handler",
                                   "", (qual,)))
    return sites


def thread_names(pkg: Package) -> Set[str]:
    """Literal thread names the package spawns (runtime shadow-check:
    live lgbm-* thread names must land in this set)."""
    return {s.name for s in spawn_inventory(pkg) if s.name}


def _external_names(pkg: Package) -> Dict[str, Set[str]]:
    """Per-file names bound by imports that do NOT resolve into the
    package (json, os, pickle, ...). A call through such a receiver is
    external by construction — no simple-name fallback."""
    out: Dict[str, Set[str]] = {}
    for rel, sf in pkg.files.items():
        imps = pkg.imports[rel]
        names: Set[str] = set()
        for node in pkg.walk(sf.tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    names.add(al.asname or al.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for al in node.names:
                    names.add(al.asname or al.name)
        out[rel] = {n for n in names
                    if n not in imps.modules and n not in imps.symbols}
    return out


def _is_instance_method(pkg: Package, qual: str) -> bool:
    fi = pkg.functions[qual]
    if fi.cls is None or "." in fi.name:
        return False
    args = fi.node.args
    return bool(args.args) and args.args[0].arg == "self"


def _thread_call_graph(pkg: Package) -> Dict[str, Set[str]]:
    """Call graph restricted to confident edges plus the narrow
    fallback described in the module docstring: unknown-receiver
    attribute calls match instance methods only, never generic verbs,
    never receivers imported from outside the package."""
    ext = _external_names(pkg)
    graph: Dict[str, Set[str]] = {}
    for qual, fi in pkg.functions.items():
        edges: Set[str] = set()
        for node in pkg.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            conf = pkg.resolve_call(fi.rel, fi, node.func, fallback=False)
            if conf:
                edges |= conf
                continue
            f = node.func
            if not isinstance(f, ast.Attribute) \
                    or f.attr in _GENERIC_ATTRS:
                continue
            base = f.value
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name) and base.id in ext[fi.rel]:
                continue
            edges |= {q for q in pkg.by_name.get(f.attr, ())
                      if _is_instance_method(pkg, q)}
        graph[qual] = edges
    return graph


def thread_reachable(pkg: Package) -> Set[str]:
    """Quals reachable from ANY spawn-site root: code that can run off
    the main thread."""
    roots: Set[str] = set()
    for s in spawn_inventory(pkg):
        roots |= set(s.roots)
    graph = _thread_call_graph(pkg)
    seen: Set[str] = set()
    stack = [r for r in roots if r in pkg.functions]
    while stack:
        q = stack.pop()
        if q in seen:
            continue
        seen.add(q)
        stack.extend(graph.get(q, ()) - seen)
    return seen


def _self_sync_attrs(pkg: Package, method_quals: List[str]) -> Set[str]:
    """Attrs assigned a synchronization-primitive constructor."""
    attrs: Set[str] = set()
    for q in method_quals:
        fi = pkg.functions[q]
        for node in pkg.walk(fi.node):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                fd = dotted(node.value.func)
                if fd is not None \
                        and fd.split(".")[-1] in _SELF_SYNC_CTORS:
                    for t in node.targets:
                        a = _self_attr(t)
                        if a is not None:
                            attrs.add(a)
    return attrs


class _AccessScanner(_MethodScanner):
    """locks.py's mutation scanner, plus self-attr READ tracking."""

    def __init__(self, lock_attrs: Set[str], method_qual: str) -> None:
        super().__init__(lock_attrs, method_qual)
        self.reads: Set[str] = set()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        a = _self_attr(node)
        if a is not None and isinstance(node.ctx, ast.Load) \
                and a not in self.lock_attrs:
            self.reads.add(a)
        self.generic_visit(node)


def _class_pragma(pkg: Package, rel: str, cls: str) -> bool:
    """Class-level `# tpulint: thread-ok(...)` on the class line."""
    sf = pkg.files[rel]
    for node in pkg.walk(sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return sf.pragma_at(node.lineno, "thread-ok") is not None
    return False


def check(pkg: Package) -> List[Finding]:
    findings: List[Finding] = []
    hot = thread_reachable(pkg)
    for (rel, cls), methods in sorted(_class_methods(pkg).items()):
        thread_methods = {q for q in methods if q in hot}
        if not thread_methods:
            continue
        if _class_pragma(pkg, rel, cls):
            continue
        sf = pkg.files[rel]
        lock_attrs = _lock_attrs(pkg, methods)
        sync_attrs = _self_sync_attrs(pkg, methods)
        mutations: List[_Mutation] = []
        touched_by_thread: Set[str] = set()   # attrs a thread can see
        for q in sorted(methods):
            fi = pkg.functions[q]
            scan = _AccessScanner(lock_attrs, q)
            for stmt in fi.node.body:
                scan.visit(stmt)
            mutations.extend(scan.mutations)
            if q in thread_methods and not q.endswith(".__init__"):
                touched_by_thread |= scan.reads
                touched_by_thread |= {m.attr for m in scan.mutations}
        for m in mutations:
            if m.attr in sync_attrs or m.under_lock:
                continue
            if m.method.endswith(".__init__"):
                continue
            # shared = mutated on a worker thread, or mutated anywhere
            # while a worker-thread method also touches it
            on_thread = m.method in thread_methods
            if not on_thread and m.attr not in touched_by_thread:
                continue
            if sf.pragma_at(m.line, "thread-ok"):
                continue
            where = "on a spawned thread" if on_thread \
                else "on the main thread while a spawned thread reads it"
            findings.append(Finding(
                RULE, rel, m.line, m.method,
                f"{cls}.{m.attr}:{m.kind}",
                f"`self.{m.attr}` is mutated {where} "
                f"({m.kind.replace('call:', '.')}) without holding a "
                f"lock — {cls} methods run on more than one thread; "
                "guard with the class lock or annotate "
                "`# tpulint: thread-ok(<reason>)`"))
    return findings
