"""Shared infrastructure of the device-side packs: the process-group
inventory and the collectives' legitimate roots.

The JAX package's counterpart inventories mesh axes and `shard_map`
bodies. The port has no mesh: it runs one process per card in the
default `torch.distributed` group, whose ranks play the JAX package's
"data" axis, so there is no axis name to check (the JAX pack's
`axis-unknown` has no counterpart). What the device-side packs need
instead, from `ast` alone:

- `process_group_inventory`: every `init_process_group` site with its
  backend (a literal, or "dynamic" when computed, as
  `network.py` `_backend_for` picks NCCL or gloo by device), and every
  `new_group` site;
- `collective_roots`: the functions from which the collectives of
  `network.py` (`psum`, `pmax`, `all_gather`, `fleet_allgather`) are
  legitimately reached: every function of the parallel learners
  (`treelearner/parallel.py`), of the distributed loader
  (`io/distributed.py`) and of the fleet plane (`obs/aggregate.py`,
  and `obs/__init__.py`'s straggler report). The collective-axis pack
  checks reachability from them.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List

from .core import Package, dotted
from .sync_points import torch_path

_ROOT_FILES = ("treelearner/parallel.py", "io/distributed.py",
               "obs/aggregate.py", "obs/__init__.py")


@dataclasses.dataclass
class GroupSite:
    rel: str
    line: int
    func: str          # enclosing function qual
    kind: str          # "init_process_group" | "new_group"
    backend: str       # literal backend, or "dynamic"
    backends: tuple    # the backend names the module can choose


def _backend(call: ast.Call) -> str:
    node = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "backend":
            node = kw.value
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return "default" if node is None else "dynamic"


_BACKENDS = ("nccl", "gloo", "mpi", "ucc")


def process_group_inventory(pkg: Package) -> List[GroupSite]:
    """Every process-group construction in the package: a call of
    `init_process_group` / `new_group`, or a reference to one handed
    on (`init = _initialize or dist.init_process_group`)."""
    out: List[GroupSite] = []
    for rel in sorted(pkg.files):
        tree = pkg.files[rel].tree
        chosen = tuple(sorted({
            n.value.value for n in pkg.walk(tree)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Constant)
            and n.value.value in _BACKENDS}))
        called = {id(n.func) for n in pkg.walk(tree)
                  if isinstance(n, ast.Call)}
        for node in pkg.walk(tree):
            target = node.func if isinstance(node, ast.Call) else node
            if not isinstance(target, (ast.Attribute, ast.Name)):
                continue
            if not isinstance(node, ast.Call) and id(node) in called:
                continue            # the call's own func node
            fd = dotted(target) or ""
            leaf = fd.split(".")[-1]
            if leaf not in ("init_process_group", "new_group"):
                continue
            full = torch_path(pkg.imports[rel], fd) or ""
            if not (full.startswith("torch.distributed.")
                    or fd.startswith("dist.")):
                continue
            fi = pkg.enclosing_function(rel, node)
            backend = _backend(node) if isinstance(node, ast.Call) \
                else "dynamic"
            out.append(GroupSite(rel, node.lineno, fi.qual if fi else "",
                                 leaf, backend, chosen))
    return sorted(out, key=lambda s: (s.rel, s.line))


def collective_roots(pkg: Package) -> Dict[str, int]:
    """qual -> definition line of every function a collective may be
    reached from."""
    roots = tuple(f"{pkg.pkg_name}/{f}" for f in _ROOT_FILES)
    return {q: fi.lineno for q, fi in pkg.functions.items()
            if fi.rel in roots}
