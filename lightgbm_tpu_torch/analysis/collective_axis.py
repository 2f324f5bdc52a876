"""Rule pack: collective-axis (the port's collectives).

A collective of `torch.distributed` blocks until every rank of the
group calls it with a matching tensor: a collective that only some
ranks reach, or one issued outside the code that keeps the ranks in
step, hangs the group (on NCCL silently, until the watchdog's
timeout). The port routes every collective through `network.py`,
which stages gloo tensors, times them (`collective_span`) and sums in
the JAX package's rank order. Three checks:

- **dist-outside-network**: a data-moving `torch.distributed` call
  (`all_reduce`, `all_gather*`, `broadcast`, `reduce_scatter*`,
  `barrier`, `send` / `recv`, ...) outside `network.py`. Queries
  (`is_initialized`, `get_rank`, `get_world_size`, `get_backend`)
  and the group's set-up are not collectives.
- **unmapped-collective**: a call of `network.psum` / `pmax` /
  `all_gather` / `fleet_allgather` in a function not reachable (call
  graph, over-approximating fallback) from the parallel learners, the
  distributed loader or the fleet plane
  (`mesh_inventory.collective_roots`): a rank of the one-device
  learners would wait for peers that never call it.
- **quantize-contract**: as in the JAX package, the packed-int32
  reduction (`ops/quantize.py`) sums the *packed* words:
  `psum(packed_hist_to_pairs(x))` / `psum(unpack_gh(x))` ships the
  unpacked pairs (`psum-of-unpacked`), and
  `pairs_to_packed_hist(psum(...))` packs after the reduction
  (`pack-after-psum`); the contract is
  `packed_hist_to_pairs(psum(pairs_to_packed_hist(h)))`.

The JAX pack's `axis-unknown` has no counterpart: the port has no mesh
and no axis names. Suppress a deliberate site with
`# tpulint: mesh-ok(<reason>)`.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import Finding, Package, dotted
from .mesh_inventory import collective_roots
from .sync_points import torch_path

RULE = "collective-axis"
_NETWORK = "network.py"
_DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast", "broadcast_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "gather", "scatter",
    "all_to_all", "all_to_all_single", "barrier", "monitored_barrier",
    "send", "recv", "isend", "irecv", "batch_isend_irecv"}
_NETWORK_COLLECTIVES = ("psum", "pmax", "all_gather", "fleet_allgather")
_UNPACKERS = ("packed_hist_to_pairs", "unpack_gh")
_PACKERS = ("pairs_to_packed_hist", "pack_gh")


def _network_collective(pkg: Package, rel: str, caller, func: ast.AST
                        ) -> Optional[str]:
    """The network.py collective a call names, or None."""
    d = dotted(func)
    if d is None or d.split(".")[-1] not in _NETWORK_COLLECTIVES:
        return None
    net = f"{pkg.pkg_name}/{_NETWORK}"
    for q in pkg.resolve_call(rel, caller, func, fallback=False):
        if q.split("::")[0] == net:
            return d.split(".")[-1]
    return None


def _is_quantize_fn(pkg: Package, rel: str, caller, node: ast.AST,
                    names) -> bool:
    """Does `node` name one of ops/quantize.py's `names`?"""
    d = dotted(node)
    if d is None or d.split(".")[-1] not in names:
        return False
    quals = pkg.resolve_call(rel, caller, node, fallback=False)
    if quals:
        return any(q.split("::")[0].endswith("ops/quantize.py")
                   for q in quals)
    return True       # unresolved but exact leaf-name match: trust it


def check(pkg: Package) -> List[Finding]:
    roots = collective_roots(pkg)
    reach: Set[str] = pkg.reachable(roots) if roots else set()
    net = f"{pkg.pkg_name}/{_NETWORK}"
    findings: List[Finding] = []
    for rel in sorted(pkg.files):
        sf = pkg.files[rel]
        for node in pkg.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            caller = pkg.enclosing_function(rel, node)
            qual = caller.qual if caller else ""

            def emit(code: str, message: str) -> None:
                if sf.pragma_at(node.lineno, "mesh-ok"):
                    return
                findings.append(Finding(RULE, rel, node.lineno, qual,
                                        code, message))

            fd = dotted(node.func) or ""
            full = torch_path(pkg.imports[rel], fd) if fd else None
            if full is not None and full.startswith("torch.distributed.") \
                    and full.split(".")[-1] in _DIST_COLLECTIVES \
                    and rel != net:
                emit(f"dist-outside-network:{full.split('.')[-1]}",
                     f"{full} outside network.py bypasses its staging, "
                     "timing and rank-order sums; call network.psum / "
                     "all_gather")
                continue
            leaf = _network_collective(pkg, rel, caller, node.func)
            if leaf is None:
                if _is_quantize_fn(pkg, rel, caller, node.func, _PACKERS) \
                        and node.args and isinstance(node.args[0], ast.Call) \
                        and _network_collective(pkg, rel, caller,
                                                node.args[0].func) == "psum":
                    emit("pack-after-psum",
                         "packing the result of network.psum: the "
                         "packed-int32 contract reduces packed words, not "
                         "pairs; pack before the collective")
                continue
            if rel != net and qual and qual not in reach:
                emit("unmapped-collective",
                     f"network.{leaf} is not reachable from the parallel "
                     "learners, the distributed loader or the fleet "
                     "plane: the other ranks never reach it")
            if leaf == "psum" and node.args \
                    and isinstance(node.args[0], ast.Call) \
                    and _is_quantize_fn(pkg, rel, caller, node.args[0].func,
                                        _UNPACKERS):
                emit("psum-of-unpacked",
                     "psum of just-unpacked histogram pairs ships 2x the "
                     "bytes; reduce the packed int32 words: "
                     "packed_hist_to_pairs(psum(pairs_to_packed_hist(h)))")
    return findings
