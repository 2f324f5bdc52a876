"""The port's linter, device-side packs (collective-axis,
kernel-contract, dtype-flow), held against the JAX package's on the CPU.

Twin fixtures: the JAX pack flags a JAX test's fixture and the port's
pack flags its torch twin, laid out line for line, at the same lines
with the mapped code (codes without a counterpart, `axis-unknown` and
`memspace`, drop out). Each rule new to the port (abi-signature,
abi-call, launch-config, dist-outside-network) has a seeded violation
and a clean or annotated twin. The whole package is clean per pack, and
the static model of csrc/*.cu (exports, launches) is checked against
what the card allows.
"""
import ast
import os
import textwrap

import pytest

from lightgbm_tpu.analysis import core as jcore
from lightgbm_tpu.analysis import collective_axis as jcollective
from lightgbm_tpu.analysis import dtype_flow as jdtype
from lightgbm_tpu.analysis import kernel_contract as jkernel
from lightgbm_tpu_torch.analysis import core as pcore
from lightgbm_tpu_torch.analysis import (collective_axis, dtype_flow,
                                         kernel_contract, mesh_inventory)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_pkg(root, pkg_name, files):
    for rel, src in files.items():
        p = root / pkg_name / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def jax_pkg(tmp_path, files):
    write_pkg(tmp_path / "jax", "lightgbm_tpu", files)
    return jcore.Package.load(str(tmp_path / "jax"), subdir="lightgbm_tpu")


def port_pkg(tmp_path, files):
    write_pkg(tmp_path / "port", "lightgbm_tpu_torch", files)
    return pcore.Package.load(str(tmp_path / "port"))


def rows(findings, code_map=None):
    out = set()
    for f in findings:
        code = f.code if code_map is None else code_map.get(f.code, f.code)
        if code is not None:
            out.add((f.path.split("/", 1)[1], f.line, code))
    return sorted(out)


def jax_fixture(module, test):
    """The files of the first `make_pkg(tmp_path, {...})` call of one
    JAX analysis test."""
    path = os.path.join(REPO_ROOT, "tests", f"{module}.py")
    tree = ast.parse(open(path).read())
    env = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            exec(compile(ast.Module([node], []), path, "exec"), env)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == test)
    call = next(c for c in ast.walk(fn) if isinstance(c, ast.Call)
                and getattr(c.func, "id", None) == "make_pkg")
    return eval(compile(ast.Expression(call.args[1]), path, "eval"), env)


@pytest.fixture(scope="module")
def repo_pkg():
    return pcore.Package.load(REPO_ROOT)


# ------------------------------------------------------ the whole package

@pytest.mark.parametrize("pack", [collective_axis, kernel_contract,
                                  dtype_flow],
                         ids=["collective-axis", "kernel-contract",
                              "dtype-flow"])
def test_package_clean(pack, repo_pkg):
    found = pack.check(repo_pkg)
    assert found == [], "\n".join(map(str, found))


def test_every_export_has_its_signature_row(repo_pkg):
    exports = {e.name: e for s in kernel_contract.cuda_sources(repo_pkg)
               for e in s.exports()}
    rows_ = kernel_contract.signature_rows(repo_pkg)
    assert len(exports) == 17 and set(exports) == set(rows_)
    for name, e in exports.items():
        lib, args, ret, _ = rows_[name]
        assert (lib, args, ret) == (e.lib, e.params, e.ret), name


def test_launch_inventory_within_the_card(repo_pkg):
    """Every launch the static model reads: a block of a multiple of 32
    and at most 1024 threads within its __launch_bounds__, the stream
    passed in, and dynamic shared memory within H100's opt-in limit
    (227 KiB)."""
    launches = kernel_contract.launch_inventory(repo_pkg)
    kernels = {ln.kernel for ln in launches}
    assert {"hp_partials", "hp_partials_dev", "hp_reduce", "hp_quant",
            "part_small", "part_tiles", "part_copyback", "rm_partials",
            "rm_reduce", "rm_quant", "mv_tiles", "mv_reduce",
            "mv_quant"} == kernels
    for ln in launches:
        assert ln.block_mult32 and ln.block_max <= 1024, ln
        assert ln.launch_bounds is None or ln.block_max <= ln.launch_bounds
        assert ln.stream == "s", ln
        assert ln.smem_max is not None and ln.smem_max <= 227 * 1024, ln


def test_process_group_inventory(repo_pkg):
    inv = mesh_inventory.process_group_inventory(repo_pkg)
    assert [(s.rel, s.func.split("::")[1], s.kind, s.backend, s.backends)
            for s in inv] == [
        ("lightgbm_tpu_torch/network.py", "ensure_distributed",
         "init_process_group", "dynamic", ("gloo", "nccl"))]
    roots = mesh_inventory.collective_roots(repo_pkg)
    assert any(q.startswith("lightgbm_tpu_torch/treelearner/parallel.py")
               for q in roots)
    assert any(q.startswith("lightgbm_tpu_torch/io/distributed.py")
               for q in roots)


# ------------------------------------------------------ twin fixtures

_NET = {"network.py": """\
    def psum(x):
        return x

    def all_gather(x):
        return x
    """}

TWINS = {
    "collective_axis_catches_typo_and_unmapped": (
        ("test_meshlint", "test_collective_axis_catches_typo_and_unmapped"),
        jcollective, collective_axis, {
            "mod.py": """\
                from . import network




                def build(devices):
                    return devices

                def mapped_body(x):
                    return network.psum(x)

                def entry(x):
                    return mapped_body(
                        x)

                def never_mapped(x):
                    return network.psum(x)
                """,
            "treelearner/parallel.py": """\
                from ..mod import entry

                def grow(x):
                    return entry(x)
                """, **_NET},
        {"axis-unknown:dat": None}),
    "collective_axis_negatives_and_pragma": (
        ("test_meshlint", "test_collective_axis_negatives_and_pragma"),
        jcollective, collective_axis, {
            "mod.py": """\
                from . import network




                def build(devices):
                    return devices

                def helper(x):
                    # bound transitively: entry's body calls helper
                    return network.psum(x)

                def mapped_body(x):
                    return helper(network.all_gather(x))

                def entry(x):
                    return mapped_body(
                        x)

                def external_harness(x):
                    return network.psum(x)  # tpulint: mesh-ok(called under an external harness)

                def guarded(self, x):
                    self.world = None
                    if self.world is None:
                        return x
                    return network.psum(x)
                """,
            "treelearner/parallel.py": """\
                from ..mod import entry, guarded

                def grow(x):
                    return entry(x) + guarded(None, x)
                """, **_NET}, {}),
    "collective_axis_quantize_contract": (
        ("test_meshlint", "test_collective_axis_quantize_contract"),
        jcollective, collective_axis, {
            "mod.py": """\
                from . import network




                def build(devices):
                    return devices
                from .ops.quantize import pack_gh, pairs_to_packed_hist, \\
                    packed_hist_to_pairs

                def bad_unpack_first(h):
                    def body(b):
                        return network.psum(packed_hist_to_pairs(b))
                    return body(
                        h)

                def bad_pack_after(h):
                    def body(b):
                        return pairs_to_packed_hist(network.psum(b))
                    return body(
                        h)

                def good(h):
                    def body(b):
                        return packed_hist_to_pairs(
                            network.psum(pairs_to_packed_hist(b)))
                    return body(
                        h)
                """,
            "ops/quantize.py": """\
                def pack_gh(qg, qh):
                    return qg

                def pairs_to_packed_hist(h):
                    return h

                def packed_hist_to_pairs(p):
                    return p
                """,
            "treelearner/parallel.py": """\
                from ..mod import bad_unpack_first, bad_pack_after, good

                def grow(h):
                    return bad_unpack_first(h), bad_pack_after(h), good(h)
                """, **_NET}, {}),
    "kernel_contract_memspace_and_bitcast": (
        ("test_meshlint", "test_kernel_contract_memspace_and_bitcast"),
        jkernel, kernel_contract, {"mod.py": """\
            import functools
            import torch


            def space():
                return None


            def widths(x):
                return x.to(torch.uint16).view(
                    torch.uint8)
            """}, {"memspace:ANY": None}),
    "kernel_contract_memspace_bitcast_negatives": (
        ("test_meshlint", "test_kernel_contract_memspace_bitcast_negatives"),
        jkernel, kernel_contract, {"mod.py": """\
            import functools
            import torch


            def smem_is_fine():
                return None


            def same_width(x):
                y = x.to(torch.float32)
                return y.view(torch.int32)

            def annotated(x):
                # tpulint: tile-ok(deliberate plane split for the packed layout)
                return x.to(torch.uint16).view(
                    torch.uint8)
            """}, {}),
    "dtype_flow_narrow_sum_and_packed": (
        ("test_meshlint", "test_dtype_flow_narrow_sum_and_packed"),
        jdtype, dtype_flow, {"mod.py": """\
            import torch
            from .ops.quantize import pairs_to_packed_hist, unpack_gh

            def narrow(x):
                q = x.to(torch.int16)
                return torch.sum(q)

            def narrow_method(w):
                qg, qh = unpack_gh(w)
                return qg.sum()

            def packed_bad(h):
                w = pairs_to_packed_hist(h)
                return w.to(torch.float32)
            """, "ops/quantize.py": """\
            def pairs_to_packed_hist(h):
                return h

            def unpack_gh(w):
                return w, w
            """}, {}),
    "dtype_flow_subtract_and_accum": (
        ("test_meshlint", "test_dtype_flow_subtract_and_accum"),
        jdtype, dtype_flow, {"mod.py": """\
            import torch

            def dequant_bad(parent, sib):
                pi = parent.to(torch.int32)
                si = sib.to(torch.int32)
                p = pi.float()
                s = si.to(torch.float32)
                return p - s

            def accum_bad(idx, v):
                acc = torch.zeros((8,), dtype=torch.int16)
                w = v.to(torch.int32)
                return acc.index_add_(0, idx, w)
            """}, {}),
    "dtype_flow_negatives_and_pragma": (
        ("test_meshlint", "test_dtype_flow_negatives_and_pragma"),
        jdtype, dtype_flow, {"mod.py": """\
            import torch

            def widened(x):
                q = x.to(torch.int16)
                return torch.sum(q, dtype=torch.int32)

            def subtract_in_int(parent, sib):
                pi = parent.to(torch.int32)
                si = sib.to(torch.int32)
                return (pi - si).to(torch.float32)

            def wide_accum(idx, v):
                acc = torch.zeros((8,), dtype=torch.int32)
                return acc.index_add_(0, idx, v.to(torch.int32))

            def annotated(x):
                q = x.to(torch.int16)
                return torch.sum(q)  # tpulint: dtype-ok(histogram is <256 rows; 16-bit sum cannot overflow)
            """}, {}),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_fixture_flagged_at_the_same_lines(name, tmp_path):
    (module, test), jmod, pmod, twin, code_map = TWINS[name]
    want = rows(jmod.check(jax_pkg(tmp_path, jax_fixture(module, test))),
                code_map)
    got = rows(pmod.check(port_pkg(tmp_path, twin)))
    assert got == want
    assert bool(want) == ("negatives" not in name)


# ------------------------------------ new rules: dist-outside-network

def test_dist_outside_network(tmp_path):
    pkg = port_pkg(tmp_path, {
        "mod.py": """\
            import torch.distributed as dist

            def ranks():
                return dist.get_rank(), dist.get_world_size()

            def rogue(t):
                dist.all_reduce(t)
                dist.barrier()  # tpulint: mesh-ok(fixture: a commit barrier)
                return t
            """,
        "network.py": """\
            import torch.distributed as dist

            def psum(t):
                dist.all_reduce(t)
                return t
            """})
    assert rows(collective_axis.check(pkg)) == [
        ("mod.py", 7, "dist-outside-network:all_reduce")]


# ------------------------------------------ new rules: abi-signature

_CU = """\
    #include <cuda_runtime.h>

    extern "C" {

    int lgbt_tile() { return 64; }

    int lgbt_run(const int* data, long long n, int k, void* out,
                 void* stream) {
      return 0;
    }

    long long lgbt_words(int p) { return 2LL * p; }

    }  // extern "C"
    """


@pytest.mark.parametrize("sig,want", [
    ('''{"k": {"lgbt_tile": ([], _I),
               "lgbt_run": ([_P, _L, _I, _P, _P], _I),
               "lgbt_words": ([_I], _L)}}''', []),
    ('''{"k": {"lgbt_tile": ([], _I),
               "lgbt_run": ([_P, _I, _I, _P, _P], _I),
               "lgbt_words": ([_I, _I], _I),
               "lgbt_gone": ([], _I)}}''', [
        ("csrc/k.cu", 7, "abi-signature:lgbt_run:arg1"),
        ("csrc/k.cu", 12, "abi-signature:lgbt_words:arity"),
        ("csrc/k.cu", 12, "abi-signature:lgbt_words:return"),
        ("ops/cuda.py", 9, "abi-signature:lgbt_gone:no-export")]),
    ('''{"k": {"lgbt_run": ([_P, _L, _I, _P, _P], _I),
               "lgbt_words": ([_I], _L)}}''', [
        ("csrc/k.cu", 5, "abi-signature:lgbt_tile:no-row")]),
], ids=["match", "mismatch", "no-row"])
def test_abi_signature(sig, want, tmp_path):
    pkg = port_pkg(tmp_path, {"csrc/k.cu": _CU, "ops/cuda.py": f"""\
        import ctypes

        _P = ctypes.c_void_p
        _I = ctypes.c_int
        _L = ctypes.c_longlong
        _SIGNATURES = {sig}
        """})
    assert rows(kernel_contract.check(pkg)) == want


# ------------------------------------------------ new rules: abi-call

_CALL_BASE = {"csrc/k.cu": _CU, "ops/cuda.py": """\
    import ctypes

    _P = ctypes.c_void_p
    _I = ctypes.c_int
    _L = ctypes.c_longlong
    _SIGNATURES = {"k": {"lgbt_tile": ([], _I),
                         "lgbt_run": ([_P, _L, _I, _P, _P], _I),
                         "lgbt_words": ([_I], _L)}}

    def lib(name):
        return None
    """}


def test_abi_call_flags_bad_calls(tmp_path):
    pkg = port_pkg(tmp_path, {**_CALL_BASE, "ops/use.py": """\
        import torch
        from . import cuda as K

        def bad(data, n, k):
            lib = K.lib("k")
            out = torch.empty(4, dtype=torch.int32)
            lib.lgbt_run(data.data_ptr(), n, k, out.data_ptr())
            lib.lgbt_run(data.data_ptr(), n, out.data_ptr(), n, None)
            lib.lgbt_words(None)
        """})
    assert rows(kernel_contract.check(pkg)) == [
        ("ops/use.py", 7, "abi-call:lgbt_run:arity"),
        ("ops/use.py", 8, "abi-call:lgbt_run:arg2"),
        ("ops/use.py", 8, "abi-call:lgbt_run:arg3"),
        ("ops/use.py", 8, "abi-call:lgbt_run:unchecked:data"),
        ("ops/use.py", 9, "abi-call:lgbt_words:arg0")]


def test_abi_call_checked_and_annotated(tmp_path):
    pkg = port_pkg(tmp_path, {**_CALL_BASE, "ops/use.py": """\
        import torch
        from . import cuda as K

        def _check(t):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError("contiguous int32")

        def _ptr(t):
            return None if t is None else t.data_ptr()

        def good(data, n, k, scratch=None):
            _check(data)
            lib = K.lib("k")
            out = torch.empty(4, dtype=torch.int32)
            stream = torch.cuda.current_stream().cuda_stream
            args = [data.data_ptr(), n, k]
            lib.lgbt_run(*args, _ptr(out), stream)
            lib.lgbt_run(data.data_ptr(), n, k, None, stream)
            lib.lgbt_words(n)  # tpulint: tile-ok(fixture: deliberate)
        """})
    assert kernel_contract.check(pkg) == []


# ------------------------------------------- new rules: launch-config

_LAUNCH_CU = """\
    #include <cuda_runtime.h>
    constexpr int kThreads = 256;
    constexpr int kBig = 2048;

    __global__ void __launch_bounds__(kThreads) k_bounded(int* x) {}
    __global__ void k_free(int* x) {}

    template <typename K>
    cudaError_t allow_smem(K k, int bytes) {
      if (bytes <= 48 * 1024) return cudaSuccess;
      return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes);
    }

    int launch(int* x, int n, int bytes, cudaStream_t s) {
      const int w = std::min(n, 16);
      allow_smem(k_bounded, bytes);
      k_bounded<<<n, kThreads, bytes, s>>>(x);
      k_free<<<n, 32 * w, 0, s>>>(x);
      k_free<<<n, 1000, 0, s>>>(x);
      k_free<<<n, kBig, 0, s>>>(x);
      k_bounded<<<n, 512, 0, s>>>(x);
      k_free<<<n, 32 * n, 0, s>>>(x);
      k_free<<<n, 128, bytes, s>>>(x);
      k_free<<<n, 128, 0, 0>>>(x);
      k_free<<<n, 128>>>(x);
      return 0;
    }
    """


def test_launch_config_flags_bad_launches(tmp_path):
    pkg = port_pkg(tmp_path, {"csrc/l.cu": _LAUNCH_CU})
    assert rows(kernel_contract.check(pkg)) == [
        ("csrc/l.cu", 20, "launch-config:k_free:block-warp"),
        ("csrc/l.cu", 21, "launch-config:k_free:block-max"),
        ("csrc/l.cu", 22, "launch-config:k_bounded:launch-bounds"),
        ("csrc/l.cu", 23, "launch-config:k_free:block-unresolved"),
        ("csrc/l.cu", 24, "launch-config:k_free:smem-optin"),
        ("csrc/l.cu", 25, "launch-config:k_free:stream"),
        ("csrc/l.cu", 26, "launch-config:k_free:stream")]


def test_launch_config_annotated_twin(tmp_path):
    lines = textwrap.dedent(_LAUNCH_CU).split("\n")
    for ln in range(20, 27):
        lines[ln - 1] += "  // tpulint: tile-ok(fixture: deliberate)"
    pkg = port_pkg(tmp_path, {"csrc/l.cu": "\n".join(lines)})
    assert kernel_contract.check(pkg) == []
    launches = kernel_contract.launch_inventory(pkg)
    assert [(ln.kernel, ln.block_max) for ln in launches[:2]] == [
        ("k_bounded", 256), ("k_free", 512)]
