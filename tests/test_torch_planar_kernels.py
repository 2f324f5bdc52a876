"""The planar histogram (B1) and the window partition (B2) of the port at
the shapes where their CUDA kernels change route or tile, on the CPU.

B1's plain version is held bit for bit against its association written
out in numpy: tiles of HIST_TILE rows, each cell summed in row order
inside its tile, the tiles added in order (the CUDA kernel's float
modes sum exactly so), and a 16-bit-code window against the JAX
package's ``histogram_scatter``. B2 is held bit for bit against the JAX
package's ``partition_pallas2`` (interpret mode) and ``partition_ref``
at windows around the CUDA kernel's small-window rule and its tile, at
P = 16 and at a P = 128 state with multi-value slot planes.
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops import plane as jplane
from lightgbm_tpu.ops.histogram import histogram_scatter as jscatter
from lightgbm_tpu_torch.ops import cuda as K
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import plane as tplane


def _bf16(x):
    """float32 -> bfloat16 (round to nearest even) -> float32, on the
    bits."""
    u = x.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _tiled_numpy(codes, g, h, num_bins, tile):
    """[F, B, 2] float32: per tile of ``tile`` rows a zero histogram,
    each row added in row order (one cell per column), codes >= num_bins
    dropped; then the tiles added in order."""
    c, f = codes.shape
    out = np.zeros((f, num_bins, 2), np.float32)
    cols = np.arange(f)
    for t0 in range(0, c, tile):
        part = np.zeros_like(out)
        for r in range(t0, min(c, t0 + tile)):
            ok = codes[r] < num_bins
            part[cols[ok], codes[r][ok], 0] += g[r]
            part[cols[ok], codes[r][ok], 1] += h[r]
        out = out + part
    return out


def _planar_state(n, g, code_bits, max_code, seed, dyadic=False):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, max_code, size=(n, g)).astype(np.int32)
    if dyadic:
        grad = (rng.randint(-1024, 1025, n) / 2048.0).astype(np.float32)
        hess = (rng.randint(0, 1025, n) / 4096.0).astype(np.float32)
    else:
        grad = rng.randn(n).astype(np.float32)
        hess = rng.rand(n).astype(np.float32)
    lay = tplane.make_layout(g, code_bits, n, with_label=True,
                             with_score=True)
    t = torch.as_tensor
    data = tplane.build_data(lay, tplane.build_codes_planes(t(codes), lay),
                             t(grad), t(hess), label=t(grad), score=t(hess))
    return lay, data, codes, grad, hess


# (code bits, columns, bins, largest code): codes at and above num_bins
# add nothing
WIDTHS = [(4, 9, 12, 16), (8, 6, 200, 256), (16, 5, 3000, 3100)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [1, TH.HIST_TILE - 1, TH.HIST_TILE + 1,
                                   6200])
@pytest.mark.parametrize("width", WIDTHS, ids=lambda w: f"{w[0]}bit")
def test_planar_plain_equals_tiled_association(width, count, dtype):
    bits, g, nb, max_code = width
    start = 37
    lay, data, codes, grad, hess = _planar_state(
        6300, g, bits, max_code, seed=bits + count)
    got = TH.histogram_planar_plain(
        data, start, count, num_bins=nb, num_cols=g, code_bits=bits,
        grad_plane=lay.grad, dtype=getattr(torch, dtype)).numpy()
    sel = slice(start, start + count)
    gw, hw = grad[sel], hess[sel]
    if dtype == "bfloat16":
        gw, hw = _bf16(gw), _bf16(hw)
    want = _tiled_numpy(codes[sel], gw, hw, nb, TH.HIST_TILE)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_planar_16bit_window_matches_jax_scatter():
    """A 16-bit-code window of 1,500 bins (codes past num_bins
    dropped), on dyadic g/h: every partial sum is exact, so any
    association gives the JAX scatter's bits."""
    g, nb = 5, 1500
    lay, data, codes, grad, hess = _planar_state(5000, g, 16, 1600, seed=3,
                                                 dyadic=True)
    start, count = 123, 4500
    sel = slice(start, start + count)
    want = np.asarray(jscatter(jnp.asarray(codes[sel]),
                               jnp.asarray(grad[sel]),
                               jnp.asarray(hess[sel]), nb))
    got = TH.hist_planar(data, start, count, num_bins=nb, num_cols=g,
                         code_bits=16, grad_plane=lay.grad).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# B2 at the CUDA kernel's route and tile boundaries
# ---------------------------------------------------------------------------

def _small_limit(P):
    """The largest window of the one-block route at P planes."""
    return tplane.PART_SMALL_BYTES // (4 * (P + 1))


def _partition_states(n, g, mv_planes, seed):
    """The same P-plane state in both packages: 8-bit codes, label and
    score planes, and ``mv_planes`` random slot planes."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 250, size=(n, g)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = rng.rand(n).astype(np.float32)
    mv = rng.randint(-1, 900, size=(mv_planes, n)).astype(np.int32) \
        if mv_planes else None
    kw = dict(with_label=True, with_score=True, tile=512,
              mv_planes=mv_planes)
    jl = jplane.make_layout(g, 8, n, **kw)
    jdata = jplane.build_data(
        jl, jplane.build_codes_planes(jnp.asarray(codes), jl),
        jnp.asarray(grad), jnp.asarray(hess), label=jnp.asarray(grad),
        score=jnp.asarray(hess), mv=None if mv is None else jnp.asarray(mv))
    tl = tplane.make_layout(g, 8, n, **kw)
    t = torch.as_tensor
    tdata = tplane.build_data(
        tl, tplane.build_codes_planes(t(codes), tl), t(grad), t(hess),
        label=t(grad), score=t(hess), mv=None if mv is None else t(mv))
    return jl, jdata, tl, tdata


def _p16_windows():
    s = _small_limit(16)
    t = tplane.PART_TILE
    return [(5, s), (5, s + 1), (700, t - 1), (700, t), (1, t + 1),
            (3, 2 * t + 1)]


@pytest.fixture(scope="module")
def states():
    return {16: _partition_states(8192, 28, 0, seed=16),
            128: _partition_states(4096, 28, 112, seed=128)}


@pytest.mark.parametrize("P,start,count",
                         [(16, s, c) for s, c in _p16_windows()]
                         + [(128, 9, _small_limit(128)),
                            (128, 9, _small_limit(128) + 1),
                            (128, 1000, tplane.PART_TILE + 1)])
def test_partition_routes_match_pallas2_and_ref(states, P, start, count):
    jl, jdata, tl, tdata = states[P]
    assert tl.num_planes == jl.num_planes == P
    kw = dict(feature=6, threshold=130, default_left=1, miss_bin=249)
    jr = jplane.route_scalars(jl, **kw)
    cap = tl.num_lanes - tl.tile    # one capacity for every window
    ref, nl_ref = jplane.partition_ref(jdata, jl, start, count, jr, cap=cap)
    pal, nl_pal = jplane.partition_pallas2(jdata, jl, start, count, jr,
                                           cap=cap, interpret=True)
    got, nl_got = tplane.partition(tdata.clone(), tl, start, count,
                                   tplane.route_scalars(tl, **kw))
    assert int(nl_got) == int(nl_ref) == int(nl_pal)
    assert 0 < int(nl_got) < count
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("P,count,small", [
    (8, 0, True), (8, _small_limit(8), True), (8, _small_limit(8) + 1,
                                               False),
    (16, 3011, True), (16, 3012, False), (128, 396, True),
    (128, 397, False), (128, 10_500_000, False)])
def test_partition_small_rule_ends(P, count, small):
    """The one-block route ends where (P + 1) * count * 4 bytes pass
    PART_SMALL_BYTES: about 3,000 lanes at P = 16, 400 at P = 128."""
    assert tplane.partition_small(P, count) is small


def test_lib_path_covers_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ renames (so rebuilds) every
    library; an edited other source does not rename this one."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "fold.cuh"\n')
    (src / "fold.cuh").write_text("// v1\n")
    (src / "other.cu").write_text("// other\n")
    monkeypatch.setattr(K, "CSRC", str(src))
    monkeypatch.setattr(K, "BUILD_DIR", str(tmp_path / "build"))
    first = K._lib_path("kern")
    assert os.path.dirname(first) == str(tmp_path / "build")
    (src / "other.cu").write_text("// other, edited\n")
    assert K._lib_path("kern") == first
    (src / "fold.cuh").write_text("// v2\n")
    second = K._lib_path("kern")
    assert second != first
    (src / "kern.cu").write_text('#include "fold.cuh"\n// edited\n')
    assert K._lib_path("kern") not in (first, second)
