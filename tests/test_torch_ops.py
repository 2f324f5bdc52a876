"""The port's planar state, partition and histogram against the JAX
package, on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode (as
tests/test_kernels.py does) and its XLA oracles; the port side runs the
plain PyTorch versions that back its CUDA kernels on the CPU. Integer
paths must match bit for bit; float histograms within rtol=1e-5,
atol=1e-4 (the sums are taken in another order).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops import plane as jplane
from lightgbm_tpu.ops.histogram import (histogram_planar_pallas,
                                        histogram_scatter as jscatter)
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import plane as tplane


def _make_states(n, g, seed, code_bits=8, tile=512, max_code=250):
    """The same planar state in both packages (tests/test_kernels.py
    _make_state inputs)."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, max_code, size=(n, g)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = rng.rand(n).astype(np.float32)
    jl = jplane.make_layout(g, code_bits, n, with_label=True,
                            with_score=True, tile=tile)
    jdata = jplane.build_data(jl, jplane.build_codes_planes(
        jnp.asarray(codes), jl), jnp.asarray(grad), jnp.asarray(hess),
        label=jnp.asarray(grad), score=jnp.asarray(hess))
    tl = tplane.make_layout(g, code_bits, n, with_label=True,
                            with_score=True, tile=tile)
    t = torch.as_tensor
    tdata = tplane.build_data(tl, tplane.build_codes_planes(t(codes), tl),
                              t(grad), t(hess), label=t(grad), score=t(hess))
    return jl, jdata, tl, tdata, codes


def _cap_for(layout, count):
    tile = layout.tile
    cap = -(-max(count, 1) // tile) * tile
    return min(cap, layout.num_lanes - tile)


# ---------------------------------------------------------------------------
# layout and state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_cols,code_bits,n,flags", [
    (28, 8, 5000, (True, True, False)),     # HIGGS width: grad%8 rule
    (9, 4, 3000, (True, True, True)),
    (5, 16, 70000, (False, False, False)),
    (60, 8, 300000, (True, True, False)),
])
def test_layout_and_state_byte_identical(num_cols, code_bits, n, flags):
    jl = jplane.make_layout(num_cols, code_bits, n, *flags)
    tl = tplane.make_layout(num_cols, code_bits, n, *flags)
    assert tuple(jl) == tuple(tl)
    if n > 10000:
        return
    rng = np.random.RandomState(n)
    dt = np.uint16 if code_bits == 16 else np.uint8
    codes = rng.randint(0, 1 << min(code_bits, 10), (n, num_cols)).astype(dt)
    g, h, lab = (rng.randn(n).astype(np.float32) for _ in range(3))
    jd = jplane.build_data(jl, jplane.build_codes_planes(jnp.asarray(codes),
                                                         jl),
                           jnp.asarray(g), jnp.asarray(h),
                           label=jnp.asarray(lab), score=jnp.asarray(g),
                           weight=jnp.asarray(h))
    t = torch.as_tensor
    td = tplane.build_data(tl, tplane.build_codes_planes(
        t(codes.astype(np.int32)), tl), t(g), t(h), label=t(lab),
        score=t(g), weight=t(h))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    # plane views round-trip
    np.testing.assert_array_equal(
        tplane.get_f32(td, tl.grad, n).numpy(), g)


@pytest.mark.parametrize("kw", [
    dict(feature=3, threshold=120, default_left=0, miss_bin=249),
    dict(feature=7, threshold=60, default_left=1, miss_bin=-1),
    dict(feature=2, threshold=0, default_left=0, miss_bin=-1, is_cat=1,
         cat_bitset=[5, -2147483648, 0, 7]),
    dict(feature=5, threshold=20, default_left=1, miss_bin=4, efb=True),
])
def test_route_scalars_byte_identical(kw):
    kw = dict(kw)
    efb = kw.pop("efb", False)
    jl = jplane.make_layout(12, 8, 4096)
    tl = tplane.make_layout(12, 8, 4096)
    tables = [np.arange(12), np.full(12, 3), np.full(12, 90),
              np.full(12, 7)]
    jt = tuple(jnp.asarray(a, jnp.int32) for a in tables) if efb else None
    tt = tuple(torch.as_tensor(a, dtype=torch.int32) for a in tables) \
        if efb else None
    jkw = dict(kw)
    if "cat_bitset" in jkw:
        jkw["cat_bitset"] = jnp.asarray(kw["cat_bitset"], jnp.int32)
    want = np.asarray(jplane.route_scalars(jl, efb_dev=jt, **jkw))
    got = tplane.route_scalars(tl, efb_dev=tt, **kw).numpy()
    np.testing.assert_array_equal(want, got)


# ---------------------------------------------------------------------------
# partition: bit-exact against partition_ref and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,count,feat,thr,dl", [
    (0, 4096, 3, 120, 0),        # full window
    (1234, 2000, 7, 60, 1),      # interior window, default-left
    (4000, 96, 0, 200, 0),       # tail window
    (17, 3, 5, 10, 1),           # tiny leaf
    (100, 3900, 3, 5, 0),        # nearly all right
    (100, 3900, 3, 245, 0),      # nearly all left
])
def test_partition_matches_pallas2_and_ref(start, count, feat, thr, dl):
    jl, jdata, tl, tdata, codes = _make_states(4096, 12, seed=start + count)
    jr = jplane.route_scalars(jl, feat, thr, dl, miss_bin=249)
    cap = _cap_for(jl, 4096)   # one capacity for every window: one compile
    ref, nl_ref = jplane.partition_ref(jdata, jl, start, count, jr, cap=cap)
    pal, nl_pal = jplane.partition_pallas2(jdata, jl, start, count, jr,
                                           cap=cap, interpret=True)
    tr = tplane.route_scalars(tl, feat, thr, dl, miss_bin=249)
    got, nl_got = tplane.partition(tdata, tl, start, count, tr)
    assert int(nl_got) == int(nl_ref) == int(nl_pal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


def test_partition_categorical_bitset_matches_pallas():
    jl, jdata, tl, tdata, codes = _make_states(2048, 6, seed=11)
    bitset = np.zeros(jplane.CAT_WORDS, dtype=np.uint32)
    for b in (3, 17, 42, 128, 200):
        bitset[b // 32] |= np.uint32(1 << (b % 32))
    bits = bitset.astype(np.int32)
    jr = jplane.route_scalars(jl, 2, 0, 0, miss_bin=-1, is_cat=1,
                              cat_bitset=bits)
    cap = _cap_for(jl, 2048)
    pal, nl_pal = jplane.partition_pallas(jdata, jl, 0, 2048, jr, cap=cap,
                                          interpret=True)
    tr = tplane.route_scalars(tl, 2, 0, 0, miss_bin=-1, is_cat=1,
                              cat_bitset=bits)
    got, nl_got = tplane.partition(tdata, tl, 0, 2048, tr)
    assert int(nl_got) == int(nl_pal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


def test_partition_4bit_packing_matches_pallas():
    jl, jdata, tl, tdata, codes = _make_states(2048, 9, seed=5, code_bits=4,
                                               max_code=16)
    cap = _cap_for(jl, 1500)
    jr = jplane.route_scalars(jl, 3, 7, 1, miss_bin=15)    # shift 12
    pal, nl_pal = jplane.partition_pallas(jdata, jl, 300, 1500, jr, cap=cap,
                                          interpret=True)
    got, nl_got = tplane.partition(
        tdata, tl, 300, 1500, tplane.route_scalars(tl, 3, 7, 1, miss_bin=15))
    assert int(nl_got) == int(nl_pal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("efb", [False, True])
def test_partition_stable_and_routes_by_code(efb):
    jl, jdata, tl, tdata, codes = _make_states(1024, 4, seed=3)
    tables = (torch.tensor([0, 1, 2, 3], dtype=torch.int32),
              torch.tensor([0, 0, 40, 0], dtype=torch.int32),
              torch.tensor([250, 250, 90, 250], dtype=torch.int32),
              torch.tensor([250, 250, 7, 250], dtype=torch.int32))
    rs = tplane.route_scalars(tl, 2, 30, 0, miss_bin=-1,
                              efb_dev=tables if efb else None)
    got, nl = tplane.partition(tdata, tl, 0, 1024, rs)
    rowids = got[tl.rowid, :1024].numpy()
    nl = int(nl)
    # stable: each side's rowids strictly increasing (input was iota)
    assert (np.diff(rowids[:nl]) > 0).all()
    assert (np.diff(rowids[nl:]) > 0).all()
    code = codes[rowids, 2].astype(np.int64)
    if efb:
        rel = code - 40
        code = np.where((rel >= 0) & (rel < 90), rel + (rel >= 7), 7)
    left = code <= 30
    assert left[:nl].all() and not left[nl:].any()
    jr = jplane.route_scalars(jl, 2, 30, 0, miss_bin=-1, efb_dev=None if
                              not efb else tuple(jnp.asarray(t.numpy())
                                                 for t in tables))
    ref, _ = jplane.partition_ref(jdata, jl, 0, 1024, jr,
                                  cap=_cap_for(jl, 1024))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# planar histogram against histogram_planar_pallas and histogram_scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("code_bits,num_bins", [(8, 255), (8, 64), (4, 16)])
def test_histogram_planar_matches_pallas(code_bits, num_bins, dtype):
    n, g = 2048, 7
    jl, jdata, tl, tdata, codes = _make_states(
        n, g, seed=code_bits + num_bins, code_bits=code_bits,
        max_code=num_bins)
    start, count = 200, 1500
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(histogram_planar_pallas(
        jdata, start, count, num_bins=num_bins, num_cols=g,
        code_bits=code_bits, grad_plane=jl.grad, cap=_cap_for(jl, count),
        dtype=jdt, rows_per_block=256, interpret=True))
    got = TH.hist_planar(
        tdata, start, count, num_bins=num_bins, num_cols=g,
        code_bits=code_bits, grad_plane=tl.grad,
        dtype=getattr(torch, dtype)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        grad = np.asarray(jplane.get_f32(jdata, jl.grad))[:n]
        hess = np.asarray(jplane.get_f32(jdata, jl.hess))[:n]
        sel = slice(start, start + count)
        oracle = np.asarray(jscatter(jnp.asarray(codes[sel]),
                                     jnp.asarray(grad[sel]),
                                     jnp.asarray(hess[sel]), num_bins))
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-4)
        # the port's row-major oracle equals its planar plain version
        np.testing.assert_array_equal(TH.histogram_scatter(
            torch.as_tensor(codes[sel].astype(np.int64)),
            torch.tensor(grad[sel]), torch.tensor(hess[sel]),
            num_bins).numpy(), got)
    else:
        # tests/test_kernels.py:165 tolerance for the bf16 input mode
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=0.3)


def test_histogram_planar_edge_windows():
    """count=0, a 3-row window, device-style 0-d tensor windows, and a
    window longer than one kernel tile (the tile association)."""
    n, g = 6000, 5
    jl, jdata, tl, tdata, codes = _make_states(n, g, seed=2)
    kw = dict(num_bins=250, num_cols=g, code_bits=8, grad_plane=tl.grad)
    assert float(TH.hist_planar(tdata, 10, 0, **kw).abs().sum()) == 0
    grad = tplane.get_f32(tdata, tl.grad, n)
    hess = tplane.get_f32(tdata, tl.hess, n)
    for start, count in ((17, 3), (5, 5000)):
        sel = slice(start, start + count)
        want = TH.histogram_scatter(
            torch.as_tensor(codes[sel].astype(np.int64)), grad[sel],
            hess[sel], 250)
        got = TH.hist_planar(
            tdata, torch.tensor(start, dtype=torch.int32),
            torch.tensor(count, dtype=torch.int32), max_count=n, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_hist_method_rule():
    """The port's dispatch names the JAX package's methods: None on the
    CPU, the planar/row-major kernels in tpu_hist_dtype on the card, and
    the multi-value layout for wide-sparse occupancy."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops.multival import OccupancyStats

    class _DS:
        occupancy = OccupancyStats(64, 2.0, 5, np.zeros(64, np.int32),
                                   np.zeros(64, np.float32), 100)

    cpu = Config.from_params({"device_type": "cpu"})
    assert TH.hist_method(cpu, _DS()) is None
    assert TH.hist_dtype(None, cpu) == torch.float32
    cuda = Config.from_params({"device": "gpu"})
    assert cuda.device_type == "cuda"
    planar = Config.from_params({"tpu_hist_layout": "planar"})
    assert TH.hist_method(planar, _DS()) == "radix_pallas_bf16"
    assert TH.hist_dtype("radix_pallas_bf16", planar) == torch.bfloat16
    f32 = Config.from_params({"tpu_hist_dtype": "float32"})
    assert TH.hist_method(f32) == "radix_pallas"
    assert TH.hist_dtype("radix_pallas", f32) == torch.float32
    assert TH.hist_method(cuda, _DS()) == "multival_pallas"
    assert TH.hist_dtype("multival_pallas", cuda) == torch.bfloat16
    assert TH.hist_dtype("multival_pallas", f32) == torch.float32
    assert TH.hist_dtype("multival_pallas", cpu) == torch.float32
    with pytest.raises(ValueError, match="partition_cuda"):
        tplane.partition_cuda(torch.zeros((8, 64), dtype=torch.int32),
                              tplane.make_layout(2, 8, 32), 0, 8,
                              torch.zeros(19, dtype=torch.int32))
    with pytest.raises(ValueError, match="hist_planar_cuda"):
        TH.hist_planar_cuda(torch.zeros((8, 64), dtype=torch.int32), 0, 8,
                            num_bins=4, num_cols=2, code_bits=8,
                            grad_plane=1)
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.ops.histogram import hist_layout as jlayout
    for p in ({}, {"tpu_hist_layout": "planar"}):
        assert TH.hist_layout(Config.from_params(p), _DS()) == \
            jlayout(JConfig.from_params(p), _DS())
