"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests skip without a CUDA
device; on a machine with one (which need not have JAX) run them with
``python -m pytest tests/test_torch_cuda.py -m cuda``. chip_smoke.py
runs the same comparisons at the main paths' full shapes."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import multival as TM
from lightgbm_tpu_torch.ops import plane as tplane
from lightgbm_tpu_torch.ops import quantize as TQ


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _state(n, g, seed):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 255, size=(n, g)).astype(np.int32)
    grad = rng.randn(n).astype(np.float32)
    hess = rng.rand(n).astype(np.float32)
    lay = tplane.make_layout(g, 8, n, with_label=True, with_score=True)
    t = torch.as_tensor
    data = tplane.build_data(lay, tplane.build_codes_planes(t(codes), lay),
                             t(grad), t(hess), label=t(grad), score=t(hess))
    return lay, data


def _dyadic(rng, n):
    """grad/hess on a dyadic grid: every partial sum is exact, so the
    kernel and the plain version agree bit for bit in any order."""
    g = (rng.randint(-1024, 1025, n) / 2048.0).astype(np.float32)
    h = (rng.randint(0, 1025, n) / 4096.0).astype(np.float32)
    return torch.as_tensor(g), torch.as_tensor(h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dtype):
    _need_card()
    lay, data = _state(50_000, 28, seed=4)
    dev = data.cuda()
    kw = dict(num_bins=255, num_cols=28, code_bits=8, grad_plane=lay.grad,
              dtype=dtype)
    for start, count in ((0, 50_000), (333, 20_001), (7, 3), (9, 0)):
        got = TH.hist_planar_cuda(dev, start, count, **kw)
        again = TH.hist_planar_cuda(dev, start, count, **kw)
        assert torch.equal(got, again)
        # the kernel sums in the plain version's association: bit for bit
        assert torch.equal(got.cpu(), TH.histogram_planar_plain(
            data, start, count, **kw))
        rs = tplane.route_scalars(lay, 3, 100, 1, miss_bin=7)
        a, na = tplane.partition_cuda(dev.clone(), lay, start, count,
                                      rs.cuda())
        b, nb = tplane.partition_plain(data.clone(), lay, start, count, rs)
        assert int(na) == int(nb)
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("num_bins,code_dtype", [
    (255, torch.uint8), (64, torch.uint8), (16, torch.int32),
    (1000, torch.int32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowmajor_kernels_match_plain(num_bins, code_dtype, dtype):
    """B4 (hist_radix_cuda) and B7 (hist_masked_cuda) against their plain
    versions: bit-exact on dyadic grad/hess, launch to launch identical,
    codes outside [0, num_bins) ignored."""
    _need_card()
    rng = np.random.RandomState(num_bins)
    for c in (9_000, 2_048, 1, 0):
        codes = rng.randint(0, num_bins, size=(c, 7))
        if c > 10:
            codes[5, 2] = num_bins + 3      # out of range: adds nothing
        bins = torch.as_tensor(codes).to(code_dtype)
        g, h = _dyadic(rng, c)
        got = TH.hist_radix_cuda(bins.cuda(), g.cuda(), h.cuda(), num_bins,
                                 dtype=dtype)
        again = TH.hist_radix_cuda(bins.cuda(), g.cuda(), h.cuda(), num_bins,
                                   dtype=dtype)
        want = TH.histogram_radix_plain(bins, g, h, num_bins, dtype)
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), want), (c, num_bins)
        if dtype == torch.float32:
            got7 = TH.hist_masked_cuda(bins.cuda(), g.cuda(), h.cuda(),
                                       num_bins)
            assert torch.equal(got7.cpu(),
                               TH.histogram_masked_plain(bins, g, h,
                                                         num_bins))


# (rows, columns, bins, code dtype): windows around the tile rule's
# breakpoints, more columns than a warp has lanes, and more bins than
# one column's histogram fits in shared memory (the wide-bin path)
RM_SHAPES = [(9_000, 7, 255, torch.uint8),
             (TH.RM_MIN_TILE - 1, 28, 255, torch.uint8),
             (TH.RM_MIN_TILE + 1, 28, 255, torch.uint8),
             (1, 28, 255, torch.uint8), (20_000, 40, 255, torch.uint8),
             (6_000, 3, 40_000, torch.int32)]


def _shape_id(shape):
    return "x".join(str(v) for v in shape[:3])


# (rows, columns, code bits, bins, largest code) of the planar
# histogram: HIGGS width, 4-bit codes, and 16-bit codes with more bins
# than one column's histogram fits in shared memory (the wide-bin path);
# codes at and above num_bins add nothing
PLANAR_SHAPES = [(30_000, 28, 8, 255, 255), (9_000, 9, 4, 14, 16),
                 (7_000, 3, 16, 40_000, 40_100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PLANAR_SHAPES, ids=_shape_id)
def test_planar_kernel_bit_exact_on_random_floats(shape):
    """B1 (float32 and bfloat16) on random, non-dyadic g/h equals the
    plain version run on the CPU bit for bit, at windows around the
    HIST_TILE-row tile, with host and device windows; B1q (packed
    levels) equals the plain int32 version."""
    _need_card()
    n, g, bits, nb, top = shape
    rng = np.random.RandomState(n + g)
    codes = rng.randint(0, top, size=(n, g)).astype(np.int32)
    grad = torch.as_tensor(rng.randn(n).astype(np.float32))
    hess = torch.as_tensor(rng.rand(n).astype(np.float32))
    lay = tplane.make_layout(g, bits, n, with_label=True, with_score=True)
    data = tplane.build_data(
        lay, tplane.build_codes_planes(torch.as_tensor(codes), lay), grad,
        hess, label=grad, score=hess)
    t = TH.HIST_TILE
    windows = ((0, n), (5, t - 1), (17, t), (3, t + 1), (n - 1, 1), (9, 0))
    kw = dict(num_bins=nb, num_cols=g, code_bits=bits, grad_plane=lay.grad)
    dev = data.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        for start, count in windows:
            got = TH.hist_planar_cuda(dev, start, count, dtype=dtype, **kw)
            dwin = TH.hist_planar_cuda(
                dev, torch.tensor(start, dtype=torch.int32, device="cuda"),
                torch.tensor(count, dtype=torch.int32, device="cuda"),
                dtype=dtype, max_count=n, **kw)
            want = TH.histogram_planar_plain(data, start, count, dtype=dtype,
                                             **kw)
            assert torch.equal(got, dwin), (shape, dtype, start, count)
            assert torch.equal(got.cpu(), want), (shape, dtype, start, count)
    qg, qh = _levels(rng, lay.num_lanes, 64)
    tplane.set_gh_packed(data, lay, tplane.i32_as_f32(TQ.pack_gh(qg, qh)))
    dev = data.cuda()
    for start, count in windows:
        got = TH.hist_planar_cuda(dev, start, count, quant=True, **kw)
        dwin = TH.hist_planar_cuda(
            dev, torch.tensor(start, dtype=torch.int32, device="cuda"),
            torch.tensor(count, dtype=torch.int32, device="cuda"),
            max_count=n, quant=True, **kw)
        want = TH.histogram_planar_plain(data, start, count, quant=True, **kw)
        assert got.dtype == torch.int32
        assert torch.equal(got, dwin), (shape, start, count)
        assert torch.equal(got.cpu(), want), (shape, start, count)


def _partition_state(n, mv_planes, seed):
    """A 28-column 8-bit state with label and score planes; with
    ``mv_planes`` = 112 slot planes, P = 128 (the wide-sparse width)."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 255, size=(n, 28)).astype(np.int32)
    grad = torch.as_tensor(rng.randn(n).astype(np.float32))
    lay = tplane.make_layout(28, 8, n, with_label=True, with_score=True,
                             mv_planes=mv_planes)
    mv = torch.as_tensor(rng.randint(-1, 900, size=(mv_planes, n)).astype(
        np.int32)) if mv_planes else None
    data = tplane.build_data(
        lay, tplane.build_codes_planes(torch.as_tensor(codes), lay), grad,
        grad, label=grad, score=grad, mv=mv)
    return lay, data


@pytest.mark.cuda
@pytest.mark.parametrize("mv_planes", [0, 112], ids=["P16", "P128"])
def test_partition_routes_bit_exact(mv_planes):
    """B2 on both routes (one block in place; tiles with look-back and
    a copy back) equals the plain version bit for bit at P = 16 and
    P = 128, call after call on the same stream (the status words'
    epochs), with the Python and C small-window rules agreeing."""
    _need_card()
    from lightgbm_tpu_torch.ops import cuda as K
    lib = K.lib("partition")
    assert lib.lgbt_partition_tile() == tplane.PART_TILE
    for P in (8, 16, 128):
        for c in (0, 1, 395, 396, 397, 1203, 1204, 3011, 3012, 10**6):
            assert bool(lib.lgbt_partition_small(P, c)) == \
                tplane.partition_small(P, c), (P, c)
    n = 70_000
    lay, data = _partition_state(n, mv_planes, seed=mv_planes)
    P = lay.num_planes
    assert P == (128 if mv_planes else 16)
    small = tplane.PART_SMALL_BYTES // (4 * (P + 1))
    t = tplane.PART_TILE
    windows = [(0, n), (11, small), (11, small + 1), (500, t - 1),
               (500, t + 1), (7, 30 * t + 3), (1, 1), (9, 0)]
    routes = set()
    dev, cpu = data.cuda(), data.clone()
    for k, (start, count) in enumerate(windows * 2):
        rs = tplane.route_scalars(lay, k % 28, 60 + 9 * k, k % 2,
                                  miss_bin=7 * k)
        routes.add(tplane.partition_small(P, count))
        a, na = tplane.partition_cuda(dev, lay, start, count, rs.cuda())
        b, nb = tplane.partition_plain(cpu, lay, start, count, rs)
        assert int(na) == int(nb), (P, start, count)
        assert torch.equal(a.cpu(), b), (P, start, count)
    assert routes == {True, False}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RM_SHAPES, ids=_shape_id)
def test_rowmajor_kernels_bit_exact_on_random_floats(shape):
    """B4 (float32 and bfloat16) and B7 on random, non-dyadic g/h: the
    kernel sums in the plain version's association, so it equals the
    plain version run on the CPU bit for bit, launch after launch."""
    _need_card()
    c, f, nb, cdt = shape
    rng = np.random.RandomState(c + f)
    codes = rng.randint(-1, nb + 1, size=(c, f)) if cdt == torch.int32 \
        else rng.randint(0, nb, size=(c, f))
    bins = torch.as_tensor(codes).to(cdt)
    g = torch.as_tensor(rng.randn(c).astype(np.float32))
    h = torch.as_tensor(rng.rand(c).astype(np.float32))
    db, dg, dh = bins.cuda(), g.cuda(), h.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        got = TH.hist_radix_cuda(db, dg, dh, nb, dtype=dtype)
        again = TH.hist_radix_cuda(db, dg, dh, nb, dtype=dtype)
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), TH.histogram_radix_plain(
            bins, g, h, nb, dtype)), (shape, dtype)
    assert torch.equal(TH.hist_masked_cuda(db, dg, dh, nb).cpu(),
                       TH.histogram_masked_plain(bins, g, h, nb)), shape


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RM_SHAPES[-2:], ids=_shape_id)
def test_quantized_rowmajor_wide_shapes(shape):
    """B4q and B7q at more than 32 columns and on the wide-bin path
    (global atomics): bit-equal to the plain int32 version."""
    _need_card()
    c, f, nb, cdt = shape
    rng = np.random.RandomState(c)
    bins = torch.as_tensor(rng.randint(0, nb, size=(c, f))).to(cdt)
    qg, qh = _levels(rng, c, 64)
    want = TH.histogram_radix_plain(bins, qg, qh, nb)
    for fn in (TH.hist_radix_cuda, TH.hist_masked_cuda):
        got = fn(bins.cuda(), qg.cuda(), qh.cuda(), nb)
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want), (fn.__name__, shape)


@pytest.mark.cuda
def test_rowmajor_tile_rule_matches_kernel():
    """The kernel's tile (lgbt_rm_tile) equals rowmajor_tile on a sweep
    of shapes: the plain version's association is the kernel's."""
    _need_card()
    from lightgbm_tpu_torch.ops import cuda as K
    lib = K.lib("hist_rowmajor")
    for c in (0, 1, 127, 128, 129, 16_384, 50_687, 50_689, 2_000_000,
              10_500_000):
        for f, nb in ((28, 255), (40, 255), (9, 16), (2, 60_000),
                      (28, 65_534)):
            assert lib.lgbt_rm_tile(c, f, nb) == TH.rowmajor_tile(c, f, nb), \
                (c, f, nb)


# windows of the multi-value checks: full, unaligned, 1 row, empty, and
# windows straddling the kernels' 512-row tiles
MV_WINDOWS = [(0, 5_000), (777, 3_001), (4_000, 1), (10, 0), (3, 512),
              (0, 511), (100, 513), (1_000, 1_537), (480, 4_500)]


def _mv_state(n, groups, seed, k=16):
    """A random row-wise code matrix: each row has up to k-1 present
    groups (distinct), sentinel in slot 0, -1 pads."""
    rng = np.random.RandomState(seed)
    gnb = rng.randint(2, 9, size=groups).astype(np.int32)
    bins = np.zeros((n, groups), np.int32)
    for i in range(n):
        present = rng.choice(groups, size=rng.randint(0, k), replace=False)
        bins[i, present] = [rng.randint(1, gnb[p]) for p in present]
    codes, lay = TM.build_rowwise_codes(bins, gnb, np.zeros(groups,
                                                            np.int32))
    return codes, lay


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [40, 3000])     # T in / beyond a block
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multival_kernels_match_plain(groups, dtype):
    """B5 (planar state, host and device windows) and B6 (slot-major
    codes) on random float grad/hess, bit for bit against their plain
    versions on the CPU (each cell in row order inside 512-row tiles,
    the tiles in order), at windows straddling the tiles; 3000 groups
    split the cells over the grid's second dimension."""
    _need_card()
    n = 5_000
    codes, lay = _mv_state(n, groups, seed=groups)
    T = lay.total_bins
    from lightgbm_tpu_torch.ops import cuda as K
    smem_cells = K.lib("hist_multival").lgbt_mv_smem_cells()
    assert (T + 1 > smem_cells) == (groups > 100), (T, smem_cells)
    rng = np.random.RandomState(1)
    g = torch.as_tensor(rng.randn(n).astype(np.float32))
    h = torch.as_tensor(rng.rand(n).astype(np.float32))
    sm = TM.slot_major(torch.as_tensor(codes))
    gh = TM.gh_planes(g, h)
    tl = tplane.make_layout(4, 8, n, with_label=True, with_score=True,
                            mv_planes=sm.shape[0])
    data = tplane.build_data(
        tl, tplane.build_codes_planes(torch.zeros((n, 4), dtype=torch.int32),
                                      tl), g, h, mv=sm)
    dd, smc, ghc = data.cuda(), sm.cuda(), gh.cuda()
    kw = dict(mv_start=tl.mv_start, mv_planes=tl.mv_planes, total_bins=T,
              grad_plane=tl.grad, dtype=dtype)
    for start, count in MV_WINDOWS:
        want = TM.histogram_multival_planar_plain(data, start, count, **kw)
        a = TM.hist_multival_planar_cuda(dd, start, count, **kw)
        b = TM.hist_multival_planar_cuda(
            dd, torch.tensor(start, dtype=torch.int32, device="cuda"),
            torch.tensor(count, dtype=torch.int32, device="cuda"),
            max_count=n, **kw)
        c = TM.hist_multival_cuda(smc[:, start:start + count],
                                  ghc[:, start:start + count], total_bins=T,
                                  dtype=dtype)
        for got in (a, b, c):
            assert torch.equal(got.cpu(), want), (start, count)


def _levels(rng, n, num_bins):
    """int32 quantized levels, qg at its negative extreme every 7th row
    (the sign-carrying unpack)."""
    qmax_g, qmax_h = TQ.grad_levels(num_bins)
    qg = rng.randint(-qmax_g, qmax_g + 1, n).astype(np.int32)
    qh = rng.randint(0, qmax_h + 1, n).astype(np.int32)
    qg[::7] = -qmax_g
    return torch.as_tensor(qg), torch.as_tensor(qh)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [4, 64])
def test_quantized_planar_and_rowmajor_kernels_match_plain(levels):
    """B1q (packed words in the grad plane), B4q and B7q (int32 levels)
    against their plain int32 versions, bit for bit."""
    _need_card()
    n = 50_000
    lay, data = _state(n, 28, seed=levels)
    qg, qh = _levels(np.random.RandomState(levels), lay.num_lanes, levels)
    tplane.set_gh_packed(data, lay, tplane.i32_as_f32(TQ.pack_gh(qg, qh)))
    dev = data.cuda()
    kw = dict(num_bins=255, num_cols=28, code_bits=8, grad_plane=lay.grad,
              quant=True)
    for start, count in ((0, n), (333, 20_001), (n - 1, 1), (9, 0)):
        got = TH.hist_planar_cuda(dev, start, count, **kw)
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), TH.histogram_planar_plain(
            data, start, count, **kw)), (start, count)
    rng = np.random.RandomState(levels)
    for c in (9_000, 1, 0):
        bins = torch.as_tensor(rng.randint(0, 255, size=(c, 7))).to(
            torch.uint8)
        g, h = qg[:c], qh[:c]
        want = TH.histogram_radix_plain(bins, g, h, 255)
        for fn in (TH.hist_radix_cuda, TH.hist_masked_cuda):
            got = fn(bins.cuda(), g.cuda(), h.cuda(), 255)
            assert got.dtype == torch.int32
            assert torch.equal(got.cpu(), want), (fn.__name__, c)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [40, 3000, 7000])   # int32 smem / global
def test_quantized_multival_kernels_match_plain(groups):
    """B5q (host and device windows) and B6q against their plain int32
    versions, bit for bit, at windows straddling the tiles; 7000 groups
    put the histogram beyond the int32 mode's shared memory (global
    atomics)."""
    _need_card()
    n = 5_000
    codes, lay = _mv_state(n, groups, seed=groups)
    T = lay.total_bins
    from lightgbm_tpu_torch.ops import cuda as K
    q_cells = K.lib("hist_multival").lgbt_mv_quant_smem_cells()
    assert (T + 1 > q_cells) == (groups > 5000), (T, q_cells)
    qg, qh = _levels(np.random.RandomState(groups), n, 64)
    sm = TM.slot_major(torch.as_tensor(codes))
    gh = TM.gh_planes(qg, qh, quant=True)
    tl = tplane.make_layout(4, 8, n, with_label=True, with_score=True,
                            mv_planes=sm.shape[0])
    zero = torch.zeros(n)
    data = tplane.build_data(
        tl, tplane.build_codes_planes(torch.zeros((n, 4), dtype=torch.int32),
                                      tl), zero, zero, mv=sm)
    tplane.set_gh_packed(data, tl, tplane.i32_as_f32(TQ.pack_gh(qg, qh)))
    dd, smc, ghc = data.cuda(), sm.cuda(), gh.cuda()
    kw = dict(mv_start=tl.mv_start, mv_planes=tl.mv_planes, total_bins=T,
              grad_plane=tl.grad, quant=True)
    for start, count in MV_WINDOWS:
        want = TM.histogram_multival_planar_plain(data, start, count, **kw)
        a = TM.hist_multival_planar_cuda(dd, start, count, **kw)
        b = TM.hist_multival_planar_cuda(
            dd, torch.tensor(start, dtype=torch.int32, device="cuda"),
            torch.tensor(count, dtype=torch.int32, device="cuda"),
            max_count=n, **kw)
        c = TM.hist_multival_cuda(smc[:, start:start + count],
                                  ghc[:, start:start + count], total_bins=T,
                                  quant=True)
        for got in (a, b, c):
            assert got.dtype == torch.int32
            assert torch.equal(got.cpu(), want), (start, count)


@pytest.mark.cuda
def test_xla_float_on_card_equals_cpu():
    """exp_f32, fma_f32 and the binary gradients give the CPU's bits on
    the card (float64 emulation of the fused multiply-adds)."""
    _need_card()
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective.functions import BinaryLogloss
    from lightgbm_tpu_torch.ops import xla_float as XF
    bits = np.arange(0, 1 << 32, 4099, dtype=np.uint64).astype(np.uint32)
    x = torch.as_tensor(bits.view(np.float32))
    a, b = XF.exp_f32(x), XF.exp_f32(x.cuda()).cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                           & b.isnan())
    assert bool(same.all())
    rng = np.random.RandomState(0)
    t = [torch.as_tensor((rng.randn(1 << 20) * np.exp(
        rng.uniform(-20, 20, 1 << 20))).astype(np.float32))
        for _ in range(3)]
    got = XF.fma_f32(*(v.cuda() for v in t)).cpu()
    assert torch.equal(got.view(torch.int32), XF.fma_f32(*t).view(torch.int32))

    class _Meta:
        label = (rng.rand(1 << 20) > 0.5).astype(np.float32)
        weights = rng.uniform(0.5, 2, 1 << 20).astype(np.float32)
    obj = BinaryLogloss(Config.from_params({"objective": "binary"}))
    obj.init(_Meta, 1 << 20)
    score = torch.as_tensor((rng.randn(1 << 20) * 4).astype(np.float32))
    for c, g in zip(obj.get_gradients(score), obj.get_gradients(score.cuda())):
        assert torch.equal(c.view(torch.int32), g.cpu().view(torch.int32))


@pytest.mark.cuda
def test_cuda_training_matches_cpu():
    _need_card()
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 8)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.randn(5000) > 0).astype(float)
    for extra in ({}, {"tpu_fused": False, "extra_trees": True},
                  {"use_quantized_grad": True},
                  {"use_quantized_grad": True, "tpu_fused": False}):
        preds, trees = [], []
        for dev in ("cuda", "cpu"):
            b = lgt.train({"objective": "binary", "device_type": dev,
                           "tpu_hist_dtype": "float32", "verbose": -1,
                           **extra},
                          lgt.Dataset(X, label=y), num_boost_round=3,
                          verbose_eval=False)
            preds.append(b.predict(X))
            trees.append(b._gbdt.models)
        np.testing.assert_allclose(preds[0], preds[1], atol=1e-6)
        for a, c in zip(*trees):
            k = a.num_leaves
            assert k == c.num_leaves
            for f in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
                np.testing.assert_array_equal(getattr(a, f)[:k - 1],
                                              getattr(c, f)[:k - 1])
