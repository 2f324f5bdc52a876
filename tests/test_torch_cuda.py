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
@pytest.mark.parametrize("mv_planes", [0, 112], ids=["P16", "P128"])
def test_partition_device_window_bit_exact(mv_planes):
    """B2's device-window entry (the window a [2] tensor on the card,
    the route chosen on the device, every launch sized by one bound)
    equals the plain version bit for bit on both routes and at a zero
    count, call after call on one set of buffers (the device epoch),
    and inside a replayed CUDA graph."""
    _need_card()
    from lightgbm_tpu_torch.ops import cuda as K
    lib = K.lib("partition")
    for P in (16, 128):
        for bound in (0, 395, 3012, 70_000, 2_000_000):
            assert lib.lgbt_partition_dev_status_words(P, bound) == \
                tplane.dev_status_words(P, bound), (P, bound)
    n = 70_000
    lay, data = _partition_state(n, mv_planes, seed=mv_planes + 1)
    P = lay.num_planes
    small = tplane.PART_SMALL_BYTES // (4 * (P + 1))
    t = tplane.PART_TILE
    windows = [(0, n), (11, small), (11, small + 1), (500, t - 1),
               (500, t + 1), (7, 30 * t + 3), (1, 1), (9, 0)]
    bufs = tplane.PartitionBuffers(P, n, "cuda")
    dev, cpu = data.cuda(), data.clone()
    routes = set()
    for k, (start, count) in enumerate(windows * 2):
        rs = tplane.route_scalars(lay, k % 28, 60 + 9 * k, k % 2,
                                  miss_bin=7 * k)
        routes.add(tplane.partition_small(P, count))
        win = torch.tensor([start, count], dtype=torch.int32,
                           device="cuda")
        a, na = tplane.partition_dev_cuda(dev, lay, win, rs.cuda(), bufs)
        b, nb = tplane.partition_plain(cpu, lay, start, count, rs)
        assert int(na) == int(nb), (P, start, count)
        assert torch.equal(a.cpu(), b), (P, start, count)
    assert routes == {True, False}
    # captured once, replayed over windows written into its input
    win = torch.zeros(2, dtype=torch.int32, device="cuda")
    rs = tplane.route_scalars(lay, 3, 100, 1, miss_bin=7).cuda()
    tplane.partition_dev_cuda(dev, lay, win, rs, bufs)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _, nl = tplane.partition_dev_cuda(dev, lay, win, rs, bufs)
    for start, count in windows:
        win.copy_(torch.tensor([start, count], dtype=torch.int32))
        g.replay()
        b, nb = tplane.partition_plain(cpu, lay, start, count, rs.cpu())
        assert int(nl) == int(nb) and torch.equal(dev.cpu(), b), \
            (P, start, count)


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


def _cat_data(n, seed):
    """4 numerical columns and categorical columns of 3, 24 and 100
    levels (NaN in the last)."""
    rng = np.random.RandomState(seed)
    X = np.column_stack([rng.randn(n, 4), rng.randint(0, 3, n),
                         rng.randint(0, 24, n),
                         rng.randint(0, 100, n).astype(float)])
    X[rng.rand(n) < 0.02, 6] = np.nan
    eff = rng.randn(100)
    y = (X[:, 0] + eff[np.nan_to_num(X[:, 6]).astype(int)] * 0.8
         + (X[:, 5] % 3 == 1) + rng.randn(n) > 0.5).astype(float)
    return X, y, [4, 5, 6]


@pytest.mark.cuda
def test_categorical_training_on_card_equals_cpu():
    """Categorical training on both learners: the card's trees (bitset
    pools included) equal the CPU's; predictions through the packed
    forest agree with early stop off and on."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    X, y, cats = _cat_data(8000, 0)
    for extra in ({}, {"tpu_fused": False}):
        out = []
        for dev in ("cuda", "cpu"):
            b = lgt.train({"objective": "binary", "device_type": dev,
                           "tpu_hist_dtype": "float32", "verbose": -1,
                           "categorical_feature": cats, **extra},
                          lgt.Dataset(X, label=y), num_boost_round=3,
                          verbose_eval=False)
            cfg = b._gbdt.config
            p = [b.predict(X)]
            cfg.pred_early_stop, cfg.pred_early_stop_freq = True, 1
            cfg.pred_early_stop_margin = 1.0
            p.append(b.predict(X, raw_score=True))
            cfg.pred_early_stop = False
            out.append((b._gbdt.models, p))
        (tg, pg), (tc, pc) = out
        assert sum(t.num_cat for t in tg) > 0
        for a, c in zip(tg, tc):
            k = a.num_leaves
            assert k == c.num_leaves
            for f in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
                np.testing.assert_array_equal(getattr(a, f)[:k - 1],
                                              getattr(c, f)[:k - 1])
            for f in ("cat_boundaries", "cat_threshold",
                      "cat_boundaries_inner", "cat_threshold_inner"):
                assert list(getattr(a, f)) == list(getattr(c, f)), f
        for a, c in zip(pg, pc):
            np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_traverse_and_forest_on_card_equal_cpu():
    """ops/traverse.py (through Tree.leaf_index_binned / leaf_index_raw)
    and models/forest.py PackedForest on the card against the same
    functions on the CPU, bit for bit, on a categorical model (trees
    twelve times over: two forest blocks)."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models.forest import PackedForest
    X, y, cats = _cat_data(4000, 1)
    b = lgt.train({"objective": "binary", "device_type": "cpu",
                   "verbose": -1, "categorical_feature": cats},
                  lgt.Dataset(X, label=y), num_boost_round=6,
                  verbose_eval=False)
    trees = b._gbdt.models
    assert sum(t.num_cat for t in trees) > 0
    x = torch.as_tensor(X.astype(np.float32))
    ds = b._gbdt.train_data
    bins = torch.as_tensor(ds.bins.astype(np.int32))
    miss = b._gbdt._fused.feature_miss_bin
    for t in trees:
        assert torch.equal(t.leaf_index_raw(x.cuda()).cpu(),
                           t.leaf_index_raw(x))
        assert torch.equal(t.leaf_index_binned(bins.cuda(), miss.cuda()).cpu(),
                           t.leaf_index_binned(bins, miss))
    for reps in (1, 12):
        fc = PackedForest(trees * reps, 1, "cuda")
        fh = PackedForest(trees * reps, 1, "cpu")
        for fn in (lambda f, v: f.raw_scores(v),
                   lambda f, v: f.leaf_indices(v),
                   lambda f, v: f.raw_scores_early_stop(v, 1, 1.0),
                   lambda f, v: f.raw_scores_early_stop(v, 3, 2.5)):
            got, want = fn(fc, x.cuda()).cpu(), fn(fh, x)
            assert torch.equal(got.view(torch.int32)
                               if got.dtype == torch.float32 else got,
                               want.view(torch.int32)
                               if want.dtype == torch.float32 else want)


# the regression family and cross-entropy (objective, its params)
REG_OBJECTIVES = [("regression", {}), ("regression", {"reg_sqrt": True}),
                  ("regression_l1", {}), ("huber", {"alpha": 0.7}),
                  ("fair", {"fair_c": 0.9}), ("poisson", {}),
                  ("quantile", {"alpha": 0.8}), ("mape", {}),
                  ("gamma", {}), ("tweedie", {"tweedie_variance_power": 1.3}),
                  ("cross_entropy", {})]


def _reg_meta(objective, n, rng, weighted):
    if objective in ("poisson", "gamma", "tweedie"):
        y = rng.gamma(2.0, 1.0, n) * (rng.rand(n) < 0.8
                                      if objective == "tweedie" else 1)
    elif objective == "cross_entropy":
        y = rng.rand(n)
    else:
        y = rng.standard_cauchy(n) * 2

    class _Meta:
        label = y.astype(np.float32)
        weights = rng.uniform(0.5, 2, n).astype(np.float32) if weighted \
            else None
    return _Meta


@pytest.mark.cuda
@pytest.mark.parametrize("objective,extra", REG_OBJECTIVES)
def test_cuda_regression_objectives_match_cpu(objective, extra):
    """Both gradient forms, convert_output and the default metric of each
    objective on the card against the CPU: gradients and conversions bit
    for bit, the metric within 1e-7 relative (float64 sums in another
    order, rounded to float32 for l2 and l1)."""
    _need_card()
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric.metrics import create_metric
    from lightgbm_tpu_torch.objective.functions import create_objective
    n = 1 << 20
    rng = np.random.RandomState(1)
    for weighted in (False, True):
        meta = _reg_meta(objective, n, rng, weighted)
        cfg = Config.from_params({"objective": objective, **extra})
        obj = create_objective(cfg)
        obj.init(meta, n)
        score = torch.as_tensor((rng.randn(n) * 2).astype(np.float32))
        label, w = (torch.as_tensor(np.asarray(a, np.float32))
                    if a is not None else None
                    for a in obj.persistent_aux())
        pairs = list(zip(obj.get_gradients(score),
                         obj.get_gradients(score.cuda())))
        pairs += list(zip(
            obj.persistent_grads(score, label, w),
            obj.persistent_grads(score.cuda(), label.cuda(),
                                 None if w is None else w.cuda())))
        pairs.append((obj.convert_output(score),
                      obj.convert_output(score.cuda())))
        for c, g in pairs:
            assert torch.equal(c.view(torch.int32), g.cpu().view(torch.int32))
        m = create_metric(cfg.metric[0], cfg)
        m.init(meta, n)
        (_, c), = m.eval_device(score, obj)
        (_, g), = m.eval_device(score.cuda(), obj)
        np.testing.assert_allclose(float(g), float(c), rtol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("objective,extra", [
    ("regression", {}), ("regression_l1", {}),
    ("quantile", {"alpha": 0.9}), ("mape", {}), ("gamma", {})])
def test_cuda_regression_training_matches_cpu(objective, extra):
    """Regression trainings on the card against the CPU on both learners,
    the percentile refits included: the same trees, leaf values and
    predictions, bit for bit."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 8)
    y = np.abs(X[:, 0] - X[:, 1] * X[:, 2] + rng.randn(5000)) + 0.1
    w = rng.uniform(0.5, 2, 5000)
    for learner in ({}, {"tpu_fused": False}):
        out = []
        for dev in ("cuda", "cpu"):
            b = lgt.train({"objective": objective, "device_type": dev,
                           "tpu_hist_dtype": "float32", "verbose": -1,
                           **extra, **learner},
                          lgt.Dataset(X, label=y, weight=w),
                          num_boost_round=3, verbose_eval=False)
            out.append((b._gbdt.models, b.predict(X, raw_score=True)))
        (tg, pg), (tc, pc) = out
        for a, b in zip(tg, tc):
            k = a.num_leaves
            assert k == b.num_leaves
            for f in ("split_feature", "threshold", "left_child",
                      "right_child"):
                assert np.array_equal(getattr(a, f)[:k - 1],
                                      getattr(b, f)[:k - 1]), f
            assert np.array_equal(a.leaf_value[:k], b.leaf_value[:k])
        assert np.array_equal(pg, pc)


def _grow_device_pair(X, y, params, wide=False, bag=None):
    """grow_device's tree arrays and leaf_of_row on the card and on the
    CPU for the same row-order gradients (random, non-dyadic); ``bag``:
    the fraction of rows in a random [bag | oob] permutation (the bag
    branch; ``params`` must turn bagging on)."""
    import scipy.sparse as sp
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    from lightgbm_tpu_torch.treelearner.fused import FusedSerialGrower
    rng = np.random.RandomState(2)
    n = len(y)
    g = torch.as_tensor(rng.randn(n).astype(np.float32))
    h = torch.as_tensor((rng.rand(n) + 0.1).astype(np.float32))
    perm = cnt = None
    if bag is not None:
        cnt = int(n * bag)
        rows = np.sort(rng.choice(n, cnt, replace=False))
        perm = torch.as_tensor(np.concatenate(
            [rows, np.setdiff1d(np.arange(n), rows)]))
    out = []
    for dev in ("cuda", "cpu"):
        cfg = Config.from_params({**params, "tpu_hist_dtype": "float32",
                                  "device_type": dev})
        ds = BinnedDataset.from_matrix(sp.csr_matrix(X) if wide else X,
                                       cfg, label=y)
        fl = FusedSerialGrower(ds, cfg, None, dev)
        ta, leaf = fl.grow_device(g.to(dev), h.to(dev),
                                  None if perm is None else perm.to(dev), cnt)
        out.append((fl, fl.read_trees([ta])[0], leaf.cpu()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["dense_B1", "wide_B5"])
def test_grow_device_on_card_equals_cpu(wide, monkeypatch):
    """The per-tree fused path on the card (B1 + B2 on dense data; B5 +
    B2 on the wide-sparse multi-value layout, which the CPU learner takes
    too when it is forced: B5's plain version) against the CPU: the same
    tree arrays and leaf_of_row, bit for bit."""
    _need_card()
    rng = np.random.RandomState(0)
    if wide:
        monkeypatch.setattr(TH, "hist_method",
                            lambda config, dataset=None: "multival_pallas")
        from chip_smoke import make_wide_like
        X, y = make_wide_like(60_000)
        params = {"objective": "multiclass", "num_class": 3,
                  "num_leaves": 63, "verbose": -1}
        y = (y + (rng.rand(len(y)) < 0.3)).astype(np.float32)
    else:
        X = rng.randn(60_000, 12)
        y = rng.randint(0, 3, 60_000).astype(np.float32)
        params = {"objective": "multiclass", "num_class": 3,
                  "num_leaves": 63, "verbose": -1}
    (fg, tg, lg), (fc, tc, lc) = _grow_device_pair(X, y, params, wide)
    if wide:
        assert fg.layout.mv_planes == fc.layout.mv_planes > 0
    assert tg["n_leaves"] == tc["n_leaves"] > 2
    for key, v in tg.items():
        assert np.array_equal(np.asarray(v), np.asarray(tc[key])), key
    assert torch.equal(lg, lc)


@pytest.mark.cuda
def test_multiclass_booster_on_card_equals_cpu():
    """A K = 3 multiclass booster, both learners, on the card and on the
    CPU: trees, leaf values and probabilities bit for bit."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(5)
    X = rng.randn(20_000, 10)
    y = np.digitize(X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(20_000) * 0.3,
                    [-0.5, 0.5]).astype(np.float32)
    for learner in ({}, {"tpu_fused": False}):
        out = []
        for dev in ("cuda", "cpu"):
            b = lgt.train({"objective": "multiclass", "num_class": 3,
                           "device_type": dev, "tpu_hist_dtype": "float32",
                           "verbose": -1, **learner},
                          lgt.Dataset(X, label=y), num_boost_round=3,
                          verbose_eval=False)
            out.append((b._gbdt.models, b.predict(X)))
        (tg, pg), (tc, pc) = out
        assert len(tg) == len(tc) == 9
        for a, b in zip(tg, tc):
            k = a.num_leaves
            assert k == b.num_leaves
            assert np.array_equal(a.split_feature[:k - 1],
                                  b.split_feature[:k - 1])
            assert np.array_equal(a.leaf_value[:k], b.leaf_value[:k])
        assert pg.shape == (20_000, 3) and np.array_equal(pg, pc)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["dense_B1", "wide_B5"])
def test_bag_branch_on_card_equals_cpu(wide, monkeypatch):
    """grow_device's bag branch (the bag-ordered state gathered and
    packed per tree, B1 or B5 and B2 on the bag's lanes, every row's
    leaf by traversal) on the card against the CPU: the same tree arrays
    and leaf_of_row, bit for bit."""
    _need_card()
    rng = np.random.RandomState(1)
    params = {"objective": "binary", "num_leaves": 63, "verbose": -1,
              "bagging_fraction": 0.8, "bagging_freq": 1}
    if wide:
        monkeypatch.setattr(TH, "hist_method",
                            lambda config, dataset=None: "multival_pallas")
        from chip_smoke import make_wide_like
        X, y = make_wide_like(60_000)
    else:
        X = rng.randn(60_000, 12)
        y = (X[:, 0] + rng.randn(60_000) > 0).astype(np.float32)
    (fg, tg, lg), (fc, tc, lc) = _grow_device_pair(X, y, params, wide,
                                                   bag=0.8)
    assert not fg._score_from_partition and not fc._score_from_partition
    assert tg["n_leaves"] == tc["n_leaves"] > 2
    for key, v in tg.items():
        assert np.array_equal(np.asarray(v), np.asarray(tc[key])), key
    assert torch.equal(lg, lc)


@pytest.mark.cuda
def test_goss_sampling_reads_nothing_back():
    """One GOSS round on the card under sync debug mode "error" (any
    host read raises), then bit for bit against the CPU."""
    _need_card()
    from lightgbm_tpu_torch.boosting.gbdt import goss_sample
    rng = np.random.RandomState(3)
    n = 200_000
    g = rng.randint(-8, 9, (1, n)).astype(np.float32) / 16
    h = rng.randint(1, 9, (1, n)).astype(np.float32) / 16
    dg, dh = torch.as_tensor(g).cuda(), torch.as_tensor(h).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = goss_sample(dg, dh, 12345, n // 5, n // 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = goss_sample(torch.as_tensor(g), torch.as_tensor(h), 12345,
                       n // 5, n // 10)
    for a, b in zip(out, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_rf_model_on_card_equals_cpu():
    """An RF model (averaged output) trained on the CPU predicts the
    same on the card and on the CPU, raw and transformed, through the
    path forest and the walker (prediction early stop)."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(4)
    X = rng.randn(20_000, 8)
    y = (X[:, 0] - X[:, 1] + rng.randn(20_000) > 0).astype(np.float32)
    b = lgt.train({"boosting": "rf", "bagging_fraction": 0.632,
                   "bagging_freq": 1, "feature_fraction": 0.8,
                   "objective": "binary", "device_type": "cpu",
                   "verbose": -1}, lgt.Dataset(X, label=y),
                  num_boost_round=5, verbose_eval=False)
    text = b.model_to_string()
    assert "average_output" in text
    for early in (False, True):
        preds = []
        for dev in ("cuda", "cpu"):
            m = lgt.Booster(params={"device_type": dev}, model_str=text)
            if early:
                from lightgbm_tpu_torch.config import Config
                m._gbdt.config = Config.from_params(
                    {"pred_early_stop": True, "pred_early_stop_margin": 1e9,
                     "device_type": dev})
            preds.append((m.predict(X, raw_score=True), m.predict(X)))
        for a, c in zip(*preds):
            assert np.array_equal(a, c)


def _card_and_cpu_models(params, X, y, rounds=3, **train_kw):
    """The same training on the card and on the CPU: (models, booster)
    per device."""
    import lightgbm_tpu_torch as lgt
    out = []
    for dev in ("cuda", "cpu"):
        b = lgt.train({"verbose": -1, "tpu_hist_dtype": "float32",
                       **params, "device_type": dev},
                      lgt.Dataset(X, label=y, free_raw_data=False),
                      num_boost_round=rounds, verbose_eval=False,
                      **{k: (v(dev) if callable(v) else v)
                         for k, v in train_kw.items()})
        out.append((b._gbdt.models, b))
    return out


def _assert_same_models(tg, tc):
    assert len(tg) == len(tc)
    for a, b in zip(tg, tc):
        k = a.num_leaves
        assert k == b.num_leaves
        for f in ("split_feature", "threshold", "split_gain"):
            assert np.array_equal(getattr(a, f)[:k - 1],
                                  getattr(b, f)[:k - 1]), f
        assert np.array_equal(a.leaf_value[:k], b.leaf_value[:k])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {}, {"bagging_fraction": 0.8, "bagging_freq": 1},
    {"use_quantized_grad": True}, {"tpu_fused": False}],
    ids=["persistent", "bagging", "quantized", "host_loop"])
def test_forced_splits_on_card_equal_cpu(extra, tmp_path):
    """Forced splits on the card (the fused forced phase through B2 and
    B1, or the host loop's B4) against the CPU, bit for bit."""
    _need_card()
    import json
    rng = np.random.RandomState(6)
    X = rng.randn(30_000, 10)
    y = (X[:, 0] + X[:, 3] * X[:, 4] + rng.randn(30_000) > 0
         ).astype(np.float32)
    path = str(tmp_path / "forced.json")
    with open(path, "w") as fh:
        json.dump({"feature": 3, "threshold": 0.0,
                   "left": {"feature": 4, "threshold": 0.5},
                   "right": {"feature": 0, "threshold": -0.25}}, fh)
    (tg, bg), (tc, bc) = _card_and_cpu_models(
        {"objective": "binary", "num_leaves": 63,
         "forcedsplits_filename": path, **extra}, X, y)
    _assert_same_models(tg, tc)
    assert all(list(t.split_feature[:3]) == [3, 4, 0] for t in tg)
    assert np.array_equal(bg.predict(X, raw_score=True),
                          bc.predict(X, raw_score=True))


@pytest.mark.cuda
def test_model_file_round_trip_on_card(tmp_path):
    """save_model, then Booster(model_file=...) on the card: raw
    predictions bit-equal to the booster that wrote the file."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(7)
    X = rng.randn(20_000, 8)
    y = (X[:, 0] - X[:, 1] + rng.randn(20_000) > 0).astype(np.float32)
    b = lgt.train({"objective": "binary", "verbose": -1,
                   "device_type": "cuda"}, lgt.Dataset(X, label=y),
                  num_boost_round=5, verbose_eval=False)
    path = str(tmp_path / "model.txt")
    b.save_model(path)
    loaded = lgt.Booster(params={"device_type": "cuda"}, model_file=path)
    assert np.array_equal(loaded.predict(X, raw_score=True),
                          b.predict(X, raw_score=True))
    assert loaded.model_to_string() == b.model_to_string()


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["fused", "host_loop"])
def test_init_model_on_card_equals_cpu(learner, tmp_path):
    """Continued training from a model file on the card against the
    CPU: the same trees and raw predictions, bit for bit."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(8)
    X = rng.randn(20_000, 8)
    y = (X[:, 0] * X[:, 1] + rng.randn(20_000) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 31,
              "tpu_fused": learner == "fused"}

    def first_model(dev):
        b = lgt.train({**params, "verbose": -1, "device_type": dev,
                       "tpu_hist_dtype": "float32"},
                      lgt.Dataset(X, label=y), num_boost_round=2,
                      verbose_eval=False)
        path = str(tmp_path / f"first_{dev}.txt")
        b.save_model(path)
        return path
    (tg, bg), (tc, bc) = _card_and_cpu_models(params, X, y, rounds=2,
                                              init_model=first_model)
    assert len(tg) == 4
    _assert_same_models(tg, tc)
    assert np.array_equal(bg.predict(X, raw_score=True),
                          bc.predict(X, raw_score=True))


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_ranking_gradients_on_card_equal_cpu(objective):
    """The ranking gradients on the card against the CPU, bit for bit,
    for every bucket size chip_smoke.py's MSLR-shaped data produces (8 to
    2048 documents; a query of one document, the ends of each bucket),
    on random scores, on tied scores, and with signed zeros."""
    _need_card()
    import types
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective.rank import LambdarankNDCG, RankXENDCG
    sizes = [1, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 256, 257, 512,
             513, 1024, 1025, 1250, 2048] + list(
                 np.random.RandomState(0).randint(1, 300, 60))
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    rng = np.random.RandomState(1)
    n = int(bounds[-1])
    meta = types.SimpleNamespace(
        label=rng.randint(0, 5, n).astype(np.float64), weights=None,
        query_boundaries=bounds)
    cls = LambdarankNDCG if objective == "lambdarank" else RankXENDCG
    objs = {}
    for dev in ("cuda", "cpu"):
        objs[dev] = cls(Config.from_params({"objective": objective,
                                            "device_type": dev}))
        objs[dev].init(meta, n)
    assert sorted({m for m, _ in objs["cpu"]._chunks}) == [
        8, 16, 32, 64, 128, 256, 512, 1024, 2048]
    s = (rng.randn(n) * 2).astype(np.float32)
    k = np.arange(n) % 3
    signed = np.where(k == 0, np.float32(-0.0),
                      np.where(k == 1, np.float32(0.0), s))
    for scores in (s, np.zeros(n, np.float32), signed.astype(np.float32)):
        gg, hg = objs["cuda"].get_gradients(torch.as_tensor(scores).cuda())
        gc, hc = objs["cpu"].get_gradients(torch.as_tensor(scores))
        assert torch.equal(gg.cpu().view(torch.int32), gc.view(torch.int32))
        assert torch.equal(hg.cpu().view(torch.int32), hc.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bins", [4, 8, 16])
def test_quantize_gradients_on_card_equal_cpu(bins):
    """The quantization pass on the card against the CPU, bit for bit,
    scales included, in both forms (the host loop's true division by the
    level count, the fused learner's product with its reciprocal), on
    maxima that the two forms round apart."""
    _need_card()
    from lightgbm_tpu_torch.ops import threefry
    rng = np.random.RandomState(bins)
    for trial in range(20):
        g = torch.as_tensor((rng.randn(10_000) * rng.rand()).astype(
            np.float32))
        h = torch.as_tensor((rng.rand(10_000) * rng.rand()).astype(
            np.float32))
        key = threefry.PRNGKey(trial)
        for reciprocal in (False, True):
            got = TQ.quantize_gradients(g.cuda(), h.cuda(), bins,
                                        key, reciprocal=reciprocal)
            want = TQ.quantize_gradients(g, h, bins, key,
                                         reciprocal=reciprocal)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (trial, reciprocal)


def _torchrun_data():
    rng = np.random.RandomState(7)
    X = rng.randn(20_000, 8).astype(np.float32)
    y = (X[:, 0] + 0.4 * X[:, 1] ** 2 + 0.2 * rng.randn(20_000) > 0.3)
    return X, y.astype(np.float32)


def _torchrun_rank(rank, world, port, out_dir, device):
    """One process as ``torchrun --nproc_per_node=world`` starts it: the
    group comes from the environment through ``lgt.train``'s own
    ``ensure_distributed`` (NCCL on the card, rank r on
    ``cuda:{LOCAL_RANK}``; gloo on the CPU)."""
    import os
    import pickle
    import torch.distributed as dist
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import network
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    X, y = _torchrun_data()
    # float32 histogram inputs: the card's default rounds grad / hess to
    # bfloat16, the CPU's plain path never does
    b = lgt.train({"objective": "binary", "tree_learner": "data",
                   "num_machines": world, "num_leaves": 15, "verbose": -1,
                   "tpu_hist_dtype": "float32", "device_type": device},
                  lgt.Dataset(X, label=y), num_boost_round=5,
                  verbose_eval=False)
    out = dict(text=b.model_to_string(), pred=b.predict(X[:2_000]),
               backend=network.backend(), world=network.world_size(),
               device=str(b.device),
               learner=type(b._gbdt._fused).__name__)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def _tree_fields(text):
    """{key: [line per tree]} of the model text's tree blocks."""
    body = text[text.index("Tree=0"):text.index("end of trees")]
    out = {}
    for line in body.splitlines():
        key, sep, val = line.partition("=")
        if sep and key != "Tree":
            out.setdefault(key, []).append(val)
    return out


@pytest.mark.cuda
def test_torchrun_data_parallel_on_cards(tmp_path):
    """The README's launch, one process per card with the group set up
    by ``lgt.train`` itself (``num_machines`` and torchrun's
    environment), at D = min(cards, 4): NCCL, rank r on cuda:r, the
    fused data-parallel learner; every rank's model is equal, and the
    same launch on the CPU (gloo) gives the same trees, leaf values and
    predictions within 1e-6."""
    import pickle
    import socket
    _need_card()
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs two cards: NCCL holds one rank per card")
    from lightgbm_tpu_torch.ops import cuda as K
    K.build_all()  # once, before the ranks load the libraries
    res = {}
    for device in ("cuda", "cpu"):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out_dir = tmp_path / device
        out_dir.mkdir()
        torch.multiprocessing.spawn(
            _torchrun_rank, args=(world, port, str(out_dir), device),
            nprocs=world, join=True)
        res[device] = []
        for r in range(world):
            with open(out_dir / f"{r}.pkl", "rb") as fh:
                res[device].append(pickle.load(fh))
    for r, got in enumerate(res["cuda"]):
        assert (got["backend"], got["world"], got["device"]) == \
            ("nccl", world, f"cuda:{r}")
        assert got["learner"] == "FusedDataParallelGrower"
    assert {c["backend"] for c in res["cpu"]} == {"gloo"}
    for dev in ("cuda", "cpu"):
        for got in res[dev][1:]:
            assert got["text"] == res[dev][0]["text"], dev
    card, cpu = (_tree_fields(res[d][0]["text"]) for d in ("cuda", "cpu"))
    for key in ("num_leaves", "split_feature", "threshold",
                "decision_type", "left_child", "right_child"):
        assert card[key] == cpu[key], key
    for a, b in zip(card["leaf_value"], cpu["leaf_value"]):
        np.testing.assert_allclose(np.array(a.split(), float),
                                   np.array(b.split(), float), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(res["cuda"][0]["pred"], res["cpu"][0]["pred"],
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_full_telemetry_on_card(tmp_path):
    """Full telemetry on the card: the records sample the caching
    allocator (``mem.live_bytes`` > 0), the profiler's Chrome trace
    holds the kernels of B1 (``lgbt_hist_planar`` launches
    ``hp_partials``) and B2, and the model equals the run without
    telemetry but the echoed telemetry keys."""
    _need_card()
    import json
    import os
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import obs
    rng = np.random.RandomState(2)
    X = rng.randn(20_000, 10)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000) > 0)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "device_type": "cuda"}
    files = {"metrics_file": str(tmp_path / "m.jsonl"),
             "trace_file": str(tmp_path / "t.json"),
             "profile_dir": str(tmp_path / "prof")}
    on = tlgb.train({**params, **files}, tlgb.Dataset(X, label=y),
                    num_boost_round=3, verbose_eval=False)
    off = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=3,
                     verbose_eval=False)
    recs = obs.read_jsonl(files["metrics_file"])
    assert len(recs) == 3
    for r in recs:
        assert obs.validate_record(r) == []
        assert r["gauges"]["mem.live_bytes"] > 0
        assert r["gauges"]["mem.live_peak_bytes"] >= \
            r["gauges"]["mem.planar_state_bytes"]
    (prof,) = os.listdir(files["profile_dir"])
    with open(os.path.join(files["profile_dir"], prof)) as fh:
        kernels = {e["name"] for e in json.load(fh)["traceEvents"]
                   if e.get("cat") == "kernel"}
    assert any("hp_partials" in k for k in kernels), sorted(kernels)[:20]
    assert any("part_small" in k or "part_tiles" in k for k in kernels)

    def text(b):
        return [ln for ln in b.model_to_string().splitlines()
                if not any(ln.startswith(f"[{k}:") for k in files)]
    assert text(on) == text(off)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{}, {"monotone_constraints": [1, 0, -1, 0,
                                                                 0, 0]}],
                         ids=["plain", "monotone"])
def test_split_step_makes_one_syncing_call(extra):
    """A steady iteration of the fused learner under CUDA sync debug
    mode "warn": no counted read (the split steps replay a captured
    graph and the tree stays on the card), and at most a few syncing
    calls (SYNC_STEADY_MAX) for the whole iteration, none per split.
    Indexing by a 0-d device tensor (an implicit read) would add one
    call per index and split."""
    import warnings
    _need_card()
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(6)
    X = rng.randn(50_000, 6)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.randn(50_000) > 0)
    b = lgt.Booster({"objective": "binary", "num_leaves": 63,
                     "verbose": -1, "device_type": "cuda", **extra},
                    lgt.Dataset(X, label=y.astype(float)))
    b.update()                      # the state built, the kernels loaded
    b.update()                      # the split step captured
    learner = b._gbdt._fused
    assert learner is not None and learner._graph is not None
    torch.cuda.synchronize()
    reads0 = learner.syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            b.update()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    calls = sum("synchroniz" in str(w.message).lower() for w in caught)
    reads = learner.syncs - reads0
    assert reads == 0 and calls <= SYNC_STEADY_MAX, (calls, reads)
    assert b._gbdt.models[-1].num_leaves > 30


SYNC_STEADY_MAX = 4


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {}, {"use_quantized_grad": True, "num_grad_quant_bins": 4},
    {"categorical_feature": [5]}, {"max_depth": 4},
    {"feature_fraction_bynode": 0.5}],
    ids=["plain", "quantized", "categorical", "max_depth", "bynode"])
def test_captured_step_equals_eager_loop(extra):
    """The persistent iteration's captured split step and the eager
    device loop train the same model text; the graph is captured once."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.compile import manager
    rng = np.random.RandomState(8)
    X = rng.randn(30_000, 6)
    X[:, 5] = rng.randint(0, 20, 30_000)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + (X[:, 5] % 3) * 0.4
         + 0.3 * rng.randn(30_000) > 0).astype(float)
    texts = {}
    for eager in (False, True):
        b = lgt.Booster({"objective": "binary", "num_leaves": 31,
                         "verbose": -1, "device_type": "cuda", **extra},
                        lgt.Dataset(X, label=y))
        b._gbdt._fused._eager_loop = eager
        n0 = manager.snapshot().get("graph_captures", 0)
        for _ in range(4):
            b.update()
        caps = manager.snapshot().get("graph_captures", 0) - n0
        assert caps == (0 if eager else 1), (eager, caps)
        texts[eager] = b.model_to_string()
    assert texts[False] == texts[True]


def _per_tree_case(case, tmp_path):
    """(X, y, params) of a per-tree card case: 30,000 rows, 31 leaves."""
    import json
    rng = np.random.RandomState(9)
    X = rng.randn(30_000, 6)
    s = X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.randn(30_000)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "device_type": "cuda"}
    if case == "multiclass":
        y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(float)
        params.update(objective="multiclass", num_class=3)
        return X, y, params
    params.update(bagging_fraction=0.8, bagging_freq=1)
    if case == "pos_neg_bagging":
        params.update(pos_bagging_fraction=0.6, neg_bagging_fraction=0.8)
        del params["bagging_fraction"]
    if case == "forced":
        path = str(tmp_path / "forced.json")
        with open(path, "w") as fh:
            # the left child (x0 <= 0) forced on x0 at 1.0 has an empty
            # right side: skipped, and the right child's split with it
            json.dump({"feature": 0, "threshold": 0.0,
                       "left": {"feature": 0, "threshold": 1.0},
                       "right": {"feature": 1, "threshold": 0.0}}, fh)
        params["forcedsplits_filename"] = path
    return X, (s > 0).astype(float), params


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["multiclass", "bagging", "forced"])
def test_per_tree_captured_step_equals_eager_loop(case, tmp_path):
    """The per-tree path (``grow_device``) replays its captured split
    step from the learner's second tree on: the same model text as the
    eager device loop, no counted read per update (the forced case's
    second split has an empty side: it and the third are skipped on the
    card, with no read), and one capture over the run."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.compile import manager
    X, y, params = _per_tree_case(case, tmp_path)
    texts = {}
    for eager in (False, True):
        b = lgt.Booster(dict(params), lgt.Dataset(X, label=y))
        fl = b._gbdt._fused
        assert fl is not None and not b._gbdt._fused_persist
        fl._eager_loop = eager
        n0 = manager.snapshot().get("graph_captures", 0)
        reads = []
        for _ in range(4):
            r0 = fl.syncs
            b.update()
            reads.append(fl.syncs - r0)
        caps = manager.snapshot().get("graph_captures", 0) - n0
        assert reads == [0] * 4, reads
        assert caps == (0 if eager else 1), (eager, caps)
        texts[eager] = b.model_to_string()
    assert texts[False] == texts[True]


@pytest.mark.cuda
def test_pos_neg_bagging_captures_once():
    """Pos/neg bagging draws a bag count per round; the per-tree step's
    launches are bounded by the learner's rows, so three rounds replay
    one capture, with no counted read."""
    _need_card()
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.compile import manager
    X, y, params = _per_tree_case("pos_neg_bagging", None)
    b = lgt.Booster(params, lgt.Dataset(X, label=y))
    fl = b._gbdt._fused
    n0 = manager.snapshot().get("graph_captures", 0)
    counts, r0 = [], fl.syncs
    for _ in range(3):
        b.update()
        counts.append(b._gbdt.bag_data_cnt)
    assert len(set(counts)) > 1, counts
    assert manager.snapshot().get("graph_captures", 0) - n0 == 1
    assert fl.syncs == r0
