#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lightgbm_tpu_torch) on one card.

    python3 chip_smoke.py [--rows 2000000] [--iters 10] [--profile]

Phases, each of which fails the run (no exception is caught):

1. build  — compile every CUDA kernel from csrc/ (one nvcc per source,
   in parallel); print the build seconds and the card.
2. xla_float — exp_f32, fma_f32, log1p_f32, the binary, multiclass
   and cross_entropy_lambda gradients and their predict transforms
   (the JAX package's XLA:CPU float32 bits) on the card against the
   CPU, bit for bit, on up to 2^24 inputs; then
   kernels — every kernel (B1-B7), and the int32 (quantized) mode of
   B1, B4, B5, B6 and B7, against its plain PyTorch version on the card,
   at the paths' shapes and at edge cases; time each at its path's root
   window beside its bound, the plain version and a library yardstick.
   B1, B4-B7 also take random (non-dyadic) float grad/hess, held bit
   for bit against the plain version run on the CPU, windows around
   their tiles, more bins (B1, B4/B7) or cells (B5/B6) than one block's
   shared memory holds (and, B4/B7, more than 32 columns), and are
   timed at a 16,384-row window too, beside ``index_add_``. B2 is held
   at P = 16, 4-bit codes and P = 128 on both of its routes (one block
   in place; tiles plus a copy back), timed at the root and at 16,384
   lanes for P = 16 and P = 128, with each route's kernel launches per
   partition.
3. paths — lightgbm_tpu_torch.train through each path the port runs,
   the launch counts of every kernel read around each run, AUC (or the
   path's loss) on held-out rows and seconds per iteration:
   - HIGGS fused: HIGGS-shaped synthetic (28 features, 255 leaves, 255
     bins) on the fused learner (B1 + B2);
   - (a) wide-sparse fused: the bench.py wide sidecar's one-hot CSR
     shape (72 variables x 8 categories, 1,048,576 rows) with the
     default config, which must pick the multi-value layout (B5 + B2);
   - (b) dense host loop: the HIGGS shape with extra_trees (B4);
   - (c) wide-sparse host loop: shape (a) with tpu_fused=false (B6);
   - (d)-(g): the same four with quantized gradients (use_quantized_grad,
     4 levels, stochastic rounding, renewed leaves): B1q + B2, B5q + B2,
     B4q, B6q; each path's held-out AUC must stay within 0.02 of its
     float twin's;
   - (h) HIGGS-cat fused: the HIGGS shape plus 4 categorical columns
     (3, 24, 100 and 250 levels, Zipf-like, 1% NaN in the 100-level
     one) on the fused learner (B1 + B2, whose categorical bitset route
     must launch), then one profiled iteration (kernels, device busy
     share);
   - (i)-(k): the HIGGS columns with a regression label (score plus
     N(0, 1) noise) on the fused learner (B1 + B2): (i) the default
     objective (no objective key: regression, metric l2), (j) quantile
     at alpha 0.9 and (k) MAPE, the last two with the in-program
     percentile refit (unweighted; weighted, as MAPE's weight plane
     carries its label weights), timed per iteration with CUDA events;
     each held-out metric must beat its floor (0.8 x the label variance;
     the constant 0.9-quantile's and the constant median's loss); each
     takes one profiled iteration.
   - (l)-(n): the per-tree fused path (``grow_device``: a fresh planar
     state per class tree from row-order gradients, the score update
     through each row's leaf): (l) HIGGS-multiclass fused, the HIGGS
     columns with 5 classes (the quintiles of (i)'s label), multiclass,
     5 iterations (25 trees), B1 + B2, held-out multi_logloss below the
     constant predictor's ln 5; (m) the same data with multiclassova, 3
     iterations, held-out multi_error below the constant predictor's
     0.8; (n) shape (a) (multi-value layout, P = 128) with a custom
     objective (the binary log loss in numpy), 3 iterations, B5 + B2,
     held-out AUC above 0.75. Each prints its kernels' launches per
     iteration.
   - (o)-(s): row sampling and the boosting modes on the per-tree fused
     path, each tree grown on a bag-ordered state gathered and packed
     per tree (its build timed by CUDA events) and every row scored by
     traversal: (o) HIGGS bagging (bagging_fraction 0.8, bagging_freq
     1), (p) HIGGS GOSS (top_rate 0.2, other_rate 0.1, learning_rate
     0.25: iterations 4-7 sample 30% of the rows, each sampling round
     run with CUDA sync debug mode "error", so a host read fails the
     run), (q) HIGGS DART (drop_rate 0.1, skip_drop 0.5; the unbagged
     per-tree state; the drop and normalize steps timed), (r) HIGGS RF
     (bagging_fraction 0.632, bagging_freq 1, feature_fraction 0.8),
     all B1 + B2 for 8 iterations with held-out AUC above 0.70, and (s)
     shape (a) with bagging (0.8, freq 1), B5 + B2 over bag-gathered
     slot planes, 3 iterations.
4. card vs CPU — the same small training on cuda and on cpu (the plain
   versions), on the fused and on the host-loop learner, with float32
   and with quantized gradients, on (h)'s columns with categorical
   features, with the regression, quantile and MAPE objectives, and
   with multiclass, multiclassova and a custom objective, and with
   bagging, pos/neg bagging, GOSS, DART, RF and multiclass with bagging
   (both learners), quantized gradients and regression_l1 with bagging
   (the host loop; these 14 on 30,000 rows): trees (bitset pools
   included), leaf values and
   predictions must agree (the per-tree and boosting-mode cases
   exactly), with prediction early stop off and on for the categorical
   model.

``--profile`` instead profiles one iteration of each path
(``--profile-paths b,h`` of the named ones only; (l)-(n) device rows
only).

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no
result. It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores
SLEEP_CYCLES = 40_000_000      # ~20 ms at the H100's clock


def log(msg: str) -> None:
    print(msg, flush=True)


def make_higgs_like(n, f, seed=0, scale=2.4):
    """HIGGS-shaped synthetic (a copy of bench.py make_higgs_like):
    labels drawn from p = sigmoid(s(x)), s standardized to ``scale``,
    Bayes-optimal AUC ~0.875."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    s = _higgs_score(X, scale)
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-s))).astype(np.float32)
    return X, y


def make_higgs_reg_like(n, f, seed=0, scale=2.4):
    """make_higgs_like's columns (the same rows for the same seed) with
    a regression label: the standardized score plus N(0, 1) noise, so
    the best possible l2 is 1 against a label variance of ~6.76."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (_higgs_score(X, scale) + rng.randn(n)).astype(np.float32)
    return X, y


def _higgs_score(X, scale):
    s = (0.9 * X[:, 0] - 0.8 * X[:, 1] + 1.1 * X[:, 2] * X[:, 3]
         + 0.8 * np.sin(2 * X[:, 4]) * X[:, 5] + 0.6 * (X[:, 6] ** 2 - 1)
         + 0.7 * X[:, 7] * X[:, 8] * X[:, 9]
         + 0.5 * np.tanh(X[:, 10]) * X[:, 11])
    return (s - s.mean()) / s.std() * scale


CAT_LEVELS = (3, 24, 100, 250)


def make_higgs_cat_like(n, seed=0, scale=2.4):
    """Path (h)'s data: make_higgs_like's 28 numerical columns plus 4
    categorical integer columns of CAT_LEVELS levels, each drawn
    Zipf-like (p(level k) ~ 1 / (k + 1)^1.1, so rare levels fall under
    cat_smooth in small leaves), 1% NaN in the 100-level column; the
    label's score gains one random effect per level (N(0, 0.5^2); NaN
    adds none). Returns X [n, 32] float32, y, and the categorical
    column indices."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 28 + len(CAT_LEVELS)), np.float32)
    X[:, :28] = rng.randn(n, 28)
    s = _higgs_score(X[:, :28], scale)
    nan = rng.rand(n) < 0.01
    for j, levels in enumerate(CAT_LEVELS):
        p = 1.0 / np.arange(1, levels + 1) ** 1.1
        cat = rng.choice(levels, size=n, p=p / p.sum()).astype(np.float32)
        if levels == 100:
            cat[nan] = np.nan
        effect = rng.randn(levels) * 0.5
        s += np.where(np.isnan(cat), 0.0,
                      effect[np.nan_to_num(cat).astype(np.int64)])
        X[:, 28 + j] = cat
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-s))).astype(np.float32)
    return X, y, list(range(28, 28 + len(CAT_LEVELS)))


def make_wide_like(rows, nvars=72, ncats=8, seed=7):
    """Wide-sparse one-hot CSR (a copy of bench.py run_wide_sidecar's
    data): ``nvars`` categorical variables of ``ncats`` levels, the
    dominant level at ~93%, every row storing its ``nvars`` one-hot
    entries; labels from a random linear logit plus noise."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    w = rng.randn(nvars, ncats).astype(np.float32) * 0.8
    cols_t = np.empty((nvars, rows), dtype=np.int32)
    logit = np.zeros(rows, np.float32)
    for v in range(nvars):
        rare = rng.rand(rows) >= 0.93
        cat_v = np.where(rare, rng.randint(1, ncats, size=rows),
                         0).astype(np.int32)
        logit += w[v][cat_v]
        cols_t[v] = cat_v + v * ncats
    y = (logit + rng.randn(rows).astype(np.float32) * 0.5 > 0)
    cols = np.ascontiguousarray(cols_t.T).reshape(-1)
    X = sp.csr_matrix(
        (np.ones(rows * nvars, np.int8), cols,
         np.arange(rows + 1, dtype=np.int64) * nvars),
        shape=(rows, nvars * ncats))
    return X, y.astype(np.float32)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA
    events, after one warm-up call). A sleep kernel queued first holds
    the card while the host queues the calls, so a call that costs the
    host more than the card is timed by the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def make_state(n, g, code_bits, max_code, seed, dev):
    """A planar state like the main path's (label and score planes) with
    random codes and grad/hess on a dyadic grid: every partial sum of a
    histogram bin is exact in float32 (|sum| * 2^11 < 2^24 for the row
    counts used here), so the kernel and the plain version must agree
    bit for bit whatever order they add in, and bfloat16 rounding (8
    significant bits) changes many of the 11-bit values."""
    from lightgbm_tpu_torch.ops import plane
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, max_code, size=(n, g)).astype(
        np.uint16 if code_bits == 16 else np.uint8)
    grad = (rng.randint(-1024, 1025, n) / 2048.0).astype(np.float32)
    hess = (rng.randint(0, 1025, n) / 4096.0).astype(np.float32)
    layout = plane.make_layout(g, code_bits, n, with_label=True,
                               with_score=True)
    cp = plane.build_codes_planes(torch.as_tensor(codes.astype(np.int32),
                                                  device=dev), layout)
    t = torch.as_tensor
    data = plane.build_data(layout, cp, t(grad, device=dev),
                            t(hess, device=dev), label=t(grad, device=dev),
                            score=t(hess, device=dev))
    return layout, data, codes


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

HIST_CASES = [
    # (name, rows, cols, code_bits, num_bins, windows); codes run to
    # min(2^bits, num_bins + 64): those >= num_bins add nothing
    ("higgs_8bit", 2_000_000, 28, 8, 255,
     [(0, 2_000_000), (777_777, 1_000_001), (2_000_000 - 12_345, 12_345),
      (1_234_567, 3), (5_000, 0)]),
    ("4bit_16bins", 200_000, 9, 4, 16,
     [(0, 200_000), (1_001, 150_000), (17, 3), (500, 0)]),
    ("16bit_1000bins", 300_000, 5, 16, 1000,
     [(0, 300_000), (333, 200_001), (5, 3), (0, 0)]),
    # more bins than one column's histogram fits in shared memory (the
    # wide-bin path), at windows around the 2048-row tile
    ("16bit_40000bins", 100_000, 3, 16, 40_000,
     [(0, 100_000), (1_001, 2_049), (7, 2_047), (5, 3), (0, 0)]),
]


def _random_gh(data, layout, rng, dev):
    """Random (non-dyadic) float grad/hess in every lane of ``data``."""
    from lightgbm_tpu_torch.ops import plane
    R = layout.num_lanes
    plane.set_gh(data, layout,
                 torch.as_tensor(rng.randn(R).astype(np.float32), device=dev),
                 torch.as_tensor(rng.rand(R).astype(np.float32), device=dev))


def _planar_index_add_ms(codes, gh, nb):
    """One ``index_add_`` of every (row, column)'s g/h (``gh`` [c, 2],
    float32 or int32 levels) into its (column, bin) cell, over
    already-unpacked codes [c, g]: the scatter alone, without
    unpacking."""
    c, g = codes.shape
    idx = (torch.arange(g, device=codes.device)[None, :] * nb
           + codes.long()).reshape(-1)
    vals = gh[:, None, :].expand(c, g, 2).reshape(-1, 2).contiguous()
    acc = torch.zeros(g * nb, 2, dtype=gh.dtype, device=codes.device)
    return time_ms(lambda: acc.index_add_(0, idx, vals), reps=50)


def check_hist(dev, report):
    """B1 (hist_planar_cuda, float32 and bfloat16) on random float
    grad/hess, bit for bit against the plain version run on the CPU
    (it sums in the kernel's association: HIST_TILE-row tiles, each cell
    in row order, the tiles in order), every launch twice and through a
    device window; timed at the main path's root window and at a
    SMALL_WINDOW-row window beside ``index_add_``."""
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import cuda as K
    assert K.lib("hist_planar").lgbt_hist_tile() == H.HIST_TILE
    rng = np.random.RandomState(13)
    worst = 0.0
    for name, n, g, bits, nb, windows in HIST_CASES:
        layout, data, _ = make_state(n, g, bits, min(1 << bits, nb + 64),
                                     seed=n + g, dev=dev)
        _random_gh(data, layout, rng, dev)
        cpu = data.cpu()
        kw = dict(num_bins=nb, num_cols=g, code_bits=bits,
                  grad_plane=layout.grad)
        for start, count in windows:
            for dt in (torch.float32, torch.bfloat16):
                got = H.hist_planar_cuda(data, start, count, dtype=dt, **kw)
                again = H.hist_planar_cuda(data, start, count, dtype=dt, **kw)
                dwin = H.hist_planar_cuda(
                    data, torch.tensor(start, dtype=torch.int32, device=dev),
                    torch.tensor(count, dtype=torch.int32, device=dev),
                    dtype=dt, max_count=n, **kw)
                want = H.histogram_planar_plain(cpu, start, count, dtype=dt,
                                                **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, again), \
                    f"B1 {name} {start}+{count} {dt}: launches differ"
                assert torch.equal(got, dwin), \
                    f"B1 {name} {start}+{count} {dt}: device window differs"
                worst = max(worst, float((got.cpu() - want).abs().max()))
                assert torch.equal(got.cpu(), want), \
                    f"B1 {name} {start}+{count} {dt}: differs from the CPU"
        log(f"B1 hist_planar {name}: {len(windows)} windows x (f32, bf16) "
            "on random float g/h bit-exact against the plain version on "
            "the CPU, run-to-run and host/device windows identical")
    # timing at the main path's root window (2M rows, 28 cols, 255 bins,
    # bf16 inputs as the main path runs them) and at SMALL_WINDOW rows
    name, n, g, bits, nb, _ = HIST_CASES[0]
    layout, data, codes = make_state(n, g, bits, nb, seed=1, dev=dev)
    _random_gh(data, layout, rng, dev)
    codes = torch.as_tensor(codes, device=dev)
    kw = dict(num_bins=nb, num_cols=g, code_bits=bits, grad_plane=layout.grad,
              dtype=torch.bfloat16)
    for c in (n, SMALL_WINDOW):
        ms = time_ms(lambda: H.hist_planar_cuda(data, 0, c, **kw), reps=50)
        plain_ms = time_ms(lambda: H.histogram_planar_plain(data, 0, c, **kw),
                           reps=3)
        gh = torch.stack([data[layout.grad, :c].view(torch.float32),
                          data[layout.hess, :c].view(torch.float32)], -1)
        lib_ms = _planar_index_add_ms(codes[:c], gh, nb)
        nbytes = (layout.code_planes + 2) * 4 * c + g * nb * 2 * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       2 * c * g / F32_OPS_PER_S) * 1e3
        if c == n:
            report.append(dict(
                name="hist_planar", route="cuda",
                source="lightgbm_tpu_torch/csrc/hist_planar.cu",
                replaces="lightgbm_tpu/ops/histogram.py:702",
                launches=0, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms))
        log(f"B1 hist_planar {'root' if c == n else 'small'} window "
            f"{c}x{g}x{nb} bf16: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"bytes, plain {plain_ms:.3f} ms, index_add_ {lib_ms:.4f} ms)")


def _efb_tables(dev):
    """Synthetic bundle tables: feature 5 lives in group 3 at offset 40
    with 90 slots and skip (most-frequent) bin 7."""
    f = 8
    t = dict(group_of=list(range(f)), offset_of=[0] * f,
             nslots_of=[255] * f, skip_of=[255] * f)
    t["group_of"][5], t["offset_of"][5] = 3, 40
    t["nslots_of"][5], t["skip_of"][5] = 90, 7
    return tuple(torch.tensor(t[k], dtype=torch.int32, device=dev)
                 for k in ("group_of", "offset_of", "nslots_of", "skip_of"))


def make_wide_state(n, seed, dev):
    """A P = 128 planar state, the wide-sparse shape's width: 28 8-bit
    code columns, label and score planes and 112 random slot planes."""
    from lightgbm_tpu_torch.ops import plane
    rng = np.random.RandomState(seed)
    layout = plane.make_layout(28, 8, n, with_label=True, with_score=True,
                               mv_planes=112)
    codes = rng.randint(0, 256, size=(n, 28)).astype(np.int32)
    cp = plane.build_codes_planes(torch.as_tensor(codes, device=dev), layout)
    g = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    mv = torch.randint(-1, 900, (112, n), dtype=torch.int32, device=dev,
                       generator=torch.Generator(dev).manual_seed(seed))
    data = plane.build_data(layout, cp, g, g.abs(), label=g, score=g, mv=mv)
    assert layout.num_planes == 128, layout.num_planes
    return layout, data, codes


def _kernels_per_call(fn):
    """Device kernels one call of ``fn`` launches, by torch.profiler
    (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def check_partition(dev, report):
    """B2 (partition_cuda) bit for bit against partition_plain on the
    card: at P = 16 (numerical, missing, categorical, EFB-routed, all
    left / right, tiny and empty windows, windows at the one-block
    route's end and at the tile), at 4-bit codes and at P = 128; timed
    at the root and at a SMALL_WINDOW-lane window at P = 16 and P = 128
    beside ``argsort`` + ``index_select``, with the kernels each route
    launches per partition."""
    from lightgbm_tpu_torch.ops import plane
    n = 2_000_000
    layout, base, codes = make_state(n, 28, 8, 256, seed=7, dev=dev)
    bitset = np.zeros(plane.CAT_WORDS, np.uint32)
    for b in (3, 17, 42, 128, 200, 255):
        bitset[b // 32] |= np.uint32(1 << (b % 32))
    small16 = plane.PART_SMALL_BYTES // (4 * (layout.num_planes + 1))
    num = dict(feature=9, threshold=128, default_left=0, miss_bin=-1)
    cases = [
        # (name, start, count, route_scalars kwargs)
        ("numerical_full", 0, n, dict(feature=3, threshold=120,
                                      default_left=0, miss_bin=-1)),
        ("missing_default_left", 123_457, 1_500_001,
         dict(feature=7, threshold=60, default_left=1, miss_bin=249)),
        ("missing_default_right", 99, 1_000_000,
         dict(feature=26, threshold=200, default_left=0, miss_bin=30)),
        ("categorical_bitset", 5, n - 10,
         dict(feature=2, threshold=0, default_left=0, miss_bin=-1, is_cat=1,
              cat_bitset=bitset.view(np.int32))),
        ("efb_routed", 1_000, 1_200_000,
         dict(feature=5, threshold=20, default_left=1, miss_bin=4,
              efb_dev=_efb_tables(dev))),
        ("all_left", 2_047, 1_000_003, dict(feature=0, threshold=255,
                                            default_left=0, miss_bin=-1)),
        ("all_right", 4_096, 999_999, dict(feature=1, threshold=-1,
                                           default_left=0, miss_bin=-1)),
        ("tiny_3", 1_234_567, 3, num),
        ("count_1", 77, 1, num),
        ("count_0", 500, 0, num),
        ("one_block_largest", 31, small16, num),
        ("tiles_smallest", 31, small16 + 1, num),
        ("tile_plus_1", 6_000, plane.PART_TILE + 1, num),
        ("small_window", 444, SMALL_WINDOW, dict(
            feature=5, threshold=20, default_left=1, miss_bin=4,
            efb_dev=_efb_tables(dev))),
    ]
    l4, base4, _ = make_state(1_048_576, 9, 4, 16, seed=9, dev=dev)
    cases4 = [("4bit_shift16", 300, 1_000_000,
               dict(feature=4, threshold=7, default_left=0, miss_bin=15)),
              ("4bit_shift12", 0, 1_048_576,
               dict(feature=3, threshold=9, default_left=1, miss_bin=2))]
    n128 = 1_048_576
    l128, base128, codes128 = make_wide_state(n128, seed=10, dev=dev)
    small128 = plane.PART_SMALL_BYTES // (4 * 129)
    cases128 = [
        ("p128_full", 0, n128, dict(feature=3, threshold=120, default_left=0,
                                    miss_bin=-1)),
        ("p128_categorical", 12_345, 700_001,
         dict(feature=2, threshold=0, default_left=0, miss_bin=-1, is_cat=1,
              cat_bitset=bitset.view(np.int32))),
        ("p128_one_block_largest", 77, small128, num),
        ("p128_tiles_smallest", 77, small128 + 1, num),
        ("p128_small_window", 5, SMALL_WINDOW, dict(
            feature=7, threshold=60, default_left=1, miss_bin=249)),
        ("p128_tiny", 3, 2, num),
        ("p128_count_0", 0, 0, num),
    ]
    for lay, st, cs in ((layout, base, cases), (l4, base4, cases4),
                        (l128, base128, cases128)):
        routes = set()
        for name, start, count, kw in cs:
            rscal = plane.route_scalars(lay, device=dev, **kw)
            routes.add(plane.partition_small(lay.num_planes, count))
            got, nl_got = plane.partition_cuda(st.clone(), lay, start, count,
                                               rscal)
            want, nl_want = plane.partition_plain(st.clone(), lay, start,
                                                  count, rscal)
            torch.cuda.synchronize()
            assert int(nl_got) == int(nl_want), (name, int(nl_got),
                                                 int(nl_want))
            assert torch.equal(got, want), f"B2 {name}: data differs"
        names = " and ".join(sorted("one block" if r else "tiles"
                                    for r in routes))
        log(f"B2 partition: {len(cs)} cases bit-exact "
            f"(P={lay.num_planes}, lanes={lay.num_lanes}; routes: {names})")
    # launches per partition on each route, and timings at the root and
    # at SMALL_WINDOW lanes beside argsort + index_select
    entries = []
    for lay, st, cds in ((layout, base, codes), (l128, base128, codes128)):
        P, root = lay.num_planes, lay.num_rows
        rscal = plane.route_scalars(lay, device=dev, **cases[0][3])
        work = st.clone()
        for c in (plane.PART_SMALL_BYTES // (4 * (P + 1)), SMALL_WINDOW):
            k = _kernels_per_call(
                lambda: plane.partition_cuda(work, lay, 0, c, rscal))
            log(f"B2 partition P={P}, {c} lanes "
                f"({'one block' if plane.partition_small(P, c) else 'tiles'}"
                f" route): {k} kernel launches per partition")
        key_all = (torch.as_tensor(cds[:, 3], device=dev) > 120).to(
            torch.int32)
        for c in (root, SMALL_WINDOW):
            ms = time_ms(lambda: plane.partition_cuda(work, lay, 0, c, rscal),
                         reps=20)
            plain_ms = time_ms(lambda: plane.partition_plain(work, lay, 0, c,
                                                             rscal), reps=3)
            key = key_all[:c]
            lib_ms = time_ms(lambda: work[:, :c].index_select(
                1, torch.argsort(key, stable=True)), reps=20)
            bound_ms = 2 * P * 4 * c / HBM_BYTES_PER_S * 1e3
            if P == layout.num_planes and c == root:
                entries = [ms, plain_ms, bound_ms, lib_ms]
            log(f"B2 partition {'root' if c == root else 'small'} window "
                f"{c} lanes x P={P}: {ms:.4f} ms (bound {bound_ms:.4f} ms "
                f"by bytes, plain {plain_ms:.3f} ms, argsort+index_select "
                f"{lib_ms:.4f} ms)")
    ms, plain_ms, bound_ms, lib_ms = entries
    report.append(dict(
        name="partition", route="cuda",
        source="lightgbm_tpu_torch/csrc/partition.cu",
        replaces="lightgbm_tpu/ops/plane.py:991",
        launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms))
    # B3 (partition_pallas, the JAX package's v1 entry) is the same CUDA
    # kernel; its entry point is partition_window
    rscal = plane.route_scalars(layout, device=dev, **cases[0][3])
    work = base.clone()
    v1_ms = time_ms(lambda: plane.partition_window(work, layout, 0, n, rscal),
                    reps=20)
    report.append(dict(
        name="partition_window", route="cuda",
        source="lightgbm_tpu_torch/csrc/partition.cu",
        replaces="lightgbm_tpu/ops/plane.py:643",
        launches=0, max_abs_err=0.0, ms=v1_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms))
    log(f"B3 partition_window (v1 entry, same kernel): {v1_ms:.4f} ms")


def _dyadic_gh(rng, n, dev):
    """grad/hess on a dyadic grid: every partial sum is exact, so a
    kernel and its plain version agree bit for bit in any order."""
    # 7 fractional bits: 2M rows of hess <= 1/8 keep |sum| * 2^7 below
    # 2^24 in any one cell
    g = (rng.randint(-64, 65, n) / 128.0).astype(np.float32)
    h = (rng.randint(0, 17, n) / 128.0).astype(np.float32)
    return torch.as_tensor(g, device=dev), torch.as_tensor(h, device=dev)


# (rows, columns, bins, code dtype) of the row-major checks besides the
# root window: a second bin count, int32 codes, windows around the tile
# rule's breakpoints (ops/histogram.py rowmajor_tile), more columns than
# a warp has lanes, and more bins than one column's histogram fits in
# shared memory (the wide-bin path)
RM_CASES = [(300_001, 28, 64, torch.uint8), (200_000, 9, 16, torch.int32),
            (100_000, 5, 1000, torch.int32), (2_047, 28, 255, torch.uint8),
            (2_049, 28, 255, torch.uint8), (1, 28, 255, torch.uint8),
            (0, 28, 255, torch.uint8),
            (200_000, 40, 255, torch.uint8), (50_000, 3, 40_000, torch.int32)]
# the mean smaller-child window of path (b): the per-launch floor
SMALL_WINDOW = 16_384


def _rm_codes(rng, c, f, nb, cdt, dev):
    return torch.as_tensor(rng.randint(0, nb, size=(c, f))).to(cdt).to(dev)


def _rm_index_add_ms(bins, g, h, nb):
    """One ``index_add_`` of every (row, column)'s g/h into its
    (column, bin) cell, in g's dtype (float32 or int32)."""
    c, f = bins.shape
    idx = (torch.arange(f, device=bins.device)[None, :] * nb
           + bins.long()).reshape(-1)
    vals = torch.stack([g, h], -1)[:, None, :].expand(c, f, 2) \
        .reshape(-1, 2).contiguous()
    acc = torch.zeros(f * nb, 2, dtype=g.dtype, device=bins.device)
    return time_ms(lambda: acc.index_add_(0, idx, vals), reps=50)


def _rm_bound_ms(c, f, nb):
    """Bytes bound: each row's f code bytes and 8 bytes of grad/hess
    read once, one [f, nb, 2] 4-byte histogram written once."""
    return (c * (f + 8) + f * nb * 2 * 4) / HBM_BYTES_PER_S * 1e3


def check_rowmajor(dev, report, rows):
    """B4 (hist_radix_cuda, float32 and bfloat16) and B7
    (hist_masked_cuda) against their plain versions: on dyadic g/h
    against the plain version on the card (exact in any order), and on
    random float g/h against the plain version on the CPU, which sums in
    the kernels' association (bit for bit); every launch twice. Timed at
    path (b)'s root (``rows`` x 28 uint8 codes, 255 bins) and at a
    SMALL_WINDOW-row window."""
    from lightgbm_tpu_torch.ops import histogram as H
    rng = np.random.RandomState(11)
    worst = 0.0
    for c, f, nb, cdt in [(rows, 28, 255, torch.uint8)] + RM_CASES:
        bins = _rm_codes(rng, c, f, nb, cdt, dev)
        g, h = _dyadic_gh(rng, c, dev)
        for dt in (torch.float32, torch.bfloat16):
            got = H.hist_radix_cuda(bins, g, h, nb, dtype=dt)
            again = H.hist_radix_cuda(bins, g, h, nb, dtype=dt)
            want = H.histogram_radix_plain(bins, g, h, nb, dt)
            torch.cuda.synchronize()
            assert torch.equal(got, again), f"B4 {c}x{f}/{nb}: launches differ"
            assert torch.equal(got, want), f"B4 {c}x{f}/{nb} {dt}: differs"
            worst = max(worst, float((got - want).abs().max()))
        got7 = H.hist_masked_cuda(bins, g, h, nb)
        assert torch.equal(got7, H.histogram_masked_plain(bins, g, h, nb)), \
            f"B7 {c}x{f}/{nb}: differs"
        # random float g/h: bit for bit against the CPU plain version
        g = torch.as_tensor(rng.randn(c).astype(np.float32), device=dev)
        h = torch.as_tensor(rng.rand(c).astype(np.float32), device=dev)
        cb, cg, ch = bins.cpu(), g.cpu(), h.cpu()
        for dt in (torch.float32, torch.bfloat16):
            got = H.hist_radix_cuda(bins, g, h, nb, dtype=dt)
            again = H.hist_radix_cuda(bins, g, h, nb, dtype=dt)
            torch.cuda.synchronize()
            assert torch.equal(got, again), \
                f"B4 {c}x{f}/{nb} {dt} random g/h: launches differ"
            assert torch.equal(got.cpu(), H.histogram_radix_plain(
                cb, cg, ch, nb, dt)), f"B4 {c}x{f}/{nb} {dt} random g/h"
        got7 = H.hist_masked_cuda(bins, g, h, nb)
        assert torch.equal(got7, H.hist_masked_cuda(bins, g, h, nb))
        assert torch.equal(got7.cpu(), H.histogram_masked_plain(
            cb, cg, ch, nb)), f"B7 {c}x{f}/{nb} random g/h"
    log(f"B4 hist_radix / B7 hist_masked: {len(RM_CASES) + 1} shapes x "
        "(f32, bf16) bit-exact against the plain versions on dyadic "
        "(card) and random (CPU) grad/hess, run-to-run identical")
    f, nb = 28, 255
    windows = {}
    for c in (rows, SMALL_WINDOW):
        bins = _rm_codes(rng, c, f, nb, torch.uint8, dev)
        g = torch.as_tensor(rng.randn(c).astype(np.float32), device=dev)
        h = torch.as_tensor(rng.rand(c).astype(np.float32), device=dev)
        windows[c] = (bins, g, h, _rm_index_add_ms(bins, g, h, nb))
    for name, fn, plain, line, what in (
            ("hist_radix",
             lambda b, g, h: H.hist_radix_cuda(b, g, h, nb,
                                               dtype=torch.bfloat16),
             lambda b, g, h: H.histogram_radix_plain(b, g, h, nb,
                                                     torch.bfloat16),
             "lightgbm_tpu/ops/histogram.py:404", "bf16"),
            ("hist_masked",
             lambda b, g, h: H.hist_masked_cuda(b, g, h, nb),
             lambda b, g, h: H.histogram_masked_plain(b, g, h, nb),
             "lightgbm_tpu/ops/histogram.py:125", "f32")):
        _rm_timings(report, name, line, worst, fn, plain, windows, nb, what)


def _rm_timings(report, name, line, worst, fn, plain, windows, nb, what):
    """Time a row-major entry at each of ``windows`` ({rows: (bins, g,
    h, index_add_ ms)}) beside ``index_add_``; the largest (the root)
    goes into the report line."""
    root = max(windows)
    for c, (bins, g, h, lib_ms) in sorted(windows.items(), reverse=True):
        f = bins.shape[1]
        ms = time_ms(lambda: fn(bins, g, h), reps=50)
        plain_ms = time_ms(lambda: plain(bins, g, h), reps=3)
        bound_ms = _rm_bound_ms(c, f, nb)
        if c == root:
            report.append(dict(
                name=name, route="cuda",
                source="lightgbm_tpu_torch/csrc/hist_rowmajor.cu",
                replaces=line, launches=0, max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=lib_ms))
        log(f"{name} {'root' if c == root else 'small'} window {c}x{f}x{nb} "
            f"{what}: {ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, plain "
            f"{plain_ms:.3f} ms, index_add_ {lib_ms:.4f} ms)")


def _synthetic_mv_codes(n, groups, k, seed, dev):
    """[n, k] row-wise flat codes over ``groups`` groups of 2-8 bins
    each: slot 0 the sentinel T, then a random number of present codes
    in DISTINCT groups (as real rows have), -1 pads. Returns (codes, T)."""
    rng = np.random.RandomState(seed)
    gnb = rng.randint(2, 9, size=groups)
    off = np.concatenate([[0], np.cumsum(gnb)[:-1]])
    total = int(gnb.sum())
    base = rng.randint(0, groups, size=n)
    grp = (base[:, None] + 7 * np.arange(k - 1)[None, :]) % groups
    cell = off[grp] + rng.randint(0, 1 << 20, size=grp.shape) % gnb[grp]
    present = np.arange(k - 1)[None, :] < rng.randint(0, k, size=n)[:, None]
    codes = np.full((n, k), -1, np.int32)
    codes[:, 0] = total
    codes[:, 1:] = np.where(present, cell, -1)
    return torch.as_tensor(codes, device=dev), total


def _mv_state(cds, g, h, dev):
    """A planar state holding row-wise codes ``cds`` [m, k] as slot planes
    and grad/hess ``g``/``h`` (float32, or zeros for packed levels set
    later); returns (layout, data, slot-major codes)."""
    from lightgbm_tpu_torch.ops import multival as MV
    from lightgbm_tpu_torch.ops import plane
    m = cds.shape[0]
    sm = MV.slot_major(cds)
    layout = plane.make_layout(1, 8, m, with_label=True, with_score=True,
                               mv_planes=sm.shape[0])
    data = plane.build_data(
        layout, plane.build_codes_planes(
            torch.zeros((m, 1), dtype=torch.int32, device=dev), layout),
        g, h, mv=sm)
    return layout, data, sm


def mv_windows(m):
    """(start, count) windows of the multi-value checks over m rows:
    full, unaligned, 1 row, empty, and windows straddling the kernels'
    512-row tiles."""
    return [(0, m), (m // 5 + 3, m // 3), (1_001, m // 4), (m - 5, 1),
            (m - 1, 1), (5, 1), (17, 0), (3, 512), (511, 513),
            (1_000, 1_537), (77, 4_500), (m - 1_029, 1_029)]


def _mv_live(sm, c, vals):
    """(index, values) of the live codes of the first ``c`` rows of
    slot-major ``sm``: the scatter ``index_add_`` performs."""
    live = sm[:, :c].t().reshape(-1).long()
    keep = live >= 0
    v = vals[:c, None, :].expand(c, sm.shape[0], 2).reshape(-1, 2)
    return live[keep], v[keep].contiguous()


def _mv_timings(report, name, line, worst, fn, plain, nbytes, lib, what,
                sizes):
    """Time a multi-value entry at each row count of ``sizes`` (the
    largest first: the root, which goes into the report line) beside its
    bound, its plain version and ``lib(c)`` (index_add_ ms)."""
    for c in sizes:
        ms = time_ms(lambda: fn(c))
        plain_ms = time_ms(lambda: plain(c), reps=3)
        lib_ms = lib(c)
        bound_ms = nbytes(c) / HBM_BYTES_PER_S * 1e3
        if c == sizes[0]:
            report.append(dict(
                name=name, route="cuda",
                source="lightgbm_tpu_torch/csrc/hist_multival.cu",
                replaces=line, launches=0, max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=lib_ms))
        log(f"{name} {'root' if c == sizes[0] else 'small'} window {c} rows"
            f", {what}: {ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, "
            f"plain {plain_ms:.3f} ms, index_add_ over live codes "
            f"{lib_ms:.4f} ms)")


def check_multival(dev, report, codes, total_bins):
    """B5 (hist_multival_planar_cuda) and B6 (hist_multival_cuda), f32
    and bf16, on random float grad/hess, bit for bit against the plain
    version run on the CPU (it sums in the kernels' association: each
    cell in row order inside 512-row tiles, the tiles in order), at path
    (a)'s real row-wise codes and at a synthetic T beyond one block's
    shared memory, on every ``mv_windows`` window; B5 through host and
    device windows, every launch twice. Timed at path (a)'s root window
    and at a SMALL_WINDOW-row window beside ``index_add_``."""
    from lightgbm_tpu_torch.ops import cuda as K
    from lightgbm_tpu_torch.ops import multival as MV
    rng = np.random.RandomState(12)
    smem_cells = K.lib("hist_multival").lgbt_mv_smem_cells()
    big, big_t = _synthetic_mv_codes(200_000, 3000, 24, 5, dev)
    assert big_t + 1 > smem_cells > total_bins + 1, (big_t, smem_cells)
    worst = 0.0
    timing = None
    for tag, cds, t in (("shape_a", codes, total_bins),
                        ("T_beyond_smem", big, big_t)):
        m = cds.shape[0]
        g = torch.as_tensor(rng.randn(m).astype(np.float32), device=dev)
        h = torch.as_tensor(rng.rand(m).astype(np.float32), device=dev)
        layout, data, sm = _mv_state(cds, g, h, dev)
        cpu = data.cpu()
        gh = MV.gh_planes(g, h)
        kw = dict(mv_start=layout.mv_start, mv_planes=layout.mv_planes,
                  total_bins=t, grad_plane=layout.grad)
        wins = mv_windows(m)
        for dt in (torch.float32, torch.bfloat16):
            for start, count in wins:
                want = MV.histogram_multival_planar_plain(
                    cpu, start, count, dtype=dt, **kw)
                got = MV.hist_multival_planar_cuda(data, start, count,
                                                   dtype=dt, **kw)
                again = MV.hist_multival_planar_cuda(data, start, count,
                                                     dtype=dt, **kw)
                dwin = MV.hist_multival_planar_cuda(
                    data, torch.tensor(start, dtype=torch.int32, device=dev),
                    torch.tensor(count, dtype=torch.int32, device=dev),
                    max_count=m, dtype=dt, **kw)
                b6 = MV.hist_multival_cuda(
                    sm[:, start:start + count], gh[:, start:start + count],
                    total_bins=t, dtype=dt)
                torch.cuda.synchronize()
                what = f"{tag} {start}+{count} {dt}"
                assert torch.equal(got, again), f"B5 {what}: launches differ"
                assert torch.equal(got, dwin), f"B5 {what}: device window"
                worst = max(worst, float((got.cpu() - want).abs().max()))
                assert torch.equal(got.cpu(), want), f"B5 {what}: differs"
                assert torch.equal(b6.cpu(), want), f"B6 {what}: differs"
        if tag == "shape_a":
            timing = (layout, data, sm, gh, g, h, t)
        log(f"B5/B6 multival {tag} (T={t}, K={sm.shape[0]}, {m} rows): "
            f"{len(wins)} windows x (f32, bf16) on random float g/h "
            "bit-exact against the plain version on the CPU, run-to-run "
            "and host/device windows identical")
    layout, data, sm, gh, g, h, t = timing
    kp, n = sm.shape
    sizes = (n, SMALL_WINDOW)
    small = {c: (sm[:, :c].contiguous(), gh[:, :c].contiguous())
             for c in sizes}
    gh2 = torch.stack([g, h], -1)

    def lib(c):
        idx, vals = _mv_live(sm, c, gh2)
        acc = torch.zeros(t + 1, 2, device=dev)
        return time_ms(lambda: acc.index_add_(0, idx, vals))
    kw = dict(mv_start=layout.mv_start, mv_planes=layout.mv_planes,
              total_bins=t, grad_plane=layout.grad, dtype=torch.bfloat16)
    out_b = (t + 1) * 2 * 4
    _mv_timings(
        report, "hist_multival_planar", "lightgbm_tpu/ops/multival.py:450",
        worst, lambda c: MV.hist_multival_planar_cuda(data, 0, c, **kw),
        lambda c: MV.histogram_multival_planar_plain(data, 0, c, **kw),
        lambda c: c * (layout.mv_planes + 2) * 4 + out_b, lib,
        f"K={kp}, T={t}, bf16", sizes)
    _mv_timings(
        report, "hist_multival", "lightgbm_tpu/ops/multival.py:377", worst,
        lambda c: MV.hist_multival_cuda(*small[c], total_bins=t,
                                        dtype=torch.bfloat16),
        lambda c: MV.histogram_multival_plain(*small[c], total_bins=t,
                                              dtype=torch.bfloat16),
        lambda c: c * (kp * 4 + 8) + out_b, lib,
        f"K={kp}, T={t}, bf16, slot-major", sizes)


def _levels(rng, n, num_bins, dev):
    """int32 quantized levels for ``num_bins`` levels, qg at its negative
    extreme every 7th row (the sign-carrying unpack) and qh at its top
    every 5th."""
    qmax_g, qmax_h = num_bins // 2 - 1, num_bins - 1
    qg = rng.randint(-qmax_g, qmax_g + 1, n).astype(np.int32)
    qh = rng.randint(0, qmax_h + 1, n).astype(np.int32)
    qg[::7] = -qmax_g
    qh[::5] = qmax_h
    return torch.as_tensor(qg, device=dev), torch.as_tensor(qh, device=dev)


def _quant_entry(report, name, source, line, ms, plain_ms, nbytes, lib_ms,
                 what):
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    report.append(dict(
        name=name, route="cuda", source=source, replaces=line, launches=0,
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=lib_ms))
    log(f"{name} root window {what}: {ms:.3f} ms (bound {bound_ms:.4f} ms "
        f"by bytes, plain {plain_ms:.3f} ms, int32 index_add_ "
        f"{lib_ms:.3f} ms)")


def _int_index_add_ms(idx, vals, cells):
    acc = torch.zeros(cells, 2, dtype=torch.int32, device=idx.device)
    return time_ms(lambda: acc.index_add_(0, idx, vals))


def check_quant_planar(dev, report, rows):
    """B1q (hist_planar_cuda(quant=True): packed levels in the grad
    plane) and B4q / B7q (int32 levels) bit for bit against their plain
    int32 versions, with 4 and 64 levels; windows full, unaligned, at
    the end of the lanes, 1 row and empty, host and device windows; B1q
    also with more bins than shared memory holds. Timed at paths (d) and
    (f)'s root windows and at a SMALL_WINDOW-row window."""
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import plane
    from lightgbm_tpu_torch.ops import quantize as Q
    rng = np.random.RandomState(21)
    for name, n, g, bits, nb in (("higgs_8bit", 2_000_000, 28, 8, 255),
                                 ("4bit_16bins", 200_000, 9, 4, 16),
                                 ("16bit_40000bins", 100_000, 3, 16, 40_000)):
        layout, data, _ = make_state(n, g, bits, min(1 << bits, nb + 64),
                                     seed=n + 1, dev=dev)
        R = layout.num_lanes
        kw = dict(num_bins=nb, num_cols=g, code_bits=bits,
                  grad_plane=layout.grad, quant=True)
        for levels in (4, 64):
            qg, qh = _levels(rng, R, levels, dev)
            plane.set_gh_packed(data, layout,
                                plane.i32_as_f32(Q.pack_gh(qg, qh)))
            for start, count in ((0, n), (n // 3 + 1, n // 2 + 1),
                                 (R - 12_345, 12_345), (n - 1, 1), (17, 0)):
                got = H.hist_planar_cuda(data, start, count, **kw)
                dwin = H.hist_planar_cuda(
                    data, torch.tensor(start, dtype=torch.int32, device=dev),
                    torch.tensor(count, dtype=torch.int32, device=dev),
                    max_count=R, **kw)
                want = H.histogram_planar_plain(data, start, count, **kw)
                torch.cuda.synchronize()
                assert got.dtype == torch.int32
                assert torch.equal(got, dwin), f"B1q {name} {start}+{count}"
                assert torch.equal(got, want), \
                    f"B1q {name} {start}+{count} levels {levels}: differs"
        log(f"B1q hist_planar quant {name}: 5 windows x (4, 64 levels) "
            "bit-exact against the plain int32 version, host and device "
            "windows identical")
    n = 2_000_000
    layout, data, codes = make_state(n, 28, 8, 255, seed=1, dev=dev)
    qg, qh = _levels(rng, layout.num_lanes, 4, dev)
    plane.set_gh_packed(data, layout, plane.i32_as_f32(Q.pack_gh(qg, qh)))
    codes = torch.as_tensor(codes, device=dev)
    kw = dict(num_bins=255, num_cols=28, code_bits=8, grad_plane=layout.grad,
              quant=True)
    for c in (n, SMALL_WINDOW):
        ms = time_ms(lambda: H.hist_planar_cuda(data, 0, c, **kw), reps=50)
        plain_ms = time_ms(lambda: H.histogram_planar_plain(data, 0, c, **kw),
                           reps=3)
        lib_ms = _planar_index_add_ms(codes[:c],
                                      torch.stack([qg[:c], qh[:c]], -1), 255)
        nbytes = (layout.code_planes + 1) * 4 * c + 28 * 255 * 2 * 4
        if c == n:
            _quant_entry(
                report, "hist_planar_q",
                "lightgbm_tpu_torch/csrc/hist_planar.cu",
                "lightgbm_tpu/ops/histogram.py:702", ms, plain_ms, nbytes,
                lib_ms, f"{n}x28x255, 4 levels")
        else:
            log(f"hist_planar_q small window {c}x28x255, 4 levels: "
                f"{ms:.4f} ms (bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
                f"by bytes, plain {plain_ms:.3f} ms, int32 index_add_ "
                f"{lib_ms:.4f} ms)")
    del data, codes

    for c, f, nb, cdt in [(rows, 28, 255, torch.uint8)] + RM_CASES:
        bins = _rm_codes(rng, c, f, nb, cdt, dev)
        for levels in (4, 64):
            g, h = _levels(rng, c, levels, dev)
            want = H.histogram_radix_plain(bins, g, h, nb)
            for fn, tag in ((H.hist_radix_cuda, "B4q"),
                            (H.hist_masked_cuda, "B7q")):
                got = fn(bins, g, h, nb)
                torch.cuda.synchronize()
                assert got.dtype == torch.int32
                assert torch.equal(got, want), \
                    f"{tag} {c}x{f}/{nb} levels {levels}: differs"
    log(f"B4q hist_radix / B7q hist_masked quant: {len(RM_CASES) + 1} "
        "shapes x (4, 64 levels) bit-exact against the plain int32 version")
    f, nb = 28, 255
    windows = {}
    for c in (rows, SMALL_WINDOW):
        bins = _rm_codes(rng, c, f, nb, torch.uint8, dev)
        g, h = _levels(rng, c, 4, dev)
        windows[c] = (bins, g, h, _rm_index_add_ms(bins, g, h, nb))
    for name, fn, line in (
            ("hist_radix_q", H.hist_radix_cuda,
             "lightgbm_tpu/ops/histogram.py:404"),
            ("hist_masked_q", H.hist_masked_cuda,
             "lightgbm_tpu/ops/histogram.py:125")):
        _rm_timings(report, name, line, 0.0,
                    lambda b, g, h, fn=fn: fn(b, g, h, nb),
                    lambda b, g, h: H.histogram_radix_plain(b, g, h, nb),
                    windows, nb, "4 levels, int32")


def check_quant_multival(dev, report, codes, total_bins):
    """B5q (packed levels in the grad plane) and B6q (packed levels in
    lane row 0) bit for bit against their plain int32 versions, with 4
    and 64 levels, at path (e)'s real row-wise codes, at a synthetic T
    beyond the float mode's block and at one beyond the int32 mode's
    shared histogram; every ``mv_windows`` window plus the end of the
    lanes, host and device windows. Timed at paths (e) and (g)'s root
    windows and at a SMALL_WINDOW-row window beside int32
    ``index_add_``."""
    from lightgbm_tpu_torch.ops import cuda as K
    from lightgbm_tpu_torch.ops import multival as MV
    from lightgbm_tpu_torch.ops import plane
    from lightgbm_tpu_torch.ops import quantize as Q
    rng = np.random.RandomState(22)
    lib_mv = K.lib("hist_multival")
    smem_cells = lib_mv.lgbt_mv_smem_cells()
    q_cells = lib_mv.lgbt_mv_quant_smem_cells()
    big, big_t = _synthetic_mv_codes(200_000, 3000, 24, 5, dev)
    huge, huge_t = _synthetic_mv_codes(50_000, 7000, 16, 6, dev)
    assert big_t + 1 > smem_cells > total_bins + 1, (big_t, smem_cells)
    assert huge_t + 1 > q_cells, (huge_t, q_cells)
    timing = None
    for tag, cds, t in (("shape_e", codes, total_bins),
                        ("T_beyond_smem", big, big_t),
                        ("T_beyond_int32_smem", huge, huge_t)):
        m = cds.shape[0]
        zero = torch.zeros(m, device=dev)
        layout, data, sm = _mv_state(cds, zero, zero, dev)
        R = layout.num_lanes
        kw = dict(mv_start=layout.mv_start, mv_planes=layout.mv_planes,
                  total_bins=t, grad_plane=layout.grad, quant=True)
        wins = mv_windows(m) + [(R - 5, 5)]
        for levels in (4, 64):
            qg, qh = _levels(rng, m, levels, dev)
            plane.set_gh_packed(data, layout,
                                plane.i32_as_f32(Q.pack_gh(qg, qh)))
            gh = MV.gh_planes(qg, qh, quant=True)
            for start, count in wins:
                got = MV.hist_multival_planar_cuda(data, start, count, **kw)
                dwin = MV.hist_multival_planar_cuda(
                    data, torch.tensor(start, dtype=torch.int32, device=dev),
                    torch.tensor(count, dtype=torch.int32, device=dev),
                    max_count=R, **kw)
                want = MV.histogram_multival_planar_plain(data, start, count,
                                                          **kw)
                torch.cuda.synchronize()
                assert got.dtype == torch.int32
                assert torch.equal(got, dwin), f"B5q {tag} {start}+{count}"
                assert torch.equal(got, want), f"B5q {tag} {start}+{count}"
                if start + count > m:
                    continue                   # lanes past the rows
                b6 = MV.hist_multival_cuda(
                    sm[:, start:start + count], gh[:, start:start + count],
                    total_bins=t, quant=True)
                want6 = MV.histogram_multival_plain(
                    sm[:, start:start + count], gh[:, start:start + count],
                    total_bins=t, quant=True)
                torch.cuda.synchronize()
                assert b6.dtype == torch.int32
                assert torch.equal(b6, want6), f"B6q {tag} {start}+{count}"
            if tag == "shape_e" and levels == 4:
                timing = (layout, data, sm, gh, qg, qh, t)
        log(f"B5q/B6q multival quant {tag} (T={t}, K={sm.shape[0]}, {m} "
            f"rows): {len(wins)} windows x (4, 64 levels) bit-exact against "
            "the plain int32 versions, host and device windows identical")
    layout, data, sm, gh, qg, qh, t = timing
    kp, n = sm.shape
    sizes = (n, SMALL_WINDOW)
    small = {c: (sm[:, :c].contiguous(), gh[:, :c].contiguous())
             for c in sizes}
    q2 = torch.stack([qg, qh], -1)

    def lib(c):
        idx, vals = _mv_live(sm, c, q2)
        return _int_index_add_ms(idx, vals, t + 1)
    kw = dict(mv_start=layout.mv_start, mv_planes=layout.mv_planes,
              total_bins=t, grad_plane=layout.grad, quant=True)
    out_b = (t + 1) * 2 * 4
    _mv_timings(
        report, "hist_multival_planar_q", "lightgbm_tpu/ops/multival.py:450",
        0.0, lambda c: MV.hist_multival_planar_cuda(data, 0, c, **kw),
        lambda c: MV.histogram_multival_planar_plain(data, 0, c, **kw),
        lambda c: c * (layout.mv_planes + 1) * 4 + out_b, lib,
        f"K={kp}, T={t}, 4 levels, int32", sizes)
    _mv_timings(
        report, "hist_multival_q", "lightgbm_tpu/ops/multival.py:377", 0.0,
        lambda c: MV.hist_multival_cuda(*small[c], total_bins=t, quant=True),
        lambda c: MV.histogram_multival_plain(*small[c], total_bins=t,
                                              quant=True),
        lambda c: c * (kp * 4 + 4) + out_b, lib,
        f"K={kp}, T={t}, 4 levels, int32, slot-major", sizes)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """float32 tensors equal bit for bit, NaN equal to NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


def check_xla_float(dev):
    """XLA:CPU's float32 arithmetic that the port reproduces (so that
    its gradients carry the JAX package's bits) gives the CPU's bits on
    the card: ``exp_f32`` on 2^24 inputs spread over every float32 bit
    pattern (stride 256), ``fma_f32`` on 2^20 random triples, and the
    binary gradients (get_gradients with weights, persistent_grads) and
    the predict transform on 2^22 scores; ``log1p_f32`` on 2^22 bit
    patterns, and the multiclass (softmax, 5 classes) and weighted
    cross_entropy_lambda (exp, log1p) gradients and transforms on 2^20
    rows."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective.functions import (BinaryLogloss,
                                                        create_objective)
    from lightgbm_tpu_torch.ops import xla_float as XF
    n = 1 << 24
    x = ((torch.arange(n, dtype=torch.int64) * 256 + 77) & 0xFFFFFFFF).to(
        torch.int32).view(torch.float32)
    t0 = time.perf_counter()
    assert _same_bits(XF.exp_f32(x.to(dev)).cpu(), XF.exp_f32(x)), \
        "exp_f32: the card differs from the CPU"
    rng = np.random.RandomState(31)
    m = 1 << 20
    abc = [torch.as_tensor((rng.randn(m) * np.exp(rng.uniform(-30, 30, m)))
                           .astype(np.float32)) for _ in range(3)]
    assert _same_bits(XF.fma_f32(*(v.to(dev) for v in abc)).cpu(),
                      XF.fma_f32(*abc)), "fma_f32: the card differs"

    k = 1 << 22

    class _Meta:
        label = (rng.rand(k) > 0.45).astype(np.float32)
        weights = rng.uniform(0.2, 3.0, k).astype(np.float32)
    obj = BinaryLogloss(Config.from_params({"objective": "binary",
                                            "scale_pos_weight": 1.3}))
    obj.init(_Meta, k)
    score = torch.as_tensor((rng.randn(k) * 4).astype(np.float32))
    score[:4096] = torch.linspace(-120.0, 120.0, 4096)
    aux = torch.as_tensor(obj.persistent_aux()[0])
    for name, card, cpu in (
            ("get_gradients", obj.get_gradients(score.to(dev)),
             obj.get_gradients(score)),
            ("persistent_grads",
             obj.persistent_grads(score.to(dev), aux.to(dev), None),
             obj.persistent_grads(score, aux, None)),
            ("convert_output", (obj.convert_output(score.to(dev)),),
             (obj.convert_output(score),))):
        for a, b in zip(card, cpu):
            assert _same_bits(a.cpu(), b), f"{name}: the card differs"
    xl = x[::4].contiguous()
    assert _same_bits(XF.log1p_f32(xl.to(dev)).cpu(), XF.log1p_f32(xl)), \
        "log1p_f32: the card differs from the CPU"
    r = 1 << 20
    weights = rng.uniform(0.2, 3.0, r).astype(np.float32)
    for params, shape, label in (
            ({"objective": "multiclass", "num_class": 5}, (5, r),
             rng.randint(0, 5, r)),
            ({"objective": "cross_entropy_lambda"}, (r,), rng.rand(r))):
        obj = create_objective(Config.from_params(params))
        obj.init(types.SimpleNamespace(label=label.astype(np.float32),
                                       weights=weights), r)
        sc = torch.as_tensor((rng.randn(*shape) * 4).astype(np.float32))
        raw = sc.t().contiguous()
        pairs = list(zip(obj.get_gradients(sc.to(dev)),
                         obj.get_gradients(sc)))
        pairs.append((obj.convert_output(raw.to(dev)),
                      obj.convert_output(raw)))
        for a, b in pairs:
            assert _same_bits(a.cpu(), b), \
                f"{params['objective']}: the card differs"
    log(f"xla_float: exp_f32 on {n} inputs over the float32 range, "
        f"fma_f32 on {m} triples, binary gradients (weighted) and the "
        f"predict transform on {k} scores, log1p_f32 on {n // 4} inputs, "
        f"multiclass (5 classes) and weighted cross_entropy_lambda "
        f"gradients and transforms on {r} rows: card == CPU bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 3: the paths
# ---------------------------------------------------------------------------

def window_rows(tree):
    """Rows a path's kernels must touch to grow ``tree``: the histogram
    reads the root window and, at every split, the smaller child's
    window (the larger child is the parent minus it); the partition
    moves the parent's window."""
    if tree.num_leaves < 2:
        return 0, 0

    def rows(child):
        return int(tree.internal_count[child] if child >= 0
                   else tree.leaf_count[~child])
    hist, part = int(tree.internal_count[0]), 0
    for node in range(tree.num_leaves - 1):
        left, right = rows(tree.left_child[node]), rows(tree.right_child[node])
        hist += min(left, right)
        part += left + right
    return hist, part


def iteration_bounds_ms(gbdt, trees):
    """Mean per-tree bytes bound at HBM rate of the path's histogram
    kernel and (fused learner) of B2: the histogram reads its bytes per
    row over the windows of ``window_rows`` and writes one histogram per
    launch; B2 reads and writes P words per row of its windows.
    Histogram bytes per row: B1 (code_planes + 2) x 4, B5
    (mv_planes + 2) x 4, B4 F code bytes + 8, B6 Kp x 4 + 8; the int32
    modes of B1, B5 and B6 read one packed gh word instead of two."""
    from lightgbm_tpu_torch.ops.multival import MV_SK
    fl, tl = gbdt._fused, gbdt.tree_learner
    gh_words = 1 if (fl or tl)._quant else 2
    if fl is not None:
        Ly = fl.layout
        if Ly.mv_planes:
            per_row = (Ly.mv_planes + gh_words) * 4
            out = fl._mv_total_bins + 1
        else:
            nbins = (fl.group_max_bin if fl._efb_hist is not None
                     else fl.max_num_bin)
            per_row = (Ly.code_planes + gh_words) * 4
            out = Ly.num_cols * nbins
        part_row = 2 * Ly.num_planes * 4
    else:
        if tl._mv_state is not None:
            codes, total, _ = tl._mv_state
            kp = -(-codes.shape[1] // MV_SK) * MV_SK
            per_row, out = kp * 4 + gh_words * 4, total + 1
        else:
            b = tl.bins
            nbins = (tl.group_max_bin if tl._efb_hist is not None
                     else tl.max_num_bin)
            per_row = b.shape[1] * b.element_size() + 8
            out = b.shape[1] * nbins
        part_row = 0
    hist_b = part_b = 0
    for t in trees:
        h, p = window_rows(t)
        hist_b += h * per_row + t.num_leaves * out * 2 * 4
        part_b += p * part_row
    n = max(len(trees), 1)
    return (hist_b / n / HBM_BYTES_PER_S * 1e3,
            part_b / n / HBM_BYTES_PER_S * 1e3)


def held_out_metric(booster, X, y, metric, device):
    """``metric`` (the port's own, computed on ``device``) of the
    booster's predictions on held-out rows ([N] raw scores, or [N, K]
    with K classes)."""
    from lightgbm_tpu_torch.metric.metrics import create_metric
    gbdt = booster._gbdt
    k = gbdt.num_tree_per_iteration
    raw = booster.predict(X, raw_score=True)
    assert raw.shape == ((len(y),) if k == 1 else (len(y), k))
    assert np.isfinite(raw).all()
    m = create_metric(metric, gbdt.config)

    class _Meta:
        label, weights = y, None
    m.init(_Meta, len(y))
    obj = gbdt.objective if metric != "auc" else None
    score = torch.as_tensor(raw.T if k > 1 else raw, device=device)
    val = m.eval_device(score, obj)[0][1]
    return float(m.finish(val.reshape(-1).to(torch.float64).cpu().numpy()))


def run_path(name, params, ds, iters, X_hold, y_hold, expect,
             device="cuda", floor=0.70, metric="auc", fobj=None):
    """Train ``iters`` iterations through lightgbm_tpu_torch.train with
    every launch counter set to 0 just before and read just after; fail
    unless each kernel of ``expect`` was launched. Prints seconds and
    host syncs per iteration, launches, the per-iteration bytes bounds
    and the held-out ``metric``, which must be above ``floor`` (AUC) or
    below it (a loss); returns (launches, booster, metric value)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda as K
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    marks = []

    def learner_syncs(gbdt):
        return (gbdt._fused if gbdt._fused is not None
                else gbdt.tree_learner).syncs

    def timer(env):
        sync()
        marks.append((time.perf_counter(), learner_syncs(env.model._gbdt)))

    K.reset_launches()
    marks.append((time.perf_counter(), 0))
    booster = lgt.train({**params, "device_type": device}, ds,
                        num_boost_round=iters, callbacks=[timer],
                        verbose_eval=False, fobj=fobj)
    sync()
    launches = dict(K.LAUNCHES)
    gbdt = booster._gbdt
    trees = gbdt.models
    k = gbdt.num_tree_per_iteration
    leaves = [t.num_leaves for t in trees]
    secs = [marks[i][0] - marks[i - 1][0] for i in range(1, len(marks))]
    for i, sec in enumerate(secs, 1):
        log(f"{name}: iteration {i}: {sec:.4f} s, "
            f"{marks[i][1] - marks[i - 1][1]} host syncs, "
            f"{leaves[(i - 1) * k:i * k]} leaves")
    assert len(trees) == iters * k, (name, len(trees), iters, k)
    if device == "cuda":
        for k in expect:
            assert launches[k] > 0, f"{name}: kernel {k} never launched"
    hb, pb = iteration_bounds_ms(gbdt, trees)
    val = held_out_metric(booster, X_hold, y_hold, metric, device)
    log(f"{name}: launches {json.dumps(launches)}; leaves per tree "
        f"{leaves}; histogram rows per tree "
        f"{[window_rows(t)[0] for t in trees]}; per-iteration bytes bound "
        f"histogram {hb:.4f} ms, partition {pb:.4f} ms")
    log(f"{name}: held-out {'AUC' if metric == 'auc' else metric} "
        f"{val:.6f} on {len(y_hold)} rows after {iters} iterations "
        f"(floor {floor:.6f}); mean {np.mean(secs):.4f} s/iteration, "
        f"{(marks[-1][1] - marks[0][1]) / iters:.1f} host syncs/iteration")
    log(f"{name}: launches per iteration " + json.dumps(
        {key: round(launches[key] / iters, 1) for key in expect}))
    if metric == "auc":
        assert floor < val <= 1.0, (name, val)
    else:
        assert 0.0 <= val < floor, (name, val, floor)
    return launches, booster, val


def wide_data(rows, hold, device):
    """Shape (a): the wide-sparse CSR and its constructed Dataset (the
    default config), plus held-out rows."""
    import lightgbm_tpu_torch as lgt
    X, y = make_wide_like(rows + hold)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:rows], label=y[:rows],
                     params={**WIDE_PARAMS, "device_type": device})
    ds.construct()
    occ = ds.handle.occupancy
    log(f"shape (a): {rows} x {X.shape[1]} CSR binned in "
        f"{time.perf_counter() - t0:.2f} s (host): {occ.num_groups} groups, "
        f"{occ.row_nnz_mean:.2f} present codes per row (max "
        f"{occ.row_nnz_max})")
    return ds, X[rows:], y[rows:]


HIGGS_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                "verbose": -1}
WIDE_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
# the default quantized config (docs/QUANTIZED_GRADIENTS.md)
QUANT_PARAMS = {"use_quantized_grad": True, "num_grad_quant_bins": 4,
                "stochastic_rounding": True, "quant_train_renew_leaf": True}
# a quantized path's held-out AUC may trail its float twin's by this
# much (a sanity floor: parity is the CPU tests' job)
QUANT_AUC_SLACK = 0.02


def cat_data(rows, hold, device):
    """Path (h)'s data: make_higgs_cat_like, its constructed Dataset and
    held-out rows."""
    import lightgbm_tpu_torch as lgt
    X, y, cats = make_higgs_cat_like(rows + hold, seed=5)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:rows], label=y[:rows], categorical_feature=cats,
                     params={**HIGGS_PARAMS, "device_type": device})
    ds.construct()
    nb = [ds.handle.bin_mappers[c].num_bin for c in cats]
    log(f"HIGGS-cat: dataset {rows} x {X.shape[1]} binned in "
        f"{time.perf_counter() - t0:.2f} s (host); categorical columns "
        f"{cats} of {list(CAT_LEVELS)} levels take {nb} bins")
    return ds, X[rows:], y[rows:]


# paths (i)-(k): the HIGGS columns with a regression label; (i) has no
# objective key (the default regression, metric l2)
REG_PARAMS = {"num_leaves": 255, "max_bin": 255, "verbose": -1}
REG_PATHS = [("i", "(i) HIGGS-reg fused", {}, "l2"),
             ("j", "(j) HIGGS-quantile fused",
              {"objective": "quantile", "alpha": 0.9}, "quantile"),
             ("k", "(k) HIGGS-MAPE fused", {"objective": "mape"}, "mape")]


def reg_data(rows, hold, device):
    """Paths (i)-(k)'s data: make_higgs_reg_like (seed 0: the HIGGS
    path's columns), its constructed Dataset, held-out rows, and each
    metric's floor on the held-out rows: 0.8 x the label variance (l2),
    and the loss of the constant 0.9-quantile (quantile) and of the
    constant median (mape) of the training labels, in numpy float64."""
    import lightgbm_tpu_torch as lgt
    X, y = make_higgs_reg_like(rows + hold, 28, seed=0)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:rows], label=y[:rows],
                     params={**REG_PARAMS, "device_type": device})
    ds.construct()
    yt, yh = y[:rows].astype(np.float64), y[rows:].astype(np.float64)
    r = yh - np.quantile(yt, 0.9)
    floors = {"l2": 0.8 * float(np.var(yh)),
              "quantile": float(np.mean(np.where(r < 0, -0.1 * r, 0.9 * r))),
              "mape": float(np.mean(np.abs(yh - np.median(yt))
                                    / np.maximum(1.0, np.abs(yh))))}
    log(f"HIGGS-reg: dataset {rows} x 28 binned in "
        f"{time.perf_counter() - t0:.2f} s (host); held-out label variance "
        f"{np.var(yh):.6f}; floors {json.dumps(floors)}")
    return ds, X[rows:], y[rows:], floors


# paths (l)-(n): the per-tree fused path (grow_device)
MC_PARAMS = {"num_leaves": 255, "max_bin": 255, "num_class": 5,
             "verbose": -1}
# (key, name, objective, held-out metric, its bound, iterations)
MC_PATHS = [("l", "(l) HIGGS-multiclass fused", "multiclass",
             "multi_logloss", float(np.log(5.0)), 5),
            ("m", "(m) HIGGS-multiclassova fused", "multiclassova",
             "multi_error", 0.8, 3)]
FOBJ_ITERS = 3                     # path (n)


def mc_data(rows, hold, device):
    """Paths (l)-(m)'s data: make_higgs_reg_like (seed 0: the HIGGS
    columns) with 5 classes, the quintiles of its regression label over
    the training rows; the constructed Dataset and held-out rows."""
    import lightgbm_tpu_torch as lgt
    X, yr = make_higgs_reg_like(rows + hold, 28, seed=0)
    y = np.digitize(yr, np.quantile(yr[:rows], [0.2, 0.4, 0.6, 0.8])
                    ).astype(np.float32)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:rows], label=y[:rows],
                     params={**MC_PARAMS, "objective": "multiclass",
                             "device_type": device})
    ds.construct()
    log(f"HIGGS-multiclass: dataset {rows} x 28 binned in "
        f"{time.perf_counter() - t0:.2f} s (host); held-out class shares "
        f"{np.bincount(y[rows:].astype(np.int64), minlength=5) / hold}")
    return ds, X[rows:], y[rows:]


def binary_fobj(preds, data):
    """Path (n)'s custom objective: the binary log loss's gradients in
    numpy float64 from the raw training scores."""
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - data.get_label(), p * (1.0 - p)


class method_timer:
    """Times each call of ``cls.<name>`` while active: CUDA events
    around it on the card (read after the training has synchronized, so
    the timing adds no blocking read) and host seconds. Entering yields
    the list of (device ms, host ms) that fills when the context
    exits. ``debug_sync``: run each call under CUDA sync debug mode
    "error", so a host read inside it raises."""

    def __init__(self, cls, name, debug_sync=False):
        self.cls, self.name, self.debug_sync = cls, name, debug_sync

    def __enter__(self):
        self.orig = self.cls.__dict__[self.name]
        self.marks, self.out = [], []
        orig, marks, debug_sync = self.orig, self.marks, self.debug_sync

        def timed(obj, *a, **kw):
            cuda = torch.cuda.is_available() and getattr(
                obj, "device", torch.device("cpu")).type == "cuda"
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if cuda else None
            if cuda:
                ev[0].record()
            t0 = time.perf_counter()
            if cuda and debug_sync:
                torch.cuda.set_sync_debug_mode("error")
            try:
                res = orig(obj, *a, **kw)
            finally:
                if cuda and debug_sync:
                    torch.cuda.set_sync_debug_mode("default")
            host = (time.perf_counter() - t0) * 1e3
            if cuda:
                ev[1].record()
            marks.append((ev, host))
            return res
        setattr(self.cls, self.name, timed)
        return self.out

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)
        if self.marks and self.marks[0][0] is not None:
            torch.cuda.synchronize()
        self.out.extend((ev[0].elapsed_time(ev[1]) if ev else host, host)
                        for ev, host in self.marks)
        return False


def _ms(marks):
    """'mean device ms (host ms)' of a method_timer's list."""
    return (f"{np.mean([m[0] for m in marks]):.3f} ms "
            f"({np.mean([m[1] for m in marks]):.3f} ms host)")


# paths (o)-(s): row sampling and the boosting modes on the per-tree
# fused path: (key, name, params over HIGGS_PARAMS or WIDE_PARAMS, wide?)
BAG_PATHS = [
    ("o", "(o) HIGGS bagging fused",
     {"bagging_fraction": 0.8, "bagging_freq": 1}, False),
    ("p", "(p) HIGGS GOSS fused",
     {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1,
      "learning_rate": 0.25}, False),
    ("q", "(q) HIGGS DART fused",
     {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.5}, False),
    ("r", "(r) HIGGS RF fused",
     {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
      "feature_fraction": 0.8}, False),
    ("s", "(s) wide bagging fused",
     {"bagging_fraction": 0.8, "bagging_freq": 1}, True),
]
BAG_WIDE_ITERS = 3                 # path (s)
BAG_CASE_ROWS = 30_000             # phase 4's boosting-mode cases


def bag_paths(args, ds, hX, hy, wide, device="cuda"):
    """Paths (o)-(s): returns {key: launches}. Each prints the per-tree
    bag build (gather + pack, CUDA events), the bag's rows, and (p) the
    sampling rounds, each run under sync debug mode "error"; (q) its
    drop and normalize steps."""
    from lightgbm_tpu_torch.boosting import gbdt as G
    from lightgbm_tpu_torch.treelearner.fused import FusedSerialGrower
    wds, wX, wy = wide
    got = {}
    for key, name, extra, is_wide in BAG_PATHS:
        t_path = time.perf_counter()
        params = {**(WIDE_PARAMS if is_wide else HIGGS_PARAMS), **extra}
        dset, Xh, yh = (wds, wX, wy) if is_wide else (ds, hX, hy)
        iters = BAG_WIDE_ITERS if is_wide else args.iters
        expect = (("hist_multival_planar", "partition") if is_wide
                  else ("hist_planar", "partition"))
        with method_timer(FusedSerialGrower, "bag_state") as builds, \
                method_timer(G.GOSS, "_bagging", debug_sync=True) as goss, \
                method_timer(G.DART, "_dropping_trees") as drops, \
                method_timer(G.DART, "_normalize") as norms:
            got[key], booster, _ = run_path(name, params, dset, iters, Xh,
                                            yh, expect, device)
        gb = booster._gbdt
        fl = gb._fused
        assert fl is not None and not gb._fused_persist, name
        assert type(gb).__name__ == {"p": "GOSS", "q": "DART",
                                     "r": "RF"}.get(key, "GBDT"), name
        if key == "q":
            assert fl._score_from_partition and not builds, name
            log(f"{name}: drop step {_ms(drops)}, normalize {_ms(norms)} "
                f"per iteration; tree weights "
                f"{[round(w, 5) for w in gb.tree_weight]}")
        else:
            assert not fl._score_from_partition, name
            assert len(builds) == iters, (name, len(builds))
            log(f"{name}: bag of {gb.bag_data_cnt} of {gb.num_data} rows "
                f"in the last iteration; per-tree bag build (gather + "
                f"pack) {_ms(builds)}: " + ", ".join(
                    f"{b[0]:.3f}" for b in builds))
        if key == "p":
            warm = int(1.0 / params["learning_rate"])
            assert len(goss) == iters, (name, len(goss))
            assert gb.bag_data_cnt == int(gb.num_data * 0.2) + int(
                gb.num_data * 0.1), (name, gb.bag_data_cnt)
            log(f"{name}: {iters - warm} sampling rounds (iterations "
                f"{warm}-{iters - 1}) under sync debug mode \"error\": no "
                f"host read; GOSS step {_ms(goss[warm:])} per sampling "
                f"round")
        if key == "r":
            assert gb.average_output and gb.shrinkage_rate == 1.0, name
        log(f"{name}: {time.perf_counter() - t_path:.1f} s in all")
    return got


def paths(args, report, wide, device="cuda"):
    """Phase 3: the HIGGS fused path and paths (a)-(c), then their
    quantized twins (d)-(g), the categorical path (h), the regression
    paths (i)-(k), the per-tree paths (l)-(n) and the row-sampling and
    boosting-mode paths (o)-(s). Each kernel's ``launches`` in the
    report is the count from its own path(s)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.treelearner.fused import FusedSerialGrower
    hold = 200_000
    X, y = make_higgs_like(args.rows + hold, 28, seed=0)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:args.rows], label=y[:args.rows],
                     params={**HIGGS_PARAMS, "device_type": device})
    ds.construct()
    log(f"HIGGS: dataset {args.rows} x 28 binned in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    wds, wX, wy = wide
    cfg = Config.from_params(WIDE_PARAMS)
    assert H.hist_layout(cfg, wds.handle) == "multival", "(a) not multival"
    hX, hy = X[args.rows:], y[args.rows:]
    rds, rX, ry, reg_floors = reg_data(args.rows, hold, device)
    cds, cX, cy = cat_data(args.rows, hold, device)
    cat_params = {**HIGGS_PARAMS,
                  "categorical_feature": list(range(28, 32))}
    # (key, name, params, dataset, iterations, held-out rows, kernels,
    #  AUC floor, float twin); (i)-(k) add their metric
    plan = [
        ("higgs", "HIGGS fused", HIGGS_PARAMS, ds, args.iters, hX, hy,
         ("hist_planar", "partition"), 0.70, None),
        ("a", "(a) wide-sparse fused", WIDE_PARAMS, wds, args.wide_iters,
         wX, wy, ("hist_multival_planar", "partition"), 0.70, None),
        ("b", "(b) dense host loop", {**HIGGS_PARAMS, "extra_trees": True},
         ds, args.host_iters, hX, hy, ("hist_radix",), 0.65, None),
        ("c", "(c) wide-sparse host loop", {**WIDE_PARAMS, "tpu_fused": False},
         wds, args.wide_host_iters, wX, wy, ("hist_multival",), 0.70, None),
        ("d", "(d) HIGGS fused quantized", {**HIGGS_PARAMS, **QUANT_PARAMS},
         ds, args.iters, hX, hy, ("hist_planar_q", "partition"), 0.0,
         "higgs"),
        ("e", "(e) wide-sparse fused quantized",
         {**WIDE_PARAMS, **QUANT_PARAMS}, wds, args.wide_iters, wX, wy,
         ("hist_multival_planar_q", "partition"), 0.0, "a"),
        ("f", "(f) dense host loop quantized",
         {**HIGGS_PARAMS, "extra_trees": True, **QUANT_PARAMS}, ds,
         args.host_iters, hX, hy, ("hist_radix_q",), 0.0, "b"),
        ("g", "(g) wide-sparse host loop quantized",
         {**WIDE_PARAMS, "tpu_fused": False, **QUANT_PARAMS}, wds,
         args.wide_host_iters, wX, wy, ("hist_multival_q",), 0.0, "c"),
        ("h", "(h) HIGGS-cat fused", cat_params, cds, args.iters, cX, cy,
         ("hist_planar", "partition"), 0.70, None),
    ] + [(key, name, {**REG_PARAMS, **extra}, rds, args.iters, rX, ry,
          ("hist_planar", "partition"), reg_floors[metric], None, metric)
         for key, name, extra, metric in REG_PATHS]
    mds, mX, my = mc_data(args.rows, hold, device)
    plan += [(key, name, {**MC_PARAMS, "objective": obj}, mds, iters, mX,
              my, ("hist_planar", "partition"), floor, None, metric)
             for key, name, obj, metric, floor, iters in MC_PATHS]
    plan.append(("n", "(n) wide custom-objective fused", WIDE_PARAMS, wds,
                 FOBJ_ITERS, wX, wy,
                 ("hist_multival_planar", "partition"), 0.75, None, "auc",
                 binary_fobj))
    got, aucs = {}, {}
    for key, name, params, dset, iters, Xh, yh, expect, floor, twin, \
            *more in plan:
        t_path = time.perf_counter()
        if twin is not None:
            floor = aucs[twin] - QUANT_AUC_SLACK
        metric, fobj = (more + ["auc", None][len(more):])[:2]
        with method_timer(FusedSerialGrower, "_renew_leaf_outputs") \
                as refits:
            got[key], booster, aucs[key] = run_path(
                name, params, dset, iters, Xh, yh, expect, device,
                floor=floor, metric=metric, fobj=fobj)
        gb = booster._gbdt
        learner = gb._fused if gb._fused is not None else gb.tree_learner
        assert learner._quant == (twin is not None), name
        if key in ("l", "m", "n"):
            # the per-tree path: no persistent state, K trees per
            # iteration, a fresh planar state per tree
            assert gb._fused is not None and not gb._fused_persist, name
            assert gb._fused_state is None, name
            assert (gb.objective is None) == (key == "n"), name
            log(f"{name}: {gb.num_tree_per_iteration} trees per iteration "
                f"through grow_device, layout P = "
                f"{gb._fused.layout.num_planes}"
                f"{' (multi-value)' if gb._fused.layout.mv_planes else ''}")
        if key in ("a", "e", "n") and device == "cuda":
            assert gb._fused._hist_method == "multival_pallas", \
                f"{name}: the dispatcher did not pick the multi-value layout"
        if twin is not None:
            log(f"{name}: held-out AUC {aucs[key]:.6f} beside its float "
                f"twin's {aucs[twin]:.6f} (diff "
                f"{aucs[key] - aucs[twin]:+.6f})")
        if key == "h":
            trees = gb.models
            ncat = sum(t.num_cat for t in trees)
            log(f"{name}: {ncat} categorical splits in {len(trees)} trees; "
                f"B2 launches on the categorical route "
                f"{got[key]['partition_cat']} of {got[key]['partition']}")
            assert gb._fused is not None, f"{name}: not the fused learner"
            if device == "cuda":
                assert got[key]["partition_cat"] > 0, \
                    f"{name}: B2's categorical route never launched"
                t_prof = time.perf_counter()
                profile_iteration(name, booster, device_only=True)
                log(f"{name}: profiled iteration took "
                    f"{time.perf_counter() - t_prof:.1f} s with the "
                    f"profiler's own work")
        if key in ("j", "k"):
            spec = gb.objective.persistent_renew_spec()
            assert gb._fused is not None and spec is not None, name
            assert len(refits) == iters, (name, len(refits))
            log(f"{name}: refit (alpha {spec[0]}, weighted {spec[1]}) "
                f"{np.mean([r[0] for r in refits]):.3f} ms per iteration "
                f"of stream time between CUDA events around it "
                f"({np.mean([r[1] for r in refits]):.3f} ms host time), "
                f"{iters} refits: " + ", ".join(
                    f"{r[0]:.3f}" for r in refits))
        if key in ("i", "j", "k") and device == "cuda":
            profile_iteration(name, booster, device_only=True)
        log(f"{name}: {time.perf_counter() - t_path:.1f} s in all")
    got.update(bag_paths(args, ds, hX, hy, wide, device))
    path_of = {"hist_planar": ["higgs", "h", "i", "j", "k", "l", "m", "o",
                               "p", "q", "r"],
               "partition": ["higgs", "a", "d", "e", "h", "i", "j", "k",
                             "l", "m", "n", "o", "p", "q", "r", "s"],
               "hist_radix": ["b"], "hist_multival_planar": ["a", "n", "s"],
               "hist_multival": ["c"], "hist_masked": [],
               "partition_window": [], "hist_planar_q": ["d"],
               "hist_radix_q": ["f"], "hist_masked_q": [],
               "hist_multival_planar_q": ["e"], "hist_multival_q": ["g"]}
    for r in report:
        r["launches"] = sum(got[p][r["name"]] for p in path_of[r["name"]])


# ---------------------------------------------------------------------------
# phase 4: card run against the port's own CPU run
# ---------------------------------------------------------------------------

def card_vs_cpu():
    """Phase 4: the same small training on the card and on the CPU (the
    plain versions), on both learners, float and quantized, on path
    (h)'s columns with categorical features, and with the regression,
    quantile and MAPE objectives (the percentile refits): trees (bitset
    pools included), leaf values and predictions, these with prediction
    early stop off and on for the categorical model."""
    import lightgbm_tpu_torch as lgt
    n = 100_000
    X, y = make_higgs_like(n, 28, seed=3)
    Xc, yc, cats = make_higgs_cat_like(n, seed=6)
    Xr, yr = make_higgs_reg_like(n, 28, seed=3)
    cat = {"categorical_feature": cats}
    cases = [("fused", {}, (X, y)),
             ("host loop", {"tpu_fused": False}, (X, y)),
             ("fused quantized", QUANT_PARAMS, (X, y)),
             ("host loop quantized", {"tpu_fused": False, **QUANT_PARAMS},
              (X, y)),
             ("fused categorical", cat, (Xc, yc)),
             ("host loop categorical", {"tpu_fused": False, **cat},
              (Xc, yc))]
    for obj in ({"objective": "regression"},
                {"objective": "quantile", "alpha": 0.9},
                {"objective": "mape"}):
        cases += [(f"fused {obj['objective']}", obj, (Xr, yr)),
                  (f"host loop {obj['objective']}",
                   {"tpu_fused": False, **obj}, (Xr, yr))]
    # the per-tree path: 3 classes (the terciles of the regression
    # label), and a custom objective (no objective function)
    y3 = np.digitize(yr, np.quantile(yr, [1 / 3, 2 / 3])).astype(np.float32)
    exact = set()
    for obj in ({"objective": "multiclass", "num_class": 3},
                {"objective": "multiclassova", "num_class": 3},
                {"objective": "none", "fobj": binary_fobj}):
        name = ("custom objective" if "fobj" in obj else obj["objective"])
        data = (X, y) if "fobj" in obj else (Xr, y3)
        cases += [(f"fused {name}", obj, data),
                  (f"host loop {name}", {"tpu_fused": False, **obj}, data)]
        exact |= {f"fused {name}", f"host loop {name}"}
    # row sampling and the boosting modes (both learners), and bagging
    # where it sends the fused config to the host loop, on the first
    # BAG_CASE_ROWS rows (the CPU side sets the phase's time)
    bag = {"bagging_fraction": 0.7, "bagging_freq": 1}
    m = BAG_CASE_ROWS
    for name, obj, data in (
            ("bagging", bag, (X[:m], y[:m])),
            ("pos/neg bagging", {"pos_bagging_fraction": 0.6,
                                 "neg_bagging_fraction": 0.8,
                                 "bagging_freq": 1}, (X[:m], y[:m])),
            ("GOSS", {"boosting": "goss", "learning_rate": 0.5},
             (X[:m], y[:m])),
            ("DART", {"boosting": "dart", "drop_rate": 0.5,
                      "skip_drop": 0.0}, (X[:m], y[:m])),
            ("RF", {"boosting": "rf", "bagging_fraction": 0.632,
                    "bagging_freq": 1, "feature_fraction": 0.8},
             (X[:m], y[:m])),
            ("multiclass bagging", {"objective": "multiclass",
                                    "num_class": 3, **bag},
             (Xr[:m], y3[:m]))):
        cases += [(f"fused {name}", obj, data),
                  (f"host loop {name}", {"tpu_fused": False, **obj}, data)]
        exact |= {f"fused {name}", f"host loop {name}"}
    cases += [("host loop quantized bagging", {**QUANT_PARAMS, **bag},
               (X[:m], y[:m])),
              ("host loop regression_l1 bagging",
               {"objective": "regression_l1", **bag}, (Xr[:m], yr[:m]))]
    exact |= {"host loop quantized bagging",
              "host loop regression_l1 bagging"}
    for learner, extra, data in cases:
        out = {}
        xs, ys = data
        extra = dict(extra)
        fobj = extra.pop("fobj", None)
        for dev in ("cuda", "cpu"):
            params = {"objective": "binary", "tpu_hist_dtype": "float32",
                      "verbose": -1, "device_type": dev, **extra}
            b = lgt.train(params, lgt.Dataset(xs, label=ys),
                          num_boost_round=3, verbose_eval=False, fobj=fobj)
            preds = [b.predict(xs[:20_000])]
            if "categorical_feature" in extra:
                cfg = b._gbdt.config
                cfg.pred_early_stop, cfg.pred_early_stop_freq = True, 1
                cfg.pred_early_stop_margin = 1.0
                preds.append(b.predict(xs[:20_000], raw_score=True))
                cfg.pred_early_stop = False
            out[dev] = (b._gbdt.models, preds)
        (tg, pg), (tc, pc) = out["cuda"], out["cpu"]
        per_iter = b._gbdt.num_tree_per_iteration
        if learner.startswith("host loop"):
            assert b._gbdt._fused is None, learner
        assert len(tg) == len(tc) == 3 * per_iter
        for a, b in zip(tg, tc):
            k = a.num_leaves
            assert k == b.num_leaves, (learner, k, b.num_leaves)
            for f in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
                assert np.array_equal(getattr(a, f)[:k - 1],
                                      getattr(b, f)[:k - 1]), (learner, f)
            for f in ("cat_boundaries", "cat_threshold",
                      "cat_boundaries_inner", "cat_threshold_inner"):
                assert list(getattr(a, f)) == list(getattr(b, f)), \
                    (learner, f)
            np.testing.assert_allclose(a.leaf_value[:k], b.leaf_value[:k],
                                       rtol=0, atol=1e-6)
        for p_g, p_c in zip(pg, pc):
            np.testing.assert_allclose(p_g, p_c, rtol=0, atol=1e-6)
            if learner in exact:
                assert np.array_equal(p_g, p_c), learner
                for a, b in zip(tg, tc):
                    assert np.array_equal(a.leaf_value, b.leaf_value)
                    assert np.array_equal(a.split_gain, b.split_gain)
        leaf_diff = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                        for a, b in zip(tg, tc))
        ncat = sum(t.num_cat for t in tg)
        if "categorical_feature" in extra:
            assert ncat > 0, f"{learner}: no categorical split"
        log(f"card vs CPU ({learner}): {len(ys)} rows, 3 iterations of "
            f"{per_iter} trees: trees "
            f"equal ({[t.num_leaves for t in tg]} leaves, {ncat} "
            f"categorical splits), leaf values max |diff| {leaf_diff:.3g}, "
            f"predictions max |diff| "
            + ", ".join(f"{float(np.abs(a - b).max()):.3g}"
                        for a, b in zip(pg, pc))
            + (" (early stop off, on)" if len(pg) > 1 else ""))


def profile_paths(args, wide):
    """One steady-state iteration of each path under torch.profiler:
    device time by kernel family, kernel count, and the device's busy
    share of the iteration's wall time, beside the bytes bound of the
    path's histogram kernel for the profiled tree."""
    import lightgbm_tpu_torch as lgt
    X, y = make_higgs_like(args.rows, 28, seed=0)
    dense = lgt.Dataset(X, label=y, params=HIGGS_PARAMS).construct()
    wds = wide[0]
    cases = [("higgs", "HIGGS fused", HIGGS_PARAMS, dense),
             ("a", "(a) wide-sparse fused", WIDE_PARAMS, wds),
             ("b", "(b) dense host loop",
              {**HIGGS_PARAMS, "extra_trees": True}, dense),
             ("c", "(c) wide-sparse host loop",
              {**WIDE_PARAMS, "tpu_fused": False}, wds)]
    cases += [(k, f"({k}) quantized twin of {name}",
               {**params, **QUANT_PARAMS}, d)
              for k, (_, name, params, d) in zip("defg", cases)]
    keep = args.profile_paths.split(",")
    if "h" in keep:
        cases.append(("h", "(h) HIGGS-cat fused",
                      {**HIGGS_PARAMS,
                       "categorical_feature": list(range(28, 32))},
                      cat_data(args.rows, 0, "cuda")[0]))
    if any(k in keep for k, *_ in REG_PATHS):
        rds = reg_data(args.rows, 1000, "cuda")[0]
        cases += [(k, name, {**REG_PARAMS, **extra}, rds)
                  for k, name, extra, _ in REG_PATHS]
    if "l" in keep or "m" in keep:
        mds = mc_data(args.rows, 1000, "cuda")[0]
        cases += [(k, name, {**MC_PARAMS, "objective": obj}, mds)
                  for k, name, obj, *_ in MC_PATHS]
    cases.append(("n", "(n) wide custom-objective fused",
                  {**WIDE_PARAMS, "objective": "none"}, wds))
    for key, name, params, ds in cases:
        if key not in keep:
            continue
        booster = lgt.Booster(params, ds)
        fobj = binary_fobj if key == "n" else None
        booster.update(fobj=fobj)          # warm: state built, first tree
        # the per-tree paths' K x 255 splits: device rows only
        profile_iteration(name, booster, device_only=key in ("l", "m", "n"),
                          fobj=fobj)


def profile_iteration(name, booster, device_only=False, fobj=None):
    """One boosting iteration of ``booster`` under torch.profiler: wall
    and device busy time, kernels, host syncs, device ms by kernel
    family beside the bytes bounds, and the top kernels. Only device
    rows are read; ``device_only`` records no host operators, which
    cuts the profiler's own work on ~200,000 kernels from minutes to
    seconds (the wall time is then less inflated than ``--profile``'s)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if not device_only:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    gbdt = booster._gbdt
    learner = gbdt._fused if gbdt._fused is not None else gbdt.tree_learner
    syncs0 = learner.syncs
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        booster.update(fobj=fobj)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows_ = []
    for evt in prof.key_averages():
        # device-side rows only (kernels, memcpy, memset): operator
        # rows repeat their kernels' time
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows_.append((dev_us, evt.count, evt.key))
    rows_.sort(reverse=True)
    assert rows_, f"profile {name}: the profiler saw no device work"
    busy = sum(r[0] for r in rows_) / 1e6
    fam = {"hist": 0.0, "partition": 0.0, "other": 0.0}
    for dev_us, _, key in rows_:
        f = ("hist" if any(k in key for k in ("hist_", "hp_", "rm_", "mv_"))
             else "partition" if "part_" in key else "other")
        fam[f] += dev_us / 1e3
    trees = gbdt.models[-gbdt.num_tree_per_iteration:]
    tree = trees[-1]
    hb, pb = (k * len(trees) for k in iteration_bounds_ms(gbdt, trees))
    log(f"profile {name}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(r[1] for r in rows_)} kernels, "
        f"{learner.syncs - syncs0} host syncs, {tree.num_leaves} leaves")
    log(f"profile {name}: device ms by family " + json.dumps(
        {k: round(v, 3) for k, v in fam.items()}) + f"; histogram "
        f"kernel {fam['hist']:.3f} ms vs bytes bound {hb:.4f} ms "
        f"({fam['hist'] / max(hb, 1e-9):.0f}x), partition kernel "
        f"{fam['partition']:.3f} ms vs {pb:.4f} ms")
    for dev_us, count, key in rows_[:8]:
        log(f"profile {name}: {dev_us / 1e3:9.3f} ms  {count:6d}x  "
            f"{key[:80]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="training rows of the HIGGS-shaped paths (HIGGS "
                    "has 10.5M)")
    ap.add_argument("--iters", type=int, default=8,
                    help="iterations of the HIGGS fused path, (d), (h) "
                    "and (i)-(k)")
    ap.add_argument("--wide-rows", type=int, default=1_048_576,
                    help="training rows of shape (a) (the bench.py wide "
                    "sidecar's own default)")
    ap.add_argument("--wide-iters", type=int, default=5)
    ap.add_argument("--host-iters", type=int, default=3,
                    help="iterations of path (b)")
    ap.add_argument("--wide-host-iters", type=int, default=2,
                    help="iterations of path (c)")
    ap.add_argument("--profile", action="store_true",
                    help="only profile one iteration of each path and exit")
    ap.add_argument("--profile-paths",
                    default="higgs,a,b,c,d,e,f,g,h,i,j,k,l,m,n",
                    help="comma-separated paths --profile profiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "lightgbm_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from lightgbm_tpu_torch.ops import cuda as K
    from lightgbm_tpu_torch.ops import multival as MV

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; {smi}")
    t_start = time.perf_counter()
    K.build_all()
    log(f"build: {K.BUILD_INFO['seconds']:.1f} s for "
        f"{K.BUILD_INFO['built'] or 'nothing (cached)'}")
    for name, text in K.BUILD_INFO["log"].items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")

    dev = torch.device("cuda")
    wide = wide_data(args.wide_rows, 100_000, "cuda")
    check_xla_float(dev)
    if args.profile:
        profile_paths(args, wide)
        return 0     # a profile prints no smoke result
    report: list = []
    check_hist(dev, report)
    check_partition(dev, report)
    check_rowmajor(dev, report, args.rows)
    h = wide[0].handle
    gnb = (h.bundles.group_num_bins if h.bundles is not None
           else [m.num_bin for m in h.bin_mappers])
    codes, lay = MV.build_rowwise_codes(h.bins, gnb, h.occupancy.default_code)
    codes = torch.as_tensor(codes, device=dev)
    check_multival(dev, report, codes, lay.total_bins)
    check_quant_planar(dev, report, args.rows)
    check_quant_multival(dev, report, codes, lay.total_bins)
    del codes
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")
    paths(args, report, wide)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    card_vs_cpu()
    log(f"all phases done in {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
