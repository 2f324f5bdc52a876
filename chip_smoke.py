#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lightgbm_tpu_torch) on one card.

    python3 chip_smoke.py [--rows 2000000] [--iters 10]

Phases, each of which fails the run (no exception is caught):

1. build  — compile every CUDA kernel of the main path from csrc/ (one
   nvcc per source, in parallel); print the build seconds and the card.
2. kernels — every kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge cases; time each at the root
   window beside its bound, the plain version and a library yardstick.
3. main path — lightgbm_tpu_torch.train on a HIGGS-shaped synthetic
   (28 features, 255 leaves, 255 bins), launch counts of every kernel
   read around the run, AUC on held-out rows.
4. card vs CPU — the same small training on cuda and on cpu (the plain
   versions): trees, leaf values and predictions must agree.

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

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def make_higgs_like(n, f, seed=0, scale=2.4):
    """HIGGS-shaped synthetic (a copy of bench.py make_higgs_like):
    labels drawn from p = sigmoid(s(x)), s standardized to ``scale``,
    Bayes-optimal AUC ~0.875."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    s = (0.9 * X[:, 0] - 0.8 * X[:, 1] + 1.1 * X[:, 2] * X[:, 3]
         + 0.8 * np.sin(2 * X[:, 4]) * X[:, 5] + 0.6 * (X[:, 6] ** 2 - 1)
         + 0.7 * X[:, 7] * X[:, 8] * X[:, 9]
         + 0.5 * np.tanh(X[:, 10]) * X[:, 11])
    s = (s - s.mean()) / s.std() * scale
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-s))).astype(np.float32)
    return X, y


def time_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
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
    # (name, rows, cols, code_bits, num_bins, windows)
    ("higgs_8bit", 2_000_000, 28, 8, 255,
     [(0, 2_000_000), (777_777, 1_000_001), (2_000_000 - 12_345, 12_345),
      (1_234_567, 3), (5_000, 0)]),
    ("4bit_16bins", 200_000, 9, 4, 16,
     [(0, 200_000), (1_001, 150_000), (17, 3), (500, 0)]),
    ("16bit_1000bins", 300_000, 5, 16, 1000,
     [(0, 300_000), (333, 200_001), (5, 3), (0, 0)]),
]


def check_hist(dev, report):
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import cuda as K
    assert K.lib("hist_planar").lgbt_hist_tile() == H.HIST_TILE
    worst = 0.0
    for name, n, g, bits, nb, windows in HIST_CASES:
        layout, data, _ = make_state(n, g, bits, nb, seed=n + g, dev=dev)
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
                want = H.histogram_planar_plain(data, start, count, dtype=dt,
                                                **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, again), \
                    f"B1 {name} {start}+{count} {dt}: launches differ"
                assert torch.equal(got, dwin), \
                    f"B1 {name} {start}+{count} {dt}: device window differs"
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
                worst = max(worst, float((got - want).abs().max()))
        log(f"B1 hist_planar {name}: {len(windows)} windows x (f32, bf16) "
            "match the plain version, run-to-run bit-identical")
    # timing at the main path's root window (2M rows, 28 cols, 255 bins,
    # bf16 inputs as the main path runs them)
    name, n, g, bits, nb, _ = HIST_CASES[0]
    layout, data, codes = make_state(n, g, bits, nb, seed=1, dev=dev)
    kw = dict(num_bins=nb, num_cols=g, code_bits=bits, grad_plane=layout.grad,
              dtype=torch.bfloat16)
    ms = time_ms(lambda: H.hist_planar_cuda(data, 0, n, **kw))
    plain_ms = time_ms(lambda: H.histogram_planar_plain(data, 0, n, **kw),
                       reps=3)
    # yardstick: ONE index_add_ over the already-unpacked (feature, bin)
    # indices — the scatter alone, without unpacking
    idx = (torch.arange(g, device=dev)[None, :] * nb
           + torch.as_tensor(codes, device=dev).long()).reshape(-1)
    vals = torch.randn(n * g, 2, device=dev)
    acc = torch.zeros(g * nb, 2, device=dev)
    lib_ms = time_ms(lambda: acc.index_add_(0, idx, vals))
    nbytes = (layout.code_planes + 2) * 4 * n + g * nb * 2 * 4
    nops = 2 * n * g
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
    report.append(dict(
        name="hist_planar", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_planar.cu",
        replaces="lightgbm_tpu/ops/histogram.py:702",
        launches=0, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms))
    log(f"B1 hist_planar root window {n}x{g}x{nb} bf16: {ms:.3f} ms "
        f"(bound {bound_ms:.4f} ms by bytes, plain {plain_ms:.3f} ms, "
        f"index_add_ {lib_ms:.3f} ms)")


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


def check_partition(dev, report):
    from lightgbm_tpu_torch.ops import plane
    n = 2_000_000
    layout, base, codes = make_state(n, 28, 8, 256, seed=7, dev=dev)
    bitset = np.zeros(plane.CAT_WORDS, np.uint32)
    for b in (3, 17, 42, 128, 200, 255):
        bitset[b // 32] |= np.uint32(1 << (b % 32))
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
        ("tiny_3", 1_234_567, 3, dict(feature=9, threshold=128,
                                      default_left=0, miss_bin=-1)),
        ("count_1", 77, 1, dict(feature=9, threshold=128, default_left=0,
                                miss_bin=-1)),
        ("count_0", 500, 0, dict(feature=9, threshold=128, default_left=0,
                                 miss_bin=-1)),
    ]
    l4, base4, _ = make_state(1_048_576, 9, 4, 16, seed=9, dev=dev)
    cases4 = [("4bit_shift16", 300, 1_000_000,
               dict(feature=4, threshold=7, default_left=0, miss_bin=15)),
              ("4bit_shift12", 0, 1_048_576,
               dict(feature=3, threshold=9, default_left=1, miss_bin=2))]
    for lay, st, cs in ((layout, base, cases), (l4, base4, cases4)):
        for name, start, count, kw in cs:
            rscal = plane.route_scalars(lay, device=dev, **kw)
            got, nl_got = plane.partition_cuda(st.clone(), lay, start, count,
                                               rscal)
            want, nl_want = plane.partition_plain(st.clone(), lay, start,
                                                  count, rscal)
            torch.cuda.synchronize()
            assert int(nl_got) == int(nl_want), (name, int(nl_got),
                                                 int(nl_want))
            assert torch.equal(got, want), f"B2 {name}: data differs"
        log(f"B2 partition: {len(cs)} cases bit-exact "
            f"(P={lay.num_planes}, lanes={lay.num_lanes})")
    # timing at the main path's root window
    rscal = plane.route_scalars(layout, device=dev, **cases[0][3])
    work = base.clone()
    ms = time_ms(lambda: plane.partition_cuda(work, layout, 0, n, rscal))
    plain_ms = time_ms(lambda: plane.partition_plain(work, layout, 0, n,
                                                     rscal), reps=3)
    key = (torch.as_tensor(codes[:, 3], device=dev) > 120).to(torch.int32)

    def library():
        return work[:, :n].index_select(1, torch.argsort(key, stable=True))
    lib_ms = time_ms(library)
    P = layout.num_planes
    bound_ms = 2 * P * 4 * n / HBM_BYTES_PER_S * 1e3
    report.append(dict(
        name="partition", route="cuda",
        source="lightgbm_tpu_torch/csrc/partition.cu",
        replaces="lightgbm_tpu/ops/plane.py:991",
        launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms))
    log(f"B2 partition root window {n} lanes x P={P}: {ms:.3f} ms (bound "
        f"{bound_ms:.4f} ms by bytes, plain {plain_ms:.3f} ms, "
        f"argsort+index_select {lib_ms:.3f} ms)")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def window_rows(tree):
    """Rows the main path's kernels must touch to grow ``tree``: B1 reads
    the root window and, at every split, the smaller child's window (the
    larger child is the parent minus it); B2 moves the parent's window."""
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


def iteration_bounds_ms(grower, trees):
    """Mean per-tree bytes bound of B1 and B2 over ``trees`` at HBM rate:
    B1 reads (code_planes + 2) words per row of its windows and writes one
    [F, B, 2] f32 histogram per launch; B2 reads and writes P words per
    row of its windows."""
    Ly = grower.layout
    nbins = (grower.group_max_bin if grower._efb_hist is not None
             else grower.max_num_bin)
    hist_b = part_b = 0
    for t in trees:
        h, p = window_rows(t)
        hist_b += (h * (Ly.code_planes + 2) * 4
                   + t.num_leaves * Ly.num_cols * nbins * 2 * 4)
        part_b += p * 2 * Ly.num_planes * 4
    n = max(len(trees), 1)
    return (hist_b / n / HBM_BYTES_PER_S * 1e3,
            part_b / n / HBM_BYTES_PER_S * 1e3)

def main_path(rows, iters, report, device="cuda"):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metric.metrics import AUCMetric
    from lightgbm_tpu_torch.ops import cuda as K
    hold = 200_000
    X, y = make_higgs_like(rows + hold, 28, seed=0)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbose": -1, "device_type": device}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ds = lgt.Dataset(X[:rows], label=y[:rows], params=params)
    t0 = time.perf_counter()
    ds.construct()
    log(f"main path: dataset {rows} x 28 binned in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    marks = []

    def timer(env):
        sync()
        marks.append((time.perf_counter(), env.model._gbdt._fused.syncs))

    K.reset_launches()
    marks.append((time.perf_counter(), 0))
    booster = lgt.train(params, ds, num_boost_round=iters, callbacks=[timer],
                        verbose_eval=False)
    sync()
    launches = dict(K.LAUNCHES)
    trees = booster._gbdt.models
    leaves = [t.num_leaves for t in trees]
    for i in range(1, len(marks)):
        log(f"main path: iteration {i}: {marks[i][0] - marks[i - 1][0]:.4f} s,"
            f" {marks[i][1] - marks[i - 1][1]} host syncs, "
            f"{leaves[i - 1]} leaves")
    log(f"main path: kernel launches {json.dumps(launches)}; "
        f"trees {len(trees)}, leaves per tree {leaves}")
    win = [window_rows(t) for t in trees]
    hb, pb = iteration_bounds_ms(booster._gbdt._fused, trees)
    log(f"main path: rows per tree read by B1 {[w[0] for w in win]}, "
        f"moved by B2 {[w[1] for w in win]}; per-iteration bytes bound "
        f"B1 {hb:.4f} ms, B2 {pb:.4f} ms")
    assert len(trees) == iters, (len(trees), iters)
    if device == "cuda":
        assert launches["hist_planar"] == sum(leaves) > 0, launches
        assert launches["partition"] == sum(k - 1 for k in leaves) > 0, \
            launches
    for r in report:
        r["launches"] = launches[r["name"]]
    pred = booster.predict(X[rows:], raw_score=True)
    assert pred.shape == (hold,) and np.isfinite(pred).all()
    metric = AUCMetric(booster.config)

    class _Meta:
        label, weights = y[rows:], None
    metric.init(_Meta, hold)
    auc = float(metric.eval_device(torch.as_tensor(pred, device=device))[0][1])
    log(f"main path: held-out AUC {auc:.6f} on {hold} rows "
        f"({iters} iterations)")
    assert 0.70 < auc <= 1.0, auc


# ---------------------------------------------------------------------------
# phase 4: card run against the port's own CPU run
# ---------------------------------------------------------------------------

def card_vs_cpu():
    import lightgbm_tpu_torch as lgt
    n = 100_000
    X, y = make_higgs_like(n, 28, seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        params = {"objective": "binary", "tpu_hist_dtype": "float32",
                  "verbose": -1, "device_type": dev}
        b = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=3,
                      verbose_eval=False)
        out[dev] = (b._gbdt.models, b.predict(X[:20_000]))
    (tg, pg), (tc, pc) = out["cuda"], out["cpu"]
    assert len(tg) == len(tc) == 3
    for a, b in zip(tg, tc):
        k = a.num_leaves
        assert k == b.num_leaves, (k, b.num_leaves)
        for f in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(a, f)[:k - 1],
                                  getattr(b, f)[:k - 1]), f
        np.testing.assert_allclose(a.leaf_value[:k], b.leaf_value[:k],
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pg, pc, rtol=0, atol=1e-5)
    log(f"card vs CPU: {n} rows, 3 iterations, float32 histograms: trees "
        f"equal ({[t.num_leaves for t in tg]} leaves), predictions max "
        f"|diff| {float(np.abs(pg - pc).max()):.3g}")


def profile_iteration(rows):
    """One steady-state training iteration of the main path under
    torch.profiler: device time by kernel, kernel count, and the
    device's busy share of the iteration's wall time."""
    import lightgbm_tpu_torch as lgt
    X, y = make_higgs_like(rows, 28, seed=0)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbose": -1}
    booster = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    booster.update()                       # warm: state built, first tree
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows_ = []
    for evt in prof.key_averages():
        # device-side rows only (kernels, memcpy, memset): operator rows
        # repeat their kernels' time
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows_.append((dev_us, evt.count, evt.key))
    rows_.sort(reverse=True)
    busy = sum(r[0] for r in rows_) / 1e6
    log(f"profile: one iteration {rows} x 28, 255 leaves: wall "
        f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f}%), {sum(r[1] for r in rows_)} kernels")
    fam = {"hist_planar": 0.0, "partition": 0.0, "other": 0.0}
    for dev_us, _, key in rows_:
        f = ("hist_planar" if "hist_" in key else
             "partition" if "part_" in key else "other")
        fam[f] += dev_us / 1e3
    log("profile: device ms by family " + json.dumps(
        {k: round(v, 3) for k, v in fam.items()}))
    tree = booster._gbdt.models[-1]
    hb, pb = iteration_bounds_ms(booster._gbdt._fused, [tree])
    log(f"profile: this iteration's tree: B1 reads {window_rows(tree)[0]} "
        f"rows (bytes bound {hb:.4f} ms, measured "
        f"{fam['hist_planar']:.3f} ms = {fam['hist_planar'] / hb:.0f}x), "
        f"B2 moves {window_rows(tree)[1]} rows (bound {pb:.4f} ms, measured "
        f"{fam['partition']:.3f} ms = {fam['partition'] / pb:.0f}x)")
    for dev_us, count, key in rows_[:15]:
        log(f"profile: {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="training rows of the main path (HIGGS has 10.5M)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile", action="store_true",
                    help="only profile one main-path iteration and exit")
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    K.build_all()
    log(f"build: {K.BUILD_INFO['seconds']:.1f} s for "
        f"{K.BUILD_INFO['built'] or 'nothing (cached)'}")
    for name, text in K.BUILD_INFO["log"].items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")

    if args.profile:
        profile_iteration(args.rows)
        return 0     # a profile prints no smoke result
    report: list = []
    check_hist(torch.device("cuda"), report)
    check_partition(torch.device("cuda"), report)
    main_path(args.rows, args.iters, report)
    card_vs_cpu()

    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
