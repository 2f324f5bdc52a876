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
     must launch);
   - (i)-(k): the HIGGS columns with a regression label (score plus
     N(0, 1) noise) on the fused learner (B1 + B2): (i) the default
     objective (no objective key: regression, metric l2), (j) quantile
     at alpha 0.9 and (k) MAPE, the last two with the in-program
     percentile refit (unweighted; weighted, as MAPE's weight plane
     carries its label weights), timed per iteration with CUDA events;
     each held-out metric must beat its floor (0.8 x the label variance;
     the constant 0.9-quantile's and the constant median's loss).
   - (l)-(n): the per-tree fused path (``grow_device``: each class
     tree's planar state built from row-order gradients into the
     learner's one buffer, the split step captured from the second
     tree, the score update through each row's leaf, no read): (l)
     HIGGS-multiclass fused, the HIGGS columns with 5 classes (the quintiles of (i)'s label), multiclass,
     1 iteration (5 trees), B1 + B2, held-out multi_logloss below the
     constant predictor's ln 5; (m) the same data with multiclassova, 1
     iteration, held-out multi_error below the constant predictor's
     0.8; (n) shape (a) (multi-value layout, P = 128) with a custom
     objective (the binary log loss in numpy), 2 iterations, B5 + B2,
     held-out AUC above 0.75. Each prints its kernels' launches per
     iteration.
   - (o)-(s): row sampling and the boosting modes on the per-tree fused
     path, each tree grown on a bag-ordered state gathered and packed
     per tree (its build timed by CUDA events) and every row scored by
     traversal: (o) HIGGS bagging (bagging_fraction 0.8, bagging_freq
     1), (p) HIGGS GOSS (top_rate 0.2, other_rate 0.1, learning_rate
     0.5: iteration 2 on samples 30% of the rows, each sampling round
     run with CUDA sync debug mode "error", so a host read fails the
     run), (q) HIGGS DART (drop_rate 0.1, skip_drop 0.5; the unbagged
     per-tree state; the drop and normalize steps timed), (r) HIGGS RF
     (bagging_fraction 0.632, bagging_freq 1, feature_fraction 0.8),
     all B1 + B2 for 3 iterations with held-out AUC above 0.70, and (s)
     shape (a) with bagging (0.8, freq 1), B5 + B2 over bag-gathered
     slot planes, 2 iterations.
   - (t) HIGGS forced splits: the HIGGS shape on the persistent fused
     path with a depth-2 forced-split tree (FORCED_SPLITS), --iters
     iterations; every tree's first three splits must be the forced
     ones (B1 + B2).
   - (u) the API: --iters // 2 iterations, save_model and
     Booster(model_file=...) (raw predictions bit-equal), the rest from
     init_model (the held-out AUC within 5e-4 of the HIGGS path's after
     --iters straight), rollback_one_iter, cv
     over 3 stratified folds (1 iteration), and a 50,000-row CSV read
     through the csv module into a Dataset, save_binary and back.
   - (v) MSLR lambdarank: MSLR-WEB10K Fold 1's shape (make_rank_like:
     136 dense columns, 723,412 training rows in 6,000 queries of 1 to
     1,250 documents, labels 0-4 in MSLR's shares; 1,000 held-out
     queries), objective=lambdarank, metric ndcg at 1, 3, 5 and 10, 255
     leaves and bins, 3 iterations on the per-tree fused path (B1 +
     B2); the ranking gradient timed by CUDA events; the held-out
     ndcg@10 must beat a random ordering's (numpy). (w) the same data
     with rank_xendcg, 2 iterations.
   - (x) the rest of the API: LGBMRanker on (v)'s first 1,000 queries
     with an eval set and eval_group, then predict; LGBMClassifier on
     10,000 HIGGS rows (predict_proba equal to Booster.predict);
     pred_contrib on 500 rows of its model (each row summing to its
     raw score within 1e-6, timed: a host recursion); the command line
     through subprocess (``python -m lightgbm_tpu_torch`` task=train
     on a 10,000-row CSV, task=predict equal to Booster.predict of the
     model file, task=convert_model a non-empty C++ file).
3b. multi-GPU — MG_WORLD = 2 ranks spawned with torch.multiprocessing
   (a FileStore rendezvous; NCCL for the card's tensors with gloo for the
   host's when there are two cards, rank r on cuda:r; on one card gloo
   carries both ranks on cuda:0, the CUDA tensors staged through host
   memory; the backend, ranks and cards are printed). Each rank runs:
   - (y) HIGGS data-parallel fused: the HIGGS path's data and params
     with tree_learner=data (the persistent FusedDataParallelGrower:
     B1 + B2 over each rank's 1,000,000 rows, one reduction of the
     smaller child's histogram per split) for --iters iterations; every
     rank's model text must be equal and the held-out AUC within 2e-3
     of the one-card HIGGS path's; prints s/iteration, host syncs, the
     reductions' calls, bytes and CUDA-event time per iteration, B1 / B2
     launches per rank per iteration and peak memory per rank;
   - (z) every parallel learner on 12,000 rows, 2 iterations, on the
     card and on the CPU in the same group: the persistent and the
     bagged (per-tree) fused data-parallel learner, multiclass (5
     classes), quantized gradients, the host-loop data-parallel,
     voting (top_k 5) and feature-parallel learners; each case's
     model equal on every rank, and card == CPU as phase 4 holds it.
4. card vs CPU — the same small training of 2 iterations of 15 leaves
   (12,000 rows;
   10,000 from the
   boosting-mode cases on) on cuda and on cpu (the plain
   versions), on the fused and on the host-loop learner, with float32
   and with quantized gradients, on (h)'s columns with categorical
   features, with the regression, quantile and MAPE objectives, and
   with multiclass, multiclassova and a custom objective, and with
   bagging, pos/neg bagging, GOSS, DART, RF and multiclass with bagging
   (both learners), quantized gradients and regression_l1 with bagging
   (the host loop), forced splits (persistent, bagging, host loop,
   quantized), lambdarank and rank_xendcg on both learners and
   lambdarank with quantized gradients (the host loop; 250 MSLR-shaped
   queries), quantized tweedie and quantized weighted regression on the
   fused learner, and init_model, rollback_one_iter and refit: trees
   (bitset pools included), leaf values and predictions must agree (the
   per-tree, boosting-mode, forced, ranking, quantized-regression and
   API cases exactly), with prediction early stop off and on for the
   categorical model.

5. robustness — checkpoint and resume, fault injection
   (``LGBM_TPU_FAULT_PLAN``), the hang watchdog and the numeric
   sentinels (lightgbm_tpu_torch/robust/):
   - (aa) chaos resume: the HIGGS path's data and params (2,000,000 x
     28, 255 leaves and bins) on the persistent fused learner (B1 + B2),
     a checkpoint every 2 iterations; a child process importing only the
     port is killed by SIGKILL entering iteration 3 (return code -9, the
     drill and not a failure), a second child resumes from the
     checkpoint of iteration 2 and finishes 4 iterations; its model text
     must equal an uninterrupted run's on the card byte for byte. Prints
     the checkpoint's bytes, its save ms (wall clock around ``save``),
     the resume's load and restore ms and the iteration time;
   - (ab) resume in process on 50,000 rows (63 leaves): the host loop
     (B4), quantized gradients (B1q + B2), bagging with
     feature_fraction, GOSS, DART, multiclass and early stopping with a
     valid set, each 1 iteration into a checkpoint directory and then 2
     in a second train() call, byte-equal to the uninterrupted run;
   - (ac) numeric_sentinels on 50,000 rows: train.iteration:nan@3 on
     the host loop and sentinel.check:nan@3 on the fused learner, each
     one tree fewer than the clean run with finite predictions and the
     card's model text equal to the CPU's; then 2 iterations of the
     HIGGS path with sentinels on and off, whose learner host syncs and
     syncing CUDA calls (sync debug mode "warn") per iteration must be
     equal (train()'s end may take one more call with them: the drain
     of the verdicts still on the card);
   - (ad) train.iteration:hang=3.0@4 against hang_timeout=1.2 on
     50,000 rows: without auto_resume it must raise HangTimeout (the
     only exception the smoke catches), with auto_resume and a
     checkpoint directory it must equal the clean run byte for byte.
6. observability — the telemetry (lightgbm_tpu_torch/obs/):
   - (ae), after phase 5: the HIGGS path's data and params, first in
     OBS_PAIRS alternating pairs of 2-iteration runs without telemetry
     and with metrics_file and trace_file (telemetry's cost per steady
     iteration, median and spread, and the host split by phase from
     the records; each model equal to phase 3's), then for
     OBS_PROFILED_ITERS iterations with full telemetry (metrics_file,
     trace_file, profile_dir, obs_port on a free port, flight_dir) and
     the held-out rows as a valid set: every JSONL record valid, its
     four phase fields summing to t_iter_s (in the pairs too); phase
     coverage >= 95% (the JAX package's gate; on the pairs' steady
     iterations and on every profiled one); the trace's sync events per
     iteration equal
     to the learner's host syncs + the eval read + the stream sync,
     each attributed to a lightgbm_tpu_torch/ file:line; /metrics,
     /healthz and /statusz fetched from a callback during training;
     mem.live_peak_bytes between mem.planar_state_bytes and the
     allocator's peak; the profiler's trace naming B1's (hp_partials)
     and B2's (part_small / part_tiles) kernels; the model text equal
     to phase 3's HIGGS run's at the same depth but the echoed
     telemetry keys. Prints the card's kernel time per phase (kernels
     mapped to the learner span around their launch), the top sync
     sites, s/iteration beside phase 3's, and the syncing CUDA calls
     of one traced iteration by call site (sync debug mode "warn");
   - (af), in (ad): the raising run also sets flight_dir and
     trace_file: exactly one bundle (manifest with trigger watchdog,
     trace.json, registry.json, stacks.txt), the HangTimeout
     diagnosis naming the flushed trace, trace-report --flight on it;
   - (ag), in (y): metrics_file and trace_file per rank: rank 0's
     records carry a fleet view of both ranks, coll.host_skew on every
     record, each rank's collective bytes equal to network.STATS, and
     trace-report --merge of the two traces gives one process track
     per rank.

7. the pipelined loop, the split step's syncing calls and warm-up, after
   phase 6, on phase 3's HIGGS dataset:
   - (ah) PIPE_PAIRS alternating pairs of PIPE_ITERS-iteration runs of
     the default (pipelined) loop and LGBM_TPU_PIPELINE=0 with the
     held-out rows as a valid set: s/iteration per pair and medians;
     every model text equal to phase 3's, the held-out AUC equal to
     phase 3's and, at the default rows and iterations, to HIGGS_AUC_3;
     then the learner reads and syncing CUDA calls of each iteration
     of a pipelined run (sync debug mode "warn"), the steady one at
     most SYNC_CALLS_MAX;
   - (ai) early stopping (ES_ROUNDS rounds) on a valid set with every
     second label flipped, under both loops: the same best iteration,
     the model texts equal at it, the pipelined run at most one tree
     longer; and at ES_CASE_ROWS rows, card == CPU (best iteration,
     trees, model text, raw predictions within 1e-6);
   - (aj) the time to the first iteration (WARM_ROWS rows of the HIGGS
     shape) in child processes on a copy of the package without its
     build directory: cold without the
     warm-up, cold with tpu_warmup, then warm; then task=warmup and
     task=train of the CLI on a WARM_CSV_ROWS-row CSV in a fresh copy
     (the train process must find all 4 libraries by their hash), with
     the compile.* counters of each.

8. the split loop without reads, after phase 7, on phase 3's HIGGS
   dataset (no valid set):
   - (ak) a pair of DEV_ITERS-iteration runs: the captured split step
     (the default on the card: the first tree eager, then one capture)
     and the eager device loop (the learner's ``_eager_loop``): equal
     model texts, the first two trees equal to phase 3's; s/iteration
     of each, captures and their seconds; then the counted reads (0)
     and the syncing CUDA calls (at most DEV_SYNC_CALLS_MAX, by site)
     of two steady ``Booster.update()`` calls, the wrappers' launches of
     one (replays counted), and one profiled steady iteration under
     each loop (B1 / B2 ms per iteration);
   - (al) LGBM_TPU_ITER_BATCH=4 over DEV_BATCH_ITERS iterations (a
     batch of 4, then a partial one): the model text of batch 1;
   - (am) card == CPU on the new loop at phase 4's sizes (PHASE4_ROWS
     rows, PHASE4_LEAVES leaves), DEV_CASE_ITERS iterations, plain and
     quantized.
   B2's device-window entry is held in phase 2: every partition case
   again through ``partition_dev_cuda`` (one set of buffers bounded by
   the rows), bit for bit against the plain version on both routes and
   at a zero count, and timed beside the host-window entry at the root
   and at 16,384 lanes.

9. the per-tree path without reads, after phase 8, on phase 3's HIGGS
   dataset and (l)'s multiclass data (no valid set):
   - (an) (l) multiclass (PT_MC_ITERS iterations of 5 trees, its eager
     twin PT_MC_EAGER_ITERS), (o) bagging, (p) GOSS and (q) DART
     (PT_ITERS each) through ``Booster.update()``, captured (the
     default: the first tree eager, then one capture) and then eager
     (``_eager_loop``): equal model texts; s/iteration of each,
     captures and their seconds; the counted reads of every iteration
     (0, and DART's one materialize) and of one more steady update with
     its syncing CUDA calls by site (sync debug mode "warn"); one
     profiled steady (l) iteration (B1 / B2 ms per iteration, card busy
     share);
   - (ao) forced splits (FORCED_SPLITS, --iters iterations) on the
     persistent and the per-tree (bagging) learner, captured and eager:
     no counted read, every tree's first three splits the forced ones,
     equal model texts, the persistent one phase 3's (t);
   - (ap) card == CPU at phase 4's sizes over PT_CASE_ITERS iterations
     (the graph from the second tree): multiclass, multiclassova,
     bagging, pos/neg bagging, GOSS (its first sampled round), DART,
     RF, forced splits on the persistent and the bagging learner.

``--devloop-only`` runs phase 1, B1's and B2's phase-2 checks, the
HIGGS path and phase 8, and prints no result; ``--pertree-only`` runs
phase 1, B1's and B2's phase-2 checks, the HIGGS path, (l)'s data and
phase 9, and prints no result. Each phase prints its seconds.
``--multi-gpu-only`` runs phase 1 and phase 3b alone (no AUC
comparison) and prints no result; ``--robust-only`` runs phase 1 and
phase 5 alone and prints no result; ``--obs-only`` runs phase 1, (ae)
(with its own telemetry-off HIGGS run to compare with), the hang
drills with (af) and phase 3b with (ag), and prints no result;
``--pipeline-only`` runs phase 1, the HIGGS path and phase 7, and prints
no result. ``--profile`` instead profiles one
iteration of each path
(``--profile-paths b,h`` of the named ones only; (l)-(n) and (v) device
rows only; (v) also one call of its ranking gradient alone).

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no
result. It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
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


# MSLR-WEB10K Fold 1, the standard public learning-to-rank set: 136
# dense columns, 723,412 training rows in 6,000 queries (sizes 1 to
# ~1,250), graded relevance 0-4 in about these shares
RANK_COLS = 136
RANK_TRAIN_ROWS = 723_412
RANK_TRAIN_QUERIES = 6_000
RANK_HOLD_QUERIES = 1_000
RANK_MAX_QUERY = 1_250
RANK_LABEL_SHARES = (0.52, 0.32, 0.13, 0.02, 0.01)


def rank_sizes(queries, rows, rng, max_size=RANK_MAX_QUERY):
    """``queries`` query sizes summing to ``rows``: log-normal around the
    mean, from 1 (the first two queries) to ``max_size`` (the third)."""
    assert rows >= max_size + queries - 1, (rows, queries, max_size)
    mean = rows / queries
    sizes = rng.lognormal(np.log(mean) - 0.405, 0.9, queries)
    sizes = np.clip(np.round(sizes * rows / sizes.sum()), 1, max_size)
    sizes = sizes.astype(np.int64)
    sizes[:2], sizes[2] = 1, max_size
    rest = np.arange(3, queries)
    while sizes.sum() != rows:
        diff = int(rows - sizes.sum())
        pick = rng.choice(rest, size=min(abs(diff), len(rest)),
                          replace=False)
        sizes[pick] = np.clip(sizes[pick] + np.sign(diff), 1, max_size)
    return sizes


def make_rank_like(queries, rows, seed=0, cols=RANK_COLS,
                   max_size=RANK_MAX_QUERY):
    """MSLR-shaped synthetic ranking data: ``rows`` x ``cols`` float32
    columns in ``queries`` queries (``rank_sizes``), relevance labels
    0-4 in RANK_LABEL_SHARES within each query, taken from the ranks of
    a noisy score, one fixed linear function of 12 columns for every
    seed (the top 1% of a query label 4, the next 2% label 3, ...).
    Returns X, y, sizes."""
    rng = np.random.RandomState(seed)
    sizes = rank_sizes(queries, rows, rng, max_size)
    X = np.random.default_rng(seed).standard_normal((rows, cols),
                                                    dtype=np.float32)
    w = np.random.RandomState(0).randn(12).astype(np.float32)
    s = X[:, :12] @ w + rng.randn(rows).astype(np.float32) * 1.5
    qid = np.repeat(np.arange(queries), sizes)
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    order = np.lexsort((-s, qid))
    pct = (np.arange(rows) - start[qid[order]]) / sizes[qid[order]]
    cuts = np.cumsum(RANK_LABEL_SHARES[::-1])[:-1]     # 0.01, 0.03, ...
    y = np.empty(rows, np.float32)
    y[order] = 4 - np.searchsorted(cuts, pct, side="right")
    return X, y, sizes


def ndcg_np(k, y, scores, sizes):
    """Mean NDCG@k over the queries in plain numpy (gains 2^label - 1,
    discount 1 / log2(rank + 2); a query without a relevant document
    counts 1), independent of the port's metric."""
    disc = 1.0 / np.log2(np.arange(k) + 2.0)
    total, start = 0.0, 0
    for size in sizes:
        lab = y[start:start + size].astype(np.int64)
        sc = scores[start:start + size]
        start += size
        kk = min(k, size)
        ideal = np.sum((2.0 ** np.sort(lab)[::-1][:kk] - 1) * disc[:kk])
        got = np.sum((2.0 ** lab[np.argsort(-sc, kind="stable")][:kk] - 1)
                     * disc[:kk])
        total += got / ideal if ideal > 0 else 1.0
    return total / len(sizes)


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
        # the device-window entry: the window a [2] tensor on the card
        # (its count never passed as an int), the route chosen on the
        # device, every launch sized by one bound; one set of buffers for
        # all cases, as a learner holds it
        bufs = plane.PartitionBuffers(lay.num_planes, lay.num_rows, dev)
        for name, start, count, kw in cs:
            rscal = plane.route_scalars(lay, device=dev, **kw)
            win = torch.tensor([start, count], dtype=torch.int32,
                               device=dev)
            got, nl_got = plane.partition_dev_cuda(st.clone(), lay, win,
                                                   rscal, bufs)
            want, nl_want = plane.partition_plain(st.clone(), lay, win,
                                                  None, rscal)
            torch.cuda.synchronize()
            assert int(nl_got) == int(nl_want), ("dev", name, int(nl_got),
                                                 int(nl_want))
            assert torch.equal(got, want), f"B2 dev {name}: data differs"
        log(f"B2 partition, device window (bound {lay.num_rows}): "
            f"{len(cs)} cases bit-exact (P={lay.num_planes}; routes: "
            f"{names}, chosen on the device)")
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
        bufs = plane.PartitionBuffers(P, root, dev)
        for c in (root, SMALL_WINDOW):
            ms = time_ms(lambda: plane.partition_cuda(work, lay, 0, c, rscal),
                         reps=20)
            win = torch.tensor([0, c], dtype=torch.int32, device=dev)
            dev_ms = time_ms(lambda: plane.partition_dev_cuda(
                work, lay, win, rscal, bufs), reps=20)
            log(f"B2 partition {c} lanes x P={P}: device window (bound "
                f"{root}) {dev_ms:.4f} ms beside the host window's "
                f"{ms:.4f} ms")
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


def held_out_metric(booster, X, y, metric, device, group=None):
    """``metric`` (the port's own, computed on ``device``) of the
    booster's predictions on held-out rows ([N] raw scores, or [N, K]
    with K classes); a ranking metric at k (``ndcg@10``) reads the
    queries' sizes ``group``."""
    from lightgbm_tpu_torch.metric.metrics import create_metric
    gbdt = booster._gbdt
    k = gbdt.num_tree_per_iteration
    raw = booster.predict(X, raw_score=True)
    assert raw.shape == ((len(y),) if k == 1 else (len(y), k))
    assert np.isfinite(raw).all()
    m = create_metric(metric.split("@")[0], gbdt.config)

    class _Meta:
        label, weights = y, None
        query_boundaries = (None if group is None else
                            np.concatenate([[0], np.cumsum(group)]))
    m.init(_Meta, len(y))
    obj = gbdt.objective if metric != "auc" else None
    score = torch.as_tensor(raw.T if k > 1 else raw, device=device)
    rows = m.eval_device(score, obj)
    name, val = next(r for r in rows if r[0] == metric) if "@" in metric \
        else rows[0]
    return float(m.finish(val.reshape(-1).to(torch.float64).cpu().numpy(),
                          name))


# per run_path name: seconds and learner host syncs of each iteration
PATH_STATS: dict = {}


def run_path(name, params, ds, iters, X_hold, y_hold, expect,
             device="cuda", floor=0.70, metric="auc", fobj=None,
             train_kw=None, hold_group=None):
    """Train ``iters`` iterations through lightgbm_tpu_torch.train with
    every launch counter set to 0 just before and read just after; fail
    unless each kernel of ``expect`` was launched. Prints seconds and
    host syncs per iteration, launches, the per-iteration bytes bounds
    and the held-out ``metric``, which must be above ``floor`` (AUC) or
    below it (a loss); returns (launches, booster, metric value).
    ``train_kw``: more train() keywords (``init_model``: the model's own
    trees come first, and only the new ones are counted). A ranking
    ``metric`` (``ndcg@10``, above its floor) reads the held-out queries'
    sizes ``hold_group``."""
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
    # at the start of each iteration, and once after train(): the
    # pipelined loop runs an iteration's after-iteration callbacks only
    # once the next iteration is dispatched
    timer.before_iteration = True

    K.reset_launches()
    booster = lgt.train({**params, "device_type": device}, ds,
                        num_boost_round=iters, callbacks=[timer],
                        verbose_eval=False, fobj=fobj, **(train_kw or {}))
    sync()
    marks.append((time.perf_counter(), learner_syncs(booster._gbdt)))
    launches = K.launch_counts()
    gbdt = booster._gbdt
    gbdt._materialize_models()          # the pending trees: one read
    k = gbdt.num_tree_per_iteration
    trees = gbdt.models[gbdt.num_init_iteration * k:]
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
    val = held_out_metric(booster, X_hold, y_hold, metric, device,
                          hold_group)
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
    PATH_STATS[name] = dict(secs=secs, syncs=[
        marks[i][1] - marks[i - 1][1] for i in range(1, len(marks))])
    if metric == "auc" or metric.startswith("ndcg@"):
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
# (i)-(k): 4 iterations clear (i)'s l2 floor (0.8 x the label variance)
REG_ITERS = 4
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
             "multi_logloss", float(np.log(5.0)), 1),
            ("m", "(m) HIGGS-multiclassova fused", "multiclassova",
             "multi_error", 0.8, 1)]
FOBJ_ITERS = 2                     # path (n)


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
    exits. A call runs on the card where its object's ``device``, else
    its first tensor argument's, is a CUDA device. ``debug_sync``: run
    each call under CUDA sync debug mode "error", so a host read inside
    it raises."""

    def __init__(self, cls, name, debug_sync=False):
        self.cls, self.name, self.debug_sync = cls, name, debug_sync

    def __enter__(self):
        self.orig = self.cls.__dict__[self.name]
        self.marks, self.out = [], []
        orig, marks, debug_sync = self.orig, self.marks, self.debug_sync

        def timed(obj, *a, **kw):
            dev = getattr(obj, "device", None) or next(
                (x.device for x in a if isinstance(x, torch.Tensor)), None)
            cuda = torch.cuda.is_available() and dev is not None \
                and dev.type == "cuda"
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
      "learning_rate": 0.5}, False),
    ("q", "(q) HIGGS DART fused",
     {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.5}, False),
    ("r", "(r) HIGGS RF fused",
     {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
      "feature_fraction": 0.8}, False),
    ("s", "(s) wide bagging fused",
     {"bagging_fraction": 0.8, "bagging_freq": 1}, True),
]
BAG_ITERS = 3                      # paths (o)-(r)
BAG_WIDE_ITERS = 2                 # path (s)
PHASE4_ROWS = 12_000               # phase 4's first cases, (z)
PHASE4_ITERS = 2                   # phase 4: iterations of each case
PHASE4_LEAVES = 15                 # phase 4's card_vs_cpu cases: leaves
BAG_CASE_ROWS = 10_000             # phase 4's boosting-mode cases
RANK_CASE_ROWS = 30_000            # phase 4's ranking cases: rows,
RANK_CASE_QUERIES = 250            # queries, and the largest query (the
RANK_CASE_MAX_QUERY = 512          # CPU side's pair program sets the time)


# path (t): a depth-2 forced-split tree on three HIGGS columns (the root
# and both of its children), at thresholds inside the columns' ranges
FORCED_SPLITS = {"feature": 0, "threshold": 0.0,
                 "left": {"feature": 1, "threshold": 0.25},
                 "right": {"feature": 2, "threshold": -0.25}}
API_ITERS = 1                      # path (u): cv's iterations per fold
CSV_ROWS = 50_000                  # path (u): the CSV file's rows


def write_forced_splits(tmp):
    """The forced-splits file of path (t) and phase 4, in ``tmp``."""
    path = os.path.join(tmp, "forced_splits.json")
    with open(path, "w") as fh:
        json.dump(FORCED_SPLITS, fh)
    return path


def forced_path(args, ds, hX, hy, tmp, device="cuda"):
    """Path (t): the HIGGS shape on the persistent fused path with
    FORCED_SPLITS; every tree's first three splits must be the forced
    ones (B1 + B2 through the forced phase and the gain loop).
    Returns (launches, held-out AUC, the model text up to its trees'
    end)."""
    name = "(t) HIGGS forced splits fused"
    params = {**HIGGS_PARAMS,
              "forcedsplits_filename": write_forced_splits(tmp)}
    got, booster, auc = run_path(name, params, ds, args.iters, hX, hy,
                                 ("hist_planar", "partition"), device)
    gb = booster._gbdt
    assert gb._fused is not None and gb._fused_persist, name
    sched = gb._fused._forced_sched
    assert [(s[0], s[1]) for s in sched] == [(0, 0), (0, 1), (1, 2)], sched
    mappers = ds.handle.bin_mappers
    for i, t in enumerate(gb.models):
        assert list(t.split_feature[:3]) == [0, 1, 2], (name, i)
        assert (t.left_child[0], t.right_child[0]) == (1, 2), (name, i)
        for node, (_, f, b) in zip((0, 1, 2), sched):
            assert t.threshold_in_bin[node] == b, (name, i, node)
            assert t.threshold[node] == mappers[f].bin_to_value(b)
    log(f"{name}: every tree's first three splits are the forced ones "
        f"(features 0, 1, 2 at bins {[s[2] for s in sched]})")
    return got, auc, _trees_part(booster.model_to_string())


def api_path(args, X, y, hX, hy, ds, straight_auc, tmp, device="cuda"):
    """Path (u), the API surface at HIGGS width: half of ``args.iters``
    iterations, the model saved to a file and loaded again (raw
    predictions bit-equal), the other iterations from it as
    ``init_model`` (the held-out AUC must be the HIGGS path's after
    ``args.iters`` straight, ``straight_auc``, within 5e-4: continuing
    from the file is training on), one ``rollback_one_iter``, ``cv``
    over 3 stratified folds, and a Dataset from a CSV file (the csv
    module where pandas is missing) through ``save_binary`` and back.
    Returns {key: launches}."""
    import lightgbm_tpu_torch as lgt
    rows = args.rows
    first = args.iters // 2
    more = args.iters - first
    assert first >= 1, "(u) takes at least 2 iterations"
    expect = ("hist_planar", "partition")
    got = {}

    def raw_dataset():
        return lgt.Dataset(X[:rows], label=y[:rows], free_raw_data=False,
                           params={**HIGGS_PARAMS, "device_type": device})
    t0 = time.perf_counter()
    got["u1"], booster, auc_first = run_path(
        f"(u) API: {first} iterations", HIGGS_PARAMS, raw_dataset(), first,
        hX, hy, expect, device, train_kw={"keep_training_booster": True})
    model = os.path.join(tmp, "model.txt")
    t1 = time.perf_counter()
    booster.save_model(model)
    loaded = lgt.Booster(params={"device_type": device}, model_file=model)
    t2 = time.perf_counter()
    a = booster.predict(hX, raw_score=True)
    b = loaded.predict(hX, raw_score=True)
    assert np.array_equal(a, b), "(u): the loaded model predicts otherwise"
    log(f"(u) API: save_model + Booster(model_file) {t2 - t1:.2f} s "
        f"({os.path.getsize(model)} bytes); raw predictions of "
        f"{len(hX)} held-out rows bit-equal (max |diff| "
        f"{float(np.abs(a - b).max())})")
    got["u2"], cont, auc_cont = run_path(
        f"(u) API: {more} more from init_model", HIGGS_PARAMS,
        raw_dataset(), more, hX, hy, expect, device,
        train_kw={"init_model": model, "keep_training_booster": True})
    gb = cont._gbdt
    assert gb.num_init_iteration == first and len(gb.models) == \
        args.iters, (gb.num_init_iteration, len(gb.models))
    log(f"(u) API: held-out AUC {auc_cont:.6f} after {first} + {more} "
        f"iterations beside {straight_auc:.6f} after {args.iters} straight "
        f"(diff {auc_cont - straight_auc:+.6f}); {auc_first:.6f} after the "
        f"first {first}")
    assert abs(auc_cont - straight_auc) < 5e-4, \
        "(u): continued training does not match straight training"
    t3 = time.perf_counter()
    cont.rollback_one_iter()
    roll = cont.predict(hX, raw_score=True)
    assert cont.current_iteration == args.iters - 1
    assert np.isfinite(roll).all()
    log(f"(u) API: rollback_one_iter {time.perf_counter() - t3:.3f} s "
        f"(state synced and dropped); {cont.current_iteration} iterations "
        f"left")
    from lightgbm_tpu_torch.ops import cuda as K
    K.reset_launches()
    t4 = time.perf_counter()
    res = lgt.cv({**HIGGS_PARAMS, "metric": "auc", "device_type": device},
                 ds, num_boost_round=API_ITERS, nfold=3, stratified=True,
                 seed=0)
    if device == "cuda":
        torch.cuda.synchronize()
    got["u3"] = K.launch_counts()
    secs = time.perf_counter() - t4
    mean, std = res["auc-mean"], res["auc-stdv"]
    assert len(mean) == API_ITERS and 0.70 < mean[-1] <= 1.0, mean
    log(f"(u) API: cv 3 stratified folds x {API_ITERS} iterations in "
        f"{secs:.1f} s ({secs / (3 * API_ITERS):.4f} s per fold-iteration, "
        f"subsets included): AUC mean {mean[-1]:.6f}, stdv {std[-1]:.6f}; "
        f"per round {[round(m, 6) for m in mean]}")
    csv_path = os.path.join(tmp, "higgs.csv")
    # 4 decimals: the text holds the matrix's values exactly
    Xc = np.round(X[:CSV_ROWS].astype(np.float64), 4)
    t5 = time.perf_counter()
    np.savetxt(csv_path, np.column_stack([y[:CSV_ROWS], Xc]),
               delimiter=",", fmt="%.4f")
    # the csv module's route, pandas or not (a machine without pandas
    # takes it)
    saved = sys.modules.get("pandas")
    sys.modules["pandas"] = None
    t6 = time.perf_counter()
    try:
        from_csv = lgt.Dataset(csv_path, params={**HIGGS_PARAMS,
                                                 "device_type": device})
        from_csv.construct()
    finally:
        if saved is None:
            del sys.modules["pandas"]
        else:
            sys.modules["pandas"] = saved
    t7 = time.perf_counter()
    bin_path = os.path.join(tmp, "higgs.bin")
    from_csv.save_binary(bin_path)
    back = lgt.Dataset(bin_path).construct()
    t8 = time.perf_counter()
    h, hb = from_csv.handle, back.handle
    assert np.array_equal(h.bins, hb.bins)
    assert np.array_equal(h.metadata.label, hb.metadata.label)
    mat = lgt.Dataset(Xc, label=y[:CSV_ROWS],
                      params=HIGGS_PARAMS).construct().handle
    assert np.array_equal(h.bins, mat.bins), "(u): CSV bins differ"
    log(f"(u) API: {CSV_ROWS} x 28 CSV written in {t6 - t5:.2f} s, read "
        f"and binned through the csv module in {t7 - t6:.2f} s (bins equal "
        f"to the matrix's); save_binary + load {t8 - t7:.2f} s "
        f"({os.path.getsize(bin_path)} bytes, bins equal)")
    log(f"(u) API: {time.perf_counter() - t0:.1f} s in all")
    return got


# paths (v)-(x): ranking on MSLR-shaped data and the rest of the API
RANK_PARAMS = {"num_leaves": 255, "max_bin": 255, "metric": "ndcg",
               "eval_at": [1, 3, 5, 10], "verbose": -1}
# (key, name, objective, iterations)
RANK_PATHS = [("v", "(v) MSLR lambdarank fused", "lambdarank", 3),
              ("w", "(w) MSLR rank_xendcg fused", "rank_xendcg", 2)]
RANKER_QUERIES = 1_000             # path (x): LGBMRanker's training queries
CLF_ROWS = 10_000                  # path (x): LGBMClassifier, CLI CSV rows
API_REST_ITERS = 2                 # path (x): iterations of each model
CONTRIB_ROWS = 500                 # path (x): pred_contrib rows


def rank_data(device, queries=RANK_TRAIN_QUERIES, rows=RANK_TRAIN_ROWS,
              hold_queries=RANK_HOLD_QUERIES):
    """Paths (v)-(w)'s data: make_rank_like's training queries as a
    constructed Dataset with its query sizes, and held-out queries at
    the same mean size. Returns (ds, X, y, sizes, hX, hy, hsizes)."""
    import lightgbm_tpu_torch as lgt
    t0 = time.perf_counter()
    X, y, sizes = make_rank_like(queries, rows, seed=11)
    hrows = int(round(rows / queries * hold_queries))
    hX, hy, hsizes = make_rank_like(hold_queries, hrows, seed=12)
    t1 = time.perf_counter()
    ds = lgt.Dataset(X, label=y, group=sizes,
                     params={**RANK_PARAMS, "objective": "lambdarank",
                             "device_type": device})
    ds.construct()
    shares = np.bincount(y.astype(np.int64), minlength=5) / len(y)
    log(f"MSLR-shaped: {rows} x {X.shape[1]} in {queries} queries (sizes "
        f"{int(sizes.min())}-{int(sizes.max())}, mean {sizes.mean():.1f}), "
        f"made in {t1 - t0:.2f} s, binned in {time.perf_counter() - t1:.2f} "
        f"s (host); label shares {np.round(shares, 4).tolist()}; held out "
        f"{hrows} rows in {hold_queries} queries")
    return ds, X, y, sizes, hX, hy, hsizes


def rank_paths(args, data, device="cuda"):
    """Paths (v) and (w): lambdarank and rank_xendcg on MSLR-shaped data
    through the per-tree fused path (B1 + B2). Each prints its seconds
    and host syncs per iteration, B1 / B2 launches per iteration, the
    ranking gradient's time per iteration (CUDA events around
    ``get_gradients``) and held-out ndcg@1/3/5/10; the held-out ndcg@10
    must beat that of a random ordering of the same rows (numpy).
    Returns {key: launches}."""
    from lightgbm_tpu_torch.objective import rank as R
    ds, X, y, sizes, hX, hy, hsizes = data
    rng = np.random.RandomState(13)
    rand10 = ndcg_np(10, hy, rng.rand(len(hy)), hsizes)
    log(f"MSLR-shaped: held-out ndcg@10 of a random ordering {rand10:.6f} "
        f"(numpy)")
    got = {}
    for key, name, objective, iters in RANK_PATHS:
        t0 = time.perf_counter()
        with method_timer(R.RankingObjective, "get_gradients") as grads:
            got[key], booster, val = run_path(
                name, {**RANK_PARAMS, "objective": objective}, ds, iters,
                hX, hy, ("hist_planar", "partition"), device, floor=rand10,
                metric="ndcg@10", hold_group=hsizes)
        gb = booster._gbdt
        assert gb._fused is not None and not gb._fused_persist, name
        assert gb.objective.name == objective and len(grads) == iters
        obj = gb.objective
        buckets = sorted({m for m, _ in obj._chunks})
        log(f"{name}: ranking gradient {_ms(grads)} per iteration over "
            f"{obj.num_queries} queries in buckets {buckets} "
            f"({len(obj._chunks)} chunks, {len(obj._batches)} batches): "
            + ", ".join(f"{g[0]:.3f}" for g in grads))
        raw = booster.predict(hX, raw_score=True)
        ndcg = {k: held_out_metric(booster, hX, hy, f"ndcg@{k}", device,
                                   hsizes) for k in (1, 3, 5, 10)}
        np_ndcg10 = ndcg_np(10, hy, raw, hsizes)
        assert abs(np_ndcg10 - ndcg[10]) < 1e-9, (np_ndcg10, ndcg[10])
        log(f"{name}: held-out " + ", ".join(
            f"ndcg@{k} {v:.6f}" for k, v in ndcg.items())
            + f" (numpy ndcg@10 {np_ndcg10:.6f}; random ordering "
            f"{rand10:.6f}); {time.perf_counter() - t0:.1f} s in all")
    return got


def api_rest_path(args, rank, X, y, tmp, device="cuda"):
    """Path (x), the rest of the API: LGBMRanker.fit on the first
    RANKER_QUERIES queries of (v)'s data with an eval set and its
    groups, then predict; LGBMClassifier on CLF_ROWS HIGGS rows
    (predict_proba equal to Booster.predict); pred_contrib on
    CONTRIB_ROWS rows of the classifier's model (each row sums to its
    raw score within 1e-6); and the command line through subprocess:
    ``python -m lightgbm_tpu_torch task=train`` on a CLF_ROWS-row CSV,
    ``task=predict`` (equal to Booster.predict of the same model file,
    as the CLI prints it) and ``task=convert_model`` (a non-empty C++
    file). Returns {key: launches}."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda as K
    got = {}
    t0 = time.perf_counter()
    _, rX, ry, rsizes, hX, hy, hsizes = rank
    nr = int(np.sum(rsizes[:RANKER_QUERIES]))
    nh = int(np.sum(hsizes[:200]))
    K.reset_launches()
    ranker = lgt.LGBMRanker(n_estimators=API_REST_ITERS, num_leaves=255,
                            max_bin=255, eval_at=[1, 3, 5, 10],
                            device_type=device)
    ranker.fit(rX[:nr], ry[:nr], group=rsizes[:RANKER_QUERIES],
               eval_set=[(hX[:nh], hy[:nh])], eval_group=[hsizes[:200]])
    pr = ranker.predict(hX[:nh])
    if device == "cuda":
        torch.cuda.synchronize()
    got["x1"] = K.launch_counts()
    ev = ranker.evals_result_["valid_0"]
    assert np.isfinite(pr).all() and len(ev["ndcg@10"]) == API_REST_ITERS
    log(f"(x) LGBMRanker: {nr} rows in {RANKER_QUERIES} queries, "
        f"{API_REST_ITERS} iterations with an eval set of 200 queries in "
        f"{time.perf_counter() - t0:.1f} s; eval ndcg@10 per iteration "
        f"{[round(v, 6) for v in ev['ndcg@10']]}; B1 / B2 launches "
        f"{got['x1']['hist_planar']} / {got['x1']['partition']}")
    t1 = time.perf_counter()
    K.reset_launches()
    clf = lgt.LGBMClassifier(n_estimators=API_REST_ITERS, num_leaves=255,
                             max_bin=255, device_type=device)
    clf.fit(X[:CLF_ROWS], y[:CLF_ROWS])
    if device == "cuda":
        torch.cuda.synchronize()
    got["x2"] = K.launch_counts()
    proba = clf.predict_proba(X[:CLF_ROWS])
    direct = clf.booster_.predict(X[:CLF_ROWS])
    assert np.array_equal(proba[:, 1], direct), "(x): predict_proba"
    assert np.array_equal(proba[:, 0], 1.0 - direct)
    labels = clf.predict(X[:CLF_ROWS])
    log(f"(x) LGBMClassifier: {CLF_ROWS} rows, {API_REST_ITERS} iterations "
        f"in {time.perf_counter() - t1:.1f} s; predict_proba equal to "
        f"Booster.predict; accuracy {np.mean(labels == y[:CLF_ROWS]):.6f}; "
        f"B1 / B2 launches {got['x2']['hist_planar']} / "
        f"{got['x2']['partition']}")
    t2 = time.perf_counter()
    xc = X[:CONTRIB_ROWS]
    contrib = clf.booster_.predict(xc, pred_contrib=True)
    secs = time.perf_counter() - t2
    raw = clf.booster_.predict(xc, raw_score=True)
    err = float(np.abs(contrib.sum(axis=1) - raw).max())
    assert contrib.shape == (CONTRIB_ROWS, X.shape[1] + 1) and err < 1e-6
    log(f"(x) pred_contrib: {CONTRIB_ROWS} rows x {API_REST_ITERS} trees of "
        f"255 leaves in {secs:.2f} s (host recursion); rows sum to the raw "
        f"score within {err:.3g}")
    t3 = time.perf_counter()
    csv_path = os.path.join(tmp, "cli.csv")
    Xc = np.round(X[:CLF_ROWS].astype(np.float64), 4)
    np.savetxt(csv_path, np.column_stack([y[:CLF_ROWS], Xc]),
               delimiter=",", fmt="%.4f")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    model = os.path.join(tmp, "cli_model.txt")
    pred = os.path.join(tmp, "cli_pred.txt")
    cpp = os.path.join(tmp, "cli_model.cpp")
    common = [f"data={csv_path}", "label_column=0", f"device_type={device}",
              "verbosity=-1"]
    secs = {}
    for task, extra in (
            ("train", ["objective=binary", "num_leaves=255", "max_bin=255",
                       f"num_iterations={API_REST_ITERS}",
                       f"output_model={model}"]),
            ("predict", [f"input_model={model}", f"output_result={pred}"]),
            ("convert_model", [f"input_model={model}",
                               f"convert_model={cpp}"])):
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                              f"task={task}"] + common + extra, env=env,
                             cwd=tmp, capture_output=True, text=True,
                             timeout=600)
        secs[task] = time.perf_counter() - t
        assert res.returncode == 0, (task, res.stdout[-2000:],
                                     res.stderr[-2000:])
    want = lgt.Booster(params={"device_type": device},
                       model_file=model).predict(Xc)
    with open(pred) as fh:
        lines = [ln.strip() for ln in fh]
    assert lines == [f"{v:g}" for v in want], "(x): CLI predictions"
    assert os.path.getsize(cpp) > 0
    log(f"(x) CLI: train / predict / convert_model on a {CLF_ROWS}-row CSV "
        f"in " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + f" (each a process of its own); predictions equal to "
        f"Booster.predict of the model file as printed; C++ file "
        f"{os.path.getsize(cpp)} bytes; {time.perf_counter() - t3:.1f} s "
        f"with the CSV")
    log(f"(x) the rest of the API: {time.perf_counter() - t0:.1f} s in all")
    return got


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
        iters = BAG_WIDE_ITERS if is_wide else BAG_ITERS
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
    paths (i)-(k), the per-tree paths (l)-(n), the row-sampling and
    boosting-mode paths (o)-(s), forced splits (t), the API (u), ranking
    (v)-(w) and the rest of the API (x). Each kernel's ``launches`` in
    the report is the count from its own path(s)."""
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
    ] + [(key, name, {**REG_PARAMS, **extra}, rds, REG_ITERS, rX, ry,
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
        if key == "higgs":
            # phase 6 (ae) trains the same data with telemetry on
            higgs = dict(ds=ds, hX=hX, hy=hy,
                         text=obs_base_texts(booster),
                         secs=PATH_STATS[name]["secs"], auc=aucs[key])
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
        log(f"{name}: {time.perf_counter() - t_path:.1f} s in all")
    higgs["mc"] = mds               # phase 9 trains (l)'s data again
    got.update(bag_paths(args, ds, hX, hy, wide, device))
    with tempfile.TemporaryDirectory() as tmp:
        got["t"], auc_t, higgs["t_text"] = forced_path(args, ds, hX, hy,
                                                       tmp, device)
        log(f"(t) HIGGS forced splits fused: held-out AUC {auc_t:.6f} "
            f"beside HIGGS fused's {aucs['higgs']:.6f} (diff "
            f"{auc_t - aucs['higgs']:+.6f})")
        got.update(api_path(args, X, y, hX, hy, ds, aucs["higgs"], tmp,
                            device))
        rank = rank_data(device)
        got.update(rank_paths(args, rank, device))
        got.update(api_rest_path(args, rank, X, y, tmp, device))
        del rank
    api = ["t", "u1", "u2", "u3", "v", "w", "x1", "x2"]
    path_of = {"hist_planar": ["higgs", "h", "i", "j", "k", "l", "m", "o",
                               "p", "q", "r"] + api,
               "partition": ["higgs", "a", "d", "e", "h", "i", "j", "k",
                             "l", "m", "n", "o", "p", "q", "r", "s"] + api,
               "hist_radix": ["b"], "hist_multival_planar": ["a", "n", "s"],
               "hist_multival": ["c"], "hist_masked": [],
               "partition_window": [], "hist_planar_q": ["d"],
               "hist_radix_q": ["f"], "hist_masked_q": [],
               "hist_multival_planar_q": ["e"], "hist_multival_q": ["g"]}
    for r in report:
        r["launches"] = sum(got[p][r["name"]] for p in path_of[r["name"]])
    return aucs["higgs"], higgs


# ---------------------------------------------------------------------------
# phase 3b: the multi-GPU learners, one process per rank
# ---------------------------------------------------------------------------

MG_WORLD = 2                       # ranks of paths (y) and (z)
MG_CASE_ITERS = 2                  # path (z): iterations of each case
# path (z): (name, params over the binary default, data, kernels on the
# card, learner class)
MG_CASES = [
    ("fused persistent", {"tree_learner": "data"}, "bin",
     ("hist_planar", "partition"), "FusedDataParallelGrower"),
    ("fused bagging", {"tree_learner": "data", "bagging_fraction": 0.8,
                       "bagging_freq": 1}, "bin",
     ("hist_planar", "partition"), "FusedDataParallelGrower"),
    ("fused multiclass", {"tree_learner": "data", "objective": "multiclass",
                          "num_class": 5}, "mc5",
     ("hist_planar", "partition"), "FusedDataParallelGrower"),
    ("fused quantized", {"tree_learner": "data", **QUANT_PARAMS}, "bin",
     ("hist_planar_q", "partition"), "FusedDataParallelGrower"),
    ("host loop data", {"tree_learner": "data", "tpu_fused": False}, "bin",
     ("hist_radix",), "DataParallelTreeGrower"),
    ("host loop voting", {"tree_learner": "voting", "top_k": 5}, "bin",
     ("hist_radix",), "VotingParallelTreeGrower"),
    ("host loop feature", {"tree_learner": "feature"}, "bin",
     ("hist_radix",), "FeatureParallelTreeGrower"),
]


def mg_backend(device="cuda"):
    """(backend, card of rank r): NCCL for the card's tensors with gloo
    for the host's when there are MG_WORLD cards, rank r on cuda:r; on
    one card NCCL cannot hold two ranks, so gloo carries both (the CUDA
    tensors through host memory), both ranks on cuda:0."""
    if device == "cuda" and torch.cuda.device_count() >= MG_WORLD:
        return "cpu:gloo,cuda:nccl", lambda r: r
    return "gloo", lambda r: 0


def _mg_rank(rank, world, backend, store_path, out_dir, cfg):
    """One rank of phase 3b: join the group through the file store, run
    the paths and pickle their results to ``out_dir/<rank>.pkl``."""
    import pickle
    import torch.distributed as dist
    sys.path.insert(0, cfg["here"])
    if rank > 0:
        # rank 0 reports; the others' results reach the parent
        sys.stdout = open(os.devnull, "w")
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    card = rank if backend != "gloo" else 0
    if cfg["device"] == "cuda":
        torch.cuda.set_device(card)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        out = {"card": card, "y": _mg_path_y(rank, cfg),
               "z": _mg_path_z(rank, cfg)}
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _mg_path_y(rank, cfg):
    """Path (y) on one rank: the HIGGS shape at full width through
    ``tree_learner=data`` (the persistent FusedDataParallelGrower, B1 +
    B2 over the rank's rows, one reduction of the smaller child's
    histogram per split), timed per iteration by run_path."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import network
    rows, hold, iters = cfg["rows"], cfg["hold"], cfg["iters"]
    device = cfg["device"]
    X, y = make_higgs_like(rows + hold, 28, seed=0)
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:rows], label=y[:rows],
                     params={**HIGGS_PARAMS, "device_type": device})
    ds.construct()
    t_bin = time.perf_counter() - t0
    network.reset_stats()
    network.set_timing(True)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    name = f"(y) HIGGS data-parallel fused, rank {rank}"
    # (ag): each rank's own JSONL records and trace
    obs_files = {"metrics_file": os.path.join(cfg["obs_dir"],
                                              f"m{rank}.jsonl"),
                 "trace_file": os.path.join(cfg["obs_dir"], f"t{rank}.json")}
    launches, booster, auc = run_path(
        name, {**HIGGS_PARAMS, "tree_learner": "data", **obs_files}, ds,
        iters, X[rows:], y[rows:], ("hist_planar", "partition"), device)
    coll_ms = network.timed_ms()
    network.set_timing(False)
    from lightgbm_tpu_torch import obs
    recs = obs.read_jsonl(obs_files["metrics_file"])
    last = recs[-1]["counters"]
    reg_bytes = sum(v for k, v in last.items()
                    if k.startswith("collective.") and k.endswith(".bytes"))
    gb = booster._gbdt
    fl = gb._fused
    assert type(fl).__name__ == "FusedDataParallelGrower", type(fl)
    assert gb._fused_persist, name
    return dict(text=obs_text(booster.model_to_string()), auc=auc,
                records=recs, reg_bytes=reg_bytes,
                launches=launches, bin_s=t_bin, rows=fl.n_valid,
                syncs=fl.syncs, calls=network.STATS["calls"],
                bytes=network.STATS["bytes"], coll_ms=coll_ms,
                peak=(torch.cuda.max_memory_allocated()
                      if device == "cuda" else 0), iters=iters)


def _mg_path_z(rank, cfg):
    """Path (z) on one rank: every parallel learner on MG_CASE_ITERS
    iterations of cfg["case_rows"] rows, once on the card and once on
    the CPU (the plain versions) in the same group; per case and device
    the model text, predictions on 20,000 rows, the learner and the
    card's launches."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda as K
    n = cfg["case_rows"]
    X, y = make_higgs_like(n, 28, seed=3)
    _, yr = make_higgs_reg_like(n, 28, seed=3)
    data = {"bin": y, "mc5": np.digitize(
        yr, np.quantile(yr, [0.2, 0.4, 0.6, 0.8])).astype(np.float32)}
    out = {}
    for name, extra, label, _, _ in MG_CASES:
        for key, dev in (("cuda", cfg["device"]), ("cpu", "cpu")):
            K.reset_launches()
            t0 = time.perf_counter()
            b = lgt.train({"objective": "binary", "tpu_hist_dtype": "float32",
                           "verbose": -1, "device_type": dev, **extra},
                          lgt.Dataset(X, label=data[label]),
                          num_boost_round=MG_CASE_ITERS, verbose_eval=False)
            gb = b._gbdt
            learner = gb._fused if gb._fused is not None else gb.tree_learner
            out[name, key] = dict(
                text=b.model_to_string(), pred=b.predict(X[:20_000]),
                learner=type(learner).__name__, launches=K.launch_counts(),
                secs=time.perf_counter() - t0)
    return out


def fleet_check(res, traces):
    """(ag): rank 0's records carry a fleet view over every rank with
    the host skew; each rank's collective bytes in its registry equal
    ``network.STATS``; the ranks' traces merge into one process track
    per rank (trace-report --merge)."""
    import contextlib
    import io
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.obs import report as obs_report
    for r, rr in enumerate(res):
        yr = rr["y"]
        assert yr["reg_bytes"] == yr["bytes"], \
            ("(ag) collective bytes", r, yr["reg_bytes"], yr["bytes"])
        for rec in yr["records"]:
            assert "coll.host_skew" in rec["gauges"], (r, rec["gauges"])
    fl = res[0]["y"]["records"][-1]["fleet"]
    assert fl["ranks"] == MG_WORLD and len(fl["per_rank"]) == MG_WORLD, fl
    out_path = traces[0] + ".merged.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["trace-report", "--merge", *traces, "--out",
                       out_path])
    assert rc == 0, buf.getvalue()
    events = obs_report.load_trace(out_path)
    tracks = {e["pid"] for e in events
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert tracks == set(range(MG_WORLD)), tracks
    log(f"(ag) fleet over {fl['ranks']} ranks: skew {fl['skew']}, slowest "
        f"rank {fl['slowest_rank']}, iteration s per rank "
        f"{[row['iter_s'] for row in fl['per_rank']]}; collective bytes "
        f"per rank {[rr['y']['reg_bytes'] for rr in res]} equal to "
        f"network.STATS; merged trace: {len(tracks)} process tracks, "
        f"{len(events)} events")


def multi_gpu_paths(args, higgs_auc, device="cuda", hold=200_000,
                    case_rows=PHASE4_ROWS):
    """Phase 3b: paths (y) and (z) in MG_WORLD ranks spawned here (the
    library uses the group it is given; this script picks the backend).
    (y): every rank's model text is the same and the held-out AUC is
    within 2e-3 of ``higgs_auc`` (the one-card HIGGS path's after as many
    iterations; None: not checked); prints s/iteration, host syncs, the
    reductions' bytes and CUDA-event time per iteration, B1 / B2 launches
    per rank per iteration and peak memory per rank. (z): each case's
    model equal on every rank, and card == CPU as phase 4 holds them.
    Returns rank 0's launches of (y). ``device="cpu"`` rehearses both
    paths on the CPU (a gloo group, the CPU run twice), at ``hold``
    held-out rows of (y) and ``case_rows`` rows of (z)."""
    import pickle
    backend, card_of = mg_backend(device)
    cards = sorted({card_of(r) for r in range(MG_WORLD)})
    log(f"multi-GPU: backend {backend}, {MG_WORLD} ranks on "
        f"{len(cards)} card(s) {cards} of {torch.cuda.device_count()}")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dict(here=here, rows=args.rows, hold=hold, iters=args.iters,
                   case_rows=case_rows, device=device, obs_dir=tmp)
        torch.multiprocessing.spawn(
            _mg_rank, args=(MG_WORLD, backend, os.path.join(tmp, "store"),
                            tmp, cfg), nprocs=MG_WORLD, join=True)
        res = []
        for r in range(MG_WORLD):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as fh:
                res.append(pickle.load(fh))
        fleet_check(res, [os.path.join(tmp, f"t{r}.json")
                          for r in range(MG_WORLD)])
    log(f"multi-GPU: {time.perf_counter() - t0:.1f} s for paths (y) and "
        f"(z) in {MG_WORLD} ranks")
    ys = [r["y"] for r in res]
    for r, yr in enumerate(ys):
        it = yr["iters"]
        log(f"(y) rank {r} (cuda:{res[r]['card']}): {yr['rows']} rows, "
            f"binned in {yr['bin_s']:.2f} s (host); "
            f"{yr['syncs'] / it:.1f} host syncs/iteration; reductions "
            f"{yr['calls'] / it:.1f} calls, {yr['bytes'] / it:.0f} "
            f"bytes and {yr['coll_ms'] / it:.3f} ms (CUDA events) per "
            f"iteration; B1 {yr['launches']['hist_planar'] / it:.1f}, "
            f"B2 {yr['launches']['partition'] / it:.1f} launches per "
            f"iteration; peak memory {yr['peak'] / 2 ** 20:.1f} MiB")
        assert yr["text"] == ys[0]["text"], f"(y) rank {r}'s model differs"
        assert yr["auc"] == ys[0]["auc"], (r, yr["auc"], ys[0]["auc"])
    if higgs_auc is not None:
        log(f"(y) held-out AUC {ys[0]['auc']:.6f} beside the one-card "
            f"HIGGS path's {higgs_auc:.6f} (diff "
            f"{ys[0]['auc'] - higgs_auc:+.6f}); models equal on "
            f"{MG_WORLD} ranks")
        assert abs(ys[0]["auc"] - higgs_auc) <= 2e-3, \
            ("(y) AUC", ys[0]["auc"], higgs_auc)
    zs = [r["z"] for r in res]
    for name, _, _, expect, learner in MG_CASES:
        g, c = zs[0][name, "cuda"], zs[0][name, "cpu"]
        for z in zs[1:]:
            for dev in ("cuda", "cpu"):
                assert z[name, dev]["text"] == zs[0][name, dev]["text"], \
                    f"(z) {name} on {dev}: the ranks' models differ"
        assert g["learner"] == c["learner"] == learner, (name, g, c)
        if device == "cuda":
            for k in expect:
                assert g["launches"][k] > 0, \
                    f"(z) {name}: {k} not launched"
        tg = _card_trees(g["text"])
        tc = _card_trees(c["text"])
        assert len(tg) == len(tc)
        for a, b in zip(tg, tc):
            k = a.num_leaves
            assert k == b.num_leaves, (name, k, b.num_leaves)
            for f in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
                assert np.array_equal(getattr(a, f)[:k - 1],
                                      getattr(b, f)[:k - 1]), (name, f)
            np.testing.assert_allclose(a.leaf_value[:k],
                                       b.leaf_value[:k], rtol=0,
                                       atol=1e-6)
        np.testing.assert_allclose(g["pred"], c["pred"], rtol=0,
                                   atol=1e-6)
        log(f"(z) {name} ({learner}): {cfg['case_rows']} rows, "
            f"{MG_CASE_ITERS} iterations on {MG_WORLD} ranks: models "
            f"equal on every rank; card == CPU: trees equal "
            f"({[t.num_leaves for t in tg]} leaves), tree blocks of "
            f"the model text "
            f"{'identical' if _tree_text(g) == _tree_text(c) else 'differ'}"
            f", "
            f"predictions max |diff| "
            f"{float(np.abs(g['pred'] - c['pred']).max()):.3g}; "
            f"{g['secs']:.1f} s on the card, {c['secs']:.1f} s on the "
            f"CPU; card launches "
            + json.dumps({k: g["launches"][k] for k in expect}))
    return ys[0]["launches"]


def _tree_text(run):
    """The Tree= blocks of a run's model text (its parameter echo names
    the device)."""
    t = run["text"]
    return t[t.index("Tree=0"):t.index("end of trees")]


def _card_trees(text):
    """The host Trees of a model text."""
    from lightgbm_tpu_torch.boosting.gbdt import parse_tree_blocks
    return parse_tree_blocks(text)


# ---------------------------------------------------------------------------
# phase 4: card run against the port's own CPU run
# ---------------------------------------------------------------------------

def card_vs_cpu(forced_file):
    """Phase 4: the same small training on the card and on the CPU (the
    plain versions), on both learners, float and quantized, on path
    (h)'s columns with categorical features, and with the regression,
    quantile and MAPE objectives (the percentile refits), the per-tree
    and boosting-mode cases, forced splits (``forced_file``), ranking
    and C12's quantized tweedie and weighted regression: trees (bitset
    pools included), leaf values and predictions, these with prediction
    early stop off and on for the categorical model."""
    import lightgbm_tpu_torch as lgt
    n = PHASE4_ROWS
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
    # forced splits: the persistent path, grow_device under bagging, the
    # host loop and quantized gradients
    forced = {"forcedsplits_filename": forced_file}
    for name, obj in (("fused forced splits", forced),
                      ("fused forced splits bagging", {**forced, **bag}),
                      ("host loop forced splits",
                       {**forced, "tpu_fused": False}),
                      ("fused forced splits quantized",
                       {**forced, **QUANT_PARAMS})):
        cases.append((name, obj, (X[:m], y[:m])))
        exact.add(name)
    # ranking on both learners (quantized gradients send it to the host
    # loop), on RANK_CASE_ROWS MSLR-shaped rows in RANK_CASE_QUERIES
    # queries, and C12's inputs: quantized tweedie and quantized
    # weighted regression on the fused learner
    rX, ry, rsizes = make_rank_like(RANK_CASE_QUERIES, RANK_CASE_ROWS,
                                    seed=14, max_size=RANK_CASE_MAX_QUERY)
    ranked = (rX, ry, {"group": rsizes})
    for name in ("lambdarank", "rank_xendcg"):
        cases += [(f"fused {name}", {"objective": name}, ranked),
                  (f"host loop {name}", {"objective": name,
                                         "tpu_fused": False}, ranked)]
        exact |= {f"fused {name}", f"host loop {name}"}
    cases.append(("host loop lambdarank quantized",
                  {"objective": "lambdarank", **QUANT_PARAMS}, ranked))
    rng = np.random.RandomState(15)
    y_tw = (np.exp(0.3 * yr[:m]) * (rng.rand(m) < 0.7)).astype(np.float32)
    cases += [("fused tweedie quantized",
               {"objective": "tweedie", "tweedie_variance_power": 1.3,
                **QUANT_PARAMS}, (Xr[:m], y_tw)),
              ("fused weighted regression quantized",
               {"objective": "regression", **QUANT_PARAMS},
               (Xr[:m], yr[:m], {"weight": rng.rand(m) + 0.5}))]
    exact |= {"host loop lambdarank quantized", "fused tweedie quantized",
              "fused weighted regression quantized"}
    for learner, extra, data in cases:
        out = {}
        xs, ys, ds_kw = (data + ({},))[:3]
        extra = dict(extra)
        fobj = extra.pop("fobj", None)
        for dev in ("cuda", "cpu"):
            params = {"objective": "binary", "tpu_hist_dtype": "float32",
                      "verbose": -1, "num_leaves": PHASE4_LEAVES,
                      "device_type": dev, **extra}
            b = lgt.train(params, lgt.Dataset(xs, label=ys, **ds_kw),
                          num_boost_round=PHASE4_ITERS, verbose_eval=False,
                          fobj=fobj)
            preds = [b.predict(xs[:20_000])]
            if "categorical_feature" in extra:
                cfg = b._gbdt.config
                cfg.pred_early_stop, cfg.pred_early_stop_freq = True, 1
                cfg.pred_early_stop_margin = 1.0
                preds.append(b.predict(xs[:20_000], raw_score=True))
                cfg.pred_early_stop = False
            out[dev] = (b._gbdt.models, preds)
            if "forcedsplits_filename" in extra:
                assert all(list(t.split_feature[:3]) == [0, 1, 2]
                           for t in b._gbdt.models), learner
        (tg, pg), (tc, pc) = out["cuda"], out["cpu"]
        per_iter = b._gbdt.num_tree_per_iteration
        if learner.startswith("host loop"):
            assert b._gbdt._fused is None, learner
        else:
            assert b._gbdt._fused is not None, learner
        assert len(tg) == len(tc) == PHASE4_ITERS * per_iter
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
        log(f"card vs CPU ({learner}): {len(ys)} rows, {PHASE4_ITERS} "
            f"iterations of "
            f"{per_iter} trees: trees "
            f"equal ({[t.num_leaves for t in tg]} leaves, {ncat} "
            f"categorical splits), leaf values max |diff| {leaf_diff:.3g}, "
            f"predictions max |diff| "
            + ", ".join(f"{float(np.abs(a - b).max()):.3g}"
                        for a, b in zip(pg, pc))
            + (" (early stop off, on)" if len(pg) > 1 else ""))


def api_card_vs_cpu(tmp):
    """Phase 4's API cases on BAG_CASE_ROWS rows, card against CPU:
    continued training from a saved model (``init_model``),
    ``rollback_one_iter`` then one more iteration, and ``refit`` on
    other rows; trees (split gains, leaf values) and raw predictions
    must be equal, max |diff| 0."""
    import lightgbm_tpu_torch as lgt
    m = BAG_CASE_ROWS
    X, y = make_higgs_like(2 * m, 28, seed=8)
    Xa, ya, Xb, yb = X[:m], y[:m], X[m:], y[m:]
    base = {"objective": "binary", "tpu_hist_dtype": "float32",
            "verbose": -1}

    def init_model(dev):
        params = {**base, "device_type": dev}
        first = lgt.train(params, lgt.Dataset(Xa, label=ya),
                          num_boost_round=2)
        path = os.path.join(tmp, f"first_{dev}.txt")
        first.save_model(path)
        return lgt.train(params, lgt.Dataset(Xa, label=ya,
                                             free_raw_data=False),
                         num_boost_round=2, init_model=path)

    def rollback(dev):
        b = lgt.train({**base, "device_type": dev},
                      lgt.Dataset(Xa, label=ya), num_boost_round=3,
                      keep_training_booster=True)
        b.rollback_one_iter()
        b.update()
        return b

    def refit(dev):
        b = lgt.train({**base, "device_type": dev},
                      lgt.Dataset(Xa, label=ya), num_boost_round=3)
        return b.refit(Xb, yb, decay_rate=0.5)

    for name, fn in (("init_model", init_model), ("rollback_one_iter",
                                                  rollback),
                     ("refit", refit)):
        got = {dev: fn(dev) for dev in ("cuda", "cpu")}
        tg, tc = got["cuda"]._gbdt.models, got["cpu"]._gbdt.models
        assert len(tg) == len(tc), name
        for a, b in zip(tg, tc):
            k = a.num_leaves
            assert k == b.num_leaves, name
            for f in ("split_feature", "threshold", "left_child",
                      "right_child", "split_gain", "leaf_value"):
                n = k if f.startswith("leaf") else k - 1
                assert np.array_equal(getattr(a, f)[:n],
                                      getattr(b, f)[:n]), (name, f)
        pg = got["cuda"].predict(Xb, raw_score=True)
        pc = got["cpu"].predict(Xb, raw_score=True)
        assert np.array_equal(pg, pc), name
        leaf_diff = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                        for a, b in zip(tg, tc))
        log(f"card vs CPU ({name}): {m} rows, {len(tg)} trees equal "
            f"({[t.num_leaves for t in tg]} leaves), leaf values max "
            f"|diff| {leaf_diff:.3g}, raw predictions max |diff| "
            f"{float(np.abs(pg - pc).max()):.3g}")


# ---------------------------------------------------------------------------
# phase 5: robustness — checkpoint and resume, fault injection, the hang
# watchdog and the numeric sentinels
# ---------------------------------------------------------------------------

CHAOS_ITERS = 4                    # (aa): iterations of each training
CHAOS_KILL = 3                     # (aa): the child dies entering this one
ROBUST_ROWS = 50_000               # (ab)-(ad): training rows
# (ab)-(ad): 63 leaves keep an iteration well inside (ad)'s 1.2 s
# hang_timeout (the JAX tests' margins) on a 100,000-row state
ROBUST_PARAMS = {**HIGGS_PARAMS, "num_leaves": 63}
ROBUST_ITERS = 2                   # (ab): iterations (half, then all)
SENTINEL_ITERS = 4                 # (ac): iterations of each drill
SENTINEL_SYNC_ITERS = 3            # (ac): HIGGS iterations, sentinels on/off
HANG_ITERS = 5                     # (ad): iterations of each run

# the child of (aa): imports only the port, trains from the saved rows,
# and prints the resume's load and restore times (ms) as JSON
_CHAOS_CHILD = """
import json, sys, time
import numpy as np
import torch
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import engine
x_path, y_path, ckpt_dir, params, iters, out = sys.argv[1:7]
params = json.loads(params)
times = {}

def timed(name, fn):
    def run(*a, **kw):
        if params["device_type"] == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        if params["device_type"] == "cuda":
            torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return res
    return run

load = engine.CheckpointManager.load_latest
engine.CheckpointManager.load_latest = (
    lambda self: timed("load_ms", load)(self))
engine._checkpoint_restore = timed("restore_ms", engine._checkpoint_restore)
bst = lgt.train(params, lgt.Dataset(np.load(x_path), label=np.load(y_path)),
                num_boost_round=int(iters), verbose_eval=False,
                checkpoint_dir=ckpt_dir)
assert "jax" not in sys.modules and "lightgbm_tpu" not in sys.modules
with open(out, "w") as fh:
    fh.write(bst.model_to_string())
print(json.dumps(times))
"""


def _timed_calls(cls, name, out, sync):
    """Wrap ``cls.name`` so each call appends its wall ms to ``out``
    (the stream synchronized before and after); returns the original."""
    orig = getattr(cls, name)

    def run(*a, **kw):
        sync()
        t0 = time.perf_counter()
        res = orig(*a, **kw)
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
        return res
    setattr(cls, name, run)
    return orig


def syncs_per_iteration(train, device="cuda", sites=None):
    """Per iteration of ``train(callback)``: (the learner's blocking host
    reads, the syncing CUDA calls). The calls are counted under CUDA
    sync debug mode "warn", where every call that waits for the card (a
    device-to-host copy, ``.item()``, ...) warns; ``callback`` marks the
    start of each iteration (a before-iteration callback), and the
    booster ``train`` returns the end of the last. An iteration holds
    the trailing read of the one before it under the pipelined loop.
    ``sites``: a list that gets, per iteration, the syncing calls by
    Python site."""
    import warnings
    marks = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def calls():
            return sum("synchroniz" in str(w.message).lower()
                       for w in caught)

        def mark(env):
            gb = env.model._gbdt
            marks.append((calls(), (gb._fused or gb.tree_learner).syncs))
        mark.before_iteration = True
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            booster = train(mark)
            mark(types.SimpleNamespace(model=booster))
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    if sites is not None:
        here = os.path.dirname(os.path.abspath(__file__))
        sync = [w for w in caught if "synchroniz" in str(w.message).lower()]
        for a, b in zip(marks, marks[1:]):
            got: dict = {}
            for w in sync[a[0]:b[0]]:
                key = f"{os.path.relpath(w.filename, here)}:{w.lineno}"
                got[key] = got.get(key, 0) + 1
            sites.append(got)
    return [(b[1] - a[1], b[0] - a[0]) for a, b in zip(marks, marks[1:])]


def chaos_resume(args, tmp, device="cuda"):
    """(aa): the HIGGS path's data and params on the persistent fused
    learner, checkpointed every 2 iterations: a child process importing
    only the port is killed by SIGKILL entering iteration CHAOS_KILL, a
    second child resumes from the newest checkpoint and finishes
    CHAOS_ITERS iterations; its model text must equal an uninterrupted
    run's in this process byte for byte. Returns the launches of the
    uninterrupted run."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import engine
    from lightgbm_tpu_torch.ops import cuda as K
    from lightgbm_tpu_torch.robust.checkpoint import CheckpointManager
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    X, y = make_higgs_like(args.rows, 28, seed=0)
    x_path, y_path = os.path.join(tmp, "X.npy"), os.path.join(tmp, "y.npy")
    np.save(x_path, X)
    np.save(y_path, y)
    params = {**HIGGS_PARAMS, "checkpoint_interval": 2,
              "device_type": device}
    saves, captures, marks = [], [], []

    def timer(env):
        sync()
        marks.append(time.perf_counter())
    # at the start of each iteration, and once after train()
    timer.before_iteration = True
    orig_save = _timed_calls(CheckpointManager, "save", saves, sync)
    orig_capture = _timed_calls(engine, "_checkpoint_capture", captures,
                                sync)
    ds = lgt.Dataset(X, label=y)
    K.reset_launches()
    try:
        straight = lgt.train(dict(params), ds, num_boost_round=CHAOS_ITERS,
                             verbose_eval=False, callbacks=[timer],
                             checkpoint_dir=os.path.join(tmp, "ck_straight"))
    finally:
        sync()
        marks.append(time.perf_counter())
        launches = K.launch_counts()
        CheckpointManager.save = orig_save
        engine._checkpoint_capture = orig_capture
    for key in ("hist_planar", "partition"):
        assert device != "cuda" or launches[key] > 0, f"(aa): {key}"
    assert straight._gbdt._fused_persist, "(aa): not the persistent path"
    secs = np.diff(marks)
    here = os.path.dirname(os.path.abspath(__file__))
    ck = os.path.join(tmp, "ck_chaos")
    out = os.path.join(tmp, "chaos_model.txt")
    env = dict(os.environ, PYTHONPATH=here,
               LGBM_TPU_FAULT_PLAN=f"train.iteration:sigkill@{CHAOS_KILL}")
    argv = [sys.executable, "-c", _CHAOS_CHILD, x_path, y_path, ck,
            json.dumps(params), str(CHAOS_ITERS), out]
    t0 = time.perf_counter()
    killed = subprocess.run(argv, env=env, cwd=here, capture_output=True,
                            text=True, timeout=600)
    t_killed = time.perf_counter() - t0
    # SIGKILL is the drill, not a failure of the smoke
    assert killed.returncode == -9, (killed.returncode, killed.stderr[-2000:])
    assert not os.path.exists(out)
    names = sorted(os.listdir(ck))
    # a checkpoint after every second iteration before the kill
    assert names == [f"ckpt_{i:07d}.lgbckpt"
                     for i in range(1, CHAOS_KILL, 2)], names
    size = os.path.getsize(os.path.join(ck, names[-1]))
    env.pop("LGBM_TPU_FAULT_PLAN")
    t0 = time.perf_counter()
    resumed = subprocess.run(argv, env=env, cwd=here, capture_output=True,
                             text=True, timeout=600)
    t_resumed = time.perf_counter() - t0
    assert resumed.returncode == 0, resumed.stderr[-4000:]
    times = json.loads(resumed.stdout.strip().splitlines()[-1])
    with open(out) as fh:
        text = fh.read()
    assert "restore_ms" in times, "(aa): the second child did not resume"
    assert text == straight.model_to_string(), \
        "(aa): the resumed model text differs from the uninterrupted run's"
    log(f"(aa) chaos resume: {args.rows} x 28, {CHAOS_ITERS} iterations, "
        f"checkpoint every 2; child 1 killed by SIGKILL entering iteration "
        f"{CHAOS_KILL} after {t_killed:.1f} s (return code "
        f"{killed.returncode}), child 2 resumed from {names[-1]} and "
        f"finished in {t_resumed:.1f} s: model text byte-equal to the "
        f"uninterrupted run ({len(text)} bytes, {len(straight._gbdt.models)} "
        f"trees)")
    log(f"(aa) checkpoint {size} bytes; save "
        + ", ".join(f"{s:.1f}" for s in saves) + " ms (wall clock around "
        f"save; the capture before it " + ", ".join(f"{c:.1f}"
                                                   for c in captures)
        + f" ms); resume: load {times['load_ms']:.1f} ms, restore "
        f"{times['restore_ms']:.1f} ms; iteration {np.mean(secs):.4f} s "
        f"(" + ", ".join(f"{s:.3f}" for s in secs) + ")")
    return launches


def _robust_data(n, hold):
    """(ab)-(ad)'s rows: the HIGGS shape (binary label) and its
    regression label's terciles (3 classes), plus held-out rows."""
    X, y = make_higgs_like(n + hold, 28, seed=3)
    _, yr = make_higgs_reg_like(n + hold, 28, seed=3)
    y3 = np.digitize(yr, np.quantile(yr, [1 / 3, 2 / 3])).astype(np.float32)
    return X, y, y3


def resume_cases(tmp, device="cuda", rows=ROBUST_ROWS):
    """(ab): per case, ROBUST_ITERS // 2 iterations into a checkpoint
    directory, then ROBUST_ITERS in a second train() call: the model text
    must equal the uninterrupted run's byte for byte. Returns each
    case's launches (both calls)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda as K
    hold = 20_000
    X, y, y3 = _robust_data(rows, hold)
    Xt, yt, y3t = X[:rows], y[:rows], y3[:rows]
    bag = {"bagging_fraction": 0.7, "bagging_freq": 1}
    cases = [
        ("host loop", {"tpu_fused": False}, yt, ("hist_radix",)),
        ("quantized", QUANT_PARAMS, yt, ("hist_planar_q", "partition")),
        ("bagging + feature_fraction", {**bag, "feature_fraction": 0.8},
         yt, ("hist_planar", "partition")),
        # learning_rate 1: GOSS samples from iteration 1 on
        ("GOSS", {"boosting": "goss", "learning_rate": 1.0}, yt,
         ("hist_planar", "partition")),
        ("DART", {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
         yt, ("hist_planar", "partition")),
        ("multiclass", {"objective": "multiclass", "num_class": 3}, y3t,
         ("hist_planar", "partition")),
        ("early stopping", {"metric": "binary_logloss",
                            "early_stopping_round": 2}, yt,
         ("hist_planar", "partition")),
    ]
    # one Dataset per label set, binned once and reused by every training
    data = {id(yt): lgt.Dataset(Xt, label=yt),
            id(y3t): lgt.Dataset(Xt, label=y3t)}
    valid_set = data[id(yt)].create_valid(X[rows:], label=y[rows:])
    got = {}
    for i, (name, extra, labels, expect) in enumerate(cases):
        d = os.path.join(tmp, f"ck_ab{i}")
        params = {**ROBUST_PARAMS, **extra, "checkpoint_interval": 1,
                  "device_type": device}
        valid = "early_stopping_round" in extra

        def run(rounds, ckpt_dir):
            kw = ({"valid_sets": [valid_set], "evals_result": {}}
                  if valid else {})
            return lgt.train(dict(params), data[id(labels)],
                             num_boost_round=rounds, verbose_eval=False,
                             checkpoint_dir=ckpt_dir, **kw), kw
        t0 = time.perf_counter()
        K.reset_launches()
        run(ROBUST_ITERS // 2, d)
        resumed, kw_r = run(ROBUST_ITERS, d)
        got[name] = K.launch_counts()
        straight, kw_s = run(ROBUST_ITERS, None)
        assert resumed.model_to_string() == straight.model_to_string(), \
            f"(ab) {name}: the resumed model differs"
        if valid:
            assert kw_r["evals_result"] == kw_s["evals_result"], name
        for key in expect:
            assert device != "cuda" or got[name][key] > 0, (name, key)
        log(f"(ab) resume {name}: {rows} rows, {ROBUST_ITERS // 2} then "
            f"{ROBUST_ITERS} iterations: byte-equal to the uninterrupted "
            f"run ({resumed.num_trees()} trees; "
            + ", ".join(f"{k} {got[name][k]}" for k in expect)
            + f" launches; {time.perf_counter() - t0:.1f} s)")
    return got


def sentinel_drills(args, device="cuda", rows=ROBUST_ROWS):
    """(ac): numeric_sentinels on ``rows`` rows under a NaN fault plan —
    the host loop's gradient plane (train.iteration:nan@3) and the
    fused learner's leaf check (sentinel.check:nan@3): one tree fewer
    than the clean run, finite predictions, and the card's model text
    equal to the CPU's (float32 histogram inputs, as phase 4). Then the
    HIGGS path, SENTINEL_SYNC_ITERS iterations with sentinels on and
    off: the learner's host syncs and the syncing CUDA calls per
    iteration must be equal, but for one more call at train()'s end with
    them (the drain of the verdicts). Returns the launches of the
    drills."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda as K
    from lightgbm_tpu_torch.robust import install_plan
    X, y, _ = _robust_data(rows, 0)
    got = {}
    for key, name, extra, plan, expect in (
            ("ac1", "host loop NaN gradient", {"tpu_fused": False},
             "train.iteration:nan@3", ("hist_radix",)),
            ("ac2", "fused leaf sentinel", {}, "sentinel.check:nan@3",
             ("hist_planar", "partition"))):
        texts = {}
        for dev, fault in ((device, plan), (device, None), ("cpu", plan)):
            params = {**ROBUST_PARAMS, **extra, "numeric_sentinels": True,
                      "tpu_hist_dtype": "float32", "device_type": dev}
            install_plan(fault)
            if dev == device and fault:
                K.reset_launches()
            try:
                b = lgt.train(params, lgt.Dataset(X, label=y),
                              num_boost_round=SENTINEL_ITERS,
                              verbose_eval=False)
            finally:
                install_plan(None)
            if dev == device and fault:
                got[key] = K.launch_counts()
                p = b.predict(X[:20_000])
                assert np.isfinite(p).all(), name
            texts[(dev, fault)] = (b.model_to_string(), b.num_trees())
        (card, n_card), (clean, n_clean) = (texts[(device, plan)],
                                            texts[(device, None)])
        cpu, n_cpu = texts[("cpu", plan)]
        assert n_card == n_clean - 1 == n_cpu, (name, n_card, n_clean, n_cpu)
        assert _tree_text({"text": card}) == _tree_text({"text": cpu}), \
            f"(ac) {name}: card and CPU model texts differ"
        for k in expect:
            assert device != "cuda" or got[key][k] > 0, (name, k)
        log(f"(ac) {name} ({plan}): {rows} rows, {SENTINEL_ITERS} "
            f"iterations: {n_card} trees against the clean run's {n_clean},"
            f" predictions finite, model text card == CPU")
    hX, hy = make_higgs_like(args.rows, 28, seed=0)
    ds = lgt.Dataset(hX, label=hy)
    ds.construct()
    per_iter = {}
    for on in (False, True):
        per_iter[on] = syncs_per_iteration(lambda mark: lgt.train(
            {**HIGGS_PARAMS, "numeric_sentinels": on, "device_type": device},
            ds, num_boost_round=SENTINEL_SYNC_ITERS, verbose_eval=False,
            callbacks=[mark]), device)
    log(f"(ac) HIGGS {args.rows} x 28, {SENTINEL_SYNC_ITERS} iterations "
        f"(learner host syncs, syncing CUDA calls) per iteration: with "
        f"sentinels {per_iter[True]}, without {per_iter[False]} (the first "
        f"iteration's calls include one-time set-up; the last holds the end "
        f"of train(), where the pending verdicts are drained)")
    # the learner's reads in every iteration, every call of the steady
    # iterations; the trees' verdicts wait on the card for a read to
    # ride, and without a valid set the first is train()'s final drain:
    # one read per training, not per iteration
    assert [r[0] for r in per_iter[True]] == \
        [r[0] for r in per_iter[False]], per_iter
    assert per_iter[True][1:-1] == per_iter[False][1:-1], per_iter
    assert per_iter[True][-1][1] - per_iter[False][-1][1] in (0, 1), \
        per_iter
    return got


def hang_drills(tmp, device="cuda", rows=ROBUST_ROWS):
    """(ad): train.iteration:hang=3.0@4 against hang_timeout=1.2 (the
    JAX tests' margins) on ``rows`` rows: without auto_resume it must
    raise HangTimeout (the one exception this smoke catches); with
    auto_resume and a checkpoint directory the model text must equal
    the clean run's byte for byte. Returns the launches of the healed
    run."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda as K
    from lightgbm_tpu_torch.robust import HangTimeout, install_plan
    X, y, _ = _robust_data(rows, 0)
    params = {**ROBUST_PARAMS, "checkpoint_interval": 2, "hang_timeout": 1.2,
              "device_type": device}
    plan = "train.iteration:hang=3.0@4"

    def run(extra, ckpt_dir=None, fault=None):
        install_plan(fault)
        try:
            return lgt.train({**params, **extra}, lgt.Dataset(X, label=y),
                             num_boost_round=HANG_ITERS, verbose_eval=False,
                             checkpoint_dir=ckpt_dir)
        finally:
            install_plan(None)
    t0 = time.perf_counter()
    raised = None
    # (af): the raising run also records a trace and arms the flight
    # recorder
    flight_dir = os.path.join(tmp, "flight_ad")
    try:
        run({"flight_dir": flight_dir,
             "trace_file": os.path.join(tmp, "t_ad.json")}, fault=plan)
    except HangTimeout as e:
        raised = e.diagnosis
    assert raised is not None, "(ad): the hang raised no HangTimeout"
    t_raise = time.perf_counter() - t0
    flight_check(flight_dir, raised)
    t0 = time.perf_counter()
    K.reset_launches()
    healed = run({"auto_resume": True}, os.path.join(tmp, "ck_ad"), plan)
    launches = K.launch_counts()
    t_heal = time.perf_counter() - t0
    clean = run({})
    assert healed.model_to_string() == clean.model_to_string(), \
        "(ad): the auto-resumed model differs from the clean run's"
    log(f"(ad) hang drill ({plan}, hang_timeout 1.2 s): raised HangTimeout "
        f"after {t_raise:.1f} s, stall_class {raised['stall_class']!r}, "
        f"phase {raised['phase']!r}, iteration {raised['iteration']}; with "
        f"auto_resume: byte-equal to the clean run ({healed.num_trees()} "
        f"trees, {t_heal:.1f} s)")
    return launches


def robust_paths(args, report, device="cuda"):
    """Phase 5: (aa) the chaos resume at full width, (ab) resume in
    process, (ac) the sentinel drills and their syncs, (ad) the hang
    drills. Adds each kernel's launches on these paths to ``report``."""
    t0 = time.perf_counter()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        got["aa"] = chaos_resume(args, tmp, device)
        got.update(resume_cases(tmp, device))
        got.update(sentinel_drills(args, device))
        got["ad"] = hang_drills(tmp, device)
    for r in report:
        r["launches"] += sum(g.get(r["name"], 0) for g in got.values())
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 6: observability — the telemetry of lightgbm_tpu_torch/obs/
# ---------------------------------------------------------------------------

# the config keys of telemetry: the model text echoes them in its
# parameter block, the one place a telemetry run's text may differ
OBS_KEYS = ("metrics_file", "trace_file", "profile_dir", "obs_port",
            "flight_dir", "metrics_interval", "flight_slo_factor")
# the learner dispatchers' spans (treelearner/fused.py) -> core phase
OBS_PHASE_OF = {"fused/leaf_histogram": "hist", "fused/split_scan": "split",
                "fused/split steps (graph replays)": "split",
                "fused/partition": "partition"}
OBS_COVERAGE_MIN = 0.95    # tests/test_trace.py's gate in the JAX package
# (ae): alternating off / on pairs that measure telemetry's own cost, and
# the iterations of the profiled run (its close costs ~12 s and its trace
# ~210 MiB per HIGGS iteration, so phase 6 keeps within 90 s)
OBS_PAIRS = 2
OBS_PROFILED_ITERS = 1


def obs_text(text):
    """A model text without the parameter lines of the telemetry keys."""
    return "\n".join(ln for ln in text.splitlines()
                     if not any(ln.startswith(f"[{k}:") for k in OBS_KEYS))


def free_port():
    """A free TCP port on 127.0.0.1 (the endpoint binds it next)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def fetch(port, route):
    """(HTTP status, body) of one route of the live endpoint."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def kernel_split(path):
    """The card's kernel time by core phase, from a torch.profiler
    Chrome trace: each kernel goes to the phase of the learner span
    (OBS_PHASE_OF) around its launch, through the launch's correlation
    id, else to "other". Returns ({phase: ms}, {kernel name: launches},
    busy ms)."""
    import bisect
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    OBS_PHASE_OF[e["name"]]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in OBS_PHASE_OF)
    starts = [sp[0] for sp in spans]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in (e.get("args") or {})}
    ms = {"hist": 0.0, "split": 0.0, "partition": 0.0, "other": 0.0}
    names: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        dur = float(e.get("dur", 0)) / 1e3
        m = re.search(r"([A-Za-z_]\w*)\s*[<(]", e["name"])
        short = m.group(1) if m else e["name"]
        names[short] = names.get(short, 0) + 1
        ts = launch_ts.get((e.get("args") or {}).get("correlation"))
        phase = "other"
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                phase = spans[i][2]
        ms[phase] += dur
    return ms, names, sum(ms.values())


def implicit_sync_sites(train, device="cuda"):
    """Run ``train()`` under CUDA sync debug mode "warn" and count the
    syncing CUDA calls by the innermost lightgbm_tpu_torch/ frame of
    the Python stack that made them (a measurement of this script; the
    package has no such feature)."""
    import collections
    import traceback
    import warnings
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(here, "lightgbm_tpu_torch") + os.sep
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message).lower():
            return
        for fr in reversed(traceback.extract_stack()):
            if os.path.abspath(fr.filename).startswith(pkg):
                sites[f"{os.path.relpath(fr.filename, here)}:{fr.lineno}"
                      f" ({fr.name})"] += 1
                return
        sites[f"(outside the package) {filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            train()
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    return sites


def check_records(tag, recs, iters):
    """One valid record per iteration, its four phase fields summing to
    t_iter_s."""
    from lightgbm_tpu_torch import obs
    assert [r["iteration"] for r in recs] == list(range(iters)), (tag, recs)
    for r in recs:
        problems = obs.validate_record(r)
        assert not problems, (tag, "record", r["iteration"], problems)
        total = (r["t_hist_s"] + r["t_split_s"] + r["t_partition_s"]
                 + r["t_other_s"])
        assert abs(total - r["t_iter_s"]) <= 1e-5, (tag, total, r)


def check_coverage(tag, events, checked):
    """Phase coverage of the iterations ``checked`` at least
    OBS_COVERAGE_MIN; returns the coverage of every iteration."""
    from lightgbm_tpu_torch.obs import report as obs_report
    cov = obs_report.iteration_coverage(events)
    assert min(cov[i] for i in checked) >= OBS_COVERAGE_MIN, \
        (tag, "coverage", cov)
    return cov


def obs_base_texts(booster):
    """{depth: model text} of phase 3's HIGGS booster at the depths of
    (ae)'s runs (its pairs and its profiled run) and of (ah)'s, as far
    as it was trained."""
    have = booster.current_iteration
    return {n: booster.model_to_string(num_iteration=n)
            for n in {2, OBS_PROFILED_ITERS, PIPE_ITERS} if n <= have}


def telemetry_unit_us(device, tmp, n=20_000):
    """Host us of one phase span and of one counted read (``device_get``
    of one float), first without telemetry, then inside a session with
    metrics_file and trace_file (registry, tracer, sync tracing): the
    differences are telemetry's cost per span and per sync event. The
    read here is made from outside the package, so its call-site walk
    climbs the whole stack (the package's reads stop at their own
    frame)."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.utils import device as D
    t = torch.zeros(1, device=device)

    def per_call(fn, k):
        fn()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        return (time.perf_counter() - t0) / k * 1e6

    def one_span():
        with obs.span("fused/partition", phase="partition"):
            pass

    def one_read():
        D.device_get(t)

    def costs():
        return per_call(one_span, n), per_call(one_read, n // 10)
    off = costs()
    session = obs.TelemetrySession(
        metrics_file=os.path.join(tmp, "unit.jsonl"),
        trace_file=os.path.join(tmp, "unit.json"), device=str(device))
    session.start()
    try:
        session.begin_iteration(0)
        on = costs()
        session.end_iteration(0)
    finally:
        session.close()
    return off, on


def median(xs):
    return float(np.median(np.asarray(xs, np.float64)))


def higgs_base(args, device="cuda"):
    """Phase 3's HIGGS run alone, for the ``--*-only`` modes: its
    dataset, held-out rows, model texts at the later phases' depths,
    seconds per iteration and held-out AUC."""
    import lightgbm_tpu_torch as lgt
    hold = 200_000
    X, y = make_higgs_like(args.rows + hold, 28, seed=0)
    ds = lgt.Dataset(X[:args.rows], label=y[:args.rows],
                     params={**HIGGS_PARAMS, "device_type": device})
    ds.construct()
    _, b, auc = run_path("HIGGS fused", HIGGS_PARAMS, ds, args.iters,
                         X[args.rows:], y[args.rows:],
                         ("hist_planar", "partition"), device)
    return dict(ds=ds, hX=X[args.rows:], hy=y[args.rows:],
                text=obs_base_texts(b),
                secs=PATH_STATS["HIGGS fused"]["secs"], auc=auc)


def obs_higgs(args, report, base=None, device="cuda"):
    """(ae): the HIGGS fused path at full width (args.rows x 28, 255
    leaves and bins, phase 3's dataset). First telemetry's own cost:
    OBS_PAIRS alternating pairs of 2-iteration runs without telemetry
    and with metrics_file and trace_file, whose steady iterations give
    the overhead and, from the records, the host split by phase. Then
    OBS_PROFILED_ITERS iterations with full telemetry: metrics_file,
    trace_file, profile_dir, obs_port and flight_dir, and the held-out
    rows as a valid set; the profiler's trace gives the card's split.
    ``base``: phase 3's HIGGS run (dataset, held-out rows, model texts
    at (ae)'s depths, seconds per iteration); None builds
    the dataset and trains the run without telemetry here. Adds its
    B1 / B2 launches to ``report``."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import report as obs_report
    from lightgbm_tpu_torch.ops import cuda as K
    t_phase = time.perf_counter()
    if base is None:
        base = higgs_base(args, device)
    ds, iters = base["ds"], OBS_PROFILED_ITERS
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    # telemetry's own cost, before the profiler runs in this process:
    # alternating pairs (off, on | on, off | ...) of the same 2
    # iterations without telemetry and with metrics_file and trace_file
    # (no profiler, endpoint or flight recorder); the second
    # iterations compared, within each pair
    fields = ("t_iter_s", "t_hist_s", "t_split_s", "t_partition_s",
              "t_other_s")
    steady = {"off": [], "on": []}
    gc_ms = {"off": [], "on": []}
    split, n_events = [], []
    # the host's garbage collections, timed: a full collection of this
    # process's heap inside a steady iteration would read as overhead
    gc_clock = {"ms": 0.0, "t0": 0.0}

    def gc_timer(phase, info):
        if phase == "start":
            gc_clock["t0"] = time.perf_counter()
        else:
            gc_clock["ms"] += 1e3 * (time.perf_counter() - gc_clock["t0"])
    gc.callbacks.append(gc_timer)
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(2 * OBS_PAIRS):
            key = ("off", "on")[(k + k // 2) % 2]
            extra = {} if key == "off" else {
                "metrics_file": os.path.join(tmp, f"m{k}.jsonl"),
                "trace_file": os.path.join(tmp, f"t{k}.json")}
            marks = []

            def tock(env):
                if env.iteration == 1:
                    sync()
                    marks.append((time.perf_counter(), gc_clock["ms"]))

            def tick(env):
                tock(env)
            # the second iteration from its start to its after-iteration
            # callbacks, in either loop (the pipelined loop runs them
            # once the next iteration is dispatched, here at the end)
            tick.before_iteration = True
            b = lgt.train({**HIGGS_PARAMS, "device_type": device, **extra},
                          ds, num_boost_round=2, callbacks=[tick, tock],
                          verbose_eval=False)
            steady[key].append(marks[1][0] - marks[0][0])
            gc_ms[key].append(marks[1][1] - marks[0][1])
            assert obs_text(b.model_to_string()) == \
                obs_text(base["text"][2]), \
                f"(ae) pair run {k} ({key}) differs from phase 3's model"
            if key == "on":
                recs = obs.read_jsonl(extra["metrics_file"])
                check_records(f"(ae) pair run {k}", recs, 2)
                events = obs_report.load_trace(extra["trace_file"])
                check_coverage(f"(ae) pair run {k}", events, [1])
                split.append({f: recs[1][f] for f in fields})
                # the steady iteration's spans and sync events
                n_events.append([sum(
                    1 for e in events if e.get("ph") == "X"
                    and e.get("cat") == cat
                    and (e.get("args") or {}).get("iteration") == 1)
                    for cat in ("phase", "sync")])
            del b
        gc.callbacks.remove(gc_timer)
        unit_off, unit_on = telemetry_unit_us(device, tmp)
    over = [100 * (on / off - 1)
            for off, on in zip(steady["off"], steady["on"])]
    log(f"(ae) steady iteration s, {OBS_PAIRS} alternating pairs: without "
        f"telemetry {json.dumps([round(x, 4) for x in steady['off']])}, "
        f"with metrics_file and trace_file "
        f"{json.dumps([round(x, 4) for x in steady['on']])}; overhead per "
        f"pair {json.dumps([round(x, 1) for x in over])}%, median "
        f"{median(over):+.1f}% (spread {min(over):+.1f} to "
        f"{max(over):+.1f}%); median s/iteration {median(steady['off']):.4f}"
        f" without, {median(steady['on']):.4f} with")
    d_span, d_read = unit_on[0] - unit_off[0], unit_on[1] - unit_off[1]
    n_span = median([n[0] for n in n_events])
    n_sync = median([n[1] for n in n_events])
    log(f"(ae) telemetry's unit cost on this host: a span {unit_off[0]:.2f}"
        f" us without, {unit_on[0]:.2f} us with metrics_file and "
        f"trace_file; a counted read {unit_off[1]:.2f} us, then "
        f"{unit_on[1]:.2f} us; the steady iteration's spans and sync "
        f"events {json.dumps(n_events)}: {n_span:.0f} x {d_span:.2f} us + "
        f"{n_sync:.0f} x {d_read:.2f} us = "
        f"{(n_span * d_span + n_sync * d_read) / 1e3:.3f} ms beside the "
        f"median overhead "
        f"{1e3 * (median(steady['on']) - median(steady['off'])):.3f} ms; "
        f"garbage collection ms in the steady iteration without "
        f"{json.dumps([round(x, 1) for x in gc_ms['off']])}, with "
        f"{json.dumps([round(x, 1) for x in gc_ms['on']])}")
    log("(ae) per-phase host seconds of the steady iteration, metrics_file "
        "and trace_file only: " + json.dumps(
            [{f: round(r[f], 6) for f in fields} for r in split])
        + "; median " + json.dumps(
            {f: round(median([r[f] for r in split]), 6) for f in fields}))
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        params = {**HIGGS_PARAMS, "device_type": device,
                  "metrics_file": os.path.join(tmp, "m.jsonl"),
                  "trace_file": os.path.join(tmp, "t.json"),
                  "profile_dir": os.path.join(tmp, "prof"),
                  "obs_port": port, "flight_dir": os.path.join(tmp, "fl")}
        valid = ds.create_valid(base["hX"], label=base["hy"])
        pages, syncs, marks = {}, [], []

        def probe(env):
            sync()
            marks.append(time.perf_counter())
            gb = env.model._gbdt
            syncs.append(gb._fused.syncs)
            if env.iteration == iters - 1:
                # the live endpoint answers during training
                for route in ("/metrics", "/healthz", "/statusz"):
                    pages[route] = fetch(port, route)
        probe.order = 40
        K.reset_launches()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        marks.append(time.perf_counter())
        booster = lgt.train(params, ds, num_boost_round=iters,
                            valid_sets=[valid], valid_names=["hold"],
                            callbacks=[probe], verbose_eval=False)
        sync()
        # from the last iteration's end: the session's close (the trace
        # and the profiler's export)
        t_close = time.perf_counter() - marks[-1]
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        gb = booster._gbdt
        assert gb._fused_persist, "(ae) not the persistent fused path"
        # telemetry changes no result
        assert obs_text(booster.model_to_string()) == \
            obs_text(base["text"][iters]), \
            "(ae): the telemetry run's model differs from phase 3's"
        for k in ("hist_planar", "partition"):
            assert device != "cuda" or launches[k] > 0, f"(ae): {k}"
        for r in report:
            r["launches"] += launches.get(r["name"], 0)
        recs = obs.read_jsonl(params["metrics_file"])
        check_records("(ae)", recs, iters)
        # coverage, and every host sync attributed and accounted for
        events = obs_report.load_trace(params["trace_file"])
        cov = check_coverage("(ae)", events, range(iters))
        per_it = {}
        for e in events:
            if e.get("cat") == "sync" and e.get("ph") == "X":
                it = (e.get("args") or {}).get("iteration")
                per_it[it] = per_it.get(it, 0) + 1
                assert "@lightgbm_tpu_torch/" in e["name"], e["name"]
        learner = [b - a for a, b in zip([0] + syncs, syncs)]
        want = [n + 2 for n in learner]      # + the eval read + the stream
        got = [per_it.get(i, 0) for i in range(iters)]
        assert got == want, ("(ae) sync events", got, "learner", learner)
        # memory: the allocator's peak brackets the sampled live peak
        g = recs[-1]["gauges"]
        if device == "cuda":
            assert g["mem.planar_state_bytes"] <= g["mem.live_peak_bytes"] \
                <= peak, ("(ae) memory", g, peak)
        # the live endpoint answered during training
        assert pages["/metrics"][0] == 200 and \
            "lgbm_tpu_kernel_hist_calls" in pages["/metrics"][1], pages
        hz = json.loads(pages["/healthz"][1])
        st = json.loads(pages["/statusz"][1])
        assert pages["/healthz"][0] == 200 and hz["status"] == "ok", hz
        assert pages["/statusz"][0] == 200 and st["registry_active"] \
            and st["iteration"] == iters - 1, st
        # the profiler's trace names B1's and B2's kernels
        prof = [os.path.join(params["profile_dir"], f)
                for f in os.listdir(params["profile_dir"])]
        assert len(prof) == 1, prof
        prof_mb = os.path.getsize(prof[0]) / 2 ** 20
        t0 = time.perf_counter()
        dev_ms, knames, busy = kernel_split(prof[0])
        t_parse = time.perf_counter() - t0
        if device == "cuda":
            assert "hp_partials" in knames, sorted(knames)[:40]
            assert {"part_small", "part_tiles"} & set(knames), \
                sorted(knames)[:40]
        summary = obs_report.summarize(events, top_n=10)
    # the printout: the card's split, sync sites, the profiler's cost
    sec = [b - a for a, b in zip(marks, marks[1:])]
    log(f"(ae) device kernel ms per iteration by phase (profiler, "
        f"{iters} iterations) " + json.dumps(
            {k: round(v / iters, 3) for k, v in dev_ms.items()})
        + f"; busy {busy / iters:.3f} ms of "
        f"{1e3 * sum(r['t_iter_s'] for r in recs) / iters:.3f} ms wall "
        f"per iteration; kernels per iteration "
        f"{sum(knames.values()) / iters:.0f}")
    log(f"(ae) phase coverage {json.dumps({k: round(v, 4) for k, v in cov.items()})}; "
        f"host syncs per iteration {got} (learner {learner} + eval read + "
        f"stream sync)")
    log("(ae) top sync sites (count, total ms, max ms): " + "; ".join(
        f"{n} {c} {t:.3f} {m:.3f}" for n, c, t, m in summary["sync_totals"]))
    log(f"(ae) s/iteration with full telemetry (profiler included) "
        f"{json.dumps([round(x, 4) for x in sec])} beside phase 3's run "
        f"without {json.dumps([round(x, 4) for x in base['secs']])}")
    log(f"(ae) session close (trace + profiler export) {t_close:.1f} s, "
        f"profiler trace {prof_mb:.1f} MiB parsed in {t_parse:.1f} s")
    log(f"(ae) memory: live peak {g.get('mem.live_peak_bytes', -1)} bytes, "
        f"planar state {g['mem.planar_state_bytes']} bytes, allocator peak "
        f"{peak} bytes; endpoint answered {sorted(pages)}; "
        f"model text equal to phase 3's")
    # implicit syncing calls of one traced iteration, by call site
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sites = implicit_sync_sites(lambda: lgt.train(
            {**HIGGS_PARAMS, "device_type": device,
             "trace_file": os.path.join(tmp, "t1.json")}, ds,
            num_boost_round=1, verbose_eval=False), device)
    log(f"(ae) syncing CUDA calls in one traced iteration (sync debug "
        f"mode warn): {sum(sites.values())} in "
        f"{time.perf_counter() - t0:.1f} s; top sites: " + "; ".join(
            f"{k} x{v}" for k, v in sites.most_common(10)))
    log(f"(ae): {time.perf_counter() - t_phase:.1f} s")
    return base


def flight_check(flight_dir, diagnosis):
    """(af): exactly one bundle in ``flight_dir``, from the watchdog,
    holding its manifest, the trace, the registry and the stacks; the
    HangTimeout diagnosis names the flushed trace; trace-report --flight
    reads the bundle."""
    import contextlib
    import io
    from lightgbm_tpu_torch import cli
    bundles = [d for d in os.listdir(flight_dir) if d.startswith("flight_")]
    assert len(bundles) == 1, ("(af) bundles", os.listdir(flight_dir))
    b = os.path.join(flight_dir, bundles[0])
    for f in ("manifest.json", "trace.json", "registry.json", "stacks.txt"):
        assert os.path.isfile(os.path.join(b, f)), ("(af)", f, os.listdir(b))
    with open(os.path.join(b, "manifest.json")) as fh:
        assert json.load(fh)["trigger"] == "watchdog"
    assert diagnosis.get("trace_file") and \
        os.path.isfile(diagnosis["trace_file"]), ("(af)", diagnosis)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["trace-report", "--flight", flight_dir])
    assert rc == 0, out.getvalue()
    log("(af) flight bundle " + bundles[0] + ": " + "; ".join(
        ln.strip() for ln in out.getvalue().splitlines()[:6]))


# ---------------------------------------------------------------------------
# phase 7: the pipelined loop, the split step's syncing calls, warm-up
# ---------------------------------------------------------------------------

PIPE_PAIRS = 2                     # (ah): alternating pairs
PIPE_ITERS = 3                     # (ah): iterations of each run
SYNC_CALLS_MAX = 2                 # (ah): syncing CUDA calls per steady
#                                    iteration and train()'s end (1,539
#                                    with implicit reads, 268 with one read
#                                    per split)
DEV_SYNC_CALLS_MAX = 1             # (ak): the same without a valid set
# (ah): the held-out AUC of the HIGGS path after 3 iterations at
# 2,000,000 rows, as this script has read it since the kernels' redesign
HIGGS_AUC_3 = "0.770587"
ES_ROUNDS = 1                      # (ai): early_stopping_rounds
ES_MAX_ITERS = 20                  # (ai): the runs' num_boost_round
ES_CASE_ROWS = 2_000               # (ai): card == CPU, training rows
WARM_ROWS = 250_000                # (aj): the children's training rows
WARM_CSV_ROWS = 20_000             # (aj): the CLI's CSV rows


def _pipeline_env(pipe):
    """Set LGBM_TPU_PIPELINE ("0": synchronous; None: the default,
    pipelined)."""
    if pipe is None:
        os.environ.pop("LGBM_TPU_PIPELINE", None)
    else:
        os.environ["LGBM_TPU_PIPELINE"] = pipe


def _flip_half(y):
    """Every second label flipped: a validation set on which the loss
    grows after the first iterations, so early stopping fires."""
    y = np.array(y, dtype=np.float64)
    y[::2] = 1.0 - y[::2]
    return y


def pipeline_paths(args, base, device="cuda"):
    """Phase 7 (ah), (ai) on phase 3's HIGGS data ``base``."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda as K
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ds, hX, hy = base["ds"], base["hX"], base["hy"]
    params = {**HIGGS_PARAMS, "device_type": device}
    valid = ds.create_valid(hX, label=hy)
    n = min(PIPE_ITERS, args.iters)

    def run(pipe, callbacks=(), iters=PIPE_ITERS):
        _pipeline_env(pipe)
        marks = []

        def tick(env):
            # host clock only: a card sync here would drain the queue
            # the pipelined loop keeps ahead
            marks.append(time.perf_counter())
        tick.before_iteration = True
        try:
            b = lgt.train(dict(params), ds, num_boost_round=iters,
                          valid_sets=[valid], valid_names=["hold"],
                          callbacks=[tick, *callbacks], verbose_eval=False)
            sync()
        finally:
            _pipeline_env(None)
        # iterations 1.. (the first builds the state)
        return b, (time.perf_counter() - marks[1]) / (iters - 1)

    # (ah): alternating pairs, pipelined first in even pairs
    secs = {"pipelined": [], "synchronous": []}
    texts, aucs = set(), set()
    K.reset_launches()
    for k in range(2 * PIPE_PAIRS):
        key = ("pipelined", "synchronous")[(k + k // 2) % 2]
        b, sec = run(None if key == "pipelined" else "0")
        secs[key].append(sec)
        texts.add(b.model_to_string(num_iteration=n))
        aucs.add(f"{held_out_metric(b, hX, hy, 'auc', device):.6f}")
        del b
    launches = K.launch_counts()
    assert len(texts) == 1 and len(aucs) == 1, \
        "(ah): the two loops' models differ"
    assert texts == {base["text"][n]}, "(ah): model differs from phase 3's"
    if args.iters == PIPE_ITERS:
        assert aucs == {f"{base['auc']:.6f}"}, (aucs, base["auc"])
    if args.rows == 2_000_000:
        assert aucs == {HIGGS_AUC_3}, (aucs, HIGGS_AUC_3)
    for key in ("hist_planar", "partition"):
        assert device != "cuda" or launches[key] > 0, f"(ah): {key}"
    log(f"(ah) HIGGS {args.rows} x 28, {PIPE_ITERS} iterations with the "
        f"held-out rows as a valid set, s/iteration of iterations 1-"
        f"{PIPE_ITERS - 1}, {PIPE_PAIRS} alternating pairs: pipelined "
        f"{json.dumps([round(x, 4) for x in secs['pipelined']])}, "
        f"synchronous (LGBM_TPU_PIPELINE=0) "
        f"{json.dumps([round(x, 4) for x in secs['synchronous']])}; per "
        f"pair pipelined/synchronous " + json.dumps(
            [round(a / b, 4) for a, b in zip(secs["pipelined"],
                                             secs["synchronous"])])
        + f"; median {median(secs['pipelined']):.4f} vs "
        f"{median(secs['synchronous']):.4f}; held-out AUC {aucs.pop()} in "
        f"every run, model text equal to phase 3's at depth {n}")
    sites: list = []
    per_iter = syncs_per_iteration(
        lambda mark: run(None, [mark], iters=2)[0], device, sites)
    # iteration 1: its own work and the trailing read of iteration 0
    # (iteration 0 builds the state), and the final drain
    reads, calls = per_iter[1]
    log(f"(ah) (learner reads, syncing CUDA calls) per iteration of the "
        f"pipelined run (sync debug mode \"warn\"): {per_iter}; steady "
        f"iteration {calls} syncing calls, {reads} learner reads "
        f"(limit {SYNC_CALLS_MAX}) at {json.dumps(sites[1])}")
    assert device != "cuda" or calls <= SYNC_CALLS_MAX, per_iter

    # (ai): early stopping on a valid set whose loss grows
    vflip = ds.create_valid(hX, label=_flip_half(hy))
    es = {}
    for pipe in (None, "0"):
        _pipeline_env(pipe)
        t0 = time.perf_counter()
        try:
            b = lgt.train(dict(params), ds, num_boost_round=ES_MAX_ITERS,
                          valid_sets=[vflip], early_stopping_rounds=ES_ROUNDS,
                          verbose_eval=False)
        finally:
            _pipeline_env(None)
        es[pipe] = (b.best_iteration, b.num_trees(),
                    b.model_to_string(num_iteration=b.best_iteration),
                    time.perf_counter() - t0)
    (bi_p, nt_p, tx_p, s_p), (bi_s, nt_s, tx_s, s_s) = es[None], es["0"]
    assert bi_p == bi_s > 0 and tx_p == tx_s, ("(ai)", es[None][:2],
                                               es["0"][:2])
    assert nt_s <= nt_p <= nt_s + 1, ("(ai)", nt_p, nt_s)
    X, y = make_higgs_like(ES_CASE_ROWS + 800, 28, seed=5)
    small = {}
    for dev in ("cuda", "cpu") if device == "cuda" else ("cpu",):
        sds = lgt.Dataset(X[:ES_CASE_ROWS], label=y[:ES_CASE_ROWS])
        svs = sds.create_valid(X[ES_CASE_ROWS:],
                               label=_flip_half(y[ES_CASE_ROWS:]))
        b = lgt.train({**HIGGS_PARAMS, "device_type": dev,
                       "tpu_hist_dtype": "float32"}, sds,
                      num_boost_round=ES_MAX_ITERS, valid_sets=[svs],
                      early_stopping_rounds=ES_ROUNDS, verbose_eval=False)
        small[dev] = (b.best_iteration, b.num_trees(), _tree_text(
            {"text": b.model_to_string()}), b.predict(X, raw_score=True))
    if device == "cuda":
        assert small["cuda"][:3] == small["cpu"][:3], \
            ("(ai) card != CPU", small["cuda"][:2], small["cpu"][:2])
        np.testing.assert_allclose(small["cuda"][3], small["cpu"][3],
                                   rtol=0, atol=1e-6)
    log(f"(ai) HIGGS early stopping ({ES_ROUNDS} rounds, held-out rows with "
        f"every second label flipped): pipelined best iteration {bi_p}, "
        f"{nt_p} trees, {s_p:.1f} s; synchronous {bi_s}, {nt_s} trees, "
        f"{s_s:.1f} s; model texts equal at the best iteration; "
        f"{ES_CASE_ROWS} rows card == CPU: best iteration "
        f"{small['cpu'][0]}, {small['cpu'][1]} trees, model text and raw "
        f"predictions equal")
    return launches


_WARM_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.compile import manager
X, y = np.load(sys.argv[2]), np.load(sys.argv[3])
t0 = time.perf_counter()
lgt.train(json.loads(sys.argv[4]), lgt.Dataset(X, label=y),
          num_boost_round=1, verbose_eval=False)
torch.cuda.synchronize()
print(json.dumps({"first_iteration_s": time.perf_counter() - t0,
                  "compile": manager.snapshot()}))
"""


# -- phase 8: the split loop without reads, the captured step, batching --
DEV_ITERS = 4                      # (ak): iterations of each run
DEV_BATCH = "4"                    # (al): LGBM_TPU_ITER_BATCH, over
DEV_BATCH_ITERS = 5                # iterations (a batch of 4, then 1)
DEV_CASE_ITERS = 3                 # (am): card == CPU at phase 4's sizes
DEV_CASE_PARAMS = {**HIGGS_PARAMS, "num_leaves": PHASE4_LEAVES,
                   "tpu_hist_dtype": "float32"}


def steady_sync_sites(booster, learner, device="cuda"):
    """One steady ``update()`` of ``booster`` under CUDA sync debug mode
    "warn": (the learner's counted reads, the syncing CUDA calls by
    Python site)."""
    import warnings
    from collections import Counter
    here = os.path.dirname(os.path.abspath(__file__))
    reads0 = learner.syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            booster.update()
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    # the mode's own one-time notice names synchronization too
    sites = Counter(
        f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message).lower()
        and "prototype" not in str(w.message))
    return learner.syncs - reads0, sites


def devloop_paths(args, base, device="cuda"):
    """Phase 8 on phase 3's HIGGS data ``base``: (ak) the captured split
    step against the eager device loop (equal model text; s/iteration,
    captures and their seconds, counted reads and syncing calls per
    steady iteration without a valid set by site, kernels per steady
    iteration, B1 / B2 ms per iteration by the profiler); (al)
    LGBM_TPU_ITER_BATCH=4 over DEV_BATCH_ITERS iterations (a partial
    last batch) against batch 1; (am) card == CPU on the new loop at
    phase 4's sizes, plain and quantized. Returns the launches of (ak)'s
    and (al)'s runs (replays counted)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.compile import manager
    from lightgbm_tpu_torch.ops import cuda as K
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ds = base["ds"]
    params = {**HIGGS_PARAMS, "device_type": device}

    def run(eager, iters=DEV_ITERS):
        marks = []

        def tick(env):
            if eager:
                env.model._gbdt._fused._eager_loop = True
            sync()
            marks.append(time.perf_counter())
        tick.before_iteration = True
        s0 = manager.snapshot()
        b = lgt.train(dict(params), ds, num_boost_round=iters,
                      callbacks=[tick], verbose_eval=False)
        sync()
        marks.append(time.perf_counter())
        s1 = manager.snapshot()
        caps = s1.get("graph_captures", 0) - s0.get("graph_captures", 0)
        cap_s = s1.get("graph_capture_s", 0) - s0.get("graph_capture_s", 0)
        secs = [b_ - a for a, b_ in zip(marks, marks[1:])]
        return b, secs, caps, cap_s

    # (ak): graph, then eager
    K.reset_launches()
    texts, secs, caps = {}, {True: [], False: []}, {}
    for eager in (False, True):
        b, sec, n_cap, cap_s = run(eager)
        texts.setdefault(eager, set()).add(obs_text(b.model_to_string()))
        assert b.model_to_string(num_iteration=2) == base["text"][2], \
            "(ak): the first two trees differ from phase 3's"
        secs[eager].append(sec)
        caps.setdefault(eager, []).append((n_cap, cap_s))
        del b
    launches = K.launch_counts()
    assert len(texts[False]) == 1 and texts[False] == texts[True], \
        "(ak): the captured step and the eager loop train different models"
    if device == "cuda":
        assert all(n == 1 for n, _ in caps[False]), caps
        assert all(n == 0 for n, _ in caps[True]), caps
    for eager in (False, True):
        steady = [s[2:] for s in secs[eager]]
        log(f"(ak) HIGGS {args.rows} x 28, {DEV_ITERS} iterations, "
            f"{'eager device loop' if eager else 'captured split step'}: "
            f"s/iteration {json.dumps([[round(x, 4) for x in s] for s in secs[eager]])}"
            f" (iteration 0 eager, 1 captures); steady median "
            f"{median([x for s in steady for x in s]):.4f}")
    log(f"(ak) captures (count, s) per graph run "
        f"{json.dumps([(n, round(c, 4)) for n, c in caps[False]])}; "
        f"model text equal in both runs; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")

    # counted reads and syncing calls per steady iteration, no valid set
    b = lgt.Booster(dict(params), ds)
    b.update()                      # the first tree, eager
    b.update()                      # the capture
    learner = b._gbdt._fused
    per = [steady_sync_sites(b, learner, device) for _ in range(2)]
    for reads, sites in per:
        log(f"(ak) steady iteration: {reads} counted reads, "
            f"{sum(sites.values())} syncing CUDA calls (limit "
            f"{DEV_SYNC_CALLS_MAX}) at {json.dumps(dict(sites))}")
        assert reads == 0, per
        assert device != "cuda" or sum(sites.values()) <= \
            DEV_SYNC_CALLS_MAX, per
    K.reset_launches()
    b.update()
    one = K.launch_counts()
    log(f"(ak) wrappers' launches in one steady iteration (replays "
        f"counted): {json.dumps({k: v for k, v in one.items() if v})}")
    if device == "cuda":
        assert one["hist_planar"] >= 255 and one["partition"] >= 254, one
        profile_iteration("(ak) HIGGS captured step", b, device_only=True)
        learner._eager_loop = True
        profile_iteration("(ak) HIGGS eager device loop", b,
                          device_only=True)
    del b, learner

    # (al): LGBM_TPU_ITER_BATCH=4 over DEV_BATCH_ITERS iterations
    os.environ["LGBM_TPU_ITER_BATCH"] = DEV_BATCH
    K.reset_launches()
    try:
        t0 = time.perf_counter()
        b = lgt.train(dict(params), ds, num_boost_round=DEV_BATCH_ITERS,
                      verbose_eval=False)
        assert b._gbdt._iter_batch == int(DEV_BATCH)
        reads = b._gbdt._fused.syncs
        text = obs_text(b.model_to_string(num_iteration=DEV_ITERS))
        sync()
        t_batch = time.perf_counter() - t0
    finally:
        os.environ.pop("LGBM_TPU_ITER_BATCH", None)
    for k, v in K.launch_counts().items():
        launches[k] += v
    assert {text} == texts[False], "(al): batch 4 and batch 1 differ"
    log(f"(al) LGBM_TPU_ITER_BATCH={DEV_BATCH}, {DEV_BATCH_ITERS} iterations "
        f"(a batch of 4, then 1): model text equal to batch 1's at depth "
        f"{DEV_ITERS}; "
        f"{reads} counted reads in training (the end's trim), "
        f"{t_batch:.2f} s with the model's read")
    del b

    # (am): card == CPU on the new loop, small
    X, y = make_higgs_like(PHASE4_ROWS, 28, seed=11)
    for name, extra in (("plain", {}),
                        ("quantized", {"use_quantized_grad": True,
                                       "num_grad_quant_bins": 4})):
        got = {}
        for dev in ("cuda", "cpu") if device == "cuda" else ("cpu",):
            sb = lgt.train({**DEV_CASE_PARAMS, **extra, "device_type": dev},
                           lgt.Dataset(X, label=y),
                           num_boost_round=DEV_CASE_ITERS)
            got[dev] = _plain_text(sb)
        assert len(set(got.values())) == 1, f"(am) {name}: card != CPU"
        log(f"(am) {name}: {PHASE4_ROWS} rows, {PHASE4_LEAVES} leaves, "
            f"{DEV_CASE_ITERS} iterations (the graph from the second): "
            f"model text card == CPU")
    return launches


# -- phase 9: the per-tree path without reads, its captured step, forced --
PT_ITERS = 3                       # (an) (o)-(q): timed iterations per run
PT_MC_ITERS = 2                    # (an) (l): captured run (5 trees each;
PT_MC_EAGER_ITERS = 1              # the eager run, 1: ~10 s an iteration)
PT_CASE_ITERS = 3                  # (ap): card == CPU at phase 4's sizes
# (an): (key, name, params, data, counted reads per steady iteration:
# DART's one materialize, as the JAX package's)
PT_PATHS = [("l", "(l) HIGGS-multiclass", "mc", 0),
            ("o", "(o) HIGGS bagging", "higgs", 0),
            ("p", "(p) HIGGS GOSS", "higgs", 0),
            ("q", "(q) HIGGS DART", "higgs", 1)]


def _plain_text(booster, **kw):
    """A model text without its ``device_type`` parameter line."""
    return "\n".join(ln for ln in booster.model_to_string(**kw).splitlines()
                     if not ln.startswith("[device_type"))


def _trees_part(text):
    """A model text up to its trees' end (no importances or parameters:
    a Booster's echo of them differs from train()'s)."""
    return text.split("end of trees")[0]


def pertree_run(params, ds, iters, eager, depth, device="cuda",
                sites=False):
    """``iters`` timed ``Booster.update()`` calls of the per-tree path
    (``eager``: the learner's ``_eager_loop``), the model text at
    ``depth`` iterations (read then: DART's later iterations rescale
    earlier trees), then, with ``sites``, one more update under CUDA
    sync debug mode "warn" (``steady_sync_sites``). Returns (booster,
    s per iteration, counted reads per iteration, captures, capture s,
    model text, (reads, syncing call sites) of the extra update or
    None)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.compile import manager
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    b = lgt.Booster({**params, "device_type": device}, ds)
    fl = b._gbdt._fused
    assert fl is not None and not b._gbdt._fused_persist, params
    fl._eager_loop = eager
    s0 = manager.snapshot()
    secs, reads = [], []
    for _ in range(iters):
        sync()
        t0, r0 = time.perf_counter(), fl.syncs
        b.update()
        sync()
        secs.append(time.perf_counter() - t0)
        reads.append(fl.syncs - r0)
    s1 = manager.snapshot()
    text = _plain_text(b, num_iteration=depth)
    steady = steady_sync_sites(b, fl, device) if sites else None
    return (b, secs, reads,
            s1.get("graph_captures", 0) - s0.get("graph_captures", 0),
            s1.get("graph_capture_s", 0) - s0.get("graph_capture_s", 0),
            text, steady)


def pertree_paths(args, base, device="cuda", tmp=None):
    """Phase 9 on phase 3's HIGGS data and (l)'s multiclass data
    (``base``, no valid set): (an) (l), (o), (p), (q) captured and
    eager, one after the other (equal model texts; s/iteration,
    captures and their seconds; counted reads and syncing calls of a
    steady update by site; one profiled steady (l) iteration); (ao)
    forced splits on the persistent and the per-tree learner (no
    counted read, the persistent model phase 3's (t)); (ap) card == CPU
    at phase 4's sizes. Returns the launches of (an) and (ao)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda as K
    bag_params = {k: e for k, _, e, _ in BAG_PATHS}
    data = {"higgs": base["ds"], "mc": base["mc"]}
    launches = {}

    def add_launches():
        for key, v in K.launch_counts().items():
            launches[key] = launches.get(key, 0) + v
        K.reset_launches()

    # (an): captured, then eager, per case
    K.reset_launches()
    t0 = time.perf_counter()
    for key, name, dkey, want in PT_PATHS:
        t_case = time.perf_counter()
        params = ({**MC_PARAMS, "objective": "multiclass"} if key == "l"
                  else {**HIGGS_PARAMS, **bag_params[key]})
        iters = PT_MC_ITERS if key == "l" else PT_ITERS
        depth = PT_MC_EAGER_ITERS if key == "l" else iters
        b, secs, reads, caps, cap_s, text, steady = pertree_run(
            params, data[dkey], iters, False, depth, device, sites=True)
        k = b._gbdt.num_tree_per_iteration
        if key == "l" and device == "cuda":
            t_prof = time.perf_counter()
            profile_iteration(f"(an) {name} captured step", b,
                              device_only=True)
            log(f"(an) {name}: the profiled iteration took "
                f"{time.perf_counter() - t_prof:.1f} s with the profiler")
        eb, esecs, ereads, ecaps, _, etext, _ = pertree_run(
            params, data[dkey], depth, True, depth, device)
        add_launches()
        assert text == etext, f"(an) {name}: captured and eager models differ"
        assert reads == [want] * iters, (name, reads)
        assert ereads == [want] * len(ereads), (name, ereads)
        assert steady[0] == want, (name, steady)
        if device == "cuda":
            assert caps == 1 and ecaps == 0, (name, caps, ecaps)
        log(f"(an) {name}, {k} tree(s) per iteration: s/iteration captured "
            f"{json.dumps([round(x, 4) for x in secs])} (the first tree "
            f"eager, the second captures: {caps} capture, {cap_s:.4f} s), "
            f"eager device loop {json.dumps([round(x, 4) for x in esecs])}; "
            f"counted reads per iteration {reads} / {ereads}; model text "
            f"equal at depth {depth}")
        log(f"(an) {name} steady update: {steady[0]} counted reads, "
            f"{sum(steady[1].values())} syncing CUDA calls at "
            f"{json.dumps(dict(steady[1]))}; the case "
            f"{time.perf_counter() - t_case:.1f} s in all")
        del b, eb

    log(f"(an): {time.perf_counter() - t0:.1f} s")

    # (ao): forced splits on the persistent and the per-tree learner
    t0 = time.perf_counter()
    forced = write_forced_splits(tmp)
    for learner, extra in (("persistent", {}),
                           ("per-tree (bagging)", bag_params["o"])):
        params = {**HIGGS_PARAMS, **extra, "forcedsplits_filename": forced,
                  "device_type": device}
        texts, reads = {}, {}
        for eager in (False, True):
            b = lgt.Booster(dict(params), base["ds"])
            fl = b._gbdt._fused
            assert fl is not None and fl._forced_sched is not None
            assert b._gbdt._fused_persist == (learner == "persistent")
            fl._eager_loop = eager
            r0 = fl.syncs
            for _ in range(args.iters):
                b.update()
            reads[eager] = fl.syncs - r0
            for t in b._gbdt.models:
                assert list(t.split_feature[:3]) == [0, 1, 2], learner
            texts[eager] = _plain_text(b)
            del b, fl
        add_launches()
        assert reads == {False: 0, True: 0}, (learner, reads)
        assert texts[False] == texts[True], \
            f"(ao) {learner}: captured and eager models differ"
        if learner == "persistent" and base.get("t_text") is not None:
            assert _trees_part(texts[False]) == base["t_text"], \
                "(ao): the persistent forced model differs from phase 3's (t)"
        log(f"(ao) forced splits, {learner} learner, {args.iters} "
            f"iterations: 0 counted reads (the forced phase's verdicts stay "
            f"on the card), every tree's first three splits the forced "
            f"ones, captured == eager model text"
            + (", equal to phase 3's (t)" if learner == "persistent"
               and base.get("t_text") is not None else ""))

    log(f"(ao): {time.perf_counter() - t0:.1f} s")

    # (ap): card == CPU at phase 4's sizes, PT_CASE_ITERS iterations (a
    # third iteration over phase 4's: GOSS's first sampled round, a
    # second pos/neg bag count, DART dropping a captured tree)
    t0 = time.perf_counter()
    n, m = PHASE4_ROWS, BAG_CASE_ROWS
    X, y = make_higgs_like(n, 28, seed=3)
    Xr, yr = make_higgs_reg_like(n, 28, seed=3)
    y3 = np.digitize(yr, np.quantile(yr, [1 / 3, 2 / 3])).astype(np.float32)
    bag = {"bagging_fraction": 0.7, "bagging_freq": 1}
    cases = [
        ("multiclass", {"objective": "multiclass", "num_class": 3}, Xr, y3),
        ("multiclassova", {"objective": "multiclassova", "num_class": 3},
         Xr, y3),
        ("bagging", bag, X[:m], y[:m]),
        ("pos/neg bagging", {"pos_bagging_fraction": 0.6,
                             "neg_bagging_fraction": 0.8,
                             "bagging_freq": 1}, X[:m], y[:m]),
        ("GOSS", {"boosting": "goss", "learning_rate": 0.5}, X[:m], y[:m]),
        ("DART", {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
         X[:m], y[:m]),
        ("RF", {"boosting": "rf", "bagging_fraction": 0.632,
                "bagging_freq": 1, "feature_fraction": 0.8}, X[:m], y[:m]),
        ("forced splits", {"forcedsplits_filename": forced}, X[:m], y[:m]),
        ("forced splits bagging", {"forcedsplits_filename": forced, **bag},
         X[:m], y[:m])]
    for name, extra, xs, ys in cases:
        got = {}
        for dev in ("cuda", "cpu") if device == "cuda" else ("cpu",):
            params = {"objective": "binary", "tpu_hist_dtype": "float32",
                      "verbose": -1, "num_leaves": PHASE4_LEAVES,
                      "device_type": dev, **extra}
            b = lgt.train(params, lgt.Dataset(xs, label=ys),
                          num_boost_round=PT_CASE_ITERS, verbose_eval=False)
            assert b._gbdt._fused is not None, name
            got[dev] = (_plain_text(b), b.predict(xs, raw_score=True))
        (tg, pg), (tc, pc) = got.get("cuda", got["cpu"]), got["cpu"]
        assert tg == tc and np.array_equal(pg, pc), f"(ap) {name}: card != CPU"
        log(f"(ap) {name}: {len(ys)} rows, {PHASE4_LEAVES} leaves, "
            f"{PT_CASE_ITERS} iterations (the graph from the second tree): "
            f"model text and raw predictions card == CPU")
    log(f"(ap): {time.perf_counter() - t0:.1f} s")
    return launches


def warmup_paths(args, tmp, device="cuda"):
    """Phase 7 (aj): time to the first iteration (train() on WARM_ROWS rows
    of the HIGGS shape for one iteration, binning included) in child processes
    on a copy of the package without its build directory: cold without
    the warm-up (``LGBM_TPU_WARMUP=0``) and with ``tpu_warmup``, then
    warm without it; then the CLI's ``task=warmup`` and ``task=train``
    on a CSV in a fresh copy. Prints each time and the compile.*
    counters."""
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    X, y = make_higgs_like(WARM_ROWS, 28, seed=0)
    x_path, y_path = os.path.join(tmp, "wX.npy"), os.path.join(tmp, "wy.npy")
    np.save(x_path, X)
    np.save(y_path, y)

    def fresh_copy(name):
        root = os.path.join(tmp, name)
        shutil.copytree(os.path.join(here, "lightgbm_tpu_torch"),
                        os.path.join(root, "lightgbm_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        return root

    def child(root, warm):
        # without tpu_warmup, LGBM_TPU_WARMUP=0: at these rows the
        # warm-up would start on its own (bucket_min_rows)
        params = {**HIGGS_PARAMS, "device_type": device,
                  "tpu_warmup": warm}
        env = dict(os.environ, LGBM_TPU_WARMUP="1" if warm else "0")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", _WARM_CHILD, root, x_path, y_path,
             json.dumps(params)], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["process_s"] = time.perf_counter() - t0
        return res

    cold_off = fresh_copy("cold_off")
    runs = [("cold, no warm-up", child(cold_off, False))]
    cold_on = fresh_copy("cold_on")
    runs.append(("cold, tpu_warmup", child(cold_on, True)))
    runs.append(("warm, no warm-up", child(cold_on, False)))
    nsrc = 4
    for name, res in runs:
        c = res["compile"]
        log(f"(aj) {name}: first iteration {res['first_iteration_s']:.2f} s "
            f"after train() (process {res['process_s']:.1f} s); compile "
            f"counters {json.dumps(c)}")
    assert runs[0][1]["compile"].get("programs") == nsrc, runs[0]
    assert runs[1][1]["compile"].get("programs") == nsrc, runs[1]
    assert runs[2][1]["compile"].get("cache_hits") == nsrc, runs[2]
    assert "programs" not in runs[2][1]["compile"], runs[2]

    # the CLI: task=warmup, then task=train, in a fresh copy
    root = fresh_copy("cli")
    csv = os.path.join(tmp, "warm.csv")
    np.savetxt(csv, np.column_stack([y[:WARM_CSV_ROWS], X[:WARM_CSV_ROWS]]),
               delimiter=",", fmt="%.6g")
    common = [f"data={csv}", "label_column=0", "num_leaves=255",
              "max_bin=255", "num_iterations=1", f"device_type={device}",
              "verbosity=1"]
    env = dict(os.environ, PYTHONPATH=root)
    times = {}
    for task, extra in (("warmup", []),
                        ("train", [f"output_model={tmp}/warm_model.txt",
                                   f"metrics_file={tmp}/warm.jsonl"])):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                              f"task={task}", *common, *extra], cwd=tmp,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        times[task] = time.perf_counter() - t0
        assert out.returncode == 0, (task, out.stderr[-4000:])
        if task == "warmup":
            said = [ln for ln in (out.stdout + out.stderr).splitlines()
                    if "Warm-up built" in ln]
            assert said and f"built {nsrc}/{nsrc}" in said[-1], said
    from lightgbm_tpu_torch import obs
    rec = obs.read_jsonl(os.path.join(tmp, "warm.jsonl"))[0]
    comp = {k: v for k, v in rec["counters"].items()
            if k.startswith("compile.")}
    assert comp.get("compile.cache_hits") == nsrc and \
        "compile.programs" not in comp, comp
    log(f"(aj) CLI on a {WARM_CSV_ROWS}-row CSV: task=warmup {times['warmup']:.1f}"
        f" s ({said[-1].split('] ')[-1]}), then task=train "
        f"{times['train']:.1f} s with compile counters {json.dumps(comp)}")


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
    if "v" in keep:
        key, name, objective, _ = RANK_PATHS[0]
        cases.append((key, name, {**RANK_PARAMS, "objective": objective},
                      rank_data("cuda")[0]))
    for key, name, params, ds in cases:
        if key not in keep:
            continue
        booster = lgt.Booster(params, ds)
        fobj = binary_fobj if key == "n" else None
        booster.update(fobj=fobj)          # warm: state built, first tree
        # the per-tree paths' K x 255 splits: device rows only
        profile_iteration(name, booster,
                          device_only=key in ("l", "m", "n", "v"), fobj=fobj)
        if key == "v":
            profile_gradient(name, booster)


def _device_rows(prof):
    """[(device us, count, name)] of a profile's device-side rows
    (kernels, memcpy, memset), largest first: operator rows repeat their
    kernels' time."""
    rows_ = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows_.append((dev_us, evt.count, evt.key))
    return sorted(rows_, reverse=True)


def profile_gradient(name, booster):
    """One ranking-gradient call (``get_gradients`` on the booster's
    training scores) alone under torch.profiler: wall and device busy
    time, kernel launches, and the top kernels."""
    gbdt = booster._gbdt
    score = gbdt.get_training_score()[0]
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gbdt.objective.get_gradients(score)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows_ = _device_rows(prof)
    assert rows_, f"profile {name}: the profiler saw no device work"
    busy = sum(r[0] for r in rows_) / 1e6
    log(f"profile {name} ranking gradient: wall {wall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(r[1] for r in rows_)} kernels")
    for dev_us, count, key in rows_[:8]:
        log(f"profile {name} ranking gradient: {dev_us / 1e3:9.3f} ms  "
            f"{count:6d}x  {key[:80]}")


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
    # the iteration's reads (reading its trees below takes more)
    reads = learner.syncs - syncs0
    rows_ = _device_rows(prof)
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
        f"{reads} host syncs, {tree.num_leaves} leaves")
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
    ap.add_argument("--iters", type=int, default=2,
                    help="iterations of the HIGGS fused path, (d), (h), "
                    "(t) and (y), and of (u)'s two trainings together")
    ap.add_argument("--wide-rows", type=int, default=1_048_576,
                    help="training rows of shape (a) (the bench.py wide "
                    "sidecar's own default)")
    ap.add_argument("--wide-iters", type=int, default=2)
    ap.add_argument("--host-iters", type=int, default=2,
                    help="iterations of path (b)")
    ap.add_argument("--wide-host-iters", type=int, default=2,
                    help="iterations of path (c)")
    ap.add_argument("--multi-gpu-only", action="store_true",
                    help="build, then only the multi-GPU paths (y) and (z)"
                    " (no AUC comparison), and exit without a result")
    ap.add_argument("--robust-only", action="store_true",
                    help="build, then only phase 5 (robustness), and exit "
                    "without a result")
    ap.add_argument("--obs-only", action="store_true",
                    help="build, then only phase 6 (observability: (ae), "
                    "the hang drill with (af), phase 3b with (ag)), and "
                    "exit without a result")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="build, then only the HIGGS path and phase 7 (the "
                    "pipelined loop, syncing calls, warm-up), and exit "
                    "without a result")
    ap.add_argument("--devloop-only", action="store_true",
                    help="build, then only B2's checks (phase 2's "
                    "partition part), the HIGGS path and phase 8 (the "
                    "captured split step, iteration batching), and exit "
                    "without a result")
    ap.add_argument("--pertree-only", action="store_true",
                    help="build, then only B1's and B2's checks (phase 2's "
                    "part), the HIGGS path, (l)'s data and phase 9 (the "
                    "per-tree path captured, forced splits without reads), "
                    "and exit without a result")
    ap.add_argument("--profile", action="store_true",
                    help="only profile one iteration of each path and exit")
    ap.add_argument("--profile-paths",
                    default="higgs,a,b,c,d,e,f,g,h,i,j,k,l,m,n,v",
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

    if args.multi_gpu_only:
        multi_gpu_paths(args, None)
        return 0     # prints no smoke result
    if args.robust_only:
        robust_paths(args, [])
        return 0     # prints no smoke result
    if args.pipeline_only:
        higgs = higgs_base(args)
        pipeline_paths(args, higgs)
        with tempfile.TemporaryDirectory() as tmp:
            warmup_paths(args, tmp)
        return 0     # prints no smoke result
    if args.devloop_only:
        check_hist(torch.device("cuda"), [])
        check_partition(torch.device("cuda"), [])
        higgs = higgs_base(args)
        devloop_paths(args, higgs)
        return 0     # prints no smoke result
    if args.pertree_only:
        check_hist(torch.device("cuda"), [])
        check_partition(torch.device("cuda"), [])
        higgs = higgs_base(args)
        higgs["mc"] = mc_data(args.rows, 1000, "cuda")[0]
        t9 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            pertree_paths(args, higgs, tmp=tmp)
        log(f"phase 9: {time.perf_counter() - t9:.1f} s; all done at "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0     # prints no smoke result
    if args.obs_only:
        obs_higgs(args, [])
        with tempfile.TemporaryDirectory() as tmp:
            hang_drills(tmp)
        multi_gpu_paths(args, None)
        return 0     # prints no smoke result
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
    marks = [t_start]

    def done(phase):
        marks.append(time.perf_counter())
        log(f"phase {phase} done at {marks[-1] - t_start:.1f} s "
            f"({marks[-1] - marks[-2]:.1f} s)")
    done("1-2")
    higgs_auc, higgs = paths(args, report, wide)
    done(3)
    y_launches = multi_gpu_paths(args, higgs_auc)
    for r in report:
        if r["name"] in ("hist_planar", "partition"):
            r["launches"] += y_launches[r["name"]]
    done("3b")
    with tempfile.TemporaryDirectory() as tmp:
        card_vs_cpu(write_forced_splits(tmp))
        api_card_vs_cpu(tmp)
    done(4)
    robust_paths(args, report)
    done(5)
    # phase 6 after phase 5: its profiler session and its implicit-sync
    # probe leave no state behind that an earlier phase could trip on
    obs_higgs(args, report, higgs)
    done("6 (ae)")
    p7 = pipeline_paths(args, higgs)
    for r in report:
        if r["name"] in ("hist_planar", "partition"):
            r["launches"] += p7[r["name"]]
    with tempfile.TemporaryDirectory() as tmp:
        warmup_paths(args, tmp)
    done(7)
    p8 = devloop_paths(args, higgs)
    for r in report:
        if r["name"] in ("hist_planar", "partition"):
            r["launches"] += p8[r["name"]]
    done(8)
    with tempfile.TemporaryDirectory() as tmp:
        p9 = pertree_paths(args, higgs, tmp=tmp)
    for r in report:
        if r["name"] in ("hist_planar", "partition"):
            r["launches"] += p9.get(r["name"], 0)
    del higgs
    done(9)
    log(f"all phases done in {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
