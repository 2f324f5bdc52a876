"""Packed-forest batch inference, with prediction early stop.

The port of the JAX package's models/forest.py (the re-design of the
reference prediction stack: src/boosting/gbdt_prediction.cpp PredictRaw,
and src/boosting/prediction_early_stop.cpp's margin-based early stop).
Every tree's flat node arrays are stacked into ``[T, Nmax]`` tensors on
the device once, the stack padded to a multiple of ``TREE_BLOCK`` with
no-op stumps (root -1: every row lands in leaf 0, value 0). Blocks of
64 trees walk in lockstep, one masked step per level for all rows of
all 64 trees (ops/traverse.py's decision rules). Categorical splits
read ONE concatenated bitset pool through per-tree family offsets, the
layout of the reference's cat_boundaries_ (tree.h).

The sums keep the JAX package's float32 association, so the raw scores
are its bits: ``raw_scores`` adds the ``[Tpad]`` leaf values of a row in
the order of XLA:CPU's ``jnp.sum`` (``ops.split.xla_sum``: windows of 32
trees); ``raw_scores_early_stop`` adds each tree's value in turn and
checks the margin every ``freq`` iterations (binary: 2|score|, more
classes: top1 - top2); a row whose margin passed adds nothing more.

Plain PyTorch: the JAX module holds no Pallas kernel.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.split import xla_sum
from ..ops.traverse import bitset_lookup, raw_go_left, tree_depth
from .tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK


class PackedForest:
    """Stacked device tensors for a list of host Trees."""

    TREE_BLOCK = 64

    def __init__(self, trees: Sequence, num_classes: int, device) -> None:
        self.device = torch.device(device)
        self.num_trees = len(trees)
        self.num_classes = num_classes
        t = -(-max(self.num_trees, 1) // self.TREE_BLOCK) * self.TREE_BLOCK
        nmax = max([max(tr.num_leaves - 1, 1) for tr in trees] or [1])
        lmax = max([max(tr.num_leaves, 1) for tr in trees] or [1])

        split_feature = np.zeros((t, nmax), np.int64)
        # the split threshold as float32, as the JAX package packs it:
        # a row goes left iff its float32 value <= this float32
        threshold = np.zeros((t, nmax), np.float32)
        left = np.full((t, nmax), -1, np.int64)
        right = np.full((t, nmax), -1, np.int64)
        default_left = np.zeros((t, nmax), bool)
        missing_type = np.zeros((t, nmax), np.int64)
        is_cat = np.zeros((t, nmax), bool)
        cat_idx = np.zeros((t, nmax), np.int64)
        leaf_value = np.zeros((t, lmax), np.float32)
        root = np.zeros(t, np.int64)
        root[self.num_trees:] = -1
        depth = np.zeros(t, np.int64)

        words: List[int] = []
        fam_bounds: List[int] = [0]
        for i, tr in enumerate(trees):
            n = tr.num_leaves - 1
            leaf_value[i, :tr.num_leaves] = tr.leaf_value[:tr.num_leaves]
            if n <= 0:
                root[i] = -1
                continue
            split_feature[i, :n] = tr.split_feature[:n]
            threshold[i, :n] = tr.threshold[:n]
            left[i, :n] = tr.left_child[:n]
            right[i, :n] = tr.right_child[:n]
            dt = tr.decision_type[:n].astype(np.int64)
            default_left[i, :n] = (dt & K_DEFAULT_LEFT_MASK) != 0
            missing_type[i, :n] = (dt >> 2) & 3
            is_cat[i, :n] = (dt & K_CATEGORICAL_MASK) != 0
            # the tree's family index -> the pool's
            cat_idx[i, :n] = (np.asarray(tr.threshold_in_bin[:n], np.int64)
                              + len(fam_bounds) - 1)
            bounds = list(tr.cat_boundaries or [0])
            for a, b in zip(bounds[:-1], bounds[1:]):
                fam_bounds.append(fam_bounds[-1] + (b - a))
            words.extend(int(w) & 0xFFFFFFFF for w in tr.cat_threshold)
            depth[i] = tree_depth(tr.left_child, tr.right_child, n)

        def dv(a):
            return torch.as_tensor(a, device=self.device)
        self.split_feature, self.threshold = dv(split_feature), dv(threshold)
        self.left, self.right = dv(left), dv(right)
        self.default_left, self.missing_type = (dv(default_left),
                                                dv(missing_type))
        self.is_cat, self.cat_idx = dv(is_cat), dv(cat_idx)
        self.leaf_value, self.root = dv(leaf_value), dv(root)
        self.has_cat = bool(is_cat.any())
        self.cat_bitset = dv(np.asarray(words or [0], np.int64))
        # one trailing bound: the last family's end, read as cat_idx + 1
        self.cat_boundaries = dv(np.asarray(fam_bounds + [fam_bounds[-1]],
                                            np.int64))
        self.num_features = int(split_feature.max()) + 1
        # levels each block of TREE_BLOCK trees walks
        self._block_depth = depth.reshape(-1, self.TREE_BLOCK).max(axis=1)
        self._tree_depth = depth

    # ------------------------------------------------------------------
    def _input(self, x: torch.Tensor) -> torch.Tensor:
        """x as float32 [N, >= num_features] on the forest's device."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        if x.shape[1] < self.num_features:
            x = torch.nn.functional.pad(x, (0, self.num_features - x.shape[1]))
        return x

    def _leaves(self, x: torch.Tensor, lo: int, hi: int, depth: int
                ) -> torch.Tensor:
        """[hi - lo, N] leaf index of every row in trees lo..hi-1, which
        walk in lockstep for ``depth`` levels."""
        n = x.shape[0]
        xt = x.t()
        node = self.root[lo:hi, None].expand(hi - lo, n).clone()
        sl = slice(lo, hi)
        for _ in range(depth):
            nid = torch.clamp(node, min=0)

            def at(a):
                return torch.gather(a[sl], 1, nid)
            f = at(self.split_feature)
            v = torch.gather(xt, 0, f)
            is_cat = at(self.is_cat) if self.has_cat else None
            ci = at(self.cat_idx) if self.has_cat else None
            go_left = raw_go_left(
                v, at(self.threshold), at(self.missing_type),
                at(self.default_left), is_cat,
                lambda iv: bitset_lookup(self.cat_bitset,
                                         self.cat_boundaries, ci, iv))
            nxt = torch.where(go_left, at(self.left), at(self.right))
            node = torch.where(node < 0, node, nxt)
        return -node - 1

    def _blocks(self, x: torch.Tensor):
        """(lo, hi, [hi - lo, N] leaves) per block of TREE_BLOCK trees."""
        for bi, d in enumerate(self._block_depth):
            lo = bi * self.TREE_BLOCK
            hi = lo + self.TREE_BLOCK
            yield lo, hi, self._leaves(x, lo, hi, int(d))

    def _values(self, leaves: torch.Tensor, lo: int, hi: int
                ) -> torch.Tensor:
        return torch.gather(self.leaf_value[lo:hi], 1, leaves)

    # ------------------------------------------------------------------
    def raw_scores(self, x) -> torch.Tensor:
        """[num_classes, N] float32 raw scores."""
        x = self._input(x)
        k = max(self.num_classes, 1)
        n = x.shape[0]
        if k == 1:
            # each block of 64 trees is two of xla_sum's 32-tree windows
            parts = []
            for lo, hi, leaves in self._blocks(x):
                vals = self._values(leaves, lo, hi).t()           # [N, 64]
                parts.append(xla_sum(vals.reshape(n, -1, 32)))
            return xla_sum(torch.cat(parts, dim=1))[None, :]
        # the JAX package's scatter-add: each class's trees in order
        score = torch.zeros((k, n), dtype=torch.float32, device=self.device)
        for lo, hi, leaves in self._blocks(x):
            vals = self._values(leaves, lo, hi)
            for j in range(hi - lo):
                score[(lo + j) % k] += vals[j]
        return score

    def leaf_indices(self, x) -> torch.Tensor:
        """[N, T] int32 leaf index of every row in every tree (reference
        PredictLeafIndex)."""
        x = self._input(x)
        leaves = torch.cat([lv for _, _, lv in self._blocks(x)], dim=0)
        return leaves[:self.num_trees].t().to(torch.int32)

    def raw_scores_early_stop(self, x, freq: int, margin: float
                              ) -> torch.Tensor:
        """Early-stopped raw scores (reference prediction_early_stop.cpp):
        every ``freq`` boosting iterations, rows whose margin exceeds
        ``margin`` stop accumulating trees (binary: 2|score|, more
        classes: top1 - top2). The trees are walked a block at a time;
        once every row has stopped (one read per block), the rest are
        skipped."""
        x = self._input(x)
        k = max(self.num_classes, 1)
        n = x.shape[0]
        iters = self.num_trees // k
        score = torch.zeros((k, n), dtype=torch.float32, device=self.device)
        done = torch.zeros(n, dtype=torch.bool, device=self.device)

        def margin_of(s):
            if k == 1:
                return 2.0 * torch.abs(s[0])
            top2 = torch.topk(s.t(), 2, dim=1).values
            return top2[:, 0] - top2[:, 1]

        it = 0
        for bi in range(len(self._block_depth)):
            lo = bi * self.TREE_BLOCK
            hi = min(lo + self.TREE_BLOCK, iters * k)
            if lo >= hi:
                break
            depth = int(self._tree_depth[lo:hi].max())
            vals = self._values(self._leaves(x, lo, hi, depth), lo, hi)
            for j in range(hi - lo):
                t = lo + j
                score[t % k] += torch.where(done, 0.0, vals[j])
                if t % k == k - 1:
                    it += 1
                    if it % freq == 0:
                        done = done | (margin_of(score) > margin)
            if bool(done.all()):
                break
        return score
