"""Monotone-constraint bookkeeping for the leaf-wise grower.

The port's copy of the JAX package's treelearner/monotone.py (plain
numpy, unchanged). Host-side port of the reference constraint machinery
(reference:
src/treelearner/monotone_constraints.hpp — BasicLeafConstraints :85,
IntermediateLeafConstraints :125, ComputeMonotoneSplitGainPenalty :67).
This logic walks the ~num_leaves-sized tree skeleton, so it stays on
the host (it is O(leaves·depth) pointer chasing, not array math); the
resulting [cmin, cmax] bounds feed the device split scan.

- ``basic``: children of a monotone split are clamped to the midpoint
  of the two outputs; no other leaf is touched.
- ``intermediate``: children are clamped by the actual sibling outputs
  (tighter), and every already-grown leaf CONTIGUOUS with the new
  split (found by walking up from the split and down the opposite
  branches) gets its bound tightened too; those leaves' best splits
  must be recomputed by the caller.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

K_EPSILON = 1e-15


def monotone_penalty_factor(depth: int, penalization: float) -> float:
    """ComputeMonotoneSplitGainPenalty (monotone_constraints.hpp:67)."""
    if penalization >= depth + 1.0:
        return K_EPSILON
    if penalization <= 1.0:
        return 1.0 - penalization / math.pow(2.0, depth) + K_EPSILON
    return 1.0 - math.pow(2.0, penalization - 1.0 - depth) + K_EPSILON


class MonotoneState:
    """Per-tree constraint entries, reset by the grower each tree."""

    def __init__(self, method: str, num_leaves: int,
                 monotone_of_inner: np.ndarray) -> None:
        self.method = method
        self.num_leaves = num_leaves
        self.monotone = monotone_of_inner
        self.cmin = np.full(num_leaves, -np.inf)
        self.cmax = np.full(num_leaves, np.inf)
        self.node_parent = np.full(max(num_leaves - 1, 1), -1, np.int32)
        self.in_monotone_subtree = np.zeros(num_leaves, bool)

    # -- hooks ----------------------------------------------------------
    def before_split(self, tree, leaf: int, mono_type: int) -> None:
        """Must run BEFORE tree.split (records the pre-split parent;
        reference BeforeSplit, :141)."""
        if self.method != "intermediate":
            return
        new_leaf = tree.num_leaves
        if mono_type != 0 or self.in_monotone_subtree[leaf]:
            self.in_monotone_subtree[leaf] = True
            self.in_monotone_subtree[new_leaf] = True
        self.node_parent[new_leaf - 1] = tree.leaf_parent[leaf]

    def update(self, tree, leaf: int, new_leaf: int, mono_type: int,
               is_numerical: bool, left_output: float, right_output: float,
               split_feature_inner: int, split_threshold: int,
               leaf_has_candidate) -> List[int]:
        """Runs AFTER tree.split; tightens the two children's entries
        and (intermediate) returns other leaf ids whose bounds changed
        (reference Update, :85-116 basic / :170-200 intermediate)."""
        self.cmin[new_leaf] = self.cmin[leaf]
        self.cmax[new_leaf] = self.cmax[leaf]
        if not is_numerical:
            return []
        if self.method != "intermediate":
            if mono_type != 0:
                mid = (left_output + right_output) / 2.0
                if mono_type < 0:
                    self.cmin[leaf] = max(self.cmin[leaf], mid)
                    self.cmax[new_leaf] = min(self.cmax[new_leaf], mid)
                else:
                    self.cmax[leaf] = min(self.cmax[leaf], mid)
                    self.cmin[new_leaf] = max(self.cmin[new_leaf], mid)
            return []

        if not self.in_monotone_subtree[leaf]:
            return []
        # children tightened by the sibling's actual output (:155-168)
        if mono_type < 0:
            self.cmin[leaf] = max(self.cmin[leaf], right_output)
            self.cmax[new_leaf] = min(self.cmax[new_leaf], left_output)
        elif mono_type > 0:
            self.cmax[leaf] = min(self.cmax[leaf], right_output)
            self.cmin[new_leaf] = max(self.cmin[new_leaf], left_output)

        self._to_update: List[int] = []
        self._feat_up: List[int] = []
        self._thr_up: List[int] = []
        self._was_right: List[bool] = []
        self._go_up(tree, tree.leaf_parent[new_leaf], split_feature_inner,
                    split_threshold, left_output, right_output,
                    leaf_has_candidate)
        return self._to_update

    # -- the contiguity walk (GoUpToFindLeavesToUpdate, :234) -----------
    def _go_up(self, tree, node_idx: int, split_feature: int,
               split_threshold: int, left_output: float, right_output: float,
               leaf_has_candidate) -> None:
        parent = int(self.node_parent[node_idx])
        if parent < 0:
            return
        inner = int(tree.split_feature_inner[parent])
        mono = int(self.monotone[inner]) if inner < len(self.monotone) else 0
        is_right = int(tree.right_child[parent]) == node_idx
        is_numerical = (tree.decision_type[parent] & 1) == 0

        opposite_should_update = True
        if is_numerical:
            for f_up, was_r in zip(self._feat_up, self._was_right):
                if f_up == inner and was_r == is_right:
                    opposite_should_update = False
                    break

        if opposite_should_update:
            if mono != 0:
                left_idx = int(tree.left_child[parent])
                right_idx = int(tree.right_child[parent])
                cur_is_left = left_idx == node_idx
                opposite = right_idx if cur_is_left else left_idx
                update_max = cur_is_left if mono < 0 else not cur_is_left
                self._go_down(tree, opposite, update_max, split_feature,
                              split_threshold, left_output, right_output,
                              True, True, leaf_has_candidate)
            self._was_right.append(is_right)
            self._thr_up.append(int(tree.threshold_in_bin[parent]))
            self._feat_up.append(inner)

        self._go_up(tree, parent, split_feature, split_threshold,
                    left_output, right_output, leaf_has_candidate)

    def _go_down(self, tree, node_idx: int, update_max: bool,
                 split_feature: int, split_threshold: int,
                 left_output: float, right_output: float,
                 use_left: bool, use_right: bool, leaf_has_candidate) -> None:
        """GoDownToFindLeavesToUpdate (:310)."""
        if node_idx < 0:
            leaf_idx = ~node_idx
            if not leaf_has_candidate(leaf_idx):
                return
            if use_left and use_right:
                lo, hi = sorted((left_output, right_output))
            elif use_right:
                lo = hi = right_output
            else:
                lo = hi = left_output
            changed = False
            if not update_max:
                if hi > self.cmin[leaf_idx]:
                    self.cmin[leaf_idx] = hi
                    changed = True
            else:
                if lo < self.cmax[leaf_idx]:
                    self.cmax[leaf_idx] = lo
                    changed = True
            if changed and leaf_idx not in self._to_update:
                self._to_update.append(leaf_idx)
            return

        keep_left, keep_right = self._keep_going(tree, node_idx)
        inner = int(tree.split_feature_inner[node_idx])
        thr = int(tree.threshold_in_bin[node_idx])
        is_numerical = (tree.decision_type[node_idx] & 1) == 0
        use_left_for_right = True
        use_right_for_left = True
        if is_numerical and inner == split_feature:
            if thr >= split_threshold:
                use_left_for_right = False
            if thr <= split_threshold:
                use_right_for_left = False
        if keep_left:
            self._go_down(tree, int(tree.left_child[node_idx]), update_max,
                          split_feature, split_threshold, left_output,
                          right_output, use_left,
                          use_right_for_left and use_right, leaf_has_candidate)
        if keep_right:
            self._go_down(tree, int(tree.right_child[node_idx]), update_max,
                          split_feature, split_threshold, left_output,
                          right_output, use_left_for_right and use_left,
                          use_right, leaf_has_candidate)

    def _keep_going(self, tree, node_idx: int) -> Tuple[bool, bool]:
        """ShouldKeepGoingLeftRight (:423)."""
        inner = int(tree.split_feature_inner[node_idx])
        thr = int(tree.threshold_in_bin[node_idx])
        is_numerical = (tree.decision_type[node_idx] & 1) == 0
        keep_left = keep_right = True
        if is_numerical:
            for f_up, t_up, was_r in zip(self._feat_up, self._thr_up,
                                         self._was_right):
                if f_up != inner:
                    continue
                if thr >= t_up and not was_r:
                    keep_right = False
                if thr <= t_up and was_r:
                    keep_left = False
                if not keep_left and not keep_right:
                    break
        return keep_left, keep_right
