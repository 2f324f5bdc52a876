"""TreeSHAP feature contributions.

Behavioral equivalent of the reference Tree::PredictContrib
(reference: include/LightGBM/tree.h:138 + the TreeSHAP recursion in
src/io/tree.cpp — the Lundberg & Lee path-dependent algorithm with
EXTEND/UNWIND over the unique decision path, and the count-weighted
ExpectedValue in the bias slot).

The JAX package's host design, kept: a per-row recursion over each tree
in float64. Its operations run here in the same order on Python floats
(IEEE doubles, as numpy's float64 scalars), over the tree's arrays read
into lists once per tree, so the values are the JAX package's bit for
bit at a fraction of the interpreter's cost. SHAP is an inference-time
explanation path, off the training loop.
"""
from __future__ import annotations

import numpy as np

from .tree import K_DEFAULT_LEFT_MASK, Tree, _in_bitset


class _TreeLists:
    """A tree's arrays as Python lists (one read per tree)."""

    def __init__(self, tree: Tree) -> None:
        n = max(tree.num_nodes, 0)
        self.split_feature = [int(v) for v in tree.split_feature[:n]]
        self.threshold = [float(v) for v in tree.threshold[:n]]
        self.decision_type = [int(v) for v in tree.decision_type[:n]]
        self.left = [int(v) for v in tree.left_child[:n]]
        self.right = [int(v) for v in tree.right_child[:n]]
        self.internal_count = [float(v) for v in tree.internal_count[:n]]
        self.leaf_count = [float(v) for v in tree.leaf_count[:tree.num_leaves]]
        self.leaf_value = [float(v) for v in tree.leaf_value[:tree.num_leaves]]
        self.words = {}
        for node in range(n):
            if tree.is_categorical_node(node):
                cat_idx = int(tree.threshold[node])
                self.words[node] = list(tree.cat_threshold[
                    tree.cat_boundaries[cat_idx]:
                    tree.cat_boundaries[cat_idx + 1]])

    def goes_left(self, node: int, row) -> bool:
        """Same routing as Tree.predict_row for one node."""
        v = row[self.split_feature[node]]
        words = self.words.get(node)
        if words is not None:
            if v != v:
                return False
            iv = int(v)
            if iv < 0:
                return False
            return _in_bitset(words, iv)
        mt = (self.decision_type[node] >> 2) & 3
        fv = v
        if fv != fv and mt != 2:
            fv = 0.0
        if (mt == 1 and abs(fv) <= 1e-35) or (mt == 2 and fv != fv):
            return bool(self.decision_type[node] & K_DEFAULT_LEFT_MASK)
        return fv <= self.threshold[node]

    def count(self, child: int) -> float:
        return self.leaf_count[~child] if child < 0 \
            else self.internal_count[child]


def _extend(feat, zero, one, pw, unique_depth, zero_fraction, one_fraction,
            feature_index) -> None:
    feat[unique_depth] = feature_index
    zero[unique_depth] = zero_fraction
    one[unique_depth] = one_fraction
    pw[unique_depth] = 1.0 if unique_depth == 0 else 0.0
    for i in range(unique_depth - 1, -1, -1):
        pw[i + 1] += one_fraction * pw[i] * (i + 1) / (unique_depth + 1)
        pw[i] = zero_fraction * pw[i] * (unique_depth - i) \
            / (unique_depth + 1)


def _unwind(feat, zero, one, pw, unique_depth, path_index) -> None:
    one_fraction = one[path_index]
    zero_fraction = zero[path_index]
    next_one_portion = pw[unique_depth]
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = pw[i]
            pw[i] = next_one_portion * (unique_depth + 1) \
                / ((i + 1) * one_fraction)
            next_one_portion = tmp - pw[i] * zero_fraction \
                * (unique_depth - i) / (unique_depth + 1)
        else:
            pw[i] = pw[i] * (unique_depth + 1) \
                / (zero_fraction * (unique_depth - i))
    for i in range(path_index, unique_depth):
        feat[i] = feat[i + 1]
        zero[i] = zero[i + 1]
        one[i] = one[i + 1]


def _unwound_sum(zero, one, pw, unique_depth, path_index) -> float:
    one_fraction = one[path_index]
    zero_fraction = zero[path_index]
    next_one_portion = pw[unique_depth]
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (unique_depth + 1) \
                / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = pw[i] - tmp * zero_fraction \
                * (unique_depth - i) / (unique_depth + 1)
        else:
            total += pw[i] / (zero_fraction * (unique_depth - i)
                              / (unique_depth + 1))
    return total


def expected_value(tree: Tree) -> float:
    """Count-weighted mean output (reference Tree::ExpectedValue)."""
    if tree.num_leaves == 1:
        return float(tree.leaf_value[0])
    total = float(tree.internal_count[0])
    k = tree.num_leaves
    return float(np.sum(tree.leaf_count[:k] * tree.leaf_value[:k]) / total)


def _tree_shap_row(t: _TreeLists, row, phi, node: int, unique_depth: int,
                   parent, parent_zero_fraction: float,
                   parent_one_fraction: float,
                   parent_feature_index: int) -> None:
    n = unique_depth + 2
    feat = parent[0][:unique_depth] + [0] * (n - unique_depth)
    zero = parent[1][:unique_depth] + [0.0] * (n - unique_depth)
    one = parent[2][:unique_depth] + [0.0] * (n - unique_depth)
    pw = parent[3][:unique_depth] + [0.0] * (n - unique_depth)
    _extend(feat, zero, one, pw, unique_depth, parent_zero_fraction,
            parent_one_fraction, parent_feature_index)

    if node < 0:  # leaf
        value = t.leaf_value[~node]
        for i in range(1, unique_depth + 1):
            w = _unwound_sum(zero, one, pw, unique_depth, i)
            phi[feat[i]] += w * (one[i] - zero[i]) * value
        return

    if t.goes_left(node, row):
        hot, cold = t.left[node], t.right[node]
    else:
        hot, cold = t.right[node], t.left[node]
    w_node = t.internal_count[node]
    hot_count = t.count(hot)
    cold_count = t.count(cold)

    incoming_zero_fraction = 1.0
    incoming_one_fraction = 1.0
    split_index = t.split_feature[node]
    # undo previous extension if we have already seen this feature
    path_index = 1
    while path_index <= unique_depth:
        if feat[path_index] == split_index:
            break
        path_index += 1
    if path_index != unique_depth + 1:
        incoming_zero_fraction = zero[path_index]
        incoming_one_fraction = one[path_index]
        _unwind(feat, zero, one, pw, unique_depth, path_index)
        unique_depth -= 1

    path = (feat, zero, one, pw)
    _tree_shap_row(t, row, phi, hot, unique_depth + 1, path,
                   hot_count / w_node * incoming_zero_fraction,
                   incoming_one_fraction, split_index)
    _tree_shap_row(t, row, phi, cold, unique_depth + 1, path,
                   cold_count / w_node * incoming_zero_fraction, 0.0,
                   split_index)


def tree_shap(tree: Tree, x: np.ndarray) -> np.ndarray:
    """SHAP contributions for a batch: [N, num_total_features + 1]
    (last column = expected value / bias)."""
    n = x.shape[0]
    out = np.zeros((n, x.shape[1] + 1))
    out[:, -1] = expected_value(tree)
    if tree.num_nodes == 0:
        return out
    t = _TreeLists(tree)
    root = ([0], [0.0], [0.0], [0.0])
    rows = np.asarray(x, dtype=np.float64).tolist()
    for r in range(n):
        phi = [0.0] * x.shape[1]
        _tree_shap_row(t, rows[r], phi, 0, 0, root, 1.0, 1.0, -1)
        out[r, :-1] = phi
    return out

