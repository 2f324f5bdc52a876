"""Flat-array decision tree model.

Mirrors the reference Tree (reference: include/LightGBM/tree.h:25,
src/io/tree.cpp): parallel flat arrays indexed by internal-node id, with
LightGBM's ``~leaf_index`` negative encoding for leaf children, the
``decision_type`` bitfield (kCategoricalMask=1, kDefaultLeftMask=2,
missing type in bits 2-3, tree.h:19-20,:247-253), and the model text
format of Tree::ToString (src/io/tree.cpp:223-260) so saved models are
line-compatible with reference tooling.

This is the port's copy of the JAX package's models/tree.py: the model
text it writes is byte-identical for the same values. The traversal
bridges (``leaf_index_binned``, ``leaf_index_raw``) walk the tree on a
device through ops/traverse.py; batch prediction over many trees is
models/forest.py and models/pathforest.py.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.traverse import (traverse_binned, traverse_raw, tree_depth,
                             words_tensor)

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2


def _fmt(x: float) -> str:
    """Shortest round-trip float formatting (reference
    Common::ArrayToString uses max digits; match readability)."""
    return repr(float(x))


class Tree:
    """Growable flat tree (reference tree.h:25; Split at tree.h:61)."""

    def __init__(self, max_leaves: int, track_branch_features: bool = False) -> None:
        m = max(max_leaves, 1)
        self.max_leaves = m
        self.num_leaves = 1
        self.num_cat = 0
        self.shrinkage = 1.0
        # internal nodes [m-1]
        self.left_child = np.zeros(max(m - 1, 1), dtype=np.int32)
        self.right_child = np.zeros(max(m - 1, 1), dtype=np.int32)
        self.split_feature_inner = np.zeros(max(m - 1, 1), dtype=np.int32)
        self.split_feature = np.zeros(max(m - 1, 1), dtype=np.int32)
        self.threshold_in_bin = np.zeros(max(m - 1, 1), dtype=np.int32)
        self.threshold = np.zeros(max(m - 1, 1), dtype=np.float64)
        self.decision_type = np.zeros(max(m - 1, 1), dtype=np.int8)
        self.split_gain = np.zeros(max(m - 1, 1), dtype=np.float32)
        self.internal_value = np.zeros(max(m - 1, 1), dtype=np.float64)
        self.internal_weight = np.zeros(max(m - 1, 1), dtype=np.float64)
        self.internal_count = np.zeros(max(m - 1, 1), dtype=np.int32)
        # leaves [m]
        self.leaf_value = np.zeros(m, dtype=np.float64)
        self.leaf_weight = np.zeros(m, dtype=np.float64)
        self.leaf_count = np.zeros(m, dtype=np.int32)
        self.leaf_parent = np.full(m, -1, dtype=np.int32)
        self.leaf_depth = np.zeros(m, dtype=np.int32)
        # categorical bitset pools
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []
        self.track_branch_features = track_branch_features
        self.branch_features: List[List[int]] = [[] for _ in range(m)] if track_branch_features else []

    # ------------------------------------------------------------------
    def _split_common(self, leaf: int, feature: int, real_feature: int,
                      left_value: float, right_value: float, left_cnt: int,
                      right_cnt: int, left_weight: float, right_weight: float,
                      gain: float) -> int:
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature
        self.split_feature[new_node] = real_feature
        self.split_gain[new_node] = gain
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        self.internal_weight[new_node] = self.leaf_weight[leaf]
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_value[leaf] = 0.0 if math.isnan(left_value) else left_value
        self.leaf_weight[leaf] = left_weight
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[self.num_leaves] = 0.0 if math.isnan(right_value) else right_value
        self.leaf_weight[self.num_leaves] = right_weight
        self.leaf_count[self.num_leaves] = right_cnt
        self.leaf_depth[self.num_leaves] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        if self.track_branch_features:
            self.branch_features[self.num_leaves] = list(self.branch_features[leaf])
            self.branch_features[self.num_leaves].append(real_feature)
            self.branch_features[leaf].append(real_feature)
        return new_node

    def split(self, leaf: int, feature: int, real_feature: int,
              threshold_bin: int, threshold_double: float, left_value: float,
              right_value: float, left_cnt: int, right_cnt: int,
              left_weight: float, right_weight: float, gain: float,
              missing_type: int, default_left: bool) -> int:
        """Numerical split (reference tree.cpp:54-68). Returns new right
        leaf index."""
        new_node = self._split_common(leaf, feature, real_feature, left_value,
                                      right_value, left_cnt, right_cnt,
                                      left_weight, right_weight, gain)
        dt = 0
        if default_left:
            dt |= K_DEFAULT_LEFT_MASK
        dt |= (int(missing_type) & 3) << 2
        self.decision_type[new_node] = dt
        self.threshold_in_bin[new_node] = threshold_bin
        self.threshold[new_node] = threshold_double
        self.num_leaves += 1
        return self.num_leaves - 1

    def split_categorical(self, leaf: int, feature: int, real_feature: int,
                          threshold_bins: Sequence[int],
                          threshold_cats: Sequence[int], left_value: float,
                          right_value: float, left_cnt: int, right_cnt: int,
                          left_weight: float, right_weight: float, gain: float,
                          missing_type: int) -> int:
        """Categorical split (reference tree.cpp:70-91): bitsets of bin
        ids (inner) and raw category values are appended to the pools."""
        new_node = self._split_common(leaf, feature, real_feature, left_value,
                                      right_value, left_cnt, right_cnt,
                                      left_weight, right_weight, gain)
        dt = K_CATEGORICAL_MASK | ((int(missing_type) & 3) << 2)
        self.decision_type[new_node] = dt
        self.threshold_in_bin[new_node] = self.num_cat
        self.threshold[new_node] = self.num_cat
        self.num_cat += 1
        bits_inner = _to_bitset(threshold_bins)
        bits_raw = _to_bitset(threshold_cats)
        self.cat_boundaries_inner.append(self.cat_boundaries_inner[-1] + len(bits_inner))
        self.cat_threshold_inner.extend(bits_inner)
        self.cat_boundaries.append(self.cat_boundaries[-1] + len(bits_raw))
        self.cat_threshold.extend(bits_raw)
        self.num_leaves += 1
        return self.num_leaves - 1

    # ------------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self.num_leaves - 1

    def missing_type(self, node: int) -> int:
        return (int(self.decision_type[node]) >> 2) & 3

    def default_left(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_DEFAULT_LEFT_MASK)

    def is_categorical_node(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_CATEGORICAL_MASK)

    def apply_shrinkage(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:187)."""
        k = self.num_leaves
        self.leaf_value[:k] *= rate
        self.internal_value[:max(k - 1, 0)] *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """Tree::AddBias (tree.h:200)."""
        k = self.num_leaves
        self.leaf_value[:k] += val
        self.internal_value[:max(k - 1, 0)] += val
        self.shrinkage = 1.0

    def set_leaf_value(self, leaf: int, value: float) -> None:
        self.leaf_value[leaf] = value

    # ------------------------------------------------------------------
    # traversal bridges (ops/traverse.py), on the device of the rows
    # ------------------------------------------------------------------
    def _node_tensors(self, dev, names):
        """The internal nodes' arrays ``names`` (fields, or the
        decision-type flags default_left / is_cat) as tensors on
        ``dev``."""
        n = self.num_nodes
        dt = self.decision_type[:n]
        out = {"default_left": (dt & K_DEFAULT_LEFT_MASK) != 0,
               "is_cat": (dt & K_CATEGORICAL_MASK) != 0}
        return [torch.as_tensor(np.asarray(out[k] if k in out
                                           else getattr(self, k)[:n]),
                                device=dev) for k in names]

    def leaf_index_binned(self, bins, feature_to_miss_bin, efb=None):
        """Leaf index [N] (int64) of every row of ``bins`` ([N, G] bin
        codes on a device) by bin-space traversal (train time; reference
        Tree::AddPredictionToScore). ``feature_to_miss_bin`` [F] routes a
        feature's missing bin by default_left (-1: none); categorical
        nodes test the inner (bin-space) bitsets. ``efb`` decodes bundle
        codes."""
        n = self.num_nodes
        dev = bins.device
        if n <= 0:
            return torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
        sf, thr, left, right, dl, is_cat = self._node_tensors(dev, (
            "split_feature_inner", "threshold_in_bin", "left_child",
            "right_child", "default_left", "is_cat"))
        sf, thr = sf.long(), thr.long()
        miss = torch.as_tensor(feature_to_miss_bin, device=dev).long()[sf]
        # categorical nodes have no missing-bin routing in bin space
        miss = torch.where(is_cat, -1, miss)
        bounds = self.cat_boundaries_inner + [self.cat_boundaries_inner[-1]]
        return traverse_binned(
            bins, sf, thr, left.long(), right.long(), dl, miss, is_cat,
            words_tensor(self.cat_threshold_inner, dev),
            torch.as_tensor(np.asarray(bounds, np.int64), device=dev),
            tree_depth(self.left_child, self.right_child, n), efb=efb)

    def leaf_index_raw(self, x):
        """Leaf index [N] (int64) of every row of ``x`` ([N, F] float32
        raw features on a device; reference Tree::PredictLeafIndex)."""
        n = self.num_nodes
        dev = x.device
        if n <= 0:
            return torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
        sf, left, right, dl, is_cat, cat_idx = self._node_tensors(dev, (
            "split_feature", "left_child", "right_child", "default_left",
            "is_cat", "threshold_in_bin"))
        thr = torch.as_tensor(self.threshold[:n].astype(np.float32),
                              device=dev)
        mt = torch.as_tensor((self.decision_type[:n].astype(np.int64) >> 2)
                             & 3, device=dev)
        bounds = self.cat_boundaries + [self.cat_boundaries[-1]]
        return traverse_raw(
            x.to(torch.float32), sf.long(), thr, left.long(), right.long(),
            dl, mt, is_cat, words_tensor(self.cat_threshold, dev),
            torch.as_tensor(np.asarray(bounds, np.int64), device=dev),
            cat_idx.long(), tree_depth(self.left_child, self.right_child, n))

    # ------------------------------------------------------------------
    # serialization (reference Tree::ToString, src/io/tree.cpp:223)
    # ------------------------------------------------------------------
    def to_string(self) -> str:
        k = self.num_leaves
        ni = max(k - 1, 0)
        lines = [f"num_leaves={k}", f"num_cat={self.num_cat}"]

        def arr(name, a, n, fmt=str):
            lines.append(name + "=" + " ".join(fmt(v) for v in a[:n]))

        arr("split_feature", self.split_feature, ni)
        arr("split_gain", self.split_gain, ni, lambda v: _fmt(v))
        arr("threshold", self.threshold, ni, lambda v: _fmt(v))
        arr("decision_type", self.decision_type, ni)
        arr("left_child", self.left_child, ni)
        arr("right_child", self.right_child, ni)
        arr("leaf_value", self.leaf_value, k, lambda v: _fmt(v))
        arr("leaf_weight", self.leaf_weight, k, lambda v: _fmt(v))
        arr("leaf_count", self.leaf_count, k)
        arr("internal_value", self.internal_value, ni, lambda v: _fmt(v))
        arr("internal_weight", self.internal_weight, ni, lambda v: _fmt(v))
        arr("internal_count", self.internal_count, ni)
        if self.num_cat > 0:
            arr("cat_boundaries", np.asarray(self.cat_boundaries), self.num_cat + 1)
            arr("cat_threshold", np.asarray(self.cat_threshold), len(self.cat_threshold))
        lines.append(f"shrinkage={_fmt(self.shrinkage)}")
        return "\n".join(lines) + "\n\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        """Parse a tree block (reference Tree::Tree(const char*, ...),
        tree.cpp:496)."""
        kv: Dict[str, str] = {}
        for line in text.strip().splitlines():
            if "=" in line:
                key, val = line.split("=", 1)
                kv[key.strip()] = val.strip()
        k = int(kv["num_leaves"])
        t = cls(max_leaves=k)
        t.num_leaves = k
        t.num_cat = int(kv.get("num_cat", "0"))
        t.shrinkage = float(kv.get("shrinkage", "1"))

        def geta(name, dtype, n):
            if n == 0 or name not in kv or not kv[name]:
                return np.zeros(max(n, 1), dtype=dtype)
            return np.asarray(kv[name].split(), dtype=dtype)

        ni = k - 1
        t.split_feature = geta("split_feature", np.int32, ni)
        t.split_feature_inner = t.split_feature.copy()
        t.split_gain = geta("split_gain", np.float32, ni)
        t.threshold = geta("threshold", np.float64, ni)
        t.threshold_in_bin = np.zeros(max(ni, 1), dtype=np.int32)
        t.decision_type = geta("decision_type", np.int8, ni)
        t.left_child = geta("left_child", np.int32, ni)
        t.right_child = geta("right_child", np.int32, ni)
        t.leaf_value = geta("leaf_value", np.float64, k)
        t.leaf_weight = geta("leaf_weight", np.float64, k)
        t.leaf_count = geta("leaf_count", np.int32, k)
        t.internal_value = geta("internal_value", np.float64, ni)
        t.internal_weight = geta("internal_weight", np.float64, ni)
        t.internal_count = geta("internal_count", np.int32, ni)
        if t.num_cat > 0:
            t.cat_boundaries = geta("cat_boundaries", np.int64, t.num_cat + 1).tolist()
            t.cat_threshold = geta("cat_threshold", np.int64,
                                   t.cat_boundaries[-1]).tolist()
            # inner bitsets are bin-space and not serialized; categorical
            # nodes use threshold_in_bin as the cat index
            t.cat_boundaries_inner = list(t.cat_boundaries)
            t.cat_threshold_inner = list(t.cat_threshold)
            t.threshold_in_bin = t.threshold.astype(np.int32)
        return t

    def relink_to_dataset(self, dataset) -> None:
        """Rebuild the bin-space traversal fields of a text-parsed tree
        against `dataset`'s bin mappers.

        The model text stores only real-valued thresholds and raw
        category sets (reference format, tree.cpp:223), but train-time
        score surgery — DART drop/normalize, rollback_one_iter — walks
        trees over BIN codes (`leaf_index_binned`). Resuming training
        from serialized trees therefore needs split_feature_inner,
        threshold_in_bin, and the inner categorical bitsets recomputed.
        Thresholds are exact bin boundaries (bin_to_value round-trips
        through repr()), so value_to_bin recovers the original bin."""
        ni = self.num_nodes
        mapper_for_cat: Dict[int, object] = {}
        for node in range(ni):
            real = int(self.split_feature[node])
            inner = dataset.inner_feature_index.get(real)
            if inner is None:
                # feature not used by this dataset: node unreachable in
                # bin-space traversal of this data; keep a safe default
                self.split_feature_inner[node] = 0
                continue
            self.split_feature_inner[node] = inner
            mapper = dataset.bin_mappers[inner]
            if self.decision_type[node] & K_CATEGORICAL_MASK:
                mapper_for_cat[int(self.threshold_in_bin[node])] = mapper
            else:
                self.threshold_in_bin[node] = mapper.value_to_bin(
                    float(self.threshold[node]))
        if self.num_cat > 0:
            bounds, bits = [0], []
            for ci in range(self.num_cat):
                lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
                mapper = mapper_for_cat.get(ci)
                words: List[int] = []
                if mapper is not None:
                    cat2bin = mapper.categorical_2_bin
                    bins = sorted(cat2bin[c]
                                  for c in _from_bitset(self.cat_threshold[lo:hi])
                                  if c in cat2bin)
                    words = _to_bitset(bins)
                bounds.append(bounds[-1] + len(words))
                bits.extend(words)
            self.cat_boundaries_inner = bounds
            self.cat_threshold_inner = bits

    def to_json(self) -> dict:
        """Reference Tree::ToJSON (tree.cpp:262)."""
        d = {"num_leaves": int(self.num_leaves), "num_cat": int(self.num_cat),
             "shrinkage": float(self.shrinkage)}
        if self.num_leaves == 1:
            d["tree_structure"] = {"leaf_value": float(self.leaf_value[0])}
        else:
            d["tree_structure"] = self._node_json(0)
        return d

    def _node_json(self, index: int) -> dict:
        if index >= 0:
            if self.is_categorical_node(index):
                cat_idx = int(self.threshold[index])
                cats = _from_bitset(
                    self.cat_threshold[self.cat_boundaries[cat_idx]:
                                       self.cat_boundaries[cat_idx + 1]])
                thr = "||".join(str(c) for c in cats)
                dec = "=="
            else:
                thr = float(self.threshold[index])
                dec = "<="
            return {
                "split_index": int(index),
                "split_feature": int(self.split_feature[index]),
                "split_gain": float(self.split_gain[index]),
                "threshold": thr,
                "decision_type": dec,
                "default_left": self.default_left(index),
                "missing_type": ["None", "Zero", "NaN"][self.missing_type(index)],
                "internal_value": float(self.internal_value[index]),
                "internal_weight": float(self.internal_weight[index]),
                "internal_count": int(self.internal_count[index]),
                "left_child": self._node_json(int(self.left_child[index])),
                "right_child": self._node_json(int(self.right_child[index])),
            }
        leaf = ~index
        return {
            "leaf_index": int(leaf),
            "leaf_value": float(self.leaf_value[leaf]),
            "leaf_weight": float(self.leaf_weight[leaf]),
            "leaf_count": int(self.leaf_count[leaf]),
        }

    # ------------------------------------------------------------------
    def predict_row(self, row: np.ndarray) -> float:
        """Scalar reference traversal (oracle for the vectorized path;
        reference tree.h:573-585)."""
        if self.num_nodes == 0:
            return float(self.leaf_value[0])
        node = 0
        while node >= 0:
            v = row[self.split_feature[node]]
            if self.is_categorical_node(node):
                cat_idx = int(self.threshold[node])
                words = self.cat_threshold[self.cat_boundaries[cat_idx]:
                                           self.cat_boundaries[cat_idx + 1]]
                if np.isnan(v):
                    go_left = False if self.missing_type(node) == 2 else _in_bitset(words, 0)
                elif int(v) < 0:
                    go_left = False
                else:
                    go_left = _in_bitset(words, int(v))
            else:
                mt = self.missing_type(node)
                fv = v
                if np.isnan(fv) and mt != 2:
                    fv = 0.0
                if (mt == 1 and abs(fv) <= 1e-35) or (mt == 2 and np.isnan(fv)):
                    go_left = self.default_left(node)
                else:
                    go_left = fv <= self.threshold[node]
            node = int(self.left_child[node] if go_left else self.right_child[node])
        return float(self.leaf_value[~node])


def _to_bitset(vals: Sequence[int]) -> List[int]:
    """Common::ConstructBitset (reference utils/common.h)."""
    if len(vals) == 0:
        return []
    n_words = max(int(v) for v in vals) // 32 + 1
    out = [0] * n_words
    for v in vals:
        out[int(v) // 32] |= 1 << (int(v) % 32)
    return out


def _from_bitset(words: Sequence[int]) -> List[int]:
    out = []
    for i, w in enumerate(words):
        for j in range(32):
            if (int(w) >> j) & 1:
                out.append(i * 32 + j)
    return out


def _in_bitset(words: Sequence[int], val: int) -> bool:
    wi = val // 32
    if wi >= len(words) or val < 0:
        return False
    return bool((int(words[wi]) >> (val % 32)) & 1)
