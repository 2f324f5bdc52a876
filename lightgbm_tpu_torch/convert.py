"""Carry a model across from the JAX package.

GBDT's parameters are its trees. ``booster_from_jax_arrays`` takes the
JAX package's per-tree arrays as numpy — the fields of its
models/tree.py ``Tree`` — and returns a port ``Booster`` that predicts
the same scores. Loading the JAX package's model text
(``Booster(model_str=...)``) is the other route and gives the same
result; bin mappers are not part of a model and are rebuilt by the port
from the same matrix when training continues.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .basic import Booster
from .models.tree import Tree

# Tree fields the model text carries, with their dtypes
_FIELDS = {
    "split_feature": np.int32, "split_gain": np.float32,
    "threshold": np.float64, "decision_type": np.int8,
    "left_child": np.int32, "right_child": np.int32,
    "internal_value": np.float64, "internal_weight": np.float64,
    "internal_count": np.int32, "leaf_value": np.float64,
    "leaf_weight": np.float64, "leaf_count": np.int32,
}


def tree_from_arrays(arrays: Dict[str, np.ndarray]) -> Tree:
    """One Tree from the JAX package's Tree fields. ``num_leaves`` and
    the structure arrays are required; missing statistics default to 0.
    A categorical tree also takes ``num_cat``, ``cat_boundaries`` and
    ``cat_threshold`` (its raw-category bitset pool) and
    ``threshold_in_bin``, which holds a categorical node's bitset
    family."""
    k = int(arrays["num_leaves"])
    ni = max(k - 1, 0)
    tree = Tree(k)
    tree.num_leaves = k
    for name, dt in _FIELDS.items():
        n = k if name.startswith("leaf_") else ni
        if name in arrays and n:
            getattr(tree, name)[:n] = np.asarray(arrays[name], dt)[:n]
    tree.split_feature_inner[:ni] = tree.split_feature[:ni]
    if "threshold_in_bin" in arrays and ni:
        tree.threshold_in_bin[:ni] = np.asarray(arrays["threshold_in_bin"],
                                                np.int32)[:ni]
    tree.num_cat = int(arrays.get("num_cat", 0))
    if tree.num_cat > 0:
        tree.cat_boundaries = [int(v) for v in arrays["cat_boundaries"]]
        tree.cat_threshold = [int(v) for v in arrays["cat_threshold"]]
        # as a parsed model text: the inner (bin-space) pools stand in
        # for the raw ones until relink_to_dataset rebuilds them
        tree.cat_boundaries_inner = list(tree.cat_boundaries)
        tree.cat_threshold_inner = list(tree.cat_threshold)
    tree.shrinkage = float(arrays.get("shrinkage", 1.0))
    return tree


def booster_from_jax_arrays(trees: Sequence[Dict[str, np.ndarray]], *,
                            objective: str = "binary sigmoid:1",
                            num_tree_per_iteration: int = 1,
                            max_feature_idx: Optional[int] = None,
                            feature_names: Optional[Sequence[str]] = None,
                            average_output: bool = False,
                            params: Optional[dict] = None) -> Booster:
    """A port Booster holding ``trees`` (a list of dicts of the JAX
    package's Tree fields as numpy). ``objective`` is the model text's
    objective line; ``average_output``: the trees' outputs are averaged
    (a random forest, the JAX booster's ``_gbdt.average_output``);
    ``params`` picks the device (``device_type``)."""
    built = [tree_from_arrays(t) for t in trees]
    if max_feature_idx is None:
        max_feature_idx = max([int(t.split_feature[:t.num_leaves - 1].max())
                               for t in built if t.num_leaves > 1] or [0])
    if feature_names is None:
        feature_names = [f"Column_{i}" for i in range(max_feature_idx + 1)]
    head = ["tree", "version=v3",
            f"num_class={num_tree_per_iteration}",
            f"num_tree_per_iteration={num_tree_per_iteration}",
            "label_index=0", f"max_feature_idx={max_feature_idx}",
            f"objective={objective}"]
    if average_output:
        head.append("average_output")
    head += ["feature_names=" + " ".join(feature_names),
             "feature_infos=" + " ".join(["none"] * (max_feature_idx + 1))]
    text = ("\n".join(head) + "\ntree_sizes=\n\n"
            + "\n".join(f"Tree={i}\n" + t.to_string()
                        for i, t in enumerate(built))
            + "\nend of trees\n")
    return Booster(params=params, model_str=text)
