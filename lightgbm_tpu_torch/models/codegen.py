"""Model → standalone C++ source codegen.

Equivalent of the reference's convert_model task
(reference: src/boosting/gbdt_model_text.cpp:127 SaveModelToIfElse +
src/io/tree.cpp:337 Tree::ToIfElse): emits a self-contained C++ file
with one if-else predictor function per tree, suitable for dependency-
free deployment of a trained model. The port of the JAX package's
codegen: the same text for the same model, from the port's
``models/tree.py`` trees.
"""
from __future__ import annotations

from typing import List

from .tree import Tree, _from_bitset


def _tree_to_ifelse(tree: Tree, index: int) -> str:
    lines: List[str] = [f"double PredictTree{index}(const double* arr) {{"]

    def emit(node: int, depth: int) -> None:
        pad = "  " * (depth + 1)
        if node < 0:
            leaf = ~node
            lines.append(f"{pad}return {float(tree.leaf_value[leaf])!r};")
            return
        f = int(tree.split_feature[node])
        if tree.is_categorical_node(node):
            cat_idx = int(tree.threshold[node])
            cats = _from_bitset(
                tree.cat_threshold[tree.cat_boundaries[cat_idx]:
                                   tree.cat_boundaries[cat_idx + 1]])
            cond = " || ".join(f"(int)arr[{f}] == {c}" for c in cats) or "false"
            lines.append(f"{pad}if (!std::isnan(arr[{f}]) && ({cond})) {{")
        else:
            mt = tree.missing_type(node)
            dl = tree.default_left(node)
            thr = float(tree.threshold[node])
            if mt == 2:  # NaN
                miss = f"std::isnan(arr[{f}])"
            elif mt == 1:  # Zero
                miss = f"(std::fabs(arr[{f}]) <= 1e-35 || std::isnan(arr[{f}]))"
            else:
                miss = "false"
            base = f"(std::isnan(arr[{f}]) ? 0.0 : arr[{f}]) <= {thr!r}"
            if dl:
                cond = f"{miss} || ({base})"
            else:
                cond = f"!({miss}) && ({base})"
            lines.append(f"{pad}if ({cond}) {{")
        emit(int(tree.left_child[node]), depth + 1)
        lines.append(f"{pad}}} else {{")
        emit(int(tree.right_child[node]), depth + 1)
        lines.append(f"{pad}}}")

    if tree.num_nodes == 0:
        lines.append(f"  return {float(tree.leaf_value[0])!r};")
    else:
        emit(0, 0)
    lines.append("}")
    return "\n".join(lines)


def model_to_cpp(gbdt) -> str:
    """Emit the full predictor (raw-score sum over trees)."""
    gbdt._materialize_models()
    k = gbdt.num_tree_per_iteration
    parts = ["#include <cmath>", "#include <cstddef>", ""]
    for i, t in enumerate(gbdt.models):
        parts.append(_tree_to_ifelse(t, i))
        parts.append("")
    ntrees = len(gbdt.models)
    parts.append(f"const int kNumTrees = {ntrees};")
    parts.append(f"const int kNumTreePerIteration = {k};")
    parts.append("""
void Predict(const double* arr, double* out) {
  for (int c = 0; c < kNumTreePerIteration; ++c) out[c] = 0.0;
""")
    for i in range(ntrees):
        parts.append(f"  out[{i % k}] += PredictTree{i}(arr);")
    parts.append("}")
    return "\n".join(parts)
