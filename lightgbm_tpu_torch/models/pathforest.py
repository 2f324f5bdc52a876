"""Path-mask batch inference: tree structure as data.

The port of the JAX package's models/pathforest.py, in plain PyTorch.
Per tree:

1. node conditions, all at once: the split feature's value of every
   row for every node (a column gather — the JAX package uses a 0/1
   matrix product because gathers are slow on the TPU), then
   LightGBM's numerical decision rules (missing type none / zero / NaN,
   default_left).
2. leaf flags, all at once: a leaf is reached iff ZERO of its path
   conditions mismatch. Two 0/1 matrix products count mismatches:
       mism = (1 - go_left) @ M_left + go_left @ M_right
   where M_left[n, l] = 1 iff leaf l's path goes LEFT at node n.
3. score += the value of the one leaf whose flag is set.

The mismatch counts are plain matrix products (``torch.matmul``), as
the JAX package leaves them to XLA; no kernel is involved. Scope: numerical splits only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK

K_ZERO = 1e-35

# host-memory ceiling for the [T, Nd, L] path matrices
PATH_TABLE_BUDGET = 1 << 29          # 512 MB (f32 host side)


def build_path_tables(trees: Sequence) -> Optional[dict]:
    """Per-node tables + [Nd, L] path matrices from host Trees, or None
    when a tree has categorical splits or the matrices would exceed
    PATH_TABLE_BUDGET."""
    T = len(trees)
    L = max([max(t.num_leaves, 1) for t in trees] or [1])
    Nd = max(L - 1, 1)
    if 2 * T * Nd * L * 4 > PATH_TABLE_BUDGET:
        return None
    for t in trees:
        if t.num_leaves > 1 and (
                t.decision_type[:t.num_nodes] & K_CATEGORICAL_MASK).any():
            return None

    feats = np.zeros((T, Nd), np.int64)
    thr = np.zeros((T, Nd), np.float32)
    mt = np.zeros((T, Nd), np.int32)
    dl = np.zeros((T, Nd), bool)
    m_left = np.zeros((T, Nd, L), np.float32)
    m_right = np.zeros((T, Nd, L), np.float32)
    values = np.zeros((T, L), np.float32)

    for i, t in enumerate(trees):
        values[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        if t.num_leaves <= 1:
            continue
        dt = t.decision_type[:t.num_nodes]
        n = t.num_nodes
        feats[i, :n] = t.split_feature[:n]
        thr[i, :n] = t.threshold[:n]
        mt[i, :n] = (dt.astype(np.int32) >> 2) & 3
        dl[i, :n] = (dt & K_DEFAULT_LEFT_MASK) != 0
        stack = [(0, [])]
        while stack:
            node, path = stack.pop()
            if node < 0:
                leaf = -node - 1
                for nd, left in path:
                    (m_left if left else m_right)[i, nd, leaf] = 1.0
                continue
            stack.append((int(t.left_child[node]), path + [(node, True)]))
            stack.append((int(t.right_child[node]), path + [(node, False)]))

    return dict(feats=feats, thr=thr, mt=mt, dl=dl, m_left=m_left,
                m_right=m_right, values=values, num_leaves=L)


class PathForest:
    """Device tables + the loop-over-trees inference program."""

    def __init__(self, trees: Sequence, num_classes: int, device,
                 tables: Optional[dict] = None) -> None:
        tabs = tables if tables is not None else build_path_tables(trees)
        assert tabs is not None, "caller must check build_path_tables"
        self.device = torch.device(device)
        self.num_trees = len(trees)
        self.num_classes = max(num_classes, 1)
        self.num_features = int(tabs["feats"].max()) + 1

        def t(k):
            return torch.as_tensor(tabs[k], device=self.device)
        self.feats, self.thr, self.mt, self.dl = (t("feats"), t("thr"),
                                                  t("mt"), t("dl"))
        self.m_left, self.m_right, self.values = (t("m_left"), t("m_right"),
                                                  t("values"))

    def raw_scores(self, x: torch.Tensor) -> torch.Tensor:
        """[num_classes, N] float32 raw scores; x [N, F] float32."""
        n, f_in = x.shape
        F = max(self.num_features, 1)
        x = x.to(self.device, torch.float32)
        if f_in < F:
            x = torch.nn.functional.pad(x, (0, F - f_in))
        x = x[:, :F]
        nanmask = torch.isnan(x)
        x0 = torch.where(nanmask, 0.0, x)
        score = torch.zeros((self.num_classes, n), dtype=torch.float32,
                            device=self.device)
        for i in range(self.num_trees):
            # the node's feature value per row: a column gather (exact
            # whatever the matmul precision setting)
            sel = x0[:, self.feats[i]]                            # [N, Nd]
            na = nanmask[:, self.feats[i]]
            mt, dl = self.mt[i][None, :], self.dl[i][None, :]
            is_missing = (((mt == 1) & (torch.abs(sel) <= K_ZERO))
                          | ((mt == 2) & na))
            go_left = torch.where(is_missing, dl, sel <= self.thr[i][None, :])
            gl = go_left.to(torch.float32)
            # 0/1 products: mismatch counts are small integers, exact
            mism = (1.0 - gl) @ self.m_left[i] + gl @ self.m_right[i]
            # the first leaf with no mismatch (padded leaf slots of a
            # smaller tree also read 0 but come after every real leaf)
            leaf = torch.argmax((mism == 0).to(torch.int32), dim=1)
            score[i % self.num_classes] += self.values[i][leaf]
        return score
