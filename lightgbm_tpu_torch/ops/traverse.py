"""Vectorized tree traversal (training-time score updates + inference).

The port of the JAX package's ops/traverse.py (the re-design of the
reference's per-row node-chasing loops: include/LightGBM/tree.h:265-345
NumericalDecision / CategoricalDecision and their bin-space Inner
variants). All rows advance one tree level per step, as masked torch ops
on the rows' device: a gather of the per-node fields and a gather of the
routed feature value per row. Rows that have reached a leaf carry a
negative node id (LightGBM's ``~leaf_index``) and stop moving. Where the
JAX package loops until no row moves (``lax.while_loop``), the port
takes the tree's depth from the host, so no step reads the device.

Plain PyTorch, integer and comparison work only: the same leaves as the
JAX package on the card and on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

K_ZERO = 1e-35
# category values at or above this are outside every bitset; clamping
# to it keeps the float -> int conversion defined
_CAT_CLAMP = float(1 << 30)


def tree_depth(left_child: Sequence[int], right_child: Sequence[int],
               num_nodes: int) -> int:
    """Number of levels a row walks to reach the deepest leaf of a flat
    tree (0 for a single leaf), from its child arrays on the host."""
    if num_nodes <= 0:
        return 0
    depth, level = 0, [0]
    while level:
        depth += 1
        level = [int(c) for n in level
                 for c in (left_child[n], right_child[n]) if c >= 0]
    return depth


def bitset_lookup(bitset: torch.Tensor, boundaries: torch.Tensor,
                  cat_idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """FindInBitset (reference include/LightGBM/utils/common.h) over a
    packed pool of bitset words with per-family ``boundaries``. Words
    hold the unsigned 32-bit values (int64 tensors); a value past its
    family's words, or negative, is out of the set. ``cat_idx`` is
    clamped into the families (a numerical node's threshold rides the
    same lanes, and its result is masked off), as XLA clamps a gather."""
    cat_idx = torch.clamp(cat_idx, 0, boundaries.shape[0] - 2)
    begin = boundaries[cat_idx]
    n_words = boundaries[cat_idx + 1] - begin
    word_i = torch.div(val, 32, rounding_mode="floor")
    in_range = (word_i < n_words) & (val >= 0)
    at = torch.clamp(begin + torch.where(in_range, word_i, 0), 0,
                     bitset.shape[0] - 1)
    bit = (bitset[at] >> torch.remainder(val, 32)) & 1
    return (bit == 1) & in_range


def cat_value(v: torch.Tensor) -> torch.Tensor:
    """The category index of raw values (reference CategoricalDecision):
    NaN reads as category 0, the rest truncate toward zero. Values out of
    the int32 range are clamped first; that changes no decision, as a
    negative value goes right and a huge one is outside every bitset."""
    v = torch.where(torch.isnan(v), 0.0, v)
    return torch.clamp(v, -1.0, _CAT_CLAMP).to(torch.int64)


def traverse_binned(bins: torch.Tensor, split_feature: torch.Tensor,
                    threshold_bin: torch.Tensor, left_child: torch.Tensor,
                    right_child: torch.Tensor, default_left: torch.Tensor,
                    miss_bin: torch.Tensor, is_cat: torch.Tensor,
                    cat_bitset_inner: torch.Tensor,
                    cat_boundaries_inner: torch.Tensor, depth: int,
                    efb=None) -> torch.Tensor:
    """Leaf index [N] (int64) of every row over bin codes (reference
    NumericalDecisionInner / CategoricalDecisionInner, tree.h:285-330).

    bins: [N, F_used] per-feature codes, or [N, G] bundle codes when
    ``efb`` = (group_of, offset_of, nslots_of, skip_of) is given; the
    routed feature's code is then decoded per row. The per-node arrays
    are the flat tree's, on the rows' device; a categorical node's
    ``threshold_bin`` is its bitset family. ``depth``: tree_depth of the
    tree."""
    n = bins.shape[0]
    dev = bins.device
    rows = torch.arange(n, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(depth):
        nid = torch.clamp(node, min=0)
        f = split_feature[nid]
        if efb is None:
            b = bins[rows, f].long()
        else:
            group_of, offset_of, nslots_of, skip_of = (x.long() for x in efb)
            rel = bins[rows, group_of[f]].long() - offset_of[f]
            inband = (rel >= 0) & (rel < nslots_of[f])
            b = torch.where(inband, rel + (rel >= skip_of[f]).long(),
                            skip_of[f])
        thr = threshold_bin[nid]
        mb = miss_bin[nid]
        go_left = torch.where((b == mb) & (mb >= 0), default_left[nid],
                              b <= thr)
        cat_left = bitset_lookup(cat_bitset_inner, cat_boundaries_inner,
                                 thr, b)
        go_left = torch.where(is_cat[nid], cat_left, go_left)
        nxt = torch.where(go_left, left_child[nid], right_child[nid])
        node = torch.where(node < 0, node, nxt)
    return -node - 1


def raw_go_left(v: torch.Tensor, thr: torch.Tensor, mt: torch.Tensor,
                dl: torch.Tensor, is_cat: Optional[torch.Tensor],
                cat_left_of) -> torch.Tensor:
    """The decision of one node per row on raw values (reference
    NumericalDecision / CategoricalDecision, tree.h:265-320). ``thr`` is
    the float32 threshold, compared in float32 as the JAX package keeps
    it. Numerical: NaN reads as 0.0 unless the node's missing type is
    NaN; a missing value (zero under missing type zero, NaN under NaN)
    goes by default_left. Categorical (``cat_left_of(iv)`` tests the
    category index): a negative value goes right, NaN goes right under
    missing type NaN and reads as category 0 otherwise."""
    nan = torch.isnan(v)
    v_num = torch.where(nan & (mt != 2), 0.0, v)
    is_missing = (((mt == 1) & (torch.abs(v_num) <= K_ZERO))
                  | ((mt == 2) & nan))
    go_left = torch.where(is_missing, dl, v_num <= thr)
    if is_cat is None:
        return go_left
    cat_left = (cat_left_of(cat_value(v)) & ~(~nan & (v < 0))
                & ~(nan & (mt == 2)))
    return torch.where(is_cat, cat_left, go_left)


def traverse_raw(x: torch.Tensor, split_feature: torch.Tensor,
                 threshold: torch.Tensor, left_child: torch.Tensor,
                 right_child: torch.Tensor, default_left: torch.Tensor,
                 missing_type: torch.Tensor, is_cat: torch.Tensor,
                 cat_bitset: torch.Tensor, cat_boundaries: torch.Tensor,
                 cat_idx: torch.Tensor, depth: int) -> torch.Tensor:
    """Leaf index [N] (int64) of every row over raw feature values
    (reference Tree::PredictLeafIndex). x: [N, F_total] float32; the
    thresholds are float32; missing_type per node in {0 none, 1 zero,
    2 nan}; ``cat_idx`` is a categorical node's bitset family."""
    n = x.shape[0]
    dev = x.device
    rows = torch.arange(n, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(depth):
        nid = torch.clamp(node, min=0)
        v = x[rows, split_feature[nid]]
        ci = cat_idx[nid]
        go_left = raw_go_left(
            v, threshold[nid], missing_type[nid], default_left[nid],
            is_cat[nid], lambda iv: bitset_lookup(cat_bitset, cat_boundaries,
                                                  ci, iv))
        nxt = torch.where(go_left, left_child[nid], right_child[nid])
        node = torch.where(node < 0, node, nxt)
    return -node - 1


def words_tensor(words: Sequence[int], device) -> torch.Tensor:
    """A bitset pool as int64 (unsigned 32-bit word values), never
    empty."""
    # tpulint: sync-ok(DART's drop traverses host trees, as the JAX package)
    return torch.as_tensor(np.asarray(list(words) or [0], dtype=np.int64)
                           & 0xFFFFFFFF, device=device)
