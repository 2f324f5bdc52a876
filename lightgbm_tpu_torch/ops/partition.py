"""Leaf data partitioning as permutation updates (the serial learner's).

The port of the JAX package's ops/partition.py (re-design of the
reference DataPartition, data_partition.hpp: one flat ``indices_``
permutation with per-leaf [begin, count) ranges; ``Split`` at :101 is a
stable two-way partition). The permutation lives on the learner's
device; splitting a leaf is a stable two-way partition of its window by
cumsum ranks, written back in place of the window. Plain PyTorch: the
JAX version has no Pallas kernel. Integer only, so the result is
bit-exact with the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import torch

from .histogram import leaf_window


def cumsum_1d(x: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Inclusive cumsum of a 1-D tensor, computed the way the JAX
    package blocks it: within blocks of ``block``, then an exclusive
    carry over the block sums. Integer inputs give the same values as a
    flat cumsum; the blocking only matters for the order of float
    sums."""
    n = x.shape[0]
    if n <= block * 4:
        return torch.cumsum(x, dim=0)
    nb = -(-n // block)
    pad = nb * block - n
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    within = torch.cumsum(xp.reshape(nb, block), dim=1)
    sums = within[:, -1]
    carry = cumsum_1d(sums, block) - sums          # exclusive over blocks
    return (within + carry[:, None]).reshape(-1)[:n]


def decode_bins(codes: torch.Tensor, feature: int, tables) -> torch.Tensor:
    """Per-row feature-local bin from EFB bundle codes (the JAX
    package's io/efb.py decode_bins): codes are the rows' values of the
    feature's GROUP column; out-of-band codes map to the feature's
    most-frequent bin."""
    _, offset_of, nslots_of, skip_of = tables
    off = offset_of[feature].to(torch.int64)
    nsl = nslots_of[feature].to(torch.int64)
    skip = skip_of[feature].to(torch.int64)
    rel = codes.to(torch.int64) - off
    inband = (rel >= 0) & (rel < nsl)
    decoded = rel + (rel >= skip).to(torch.int64)
    return torch.where(inband, decoded, skip)


def decision_go_left(binval: torch.Tensor, threshold: int,
                     default_left: bool, miss_bin: int, is_cat: bool,
                     cat_bitset: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Bin-space routing (the JAX package's _decision_go_left; reference
    dense_bin.hpp Split): left iff bin <= threshold, the missing bin
    routed by default_left; categorical membership via the bitset."""
    if is_cat:
        if cat_bitset is None:
            return torch.zeros_like(binval, dtype=torch.bool)
        # an index past the bitset reads its last word, as a clamped
        # XLA gather does
        words = cat_bitset.to(torch.int64) & 0xFFFFFFFF
        widx = torch.clamp(binval // 32, 0, words.shape[0] - 1)
        return ((words[widx] >> (binval % 32)) & 1) == 1
    go_left = binval <= threshold
    if miss_bin >= 0:
        go_left = torch.where(binval == miss_bin, bool(default_left),
                              go_left)
    return go_left


def partition_leaf(bins_full: torch.Tensor, perm: torch.Tensor, start: int,
                   count: int, feature: int, threshold: int,
                   default_left: bool, miss_bin: int, is_cat: bool,
                   cat_bitset: Optional[torch.Tensor] = None,
                   capacity: Optional[int] = None, efb=None):
    """Stable-partition one leaf's rows by a split decision.

    Returns (new_perm, left_count): the rows routed left keep their
    relative order at the front of the window, the rest follow; rows
    outside the window keep their positions. ``perm`` is not modified.
    ``capacity`` pads the window as the JAX package does (it changes no
    result); None takes exactly the leaf's rows. ``efb``: the bundle
    tables (group_of, offset_of, nslots_of, skip_of) when ``bins_full``
    holds bundle codes."""
    start, count = int(start), int(count)
    capacity = count if capacity is None else int(capacity)
    rows, valid, read_start = leaf_window(perm, start, count, capacity)
    safe = torch.where(valid, rows, 0).to(torch.int64)
    if efb is not None:
        col = int(efb[0][feature])
        binval = decode_bins(bins_full[safe, col], feature, efb)
    else:
        binval = bins_full[safe, feature].to(torch.int64)
    go_left = decision_go_left(binval, threshold, default_left, miss_bin,
                               is_cat, cat_bitset)
    pos = torch.arange(capacity, device=perm.device)
    off = start - read_start
    gl = go_left & valid
    gr = (~go_left) & valid
    left_count = int(gl.sum())
    rank_l = cumsum_1d(gl.to(torch.int64)) - 1
    rank_r = cumsum_1d(gr.to(torch.int64)) - 1
    new_pos = torch.where(gl, off + rank_l,
                          torch.where(gr, off + left_count + rank_r, pos))
    new_rows = torch.empty_like(rows)
    new_rows[new_pos] = rows
    out = perm.clone()
    n = perm.shape[0]
    if capacity <= n:
        out[read_start:read_start + capacity] = new_rows
    else:
        out[:] = new_rows[:n]
    return out, left_count


def next_capacity(count: int, minimum: int = 256) -> int:
    """Power-of-two capacity bucket for a leaf size."""
    c = max(int(count), 1)
    cap = minimum
    while cap < c:
        cap *= 2
    return cap


def capacity_ladder(top: int, base: int, factor: int) -> list:
    """Geometric capacity ladder [base, base*factor, ...] capped by (and
    always ending at) ``top``."""
    caps = []
    c = base
    while c < top:
        caps.append(c)
        c *= factor
    caps.append(top)
    return caps
