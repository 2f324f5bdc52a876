"""Exclusive Feature Bundling — the sparse-feature data plane.

Re-design of the reference EFB (reference: src/io/dataset.cpp:50-302
GetConflictCount/FindGroups/FastFeatureBundling and FeatureGroup's
shared-column bin packing, include/LightGBM/feature_group.h:21). The
reference bundles near-mutually-exclusive sparse features into one
physical bin column so the histogram pass touches G << F columns; the
same packing here shrinks the device-resident bin matrix [N, G] and
every histogram/partition pass over it.

Encoding (one uint8/uint16 column per bundle):
  code 0                    = every member feature at its most-frequent
                              bin (for sparse features: the zero bin)
  code offset_f + slot(b)   = member f at bin b != mfb_f, where
                              slot(b) = b - (b > mfb_f) skips the mfb
                              slot (reference FeatureGroup bin offsets
                              skip the most-freq bin the same way)
Conflicts (two members non-default on one row) overwrite in member
order, bounded by the sampled conflict budget — identical information
loss to the reference's Push ordering (dataset.cpp:297 comment).

The per-feature histogram is recovered from the bundle histogram by a
precomputed gather plus the reference's FixHistogram identity
(dataset.cpp:1410): hist[mfb] = leaf_total - sum(other bins).

Unbundled features use the same table machinery with identity values
(offset 0, skip = num_bin), so every consumer (partition, traversal,
histogram gather) has ONE uniform code path.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import log
from .binning import BIN_CATEGORICAL

MAX_BUNDLE_BINS = 256          # default: keeps bundle codes uint8
MAX_SEARCH_GROUP = 100         # reference dataset.cpp:105 max_search_group
CONFLICT_FRACTION = 1.0 / 10000  # reference single_val_max_conflict_cnt


def find_bundles(nonzero_rows: List[np.ndarray], num_bins: Sequence[int],
                 bundle_ok: Sequence[bool], sample_cnt: int,
                 max_bundle_bins: int = MAX_BUNDLE_BINS,
                 max_conflict_rate: float = CONFLICT_FRACTION
                 ) -> List[List[int]]:
    """Greedy conflict-bounded grouping of features into bundles.

    nonzero_rows[f]: sorted sample-row indices where feature f is NOT at
    its most-frequent bin. bundle_ok[f]: feature is eligible (numerical,
    default==mfb). Returns a list of groups (lists of feature indices)
    covering every feature exactly once.

    Mirrors reference FindGroups (dataset.cpp:96): features are visited
    in descending non-default count, a feature joins the first existing
    group whose accumulated conflict count stays within
    sample_cnt * max_conflict_rate, else opens a new group. Both budgets
    are config knobs (efb_max_bundle_bins / efb_max_conflict_rate):
    denser bundling — wider groups, uint16 codes past 256 bins — is the
    lever the row-wise multival histogram layout wants, since its
    per-row code list shrinks with the group count.
    """
    f_total = len(nonzero_rows)
    max_conflict = int(sample_cnt * max_conflict_rate)
    order = sorted(range(f_total), key=lambda f: -len(nonzero_rows[f]))

    group_members: List[List[int]] = []
    group_marks: List[np.ndarray] = []   # bool over sample rows
    group_bins: List[int] = []
    group_confl: List[int] = []
    # probe screen: a fixed random row subset lets ONE matvec estimate
    # every group's conflict with a candidate feature, so the exact
    # check only visits the most promising MAX_SEARCH_GROUP groups.
    # The reference caps its search by sampling groups at RANDOM
    # (dataset.cpp:132-143) — at thousands of columns that misses the
    # compatible group most of the time; the probe finds it while the
    # conflict budget is still enforced EXACTLY below.
    probe_n = min(4096, sample_cnt)
    probe_rng = np.random.RandomState(3)
    probe_idx = np.sort(probe_rng.choice(sample_cnt, probe_n,
                                         replace=False)) \
        if probe_n < sample_cnt else np.arange(sample_cnt)
    probe_lut = np.full(sample_cnt, -1, np.int64)
    probe_lut[probe_idx] = np.arange(probe_n)
    probe_mat = np.zeros((f_total, probe_n), np.float32)  # row g = group g

    for f in order:
        if not bundle_ok[f]:
            group_members.append([f])
            group_marks.append(None)       # ineligible: never joined
            group_bins.append(num_bins[f])
            group_confl.append(0)
            continue
        rows = nonzero_rows[f]
        pf = probe_lut[rows]
        pf = pf[pf >= 0]
        pvec = np.zeros(probe_n, np.float32)
        pvec[pf] = 1.0
        placed = False
        g_count = len(group_members)
        gids = []
        if g_count:
            est = probe_mat[:g_count] @ pvec              # [G]
            # ineligible / bin-budget-full groups can never accept the
            # feature: push them past the end so they neither appear in
            # the candidate order nor consume exact-check budget
            blocked = np.fromiter(
                (group_marks[g] is None
                 or group_bins[g] + num_bins[f] - 1 > max_bundle_bins
                 for g in range(g_count)), dtype=bool, count=g_count)
            est[blocked] = np.inf
            gids = np.argsort(est, kind="stable")[:MAX_SEARCH_GROUP]
            gids = gids[np.isfinite(est[gids])]
        for gid in gids:
            cnt = int(np.count_nonzero(group_marks[gid][rows]))
            if group_confl[gid] + cnt <= max_conflict:
                group_members[gid].append(f)
                group_marks[gid][rows] = True
                group_bins[gid] += num_bins[f] - 1
                group_confl[gid] += cnt
                np.maximum(probe_mat[gid], pvec, out=probe_mat[gid])
                placed = True
                break
        if not placed:
            mark = np.zeros(sample_cnt, dtype=bool)
            mark[rows] = True
            group_members.append(list([f]))
            group_marks.append(mark)
            group_bins.append(num_bins[f])
            group_confl.append(0)
            probe_mat[len(group_members) - 1] = pvec
    return group_members


class BundleTables:
    """Per-feature bundle lookup tables (host numpy + lazy device copies).

    With no bundling these are identity tables: group_of = arange(F),
    offset 0, nslots = num_bin, skip = num_bin (decode is then the
    identity and every code is in-band).
    """

    def __init__(self, groups: List[List[int]], num_bins: Sequence[int],
                 mfb: Sequence[int]) -> None:
        f_total = len(num_bins)
        self.groups = groups
        self.num_groups = len(groups)
        self.group_of = np.zeros(f_total, dtype=np.int32)
        self.offset_of = np.zeros(f_total, dtype=np.int32)
        self.nslots_of = np.zeros(f_total, dtype=np.int32)
        self.skip_of = np.zeros(f_total, dtype=np.int32)
        self.bundled = np.zeros(f_total, dtype=bool)
        self.group_num_bins = np.zeros(self.num_groups, dtype=np.int32)
        for g, members in enumerate(groups):
            if len(members) == 1:
                f = members[0]
                self.group_of[f] = g
                self.offset_of[f] = 0
                self.nslots_of[f] = num_bins[f]
                self.skip_of[f] = num_bins[f]       # "skip nothing"
                self.group_num_bins[g] = num_bins[f]
            else:
                off = 1                              # code 0 = all-default
                for f in members:
                    self.group_of[f] = g
                    self.offset_of[f] = off
                    self.nslots_of[f] = num_bins[f] - 1
                    self.skip_of[f] = mfb[f]
                    self.bundled[f] = True
                    off += num_bins[f] - 1
                self.group_num_bins[g] = off
        self._device = None
        self._hist_tables = None

    @property
    def is_trivial(self) -> bool:
        return not self.bundled.any()

    @classmethod
    def identity(cls, num_bins: Sequence[int]) -> "BundleTables":
        return cls([[f] for f in range(len(num_bins))], num_bins,
                   [0] * len(num_bins))

    # ------------------------------------------------------------------
    def device(self, device) -> tuple:
        """(group_of, offset_of, nslots_of, skip_of) as int32 tensors on
        ``device``."""
        device = torch.device(device)
        if self._device is None or self._device[0] != device:
            self._device = (device, tuple(
                torch.as_tensor(a, dtype=torch.int32, device=device)
                for a in (self.group_of, self.offset_of, self.nslots_of,
                          self.skip_of)))
        return self._device[1]

    def hist_tables(self, num_bins: Sequence[int], max_feature_bins: int,
                    device) -> tuple:
        """Precomputed gather tables mapping the flattened bundle
        histogram [G * Bg] to per-feature histograms [F, Bmax]:
        (gather_idx, valid, mfb_onehot, bg) with tensors on ``device``."""
        device = torch.device(device)
        if self._hist_tables is None or self._hist_tables[0] != device:
            f_total = len(self.group_of)
            bg = int(self.group_num_bins.max()) if self.num_groups else 1
            idx = np.zeros((f_total, max_feature_bins), dtype=np.int64)
            valid = np.zeros((f_total, max_feature_bins), dtype=np.float32)
            mfb_oh = np.zeros((f_total, max_feature_bins), dtype=np.float32)
            for f in range(f_total):
                g, off = self.group_of[f], self.offset_of[f]
                skip = self.skip_of[f]
                for b in range(num_bins[f]):
                    if self.bundled[f] and b == skip:
                        mfb_oh[f, b] = 1.0   # reconstructed by FixHistogram
                        continue
                    slot = b - (1 if b > skip else 0)
                    idx[f, b] = g * bg + off + slot
                    valid[f, b] = 1.0
            self._hist_tables = (device, (
                torch.as_tensor(idx, device=device),
                torch.as_tensor(valid, device=device),
                torch.as_tensor(mfb_oh, device=device), bg))
        return self._hist_tables[1]


# ---------------------------------------------------------------------------
# Device-side helper
# ---------------------------------------------------------------------------

def per_feature_hist(group_hist: torch.Tensor, hist_tables, sum_g, sum_h
                     ) -> torch.Tensor:
    """Bundle histogram [G, Bg, 2] → per-feature histogram [F, Bmax, 2].

    Reconstructs each bundled feature's most-frequent-bin entry as
    leaf_total - sum(other bins) — the reference's FixHistogram
    (dataset.cpp:1410) using the leaf sums the split scan already has.
    """
    gather_idx, valid, mfb_oh, _ = hist_tables
    flat = group_hist.reshape(-1, 2)
    # the casts keep quantized int32 histograms in exact integer space
    # (no-ops on the float32 path)
    fh = flat[gather_idx] * valid[..., None].to(flat.dtype)
    total = torch.stack([torch.as_tensor(sum_g, dtype=fh.dtype,
                                         device=fh.device),
                         torch.as_tensor(sum_h, dtype=fh.dtype,
                                         device=fh.device)])    # [2]
    rest = fh.sum(dim=1).to(fh.dtype)                           # [F, 2]
    fill = total[None, :] - rest                                # [F, 2]
    return fh + mfb_oh[..., None].to(fh.dtype) * fill[:, None, :]


def bundle_eligible(m) -> bool:
    """Numerical features whose default (zero) bin is the most-frequent
    bin survive the encoding losslessly; everything else stays single."""
    return (m.bin_type != BIN_CATEGORICAL
            and m.default_bin == m.most_freq_bin and m.num_bin >= 2)


def build_bundles(nonzero_rows: List[np.ndarray], mappers,
                  sample_cnt: int, enable: bool,
                  bundle_ok: Optional[Sequence[bool]] = None,
                  max_bundle_bins: int = MAX_BUNDLE_BINS,
                  max_conflict_rate: float = CONFLICT_FRACTION
                  ) -> BundleTables:
    """Decide bundling from per-feature sampled non-default row sets.

    nonzero_rows[f]: sample-row indices where feature f's bin != its
    most-frequent bin (empty for ineligible features). Returns identity
    tables when bundling is disabled or not profitable. Codes are uint8
    while every group fits 256 bins and widen to uint16 past that
    (io/dataset.py _apply_mappers picks the dtype off group_num_bins).
    """
    num_bins = [m.num_bin for m in mappers]
    f_total = len(mappers)
    if not enable or f_total <= 1:
        return BundleTables.identity(num_bins)
    if bundle_ok is None:
        bundle_ok = [bundle_eligible(m) for m in mappers]
    groups = find_bundles(nonzero_rows, num_bins, bundle_ok, sample_cnt,
                          max_bundle_bins=max_bundle_bins,
                          max_conflict_rate=max_conflict_rate)
    if len(groups) >= f_total:
        return BundleTables.identity(num_bins)
    mfb = [m.most_freq_bin for m in mappers]
    tables = BundleTables(groups, num_bins, mfb)
    n_multi = sum(1 for g in groups if len(g) > 1)
    log.info("EFB: bundled %d features into %d groups (%d multi-feature)",
             f_total, len(groups), n_multi)
    return tables
