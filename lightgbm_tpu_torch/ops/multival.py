"""Row-occupancy statistics of a bin-code matrix.

The port's copy of the part of the JAX package's ops/multival.py that
the histogram-layout decision reads (ops/histogram.py ``hist_layout``):
construct-time occupancy of the [N, G] bin-code matrix and the two
thresholds that pick the row-wise multi-value layout for wide-sparse
shapes. The multi-value histogram kernels themselves are not ported yet
(ROADMAP A11, kernels B5/B6).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# layout decision thresholds (ops/histogram.py hist_layout): the
# multi-value layout needs at least this many groups, and a mean
# present-codes-per-row of at most this fraction of the group count
MULTIVAL_MIN_GROUPS = 32
MULTIVAL_MAX_OCCUPANCY = 0.25


class OccupancyStats(NamedTuple):
    """Measured dataset occupancy (io/dataset.py computes this at
    construct time from a bounded deterministic row sample)."""
    num_groups: int
    row_nnz_mean: float          # mean non-default codes per row
    row_nnz_max: int             # max over the sample
    default_code: np.ndarray     # [G] int32 per-group default code
    group_density: np.ndarray    # [G] f32 non-default fraction
    sample_rows: int


def measure_occupancy(bins: np.ndarray, sample_rows: int = 65536
                      ) -> OccupancyStats:
    """Occupancy statistics from a deterministic strided row sample of
    the [N, G] bin-code matrix. The per-group default code is the
    sample's most frequent code (for multi-feature EFB bundles that is
    code 0 by construction; for singleton groups it is the feature's
    most-frequent bin)."""
    n, g = bins.shape
    step = max(1, n // max(1, sample_rows))
    sample = np.asarray(bins[::step][:sample_rows])
    default = np.empty(g, np.int32)
    for j in range(g):
        default[j] = np.argmax(np.bincount(sample[:, j]))
    present = sample != default[None, :]
    nnz = present.sum(axis=1)
    return OccupancyStats(
        num_groups=int(g),
        row_nnz_mean=float(nnz.mean()) if nnz.size else 0.0,
        row_nnz_max=int(nnz.max()) if nnz.size else 0,
        default_code=default,
        group_density=present.mean(axis=0).astype(np.float32),
        sample_rows=int(sample.shape[0]))
