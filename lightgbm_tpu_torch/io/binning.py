"""Quantile feature binning.

Behavioral re-implementation (host-side, numpy) of the reference BinMapper
(reference: src/io/bin.cpp — GreedyFindBin at bin.cpp:78,
FindBinWithZeroAsOneBin at bin.cpp:256, BinMapper::FindBin at bin.cpp:325;
ValueToBin at include/LightGBM/bin.h:457-495).  Binning runs once per feature
at Dataset construction time on a bounded sample (bin_construct_sample_cnt),
so it stays on the host; the resulting integer bin codes are what live on the
device.  Bin *application* (value->bin for the full column) is vectorized with
``np.searchsorted`` instead of the reference's per-value binary search.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from ..utils import log

K_ZERO_THRESHOLD = 1e-35
K_SPARSE_THRESHOLD = 0.8
K_EPSILON = 1e-15

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1

_MISSING_NAMES = {MISSING_NONE: "none", MISSING_ZERO: "zero", MISSING_NAN: "nan"}
_MISSING_FROM_NAME = {v: k for k, v in _MISSING_NAMES.items()}


def _next_after_up(x: float) -> float:
    """float64 nextafter toward +inf (reference Common::GetDoubleUpperBound)."""
    return float(np.nextafter(np.float64(x), np.inf))


def _check_double_equal_ordered(a: float, b: float) -> bool:
    """b <= nextafter(a, inf) (reference Common::CheckDoubleEqualOrdered)."""
    return b <= _next_after_up(a)


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Equal-count greedy bin boundary search (reference bin.cpp:78-155).

    Returns the list of bin upper bounds; the last bound is +inf.
    """
    assert max_bin > 0
    if len(distinct_values) > 256:  # native pays off past trivial sizes
        from ..native import greedy_find_bin_native
        out = greedy_find_bin_native(distinct_values, counts, max_bin,
                                     total_cnt, min_data_in_bin)
        if out is not None:
            return out
    return greedy_find_bin_python(distinct_values, counts, max_bin,
                                  total_cnt, min_data_in_bin)


def greedy_find_bin_python(distinct_values: np.ndarray, counts: np.ndarray,
                           max_bin: int, total_cnt: int,
                           min_data_in_bin: int) -> List[float]:
    """The pure-Python GreedyFindBin: the path taken at 256 distinct values
    or fewer, and at any size when no C++ compiler is found."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += int(counts[i])
            if cur_cnt >= min_data_in_bin:
                val = _next_after_up((float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0)
                if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt = 0
        bin_upper_bound.append(math.inf)
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = min(max_bin, max(1, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = total_cnt
    is_big = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big.sum())
    rest_sample_cnt -= int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin
    bin_cnt = 0
    lower_bounds[0] = float(distinct_values[0])
    cur_cnt = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur_cnt += int(counts[i])
        if (is_big[i] or cur_cnt >= mean_bin_size or
                (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * 0.5))):
            upper_bounds[bin_cnt] = float(distinct_values[i])
            bin_cnt += 1
            lower_bounds[bin_cnt] = float(distinct_values[i + 1])
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
            bin_upper_bound.append(val)
    bin_upper_bound.append(math.inf)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  max_bin: int, total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Reserve a dedicated bin for ~zero values (reference bin.cpp:256-321).

    Negative values are binned on the left of the zero bin, positives on the
    right, with the per-side bin budget proportional to the side's data count.
    """
    dv = np.asarray(distinct_values, dtype=np.float64)
    cnts = np.asarray(counts, dtype=np.int64)
    left_mask = dv <= -K_ZERO_THRESHOLD
    right_mask = dv > K_ZERO_THRESHOLD
    zero_mask = ~left_mask & ~right_mask
    left_cnt_data = int(cnts[left_mask].sum())
    cnt_zero = int(cnts[zero_mask].sum())
    right_cnt_data = int(cnts[right_mask].sum())

    left_cnt = int(np.argmax(~left_mask)) if (~left_mask).any() else len(dv)

    bin_upper_bound: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bin_upper_bound = greedy_find_bin(dv[:left_cnt], cnts[:left_cnt],
                                          left_max_bin, left_cnt_data,
                                          min_data_in_bin)
        if bin_upper_bound:
            bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    right_start = -1
    for i in range(left_cnt, len(dv)):
        if dv[i] > K_ZERO_THRESHOLD:
            right_start = i
            break

    right_max_bin = max_bin - 1 - len(bin_upper_bound)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(dv[right_start:], cnts[right_start:],
                                       right_max_bin, right_cnt_data,
                                       min_data_in_bin)
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


class BinMapper:
    """Maps one raw feature column to integer bins.

    Mirrors the reference BinMapper state: ``bin_upper_bound_`` for numerical
    features, ``categorical_2_bin_`` / ``bin_2_categorical_`` for categorical
    ones, plus missing handling, default/most-frequent bin tracking
    (reference include/LightGBM/bin.h:61-225).
    """

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: int = BIN_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([math.inf])
        self.categorical_2_bin: Dict[int, int] = {}
        self.bin_2_categorical: List[int] = []
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int = 3,
                 min_split_data: int = 20, pre_filter: bool = False,
                 bin_type: int = BIN_NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        """Find bin boundaries from a sample of the column
        (reference BinMapper::FindBin, bin.cpp:325-521).

        ``values`` are the sampled *non-zero* values (the reference pushes
        only nonzeros plus an implied zero count); zero count is inferred as
        total_sample_cnt - len(values) - nan_count.
        """
        values = np.asarray(values, dtype=np.float64)
        nan_cnt = int(np.isnan(values).sum())
        values = values[~np.isnan(values)]

        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if nan_cnt > 0 else MISSING_NONE
        # NaNs only stay "missing" for the NaN missing type; otherwise the
        # reference folds them into the zero count (bin.cpp:329-352 keeps
        # na_cnt=0 outside the NaN branch)
        na_cnt = nan_cnt if self.missing_type == MISSING_NAN else 0

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        # distinct values (vectorized run-merge: adjacent sorted values equal
        # under CheckDoubleEqualOrdered collapse into one, keeping the larger
        # value — reference bin.cpp:355-383) with the zero pseudo-value
        # injected in value order
        values = np.sort(values, kind="stable")
        if len(values) > 0:
            new_run = np.empty(len(values), dtype=bool)
            new_run[0] = True
            if len(values) > 1:
                new_run[1:] = values[1:] > np.nextafter(values[:-1], np.inf)
            run_starts = np.flatnonzero(new_run)
            run_ends = np.concatenate([run_starts[1:], [len(values)]])
            base_dv = values[run_ends - 1]  # use the larger value of each run
            base_cnt = (run_ends - run_starts).astype(np.int64)
        else:
            base_dv = np.empty(0, dtype=np.float64)
            base_cnt = np.empty(0, dtype=np.int64)

        if len(base_dv) == 0:
            dv = np.asarray([0.0])
            cnts = np.asarray([zero_cnt], dtype=np.int64)
        else:
            pos = int(np.searchsorted(base_dv, 0.0, side="left"))
            zero_present = pos < len(base_dv) and base_dv[pos] == 0.0
            if zero_present:
                insert = False
            elif pos == 0 or pos == len(base_dv):
                insert = zero_cnt > 0  # all-positive (front) / all-negative (back)
            else:
                insert = True  # straddles zero: middle insert is unconditional
            if insert:
                dv = np.insert(base_dv, pos, 0.0)
                cnts = np.insert(base_cnt, pos, zero_cnt)
            else:
                dv, cnts = base_dv, base_cnt
        self.min_val = float(dv[0]) if len(dv) else 0.0
        self.max_val = float(dv[-1]) if len(dv) else 0.0
        cnt_in_bin: List[int] = []

        if bin_type == BIN_NUMERICAL:
            if self.missing_type == MISSING_ZERO:
                bounds = find_bin_with_zero_as_one_bin(
                    dv, cnts, max_bin, total_sample_cnt, min_data_in_bin)
                if len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            elif self.missing_type == MISSING_NONE:
                bounds = find_bin_with_zero_as_one_bin(
                    dv, cnts, max_bin, total_sample_cnt, min_data_in_bin)
            else:  # NaN: reserve last bin for missing
                bounds = find_bin_with_zero_as_one_bin(
                    dv, cnts, max_bin - 1, total_sample_cnt - na_cnt,
                    min_data_in_bin)
                bounds.append(math.nan)
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            # count per bin: first bound >= value (vectorized form of the
            # reference's sequential walk; NaN sentinel bound sorts last
            # and finite values never reach it)
            n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN
                                       else 0)
            bin_of_dv = np.searchsorted(self.bin_upper_bound[:n_search], dv,
                                        side="left")
            cnt_in_bin = np.bincount(bin_of_dv, weights=cnts,
                                     minlength=self.num_bin).astype(np.int64)
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical (reference bin.cpp:428-494)
            dv_int: List[int] = []
            cnts_int: List[int] = []
            for v, c in zip(dv, cnts):
                iv = int(v)
                if iv < 0:
                    na_cnt += int(c)
                    log.warning("Met negative value in categorical features, "
                                "will convert it to NaN")
                elif dv_int and iv == dv_int[-1]:
                    cnts_int[-1] += int(c)
                else:
                    dv_int.append(iv)
                    cnts_int.append(int(c))
            rest_cnt = total_sample_cnt - na_cnt
            if rest_cnt > 0:
                # stable sort by count desc
                order = sorted(range(len(dv_int)), key=lambda i: -cnts_int[i])
                cut_cnt = int(round((total_sample_cnt - na_cnt) * 0.99))
                distinct_cnt = len(dv_int) + (1 if na_cnt > 0 else 0)
                max_bin_c = min(distinct_cnt, max_bin)
                self.categorical_2_bin = {-1: 0}
                self.bin_2_categorical = [-1]
                cnt_in_bin = [0]
                self.num_bin = 1
                used_cnt = 0
                cur = 0
                while cur < len(order) and (used_cnt < cut_cnt or self.num_bin < max_bin_c):
                    idx = order[cur]
                    if cnts_int[idx] < min_data_in_bin and cur > 1:
                        break
                    self.bin_2_categorical.append(dv_int[idx])
                    self.categorical_2_bin[dv_int[idx]] = self.num_bin
                    used_cnt += cnts_int[idx]
                    cnt_in_bin.append(cnts_int[idx])
                    self.num_bin += 1
                    cur += 1
                if cur == len(order) and na_cnt == 0:
                    self.missing_type = MISSING_NONE
                else:
                    self.missing_type = MISSING_NAN
                cnt_in_bin[0] = int(total_sample_cnt - used_cnt)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and _need_filter(
                cnt_in_bin, total_sample_cnt, min_split_data, bin_type):
            self.is_trivial = True

        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
            if self.most_freq_bin != self.default_bin and max_sparse_rate < K_SPARSE_THRESHOLD:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    # ------------------------------------------------------------------
    def value_to_bin(self, value: float) -> int:
        """Single value -> bin (reference bin.h:457-495)."""
        return int(self.values_to_bins(np.asarray([value]))[0])

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized column -> bin codes (replaces per-value binary search)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_NUMERICAL:
            nan_mask = np.isnan(values)
            # non-NaN-missing-type: NaN treated as 0.0 (reference bin.h:462-466)
            safe = np.where(nan_mask, 0.0, values)
            n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
            if len(values) > 4096:
                from ..native import values_to_bins_native
                out = values_to_bins_native(safe,
                                            self.bin_upper_bound[:n_search])
                if out is not None:
                    out = out.astype(np.int64)
                    if self.missing_type == MISSING_NAN:
                        out = np.where(nan_mask, self.num_bin - 1, out)
                    return out
            # smallest j with value <= upper[j]; last searched bound is +inf
            out = np.searchsorted(self.bin_upper_bound[:n_search], safe, side="left")
            out = np.minimum(out, n_search - 1)
            if self.missing_type == MISSING_NAN:
                out = np.where(nan_mask, self.num_bin - 1, out)
            return out.astype(np.int32)
        else:
            iv = np.where(np.isnan(values), -1, values).astype(np.int64)
            out = np.zeros(len(values), dtype=np.int32)
            if self.categorical_2_bin:
                keys = np.fromiter(self.categorical_2_bin.keys(), dtype=np.int64)
                vals = np.fromiter(self.categorical_2_bin.values(), dtype=np.int64)
                order = np.argsort(keys)
                keys, vals = keys[order], vals[order]
                pos = np.searchsorted(keys, iv)
                pos = np.clip(pos, 0, len(keys) - 1)
                hit = keys[pos] == iv
                out = np.where(hit & (iv >= 0), vals[pos], 0).astype(np.int32)
            return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative split value for a bin boundary (used for model
        thresholds: reference stores bin_upper_bound_[bin] as the real
        threshold, tree.cpp RealThreshold)."""
        if self.bin_type == BIN_NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    # serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        d = {
            "num_bin": self.num_bin,
            "missing_type": _MISSING_NAMES[self.missing_type],
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_type": "categorical" if self.bin_type == BIN_CATEGORICAL else "numerical",
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
        }
        if self.bin_type == BIN_NUMERICAL:
            d["bin_upper_bound"] = [float(x) for x in self.bin_upper_bound]
        else:
            d["bin_2_categorical"] = list(self.bin_2_categorical)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = _MISSING_FROM_NAME[d["missing_type"]]
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = BIN_CATEGORICAL if d["bin_type"] == "categorical" else BIN_NUMERICAL
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        m.most_freq_bin = int(d["most_freq_bin"])
        if m.bin_type == BIN_NUMERICAL:
            m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        else:
            m.bin_2_categorical = [int(x) for x in d["bin_2_categorical"]]
            m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        return m


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """True if no split on this feature could satisfy min_data constraints
    (reference bin.cpp:54-76)."""
    if bin_type == BIN_NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True
    if len(cnt_in_bin) <= 2:
        for i in range(len(cnt_in_bin) - 1):
            if cnt_in_bin[i] >= filter_cnt and total_cnt - cnt_in_bin[i] >= filter_cnt:
                return False
        return True
    return False
