// Native host-side binning kernels.
//
// The greedy equal-count bin boundary search (reference: bin.cpp:78-155
// GreedyFindBin) walks every distinct sampled value sequentially — a
// Python-loop hotspot at dataset-construction time (≈40% of
// from_matrix at HIGGS scale). The algorithm here transliterates the
// package's Python implementation (io/binning.py greedy_find_bin),
// which itself carries the reference's parity semantics, so the two
// must return bit-identical boundaries (tests/test_torch_data.py).
//
// Built on demand by lightgbm_tpu_torch/native/__init__.py into the
// package's ignored build directory:
//   g++ -O3 -std=c++17 -shared -fPIC binning.cpp -o _build/libbinning.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

namespace {

inline double next_after_up(double x) {
  return std::nextafter(x, std::numeric_limits<double>::infinity());
}

inline bool double_equal_ordered(double a, double b) {
  // b <= nextafter(a, inf) (reference Common::CheckDoubleEqualOrdered)
  return b <= next_after_up(a);
}

}  // namespace

extern "C" {

// Writes bin upper bounds (last = +inf) into out (capacity >= max_bin+1).
// Returns the number of bounds written.
int lgbt_greedy_find_bin(const double* dv, const int64_t* counts,
                         int64_t num_distinct, int max_bin,
                         int64_t total_cnt, int min_data_in_bin,
                         double* out) {
  const double kInf = std::numeric_limits<double>::infinity();
  int n_out = 0;

  if (num_distinct <= max_bin) {
    int64_t cur_cnt = 0;
    for (int64_t i = 0; i + 1 < num_distinct; ++i) {
      cur_cnt += counts[i];
      if (cur_cnt >= min_data_in_bin) {
        double val = next_after_up((dv[i] + dv[i + 1]) / 2.0);
        if (n_out == 0 || !double_equal_ordered(out[n_out - 1], val)) {
          out[n_out++] = val;
          cur_cnt = 0;
        }
      }
    }
    out[n_out++] = kInf;
    return n_out;
  }

  if (min_data_in_bin > 0) {
    max_bin = std::min<int64_t>(max_bin,
                                std::max<int64_t>(1, total_cnt / min_data_in_bin));
  }
  double mean_bin_size = static_cast<double>(total_cnt) / max_bin;
  int64_t rest_bin_cnt = max_bin;
  int64_t rest_sample_cnt = total_cnt;

  // is_big flags (counts >= mean_bin_size with the INITIAL mean)
  for (int64_t i = 0; i < num_distinct; ++i) {
    if (static_cast<double>(counts[i]) >= mean_bin_size) {
      --rest_bin_cnt;
      rest_sample_cnt -= counts[i];
    }
  }
  const double init_mean = mean_bin_size;
  mean_bin_size = static_cast<double>(rest_sample_cnt) /
                  std::max<int64_t>(rest_bin_cnt, 1);

  // upper/lower bound buffers on the stack of the caller's max_bin size
  // are avoided: we emit pair midpoints on the fly. We need the
  // previous upper bound and the next lower bound, which the streaming
  // structure provides.
  double* uppers = new double[max_bin];
  double* lowers = new double[max_bin];
  for (int i = 0; i < max_bin; ++i) uppers[i] = lowers[i] = kInf;
  int bin_cnt = 0;
  lowers[0] = dv[0];
  int64_t cur_cnt = 0;
  for (int64_t i = 0; i + 1 < num_distinct; ++i) {
    const bool big_i = static_cast<double>(counts[i]) >= init_mean;
    const bool big_next = static_cast<double>(counts[i + 1]) >= init_mean;
    if (!big_i) rest_sample_cnt -= counts[i];
    cur_cnt += counts[i];
    if (big_i || static_cast<double>(cur_cnt) >= mean_bin_size ||
        (big_next &&
         static_cast<double>(cur_cnt) >= std::max(1.0, mean_bin_size * 0.5))) {
      uppers[bin_cnt] = dv[i];
      ++bin_cnt;
      lowers[bin_cnt] = dv[i + 1];
      if (bin_cnt >= max_bin - 1) break;
      cur_cnt = 0;
      if (!big_i) {
        --rest_bin_cnt;
        mean_bin_size = static_cast<double>(rest_sample_cnt) /
                        std::max<int64_t>(rest_bin_cnt, 1);
      }
    }
  }
  ++bin_cnt;
  for (int i = 0; i + 1 < bin_cnt; ++i) {
    double val = next_after_up((uppers[i] + lowers[i + 1]) / 2.0);
    if (n_out == 0 || !double_equal_ordered(out[n_out - 1], val)) {
      out[n_out++] = val;
    }
  }
  out[n_out++] = kInf;
  delete[] uppers;
  delete[] lowers;
  return n_out;
}

// Numerical value->bin conversion over a full column (reference
// BinMapper::ValueToBin binary search, bin.h:457-495): out[i] = first j
// with bounds[j] >= v (NaN handled by the caller). uint16 output covers
// every bin width the package produces.
void lgbt_values_to_bins(const double* vals, int64_t n, const double* bounds,
                         int32_t nb, uint16_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const double v = vals[i];
    int32_t lo = 0, hi = nb - 1;
    while (lo < hi) {
      int32_t mid = (lo + hi) >> 1;
      if (bounds[mid] < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[i] = static_cast<uint16_t>(lo);
  }
}

}  // extern "C"
