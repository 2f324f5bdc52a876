// Leaf-window gradient/hessian histogram straight off the planar state.
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram.py
// histogram_planar_pallas (bodies _radix_planar_kernel_grid and
// _radix_planar_kernel, shared _chunk_partials). It computes the same
// function: for the lane window [start, start+count) of the [P, R]
// int32 planar state, unpack each column's 4/8/16-bit code from the
// code planes (column f sits in plane f*bits/32 at bit f*bits%32,
// little-endian), bitcast grad/hess from planes grad_plane and
// grad_plane+1, optionally round them to bfloat16 (round to nearest
// even, like the JAX package's astype), and sum them per (column, bin)
// in float32. Output [num_cols, num_bins, 2] float32.
//
// The quantized mode (histogram_planar_pallas(quant=True)) reads one
// packed (qg << 16) | (qh & 0xFFFF) word per row from the grad plane
// (the hess plane is not read), unpacks it (arithmetic >> 16 restores
// the sign of qg, & 0xFFFF gives qh) and sums the levels exactly in
// int32: output [num_cols, num_bins, 2] int32. Each row is unpacked
// before it is added, so no sum of packed words is ever formed, and a
// cell's sum is at most rows * 63 < 2^31 for fewer than 34M rows.
// Integer addition is associative: the same bits in any order. Both
// modes are one template, instantiated per accumulator type.
//
// What bounds it on the card: at HIGGS width (28 columns, 255 bins) the
// least work is one read of (code_planes + 2) * 4 bytes per row — the
// kernel is meant to be bandwidth bound. This first version is not: each
// thread owns (column, bin) pairs and walks every staged row of its tile,
// so the instruction count grows with num_bins (about 256 compare-selects
// per row and column at 255 bins). It is simple and exact, and later
// work makes it fast (per-warp sub-histograms merged in a fixed order).
//
// What the design does about determinism: float atomics are never used.
// Pass 1 gives every (row tile, column chunk) block a private partial
// histogram, each cell accumulated in row order by one thread. Pass 2
// sums the partials over tiles in tile order. The same input therefore
// gives the same bits on every launch.
//
// The window may be given as host ints or read from device memory (two
// int32: start, count) so the tree learner can size a child's launch
// by its parent's count without reading the child's count back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 2048;     // rows per block
constexpr int kThreads = 256;
constexpr int kMaxCols = 4;     // columns per block (shared code rows)

// kQuant: packed int32 levels in the grad plane, int32 sums; else
// float32 grad/hess planes, float32 sums
template <bool kQuant>
__global__ void __launch_bounds__(kThreads)
hist_partials(const int32_t* __restrict__ data, long long R,
              const int32_t* __restrict__ win_start,
              const int32_t* __restrict__ win_count,
              int start_h, int count_h, int num_cols, int num_bins,
              int code_bits, int grad_plane, int cols_per_block,
              int round_bf16,
              typename std::conditional<kQuant, int32_t, float>::type*
                  __restrict__ partials) {
  using Acc = typename std::conditional<kQuant, int32_t, float>::type;
  const int start = win_start ? win_start[0] : start_h;
  const int count = win_count ? win_count[0] : count_h;
  const int tile = blockIdx.x;
  const int row0 = tile * kTile;
  if (row0 >= count) return;                 // past the window
  const int rows = min(kTile, count - row0);
  const int f0 = blockIdx.y * cols_per_block;
  const int nf = min(cols_per_block, num_cols - f0);

  __shared__ Acc sg[kTile];
  __shared__ Acc sh[kTile];
  __shared__ uint16_t sc[kMaxCols][kTile];

  const long long base = (long long)start + row0;
  const int32_t* gp = data + (long long)grad_plane * R + base;
  const int32_t* hp = gp + R;
  const uint32_t mask = (code_bits == 32) ? 0xFFFFFFFFu
                                          : ((1u << code_bits) - 1u);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    if constexpr (kQuant) {
      const int32_t w = gp[i];
      sg[i] = w >> 16;          // arithmetic shift: qg keeps its sign
      sh[i] = w & 0xFFFF;
    } else {
      float g = __int_as_float(gp[i]);
      float h = __int_as_float(hp[i]);
      if (round_bf16) {
        g = __bfloat162float(__float2bfloat16_rn(g));
        h = __bfloat162float(__float2bfloat16_rn(h));
      }
      sg[i] = g;
      sh[i] = h;
    }
    for (int j = 0; j < nf; ++j) {
      const int bitpos = (f0 + j) * code_bits;
      const uint32_t w =
          (uint32_t)data[(long long)(bitpos >> 5) * R + base + i];
      sc[j][i] = (uint16_t)((w >> (bitpos & 31)) & mask);
    }
  }
  __syncthreads();

  const int pairs = nf * num_bins;
  const size_t cells = (size_t)num_cols * num_bins;
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int j = p / num_bins;
    const int b = p - j * num_bins;
    const uint16_t* c = sc[j];
    Acc ag = 0, ah = 0;
    for (int i = 0; i < rows; ++i) {      // fixed row order
      const bool hit = c[i] == b;
      ag += hit ? sg[i] : Acc(0);
      ah += hit ? sh[i] : Acc(0);
    }
    const size_t o =
        ((size_t)tile * cells + (size_t)(f0 + j) * num_bins + b) * 2;
    partials[o] = ag;
    partials[o + 1] = ah;
  }
}

template <typename Acc>
__global__ void hist_reduce(const Acc* __restrict__ partials,
                            const int32_t* __restrict__ win_count,
                            int count_h, int grid_tiles, int cells2,
                            Acc* __restrict__ out) {
  const int count = win_count ? win_count[0] : count_h;
  const int ntiles = min(grid_tiles, (count + kTile - 1) / kTile);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells2) return;
  Acc s = 0;
  for (int t = 0; t < ntiles; ++t) {      // fixed tile order
    s += partials[(size_t)t * cells2 + idx];
  }
  out[idx] = s;
}

int cols_per_block(int num_bins) {
  int c = 1024 / (num_bins > 0 ? num_bins : 1);
  return c < 1 ? 1 : (c > kMaxCols ? kMaxCols : c);
}

template <bool kQuant>
int launch(const int32_t* data, long long R, const int32_t* win_start,
           const int32_t* win_count, int start_h, int count_h,
           int max_count, int num_cols, int num_bins, int code_bits,
           int grad_plane, int round_bf16, void* partials, void* out,
           cudaStream_t s) {
  using Acc = typename std::conditional<kQuant, int32_t, float>::type;
  const int cpb = cols_per_block(num_bins);
  int grid_tiles = (max_count + kTile - 1) / kTile;
  if (grid_tiles < 1) grid_tiles = 1;
  dim3 grid(grid_tiles, (num_cols + cpb - 1) / cpb);
  hist_partials<kQuant><<<grid, kThreads, 0, s>>>(
      data, R, win_start, win_count, start_h, count_h, num_cols, num_bins,
      code_bits, grad_plane, cpb, round_bf16, static_cast<Acc*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cells2 = num_cols * num_bins * 2;
  hist_reduce<Acc><<<(cells2 + 255) / 256, 256, 0, s>>>(
      static_cast<const Acc*>(partials), win_count, count_h, grid_tiles,
      cells2, static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lgbt_hist_tile() { return kTile; }

int lgbt_hist_cols_per_block(int num_bins) {
  return cols_per_block(num_bins);
}

// partials: grid_tiles * num_cols * num_bins * 2 floats (int32 when
// quant), where grid_tiles = max(1, ceil(max_count / kTile)); max_count
// must bound the window's count. win_start/win_count: device int32
// scalars, or null to use start_h/count_h. quant: the grad plane holds
// packed levels and partials / out are int32.
int lgbt_hist_planar(const int32_t* data, long long R,
                     const int32_t* win_start, const int32_t* win_count,
                     int start_h, int count_h, int max_count, int num_cols,
                     int num_bins, int code_bits, int grad_plane,
                     int round_bf16, int quant, void* partials, void* out,
                     void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (quant) {
    return launch<true>(data, R, win_start, win_count, start_h, count_h,
                        max_count, num_cols, num_bins, code_bits,
                        grad_plane, 0, partials, out, s);
  }
  return launch<false>(data, R, win_start, win_count, start_h, count_h,
                       max_count, num_cols, num_bins, code_bits, grad_plane,
                       round_bf16, partials, out, s);
}

}  // extern "C"
