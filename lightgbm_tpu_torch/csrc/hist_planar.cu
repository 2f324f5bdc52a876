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
// in float32. Output [num_cols, num_bins, 2] float32. A code >= num_bins
// adds nothing.
//
// The quantized mode (histogram_planar_pallas(quant=True)) reads one
// packed (qg << 16) | (qh & 0xFFFF) word per row from the grad plane
// (the hess plane is not read), unpacks it (arithmetic >> 16 restores
// the sign of qg, & 0xFFFF gives qh) and sums the levels exactly in
// int32: output [num_cols, num_bins, 2] int32. Each row is unpacked
// before it is added, so no sum of packed words is ever formed, and a
// cell's sum is at most rows * 63 < 2^31 for fewer than 34M rows.
//
// What bounds it on the card: bytes. The least work reads
// (code_planes + 2) * 4 bytes per row (the int32 mode code_planes + 1)
// and writes one histogram. The TPU kernel's one-hot radix product on
// the matrix unit is its way around slow scatter and is not carried
// over: here every (row, column) is read once and added once into one
// histogram cell in shared memory, so the work grows with rows x columns
// and not with the number of bins.
//
// Float modes: no float atomics; every cell is summed in row order inside
// its tile of kTile rows, and hp_reduce sums the tiles' partials in tile
// order, so the same input gives the same bits on every launch, and the
// plain PyTorch version (ops/histogram.py tiled_scatter with HIST_TILE)
// gives them too. hp_partials gives one warp to each (tile, column): the
// warp walks the tile 32 rows at a time, lane u holding row u's code, g
// and h (128 rows' loads in flight). The 32 rows' words of a column are
// 32 consecutive int32 of its code plane: one coalesced 128-byte load,
// then a shift and a mask; the columns that share a plane word, and the
// g/h words every column of the block reads, share L1 lines. Lanes whose
// rows hit the same cell form a group and the group's last lane folds it
// into the cell in row order (warp_fold.cuh fold_rows, shared with
// hist_rowmajor.cu). A block takes as many of a tile's columns as fit in
// shared memory (up to 32) but no more than keeps about kSMs x
// kBlocksPerSM blocks in the grid, so a window of a few thousand rows
// still spreads over the card; this choice does not change the sums.
// Wide bins: when one column's cells (12 bytes per bin with the group
// mask) do not fit in shared memory, the grid's third dimension splits
// the bins into ranges, each warp adding only its range, in row order.
//
// Int32 mode: integer sums give the same bits in any order, so hp_quant
// lets every thread of a 1024-thread block take (row, code plane word)
// elements of the block's rows (four elements' loads in flight), unpack
// each of the word's columns and add into one shared [columns, bins, 2]
// int32 histogram with shared-memory atomics; the block's nonzero cells
// go into the zeroed output with global atomics. The grid is about kQBlocks
// blocks of at least kQMinRows rows, sized on the device from the window's
// count. When one column's histogram does not fit in shared memory,
// every element adds straight into the output by a global atomic.
//
// The window may be given as host ints or read from device memory (two
// int32: start, count) so the tree learner can launch a child's
// histogram with a bound it holds on the host (half the rows, say)
// without reading the child's count back. Then the float mode runs
// hp_partials_dev: a grid of at most kSMs x kBlocksPerSM blocks that
// walk the window's own (tile, column group, bin range) items, split
// from the device count as a launch sized by that count would split
// them (the columns per block re-derived from the window's own tiles,
// so a small window still spreads over the card); warps past the
// window's columns per block leave at once. The reduce reads the tile
// count from the device count. Neither changes a sum: every (tile,
// column, bin) cell is summed in row order whichever block takes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_fold.cuh"

namespace {

constexpr int kTile = 2048;              // rows per tile (HIST_TILE)
constexpr long long kSMs = 132;          // H100 SXM
constexpr long long kBlocksPerSM = 2;
constexpr int kSmemBudget = 232448;      // dynamic shared memory per block
constexpr int kQThreads = 1024;
constexpr long long kQBlocks = 132;      // int32 mode: one block per SM
constexpr long long kQMinRows = 64;

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

// the lane window: device int32 scalars, or host ints when null
struct Window {
  const int32_t* start_p;
  const int32_t* count_p;
  int start_h;
  int count_h;
  __device__ int start() const { return start_p ? *start_p : start_h; }
  __device__ int count() const { return count_p ? *count_p : count_h; }
};

// four steps (128 rows) of one column from `step` on: key relative to
// the block's bin range (a code below b0 wraps; a row past the tile gets
// 0xFFFFFFFF, so it adds nothing)
__device__ __forceinline__ void hp_load(const int32_t* __restrict__ cp,
                                        const int32_t* __restrict__ gp,
                                        const int32_t* __restrict__ hp,
                                        unsigned shift, unsigned cmask,
                                        int b0, int step, int rows,
                                        int round_bf16, int lane,
                                        unsigned (&key)[4], float (&g)[4],
                                        float (&h)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = step + 32 * k + lane;
    key[k] = 0xFFFFFFFFu;
    g[k] = h[k] = 0.f;
    if (r < rows) {
      key[k] = (((unsigned)cp[r] >> shift) & cmask) - (unsigned)b0;
      g[k] = __int_as_float(gp[r]);
      h[k] = __int_as_float(hp[r]);
      if (round_bf16) {
        g[k] = __bfloat162float(__float2bfloat16_rn(g[k]));
        h[k] = __bfloat162float(__float2bfloat16_rn(h[k]));
      }
    }
  }
}

// one (tile, column, bin range) of the float mode: the tile's rows
// folded in row order into this warp's shared cells, then written out
__device__ __forceinline__ void hp_cell_block(
    const int32_t* __restrict__ data, long long R, int start, int count,
    int tile, int f, int b0, int num_cols, int num_bins, int code_bits,
    int grad_plane, int nbr, int round_bf16, float2* col, unsigned* mask,
    int lane, float2* __restrict__ partials) {
  const int row0 = tile * kTile;
  const int rows = min(kTile, count - row0);
  const int nb = min(nbr, num_bins - b0);
  for (int i = lane; i < nb; i += 32) {
    col[i] = make_float2(0.f, 0.f);
    mask[i] = 0u;
  }
  __syncwarp();
  const int bitpos = f * code_bits;
  const unsigned shift = (unsigned)(bitpos & 31);
  const unsigned cmask = (1u << code_bits) - 1u;   // code_bits <= 16
  const long long base = (long long)start + row0;
  const int32_t* cp = data + (long long)(bitpos >> 5) * R + base;
  const int32_t* gp = data + (long long)grad_plane * R + base;
  const int32_t* hp = gp + R;
  for (int step = 0; step < rows; step += 128) {
    // four steps' loads in flight, then the four steps in row order
    unsigned key[4];
    float g[4], h[4];
    hp_load(cp, gp, hp, shift, cmask, b0, step, rows, round_bf16, lane, key,
            g, h);
#pragma unroll
    for (int k = 0; k < 4; ++k) {                // fixed row order
      if (step + 32 * k < rows) {
        lgbt::fold_rows(col, mask, key[k], nb, g[k], h[k], lane);
      }
    }
  }
  for (int i = lane; i < nb; i += 32) {
    partials[((size_t)tile * num_cols + f) * num_bins + b0 + i] = col[i];
  }
}

// host window: block (tile, column group, bin range) of the launch's grid
__global__ void __launch_bounds__(1024)
hp_partials(const int32_t* __restrict__ data, long long R, Window win,
            int num_cols, int num_bins, int code_bits, int grad_plane,
            int cpb, int nbr, int round_bf16,
            float2* __restrict__ partials) {
  extern __shared__ float4 smem[];                 // [cpb][warp_bytes]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.y * cpb + warp;           // this warp's column
  if (f >= num_cols) return;
  const int count = win.count();
  if ((int)blockIdx.x * kTile >= count) return;    // past the window
  float2* col = reinterpret_cast<float2*>(
      reinterpret_cast<char*>(smem) + (size_t)warp * lgbt::warp_bytes(nbr));
  hp_cell_block(data, R, win.start(), count, blockIdx.x, f,
                blockIdx.z * nbr, num_cols, num_bins, code_bits, grad_plane,
                nbr, round_bf16, col, reinterpret_cast<unsigned*>(col + nbr),
                lane, partials);
}

// device window: a grid of a few hundred blocks walks the window's own
// (tile, column group, bin range) items, which the block derives from
// the device count as a launch sized by that count would split them
// (columns per block re-derived from the window's tiles, at most
// cpb), so a window far below the launch's bound pays for no grid of
// empty blocks
__global__ void __launch_bounds__(1024)
hp_partials_dev(const int32_t* __restrict__ data, long long R, Window win,
                int num_cols, int num_bins, int code_bits, int grad_plane,
                int cpb, int nbr, int nranges, int grid_tiles,
                int round_bf16, float2* __restrict__ partials) {
  extern __shared__ float4 smem[];                 // [cpb][warp_bytes]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int count = win.count();
  const int at = min(grid_tiles, count / kTile + (count % kTile != 0));
  if (at <= 0) return;
  const int cpb_e = (int)min(
      (long long)cpb,
      ceil_div((long long)num_cols * at * nranges, kSMs * kBlocksPerSM));
  if (warp >= cpb_e) return;
  const int ncol_e = (num_cols + cpb_e - 1) / cpb_e;
  const int items = at * ncol_e * nranges;
  const int start = win.start();
  float2* col = reinterpret_cast<float2*>(
      reinterpret_cast<char*>(smem) + (size_t)warp * lgbt::warp_bytes(nbr));
  unsigned* mask = reinterpret_cast<unsigned*>(col + nbr);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % at;
    const int rest = it / at;
    const int f = (rest % ncol_e) * cpb_e + warp;  // this warp's column
    if (f < num_cols) {
      hp_cell_block(data, R, start, count, tile, f, (rest / ncol_e) * nbr,
                    num_cols, num_bins, code_bits, grad_plane, nbr,
                    round_bf16, col, mask, lane, partials);
    }
  }
}

__global__ void hp_reduce(const float* __restrict__ partials, Window win,
                          int grid_tiles, int cells2,
                          float* __restrict__ out) {
  const int count = win.count();
  const int ntiles = (int)min((long long)grid_tiles, ceil_div(count, kTile));
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells2) return;
  float s = 0.f;
  int t = 0;
  for (; t + 16 <= ntiles; t += 16) {     // loads in flight, adds in order
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k] = partials[(size_t)(t + k) * cells2 + idx];
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) s += v[k];
  }
  for (; t < ntiles; ++t) s += partials[(size_t)t * cells2 + idx];
  out[idx] = s;
}

// kShared: the block's columns live in shared memory (zeroed, then
// folded into `out`); otherwise every element adds straight into `out`
template <bool kShared>
__global__ void __launch_bounds__(kQThreads)
hp_quant(const int32_t* __restrict__ data, long long R, Window win,
         int num_cols, int num_bins, int code_bits, int grad_plane, int cpb,
         int32_t* __restrict__ out) {
  extern __shared__ int32_t qhist[];               // [cpb][num_bins][2]
  const int count = win.count();
  const long long rpb =
      ceil_div(count, kQBlocks) > kQMinRows ? ceil_div(count, kQBlocks)
                                            : kQMinRows;
  const long long row0 = (long long)blockIdx.x * rpb;
  if (row0 >= count) return;                       // the whole block
  const int rows = (int)min(rpb, (long long)count - row0);
  const int f0 = blockIdx.y * cpb;
  const int nf = min(cpb, num_cols - f0);
  const int per_word = 32 / code_bits;             // columns per word
  const int w0 = f0 / per_word;
  const int nw = (f0 + nf - 1) / per_word - w0 + 1;
  int32_t* out_cols = out + (size_t)f0 * num_bins * 2;
  int32_t* hist = kShared ? qhist : out_cols;
  const int cells2 = nf * num_bins * 2;
  if (kShared) {
    for (int i = threadIdx.x; i < cells2; i += kQThreads) hist[i] = 0;
    __syncthreads();
  }
  const long long base = (long long)win.start() + row0;
  const int32_t* cw = data + (long long)w0 * R + base;
  const int32_t* gw = data + (long long)grad_plane * R + base;
  const unsigned cmask = (1u << code_bits) - 1u;
  // element (r, w) = r * nw + w, advanced by kQThreads without dividing
  int r = threadIdx.x / nw, w = threadIdx.x % nw;
  const int dr = kQThreads / nw, dw = kQThreads % nw;
  while (r < rows) {
    uint32_t word[4];
    int32_t gh[4];
    int wk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wk[k] = -1;
      word[k] = 0u;
      gh[k] = 0;
      if (r < rows) {
        wk[k] = w;
        word[k] = (uint32_t)cw[(long long)w * R + r];
        gh[k] = gw[r];
      }
      r += dr;
      w += dw;
      if (w >= nw) {
        w -= nw;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (wk[k] < 0) continue;
      const int32_t qg = gh[k] >> 16;     // arithmetic: qg keeps its sign
      const int32_t qh = gh[k] & 0xFFFF;
      const int first = (w0 + wk[k]) * per_word;
      const int c_lo = max(f0, first);
      const int c_hi = min(f0 + nf, first + per_word);
      for (int c = c_lo; c < c_hi; ++c) {
        const unsigned code =
            (word[k] >> ((unsigned)(c * code_bits) & 31u)) & cmask;
        if (code < (unsigned)num_bins) {
          int32_t* cell = hist + ((size_t)(c - f0) * num_bins + code) * 2;
          if (qg) atomicAdd(cell, qg);
          if (qh) atomicAdd(cell + 1, qh);
        }
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells2; i += kQThreads) {
      const int32_t v = hist[i];
      if (v) atomicAdd(out_cols + i, v);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

int launch_float(const int32_t* data, long long R, Window win, int max_count,
                 int num_cols, int num_bins, int code_bits, int grad_plane,
                 int round_bf16, float* partials, float* out,
                 cudaStream_t s) {
  const int grid_tiles = (int)std::max(1LL, ceil_div(max_count, kTile));
  const int cells2 = num_cols * num_bins * 2;
  if (max_count > 0) {
    // bins per range (the whole column unless it is wider than shared
    // memory: the wide-bin path); then columns per block: as many as
    // fit (up to 32), but no more than spreads the grid over about
    // kSMs x kBlocksPerSM blocks
    const int nbr = std::min(num_bins, kSmemBudget / 12 - 2);
    const int nranges = (int)ceil_div(num_bins, nbr);
    const long long spread = ceil_div(
        (long long)num_cols * grid_tiles * nranges, kSMs * kBlocksPerSM);
    const int cpb = (int)std::min<long long>(
        {32, num_cols, kSmemBudget / lgbt::warp_bytes(nbr), spread});
    const int smem = cpb * lgbt::warp_bytes(nbr);
    cudaError_t e;
    if (win.count_p == nullptr) {
      const int ncol = (int)ceil_div(num_cols, cpb);
      if (ncol > 65535 || nranges > 65535) return (int)cudaErrorInvalidValue;
      if ((e = allow_smem(hp_partials, smem)) != cudaSuccess) return (int)e;
      hp_partials<<<dim3(grid_tiles, ncol, nranges), 32 * cpb, smem, s>>>(
          data, R, win, num_cols, num_bins, code_bits, grad_plane, cpb, nbr,
          round_bf16, reinterpret_cast<float2*>(partials));
    } else {
      // the most items any count up to max_count has, in at most
      // kSMs * kBlocksPerSM blocks
      long long items = 0;
      for (long long at = 1; at <= grid_tiles; ++at) {
        const long long ce = std::min<long long>(
            cpb, ceil_div((long long)num_cols * at * nranges,
                          kSMs * kBlocksPerSM));
        items = std::max(items, at * ceil_div(num_cols, ce) * nranges);
      }
      if (items > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
      const int blocks = (int)std::min(items, kSMs * kBlocksPerSM);
      if ((e = allow_smem(hp_partials_dev, smem)) != cudaSuccess) {
        return (int)e;
      }
      hp_partials_dev<<<blocks, 32 * cpb, smem, s>>>(
          data, R, win, num_cols, num_bins, code_bits, grad_plane, cpb, nbr,
          nranges, grid_tiles, round_bf16,
          reinterpret_cast<float2*>(partials));
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  hp_reduce<<<(cells2 + 127) / 128, 128, 0, s>>>(partials, win, grid_tiles,
                                                 cells2, out);
  return (int)cudaGetLastError();
}

int launch_quant(const int32_t* data, long long R, Window win, int max_count,
                 int num_cols, int num_bins, int code_bits, int grad_plane,
                 int32_t* out, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(
      out, 0, (size_t)num_cols * num_bins * 2 * sizeof(int32_t), s);
  if (e != cudaSuccess || max_count == 0) return (int)e;
  // enough blocks for any count <= max_count (hp_quant sizes its rows
  // from the device count: max(kQMinRows, ceil(count / kQBlocks)))
  const int nblocks =
      (int)std::min(kQBlocks, ceil_div(max_count, kQMinRows));
  const int cpb = std::min(num_cols, kSmemBudget / (num_bins * 8));
  if (cpb > 0) {
    const int ncol = (int)ceil_div(num_cols, cpb);
    if (ncol > 65535) return (int)cudaErrorInvalidValue;
    const int smem = cpb * num_bins * 8;
    e = allow_smem(hp_quant<true>, smem);
    if (e != cudaSuccess) return (int)e;
    hp_quant<true><<<dim3(nblocks, ncol), kQThreads, smem, s>>>(
        data, R, win, num_cols, num_bins, code_bits, grad_plane, cpb, out);
  } else {                                // a column beyond shared memory
    hp_quant<false><<<dim3(nblocks, 1), kQThreads, 0, s>>>(
        data, R, win, num_cols, num_bins, code_bits, grad_plane, num_cols,
        out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lgbt_hist_tile() { return kTile; }

// partials (float modes only; NULL under quant): grid_tiles * num_cols *
// num_bins * 2 floats, where grid_tiles = max(1, ceil(max_count /
// kTile)); max_count must bound the window's count. win_start/win_count:
// device int32 scalars, or null to use start_h/count_h. quant: the grad
// plane holds packed levels and out is int32.
int lgbt_hist_planar(const int32_t* data, long long R,
                     const int32_t* win_start, const int32_t* win_count,
                     int start_h, int count_h, int max_count, int num_cols,
                     int num_bins, int code_bits, int grad_plane,
                     int round_bf16, int quant, void* partials, void* out,
                     void* stream) {
  if (num_bins < 1 || num_bins > 65536 || num_cols < 1 || max_count < 0 ||
      (code_bits != 4 && code_bits != 8 && code_bits != 16) ||
      (long long)num_cols * num_bins * 2 > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Window win{win_start, win_count, start_h, count_h};
  if (quant) {
    return launch_quant(data, R, win, max_count, num_cols, num_bins,
                        code_bits, grad_plane, static_cast<int32_t*>(out), s);
  }
  return launch_float(data, R, win, max_count, num_cols, num_bins, code_bits,
                      grad_plane, round_bf16, static_cast<float*>(partials),
                      static_cast<float*>(out), s);
}

}  // extern "C"
