// Row-major gradient/hessian histogram of a [C, F] bin-code matrix.
//
// Replaces two TPU kernels of lightgbm_tpu/ops/histogram.py, which share
// one contract (bins [C, F], grad/hess [C] float32 -> [F, B, 2] float32):
//   - histogram_radix_pallas (_radix_pallas_kernel via _accum_chunks /
//     _chunk_partials): the serial learner's leaf histogram; its `dtype`
//     argument rounds grad/hess to bfloat16 before the float32 sums;
//   - histogram_pallas (_hist_pallas_kernel): the masked
//     multiply-accumulate histogram, float32 only.
// Both entries below launch the same kernels; the second never rounds.
// A code outside [0, num_bins) adds nothing (the JAX scatter drops it,
// the radix kernel lands it in cells the output slice cuts off).
//
// What bounds it on the card: bytes. The least work reads each row's F
// code bytes and 8 bytes of grad/hess once and writes one [F, B, 2]
// histogram; each (row, column) is read once and added once into one
// histogram cell in shared memory, so the work grows with rows x F and
// not with the number of bins.
//
// Float modes (float32 grad/hess, optionally rounded to bfloat16): no
// atomics on the sums; every cell is summed in row order inside its
// tile. rm_partials gives one warp to each (tile, column): the warp walks
// the tile 32 rows at a time, lane u holding row u's code, g and h (128
// rows' loads in flight at once). The lanes whose rows fall in the same
// cell form a group through an integer atomicOr into the cell's mask word
// in shared memory, and the group's last lane folds the group into the
// cell in row order (warp_fold.cuh fold_rows, shared with hist_planar.cu).
// So a cell's chain of adds is as long as its rows, not as the tile. The
// warp's histogram (one column) lives in shared memory and goes
// out as the tile's partial; rm_reduce sums the partials in tile order.
// The plain PyTorch version (ops/histogram.py tiled_scatter with the
// tile of rowmajor_tile) sums in exactly this association, so the bits
// match and are the same on every launch. (__match_any_sync forms the
// same groups, but on the H100 its throughput made the root window
// markedly slower than the mask words do.)
//
// The tile comes from the shapes alone (rm_tile below, ops/histogram.py
// rowmajor_tile, which the wrapper checks against lgbt_rm_tile): one
// tile per resident block of a fixed grid (kSMs x kBlocksPerSM), at
// least kMinTile rows (a window of up to kMinTile rows is summed in
// plain row order, as the JAX package's scatter sums it), and few enough
// tiles that the partials stay within kMaxPartialCells. A block takes as
// many of a tile's columns as fit in shared memory (up to 32, sharing
// the rows' lines in L1) but no more than keeps about kSMs x kBlocksPerSM
// blocks in the grid, so a window of a few thousand rows still spreads
// its columns over the card; this choice does not change the sums.
//
// Wide-bin path: a warp's share of shared memory holds at most
// kSmemBudget bytes. When one column's cells (B x 12 bytes) need more,
// the grid's third dimension splits the bins into ranges: one warp per
// (tile, column, bin range), adding only the rows whose codes fall in
// its range, still in row order.
//
// Int32 mode (quantized levels, `quant`: grad/hess are [C] int32 levels,
// unpacked, |qg| <= 31, qh <= 63; the output is int32): integer sums
// give the same bits in any order, so rm_quant lets every thread of a
// 1024-thread block add (row, column) elements into one shared [columns,
// bins, 2] int32 histogram with shared-memory atomics (four elements'
// loads in flight), and folds the block's nonzero cells into the zeroed
// output with global integer atomics; there is no partials pass. The
// grid is kQBlocks blocks of at least kQMinRows rows, whatever the
// window. When a column's histogram does not
// fit in shared memory, every element goes to the output by a global
// atomic. qg keeps its sign; a cell holds at most C x 63 < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_fold.cuh"

namespace {

// the tile rule (ops/histogram.py rowmajor_tile holds the same numbers)
constexpr long long kSMs = 132;          // H100 SXM
constexpr long long kBlocksPerSM = 2;
constexpr long long kMinTile = 2048;
constexpr long long kMaxPartialCells = 1LL << 22;

constexpr int kSmemBudget = 232448;      // dynamic shared memory per block
constexpr int kQThreads = 1024;
constexpr long long kQBlocks = 132;      // int32 mode: one block per SM
constexpr long long kQMinRows = 64;
constexpr int kNoBin = 0xFFFF;

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

long long rm_tile(long long C, long long F, long long B) {
  long long tile = ceil_div(C, kSMs * kBlocksPerSM);
  if (tile < kMinTile) tile = kMinTile;
  const long long cells = F * B > 0 ? F * B : 1;
  long long max_tiles = kMaxPartialCells / cells;
  if (max_tiles < 1) max_tiles = 1;
  const long long need = ceil_div(C, max_tiles);
  return tile > need ? tile : need;
}

// four steps (128 rows) of one column: key relative to the block's bin
// range (any other range, a negative code or one >= num_bins wraps to a
// value >= nb; rows past the tile get 0xFFFFFFFF)
template <typename CodeT>
__device__ __forceinline__ void rm_load(const CodeT* __restrict__ codes,
                                       const float* __restrict__ grad,
                                       const float* __restrict__ hess,
                                       long long row0, int base, int rows,
                                       int F, int f, int b0, int round_bf16,
                                       int lane, unsigned (&key)[4],
                                       float (&g)[4], float (&h)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = base + 32 * k + lane;
    key[k] = 0xFFFFFFFFu;
    g[k] = h[k] = 0.f;
    if (r < rows) {
      const long long row = row0 + r;
      key[k] = (unsigned)codes[row * F + f] - (unsigned)b0;
      g[k] = grad[row];
      h[k] = hess[row];
      if (round_bf16) {
        g[k] = __bfloat162float(__float2bfloat16_rn(g[k]));
        h[k] = __bfloat162float(__float2bfloat16_rn(h[k]));
      }
    }
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(1024)
rm_partials(const CodeT* __restrict__ codes, int C, int F,
            const float* __restrict__ grad, const float* __restrict__ hess,
            int num_bins, int tile, int cpb, int nbr, int round_bf16,
            float2* __restrict__ partials) {
  extern __shared__ float4 smem[];                 // [cpb][warp_bytes]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.y * cpb + warp;           // this warp's column
  if (f >= F) return;
  const long long row0 = (long long)blockIdx.x * tile;
  const int rows = (int)min((long long)tile, (long long)C - row0);
  const int b0 = blockIdx.z * nbr;
  const int nb = min(nbr, num_bins - b0);
  float2* col = reinterpret_cast<float2*>(
      reinterpret_cast<char*>(smem) + (size_t)warp * lgbt::warp_bytes(nbr));
  unsigned* mask = reinterpret_cast<unsigned*>(col + nbr);
  for (int i = lane; i < nb; i += 32) {
    col[i] = make_float2(0.f, 0.f);
    mask[i] = 0u;
  }
  __syncwarp();
  for (int base = 0; base < rows; base += 128) {
    // four steps' loads in flight, then the four steps in row order (a
    // register double buffer of the next four cost a block per SM)
    unsigned key[4];
    float g[4], h[4];
    rm_load(codes, grad, hess, row0, base, rows, F, f, b0, round_bf16, lane,
            key, g, h);
#pragma unroll
    for (int k = 0; k < 4; ++k) {               // fixed row order
      if (base + 32 * k < rows) {
        lgbt::fold_rows(col, mask, key[k], nb, g[k], h[k], lane);
      }
    }
  }
  for (int i = lane; i < nb; i += 32) {
    partials[((size_t)blockIdx.x * F + f) * num_bins + b0 + i] = col[i];
  }
}

__global__ void rm_reduce(const float* __restrict__ partials, int ntiles,
                          int cells2, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells2) return;
  float s = 0.f;
  int t = 0;
  for (; t + 8 <= ntiles; t += 8) {       // loads in flight, adds in order
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = partials[(size_t)(t + k) * cells2 + idx];
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[k];
  }
  for (; t < ntiles; ++t) s += partials[(size_t)t * cells2 + idx];
  out[idx] = s;
}

// kShared: the block's columns live in shared memory (zeroed, then
// folded into `out`); otherwise every element adds straight into `out`
template <typename CodeT, bool kShared>
__global__ void __launch_bounds__(kQThreads)
rm_quant(const CodeT* __restrict__ codes, int C, int F,
         const int32_t* __restrict__ grad, const int32_t* __restrict__ hess,
         int num_bins, int rows_per_block, int cpb, int32_t* __restrict__ out) {
  extern __shared__ int32_t qhist[];               // [cpb][num_bins][2]
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, (long long)C - row0);
  const int f0 = blockIdx.y * cpb;
  const int nf = min(cpb, F - f0);
  int32_t* out_cols = out + (size_t)f0 * num_bins * 2;
  int32_t* hist = kShared ? qhist : out_cols;
  const int cells2 = nf * num_bins * 2;
  if (kShared) {
    for (int i = threadIdx.x; i < cells2; i += kQThreads) hist[i] = 0;
    __syncthreads();
  }
  // element (r, j) = r * nf + j, advanced by kQThreads without dividing;
  // four elements' loads in flight before their atomics
  int r = threadIdx.x / nf, j = threadIdx.x % nf;
  const int dr = kQThreads / nf, dj = kQThreads % nf;
  while (r < rows) {
    unsigned code[4];
    int32_t g[4], h[4];
    int col[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      code[k] = 0xFFFFFFFFu;
      g[k] = h[k] = 0;
      col[k] = j;
      if (r < rows) {
        const long long row = row0 + r;
        code[k] = (unsigned)codes[row * F + f0 + j];
        g[k] = grad[row];
        h[k] = hess[row];
      }
      r += dr;
      j += dj;
      if (j >= nf) {
        j -= nf;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (code[k] < (unsigned)num_bins) {
        int32_t* cell = hist + ((size_t)col[k] * num_bins + code[k]) * 2;
        if (g[k]) atomicAdd(cell, g[k]);
        if (h[k]) atomicAdd(cell + 1, h[k]);
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

template <typename CodeT>
int launch_float(const CodeT* codes, int C, int F, const float* g,
                 const float* h, int num_bins, int round_bf16,
                 float* partials, float* out, cudaStream_t s) {
  const int tile = (int)rm_tile(C, F, num_bins);
  const int ntiles = C > 0 ? (int)ceil_div(C, tile) : 0;
  const int cells2 = F * num_bins * 2;
  if (ntiles > 0) {
    // bins per range (the whole column unless it is wider than shared
    // memory: the wide-bin path); then columns per block: as many as
    // fit (up to 32), but no more than spreads the grid over about
    // kSMs x kBlocksPerSM blocks
    const int nbr = std::min(num_bins, kSmemBudget / 12 - 2);
    const int nranges = (int)ceil_div(num_bins, nbr);
    const long long spread =
        ceil_div((long long)F * ntiles * nranges, kSMs * kBlocksPerSM);
    const int cpb = (int)std::min<long long>(
        {32, F, kSmemBudget / lgbt::warp_bytes(nbr), spread});
    const int ncol = (int)ceil_div(F, cpb);
    if (ncol > 65535) return (int)cudaErrorInvalidValue;
    const int smem = cpb * lgbt::warp_bytes(nbr);
    cudaError_t e = allow_smem(rm_partials<CodeT>, smem);
    if (e != cudaSuccess) return (int)e;
    rm_partials<CodeT><<<dim3(ntiles, ncol, nranges), 32 * cpb, smem, s>>>(
        codes, C, F, g, h, num_bins, tile, cpb, nbr, round_bf16,
        reinterpret_cast<float2*>(partials));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rm_reduce<<<(cells2 + 127) / 128, 128, 0, s>>>(partials, ntiles, cells2,
                                                 out);
  return (int)cudaGetLastError();
}

template <typename CodeT>
int launch_quant(const CodeT* codes, int C, int F, const int32_t* g,
                 const int32_t* h, int num_bins, int32_t* out,
                 cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)F * num_bins * 2 * 4, s);
  if (e != cudaSuccess || C == 0) return (int)e;
  long long rpb = ceil_div(C, kQBlocks);
  if (rpb < kQMinRows) rpb = kQMinRows;
  const int nblocks = (int)ceil_div(C, rpb);
  const int cpb = std::min(F, kSmemBudget / (num_bins * 8));
  if (cpb > 0) {
    const int ncol = (int)ceil_div(F, cpb);
    if (ncol > 65535) return (int)cudaErrorInvalidValue;
    const int smem = cpb * num_bins * 8;
    e = allow_smem(rm_quant<CodeT, true>, smem);
    if (e != cudaSuccess) return (int)e;
    rm_quant<CodeT, true><<<dim3(nblocks, ncol), kQThreads, smem, s>>>(
        codes, C, F, g, h, num_bins, (int)rpb, cpb, out);
  } else {                                // a column beyond shared memory
    rm_quant<CodeT, false><<<dim3(nblocks, 1), kQThreads, 0, s>>>(
        codes, C, F, g, h, num_bins, (int)rpb, F, out);
  }
  return (int)cudaGetLastError();
}

template <typename CodeT>
int dispatch_codes(const void* codes, int C, int F, const void* grad,
                   const void* hess, int num_bins, int round_bf16, int quant,
                   void* partials, void* out, cudaStream_t s) {
  const CodeT* c = static_cast<const CodeT*>(codes);
  if (quant) {
    return launch_quant<CodeT>(c, C, F, static_cast<const int32_t*>(grad),
                               static_cast<const int32_t*>(hess), num_bins,
                               static_cast<int32_t*>(out), s);
  }
  return launch_float<CodeT>(c, C, F, static_cast<const float*>(grad),
                             static_cast<const float*>(hess), num_bins,
                             round_bf16, static_cast<float*>(partials),
                             static_cast<float*>(out), s);
}

int dispatch(const void* codes, int code_bytes, int C, int F,
             const void* grad, const void* hess, int num_bins,
             int round_bf16, int quant, void* partials, void* out,
             void* stream) {
  if (num_bins < 1 || num_bins >= kNoBin || F < 1 || C < 0 ||
      (long long)F * num_bins * 2 > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (code_bytes == 1) {
    return dispatch_codes<uint8_t>(codes, C, F, grad, hess, num_bins,
                                   round_bf16, quant, partials, out, s);
  }
  if (code_bytes == 4) {
    return dispatch_codes<int32_t>(codes, C, F, grad, hess, num_bins,
                                   round_bf16, quant, partials, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// rows per tile of the float modes' first pass for these shapes
int lgbt_rm_tile(int C, int F, int num_bins) {
  return (int)rm_tile(C, F, num_bins);
}

// partials (float modes only; NULL under quant): max(1, ceil(C / tile))
// * F * num_bins * 2 floats, tile = lgbt_rm_tile(C, F, num_bins); codes:
// [C, F] uint8 (code_bytes 1) or int32 (code_bytes 4), row-major;
// grad/hess: [C] float32, or int32 levels when quant.
int lgbt_hist_radix(const void* codes, int code_bytes, int C, int F,
                    const void* grad, const void* hess, int num_bins,
                    int round_bf16, int quant, void* partials, void* out,
                    void* stream) {
  return dispatch(codes, code_bytes, C, F, grad, hess, num_bins, round_bf16,
                  quant, partials, out, stream);
}

int lgbt_hist_masked(const void* codes, int code_bytes, int C, int F,
                     const void* grad, const void* hess, int num_bins,
                     int quant, void* partials, void* out, void* stream) {
  return dispatch(codes, code_bytes, C, F, grad, hess, num_bins, 0, quant,
                  partials, out, stream);
}

}  // extern "C"
