// Row-wise multi-value histogram over flat codes (wide-sparse layout).
//
// Replaces two TPU kernels of lightgbm_tpu/ops/multival.py:
//   - histogram_multival_planar (_mv_kernel_grid): the fused learner's
//     leaf histogram, read straight off the [P, R] planar state: slot
//     planes [mv_start, mv_start + mv_planes), grad/hess bitcast from
//     planes grad_plane and grad_plane + 1, lane window
//     [start, start + count) (host ints or device int32 scalars);
//   - histogram_multival_pallas (_mv_kernel): the serial learner's leaf
//     histogram over slot-major codes [Kp, C] and pre-masked [8, C]
//     lane planes (rows 0/1 = bitcast float32 grad/hess), all C rows.
// Both compute, for every row of the window and every slot s, the add
// of (grad, hess) into flat cell codes[s]; a code outside [0, T] (the
// -1 pad) adds nothing, and slot 0 carries the sentinel T, so cell T
// ends up holding the window's totals. Output [T + 1, 2] float32.
// Grad/hess may be rounded to bfloat16 (round to nearest even) first.
// A row's codes are distinct cells (one per group, plus the sentinel).
//
// Quantized mode (both TPU kernels' quant=True): the grad plane (B5) or
// lane row 0 (B6) holds one packed (qg << 16) | (qh & 0xFFFF) word per
// row; each row's word is unpacked (arithmetic >> 16, & 0xFFFF) and the
// levels are summed exactly in int32: output [T + 1, 2] int32.
//
// What bounds it on the card: bytes. The least work reads each row's K
// slot words and its grad/hess once (count * (K + 2) * 4 bytes) and
// writes [T + 1, 2]. About 10 of a row's 40 slots are live at the
// wide-sparse shape, so the adds are few; what costs is latency.
//
// Float modes: no float atomics. Every cell is summed in row order
// inside its tile of kTile rows (relative to the window's start), and
// mv_reduce sums the tiles' partials in tile order, so every launch
// gives the same bits, and so does the plain PyTorch version
// (ops/multival.py _tiled_flat, MV_TILE). mv_tiles gives one block to
// each tile and splits the work over cells, not rows:
//   1. thread r of the block takes row r: it stages the row's grad/hess
//      in shared memory and reads the row's K slot codes (coalesced over
//      rows, kLoadBatch loads in flight), setting bit r of the cell's
//      row mask for each live code (integer atomicOr: order-free). The
//      mask is kTile bits per cell, one 32-bit word per warp of rows.
//   2. thread t then owns cells t, t + kThreads, ...: for each, it walks
//      the cell's mask words in row order and adds the marked rows'
//      grad/hess from shared memory in row order, in registers: a cell
//      with few rows costs a few adds (two rows' loads in flight per
//      step), a dense word (the sentinel's) is added from 32 staged
//      values by selects. The chain per launch is the densest cell's
//      rows, not the tile's 512 rows times K. Measured on the H100 the
//      fold is still about half of a block's time (PERF.md).
// A block holds at most kBlockCells cells' masks; past that the grid's
// second dimension splits the cells into even ranges, each block adding
// only codes in its range (each range reads the tile's codes again).
// mv_reduce stages the partials of 16 cells for kRedChunk tiles at a
// time in shared memory (cp.async, double-buffered) and one warp adds
// them in tile order; the tile count is read from the device count.
//
// Int32 mode: integer sums give the same bits in any order, so mv_quant
// lets the 1024 threads of about kQBlocks blocks take (slot, row)
// elements (four loads in flight) and add into one shared [T + 1, 2]
// int32 histogram by shared atomics; the sentinel cell, which every row
// hits, is summed in registers and added once per warp. The block's
// nonzero cells go into the zeroed output by global atomics: no
// partials. The rows per block are sized on the device from the count.
// Past kQSmemCells cells every element adds straight into the output.
//
// The fused learner sizes a child's launch by its parent's count
// (max_count) and passes the window on the device: tiles and blocks
// past the real count leave at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;                // rows per tile (MV_TILE)
constexpr int kWords = kTile / 32;        // mask words per cell
constexpr int kThreads = kTile;           // float mode: one row each
constexpr int kBlockCells = 2048;         // cells per float block
constexpr int kLoadBatch = 16;            // slot loads in flight
constexpr int kDense = 8;                 // set bits of a dense word
constexpr int kMaxSlots = 4096;
constexpr int kRedFloats = 32;            // reduce: 16 cells per block
constexpr int kRedChunk = 256;            // reduce: tiles per stage
constexpr int kRedThreads = 256;
constexpr int kQThreads = 1024;
constexpr long long kQBlocks = 132;       // int32 mode: one per SM
constexpr long long kQMinRows = 64;
constexpr int kSmemBudget = 232448;       // dynamic shared memory
constexpr int kQSmemCells = kSmemBudget / 8;

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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one mask word of a cell (32 rows from row 32 * k) added in row order
__device__ __forceinline__ void fold_word(unsigned m, const float* g,
                                          const float* h, float& ag,
                                          float& ah) {
  if (__popc(m) >= kDense) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {       // select, never add a zero
      const bool on = (m >> j) & 1u;
      const float a = ag + g[j];
      const float b = ah + h[j];
      ag = on ? a : ag;
      ah = on ? b : ah;
    }
  } else {              // two rows per step: both loads in flight
    while (m) {
      const int j0 = __ffs(m) - 1;
      m &= m - 1u;
      const bool two = m != 0u;
      const int j1 = two ? __ffs(m) - 1 : j0;
      m &= m - 1u;
      const float g0 = g[j0], h0 = h[j0], g1 = g[j1], h1 = h[j1];
      ag += g0;
      ah += h0;
      if (two) {
        ag += g1;
        ah += h1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
mv_tiles(const int32_t* __restrict__ slots, long long stride, int kp,
         const int32_t* __restrict__ gplane,
         const int32_t* __restrict__ hplane, Window win, int total_bins,
         int ncb, int round_bf16, float2* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;                                  // [kTile]
  float* sh = smem + kTile;                          // [kTile]
  unsigned* mask = reinterpret_cast<unsigned*>(smem + 2 * kTile);
  const int count = win.count();
  const int row0 = blockIdx.x * kTile;
  if (row0 >= count) return;                         // past the window
  const int rows = min(kTile, count - row0);
  const int cells = total_bins + 1;
  const int c0 = blockIdx.y * ncb;
  const int nc = min(ncb, cells - c0);
  const int tid = threadIdx.x;
  for (int i = tid; i < kWords * ncb; i += kThreads) mask[i] = 0u;
  const long long base = (long long)win.start() + row0;
  if (tid < rows) {
    float g = __int_as_float(gplane[base + tid]);
    float h = __int_as_float(hplane[base + tid]);
    if (round_bf16) {
      g = __bfloat162float(__float2bfloat16_rn(g));
      h = __bfloat162float(__float2bfloat16_rn(h));
    }
    sg[tid] = g;
    sh[tid] = h;
  }
  __syncthreads();
  if (tid < rows) {                    // 1. mark the row in its cells
    const int32_t* sp = slots + base + tid;
    unsigned* mrow = mask + (tid >> 5) * ncb;
    const unsigned bit = 1u << (tid & 31);
    for (int s0 = 0; s0 < kp; s0 += kLoadBatch) {
      int32_t code[kLoadBatch];
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        code[k] = s0 + k < kp ? sp[(long long)(s0 + k) * stride] : -1;
      }
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const unsigned local = (unsigned)(code[k] - c0);
        if (code[k] >= 0 && local < (unsigned)nc) atomicOr(mrow + local, bit);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < nc; c += kThreads) {     // 2. fold in row order
    unsigned m[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) m[k] = mask[k * ncb + c];
    float ag = 0.f, ah = 0.f;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if (m[k]) fold_word(m[k], sg + 32 * k, sh + 32 * k, ag, ah);
    }
    partials[(size_t)blockIdx.x * cells + c0 + c] = make_float2(ag, ah);
  }
}

// the tiles' partials in tile order: block b adds floats
// [b * kRedFloats, ...) of every tile's [cells2] row
__global__ void __launch_bounds__(kRedThreads)
mv_reduce(const float* __restrict__ partials, Window win, int grid_tiles,
          int cells2, float* __restrict__ out) {
  extern __shared__ __align__(16) float rbuf[];   // [2][kRedChunk][32]
  const int count = win.count();
  const int ntiles =
      (int)min((long long)grid_tiles, ceil_div(count, kTile));
  const int f0 = blockIdx.x * kRedFloats;
  const int nf = min(kRedFloats, cells2 - f0);
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int nchunks = (int)ceil_div(ntiles, kRedChunk);
  auto issue = [&](int ch) {
    const int t0 = ch * kRedChunk;
    const int nt = min(kRedChunk, ntiles - t0);
    float* b = rbuf + (ch & 1) * kRedChunk * kRedFloats;
    if (lane < nf) {
      for (int t = wp; t < nt; t += kRedThreads / 32) {
        cp_async4(b + t * kRedFloats + lane,
                  partials + (size_t)(t0 + t) * cells2 + f0 + lane);
      }
    }
    cp_async_commit();
  };
  float s = 0.f;
  if (nchunks > 0) issue(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      issue(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (wp == 0) {                                 // fixed tile order
      const int nt = min(kRedChunk, ntiles - ch * kRedChunk);
      const float* b = rbuf + (ch & 1) * kRedChunk * kRedFloats + lane;
      for (int t = 0; t < nt; ++t) s += b[t * kRedFloats];
    }
    __syncthreads();                  // the buffer is issued again next
  }
  if (wp == 0 && lane < nf) out[f0 + lane] = s;
}

// kShared: the histogram lives in shared memory (zeroed, then folded
// into `out`); otherwise every element adds straight into `out`
template <bool kShared>
__global__ void __launch_bounds__(kQThreads)
mv_quant(const int32_t* __restrict__ slots, long long stride, int kp,
         const int32_t* __restrict__ words, Window win, int total_bins,
         int32_t* __restrict__ out) {
  extern __shared__ int32_t qhist[];               // [cells][2]
  const int count = win.count();
  const long long rpb = ceil_div(count, kQBlocks) > kQMinRows
                            ? ceil_div(count, kQBlocks)
                            : kQMinRows;
  const long long row0 = (long long)blockIdx.x * rpb;
  if (row0 >= count) return;                       // the whole block
  const int rows = (int)min(rpb, (long long)count - row0);
  const int cells2 = (total_bins + 1) * 2;
  int32_t* hist = kShared ? qhist : out;
  if (kShared) {
    for (int i = threadIdx.x; i < cells2; i += kQThreads) hist[i] = 0;
    __syncthreads();
  }
  const long long base = (long long)win.start() + row0;
  const int32_t* sp = slots + base;
  const int32_t* wp = words + base;
  // element (s, r) = s * rows + r, advanced by kQThreads without dividing
  int s = threadIdx.x / rows, r = threadIdx.x % rows;
  const int ds = kQThreads / rows, dr = kQThreads % rows;
  int32_t tg = 0, th = 0;                          // the sentinel's sums
  while (s < kp) {
    int32_t code[4], wd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      code[k] = -1;
      wd[k] = 0;
      if (s < kp) {
        code[k] = sp[(long long)s * stride + r];
        wd[k] = wp[r];
      }
      s += ds;
      r += dr;
      if (r >= rows) {
        r -= rows;
        ++s;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((unsigned)code[k] > (unsigned)total_bins) continue;
      const int32_t qg = wd[k] >> 16;      // arithmetic: qg keeps its sign
      const int32_t qh = wd[k] & 0xFFFF;
      if (code[k] == total_bins) {
        tg += qg;
        th += qh;
      } else {
        int32_t* cell = hist + 2 * code[k];
        if (qg) atomicAdd(cell, qg);
        if (qh) atomicAdd(cell + 1, qh);
      }
    }
  }
  tg = __reduce_add_sync(0xFFFFFFFFu, tg);
  th = __reduce_add_sync(0xFFFFFFFFu, th);
  if ((threadIdx.x & 31) == 0) {
    if (tg) atomicAdd(hist + 2 * total_bins, tg);
    if (th) atomicAdd(hist + 2 * total_bins + 1, th);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells2; i += kQThreads) {
      const int32_t v = hist[i];
      if (v) atomicAdd(out + i, v);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

int launch_float(const int32_t* slots, long long stride, int kp,
                 const int32_t* gplane, const int32_t* hplane, Window win,
                 int max_count, int total_bins, int round_bf16,
                 float* partials, float* out, cudaStream_t s) {
  const int cells = total_bins + 1;
  const int grid_tiles = (int)(max_count > kTile
                                   ? ceil_div(max_count, kTile) : 1);
  cudaError_t e;
  if (max_count > 0) {
    // cells per block: all of them up to kBlockCells, else even ranges
    const int ny = (int)ceil_div(cells, kBlockCells);
    const int ncb = (int)ceil_div(cells, ny);
    if (ny > 65535) return (int)cudaErrorInvalidValue;
    const int smem = (2 * kTile + kWords * ncb) * 4;
    if ((e = allow_smem(mv_tiles, smem)) != cudaSuccess) return (int)e;
    mv_tiles<<<dim3(grid_tiles, ny), kThreads, smem, s>>>(
        slots, stride, kp, gplane, hplane, win, total_bins, ncb, round_bf16,
        reinterpret_cast<float2*>(partials));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const int rsmem = 2 * kRedChunk * kRedFloats * 4;
  if ((e = allow_smem(mv_reduce, rsmem)) != cudaSuccess) return (int)e;
  mv_reduce<<<(int)ceil_div(2 * cells, kRedFloats), kRedThreads, rsmem, s>>>(
      partials, win, grid_tiles, 2 * cells, out);
  return (int)cudaGetLastError();
}

int launch_quant(const int32_t* slots, long long stride, int kp,
                 const int32_t* words, Window win, int max_count,
                 int total_bins, int32_t* out, cudaStream_t s) {
  const int cells = total_bins + 1;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)cells * 2 * 4, s);
  if (e != cudaSuccess || max_count == 0) return (int)e;
  // enough blocks for any count <= max_count (mv_quant sizes its rows
  // from the device count: max(kQMinRows, ceil(count / kQBlocks)))
  const int nblocks = (int)(ceil_div(max_count, kQMinRows) < kQBlocks
                                ? ceil_div(max_count, kQMinRows)
                                : kQBlocks);
  if (cells <= kQSmemCells) {
    const int smem = cells * 8;
    if ((e = allow_smem(mv_quant<true>, smem)) != cudaSuccess) return (int)e;
    mv_quant<true><<<nblocks, kQThreads, smem, s>>>(
        slots, stride, kp, words, win, total_bins, out);
  } else {                            // beyond shared memory
    mv_quant<false><<<nblocks, kQThreads, 0, s>>>(
        slots, stride, kp, words, win, total_bins, out);
  }
  return (int)cudaGetLastError();
}

int dispatch(const int32_t* slots, long long stride, int kp,
             const int32_t* gplane, const int32_t* hplane, Window win,
             int max_count, int total_bins, int round_bf16, int quant,
             void* partials, void* out, void* stream) {
  if (kp < 1 || kp > kMaxSlots || total_bins < 0 || max_count < 0 ||
      (long long)(total_bins + 1) * 2 > 0x7FFFFFFFLL ||
      (!quant && partials == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (quant) {
    return launch_quant(slots, stride, kp, gplane, win, max_count,
                        total_bins, static_cast<int32_t*>(out), s);
  }
  return launch_float(slots, stride, kp, gplane, hplane, win, max_count,
                      total_bins, round_bf16, static_cast<float*>(partials),
                      static_cast<float*>(out), s);
}

}  // namespace

extern "C" {

int lgbt_mv_tile() { return kTile; }
int lgbt_mv_max_slots() { return kMaxSlots; }
// cells one float-mode block holds (past that the cells are split over
// the grid) and cells the int32 mode's shared histogram holds
int lgbt_mv_smem_cells() { return kBlockCells; }
int lgbt_mv_quant_smem_cells() { return kQSmemCells; }

// Planar-state entry (histogram_multival_planar). data: [P, R] int32;
// win_start / win_count: device int32 scalars or null (then start_h /
// count_h); max_count bounds the count and sizes the launch. partials
// (float modes; null under quant): max(1, ceil(max_count / kTile)) *
// (total_bins + 1) * 2 floats. quant: the grad plane holds packed
// levels and out is int32.
int lgbt_hist_multival_planar(const int32_t* data, long long R,
                              const int32_t* win_start,
                              const int32_t* win_count, int start_h,
                              int count_h, int max_count, int mv_start,
                              int mv_planes, int grad_plane, int total_bins,
                              int round_bf16, int quant, void* partials,
                              void* out, void* stream) {
  const Window w{win_start, win_count, start_h, count_h};
  return dispatch(data + (long long)mv_start * R, R, mv_planes,
                  data + (long long)grad_plane * R,
                  data + (long long)(grad_plane + 1) * R, w, max_count,
                  total_bins, round_bf16, quant, partials, out, stream);
}

// Slot-major entry (histogram_multival_pallas). codes: [kp, C] int32;
// gh: [8, C] int32 lane planes, rows 0/1 = bitcast float32 grad/hess,
// or row 0 = packed levels when quant (pre-masked by the caller).
// partials as above with max_count = C.
int lgbt_hist_multival(const int32_t* codes, const int32_t* gh, int kp,
                       int C, int total_bins, int round_bf16, int quant,
                       void* partials, void* out, void* stream) {
  const Window w{nullptr, nullptr, 0, C};
  return dispatch(codes, C, kp, gh, gh + C, w, C, total_bins, round_bf16,
                  quant, partials, out, stream);
}

}  // extern "C"
