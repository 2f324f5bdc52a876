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
//
// Quantized mode (both TPU kernels' quant=True): the grad plane (B5) or
// lane row 0 (B6) holds one packed (qg << 16) | (qh & 0xFFFF) word per
// row; each row's word is unpacked (arithmetic >> 16, & 0xFFFF) before
// it is added, and the levels are summed exactly in int32: output
// [T + 1, 2] int32. The same template serves both modes; integer sums
// give the same bits in any order.
//
// What bounds it on the card: bytes. The least work reads each row's K
// slot words and its grad/hess once (count * (K + 2) * 4 bytes) and
// writes [T + 1, 2]. This version is latency bound instead: each warp
// walks its rows one at a time.
//
// Design. One warp owns a tile of kTile rows and a private histogram:
// in shared memory when (T + 1) fits, else its slice of the global
// partials. The warp stages a few rows' slot codes (coalesced over
// rows), then takes the rows in order; lane l adds the row's slots l,
// l + 32, ... A row's present codes are distinct cells (one per group,
// plus the sentinel), so the lanes never collide inside a row, and a
// __syncwarp after each row orders the read-modify-writes of one cell
// across rows: every cell is summed in row order, with no atomics.
// Pass 2 sums the tiles' partials in tile order. The plain PyTorch
// version (ops/multival.py) sums in the same association, so the two
// agree bit for bit on the CPU, and every launch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 512;          // rows per warp tile
constexpr int kWarps = 4;           // warps (tiles) per block
constexpr int kStage = 2048;        // staged slot words per warp
constexpr int kMaxRowsStaged = 32;
constexpr int kSmemHistMax = 192 * 1024;   // shared bytes for histograms

struct Window {
  const int32_t* start_d;   // device scalars, or null
  const int32_t* count_d;
  int start_h;
  int count_h;
};

__device__ __forceinline__ int win_start(const Window& w) {
  return w.start_d ? w.start_d[0] : w.start_h;
}
__device__ __forceinline__ int win_count(const Window& w) {
  return w.count_d ? w.count_d[0] : w.count_h;
}

// kQuant: packed levels in gplane (hplane unused), int32 sums
template <bool kQuant>
struct Mode {
  using Acc = float;
  using Acc2 = float2;
};
template <>
struct Mode<true> {
  using Acc = int32_t;
  using Acc2 = int2;
};

template <bool kSmemHist, bool kQuant>
__global__ void __launch_bounds__(32 * kWarps)
mv_partials(const int32_t* __restrict__ slots, long long plane_stride,
            int kp, int stage_words, const int32_t* __restrict__ gplane,
            const int32_t* __restrict__ hplane, Window w, int total_bins,
            int round_bf16,
            typename Mode<kQuant>::Acc2* __restrict__ partials) {
  using Acc = typename Mode<kQuant>::Acc;
  using Acc2 = typename Mode<kQuant>::Acc2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = win_start(w);
  const int count = win_count(w);
  const int tile = blockIdx.x * kWarps + warp;
  const int row0 = tile * kTile;
  if (row0 >= count) return;          // past the window: tile unused
  const int rows = min(kTile, count - row0);
  const int cells = total_bins + 1;

  // shared layout: int32 stage[kWarps][stage_words],
  // Acc gh[kWarps][2][kMaxRowsStaged], Acc2 hist[kWarps][cells]
  int32_t* stage_all = reinterpret_cast<int32_t*>(smem);
  Acc* gh_all = reinterpret_cast<Acc*>(stage_all + kWarps * stage_words);
  int32_t* stage = stage_all + warp * stage_words;
  Acc* sg = gh_all + warp * 2 * kMaxRowsStaged;
  Acc* sh = sg + kMaxRowsStaged;
  Acc2* hist = kSmemHist
      ? reinterpret_cast<Acc2*>(gh_all + kWarps * 2 * kMaxRowsStaged) +
            (size_t)warp * cells
      : partials + (size_t)tile * cells;
  for (int c = lane; c < cells; c += 32) hist[c] = Acc2{0, 0};
  __syncwarp();

  const int rps = stage_words / kp;   // rows per stage
  const long long base = (long long)start + row0;
  for (int r0 = 0; r0 < rows; r0 += rps) {
    const int nr = min(rps, rows - r0);
    for (int i = lane; i < kp * nr; i += 32) {
      const int s = i / nr;
      const int r = i - s * nr;
      stage[s * nr + r] = slots[(long long)s * plane_stride + base + r0 + r];
    }
    if (lane < nr) {
      if constexpr (kQuant) {
        const int32_t wd = gplane[base + r0 + lane];
        sg[lane] = wd >> 16;    // arithmetic shift: qg keeps its sign
        sh[lane] = wd & 0xFFFF;
      } else {
        float g = __int_as_float(gplane[base + r0 + lane]);
        float h = __int_as_float(hplane[base + r0 + lane]);
        if (round_bf16) {
          g = __bfloat162float(__float2bfloat16_rn(g));
          h = __bfloat162float(__float2bfloat16_rn(h));
        }
        sg[lane] = g;
        sh[lane] = h;
      }
    }
    __syncwarp();
    for (int r = 0; r < nr; ++r) {    // fixed row order
      const Acc g = sg[r];
      const Acc h = sh[r];
      for (int s = lane; s < kp; s += 32) {
        const int c = stage[s * nr + r];
        if (c >= 0 && c <= total_bins) {
          Acc2 v = hist[c];
          v.x += g;
          v.y += h;
          hist[c] = v;
        }
      }
      __syncwarp();
    }
  }
  if (kSmemHist) {
    Acc2* dst = partials + (size_t)tile * cells;
    for (int c = lane; c < cells; c += 32) dst[c] = hist[c];
  }
}

template <typename Acc2>
__global__ void mv_reduce(const Acc2* __restrict__ partials, Window w,
                          int grid_tiles, int cells,
                          Acc2* __restrict__ out) {
  const int count = win_count(w);
  const int ntiles = min(grid_tiles, (count + kTile - 1) / kTile);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  Acc2 s{0, 0};
  for (int t = 0; t < ntiles; ++t) {  // fixed tile order
    const Acc2 p = partials[(size_t)t * cells + c];
    s.x += p.x;
    s.y += p.y;
  }
  out[c] = s;
}

// staged slot words per warp: kp slots of up to kMaxRowsStaged rows
int stage_words_for(int kp) {
  int rps = kStage / kp;
  if (rps > kMaxRowsStaged) rps = kMaxRowsStaged;
  return kp * rps;
}

size_t stage_bytes(int stage_words) {
  return (size_t)kWarps * stage_words * 4 +
         (size_t)kWarps * 2 * kMaxRowsStaged * 4;
}

template <bool kQuant>
int launch(const int32_t* slots, long long plane_stride, int kp,
           const int32_t* gplane, const int32_t* hplane, Window w,
           int max_count, int total_bins, int round_bf16, void* partials,
           void* out, void* stream) {
  using Acc2 = typename Mode<kQuant>::Acc2;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (kp < 1 || kp > kStage || total_bins < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int cells = total_bins + 1;
  int grid_tiles = (max_count + kTile - 1) / kTile;
  if (grid_tiles < 1) grid_tiles = 1;
  const int blocks = (grid_tiles + kWarps - 1) / kWarps;
  Acc2* parts = static_cast<Acc2*>(partials);
  const size_t hist_bytes = (size_t)kWarps * cells * sizeof(Acc2);
  const int sw = stage_words_for(kp);
  cudaError_t e;
  if (hist_bytes <= (size_t)kSmemHistMax) {
    const size_t bytes = stage_bytes(sw) + hist_bytes;
    e = cudaFuncSetAttribute(mv_partials<true, kQuant>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    mv_partials<true, kQuant><<<blocks, 32 * kWarps, bytes, s>>>(
        slots, plane_stride, kp, sw, gplane, hplane, w, total_bins,
        round_bf16, parts);
  } else {
    mv_partials<false, kQuant><<<blocks, 32 * kWarps, stage_bytes(sw), s>>>(
        slots, plane_stride, kp, sw, gplane, hplane, w, total_bins,
        round_bf16, parts);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mv_reduce<Acc2><<<(cells + 255) / 256, 256, 0, s>>>(
      parts, w, grid_tiles, cells, static_cast<Acc2*>(out));
  return (int)cudaGetLastError();
}

int dispatch(const int32_t* slots, long long plane_stride, int kp,
             const int32_t* gplane, const int32_t* hplane, Window w,
             int max_count, int total_bins, int round_bf16, int quant,
             void* partials, void* out, void* stream) {
  if (quant) {
    return launch<true>(slots, plane_stride, kp, gplane, hplane, w,
                        max_count, total_bins, 0, partials, out, stream);
  }
  return launch<false>(slots, plane_stride, kp, gplane, hplane, w, max_count,
                       total_bins, round_bf16, partials, out, stream);
}

}  // namespace

extern "C" {

int lgbt_mv_tile() { return kTile; }
int lgbt_mv_max_slots() { return kStage; }
int lgbt_mv_smem_cells() {
  return kSmemHistMax / (kWarps * (int)sizeof(float2));
}

// Planar-state entry (histogram_multival_planar). data: [P, R] int32;
// win_start / win_count: device int32 scalars or null (then start_h /
// count_h); max_count bounds the count and sizes the launch. partials:
// max(1, ceil(max_count / kTile)) * (total_bins + 1) * 2 floats (int32
// when quant: the grad plane then holds packed levels).
int lgbt_hist_multival_planar(const int32_t* data, long long R,
                              const int32_t* win_start,
                              const int32_t* win_count, int start_h,
                              int count_h, int max_count, int mv_start,
                              int mv_planes, int grad_plane, int total_bins,
                              int round_bf16, int quant, void* partials,
                              void* out, void* stream) {
  Window w{win_start, win_count, start_h, count_h};
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
  Window w{nullptr, nullptr, 0, C};
  return dispatch(codes, C, kp, gh, gh + C, w, C, total_bins, round_bf16,
                  quant, partials, out, stream);
}

}  // extern "C"
