// Stable in-place partition of a leaf window of the planar state.
//
// Replaces the TPU kernels lightgbm_tpu/ops/plane.py partition_pallas2
// (_partition_kernel2) and partition_pallas (_partition_kernel): both
// entries share this one kernel. Contract: every one of the P planes
// of the [P, R] int32 state moves; inside the lane window
// [start, start+count) the rows routed left come first, then the rows
// routed right, each side in its original order; lanes outside the
// window are not touched; the left count is written to nleft[0].
//
// Routing is _route_from_col32 (plane.py:341-366) as device code: the
// split column's code is pulled from its packed plane word with a
// logical shift, decoded through the EFB bundle tables, compared with
// the threshold bin, with the missing bin sent by default_left; a
// categorical split tests membership in an 8-word bitset (missing
// categoricals are out of the set, so they go right).
//
// What bounds it on the card: bytes. The least work reads and writes
// each of the window's P plane words once (2 * P * 4 bytes per lane, P =
// 16 at HIGGS width, 128 at the wide-sparse shape). Most of a tree's
// partitions are of small windows, where launches set the pace. Two
// routes, chosen by the window's shape alone (part_is_small below,
// ops/plane.py partition_small):
//
//   - small window (P + 1) * count * 4 <= kSmallBytes: part_small, ONE
//     launch of one block, in place. It loads every plane of the window
//     into shared memory, routes the lanes, ranks them by warp ballots
//     and a scan of the warp counts, and writes every word back to its
//     place. No scratch, no second launch.
//   - large window: two launches, about 4 * P * 4 + 4 bytes per lane
//     (twice the bound), every access coalesced.
//       1. part_tiles, a single-pass tile kernel. Each block takes a
//          tile of kTile lanes (and a group of planes) in launch order
//          through a global ticket, so that the look-back below cannot
//          wait on a block that has not started. It routes its tile
//          (one coalesced read of the split column's plane), ranks the
//          lanes inside the tile by warp ballots and a scan of the 64
//          warp counts, and gets the lefts of all earlier tiles by
//          decoupled look-back over per-tile status words (aggregate,
//          then inclusive prefix). The status words carry the call's
//          epoch, so words of earlier calls read as "not ready" and no
//          memset is needed per call. The epoch is a device word beside
//          the ticket: every block reads it before it draws its ticket,
//          and the block that draws the last ticket resets the ticket
//          and advances the epoch, so a launch captured in a CUDA graph
//          gets a fresh epoch on every replay. Then plane by plane it copies the
//          tile's words into a [P, count] scratch: the lefts from the
//          front at their final rank, the rights from the back in
//          reverse order (nleft is not known until the last tile). The
//          32 lanes of a warp are 32 consecutive lanes of the window, so
//          their lefts land in one contiguous run and their rights in
//          another: each warp's store is at most two coalesced runs.
//          When the window has few tiles, a tile's planes are split
//          into groups over more blocks (each routes the tile again and
//          looks back on its own chain), so a window of a few thousand
//          lanes at P = 128 still spreads over the card.
//       2. part_copyback: data[:, start + i] takes the front word i for
//          i < nleft, else the back word count - 1 - (i - nleft).
//
// Two entries. lgbt_partition takes the window as host ints and
// chooses the route on the host. lgbt_partition_dev reads the window
// (start, count) from device memory, so a learner can partition a leaf
// whose window only the device knows (and a CUDA graph can replay the
// launch): its launches are sized by a bound on the count that the
// caller holds, all three kernels are enqueued, and each one checks the
// route on the device and leaves at once when the other route applies;
// part_tiles' blocks past the window's own tile and group count leave
// before they draw a ticket.
//
// Integer only: the result is the same on every launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;   // lanes per tile
constexpr int kSmallThreads = 1024;
constexpr int kBatch = 16;                 // part_small: loads in flight
// the small-window rule (ops/plane.py PART_SMALL_BYTES holds the same)
constexpr long long kSmallBytes = 200 * 1024;
constexpr long long kSpreadBlocks = 264;   // 2 x 132 SMs
constexpr int kRouteScalars = 19;
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kItems * kWarps == 64, "one warp scans two counts a lane");

__host__ __device__ inline bool part_is_small(long long P, long long count) {
  return count * (P + 1) * 4 <= kSmallBytes;
}

// planes per block of part_tiles: all of them, unless the window has
// too few tiles to spread over about kSpreadBlocks blocks; groups of at
// least 8 planes
__host__ __device__ inline int planes_per_group(int P, int ntiles) {
  long long want = (kSpreadBlocks + ntiles - 1) / ntiles;
  const long long most = (P + 7) / 8;
  if (want > most) want = most;
  if (want < 1) want = 1;
  return (int)((P + want - 1) / want);
}

// plane.py _route_from_col32; rs layout (route_scalars):
// [plane, shift, mask, thr, dl, miss, efb_use, efb_off, efb_nsl,
//  efb_skip, is_cat, bitset_w0..w7]
__device__ __forceinline__ int route_left(uint32_t col32,
                                          const int32_t* rs) {
  const int code = (int)((col32 >> (uint32_t)rs[1]) & (uint32_t)rs[2]);
  const int rel = code - rs[7];
  const bool inband = rel >= 0 && rel < rs[8];
  const int dec = rel + (rel >= rs[9] ? 1 : 0);
  const int efb_bin = inband ? dec : rs[9];
  const int binval = rs[6] == 1 ? efb_bin : code;
  const int num_left = binval <= rs[3] ? 1 : 0;
  const uint32_t widx = (uint32_t)binval >> 5;
  const int word = widx < 8 ? rs[11 + widx] : 0;
  const int cat_left = (int)(((uint32_t)word >> (binval & 31)) & 1u);
  const int dec_lr = rs[10] == 1 ? cat_left : num_left;
  const bool is_miss = binval == rs[5] && rs[5] >= 0 && rs[10] == 0;
  return (is_miss ? rs[4] : dec_lr) == 1 ? 1 : 0;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// the lane window: (start, count) in device memory, or host ints when
// the pointer is null
struct Window {
  const int32_t* p;
  int start_h;
  int count_h;
  __device__ int start() const { return p ? p[0] : start_h; }
  __device__ int count() const { return p ? p[1] : count_h; }
};

__global__ void __launch_bounds__(kSmallThreads)
part_small(int32_t* __restrict__ data, long long R, int P, Window win,
           int gate, const int32_t* __restrict__ rscal,
           int32_t* __restrict__ nleft) {
  extern __shared__ int32_t sbuf[];    // [P][count] words, then [count] ranks
  __shared__ int32_t rs[kRouteScalars];
  __shared__ int s_cnt[32];
  __shared__ int s_carry, s_next;
  const int count = win.count();
  if (gate && !part_is_small(P, count)) return;   // the tiles' window
  const int start = win.start();
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t < kRouteScalars) rs[t] = rscal[t];
  if (t == 0) s_carry = 0;
  const int total = P * count;
  // kBatch words' loads in flight per thread: one block has to keep the
  // memory system busy on its own
  for (int idx0 = t; idx0 < total; idx0 += kSmallThreads * kBatch) {
    int32_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = idx0 + k * kSmallThreads;
      if (idx < total) {
        const int p = idx / count;
        v[k] = data[(long long)p * R + start + (idx - p * count)];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = idx0 + k * kSmallThreads;
      if (idx < total) sbuf[idx] = v[k];
    }
  }
  __syncthreads();
  // rank: a lane's left rank, or ~(its right rank)
  int32_t* rank = sbuf + total;
  const int32_t* col = sbuf + (long long)rs[0] * count;
  for (int b = 0; b < count; b += kSmallThreads) {
    const int i = b + t;
    const bool left = i < count && route_left((uint32_t)col[i], rs);
    const unsigned m = __ballot_sync(kFull, left);
    if (lane == 0) s_cnt[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int v = s_cnt[lane];
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      const int carry = s_carry;
      __syncwarp();
      s_cnt[lane] = carry + incl - v;
      if (lane == 31) s_next = carry + incl;
    }
    __syncthreads();
    if (i < count) {
      const int lr = s_cnt[warp] + __popc(m & lanes_below(lane));
      rank[i] = left ? lr : ~(i - lr);
    }
    if (t == 0) s_carry = s_next;
  }
  __syncthreads();
  const int nl = s_carry;
  if (t == 0) nleft[0] = nl;
#pragma unroll 8
  for (int idx = t; idx < total; idx += kSmallThreads) {
    const int p = idx / count;
    const int r = rank[idx - p * count];
    data[(long long)p * R + start + (r >= 0 ? r : nl + ~r)] = sbuf[idx];
  }
}

// status word: (epoch * 2 + inclusive) << 32 | value
__device__ __forceinline__ void publish(unsigned long long* w,
                                        unsigned epoch, unsigned inclusive,
                                        int value) {
  atomicExch(w, ((unsigned long long)(epoch * 2u + inclusive) << 32) |
                    (unsigned)value);
}

// one warp: the lefts of tiles [0, tile) of this chain, summed from the
// nearest predecessors back to the first inclusive prefix
__device__ int look_back(const unsigned long long* st, int tile,
                         unsigned epoch, int lane) {
  int prefix = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int idx = pred - lane;       // lane 0 is the nearest tile
    unsigned long long w;
    int state;                         // 0 not ready, 1 aggregate, 2 prefix
    do {
      w = 0ull;
      state = 2;                       // before tile 0: nothing to add
      if (idx >= 0) {
        w = *reinterpret_cast<const volatile unsigned long long*>(st + idx);
        const unsigned tag = (unsigned)(w >> 32);
        state = (tag >> 1) == epoch ? 1 + (int)(tag & 1u) : 0;
      }
    } while (__any_sync(kFull, state == 0));
    const unsigned incl = __ballot_sync(kFull, state == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= stop ? (int)(unsigned)w : 0;
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    prefix += v;
    if (incl) return prefix;
  }
}

__global__ void __launch_bounds__(kThreads)
part_tiles(const int32_t* __restrict__ data, long long R, int P, Window win,
           int gate, const int32_t* __restrict__ rscal,
           unsigned long long* __restrict__ status,
           int32_t* __restrict__ scratch, int32_t* __restrict__ nleft) {
  __shared__ int32_t rs[kRouteScalars];
  __shared__ int s_cnt[kItems * kWarps];  // item-major: k * kWarps + warp
  __shared__ int s_ticket, s_prefix;
  __shared__ unsigned s_epoch;
  const int count = win.count();
  if (gate && part_is_small(P, count)) return;    // the one-block window
  const int start = win.start();
  const int ntiles = (count + kTile - 1) / kTile;
  const int pg = planes_per_group(P, ntiles);
  const int groups = (P + pg - 1) / pg;
  // blocks past this window's own grid (a launch sized by a bound)
  // leave before they draw a ticket, so the tickets drawn are exactly
  // [0, ntiles * groups)
  if ((long long)blockIdx.x >= (long long)ntiles * groups) return;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) {
    // word 0 of the status words: the ticket (low half) and the epoch
    // (high half; 0 before the first launch reads as 1)
    unsigned* ticket = reinterpret_cast<unsigned*>(status);
    volatile unsigned* epoch_w = ticket + 1;
    const unsigned raw = *epoch_w;
    const unsigned epoch = raw ? raw : 1u;
    __threadfence();                   // the epoch is read before the draw
    const unsigned tk = atomicAdd(ticket, 1u);
    // every block draws once: the last ticket's holder resets the ticket
    // and advances the epoch for the next launch (every block of this
    // one has read it already)
    if (tk == (unsigned)(ntiles * groups) - 1u) {
      atomicExch(ticket, 0u);
      __threadfence();
      atomicExch(const_cast<unsigned*>(epoch_w),
                 epoch + 1u < 0x80000000u ? epoch + 1u : 1u);
    }
    s_ticket = (int)tk;
    s_epoch = epoch;
  }
  if (t < kRouteScalars) rs[t] = rscal[t];
  __syncthreads();
  const unsigned epoch = s_epoch;
  const int tile = s_ticket / groups;
  const int g = s_ticket - tile * groups;
  unsigned long long* st = status + 1 + (size_t)g * ntiles;
  const int base = tile * kTile;
  const int n_here = min(kTile, count - base);

  // route: lane i = k * kThreads + t of the tile (coalesced)
  const int32_t* col = data + (long long)rs[0] * R + start + base;
  uint32_t cw[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + t;
    cw[k] = i < n_here ? (uint32_t)col[i] : 0u;
  }
  unsigned m[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool left = k * kThreads + t < n_here && route_left(cw[k], rs);
    m[k] = __ballot_sync(kFull, left);
    if (lane == 0) s_cnt[k * kWarps + warp] = __popc(m[k]);
  }
  __syncthreads();
  if (warp == 0) {
    // the 64 counts in lane order: lane L holds counts 2L and 2L + 1
    const int a = s_cnt[2 * lane], b = s_cnt[2 * lane + 1];
    int incl = a + b;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    __syncwarp();
    s_cnt[2 * lane] = incl - a - b;
    s_cnt[2 * lane + 1] = incl - b;
    const int tile_left = __shfl_sync(kFull, incl, 31);
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) publish(st, epoch, 1u, tile_left);
    } else {
      if (lane == 0) publish(st + tile, epoch, 0u, tile_left);
      prefix = look_back(st, tile, epoch, lane);
      if (lane == 0) publish(st + tile, epoch, 1u, prefix + tile_left);
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (g == 0 && tile == ntiles - 1) nleft[0] = prefix + tile_left;
    }
  }
  __syncthreads();

  // each lane's place in the scratch: lefts from the front, rights from
  // the back; -1 past the window
  const int left_before = s_prefix;
  const int right_before = base - left_before;
  int dst[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + t;
    const int lr = s_cnt[k * kWarps + warp] + __popc(m[k] & lanes_below(lane));
    const bool left = (m[k] >> lane) & 1u;
    dst[k] = i >= n_here ? -1
             : left      ? left_before + lr
                         : count - 1 - (right_before + i - lr);
  }
  const int p1 = min(P, (g + 1) * pg);
#pragma unroll 2
  for (int p = g * pg; p < p1; ++p) {
    const int32_t* src = data + (long long)p * R + start + base;
    int32_t* out = scratch + (long long)p * count;
    int32_t v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (dst[k] >= 0) v[k] = src[k * kThreads + t];
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (dst[k] >= 0) out[dst[k]] = v[k];
    }
  }
}

__global__ void part_copyback(const int32_t* __restrict__ scratch,
                              int32_t* __restrict__ data, long long R, int P,
                              Window win, int gate,
                              const int32_t* __restrict__ nleft_p) {
  const int count = win.count();
  if (gate && part_is_small(P, count)) return;
  const int start = win.start();
  const int nl = nleft_p[0];
  const int p = blockIdx.y;
  const int32_t* src = scratch + (long long)p * count;
  int32_t* dst = data + (long long)p * R + start;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    dst[i] = src[i < nl ? i : count - 1 + nl - i];
  }
}

// the most blocks and status words a part_tiles launch needs for any
// count up to `bound` (its tiles times plane groups, plus the ticket)
long long dev_max_blocks(int P, int bound) {
  const int tmax = (bound + kTile - 1) / kTile;
  long long most = 1;
  for (int t = 1; t <= tmax; ++t) {
    const long long b = (long long)t * ((P + planes_per_group(P, t) - 1) /
                                        planes_per_group(P, t));
    if (b > most) most = b;
  }
  return most;
}

// the largest count that takes the one-block route at P planes
long long small_cap(int P) { return kSmallBytes / (4LL * (P + 1)); }

cudaError_t allow_small_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(part_small,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

int lgbt_partition_tile() { return kTile; }

// 1 when a window of `count` lanes of a P-plane state takes the one-block
// in-place route (no scratch, no status words)
int lgbt_partition_small(int P, int count) {
  return part_is_small(P, count) ? 1 : 0;
}

// status words (uint64) the large route needs: word 0 (the ticket and
// the epoch), then one word per (plane group, tile); 0 for a small window
long long lgbt_partition_status_words(int P, int count) {
  if (part_is_small(P, count)) return 0;
  const int ntiles = (count + kTile - 1) / kTile;
  const int pg = planes_per_group(P, ntiles);
  return 1 + (long long)((P + pg - 1) / pg) * ntiles;
}

// status words of lgbt_partition_dev for counts up to `bound`; 0 when
// every such count takes the one-block route
long long lgbt_partition_dev_status_words(int P, int bound) {
  if (part_is_small(P, bound)) return 0;
  return 1 + dev_max_blocks(P, bound);
}

// scratch: [P * count] int32 and status: lgbt_partition_status_words
// uint64 words (zero when first made; word 0 keeps the ticket and the
// epoch between calls, so calls that share `status` must be ordered on
// one stream), both NULL for a small window. nleft: [1] int32.
int lgbt_partition(int32_t* data, long long R, int P, int start, int count,
                   const int32_t* rscal, int32_t* scratch,
                   unsigned long long* status, int32_t* nleft, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (P < 1 || count < 0) return (int)cudaErrorInvalidValue;
  const Window win{nullptr, start, count};
  if (part_is_small(P, count)) {
    const int smem = (P + 1) * count * 4;
    if ((e = allow_small_smem(smem)) != cudaSuccess) return (int)e;
    part_small<<<1, kSmallThreads, smem, s>>>(data, R, P, win, 0, rscal,
                                              nleft);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || status == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntiles = (count + kTile - 1) / kTile;
  const int pg = planes_per_group(P, ntiles);
  const int groups = (P + pg - 1) / pg;
  part_tiles<<<ntiles * groups, kThreads, 0, s>>>(data, R, P, win, 0, rscal,
                                                  status, scratch, nleft);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  int gx = (count + 1023) / 1024;
  if (gx > 2048) gx = 2048;
  part_copyback<<<dim3(gx, P), 256, 0, s>>>(scratch, data, R, P, win, 0,
                                            nleft);
  return (int)cudaGetLastError();
}

// The device-window entry: win = [2] int32 (start, count) in device
// memory, count <= bound (the caller's bound, a host int). scratch:
// [P * bound] int32 and status: lgbt_partition_dev_status_words(P, bound)
// uint64 words (zero when first made; ordered on one stream), both may be
// NULL when that is 0. Every launch is sized by `bound` alone, so the
// host reads nothing of the window; the route is chosen on the device.
int lgbt_partition_dev(int32_t* data, long long R, int P, const int32_t* win,
                       int bound, const int32_t* rscal, int32_t* scratch,
                       unsigned long long* status, int32_t* nleft,
                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (P < 1 || bound < 0 || win == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Window w{win, 0, 0};
  const long long cap = small_cap(P) < bound ? small_cap(P) : bound;
  const int smem = (int)((P + 1) * cap * 4);
  if ((e = allow_small_smem(smem)) != cudaSuccess) return (int)e;
  part_small<<<1, kSmallThreads, smem, s>>>(data, R, P, w, 1, rscal, nleft);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (part_is_small(P, bound)) return (int)cudaSuccess;
  if (scratch == nullptr || status == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  part_tiles<<<(unsigned)dev_max_blocks(P, bound), kThreads, 0, s>>>(
      data, R, P, w, 1, rscal, status, scratch, nleft);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // a grid-stride copy: a few thousand blocks whatever the bound, so a
  // small window does not pay for a grid of empty blocks
  int gx = (bound + 1023) / 1024;
  const int most = 4096 / P > 1 ? 4096 / P : 1;
  if (gx > most) gx = most;
  part_copyback<<<dim3(gx, P), 256, 0, s>>>(scratch, data, R, P, w, 1,
                                            nleft);
  return (int)cudaGetLastError();
}

}  // extern "C"
