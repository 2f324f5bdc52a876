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
// the window's P words per row once (2 * P * 4 bytes per row, P = 16 at
// HIGGS width). This version moves them twice — read, write to scratch,
// read scratch, write back — plus one plane read to route: a four-pass
// design
// that is simple and exact (integer only): it pays the copy back and
// the uncoalesced scatter; later work fuses the scatter and the copy.
//
//   1. part_flags: route every lane once, store a byte flag, reduce a
//      left count per tile of kTile lanes.
//   2. part_scan: one block scans the tile counts (CUB BlockScan) into
//      tile offsets and the total nleft.
//   3. part_scatter: per tile, a block scan of the flags gives each
//      lane its stable rank on its side; every plane word of the lane
//      goes to its destination in a [P, count] scratch window.
//   4. part_copyback: scratch -> data[:, start:start+count].

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;   // lanes per block
constexpr int kScanThreads = 1024;
constexpr int kRouteScalars = 19;

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

__global__ void __launch_bounds__(kThreads)
part_flags(const int32_t* __restrict__ data, long long R, int start,
           int count, const int32_t* __restrict__ rscal,
           uint8_t* __restrict__ flags, int32_t* __restrict__ tile_left) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage temp;
  __shared__ int32_t rs[kRouteScalars];
  if (threadIdx.x < kRouteScalars) rs[threadIdx.x] = rscal[threadIdx.x];
  __syncthreads();
  const int base = blockIdx.x * kTile;
  const int32_t* col = data + (long long)rs[0] * R + start;
  int local = 0;
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kThreads + threadIdx.x;   // coalesced
    if (i < count) {
      const int l = route_left((uint32_t)col[i], rs);
      flags[i] = (uint8_t)l;
      local += l;
    }
  }
  const int total = Reduce(temp).Sum(local);
  if (threadIdx.x == 0) tile_left[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
part_scan(const int32_t* __restrict__ tile_left, int ntiles,
          int32_t* __restrict__ tile_off, int32_t* __restrict__ nleft) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage temp;
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? tile_left[i] : 0;
    int excl, agg;
    Scan(temp).ExclusiveSum(v, excl, agg);
    if (i < ntiles) tile_off[i] = carry + excl;
    __syncthreads();
    if (threadIdx.x == 0) carry += agg;
    __syncthreads();
  }
  if (threadIdx.x == 0) nleft[0] = carry;
}

__global__ void __launch_bounds__(kThreads)
part_scatter(const int32_t* __restrict__ data, long long R, int P,
             int start, int count, const uint8_t* __restrict__ flags,
             const int32_t* __restrict__ tile_off,
             const int32_t* __restrict__ nleft_p,
             int32_t* __restrict__ scratch) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage temp;
  const int base = blockIdx.x * kTile;
  const int nleft = nleft_p[0];
  const int left_before = tile_off[blockIdx.x];
  const int right_before = base - left_before;
  // blocked arrangement: thread t owns lanes base + t*kItems + k, so the
  // block-wide exclusive scan of flags is each lane's stable left rank
  int fl[kItems];
  int rank[kItems];
  const int first = base + threadIdx.x * kItems;
  for (int k = 0; k < kItems; ++k) {
    const int i = first + k;
    fl[k] = i < count ? (int)flags[i] : 0;
  }
  Scan(temp).ExclusiveSum(fl, rank);
  for (int k = 0; k < kItems; ++k) {
    const int i = first + k;
    if (i >= count) break;
    const int pos = threadIdx.x * kItems + k;        // position in tile
    const int dest = fl[k] ? left_before + rank[k]
                           : nleft + right_before + (pos - rank[k]);
    const int32_t* src = data + start + i;
    int32_t* dst = scratch + dest;
    for (int p = 0; p < P; ++p) {
      dst[(long long)p * count] = src[(long long)p * R];
    }
  }
}

__global__ void part_copyback(const int32_t* __restrict__ scratch,
                              int32_t* __restrict__ data, long long R,
                              int start, int count) {
  const int p = blockIdx.y;
  const int32_t* src = scratch + (long long)p * count;
  int32_t* dst = data + (long long)p * R + start;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    dst[i] = src[i];
  }
}

}  // namespace

extern "C" {

int lgbt_partition_tile() { return kTile; }

// Scratch sizes (elements): flags [count] u8, tile_left / tile_off
// [ceil(count / kTile)] i32, scratch [P * count] i32; nleft [1] i32.
int lgbt_partition(int32_t* data, long long R, int P, int start, int count,
                   const int32_t* rscal, uint8_t* flags, int32_t* tile_left,
                   int32_t* tile_off, int32_t* scratch, int32_t* nleft,
                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int ntiles = (count + kTile - 1) / kTile;
  cudaError_t e;
  if (ntiles > 0) {
    part_flags<<<ntiles, kThreads, 0, s>>>(data, R, start, count, rscal,
                                           flags, tile_left);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  part_scan<<<1, kScanThreads, 0, s>>>(tile_left, ntiles, tile_off, nleft);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (ntiles == 0) return 0;
  part_scatter<<<ntiles, kThreads, 0, s>>>(data, R, P, start, count, flags,
                                           tile_off, nleft, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  int gx = (count + 255) / 256;
  if (gx > 1024) gx = 1024;
  part_copyback<<<dim3(gx, P), 256, 0, s>>>(scratch, data, R, start, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
