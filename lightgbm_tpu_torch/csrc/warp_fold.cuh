// The warp-group fold shared by the float modes of the row-major
// (hist_rowmajor.cu) and planar (hist_planar.cu) histograms.
//
// One warp owns one column's histogram in shared memory and walks a tile
// 32 rows at a time, lane u holding row u's bin key and g/h. The lanes
// whose rows fall in the same cell form a group: each sets its bit in the
// cell's mask word (an integer atomicOr: the mask is the same whatever
// the order), and the group's last lane loads the cell, adds the group's
// g/h one row after the other (shuffled from the lanes in ascending
// order) and stores it back. So every cell is summed in row order, and a
// cell's chain of adds is as long as its rows, not as the tile.
#pragma once

#include <cuda_runtime.h>

namespace lgbt {

constexpr unsigned kFull = 0xFFFFFFFFu;

// one warp's share of shared memory: a column's float2 cells, then one
// group-mask word per cell (zero between steps), 16-byte aligned
__host__ __device__ inline int warp_bytes(int nbr) {
  return (nbr * 12 + 15) / 16 * 16;
}

// one step of 32 rows of one column: lanes whose rows fall in the same
// cell form a group (each sets its bit in the cell's mask word); the
// group's last lane folds the group's g/h into the cell in lane (row)
// order, two members per round of shuffles. A key >= nb adds nothing.
__device__ __forceinline__ void fold_rows(float2* col, unsigned* mask,
                                          unsigned key, int nb, float g,
                                          float h, int lane) {
  const bool valid = key < (unsigned)nb;
  if (valid) atomicOr(mask + key, 1u << lane);
  __syncwarp();
  const unsigned group = valid ? mask[key] : 0u;
  __syncwarp();
  const bool last = valid && lane == 31 - __clz(group);
  float2 s = make_float2(0.f, 0.f);
  if (last) {
    mask[key] = 0u;
    s = col[key];
  }
  unsigned m = group;
  while (__any_sync(kFull, m != 0u)) {
    const int src0 = m ? __ffs(m) - 1 : lane;
    const unsigned m1 = m & (m - 1);
    const int src1 = m1 ? __ffs(m1) - 1 : lane;
    const float g0 = __shfl_sync(kFull, g, src0);
    const float h0 = __shfl_sync(kFull, h, src0);
    const float g1 = __shfl_sync(kFull, g, src1);
    const float h1 = __shfl_sync(kFull, h, src1);
    if (m) {
      s.x += g0;
      s.y += h0;
    }
    if (m1) {
      s.x += g1;
      s.y += h1;
    }
    m = m1 & (m1 - 1);
  }
  if (last) col[key] = s;
  __syncwarp();
}

}  // namespace lgbt
