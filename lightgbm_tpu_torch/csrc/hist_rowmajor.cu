// Row-major gradient/hessian histogram of a [C, F] bin-code matrix.
//
// Replaces two TPU kernels of lightgbm_tpu/ops/histogram.py, which share
// one contract (bins [C, F], grad/hess [C] float32 -> [F, B, 2] float32):
//   - histogram_radix_pallas (_radix_pallas_kernel via _accum_chunks /
//     _chunk_partials): the serial learner's leaf histogram; its `dtype`
//     argument rounds grad/hess to bfloat16 before the float32 sums;
//   - histogram_pallas (_hist_pallas_kernel): the masked
//     multiply-accumulate histogram, float32 only.
// Both entries below launch the same kernel; the second never rounds.
// A code outside [0, num_bins) adds nothing (the JAX scatter drops it,
// the radix kernel lands it in cells the output slice cuts off).
//
// Both TPU kernels also have an integer mode, taken when grad/hess are
// int32 quantized levels (ops/quantize.py): the sums are exact int32
// and so is the output. Here `quant` selects it: grad/hess are [C]
// int32 levels (unpacked, |qg| <= 31, qh <= 63) and partials / out
// are int32. Integer addition is associative, so the bits do not
// depend on the order; the same template serves both modes.
//
// What bounds it on the card: bytes. The least work reads each row's
// F code bytes and 8 bytes of grad/hess once and writes one [F, B, 2]
// float32 histogram. This first version is not bandwidth bound: as in
// csrc/hist_planar.cu, each thread owns (column, bin) pairs and walks
// every staged row of its tile, so the instruction count grows with
// num_bins. It is simple and exact; a later redesign makes it fast.
//
// Determinism: no float atomics. Pass 1 gives every (row tile, column
// chunk) block a private partial histogram, each cell summed in row
// order by one thread; pass 2 sums the partials over tiles in tile
// order. The plain PyTorch version (ops/histogram.py
// histogram_radix_plain) sums in the same association.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 2048;     // rows per block
constexpr int kThreads = 256;
constexpr int kMaxCols = 4;     // columns per block (shared code rows)
constexpr uint16_t kNoBin = 0xFFFF;

// Acc: float (float32 grad/hess) or int32_t (quantized levels)
template <typename CodeT, typename Acc>
__global__ void __launch_bounds__(kThreads)
rm_partials(const CodeT* __restrict__ codes, int C, int F,
            const Acc* __restrict__ grad, const Acc* __restrict__ hess,
            int num_bins, int cols_per_block, int round_bf16,
            Acc* __restrict__ partials) {
  const int tile = blockIdx.x;
  const int row0 = tile * kTile;
  const int rows = max(0, min(kTile, C - row0));
  const int f0 = blockIdx.y * cols_per_block;
  const int nf = min(cols_per_block, F - f0);

  __shared__ Acc sg[kTile];
  __shared__ Acc sh[kTile];
  __shared__ uint16_t sc[kMaxCols][kTile];

  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const long long r = (long long)row0 + i;
    Acc g = grad[r];
    Acc h = hess[r];
    if constexpr (std::is_same<Acc, float>::value) {
      if (round_bf16) {
        g = __bfloat162float(__float2bfloat16_rn(g));
        h = __bfloat162float(__float2bfloat16_rn(h));
      }
    }
    sg[i] = g;
    sh[i] = h;
    for (int j = 0; j < nf; ++j) {
      const long long c = (long long)codes[r * F + f0 + j];
      sc[j][i] = (c >= 0 && c < num_bins) ? (uint16_t)c : kNoBin;
    }
  }
  __syncthreads();

  const int pairs = nf * num_bins;
  const size_t cells = (size_t)F * num_bins;
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
__global__ void rm_reduce(const Acc* __restrict__ partials, int ntiles,
                          int cells2, Acc* __restrict__ out) {
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

template <typename Acc>
int launch(const void* codes, int code_bytes, int C, int F, const void* grad,
           const void* hess, int num_bins, int round_bf16, void* partials,
           void* out, cudaStream_t s) {
  if (num_bins < 1 || num_bins >= kNoBin || F < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Acc* g = static_cast<const Acc*>(grad);
  const Acc* h = static_cast<const Acc*>(hess);
  Acc* parts = static_cast<Acc*>(partials);
  const int cpb = cols_per_block(num_bins);
  const int ntiles = C > 0 ? (C + kTile - 1) / kTile : 0;
  const int cells2 = F * num_bins * 2;
  if (ntiles > 0) {
    dim3 grid(ntiles, (F + cpb - 1) / cpb);
    if (code_bytes == 1) {
      rm_partials<uint8_t, Acc><<<grid, kThreads, 0, s>>>(
          static_cast<const uint8_t*>(codes), C, F, g, h, num_bins, cpb,
          round_bf16, parts);
    } else if (code_bytes == 4) {
      rm_partials<int32_t, Acc><<<grid, kThreads, 0, s>>>(
          static_cast<const int32_t*>(codes), C, F, g, h, num_bins, cpb,
          round_bf16, parts);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rm_reduce<Acc><<<(cells2 + 255) / 256, 256, 0, s>>>(
      parts, ntiles, cells2, static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

int dispatch(const void* codes, int code_bytes, int C, int F,
             const void* grad, const void* hess, int num_bins,
             int round_bf16, int quant, void* partials, void* out,
             void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (quant) {
    return launch<int32_t>(codes, code_bytes, C, F, grad, hess, num_bins, 0,
                           partials, out, s);
  }
  return launch<float>(codes, code_bytes, C, F, grad, hess, num_bins,
                       round_bf16, partials, out, s);
}

}  // namespace

extern "C" {

int lgbt_rm_tile() { return kTile; }

// partials: max(1, ceil(C / kTile)) * F * num_bins * 2 floats (int32
// when quant); codes: [C, F] uint8 (code_bytes 1) or int32 (code_bytes
// 4), row-major; grad/hess: [C] float32, or int32 levels when quant.
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
