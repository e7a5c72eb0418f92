// Fused DP clip+noise for Hopper (sm_90a): the CUDA counterpart of the two
// Pallas TPU kernels in src/repro/kernels/dp_clip_noise.py.
//
//   dpcn_sumsq_rows       replaces _sumsq_kernel       (pallas_call at :62)
//   dpcn_scale_noise_rows replaces _scale_noise_kernel (pallas_call at :81)
//
// Both work on the stacked client updates x[R, P] (row-major f32, one row per
// client, the leaves of one update laid end to end in sorted-key order).
//
// What bounds them: each element is touched once, with 1-2 flops, so both
// are memory-bound (sumsq reads 4·R·P bytes; scale_noise reads 8·R·P and
// writes 4·R·P).  At the paper's config (R = 40, P = 13,890: 2.2 MB) a launch
// moves less data than one launch costs, so the design keeps them simple and
// exact rather than fast:
//
// * sumsq: one block per row.  Each thread strides over the row in a fixed
//   order, then a warp-shuffle tree and a shared-memory tree of warp partials
//   reduce the block.  No atomics, so the result is the same bits run to run
//   (the TPU kernel carried one SMEM scalar across its sequential grid; here a
//   row never leaves its block, so no second pass is needed).
// * scale_noise: a 2-D grid, y over rows and x over column tiles; each thread
//   reads its row's scale once.  __fmul_rn/__fadd_rn keep the compiler from
//   contracting x·s + σ·n into an FMA, so the kernel rounds exactly as the
//   plain PyTorch version (three rounded ops) does.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumsqThreads = 512;
constexpr int kScaleThreads = 256;
constexpr int kScaleItems = 4;  // elements per thread per column tile

__global__ void __launch_bounds__(kSumsqThreads)
sumsq_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int64_t P) {
  const float* row = x + static_cast<int64_t>(blockIdx.x) * P;
  float acc = 0.0f;
  for (int64_t i = threadIdx.x; i < P; i += kSumsqThreads) {
    const float v = row[i];
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);

  __shared__ float warp_sums[kSumsqThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kSumsqThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[blockIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(kScaleThreads)
scale_noise_rows_kernel(const float* __restrict__ x,
                        const float* __restrict__ noise,
                        const float* __restrict__ scale, float sigma,
                        float* __restrict__ out, int64_t P) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * P;
  const float s = scale[blockIdx.y];
  const int64_t tile = static_cast<int64_t>(kScaleThreads) * kScaleItems;
  for (int64_t col = static_cast<int64_t>(blockIdx.x) * tile + threadIdx.x;
       col < P; col += static_cast<int64_t>(gridDim.x) * tile) {
#pragma unroll
    for (int k = 0; k < kScaleItems; ++k) {
      const int64_t c = col + static_cast<int64_t>(k) * kScaleThreads;
      if (c < P) {
        const int64_t i = base + c;
        out[i] = __fadd_rn(__fmul_rn(x[i], s), __fmul_rn(sigma, noise[i]));
      }
    }
  }
}

}  // namespace

extern "C" int dpcn_sumsq_rows(const float* x, float* out, int64_t R,
                               int64_t P, cudaStream_t stream) {
  sumsq_rows_kernel<<<static_cast<unsigned>(R), kSumsqThreads, 0, stream>>>(
      x, out, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpcn_scale_noise_rows(const float* x, const float* noise,
                                     const float* scale, float sigma,
                                     float* out, int64_t R, int64_t P,
                                     cudaStream_t stream) {
  const int64_t tile = static_cast<int64_t>(kScaleThreads) * kScaleItems;
  int64_t tiles = (P + tile - 1) / tile;
  if (tiles < 1) tiles = 1;
  if (tiles > 65535) tiles = 65535;  // the loop strides over the rest
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(R));
  scale_noise_rows_kernel<<<grid, kScaleThreads, 0, stream>>>(
      x, noise, scale, sigma, out, P);
  return static_cast<int>(cudaGetLastError());
}
