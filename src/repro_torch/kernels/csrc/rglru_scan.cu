// Diagonal linear recurrence h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a):
// the CUDA counterpart of the Pallas TPU kernel in
// src/repro/kernels/rglru_scan.py.
//
//   rgs_rglru_scan replaces rglru_scan._kernel (pallas_call at :60)
//
// Layout: a, x, h are [B, L, W] row-major f32, h0 and h_last [B, W].  One
// thread owns one (b, w) lane and walks L inside a loop; neighbouring
// threads hold neighbouring w, so every step's loads and stores are
// coalesced.  The TPU kernel's chunk grid existed to keep the state in VMEM
// across sequential grid steps; here the state is one register and no block
// needs another's result, so there is no chunk axis and nothing crosses
// blocks.
//
// What bounds it: each element of a and x is read once and each h written
// once with 2 flops, so it is memory-bound (12 bytes per element, plus the
// h0/h_last rows).  On the ssm detector's path (B = 128, L = 4, W = 512:
// 3.1 MB) a launch moves less data than one launch costs.
//
// __fmul_rn/__fadd_rn keep the compiler from contracting a*h + x into an
// FMA, so the kernel rounds exactly as the plain PyTorch version (a product
// kernel, then a sum kernel) does: the two are bitwise equal.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int64_t L, int64_t W,
                  int64_t lanes) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (lane >= lanes) return;
  const int64_t b = lane / W;
  const int64_t w = lane - b * W;
  int64_t i = b * L * W + w;
  float s = h0 != nullptr ? h0[lane] : 0.0f;
  for (int64_t t = 0; t < L; ++t, i += W) {
    s = __fadd_rn(__fmul_rn(a[i], s), x[i]);
    h[i] = s;
  }
  h_last[lane] = s;
}

}  // namespace

extern "C" int rgs_rglru_scan(const float* a, const float* x, const float* h0,
                              float* h, float* h_last, int64_t B, int64_t L,
                              int64_t W, cudaStream_t stream) {
  const int64_t lanes = B * W;
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, x, h0, h, h_last, L, W, lanes);
  return static_cast<int>(cudaGetLastError());
}
