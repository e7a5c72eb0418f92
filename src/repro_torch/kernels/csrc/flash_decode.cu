// Flash decode (one query token against a KV cache) for Hopper (sm_90a):
// the CUDA counterpart of the Pallas TPU kernel in
// src/repro/kernels/flash_decode.py.
//
//   fd_flash_decode replaces flash_decode._kernel (pallas_call at :102)
//
// Layout: the public one.  q and o are [B, HQ, D], k and v [B, T, HKV, D],
// row-major, f32 or bf16 (o in q's type); length is i32 [B], the valid
// cache prefix of each row; m and l are f32 [B, HQ], the row max and the
// softmax normaliser, so a caller that shards the cache can merge shards
// by log-sum-exp (ref.combine_partials).  All arithmetic is f32.
//
// The grid is (HQ, B): one block of 128 threads per query head of one row
// (q head h reads kv head h / (HQ / HKV): GQA).  The block walks the cache
// in tiles of 128 keys with an online softmax, as the TPU kernel walked its
// sequential grid axis:
//   1. each thread scores one key of the tile (a dot over D against the
//      query, staged in shared memory);
//   2. a warp-shuffle and shared-memory max over the tile, the new running
//      max m, and p = exp(s - m) for each key;
//   3. a block sum of p updates l = alpha * l + sum(p);
//   4. the output accumulator is split over the threads as (part, column):
//      thread (part, d) sums p_t * v[t, d] over the keys t = part (mod parts)
//      of the tile and rescales its partial by alpha.  After the last tile
//      a shared-memory pass adds the parts, and column d is divided by l.
//
// Masking follows the TPU kernel exactly: a position past length scores
// -1e30 (not -inf) and takes part in the max, so a row with no valid
// position (an empty shard of a split cache) ends with m = -1e30, l = T
// and o = the mean of v, all finite, and its shard weight
// l * exp(m - m*) is 0 in the merge.  Positions past T (the ragged last
// tile) are not keys at all: they score -inf and weigh 0.
//
// What bounds it: on the attn detector's read-out (B = 128, HQ = 2, D = 8,
// T = 64) a call reads 0.5 MB of K/V and does ~0.5 MFLOP: it is bound by
// bytes, and by far less than one launch costs.  For a long LM cache the
// same design is bound by reading K and V once per q head (GQA groups
// re-read their kv head), which a later PR can share across the group.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 128;      // keys per tile, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = kThreads;    // head dims up to 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    T* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Tk, int HQ, int HKV, int D,
                    float scale) {
  __shared__ float qs[kMaxD];
  __shared__ float ps[kThreads];
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps];
  __shared__ float parts_acc[kThreads];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (HQ / HKV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = length[b];
  const int64_t qo = (static_cast<int64_t>(b) * HQ + h) * D;
  for (int d = tid; d < D; d += kThreads) qs[d] = to_f32(q[qo + d]);

  const int parts = kThreads / D;  // accumulator split: (part, column)
  const int col = tid % D;
  const int part = tid / D;
  const bool owner = part < parts;
  const int64_t kv_base = (static_cast<int64_t>(b) * Tk * HKV + hk) * D;
  const int64_t kv_stride = static_cast<int64_t>(HKV) * D;

  float m = kNegInf, l = 0.0f, acc = 0.0f;
  __syncthreads();  // qs
  for (int t0 = 0; t0 < Tk; t0 += kThreads) {
    const int t = t0 + tid;
    float sc = -INFINITY;  // past the cache: no key
    if (t < Tk) {
      sc = kNegInf;
      if (t < len) {
        const T* kp = k + kv_base + t * kv_stride;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qs[d], to_f32(kp[d]), dot);
        sc = dot * scale;
      }
    }
    float mx = sc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();
    mx = red_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_max[w]);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);
    ps[tid] = p;
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) red_sum[warp] = sum;
    __syncthreads();
    sum = red_sum[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red_sum[w];
    l = alpha * l + sum;
    m = m_new;
    if (owner) {
      const int jn = min(kThreads, Tk - t0);
      float a = 0.0f;
      for (int j = part; j < jn; j += parts)
        a = fmaf(ps[j], to_f32(v[kv_base + (t0 + j) * kv_stride + col]), a);
      acc = acc * alpha + a;
    }
    // no barrier needed here: red_max, ps and red_sum are next written
    // after the next tile's first barrier, which every reader has passed
  }
  parts_acc[tid] = owner ? acc : 0.0f;
  __syncthreads();
  if (tid < D) {
    float s = 0.0f;
    for (int p = 0; p < parts; ++p) s += parts_acc[p * D + tid];
    store(o + qo + tid, s / fmaxf(l, 1e-30f));
  }
  if (tid == 0) {
    m_out[static_cast<int64_t>(b) * HQ + h] = m;
    l_out[static_cast<int64_t>(b) * HQ + h] = l;
  }
}

}  // namespace

// is_bf16: q, k, v, o are bf16, else f32.  D <= 128.
extern "C" int fd_flash_decode(const void* q, const void* k, const void* v,
                               const int* length, void* o, float* m, float* l,
                               int B, int Tk, int HQ, int HKV, int D,
                               float scale, int is_bf16,
                               cudaStream_t stream) {
  const dim3 grid(HQ, B);
  if (is_bf16)
    flash_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), length,
        static_cast<__nv_bfloat16*>(o), m, l, Tk, HQ, HKV, D, scale);
  else
    flash_decode_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), length, static_cast<float*>(o), m, l,
        Tk, HQ, HKV, D, scale);
  return static_cast<int>(cudaGetLastError());
}
