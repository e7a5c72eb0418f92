// Helpers shared by the attention kernels (flash_attention.cu and
// flash_decode.cu): the TPU kernels' mask value, f32/bf16 loads and stores,
// cp.async copies into shared memory, 2^x by the special-function unit, and
// the q . k dot products and p * v update over a staged row.  Everything is
// __forceinline__ in an anonymous namespace, so each source compiles its own
// copy and the header adds no symbol.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 48 * 1024;  // static shared memory a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  cp_async_16(shared_addr(dst), src);
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One unit of `width` bytes from global to shared memory: 16 or 4 by
// cp.async, 2 by a plain copy (bf16 rows that are not 4-byte aligned).
__device__ __forceinline__ void copy_unit(char* s, const char* g, int width) {
  if (width == 16)
    cp_async_16(s, g);
  else if (width == 4)
    cp_async_4(s, g);
  else
    *reinterpret_cast<uint16_t*>(s) = *reinterpret_cast<const uint16_t*>(g);
}
// ... and from shared to global memory, by plain stores
__device__ __forceinline__ void copy_unit_out(char* g, const char* s,
                                              int width) {
  if (width == 16)
    *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
  else if (width == 4)
    *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<const uint32_t*>(s);
  else
    *reinterpret_cast<uint16_t*>(g) = *reinterpret_cast<const uint16_t*>(s);
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22,
// subnormal results flushed to 0; exp2(-1e30) and exp2(-inf) are 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// q . k over DMAX columns of a staged row (16-byte aligned in shared memory)
// in one FMA chain, column by column: flash_attention's lanes kernel
template <int DMAX>
__device__ __forceinline__ float dot_row_serial(const float (&qr)[DMAX],
                                                const float* kr) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < DMAX; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
    s = fmaf(qr[d], kv.x, s);
    s = fmaf(qr[d + 1], kv.y, s);
    s = fmaf(qr[d + 2], kv.z, s);
    s = fmaf(qr[d + 3], kv.w, s);
  }
  return s;
}
template <int DMAX>
__device__ __forceinline__ float dot_row_serial(const float (&qr)[DMAX],
                                                const __nv_bfloat16* kr) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < DMAX; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 kv = __bfloat1622float2(h[e]);
      s = fmaf(qr[d + 2 * e], kv.x, s);
      s = fmaf(qr[d + 2 * e + 1], kv.y, s);
    }
  }
  return s;
}

// the same with one partial sum per 4 columns, added at the end, so the FMA
// chain is 4 deep rather than DMAX: flash_decode's lanes kernel
template <int DMAX>
__device__ __forceinline__ float dot_row(const float (&qr)[DMAX],
                                         const float* kr) {
  float part[DMAX / 4];
#pragma unroll
  for (int c = 0; c < DMAX / 4; ++c) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * c);
    float s = qr[4 * c] * kv.x;
    s = fmaf(qr[4 * c + 1], kv.y, s);
    s = fmaf(qr[4 * c + 2], kv.z, s);
    part[c] = fmaf(qr[4 * c + 3], kv.w, s);
  }
#pragma unroll
  for (int w = 1; w < DMAX / 4; w <<= 1)
#pragma unroll
    for (int c = 0; c + w < DMAX / 4; c += 2 * w) part[c] += part[c + w];
  return part[0];
}
template <int DMAX>
__device__ __forceinline__ float dot_row(const float (&qr)[DMAX],
                                         const __nv_bfloat16* kr) {
  float part[DMAX / 4];
#pragma unroll
  for (int c = 0; c < DMAX / 8; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + 8 * c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 k0 = __bfloat1622float2(h[2 * e]);
      const float2 k1 = __bfloat1622float2(h[2 * e + 1]);
      const int d = 8 * c + 4 * e;
      float s = qr[d] * k0.x;
      s = fmaf(qr[d + 1], k0.y, s);
      s = fmaf(qr[d + 2], k1.x, s);
      part[2 * c + e] = fmaf(qr[d + 3], k1.y, s);
    }
  }
#pragma unroll
  for (int w = 1; w < DMAX / 4; w <<= 1)
#pragma unroll
    for (int c = 0; c + w < DMAX / 4; c += 2 * w) part[c] += part[c + w];
  return part[0];
}

// acc += p * v over DMAX columns of a staged row
template <int DMAX>
__device__ __forceinline__ void axpy_row(float (&acc)[DMAX], float p,
                                         const float* vr) {
#pragma unroll
  for (int d = 0; d < DMAX; d += 4) {
    const float4 vv = *reinterpret_cast<const float4*>(vr + d);
    acc[d] = fmaf(p, vv.x, acc[d]);
    acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
    acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
    acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
  }
}
template <int DMAX>
__device__ __forceinline__ void axpy_row(float (&acc)[DMAX], float p,
                                         const __nv_bfloat16* vr) {
#pragma unroll
  for (int d = 0; d < DMAX; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(vr + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 vv = __bfloat1622float2(h[e]);
      acc[d + 2 * e] = fmaf(p, vv.x, acc[d + 2 * e]);
      acc[d + 2 * e + 1] = fmaf(p, vv.y, acc[d + 2 * e + 1]);
    }
  }
}

}  // namespace
