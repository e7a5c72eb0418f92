// Flash attention forward for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel in src/repro/kernels/flash_attention.py.
//
//   fa_flash_attention replaces flash_attention._kernel (pallas_call at :103)
//
// Layout: the public one, no transposes.  q and o are [B, S, HQ, D], k and v
// [B, T, HKV, D], row-major, f32 or bf16 (o in q's type); all arithmetic is
// f32.  The grid is (ceil(S / 64), HQ, B): one block per 64 query rows of
// one (batch, head), one thread per query row.  A thread keeps its query
// and its output accumulator in registers (D is a template bound, DMAX in
// 8..128, so the arrays stay in registers for the small head dims of the
// detectors; at 128 they spill).  The block stages K/V tiles of BK keys of
// its kv head (q head h reads kv head h / (HQ / HKV): GQA) in shared memory
// as f32, and every thread walks the tile with an online softmax, one key
// at a time: the running max m, normaliser l and accumulator are rescaled
// when a larger score arrives.  The TPU kernel carried (m, l, acc) across
// its sequential grid axis in VMEM; here the K/V loop is inside the block.
//
// Masking follows the TPU kernel exactly: a masked key scores -1e30 (not
// -inf), so a row with no valid key so far gives every masked key weight 1,
// and the first valid key wipes them (exp(-1e30 - s) == 0).  Once a row has
// a valid key a masked one adds exactly nothing, so it is skipped.  The
// causal mask uses the offset T - S; the optional sliding window keeps
// keys with pos - window < t <= pos.  Rows past S and keys past T (the
// ragged edge) are not keys at all: blocks compute their own offsets and
// mask them, so any S and T work.  Tiles past every row's causal limit are
// skipped when every row of the block has a valid key.
//
// What bounds it: on the attn detector's path (B = 128, S = T = 64, HQ = 2,
// D = 8) a call reads and writes 2.1 MB and does ~17 MFLOP, so its bound is
// bytes and is under a microsecond: a launch costs more.  This simple
// version uses FMAs, not mma/wgmma (which need D >= 16); a later PR makes
// it fast.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kRows = 64;          // query rows per block, one per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// keys per shared-memory tile: K and V tiles of BK x DMAX f32, 32 KB at most
template <int DMAX>
__host__ __device__ constexpr int tile_keys() {
  return DMAX >= 128 ? 32 : 64;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kRows)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Tk, int HQ, int HKV, int D, float scale,
                       int causal, int window) {
  constexpr int BK = tile_keys<DMAX>();
  __shared__ float ks[BK][DMAX];
  __shared__ float vs[BK][DMAX];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (HQ / HKV);
  const int first_row = blockIdx.x * kRows;
  const int row = first_row + threadIdx.x;
  const bool active = row < S;
  const int offset = Tk - S;
  const int pos = row + offset;  // absolute position of this query

  float qr[DMAX], acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qr[d] = 0.0f;
    acc[d] = 0.0f;
  }
  const int64_t q_off = ((static_cast<int64_t>(b) * S + row) * HQ + h) * D;
  if (active) {
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < D) qr[d] = to_f32(q[q_off + d]);
  }
  float m = kNegInf, l = 0.0f;

  int n_tiles = (Tk + BK - 1) / BK;
  const int last_row = min(S, first_row + kRows) - 1;
  if (causal && first_row + offset >= 0)  // every row has key 0 valid
    n_tiles = min(n_tiles, (last_row + offset) / BK + 1);

  const int64_t kv_base = (static_cast<int64_t>(b) * Tk * HKV + hk) * D;
  const int64_t kv_stride = static_cast<int64_t>(HKV) * D;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * BK;
    __syncthreads();  // the previous tile has been read
    for (int e = threadIdx.x; e < BK * DMAX; e += kRows) {
      const int j = e / DMAX;
      const int d = e - j * DMAX;
      float kv = 0.0f, vv = 0.0f;
      if (t0 + j < Tk && d < D) {
        const int64_t idx = kv_base + (t0 + j) * kv_stride + d;
        kv = to_f32(k[idx]);
        vv = to_f32(v[idx]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (!active) continue;
    const int jn = min(BK, Tk - t0);
    for (int j = 0; j < jn; ++j) {
      const int t = t0 + j;
      const bool valid =
          (!causal || t <= pos) && (window <= 0 || t > pos - window);
      if (!valid && m > kNegInf) continue;
      float sc = kNegInf;
      if (valid) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        sc = dot * scale;
      }
      if (sc > m) {
        const float alpha = expf(m - sc);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DMAX; ++d) acc[d] *= alpha;
        m = sc;
      }
      const float p = expf(sc - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
  }
  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < D) store(o + q_off + d, acc[d] / denom);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int HQ, int HKV, int D, float scale, int causal,
           int window, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, HQ, B);
  flash_attention_kernel<T, DMAX><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, HQ, HKV, D, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tk, int HQ, int HKV, int D, float scale, int causal,
             int window, cudaStream_t stream) {
  if (D <= 8)
    return launch<T, 8>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                        window, stream);
  if (D <= 16)
    return launch<T, 16>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                         window, stream);
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                         window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                         window, stream);
  return launch<T, 128>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                        window, stream);
}

}  // namespace

// window <= 0: no sliding window.  is_bf16: q, k, v, o are bf16, else f32.
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int Tk, int HQ,
                                  int HKV, int D, float scale, int causal,
                                  int window, int is_bf16,
                                  cudaStream_t stream) {
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale,
                                   causal, window, stream);
  return dispatch<float>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                         window, stream);
}
