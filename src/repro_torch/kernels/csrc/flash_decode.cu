// Flash decode (one query token against a KV cache) for Hopper (sm_90a):
// the CUDA counterpart of the Pallas TPU kernel in
// src/repro/kernels/flash_decode.py.
//
//   fd_flash_decode replaces flash_decode._kernel (pallas_call at :102)
//
// Layout: the public one.  q and o are [B, HQ, D] (q may broadcast one
// query over the batch: its batch stride is an argument, 0 for that), k and
// v [B, T, HKV, D], row-major, f32 or bf16 (o in q's type); length is i32
// [B], the valid cache prefix of each row; m and l are f32 [B, HQ], the row
// max of the scaled scores and the softmax normaliser sum(exp(s - m)), so a
// caller that shards the cache can merge shards by log-sum-exp
// (ref.combine_partials).  All arithmetic is f32.
//
// Masking follows the TPU kernel exactly: a position t < T with
// t >= length scores -1e30 (not -inf) and takes part in the max, so a row
// with no valid position (an empty shard of a split cache) ends with
// m = -1e30, l = T and o = the mean of v, all finite, and its shard weight
// l * exp(m - m*) is 0 in the merge.  Positions past T (a ragged last tile,
// a lane's padding) are not keys at all: they weigh 0.
//
// What bounds it: on the attn detector's read-out (B = 128, HQ = HKV = 2,
// D = 8, T = 64, f32) a call moves 1.05 MB and does 0.5 MFLOP: bytes bound
// it, at 0.32 us on an H100.  What sets the time instead is one launch, one
// global -> shared -> global round trip and the instructions around them:
// the whole call is 256 (row, head) pairs of 64 keys, one or two warps an
// SM, so every instruction's latency is exposed.  The design keeps the
// chain of dependent instructions short.
//
// Head dims up to 32 (DMAX 8, 16, 32): flash_decode_lanes_kernel.
//   * One block per (batch row, group of kv heads): the block is
//     (heads * G, kv_heads) threads, so thread (x, y) is lane x % G of q
//     head x / G of kv head y, found without a division.  A block takes
//     every q head that shares its kv heads: on the path both heads of a row
//     (two warps, 128 blocks).  Each kv head is read from global memory once
//     per row, whatever the GQA group.
//   * Staging: the row's K and V key tile [t0, t1) x (its kv heads) x D is
//     one contiguous range when the block takes all kv heads; both go to
//     shared memory together with 16-byte cp.async (4-byte cp.async or
//     plain 2-byte copies where pointers or D * esize are not 16-byte
//     aligned), then one wait and one barrier: K and V cost one round trip.
//     The query's and the row's length's loads go out first and nothing
//     waits on them until the copies are issued.  Key tiles (64 keys) are
//     double-buffered when T spans more than one.
//   * G = 32 lanes, one warp, per (row, q head) split the keys: lane g takes
//     keys t0 + g and t0 + g + 32 of each tile, keeps its own
//     (m, l, acc[DMAX]) in registers and does a softmax per tile, with
//     scale * log2(e) folded into q and ex2.approx; the loops have no
//     branch (a lane past the tile's keys reads the last one and weighs it
//     0), so the keys' loads and FMAs interleave.  The lanes merge in a
//     fixed xor butterfly of shuffles (the log-sum-exp merge of
//     ref.combine_partials) with the products and sums rounded apart, so
//     every lane ends with the same bits and a call repeats bitwise (no
//     atomics).  Lane g divides the column it stores, once; m goes back to
//     natural-log units at the end, and -1e30 stays exactly -1e30.  G = 32
//     measured fastest of 4, 8, 16 and 32 on the path: the shortest chain
//     of keys per lane wins over the longer merge.
//   The launch plan (q heads per block, shared memory, copy width) is chosen
//   by launch_plan() in kernels/flash_decode.py; this file checks it and
//   refuses a plan it was not built for.
//
// Head dims 64 and 128: flash_decode_kernel,
// the first port's design, unchanged: one block of 128 threads per
// (row, q head), a thread per key of a 128-key tile, a block max and sum per
// tile and the output accumulator split over (part, column).  No port path
// launches these head dims yet; their redesign belongs with LM decode.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it does not take.

#include <math.h>

#include "attn_common.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxGridYZ = 65535;

// ---------------------------------------------------------------------------
// Head dims up to 32: G lanes per (row, q head)

constexpr int kLanes = 32;    // G: lanes per (row, q head), one warp
constexpr int kKeyTile = 64;  // keys of one staged tile

// the most threads a block of the lanes kernel may have
template <int DMAX>
__host__ __device__ constexpr int max_threads() {
  return DMAX >= 32 ? 256 : 512;
}

// The query row [D] as raw 32-bit words (D..DMAX-1 zero): the loads go out
// and nothing waits on them until q_from_raw, after the K/V copies are
// issued.  16-byte loads when the plan's copy width is 16 (then D is a
// whole number of 16-byte units and the row is 16-byte aligned).
template <typename T, int DMAX>
struct QWords {
  static constexpr int kWords = DMAX * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];
};
template <typename T, int DMAX>
__device__ __forceinline__ void load_q(QWords<T, DMAX>& q, const T* qp, int D,
                                       int width) {
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));  // elements
  if (width == 16) {
#pragma unroll
    for (int c = 0; c < DMAX / kPer16; ++c) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (c * kPer16 < D) x = *reinterpret_cast<const uint4*>(qp + c * kPer16);
      q.w[4 * c] = x.x;
      q.w[4 * c + 1] = x.y;
      q.w[4 * c + 2] = x.z;
      q.w[4 * c + 3] = x.w;
    }
    return;
  }
  const uint16_t* h = reinterpret_cast<const uint16_t*>(qp);
#pragma unroll
  for (int i = 0; i < QWords<T, DMAX>::kWords; ++i) {
    if (sizeof(T) == 4) {
      q.w[i] = i < D ? __float_as_uint(reinterpret_cast<const float*>(qp)[i])
                     : 0u;
    } else {  // two bf16 a word, low half first
      const uint32_t lo = 2 * i < D ? h[2 * i] : 0u;
      const uint32_t hi = 2 * i + 1 < D ? h[2 * i + 1] : 0u;
      q.w[i] = lo | (hi << 16);
    }
  }
}
// ... then f32 times qscale
template <int DMAX>
__device__ __forceinline__ void q_from_raw(float (&qr)[DMAX],
                                           const QWords<float, DMAX>& q,
                                           float qscale) {
#pragma unroll
  for (int d = 0; d < DMAX; ++d) qr[d] = __uint_as_float(q.w[d]) * qscale;
}
template <int DMAX>
__device__ __forceinline__ void q_from_raw(
    float (&qr)[DMAX], const QWords<__nv_bfloat16, DMAX>& q, float qscale) {
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) {
    qr[2 * i] = __uint_as_float(q.w[i] << 16) * qscale;
    qr[2 * i + 1] = __uint_as_float(q.w[i] & 0xffff0000u) * qscale;
  }
}

// Shared memory: n_buf buffers, each [K, V][kKeyTile][kv_heads][DMAX]
// (columns D..DMAX-1 zero).
__host__ __device__ inline int smem_bytes_of(int kv_heads, int Tk, int dmax,
                                             int esize) {
  const int n_buf = Tk > kKeyTile ? 2 : 1;
  return n_buf * 2 * kKeyTile * kv_heads * dmax * esize;
}

// K and V of the key tile [t0, t0 + jn) of row b into buffer `buf`, in one
// go: flat when the tile is one contiguous range (all kv heads, D = DMAX),
// else thread (x, y) copies whole key rows of kv head y.
template <typename T, int DMAX>
__device__ __forceinline__ void stage_tile(T* smem, const T* k, const T* v,
                                           int t0, int buf, int b, int Tk,
                                           int HKV, int kh0, int D,
                                           int kv_heads, int width, bool flat,
                                           int tid, int nthreads) {
  constexpr int esize = static_cast<int>(sizeof(T));
  const int tile_elems = kKeyTile * kv_heads * DMAX;
  const int jn = min(kKeyTile, Tk - t0);
  T* ks = smem + buf * 2 * tile_elems;
  char* kd = reinterpret_cast<char*>(ks);
  char* vd = reinterpret_cast<char*>(ks + tile_elems);
  const int64_t first = ((static_cast<int64_t>(b) * Tk + t0) * HKV + kh0) * D;
  const char* kg = reinterpret_cast<const char*>(k + first);
  const char* vg = reinterpret_cast<const char*>(v + first);
  if (flat && width == 16) {  // the path: unrolled, 16 bytes a copy
    const unsigned ks_s = shared_addr(kd), vs_s = shared_addr(vd);
    const int units = jn * HKV * D * esize / 16;
#pragma unroll 4
    for (int u = tid; u < units; u += nthreads) {
      cp_async_16(ks_s + u * 16, kg + u * 16);
      cp_async_16(vs_s + u * 16, vg + u * 16);
    }
  } else if (flat) {
    const int bytes = jn * HKV * D * esize;
    for (int off = tid * width; off < bytes; off += nthreads * width) {
      copy_unit(kd + off, kg + off, width);
      copy_unit(vd + off, vg + off, width);
    }
  } else {
    const int row_bytes = D * esize;
    for (int j = threadIdx.x; j < jn; j += blockDim.x) {
      const int64_t src =
          (static_cast<int64_t>(j) * HKV + threadIdx.y) * row_bytes;
      const int dst = (j * kv_heads + threadIdx.y) * DMAX * esize;
      for (int c = 0; c < row_bytes; c += width) {
        copy_unit(kd + dst + c, kg + src + c, width);
        copy_unit(vd + dst + c, vg + src + c, width);
      }
    }
  }
}

// (minBlocks 1: ptxas otherwise caps registers to fit two or three of the
// largest blocks an SM and spills; the path runs one or two warps an SM)
template <typename T, int DMAX>
__global__ void __launch_bounds__(max_threads<DMAX>(), 1)
flash_decode_lanes_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ length, T* __restrict__ o,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out, int Tk, int HQ, int HKV,
                          int D, int group, int64_t q_bstride, float qscale,
                          int width) {
  constexpr int NS = kKeyTile / kLanes;  // keys a lane takes from one tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  // block (heads_per_kv * G, kv_heads); grid (batch rows, kv-head tiles,
  // parts of a GQA group)
  const int kv_heads = blockDim.y;
  const int tile_elems = kKeyTile * kv_heads * DMAX;  // one K or V tile
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int b = blockIdx.x;
  const int kh0 = blockIdx.y * kv_heads;
  const int n_buf = Tk > kKeyTile ? 2 : 1;
  // all kv heads and D = DMAX: the row's tile is one contiguous range
  const bool flat = kv_heads == HKV && D == DMAX;

  // this thread's head, length and query: the loads go out first, and
  // nothing waits on them until the K/V copies are issued
  const int g = threadIdx.x % kLanes;
  const int h = (kh0 + threadIdx.y) * group +
                blockIdx.z * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  const int len = length[b];
  QWords<T, DMAX> qw;
  load_q<T, DMAX>(qw, q + b * q_bstride + static_cast<int64_t>(h) * D, D,
                  width);

  if (D < DMAX) {  // zero the pad columns, which no copy writes
    const int n = n_buf * 2 * tile_elems / DMAX;
    for (int e = tid; e < n; e += nthreads)
      for (int d = D; d < DMAX; ++d) store(smem + e * DMAX + d, 0.0f);
  }
  stage_tile<T, DMAX>(smem, k, v, 0, 0, b, Tk, HKV, kh0, D, kv_heads, width,
                      flat, tid, nthreads);
  cp_async_commit();
  float qr[DMAX], acc[DMAX];
  q_from_raw<DMAX>(qr, qw, qscale);
#pragma unroll
  for (int d = 0; d < DMAX; ++d) acc[d] = 0.0f;
  float m = kNegInf, l = 0.0f;

  int buf = 0;
  for (int t0 = 0; t0 < Tk; t0 += kKeyTile, buf ^= 1) {
    if (t0 + kKeyTile < Tk) {
      stage_tile<T, DMAX>(smem, k, v, t0 + kKeyTile, buf ^ 1, b, Tk, HKV,
                          kh0, D, kv_heads, width, flat, tid, nthreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t0 has landed
    const int jn = min(kKeyTile, Tk - t0);
    const T* ks = smem + buf * 2 * tile_elems + threadIdx.y * DMAX;
    const T* vs = ks + tile_elems;
    // lane g takes keys j = g + i * G; past the tile's jn keys it reads the
    // last staged key instead and gives it no weight, so the loops have no
    // branch and the keys' loads and FMAs interleave
    float sc[NS];
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int j = g + i * kLanes;
      const float s = dot_row<DMAX>(qr, ks + min(j, jn - 1) * kv_heads * DMAX);
      sc[i] = j >= jn ? -INFINITY : t0 + j < len ? s : kNegInf;
      mt = fmaxf(mt, sc[i]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = fast_exp2(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) acc[d] *= alpha;
    // a masked key weighs 1 while the lane has no valid key, else 0; a key
    // past the tile weighs 0 (exp2(-inf) = 0)
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = fast_exp2(sc[i] - m_new);
      l += p;
      axpy_row<DMAX>(acc, p,
                     vs + min(g + i * kLanes, jn - 1) * kv_heads * DMAX);
    }
    m = m_new;
    if (t0 + 2 * kKeyTile < Tk) __syncthreads();  // buf is refilled next
  }

  // log-sum-exp merge of the G lanes, the same bits in every lane
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    const float a = fast_exp2(m - m_new);
    const float c = fast_exp2(m_o - m_new);
    l = __fadd_rn(__fmul_rn(l, a), __fmul_rn(l_o, c));
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = __fadd_rn(__fmul_rn(acc[d], a), __fmul_rn(acc_o, c));
    }
    m = m_new;
  }

  // lane g stores column g of its (row, head) (DMAX <= G)
  const int64_t pair = static_cast<int64_t>(b) * HQ + h;
  float val = acc[0];
#pragma unroll
  for (int e = 1; e < DMAX; ++e)
    if (g == e) val = acc[e];
  if (g < D) store(o + pair * D + g, val / fmaxf(l, 1e-30f));
  if (g == 0 && m_out != nullptr) {
    // back to natural-log units; the mask value stays exactly -1e30
    m_out[pair] = m == kNegInf ? kNegInf : m * kLn2;
    l_out[pair] = l;
  }
}

template <typename T, int DMAX>
int launch_lanes(const void* q, const void* k, const void* v,
                 const int* length, void* o, float* m, float* l, int B,
                 int Tk, int HQ, int HKV, int D, int64_t q_bstride,
                 float scale, int lanes, int heads, int smem_bytes, int width,
                 cudaStream_t stream) {
  const int esize = static_cast<int>(sizeof(T));
  const int group = HQ / HKV;
  const bool whole_groups = heads >= group;
  const int kv_heads = whole_groups ? heads / group : 1;
  const int per_kv = whole_groups ? group : heads;  // q heads per kv head
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15u) == 0;
  const bool width_ok =
      width == esize || (width == 16 && aligned && D * esize % 16 == 0 &&
                         q_bstride * esize % 16 == 0);
  if (lanes != kLanes || heads < 1 || HQ % heads ||
      (whole_groups ? heads % group : group % heads) ||
      heads * kLanes > max_threads<DMAX>() || !width_ok ||
      smem_bytes > kMaxSmem || (m == nullptr) != (l == nullptr) ||
      smem_bytes != smem_bytes_of(kv_heads, Tk, DMAX, esize))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, HKV / kv_heads, group / per_kv);
  if (grid.y > kMaxGridYZ || grid.z > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(per_kv * kLanes, kv_heads);
  flash_decode_lanes_kernel<T, DMAX><<<grid, block, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(o), m, l, Tk, HQ, HKV,
      D, group, q_bstride, scale * kLog2e, width);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Head dims 64 and 128: one block per (row, q head), a thread per key (the
// first port's design)

constexpr int kThreads = 128;      // keys per tile, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = kThreads;    // head dims up to 128

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

template <typename T>
int launch_rows(const void* q, const void* k, const void* v,
                const int* length, void* o, float* m, float* l, int B, int Tk,
                int HQ, int HKV, int D, int64_t q_bstride, float scale,
                int lanes, int heads, cudaStream_t stream) {
  // the first port's layout: a contiguous q, and m and l always written
  if (lanes != 1 || heads != 1 ||
      q_bstride != static_cast<int64_t>(HQ) * D || m == nullptr ||
      l == nullptr || B > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(HQ, B);
  flash_decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(o), m, l, Tk, HQ, HKV,
      D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* length,
             void* o, float* m, float* l, int B, int Tk, int HQ, int HKV,
             int D, int64_t q_bstride, float scale, int lanes, int heads,
             int smem_bytes, int width, cudaStream_t stream) {
#define FD_ARGS                                                         \
  q, k, v, length, o, m, l, B, Tk, HQ, HKV, D, q_bstride, scale, lanes, \
      heads, smem_bytes, width, stream
  if (D <= 8) return launch_lanes<T, 8>(FD_ARGS);
  if (D <= 16) return launch_lanes<T, 16>(FD_ARGS);
  if (D <= 32) return launch_lanes<T, 32>(FD_ARGS);
#undef FD_ARGS
  return launch_rows<T>(q, k, v, length, o, m, l, B, Tk, HQ, HKV, D,
                        q_bstride, scale, lanes, heads, stream);
}

}  // namespace

// is_bf16: q, k, v, o are bf16, else f32.  D <= 128.  q_bstride: elements
// between q's batch rows (0 broadcasts one query).  m and l may both be null
// (lanes kernel only): the partials are then not written.  lanes, heads,
// smem_bytes, width: the launch plan of kernels/flash_decode.py launch_plan
// (head dims above 32 take the thread-per-key kernel with lanes 1 and
// heads 1, and ignore the rest).
extern "C" int fd_flash_decode(const void* q, const void* k, const void* v,
                               const int* length, void* o, float* m, float* l,
                               int B, int Tk, int HQ, int HKV, int D,
                               long long q_bstride, float scale, int is_bf16,
                               int lanes, int heads, int smem_bytes,
                               int width, cudaStream_t stream) {
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, length, o, m, l, B, Tk, HQ, HKV,
                                   D, q_bstride, scale, lanes, heads,
                                   smem_bytes, width, stream);
  return dispatch<float>(q, k, v, length, o, m, l, B, Tk, HQ, HKV, D,
                         q_bstride, scale, lanes, heads, smem_bytes, width,
                         stream);
}
