// Flash attention forward for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel in src/repro/kernels/flash_attention.py.
//
//   fa_flash_attention replaces flash_attention._kernel (pallas_call at :103)
//
// Layout: the public one, no transposes.  q and o are [B, S, HQ, D], k and v
// [B, T, HKV, D], row-major, f32 or bf16 (o in q's type); all arithmetic is
// f32.  q head h reads kv head h / (HQ / HKV) (GQA).  The causal mask uses
// the offset T - S; the optional sliding window keeps keys with
// pos - window < t <= pos.
//
// Masking follows the TPU kernel exactly: a masked key scores -1e30 (not
// -inf), set after scaling, and takes part in the max.  So a row with no
// valid key (S > T gives rows at pos < 0) weighs every key 1 and averages
// all T of them, and the first valid key wipes the masked ones
// (exp(-1e30 - s) == 0).  Once a row has a valid key a masked one adds
// exactly nothing and is skipped.  Rows past S and keys past T (the ragged
// edge) are not keys at all.  Tiles past every row's causal limit are
// skipped when every row of the block has a valid key.
//
// What bounds it: on the attn detector's path (B = 128, S = T = 64,
// HQ = HKV = 2, D = 8, f32, causal) a call moves 2.1 MB and does ~17 MFLOP:
// bytes bound it, at 0.63 us on an H100.  The path is f32 (TF32 stays
// off), so mma/wgmma do not apply, and its FLOPs take 0.25 us at the FMA
// peak.  What it takes instead is instruction issue: every warp of an SM
// runs the same phase at the same time, so an instruction of per-lane
// overhead (index arithmetic, divisions, exponentials, the merge) costs as
// much as one of the dot products.  The design keeps that overhead small.
//
// Head dims up to 32 (DMAX 8, 16, 32): flash_attention_kernel.
//   * One block per (batch element, tile of query rows, group of heads);
//     threadIdx is (head * G + lane, row), so no lane divides to find its
//     row and head.  On the path one block covers 32 rows x both heads
//     (256 threads) and the grid has 256 blocks: 16 warps an SM.
//   * Staging: the block's q rows and each key tile [t0, t1) x (its kv
//     heads) x D are contiguous ranges for one b (or one range per row or
//     key when the block takes a part of the heads); they go to shared
//     memory with 16-byte cp.async (4-byte units where a range is not
//     16-byte aligned; plain 2-byte copies for such bf16 rows), flat with
//     no index arithmetic when contiguous, bf16 kept as bf16 and converted
//     on read.  Key tiles are double-buffered when T spans more than one:
//     tile j+1 loads while tile j is computed.  Heads that share a kv head
//     read the same staged tile.
//   * G = 4 adjacent lanes of a warp share one (query row, head) and split
//     the keys: lane g takes keys t0 + g, t0 + g + G, ... of each tile (at
//     most 16), keeps its own (m, l, acc[DMAX]), and does the softmax
//     per tile: scores into registers, one max, one rescale of l and acc,
//     then p * v, with scale * log2(e) folded into q and ex2.approx.
//   * The G lane states merge in a fixed xor butterfly of shuffles (the
//     log-sum-exp merge of ref.combine_partials), with the products and
//     sums rounded apart so that every lane ends with the same bits.  Lane
//     g divides columns g, g + G, ... once each; the output goes through
//     shared memory to coalesced stores.  No atomics: a call repeats
//     bitwise.
//   G = 4 measured fastest on the path: at G = 8 the per-lane work that
//   does not shrink with the keys (staging, the merge, the output) is
//   paid twice as often, at G = 2 each lane's chain doubles.  The launch
//   plan (rows, heads, G, key tile, shared memory, copy width) is chosen
//   by launch_plan() in kernels/flash_attention.py; this file checks it
//   and refuses a plan it was not built for.
//
// Head dims 64 and 128: flash_attention_row_kernel, the first port's design,
// unchanged: one block per 64 query rows of one (batch, head), one thread
// per row walking the keys with a per-key online softmax.  The LM prefill
// (models/attention.py attention(impl="flash")) launches it once a layer:
// granite-3-8b at D = 128 (GQA group 4) and phi3-mini at D = 96, padded
// into DMAX 128, both bf16.  It spills at DMAX 128; its redesign (bf16
// tensor cores) is a later PR's, against the times that path measures.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;          // row kernel: query rows per block
constexpr int kMaxKeyTile = 64;    // lanes kernel: keys per tile, at most
constexpr int kMaxSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Head dims up to 32: G lanes per (query row, head)

constexpr int kLanes = 4;  // G: lanes per (query row, head)

// the most threads a block of the lanes kernel may have
template <int DMAX>
__host__ __device__ constexpr int max_threads() {
  return DMAX >= 32 ? 256 : 512;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One unit of `width` bytes: 16 or 4 by cp.async (to shared), 2 by a plain
// copy (bf16 rows that are not 4-byte aligned); plain stores to global.
template <bool kToShared>
__device__ __forceinline__ void copy_unit(char* s, char* g, int width) {
  if (kToShared) {
    if (width == 16)
      cp_async_16(s, g);
    else if (width == 4)
      cp_async_4(s, g);
    else
      *reinterpret_cast<uint16_t*>(s) = *reinterpret_cast<uint16_t*>(g);
  } else {
    if (width == 16)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<uint4*>(s);
    else if (width == 4)
      *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<uint32_t*>(s);
    else
      *reinterpret_cast<uint16_t*>(g) = *reinterpret_cast<uint16_t*>(s);
  }
}

// Copy n_outer x n_inner rows of D elements between global memory, where
// row (o, i) starts at element (o * outer_stride + i) * D of `glob`, and
// shared memory, where it is row o * n_inner + i of stride DMAX, by the
// block's threads (tid of nthreads).  When the rows are one contiguous
// range at both ends (all heads, D = DMAX; the attn path) the copy is flat
// and needs no index arithmetic.
template <typename T, int DMAX, bool kToShared>
__device__ __forceinline__ void copy_rows(T* smem, T* glob, int n_outer,
                                          int n_inner, int outer_stride,
                                          int D, int width, int tid,
                                          int nthreads) {
  char* sb = reinterpret_cast<char*>(smem);
  char* gb = reinterpret_cast<char*>(glob);
  if (D == DMAX && n_inner == outer_stride) {
    const int bytes = n_outer * n_inner * D * static_cast<int>(sizeof(T));
    for (int off = tid * width; off < bytes; off += nthreads * width)
      copy_unit<kToShared>(sb + off, gb + off, width);
    return;
  }
  const int chunks = D * static_cast<int>(sizeof(T)) / width;
  const int units = n_outer * n_inner * chunks;
  for (int u = tid; u < units; u += nthreads) {
    const int c = u % chunks;
    const int rr = u / chunks;
    const int i = rr % n_inner;
    const int o = rr / n_inner;
    const int64_t row = static_cast<int64_t>(o) * outer_stride + i;
    copy_unit<kToShared>(sb + (rr * DMAX) * sizeof(T) + c * width,
                         gb + row * D * sizeof(T) + c * width, width);
  }
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22,
// subnormal results flushed to 0; exp2(-1e30) and exp2(-inf) are 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// q . k over DMAX columns of a staged row (16-byte aligned in shared memory)
template <int DMAX>
__device__ __forceinline__ float dot_row(const float (&qr)[DMAX],
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
__device__ __forceinline__ float dot_row(const float (&qr)[DMAX],
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

// Shared memory: the q tile [rows][heads][DMAX] (the output tile at the
// end), then n_buf buffers of a K tile and a V tile [key_tile][kv_heads]
// [DMAX].  Columns D..DMAX-1 are zero.
__host__ __device__ inline int kv_heads_of(int heads, int group) {
  return heads >= group ? heads / group : 1;
}
__host__ __device__ inline int smem_bytes_of(int rows, int heads,
                                             int kv_heads, int key_tile,
                                             int Tk, int dmax, int esize) {
  const int n_buf = Tk > key_tile ? 2 : 1;
  return (rows * heads + n_buf * 2 * key_tile * kv_heads) * dmax * esize;
}

template <typename T, int DMAX, int G>
__global__ void __launch_bounds__(max_threads<DMAX>())
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Tk, int HQ, int HKV, int D, float qscale,
                       int causal, int window, int rows, int heads,
                       int key_tile, int width) {
  constexpr int NS = kMaxKeyTile / G;  // keys a lane takes from one tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group = HQ / HKV;
  const int kv_heads = kv_heads_of(heads, group);
  const int n_buf = Tk > key_tile ? 2 : 1;
  const int tile_elems = key_tile * kv_heads * DMAX;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kvs = qs + rows * heads * DMAX;

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * heads;
  const int kh0 = h0 / group;
  const int r0 = blockIdx.x * rows;
  const int n_rows = min(rows, S - r0);
  const int offset = Tk - S;

  // threadIdx = (hh * G + g, r): lane g of (row r0 + r, head h0 + hh)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int g = threadIdx.x % G;
  const int hh = threadIdx.x / G;
  const int pair = threadIdx.y * heads + hh;  // its row of the q tile
  const int row = r0 + threadIdx.y;
  const bool active = row < S;
  const int pos = row + offset;  // absolute position of this query
  const int kv_local = (h0 + hh) / group - kh0;
  // its valid keys: lo <= t <= hi
  const int hi = causal ? pos : INT_MAX;
  const int lo = window > 0 ? pos - window + 1 : INT_MIN;

  // keys this block needs: all T, or up to its last row's causal limit when
  // every row has a valid key
  int kend = Tk;
  if (causal && r0 + offset >= 0) kend = min(Tk, r0 + n_rows + offset);
  const int n_tiles = (kend + key_tile - 1) / key_tile;

  if (D < DMAX) {  // zero the pad columns, which no copy writes
    const int pad = DMAX - D;
    const int n = (rows * heads + n_buf * 2 * key_tile * kv_heads) * pad;
    for (int e = tid; e < n; e += nthreads)
      store(qs + (e / pad) * DMAX + D + e % pad, 0.0f);
  }
  const int64_t q_first = (static_cast<int64_t>(b) * S + r0) * HQ + h0;
  copy_rows<T, DMAX, true>(qs, const_cast<T*>(q) + q_first * D, n_rows, heads,
                           HQ, D, width, tid, nthreads);
  auto stage_tile = [&](int tile) {
    const int t0 = tile * key_tile;
    const int jn = min(key_tile, kend - t0);
    T* ks = kvs + (tile & 1) * 2 * tile_elems;
    const int64_t first = (static_cast<int64_t>(b) * Tk + t0) * HKV + kh0;
    copy_rows<T, DMAX, true>(ks, const_cast<T*>(k) + first * D, jn, kv_heads,
                             HKV, D, width, tid, nthreads);
    copy_rows<T, DMAX, true>(ks + tile_elems, const_cast<T*>(v) + first * D,
                             jn, kv_heads, HKV, D, width, tid, nthreads);
  };
  stage_tile(0);
  cp_async_commit();

  float qr[DMAX], acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) acc[d] = 0.0f;
  float m = kNegInf, l = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      stage_tile(tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `tile` (and at tile 0 the q rows) has landed
    if (tile == 0) {
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        qr[d] = active ? to_f32(qs[pair * DMAX + d]) * qscale : 0.0f;
    }
    if (active) {
      const int t0 = tile * key_tile;
      const int jn = min(key_tile, kend - t0);
      const T* ks = kvs + (tile & 1) * 2 * tile_elems + kv_local * DMAX;
      const T* vs = ks + tile_elems;
      float sc[NS];
      unsigned valid = 0u;
      float mt = -INFINITY;  // no key of this tile is this lane's yet
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int j = g + i * G;
        sc[i] = -INFINITY;
        if (j < jn) {
          const int t = t0 + j;
          if (t <= hi && t >= lo) {
            sc[i] = dot_row<DMAX>(qr, ks + j * kv_heads * DMAX);
            valid |= 1u << i;
          } else {
            sc[i] = kNegInf;
          }
          mt = fmaxf(mt, sc[i]);
        }
      }
      const float m_new = fmaxf(m, mt);
      const float alpha = fast_exp2(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) acc[d] *= alpha;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int j = g + i * G;
        // a masked key weighs 1 while the lane has no valid key, else 0
        if (j < jn && (((valid >> i) & 1u) || m_new == kNegInf)) {
          const float p = fast_exp2(sc[i] - m_new);
          l += p;
          axpy_row<DMAX>(acc, p, vs + j * kv_heads * DMAX);
        }
      }
      m = m_new;
    }
    __syncthreads();  // the buffer of `tile` is free for tile + 2
  }

  // log-sum-exp merge of the G lanes, the same bits in every lane
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
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

  // the q tile is free (read at tile 0, and the loop ended on a barrier):
  // lane g puts columns g, g + G, ... of its row there, then the block
  // stores the tile
  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DMAX / G; ++j) {
      float val = acc[j * G];
#pragma unroll
      for (int e = 1; e < G; ++e)
        if (g == e) val = acc[j * G + e];
      if (j * G + g < D) store(qs + pair * DMAX + j * G + g, val / denom);
    }
  }
  __syncthreads();
  copy_rows<T, DMAX, false>(qs, o + q_first * D, n_rows, heads, HQ, D, width,
                            tid, nthreads);
}

template <typename T, int DMAX>
int launch_lanes(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Tk, int HQ, int HKV, int D, float scale,
                 int causal, int window, int rows, int heads, int lanes,
                 int key_tile, int smem_bytes, int width,
                 cudaStream_t stream) {
  constexpr int G = kLanes;
  const int group = HQ / HKV;
  const int threads = rows * heads * G;
  const int esize = static_cast<int>(sizeof(T));
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15u) == 0;
  const bool width_ok =
      width == esize || (width == 16 && aligned && D * esize % 16 == 0);
  if (lanes != G || rows < 1 || heads < 1 || HQ % heads ||
      (heads % group && group % heads) ||
      threads % 32 || threads > max_threads<DMAX>() || key_tile < G ||
      key_tile > kMaxKeyTile || key_tile % G || !width_ok ||
      smem_bytes > kMaxSmem ||
      smem_bytes != smem_bytes_of(rows, heads, kv_heads_of(heads, group),
                                  key_tile, Tk, DMAX, esize))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + rows - 1) / rows, HQ / heads, B);
  const dim3 block(heads * G, rows);
  flash_attention_kernel<T, DMAX, G><<<grid, block, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, HQ, HKV, D,
      scale * kLog2e, causal, window, rows, heads, key_tile, width);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Head dims 64 and 128: one thread per query row (the first port's design)

// keys per shared-memory tile: K and V tiles of BK x DMAX f32, 32 KB at most
template <int DMAX>
__host__ __device__ constexpr int tile_keys() {
  return DMAX >= 128 ? 32 : 64;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kRows)
flash_attention_row_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_rows(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int HQ, int HKV, int D, float scale,
                int causal, int window, int rows, int heads, int lanes,
                cudaStream_t stream) {
  if (rows != kRows || heads != 1 || lanes != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kRows - 1) / kRows, HQ, B);
  flash_attention_row_kernel<T, DMAX><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, HQ, HKV, D, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tk, int HQ, int HKV, int D, float scale, int causal,
             int window, int rows, int heads, int lanes, int key_tile,
             int smem_bytes, int width, cudaStream_t stream) {
  if (D <= 8)
    return launch_lanes<T, 8>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                              window, rows, heads, lanes, key_tile,
                              smem_bytes, width, stream);
  if (D <= 16)
    return launch_lanes<T, 16>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale,
                               causal, window, rows, heads, lanes, key_tile,
                               smem_bytes, width, stream);
  if (D <= 32)
    return launch_lanes<T, 32>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale,
                               causal, window, rows, heads, lanes, key_tile,
                               smem_bytes, width, stream);
  if (D <= 64)
    return launch_rows<T, 64>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                              window, rows, heads, lanes, stream);
  return launch_rows<T, 128>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                             window, rows, heads, lanes, stream);
}

}  // namespace

// window <= 0: no sliding window.  is_bf16: q, k, v, o are bf16, else f32.
// rows, heads, lanes, key_tile, smem_bytes, width: the launch plan of
// kernels/flash_attention.py launch_plan (D > 32 takes rows 64, heads 1,
// lanes 1 and ignores the rest).
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int Tk, int HQ,
                                  int HKV, int D, float scale, int causal,
                                  int window, int is_bf16, int rows,
                                  int heads, int lanes, int key_tile,
                                  int smem_bytes, int width,
                                  cudaStream_t stream) {
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale,
                                   causal, window, rows, heads, lanes,
                                   key_tile, smem_bytes, width, stream);
  return dispatch<float>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                         window, rows, heads, lanes, key_tile, smem_bytes,
                         width, stream);
}
