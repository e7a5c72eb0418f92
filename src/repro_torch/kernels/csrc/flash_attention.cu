// Flash attention forward for Hopper (sm_90a): the CUDA counterpart of the
// Pallas TPU kernel in src/repro/kernels/flash_attention.py.
//
//   fa_flash_attention replaces flash_attention._kernel (pallas_call at :103)
//
// Layout: the public one, no transposes.  q and o are [B, S, HQ, D], k and v
// [B, T, HKV, D], row-major, f32 or bf16 (o in q's type); sums are f32 (the
// bf16 kernel's products run on the tensor cores, exact).  q head h reads
// kv head h / (HQ / HKV) (GQA).  The causal mask uses the offset T - S; the
// optional sliding window keeps keys with pos - window < t <= pos.
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
// f32 at head dims 33-128: flash_attention_row_kernel, the first port's
// design, unchanged: one block per 64 query rows of one (batch, head), one
// thread per row walking the keys with a per-key online softmax.  No timed
// path runs it (the LM runs bf16; TF32 stays off, so f32 has no tensor
// cores): the 2-layer f32 LM on the card and phase 8's f32 cases do.
//
// bf16 at head dims 33-256: flash_attention_mma_kernel<DMAX> (DMAX 64, 96,
// 128, 256; D pads into the next DMAX with zero columns).  The LM prefill
// (models/attention.py attention(impl="flash")) launches it once a layer:
// granite-3-8b at D = 128 (GQA group 4) and phi3-mini at D = 96.  At
// granite's [4, 512, 32 | 8, 128] a call moves 42 MB and does 8.6 GFLOP of
// causal q.k and p.v: the bf16 tensor cores (8.7 us at the data sheet's 989
// TFLOP/s) and the bytes (12.5 us at 3.35 TB/s) bound it about equally, and
// the f32 FMA pipes alone would need 128 us.  So the products run on the
// tensor cores, FlashAttention-2's shape with mma.sync:
//   * A block is 4 warps and 64 query positions of one q head; each warp
//     owns 16 of them.  Grid: (q heads, batch, position tiles), the last
//     (longest causal) tile first, so the grid's tail is short.  The heads
//     of a GQA group stage their kv head's tiles apart and share them in
//     L2: packing the group into one block (8 warps, one staged tile for 4
//     heads) measured no faster alone, and within 0.2 % of a prefill step,
//     on the card (PERF.md).
//   * q is staged once and held in registers as m16n8k16 A fragments
//     (ldmatrix); at DMAX 256 it is re-read from shared memory each tile,
//     so that the f32 output tile (128 floats a lane) fits without a spill.
//     K and V tiles of 64 keys (32 at DMAX 256) are staged as bf16 in
//     dynamic shared memory, double-buffered behind one barrier a tile (the
//     next tile's copies go out after it), by 16-byte cp.async, each row
//     padded by 16 bytes so that ldmatrix (K) and ldmatrix.trans (V) read
//     without bank conflicts.  The launch opts in to more than 48 KB once
//     an instance and device (cudaFuncSetAttribute).
//   * S = q . K^T by bf16 mma into f32; the scale 1/sqrt(D) (times log2 e)
//     multiplies the f32 S, never the bf16 q (1/sqrt(128) is not a power
//     of two, so folding it into q would round it).  An online softmax per
//     row: the max across the 4 lanes of a quad by shuffles, ex2.approx,
//     the row sum of the f32 weights kept per lane and reduced once at the
//     end.
//   * P . V: P stays in registers as the A operand, in kPTerms = 2 bf16
//     terms: P rounded to bf16 and the rest P - bf16(P) rounded again (one
//     more mma a tile, no extra bytes), so each weight is within ~2^-17 of
//     the f32 P the reference weighs v by (one bf16 term alone is off by up
//     to 2^-9).  O stays in f32 registers, is divided by max(l, 1e-30) at
//     the end, and leaves through shared memory as coalesced 16-byte stores.
//   * Tiles before the block's window start or past its causal limit are
//     not staged when every row of the block has a valid key, and a warp
//     skips a tile that masks all its rows once each has a valid key: such
//     a tile adds exactly nothing (exp2(-1e30 - m) = 0).  No atomics and no
//     split over keys: a call repeats bitwise.
// The launch plan (kernel, rows, key tile, shared memory, copy width) is
// chosen by launch_plan() in kernels/flash_attention.py; this file checks
// it and refuses any other.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it does not take.

#include <limits.h>
#include <math.h>

#include "attn_common.cuh"

namespace {

constexpr int kRows = 64;          // row kernel: query rows per block
constexpr int kMaxGridYZ = 65535;
constexpr int kMaxKeyTile = 64;    // lanes kernel: keys per tile, at most

// ---------------------------------------------------------------------------
// Head dims up to 32: G lanes per (query row, head)

constexpr int kLanes = 4;  // G: lanes per (query row, head)

// the most threads a block of the lanes kernel may have
template <int DMAX>
__host__ __device__ constexpr int max_threads() {
  return DMAX >= 32 ? 256 : 512;
}

// One unit of `width` bytes from global to shared memory, or back
template <bool kToShared>
__device__ __forceinline__ void copy_between(char* s, char* g, int width) {
  if (kToShared)
    copy_unit(s, g, width);
  else
    copy_unit_out(g, s, width);
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
      copy_between<kToShared>(sb + off, gb + off, width);
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
    copy_between<kToShared>(sb + (rr * DMAX) * sizeof(T) + c * width,
                            gb + row * D * sizeof(T) + c * width, width);
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
            sc[i] = dot_row_serial<DMAX>(qr, ks + j * kv_heads * DMAX);
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
// f32 at head dims 33-128: one thread per query row (the first port's design)

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

template <int DMAX>
int launch_rows(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int HQ, int HKV, int D, float scale,
                int causal, int window, int rows, int heads, int lanes,
                cudaStream_t stream) {
  if (rows != kRows || heads != 1 || lanes != 1 || B > kMaxGridYZ ||
      HQ > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kRows - 1) / kRows, HQ, B);
  flash_attention_row_kernel<float, DMAX><<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, HQ, HKV,
      D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 at head dims 33-256: warps of 16 query rows on the bf16 tensor cores

constexpr int kMmaRows = 64;  // query positions a block: 4 warps of 16
constexpr int kMmaThreads = 2 * kMmaRows;
constexpr int kPTerms = 2;  // bf16 terms of P in P . V: bf16(P) and the rest
constexpr int kMaxSmemOptin = 232448;  // 227 KB, after the opt-in
constexpr int kMaxDevices = 64;

// keys of one staged K/V tile: 32 at DMAX 256, so that the score and P
// fragments fit in registers beside the 128 floats of the output tile
template <int DMAX>
__host__ __device__ constexpr int mma_key_tile() {
  return DMAX >= 256 ? 32 : 64;
}

// Shared memory: the q tile [kMmaRows][DMAX + 8] (the output tile at the
// end), then two buffers of a K tile and a V tile [key_tile][DMAX + 8].
// The 8 extra columns (16 bytes) move each row 4 banks on from the one
// before, so the 8 rows an ldmatrix reads lie in 32 different banks.
__host__ __device__ inline int mma_smem_bytes(int dmax, int key_tile) {
  return (kMmaRows + 4 * key_tile) * (dmax + 8) * 2;
}

// four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and each lane gets (row lane/4, columns 2(lane%4)
// and +1) of each, or with .trans (rows 2(lane%4) and +1, column lane/4)
__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a . b: a 16x16 bf16 (row-major), b 16x8 bf16 (column-major), c 16x8
// f32; the products are exact and summed in f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats rounded to a bf16 pair (the first in the low half), and the
// pair's values back in f32
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// n rows of D bf16 into shared rows of LD elements, row i from
// src + i * stride, by 16-byte cp.async of `chunks` units a row; rows
// i >= n_valid are zero rows
template <int LD>
__device__ __forceinline__ void stage_rows_16(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              int64_t stride, int n,
                                              int n_valid, int chunks) {
  for (int u = threadIdx.x; u < n * chunks; u += kMmaThreads) {
    const int i = u / chunks;
    const int c = u - i * chunks;
    __nv_bfloat16* s = dst + i * LD + 8 * c;
    if (i < n_valid)
      cp_async_16(s, src + i * stride + 8 * c);
    else
      *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
  }
}
// the same with the plan's copy width: 16-byte units (D = DMAX: a constant
// count a row), or 2-byte copies for rows that are not whole 16-byte units
template <int DMAX>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int n, int n_valid,
                                           int D, int width) {
  constexpr int LD = DMAX + 8;
  if (width == 16 && D == DMAX) {
    stage_rows_16<LD>(dst, src, stride, n, n_valid, DMAX / 8);
  } else if (width == 16) {
    stage_rows_16<LD>(dst, src, stride, n, n_valid, D / 8);
  } else {
    for (int u = threadIdx.x; u < n * D; u += kMmaThreads) {
      const int i = u / D;
      const int c = u - i * D;
      dst[i * LD + c] =
          i < n_valid ? src[i * stride + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int S, int Tk,
                           int HQ, int HKV, int D, float qk_scale, int causal,
                           int window, int width) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = mma_key_tile<DMAX>();
  constexpr int LD = DMAX + 8;   // a staged row, in elements
  constexpr int KC = DMAX / 16;  // 16-column chunks of q . k
  constexpr int NB = BK / 8;     // 8-key blocks of a score tile
  constexpr int DB = DMAX / 8;   // 8-column blocks of the output tile
  constexpr bool kQInRegs = DMAX <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kvs = qs + kMmaRows * LD;  // buffer u: K at kvs + 2u * BK * LD, then V

  // grid (q heads, batch, tiles of kMmaRows query positions, the last first)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int p0 = (gridDim.z - 1 - blockIdx.z) * kMmaRows;
  const int n_pos = min(kMmaRows, S - p0);
  const int offset = Tk - S;

  // keys the block needs: all T, or from its first row's window start to
  // its last row's causal limit when every row has a valid key
  const int pmin = p0 + offset, pmax = p0 + n_pos - 1 + offset;
  const bool all_valid = !causal || pmin >= 0;
  const int kbeg = all_valid && window > 0 ? max(0, pmin - window + 1) : 0;
  const int kend = all_valid && causal ? min(Tk, pmax + 1) : Tk;
  const int tile0 = kbeg / BK;
  const int tile1 = (kend + BK - 1) / BK;

  if (D < DMAX) {  // zero the pad columns, which no copy writes
    const int pad = DMAX - D;
    for (int e = threadIdx.x; e < (kMmaRows + 4 * BK) * pad;
         e += kMmaThreads)
      qs[(e / pad) * LD + D + e % pad] = __float2bfloat16_rn(0.0f);
  }
  const int64_t kv_stride = static_cast<int64_t>(HKV) * D;
  const bf16* kg = k + (b * Tk * HKV + h / (HQ / HKV)) * D;
  const bf16* vg = v + (b * Tk * HKV + h / (HQ / HKV)) * D;
  stage_rows<DMAX>(qs, q + ((b * S + p0) * HQ + h) * D,
                   static_cast<int64_t>(HQ) * D, kMmaRows, n_pos, D, width);
  auto stage_kv = [&](int tile, int buf) {
    const int t0 = tile * BK;
    bf16* ks = kvs + buf * 2 * BK * LD;
    stage_rows<DMAX>(ks, kg + t0 * kv_stride, kv_stride, BK, Tk - t0, D,
                     width);
    stage_rows<DMAX>(ks + BK * LD, vg + t0 * kv_stride, kv_stride, BK,
                     Tk - t0, D, width);
  };
  stage_kv(tile0, 0);
  cp_async_commit();

  // the warp's 16 rows: positions wp0 .. wp0 + 15; this lane's two rows are
  // wp0 + lane / 4 and 8 more
  const int wr0 = warp * 16;
  const int wp0 = p0 + wr0;
  const int wmin = wp0 + offset, wmax = wmin + 15;
  const bool w_live = wp0 < S;
  const bool w_valid = !causal || wmin >= 0;  // each row has a valid key
  const int pos_a = wmin + lane / 4, pos_b = pos_a + 8;
  // this lane's ldmatrix row addresses (elements): q as the A operand, K as
  // the B operand of q . k (non-transposed), V of p . v (transposed)
  const int q_off = (wr0 + lane % 16) * LD + (lane / 16) * 8;
  const int k_off = ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int v_off = ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
  const unsigned qs_addr = shared_addr(qs), kvs_addr = shared_addr(kvs);

  uint32_t qf[kQInRegs ? KC : 1][4];
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  int buf = 0;
  for (int tile = tile0; tile < tile1; ++tile, buf ^= 1) {
    // one barrier a tile: tile `tile` (and at the first tile the q rows)
    // has landed, and every warp is done with the other buffer, which then
    // takes tile + 1 while this one is computed
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < tile1) {
      stage_kv(tile + 1, buf ^ 1);
      cp_async_commit();
    }
    if (kQInRegs && tile == tile0) {
#pragma unroll
      for (int kc = 0; kc < (kQInRegs ? KC : 0); ++kc)
        ldsm_x4(qs_addr + 2 * (q_off + 16 * kc), qf[kc]);
    }
    const int t0 = tile * BK;
    // a tile that masks every row of the warp adds exactly nothing once each
    // row has a valid key (exp2(-1e30 - m) = 0), before or after it
    const bool skip =
        !w_live || (w_valid && ((causal && t0 > wmax) ||
                                (window > 0 && t0 + BK - 1 <= wmin - window)));
    if (!skip) {
      const unsigned ks = kvs_addr + 2 * (buf * 2 * BK * LD);
      const unsigned vs = ks + 2 * (BK * LD);
      // S = q . K^T in f32
      float sc[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
        } else {
          ldsm_x4(qs_addr + 2 * (q_off + 16 * kc), a);
        }
#pragma unroll
        for (int jp = 0; jp < NB / 2; ++jp) {
          uint32_t bk[4];
          ldsm_x4(ks + 2 * (k_off + jp * 16 * LD + kc * 16), bk);
          mma_bf16(sc[2 * jp], a, bk[0], bk[1]);
          mma_bf16(sc[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
      // scale (times log2(e)) in f32; a masked key scores -1e30 and takes
      // part in the max, a key past T is no key (-inf: weight 0)
      const bool full = t0 + BK <= Tk && (!causal || t0 + BK - 1 <= wmin) &&
                        (window <= 0 || t0 > wmax - window);
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[j][e] * qk_scale;
          if (!full) {
            const int t = t0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            if (t >= Tk)
              s = -INFINITY;
            else if ((causal && t > pos) || (window > 0 && t <= pos - window))
              s = kNegInf;
          }
          sc[j][e] = s;
          if (e < 2)
            mx_a = fmaxf(mx_a, s);
          else
            mx_b = fmaxf(mx_b, s);
        }
      // a row's scores lie in the 4 lanes of a quad
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = fast_exp2(m_a - mn_a), al_b = fast_exp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      // P as the A operand of P . V in kPTerms bf16 terms, each the rest of
      // the one before rounded to bf16 (P's own rounding is up to 2^-9 of
      // it, the rest's ~2^-17); l sums the f32 weights
      uint32_t pt[kPTerms][BK / 16][4];
      float ls_a = 0.0f, ls_b = 0.0f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* s = sc[2 * kk + half];
          float ra0 = fast_exp2(s[0] - mn_a);
          float ra1 = fast_exp2(s[1] - mn_a);
          float rb0 = fast_exp2(s[2] - mn_b);
          float rb1 = fast_exp2(s[3] - mn_b);
          ls_a += ra0 + ra1;
          ls_b += rb0 + rb1;
#pragma unroll
          for (int u = 0; u < kPTerms; ++u) {
            const uint32_t ha = pack_bf16(ra0, ra1), hb = pack_bf16(rb0, rb1);
            pt[u][kk][2 * half] = ha;
            pt[u][kk][2 * half + 1] = hb;
            const float2 fa = unpack_bf16(ha), fb = unpack_bf16(hb);
            ra0 -= fa.x;
            ra1 -= fa.y;
            rb0 -= fb.x;
            rb1 -= fb.y;
          }
        }
      l_a = l_a * al_a + ls_a;  // this lane's part of the row's sum
      l_b = l_b * al_b + ls_b;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        acc[j][0] *= al_a;
        acc[j][1] *= al_a;
        acc[j][2] *= al_b;
        acc[j][3] *= al_b;
      }
      // O += P . V in f32
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int dp = 0; dp < DB / 2; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(vs + 2 * (v_off + kk * 16 * LD + dp * 16), bv);
#pragma unroll
          for (int u = 0; u < kPTerms; ++u) {
            mma_bf16(acc[2 * dp], pt[u][kk], bv[0], bv[1]);
            mma_bf16(acc[2 * dp + 1], pt[u][kk], bv[2], bv[3]);
          }
        }
    }
  }

  // the row sums over the quad (the same bits in its 4 lanes), then the
  // warp's rows of the q tile, which only this warp read, take its output
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  bf16* os = qs + wr0 * LD;
  const int ra = lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    *reinterpret_cast<uint32_t*>(os + ra * LD + 8 * j + cq) =
        pack_bf16(acc[j][0] / den_a, acc[j][1] / den_a);
    *reinterpret_cast<uint32_t*>(os + (ra + 8) * LD + 8 * j + cq) =
        pack_bf16(acc[j][2] / den_b, acc[j][3] / den_b);
  }
  __syncwarp();
  const int n_out = min(16, S - wp0);  // rows past S are not stored
  bf16* og = o + ((b * S + wp0) * HQ + h) * D;
  const int64_t o_stride = static_cast<int64_t>(HQ) * D;
  if (width == 16) {
    const int chunks = D / 8;
    for (int u = lane; u < n_out * chunks; u += 32) {
      const int i = u / chunks;
      const int c = u - i * chunks;
      *reinterpret_cast<uint4*>(og + i * o_stride + 8 * c) =
          *reinterpret_cast<const uint4*>(os + i * LD + 8 * c);
    }
  } else {
    for (int u = lane; u < n_out * D; u += 32) {
      const int i = u / D;
      og[i * o_stride + u - i * D] = os[i * LD + u - i * D];
    }
  }
}

template <int DMAX>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Tk, int HQ, int HKV, int D, float scale, int causal,
               int window, int rows, int heads, int lanes, int key_tile,
               int smem_bytes, int width, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15u) == 0;
  const bool width_ok = width == 2 || (width == 16 && aligned && D % 8 == 0);
  const dim3 grid(HQ, B, (S + kMmaRows - 1) / kMmaRows);
  if (rows != kMmaRows || heads != 1 || lanes != 1 ||
      key_tile != mma_key_tile<DMAX>() || !width_ok ||
      smem_bytes != mma_smem_bytes(DMAX, key_tile) ||
      grid.y > kMaxGridYZ || grid.z > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_mma_kernel<DMAX>;
  // above 48 KB only after the opt-in: once an instance and device
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemOptin);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  kernel<<<grid, kMmaThreads, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, Tk, HQ, HKV, D, scale * kLog2e, causal, window, width);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lanes_any(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Tk, int HQ, int HKV, int D,
                     float scale, int causal, int window, int rows,
                     int heads, int lanes, int key_tile, int smem_bytes,
                     int width, cudaStream_t stream) {
#define FA_LANES_ARGS                                                      \
  q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal, window, rows, heads, \
      lanes, key_tile, smem_bytes, width, stream
  if (D <= 8) return launch_lanes<T, 8>(FA_LANES_ARGS);
  if (D <= 16) return launch_lanes<T, 16>(FA_LANES_ARGS);
  return launch_lanes<T, 32>(FA_LANES_ARGS);
#undef FA_LANES_ARGS
}

}  // namespace

// window <= 0: no sliding window.  is_bf16: q, k, v, o are bf16, else f32.
// kernel, rows, heads, lanes, key_tile, smem_bytes, width: the launch plan of
// kernels/flash_attention.py launch_plan.  kernel 0 is the lanes kernel
// (D <= 32), 1 the row kernel (f32 at 32 < D <= 128: rows 64, heads 1,
// lanes 1; the rest ignored), 2 the tensor-core kernel (bf16 at
// 32 < D <= 256: rows 64, heads 1, lanes 1); any other pairing of kernel,
// dtype and D is refused.
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int Tk, int HQ,
                                  int HKV, int D, float scale, int causal,
                                  int window, int is_bf16, int kernel,
                                  int rows, int heads, int lanes,
                                  int key_tile, int smem_bytes, int width,
                                  cudaStream_t stream) {
#define FA_ARGS                                                             \
  q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal, window, rows, heads, \
      lanes, key_tile, smem_bytes, width, stream
  if (D < 1 || S < 1 || Tk < 1 || HKV < 1 || HQ % HKV)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) {
    if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (is_bf16) return launch_lanes_any<__nv_bfloat16>(FA_ARGS);
    return launch_lanes_any<float>(FA_ARGS);
  }
  if (is_bf16) {
    if (kernel != 2 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 64) return launch_mma<64>(FA_ARGS);
    if (D <= 96) return launch_mma<96>(FA_ARGS);
    if (D <= 128) return launch_mma<128>(FA_ARGS);
    return launch_mma<256>(FA_ARGS);
  }
  if (kernel != 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return launch_rows<64>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                           window, rows, heads, lanes, stream);
  return launch_rows<128>(q, k, v, o, B, S, Tk, HQ, HKV, D, scale, causal,
                          window, rows, heads, lanes, stream);
#undef FA_ARGS
}
