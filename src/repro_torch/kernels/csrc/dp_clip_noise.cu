// Fused DP clip+noise for Hopper (sm_90a): the CUDA counterpart of the two
// Pallas TPU kernels in src/repro/kernels/dp_clip_noise.py.
//
//   dpcn_sumsq_rows       replaces _sumsq_kernel       (pallas_call at :62)
//   dpcn_scale_noise_rows replaces _scale_noise_kernel (pallas_call at :81);
//   dpcn_scale_noise_rows_sigma is the same kernel with one σ a row
//
// Both work on the stacked client updates x[R, P] (row-major f32, one row per
// client, the leaves of one update laid end to end in sorted-key order).
//
// What bounds them: each element is touched once, with 1-2 flops, so both
// are memory-bound (sumsq reads 4·R·P bytes; scale_noise reads 8·R·P and
// writes 4·R·P).  At the paper's config (R = 40, P = 13,890: 2.2 MB) a launch
// moves less data than one launch costs, so what the design can win is the
// latency of the few loads each thread makes:
//
// * sumsq: a thread-block cluster of C blocks per row (C = 1, 2, 4 or 8,
//   chosen by sumsq_plan() in kernels/dp_clip_noise.py so that R·C blocks
//   cover the 132 SMs: C = 4 at R = 40).  Block `rank` of row r (grid
//   (C, R), so rank = blockIdx.x, r = blockIdx.y, no division) takes the
//   fixed column range [rank·chunk, (rank + 1)·chunk) ∩ [0, P), chunk a
//   multiple of 4; a range may be empty when P is small.  A range is read as
//   a scalar head up to the first 16-byte boundary (a row starts at byte
//   4·r·P, so with P ≡ 2 (mod 4) every other row is only 8-byte aligned),
//   16-byte float4 loads, kUnroll of them issued together per thread before
//   any is used, and a scalar tail.  A warp-shuffle tree and a tree of warp
//   partials reduce the block.  Then every block of rank r > 0 writes its
//   partial into slot r of rank 0's shared memory (distributed shared
//   memory) with st.async, which counts the bytes in on an mbarrier there,
//   and rank 0 waits on that mbarrier and adds slots 0..C-1 in rank order.
//   A cluster barrier, arrived at when a block starts and waited on only
//   before the remote writes, makes sure rank 0 is running and its mbarrier
//   is set up; its wait is over by the time the loads are.  (In probe
//   copies on an H100 a full cluster.sync() there cost as much as the
//   loads, and a plain remote store with a release arrive more than half
//   that: with either, C = 4 was slower than one block a row.)
//   The order of every sum is fixed, with no atomics and no workspace, so a
//   row gives the same bits run to run and the launch is safe to replay in
//   a CUDA graph.  (The TPU kernel carried one SMEM scalar across its
//   sequential grid; here a row's C partials meet in the cluster, so no
//   second pass is needed.)
// * sumsq, split plan (sumsq_plan() picks it when even C = 8 leaves R·8
//   blocks short of the SMs and a block would take over 2^20 columns: one
//   or a few rows as wide as a whole language model, P = 1.8·10^9 for
//   granite-3-8b's update at 8 layers, where 8 SMs would read 7.2 GB).  A
//   row is cut into S ranges of `chunk` columns (S·R ≈ 4 blocks a SM), each
//   summed by one block exactly as a cluster block sums its range, and
//   written to partials[r·S + b]; a second launch, one block a row, adds a
//   row's S partials (thread t takes t, t + 256, ... in order, then the
//   block's trees).  Both orders are fixed, so the result is bitwise
//   repeatable; the S·R floats of workspace come from the wrapper.
// * scale_noise: a 2-D grid, y over rows and x over column tiles; each thread
//   reads its row's scale once, and its row's σ once when σ is per row (a
//   sweep's stacked lanes, each with its own ε: R = L·N rows, up to
//   [1600, 13890] f32 at 40 lanes of the paper's 40 clients, 89 MB an array,
//   where the bytes and not the launch set the bound).  The TPU kernel
//   bakes σ in as a constant, so the reference folds a traced σ into its
//   noise operand, a further pass over [R, P]; reading σ[r] here costs one
//   load a thread.  __fmul_rn/__fadd_rn keep the compiler from contracting
//   x·s + σ·n into an FMA, so the kernel rounds exactly as the plain PyTorch
//   version (three rounded ops) does, and as the fold does (σ·n rounded
//   once, then 1.0·(σ·n) exact).
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a sumsq plan it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumsqThreads = 256;
constexpr int kUnroll = 4;      // float4 loads a thread issues together
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxRows = 65535;
constexpr int kMaxSplit = 1 << 16;  // split-plan blocks a row
constexpr int kScaleThreads = 256;
constexpr int kScaleItems = 4;  // elements per thread per column tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the same shared-memory variable in the block of cluster rank `rank`
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ float sq4(float4 v, float acc) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  return fmaf(v.w, v.w, acc);
}

// the block's sum of its threads' `sum`s: a warp-shuffle tree, then a tree
// of the warp partials in warp 0; the block's total is thread 0's
__device__ __forceinline__ float block_reduce(float sum) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);

  __shared__ float warp_sums[kSumsqThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    sum = lane < kSumsqThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = kSumsqThreads / 64; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  return sum;
}

// Σ p[i]² over [0, n) by one block (p 4-byte aligned): a scalar head up to
// the first 16-byte boundary, float4 loads, kUnroll issued together per
// thread before any is used, a scalar tail; the block's total is thread 0's
__device__ __forceinline__ float block_sumsq(const float* __restrict__ p,
                                             int64_t n) {
  // elements before the first 16-byte boundary (x is 4-byte aligned)
  const int64_t misaligned = reinterpret_cast<uintptr_t>(p) % 16 / 4;
  const int64_t head = min((4 - misaligned) % 4, n);
  const int64_t n4 = (n - head) / 4;
  const int64_t tail = n - head - 4 * n4;
  const float4* p4 = reinterpret_cast<const float4*>(p + head);
  const int tid = threadIdx.x;

  float acc[kUnroll] = {};
  if (tid < head) acc[0] = p[tid] * p[tid];
  for (int64_t i = tid; i < n4; i += kSumsqThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + static_cast<int64_t>(u) * kSumsqThreads;
      v[u] = j < n4 ? __ldg(p4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = sq4(v[u], acc[u]);
  }
  if (tid < tail) {
    const float v = p[head + 4 * n4 + tid];
    acc[1] = fmaf(v, v, acc[1]);
  }
  float sum = acc[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) sum += acc[u];
  return block_reduce(sum);
}

__global__ void __launch_bounds__(kSumsqThreads)
sumsq_rows_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int64_t P, int64_t chunk) {
  const int64_t lo = min(static_cast<int64_t>(blockIdx.x) * chunk, P);
  const int64_t n = min(chunk, P - lo);
  const float* p = x + static_cast<int64_t>(blockIdx.y) * P + lo;
  const int tid = threadIdx.x;
  const unsigned rank = blockIdx.x;  // the cluster is the grid's x extent
  const bool cluster = gridDim.x > 1;

  // rank 0's slots for the others' partials, and the mbarrier that counts
  // their bytes in: its one arrival is rank 0's own, made here with the
  // bytes to expect, so it completes once all C - 1 partials have landed
  __shared__ float parts[kMaxCluster];
  __shared__ uint64_t landed;
  if (cluster) {
    if (rank == 0 && tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&landed)));
      asm volatile(
          "{\n .reg .b64 state;\n"
          " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
          :: "r"(smem_addr(&landed)), "r"(4 * (gridDim.x - 1)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }

  const float sum = block_sumsq(p, n);
  if (!cluster) {  // C = 1: the block is the row
    if (tid == 0) out[blockIdx.y] = sum;
    return;
  }
  // every block of the cluster has started and rank 0's mbarrier is set up
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid != 0) return;
  if (rank != 0) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
        "[%0], %1, [%2];"
        :: "r"(cluster_addr(&parts[rank], 0)), "f"(sum),
           "r"(cluster_addr(&landed, 0)) : "memory");
    return;
  }
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
        " p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(&landed)) : "memory");
  }
  float row = sum;
  for (unsigned r = 1; r < gridDim.x; ++r) row += parts[r];
  out[blockIdx.y] = row;
}

// split plan, pass 1: grid (S, R); block b of row r sums its columns
// [b·chunk, (b + 1)·chunk) ∩ [0, P) into partials[r·S + b]
__global__ void __launch_bounds__(kSumsqThreads)
sumsq_rows_split_kernel(const float* __restrict__ x,
                        float* __restrict__ partials, int64_t P,
                        int64_t chunk) {
  const int64_t lo = min(static_cast<int64_t>(blockIdx.x) * chunk, P);
  const int64_t n = min(chunk, P - lo);
  const float sum =
      block_sumsq(x + static_cast<int64_t>(blockIdx.y) * P + lo, n);
  if (threadIdx.x == 0)
    partials[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x] = sum;
}

// split plan, pass 2: one block a row adds the row's S partials, thread t
// taking t, t + 256, ... in order, then the block's trees
__global__ void __launch_bounds__(kSumsqThreads)
sumsq_rows_finish_kernel(const float* __restrict__ partials,
                         float* __restrict__ out, int split) {
  const float* p = partials + static_cast<int64_t>(blockIdx.x) * split;
  float sum = 0.0f;
  for (int i = threadIdx.x; i < split; i += kSumsqThreads) sum += p[i];
  sum = block_reduce(sum);
  if (threadIdx.x == 0) out[blockIdx.x] = sum;
}

// sigma_rows: one σ a row, or null for the one `sigma` of every row
__global__ void __launch_bounds__(kScaleThreads)
scale_noise_rows_kernel(const float* __restrict__ x,
                        const float* __restrict__ noise,
                        const float* __restrict__ scale, float sigma,
                        const float* __restrict__ sigma_rows,
                        float* __restrict__ out, int64_t P) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * P;
  const float s = scale[blockIdx.y];
  if (sigma_rows != nullptr) sigma = sigma_rows[blockIdx.y];
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

// grid (cluster, R) with clusters of `cluster` blocks along x, each block
// `chunk` columns of its row, as sumsq_plan() gives them
extern "C" int dpcn_sumsq_rows(const float* x, float* out, int64_t R,
                               int64_t P, int cluster, int64_t chunk,
                               cudaStream_t stream) {
  const bool ok = R >= 1 && R <= kMaxRows && P >= 0 && cluster >= 1 &&
                  cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0 &&
                  chunk == ((P + cluster - 1) / cluster + 3) / 4 * 4;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(cluster),
                        static_cast<unsigned>(R));
  config.blockDim = dim3(kSumsqThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, sumsq_rows_cluster_kernel, x, out, P, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the split plan: S = `split` blocks a row of `chunk` columns each, as
// sumsq_plan() gives them; `partials` holds R·S floats
extern "C" int dpcn_sumsq_rows_split(const float* x, float* partials,
                                     float* out, int64_t R, int64_t P,
                                     int split, int64_t chunk,
                                     cudaStream_t stream) {
  const bool ok = R >= 1 && R <= kMaxRows && P >= 0 && split >= 2 &&
                  split <= kMaxSplit &&
                  chunk == ((P + split - 1) / split + 3) / 4 * 4;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  sumsq_rows_split_kernel<<<dim3(static_cast<unsigned>(split),
                                 static_cast<unsigned>(R)),
                            kSumsqThreads, 0, stream>>>(x, partials, P,
                                                        chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sumsq_rows_finish_kernel<<<static_cast<unsigned>(R), kSumsqThreads, 0,
                             stream>>>(partials, out, split);
  return static_cast<int>(cudaGetLastError());
}

namespace {

int launch_scale_noise(const float* x, const float* noise, const float* scale,
                       float sigma, const float* sigma_rows, float* out,
                       int64_t R, int64_t P, cudaStream_t stream) {
  const int64_t tile = static_cast<int64_t>(kScaleThreads) * kScaleItems;
  int64_t tiles = (P + tile - 1) / tile;
  if (tiles < 1) tiles = 1;
  if (tiles > 65535) tiles = 65535;  // the loop strides over the rest
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(R));
  scale_noise_rows_kernel<<<grid, kScaleThreads, 0, stream>>>(
      x, noise, scale, sigma, sigma_rows, out, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dpcn_scale_noise_rows(const float* x, const float* noise,
                                     const float* scale, float sigma,
                                     float* out, int64_t R, int64_t P,
                                     cudaStream_t stream) {
  return launch_scale_noise(x, noise, scale, sigma, nullptr, out, R, P,
                            stream);
}

// one σ a row: sigma[R]
extern "C" int dpcn_scale_noise_rows_sigma(const float* x, const float* noise,
                                           const float* scale,
                                           const float* sigma, float* out,
                                           int64_t R, int64_t P,
                                           cudaStream_t stream) {
  return launch_scale_noise(x, noise, scale, 0.0f, sigma, out, R, P, stream);
}
