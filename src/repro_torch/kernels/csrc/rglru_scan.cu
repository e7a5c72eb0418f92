// Diagonal linear recurrence h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a):
// the CUDA counterpart of the Pallas TPU kernel in
// src/repro/kernels/rglru_scan.py.
//
//   rgs_rglru_scan replaces rglru_scan._kernel (pallas_call at :60)
//
// Layout: a, x, h are [B, L, W] row-major f32, h0 and h_last [B, W].  The
// TPU kernel's chunk grid existed to keep the state in VMEM across
// sequential grid steps; here the state is a register and no block needs
// another's result, so nothing crosses blocks.
//
// What bounds it: each element of a and x is read once and each h written
// once with 2 flops, so bytes bound it (12 bytes per element, plus the h0
// and h_last rows): 1.6-3.1 MB on the detectors' shapes, under a
// microsecond at 3.35 TB/s.  What sets the time instead is the serial chain
// of steps each thread walks and what stalls it.  The first port's loop (a
// thread per lane, loads hoisted two or three steps ahead by nvcc, h stored
// every step) took 5.4 us on the rglru detector's [128, 64, 16] on an H100
// (chip_before_after.py), about 65 ns a step over the launch floor, and
// probe copies that spread the lanes over more SMs or kept more loads in
// flight took as long: the store of h_t reads the registers that step
// t + 1 overwrites, so every step waited on a memory instruction.  This
// design keeps memory instructions off the chain:
//
//   * rglru_scan_tiles_kernel<VEC>: thread (x, y) of a 2-D block owns the
//     VEC adjacent lanes w0 = VEC * (blockIdx.x * blockDim.x + x) of batch
//     row b = blockIdx.y * blockDim.y + y: no division in the index math.
//     A block packs blockDim.y rows when W is narrow.
//   * The time axis goes in register tiles of kTile = kTileElems / VEC
//     steps: 4 steps of 4 lanes or 16 steps of 1 lane.  All loads of a tile
//     go out together: 16-byte float4 with 4 lanes, one element with 1.
//     Two tiles ping-pong, so tile k + 1's loads are in flight while tile
//     k's chain runs.
//   * A whole tile's chain runs on registers, writing each h_t over the x_t
//     it no longer needs, and the tile's h leave after it: no step waits on
//     a memory instruction.  Only a ragged last tile (and L < kTile) takes
//     per-step guards.
//   * 4 lanes a thread for calls of one 4-step tile whose W % 4 == 0 and
//     whose pointers are 16-byte aligned (the ssm detector's [128, 4, 512]:
//     fewer, wider threads); 1 lane a thread otherwise (the rglru
//     detector's [128, 64, 16]: four times the threads, each with one
//     chain and 16-step tiles), as launch_plan() picks them.
//   * The recurrence is __fadd_rn(__fmul_rn(a, h), x) in t order: the
//     compiler may not contract it into an FMA, so the kernel rounds
//     exactly as the plain PyTorch version (a product, then a sum) does, and
//     the two are bitwise equal.  A time-parallel (associative) scan would
//     round differently, and is not used.
//
// The launch (lanes a thread, block and grid shape) is chosen by
// launch_plan() in kernels/rglru_scan.py; the entry point checks it and
// refuses a plan that does not cover the input or that its pointers do not
// allow.  Plain C interface, loaded with ctypes: the entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileElems = 16;    // elements of a and of x in one tile
constexpr int kMaxThreads = 256;  // threads of one block, at most
constexpr int kMaxGridY = 65535;

// One register tile: kTile time steps of a thread's VEC lanes.
template <int VEC>
struct Tile {
  static constexpr int kTile = kTileElems / VEC;
  float a[kTile][VEC];
  float x[kTile][VEC];
};

template <int VEC>
__device__ __forceinline__ void load_step(Tile<VEC>& tile, int j,
                                          const float* __restrict__ pa,
                                          const float* __restrict__ px) {
  if constexpr (VEC == 4) {
    const float4 va = __ldg(reinterpret_cast<const float4*>(pa));
    const float4 vx = __ldg(reinterpret_cast<const float4*>(px));
    tile.a[j][0] = va.x; tile.a[j][1] = va.y;
    tile.a[j][2] = va.z; tile.a[j][3] = va.w;
    tile.x[j][0] = vx.x; tile.x[j][1] = vx.y;
    tile.x[j][2] = vx.z; tile.x[j][3] = vx.w;
  } else {
    tile.a[j][0] = __ldg(pa);
    tile.x[j][0] = __ldg(px);
  }
}

// Steps [t0, t0 + kTile) ∩ [0, L) of a and x into a tile, every load issued
// before anything waits on one.  pa and px point at (b, 0, w0).
template <int VEC>
__device__ __forceinline__ void load_tile(Tile<VEC>& tile,
                                          const float* __restrict__ pa,
                                          const float* __restrict__ px,
                                          int t0, int L, int64_t W) {
  constexpr int kTile = Tile<VEC>::kTile;
  const int64_t off = static_cast<int64_t>(t0) * W;
  if (t0 + kTile <= L) {
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      load_step<VEC>(tile, j, pa + off + j * W, px + off + j * W);
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      if (t0 + j < L)
        load_step<VEC>(tile, j, pa + off + j * W, px + off + j * W);
  }
}

template <int VEC>
__device__ __forceinline__ void store_step(float* out,
                                           const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  else
    out[0] = v[0];
}

// The recurrence over one loaded tile, in t order, each h_t written over
// x_t; the tile's h are stored once its chain has run.
template <int VEC>
__device__ __forceinline__ void run_tile(Tile<VEC>& tile, float (&s)[VEC],
                                         float* __restrict__ ph, int t0,
                                         int L, int64_t W) {
  constexpr int kTile = Tile<VEC>::kTile;
  float* out = ph + static_cast<int64_t>(t0) * W;
  const int n = t0 + kTile <= L ? kTile : L - t0;
  if (n == kTile) {
#pragma unroll
    for (int j = 0; j < kTile; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s[k] = __fadd_rn(__fmul_rn(tile.a[j][k], s[k]), tile.x[j][k]);
        tile.x[j][k] = s[k];
      }
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      store_step<VEC>(out + j * W, tile.x[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s[k] = __fadd_rn(__fmul_rn(tile.a[j][k], s[k]), tile.x[j][k]);
          tile.x[j][k] = s[k];
        }
        store_step<VEC>(out + j * W, tile.x[j]);
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
rglru_scan_tiles_kernel(const float* __restrict__ a,
                        const float* __restrict__ x,
                        const float* __restrict__ h0, float* __restrict__ h,
                        float* __restrict__ h_last, int B, int L, int W) {
  constexpr int kTile = Tile<VEC>::kTile;
  const int b = blockIdx.y * blockDim.y + threadIdx.y;
  const int w0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (b >= B || w0 >= W) return;
  const int64_t base = static_cast<int64_t>(b) * L * W + w0;
  const float* pa = a + base;
  const float* px = x + base;
  float* ph = h + base;
  const int64_t row = static_cast<int64_t>(b) * W + w0;

  Tile<VEC> t_even, t_odd;
  load_tile<VEC>(t_even, pa, px, 0, L, W);
  float s[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = 0.0f;
  if (h0 != nullptr) {
    if constexpr (VEC == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(h0 + row));
      s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
    } else {
      s[0] = __ldg(h0 + row);
    }
  }
  // ping-pong over the two register tiles: the next tile's loads go out
  // before this tile's chain
  for (int t0 = 0;;) {
    if (t0 + kTile < L) load_tile<VEC>(t_odd, pa, px, t0 + kTile, L, W);
    run_tile<VEC>(t_even, s, ph, t0, L, W);
    t0 += kTile;
    if (t0 >= L) break;
    if (t0 + kTile < L) load_tile<VEC>(t_even, pa, px, t0 + kTile, L, W);
    run_tile<VEC>(t_odd, s, ph, t0, L, W);
    t0 += kTile;
    if (t0 >= L) break;
  }
  store_step<VEC>(h_last + row, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// lanes a thread (vec: 4, with 16-byte loads, or 1), block (tx, ty) and
// grid (gx, gy) as launch_plan() gives them; h0 may be null (a zero initial
// state).
extern "C" int rgs_rglru_scan(const float* a, const float* x, const float* h0,
                              float* h, float* h_last, int B, int L, int W,
                              int vec, int tx, int ty, int gx, int gy,
                              cudaStream_t stream) {
  const bool covers = (vec == 4 || vec == 1) && B >= 1 && L >= 1 &&
                      W >= 1 && tx >= 1 && ty >= 1 &&
                      tx * ty <= kMaxThreads && gx >= 1 && gy >= 1 &&
                      gy <= kMaxGridY &&
                      static_cast<int64_t>(gx) * tx * vec >= W &&
                      static_cast<int64_t>(gx - 1) * tx * vec < W &&
                      static_cast<int64_t>(gy) * ty >= B &&
                      static_cast<int64_t>(gy - 1) * ty < B;
  const bool vec_ok = vec == 1 || (W % 4 == 0 && aligned16(a) &&
                                   aligned16(x) && aligned16(h) &&
                                   aligned16(h_last) &&
                                   (h0 == nullptr || aligned16(h0)));
  if (!covers || !vec_ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(tx, ty), grid(gx, gy);
  if (vec == 4)
    rglru_scan_tiles_kernel<4><<<grid, block, 0, stream>>>(a, x, h0, h,
                                                           h_last, B, L, W);
  else
    rglru_scan_tiles_kernel<1><<<grid, block, 0, stream>>>(a, x, h0, h,
                                                           h_last, B, L, W);
  return static_cast<int>(cudaGetLastError());
}
