// Mandelbrot escape time on Hopper (sm_90a).
//
// Replaces the TPU kernel `_mandelbrot_kernel` in
// src/repro/kernels/mandelbrot/kernel.py (wrapper `mandelbrot_pallas`).
//
// What bounds it: FP32 instruction issue and dependent latency, not bytes.
// A point moves 16 bytes (two f32 coordinates in, two i32 results out) and
// then runs about eight FP32 instructions per live trip (two squares, the
// escape test's add and compare, 2*zx, the two fmas, the add of x0), up to
// max_iters trips.  There is no matrix product and nothing to stage, so TMA,
// wgmma and shared-memory tiling have nothing to offer here and are not used.
//
// Two entries share one escape-count device function:
//
// * mandelbrot_launch: [H, W] coordinates in, iterations and colour out.
//   A flat 1-D launch over the H*W points, kBlock consecutive points a
//   block, so a [1, W] launch has no dead warps.
// * mandelbrot_line_launch: one work item of the paper's job.  Each thread
//   builds its own x (the float32 product-then-sum of `line_coords`), counts
//   its point, and the launch sums the line's (white, total_iters) into an
//   int64 [2] output: a warp reduction, then one 64-bit atomicAdd per block
//   and output.  Integer sums are exact in any order.
//
// Latency.  The paper's job launches one line of 5,600 points at a time:
// 175 warps on 132 SMs x 4 schedulers, about one warp per scheduler, so
// nothing hides latency and a line waits on its slowest point.  A loop that
// branches on the escape test in every trip serialises the test (zx^2 ->
// add -> compare -> branch) behind the update chain (zy^2 -> fma -> +x0).
// Here a thread runs its trips in chunks of kChunk without a branch: each
// trip ORs its escape test into a flag beside the update chain.  After a
// chunk in which no trip escaped, n += kChunk; after one in which a trip
// did, the thread restores the z saved at the chunk's start and redoes at
// most kChunk trips one at a time with the plain loop, which also runs the
// tail (fewer than kChunk trips left).  Trips after an escape may overflow
// to inf or NaN; the rollback discards them.  Every point runs exactly the
// reference's trips: no cardioid, bulb or periodicity shortcut.
//
// Rounding: the JAX reference compiles through XLA on the CPU, which
// contracts exactly two operations into fused multiply-adds:
//   new_zx = fma(zx, zx, -zy2) + x0,   new_zy = fma(2 zx, zy, y0).
// The kernel calls __fmaf_rn for those two, and is built with -fmad=false so
// that nvcc contracts nothing else; both loops do the same arithmetic per
// trip, so the counts equal the reference's bit for bit for any kChunk and
// any max_iters.  Never build it with --use_fast_math.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Both chosen by timing copies of this source on the H100 (PERF.md): kChunk
// 16 runs the paper's 3,200 lines faster than 8, and kBlock 128 (one line's
// 175 warps one per scheduler on 44 SMs) runs them as fast as 32 or 64 and
// the full grid faster.
constexpr int kChunk = 16;   // trips between escape branches
constexpr int kBlock = 128;  // threads (points) a block

// One trip of the reference's loop: z <- z^2 + c.  Returns the escape test
// on the z it started from (true: |z|^2 >= 4 or NaN, the trip did not count).
__device__ __forceinline__ bool trip(float& zx, float& zy, float cx, float cy) {
  const float zx2 = zx * zx;
  const float zy2 = zy * zy;
  const bool out = !(zx2 + zy2 < 4.f);  // NaN is out too, as in the reference
  const float nzx = __fmaf_rn(zx, zx, -zy2) + cx;
  zy = __fmaf_rn(2.f * zx, zy, cy);
  zx = nzx;
  return out;
}

__device__ __forceinline__ int escape_count(float cx, float cy, int max_iters) {
  float zx = 0.f, zy = 0.f;
  int n = 0;
  while (max_iters - n >= kChunk) {
    const float sx = zx, sy = zy;
    bool out = false;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) out |= trip(zx, zy, cx, cy);
    if (out) {  // a trip of this chunk escaped: redo it one trip at a time
      zx = sx;
      zy = sy;
      break;
    }
    n += kChunk;
  }
  for (; n < max_iters; ++n) {
    if (trip(zx, zy, cx, cy)) break;
  }
  return n;
}

__global__ void __launch_bounds__(kBlock)
mandelbrot_kernel(const float* __restrict__ x0, const float* __restrict__ y0,
                  int32_t* __restrict__ iters, int32_t* __restrict__ colour,
                  int64_t points, int max_iters) {
  const int64_t i = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= points) return;
  const int n = escape_count(x0[i], y0[i], max_iters);
  iters[i] = n;
  colour[i] = n < max_iters ? 1 : 0;
}

__global__ void __launch_bounds__(kBlock)
mandelbrot_line_kernel(int width, float y, float min_x, float delta,
                       int max_iters, unsigned long long* __restrict__ out) {
  constexpr int kWarps = kBlock / 32;
  __shared__ unsigned long long partial[kWarps][2];
  const int64_t i = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  unsigned white = 0, lo = 0, hi = 0;
  if (i < width) {
    const float x = __fadd_rn(min_x, __fmul_rn(float(i), delta));
    const int n = escape_count(x, y, max_iters);
    white = n < max_iters ? 1u : 0u;
    // A warp's 32 counts may pass 2^32; its 32 low and 32 high halves
    // sum exactly in 32 bits.
    lo = unsigned(n) & 0xffffu;
    hi = unsigned(n) >> 16;
  }
  white = __reduce_add_sync(0xffffffffu, white);
  lo = __reduce_add_sync(0xffffffffu, lo);
  hi = __reduce_add_sync(0xffffffffu, hi);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    partial[warp][0] = white;
    partial[warp][1] = (static_cast<unsigned long long>(hi) << 16) + lo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long w = 0, t = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      w += partial[k][0];
      t += partial[k][1];
    }
    atomicAdd(out, w);
    atomicAdd(out + 1, t);
  }
}

}  // namespace

extern "C" int mandelbrot_launch(const float* x0, const float* y0,
                                 int32_t* iters, int32_t* colour,
                                 int64_t rows, int64_t cols, int max_iters,
                                 cudaStream_t stream) {
  const int64_t points = rows * cols;
  const int64_t blocks = (points + kBlock - 1) / kBlock;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  mandelbrot_kernel<<<unsigned(blocks), kBlock, 0, stream>>>(
      x0, y0, iters, colour, points, max_iters);
  return int(cudaGetLastError());
}

// out: int64 [2], zeroed by the caller; receives (white, total_iters).
extern "C" int mandelbrot_line_launch(int width, float y, float min_x,
                                      float delta, int max_iters, int64_t* out,
                                      cudaStream_t stream) {
  const int64_t blocks = (int64_t(width) + kBlock - 1) / kBlock;
  mandelbrot_line_kernel<<<unsigned(blocks), kBlock, 0, stream>>>(
      width, y, min_x, delta, max_iters,
      reinterpret_cast<unsigned long long*>(out));
  return int(cudaGetLastError());
}

extern "C" int mandelbrot_chunk() { return kChunk; }

extern "C" const char* mandelbrot_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
