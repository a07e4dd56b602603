// Mandelbrot escape time on Hopper (sm_90a).
//
// Replaces the TPU kernel `_mandelbrot_kernel` in
// src/repro/kernels/mandelbrot/kernel.py (wrapper `mandelbrot_pallas`).
//
// What bounds it: FP32 instruction issue, not bytes.  A point moves 16 bytes
// (two f32 coordinates in, two i32 results out) and then runs about seven
// FP32 instructions per live iteration (two squares, the add and compare of
// the escape test, the two fmas, the add of x0), up to max_iters of them.
//
// Design: one thread per point, a 2-D grid of 32x8 blocks over [H, W] with a
// bounds mask, so any H and W work without padding.  The TPU has no per-lane
// control flow and runs a fixed-trip loop of max_iters trips with an alive
// mask; here each thread leaves its loop when its point escapes.  The counts
// are the same, because a point that has escaped never becomes alive again.
// Early exit saves the work of dead lanes: the fixed-trip form costs
// H*W*max_iters iterations, this one the sum of the counts (plus, within a
// warp, the wait for its slowest point).
//
// Rounding: the JAX reference compiles through XLA on the CPU, which
// contracts exactly two operations into fused multiply-adds:
//   new_zx = fma(zx, zx, -zy2) + x0,   new_zy = fma(2 zx, zy, y0).
// The kernel calls __fmaf_rn for those two, and is built with -fmad=false so
// that nvcc contracts nothing else; the counts then equal the reference's
// bit for bit.  Never build it with --use_fast_math.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void mandelbrot_kernel(const float* __restrict__ x0,
                                  const float* __restrict__ y0,
                                  int32_t* __restrict__ iters,
                                  int32_t* __restrict__ colour,
                                  int64_t rows, int64_t cols, int max_iters) {
  const int64_t c = int64_t(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t r = int64_t(blockIdx.y) * kBlockY + threadIdx.y;
  if (r >= rows || c >= cols) return;
  const int64_t i = r * cols + c;
  const float cx = x0[i];
  const float cy = y0[i];
  float zx = 0.f, zy = 0.f;
  int n = 0;
  for (; n < max_iters; ++n) {
    const float zx2 = zx * zx;
    const float zy2 = zy * zy;
    if (!(zx2 + zy2 < 4.f)) break;  // NaN leaves too, as in the reference
    const float nzx = __fmaf_rn(zx, zx, -zy2) + cx;
    zy = __fmaf_rn(2.f * zx, zy, cy);
    zx = nzx;
  }
  iters[i] = n;
  colour[i] = n < max_iters ? 1 : 0;
}

}  // namespace

extern "C" int mandelbrot_launch(const float* x0, const float* y0,
                                 int32_t* iters, int32_t* colour,
                                 int64_t rows, int64_t cols, int max_iters,
                                 cudaStream_t stream) {
  const int64_t gx = (cols + kBlockX - 1) / kBlockX;
  const int64_t gy = (rows + kBlockY - 1) / kBlockY;
  if (gx > 2147483647LL || gy > 65535LL) return int(cudaErrorInvalidConfiguration);
  mandelbrot_kernel<<<dim3(unsigned(gx), unsigned(gy)), dim3(kBlockX, kBlockY), 0,
                      stream>>>(x0, y0, iters, colour, rows, cols, max_iters);
  return int(cudaGetLastError());
}

extern "C" const char* mandelbrot_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
