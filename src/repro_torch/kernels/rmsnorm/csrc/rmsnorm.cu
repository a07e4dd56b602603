// Fused RMS norm on Hopper (sm_90a).
//
// Replaces the TPU kernel `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm/kernel.py (wrapper `rms_norm_pallas`).  For each
// row of x [N, D]:  out = x * (1 / sqrt(mean(x^2) + eps)) * (1 + scale),
// computed in f32 and written once in x's type.
//
// What bounds it: bytes.  A few FP32 operations per element against reading
// x once and writing out once: the least time is (2 * N * D * sizeof(x) +
// D * sizeof(scale)) / 3.35 TB/s.
//
// Design: a launch is one memory pass over x.  A row is cut into units, 16
// bytes of x each (8 bf16 or 4 f32; one element where D is not a multiple of
// that), and a row's threads hold up to kPer = 2 units each in registers,
// unit u on thread u % threads: neighbouring threads read neighbouring 16
// bytes.  A row is at most 1,024 threads of 2 units (16,384 bf16, 8,192 f32,
// 2,048 elements on the one-element path); more units a thread spill at
// 1,024 threads, and fewer threads would hold no wider a row.
// Every thread first issues all its loads, x's units and the matching units
// of scale (vectors too, 8 or 16 bytes), so a launch waits on one memory
// latency; then it sums its squares, the row reduces them (warp shuffles,
// then the row's warps through shared memory), and the thread scales the
// values it holds and stores them.  From device memory the kernel moves the
// bound's bytes: x once, out once; every row reads scale, which after the
// first comes from L2.
//
// The launch plan (unit, threads a row, rows a block) is
// `launch_plan` in kernel.py and depends on D and x's type only, never on N:
// a row's reduction order is the same in a [1, D], [4, D] or [3000, D] launch,
// so a batch-4 decode tick normalises a row to the same bits as a batch-1
// one (the serving engine's greedy decode must equal offline decode).  A row
// takes enough threads that each holds one or two units where it can: D 4096
// bf16 is 256 threads of 2 units, D 2560 bf16 160 threads of 2.  Narrow rows
// share a block of up to 256 threads.  Every block is one row group, so the
// prefill's [S, D] launches put S blocks on the 132 SMs, up to 8 resident on
// each (8 x 8 KB in flight an SM at D 4096 bf16).
//
// The decode tick's [4, D] launches move 65 KB at most: 20 ns of bytes.  What
// they cost is the launch and one load latency; `chip_smoke.py` times the
// same kernel at [1, 8] as often as the path launches it
// (`launch_floor_ms`), the least time any design can reach.  A cluster of
// CTAs a row, reducing through distributed shared memory, would add a
// cluster barrier to the one latency a row waits on, and was not tried: the
// tick's launches already run within half a microsecond of that floor.
//
// Rounding: the kernel rounds where the plain version (ref.py) rounds on the
// card, so that it agrees with it within 1e-6 in f32 where outputs reach 8
// and one ulp is 9.5e-7: each square is rounded before it is added (torch
// squares in one launch and sums in the next), the mean is the sum times
// 1/D rounded to f32 (torch's mean multiplies by that factor), eps is added
// on its own, and the reciprocal square root is rsqrtf, the instruction
// torch.rsqrt runs on the card (it differs from a correctly rounded
// 1 / sqrt by up to 2 ulp; `chip_smoke.py`'s rmsnorm_rsqrt phase counts how
// often).  Only the order of the sum of squares differs from the plain
// version's, so the two agree within the tolerance, not bit for bit.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxBlock = 1024;
constexpr int kPer = 2;  // units a thread holds

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int pack_align(int bytes) { return bytes < 16 ? bytes : 16; }

// N elements of T loaded and stored as one (or two) aligned vectors.
template <typename T, int N>
struct alignas(pack_align(int(sizeof(T)) * N)) Pack {
  T v[N];
};

template <typename T, typename S, int kUnit>
__global__ void __launch_bounds__(kMaxBlock)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               int64_t rows, int cols, int threads, float eps) {
  __shared__ float partial[kMaxBlock / kWarp];
  using XP = Pack<T, kUnit>;
  using SP = Pack<S, kUnit>;
  const int group = threadIdx.x / threads, tid = threadIdx.x % threads;
  const int64_t row = int64_t(blockIdx.x) * (blockDim.x / threads) + group;
  const bool live = row < rows;
  const int units = cols / kUnit;
  const XP* xr = reinterpret_cast<const XP*>(x + row * cols);
  const SP* sr = reinterpret_cast<const SP*>(scale);

  // Every load first: x's units and scale's, all independent.
  XP xv[kPer];
  SP sv[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = tid + p * threads;
    if (live && u < units) {
      xv[p] = xr[u];
      sv[p] = sr[u];
    } else {
#pragma unroll
      for (int e = 0; e < kUnit; ++e) {
        xv[p].v[e] = from_float<T>(0.f);
        sv[p].v[e] = from_float<S>(0.f);
      }
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int e = 0; e < kUnit; ++e) {
      const float f = to_float(xv[p].v[e]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threads > kWarp) {  // the same for every thread of the block
    const int warps = threads / kWarp, lane = threadIdx.x % kWarp;
    if (lane == 0) partial[threadIdx.x / kWarp] = ss;
    __syncthreads();
    ss = lane < warps ? partial[group * warps + lane] : 0.f;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (!live) return;
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / float(cols)), eps));

  XP* orow = reinterpret_cast<XP*>(out + row * cols);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = tid + p * threads;
    if (u < units) {
      XP res;
#pragma unroll
      for (int e = 0; e < kUnit; ++e)
        res.v[e] = from_float<T>((to_float(xv[p].v[e]) * inv) * (1.0f + to_float(sv[p].v[e])));
      orow[u] = res;
    }
  }
}

template <typename T, typename S, int kUnit>
int launch_unit(const void* x, const void* scale, void* out, int64_t rows, int cols,
                int threads, int rows_per_block, float eps, cudaStream_t stream) {
  if (rows_per_block * threads > kMaxBlock) return int(cudaErrorInvalidValue);
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidValue);
  rmsnorm_kernel<T, S, kUnit><<<unsigned(blocks), rows_per_block * threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), rows, cols,
      threads, eps);
  return int(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int64_t rows, int cols, int unit,
           int threads, int rows_per_block, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (unit == kVec) {
    const uintptr_t align_s = pack_align(int(sizeof(S)) * kVec);
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
        reinterpret_cast<uintptr_t>(scale) % align_s)
      return int(cudaErrorMisalignedAddress);
    return launch_unit<T, S, kVec>(x, scale, out, rows, cols, threads, rows_per_block, eps,
                                   stream);
  }
  if (unit == 1)
    return launch_unit<T, S, 1>(x, scale, out, rows, cols, threads, rows_per_block, eps, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x and out share one type).  The
// plan (unit, threads, rows_per_block) comes from kernel.launch_plan; a plan
// that does not cover the row or fit a block is refused.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out, int64_t rows,
                              int64_t cols, int x_dtype, int scale_dtype, int unit,
                              int threads, int rows_per_block, float eps,
                              cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || cols > 2147483647LL || unit <= 0 || cols % unit ||
      threads < kWarp || threads % kWarp || rows_per_block < 1 ||
      int64_t(threads) * kPer * unit < cols)
    return int(cudaErrorInvalidValue);
  const int c = int(cols);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, rows, c, unit, threads, rows_per_block, eps, stream);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, c, unit, threads, rows_per_block, eps, stream);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, c, unit, threads, rows_per_block, eps, stream);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, c, unit, threads, rows_per_block, eps, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
