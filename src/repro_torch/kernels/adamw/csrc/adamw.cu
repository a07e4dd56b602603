// AdamW's update of one leaf on Hopper (sm_90a), in one memory pass.
//
// Replaces no TPU kernel: the JAX package leaves the update to XLA, which
// fuses it.  The port's plain version, `adamw_update_reference` in ref.py
// (the per-leaf loop of optim/adamw.py before this kernel), makes about 17
// elementwise launches a leaf, each a full f32 pass: about 160 bytes a
// parameter, where the update needs 28 (f32 p, g, m and v read, p, m and v
// written).
//
// What bounds it: bytes.  Some twenty FP32 operations (two divisions and a
// square root among them) per element against 28 bytes: the least time is
// the leaf's bytes over 3.35 TB/s.
//
// Design: one launch a leaf, a grid-stride loop over vectors of kVec = 8
// elements, sized to the SMs the card has times the blocks of kBlock
// threads that fit on one.  A vector is 16 bytes of each bf16 array and two
// 16-byte loads of each f32 array, so every load and store is 128 bits wide
// where the four arrays start on 16-byte boundaries; a thread issues all
// its loads of a vector (p, g, m, v) before it computes.  The elements past
// the last whole vector, or every element where a pointer is off a 16-byte
// boundary, take a scalar loop with the same arithmetic.  Every
// intermediate stays in a register.  The four step scalars (the clipping
// scale, the two bias corrections and the learning rate) are 0-d f32
// tensors on the device, read through pointers: the step never waits for
// the host.
//
// Rounding: bit for bit the plain version on the card.  Its launches round
// after every operation, in this order, and so does the kernel:
//   gs = g * scale
//   m1 = m * b1 + gs * (1 - b1)
//   v1 = v * b2 + (gs * (1 - b2)) * gs
//   u  = (m1 / b1c) / (sqrt(v1 / b2c) + eps)
//   u  = (u + wd * p) * lr
//   p  = p - u
// with each Python constant (b1, 1 - b1, b2, 1 - b2, eps, wd) rounded once
// to f32 on the host, as PyTorch rounds a Python scalar; divisions and the
// square root correctly rounded (PyTorch's CUDA division by a tensor and its
// sqrtf are); the moments and a bf16 p rounded to nearest even when stored,
// as `copy_` rounds.  The kernel spells every operation as an intrinsic and
// is built with -fmad=false, so nvcc contracts nothing into an FMA.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // threads a block
constexpr int kVec = 8;      // elements a vector

struct Consts {
  float b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2, each rounded once
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kVec elements from 16-byte aligned `src`, as f32.
__device__ __forceinline__ void load_vec(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// One element's update, in the plain version's order (see the head note).
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float scale,
                                       float b1c, float b2c, float lr, const Consts& c) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(gs, c.c1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(gs, c.c2), gs));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), c.eps);
  const float u = __fdiv_rn(__fdiv_rn(m, b1c), den);
  p = __fsub_rn(p, __fmul_rn(__fadd_rn(u, __fmul_rn(c.wd, p)), lr));
}

// p and g in P, m and v in S.  Vectors [0, vectors) first, then the
// elements [vectors * kVec, n) one at a time.
template <typename P, typename S>
__global__ void __launch_bounds__(kBlock)
adamw_kernel(P* __restrict__ p, const P* __restrict__ g, S* __restrict__ m,
             S* __restrict__ v, const float* __restrict__ scale_p,
             const float* __restrict__ b1c_p, const float* __restrict__ b2c_p,
             const float* __restrict__ lr_p, int64_t n, int64_t vectors, Consts c) {
  const float scale = *scale_p, b1c = *b1c_p, b2c = *b2c_p, lr = *lr_p;
  const int64_t stride = int64_t(gridDim.x) * kBlock;
  const int64_t first = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  for (int64_t i = first; i < vectors; i += stride) {
    const int64_t at = i * kVec;
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    load_vec(p + at, pv);
    load_vec(g + at, gv);
    load_vec(m + at, mv);
    load_vec(v + at, vv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) update(pv[k], gv[k], mv[k], vv[k], scale, b1c, b2c, lr, c);
    store_vec(p + at, pv);
    store_vec(m + at, mv);
    store_vec(v + at, vv);
  }
  for (int64_t j = vectors * kVec + first; j < n; j += stride) {
    float pj = to_float(p[j]), mj = to_float(m[j]), vj = to_float(v[j]);
    update(pj, to_float(g[j]), mj, vj, scale, b1c, b2c, lr, c);
    p[j] = from_float<P>(pj);
    m[j] = from_float<S>(mj);
    v[j] = from_float<S>(vj);
  }
}

template <typename P, typename S>
int launch(void* p, const void* g, void* m, void* v, const float* scale, const float* b1c,
           const float* b2c, const float* lr, int64_t n, const Consts& c,
           cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) %
                        16) == 0;
  const int64_t vectors = aligned ? n / kVec : 0;
  const int64_t items = vectors + (n - vectors * kVec);  // a thread's share at most
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_kernel<P, S>, kBlock, 0);
  if (err != cudaSuccess) return int(err);
  const int64_t wanted = (items + kBlock - 1) / kBlock;
  const int64_t resident = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = wanted < resident ? wanted : resident;
  adamw_kernel<P, S><<<unsigned(blocks), kBlock, 0, stream>>>(
      static_cast<P*>(p), static_cast<const P*>(g), static_cast<S*>(m), static_cast<S*>(v),
      scale, b1c, b2c, lr, n, vectors, c);
  return int(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; p and g share param_dtype, m and v
// state_dtype.  scale, b1c, b2c and lr point at f32 scalars on the device.
// p, m and v are updated in place; n elements each, contiguous.
extern "C" int adamw_launch(void* p, const void* g, void* m, void* v, const float* scale,
                            const float* b1c, const float* b2c, const float* lr, int64_t n,
                            int param_dtype, int state_dtype, float b1, float c1, float b2,
                            float c2, float eps, float wd, cudaStream_t stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const Consts c{b1, c1, b2, c2, eps, wd};
  if (param_dtype == 0 && state_dtype == 0)
    return launch<float, float>(p, g, m, v, scale, b1c, b2c, lr, n, c, stream);
  if (param_dtype == 0 && state_dtype == 1)
    return launch<float, __nv_bfloat16>(p, g, m, v, scale, b1c, b2c, lr, n, c, stream);
  if (param_dtype == 1 && state_dtype == 0)
    return launch<__nv_bfloat16, float>(p, g, m, v, scale, b1c, b2c, lr, n, c, stream);
  if (param_dtype == 1 && state_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, scale, b1c, b2c, lr, n, c, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
