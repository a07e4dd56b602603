// Flash attention (forward) on Hopper (sm_90a): two variants in one file.
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py (wrapper
// `flash_attention_pallas`, GQA expansion in `ops.flash_attention`).  Both
// variants compute softmax(q k^T / sqrt(D) + mask) v with f32 accumulation
// and an online softmax, so no [Sq, Skv] tensor ever exists.  The mask is
// causal (key <= query) and/or a sliding window (key > query - window),
// counted from position 0 for both q and k, and always k < Skv.  GQA: query
// head h reads KV head h / (H / KV), which is the head jnp.repeat gives it;
// K and V are never repeated.  The wrapper picks the variant from the dtype.
//
// What bounds it: operations.  Causal attention does 4 * D FLOPs for every
// visible (query, key) pair and moves only Q, K, V and O, so at the serving
// shapes (D = 128 or 256, hundreds of keys per query) it lies far above the
// card's ratio of operations to bytes.  The least time is 4 * B * H * D *
// (visible pairs) at the bf16 tensor-core rate of 989 TFLOP/s.
//
// bfloat16 (both serving paths): `flash_kernel_wgmma`, tensor cores fed by
// TMA.  A block of one (head, batch) has NC consumer warpgroups of 64 query
// rows each and one producer warpgroup; NC is 2 (128 rows share each K/V
// tile) unless the launch has too few 64-row tiles to fill the SMs or
// D = 256, where it is 1 (see `launch_wgmma`).  In the producer, one thread
// loads the block's Q tile once and then keeps a ring of K and V tiles in
// flight with cp.async.bulk.tensor, as many stages as shared memory holds
// (up to 4), each K and each V tile signalled through its own mbarrier
// ("full") and released through another ("empty").  With NC = 2,
// `setmaxnreg` moves registers from the producer to the consumers.  A
// consumer warpgroup, per key tile i:
//   S_i = Q K_i^T   wgmma m64nBNk16, Q and K both K-major in shared memory,
//   issued together with O += P_{i-1} V_{i-1} (wgmma m64nDk16, P from
//   registers, V the MN-major B operand through the descriptor's transpose
//   bit, so V needs no transposed copy);
//   as soon as S_i is in, K_i is released and the softmax of S_i runs
//   (mask only on a tile that the diagonal, the window's edge or the end of
//   Skv cuts; exp2 with log2(e) folded into the scale) while P_{i-1} V_{i-1}
//   finishes; then V_{i-1} is released and P_i is packed from the f32 S
//   accumulator into bf16x2 A fragments in place (the two layouts agree
//   element for element), without going through shared memory.
// Keys per tile BN = 64 for D >= 128 (O is D / 2 f32 registers a thread,
// S BN / 2 and P BN / 4, and the compiler keeps descriptors out of
// registers), else 128.  The tensor maps are 4-D (D, S, heads, B) with the
// caller's strides, so the model's [B, S, H, D] tensors are read in place
// and a ragged tile is zero-filled by the TMA unit without reading the next
// head's rows.  Tiles use the swizzle that matches one box row (128 bytes:
// D >= 64 is loaded as D / 64 boxes of 64 columns; 64 or 32 bytes for
// D = 32 or 16), and the wgmma descriptors read that layout.  A block
// visits only the K/V tiles its rows can see, from the window's first to
// the diagonal's last; a consumer passes on, uncomputed, the tiles that
// none of its own 64 rows can see.  Query tiles launch heaviest first
// (reversed, for the causal triangle), and the heads that share one KV head
// are neighbours in the grid, so their K/V tiles meet in L2.  The output is
// written from registers, two bf16 a store.

// float32 (checks, greedy-equality runs): `flash_kernel_f32`, on the CUDA
// cores, exact enough for a 2e-6 tolerance (TF32 tensor cores are not).
// One block of 128 threads per (query tile, head, batch); a query tile of
// BQ rows (64, or 32 when D = 256) stays in shared memory; the block walks
// 64-key tiles of K and V through shared memory over the same visible
// range.  Each thread owns RQ query rows and 8 keys (key = lane % 8 + 8 j)
// of the score tile and takes each row's max and sum by shuffles within
// its group of 8 lanes; for P V it fetches the probabilities it needs from
// its group's lanes.  Rows of Q and K in shared memory are padded by 4
// floats, so the 16-byte reads of a quarter-warp fall in distinct banks.
//
// Scale: each score is q.k * (1/sqrt(D)), after the product, as the plain
// version computes it (PyTorch divides by a scalar as a product with its
// reciprocal); the TPU kernel scales q before the product instead, which
// rounds differently.  Scaling q first gave f32 errors up to 1.85e-6
// against the plain version at yi-9b's shapes on an H100, close to the
// 2e-6 tolerance.
//
// Masking: masked scores are -inf.  A row whose visible keys are all masked
// (possible only with a window and no causal mask) keeps a denominator of 0
// and is written as 0, guarded by max(l, 1e-30) as in the TPU kernel.
// Query rows past Sq are computed on zeros and not written; keys past Skv
// are loaded as zeros and masked.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or, for a tensor map that libcuda refuses, the
// negated CUresult).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

struct Strides {
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // 16 groups of 8 lanes
constexpr int kBK = 64;        // keys per tile: 8 per lane

template <int D>
struct Shape {
  static constexpr int kRQ = D >= 256 ? 2 : 4;     // query rows per thread
  static constexpr int kBQ = 16 * kRQ;             // query rows per block
  static constexpr int kDP = D + 4;                // padded row of Q and K
  static constexpr int kVec = D >= 32 ? 4 : D / 8; // output columns per chunk
  static constexpr int kChunks = D / (8 * kVec);   // chunks per thread
  static constexpr size_t kSmemBytes =
      sizeof(float) * (size_t(kBQ) * kDP + size_t(kBK) * kDP + size_t(kBK) * D);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int KV,
                 int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int64_t window, float sm_scale) {
  using Sh = Shape<D>;
  constexpr int RQ = Sh::kRQ, BQ = Sh::kBQ, DP = Sh::kDP, VEC = Sh::kVec, NC = Sh::kChunks;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + kBK * DP;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 7;   // key / column slot within the group of 8 lanes
  const int ty = tid >> 3;  // row group
  const int group_base = lane & ~7;
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int64_t q0 = int64_t(blockIdx.x) * BQ;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int64_t qg = q0 + r;
    Qs[r * DP + d] = qg < Sq ? qb[qg * qs.s + d] : 0.f;
  }

  // Keys this tile's rows can see: [k_lo, k_hi).
  const int64_t q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int64_t k_hi = causal ? (q_last + 1 < Skv ? q_last + 1 : Skv) : Skv;
  int64_t k_lo = window > 0 ? q0 - window + 1 : 0;
  if (k_lo < 0) k_lo = 0;

  float m[RQ], l[RQ], acc[RQ][NC][VEC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][c][e] = 0.f;
  }

  for (int64_t k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and Q is in)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int64_t kg = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kg < Skv) {
        kv = kb[kg * ks.s + d];
        vv = vb[kg * vs.s + d];
      }
      Ks[c * DP + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[RQ][8];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * RQ + i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * DP + d]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          s[i][j] += qv[i].x * kk.x;
          s[i][j] += qv[i].y * kk.y;
          s[i][j] += qv[i].z * kk.z;
          s[i][j] += qv[i].w * kk.w;
        }
      }
    }

    // Mask, then the online softmax update of each row.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int64_t qg = q0 + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t kg = k0 + tx + 8 * j;
        const bool ok = kg < Skv && (!causal || kg <= qg) && (window <= 0 || kg > qg - window);
        s[i][j] = ok ? s[i][j] * sm_scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][c][e] *= alpha;
    }

    // acc += P V: key c's probability for row i lives in lane c % 8 of the
    // group, register j = c / 8.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int src = 0; src < 8; ++src) {
        const int c = src + 8 * j;
        float p[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) p[i] = __shfl_sync(0xffffffffu, s[i][j], group_base | src);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float* vrow = &Vs[c * D + cc * 8 * VEC + tx * VEC];
          float vv[VEC];
          if constexpr (VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) vv[e] = vrow[e];
          }
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][cc][e] += p[i] * vv[e];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int64_t qg = q0 + ty * RQ + i;
    if (qg >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + qg * os.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < VEC; ++e) orow[cc * 8 * VEC + tx * VEC + e] = acc[i][cc][e] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
               int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs, Strides os,
               int causal, int64_t window, float sm_scale, cudaStream_t stream) {
  using Sh = Shape<D>;
  const int64_t tiles = (Sq + Sh::kBQ - 1) / Sh::kBQ;
  if (tiles > 2147483647LL || H > 65535 || B > 65535) return int(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(Sh::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  flash_kernel_f32<D><<<dim3(unsigned(tiles), unsigned(H), unsigned(B)), kThreads,
                        Sh::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup
// With two consumer warpgroups, setmaxnreg gives the producer's registers
// to them, within the 65,536 of an SM (2 x 128 x 232 + 128 x 40).  With
// one, each thread may hold 255 registers from the start.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// NC consumer warpgroups of 64 query rows each, and one producer.
template <int D, int NC>
struct WShape {
  static constexpr int kBM = 64 * NC;                  // query rows per block
  static constexpr int kThreads = kWgThreads * (NC + 1);
  static constexpr int kBN = D >= 128 ? 64 : 128;      // keys per tile
  static constexpr int kBoxW = D < 64 ? D : 64;        // columns per TMA box
  static constexpr int kRowBytes = 2 * kBoxW;          // one box row = the swizzle span
  static constexpr int kBoxes = D / kBoxW;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;       // one K or V tile
  // K/V ring depth: as many stages as shared memory holds, up to 4.
  static constexpr int kFit = (kSmemLimit - 2048 - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // wgmma descriptor layout type of the swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B.
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + size_t(2 * kStages) * kTileBytes + 8 * (1 + 4 * kStages);
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit, "tiles do not fit");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts kWaitTrapNs traps, so a broken ring fails the launch instead of
// hanging the card.
constexpr uint64_t kWaitTrapNs = 10000000000ull;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - start > kWaitTrapNs) __trap();
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle's layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(layout) << 62);
}

// The value itself, made opaque to the compiler, so that descriptors are
// rebuilt where they are used instead of being hoisted out of the loop into
// registers that the accumulators need.
__device__ __forceinline__ uint64_t opaque(uint64_t v) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(v));
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warp are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_u32(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], f32 += bf16 x bf16.  wgmma_ss: A and B
// from shared memory, both K-major; d is overwritten when scale_d is 0.
// wgmma_rs: A from registers (four bf16x2 fragments a thread), B MN-major.
template <int N>
__device__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <> __device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Masks a score tile (only where the diagonal, the window's edge or Skv cut
// it), then takes the online-softmax step of the thread's two rows, each
// spread over a quad of lanes: updates m and the lane's partial row sum l,
// sets the factor alpha for the rows of O, and leaves the probabilities
// (f32) in place of the scores.
template <int BN>
__device__ __forceinline__ void softmax_step(float* sc, float* m, float* l, float* alpha,
                                             bool mask, int k0, int r0, int lane, int Skv,
                                             int causal, int window, float scale_log2) {
  if (mask) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int key = k0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
      const int row = r0 + 8 * ((e / 2) % 2);
      const bool ok = key < Skv && (!causal || key <= row) && (window <= 0 || key > row - window);
      if (!ok) sc[e] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    mu[r] = m_new == -INFINITY ? 0.f : m_new * scale_log2;  // no -inf - -inf
    alpha[r] = exp2f(m[r] * scale_log2 - mu[r]);
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    sc[e] = exp2f(fmaf(sc[e], scale_log2, -mu[(e / 2) % 2]));
    rs[(e / 2) % 2] += sc[e];
  }
  // Row sums stay partial per lane until the end: the quad shares m.
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// P as the A fragments of P V: for keys 16 kk .. 16 kk + 15, elements
// 8 kk .. 8 kk + 7 of the S accumulator, in order, as bf16 pairs.
template <int BN>
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pa) {
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) pa[e / 2] = pack_bf16x2(sc[e], sc[e + 1]);
}

// O's rows times their softmax factors.
template <int D>
__device__ __forceinline__ void rescale(float* acc, const float* alpha) {
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e / 2) % 2];
}

// The keys [lo, hi) that query rows [row_lo, row_lo + 64) can see; none
// (lo >= hi) when the rows start past Sq.
__device__ __forceinline__ void visible_keys(int row_lo, int Sq, int Skv, int causal, int window,
                                             int& lo, int& hi) {
  const int row_hi = min(row_lo + 64, Sq) - 1;
  hi = row_lo >= Sq ? 0 : causal ? min(row_hi + 1, Skv) : Skv;
  lo = window > 0 ? max(row_lo - window + 1, 0) : 0;
}

// One arrival per consumer warp on a stage's "empty" barrier.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int D, int NC>
__global__ void __launch_bounds__(WShape<D, NC>::kThreads, 1)
flash_kernel_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H,
                   int KV, int Sq, int Skv, Strides os, int causal, int window,
                   float scale_log2) {
  using Sh = WShape<D, NC>;
  constexpr int BN = Sh::kBN, RB = Sh::kRowBytes, NS = Sh::kStages, BM = Sh::kBM;
  extern __shared__ __align__(1024) uint8_t smem_tiles[];
  // Swizzled tiles must start on 1024 bytes.
  const uint32_t sQ = (smem_u32(smem_tiles) + 1023) & ~1023u;
  const uint32_t sK = sQ + Sh::kQBytes;  // stage s at sK + s * kTileBytes
  const uint32_t sV = sK + NS * Sh::kTileBytes;
  // Barriers, 8 bytes each: q_full, then NS each of k_full, v_full,
  // k_empty and v_empty.
  const uint32_t q_full = sV + NS * Sh::kTileBytes;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * NS;
  const uint32_t k_empty = v_full + 8 * NS, v_empty = k_empty + 8 * NS;

  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (H / KV);
  // Each consumer warpgroup owns a tile of 64 query rows: block y takes
  // the tiles from row y BM on, the heaviest blocks first.
  const int rows0 = int(gridDim.y - 1 - blockIdx.y) * BM;

  // Keys the block's rows can see, [k_lo, k_hi), walked in tiles of BN: from
  // the first row's window to the last row's diagonal.
  int k_lo, k_hi, lo_last, hi_last;
  visible_keys(rows0, Sq, Skv, causal, window, k_lo, k_hi);
  visible_keys(min(rows0 + BM - 64, Sq - 1), Sq, Skv, causal, window, lo_last, hi_last);
  if (lo_last < hi_last) k_hi = max(k_hi, hi_last);
  const int t_begin = k_lo / BN;
  const int n_tiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, NC * 4);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * s, NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup's index, broadcast from lane 0 so that the compiler sees
  // it is uniform across the warp (the role branch holds setmaxnreg).
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / kWgThreads, 0);
  if (wg == NC) {
    // Producer: one thread issues every copy, K then V of each tile.
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x % kWgThreads == 0) {
      mbar_expect_tx(q_full, Sh::kQBytes);
      for (int x = 0; x < Sh::kBoxes; ++x)
        tma_load(sQ + x * BM * RB, &tq, q_full, x * Sh::kBoxW, rows0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        const uint32_t parity = ((i / NS) & 1) ^ 1;  // the first round passes
        const int k0 = (t_begin + i) * BN;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, Sh::kTileBytes);
        for (int x = 0; x < Sh::kBoxes; ++x)
          tma_load(sK + s * Sh::kTileBytes + x * BN * RB, &tk, k_full + 8 * s, x * Sh::kBoxW,
                   k0, kvh, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, Sh::kTileBytes);
        for (int x = 0; x < Sh::kBoxes; ++x)
          tma_load(sV + s * Sh::kTileBytes + x * BN * RB, &tv, v_full + 8 * s, x * Sh::kBoxW,
                   k0, kvh, b);
      }
    }
  } else {
    // Consumer: 64 query rows.  A thread holds rows r0 and r0 + 8 of its
    // warp's 16, and in each 8-column group of S and O the columns
    // 2 (lane % 4) and 2 (lane % 4) + 1 (the wgmma accumulator layout).
    if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % kWgThreads;
    const int lane = tid % 32;
    const int row_lo = min(rows0 + wg * 64, Sq);  // Sq: the warpgroup has no rows
    const int r0 = row_lo + (tid / 32) * 16 + lane / 4;
    const int row_hi = min(row_lo + 64, Sq) - 1;
    // The tiles [a0, a1) that this warpgroup's rows can see; it passes the
    // others on without computing.
    int wk_lo, wk_hi, a0 = 0, a1 = 0;
    visible_keys(row_lo, Sq, Skv, causal, window, wk_lo, wk_hi);
    if (wk_lo < wk_hi) {
      a0 = wk_lo / BN - t_begin;
      a1 = max(min((wk_hi + BN - 1) / BN - t_begin, n_tiles), a0);
    }
    const uint32_t qa = sQ + wg * 64 * RB;  // this warpgroup's rows in each Q box

    auto stage = [](int i) { return 8 * uint32_t(i % NS); };
    auto parity = [](int i) { return uint32_t(i / NS) & 1; };
    auto pass = [&](int i) {
      mbar_wait(k_full + stage(i), parity(i));
      mbar_wait(v_full + stage(i), parity(i));
      release(k_empty + stage(i), lane);
      release(v_empty + stage(i), lane);
    };
    // S = Q K^T over D in steps of 16, issued (not waited for).  A step
    // moves a descriptor by whole 16-byte units, so it adds to the start
    // address field.
    auto issue_s = [&](float* sc, int i) {
      const uint64_t dq = opaque(make_desc(qa, 16, 8 * RB, Sh::kLayout));
      const uint64_t dk =
          opaque(make_desc(sK + (i % NS) * Sh::kTileBytes, 16, 8 * RB, Sh::kLayout));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 16 / Sh::kBoxW, col = kk * 16 % Sh::kBoxW;
        wgmma_ss<BN>(sc, dq + ((box * BM * RB + 2 * col) >> 4),
                     dk + ((box * BN * RB + 2 * col) >> 4), 0 < kk);
      }
      wgmma_commit();
    };
    // O += P V over the tile's keys in steps of 16, issued.
    auto issue_pv = [&](float* acc, const uint32_t* pa, int i) {
      const uint64_t dv =
          opaque(make_desc(sV + (i % NS) * Sh::kTileBytes, BN * RB, 8 * RB, Sh::kLayout));
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D>(acc, &pa[4 * kk], dv + ((kk * 16 * RB) >> 4));
      wgmma_commit();
    };
    auto needs_mask = [&](int i) {
      const int k0 = (t_begin + i) * BN;
      return k0 + BN > Skv || (causal && k0 + BN - 1 > row_lo) ||
             (window > 0 && k0 <= row_hi - window);
    };

    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < a0; ++i) pass(i);
    if (a0 < a1) {
      float sc[BN / 2];    // S of the tile, then its probabilities
      uint32_t pa[BN / 4];  // the probabilities as the A fragments of P V
      mbar_wait(k_full + stage(a0), parity(a0));
      wgmma_fence();
      issue_s(sc, a0);
      wgmma_wait<0>();
      fence_regs<BN / 2>(sc);
      release(k_empty + stage(a0), lane);
      softmax_step<BN>(sc, m, l, alpha, needs_mask(a0), (t_begin + a0) * BN, r0, lane, Skv,
                       causal, window, scale_log2);
      pack_p<BN>(sc, pa);
      // Tile i's scores are computed on the tensor cores beside tile i - 1's
      // P V, and its softmax runs while that P V finishes.
      for (int i = a0 + 1; i < a1; ++i) {
        mbar_wait(k_full + stage(i), parity(i));
        mbar_wait(v_full + stage(i - 1), parity(i - 1));
        rescale<D>(acc, alpha);
        fence_regs<BN / 2>(sc);
        fence_regs<D / 2>(acc);
        fence_u32<BN / 4>(pa);
        wgmma_fence();
        issue_s(sc, i);
        issue_pv(acc, pa, i - 1);
        wgmma_wait<1>();  // S of tile i is in
        fence_regs<BN / 2>(sc);
        release(k_empty + stage(i), lane);
        softmax_step<BN>(sc, m, l, alpha, needs_mask(i), (t_begin + i) * BN, r0, lane, Skv,
                         causal, window, scale_log2);
        wgmma_wait<0>();  // P V of tile i - 1 is in
        fence_regs<D / 2>(acc);
        fence_u32<BN / 4>(pa);
        release(v_empty + stage(i - 1), lane);
        pack_p<BN>(sc, pa);
      }
      mbar_wait(v_full + stage(a1 - 1), parity(a1 - 1));
      rescale<D>(acc, alpha);
      fence_regs<D / 2>(acc);
      fence_u32<BN / 4>(pa);
      wgmma_fence();
      issue_pv(acc, pa, a1 - 1);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      fence_u32<BN / 4>(pa);
      release(v_empty + stage(a1 - 1), lane);
    }
    for (int i = a1; i < n_tiles; ++i) pass(i);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * os.s + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the libcuda the process has loaded (PyTorch
// has), so the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 4-D map (D, S, heads, B) of a bf16 tensor with element strides `st`,
// read in boxes of box_w columns by box_rows rows.  Returns 0 or -CUresult.
int encode_map(CUtensorMap* map, const void* ptr, int D, int64_t S, int heads, int B, Strides st,
               int box_w, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -int(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st.s) * 2, cuuint64_t(st.h) * 2, cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {cuuint32_t(box_w), cuuint32_t(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -int(res);
}

using Launch = int (*)(const void*, const void*, const void*, void*, int, int, int, int64_t,
                       int64_t, Strides, Strides, Strides, Strides, int, int64_t, float,
                       cudaStream_t);

template <int D, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
              int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs, Strides os,
              int causal, int64_t window, float sm_scale, cudaStream_t stream) {
  using Sh = WShape<D, NC>;
  const int64_t tiles = (Sq + Sh::kBM - 1) / Sh::kBM;
  if (tiles > 65535 || B > 65535 || Skv > 2147483647LL || window > 2147483647LL)
    return int(cudaErrorInvalidConfiguration);
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, D, Sq, H, B, qs, Sh::kBoxW, Sh::kBM);
  if (err == 0) err = encode_map(&tk, k, D, Skv, KV, B, ks, Sh::kBoxW, Sh::kBN);
  if (err == 0) err = encode_map(&tv, v, D, Skv, KV, B, vs, Sh::kBoxW, Sh::kBN);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(flash_kernel_wgmma<D, NC>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          int(Sh::kSmemBytes));
  if (cerr != cudaSuccess) return int(cerr);
  flash_kernel_wgmma<D, NC><<<dim3(unsigned(H), unsigned(tiles), unsigned(B)), Sh::kThreads,
                              Sh::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, KV, int(Sq), int(Skv), os, causal,
      int(window), sm_scale * kLog2e);
  return int(cudaGetLastError());
}

// Two consumer warpgroups share each K/V tile between 128 query rows.  One
// gives a block a whole SM for 64 rows: it keeps head_dim 256 (O alone is
// 128 registers a thread) from spilling, and it fills more SMs where a
// launch has too few tiles of 128 rows to go round.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                 int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int64_t window, float sm_scale, cudaStream_t stream) {
  Launch fn = launch_nc<D, 1>;
  if constexpr (D < 256) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return int(err);
    if (int64_t(B) * H * ((Sq + 63) / 64) > sms) fn = launch_nc<D, 2>;
  }
  return fn(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale, stream);
}

int run(Launch fn16, Launch fn32, Launch fn64, Launch fn128, Launch fn256, int D, const void* q,
        const void* k, const void* v, void* o, int B, int H, int KV, int64_t Sq, int64_t Skv,
        Strides qs, Strides ks, Strides vs, Strides os, int causal, int64_t window,
        float sm_scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0)
    return int(cudaErrorInvalidValue);
  Launch fn = D == 16 ? fn16 : D == 32 ? fn32 : D == 64 ? fn64 : D == 128 ? fn128
            : D == 256 ? fn256 : nullptr;
  if (fn == nullptr) return int(cudaErrorInvalidValue);
  return fn(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale, stream);
}

}  // namespace

// q, k, v and o share one dtype: float32 for the _f32 entry point, bfloat16
// for the _wgmma one.  Strides are in elements, for the batch, head and
// sequence dimensions; the last dimension is contiguous.
#define FLASH_ARGS                                                                            \
  const void *q, const void *k, const void *v, void *o, int B, int H, int KV, int64_t Sq,     \
      int64_t Skv, int D, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,    \
      int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,           \
      int64_t oss, int causal, int64_t window, float sm_scale, cudaStream_t stream
#define FLASH_CALL(L)                                                                         \
  run(L<16>, L<32>, L<64>, L<128>, L<256>, D, q, k, v, o, B, H, KV, Sq, Skv,                  \
      Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss},                 \
      Strides{osb, osh, oss}, causal, window, sm_scale, stream)

extern "C" int flash_attention_f32_launch(FLASH_ARGS) { return FLASH_CALL(launch_f32); }

extern "C" int flash_attention_wgmma_launch(FLASH_ARGS) { return FLASH_CALL(launch_wgmma); }

extern "C" const char* flash_attention_error_string(int code) {
  if (code >= 0) return cudaGetErrorString(cudaError_t(code));
  static thread_local char text[64];
  snprintf(text, sizeof text, "cuTensorMapEncodeTiled failed: CUresult %d", -code);
  return text;
}
