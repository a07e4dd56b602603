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
//
// Log-sum-exp: where the caller passes an lse buffer (training), each row
// also writes m + ln l of its scaled scores, natural log (the wgmma variant
// converts from its base 2), +inf for a row that sees no key, so that the
// backward (flash_attention_bwd.cu) rebuilds P = exp(s - lse) without
// another pass over the keys and gets 0 where the forward wrote 0.
// Serving passes null and the write is skipped.  Helpers shared with the
// backward are in flash_common.cuh.
// Query rows past Sq are computed on zeros and not written; keys past Skv
// are loaded as zeros and masked.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or, for a tensor map that libcuda refuses, the
// negated CUresult).

#include "flash_common.cuh"

namespace {

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
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int64_t Sq, int64_t Skv, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal, int64_t window, float sm_scale) {
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
    if (lse != nullptr && tx == 0)
      lse[(int64_t(b) * H + h) * Sq + qg] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    float* orow = ob + qg * os.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < VEC; ++e) orow[cc * 8 * VEC + tx * VEC + e] = acc[i][cc][e] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int KV, int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs,
               Strides os, int causal, int64_t window, float sm_scale, cudaStream_t stream) {
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
      static_cast<float*>(o), lse, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------

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

template <int D, int NC>
__global__ void __launch_bounds__(WShape<D, NC>::kThreads, 1)
flash_kernel_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int H,
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
    // The rows' log-sum-exp in natural log, m scale + ln l, for the backward.
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < Sq)
          lse[(int64_t(b) * H + h) * Sq + row] =
              l[r] > 0.f ? (m[r] * scale_log2 + log2f(l[r])) / kLog2e : INFINITY;
      }
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

using Launch = int (*)(const void*, const void*, const void*, void*, float*, int, int, int,
                       int64_t, int64_t, Strides, Strides, Strides, Strides, int, int64_t,
                       float, cudaStream_t);

template <int D, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
              int KV, int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs, Strides os,
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
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, KV, int(Sq), int(Skv), os, causal,
      int(window), sm_scale * kLog2e);
  return int(cudaGetLastError());
}

// Two consumer warpgroups share each K/V tile between 128 query rows.  One
// gives a block a whole SM for 64 rows: it keeps head_dim 256 (O alone is
// 128 registers a thread) from spilling, and it fills more SMs where a
// launch has too few tiles of 128 rows to go round.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int H, int KV, int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs, Strides os,
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
  return fn(q, k, v, o, lse, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale,
            stream);
}

int run(Launch fn16, Launch fn32, Launch fn64, Launch fn128, Launch fn256, int D, const void* q,
        const void* k, const void* v, void* o, float* lse, int B, int H, int KV, int64_t Sq,
        int64_t Skv,
        Strides qs, Strides ks, Strides vs, Strides os, int causal, int64_t window,
        float sm_scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0)
    return int(cudaErrorInvalidValue);
  Launch fn = D == 16 ? fn16 : D == 32 ? fn32 : D == 64 ? fn64 : D == 128 ? fn128
            : D == 256 ? fn256 : nullptr;
  if (fn == nullptr) return int(cudaErrorInvalidValue);
  return fn(q, k, v, o, lse, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale,
            stream);
}

}  // namespace

// q, k, v and o share one dtype: float32 for the _f32 entry point, bfloat16
// for the _wgmma one.  Strides are in elements, for the batch, head and
// sequence dimensions; the last dimension is contiguous.  lse, where it is
// not null, is a contiguous [B, H, Sq] float32 tensor that receives each
// row's log-sum-exp of its scaled scores (natural log; +inf for a row that
// sees no key); serving passes null.
#define FLASH_ARGS                                                                            \
  const void *q, const void *k, const void *v, void *o, float *lse, int B, int H, int KV,     \
      int64_t Sq, int64_t Skv, int D, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,    \
      int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,           \
      int64_t oss, int causal, int64_t window, float sm_scale, cudaStream_t stream
#define FLASH_CALL(L)                                                                         \
  run(L<16>, L<32>, L<64>, L<128>, L<256>, D, q, k, v, o, lse, B, H, KV, Sq, Skv,             \
      Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss},                 \
      Strides{osb, osh, oss}, causal, window, sm_scale, stream)

extern "C" int flash_attention_f32_launch(FLASH_ARGS) { return FLASH_CALL(launch_f32); }

extern "C" int flash_attention_wgmma_launch(FLASH_ARGS) { return FLASH_CALL(launch_wgmma); }

extern "C" const char* flash_attention_error_string(int code) { return error_text(code); }
