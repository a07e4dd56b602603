// Flash attention (backward) on Hopper (sm_90a): two variants in one file.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel (JAX
// differentiates its jnp attention, src/repro/models/attention.py).  It is
// the gradient of the port's own forward kernel (flash_attention.cu), in
// place of the explicit PyTorch gradient (ref.py,
// attention_backward_reference), which builds f32 [G, Sq, Skv] tensors.
// With scale = 1/sqrt(D), the forward's log-sum-exp lse of each query row
// and the same mask (causal key <= query and/or a window key > query -
// window, positions from 0, k < Skv):
//   Delta_i = sum_d dO_id O_id,   P_ij = exp(scale q_i.k_j - lse_i),
//   dV_j = sum_i P_ij dO_i,       dS_ij = P_ij (dO_i.v_j - Delta_i),
//   dQ_i = scale sum_j dS_ij k_j, dK_j = scale sum_i dS_ij q_i.
// GQA: query head h reads KV head h / G (G = H / KV), and dK, dV of a KV
// head sum over its G query heads.
//
// Launches, in order on the caller's stream:
//  1. the prologue: one warp a query row writes Delta and the row's lse
//     (times log2 e for the wgmma variant, which works in base 2) into
//     [B, H, Sq_pad] f32, Sq_pad = Sq rounded up to 64.  Rows past Sq get
//     lse = +inf and Delta = 0, so P = 0 there without a mask, and the
//     dK/dV pass copies a tile's lse and Delta with one 1-D bulk copy that
//     never reads past the buffer.  A prologue reads O and dO once; fused
//     into the dK/dV pass it would read them once per key tile.
//  2. the dK/dV pass: one block per key tile, KV head (x split) and batch
//     row.  It walks, in order, its heads' query tiles that can see its
//     keys (from the diagonal to the window's far edge) and keeps dK and dV
//     in registers; it writes them once.
//  3. where split > 1, a reduction: the wrapper splits the G query heads of
//     a KV head among `split` blocks when the grid of key tiles x KV heads
//     would have fewer than 264 blocks, two an SM of a 132-SM H100
//     (recurrentgemma-2b: 32 key tiles of one KV head; G = 10 gives 320
//     blocks).  Each block writes f32
//     partial sums, and this launch adds them in split order, scales dK and
//     writes both in the caller's layout.
//  4. the dQ pass: one block per query tile, head and batch row; it walks
//     the visible key tiles as the forward does, dQ in registers.
// No atomics: every sum has one order fixed by the shapes (the split too),
// so a replayed call gives the same bits, on any card.
//
// What bounds it: operations.  Five products of 2 D FLOPs per (query, key)
// pair are the least work (10 B H Sq Skv D where nothing is masked); the two
// passes compute S and dP twice, and the dV and dK products run twice (the
// high and low bf16 halves of P and dS, below): nine (at D = 256, where the
// dK/dV pass's two warpgroups both compute S^T and dP^T, eleven).  The
// least time is the five at 989 TFLOP/s, over the pairs the mask leaves.
//
// Precision: P and dS enter the dV and dK products as a bf16 high part
// plus the bf16 of the rest, so the products see them to 16 bits.  A key's
// dV and dK sum up to 2,048 queries x 10 heads at recurrentgemma-2b's
// training shape, and with P and dS rounded to bf16 once, as a
// one-product flash backward does, their error came within a few per cent
// of the 2e-2 of max(1, |value|) that the card's checks allow (SDPA's
// backward misses it there: chip_smoke.py's train_flash_backward prints
// both errors against the explicit gradient in f32).  dQ sums one head's
// keys and keeps one bf16 dS.
//
// bfloat16 (training): wgmma on tiles fed by TMA, as the forward.  A
// producer warpgroup (one thread) issues every copy; consumer warpgroups
// wait on "full" mbarriers and release stages through "empty" ones; the
// producer gives its registers to them with setmaxnreg (232 / 40).
//   dK/dV pass, per query tile of BM rows (Q, dO, lse and Delta one stage
//   of the ring; K and V of the block loaded once):
//     S^T = K Q^T and dP^T = V dO^T   wgmma m64nBMk16, both K-major;
//     P^T, dS^T from S^T and dP^T in registers (masked only on a tile that
//     the diagonal, the window's edge, Skv or Sq cuts), packed to bf16 A
//     fragments in place (high and low halves), as the forward packs P;
//     dV += P^T dO, dK += dS^T Q      wgmma m64nCk16 twice (the halves), A
//     from registers, B MN-major through the descriptor's transpose bit
//     (nothing is copied transposed).
//   dQ pass, per key tile of 64 keys (the block's Q and dO loaded once):
//     S = Q K^T, dP = dO V^T          wgmma m64n64k16;
//     dQ += dS K                      wgmma m64nDk16, K MN-major.
// Tile shapes, stages and registers a thread (f32 accumulators; the A
// fragments add BM / 2 in the dK/dV pass, BN / 4 in the dQ pass):
//   D   | dK/dV: keys/block  BM  stages  regs (dK+dV, S^T+dP^T) | dQ: rows/block  stages  regs (dQ, S+dP)
//   16  |        128         64    4     16, 64                 |     128           4     8, 64
//   32  |        128         64    4     32, 64                 |     128           4     16, 64
//   64  |        128         64    4     64, 64                 |     128           4     32, 64
//   128 |        128         32    4     128, 32                |     128           4     64, 64
//   256 |         64         32    4     128, 32 (D split in    |      64           2     128, 64
//       |                                 two halves, one a warpgroup)
// D = 256 is the hard case: dK and dV of 64 keys are 2 x 64 x 256 f32 =
// 128 KB, 256 registers a thread for one warpgroup.  So at D = 256 the two
// consumer warpgroups share the block's 64 keys and each owns half of dK's
// and dV's columns (128 registers a thread), over query tiles of 32 rows;
// each computes the whole S^T and dP^T (the price of the split).  Shared
// memory: K and V of the block, then each stage's Q, dO, lse and Delta,
// within 227 KB (194 KB at D = 256); the dQ pass holds Q and dO (64 KB at
// D = 256) and a ring of two K/V stages.
// The kernels are compiled for 384 threads, so ptxas allots 168 registers
// a thread; at D = 128 and 256 the dK/dV pass spills a few hundred bytes
// (the build phase prints ptxas's report).  Tensor maps are 4-D (D, S,
// heads, B) with the caller's strides, so the model's [B, S, H, D] views
// are read in place; a ragged tile is zero-filled by the TMA unit and
// masked.  Tiles that none of a warpgroup's rows or keys can see are
// passed on uncomputed.
//
// float32 (checks, the f32 trainer): the same two passes on the CUDA cores,
// 256 threads a block, tiles of 32 keys and 32 queries in shared memory
// (rows padded by one float).  A thread owns one key (dK/dV pass) or one
// query (dQ pass) and D / 8 of its columns, and 4 entries of each 32 x 32
// score tile.  Exact to f32 rounding: no TF32; dK and dV add each query
// tile's sums apart before the running ones.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or, for a tensor map that libcuda refuses, the
// negated CUresult).

#include "flash_common.cuh"

namespace {

constexpr int kRowPad = 64;  // Sq_pad: Sq rounded up to this

struct BwdArgs {
  const void *q, *k, *v, *o, *d_o;
  const float* lse;  // [B, H, Sq]
  void *dq, *dk, *dv;
  float* aux;   // [2, B, H, Sq_pad]: Delta, then the padded lse
  float* part;  // [2, split, B, KV, Skv, D]: dK's and dV's partial sums
  int B, H, KV, Sq, Skv, D, Sq_pad;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
  int split;
  cudaStream_t stream;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// (a, b) as a bf16x2 high part and the bf16x2 of what it leaves out.
__device__ __forceinline__ void pack_split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - f.x, b - f.y);
}

// (key, query) is a pair the mask leaves.
__device__ __forceinline__ bool visible_pair(int key, int query, int Sq, int Skv, int causal,
                                             int window) {
  return key < Skv && query < Sq && (!causal || key <= query) &&
         (window <= 0 || key > query - window);
}

// ---------------------------------------------------------------------------
// Prologue and reduction (both variants)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
bwd_prologue(const T* __restrict__ o, const T* __restrict__ d_o, const float* __restrict__ lse,
             float* __restrict__ delta, float* __restrict__ lse_pad, int H, int Sq, int Sq_pad,
             int D, Strides os, Strides dos, float lse_mult) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= Sq_pad) return;
  const int64_t at = (int64_t(b) * H + h) * Sq_pad + row;
  if (row >= Sq) {
    if (lane == 0) {
      delta[at] = 0.f;
      lse_pad[at] = INFINITY;
    }
    return;
  }
  const T* orow = o + b * os.b + h * os.h + row * os.s;
  const T* drow = d_o + b * dos.b + h * dos.h + row * dos.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[at] = acc;
    lse_pad[at] = lse[(int64_t(b) * H + h) * Sq + row] * lse_mult;
  }
}

// dK = scale * (sum of the splits' partials), dV = their sum, in split order.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_reduce(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv, int split,
           int KV, int Skv, int D, int64_t n, Strides dks, Strides dvs, float scale) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int d = int(i % D);
    const int64_t r = i / D;
    const int j = int(r % Skv);
    const int kvh = int((r / Skv) % KV), b = int(r / (int64_t(Skv) * KV));
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < split; ++s) {
      sk += part[s * n + i];
      sv += part[(split + s) * n + i];
    }
    dk[b * dks.b + kvh * dks.h + j * dks.s + d] = from_f32<T>(sk * scale);
    dv[b * dvs.b + kvh * dvs.h + j * dvs.s + d] = from_f32<T>(sv);
  }
}

template <typename T>
int launch_prologue(const BwdArgs& a, float lse_mult) {
  float* delta = a.aux;
  float* lse_pad = a.aux + int64_t(a.B) * a.H * a.Sq_pad;
  bwd_prologue<T><<<dim3(unsigned(a.Sq_pad / 8), unsigned(a.H), unsigned(a.B)), 256, 0,
                    a.stream>>>(static_cast<const T*>(a.o), static_cast<const T*>(a.d_o), a.lse,
                                delta, lse_pad, a.H, a.Sq, a.Sq_pad, a.D, a.os, a.dos, lse_mult);
  return int(cudaGetLastError());
}

template <typename T>
int launch_reduce(const BwdArgs& a) {
  if (a.split == 1) return 0;
  const int64_t n = int64_t(a.B) * a.KV * a.Skv * a.D;
  const int64_t blocks = (n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192;
  bwd_reduce<T><<<unsigned(blocks), 256, 0, a.stream>>>(
      a.part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.split, a.KV, a.Skv, a.D, n, a.dks,
      a.dvs, a.scale);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFThreads = 256;
constexpr int kFB = 32;  // keys and queries per tile

template <int D>
struct FShape {
  static constexpr int kP = D + 1;     // padded row of a tile
  static constexpr int kCols = D / 8;  // output columns per thread
  static constexpr int kSP = kFB + 1;  // padded row of a score tile
  static constexpr size_t kSmemBytes =
      sizeof(float) * (4 * size_t(kFB) * kP + 2 * size_t(kFB) * kSP + 2 * kFB);
};

// One [kFB, D] tile of rows [r0, r0 + kFB) of a [*, D] head, zeros past n.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int64_t stride,
                                              int r0, int n, int D, int P) {
  for (int idx = threadIdx.x; idx < kFB * D; idx += kFThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * P + d] = r0 + r < n ? src[int64_t(r0 + r) * stride + d] : 0.f;
  }
}

// dK and dV of 32 keys: block (key tile, KV head x split, batch row).
template <int D>
__global__ void __launch_bounds__(kFThreads)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ d_o,
             const float* __restrict__ lse_pad, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part, int B,
             int H, int KV, int Sq, int Skv, int Sq_pad, Strides qs, Strides ks, Strides vs,
             Strides dos, Strides dks, Strides dvs, int causal, int window, float scale,
             int split) {
  using Sh = FShape<D>;
  constexpr int P = Sh::kP, NCOL = Sh::kCols, SP = Sh::kSP;
  extern __shared__ float fsmem[];
  float* Ks = fsmem;
  float* Vs = Ks + kFB * P;
  float* Qs = Vs + kFB * P;
  float* Os = Qs + kFB * P;  // dO
  float* Ps = Os + kFB * P;
  float* Ss = Ps + kFB * SP;  // dS
  float* Ls = Ss + kFB * SP;
  float* Dl = Ls + kFB;

  const int tid = threadIdx.x, kr = tid / 8, c8 = tid % 8;
  const int b = blockIdx.z, kvh = blockIdx.y / split, part_i = blockIdx.y % split;
  const int G = H / KV, gs = G / split;
  const int k0 = blockIdx.x * kFB;
  load_tile_f32(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, Skv, D, P);
  load_tile_f32(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, Skv, D, P);

  // Queries that can see the tile's keys: [q_lo, q_hi).
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kFB - 1 + window) : Sq;
  float adk[NCOL], adv[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) adk[c] = adv[c] = 0.f;

  for (int g = 0; g < gs; ++g) {
    const int h = kvh * G + part_i * gs + g;
    const float* lrow = lse_pad + (int64_t(b) * H + h) * Sq_pad;
    const float* drow = delta + (int64_t(b) * H + h) * Sq_pad;
    for (int q0 = (q_lo / kFB) * kFB; q0 < q_hi; q0 += kFB) {
      __syncthreads();  // the previous tile's readers are done (and K, V are in)
      load_tile_f32(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, P);
      load_tile_f32(Os, d_o + b * dos.b + h * dos.h, dos.s, q0, Sq, D, P);
      if (tid < kFB) {  // q0 + kFB <= Sq_pad
        Ls[tid] = lrow[q0 + tid];
        Dl[tid] = drow[q0 + tid];
      }
      __syncthreads();
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kk = Ks[kr * P + d], vv = Vs[kr * P + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] += kk * Qs[(c8 + 8 * i) * P + d];
          dp[i] += vv * Os[(c8 + 8 * i) * P + d];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = c8 + 8 * i;
        const float p = visible_pair(k0 + kr, q0 + qi, Sq, Skv, causal, window)
                            ? expf(s[i] * scale - Ls[qi])
                            : 0.f;
        Ps[kr * SP + qi] = p;
        Ss[kr * SP + qi] = p * (dp[i] - Dl[qi]);
      }
      __syncthreads();
      // The tile's sums apart, then into the running ones: two levels keep
      // the rounding of a sum over thousands of queries near the library's.
      float tdk[NCOL], tdv[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) tdk[c] = tdv[c] = 0.f;
      for (int qi = 0; qi < kFB; ++qi) {
        const float p = Ps[kr * SP + qi], ds = Ss[kr * SP + qi];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          tdv[c] += p * Os[qi * P + c8 + 8 * c];
          tdk[c] += ds * Qs[qi * P + c8 + 8 * c];
        }
      }
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        adk[c] += tdk[c];
        adv[c] += tdv[c];
      }
    }
  }

  const int j = k0 + kr;
  if (j >= Skv) return;
  const int64_t n = int64_t(B) * KV * Skv * D;
  const int64_t at = ((int64_t(b) * KV + kvh) * Skv + j) * D;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int d = c8 + 8 * c;
    if (split == 1) {
      dk[b * dks.b + kvh * dks.h + j * dks.s + d] = adk[c] * scale;
      dv[b * dvs.b + kvh * dvs.h + j * dvs.s + d] = adv[c];
    } else {
      part[part_i * n + at + d] = adk[c];
      part[(split + part_i) * n + at + d] = adv[c];
    }
  }
}

// dQ of 32 query rows: block (query tile, head, batch row), heaviest first.
template <int D>
__global__ void __launch_bounds__(kFThreads)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ d_o, const float* __restrict__ lse_pad,
           const float* __restrict__ delta, float* __restrict__ dq, int H, int KV, int Sq, int Skv,
           int Sq_pad, Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, int causal,
           int window, float scale) {
  using Sh = FShape<D>;
  constexpr int P = Sh::kP, NCOL = Sh::kCols, SP = Sh::kSP;
  extern __shared__ float fsmem[];
  float* Qs = fsmem;
  float* Os = Qs + kFB * P;  // dO
  float* Ks = Os + kFB * P;
  float* Vs = Ks + kFB * P;
  float* Ss = Vs + kFB * P;  // dS (Ps unused here)
  float* Ls = Ss + 2 * kFB * SP;
  float* Dl = Ls + kFB;

  const int tid = threadIdx.x, qr = tid / 8, c8 = tid % 8;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = int(gridDim.x - 1 - blockIdx.x) * kFB;
  load_tile_f32(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, P);
  load_tile_f32(Os, d_o + b * dos.b + h * dos.h, dos.s, q0, Sq, D, P);
  if (tid < kFB) {
    Ls[tid] = lse_pad[(int64_t(b) * H + h) * Sq_pad + q0 + tid];
    Dl[tid] = delta[(int64_t(b) * H + h) * Sq_pad + q0 + tid];
  }
  // Keys the tile's rows can see: [k_lo, k_hi).
  const int q_last = min(q0 + kFB, Sq) - 1;
  const int k_hi = causal ? min(q_last + 1, Skv) : Skv;
  const int k_lo = window > 0 ? max(q0 - window + 1, 0) : 0;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float adq[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) adq[c] = 0.f;

  for (int k0 = (k_lo / kFB) * kFB; k0 < k_hi; k0 += kFB) {
    __syncthreads();  // the previous tile's readers are done (and Q, dO are in)
    load_tile_f32(Ks, kb, ks.s, k0, Skv, D, P);
    load_tile_f32(Vs, vb, vs.s, k0, Skv, D, P);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qq = Qs[qr * P + d], oo = Os[qr * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] += qq * Ks[(c8 + 8 * i) * P + d];
        dp[i] += oo * Vs[(c8 + 8 * i) * P + d];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = c8 + 8 * i;
      const float p = visible_pair(k0 + kj, q0 + qr, Sq, Skv, causal, window)
                          ? expf(s[i] * scale - Ls[qr])
                          : 0.f;
      Ss[qr * SP + kj] = p * (dp[i] - Dl[qr]);
    }
    __syncthreads();
    for (int kj = 0; kj < kFB; ++kj) {
      const float ds = Ss[qr * SP + kj];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) adq[c] += ds * Ks[kj * P + c8 + 8 * c];
    }
  }

  const int row = q0 + qr;
  if (row >= Sq) return;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) dq[b * dqs.b + h * dqs.h + row * dqs.s + c8 + 8 * c] = adq[c] * scale;
}

template <int D>
int bwd_f32(const BwdArgs& a) {
  using Sh = FShape<D>;
  int err = launch_prologue<float>(a, 1.f);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(bwd_dkdv_f32<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          int(Sh::kSmemBytes));
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(Sh::kSmemBytes));
  if (cerr != cudaSuccess) return int(cerr);
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* d_o = static_cast<const float*>(a.d_o);
  const float* delta = a.aux;
  const float* lse_pad = a.aux + int64_t(a.B) * a.H * a.Sq_pad;
  bwd_dkdv_f32<D><<<dim3(unsigned((a.Skv + kFB - 1) / kFB), unsigned(a.KV * a.split),
                         unsigned(a.B)),
                    kFThreads, Sh::kSmemBytes, a.stream>>>(
      q, k, v, d_o, lse_pad, delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.part,
      a.B, a.H, a.KV, a.Sq, a.Skv, a.Sq_pad, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.causal,
      a.window, a.scale, a.split);
  err = int(cudaGetLastError());
  if (err == 0) err = launch_reduce<float>(a);
  if (err != 0) return err;
  bwd_dq_f32<D><<<dim3(unsigned((a.Sq + kFB - 1) / kFB), unsigned(a.H), unsigned(a.B)),
                  kFThreads, Sh::kSmemBytes, a.stream>>>(
      q, k, v, d_o, lse_pad, delta, static_cast<float*>(a.dq), a.H, a.KV, a.Sq, a.Skv, a.Sq_pad,
      a.qs, a.ks, a.vs, a.dos, a.dqs, a.causal, a.window, a.scale);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------

// Shared by both passes: TMA boxes of 64 columns (the 128-byte swizzle),
// or the whole row where D < 64.
template <int D>
struct Boxes {
  static constexpr int kBoxW = D < 64 ? D : 64;   // columns per TMA box
  static constexpr int kRowBytes = 2 * kBoxW;     // one box row = the swizzle span
  static constexpr int kCount = D / kBoxW;
  // wgmma descriptor layout type of the swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B.
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
};

// dK/dV pass: two consumer warpgroups and a producer.
template <int D>
struct KVShape : Boxes<D> {
  static constexpr bool kSplitD = D == 256;          // both on the same 64 keys
  static constexpr int kKeys = kSplitD ? 64 : 128;   // keys per block
  static constexpr int kCols = kSplitD ? D / 2 : D;  // dK, dV columns per warpgroup
  static constexpr int kBM = D >= 128 ? 32 : 64;     // queries per tile
  static constexpr int kThreads = 3 * kWgThreads;
  static constexpr int kKVBytes = kKeys * D * 2;     // the K tile, or the V tile
  static constexpr int kQBytes = kBM * D * 2;        // a Q tile, or a dO tile
  static constexpr int kRowF32 = kBM * 4;            // a tile's lse, or its Delta
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kRowF32;
  static constexpr int kFit = (kSmemLimit - 2048 - 2 * kKVBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmemBytes =
      1024 + 2 * size_t(kKVBytes) + size_t(kStages) * kStageBytes + 8 * (1 + 2 * kStages);
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit, "tiles do not fit");
  static_assert(kRowPad % kBM == 0, "a query tile never crosses Sq_pad");
};

// dQ pass: NC consumer warpgroups of 64 query rows each, and a producer.
template <int D>
struct QShape : Boxes<D> {
  static constexpr int kNC = D == 256 ? 1 : 2;
  static constexpr int kBM = 64 * kNC;               // query rows per block
  static constexpr int kThreads = kWgThreads * (kNC + 1);
  static constexpr int kBN = 64;                     // keys per tile
  static constexpr int kQBytes = kBM * D * 2;        // Q, or dO
  static constexpr int kTileBytes = kBN * D * 2;     // one K or V tile
  static constexpr int kFit = (kSmemLimit - 2048 - 2 * kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmemBytes =
      1024 + 2 * size_t(kQBytes) + size_t(2 * kStages) * kTileBytes + 8 * (1 + 4 * kStages);
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit, "tiles do not fit");
};

template <int D>
__global__ void __launch_bounds__(KVShape<D>::kThreads, 1)
bwd_dkdv_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
               __grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ part, int B, int H, int KV, int Sq, int Skv, int Sq_pad,
               Strides dks, Strides dvs, int causal, int window, float scale, float scale_log2,
               int split) {
  using Sh = KVShape<D>;
  constexpr int BM = Sh::kBM, RB = Sh::kRowBytes, NS = Sh::kStages, KEYS = Sh::kKeys;
  constexpr int COLS = Sh::kCols, BW = Sh::kBoxW;
  extern __shared__ __align__(1024) uint8_t smem_tiles[];
  // Swizzled tiles must start on 1024 bytes.
  const uint32_t base = smem_u32(smem_tiles);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + Sh::kKVBytes;
  const uint32_t sQ = sV + Sh::kKVBytes;        // stage s at sQ + s * kQBytes
  const uint32_t sO = sQ + NS * Sh::kQBytes;    // dO
  const uint32_t sL = sO + NS * Sh::kQBytes;    // lse (base 2), kRowF32 a stage
  const uint32_t sDl = sL + NS * Sh::kRowF32;   // Delta
  // Barriers, 8 bytes each: kv_full, then NS each of full and empty.
  const uint32_t kv_full = sDl + NS * Sh::kRowF32;
  const uint32_t full = kv_full + 8, empty = full + 8 * NS;
  const float* lrows = reinterpret_cast<const float*>(smem_tiles + (sL - base));
  const float* drows = reinterpret_cast<const float*>(smem_tiles + (sDl - base));

  const int b = blockIdx.z, kvh = blockIdx.x / split, part_i = blockIdx.x % split;
  const int G = H / KV, gs = G / split, h0 = kvh * G + part_i * gs;
  const int kbase = blockIdx.y * KEYS;
  // Query tiles that can see the block's keys, walked for each of its gs
  // heads in order: item i is head h0 + i / n_qt, tile qt0 + i % n_qt.
  const int q_lo = causal ? kbase : 0;
  const int q_hi = window > 0 ? min(Sq, kbase + KEYS - 1 + window) : Sq;
  const int qt0 = q_lo / BM;
  const int n_qt = q_hi > q_lo ? (q_hi + BM - 1) / BM - qt0 : 0;
  const int n_items = gs * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / kWgThreads, 0);
  if (wg == 2) {
    // Producer: K and V once, then Q, dO, lse and Delta of every item.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x % kWgThreads == 0) {
      mbar_expect_tx(kv_full, 2 * Sh::kKVBytes);
      for (int x = 0; x < Sh::kCount; ++x) {
        tma_load(sK + x * KEYS * RB, &tk, kv_full, x * BW, kbase, kvh, b);
        tma_load(sV + x * KEYS * RB, &tv, kv_full, x * BW, kbase, kvh, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = it % NS;
        const int h = h0 + it / n_qt, q0 = (qt0 + it % n_qt) * BM;
        mbar_wait(empty + 8 * s, ((it / NS) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full + 8 * s, Sh::kStageBytes);
        for (int x = 0; x < Sh::kCount; ++x) {
          tma_load(sQ + s * Sh::kQBytes + x * BM * RB, &tq, full + 8 * s, x * BW, q0, h, b);
          tma_load(sO + s * Sh::kQBytes + x * BM * RB, &tdo, full + 8 * s, x * BW, q0, h, b);
        }
        const int64_t row = (int64_t(b) * H + h) * Sq_pad + q0;
        bulk_load(sL + s * Sh::kRowF32, lse2 + row, Sh::kRowF32, full + 8 * s);
        bulk_load(sDl + s * Sh::kRowF32, delta + row, Sh::kRowF32, full + 8 * s);
      }
    }
  } else {
    // Consumer: 64 keys (its own, or at D = 256 the block's) and COLS
    // columns of their dK and dV.  A thread holds keys kr0 and kr0 + 8 of
    // its warp's 16; in each 8-column group of an accumulator the columns
    // 2 (lane % 4) and 2 (lane % 4) + 1.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % kWgThreads;
    const int lane = tid % 32;
    const int kw = Sh::kSplitD ? 0 : 64 * wg;   // this warpgroup's keys in the block's tile
    const int k0w = kbase + kw;
    const int col0 = Sh::kSplitD ? wg * COLS : 0;
    const int kr0 = (tid / 32) * 16 + lane / 4;
    float adk[COLS / 2], adv[COLS / 2];
#pragma unroll
    for (int e = 0; e < COLS / 2; ++e) adk[e] = adv[e] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % NS;
      const int q0 = (qt0 + it % n_qt) * BM;
      mbar_wait(full + 8 * s, (it / NS) & 1);
      const bool seen = k0w < Skv && q0 < Sq && (!causal || k0w <= q0 + BM - 1) &&
                        (window <= 0 || q0 < k0w + 63 + window);
      if (seen) {
        float sc[BM / 2], dp[BM / 2];  // S^T and dP^T: 64 keys x BM queries
        // P^T and dS^T as A fragments, each as a bf16 high part and the
        // bf16 rest, so that the products see them to 16 bits.
        uint32_t pa[BM / 4], pl[BM / 4], da[BM / 4], dl[BM / 4];
        const uint32_t sq = sQ + s * Sh::kQBytes, so = sO + s * Sh::kQBytes;
        const bool mask = (causal && k0w + 63 > q0) || (window > 0 && k0w <= q0 + BM - 1 - window) ||
                          k0w + 64 > Skv || q0 + BM > Sq;
        const float* lr = lrows + s * BM;
        const float* dr = drows + s * BM;
        // S^T = K Q^T (or dP^T = V dO^T) over D in steps of 16, issued.
        auto issue = [&](float* acc, uint32_t a, uint32_t b) {
          const uint64_t desc_a = opaque(make_desc(a, 16, 8 * RB, Sh::kLayout));
          const uint64_t desc_b = opaque(make_desc(b, 16, 8 * RB, Sh::kLayout));
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int box = kk * 16 / BW, col = kk * 16 % BW;
            wgmma_ss<BM>(acc, desc_a + ((box * KEYS * RB + 2 * col) >> 4),
                         desc_b + ((box * BM * RB + 2 * col) >> 4), 0 < kk);
          }
        };
        // P^T in place of S^T.  Element e: key kr0 + 8 ((e / 2) % 2), query
        // 8 (e / 4) + 2 (lane % 4) + e % 2 of the tile.
        auto probs = [&]() {
#pragma unroll
          for (int e = 0; e < BM / 2; ++e) {
            const int key = k0w + kr0 + 8 * ((e / 2) % 2);
            const int c = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
            sc[e] = exp2f(fmaf(sc[e], scale_log2, -lr[c]));
            if (mask && !visible_pair(key, q0 + c, Sq, Skv, causal, window)) sc[e] = 0.f;
          }
        };
        // Both products issued together.  At D = 256 the two warpgroups
        // compute the same two for their shared 64 keys; trading them
        // through shared memory behind a barrier of both ran slower on the
        // H100: the barrier keeps one warpgroup's softmax from overlapping
        // the other's products.
        wgmma_fence();
        issue(sc, sK + kw * RB, sq);
        issue(dp, sV + kw * RB, so);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BM / 2>(sc);
        fence_regs<BM / 2>(dp);
        probs();
        // P^T and dS^T = P^T (dP^T - Delta) as A fragments.
#pragma unroll
        for (int e = 0; e < BM / 2; e += 2) {
          const int c = 8 * (e / 4) + 2 * (lane % 4);
          pack_split(sc[e], sc[e + 1], pa[e / 2], pl[e / 2]);
          pack_split(sc[e] * (dp[e] - dr[c]), sc[e + 1] * (dp[e + 1] - dr[c + 1]), da[e / 2],
                     dl[e / 2]);
        }
        // dV += P^T dO and dK += dS^T Q over the tile's queries in steps of
        // 16; dO and Q are the MN-major B operands, from this warpgroup's
        // first column on.
        {
          const uint32_t cb = (col0 / BW) * BM * RB;
          const uint64_t bo = opaque(make_desc(so + cb, BM * RB, 8 * RB, Sh::kLayout));
          const uint64_t bq = opaque(make_desc(sq + cb, BM * RB, 8 * RB, Sh::kLayout));
          fence_u32<BM / 4>(pa);
          fence_u32<BM / 4>(pl);
          fence_u32<BM / 4>(da);
          fence_u32<BM / 4>(dl);
          fence_regs<COLS / 2>(adv);
          fence_regs<COLS / 2>(adk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<COLS>(adv, &pa[4 * kk], bo + ((kk * 16 * RB) >> 4));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<COLS>(adv, &pl[4 * kk], bo + ((kk * 16 * RB) >> 4));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<COLS>(adk, &da[4 * kk], bq + ((kk * 16 * RB) >> 4));
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<COLS>(adk, &dl[4 * kk], bq + ((kk * 16 * RB) >> 4));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<COLS / 2>(adv);
          fence_regs<COLS / 2>(adk);
          fence_u32<BM / 4>(pa);
          fence_u32<BM / 4>(pl);
          fence_u32<BM / 4>(da);
          fence_u32<BM / 4>(dl);
        }
      }
      release(empty + 8 * s, lane);
    }

    const int64_t n = int64_t(B) * KV * Skv * D;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0w + kr0 + 8 * r;
        if (key >= Skv) continue;
        const float k0v = adk[4 * j + 2 * r], k1v = adk[4 * j + 2 * r + 1];
        const float v0 = adv[4 * j + 2 * r], v1 = adv[4 * j + 2 * r + 1];
        if (split == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dk + b * dks.b + kvh * dks.h + key * dks.s + col) =
              __floats2bfloat162_rn(k0v * scale, k1v * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + b * dvs.b + kvh * dvs.h + key * dvs.s + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          const int64_t at = ((int64_t(b) * KV + kvh) * Skv + key) * D + col;
          *reinterpret_cast<float2*>(part + part_i * n + at) = make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(part + (split + part_i) * n + at) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(QShape<D>::kThreads, 1)
bwd_dq_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
             __grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int H, int KV, int Sq, int Skv, int Sq_pad,
             Strides dqs, int causal, int window, float scale, float scale_log2) {
  using Sh = QShape<D>;
  constexpr int NC = Sh::kNC, BN = Sh::kBN, RB = Sh::kRowBytes, NS = Sh::kStages, BM = Sh::kBM;
  constexpr int BW = Sh::kBoxW;
  extern __shared__ __align__(1024) uint8_t smem_tiles[];
  const uint32_t sQ = (smem_u32(smem_tiles) + 1023) & ~1023u;
  const uint32_t sO = sQ + Sh::kQBytes;  // dO
  const uint32_t sK = sO + Sh::kQBytes;  // stage s at sK + s * kTileBytes
  const uint32_t sV = sK + NS * Sh::kTileBytes;
  // Barriers, 8 bytes each: q_full, then NS each of k_full, v_full,
  // k_empty and v_empty.
  const uint32_t q_full = sV + NS * Sh::kTileBytes;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * NS;
  const uint32_t k_empty = v_full + 8 * NS, v_empty = k_empty + 8 * NS;

  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows0 = int(gridDim.y - 1 - blockIdx.y) * BM;  // heaviest blocks first

  // Keys the block's rows can see, [k_lo, k_hi), walked in tiles of BN.
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

  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / kWgThreads, 0);
  if (wg == NC) {
    // Producer: Q and dO once, then K and V of each tile.
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x % kWgThreads == 0) {
      mbar_expect_tx(q_full, 2 * Sh::kQBytes);
      for (int x = 0; x < Sh::kCount; ++x) {
        tma_load(sQ + x * BM * RB, &tq, q_full, x * BW, rows0, h, b);
        tma_load(sO + x * BM * RB, &tdo, q_full, x * BW, rows0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        const uint32_t parity = ((i / NS) & 1) ^ 1;  // the first round passes
        const int k0 = (t_begin + i) * BN;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, Sh::kTileBytes);
        for (int x = 0; x < Sh::kCount; ++x)
          tma_load(sK + s * Sh::kTileBytes + x * BN * RB, &tk, k_full + 8 * s, x * BW, k0, kvh, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, Sh::kTileBytes);
        for (int x = 0; x < Sh::kCount; ++x)
          tma_load(sV + s * Sh::kTileBytes + x * BN * RB, &tv, v_full + 8 * s, x * BW, k0, kvh, b);
      }
    }
  } else {
    // Consumer: 64 query rows; a thread holds rows r0 and r0 + 8.
    if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % kWgThreads;
    const int lane = tid % 32;
    const int row_lo = min(rows0 + wg * 64, Sq);  // Sq: the warpgroup has no rows
    const int r0 = row_lo + (tid / 32) * 16 + lane / 4;
    const int row_hi = min(row_lo + 64, Sq) - 1;
    int wk_lo, wk_hi, a0 = 0, a1 = 0;
    visible_keys(row_lo, Sq, Skv, causal, window, wk_lo, wk_hi);
    if (wk_lo < wk_hi) {
      a0 = wk_lo / BN - t_begin;
      a1 = max(min((wk_hi + BN - 1) / BN - t_begin, n_tiles), a0);
    }
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const int64_t at = (int64_t(b) * H + h) * Sq_pad + row;
      lse_r[r] = row < Sq ? lse2[at] : INFINITY;
      delta_r[r] = row < Sq ? delta[at] : 0.f;
    }
    const uint32_t qa = sQ + wg * 64 * RB, oa = sO + wg * 64 * RB;  // this warpgroup's rows

    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const uint32_t st = 8 * uint32_t(i % NS), par = uint32_t(i / NS) & 1;
      mbar_wait(k_full + st, par);
      mbar_wait(v_full + st, par);
      if (i >= a0 && i < a1) {
        const int k0 = (t_begin + i) * BN;
        const uint32_t sk = sK + (i % NS) * Sh::kTileBytes, sv = sV + (i % NS) * Sh::kTileBytes;
        float sc[BN / 2], dp[BN / 2];
        uint32_t da[BN / 4];
        {
          const uint64_t dqa = opaque(make_desc(qa, 16, 8 * RB, Sh::kLayout));
          const uint64_t doa = opaque(make_desc(oa, 16, 8 * RB, Sh::kLayout));
          const uint64_t dkb = opaque(make_desc(sk, 16, 8 * RB, Sh::kLayout));
          const uint64_t dvb = opaque(make_desc(sv, 16, 8 * RB, Sh::kLayout));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int box = kk * 16 / BW, col = kk * 16 % BW;
            wgmma_ss<BN>(sc, dqa + ((box * BM * RB + 2 * col) >> 4),
                         dkb + ((box * BN * RB + 2 * col) >> 4), 0 < kk);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int box = kk * 16 / BW, col = kk * 16 % BW;
            wgmma_ss<BN>(dp, doa + ((box * BM * RB + 2 * col) >> 4),
                         dvb + ((box * BN * RB + 2 * col) >> 4), 0 < kk);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<BN / 2>(sc);
          fence_regs<BN / 2>(dp);
        }
        release(v_empty + st, lane);
        // dS; element e: row r0 + 8 ((e / 2) % 2), key k0 + 8 (e / 4) +
        // 2 (lane % 4) + e % 2.
        const bool mask = k0 + BN > Skv || (causal && k0 + BN - 1 > row_lo) ||
                          (window > 0 && k0 <= row_hi - window);
#pragma unroll
        for (int e = 0; e < BN / 2; e += 2) {
          const int r = (e / 2) % 2;
          const int key = k0 + 8 * (e / 4) + 2 * (lane % 4);
          float ds[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float p = exp2f(fmaf(sc[e + u], scale_log2, -lse_r[r]));
            if (mask && !visible_pair(key + u, r0 + 8 * r, Sq, Skv, causal, window)) p = 0.f;
            ds[u] = p * (dp[e + u] - delta_r[r]);
          }
          da[e / 2] = pack_bf16x2(ds[0], ds[1]);
        }
        // dQ += dS K over the tile's keys in steps of 16, K the MN-major B.
        {
          const uint64_t kb = opaque(make_desc(sk, BN * RB, 8 * RB, Sh::kLayout));
          fence_u32<BN / 4>(da);
          fence_regs<D / 2>(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_rs<D>(acc, &da[4 * kk], kb + ((kk * 16 * RB) >> 4));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<D / 2>(acc);
          fence_u32<BN / 4>(da);
        }
        release(k_empty + st, lane);
      } else {
        release(k_empty + st, lane);
        release(v_empty + st, lane);
      }
    }

    __nv_bfloat16* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(qb + row * dqs.s + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

template <int D>
int bwd_wgmma(const BwdArgs& a) {
  using KS = KVShape<D>;
  using QS = QShape<D>;
  const int key_tiles = (a.Skv + KS::kKeys - 1) / KS::kKeys;
  const int q_tiles = (a.Sq + QS::kBM - 1) / QS::kBM;
  if (key_tiles > 65535 || q_tiles > 65535) return int(cudaErrorInvalidConfiguration);
  int err = launch_prologue<__nv_bfloat16>(a, kLog2e);
  if (err != 0) return err;
  const float* delta = a.aux;
  const float* lse2 = a.aux + int64_t(a.B) * a.H * a.Sq_pad;
  const float scale_log2 = a.scale * kLog2e;

  // dK/dV pass: Q and dO in boxes of BM rows, K and V of the block's keys.
  CUtensorMap tq, tdo, tk, tv;
  err = encode_map(&tq, a.q, D, a.Sq, a.H, a.B, a.qs, KS::kBoxW, KS::kBM);
  if (err == 0) err = encode_map(&tdo, a.d_o, D, a.Sq, a.H, a.B, a.dos, KS::kBoxW, KS::kBM);
  if (err == 0) err = encode_map(&tk, a.k, D, a.Skv, a.KV, a.B, a.ks, KS::kBoxW, KS::kKeys);
  if (err == 0) err = encode_map(&tv, a.v, D, a.Skv, a.KV, a.B, a.vs, KS::kBoxW, KS::kKeys);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(bwd_dkdv_wgmma<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          int(KS::kSmemBytes));
  if (cerr != cudaSuccess) return int(cerr);
  bwd_dkdv_wgmma<D><<<dim3(unsigned(a.KV * a.split), unsigned(key_tiles), unsigned(a.B)),
                      KS::kThreads, KS::kSmemBytes, a.stream>>>(
      tq, tdo, tk, tv, lse2, delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.part, a.B, a.H, a.KV, a.Sq, a.Skv, a.Sq_pad, a.dks,
      a.dvs, a.causal, a.window, a.scale, scale_log2, a.split);
  err = int(cudaGetLastError());
  if (err == 0) err = launch_reduce<__nv_bfloat16>(a);
  if (err != 0) return err;

  // dQ pass: Q and dO in boxes of the block's rows, K and V of BN keys.
  err = encode_map(&tq, a.q, D, a.Sq, a.H, a.B, a.qs, QS::kBoxW, QS::kBM);
  if (err == 0) err = encode_map(&tdo, a.d_o, D, a.Sq, a.H, a.B, a.dos, QS::kBoxW, QS::kBM);
  if (err == 0) err = encode_map(&tk, a.k, D, a.Skv, a.KV, a.B, a.ks, QS::kBoxW, QS::kBN);
  if (err == 0) err = encode_map(&tv, a.v, D, a.Skv, a.KV, a.B, a.vs, QS::kBoxW, QS::kBN);
  if (err != 0) return err;
  cerr = cudaFuncSetAttribute(bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(QS::kSmemBytes));
  if (cerr != cudaSuccess) return int(cerr);
  bwd_dq_wgmma<D><<<dim3(unsigned(a.H), unsigned(q_tiles), unsigned(a.B)), QS::kThreads,
                    QS::kSmemBytes, a.stream>>>(
      tq, tdo, tk, tv, lse2, delta, static_cast<__nv_bfloat16*>(a.dq), a.H, a.KV, a.Sq, a.Skv,
      a.Sq_pad, a.dqs, a.causal, a.window, a.scale, scale_log2);
  return int(cudaGetLastError());
}

using BwdLaunch = int (*)(const BwdArgs&);

int run_bwd(BwdLaunch fn16, BwdLaunch fn32, BwdLaunch fn64, BwdLaunch fn128, BwdLaunch fn256,
            const BwdArgs& a) {
  const int D = a.D;
  if (a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.Sq <= 0 || a.Skv <= 0 ||
      a.split <= 0 || (a.H / a.KV) % a.split != 0 || (a.split > 1 && a.part == nullptr) ||
      a.B > 65535 || a.H > 65535 || int64_t(a.KV) * a.split > 65535)
    return int(cudaErrorInvalidValue);
  BwdLaunch fn = D == 16 ? fn16 : D == 32 ? fn32 : D == 64 ? fn64 : D == 128 ? fn128
               : D == 256 ? fn256 : nullptr;
  if (fn == nullptr) return int(cudaErrorInvalidValue);
  return fn(a);
}

}  // namespace

// q, k, v, o, d_o, dq, dk and dv share one dtype: float32 for the _f32
// entry point, bfloat16 for the _wgmma one.  lse is the forward's [B, H, Sq]
// float32 output; aux a float32 scratch of [2, B, H, Sq_pad] (Sq_pad = Sq
// rounded up to 64) and, where split > 1, part one of [2, split, B, KV, Skv,
// D]; split divides H / KV.  Strides are in elements, for the batch, head
// and sequence dimensions; the last dimension is contiguous.
#define BWD_ARGS                                                                              \
  const void *q, const void *k, const void *v, const void *o, const void *d_o,                \
      const float *lse, void *dq, void *dk, void *dv, float *aux, float *part, int B, int H,  \
      int KV, int64_t Sq, int64_t Skv, int D, int64_t qsb, int64_t qsh, int64_t qss,          \
      int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,           \
      int64_t osb, int64_t osh, int64_t oss, int64_t dosb, int64_t dosh, int64_t doss,        \
      int64_t dqsb, int64_t dqsh, int64_t dqss, int64_t dksb, int64_t dksh, int64_t dkss,     \
      int64_t dvsb, int64_t dvsh, int64_t dvss, int causal, int64_t window, float sm_scale,   \
      int split, cudaStream_t stream

static int bwd_call(BwdLaunch f16, BwdLaunch f32, BwdLaunch f64, BwdLaunch f128,
                    BwdLaunch f256, BWD_ARGS) {
  if (Sq > 2147483647LL - kRowPad || Skv > 2147483647LL || window > 2147483647LL)
    return int(cudaErrorInvalidConfiguration);
  const int sq = int(Sq);
  const BwdArgs a{q, k, v, o, d_o, lse, dq, dk, dv, aux, part, B, H, KV, sq, int(Skv), D,
                  (sq + kRowPad - 1) / kRowPad * kRowPad,
                  Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss},
                  Strides{osb, osh, oss}, Strides{dosb, dosh, doss}, Strides{dqsb, dqsh, dqss},
                  Strides{dksb, dksh, dkss}, Strides{dvsb, dvsh, dvss}, causal, int(window),
                  sm_scale, split, stream};
  return run_bwd(f16, f32, f64, f128, f256, a);
}

#define BWD_PASS                                                                              \
  q, k, v, o, d_o, lse, dq, dk, dv, aux, part, B, H, KV, Sq, Skv, D, qsb, qsh, qss, ksb, ksh, \
      kss, vsb, vsh, vss, osb, osh, oss, dosb, dosh, doss, dqsb, dqsh, dqss, dksb, dksh, dkss, \
      dvsb, dvsh, dvss, causal, window, sm_scale, split, stream

extern "C" int flash_attention_bwd_f32_launch(BWD_ARGS) {
  return bwd_call(bwd_f32<16>, bwd_f32<32>, bwd_f32<64>, bwd_f32<128>, bwd_f32<256>, BWD_PASS);
}

extern "C" int flash_attention_bwd_wgmma_launch(BWD_ARGS) {
  return bwd_call(bwd_wgmma<16>, bwd_wgmma<32>, bwd_wgmma<64>, bwd_wgmma<128>, bwd_wgmma<256>,
                  BWD_PASS);
}

extern "C" const char* flash_attention_bwd_error_string(int code) { return error_text(code); }

// The keys a block of the dK/dV pass owns (the wrapper's split reads it);
// 0 for a head_dim the kernels do not take.
extern "C" int flash_attention_bwd_keys_per_block(int wgmma, int D) {
  if (!wgmma) return D == 16 || D == 32 || D == 64 || D == 128 || D == 256 ? kFB : 0;
  return D == 16    ? KVShape<16>::kKeys
         : D == 32  ? KVShape<32>::kKeys
         : D == 64  ? KVShape<64>::kKeys
         : D == 128 ? KVShape<128>::kKeys
         : D == 256 ? KVShape<256>::kKeys
                    : 0;
}
