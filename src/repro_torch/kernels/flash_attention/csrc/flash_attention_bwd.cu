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
//     [B, H, Sq_pad] f32, Sq_pad = Sq rounded up to 128.  Rows past Sq get
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
//     blocks).  Each block writes f32 partial sums, and this launch adds
//     them in split order, scales dK and writes both in the caller's
//     layout (0.015 ms a call at recurrentgemma-2b's shape; run by the last
//     of a key tile's blocks, or by extra blocks of the dQ pass's grid, the
//     sum made the call slower).
//  4. the dQ pass: one block per query tile, head and batch row; it walks
//     the visible key tiles as the forward does, dQ in registers.
// No atomics: every sum has one order fixed by the shapes (the split too),
// so a replayed call gives the same bits, on any card.
//
// What bounds it: operations.  Five products of 2 D FLOPs per (query, key)
// pair are the least work (10 B H Sq Skv D where nothing is masked).  This
// kernel does nine: the dK/dV pass computes S and dP, and the dV and dK
// products twice (the high and low bf16 halves of P and dS, below); the dQ
// pass computes S and dP again, and dQ.  The least time is the five at 989
// TFLOP/s, over the pairs the mask leaves.
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
// bfloat16 (training): wgmma on tiles fed by TMA, as the forward.  One
// thread issues every copy; consumer warpgroups wait on "full" mbarriers and
// release stages through "empty" ones.  Register budget: ptxas compiles a
// kernel of three warpgroups (a producer beside two consumers) for 168
// registers a thread, whatever setmaxnreg grants later (a 288-thread block
// of 224 registers is refused at launch); two warpgroups alone may use 255.
//   dK/dV pass at D >= 128, 64 keys a block, per query tile of BM rows (Q,
//   dO, lse and Delta one stage of the ring; K and V of the block loaded
//   once).  The two warpgroups split the work by role:
//     warpgroup 0: S^T = K Q^T (wgmma m64nBMk16, both K-major), P^T in
//       place (masked only on a tile that the diagonal, the window's edge,
//       Skv or Sq cuts), written as bf16 high and low tiles in shared
//       memory, then dV += P^T dO (m64nDk16, both from shared memory, dO
//       the MN-major B through the descriptor's transpose bit: nothing is
//       copied transposed);
//     warpgroup 1: dP^T = V dO^T, then, with P^T from warpgroup 0's tiles,
//       dS^T = P^T (dP^T - Delta) into its own tiles, then dK += dS^T Q.
//   Each warpgroup owns all D columns of its one accumulator (at D = 256,
//   128 registers a thread), so nothing is computed twice: the first
//   version split D between the warpgroups, and each computed the whole
//   S^T and dP^T, eleven products' work where this does nine.  A tile's dV
//   (dK) product is left running while the warpgroup issues the next tile's
//   S^T (dP^T), and warpgroup 1 trails warpgroup 0 by the exponentials, so
//   one's softmax runs under the other's products.  The A operands come
//   from shared memory, not registers, so that a thread's live state is its
//   accumulator and one tile of scores.  At D = 256 even that needs more
//   than 168 registers (ptxas serialised the wgmma pipeline for want of
//   them), so the block is the two warpgroups alone, 256 threads, and the
//   first thread of warpgroup 1 issues the copies, each item's as soon as
//   both warpgroups release the stage the previous one held; at D = 128 a
//   producer warpgroup issues them (issued from a consumer thread, the
//   copies made the pass slower there).
//   dK/dV pass at D <= 64 (KVOwnShape), 128 keys a block: each warpgroup
//   owns 64 of them and computes S^T and dP^T for them, P^T and dS^T packed
//   in place into A fragments (high and low halves) in registers for dV +=
//   P^T dO and dK += dS^T Q (m64nDk16 from registers).  A tile's products
//   are short at these widths, and the role split's hand-over of P^T cost
//   more than it saved (whole calls were slower at D = 64 with it).
//   dQ pass, per key tile of 64 keys (the block's Q and dO loaded once):
//     S = Q K^T, dP = dO V^T          wgmma m64n64k16;
//     dQ += dS K                      wgmma m64nDk16, K MN-major;
//   one consumer warpgroup at D = 256 (64 rows a block), two below (128
//   rows).
// Tile shapes, stages and registers a thread (f32 accumulators):
//   D   | dK/dV: keys  BM  stages  threads  regs (accumulators, scores)    | dQ: rows  stages  regs (dQ, S+dP)
//   16  |        128   64    4      384     16, 64 (+ 64 of A fragments)  |     128     4     8, 64
//   32  |        128   64    4      384     32, 64 (+ 64)                 |     128     4     16, 64
//   64  |        128   64    4      384     64, 64 (+ 64)                 |     128     4     32, 64
//   128 |         64   64    4      384     64, 32                        |     128     4     64, 64
//   256 |         64   64    2      256     128, 32                       |      64     2     128, 64
// ptxas (chip_smoke.py's build phase prints it): the dK/dV pass takes 231
// registers a thread at D = 256 and 168 at D = 128, the dQ pass 219 and
// 168, with no spills and no serialised wgmma pipeline.
// Shared memory: K and V of the block, each stage's Q, dO, lse and Delta,
// and at D >= 128 the four A tiles, within 227 KB (226 KB at D = 256); the
// dQ pass holds Q and dO and a ring of K/V stages.  Tensor maps are 4-D (D,
// S, heads, B) with the caller's strides, so the model's [B, S, H, D] views
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

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kRowPad = 128;  // Sq_pad: Sq rounded up to this (a multiple of every BM)

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
  int keys;  // the keys a block of the dK/dV pass owns, as the caller's split assumed
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
  if (a.keys != kFB) return int(cudaErrorInvalidValue);
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

// d[64 x N] += A[64 x 16] B[16 x N], f32 += bf16 x bf16, A and B from shared
// memory, A K-major and B MN-major (the descriptor's transpose bit).
template <int N>
__device__ void wgmma_ss_tb(float* d, uint64_t a, uint64_t b);

template <> __device__ __forceinline__ void wgmma_ss_tb<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_ss_tb<256>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}

// dK/dV pass: 64 keys a block.  Warpgroup 0 computes S^T and owns dV,
// warpgroup 1 computes dP^T and owns dK.  P^T and dS^T go through shared
// memory as bf16 tiles (a high part and the bf16 of the rest), in the
// layout the TMA unit gives Q (rows of 64 columns, 128-byte swizzle): they
// are the A operands of the dV and dK products, and warpgroup 1 reads P^T
// from there.  At D = 256 the block is the two warpgroups alone, 256
// threads, so ptxas may give a thread 255 registers (beside a producer
// warpgroup it holds every thread to 168, and at D = 256 that serialised
// the wgmma pipeline), and the first thread of warpgroup 1, which trails
// warpgroup 0 by the exponentials, issues the copies.  Below D = 256 the
// accumulators fit in 168 registers and a producer warpgroup issues them
// (issued from a consumer thread, the copies made the pass slower there).
template <int D>
struct KVShape : Boxes<D> {
  static constexpr int kKeys = 64;                   // keys per block: one wgmma M
  static constexpr bool kProducerWG = D < 256;
  static constexpr int kThreads = (kProducerWG ? 3 : 2) * kWgThreads;
  static constexpr int kKVBytes = kKeys * D * 2;     // the K tile, or the V tile
  static constexpr int kRoom = kSmemLimit - 2048 - 2 * kKVBytes;
  static constexpr int stage_bytes(int bm) { return 2 * bm * D * 2 + 2 * bm * 4; }
  // Queries per tile: 128 where two stages fit beside the four A tiles.
  static constexpr int kBM = kRoom - 4 * kKeys * 128 * 2 >= 2 * stage_bytes(128) ? 128 : 64;
  static constexpr int kQBytes = kBM * D * 2;        // a Q tile, or a dO tile
  static constexpr int kRowF32 = kBM * 4;            // a tile's lse, or its Delta
  static constexpr int kStageBytes = stage_bytes(kBM);
  static constexpr int kATile = kKeys * kBM * 2;     // P^T or dS^T, high or low part
  static constexpr int kFit = (kRoom - 4 * kATile) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmemBytes = 1024 + 2 * size_t(kKVBytes) +
                                       size_t(kStages) * kStageBytes + 4 * size_t(kATile) +
                                       8 * (1 + 2 * kStages + 2);
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit, "tiles do not fit");
  static_assert(kRowPad % kBM == 0, "a query tile never crosses Sq_pad");
};

// Byte offset of (row, col) in a bf16 A tile of 64 rows: boxes of 64
// columns, 128-byte rows, 16-byte chunks swizzled by the row (as TMA's
// 128-byte swizzle and the wgmma descriptor's layout 1 place them).
__device__ __forceinline__ uint32_t a_tile_offset(int row, int col) {
  const int cb = col % 64;
  return uint32_t((col / 64) * 64 * 128 + row * 128 + ((((cb * 2) >> 4) ^ (row & 7)) << 4) +
                  ((cb * 2) & 15));
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads) : "memory");
}



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
  constexpr int BM = Sh::kBM, RB = Sh::kRowBytes, NS = Sh::kStages;
  constexpr int KEYS = Sh::kKeys, BW = Sh::kBoxW;
  extern __shared__ __align__(1024) uint8_t smem_tiles[];
  // Swizzled tiles must start on 1024 bytes.
  const uint32_t base = smem_u32(smem_tiles);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + Sh::kKVBytes;
  const uint32_t sQ = sV + Sh::kKVBytes;        // stage s at sQ + s * kQBytes
  const uint32_t sO = sQ + NS * Sh::kQBytes;    // dO
  // The A tiles: P^T high and low (warpgroup 0), dS^T high and low (1).
  const uint32_t sA = sO + NS * Sh::kQBytes;
  const uint32_t sL = sA + 4 * Sh::kATile;      // lse (base 2), kRowF32 a stage
  const uint32_t sDl = sL + NS * Sh::kRowF32;   // Delta
  // Barriers, 8 bytes each: kv_full, NS each of full and empty, p_full and
  // p_empty (P^T written by warpgroup 0; read by warpgroup 1).
  const uint32_t kv_full = sDl + NS * Sh::kRowF32;
  const uint32_t full = kv_full + 8, empty = full + 8 * NS;
  const uint32_t p_full = empty + 8 * NS, p_empty = p_full + 8;
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
      mbar_init(empty + 8 * s, 2 * 4);  // one arrival per warp
    }
    mbar_init(p_full, 4);   // warpgroup 0's warps
    mbar_init(p_empty, 4);  // warpgroup 1's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q, dO, lse and Delta of item it into its stage, once both warpgroups
  // have released the stage's previous item.
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / kWgThreads, 0);
  const bool loader = threadIdx.x == (Sh::kProducerWG ? 2 : 1) * kWgThreads;
  auto load_item = [&](int it) {
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
  };
  if constexpr (Sh::kProducerWG) {
    if (wg == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
      if (!loader) return;
    }
  }
  if (loader) {
    mbar_expect_tx(kv_full, 2 * Sh::kKVBytes);
    for (int x = 0; x < Sh::kCount; ++x) {
      tma_load(sK + x * KEYS * RB, &tk, kv_full, x * BW, kbase, kvh, b);
      tma_load(sV + x * KEYS * RB, &tv, kv_full, x * BW, kbase, kvh, b);
    }
    for (int it = 0; it < (Sh::kProducerWG ? n_items : min(NS, n_items)); ++it) load_item(it);
    if constexpr (Sh::kProducerWG) return;
  }
  if constexpr (Sh::kProducerWG)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // The block's 64 keys and all D columns of dV (warpgroup 0) or dK
  // (warpgroup 1).  A thread holds keys kr0 and kr0 + 8 of its warp's 16;
  // in each 8-column group of an accumulator the columns 2 (lane % 4) and
  // 2 (lane % 4) + 1.
  const int tid = threadIdx.x % kWgThreads;
  const int lane = tid % 32;
  const int kr0 = (tid / 32) * 16 + lane / 4;
  // The first product's A (K or V) and K-major B (Q or dO); the
  // accumulation's A tiles (P^T or dS^T) and MN-major B (dO or Q).
  const uint32_t a_first = wg == 0 ? sK : sV;
  const uint32_t b_first = wg == 0 ? sQ : sO;
  const uint32_t a_hi = sA + (2 * wg) * Sh::kATile, a_lo = a_hi + Sh::kATile;
  const uint32_t b_acc = wg == 0 ? sO : sQ;
  uint8_t* const p_hi = smem_tiles + (sA - base);
  uint8_t* const p_lo = p_hi + Sh::kATile;
  uint8_t* const w_hi = smem_tiles + (a_hi - base);
  uint8_t* const w_lo = smem_tiles + (a_lo - base);
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float sc[BM / 2];  // S^T or dP^T of the tile: 64 keys x BM queries

  mbar_wait(kv_full, 0);
  int np = 0;     // tiles computed so far: the P^T handshake's phase
  int held = -1;  // the stage whose accumulation may still be running
  for (int it = 0; it < n_items; ++it) {
    const int s = it % NS;
    const int q0 = (qt0 + it % n_qt) * BM;
    mbar_wait(full + 8 * s, (it / NS) & 1);
    const bool seen = kbase < Skv && q0 < Sq && (!causal || kbase <= q0 + BM - 1) &&
                      (window <= 0 || q0 < kbase + KEYS - 1 + window);
    if (seen) {
      // The first product over D in steps of 16, issued behind the previous
      // tile's accumulation.
      const uint64_t desc_a = opaque(make_desc(a_first, 16, 8 * RB, Sh::kLayout));
      const uint64_t desc_b =
          opaque(make_desc(b_first + s * Sh::kQBytes, 16, 8 * RB, Sh::kLayout));
      fence_regs<BM / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 16 / BW, col = kk * 16 % BW;
        wgmma_ss<BM>(sc, desc_a + ((box * KEYS * RB + 2 * col) >> 4),
                     desc_b + ((box * BM * RB + 2 * col) >> 4), 0 < kk);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();  // the first product, and the previous accumulation
    fence_regs<BM / 2>(sc);
    fence_regs<D / 2>(acc);
    if (held >= 0) release(empty + 8 * held, lane);
    held = -1;
    if (!seen) release(empty + 8 * s, lane);
    // The stage the previous item held takes the item NS - 1 on.
    if (!Sh::kProducerWG && loader && it >= 1 && it + NS - 1 < n_items) load_item(it + NS - 1);
    if (!seen) continue;
    const uint32_t phase = uint32_t(np++) & 1;
    const bool mask = (causal && kbase + KEYS - 1 > q0) ||
                      (window > 0 && kbase <= q0 + BM - 1 - window) || kbase + KEYS > Skv ||
                      q0 + BM > Sq;
    // Element e of the tile: key kr0 + 8 ((e / 2) % 2), query
    // 8 (e / 4) + 2 (lane % 4) + e % 2.
    if (wg == 0) {
      // P^T in place of S^T, into the tiles warpgroup 1 reads.
      const float* lr = lrows + s * BM;
#pragma unroll
      for (int e = 0; e < BM / 2; ++e) {
        const int key = kbase + kr0 + 8 * ((e / 2) % 2);
        const int c = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        sc[e] = exp2f(fmaf(sc[e], scale_log2, -lr[c]));
        if (mask && !visible_pair(key, q0 + c, Sq, Skv, causal, window)) sc[e] = 0.f;
      }
      mbar_wait(p_empty, phase ^ 1);  // warpgroup 1 has read the last P^T
#pragma unroll
      for (int e = 0; e < BM / 2; e += 2) {
        const uint32_t at = a_tile_offset(kr0 + 8 * ((e / 2) % 2), 8 * (e / 4) + 2 * (lane % 4));
        uint32_t hi, lo;
        pack_split(sc[e], sc[e + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(w_hi + at) = hi;
        *reinterpret_cast<uint32_t*>(w_lo + at) = lo;
      }
      release(p_full, lane);
    } else {
      // dS^T = P^T (dP^T - Delta), P^T from warpgroup 0's tiles.
      const float* dr = drows + s * BM;
      mbar_wait(p_full, phase);
#pragma unroll
      for (int e = 0; e < BM / 2; e += 2) {
        const int c = 8 * (e / 4) + 2 * (lane % 4);
        const uint32_t at = a_tile_offset(kr0 + 8 * ((e / 2) % 2), c);
        const float2 ph = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p_hi + at));
        const float2 pl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p_lo + at));
        uint32_t hi, lo;
        pack_split((ph.x + pl.x) * (sc[e] - dr[c]), (ph.y + pl.y) * (sc[e + 1] - dr[c + 1]), hi,
                   lo);
        *reinterpret_cast<uint32_t*>(w_hi + at) = hi;
        *reinterpret_cast<uint32_t*>(w_lo + at) = lo;
      }
      release(p_empty, lane);
    }
    // The tiles are read by wgmma (the async proxy): every thread's writes
    // fenced, and the warpgroup's four warps past them, before it issues.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(wg);
    // dV += P^T dO or dK += dS^T Q over the tile's queries in steps of 16,
    // the high parts then the low ones; dO or Q the MN-major B.  Left
    // running under the next tile's first product.
    {
      const uint64_t dh = opaque(make_desc(a_hi, 16, 8 * 128, 1));
      const uint64_t dl = opaque(make_desc(a_lo, 16, 8 * 128, 1));
      const uint64_t db =
          opaque(make_desc(b_acc + s * Sh::kQBytes, BM * RB, 8 * RB, Sh::kLayout));
      fence_regs<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint32_t at = ((kk * 16 / 64) * 64 * 128 + 2 * (kk * 16 % 64)) >> 4;
        wgmma_ss_tb<D>(acc, dh + at, db + ((kk * 16 * RB) >> 4));
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint32_t at = ((kk * 16 / 64) * 64 * 128 + 2 * (kk * 16 % 64)) >> 4;
        wgmma_ss_tb<D>(acc, dl + at, db + ((kk * 16 * RB) >> 4));
      }
      wgmma_commit();
    }
    held = s;
  }
  wgmma_wait<0>();
  fence_regs<D / 2>(acc);
  if (held >= 0) release(empty + 8 * held, lane);

  // dV (warpgroup 0) or scale * dK (warpgroup 1); where split > 1 the f32
  // sums go to part ([2, split, ...]: dK's, then dV's) for the reduction.
  const int64_t n = int64_t(B) * KV * Skv * D;
  __nv_bfloat16* out = wg == 0 ? dv : dk;
  const Strides os = wg == 0 ? dvs : dks;
  const float mult = wg == 0 ? 1.f : scale;
  float* pbase = part + int64_t(wg == 0 ? split + part_i : part_i) * n;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kbase + kr0 + 8 * r;
      if (key >= Skv) continue;
      const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (split == 1) {
        *reinterpret_cast<__nv_bfloat162*>(out + b * os.b + kvh * os.h + key * os.s + col) =
            __floats2bfloat162_rn(v0 * mult, v1 * mult);
      } else {
        const int64_t at = ((int64_t(b) * KV + kvh) * Skv + key) * D + col;
        *reinterpret_cast<float2*>(pbase + at) = make_float2(v0, v1);
      }
    }
  }
}

// The dK/dV pass below D = 128: each of the two consumer warpgroups owns 64
// of the block's 128 keys and computes everything for them, S^T, dP^T and
// both products, P^T and dS^T packed into A fragments in registers (high
// and low bf16 halves), beside a producer warpgroup.  There D is small and
// a tile's products short, so the role split's hand-over of P^T between
// the warpgroups costs more than it saves (slower at D = 64), and
// the accumulators (2 x D / 2 registers) fit in 168.
template <int D>
struct KVOwnShape : Boxes<D> {
  static constexpr int kKeys = 128;                  // keys per block: 64 a warpgroup
  static constexpr int kCols = D;                    // dK, dV columns per warpgroup
  static constexpr int kBM = 64;                     // queries per tile
  static constexpr int kThreads = 3 * kWgThreads;
  static constexpr int kKVBytes = kKeys * D * 2;     // the K tile, or the V tile
  static constexpr int kQBytes = kBM * D * 2;        // a Q tile, or a dO tile
  static constexpr int kRowF32 = kBM * 4;            // a tile's lse, or its Delta
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kRowF32;
  static constexpr int kFit = (kSmemLimit - 2048 - 2 * kKVBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmemBytes =
      1024 + 2 * size_t(kKVBytes) + size_t(kStages) * kStageBytes + 8 * (1 + 2 * kStages);
  static_assert(D <= 64, "the accumulators fit in 168 registers up to D = 64");
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit, "tiles do not fit");
  static_assert(kRowPad % kBM == 0, "a query tile never crosses Sq_pad");
};

template <int D>
__global__ void __launch_bounds__(KVOwnShape<D>::kThreads, 1)
bwd_dkdv_own_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
               __grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ part, int B, int H, int KV, int Sq, int Skv, int Sq_pad,
               Strides dks, Strides dvs, int causal, int window, float scale, float scale_log2,
               int split) {
  using Sh = KVOwnShape<D>;
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
    // Consumer: its own 64 keys and all D columns of their dK and dV.  A
    // thread holds keys kr0 and kr0 + 8 of its warp's 16; in each 8-column
    // group of an accumulator the columns 2 (lane % 4) and 2 (lane % 4) + 1.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % kWgThreads;
    const int lane = tid % 32;
    const int kw = 64 * wg;  // this warpgroup's keys in the block's tile
    const int k0w = kbase + kw;
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
        // Both products issued together.
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
        // 16; dO and Q are the MN-major B operands.
        {
          const uint64_t bo = opaque(make_desc(so, BM * RB, 8 * RB, Sh::kLayout));
          const uint64_t bq = opaque(make_desc(sq, BM * RB, 8 * RB, Sh::kLayout));
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
      const int col = 8 * j + 2 * (lane % 4);
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
  // D >= 128: the warpgroups split by role; below, each owns its keys.
  using KS = std::conditional_t<(D >= 128), KVShape<D>, KVOwnShape<D>>;
  constexpr auto dkdv = [] {
    if constexpr (D >= 128) return bwd_dkdv_wgmma<D>;
    else return bwd_dkdv_own_wgmma<D>;
  }();
  if (a.keys != KS::kKeys) return int(cudaErrorInvalidValue);
  const int key_tiles = (a.Skv + KS::kKeys - 1) / KS::kKeys;
  if (key_tiles > 65535 || (a.Sq + QShape<D>::kBM - 1) / QShape<D>::kBM > 65535)
    return int(cudaErrorInvalidConfiguration);
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
  cudaError_t cerr = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          int(KS::kSmemBytes));
  if (cerr != cudaSuccess) return int(cerr);
  dkdv<<<dim3(unsigned(a.KV * a.split), unsigned(key_tiles), unsigned(a.B)), KS::kThreads,
         KS::kSmemBytes, a.stream>>>(
      tq, tdo, tk, tv, lse2, delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.part, a.B, a.H, a.KV, a.Sq, a.Skv, a.Sq_pad, a.dks,
      a.dvs, a.causal, a.window, a.scale, scale_log2, a.split);
  err = int(cudaGetLastError());
  if (err == 0) err = launch_reduce<__nv_bfloat16>(a);
  if (err != 0) return err;

  // dQ pass: Q and dO in boxes of the block's rows, K and V of BN keys.
  using QS = QShape<D>;
  const int q_tiles = (a.Sq + QS::kBM - 1) / QS::kBM;
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
// rounded up to 128) and, where split > 1, part one of [2, split, B, KV, Skv,
// D]; split divides H / KV.  keys_per_block is the keys a block of the
// dK/dV pass owns, which the caller's split assumed (kernel.py's
// BACKWARD_KEYS_PER_BLOCK): a launch with another value is refused.
// Strides are in elements, for the batch, head and sequence dimensions;
// the last dimension is contiguous.
#define BWD_ARGS                                                                              \
  const void *q, const void *k, const void *v, const void *o, const void *d_o,                \
      const float *lse, void *dq, void *dk, void *dv, float *aux, float *part, int B, int H,  \
      int KV, int64_t Sq, int64_t Skv, int D, int64_t qsb, int64_t qsh, int64_t qss,          \
      int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,           \
      int64_t osb, int64_t osh, int64_t oss, int64_t dosb, int64_t dosh, int64_t doss,        \
      int64_t dqsb, int64_t dqsh, int64_t dqss, int64_t dksb, int64_t dksh, int64_t dkss,     \
      int64_t dvsb, int64_t dvsh, int64_t dvss, int causal, int64_t window, float sm_scale,   \
      int split, int keys_per_block, cudaStream_t stream

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
                  sm_scale, split, keys_per_block, stream};
  return run_bwd(f16, f32, f64, f128, f256, a);
}

#define BWD_PASS                                                                              \
  q, k, v, o, d_o, lse, dq, dk, dv, aux, part, B, H, KV, Sq, Skv, D, qsb, qsh, qss, ksb, ksh, \
      kss, vsb, vsh, vss, osb, osh, oss, dosb, dosh, doss, dqsb, dqsh, dqss, dksb, dksh, dkss, \
      dvsb, dvsh, dvss, causal, window, sm_scale, split, keys_per_block, stream

extern "C" int flash_attention_bwd_f32_launch(BWD_ARGS) {
  return bwd_call(bwd_f32<16>, bwd_f32<32>, bwd_f32<64>, bwd_f32<128>, bwd_f32<256>, BWD_PASS);
}

extern "C" int flash_attention_bwd_wgmma_launch(BWD_ARGS) {
  return bwd_call(bwd_wgmma<16>, bwd_wgmma<32>, bwd_wgmma<64>, bwd_wgmma<128>, bwd_wgmma<256>,
                  BWD_PASS);
}

extern "C" const char* flash_attention_bwd_error_string(int code) { return error_text(code); }
