// Backward of GQA attention for Hopper (sm_90a), f32 or bf16, causal or
// not, with a one-sided window and a logit softcap, on the tensor cores, in
// the standard recompute form:
//   q (B, Sq, H, Dh), k/v (B, Sk, KVH, Dh), dO (B, Sq, H, Dh), read through
//   strides (head dim contiguous), query head h reading kv head h / G with
//   G = H / KVH; o (B, Sq, H, Dh) the forward's f32 output (for bf16 inputs
//   the unrounded one, flash_attention.cu's o32) and lse (B, H, Sq) f32;
//   dq (B, Sq, H, Dh), dk/dv (B, Sk, KVH, Dh) contiguous, in the inputs'
//   dtype.  With scale = 1/sqrt(Dh), X = (q k^T) scale, S = c tanh(X / c)
//   with a softcap c (S = X without), P = exp(S - lse) (0 where a mask
//   drops key j for query row i at position pq = q_offset + i: causal
//   j > pq, window pq - j >= window), D = rowsum(dO * O):
//     dV = P^T dO,  dS = P (dO V^T - D) (1 - (S / c)^2),
//     dQ = dS K scale,  dK = dS^T Q scale
//   dK and dV of a kv head are summed over its G query heads.
//
// No Pallas kernel is replaced: the JAX package trains through XLA's
// autodiff of repro.models.layers.attention (jnp, in f32 whatever the
// inputs' dtype, rounded once at the end), so this is written for Hopper
// from the formulas, with the reference's rounding points: every product
// and sum in f32, D from the f32 output (the reference's sum of P dP;
// with the bf16 output 19% of bf16 dq and dk elements land elsewhere),
// dq/dk/dv rounded to bf16 once.  The window is the one layers.attention
// applies (pq - j < window, whether causal or not); the wrapper
// (kernels/ops.py) raises for the Pallas kernel's symmetric window and for
// ring-cache key positions (k_pos), which training never passes.  A query
// offset is a sequence split over ranks (tensor parallelism's "seq"
// attention layout): a rank's rows sit at q_offset on, against every key.
//
// Bound: at the DiT-MoE-XL shape (8, 256, 16, 72) f32 the five products
// are 6.04e9 FLOP against 75 MB, so operations bound it: 0.0366 ms at
// 3xTF32 on the tensor cores (0.090 ms on the FP32 cores).  At the LM
// training shapes in bf16 (qwen3-32b's (8, 128, 64 over 8, 128), causal)
// the bytes of q, k, v, o, dO and the gradients are of the same order as
// the work over the tensor cores' peak; chip_smoke.py 3B prints both.
// The kernels do seven products (S and dP are formed in both).  Every
// product runs as mma.sync m16n8k8 with tf32 operands (tf32_mma.cuh), with
// the forward's building blocks:
//   1. flash_bwd_dq: a block of 4 warps owns 64 queries of one (b, h);
//      each warp owns 16 of them, the m16 of the mma.  It first sums
//      D = rowsum(dO * O) for its rows from device memory and stores it
//      (the dK/dV launch reads it), then loops over the keys in tiles of
//      BT (32) on a 2-stage cp.async ring of K and V (of kv head h / G):
//      S = Q K^T and dP = dO V^T in register fragments, P and dS formed in
//      the accumulator registers, dQ += dS K with dS taken straight from
//      them as A fragments.  Causal: the key tiles whose first key lies
//      past the block's last query's position are skipped; window: the
//      key tiles that lie wholly before the block's first query's window.
//   2. flash_bwd_dkdv: the same with keys as the m rows: a block owns 64
//      keys of one (b, kv head), a warp 16, and loops over the kv head's G
//      query heads and, for each, over its queries on a ring of Q, dO, lse
//      and D (one ring across the heads, so the prefetch runs on from one
//      head to the next); S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and
//      dK += dS^T Q from the accumulator registers, which carry across the
//      heads.  Causal: the query tiles whose last query's position lies
//      before the block's first key are skipped; window: the query tiles
//      that lie wholly past the block's last key's window.
//   - The scale multiplies the S accumulators, not the q (or k) operand:
//     bf16 q and k are exact in TF32, so for bf16 inputs S and dP are one
//     TF32 pass of exact products with f32 sums, and dV, dK and dQ, whose
//     f32 P or dS operand is split 3xTF32-wise, two passes (the bf16 side
//     has no small part); f32 inputs take all three passes everywhere.
//     The softcap is applied to the scaled accumulators as the forward
//     applies it (c tanhf(X / c)), and its derivative 1 - tanh^2 multiplies
//     dS in the same registers.
//     Shared memory holds the inputs in their dtype (16-byte cp.async
//     pieces), converted to f32 as the fragments are formed.
//   - P and dS become A fragments with no shuffle and no staging through
//     the forward's trick: the 8 columns of each k-step are taken in the
//     order 0, 2, 4, 6 | 1, 3, 5, 7, which turns the C-fragment layout
//     into the A-fragment layout; the B fragments of that step read rows
//     2t and 2t + 1 (flash_attention.cu).
//   - What the card's time goes to is the split, not the mma: a
//     cvt.rna.tf32.f32 is four instructions (cuobjdump -sass), so the cvt
//     split (two cvts and a subtraction) was nine instructions a value
//     and 2.5x as many as the mmas.  The split here is tf32_mma.cuh's
//     FastFrag: the same big part by two integer instructions, the small
//     part truncated, four in all.  The two products that share the A rows
//     are interleaved (S with dP, dV with dK) and each pass goes over all
//     their accumulators before the next, so dependent mmas are 8 (S) or
//     6 to 8 (dV/dK) apart.  Shared rows are Dh padded to 8 NT plus 16
//     bytes, a compile-time stride, so fragment addresses are immediate
//     offsets and the fragment loads, rows g / columns t and rows 2t /
//     columns g alike, spread over the banks.  On an H100 SXM
//     (launch/kernel_variants.py) the XL shape took 0.28 ms with this split
//     and 0.40 ms with the cvt split; one TF32 pass, not f32-accurate,
//     would take 0.17.
//   - D is folded into the dQ launch, which reads O once more and saves a
//     third launch that would read O and dO once more and wait its turn on
//     the stream.
//   - The register tiles are sized by a template argument NT (8-wide Dh
//     tiles: 4, 8, 9, 12, 16, 20 or 32 in f32; 4, 8, 16, 20 or 32 in
//     bf16); Dh = 64 runs at NT = 8, 72 at 9, 88 at 12, 112 and 128 at 16,
//     stablelm's 160 at 20 and gemma2's 256 at 32.  The output
//     accumulators (dQ: NC x 4 floats a thread; dK and dV: 2 x NC x 4) stay
//     in registers because a block owns NC = NT (up to 16) or NT / 2 (20
//     and 32) of the Dh tiles: above 128 the grid's z splits the output's
//     columns in two halves, and each half's block forms S and dP over the
//     whole of Dh (twice the S and dP products, the ring's bytes read
//     twice) while it accumulates only its own columns.  At NT = 16 the
//     dK/dV accumulators already take 232 registers (bf16), so NT = 32
//     whole would spill.  The streamed tile is 16 rows instead of 32 where
//     the ring would not fit the 227 KB a block may use (f32 at Dh 256:
//     266 KB at 32 rows, 200 KB at 16).  chip_smoke.py 3B prints ptxas's
//     registers and spills of each instance.
//   - No atomics: every output element is summed by one thread in a fixed
//     order (a kv head's query heads in turn), so two runs agree bit for
//     bit.
//   - Keys past Sk, queries past Sq and pairs a mask drops get P = 0 and
//     dS = 0 by selection, so a NaN query row gives NaN exactly where the
//     plain version has it.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace dice {
namespace {

// Tiling.  The defaults are the port's; launch/kernel_variants.py builds
// the other values with -D and times them against these: blocks of
// DICE_FLASH_BWD_WARPS warps, streamed tiles of DICE_FLASH_BWD_TILE rows.
#ifndef DICE_FLASH_BWD_WARPS
#define DICE_FLASH_BWD_WARPS 4
#endif
#ifndef DICE_FLASH_BWD_TILE
#define DICE_FLASH_BWD_TILE 32
#endif
constexpr int WARPS = DICE_FLASH_BWD_WARPS;   // warps a block, 16 owned rows each
constexpr int BM = 16 * WARPS;          // rows a block owns
constexpr int STAGES = 2;               // ring depth
constexpr bool SPLIT_F = kSplit<float>; // P and dS: 3xTF32 (one pass with DICE_TF32_ONE_PASS)
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may use

// the 3xTF32 split: tf32_mma.cuh's FastFrag, or with -DDICE_BWD_CVT_SPLIT
// its cvt.rna Frag (launch/kernel_variants.py times the two)
#ifdef DICE_BWD_CVT_SPLIT
template <bool S, int N>
using BwdFrag = Frag<S, N>;
#else
template <bool S, int N>
using BwdFrag = FastFrag<S, N>;
#endif

struct Strides {
  long long b, s, h;
};

// shared bytes of a block: the owned rows of two tensors and a ring of two
// streamed tensors of bt rows, ld elements a row in the inputs' dtype, then
// two f32 per-row vectors (lse, D) for each stage
constexpr size_t smem_bytes(int es, int bt, int ld) {
  return (size_t)es * (2 * BM + STAGES * 2 * bt) * ld + sizeof(float) * STAGES * 2 * bt;
}

// The compile-time geometry of the head-dim class NT (8-wide Dh tiles):
//   LD  elements a shared row: Dh padded to 8 NT, plus 16 bytes; a
//       compile-time constant, so every fragment address folds into the
//       load's immediate offset
//   BT  rows of a streamed tile (DICE_FLASH_BWD_TILE, or 16 where that
//       ring would not fit), SN its 8-wide tiles of S
//   NC  Dh tiles of the output a block owns: all of them up to 16, half
//       above (the grid's z walks the halves)
template <typename T, int NT>
struct Geo {
  static constexpr int LD = 8 * NT + 16 / (int)sizeof(T);
  static constexpr int BT =
      smem_bytes(sizeof(T), DICE_FLASH_BWD_TILE, LD) <= SMEM_LIMIT ? DICE_FLASH_BWD_TILE : 16;
  static constexpr int SN = BT / 8;
  static constexpr int NC = NT > 16 ? NT / 2 : NT;
  static constexpr int SPLITS = NT / NC;
  static constexpr size_t SMEM = smem_bytes(sizeof(T), BT, LD);
  static_assert(NT % NC == 0, "the column halves split NT evenly");
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// rows x 8 NT of a (B, S, heads, Dh) tensor (positions pos0 ...) into
// shared memory, zero past S and past Dh.  vec: every row is 16-byte
// aligned, so 16-byte cp.async pieces.
template <typename T, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ss, int pos0,
                                          int rows, int S, int Dh, bool vec) {
  constexpr int dp = 8 * NT, ld = Geo<T, NT>::LD, VE = 16 / (int)sizeof(T);
  if (vec) {
    constexpr int cpr = dp / VE;
    for (int idx = threadIdx.x; idx < rows * cpr; idx += WARPS * 32) {
      const int r = idx / cpr, d0 = (idx % cpr) * VE;
      const int p = pos0 + r;
      const int n = p < S ? max(0, min(VE, Dh - d0)) : 0;
      cp_async16(dst + r * ld + d0, n > 0 ? src + p * ss + d0 : src, n * (int)sizeof(T));
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * dp; idx += WARPS * 32) {
      const int r = idx / dp, dd = idx % dp;
      const int p = pos0 + r;
      store_f32(dst + r * ld + dd, p < S && dd < Dh ? load_f32(src + p * ss + dd) : 0.0f);
    }
  }
}

// n values of a per-row (B, H, Sq) vector from pos0, zero past Sq
__device__ __forceinline__ void load_vec(float* dst, const float* src, int pos0, int n,
                                         int S) {
  for (int i = threadIdx.x; i < n; i += WARPS * 32) {
    const int p = pos0 + i;
    cp_async4(dst + i, p < S ? src + p : src, p < S ? 4 : 0);
  }
}

// acc1[j] += A1 B1^T and acc2[j] += A2 B2^T over Dh, two S-like products
// at once: A (16 x 8 at kk of this warp's rows) and B (rows j * 8 ... of a
// tile) row-major in shared memory, both of the inputs' dtype T (exact in
// TF32 for bf16: one pass).  Per k-step every fragment is formed first,
// then each pass goes over all 2 SN accumulators, so that dependent mmas
// are 2 SN apart.
template <typename T, int NT>
__device__ __forceinline__ void rows_by_rows(float (&acc1)[Geo<T, NT>::SN][4], const T* a1,
                                             const T* b1, float (&acc2)[Geo<T, NT>::SN][4],
                                             const T* a2, const T* b2, int nd) {
  constexpr int ld = Geo<T, NT>::LD, SN = Geo<T, NT>::SN;
  constexpr bool SP = kSplit<T>;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (kk < nd) {
      BwdFrag<SP, 4> af1, af2;
      const T* ap1 = a1 + g * ld + kk * 8 + t;
      const T* ap2 = a2 + g * ld + kk * 8 + t;
      af1.set(0, load_f32(ap1));
      af1.set(1, load_f32(ap1 + 8 * ld));
      af1.set(2, load_f32(ap1 + 4));
      af1.set(3, load_f32(ap1 + 8 * ld + 4));
      af2.set(0, load_f32(ap2));
      af2.set(1, load_f32(ap2 + 8 * ld));
      af2.set(2, load_f32(ap2 + 4));
      af2.set(3, load_f32(ap2 + 8 * ld + 4));
      BwdFrag<SP, 2> bf1[SN], bf2[SN];
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int o = (j * 8 + g) * ld + kk * 8 + t;
        bf1[j].set(0, load_f32(b1 + o));
        bf1[j].set(1, load_f32(b1 + o + 4));
        bf2[j].set(0, load_f32(b2 + o));
        bf2[j].set(1, load_f32(b2 + o + 4));
      }
      if constexpr (SP) {
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          mma_tf32(acc1[j], af1.small, bf1[j].big);
          mma_tf32(acc2[j], af2.small, bf2[j].big);
        }
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          mma_tf32(acc1[j], af1.big, bf1[j].small);
          mma_tf32(acc2[j], af2.big, bf2[j].small);
        }
      }
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        mma_tf32(acc1[j], af1.big, bf1[j].big);
        mma_tf32(acc2[j], af2.big, bf2[j].big);
      }
    }
  }
}

// the A fragment of k-step kk of X (16 x BT, in C-fragment registers):
// its 8 columns in the order 0, 2, 4, 6 | 1, 3, 5, 7
template <int SN>
__device__ __forceinline__ BwdFrag<SPLIT_F, 4> regs_frag(const float (&x)[SN][4], int kk) {
  BwdFrag<SPLIT_F, 4> af;
  af.set(0, x[kk][0]);
  af.set(1, x[kk][2]);
  af.set(2, x[kk][1]);
  af.set(3, x[kk][3]);
  return af;
}

// acc1[n] += X1 Y1 (and, with TWO, acc2[n] += X2 Y2): X (16 x BT, f32) in
// C-fragment registers, Y (BT x 8 NC, of dtype T) row-major in shared
// memory from this block's first output column on; dV/dK/dQ-like products
// over a tile's rows.  ndc: the Dh tiles from that column on.  The B
// fragments of k-step kk read rows kk * 8 + 2t and 2t + 1, the order of
// regs_frag's columns.  Dh tiles go in chunks of CH: a chunk's fragments
// are formed first, then the passes go over its accumulators, dependent
// mmas CH (2 CH) apart.  Passes: X small x Y big, X big x Y small (f32 Y
// only), X big x Y big.
template <typename T, int NT, int CH, bool TWO>
__device__ __forceinline__ void regs_by_rows(float (&acc1)[Geo<T, NT>::NC][4],
                                             const float (&x1)[Geo<T, NT>::SN][4], const T* y1,
                                             float (&acc2)[Geo<T, NT>::NC][4],
                                             const float (&x2)[Geo<T, NT>::SN][4], const T* y2,
                                             int ndc) {
  constexpr int ld = Geo<T, NT>::LD, SN = Geo<T, NT>::SN, NC = Geo<T, NT>::NC;
  constexpr bool SB = kSplit<T>;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < SN; ++kk) {
    const BwdFrag<SPLIT_F, 4> af1 = regs_frag<SN>(x1, kk);
    BwdFrag<SPLIT_F, 4> af2;
    if constexpr (TWO) af2 = regs_frag<SN>(x2, kk);
    const int row = (kk * 8 + 2 * t) * ld + g;
#pragma unroll
    for (int n0 = 0; n0 < NC; n0 += CH) {
      BwdFrag<SB, 2> bf1[CH], bf2[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int n = n0 + c;
        if (n < NC && n < ndc) {
          bf1[c].set(0, load_f32(y1 + row + n * 8));
          bf1[c].set(1, load_f32(y1 + row + ld + n * 8));
          if constexpr (TWO) {
            bf2[c].set(0, load_f32(y2 + row + n * 8));
            bf2[c].set(1, load_f32(y2 + row + ld + n * 8));
          }
        }
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        if ((pass == 0 && !SPLIT_F) || (pass == 1 && !SB)) continue;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int n = n0 + c;
          if (n < NC && n < ndc) {
            const uint32_t(&a1)[4] = pass == 0 ? af1.small : af1.big;
            const uint32_t(&b1)[2] = pass == 1 ? bf1[c].small : bf1[c].big;
            mma_tf32(acc1[n], a1, b1);
            if constexpr (TWO) {
              const uint32_t(&a2)[4] = pass == 0 ? af2.small : af2.big;
              const uint32_t(&b2)[2] = pass == 1 ? bf2[c].small : bf2[c].big;
              mma_tf32(acc2[n], a2, b2);
            }
          }
        }
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

// dst (B, S, heads, Dh) contiguous rows row0 + g (+ 8) of this warp's
// accumulators (Dh tiles c0 ... c0 + NC - 1), times mul, rounded once to
// T, up to S and Dh
template <typename T, int NC>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[NC][4], int b, int hh,
                                           int row0, int S, int heads, int Dh, int c0,
                                           float mul) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = row0 + g + half * 8;
    if (p >= S) continue;
    T* base = dst + (((size_t)b * S + p) * heads + hh) * Dh;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int dd = (c0 + n) * 8 + 2 * t + c;
        if (dd < Dh) store_f32(base + dd, acc[n][2 * half + c] * mul);
      }
  }
}

struct Dims {
  int Sq, Sk, H, KVH, Dh, causal, aligned;   // aligned bit 0: q, 1: k, 2: v, 3: dO rows
  int qoff;                                  // position of query row 0
  int has_window, window;                    // keep pq - pk < window
  int has_softcap;
  float softcap;
};

// (P, dS) of one (query row i, key pk) pair from its unscaled logit x and
// its dP: P = exp(S - lse) with S the scaled (MASKS: and capped) logit, dS =
// P (dP - D) (MASKS: times 1 - (S / c)^2); both 0 where a mask drops the
// pair or past Sq / Sk.  Row i sits at position pq = qoff + i.  MASKS is
// a compile-time switch: the window and softcap tests and the cap's tanhf
// are not in the other instance's code
// (with them its registers rose from 164 to 181 at NT 8, bf16, a block
// fewer on each SM, and the seamless encoder's backward took 33.4 ms
// against 26.2)
template <bool MASKS>
__device__ __forceinline__ float2 p_ds(Dims dm, int i, int pk, float x, float dp,
                                       float lse, float d, float scale) {
  const int pq = dm.qoff + i;
  bool in = i < dm.Sq && pk < dm.Sk && (!dm.causal || pq >= pk);
  x *= scale;
  float cap = 1.0f;
  if constexpr (MASKS) {
    in = in && (!dm.has_window || pq - pk < dm.window);
    if (dm.has_softcap) {
      const float th = tanhf(x / dm.softcap);
      x = dm.softcap * th;
      cap = 1.0f - th * th;
    }
  }
  const float p = in ? expf(x - lse) : 0.0f;
  if constexpr (MASKS) return make_float2(p, in ? p * (dp - d) * cap : 0.0f);
  return make_float2(p, in ? p * (dp - d) : 0.0f);
}

template <typename T, int NT, bool MASKS>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ o,
                    const T* __restrict__ dO, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, Dims dm, Strides qs,
                    Strides ks, Strides vs, Strides os, Strides dos, float scale) {
  using Gm = Geo<T, NT>;
  constexpr int ld = Gm::LD, BT = Gm::BT, SN = Gm::SN, NC = Gm::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Sq = dm.Sq, Sk = dm.Sk, H = dm.H, Dh = dm.Dh;
  const int nd = (Dh + 7) / 8;
  const int c0 = blockIdx.z * NC;       // this block's first Dh tile of dQ
  T* Qs = reinterpret_cast<T*>(smem);   // BM x ld
  T* dOs = Qs + BM * ld;
  T* ring = dOs + BM * ld;              // STAGES x {K, V}, BT x ld each
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int kvh = hh / (H / dm.KVH);
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  // key tiles kt0 .. kt1 - 1.  Causal: tiles whose first key lies past the
  // block's last query's position hold no kept pair; window: nor do tiles
  // that end before the block's first query's first visible key,
  // qoff + q0 - window + 1
  int kt1 = (Sk + BT - 1) / BT;
  if (dm.causal)
    kt1 = (int)min((long long)kt1, ((long long)dm.qoff + min(q0 + BM, Sq) - 1) / BT + 1);
  int kt0 = 0;
  if (MASKS && dm.has_window) {
    const long long first = (long long)dm.qoff + q0 - dm.window + 1;
    if (first > 0) kt0 = (int)min(first / BT, (long long)kt1);
  }
  const int ntiles = kt1 - kt0;
  auto load_stage = [&](int stage, int kt) {
    T* st = ring + stage * 2 * BT * ld;
    load_rows<T, NT>(st, kb, ks.s, kt * BT, BT, Sk, Dh, dm.aligned & 2);
    load_rows<T, NT>(st + BT * ld, vb, vs.s, kt * BT, BT, Sk, Dh, dm.aligned & 4);
  };
  load_rows<T, NT>(Qs, q + b * qs.b + hh * qs.h, qs.s, q0, BM, Sq, Dh, dm.aligned & 1);
  load_rows<T, NT>(dOs, dO + b * dos.b + hh * dos.h, dos.s, q0, BM, Sq, Dh, dm.aligned & 8);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, kt0 + s);
    cp_async_commit();
  }

  // D for this warp's 16 rows, from device memory while the tiles land:
  // lanes 2r and 2r + 1 sum the even and odd dims of row r (each column
  // half's block sums the same D; the first stores it)
  const int row0 = q0 + warp * 16;
  float dl[2], ls[2] = {0.0f, 0.0f};
  {
    const int p = row0 + lane / 2;
    float sum = 0.0f;
    if (p < Sq) {
      const float* orow = o + b * os.b + p * os.s + hh * os.h;
      const T* drow = dO + b * dos.b + p * dos.s + hh * dos.h;
#pragma unroll 4
      for (int dd = lane & 1; dd < Dh; dd += 2) sum += orow[dd] * load_f32(drow + dd);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (blockIdx.z == 0 && p < Sq && (lane & 1) == 0) delta[(size_t)bh * Sq + p] = sum;
    dl[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = row0 + g + half * 8;
    if (p < Sq) ls[half] = lse[(size_t)bh * Sq + p];
  }

  float acc[NC][4];
  zero(acc);
  const T* qa = Qs + warp * 16 * ld;
  const T* da = dOs + warp * 16 * ld;
  for (int i = 0; i < ntiles; ++i) {
    const int kt = kt0 + i;
    cp_async_wait<STAGES - 2>();
    __syncthreads();                    // tile i landed; tile i - 1 consumed
    {
      const int ni = i + STAGES - 1;
      if (ni < ntiles) load_stage(ni % STAGES, kt0 + ni);
      cp_async_commit();
    }
    const T* Kt = ring + (i % STAGES) * 2 * BT * ld;
    const T* Vt = Kt + BT * ld;
    float s[SN][4], dpv[SN][4];
    zero(s);
    zero(dpv);
    rows_by_rows<T, NT>(s, qa, Kt, dpv, da, Vt, nd);
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pq = row0 + g + (e >> 1) * 8;
        const int pk = kt * BT + j * 8 + 2 * t + (e & 1);
        s[j][e] =
            p_ds<MASKS>(dm, pq, pk, s[j][e], dpv[j][e], ls[e >> 1], dl[e >> 1], scale).y;
      }
    regs_by_rows<T, NT, (NC < 8 ? NC : 8), false>(acc, s, Kt + c0 * 8, acc, s, Kt + c0 * 8,
                                                  nd - c0);
  }
  store_rows<T, NC>(dq, acc, b, hh, row0, Sq, H, Dh, c0, scale);
}

template <typename T, int NT, bool MASKS>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, Dims dm, Strides qs, Strides ks,
                      Strides vs, Strides dos, float scale) {
  using Gm = Geo<T, NT>;
  constexpr int ld = Gm::LD, BT = Gm::BT, SN = Gm::SN, NC = Gm::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Sq = dm.Sq, Sk = dm.Sk, H = dm.H, KVH = dm.KVH, Dh = dm.Dh;
  const int nd = (Dh + 7) / 8;
  const int c0 = blockIdx.z * NC;       // this block's first Dh tile of dK and dV
  T* Ks = reinterpret_cast<T*>(smem);   // BM x ld
  T* Vs = Ks + BM * ld;
  T* ring = Vs + BM * ld;               // STAGES x {Q, dO}, BT x ld each
  float* vecs = reinterpret_cast<float*>(ring + STAGES * 2 * BT * ld);  // STAGES x {lse, D}
  const int bk = blockIdx.y, b = bk / KVH, kvh = bk % KVH, G = H / KVH;
  const int k0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // query tiles qt0 .. qt1 - 1.  Causal: tiles whose last query's
  // position lies before the block's first key hold no kept pair; window:
  // nor do tiles that start past the block's last key's last visible
  // query, k_last + window - 1 - qoff.  The same tiles for each of the G
  // query heads, walked as one sequence i = head * nqt + tile
  const int nq_all = (Sq + BT - 1) / BT;
  const int qt0 = dm.causal ? min(max(k0 - dm.qoff, 0) / BT, nq_all) : 0;
  int qt1 = nq_all;
  if (MASKS && dm.has_window) {
    const long long last =
        (long long)min(k0 + BM, Sk) - 1 + dm.window - 1 - dm.qoff;
    qt1 = last < 0 ? 0 : (int)min(last / BT + 1, (long long)nq_all);
  }
  const int nqt = max(0, qt1 - qt0);
  const int ntiles = G * nqt;
  auto load_stage = [&](int stage, int i) {
    const int hh = kvh * G + i / nqt, qt = qt0 + i % nqt;
    const size_t bh = (size_t)b * H + hh;
    T* st = ring + stage * 2 * BT * ld;
    load_rows<T, NT>(st, q + b * qs.b + hh * qs.h, qs.s, qt * BT, BT, Sq, Dh, dm.aligned & 1);
    load_rows<T, NT>(st + BT * ld, dO + b * dos.b + hh * dos.h, dos.s, qt * BT, BT, Sq, Dh,
                     dm.aligned & 8);
    load_vec(vecs + stage * 2 * BT, lse + bh * Sq, qt * BT, BT, Sq);
    load_vec(vecs + stage * 2 * BT + BT, delta + bh * Sq, qt * BT, BT, Sq);
  };
  load_rows<T, NT>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, BM, Sk, Dh, dm.aligned & 2);
  load_rows<T, NT>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, BM, Sk, Dh, dm.aligned & 4);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }

  float adk[NC][4], adv[NC][4];
  zero(adk);
  zero(adv);
  const int row0 = k0 + warp * 16;
  const T* ka = Ks + warp * 16 * ld;
  const T* va = Vs + warp * 16 * ld;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                    // tile i landed; tile i - 1 consumed
    {
      const int ni = i + STAGES - 1;
      if (ni < ntiles) load_stage(ni % STAGES, ni);
      cp_async_commit();
    }
    const int qt = qt0 + i % nqt;
    const T* Qt = ring + (i % STAGES) * 2 * BT * ld;
    const T* dOt = Qt + BT * ld;
    const float* lse_s = vecs + (i % STAGES) * 2 * BT;
    const float* del_s = lse_s + BT;
    // S^T = K Q^T and dP^T = V dO^T: keys x queries
    float st[SN][4], dpt[SN][4];
    zero(st);
    zero(dpt);
    rows_by_rows<T, NT>(st, ka, Qt, dpt, va, dOt, nd);
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pk = row0 + g + (e >> 1) * 8;
        const int jq = j * 8 + 2 * t + (e & 1);
        const float2 pd = p_ds<MASKS>(dm, qt * BT + jq, pk, st[j][e], dpt[j][e], lse_s[jq],
                                      del_s[jq], scale);
        st[j][e] = pd.x;                // P^T
        dpt[j][e] = pd.y;               // dS^T
      }
    constexpr int CH = NC % 4 == 0 ? 4 : (NC % 5 == 0 ? 5 : 3);
    regs_by_rows<T, NT, CH, true>(adv, st, dOt + c0 * 8, adk, dpt, Qt + c0 * 8, nd - c0);
  }
  store_rows<T, NC>(dk, adk, b, kvh, row0, Sk, KVH, Dh, c0, scale);
  store_rows<T, NC>(dv, adv, b, kvh, row0, Sk, KVH, Dh, c0, 1.0f);
}

template <typename T, int NT, bool MASKS>
cudaError_t launch_nt(const void* q, const void* k, const void* v, const float* o,
                      const float* lse, const void* dO, float* delta, void* dq, void* dk,
                      void* dv, int B, Dims dm, Strides qs, Strides ks, Strides vs, Strides os,
                      Strides dos, cudaStream_t stream) {
  using Gm = Geo<T, NT>;
  const size_t smem = Gm::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, NT, MASKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, NT, MASKS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long es = sizeof(T);
  auto vec = [&](const void* p, Strides st) {
    return int(rows_16b_aligned(p, st.b * es) && st.s * es % 16 == 0 && st.h * es % 16 == 0);
  };
  dm.aligned = vec(q, qs) | vec(k, ks) << 1 | vec(v, vs) << 2 | vec(dO, dos) << 3;
  const float scale = (float)(1.0 / sqrt((double)dm.Dh));
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  // dQ first: it stores D, which the dK/dV launch reads
  flash_bwd_dq_kernel<T, NT, MASKS>
      <<<dim3((dm.Sq + BM - 1) / BM, B * dm.H, Gm::SPLITS), WARPS * 32, smem, stream>>>(
          in(q), in(k), in(v), o, in(dO), lse, delta, out(dq), dm, qs, ks, vs, os, dos, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, NT, MASKS>
      <<<dim3((dm.Sk + BM - 1) / BM, B * dm.KVH, Gm::SPLITS), WARPS * 32, smem, stream>>>(
          in(q), in(k), in(v), in(dO), lse, delta, out(dk), out(dv), dm, qs, ks, vs, dos,
          scale);
  return cudaGetLastError();
}

template <typename T, bool MASKS>
cudaError_t launch(const void* q, const void* k, const void* v, const float* o,
                   const float* lse, const void* dO, float* delta, void* dq, void* dk, void* dv,
                   int B, Dims dm, Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
                   cudaStream_t stream) {
  auto run = [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return launch_nt<T, NT, MASKS>(q, k, v, o, lse, dO, delta, dq, dk, dv, B, dm, qs, ks, vs,
                                   os, dos, stream);
  };
  const int nd = (dm.Dh + 7) / 8;
  if (nd <= 4) return run(std::integral_constant<int, 4>{});
  if (nd <= 8) return run(std::integral_constant<int, 8>{});
  if constexpr (std::is_same<T, float>::value) {   // the DiT's Dh 72 and 88
    if (nd <= 9) return run(std::integral_constant<int, 9>{});
    if (nd <= 12) return run(std::integral_constant<int, 12>{});
  }
  if (nd <= 16) return run(std::integral_constant<int, 16>{});
  if (nd <= 20) return run(std::integral_constant<int, 20>{});   // stablelm's Dh 160
  return run(std::integral_constant<int, 32>{});                 // gemma2's Dh 256
}

// The C entry points' body (flash_attention_bwd.cu without the masks,
// flash_attention_bwd_masked.cu with them).
template <bool MASKS>
int run_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
            const void* dO, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
            int H, int KVH, int Dh, long long q_sb, long long q_ss, long long q_sh,
            long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
            long long v_sh, long long o_sb, long long o_ss, long long o_sh, long long do_sb,
            long long do_ss, long long do_sh, int causal, int q_offset, int has_window,
            int window, int has_softcap, float softcap, int dtype, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KVH <= 0 || H % KVH || Dh <= 0 || Dh > 256 || q_offset < 0 ||
      (has_window && (!MASKS || window < 0)) ||
      (has_softcap && (!MASKS || !(softcap > 0.0f))))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaGetLastError();
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh};
  const Dims dm{Sq, Sk, H, KVH, Dh, causal != 0, 0, q_offset, has_window != 0, window,
                has_softcap != 0, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* of = static_cast<const float*>(o);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  if (dtype == kF32)
    err = launch<float, MASKS>(q, k, v, of, lf, dO, df, dq, dk, dv, B, dm, qs, ks, vs, os,
                               dos, s);
  else
    err = launch<__nv_bfloat16, MASKS>(q, k, v, of, lf, dO, df, dq, dk, dv, B, dm, qs, ks, vs,
                                       os, dos, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dice
