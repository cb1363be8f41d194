// Backward of unmasked attention for Hopper (sm_90a), f32, on the tensor
// cores, in the standard recompute form:
//   q (B, Sq, H, Dh), k/v (B, Sk, H, Dh), o and dO (B, Sq, H, Dh), read
//   through strides (head dim contiguous); lse (B, H, Sq) f32 from the
//   forward kernel (flash_attention.cu); dq/dk/dv contiguous f32.
//   scale = 1/sqrt(Dh),  P = exp(S - lse) with S = (q scale) k,
//   D = rowsum(dO * O),  dV = P^T dO,  dS = P (dO V^T - D),
//   dQ = dS K scale,  dK = dS^T Q scale
//
// No Pallas kernel is replaced: the JAX package trains through XLA's
// autodiff of repro.kernels.ref, so this is written for Hopper from the
// formulas.  The DiT needs no mask, no softcap and H == KVH; the wrapper
// (kernels/ops.py) raises for the rest, and for bf16 and Dh > 128.
//
// Bound: at the DiT-MoE-XL shape (8, 256, 16, 72) the five products are
// 6.04e9 FLOP against 75 MB of q/k/v/o/dO/dq/dk/dv, so operations bound
// it: 0.0366 ms at 3xTF32 on the tensor cores (0.090 ms on the FP32
// cores).  The kernels do seven products (S and dP are formed in both).
// Every product runs as 3xTF32 mma.sync m16n8k8 (tf32_mma.cuh), with the
// forward's building blocks:
//   1. flash_bwd_dq: a block of 4 warps owns 64 queries of one (b, h);
//      each warp owns 16 of them, the m16 of the mma.  It first sums
//      D = rowsum(dO * O) for its rows from device memory and stores it
//      (the dK/dV launch reads it), then loops over the keys in tiles of
//      32 on a 2-stage cp.async ring of K and V: S = (Q scale) K^T and
//      dP = dO V^T in register fragments, P and dS formed in the
//      accumulator registers, dQ += dS K with dS taken straight from them
//      as A fragments.
//   2. flash_bwd_dkdv: the same with keys as the m rows: a warp owns 16
//      keys, the block loops over the queries on a ring of Q, dO, lse and
//      D; S^T = (K scale) Q^T, dP^T = V dO^T, then dV += P^T dO and
//      dK += dS^T Q from the accumulator registers.
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
//     are interleaved (S with dP, dV with dK) and each 3xTF32 pass goes
//     over all their accumulators before the next, so dependent mmas are 8
//     (S) or 6 to 8 (dV/dK) apart.  Shared rows are Dh padded to 8 NT plus
//     4 floats, a compile-time stride, so fragment addresses are immediate
//     offsets; at NT = 9 that row is 76 floats and every fragment load,
//     rows g / columns t and rows 2t / columns g alike, hits 32 banks.
//     On an H100 SXM (launch/kernel_variants.py) the XL shape takes
//     0.28 ms with this split and 0.40 ms with the cvt split; one TF32
//     pass, not f32-accurate, would take 0.17.
//   - D is folded into the dQ launch, which reads O once more (4.7 MB at
//     XL, about 2 us of device memory time) and saves a third launch that
//     would read O and dO once more and wait its turn on the stream.
//   - The register tiles are sized by a template argument NT (8-wide Dh
//     tiles: 4, 8, 9, 12 or 16), so the dK and dV accumulators (2 x NT x
//     4 floats a thread) never spill; Dh = 72 runs at NT = 9, 88 at 12.
//     At NT = 9 dK/dV takes 224 registers and dQ 198 (-Xptxas -v), and a
//     block 78 KB of shared memory: two blocks, 8 warps, an SM, and the
//     XL shape's 512 blocks of each kernel run in two waves.
//   - No atomics: every output element is summed by one thread in a fixed
//     order, so two runs agree bit for bit.
//   - Keys past Sk and queries past Sq get P = 0 and dS = 0 by selection,
//     so a NaN query row gives NaN exactly where the plain version has it.
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
constexpr int BT = DICE_FLASH_BWD_TILE; // rows of a streamed tile
constexpr int SN = BT / 8;              // 8-wide tiles of S across a tile
constexpr int STAGES = 2;               // ring depth
constexpr bool SPLIT = kSplit<float>;   // 3xTF32 (one pass with DICE_TF32_ONE_PASS)

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

// floats a shared row: Dh padded to the head-dim class's 8 NT, plus 16
// bytes; a compile-time constant, so every fragment address folds into
// the load's immediate offset
template <int NT>
constexpr int LD = 8 * NT + 4;

// shared floats: the owned rows of two tensors, a ring of two streamed
// tensors and two per-row vectors (lse, D) for each stage
template <int NT>
constexpr size_t SMEM_FLOATS = (size_t)(2 * BM + STAGES * 2 * BT) * LD<NT> + STAGES * 2 * BT;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// rows x 8 NT of a (B, S, H, Dh) tensor (positions pos0 ...) into shared
// memory, zero past S and past Dh.  vec: every row is 16-byte aligned.
template <int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ss,
                                          int pos0, int rows, int S, int Dh, bool vec) {
  constexpr int dp = 8 * NT, ld = LD<NT>;
  if (vec) {
    constexpr int cpr = dp / 4;
    for (int idx = threadIdx.x; idx < rows * cpr; idx += WARPS * 32) {
      const int r = idx / cpr, d0 = (idx % cpr) * 4;
      const int p = pos0 + r;
      const int n = p < S ? max(0, min(4, Dh - d0)) : 0;
      cp_async16(dst + r * ld + d0, n > 0 ? src + p * ss + d0 : src, n * 4);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * dp; idx += WARPS * 32) {
      const int r = idx / dp, dd = idx % dp;
      const int p = pos0 + r;
      dst[r * ld + dd] = p < S && dd < Dh ? src[p * ss + dd] : 0.0f;
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

// acc1[j] += (A1 s1) B1^T and acc2[j] += A2 B2^T over Dh, two S-like
// products at once: A (16 x 8 at kk of this warp's rows) and B (rows j * 8
// ... of a tile) row-major in shared memory.  Per k-step every fragment is
// split first, then each of the three 3xTF32 passes goes over all 2 SN
// accumulators, so that dependent mmas are 2 SN apart.
template <int NT>
__device__ __forceinline__ void rows_by_rows(float (&acc1)[SN][4], const float* a1,
                                             const float* b1, float s1, float (&acc2)[SN][4],
                                             const float* a2, const float* b2, int nd) {
  constexpr int ld = LD<NT>;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (kk < nd) {
      BwdFrag<SPLIT, 4> af1, af2;
      const float* ap1 = a1 + g * ld + kk * 8 + t;
      const float* ap2 = a2 + g * ld + kk * 8 + t;
      af1.set(0, ap1[0] * s1);
      af1.set(1, ap1[8 * ld] * s1);
      af1.set(2, ap1[4] * s1);
      af1.set(3, ap1[8 * ld + 4] * s1);
      af2.set(0, ap2[0]);
      af2.set(1, ap2[8 * ld]);
      af2.set(2, ap2[4]);
      af2.set(3, ap2[8 * ld + 4]);
      BwdFrag<SPLIT, 2> bf1[SN], bf2[SN];
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int o = (j * 8 + g) * ld + kk * 8 + t;
        bf1[j].set(0, b1[o]);
        bf1[j].set(1, b1[o + 4]);
        bf2[j].set(0, b2[o]);
        bf2[j].set(1, b2[o + 4]);
      }
      if constexpr (SPLIT) {
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
__device__ __forceinline__ BwdFrag<SPLIT, 4> regs_frag(const float (&x)[SN][4], int kk) {
  BwdFrag<SPLIT, 4> af;
  af.set(0, x[kk][0]);
  af.set(1, x[kk][2]);
  af.set(2, x[kk][1]);
  af.set(3, x[kk][3]);
  return af;
}

// acc1[n] += X1 Y1 (and, with TWO, acc2[n] += X2 Y2): X (16 x BT) in
// C-fragment registers, Y (BT x Dh) row-major in shared memory; dV/dK/dQ-
// like products over a tile's rows.  The B fragments of k-step kk read
// rows kk * 8 + 2t and 2t + 1, the order of regs_frag's columns.  Dh
// tiles go in chunks of CH: a chunk's fragments are split first, then the
// three passes go over its accumulators, dependent mmas CH (2 CH) apart.
template <int NT, int CH, bool TWO>
__device__ __forceinline__ void regs_by_rows(float (&acc1)[NT][4], const float (&x1)[SN][4],
                                             const float* y1, float (&acc2)[NT][4],
                                             const float (&x2)[SN][4], const float* y2,
                                             int nd) {
  constexpr int ld = LD<NT>;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < SN; ++kk) {
    const BwdFrag<SPLIT, 4> af1 = regs_frag(x1, kk);
    BwdFrag<SPLIT, 4> af2;
    if constexpr (TWO) af2 = regs_frag(x2, kk);
    const int row = (kk * 8 + 2 * t) * ld + g;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += CH) {
      BwdFrag<SPLIT, 2> bf1[CH], bf2[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int n = n0 + c;
        if (n < NT && n < nd) {
          bf1[c].set(0, y1[row + n * 8]);
          bf1[c].set(1, y1[row + ld + n * 8]);
          if constexpr (TWO) {
            bf2[c].set(0, y2[row + n * 8]);
            bf2[c].set(1, y2[row + ld + n * 8]);
          }
        }
      }
#pragma unroll
      for (int pass = SPLIT ? 0 : 2; pass < 3; ++pass)
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int n = n0 + c;
          if (n < NT && n < nd) {
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

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

// dst (B, S, H, Dh) contiguous rows row0 + g (+ 8) of this warp's
// accumulators, times mul, up to S and Dh
template <int NT>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[NT][4], int b,
                                           int hh, int row0, int S, int H, int Dh, float mul) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = row0 + g + half * 8;
    if (p >= S) continue;
    float* base = dst + (((size_t)b * S + p) * H + hh) * Dh;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int dd = n * 8 + 2 * t + c;
        if (dd < Dh) base[dd] = acc[n][2 * half + c] * mul;
      }
  }
}

// bit 0: q, 1: k, 2: v, 3: dO have 16-byte aligned rows
template <int NT>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dO, const float* __restrict__ lse,
                    float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk, int H,
                    int Dh, Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
                    float scale, int aligned) {
  extern __shared__ __align__(16) float sm[];
  constexpr int ld = LD<NT>;
  const int nd = (Dh + 7) / 8;
  float* Qs = sm;                       // BM x ld
  float* dOs = Qs + BM * ld;
  float* ring = dOs + BM * ld;          // STAGES x {K, V}, BT x ld each
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + b * ks.b + hh * ks.h;
  const float* vb = v + b * vs.b + hh * vs.h;
  const int ntiles = (Sk + BT - 1) / BT;
  auto load_stage = [&](int stage, int kt) {
    float* st = ring + stage * 2 * BT * ld;
    load_rows<NT>(st, kb, ks.s, kt * BT, BT, Sk, Dh, aligned & 2);
    load_rows<NT>(st + BT * ld, vb, vs.s, kt * BT, BT, Sk, Dh, aligned & 4);
  };
  load_rows<NT>(Qs, q + b * qs.b + hh * qs.h, qs.s, q0, BM, Sq, Dh, aligned & 1);
  load_rows<NT>(dOs, dO + b * dos.b + hh * dos.h, dos.s, q0, BM, Sq, Dh, aligned & 8);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }

  // D for this warp's 16 rows, from device memory while the tiles land:
  // lanes 2r and 2r + 1 sum the even and odd dims of row r
  const int row0 = q0 + warp * 16;
  float dl[2], ls[2] = {0.0f, 0.0f};
  {
    const int p = row0 + lane / 2;
    float sum = 0.0f;
    if (p < Sq) {
      const float* orow = o + b * os.b + p * os.s + hh * os.h;
      const float* drow = dO + b * dos.b + p * dos.s + hh * dos.h;
#pragma unroll 4
      for (int dd = lane & 1; dd < Dh; dd += 2) sum += orow[dd] * drow[dd];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (p < Sq && (lane & 1) == 0) delta[(size_t)bh * Sq + p] = sum;
    dl[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = row0 + g + half * 8;
    if (p < Sq) ls[half] = lse[(size_t)bh * Sq + p];
  }

  float acc[NT][4];
  zero(acc);
  const float* qa = Qs + warp * 16 * ld;
  const float* da = dOs + warp * 16 * ld;
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                    // tile kt landed; tile kt - 1 consumed
    {
      const int nk = kt + STAGES - 1;
      if (nk < ntiles) load_stage(nk % STAGES, nk);
      cp_async_commit();
    }
    const float* Kt = ring + (kt % STAGES) * 2 * BT * ld;
    const float* Vt = Kt + BT * ld;
    float s[SN][4], dpv[SN][4];
    zero(s);
    zero(dpv);
    rows_by_rows<NT>(s, qa, Kt, scale, dpv, da, Vt, nd);
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pq = row0 + g + (e >> 1) * 8;
        const int pk = kt * BT + j * 8 + 2 * t + (e & 1);
        const bool in = pq < Sq && pk < Sk;
        const float p = in ? expf(s[j][e] - ls[e >> 1]) : 0.0f;
        s[j][e] = in ? p * (dpv[j][e] - dl[e >> 1]) : 0.0f;    // dS
      }
    regs_by_rows<NT, (NT < 8 ? NT : 8), false>(acc, s, Kt, acc, s, Kt, nd);
  }
  store_rows<NT>(dq, acc, b, hh, row0, Sq, H, Dh, scale);
}

template <int NT>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                      int Dh, Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                      int aligned) {
  extern __shared__ __align__(16) float sm[];
  constexpr int ld = LD<NT>;
  const int nd = (Dh + 7) / 8;
  float* Ks = sm;                       // BM x ld
  float* Vs = Ks + BM * ld;
  float* ring = Vs + BM * ld;           // STAGES x {Q, dO}, BT x ld each
  float* vecs = ring + STAGES * 2 * BT * ld;   // STAGES x {lse, D}, BT each
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int k0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + b * qs.b + hh * qs.h;
  const float* dob = dO + b * dos.b + hh * dos.h;
  const float* lseb = lse + (size_t)bh * Sq;
  const float* delb = delta + (size_t)bh * Sq;
  const int ntiles = (Sq + BT - 1) / BT;
  auto load_stage = [&](int stage, int qt) {
    float* st = ring + stage * 2 * BT * ld;
    load_rows<NT>(st, qb, qs.s, qt * BT, BT, Sq, Dh, aligned & 1);
    load_rows<NT>(st + BT * ld, dob, dos.s, qt * BT, BT, Sq, Dh, aligned & 8);
    load_vec(vecs + stage * 2 * BT, lseb, qt * BT, BT, Sq);
    load_vec(vecs + stage * 2 * BT + BT, delb, qt * BT, BT, Sq);
  };
  load_rows<NT>(Ks, k + b * ks.b + hh * ks.h, ks.s, k0, BM, Sk, Dh, aligned & 2);
  load_rows<NT>(Vs, v + b * vs.b + hh * vs.h, vs.s, k0, BM, Sk, Dh, aligned & 4);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }

  float adk[NT][4], adv[NT][4];
  zero(adk);
  zero(adv);
  const int row0 = k0 + warp * 16;
  const float* ka = Ks + warp * 16 * ld;
  const float* va = Vs + warp * 16 * ld;
  for (int qt = 0; qt < ntiles; ++qt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                    // tile qt landed; tile qt - 1 consumed
    {
      const int nq = qt + STAGES - 1;
      if (nq < ntiles) load_stage(nq % STAGES, nq);
      cp_async_commit();
    }
    const float* Qt = ring + (qt % STAGES) * 2 * BT * ld;
    const float* dOt = Qt + BT * ld;
    const float* lse_s = vecs + (qt % STAGES) * 2 * BT;
    const float* del_s = lse_s + BT;
    // S^T = (K scale) Q^T and dP^T = V dO^T: keys x queries (the scale
    // goes on the A fragments, K's here, q's in the forward and in dQ)
    float st[SN][4], dpt[SN][4];
    zero(st);
    zero(dpt);
    rows_by_rows<NT>(st, ka, Qt, scale, dpt, va, dOt, nd);
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pk = row0 + g + (e >> 1) * 8;
        const int jq = j * 8 + 2 * t + (e & 1);
        const bool in = pk < Sk && qt * BT + jq < Sq;
        const float p = in ? expf(st[j][e] - lse_s[jq]) : 0.0f;
        st[j][e] = p;                                           // P^T
        dpt[j][e] = in ? p * (dpt[j][e] - del_s[jq]) : 0.0f;    // dS^T
      }
    regs_by_rows<NT, (NT % 4 == 0 ? 4 : 3), true>(adv, st, dOt, adk, dpt, Qt, nd);
  }
  store_rows<NT>(dk, adk, b, hh, row0, Sk, H, Dh, scale);
  store_rows<NT>(dv, adv, b, hh, row0, Sk, H, Dh, 1.0f);
}

template <int NT>
cudaError_t launch_nt(const float* q, const float* k, const float* v, const float* o,
                      const float* lse, const float* dO, float* delta, float* dq, float* dk,
                      float* dv, int B, int Sq, int Sk, int H, int Dh, Strides qs,
                      Strides ks, Strides vs, Strides os, Strides dos, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SMEM_FLOATS<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto vec = [](const void* p, Strides st) {
    return int(rows_16b_aligned(p, st.b * 4) && st.s * 4 % 16 == 0 && st.h * 4 % 16 == 0);
  };
  const int aligned = vec(q, qs) | vec(k, ks) << 1 | vec(v, vs) << 2 | vec(dO, dos) << 3;
  const float scale = (float)(1.0 / sqrt((double)Dh));
  // dQ first: it stores D, which the dK/dV launch reads
  flash_bwd_dq_kernel<NT><<<dim3((Sq + BM - 1) / BM, B * H), WARPS * 32, smem, stream>>>(
      q, k, v, o, dO, lse, delta, dq, Sq, Sk, H, Dh, qs, ks, vs, os, dos, scale, aligned);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<NT><<<dim3((Sk + BM - 1) / BM, B * H), WARPS * 32, smem, stream>>>(
      q, k, v, dO, lse, delta, dk, dv, Sq, Sk, H, Dh, qs, ks, vs, dos, scale, aligned);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dice

// Strides in elements (batch, sequence, head) of q, k, v, o and dO; dq, dk,
// dv are written contiguous (B, S, H, Dh); delta: f32 (B, H, Sq) scratch.
// Dh in [1, 128].  Returns the first launch error, else cudaGetLastError().
extern "C" int dice_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dO, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int Dh, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    int device, void* stream) {
  using namespace dice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Dh <= 0 || Dh > 128)
    return (int)cudaGetLastError();
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto run = [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return launch_nt<NT>(f(q), f(k), f(v), f(o), f(lse), f(dO), w(delta), w(dq), w(dk),
                         w(dv), B, Sq, Sk, H, Dh, qs, ks, vs, os, dos, s);
  };
  const int nd = (Dh + 7) / 8;
  if (nd <= 4) err = run(std::integral_constant<int, 4>{});
  else if (nd <= 8) err = run(std::integral_constant<int, 8>{});
  else if (nd <= 9) err = run(std::integral_constant<int, 9>{});
  else if (nd <= 12) err = run(std::integral_constant<int, 12>{});
  else err = run(std::integral_constant<int, 16>{});
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
