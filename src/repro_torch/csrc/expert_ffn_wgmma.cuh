// The grouped 3xTF32 GEMM main loop of the expert FFN's backward
// (expert_ffn_bwd.cu) on Hopper's warpgroup MMA (wgmma, sm_90a): a block's
// 128 x (NB x BN) output tile of A (M x K) B (K x N) per expert, with A
// read from registers and B from shared memory, fed by TMA.
//
// The tf32 constraint.  With tf32 operands wgmma reads a shared-memory
// operand only K-major (the transpose bits exist for 16-bit types alone),
// and A may come from registers in any layout the threads load.  So every
// B operand of the backward is laid out K-major as it lies in device
// memory (the caller's scratch is transposed to make that so), and A is
// loaded from shared memory into registers through the fragment offsets of
// whichever layout it has: K-major ([m][k] rows of 32 floats) or M-major
// (four boxes of [k][m], 32 x 32 floats each).
//
// 3xTF32.  x ~ big + small, big = x rounded to tf32 as cvt.rna.tf32 rounds
// it, small = x - big truncated to tf32 (tf32_mma.cuh's FastFrag: two
// integer instructions for the rounding where a cvt takes four), and each
// k8 step issues three wgmmas, a_small b_big, a_big b_small, a_big b_big
// (tf32_mma.cuh has the argument).  A is split in the consumers' registers
// as it is loaded.  Each B tile is split once in
// shared memory by the producer warpgroup: big in place, small into a
// second tile at the same offsets (an elementwise pass, so the TMA swizzle
// carries over), shared by both consumer warpgroups.
//
// The block: 384 threads.  Warpgroups 0 and 1 consume, 64 rows of the
// tile each, their accumulators in registers (setmaxnreg 232); warpgroup
// 2 produces (setmaxnreg 40): one thread issues the TMA loads into a ring
// of STAGES stages (128-byte swizzle, one k-tile of 32 floats a stage),
// three warps split the B tiles.  Three mbarriers a stage: full (TMA's
// bytes landed), split (the B tiles are split and fenced for the async
// proxy), empty (both consumer warpgroups' wgmmas on it are done).  A
// consumer warpgroup waits for its k-tile's wgmmas before it frees the
// stage and loads its next A fragments; the other warpgroup's wgmmas keep
// the tensor cores busy meanwhile.  Keeping one group in flight instead
// (two sets of fragment registers in turn) measured no faster on an H100
// SXM (launch/kernel_variants.py).  No instruction may define the
// accumulators or the A fragments while a group is in flight: ptxas then
// serializes the wgmmas (its C7513/C7515 notes in build.log).
//
// wgmma operand layouts (per warp w of a warpgroup, lane = 4 g + t):
//   A (m64 x k8, registers): a0 (16w + g, t)  a1 (16w + g + 8, t)
//                            a2 (16w + g, t + 4)  a3 (16w + g + 8, t + 4)
//   D (m64 x nN, f32):       d[4j + 2h + c] = (16w + g + 8h, 8j + 2t + c)
//   B (descriptor): K-major, 128-byte swizzle, rows of 32 floats, 8-row
//   groups 1024 bytes apart (SBO), k8 steps 32 bytes apart in the row.
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace dice {
namespace wg {

constexpr int BM = 128;                 // rows of a block tile
constexpr int BK = 32;                  // k of a stage: one 128-byte swizzle row of f32
constexpr int THREADS = 384;            // 2 consumer warpgroups + 1 producer
constexpr int SPLITTERS = 96;           // producer warps 9..11
constexpr bool SPLIT = kSplit<float>;   // 3xTF32 (one pass with DICE_TF32_ONE_PASS)

// The split of A (in the consumers' registers) and of the B tiles (by the
// producer's splitters): FastFrag's integer rounding by default, which
// gives cvt.rna's big part; -DDICE_BWD_CVT_SPLIT builds tf32_mma.cuh's cvt
// split for comparison (launch/kernel_variants.py).
#ifdef DICE_BWD_CVT_SPLIT
template <int N>
using AFrag = Frag<SPLIT, N>;
__device__ __forceinline__ float4 split_big(float4 v, float4& small) {
  float4 big;
  big.x = __uint_as_float(tf32_rna(v.x));
  big.y = __uint_as_float(tf32_rna(v.y));
  big.z = __uint_as_float(tf32_rna(v.z));
  big.w = __uint_as_float(tf32_rna(v.w));
  small.x = __uint_as_float(tf32_rna(v.x - big.x));
  small.y = __uint_as_float(tf32_rna(v.y - big.y));
  small.z = __uint_as_float(tf32_rna(v.z - big.z));
  small.w = __uint_as_float(tf32_rna(v.w - big.w));
  return big;
}
#else
template <int N>
using AFrag = FastFrag<SPLIT, N>;
__device__ __forceinline__ float4 split_big(float4 v, float4& small) {
  FastFrag<true, 4> f;
  f.set(0, v.x);
  f.set(1, v.y);
  f.set(2, v.z);
  f.set(3, v.w);
  small = make_float4(__uint_as_float(f.small[0]), __uint_as_float(f.small[1]),
                      __uint_as_float(f.small[2]), __uint_as_float(f.small[3]));
  return make_float4(__uint_as_float(f.big[0]), __uint_as_float(f.big[1]),
                     __uint_as_float(f.big[2]), __uint_as_float(f.big[3]));
}
#endif

// NA A operands x NB B operands of BN columns each (NA * NB accumulators
// of 64 x BN a consumer warpgroup); A_KMAJOR: A's tile is [m][k].
template <int NA_, int NB_, int BN_, bool A_KMAJOR_>
struct Cfg {
  static constexpr int NA = NA_, NB = NB_, BN = BN_, NACC = NA_ * NB_;
  static constexpr bool A_KMAJOR = A_KMAJOR_;
  static constexpr int A_TILE = BM * BK * 4;
  static constexpr int B_TILE = BN * BK * 4;
  static constexpr int STAGE = NA * A_TILE + 2 * NB * B_TILE;   // A, B big, B small
  static constexpr int TX = NA * A_TILE + NB * B_TILE;          // bytes TMA brings
  static constexpr int STAGES = 200 * 1024 / STAGE > 4 ? 4 : 200 * 1024 / STAGE;
  static constexpr int BYTES = 1024 + STAGES * STAGE + 3 * STAGES * 8;
  static_assert(BN == 64 || BN == 128, "wgmma_tf32 has n64 and n128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// returns once the barrier's phase of this parity has completed; a wait
// of more than 2^35 clocks (about 20 s) traps, so a pipeline fault ends
// the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 35)) __trap();
}

// box (c0 innermost, c1, c2) of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// K-major, 128-byte swizzle: SBO 1024 bytes (64 x 16), LBO unused (1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmmas
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps A fragments live (their registers unreused) until the wgmmas that
// read them have completed
__device__ __forceinline__ void keep(const uint32_t (&a)[4]) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// d (64 x N) += a (64 x 8, registers) * B (8 x N at desc), f32 accumulate
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// a (this thread's A fragment of k-step kk) from an A tile in shared
// memory, split as it is loaded.  wgi: consumer warpgroup (rows 64 wgi
// ...), q: warp in it.  K-major tile: [128 m][32 k], 16-byte chunk c of
// row m at c ^ (m % 8).  M-major tile: four boxes [32 k][32 m] of 32
// consecutive m, chunk c of row k at c ^ (k % 8).
template <bool A_KMAJOR>
__device__ __forceinline__ void load_a(AFrag<4>& f, const float* tile, int kk, int wgi,
                                       int q, int g, int t) {
  const int m = 64 * wgi + 16 * q + g;  // rows m and m + 8
  if constexpr (A_KMAJOR) {
    const float* r0 = tile + m * 32 + t;
    const float* r1 = r0 + 8 * 32;
    const int c0 = ((2 * kk) ^ g) << 2, c1 = ((2 * kk + 1) ^ g) << 2;
    f.set(0, r0[c0]);
    f.set(1, r1[c0]);
    f.set(2, r0[c1]);
    f.set(3, r1[c1]);
  } else {
    const int mm = m & 31, ca = mm >> 2, cb = ca + 2;
    const float* k0 = tile + (m >> 5) * 1024 + kk * 256 + t * 32 + (mm & 3);
    const float* k1 = k0 + 4 * 32;
    f.set(0, k0[(ca ^ t) << 2]);
    f.set(1, k0[(cb ^ t) << 2]);
    f.set(2, k1[(ca ^ (t + 4)) << 2]);
    f.set(3, k1[(cb ^ (t + 4)) << 2]);
  }
}

template <int NA>
__device__ __forceinline__ void keep_all(const AFrag<4> (&af)[NA][BK / 8]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      keep(af[a][kk].big);
      if constexpr (SPLIT) keep(af[a][kk].small);
    }
}

// The warp-specialised main loop over ktiles k-tiles.  load(kt, stage,
// bar) is called by one producer thread: it issues the TMA loads of
// k-tile kt into the stage at shared address stage (A tiles, then B
// tiles, as Cfg lays them out), all completing on bar, C::TX bytes.
// epi(acc, wgi, q, g, t) runs in each consumer thread with its
// accumulators (acc[a * NB + b] = A_a B_b, D layout above).  smem_raw:
// C::BYTES of dynamic shared memory.
template <class C, class Load, class Epi>
__device__ __forceinline__ void run(unsigned char* smem_raw, int ktiles, Load&& load,
                                    Epi&& epi) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + C::STAGES * C::STAGE;
  const uint32_t split0 = full0 + 8 * C::STAGES, empty0 = split0 + 8 * C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(split0 + 8 * s, SPLITTERS);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {                      // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      if (lane == 0) {
        for (int kt = 0; kt < ktiles; ++kt) {
          const int s = kt % C::STAGES;
          if (kt >= C::STAGES) mbar_wait(empty0 + 8 * s, ((kt / C::STAGES) - 1) & 1);
          mbar_expect_tx(full0 + 8 * s, C::TX);
          load(kt, base + s * C::STAGE, full0 + 8 * s);
        }
      }
    } else {                            // splitters
      const int tid = threadIdx.x - 9 * 32;
      constexpr int N4 = C::NB * C::B_TILE / 16;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % C::STAGES;
        mbar_wait(full0 + 8 * s, (kt / C::STAGES) & 1);
        if constexpr (SPLIT) {
          float4* big = reinterpret_cast<float4*>(smem + s * C::STAGE + C::NA * C::A_TILE);
          float4* small = big + N4;
          for (int i = tid; i < N4; i += SPLITTERS) {
            float4 lo;
            big[i] = split_big(big[i], lo);
            small[i] = lo;
          }
          // generic-proxy writes, read next by wgmma (async proxy)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        mbar_arrive(split0 + 8 * s);
      }
    }
  } else {                              // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = warp / 4, q = warp % 4, g = lane >> 2, t = lane & 3;
    float acc[C::NACC][C::BN / 2];
#pragma unroll
    for (int i = 0; i < C::NACC; ++i)
#pragma unroll
      for (int j = 0; j < C::BN / 2; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) fence_regs(acc[i]);
    AFrag<4> af[C::NA][BK / 8];
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % C::STAGES;
      const uint32_t par = (kt / C::STAGES) & 1;
      mbar_wait(full0 + 8 * s, par);
      mbar_wait(split0 + 8 * s, par);
      const float* at = reinterpret_cast<const float*>(smem + s * C::STAGE);
#pragma unroll
      for (int a = 0; a < C::NA; ++a)
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          load_a<C::A_KMAJOR>(af[a][kk], at + a * (C::A_TILE / 4), kk, wgi, q, g, t);
      const uint32_t bbig = base + s * C::STAGE + C::NA * C::A_TILE;
      const uint32_t bsmall = bbig + C::NB * C::B_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int a = 0; a < C::NA; ++a)
#pragma unroll
          for (int b = 0; b < C::NB; ++b) {
            const uint64_t db = desc_sw128(bbig + b * C::B_TILE) + 2 * kk;
            auto& d = acc[a * C::NB + b];
            if constexpr (SPLIT) {
              const uint64_t ds = desc_sw128(bsmall + b * C::B_TILE) + 2 * kk;
              wgmma_tf32(d, af[a][kk].small, db);
              wgmma_tf32(d, af[a][kk].big, ds);
            }
            wgmma_tf32(d, af[a][kk].big, db);
          }
      wgmma_commit();
      wgmma_wait<0>();
      keep_all<C::NA>(af);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * s);
    }
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) fence_regs(acc[i]);
    epi(acc, wgi, q, g, t);
  }
}

}  // namespace wg
}  // namespace dice
