// The grouped GEMM main loop of the expert FFN forward (expert_ffn.cu): a
// block's 128 x BN tile of A (M x K) @ B (K x N) on the tensor cores as
// 3xTF32 mma.sync m16n8k8 (tf32_mma.cuh), over a 2-stage cp.async ring of
// A and B tiles in dynamic shared memory, both read row-major.  The layout
// notes are in expert_ffn.cu.  The backward (expert_ffn_bwd.cu) runs on
// the wgmma main loop of expert_ffn_wgmma.cuh and shares only
// activation() and store2() from here.
#pragma once

#include "common.cuh"
#include "tf32_mma.cuh"

namespace dice {
namespace {

// Tiling.  The defaults are the port's; launch/kernel_variants.py builds
// the other values with -D and times them against these.
//   DICE_FFN_WARPS_M 2: 128-row blocks of 2 x 2 warps, 64 x 64 warp tiles;
//                    1: 64-row blocks of 1 x 4 warps, 64 x 32 warp tiles.
#ifndef DICE_FFN_WARPS_M
#define DICE_FFN_WARPS_M 2
#endif
#ifndef DICE_FFN_STAGES
#define DICE_FFN_STAGES 2
#endif
constexpr int BK = 32;                  // contraction tile
constexpr int STAGES = DICE_FFN_STAGES; // cp.async ring depth
constexpr int WARPS_M = DICE_FFN_WARPS_M, WARPS_N = 4 / WARPS_M;
static_assert(WARPS_M == 1 || WARPS_M == 2, "DICE_FFN_WARPS_M is 1 or 2");
constexpr int NJ = 4 * WARPS_M;         // m16n8 tiles across a warp's columns
constexpr int NT = 32 * WARPS_M * WARPS_N;
constexpr int BM = 64 * WARPS_M;        // rows of C per block
constexpr int MIN_BLOCKS = 4 / WARPS_M; // blocks per SM the registers allow

__device__ __forceinline__ float activation(float g, int act) {
  if (act == 0) return g * (1.0f / (1.0f + expf(-g)));  // silu
  // gelu, tanh approximation (jax.nn.gelu's default)
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * g * (1.0f + tanhf(k * (g + 0.044715f * g * g * g)));
}

// Shared-memory layout of one pipeline stage: an A tile BM x BK and NB B
// tiles BK x BN (NB = 2 for gate/up), rows padded as the notes say.
template <typename TA, typename TB, bool GATED>
struct Layout {
  static constexpr int NB = GATED ? 2 : 1;
  static constexpr int BN = (GATED ? 4 : 8) * NJ * WARPS_N;  // columns per B tile
  static constexpr int LDA = BK + 16 / (int)sizeof(TA);
  static constexpr int LDB = BN + 32 / (int)sizeof(TB);
  static constexpr size_t A_BYTES = sizeof(TA) * BM * LDA;
  static constexpr size_t B_BYTES = sizeof(TB) * BK * LDB;
  static constexpr size_t STAGE = A_BYTES + NB * B_BYTES;
  static constexpr size_t BYTES = STAGES * STAGE;
};

// ROWS x COLS tile at (r0, c0) of the row-major (rows x cols) matrix src
// into dst (row length ld), zero outside the matrix.  vec: cols and the
// base are 16-byte aligned, so a 16-byte piece is all inside or all out.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int rows,
                                          int cols, int r0, int c0, bool vec) {
  if (vec) {
    constexpr int VE = 16 / sizeof(T), CPR = COLS / VE, N = ROWS * CPR;
    static_assert(N % NT == 0, "tile pieces must split evenly over the threads");
#pragma unroll
    for (int l = 0; l < N / NT; ++l) {
      const int idx = threadIdx.x + l * NT;
      const int r = idx / CPR, c = (idx % CPR) * VE;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < rows && gc < cols;
      cp_async16(dst + r * ld + c, in ? src + (size_t)gr * cols + gc : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += NT) {
      const int r = idx / COLS, c = idx % COLS;
      const int gr = r0 + r, gc = c0 + c;
      store_f32(dst + r * ld + c,
                gr < rows && gc < cols ? load_f32(src + (size_t)gr * cols + gc) : 0.0f);
    }
  }
}

// acc[i][j] = the (i, j) m16n8 tile of this warp's 64 x 8 NJ outputs of
// A (M x K) @ B (K x N), over the block's tile (blockIdx.x rows, blockIdx.y
// columns).  GATED: B0 gives tiles j < NJ / 2 and B1 tiles j >= NJ / 2 of
// the same columns.
template <typename TA, typename TB, bool GATED>
__device__ __forceinline__ void gemm_mainloop(const TA* __restrict__ A,
                                              const TB* __restrict__ B0,
                                              const TB* __restrict__ B1, int M, int K,
                                              int N, bool vec_a, bool vec_b,
                                              unsigned char* smem, float (&acc)[4][NJ][4]) {
  using L = Layout<TA, TB, GATED>;
  constexpr bool SA = kSplit<TA>;
  constexpr bool SB = kSplit<TB>;
  // element strides of the m and k (A) and k and n (B) indices in a tile
  constexpr int A_M = L::LDA, A_K = 1;
  constexpr int B_K = L::LDB, B_N = 1;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * L::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  auto a_tile = [&](int s) { return reinterpret_cast<TA*>(smem + s * L::STAGE); };
  auto b_tile = [&](int s, int mat) {
    return reinterpret_cast<TB*>(smem + s * L::STAGE + L::A_BYTES + mat * L::B_BYTES);
  };
  const int ktiles = (K + BK - 1) / BK;
  auto load_b = [&](int s, int mat, const TB* B, int k0) {
    load_tile<TB, BK, L::BN>(b_tile(s, mat), L::LDB, B, K, N, k0, col0, vec_b);
  };
  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * BK;
    load_tile<TA, BM, BK>(a_tile(s), L::LDA, A, M, K, row0, k0, vec_a);
    load_b(s, 0, B0, k0);
    if constexpr (GATED) load_b(s, 1, B1, k0);
  };

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                    // tile kt landed; tile kt - 1 consumed
    {
      const int nk = kt + STAGES - 1;
      if (nk < ktiles) load_stage(nk % STAGES, nk);
      cp_async_commit();
    }
    const int st = kt % STAGES;
    const TA* as = a_tile(st) + (wm * 64 + g) * A_M + t * A_K;
    const TB* bs[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bs[j] = GATED ? b_tile(st, j / (NJ / 2)) + t * B_K + (wn * 4 * NJ + j % (NJ / 2) * 8 + g) * B_N
                    : b_tile(st, 0) + t * B_K + (wn * 8 * NJ + j * 8 + g) * B_N;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      Frag<SB, 2> b[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const TB* bp = bs[j] + kk * 8 * B_K;
        b[j].set(0, load_f32(bp));
        b[j].set(1, load_f32(bp + 4 * B_K));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const TA* ap = as + i * 16 * A_M + kk * 8 * A_K;
        Frag<SA, 4> a;
        a.set(0, load_f32(ap));
        a.set(1, load_f32(ap + 8 * A_M));
        a.set(2, load_f32(ap + 4 * A_K));
        a.set(3, load_f32(ap + 8 * A_M + 4 * A_K));
        // pass by pass over the NJ tiles, so that dependent mmas are NJ
        // apart
        if constexpr (SA) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], a.small, b[j].big);
        }
        if constexpr (SB) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], a.big, b[j].small);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], a.big, b[j].big);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (second) p[1] = v1;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (second) p[1] = __float2bfloat16(v1);
  }
}

}  // namespace
}  // namespace dice
