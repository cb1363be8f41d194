// Backward of the grouped gated expert MLP for Hopper (sm_90a), f32:
//   forward  G = X Wg,  U = X Wu,  H = act(G) * U,  Y = H Wd   (per expert)
//   backward dH = dY Wd^T,  dG = dH * U * act'(G),  dU = dH * act(G)
//            dWd = H^T dY,  dX = dG Wg^T + dU Wu^T,  dWg = X^T dG,  dWu = X^T dU
// X (E, C, d), Wg/Wu (E, d, f), Wd (E, f, d), dY (E, C, d), all row-major.
//
// No Pallas kernel is replaced: the JAX package trains through XLA's
// autodiff of repro.kernels.ref (use_pallas=False), so this backward is
// written for Hopper from the formulas above.
//
// Bound: at DiT-MoE-XL refresh shapes (E=8, C=640, d=1152, f=4608) the six
// products are 3.26e11 FLOP against 1.1 GB of operands and gradients, so
// operations bound it (1.98 ms at 3xTF32 on the tensor cores, 4.87 ms on
// the FP32 cores).  Every product is the forward's main loop
// (expert_ffn_gemm.cuh: 3xTF32 mma.sync, 128 x 64/128 block tiles, a
// 2-stage cp.async ring), with E in the grid's z.  The transposed operands
// (Wd^T, Wg^T, Wu^T as B; H^T, X^T as A) are copied into shared memory as
// they lie in device memory and read through transposed fragment offsets,
// so no transposed copy is made.
//
// G and U are recomputed, not saved by the forward: the forward kernel and
// its output stay as they were, and a layer holds no (E, C, f) tensor
// between its forward and backward (3 x 94 MB a layer at XL, 2.3 GB over 8
// layers).  The recompute costs two more products (1.09e11 FLOP, a third
// of the six) and a transient f32 scratch of 3 x E x C x f the caller
// allocates (G, U and H, then dG and dU in place of G and U).
//
// Five launches, in order (no atomics: every output element is written by
// one thread once, so two runs agree bit for bit):
//   0  G, U, H        gated: X @ [Wg | Wu], H = act(G) * U in the epilogue;
//   1  dG, dU         dY @ Wd^T, with the gating fused into the epilogue
//                     (reads G and U, writes dG and dU over them);
//   2  dWd = H^T dY   A transposed;
//   3  dX             dG @ Wg^T, then dU @ Wu^T into the same sums: one
//                     reduction over the 2f columns;
//   4  dWg, dWu       gated: X^T @ [dG | dU], A transposed.
// Capacity rows that are dropped or empty are zero in X and get a zero dY
// (combine gathers nothing from them), so they add exactly 0 to every
// weight gradient.  Ragged C, d and f edges are masked as in the forward.
#include "expert_ffn_gemm.cuh"

namespace dice {
namespace {

__device__ __forceinline__ float activation_grad(float g, int act) {
  if (act == 0) {                       // silu: s (1 + g (1 - s))
    const float s = 1.0f / (1.0f + expf(-g));
    return s * (1.0f + g * (1.0f - s));
  }
  const float k = 0.7978845608028654f;  // gelu, tanh approximation
  const float th = tanhf(k * (g + 0.044715f * g * g * g));
  return 0.5f * (1.0f + th) + 0.5f * g * (1.0f - th * th) * k * (1.0f + 3.0f * 0.044715f * g * g);
}

struct BwdArgs {
  const float* x;
  const float* wg;
  const float* wu;
  const float* wd;
  const float* dy;
  float* g;       // (E, C, f): G, then dG
  float* u;       // (E, C, f): U, then dU
  float* h;       // (E, C, f): H
  float* dx;
  float* dwg;
  float* dwu;
  float* dwd;
  int C, d, f, act;
  int vec_x, vec_wgu, vec_wd, vec_dy, vec_scratch;
};

// fn(r, c, v0, v1) for the outputs (r, c) and (r, c + 1) this thread holds
// of a non-gated block tile (M x N output); the caller masks c + 1 >= N.
template <int BN_, typename Fn>
__device__ __forceinline__ void each_output(const float (&acc)[4][NJ][4], int M, int N,
                                            Fn&& fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int r0 = blockIdx.x * BM + wm * 64 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = blockIdx.y * BN_ + wn * 8 * NJ + j * 8 + 2 * (lane & 3);
      if (c >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + i * 16 + half * 8;
        if (r < M) fn(r, c, acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
}

// fn(r, c, b0_0, b0_1, b1_0, b1_1) for a gated block tile: the outputs of
// B0 and of B1 at (r, c) and (r, c + 1).
template <int BN_, typename Fn>
__device__ __forceinline__ void each_gated_output(const float (&acc)[4][NJ][4], int M, int N,
                                                  Fn&& fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int r0 = blockIdx.x * BM + wm * 64 + (lane >> 2);
  constexpr int U = NJ / 2;             // B1's tiles follow B0's
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < U; ++jj) {
      const int c = blockIdx.y * BN_ + wn * 4 * NJ + jj * 8 + 2 * (lane & 3);
      if (c >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + i * 16 + half * 8;
        if (r < M)
          fn(r, c, acc[i][jj][2 * half], acc[i][jj][2 * half + 1], acc[i][jj + U][2 * half],
             acc[i][jj + U][2 * half + 1]);
      }
    }
}

using LGated = Layout<float, float, true>;
using LGatedTA = Layout<float, float, true, true, false>;
using LPlainTB = Layout<float, float, false, false, true>;
using LPlainTA = Layout<float, float, false, true, false>;

template <int PASS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) bwd_gemm_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.z;
  const int C = a.C, d = a.d, f = a.f;
  const size_t cd = (size_t)C * d, df = (size_t)d * f, cf = (size_t)C * f;
  const float* X = a.x + e * cd;
  const float* dY = a.dy + e * cd;
  float* G = a.g + e * cf;
  float* Uu = a.u + e * cf;
  float* Hh = a.h + e * cf;
  float acc[4][NJ][4];
  if constexpr (PASS == 0) {            // G, U, H
    gemm_mainloop<float, float, true>(X, a.wg + e * df, a.wu + e * df, C, d, f, a.vec_x,
                                      a.vec_wgu, smem, acc);
    const bool even = f % 2 == 0;
    each_gated_output<LGated::BN>(acc, C, f, [&](int r, int c, float g0, float g1, float u0,
                                                 float u1) {
      const size_t o = (size_t)r * f + c;
      const bool pair = even && c + 1 < f, second = c + 1 < f;
      store2(G + o, g0, g1, pair, second);
      store2(Uu + o, u0, u1, pair, second);
      store2(Hh + o, activation(g0, a.act) * u0, activation(g1, a.act) * u1, pair, second);
    });
  } else if constexpr (PASS == 1) {     // dH = dY Wd^T; dG, dU over G, U
    gemm_mainloop<float, float, false, false, true>(dY, a.wd + e * df, nullptr, C, d, f,
                                                    a.vec_dy, a.vec_wd, smem, acc);
    each_output<LPlainTB::BN>(acc, C, f, [&](int r, int c, float v0, float v1) {
      const float dh[2] = {v0, v1};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (c + q >= f) break;
        const size_t o = (size_t)r * f + c + q;
        const float gv = G[o], uv = Uu[o];
        G[o] = dh[q] * uv * activation_grad(gv, a.act);
        Uu[o] = dh[q] * activation(gv, a.act);
      }
    });
  } else if constexpr (PASS == 2) {     // dWd = H^T dY: (f x d)
    gemm_mainloop<float, float, false, true, false>(Hh, dY, nullptr, f, C, d, a.vec_scratch,
                                                    a.vec_dy, smem, acc);
    float* dWd = a.dwd + e * df;
    each_output<LPlainTA::BN>(acc, f, d, [&](int r, int c, float v0, float v1) {
      store2(dWd + (size_t)r * d + c, v0, v1, d % 2 == 0 && c + 1 < d, c + 1 < d);
    });
  } else if constexpr (PASS == 3) {     // dX = dG Wg^T + dU Wu^T: (C x d)
    gemm_mainloop<float, float, false, false, true>(G, a.wg + e * df, nullptr, C, f, d,
                                                    a.vec_scratch, a.vec_wgu, smem, acc);
    __syncthreads();                    // the second loop refills stage 0
    gemm_mainloop<float, float, false, false, true, true>(Uu, a.wu + e * df, nullptr, C, f, d,
                                                          a.vec_scratch, a.vec_wgu, smem, acc);
    float* dX = a.dx + e * cd;
    each_output<LPlainTB::BN>(acc, C, d, [&](int r, int c, float v0, float v1) {
      store2(dX + (size_t)r * d + c, v0, v1, d % 2 == 0 && c + 1 < d, c + 1 < d);
    });
  } else {                              // dWg = X^T dG, dWu = X^T dU: (d x f)
    gemm_mainloop<float, float, true, true, false>(X, G, Uu, d, C, f, a.vec_x, a.vec_scratch,
                                                   smem, acc);
    float* dWg = a.dwg + e * df;
    float* dWu = a.dwu + e * df;
    const bool even = f % 2 == 0;
    each_gated_output<LGatedTA::BN>(acc, d, f, [&](int r, int c, float g0, float g1, float u0,
                                                   float u1) {
      const size_t o = (size_t)r * f + c;
      store2(dWg + o, g0, g1, even && c + 1 < f, c + 1 < f);
      store2(dWu + o, u0, u1, even && c + 1 < f, c + 1 < f);
    });
  }
}

template <int PASS, typename L>
cudaError_t launch_pass(const BwdArgs& a, int M, int N, int E, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_gemm_kernel<PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + L::BN - 1) / L::BN, E);
  bwd_gemm_kernel<PASS><<<grid, NT, L::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dice

// scratch: f32 (3, E, C, f) the caller allocates (G, U, H); act: 0 silu,
// 1 gelu.  Returns the first launch error, else cudaGetLastError().
extern "C" int dice_expert_ffn_bwd(const void* x, const void* wg, const void* wu,
                                   const void* wd, const void* dy, void* scratch, void* dx,
                                   void* dwg, void* dwu, void* dwd, int E, int C, int d,
                                   int f, int act, int device, void* stream) {
  using namespace dice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || d <= 0 || f <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const size_t ecf = (size_t)E * C * f;
  BwdArgs a{static_cast<const float*>(x),  static_cast<const float*>(wg),
            static_cast<const float*>(wu), static_cast<const float*>(wd),
            static_cast<const float*>(dy), sc,
            sc + ecf,                      sc + 2 * ecf,
            static_cast<float*>(dx),       static_cast<float*>(dwg),
            static_cast<float*>(dwu),      static_cast<float*>(dwd),
            C, d, f, act, 0, 0, 0, 0, 0};
  a.vec_x = rows_16b_aligned(x, d * 4LL);
  a.vec_dy = rows_16b_aligned(dy, d * 4LL);
  a.vec_wgu = rows_16b_aligned(wg, f * 4LL) && rows_16b_aligned(wu, f * 4LL);
  a.vec_wd = rows_16b_aligned(wd, d * 4LL);
  a.vec_scratch = rows_16b_aligned(a.g, f * 4LL) && rows_16b_aligned(a.u, f * 4LL) &&
                  rows_16b_aligned(a.h, f * 4LL);
  if (C > 0) {
    if ((err = launch_pass<0, LGated>(a, C, f, E, s)) != cudaSuccess) return (int)err;
    if ((err = launch_pass<1, LPlainTB>(a, C, f, E, s)) != cudaSuccess) return (int)err;
  }
  // with C == 0 the weight gradients are zero: passes 2 and 4 sum no rows
  if ((err = launch_pass<2, LPlainTA>(a, f, d, E, s)) != cudaSuccess) return (int)err;
  if (C > 0) {
    if ((err = launch_pass<3, LPlainTB>(a, C, d, E, s)) != cudaSuccess) return (int)err;
  }
  if ((err = launch_pass<4, LGatedTA>(a, d, f, E, s)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
