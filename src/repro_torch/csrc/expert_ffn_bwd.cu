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
// operations bound it: 1.98 ms at 3xTF32 on the tensor cores, 4.87 ms on
// the FP32 cores.  Only wgmma reaches the tensor cores' full rate, so every
// product runs on the grouped 3xTF32 wgmma main loop of
// expert_ffn_wgmma.cuh (TMA ring, one producer and two consumer
// warpgroups, 128 x 128 block tiles; pass 0's two accumulators 128 x 64),
// with E in the grid's z and the blocks of one expert's rows walked
// columns first, so that a weight tile is read from device memory about
// once.
//
// wgmma takes tf32 operands from shared memory only K-major, so each
// product is oriented to read its B operand K-major as it lies, and A,
// which comes from registers, in whatever layout it has.  The backward
// chooses its own scratch layout to make that possible: G, U and H (then
// dG and dU over G and U) are held transposed, (3, E, f, cp) with the
// capacity dim C contiguous and padded to cp (a multiple of 4, for TMA's
// 16-byte strides; columns past C are never read):
//   pass  product (output)                    A (registers)   B (K-major)
//   0     G^T = Wg^T X^T, U^T = Wu^T X^T      Wg^T, Wu^T      X (C x d)
//         (f x C, K = d); H^T = act(G^T) U^T in the epilogue
//   1     dH^T = Wd dY^T (f x C, K = d);      Wd              dY (C x d)
//         the epilogue reads G^T, U^T and writes dG^T, dU^T over them
//   2     dWd^T = dY^T H (d x f, K = C),      dY^T            H^T (f x C)
//         stored into dWd (f x d): 8 lanes write 8 consecutive floats
//   3     dX = dG Wg^T + dU Wu^T (C x d,      dG, then dU     Wg, then Wu
//         K = 2f: one sum)                                    (d x f)
//   4     dWg = X^T dG, dWu = X^T dU          X^T             dG^T, dU^T
//         (d x f, K = C)                                      (f x C)
// Wd is the only K-major A; the others are M-major and read as four
// swizzled 32 x 32 boxes.  d and f must be multiples of 4 (TMA's 16-byte
// strides): the wrapper (kernels/ops.py) stages zero-padded copies of
// the operands for other widths.
//
// G and U are recomputed, not saved by the forward: the forward kernel and
// its output stay as they were, and a layer holds no (E, C, f) tensor
// between its forward and backward.  The recompute costs two more
// products (1.09e11 FLOP, a third of the six) and the transient scratch.
//
// No atomics: every output element is summed by one thread's wgmmas in a
// fixed order, so two runs agree bit for bit.  Capacity rows that are
// dropped or empty are zero in X and get a zero dY (combine gathers
// nothing from them), so they add exactly 0 to every weight gradient.
// Ragged edges of C, d and f are zero-filled by TMA and masked in the
// epilogues.
#include <initializer_list>

#include "expert_ffn_gemm.cuh"
#include "expert_ffn_wgmma.cuh"

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
  float* s;       // scratch (3E, f, cp): G^T, U^T, H^T; then dG^T, dU^T
  float* dx;
  float* dwg;
  float* dwu;
  float* dwd;
  int E, C, d, f, cp, act;
};

// the tensor maps of one pass: A operands a0 (a1), B operands b0 (b1)
struct Maps {
  CUtensorMap a0, a1, b0, b1;
};

template <int PASS>
struct PassCfg {                        // passes 2 and 3
  using type = wg::Cfg<1, 1, 128, false>;
};
// Pass 0 holds two accumulators (G^T and U^T); at 64 columns they and the
// A fragments of both weights fit the consumers' registers, at 128 they
// spill.  DICE_BWD_GU_BN=128 builds the wider tile for comparison
// (launch/kernel_variants.py).
#ifndef DICE_BWD_GU_BN
#define DICE_BWD_GU_BN 64
#endif
template <>
struct PassCfg<0> {
  using type = wg::Cfg<2, 1, DICE_BWD_GU_BN, false>;
};
template <>
struct PassCfg<1> {
  using type = wg::Cfg<1, 1, 128, true>;
};
template <>
struct PassCfg<4> {
  using type = wg::Cfg<1, 2, 64, false>;
};

// fn(r, c, i): this thread's outputs (r, c) and (r, c + 1) of the block
// tile are acc[.][i] and acc[.][i + 1]
template <int BN, typename Fn>
__device__ __forceinline__ void each_pair(int wgi, int q, int g, int t, Fn&& fn) {
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2)
    fn(64 * wgi + 16 * q + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t, i);
}

template <int PASS>
__global__ void __launch_bounds__(wg::THREADS, 1)
bwd_wgmma_kernel(const __grid_constant__ Maps maps, const BwdArgs a) {
  using C = typename PassCfg<PASS>::type;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int e = blockIdx.z, E = a.E, f = a.f, d = a.d, Cc = a.C, cp = a.cp;
  const int m0 = blockIdx.y * wg::BM, n0 = blockIdx.x * C::BN;
  // four 32 x 32 boxes of an M-major A tile
  auto load_a_mmajor = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int k0, int z) {
#pragma unroll
    for (int i = 0; i < 4; ++i) wg::tma_load(dst + i * 4096, map, bar, m0 + 32 * i, k0, z);
  };
  const uint32_t b_at = C::NA * C::A_TILE;   // the B tiles' offset in a stage
  float* Sg = a.s + (size_t)e * f * cp;              // G^T, then dG^T
  float* Su = a.s + (size_t)(E + e) * f * cp;        // U^T, then dU^T
  float* Sh = a.s + (size_t)(2 * E + e) * f * cp;    // H^T
  if constexpr (PASS == 0) {            // G^T, U^T, H^T: (f x C)
    wg::run<C>(
        smem, (d + wg::BK - 1) / wg::BK,
        [&](int kt, uint32_t st, uint32_t bar) {
          load_a_mmajor(st, &maps.a0, bar, kt * wg::BK, e);
          load_a_mmajor(st + C::A_TILE, &maps.a1, bar, kt * wg::BK, e);
          wg::tma_load(st + b_at, &maps.b0, bar, kt * wg::BK, n0, e);
        },
        [&](float (&acc)[C::NACC][C::BN / 2], int wgi, int q, int g, int t) {
          each_pair<C::BN>(wgi, q, g, t, [&](int r, int c, int i) {
            const int m = m0 + r, n = n0 + c;
            if (m >= f || n >= Cc) return;
            const size_t o = (size_t)m * cp + n;
            const bool pair = n + 1 < Cc;
            const float g0 = acc[0][i], g1 = acc[0][i + 1], u0 = acc[1][i], u1 = acc[1][i + 1];
            store2(Sg + o, g0, g1, pair, pair);
            store2(Su + o, u0, u1, pair, pair);
            store2(Sh + o, activation(g0, a.act) * u0, activation(g1, a.act) * u1, pair, pair);
          });
        });
  } else if constexpr (PASS == 1) {     // dH^T = Wd dY^T; dG^T, dU^T over G^T, U^T
    wg::run<C>(
        smem, (d + wg::BK - 1) / wg::BK,
        [&](int kt, uint32_t st, uint32_t bar) {
          wg::tma_load(st, &maps.a0, bar, kt * wg::BK, m0, e);
          wg::tma_load(st + b_at, &maps.b0, bar, kt * wg::BK, n0, e);
        },
        [&](float (&acc)[C::NACC][C::BN / 2], int wgi, int q, int g, int t) {
          // half the tile at a time: its G and U are loaded before any
          // store, which the compiler could not otherwise move them past
          constexpr int HALF = C::BN / 4;
#pragma unroll
          for (int h0 = 0; h0 < C::BN / 2; h0 += HALF) {
            float gv[HALF], uv[HALF];
            each_pair<C::BN>(wgi, q, g, t, [&](int r, int c, int i) {
              if (i < h0 || i >= h0 + HALF) return;
              const int m = m0 + r, n = n0 + c;
              const size_t o = (size_t)m * cp + n;
              float2 gg = make_float2(0.0f, 0.0f), uu = gg;
              if (m < f && n + 1 < Cc) {
                gg = *reinterpret_cast<const float2*>(Sg + o);
                uu = *reinterpret_cast<const float2*>(Su + o);
              } else if (m < f && n < Cc) {
                gg.x = Sg[o];
                uu.x = Su[o];
              }
              gv[i - h0] = gg.x, gv[i - h0 + 1] = gg.y;
              uv[i - h0] = uu.x, uv[i - h0 + 1] = uu.y;
            });
            each_pair<C::BN>(wgi, q, g, t, [&](int r, int c, int i) {
              if (i < h0 || i >= h0 + HALF) return;
              const int m = m0 + r, n = n0 + c;
              if (m >= f || n >= Cc) return;
              const size_t o = (size_t)m * cp + n;
              const bool pair = n + 1 < Cc;
              float dg[2], du[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float dh = acc[0][i + h], gq = gv[i - h0 + h], uq = uv[i - h0 + h];
                dg[h] = dh * uq * activation_grad(gq, a.act);
                du[h] = dh * activation(gq, a.act);
              }
              store2(Sg + o, dg[0], dg[1], pair, pair);
              store2(Su + o, du[0], du[1], pair, pair);
            });
          }
        });
  } else if constexpr (PASS == 2) {     // dWd^T = dY^T H: (d x f), into dWd (f x d)
    wg::run<C>(
        smem, (Cc + wg::BK - 1) / wg::BK,
        [&](int kt, uint32_t st, uint32_t bar) {
          load_a_mmajor(st, &maps.a0, bar, kt * wg::BK, e);
          wg::tma_load(st + b_at, &maps.b0, bar, kt * wg::BK, n0, 2 * E + e);
        },
        [&](float (&acc)[C::NACC][C::BN / 2], int wgi, int q, int g, int t) {
          float* dWd = a.dwd + (size_t)e * f * d;
          each_pair<C::BN>(wgi, q, g, t, [&](int r, int c, int i) {
            const int m = m0 + r, n = n0 + c;
            if (m >= d) return;
            if (n < f) dWd[(size_t)n * d + m] = acc[0][i];
            if (n + 1 < f) dWd[(size_t)(n + 1) * d + m] = acc[0][i + 1];
          });
        });
  } else if constexpr (PASS == 3) {     // dX = dG Wg^T + dU Wu^T: (C x d)
    const int kf = (f + wg::BK - 1) / wg::BK;
    wg::run<C>(
        smem, 2 * kf,
        [&](int kt, uint32_t st, uint32_t bar) {
          const int up = kt >= kf, k0 = (kt - up * kf) * wg::BK;
          load_a_mmajor(st, &maps.a0, bar, k0, up * E + e);
          wg::tma_load(st + b_at, up ? &maps.b1 : &maps.b0, bar, k0, n0, e);
        },
        [&](float (&acc)[C::NACC][C::BN / 2], int wgi, int q, int g, int t) {
          float* dX = a.dx + (size_t)e * Cc * d;
          each_pair<C::BN>(wgi, q, g, t, [&](int r, int c, int i) {
            const int m = m0 + r, n = n0 + c;
            if (m >= Cc || n >= d) return;
            const bool pair = n + 1 < d;
            store2(dX + (size_t)m * d + n, acc[0][i], acc[0][i + 1], pair, pair);
          });
        });
  } else {                              // dWg = X^T dG, dWu = X^T dU: (d x f)
    wg::run<C>(
        smem, (Cc + wg::BK - 1) / wg::BK,
        [&](int kt, uint32_t st, uint32_t bar) {
          load_a_mmajor(st, &maps.a0, bar, kt * wg::BK, e);
          wg::tma_load(st + b_at, &maps.b0, bar, kt * wg::BK, n0, e);
          wg::tma_load(st + b_at + C::B_TILE, &maps.b0, bar, kt * wg::BK, n0, E + e);
        },
        [&](float (&acc)[C::NACC][C::BN / 2], int wgi, int q, int g, int t) {
          float* dWg = a.dwg + (size_t)e * d * f;
          float* dWu = a.dwu + (size_t)e * d * f;
          each_pair<C::BN>(wgi, q, g, t, [&](int r, int c, int i) {
            const int m = m0 + r, n = n0 + c;
            if (m >= d || n >= f) return;
            const size_t o = (size_t)m * f + n;
            const bool pair = n + 1 < f;
            store2(dWg + o, acc[0][i], acc[0][i + 1], pair, pair);
            store2(dWu + o, acc[1][i], acc[1][i + 1], pair, pair);
          });
        });
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D f32 tensor map (inner, rows, z) with row and z strides in elements,
// boxes of bi x br x 1, 128-byte swizzle, zero fill out of bounds
bool make_map(CUtensorMap* map, const float* base, long long inner, long long rows,
              long long z, long long row_stride, long long z_stride, int bi, int br) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)z};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 4, (cuuint64_t)z_stride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)bi, (cuuint32_t)br, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int PASS>
cudaError_t launch_pass(const Maps& maps, const BwdArgs& a, int M, int N, cudaStream_t stream) {
  using C = typename PassCfg<PASS>::type;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_wgmma_kernel<PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + wg::BM - 1) / wg::BM, a.E);
  bwd_wgmma_kernel<PASS><<<grid, wg::THREADS, C::BYTES, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dice

// scratch: f32 (3, E, f, cp) the caller allocates (G^T, U^T, H^T), cp >= C
// a multiple of 4; d and f multiples of 4; every pointer 16-byte aligned;
// C > 0.  act: 0 silu, 1 gelu.  Returns cudaErrorInvalidValue for what it
// does not take or a tensor map it cannot encode, else the first launch
// error, else cudaGetLastError().
extern "C" int dice_expert_ffn_bwd(const void* x, const void* w_g, const void* w_u,
                                   const void* w_d, const void* dy, void* scratch, void* dx,
                                   void* dwg, void* dwu, void* dwd, int E, int C, int d,
                                   int f, int cp, int act, int device, void* stream) {
  using namespace dice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || d % 4 || f % 4 || cp % 4 || cp < C)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, w_g, w_u, w_d, dy, (const void*)scratch})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  const long long cd = (long long)C * d, df = (long long)d * f, fc = (long long)f * cp;
  Maps m0{}, m1{}, m2{}, m3{}, m4{};
  bool ok = true;
  // A boxes: 32 x 32 (M-major) or 32 x 128 (K-major); B boxes: 32 x BN
  const int bn0 = PassCfg<0>::type::BN, bn1 = PassCfg<1>::type::BN,
            bn2 = PassCfg<2>::type::BN, bn3 = PassCfg<3>::type::BN,
            bn4 = PassCfg<4>::type::BN;
  // pass 0: A Wg^T, Wu^T (M-major boxes of f x d), B X (rows of C)
  ok &= make_map(&m0.a0, F(w_g), f, d, E, f, df, 32, 32);
  ok &= make_map(&m0.a1, F(w_u), f, d, E, f, df, 32, 32);
  ok &= make_map(&m0.b0, F(x), d, C, E, d, cd, 32, bn0);
  // pass 1: A Wd (K-major rows of f), B dY
  ok &= make_map(&m1.a0, F(w_d), d, f, E, d, (long long)f * d, 32, wg::BM);
  ok &= make_map(&m1.b0, F(dy), d, C, E, d, cd, 32, bn1);
  // pass 2: A dY^T (M-major boxes of d x C), B H^T (rows of f, K = C)
  ok &= make_map(&m2.a0, F(dy), d, C, E, d, cd, 32, 32);
  ok &= make_map(&m2.b0, F(scratch), C, f, 3LL * E, cp, fc, 32, bn2);
  // pass 3: A dG, dU (M-major boxes of C x f), B Wg, Wu (rows of d, K = f)
  ok &= make_map(&m3.a0, F(scratch), C, f, 3LL * E, cp, fc, 32, 32);
  ok &= make_map(&m3.b0, F(w_g), f, d, E, f, df, 32, bn3);
  ok &= make_map(&m3.b1, F(w_u), f, d, E, f, df, 32, bn3);
  // pass 4: A X^T (M-major boxes of d x C), B dG^T, dU^T (rows of f, K = C)
  ok &= make_map(&m4.a0, F(x), d, C, E, d, cd, 32, 32);
  ok &= make_map(&m4.b0, F(scratch), C, f, 3LL * E, cp, fc, 32, bn4);
  if (!ok) return (int)cudaErrorInvalidValue;
  const BwdArgs a{static_cast<float*>(scratch), static_cast<float*>(dx),
                  static_cast<float*>(dwg),     static_cast<float*>(dwu),
                  static_cast<float*>(dwd),     E, C, d, f, cp, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = launch_pass<0>(m0, a, f, C, s)) != cudaSuccess) return (int)err;
  if ((err = launch_pass<1>(m1, a, f, C, s)) != cudaSuccess) return (int)err;
  if ((err = launch_pass<2>(m2, a, d, f, s)) != cudaSuccess) return (int)err;
  if ((err = launch_pass<3>(m3, a, C, d, s)) != cudaSuccess) return (int)err;
  if ((err = launch_pass<4>(m4, a, d, f, s)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
