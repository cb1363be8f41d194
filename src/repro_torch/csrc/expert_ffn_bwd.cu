// Backward of the grouped gated expert MLP for Hopper (sm_90a), f32 or
// bf16:
//   forward  G = X Wg,  U = X Wu,  H = act(G) * U,  Y = H Wd   (per expert)
//   backward dH = dY Wd^T,  dG = dH * U * act'(G),  dU = dH * act(G)
//            dWd = H^T dY,  dX = dG Wg^T + dU Wu^T,  dWg = X^T dG,  dWu = X^T dU
// X (E, C, d), Wg/Wu (E, d, f), Wd (E, f, d), dY (E, C, d), all row-major,
// of one dtype; dX, dWg, dWu, dWd in that dtype.
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
//
// bf16 (the LM MoE family's params and tokens): a first launch widens X,
// dY, Wg, Wu and Wd into an f32 copy (a stage the caller allocates), the
// five passes run on it as for f32 inputs, and the epilogues round each
// gradient to bf16 once from its f32 sum.  G, U, H, dG and dU stay f32 in
// the scratch: the reference's bf16 einsums round them, but with them in
// f32 every step-0 gradient of the MoE smoke configs meets the bf16
// tolerance against jax.grad with room to spare
// (tests/test_torch_moe_train.py), so one rounding at the end it is.  A
// bf16 value is exact in tf32, so the small parts of the widened operands
// are 0 and a third of the wgmmas add nothing; bf16 wgmma (k16, f32
// accumulate) on the bf16 operands would run those products at three
// times the rate, and is later work.  The widening pass reads the inputs
// once and writes twice their bytes.
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
  void* dx;       // the gradients, of the epilogues' output type
  void* dwg;
  void* dwu;
  void* dwd;
  int E, C, d, f, cp, act;
};

// dst[i] = src[i] in f32, i < n: 16-byte pieces of 8 elements (both
// pointers 16-byte aligned), the last n % 8 one at a time
__global__ void widen_kernel(const __nv_bfloat16* __restrict__ src, float* __restrict__ dst,
                             long long n) {
  const long long n8 = n / 8;
  const long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = i0; i < n8; i += stride) {
    const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]),
                 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[2 * i] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[2 * i + 1] = make_float4(c.x, c.y, e.x, e.y);
  }
  if (i0 < n - 8 * n8) dst[8 * n8 + i0] = __bfloat162float(src[8 * n8 + i0]);
}

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

// TO: the gradients' type (float or __nv_bfloat16), each rounded once
template <int PASS, typename TO>
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
          TO* dWd = static_cast<TO*>(a.dwd) + (size_t)e * f * d;
          each_pair<C::BN>(wgi, q, g, t, [&](int r, int c, int i) {
            const int m = m0 + r, n = n0 + c;
            if (m >= d) return;
            if (n < f) store_f32(dWd + (size_t)n * d + m, acc[0][i]);
            if (n + 1 < f) store_f32(dWd + (size_t)(n + 1) * d + m, acc[0][i + 1]);
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
          TO* dX = static_cast<TO*>(a.dx) + (size_t)e * Cc * d;
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
          TO* dWg = static_cast<TO*>(a.dwg) + (size_t)e * d * f;
          TO* dWu = static_cast<TO*>(a.dwu) + (size_t)e * d * f;
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

template <int PASS, typename TO>
cudaError_t launch_pass(const Maps& maps, const BwdArgs& a, int M, int N, cudaStream_t stream) {
  using C = typename PassCfg<PASS>::type;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_wgmma_kernel<PASS, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + wg::BM - 1) / wg::BM, a.E);
  bwd_wgmma_kernel<PASS, TO><<<grid, wg::THREADS, C::BYTES, stream>>>(maps, a);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_passes(const Maps (&m)[5], const BwdArgs& a, cudaStream_t s) {
  cudaError_t err;
  // passes 0 and 1 write only the f32 scratch
  if ((err = launch_pass<0, float>(m[0], a, a.f, a.C, s)) != cudaSuccess) return err;
  if ((err = launch_pass<1, float>(m[1], a, a.f, a.C, s)) != cudaSuccess) return err;
  if ((err = launch_pass<2, TO>(m[2], a, a.d, a.f, s)) != cudaSuccess) return err;
  if ((err = launch_pass<3, TO>(m[3], a, a.C, a.d, s)) != cudaSuccess) return err;
  return launch_pass<4, TO>(m[4], a, a.d, a.f, s);
}

}  // namespace
}  // namespace dice

// scratch: f32 (3, E, f, cp) the caller allocates (G^T, U^T, H^T), cp >= C
// a multiple of 4; d and f multiples of 4; every pointer 16-byte aligned;
// C > 0.  dtype: 0 f32, 1 bf16 (x, w_g, w_u, w_d, dy and the gradients);
// for bf16, stage: f32 room for 2 E C d + 3 E d f elements (the widened
// inputs), else unused.  act: 0 silu, 1 gelu.  Returns
// cudaErrorInvalidValue for what it does not take or a tensor map it
// cannot encode, else the first launch error, else cudaGetLastError().
extern "C" int dice_expert_ffn_bwd(const void* x, const void* w_g, const void* w_u,
                                   const void* w_d, const void* dy, void* scratch, void* stage,
                                   void* dx, void* dwg, void* dwu, void* dwd, int E, int C,
                                   int d, int f, int cp, int act, int dtype, int device,
                                   void* stream) {
  using namespace dice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || d % 4 || f % 4 || cp % 4 || cp < C ||
      (dtype != kF32 && dtype != kBF16) || (dtype == kBF16 && stage == nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, w_g, w_u, w_d, dy, (const void*)scratch, (const void*)stage})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cd = (long long)C * d, df = (long long)d * f, fc = (long long)f * cp;
  if (dtype == kBF16) {                 // widen the five inputs into the stage
    float* st = static_cast<float*>(stage);
    const void* src[5] = {x, dy, w_g, w_u, w_d};
    const long long n[5] = {E * cd, E * cd, E * df, E * df, E * df};
    float* dst[5];
    for (int i = 0; i < 5; ++i) {
      dst[i] = st;
      st += n[i];
      const long long blocks = (n[i] / 8 + 255) / 256 + 1;
      widen_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(src[i]), dst[i], n[i]);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    x = dst[0], dy = dst[1], w_g = dst[2], w_u = dst[3], w_d = dst[4];
  }
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  Maps m[5] = {};
  bool ok = true;
  // A boxes: 32 x 32 (M-major) or 32 x 128 (K-major); B boxes: 32 x BN
  const int bn0 = PassCfg<0>::type::BN, bn1 = PassCfg<1>::type::BN,
            bn2 = PassCfg<2>::type::BN, bn3 = PassCfg<3>::type::BN,
            bn4 = PassCfg<4>::type::BN;
  // pass 0: A Wg^T, Wu^T (M-major boxes of f x d), B X (rows of C)
  ok &= make_map(&m[0].a0, F(w_g), f, d, E, f, df, 32, 32);
  ok &= make_map(&m[0].a1, F(w_u), f, d, E, f, df, 32, 32);
  ok &= make_map(&m[0].b0, F(x), d, C, E, d, cd, 32, bn0);
  // pass 1: A Wd (K-major rows of f), B dY
  ok &= make_map(&m[1].a0, F(w_d), d, f, E, d, (long long)f * d, 32, wg::BM);
  ok &= make_map(&m[1].b0, F(dy), d, C, E, d, cd, 32, bn1);
  // pass 2: A dY^T (M-major boxes of d x C), B H^T (rows of f, K = C)
  ok &= make_map(&m[2].a0, F(dy), d, C, E, d, cd, 32, 32);
  ok &= make_map(&m[2].b0, F(scratch), C, f, 3LL * E, cp, fc, 32, bn2);
  // pass 3: A dG, dU (M-major boxes of C x f), B Wg, Wu (rows of d, K = f)
  ok &= make_map(&m[3].a0, F(scratch), C, f, 3LL * E, cp, fc, 32, 32);
  ok &= make_map(&m[3].b0, F(w_g), f, d, E, f, df, 32, bn3);
  ok &= make_map(&m[3].b1, F(w_u), f, d, E, f, df, 32, bn3);
  // pass 4: A X^T (M-major boxes of d x C), B dG^T, dU^T (rows of f, K = C)
  ok &= make_map(&m[4].a0, F(x), d, C, E, d, cd, 32, 32);
  ok &= make_map(&m[4].b0, F(scratch), C, f, 3LL * E, cp, fc, 32, bn4);
  if (!ok) return (int)cudaErrorInvalidValue;
  const BwdArgs a{static_cast<float*>(scratch), dx, dwg, dwu, dwd, E, C, d, f, cp, act};
  err = dtype == kF32 ? launch_passes<float>(m, a, s) : launch_passes<__nv_bfloat16>(m, a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
