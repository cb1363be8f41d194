// Grouped gated expert MLP for Hopper (sm_90a):
//   out[e] = (act(buf[e] @ Wg[e]) * (buf[e] @ Wu[e])) @ Wd[e]
// buf (E, C, d), Wg/Wu (E, d, f), Wd (E, f, d), all row-major; f32 or bf16
// in, the dtype of buf out, f32 accumulation throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/expert_ffn.py
// (expert_ffn_pallas).  That kernel carries the (bc, bf) gate/up sums and
// the (bc, d) output sum in VMEM across sequential grid steps.  Hopper runs
// blocks in no order, so nothing carries across blocks; the work is two
// launches instead:
//   1. gate_up: one block per (f-tile, C-tile, e) loops over d in shared-
//      memory tiles, keeps g and u in f32 registers and writes
//      h = act(g) * u to an f32 scratch (E, C, f);
//   2. down: one block per (d-tile, C-tile, e) computes h @ Wd.
// Ragged C, d and f edges are masked, so any capacity and width work.
//
// Bound: at DiT-MoE-XL refresh shapes (E=8, C=640, d=1152, f=4608) the
// products are ~163 GFLOP against ~0.5 GB of weights, so the kernel is
// bound by operations.  With f32 in it runs on the FP32 CUDA cores (FMA,
// no TF32, to match the JAX package's f32 numerics), whose peak on an H100
// SXM is 67 TFLOP/s.  The tiling is the plain 64x64 shared-memory SGEMM
// with a 4x4 register tile per thread; wgmma/TMA pipelines are later work.
#include "common.cuh"

namespace dice {
namespace {

constexpr int BM = 64;    // rows of C per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 16;    // contraction tile
constexpr int NT = 256;   // threads: a 16x16 grid, 4x4 outputs each
constexpr int PAD = 4;

__device__ __forceinline__ float activation(float g, int act) {
  if (act == 0) return g * (1.0f / (1.0f + expf(-g)));  // silu
  // gelu, tanh approximation (jax.nn.gelu's default)
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * g * (1.0f + tanhf(k * (g + 0.044715f * g * g * g)));
}

// Loads a BM x BK tile of the row-major (rows x cols) matrix A starting at
// (row0, k0) into As[k][row], zero-filling outside the matrix.
template <typename T>
__device__ __forceinline__ void load_a_tile(float (*As)[BM + PAD], const T* A,
                                            int rows, int cols, int row0, int k0) {
#pragma unroll
  for (int l = 0; l < (BM * BK) / NT; ++l) {
    const int idx = threadIdx.x + l * NT;
    const int r = idx / BK, kk = idx % BK;
    const int gr = row0 + r, gk = k0 + kk;
    As[kk][r] = (gr < rows && gk < cols) ? load_f32(A + (size_t)gr * cols + gk) : 0.0f;
  }
}

// Loads a BK x BN tile of the row-major (rows x cols) matrix B starting at
// (k0, col0) into Bs[k][col].
template <typename T>
__device__ __forceinline__ void load_b_tile(float (*Bs)[BN + PAD], const T* B,
                                            int rows, int cols, int k0, int col0) {
#pragma unroll
  for (int l = 0; l < (BK * BN) / NT; ++l) {
    const int idx = threadIdx.x + l * NT;
    const int kk = idx / BN, c = idx % BN;
    const int gk = k0 + kk, gc = col0 + c;
    Bs[kk][c] = (gk < rows && gc < cols) ? load_f32(B + (size_t)gk * cols + gc) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
gate_up_kernel(const T* __restrict__ buf, const T* __restrict__ wg,
               const T* __restrict__ wu, float* __restrict__ h,
               int C, int d, int f, int act) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Gs[BK][BN + PAD];
  __shared__ float Us[BK][BN + PAD];
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const T* A = buf + (size_t)e * C * d;
  const T* G = wg + (size_t)e * d * f;
  const T* U = wu + (size_t)e * d * f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float accg[4][4], accu[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accg[i][j] = accu[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    load_a_tile(As, A, C, d, row0, k0);
    load_b_tile(Gs, G, d, f, k0, col0);
    load_b_tile(Us, U, d, f, k0, col0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bg[4], bu[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bg[j] = Gs[kk][tx + 16 * j];
        bu[j] = Us[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accg[i][j] = fmaf(a[i], bg[j], accg[i][j]);
          accu[i][j] = fmaf(a[i], bu[j], accu[i][j]);
        }
    }
    __syncthreads();
  }

  float* H = h + (size_t)e * C * f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < C && c < f) H[(size_t)r * f + c] = activation(accg[i][j], act) * accu[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
down_kernel(const float* __restrict__ h, const T* __restrict__ wd,
            T* __restrict__ out, int C, int d, int f) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const float* A = h + (size_t)e * C * f;
  const T* B = wd + (size_t)e * f * d;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < f; k0 += BK) {
    load_a_tile(As, A, C, f, row0, k0);
    load_b_tile(Bs, B, f, d, k0, col0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* O = out + (size_t)e * C * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < C && c < d) store_f32(O + (size_t)r * d + c, acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* buf, const void* wg, const void* wu, const void* wd,
            float* h, void* out, int E, int C, int d, int f, int act,
            cudaStream_t stream) {
  const dim3 block(NT);
  const dim3 grid1((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  gate_up_kernel<T><<<grid1, block, 0, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(wg),
      static_cast<const T*>(wu), h, C, d, f, act);
  const dim3 grid2((d + BN - 1) / BN, (C + BM - 1) / BM, E);
  down_kernel<T><<<grid2, block, 0, stream>>>(
      h, static_cast<const T*>(wd), static_cast<T*>(out), C, d, f);
}

}  // namespace
}  // namespace dice

// h: f32 scratch (E, C, f) the caller allocates; act: 0 silu, 1 gelu;
// dtype: 0 f32, 1 bf16.  Returns cudaGetLastError() after both launches.
extern "C" int dice_expert_ffn(const void* buf, const void* wg, const void* wu,
                               const void* wd, void* h, void* out, int E, int C,
                               int d, int f, int act, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 0 && C > 0 && d > 0 && f > 0) {
    if (dtype == dice::kF32)
      dice::launch<float>(buf, wg, wu, wd, static_cast<float*>(h), out, E, C, d, f, act, s);
    else
      dice::launch<__nv_bfloat16>(buf, wg, wu, wd, static_cast<float*>(h), out, E, C, d, f,
                                  act, s);
  }
  return (int)cudaGetLastError();
}
