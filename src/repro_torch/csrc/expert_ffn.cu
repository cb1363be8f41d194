// Grouped gated expert MLP for Hopper (sm_90a) on the tensor cores:
//   out[e] = (act(buf[e] @ Wg[e]) * (buf[e] @ Wu[e])) @ Wd[e]
// buf (E, C, d), Wg/Wu (E, d, f), Wd (E, f, d), all row-major; f32 or bf16
// in, the dtype of buf out, f32 accumulation throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/expert_ffn.py
// (expert_ffn_pallas), which carries the (bc, bf) gate/up sums and the
// (bc, d) output sum in VMEM across sequential grid steps.  Hopper runs
// blocks in no order, so nothing carries across blocks; the work is two
// launches of one grouped GEMM main loop:
//   1. gate_up_kernel: a block owns 128 rows x 64 columns of f of one
//      expert, keeps one A tile in shared memory for both products (two
//      accumulators), and writes h = act(g) * u to an f32 scratch (E, C, f)
//      in its epilogue with float2 stores;
//   2. down_kernel: a block owns 128 rows x 128 columns of d and computes
//      h @ Wd.
// A down projection fused into (1) would need a (rows x d) f32 sum per
// block, which does not fit; the h round trip costs ~0.06 ms at XL.
//
// Bound: at DiT-MoE-XL refresh shapes (E=8, C=640, d=1152, f=4608) the
// products are 163 GFLOP against 0.5 GB of weights, so operations bound
// it.  The products run on the tensor cores as mma.sync m16n8k8 tf32 with
// the 3xTF32 split (tf32_mma.cuh): f32 accuracy, as the JAX package's f32
// numerics and TOL_F32 need, at up to 165 TFLOP/s against the CUDA cores'
// 67.  wgmma takes tf32 operands only K-major from shared memory, and Wg,
// Wu, Wd and h are N-major here; mma.sync reads fragments in any layout.
//   - 4 warps as 2 (rows) x 2 (columns); a warp owns 64 x 64 outputs, 4 x 8
//     m16n8 tiles (gate/up: 4 gate and 4 up tiles of the same columns, so
//     one thread holds g and u of an output for the epilogue).  Per 8-deep
//     k-step a warp splits 16 A and 16 B fragment values for 96 mmas; the
//     split (cvt, sub, cvt) is the cost that the wide warp tile spreads.
//   - BK = 32, a 2-stage cp.async ring of A and B tiles in dynamic shared
//     memory (72 KB gate/up, 70 KB down), 255 registers a thread (down
//     spills 20 bytes, -Xptxas -v): two blocks, 8 warps, per SM.  16-byte
//     cp.async.cg with zero-fill on ragged edges where rows are 16-byte
//     aligned, element loads otherwise.
//   - On an H100 SXM (launch/kernel_variants.py), 64-row blocks of 4 warps
//     with 64 x 32 warp tiles ran the XL refresh shape (C = 640) 1.2x as
//     long and the light shape (C = 320, where 128-row blocks waste 64 of
//     384 rows) 6% faster; refresh-size calls are 80% of a DICE run's, so
//     the wide tiles win; a third pipeline stage did not help.
//   - Rows of A are padded to BK + 4 floats and rows of B to BN + 8, so
//     the A fragment (rows g, columns t) and the B fragment of the row-
//     major weights (rows t, columns g) each hit 32 different banks.
//   - bf16 operands are exact in tf32, so gate/up in bf16 runs one mma per
//     tile and down two (h is f32).
//   - Blocks walk rows fastest, so the C / 128 blocks that read one weight
//     tile run together and the weights come from HBM about once.
// Ragged C, d and f edges are masked, so any capacity and width work.
// The tiling and the main loop live in expert_ffn_gemm.cuh, which the
// backward kernels (expert_ffn_bwd.cu) share.
#include "expert_ffn_gemm.cuh"

namespace dice {
namespace {

template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
gate_up_kernel(const T* __restrict__ buf, const T* __restrict__ wg,
               const T* __restrict__ wu, float* __restrict__ h, int C, int d, int f,
               int act, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.z;
  float acc[4][NJ][4];
  gemm_mainloop<T, T, true>(buf + (size_t)e * C * d, wg + (size_t)e * d * f,
                            wu + (size_t)e * d * f, C, d, f, vec_a, vec_b, smem, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float* H = h + (size_t)e * C * f;
  const int r0 = blockIdx.x * BM + wm * 64 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      const int c = blockIdx.y * Layout<T, T, true>::BN + wn * 4 * NJ + jj * 8 + 2 * (lane & 3);
      if (c >= f) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + i * 16 + half * 8;
        if (r >= C) continue;
        constexpr int U = NJ / 2;             // up tiles follow the gate tiles
        const float v0 = activation(acc[i][jj][2 * half], act) * acc[i][jj + U][2 * half];
        const float v1 =
            activation(acc[i][jj][2 * half + 1], act) * acc[i][jj + U][2 * half + 1];
        store2(H + (size_t)r * f + c, v0, v1, f % 2 == 0 && c + 1 < f, c + 1 < f);
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
down_kernel(const float* __restrict__ h, const T* __restrict__ wd, T* __restrict__ out,
            int C, int d, int f, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.z;
  float acc[4][NJ][4];
  gemm_mainloop<float, T, false>(h + (size_t)e * C * f, wd + (size_t)e * f * d, nullptr,
                                 C, f, d, vec_a, vec_b, smem, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  T* O = out + (size_t)e * C * d;
  const int r0 = blockIdx.x * BM + wm * 64 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = blockIdx.y * Layout<float, T, false>::BN + wn * 8 * NJ + j * 8 + 2 * (lane & 3);
      if (c >= d) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + i * 16 + half * 8;
        if (r >= C) continue;
        store2(O + (size_t)r * d + c, acc[i][j][2 * half], acc[i][j][2 * half + 1],
               d % 2 == 0 && c + 1 < d, c + 1 < d);
      }
    }
}

template <typename T>
cudaError_t launch(const void* buf, const void* wg, const void* wu, const void* wd,
                   float* h, void* out, int E, int C, int d, int f, int act,
                   cudaStream_t stream) {
  using LG = Layout<T, T, true>;
  using LD = Layout<float, T, false>;
  const long long es = sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gate_up_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LG::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(down_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)LD::BYTES);
  if (err != cudaSuccess) return err;
  const int vec_buf = rows_16b_aligned(buf, d * es);
  const int vec_gu = rows_16b_aligned(wg, f * es) && rows_16b_aligned(wu, f * es);
  const int vec_h = rows_16b_aligned(h, f * 4LL);
  const int vec_wd = rows_16b_aligned(wd, d * es);
  const dim3 grid1((C + BM - 1) / BM, (f + LG::BN - 1) / LG::BN, E);
  gate_up_kernel<T><<<grid1, NT, LG::BYTES, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(wg), static_cast<const T*>(wu), h,
      C, d, f, act, vec_buf, vec_gu);
  const dim3 grid2((C + BM - 1) / BM, (d + LD::BN - 1) / LD::BN, E);
  down_kernel<T><<<grid2, NT, LD::BYTES, stream>>>(
      h, static_cast<const T*>(wd), static_cast<T*>(out), C, d, f, vec_h, vec_wd);
  return cudaSuccess;
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
      err = dice::launch<float>(buf, wg, wu, wd, static_cast<float*>(h), out, E, C, d, f,
                                act, s);
    else
      err = dice::launch<__nv_bfloat16>(buf, wg, wu, wd, static_cast<float*>(h), out, E, C,
                                        d, f, act, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
