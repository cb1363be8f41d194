// Fused int8 residual quantize-pack for Hopper (sm_90a), the wire codec's
// hot path.  Per row of the (N, d) payload:
//   r     = value - base
//   scale = max(amax|r| * f32(1/127), eps)
//   q     = clip(round_half_even(r / scale), -127, 127)       -> int8 (N, d)
//   recon = base + q * scale                                  -> (N, d)
// with scale written as f32 (N, 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/residual_codec.py
// (residual_int8_pallas), which holds a (bn, d) row tile in VMEM.  Here one
// warp owns one row: a first pass reduces the abs-max over d with warp
// shuffles, a second pass writes q, recon and the scale.  Rounding is rintf
// (half to even, like jnp.round); the quotient is an IEEE division and
// recon avoids FMA contraction, so the arithmetic is the reference's.
//
// Bound: memory.  At N=4096, d=1152 (the combine payload of 8 DiT-MoE-XL
// requests) it must read 37.7 MB and write 23.6 MB; H100 SXM HBM3 moves
// 3.35 TB/s.  The second pass re-reads the row from L1/L2, not from HBM.
#include "common.cuh"

namespace dice {
namespace {

constexpr int ROWS_PER_BLOCK = 8;       // one warp per row

template <typename T>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
residual_int8_kernel(const T* __restrict__ value, const T* __restrict__ base,
                     int8_t* __restrict__ q, float* __restrict__ scale,
                     T* __restrict__ recon, int N, int d, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const size_t off = (size_t)row * d;
  const T* v = value + off;
  const T* b = base + off;

  float amax = 0.0f;
  for (int i = lane; i < d; i += 32) amax = fmaxf(amax, fabsf(load_f32(v + i) - load_f32(b + i)));
  amax = warp_max(amax);
  // amax * f32(1/127): XLA compiles the reference's division by the
  // constant 127 into this product, so the scales agree to the bit
  const float s = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), eps);

  for (int i = lane; i < d; i += 32) {
    const float bi = load_f32(b + i);
    const float r = load_f32(v + i) - bi;
    const float qi = fminf(fmaxf(rintf(r / s), -127.0f), 127.0f);
    q[off + i] = (int8_t)qi;
    store_f32(recon + off + i, __fadd_rn(bi, __fmul_rn(qi, s)));
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
void launch(const void* value, const void* base, void* q, void* scale, void* recon,
            int N, int d, float eps, cudaStream_t stream) {
  const dim3 grid((N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  residual_int8_kernel<T><<<grid, ROWS_PER_BLOCK * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const T*>(base),
      static_cast<int8_t*>(q), static_cast<float*>(scale), static_cast<T*>(recon), N, d,
      eps);
}

}  // namespace
}  // namespace dice

// dtype: 0 f32, 1 bf16 (value, base and recon share it).  Returns
// cudaGetLastError().
extern "C" int dice_residual_int8(const void* value, const void* base, void* q,
                                  void* scale, void* recon, int N, int d, float eps,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 0 && d > 0) {
    if (dtype == dice::kF32)
      dice::launch<float>(value, base, q, scale, recon, N, d, eps, s);
    else
      dice::launch<__nv_bfloat16>(value, base, q, scale, recon, N, d, eps, s);
  }
  return (int)cudaGetLastError();
}
