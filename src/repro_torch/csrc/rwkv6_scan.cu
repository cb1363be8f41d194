// RWKV-6 time-mix recurrence for Hopper (sm_90a).  Per (b, h), over t:
//   out_t = r_t S + (sum_i r_t,i u_i k_t,i) v_t
//   S     = diag(exp(logw_t)) S + k_t^T v_t
// r, k, v, logw (B, H, T, DK) are read through strides (the last dim must be
// contiguous), u (H, DK) and s0 (B, H, DK, DK) contiguous; out (B, H, T, DK)
// and S_T (B, H, DK, DK) are f32 and contiguous.  r/k/v are f32 or bf16, logw
// and u f32 or that type, s0 f32; everything is widened to f32 on load.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py
// (rwkv6_scan_pallas).  That kernel keeps the (DK, DK) f32 state in VMEM
// while its grid walks the T/chunk axis of one (b, h) in order.  Hopper
// blocks run in no order, so here one block owns one (b, h) and the time
// loop runs inside it: DK threads, thread j holding column j of S in DK f32
// registers.  A tile of timesteps of r, k, v and w = exp(logw) is staged in
// shared memory (broadcast reads: every thread reads the same r_i, k_i,
// w_i), u once.  Each step follows the Pallas kernel's order, r S plus the
// bonus term before the update, so S never leaves the chip between steps.
//
// Bound: per (b, h, t) it reads r/k/v (2 B each in bf16) and logw (4 B) and
// writes out (4 B); per (b, h) it reads and writes DK^2 f32 of state; it
// does about 5 DK^2 FLOPs per (b, h, t) on the FP32 cores.  At the rwkv6-3b
// prefill shape (B=8, H=40, T=2048, DK=64) that is ~0.59 GB against ~13.4
// GFLOP, i.e. a few tenths of a millisecond either way.  The design is not
// bound by either: a block walks T dependent steps, and B*H = 320 blocks of
// 64 threads leave most of the 132 SMs' issue slots idle, so it is latency-
// bound.  Decode runs it with T = 1 (one state read and write per (b, h)).
// More threads per column with shuffle reductions, cp.async prefetch of the
// next tile and a chunked matmul form on the tensor cores are later work.
#include "common.cuh"

namespace dice {
namespace {

struct SeqStrides {
  long long b, h, t;      // element strides of a (B, H, T, DK) input
};

__device__ __forceinline__ float load_as_f32(const void* p, long long i, int dtype) {
  return dtype == kF32 ? static_cast<const float*>(p)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

template <int DK>
__global__ void __launch_bounds__(DK)
rwkv6_scan_kernel(const void* __restrict__ r, const void* __restrict__ k,
                  const void* __restrict__ v, const void* __restrict__ logw,
                  const void* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ out, float* __restrict__ sT, int H, int T,
                  SeqStrides rs, SeqStrides ks, SeqStrides vs, SeqStrides ws,
                  int rkv_dtype, int w_dtype, int u_dtype) {
  constexpr int TT = 2048 / DK;         // timesteps per staged tile: 32 KB
  __shared__ float sr[TT][DK], sk[TT][DK], sv[TT][DK], sw[TT][DK];
  __shared__ float su[DK];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  float S[DK];                          // column j of the state
  const float* s0p = s0 + (size_t)bh * DK * DK;
#pragma unroll
  for (int i = 0; i < DK; ++i) S[i] = s0p[i * DK + j];
  su[j] = load_as_f32(u, (long long)h * DK + j, u_dtype);

  const long long r0 = b * rs.b + h * rs.h + j, k0 = b * ks.b + h * ks.h + j,
                  v0 = b * vs.b + h * vs.h + j, w0 = b * ws.b + h * ws.h + j;
  float* outp = out + (size_t)bh * T * DK + j;

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int n = min(TT, T - t0);
    __syncthreads();                    // the last tile is consumed
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const long long t = t0 + s;
      sr[s][j] = load_as_f32(r, r0 + t * rs.t, rkv_dtype);
      sk[s][j] = load_as_f32(k, k0 + t * ks.t, rkv_dtype);
      sv[s][j] = load_as_f32(v, v0 + t * vs.t, rkv_dtype);
      sw[s][j] = expf(load_as_f32(logw, w0 + t * ws.t, w_dtype));
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      float rS = 0.0f, bonus = 0.0f;
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        const float ri = sr[s][i];
        rS = fmaf(ri, S[i], rS);
        bonus = fmaf(ri * su[i], sk[s][i], bonus);
      }
      const float vj = sv[s][j];
      outp[(size_t)(t0 + s) * DK] = rS + bonus * vj;
#pragma unroll
      for (int i = 0; i < DK; ++i) S[i] = fmaf(sw[s][i], S[i], sk[s][i] * vj);
    }
  }

  float* sTp = sT + (size_t)bh * DK * DK;
#pragma unroll
  for (int i = 0; i < DK; ++i) sTp[i * DK + j] = S[i];
}

template <int DK>
void launch(const void* r, const void* k, const void* v, const void* logw,
            const void* u, const void* s0, void* out, void* sT, int B, int H, int T,
            SeqStrides rs, SeqStrides ks, SeqStrides vs, SeqStrides ws, int rkv_dtype,
            int w_dtype, int u_dtype, cudaStream_t stream) {
  rwkv6_scan_kernel<DK><<<B * H, DK, 0, stream>>>(
      r, k, v, logw, u, static_cast<const float*>(s0), static_cast<float*>(out),
      static_cast<float*>(sT), H, T, rs, ks, vs, ws, rkv_dtype, w_dtype, u_dtype);
}

}  // namespace
}  // namespace dice

// Strides are in elements: *_sb, *_sh, *_st for the batch, head and time dims
// of r, k, v and logw.  Dtype codes (0 f32, 1 bf16): rkv_dtype for r/k/v,
// w_dtype for logw, u_dtype for u.  DK must be 16, 32, 64 or 128.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for another DK).
extern "C" int dice_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* logw, const void* u,
    const void* s0, void* out, void* sT, int B, int H, int T, int DK, long long r_sb,
    long long r_sh, long long r_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long w_sb, long long w_sh,
    long long w_st, int rkv_dtype, int w_dtype, int u_dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaGetLastError();
  const dice::SeqStrides rs{r_sb, r_sh, r_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, ws{w_sb, w_sh, w_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DICE_RWKV6_CASE(N)                                                          \
  case N:                                                                           \
    dice::launch<N>(r, k, v, logw, u, s0, out, sT, B, H, T, rs, ks, vs, ws,         \
                    rkv_dtype, w_dtype, u_dtype, s);                                \
    break;
  switch (DK) {
    DICE_RWKV6_CASE(16)
    DICE_RWKV6_CASE(32)
    DICE_RWKV6_CASE(64)
    DICE_RWKV6_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DICE_RWKV6_CASE
  return (int)cudaGetLastError();
}
