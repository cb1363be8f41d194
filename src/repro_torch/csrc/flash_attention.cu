// Online-softmax attention for Hopper (sm_90a).
//   q (B, Sq, H, Dh), k/v (B, Sk, KVH, Dh) -> o (B, Sq, H, Dh)
// read and written through strides in that layout (the last dim must be
// contiguous), so the caller makes no transposed copy.  Options exactly as
// the Pallas kernel's: causal, sliding window (symmetric when not causal),
// logit softcap, GQA by h // (H / KVH); masked logits are -1e30 (not -inf),
// so a fully masked row gives the mean of V; l is clamped at 1e-30.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention).  That kernel keeps m/l/acc in VMEM scratch across the
// sequential kv-block grid dimension.  Here one block owns (b, h, a tile of
// 32 query rows) and loops over 64-key k/v tiles held in shared memory;
// each warp owns 4 query rows and keeps their running max, sum and output
// accumulator in f32 registers (lane i holds dims i, i+32, ... of a row),
// so nothing carries across blocks.  Dh up to 256.
//
// Bound: at the DiT-MoE-XL shape (8, 256, 16, 72) the work is ~2.4 GFLOP
// against ~19 MB of q/k/v/o, so it is bound by operations, which run on the
// FP32 CUDA cores (67 TFLOP/s peak on an H100 SXM).  Scores and P.V are
// plain FMA loops over shared memory; tensor-core (wgmma) tiles are later
// work.
#include "common.cuh"

namespace dice {
namespace {

constexpr int WARPS = 8;
constexpr int ROWS = 4;                 // query rows per warp
constexpr int BQ = WARPS * ROWS;        // query rows per block
constexpr int BKV = 64;                 // keys per tile: two per lane
constexpr int MAXCH = 8;                // Dh <= 32 * MAXCH = 256
constexpr float MASKED = -1e30f;

struct Strides {
  long long b, s, h;
};

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
             int KVH, int Dh, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int has_window, int window, int has_softcap,
             float softcap, float scale) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;                // padded: lanes read distinct banks
  float* Qs = smem;                     // BQ x ld
  float* Ks = Qs + BQ * ld;             // BKV x ld
  float* Vs = Ks + BKV * ld;            // BKV x ld
  float* Ps = Vs + BKV * ld;            // WARPS x BKV

  const int bh = blockIdx.y;
  const int b = bh / H, hh = bh % H;
  const int kvh = hh / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = WARPS * 32;

  const T* qb = q + b * qs.b + hh * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int idx = threadIdx.x; idx < BQ * Dh; idx += nthreads) {
    const int r = idx / Dh, dd = idx % Dh;
    const int gq = q0 + r;
    Qs[r * ld + dd] = gq < Sq ? load_f32(qb + gq * qs.s + dd) * scale : 0.0f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][MAXCH];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = MASKED;
    l[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXCH; ++c) acc[rr][c] = 0.0f;
  }
  float* Pw = Ps + warp * BKV;

  for (int k0 = 0; k0 < Sk; k0 += BKV) {
    __syncthreads();                    // previous tile fully consumed
    for (int idx = threadIdx.x; idx < BKV * Dh; idx += nthreads) {
      const int r = idx / Dh, dd = idx % Dh;
      const int gk = k0 + r;
      Ks[r * ld + dd] = gk < Sk ? load_f32(kb + gk * ks.s + dd) : 0.0f;
      Vs[r * ld + dd] = gk < Sk ? load_f32(vb + gk * vs.s + dd) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      const int pq = q0 + r;
      const float* qr = Qs + r * ld;
      float s[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        const int pk = k0 + j;
        const float* kr = Ks + j * ld;
        float dot = 0.0f;
        for (int dd = 0; dd < Dh; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        if (has_softcap) dot = softcap * tanhf(dot / softcap);
        bool keep = true;
        if (causal) keep = keep && (pq >= pk);
        if (has_window) {
          keep = keep && (pq - pk) < window;
          if (!causal) keep = keep && (pk - pq) < window;
        }
        if (!keep) dot = MASKED;
        // keys past Sk are padding, not masked keys: they get weight 0
        s[jj] = pk < Sk ? dot : -INFINITY;
      }
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p0 + p1);
      m[rr] = m_new;
      Pw[lane] = p0;
      Pw[lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < MAXCH; ++c) acc[rr][c] *= corr;
      for (int j = 0; j < BKV; ++j) {
        const float pj = Pw[j];
        const float* vr = Vs + j * ld;
#pragma unroll
        for (int c = 0; c < MAXCH; ++c) {
          const int dd = lane + 32 * c;
          if (dd < Dh) acc[rr][c] = fmaf(pj, vr[dd], acc[rr][c]);
        }
      }
      __syncwarp();
    }
  }

  T* ob = o + b * os.b + hh * os.h;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int pq = q0 + warp * ROWS + rr;
    if (pq >= Sq) continue;
    const float lc = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < MAXCH; ++c) {
      const int dd = lane + 32 * c;
      if (dd < Dh) store_f32(ob + pq * os.s + dd, acc[rr][c] / lc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KVH, int Dh, Strides qs, Strides ks,
                   Strides vs, Strides os, int causal, int has_window, int window,
                   int has_softcap, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BKV) * (Dh + 1) + WARPS * BKV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KVH, Dh, qs, ks, vs, os, causal, has_window,
      window, has_softcap, softcap, (float)(1.0 / sqrt((double)Dh)));
  return cudaSuccess;
}

}  // namespace
}  // namespace dice

// Strides are in elements: *_sb, *_ss, *_sh for the batch, sequence and head
// dims of each tensor.  dtype: 0 f32, 1 bf16.  Returns cudaGetLastError().
extern "C" int dice_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
    int H, int KVH, int Dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    int has_window, int window, int has_softcap, float softcap, int dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaGetLastError();
  const dice::Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dice::kF32)
    err = dice::launch<float>(q, k, v, o, B, Sq, Sk, H, KVH, Dh, qs, ks, vs, os, causal,
                              has_window, window, has_softcap, softcap, s);
  else
    err = dice::launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KVH, Dh, qs, ks, vs, os,
                                      causal, has_window, window, has_softcap, softcap, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
