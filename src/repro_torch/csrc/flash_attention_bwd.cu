// Backward of unmasked attention for Hopper (sm_90a), f32, in the standard
// recompute form:
//   q (B, Sq, H, Dh), k/v (B, Sk, H, Dh), o and dO (B, Sq, H, Dh), read
//   through strides (head dim contiguous); lse (B, H, Sq) f32 from the
//   forward kernel (flash_attention.cu); dq/dk/dv contiguous f32.
//   scale = 1/sqrt(Dh),  P = exp(S scale - lse),  D = rowsum(dO * O)
//   dV = P^T dO,  dS = P (dO V^T - D),  dQ = dS K scale,  dK = dS^T Q scale
//
// No Pallas kernel is replaced: the JAX package trains through XLA's
// autodiff of repro.kernels.ref, so this is written for Hopper from the
// formulas.  The DiT needs no mask, no softcap and H == KVH; the wrapper
// (kernels/ops.py) raises for the rest, and for bf16 and Dh > 128.
//
// Bound: at the DiT-MoE-XL shape (8, 256, 16, 72) the backward is 2.5x the
// forward's products, 6.04e9 FLOP against 75 MB of q/k/v/o/dO/dq/dk/dv:
// operations bound it (0.090 ms on the FP32 cores, 0.0366 ms at 3xTF32 on
// the tensor cores).  This first kernel is the simple one: FP32 FMAs on the
// CUDA cores from shared memory, three launches, no atomics (every output
// element is summed by one thread in a fixed order, so two runs agree bit
// for bit):
//   1. flash_bwd_delta: D, one warp a row;
//   2. flash_bwd_dkdv: a block of 256 threads owns 64 keys of one (b, h),
//      keeps K and V in shared memory and loops over the queries in tiles
//      of 64: it rebuilds P^T and dS^T (64 x 64, through shared memory) and
//      accumulates dV += P^T dO and dK += dS^T (Q scale) in registers;
//   3. flash_bwd_dq: a block owns 64 queries, loops over the keys in tiles
//      of 64, rebuilds dS and accumulates dQ += dS K, scaled at the end.
// S is rebuilt as (q scale) . k, the forward's order.  A thread holds 4 x 4
// entries of a 64 x 64 tile (rows ty + 16 i, columns tx + 16 j) and 4 rows
// x Dh / 16 columns of its accumulators; shared rows are padded to an odd
// length (DP + 1, 65), so the 16 columns a half-warp reads fall in 16
// banks.  Dh is padded with zeros to DP = 16 NDJ (the template argument),
// keys past Sk and queries past Sq get P = 0.
#include "common.cuh"

namespace dice {
namespace {

constexpr int BT = 64;                  // queries or keys per tile
constexpr int THREADS = 256;            // 16 x 16

struct Strides {
  long long b, s, h;
};

template <int NDJ>
struct Smem {
  static constexpr int DP = 16 * NDJ;   // padded head dim
  static constexpr int LD = DP + 1;     // shared row length (odd)
  static constexpr int LP = BT + 1;     // P / dS row length
};

// BT rows x DP of a (B, S, H, Dh) tensor (positions pos0 ...) into shared
// rows of length LD, times mul, zero past S and past Dh.
template <int NDJ>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ss, int pos0,
                                          int S, int Dh, float mul) {
  constexpr int DP = Smem<NDJ>::DP, LD = Smem<NDJ>::LD;
  for (int idx = threadIdx.x; idx < BT * DP; idx += THREADS) {
    const int r = idx / DP, dd = idx % DP;
    const int p = pos0 + r;
    dst[r * LD + dd] = p < S && dd < Dh ? src[p * ss + dd] * mul : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                       float* __restrict__ delta, int Sq, int H, int Dh, Strides os,
                       Strides dos, long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int q = row % Sq;
  const int hh = (row / Sq) % H;
  const int b = row / ((long long)Sq * H);
  const float* orow = o + b * os.b + q * os.s + hh * os.h;
  const float* drow = dO + b * dos.b + q * dos.s + hh * dos.h;
  float sum = 0.0f;
  for (int dd = lane; dd < Dh; dd += 32) sum += orow[dd] * drow[dd];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;      // row = (b * H + h) * Sq + q
}

template <int NDJ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                      int Dh, Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  using SM = Smem<NDJ>;
  constexpr int LD = SM::LD, LP = SM::LP;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                       // BT x LD
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;             // q * scale
  float* dOs = Qs + BT * LD;
  float* Pt = dOs + BT * LD;            // P^T: BT keys x LP
  float* dSt = Pt + BT * LP;            // dS^T
  float* lse_s = dSt + BT * LP;         // BT
  float* del_s = lse_s + BT;

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int k0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<NDJ>(Ks, k + b * ks.b + hh * ks.h, ks.s, k0, Sk, Dh, 1.0f);
  load_rows<NDJ>(Vs, v + b * vs.b + hh * vs.h, vs.s, k0, Sk, Dh, 1.0f);
  const float* qb = q + b * qs.b + hh * qs.h;
  const float* dob = dO + b * dos.b + hh * dos.h;
  const float* lseb = lse + (size_t)bh * Sq;
  const float* delb = delta + (size_t)bh * Sq;

  float adk[4][NDJ], adv[4][NDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NDJ; ++j) adk[i][j] = adv[i][j] = 0.0f;

  for (int q0 = 0; q0 < Sq; q0 += BT) {
    __syncthreads();                    // the last tile's P^T, dS^T, Q, dO consumed
    load_rows<NDJ>(Qs, qb, qs.s, q0, Sq, Dh, scale);
    load_rows<NDJ>(dOs, dob, dos.s, q0, Sq, Dh, 1.0f);
    if (threadIdx.x < BT) {
      const int p = q0 + threadIdx.x;
      lse_s[threadIdx.x] = p < Sq ? lseb[p] : 0.0f;
      del_s[threadIdx.x] = p < Sq ? delb[p] : 0.0f;
    }
    __syncthreads();
    // S^T and dP^T for keys ty + 16 i, queries tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int dd = 0; dd < SM::DP; ++dd) {
      float kv[4], vv[4], qv[4], dv_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * LD + dd];
        vv[i] = Vs[(ty + 16 * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * LD + dd];
        dv_[j] = dOs[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dv_[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = ty + 16 * i, qq = tx + 16 * j;
        const bool in = k0 + key < Sk && q0 + qq < Sq;
        const float p = in ? expf(s[i][j] - lse_s[qq]) : 0.0f;
        Pt[key * LP + qq] = p;
        dSt[key * LP + qq] = in ? p * (dp[i][j] - del_s[qq]) : 0.0f;
      }
    __syncthreads();
    // dV += P^T dO, dK += dS^T (Q scale) for keys ty + 16 i, dims tx + 16 j
    for (int qq = 0; qq < BT; ++qq) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(ty + 16 * i) * LP + qq];
        sv[i] = dSt[(ty + 16 * i) * LP + qq];
      }
#pragma unroll
      for (int j = 0; j < NDJ; ++j) {
        const float dov = dOs[qq * LD + tx + 16 * j];
        const float qv = Qs[qq * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          adv[i][j] = fmaf(pv[i], dov, adv[i][j]);
          adk[i][j] = fmaf(sv[i], qv, adk[i][j]);
        }
      }
    }
  }
  // dk, dv contiguous (B, Sk, H, Dh)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const size_t base = (((size_t)b * Sk + key) * H + hh) * Dh;
#pragma unroll
    for (int j = 0; j < NDJ; ++j) {
      const int dd = tx + 16 * j;
      if (dd < Dh) {
        dk[base + dd] = adk[i][j];
        dv[base + dd] = adv[i][j];
      }
    }
  }
}

template <int NDJ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int H, int Dh, Strides qs,
                    Strides ks, Strides vs, Strides dos, float scale) {
  using SM = Smem<NDJ>;
  constexpr int LD = SM::LD, LP = SM::LP;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                       // q * scale
  float* dOs = Qs + BT * LD;
  float* Ks = dOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* dS = Vs + BT * LD;             // BT queries x LP
  float* lse_s = dS + BT * LP;
  float* del_s = lse_s + BT;

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int q0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<NDJ>(Qs, q + b * qs.b + hh * qs.h, qs.s, q0, Sq, Dh, scale);
  load_rows<NDJ>(dOs, dO + b * dos.b + hh * dos.h, dos.s, q0, Sq, Dh, 1.0f);
  if (threadIdx.x < BT) {
    const int p = q0 + threadIdx.x;
    lse_s[threadIdx.x] = p < Sq ? lse[(size_t)bh * Sq + p] : 0.0f;
    del_s[threadIdx.x] = p < Sq ? delta[(size_t)bh * Sq + p] : 0.0f;
  }
  const float* kb = k + b * ks.b + hh * ks.h;
  const float* vb = v + b * vs.b + hh * vs.h;

  float adq[4][NDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NDJ; ++j) adq[i][j] = 0.0f;

  for (int k0 = 0; k0 < Sk; k0 += BT) {
    __syncthreads();                    // the last tile's K, V, dS consumed
    load_rows<NDJ>(Ks, kb, ks.s, k0, Sk, Dh, 1.0f);
    load_rows<NDJ>(Vs, vb, vs.s, k0, Sk, Dh, 1.0f);
    __syncthreads();
    // S and dP for queries ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int dd = 0; dd < SM::DP; ++dd) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + dd];
        dov[i] = dOs[(ty + 16 * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + dd];
        vv[j] = Vs[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qq = ty + 16 * i, key = tx + 16 * j;
        const bool in = q0 + qq < Sq && k0 + key < Sk;
        const float p = in ? expf(s[i][j] - lse_s[qq]) : 0.0f;
        dS[qq * LP + key] = in ? p * (dp[i][j] - del_s[qq]) : 0.0f;
      }
    __syncthreads();
    // dQ += dS K for queries ty + 16 i, dims tx + 16 j
    for (int key = 0; key < BT; ++key) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dS[(ty + 16 * i) * LP + key];
#pragma unroll
      for (int j = 0; j < NDJ; ++j) {
        const float kv = Ks[key * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) adq[i][j] = fmaf(sv[i], kv, adq[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qq = q0 + ty + 16 * i;
    if (qq >= Sq) continue;
    const size_t base = (((size_t)b * Sq + qq) * H + hh) * Dh;
#pragma unroll
    for (int j = 0; j < NDJ; ++j) {
      const int dd = tx + 16 * j;
      if (dd < Dh) dq[base + dd] = adq[i][j] * scale;
    }
  }
}

template <int NDJ>
cudaError_t launch_ndj(const float* q, const float* k, const float* v, const float* o,
                       const float* lse, const float* dO, float* delta, float* dq, float* dk,
                       float* dv, int B, int Sq, int Sk, int H, int Dh, Strides qs,
                       Strides ks, Strides vs, Strides os, Strides dos, cudaStream_t stream) {
  using SM = Smem<NDJ>;
  const size_t smem_kv = sizeof(float) * (4 * BT * SM::LD + 2 * BT * SM::LP + 2 * BT);
  const size_t smem_q = sizeof(float) * (4 * BT * SM::LD + BT * SM::LP + 2 * BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<NDJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<NDJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)Dh));
  const long long rows = (long long)B * H * Sq;
  flash_bwd_delta_kernel<<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0,
                           stream>>>(o, dO, delta, Sq, H, Dh, os, dos, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<NDJ><<<dim3((Sk + BT - 1) / BT, B * H), THREADS, smem_kv, stream>>>(
      q, k, v, dO, lse, delta, dk, dv, Sq, Sk, H, Dh, qs, ks, vs, dos, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_kernel<NDJ><<<dim3((Sq + BT - 1) / BT, B * H), THREADS, smem_q, stream>>>(
      q, k, v, dO, lse, delta, dq, Sq, Sk, H, Dh, qs, ks, vs, dos, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dice

// Strides in elements (batch, sequence, head) of q, k, v, o and dO; dq, dk,
// dv are written contiguous (B, S, H, Dh); delta: f32 (B, H, Sq) scratch.
// Dh in [1, 128].  Returns the first launch error, else cudaGetLastError().
extern "C" int dice_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dO, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int Dh, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    int device, void* stream) {
  using namespace dice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Dh <= 0 || Dh > 128)
    return (int)cudaGetLastError();
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const int ndj = (Dh + 15) / 16;
#define DICE_FLASH_BWD(N)                                                                  \
  case N:                                                                                  \
    err = launch_ndj<N>(f(q), f(k), f(v), f(o), f(lse), f(dO), w(delta), w(dq), w(dk),     \
                        w(dv), B, Sq, Sk, H, Dh, qs, ks, vs, os, dos, s);                  \
    break;
  switch (ndj) {
    DICE_FLASH_BWD(1)
    DICE_FLASH_BWD(2)
    DICE_FLASH_BWD(3)
    DICE_FLASH_BWD(4)
    DICE_FLASH_BWD(5)
    DICE_FLASH_BWD(6)
    DICE_FLASH_BWD(7)
    DICE_FLASH_BWD(8)
  }
#undef DICE_FLASH_BWD
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
