// Backward of the RWKV-6 recurrence for Hopper (sm_90a).  The forward
// (csrc/rwkv6_scan.cu), per (b, h) over t, with P_t the state before step t
// (P_0 = s0, P_T = S_T) and w_t = exp(logw_t):
//   out_t = r_t P_t + (sum_i r_t,i u_i k_t,i) v_t
//   P_t+1 = diag(w_t) P_t + k_t^T v_t
// Given dout (B, H, T, DK) and dS_T (or none), with G_t = dL/dP_t
// (G_T = dS_T) and the scalars vd_t = v_t . dout_t, bs_t = sum_i u_i r_t,i k_t,i:
//   G_t    = diag(w_t) G_t+1 + r_t^T dout_t            ds0 = G_0
//   dr_t   = P_t dout_t    + u (.) k_t vd_t            (sum over columns)
//   dk_t   = G_t+1 v_t     + u (.) r_t vd_t            (sum over columns)
//   dv_t   = k_t G_t+1     + dout_t bs_t               (sum over rows)
//   du     = sum_b,t r_t (.) k_t vd_t
//   dlogw_t = w_t (.) sum_v G_t+1 (.) P_t
//          = Q_T + sum_{m>t} r_m (.) dr^st_m - sum_{m>=t} k_m (.) dk^st_m
// where dr^st = P dout and dk^st = G v are the parts through the state and
// Q_T = sum_v dS_T (.) S_T.  The second form of dlogw needs no state of step
// t: it is a reverse running sum per row, and divides by no decay (a reverse
// recurrence that undid diag(w_t) would blow up where w_t is small).
//
// Replaces no Pallas kernel: the JAX package trains through XLA's autodiff
// of the chunked jnp scan of src/repro/models/rwkv6.py:143 (_time_mix_scan;
// its Pallas forward rwkv6_scan_pallas has no backward).  Written from the
// formulas above, not carried over from XLA's scan.
//
// Layout.  One block owns one (b, h) and a pass's state lives in registers,
// NC = 4 threads to a row (or column), each holding CW = DK / 4 elements.
// The forward splits the state's columns across warps because its readout
// r S sums over rows; here dr = P dout and dk = G v sum over columns while
// dv = k G sums over rows.  So each pass takes the split that makes its one
// readout a sum inside a thread plus two xor shuffles among its 4 lanes:
//   blockIdx.y = 0, rows split: pass (A) walks time forward, recomputing
//     P_t from s0, and writes dr_t; it keeps r_t (.) dr^st_t in the dlogw
//     output (f32) and ends with Q_T from the recomputed S_T.  Pass (B) then
//     walks time backward carrying G from dS_T, writes dk_t and, from the
//     running sum started at Q_T, dlogw_t over what (A) left there; it ends
//     with ds0 = G_0.
//   blockIdx.y = 1, columns split: pass (C) walks time backward carrying G
//     again (the same arithmetic as (B)) and writes dv_t.  It needs nothing
//     from (A) or (B), so it runs beside them in a block of its own.
// du is written per (b, h) by (A) and summed over b in a fixed order by a
// second small launch: no atomics, two runs agree bit for bit.
//
// What bounds it.  Per state element and step: 3 FLOP to carry a state
// (a multiply and an FMA) and 2 for a readout, in three passes: 15 FLOP,
// of which the formulas need 9 (G, dr, dk, dv) and the forward's state 3.
// At rwkv6-3b's training shape (B = 8, H = 40, T = 128, DK = 64) the 12 of
// the formulas and the recompute are 2.0 GFLOP, 0.030 ms at the card's 67
// TFLOP/s FP32 rate; it moves ~63 MB (0.019 ms).  This first version is
// simple: each tile of TT = 1024 / DK steps of r, k, v, w = exp(logw), dout
// (and the kept r (.) dr^st for (B)) is loaded into shared memory as f32
// by all threads, behind three barriers a tile; the per-step scalars vd
// and bs are warp reductions over the staged tile.  Its time against the
// bound is in PERF.md; making it fast is later work.
#include "common.cuh"

namespace dice {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int NC = 4;     // threads that share a row (A, B) or a column (C)

template <int DK>
struct BwdShape {
  static constexpr int THREADS = NC * DK;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int CW = DK / NC;          // state elements a thread
  static constexpr int TT = 1024 / DK;        // steps a staged tile
  static constexpr int TILE = TT * DK;
  // r, k, v, w, dout, kept r (.) dr^st; vd and bs a step; u
  static constexpr int SMEM_FLOATS = 6 * TILE + 2 * TT + DK;
  static_assert(CW % 4 == 0 && THREADS % 32 == 0, "rows go in float4 pieces");
};

struct BwdArgs {
  const char* src[4];     // r, k, v, logw: (B, H, T, DK), last dim contiguous
  long long sb[4], sh[4], st[4];   // element strides
  int es[4];              // element bytes
  const float* dout;      // (B, H, T, DK) f32, last dim contiguous
  long long db, dh, dt;
  const void* u;          // (H, DK)
  int u_dtype;
  const float* s0;        // (B, H, DK, DK) f32
  const float* dST;       // (B, H, DK, DK) f32, or null: dS_T = 0
  void* dr;               // (B, H, T, DK) in r's dtype, contiguous
  void* dk;
  void* dv;
  int out_es;
  float* dlogw;           // (B, H, T, DK) f32, contiguous
  float* ds0;             // (B, H, DK, DK) f32
  float* du_part;         // (B, H, DK) f32
  int H, T;
};

__device__ __forceinline__ float load_elem(const char* p, int es) {
  return es == 4 ? *reinterpret_cast<const float*>(p)
                 : __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

__device__ __forceinline__ void store_elem(void* base, size_t i, int es, float x) {
  if (es == 4) static_cast<float*>(base)[i] = x;
  else static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
}

// Steps [t0, t0 + n) of one (b, h) into the shared tile, widened to f32:
// r, k, v, w = exp(logw), dout and (when ``kept`` is given) the f32 rows
// there; then vd = v . dout and bs = sum u r k of each step, one warp a
// step.  Ends behind a barrier; the caller puts one before it.
template <int DK>
__device__ __forceinline__ void stage(float* sm, const BwdArgs& a, const float* kept, int b,
                                      int h, int t0, int n) {
  using Sh = BwdShape<DK>;
  constexpr int TILE = Sh::TILE;
  float* sr = sm;
  float* sk = sr + TILE;
  float* sv = sk + TILE;
  float* sw = sv + TILE;
  float* sd = sw + TILE;
  float* sx = sd + TILE;
  float* svd = sx + TILE;
  float* sbs = svd + Sh::TT;
  const float* su = sbs + Sh::TT;
  const size_t bh = (size_t)b * a.H + h;
  for (int idx = threadIdx.x; idx < n * DK; idx += Sh::THREADS) {
    const int s = idx / DK, e = idx % DK;
    const long long t = t0 + s;
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[q] = load_elem(a.src[q] + (b * a.sb[q] + h * a.sh[q] + t * a.st[q] + e) * a.es[q],
                       a.es[q]);
    sr[idx] = x[0];
    sk[idx] = x[1];
    sv[idx] = x[2];
    sw[idx] = exp2f(x[3] * kLog2e);
    sd[idx] = a.dout[b * a.db + h * a.dh + t * a.dt + e];
    if (kept != nullptr) sx[idx] = kept[(bh * a.T + t) * DK + e];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int s = warp; s < n; s += Sh::WARPS) {
    float vd = 0.0f, bs = 0.0f;
    for (int e = lane; e < DK; e += 32) {
      vd = fmaf(sv[s * DK + e], sd[s * DK + e], vd);
      bs = fmaf(su[e] * sr[s * DK + e], sk[s * DK + e], bs);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      vd += __shfl_xor_sync(kFull, vd, o);
      bs += __shfl_xor_sync(kFull, bs, o);
    }
    if (lane == 0) {
      svd[s] = vd;
      sbs[s] = bs;
    }
  }
  __syncthreads();
}

// sum_j x[j] y[j] over a thread's CW elements (y in shared memory, in
// float4s), four independent FMA chains, then over the NC = 4 lanes.
template <int CW>
__device__ __forceinline__ float dot_lanes(const float (&x)[CW], const float* y) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < CW; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(y + j);
    acc[0] = fmaf(x[j], q.x, acc[0]);
    acc[1] = fmaf(x[j + 1], q.y, acc[1]);
    acc[2] = fmaf(x[j + 2], q.z, acc[2]);
    acc[3] = fmaf(x[j + 3], q.w, acc[3]);
  }
  float d = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  d += __shfl_xor_sync(kFull, d, 1);
  d += __shfl_xor_sync(kFull, d, 2);
  return d;
}

// Passes (A) and (B): thread (row, c) holds elements [c CW, c CW + CW) of
// one row of P, then of G.
template <int DK>
__device__ void rows_passes(float* sm, const BwdArgs& a, int b, int h) {
  using Sh = BwdShape<DK>;
  constexpr int TILE = Sh::TILE, TT = Sh::TT, CW = Sh::CW;
  const float* sr = sm;
  const float* sk = sr + TILE;
  const float* sv = sk + TILE;
  const float* sw = sv + TILE;
  const float* sd = sw + TILE;
  const float* sx = sd + TILE;
  const float* svd = sx + TILE;
  const float* su = svd + 2 * TT;
  const int row = threadIdx.x / NC, c = threadIdx.x % NC, j0 = c * CW;
  const size_t bh = (size_t)b * a.H + h;
  const int T = a.T, ntiles = (T + TT - 1) / TT;
  const float ur = su[row];
  float* kept = a.dlogw;          // r (.) dr^st from (A), then dlogw from (B)

  // (A) forward in time: P from s0
  float P[CW];
  const float* s0p = a.s0 + (bh * DK + row) * DK + j0;
#pragma unroll
  for (int j = 0; j < CW; ++j) P[j] = s0p[j];
  float du = 0.0f;
  for (int n = 0; n < ntiles; ++n) {
    const int t0 = n * TT, steps = min(TT, T - t0);
    __syncthreads();                                // the last tile is read
    stage<DK>(sm, a, nullptr, b, h, t0, steps);
    for (int s = 0; s < steps; ++s) {
      const float drst = dot_lanes<CW>(P, sd + s * DK + j0);
      const float kk = sk[s * DK + row], ww = sw[s * DK + row];
      const float* vv = sv + s * DK + j0;
#pragma unroll
      for (int j = 0; j < CW; ++j) P[j] = fmaf(ww, P[j], kk * vv[j]);
      if (c == 0) {
        const size_t i = (bh * T + t0 + s) * DK + row;
        const float rr = sr[s * DK + row], vd = svd[s];
        store_elem(a.dr, i, a.out_es, drst + ur * kk * vd);
        kept[i] = rr * drst;
        du = fmaf(rr * kk, vd, du);
      }
    }
  }
  if (c == 0) a.du_part[bh * DK + row] = du;
  // Q_T = sum_v dS_T (.) S_T on the recomputed S_T
  float G[CW];
  float R = 0.0f;
  if (a.dST != nullptr) {
    const float* g = a.dST + (bh * DK + row) * DK + j0;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      G[j] = g[j];
      R = fmaf(G[j], P[j], R);
    }
    R += __shfl_xor_sync(kFull, R, 1);
    R += __shfl_xor_sync(kFull, R, 2);
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) G[j] = 0.0f;
  }

  // (B) backward in time: G from dS_T; R runs to dlogw
  for (int n = ntiles - 1; n >= 0; --n) {
    const int t0 = n * TT, steps = min(TT, T - t0);
    __syncthreads();                                // (A)'s stores, or the last tile, done
    stage<DK>(sm, a, kept, b, h, t0, steps);
    for (int s = steps - 1; s >= 0; --s) {
      const float dkst = dot_lanes<CW>(G, sv + s * DK + j0);
      const float kk = sk[s * DK + row], ww = sw[s * DK + row], rr = sr[s * DK + row];
      R = fmaf(-kk, dkst, R);
      if (c == 0) {
        const size_t i = (bh * T + t0 + s) * DK + row;
        store_elem(a.dk, i, a.out_es, dkst + ur * rr * svd[s]);
        a.dlogw[i] = R;
      }
      R += sx[s * DK + row];
      const float* dd = sd + s * DK + j0;
#pragma unroll
      for (int j = 0; j < CW; ++j) G[j] = fmaf(ww, G[j], rr * dd[j]);
    }
  }
  float* ds0 = a.ds0 + (bh * DK + row) * DK + j0;
#pragma unroll
  for (int j = 0; j < CW; j += 4)
    *reinterpret_cast<float4*>(ds0 + j) = make_float4(G[j], G[j + 1], G[j + 2], G[j + 3]);
}

// Pass (C): thread (col, c) holds rows [c CW, c CW + CW) of one column of G.
template <int DK>
__device__ void column_pass(float* sm, const BwdArgs& a, int b, int h) {
  using Sh = BwdShape<DK>;
  constexpr int TILE = Sh::TILE, TT = Sh::TT, CW = Sh::CW;
  const float* sr = sm;
  const float* sk = sr + TILE;
  const float* sw = sk + 2 * TILE;
  const float* sd = sw + TILE;
  const float* sbs = sd + 2 * TILE + TT;
  const int col = threadIdx.x / NC, c = threadIdx.x % NC, i0 = c * CW;
  const size_t bh = (size_t)b * a.H + h;
  const int T = a.T, ntiles = (T + TT - 1) / TT;
  float G[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i)
    G[i] = a.dST != nullptr ? a.dST[(bh * DK + i0 + i) * DK + col] : 0.0f;
  for (int n = ntiles - 1; n >= 0; --n) {
    const int t0 = n * TT, steps = min(TT, T - t0);
    __syncthreads();
    stage<DK>(sm, a, nullptr, b, h, t0, steps);
    for (int s = steps - 1; s >= 0; --s) {
      const float dvst = dot_lanes<CW>(G, sk + s * DK + i0);
      const float dd = sd[s * DK + col];
      if (c == 0) store_elem(a.dv, (bh * T + t0 + s) * DK + col, a.out_es, dvst + dd * sbs[s]);
      const float* rq = sr + s * DK + i0;
      const float* wq = sw + s * DK + i0;
#pragma unroll
      for (int i = 0; i < CW; ++i) G[i] = fmaf(wq[i], G[i], rq[i] * dd);
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(BwdShape<DK>::THREADS)
rwkv6_scan_bwd_kernel(BwdArgs a) {
  using Sh = BwdShape<DK>;
  __shared__ __align__(16) float sm[Sh::SMEM_FLOATS];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  float* su = sm + 6 * Sh::TILE + 2 * Sh::TT;
  for (int i = threadIdx.x; i < DK; i += Sh::THREADS)
    su[i] = a.u_dtype == kF32
                ? static_cast<const float*>(a.u)[h * DK + i]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(a.u)[h * DK + i]);
  __syncthreads();
  if (blockIdx.y == 0) rows_passes<DK>(sm, a, b, h);
  else column_pass<DK>(sm, a, b, h);
}

// du = sum over b of the (B, H, DK) partials, in order of b, into u's dtype.
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ part, void* du, int B, int H,
                                    int DK, int u_dtype) {
  const int h = blockIdx.x, i = threadIdx.x;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += part[((size_t)b * H + h) * DK + i];
  store_elem(du, (size_t)h * DK + i, u_dtype == kF32 ? 4 : 2, s);
}

template <int DK>
int launch(const BwdArgs& a, int B, void* du, int u_dtype, cudaStream_t stream) {
  rwkv6_scan_bwd_kernel<DK><<<dim3(B * a.H, 2), BwdShape<DK>::THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_du_kernel<<<a.H, DK, 0, stream>>>(a.du_part, du, B, a.H, DK, u_dtype);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dice

// Gradients of dice_rwkv6_scan.  Strides are in elements (*_sb, *_sh, *_st
// for the batch, head and time dims of r, k, v, logw and dout; the last dim
// of each is contiguous).  Dtype codes (0 f32, 1 bf16): rkv_dtype for r/k/v
// and the outputs dr/dk/dv, w_dtype for logw, u_dtype for u and du; dout,
// s0, dS_T (null: zeros), dlogw, ds0 and du_part (B * H * DK scratch) are
// f32.  Two launches.  DK must be 16, 32, 64 or 128.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for another DK).
extern "C" int dice_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* logw, const void* u,
    const void* s0, const void* dout, const void* dST, void* dr, void* dk, void* dv,
    void* dlogw, void* du, void* ds0, void* du_part, int B, int H, int T, int DK,
    long long r_sb, long long r_sh, long long r_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, long long w_sb,
    long long w_sh, long long w_st, long long d_sb, long long d_sh, long long d_st,
    int rkv_dtype, int w_dtype, int u_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaGetLastError();
  const int e_rkv = rkv_dtype == dice::kF32 ? 4 : 2, e_w = w_dtype == dice::kF32 ? 4 : 2;
  dice::BwdArgs a{};
  const void* src[4] = {r, k, v, logw};
  const long long sb[4] = {r_sb, k_sb, v_sb, w_sb}, sh[4] = {r_sh, k_sh, v_sh, w_sh},
                  st[4] = {r_st, k_st, v_st, w_st};
  for (int q = 0; q < 4; ++q) {
    a.src[q] = static_cast<const char*>(src[q]);
    a.sb[q] = sb[q];
    a.sh[q] = sh[q];
    a.st[q] = st[q];
    a.es[q] = q == 3 ? e_w : e_rkv;
  }
  a.dout = static_cast<const float*>(dout);
  a.db = d_sb;
  a.dh = d_sh;
  a.dt = d_st;
  a.u = u;
  a.u_dtype = u_dtype;
  a.s0 = static_cast<const float*>(s0);
  a.dST = static_cast<const float*>(dST);
  a.dr = dr;
  a.dk = dk;
  a.dv = dv;
  a.out_es = e_rkv;
  a.dlogw = static_cast<float*>(dlogw);
  a.ds0 = static_cast<float*>(ds0);
  a.du_part = static_cast<float*>(du_part);
  a.H = H;
  a.T = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DK) {
    case 16: return dice::launch<16>(a, B, du, u_dtype, s);
    case 32: return dice::launch<32>(a, B, du, u_dtype, s);
    case 64: return dice::launch<64>(a, B, du, u_dtype, s);
    case 128: return dice::launch<128>(a, B, du, u_dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
