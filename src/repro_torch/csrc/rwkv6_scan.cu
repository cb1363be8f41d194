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
// loop runs inside it, the state in registers from the first step to the
// last.
//
// What bounds it.  The state's own recurrence is one FMA deep per step and
// the readout r S feeds nothing back, so the kernel is bound by issue rate
// on the FP32 cores, not by a dependency chain: per state element and step
// one FMA for r S, one multiply for k v and one FMA for the update.  At the
// rwkv6-3b prefill shape (B=8, H=40, T=2048, DK=64) that is 2.7 G element-
// steps, about 0.28 ms at the card's FP32 issue rate; it reads ~0.6 GB
// (0.18 ms at 3.35 TB/s).  The design keeps every issue slot it can for
// those three instructions:
//   - Column j of S evolves on its own, so the columns are split across
//     warps: a warp owns CB = NCG * CC columns, and a block of DK / CB warps
//     owns one (b, h) (4 warps of 16 columns at DK = 64; 320 blocks at the
//     prefill shape, 1,280 warps).
//   - Each thread holds an RB x CC patch of S in registers (8 rows x 4
//     columns at DK = 64: lane = row group * NCG + column group), so one
//     vector shared read of r_i, w_i and k_i feeds CC columns.
//   - The readout of a group of G = 8 timesteps is kept as G x CC partial
//     sums in registers (independent FMA chains), then reduced over the
//     NRG row groups at once through shared memory: each lane puts its 32
//     partials down as 8 float4s and reads back, from the 8 lanes of its
//     column group, the 4 columns of one timestep, which it finishes and
//     writes as one 16-byte store.  (An xor-shuffle reduce-scatter of the
//     same partials cost 26% of the kernel: 28 shuffles and 56 selects a
//     group against 16 vector shared accesses.)
//   - Tiles of TT = 1024 / DK timesteps of r/k/v/logw are copied with 16-
//     byte cp.async into a raw stage and widened to f32 (w = exp(logw), and
//     the bonus sum_i r_i u_i k_i of each step as a shuffle reduction over
//     the DK / 8 threads of that step), once per timestep rather than by
//     every thread in every step.  Each thread copies and widens the same
//     8-element items, so it needs no barrier to read its own copies: the
//     widening of tile n + 1 and the copy of tile n + 2 run inside the
//     compute of tile n (after its first group), into the other of two f32
//     buffers, and a tile costs one barrier.  A tensor whose rows are not
//     16-byte aligned (base or any stride) is copied element by element.
//   - The state goes in and out through shared memory, so that its global
//     reads and writes are whole 16-byte pieces of contiguous rows (a
//     warp's own 16 columns would make 64-byte pieces of 8 rows).
// Decode runs the same kernel with T = 1, which takes a path of its own:
// its time is the state's read and write, so the state streams through
// registers in whole rows (see decode_one), with no cp.async staging and
// none of the tiled path's shared memory.  A chunked form on the tensor
// cores would leave the FP32 cores, but exp of cumulative log decays over a
// chunk under- or overflows f32 at RWKV-6's decays; that is later work.
//
// Tiling.  The defaults are the port's; launch/kernel_variants.py builds the
// other values with -D and times them against these (DK >= 64 only; the
// small heads keep 8 row groups of 4 columns):
//   DICE_SCAN_ROW_GROUPS  NRG, row groups per warp (a power of 2 up to 32)
//   DICE_SCAN_COLS        CC, columns per thread
//   DICE_SCAN_TILE        timesteps x DK per staged tile
//   DICE_SCAN_GROUP       G, timesteps whose readouts are reduced at once
// and two diagnostics that give wrong outputs and show what a part costs:
// DICE_SCAN_NO_REDUCE drops the row-group reduction, DICE_SCAN_NO_WIDEN the
// widening of the staged tiles to f32.
#include <type_traits>

#include "common.cuh"

#ifndef DICE_SCAN_ROW_GROUPS
#define DICE_SCAN_ROW_GROUPS 8
#endif
#ifndef DICE_SCAN_COLS
#define DICE_SCAN_COLS 4
#endif
#ifndef DICE_SCAN_TILE
#define DICE_SCAN_TILE 1024
#endif
#ifndef DICE_SCAN_GROUP
#define DICE_SCAN_GROUP 8
#endif

namespace dice {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int DK>
struct Shape {
  static constexpr int NRG = DK >= 64 ? DICE_SCAN_ROW_GROUPS : 8;  // row groups
  static constexpr int CC = DK >= 64 ? DICE_SCAN_COLS : 4;         // columns a thread
  static constexpr int RB = DK / NRG;                              // rows a thread
  static constexpr int NCG = 32 / NRG;                             // column groups
  static constexpr int CB = NCG * CC;                              // columns a warp
  static constexpr int WARPS = DK / CB;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TT = DICE_SCAN_TILE / DK;                   // steps a tile
  static constexpr int G = cmin(DICE_SCAN_GROUP, TT);              // steps a reduction
  static constexpr int LD = DK + 4;          // f32 tile row: conflict-free float4 rows
  static constexpr int CH = DK / 8;          // 8-element items a row
  static constexpr int ITEMS = TT * CH;      // items a tile
  static constexpr int KPT = (ITEMS + THREADS - 1) / THREADS;     // items a thread
  static constexpr int NL = G * CC / NRG;    // outputs a lane keeps of a group
  static constexpr int VW = cmin(NL, CC);    // outputs a store
  static constexpr int NCHUNK = G * CC / 4;  // float4 partials a lane has of a group
  static constexpr int ROW = 36;             // float4s a row of the transpose (4 mod 8)
  static_assert(NRG <= 32 && (NRG & (NRG - 1)) == 0, "row groups: a power of 2 up to 32");
  static_assert((CC & (CC - 1)) == 0 && (G & (G - 1)) == 0, "powers of 2");
  static_assert(DK % NRG == 0 && DK % CB == 0 && WARPS >= 1, "tiling must divide DK");
  static_assert(TT >= 1 && TT % G == 0 && ITEMS % 32 == 0, "tile sizes");
  static_assert(NL % 4 == 0 && CC % 4 == 0, "partials move in float4s");
  // u; two f32 tile buffers (r, k, v, w and the bonus each), which hold the
  // state on its way in and out; the readout transpose, a buffer a warp;
  // then the raw stage
  static constexpr int FBUF = (4 * TT * LD + TT + 3) / 4 * 4;
  static constexpr int AREA = cmax(2 * FBUF, DK * DK);
  static constexpr int RED = WARPS * NCHUNK * ROW * 4;
  static constexpr int F32_BYTES = (DK + AREA + RED) * 4;
  // decode (T = 1): r, w, k, v, the readout partials and the bonus sums
  static constexpr int DECODE_BYTES = ((4 + THREADS / DK) * DK + DK / 32 + 1) * 4;
  static int smem_bytes(int rkv_es, int w_es) {
    return F32_BYTES + TT * DK * (3 * rkv_es + w_es);
  }
};

struct SeqStrides {
  long long b, h, t;      // element strides of a (B, H, T, DK) input
};

struct ScanArgs {
  const char* src[4];     // r, k, v, logw
  SeqStrides st[4];
  int es[4];              // element bytes
  int aligned;            // bit a: rows of src[a] can be copied in 16-byte pieces
};

// N consecutive f32 from shared or global memory, in the widest aligned
// vector loads the count allows (the callers' offsets are multiples of N).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      x[i] = q.x; x[i + 1] = q.y; x[i + 2] = q.z; x[i + 3] = q.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      x[i] = q.x; x[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  static_assert(N % 4 == 0, "stores go out in float4s");
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

__device__ __forceinline__ float u_at(const void* u, int u_dtype, int i) {
  return u_dtype == kF32 ? static_cast<const float*>(u)[i]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(u)[i]);
}

// 8 staged elements (16 bytes of bf16 or 32 of f32) widened to f32.
__device__ __forceinline__ void load8(const unsigned char* p, int es, float (&x)[8]) {
  if (es == 2) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    load_vec<8>(reinterpret_cast<const float*>(p), x);
  }
}

// Item (s, g) of one input, elements [8 g, 8 g + 8) of step t0 + s, into
// its place in the raw stage ([TT][DK] of that input's type): 16-byte
// cp.async pieces where the rows are aligned, else element by element.  A
// thread copies and later widens the same items, so it needs no barrier to
// see its own copies.
__device__ __forceinline__ void copy_item(unsigned char* dst, const char* src, int es,
                                          bool aligned) {
  if (aligned) {
    cp_async16(dst, src, 16);
    if (es == 4) cp_async16(dst + 16, src + 16, 16);
  } else if (es == 4) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      reinterpret_cast<float*>(dst)[e] = reinterpret_cast<const float*>(src)[e];
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      reinterpret_cast<uint16_t*>(dst)[e] = reinterpret_cast<const uint16_t*>(src)[e];
  }
}

// This thread's items of timesteps [t0, t0 + n) of the four inputs of one
// (b, h): raw stage [r | k | v | logw].
template <int DK>
__device__ __forceinline__ void issue_items(unsigned char* stage, const ScanArgs& a, int b,
                                            int h, int t0, int n) {
  using Sh = Shape<DK>;
#pragma unroll
  for (int q = 0; q < Sh::KPT; ++q) {
    const int item = threadIdx.x + q * Sh::THREADS;
    const int s = item / Sh::CH, g = item % Sh::CH;
    if (item < Sh::ITEMS && s < n) {
      unsigned char* dst = stage;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int es = a.es[x];
        const char* src = a.src[x] + (b * a.st[x].b + h * a.st[x].h +
                                      (long long)(t0 + s) * a.st[x].t + 8 * g) * es;
        copy_item(dst + (s * DK + 8 * g) * es, src, es, a.aligned >> x & 1);
        dst += Sh::TT * DK * es;
      }
    }
  }
}

// This thread's items of a staged tile widened into an f32 tile buffer:
// r, k, v, w = exp(logw), and the bonus sum_i r_i u_i k_i of each step,
// reduced over the CH threads that hold its items.
template <int DK>
__device__ __forceinline__ void widen_items(float* fb, const unsigned char* stage,
                                            const float* su, int steps, int e_rkv, int e_w) {
  using Sh = Shape<DK>;
  constexpr int TT = Sh::TT, LD = Sh::LD;
  float* fr = fb;
  float* fk = fr + TT * LD;
  float* fv = fk + TT * LD;
  float* fw = fv + TT * LD;
  float* fbonus = fw + TT * LD;
#pragma unroll
  for (int q = 0; q < Sh::KPT; ++q) {
    const int item = threadIdx.x + q * Sh::THREADS;
    const int s = item / Sh::CH, g = item % Sh::CH, off = s * DK + 8 * g;
    const bool live = item < Sh::ITEMS && s < steps;
    float part = 0.0f;
    if (live) {
      float rr[8], kk[8], vv[8], ww[8], uu[8];
      load8(stage + off * e_rkv, e_rkv, rr);
      load8(stage + (TT * DK + off) * e_rkv, e_rkv, kk);
      load8(stage + (2 * TT * DK + off) * e_rkv, e_rkv, vv);
      load8(stage + 3 * TT * DK * e_rkv + off * e_w, e_w, ww);
      load_vec<8>(su + 8 * g, uu);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        part = fmaf(rr[e] * uu[e], kk[e], part);
        ww[e] = exp2f(ww[e] * kLog2e);
      }
      store_vec<8>(fr + s * LD + 8 * g, rr);
      store_vec<8>(fk + s * LD + 8 * g, kk);
      store_vec<8>(fv + s * LD + 8 * g, vv);
      store_vec<8>(fw + s * LD + 8 * g, ww);
    }
    if (item - threadIdx.x % 32 < Sh::ITEMS) {  // whole warps
#pragma unroll
      for (int o = 1; o < Sh::CH; o <<= 1) part += __shfl_xor_sync(kFull, part, o);
    }
    if (live && g == 0) fbonus[s] = part;
  }
}

// One element of input x at (b, h, t = 0, i), widened to f32.
__device__ __forceinline__ float load_elem(const ScanArgs& a, int x, int b, int h, int i) {
  const char* p = a.src[x] + (b * a.st[x].b + h * a.st[x].h + i) * a.es[x];
  return a.es[x] == 4 ? *reinterpret_cast<const float*>(p)
                      : __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

// T = 1 (decode): the state is the whole of the traffic, so it streams
// through registers in whole rows (thread j of a row group holds column j,
// as a warp reads 32 neighbouring floats), each element read, updated and
// written back at once, with no staging: one barrier after the step's
// vectors land, one before the partial readouts are summed.
template <int DK>
__device__ __forceinline__ void decode_one(const ScanArgs& a, const void* u, const float* s0,
                                           float* out, float* sT, int H, int u_dtype) {
  constexpr int THREADS = Shape<DK>::THREADS;
  constexpr int TPC = THREADS / DK;           // threads a column
  constexpr int RPT = DK / TPC;               // rows a thread
  static_assert(THREADS % DK == 0 && DK % TPC == 0, "decode layout");
  extern __shared__ __align__(16) unsigned char smem[];
  float* sr = reinterpret_cast<float*>(smem);   // r, w, k, v of the step, then partials
  float* sw = sr + DK;
  float* sk = sw + DK;
  float* sv = sk + DK;
  float* spart = sv + DK;                      // (TPC, DK) readout partials
  float* sbonus = spart + TPC * DK;            // (DK / 32 + 1) warp sums
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int j = tid % DK, part = tid / DK;
  const float* s0p = s0 + (size_t)bh * DK * DK + part * RPT * DK + j;
  float s[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) s[i] = s0p[i * DK];   // all in flight at once
  float bonus_part = 0.0f;
  if (tid < DK) {
    const float r = load_elem(a, 0, b, h, tid), k = load_elem(a, 1, b, h, tid);
    const float uu = u_at(u, u_dtype, h * DK + tid);
    sr[tid] = r;
    sk[tid] = k;
    sv[tid] = load_elem(a, 2, b, h, tid);
    sw[tid] = exp2f(load_elem(a, 3, b, h, tid) * kLog2e);
    bonus_part = r * uu * k;
  }
  if (tid < (DK + 31) / 32 * 32) {            // whole warps, lanes past DK add 0
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) bonus_part += __shfl_xor_sync(kFull, bonus_part, o);
    if (tid % 32 == 0) sbonus[tid / 32] = bonus_part;
  }
  __syncthreads();
  const float vj = sv[j];
  float acc0 = 0.0f, acc1 = 0.0f;
  float* sTp = sT + (size_t)bh * DK * DK + part * RPT * DK + j;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = part * RPT + i;
    if (i % 2 == 0) acc0 = fmaf(sr[row], s[i], acc0);
    else acc1 = fmaf(sr[row], s[i], acc1);
    sTp[i * DK] = fmaf(sw[row], s[i], sk[row] * vj);
  }
  spart[part * DK + j] = acc0 + acc1;
  __syncthreads();
  if (tid < DK) {
    float y = 0.0f, bonus = 0.0f;
#pragma unroll
    for (int q = 0; q < TPC; ++q) y += spart[q * DK + tid];
#pragma unroll
    for (int w = 0; w < (DK + 31) / 32; ++w) bonus += sbonus[w];
    out[(size_t)bh * DK + tid] = fmaf(bonus, sv[tid], y);
  }
}

template <int DK>
__global__ void __launch_bounds__(Shape<DK>::THREADS)
rwkv6_scan_kernel(ScanArgs a, const void* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ out, float* __restrict__ sT, int H, int T,
                  int u_dtype) {
  if (T == 1) {
    decode_one<DK>(a, u, s0, out, sT, H, u_dtype);
    return;
  }
  using Sh = Shape<DK>;
  constexpr int TT = Sh::TT, LD = Sh::LD, RB = Sh::RB, CC = Sh::CC, NCG = Sh::NCG;
  constexpr int G = Sh::G, NL = Sh::NL, VW = Sh::VW, NRG = Sh::NRG, ROW = Sh::ROW;
  constexpr int RV = RB % 4 == 0 ? 4 : RB;    // rows a shared read
  extern __shared__ __align__(16) unsigned char smem[];
  float* su = reinterpret_cast<float*>(smem);
  float* area = su + DK;                      // the state, on the way in and out
  // f32 tiles, in between: tile n in buffer n % 2, at area + (n % 2) FBUF
  float* sred = area + Sh::AREA;
  unsigned char* stage = smem + Sh::F32_BYTES;
  const int e_rkv = a.es[0], e_w = a.es[3];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = lane / NCG, cg = lane % NCG;
  const int i0 = rg * RB;                       // the thread's rows of S
  const int j0 = warp * Sh::CB + cg * CC;       // and columns
  float4* red = reinterpret_cast<float4*>(sred) + warp * Sh::NCHUNK * ROW;

  for (int i = tid; i < DK; i += Sh::THREADS) su[i] = u_at(u, u_dtype, h * DK + i);
  // the state comes in whole rows: 16-byte pieces, neighbours on neighbours
  const float* s0p = s0 + (size_t)bh * DK * DK;
  if (reinterpret_cast<uintptr_t>(s0p) % 16 == 0) {
    for (int c = tid; c < DK * DK / 4; c += Sh::THREADS) cp_async16(area + 4 * c, s0p + 4 * c, 16);
  } else {
    for (int i = tid; i < DK * DK; i += Sh::THREADS) area[i] = s0p[i];
  }
  const int ntiles = (T + TT - 1) / TT;
  issue_items<DK>(stage, a, b, h, 0, min(TT, T));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float S[RB][CC];
#pragma unroll
  for (int i = 0; i < RB; ++i) load_vec<CC>(area + (i0 + i) * DK + j0, S[i]);
  __syncthreads();                              // the area holds f32 tiles from here
  widen_items<DK>(area, stage, su, min(TT, T), e_rkv, e_w);
  if (ntiles > 1) issue_items<DK>(stage, a, b, h, TT, min(TT, T - TT));
  cp_async_commit();
  __syncthreads();

  float* outp = out + (size_t)bh * T * DK;
  for (int n = 0; n < ntiles; ++n) {
    const float* fb = area + (n % 2) * Sh::FBUF;
    const float* sr = fb;
    const float* sk = sr + TT * LD;
    const float* sv = sk + TT * LD;
    const float* sw = sv + TT * LD;
    const float* sbonus = sw + TT * LD;
    const int t0 = n * TT, steps = min(TT, T - t0);
    for (int g0 = 0; g0 < steps; g0 += G) {
      const int live = min(G, steps - g0);
      // readout partials of G steps over the thread's rows, and the update
      float p[G * CC];
#pragma unroll
      for (int s = 0; s < G; ++s) {
#pragma unroll
        for (int c = 0; c < CC; ++c) p[s * CC + c] = 0.0f;
        if (s < live) {
          const int row = (g0 + s) * LD;
          float vv[CC];
          load_vec<CC>(sv + row + j0, vv);
#pragma unroll
          for (int i = 0; i < RB; i += RV) {
            float rr[RV], ww[RV], kk[RV];
            load_vec<RV>(sr + row + i0 + i, rr);
            load_vec<RV>(sw + row + i0 + i, ww);
            load_vec<RV>(sk + row + i0 + i, kk);
#pragma unroll
            for (int q = 0; q < RV; ++q) {
#pragma unroll
              for (int c = 0; c < CC; ++c) {
                p[s * CC + c] = fmaf(rr[q], S[i + q][c], p[s * CC + c]);
                S[i + q][c] = fmaf(ww[q], S[i + q][c], kk[q] * vv[c]);
              }
            }
          }
        }
      }
      // reduce over the row groups through shared memory: every lane puts
      // its partials down as float4 chunks, chunk k of lane L at row k,
      // column L, and lane (rg, cg) adds up flat outputs [rg NL, rg NL + NL)
      // of (step, column) from the NRG lanes of its column group
#ifndef DICE_SCAN_NO_REDUCE
#pragma unroll
      for (int k = 0; k < Sh::NCHUNK; ++k)
        red[k * ROW + lane] = make_float4(p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < NL / 4; ++k) {
        float4 acc = red[(rg * NL / 4 + k) * ROW + cg];
#pragma unroll
        for (int r = 1; r < NRG; ++r) {
          const float4 x = red[(rg * NL / 4 + k) * ROW + r * NCG + cg];
          acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
        }
        p[4 * k] = acc.x; p[4 * k + 1] = acc.y; p[4 * k + 2] = acc.z; p[4 * k + 3] = acc.w;
      }
      __syncwarp();
#endif
#pragma unroll
      for (int e0 = 0; e0 < NL; e0 += VW) {
        const int f = rg * NL + e0, s = f / CC, c0 = f % CC;
        if (s < live) {
          float vv[VW], o[VW];
          load_vec<VW>(sv + (g0 + s) * LD + j0 + c0, vv);
          const float bonus = sbonus[g0 + s];
#pragma unroll
          for (int e = 0; e < VW; ++e) o[e] = fmaf(bonus, vv[e], p[e0 + e]);
          store_vec<VW>(outp + (size_t)(t0 + g0 + s) * DK + j0 + c0, o);
        }
      }
      // after the first group, widen this thread's items of tile n + 1
      // (copied while tile n - 1 ran) and start copying tile n + 2
      if (g0 == 0 && n + 1 < ntiles) {
        cp_async_wait<0>();
#ifndef DICE_SCAN_NO_WIDEN
        widen_items<DK>(area + ((n + 1) % 2) * Sh::FBUF, stage, su, min(TT, T - t0 - TT), e_rkv, e_w);
#endif
        if (n + 2 < ntiles) issue_items<DK>(stage, a, b, h, t0 + 2 * TT, min(TT, T - t0 - 2 * TT));
        cp_async_commit();
      }
    }
    __syncthreads();                            // tile n + 1 widened; tile n read
  }

  // the state goes out in whole rows too
#pragma unroll
  for (int i = 0; i < RB; ++i) store_vec<CC>(area + (i0 + i) * DK + j0, S[i]);
  __syncthreads();
  float4* sTp = reinterpret_cast<float4*>(sT + (size_t)bh * DK * DK);
  for (int c = tid; c < DK * DK / 4; c += Sh::THREADS)
    sTp[c] = reinterpret_cast<const float4*>(area)[c];
}

template <int DK>
int launch(const ScanArgs& a, const void* u, const void* s0, void* out, void* sT, int B,
           int H, int T, int u_dtype, int device, cudaStream_t stream) {
  using Sh = Shape<DK>;
  // above 48 KB of shared memory a block must ask for it, once per device
  static bool asked[64] = {};
  const int most = Sh::smem_bytes(4, 4);
  if (most > 48 * 1024 && device < 64 && !asked[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    asked[device] = true;
  }
  const int smem = T == 1 ? Sh::DECODE_BYTES : Sh::smem_bytes(a.es[0], a.es[3]);
  rwkv6_scan_kernel<DK><<<B * H, Sh::THREADS, smem, stream>>>(
      a, u, static_cast<const float*>(s0), static_cast<float*>(out), static_cast<float*>(sT),
      H, T, u_dtype);
  return (int)cudaGetLastError();
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
  const int e_rkv = rkv_dtype == dice::kF32 ? 4 : 2, e_w = w_dtype == dice::kF32 ? 4 : 2;
  dice::ScanArgs a{{static_cast<const char*>(r), static_cast<const char*>(k),
                    static_cast<const char*>(v), static_cast<const char*>(logw)},
                   {{r_sb, r_sh, r_st}, {k_sb, k_sh, k_st}, {v_sb, v_sh, v_st},
                    {w_sb, w_sh, w_st}},
                   {e_rkv, e_rkv, e_rkv, e_w},
                   0};
  for (int x = 0; x < 4; ++x) {
    const long long es = a.es[x];
    if (dice::rows_16b_aligned(a.src[x], a.st[x].b * es) &&
        a.st[x].h * es % 16 == 0 && a.st[x].t * es % 16 == 0)
      a.aligned |= 1 << x;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DK) {
    case 16: return dice::launch<16>(a, u, s0, out, sT, B, H, T, u_dtype, device, s);
    case 32: return dice::launch<32>(a, u, s0, out, sT, B, H, T, u_dtype, device, s);
    case 64: return dice::launch<64>(a, u, s0, out, sT, B, H, T, u_dtype, device, s);
    case 128: return dice::launch<128>(a, u, s0, out, sT, B, H, T, u_dtype, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
