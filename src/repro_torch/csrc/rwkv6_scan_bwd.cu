// Backward of the RWKV-6 recurrence for Hopper (sm_90a), as a chunked
// recurrence on the tensor cores.  The forward (csrc/rwkv6_scan.cu), per
// (b, h) over t, with P_t the state before step t (P_0 = s0, P_T = S_T) and
// w_t = exp(logw_t):
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
// t: it is a reverse running sum per row, and divides by no decay.
//
// Replaces no Pallas kernel: the JAX package trains through XLA's autodiff
// of the chunked jnp scan of src/repro/models/rwkv6.py:143 (_time_mix_scan;
// its Pallas forward rwkv6_scan_pallas has no backward).  Written from the
// formulas above, not carried over from XLA's scan.
//
// Chunks.  Time is walked C = 16 steps at a time, [a, e).  Inside a chunk,
//   alpha_t = prod_{a<=m<t} w_m,  beta_t = prod_{t<m<e} w_m,
//   Lambda  = prod_{a<=m<e} w_m,  D_{t,s} = prod_{s<m<t} w_m,
// and with A = dOut V^T (A[t][s] = dout_t . v_s) the chunk step is
//   P_e   = diag(Lambda) P_a + (K (.) beta)^T V
//   G_a   = diag(Lambda) G_e + (R (.) alpha)^T dOut
//   dr^st_t = alpha_t (.) (P_a dout_t) + sum_{s<t} D_{t,s} (.) k_s A[t][s]
//   dk^st_t = beta_t (.) (G_e v_t)    + sum_{m>t} D_{m,t} (.) r_m A[m][t]
//   dv_t  = (k_t (.) beta_t) G_e + sum_{m>t} B[m][t] dout_m + dout_t bs_t,
//           B[m][t] = sum_i k_t,i D_{m,t,i} r_m,i.
// The products with the state and A are (16 x DK) . (DK x DK) and
// (16 x DK) . (DK x 16) matrix products: 3xTF32 mma.sync.m16n8k8 from
// tf32_mma.cuh (FastFrag split; an operand read from bf16 is exact in tf32
// and has no small part), as is B^T dOut.  The sums inside a chunk (the D
// terms and B) are C x C x DK work on the FP32 cores, about 1/15 of the
// products' FLOP: the P side's by Horner's rule in the fragments' layout,
// the G side's dk and B in one pass over (t, m > t) that carries D_{m,t}
// as a running product, four rows i a thread.
//
// Why products of decays.  Every decay above is a running product of w's
// (alpha, beta and Lambda per column over the chunk; D as Horner's rule
// inside the sums: acc = acc * w_s + k_s A[t][s]), each <= 1.  exp of a
// difference of cumulative log-decays would give NaN for a logw of -inf
// (the model's decay > 88.7: -inf - -inf) and exp(-g) overflows f32 once a
// chunk's decays pass e^88 (16 steps of logw -7.4 are e^-118).  A product
// that underflows is 0, which is what the plain version's state holds.
//
// Layout.  One launch of two kinds of block, a (b, h) each, 2 DK threads
// (DK / 16 warps; warp w owns rows [16 w, 16 w + 16) of a state, kept in
// mma accumulator fragments from the first chunk to the last):
//   blockIdx.y = 0, the G side: walks the chunks backward from dS_T (or
//     zeros), writes dk, dv and ds0, and keeps k (.) dk^st (f32 scratch).
//     dv sums G over rows, across warps, so each chunk puts G_e in shared
//     memory once and the warps read their column bands from there.
//   blockIdx.y = 1, the P side: walks the chunks forward from s0, writes
//     dr, keeps r (.) dr^st in the dlogw output, and ends with du's part
//     of its (b, h) and Q_T.
// The two need nothing from each other, so each block's chain is T / 16
// chunk steps.  The G side (three state products and B) is the heavier,
// so its blocks come first in the grid.
// A chunk's r, k, v, logw and dout come in through 16-byte cp.async, one
// chunk ahead, into the other of two stage buffers (a tensor whose base or
// strides are not 16-byte aligned is copied element by element); rows past
// T are zero-filled (w = 1), and the sums inside a chunk select by m < L
// rather than multiply by a mask, so a NaN spreads only where the plain
// version spreads it.  A chunk takes three barriers: its stage landed; w,
// vd, bs, A (and the G side's copy of G_e) written; alpha, beta (and B and
// dk's sums) written.  A second launch forms dlogw's reverse running sums
// from Q_T and the two kept arrays, a (b, h, i) walked by up to 32 threads
// at once over spans of time (each span's sum first, then each span from
// the later spans' sums), and sums du over b; no atomics, a fixed order of
// additions, so two runs agree bit for bit.
//
// What bounds it.  The formulas need 12 FLOP an element of the state and
// step (the state gradient's carry 3, dr, dk, dv 2 each, the forward
// state's recompute 3): at rwkv6-3b's training shape (B = 8, H = 40,
// T = 128, DK = 64) 2.0 GFLOP, 0.012 ms at 3xTF32's 165 TFLOP/s (0.030 at
// FP32's 67); it moves ~73 MB, 0.022 ms at 3.35 TB/s, so bytes bound it.
// The kernel does the three state products of the G side and two of the P
// side on the tensor cores, and its sums inside a chunk on the FP32 cores;
// the two kept arrays cost the finish launch three more passes over an f32
// (B, H, T, DK) tensor.  Shared memory (two stages, the decay tiles, the
// copy of G_e and dk's sums: 66,752 B at DK = 64 bf16) holds it to three
// blocks an SM; its times against the bound are in PERF.md.
#include "tf32_mma.cuh"

namespace dice {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int CH = 16;    // steps a chunk

template <typename TR, int DK>
struct ChunkShape {
  static constexpr int NW = DK / 16;          // warps: a 16-row band of the state each
  static constexpr int THREADS = 32 * NW;     // = 2 DK
  static constexpr int NT = DK / 8;           // 8-column tiles of a band
  static constexpr int LD = DK + 8;           // elements a chunk tile row (rows 16-byte aligned)
  static constexpr int LDG = DK + 4;          // f32 a row of the G side's copy of G_e
  static constexpr int LDA = CH + 1;          // A[t][s]
  static constexpr int LDB = CH + 8;          // B[m][t]
  static constexpr int RKV_TILE = CH * LD * (int)sizeof(TR);
  static constexpr int F32_TILE = CH * LD * 4;
  // a stage: r, k, v (TR), logw (read in place as w, f32 slots), dout
  static constexpr int OFF_K = RKV_TILE, OFF_V = 2 * RKV_TILE, OFF_W = 3 * RKV_TILE;
  static constexpr int OFF_D = OFF_W + F32_TILE;
  static constexpr int STAGE = OFF_D + F32_TILE;
  // two stages (the next chunk's loads in flight during this one's), then
  // alpha, beta, A, B, vd, bs, u, Lambda (the P side's last), the copy of
  // G_e, dk's sums
  static constexpr int OFF_AL = 2 * STAGE, OFF_BE = OFF_AL + F32_TILE;
  static constexpr int OFF_A = OFF_BE + F32_TILE;
  static constexpr int OFF_B = OFF_A + CH * LDA * 4;
  static constexpr int OFF_VD = OFF_B + CH * LDB * 4;
  static constexpr int OFF_BS = OFF_VD + CH * 4;
  static constexpr int OFF_U = OFF_BS + CH * 4;
  static constexpr int OFF_LAM = OFF_U + DK * 4;
  static constexpr int OFF_GS = OFF_LAM + DK * 4;
  static constexpr int OFF_DKI = OFF_GS + DK * LDG * 4;   // the G side's dk sums inside a chunk
  static constexpr int SMEM = OFF_DKI + F32_TILE;
  static_assert(THREADS == 2 * DK && DK % 16 == 0, "a warp a 16-row band");
  static_assert(RKV_TILE % 16 == 0 && OFF_A % 16 == 0 && OFF_VD % 16 == 0, "16-byte tiles");
};

struct Src {
  const char* p;
  long long sb, sh, st;   // element strides of the batch, head and time dims
};

struct ChunkArgs {
  Src x[5];               // r, k, v, logw, dout; last dim contiguous
  int es_w;               // logw's element bytes (r, k, v: sizeof(TR); dout 4)
  int aligned;            // bit x: rows of x[x] can be copied in 16-byte pieces
  const void* u;          // (H, DK)
  int u_dtype;
  const float* s0;        // (B, H, DK, DK)
  const float* dST;       // (B, H, DK, DK), or null: dS_T = 0
  void* dr;               // (B, H, T, DK) in r's dtype, contiguous
  void* dk;
  void* dv;
  float* dlogw;           // (B, H, T, DK): r (.) dr^st from the P side, then dlogw
  float* kept;            // (B, H, T, DK) scratch: k (.) dk^st from the G side
  float* du_part;         // (B, H, DK) scratch
  float* q;               // (B, H, DK) scratch: Q_T
  float* ds0;             // (B, H, DK, DK)
  int H, T;
};

__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 8 consecutive elements (16-byte aligned) widened to f32.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 consecutive elements (8-byte aligned bf16, 16-byte f32) widened to f32.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(q.x << 16); x[1] = __uint_as_float(q.x & 0xffff0000u);
  x[2] = __uint_as_float(q.y << 16); x[3] = __uint_as_float(q.y & 0xffff0000u);
}

// v[0..NV) summed over the lanes of an aligned group of 2 O lanes (``sub``
// the lane's place in it), reduce-scattered by halving: each lane keeps the
// sums of NV / (2 O) of the values (at least 1), in v[0..), whose first
// index it adds to ``base``.  Deterministic: a fixed tree of additions.
template <int O, int NV>
__device__ __forceinline__ void reduce_scatter(float (&v)[16], int sub, int& base) {
  if constexpr (NV > 1) {
    constexpr int H = NV / 2;
    const bool up = sub & O;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = up ? v[j] : v[j + H];
      const float keep = up ? v[j + H] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, O);
    }
    if (up) base += H;
    if constexpr (O > 1) reduce_scatter<O / 2, H>(v, sub, base);
  } else {
    v[0] += __shfl_xor_sync(kFull, v[0], O);
    if constexpr (O > 1) reduce_scatter<O / 2, 1>(v, sub, base);
  }
}

// d += a b to f32 accuracy, the split parts first (FastFrag's big part of
// a value read from bf16 is the value itself).
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float (&d)[4], const FastFrag<SA, 4>& a,
                                     const FastFrag<SB, 2>& b) {
  if constexpr (SA) mma_tf32(d, a.small, b.big);
  if constexpr (SB) mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

constexpr bool kSF = kSplit<float>;

// Rows [t0, t0 + L) of one input into its tile, 16-byte cp.async pieces
// where its rows are aligned, else element by element; rows L..15
// zero-filled.  ``slot``: logw, whose elements go to f32 slots (a bf16 row
// of 8 into the first half of the 32 bytes its 8 w's take), so the thread
// that widens an item writes w over its own bytes only.  Not inlined: it
// runs once a chunk for each input, and its code stays out of the chunk
// loop's instruction stream.
template <int DK>
__device__ __noinline__ void stage_rows(unsigned char* dst, const char* src, long long row_bytes,
                                        int es, bool slot, bool aligned, int L, int threads) {
  constexpr int LD = DK + 8;
  if (aligned) {
    const int per_row = DK * es / 16, shift = __ffs(per_row) - 1, per = 16 / es;
    const int tile_es = slot ? 4 : es;
    for (int p = threadIdx.x; p < CH * per_row; p += threads) {
      const int row = p >> shift, col = (p & (per_row - 1)) * per;
      const bool live = row < L;
      cp_async16(dst + (row * LD + col) * tile_es, live ? src + row * row_bytes + col * es : src,
                 live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < CH * DK; i += threads) {
      const int row = i / DK, col = i % DK;
      const char* s = src + row * row_bytes + col * es;
      if (es == 4) {
        reinterpret_cast<float*>(dst)[row * LD + col] =
            row < L ? *reinterpret_cast<const float*>(s) : 0.0f;
      } else {
        uint16_t* d = reinterpret_cast<uint16_t*>(dst) +
                      (slot ? 2 * (row * LD + (col & ~7)) + (col & 7) : row * LD + col);
        *d = row < L ? *reinterpret_cast<const uint16_t*>(s) : 0;
      }
    }
  }
}

// Rows [t0, t0 + L) of the five inputs of one (b, h) (``base``: their
// pointers at (b, h, t = 0)) into a stage.
template <typename TR, int DK>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const ChunkArgs& a,
                                            const char* const* base, int t0, int L) {
  using Sh = ChunkShape<TR, DK>;
  const int off[5] = {0, Sh::OFF_K, Sh::OFF_V, Sh::OFF_W, Sh::OFF_D};
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    const int es = x < 3 ? (int)sizeof(TR) : x == 3 ? a.es_w : 4;
    const long long row_bytes = a.x[x].st * es;
    stage_rows<DK>(st + off[x], base[x] + t0 * row_bytes, row_bytes, es, x == 3,
                   a.aligned >> x & 1, L, Sh::THREADS);
  }
}

// One item a thread: 8 elements of one row.  w = exp(logw) over its logw
// slot, and vd = v . dout and bs = sum u r k of the row, reduced over the
// DK / 8 threads of the row.
template <typename TR, int DK>
__device__ __forceinline__ void widen(unsigned char* st, float* svd, float* sbs,
                                      const float* su, int es_w) {
  using Sh = ChunkShape<TR, DK>;
  constexpr int LD = Sh::LD, PER = DK / 8;
  const int t = threadIdx.x / PER, col = threadIdx.x % PER * 8, e0 = t * LD + col;
  float* w = reinterpret_cast<float*>(st + Sh::OFF_W) + e0;
  float x[8];
  if (es_w == 4) {
    load8(w, x);
  } else {
    load8(reinterpret_cast<const __nv_bfloat16*>(w), x);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = exp2f(x[e] * kLog2e);
  reinterpret_cast<float4*>(w)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(w)[1] = make_float4(x[4], x[5], x[6], x[7]);
  float rr[8], kk[8], vv[8], dd[8];
  load8(reinterpret_cast<const TR*>(st) + e0, rr);
  load8(reinterpret_cast<const TR*>(st + Sh::OFF_K) + e0, kk);
  load8(reinterpret_cast<const TR*>(st + Sh::OFF_V) + e0, vv);
  load8(reinterpret_cast<const float*>(st + Sh::OFF_D) + e0, dd);
  float vd = 0.0f, bs = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    vd = fmaf(vv[e], dd[e], vd);
    bs = fmaf(su[col + e] * rr[e], kk[e], bs);
  }
#pragma unroll
  for (int o = 1; o < PER; o <<= 1) {
    vd += __shfl_xor_sync(kFull, vd, o);
    bs += __shfl_xor_sync(kFull, bs, o);
  }
  if (col == 0) {
    svd[t] = vd;
    sbs[t] = bs;
  }
}

// alpha (prefix) and beta (suffix) products of w down each column, one
// thread a column each; Lambda = alpha_15 w_15.
template <int DK, int LD>
__device__ __forceinline__ void decays(const float* W, float* AL, float* BE, float* lam) {
  if (threadIdx.x < DK) {
    const int i = threadIdx.x;
    float p = 1.0f;
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      AL[t * LD + i] = p;
      p *= W[t * LD + i];
    }
    lam[i] = p;
  } else {
    const int i = threadIdx.x - DK;
    float p = 1.0f;
#pragma unroll
    for (int t = CH - 1; t >= 0; --t) {
      BE[t * LD + i] = p;
      p *= W[t * LD + i];
    }
  }
}

// A = dOut V^T (A[t][s] = dout_t . v_s) on the tensor cores: warps 0 and 1
// one 8-column half each (a single warp both).  K (the DK columns) runs in
// the order j = 8 kt + 2 q, 8 kt + 2 q + 1, so each fragment is a pair.
template <typename TR, int DK>
__device__ __forceinline__ void a_matrix(const TR* V, const float* D, float* sA) {
  using Sh = ChunkShape<TR, DK>;
  constexpr int LD = Sh::LD, LDA = Sh::LDA;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane >> 2, q = lane & 3;
  for (int ns = warp; ns < 2; ns += Sh::NW) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < Sh::NT; ++kt) {
      const int j = 8 * kt + 2 * q;
      const float2 d0 = pair(D + g * LD + j), d1 = pair(D + (g + 8) * LD + j);
      FastFrag<kSF, 4> af;
      af.set(0, d0.x); af.set(1, d1.x); af.set(2, d0.y); af.set(3, d1.y);
      const float2 vs = pair(V + (8 * ns + g) * LD + j);
      FastFrag<kSplit<TR>, 2> bf;
      bf.set(0, vs.x); bf.set(1, vs.y);
      mma3(acc, af, bf);
    }
    const int s = 8 * ns + 2 * q;
    sA[g * LDA + s] = acc[0];
    sA[g * LDA + s + 1] = acc[1];
    sA[(g + 8) * LDA + s] = acc[2];
    sA[(g + 8) * LDA + s + 1] = acc[3];
  }
}

// Out[t][i] = sum_j X[t][j] S[i][j] for the warp's 16 rows i of the state:
// the accumulator tile kt of the state is the B fragment of K tile kt when
// K runs in the order j = 8 kt + 2 q, 8 kt + 2 q + 1.  out[ni]: rows t = g,
// g + 8, columns i = 16 w + 8 ni + 2 q, + 1.
template <typename TX, int DK>
__device__ __forceinline__ void by_state(const TX* X, const float (&S)[DK / 8][4],
                                         float (&out)[2][4]) {
  constexpr int LD = DK + 8;
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[ni][c] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < DK / 8; ++kt) {
    const int j = 8 * kt + 2 * q;
    const float2 x0 = pair(X + g * LD + j), x1 = pair(X + (g + 8) * LD + j);
    FastFrag<kSplit<TX>, 4> af;
    af.set(0, x0.x); af.set(1, x1.x); af.set(2, x0.y); af.set(3, x1.y);
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      FastFrag<kSF, 2> bf;
      bf.set(0, S[kt][2 * ni]);
      bf.set(1, S[kt][2 * ni + 1]);
      mma3(out[ni], af, bf);
    }
  }
}

// S = diag(Lambda) S + (X (.) Y)^T Z over the chunk's 16 steps, for the
// warp's rows i: X (.) Y is (t, i) with t the K index, Z (t, j) in TZ.
template <typename TX, typename TZ, int DK>
__device__ __forceinline__ void update_state(float (&S)[DK / 8][4], const float* lam,
                                             const TX* X, const float* Y, const TZ* Z) {
  constexpr int LD = DK + 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane >> 2, q = lane & 3;
  const int i0 = 16 * warp + g, i1 = i0 + 8;
  const float l0 = lam[i0], l1 = lam[i1];
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt) {
    S[nt][0] *= l0; S[nt][1] *= l0; S[nt][2] *= l1; S[nt][3] *= l1;
  }
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const int t0 = 8 * kt + q, t1 = t0 + 4;
    FastFrag<kSF, 4> af;
    af.set(0, load_f32(X + t0 * LD + i0) * Y[t0 * LD + i0]);
    af.set(1, load_f32(X + t0 * LD + i1) * Y[t0 * LD + i1]);
    af.set(2, load_f32(X + t1 * LD + i0) * Y[t1 * LD + i0]);
    af.set(3, load_f32(X + t1 * LD + i1) * Y[t1 * LD + i1]);
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt) {
      FastFrag<kSplit<TZ>, 2> bf;
      bf.set(0, load_f32(Z + t0 * LD + 8 * nt + g));
      bf.set(1, load_f32(Z + t1 * LD + 8 * nt + g));
      mma3(S[nt], af, bf);
    }
  }
}

// Per-(b, h) pointers of the five inputs at t = 0.
__device__ __forceinline__ void bases(const ChunkArgs& a, int b, int h, int es_rkv,
                                      const char* (&base)[5]) {
  const int es[5] = {es_rkv, es_rkv, es_rkv, a.es_w, 4};
#pragma unroll
  for (int x = 0; x < 5; ++x) base[x] = a.x[x].p + (b * a.x[x].sb + h * a.x[x].sh) * es[x];
}

// u of head h, widened to f32, into the shared vector ``su`` (read after
// the first barrier of the chunk loop).
template <int DK>
__device__ __forceinline__ void load_u(float* su, const ChunkArgs& a, int h) {
  for (int i = threadIdx.x; i < DK; i += 2 * DK)
    su[i] = a.u_dtype == kF32
                ? static_cast<const float*>(a.u)[h * DK + i]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(a.u)[h * DK + i]);
}

// The P side: P from s0 forward; dr, r (.) dr^st, du's part, Q_T.
template <typename TR, int DK>
__device__ void p_side(unsigned char* smem, const ChunkArgs& a, int b, int h) {
  using Sh = ChunkShape<TR, DK>;
  constexpr int LD = Sh::LD, NT = Sh::NT, LDA = Sh::LDA;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane >> 2, q = lane & 3;
  const size_t bh = (size_t)b * a.H + h;
  const int T = a.T, nch = (T + CH - 1) / CH;
  float* AL = reinterpret_cast<float*>(smem + Sh::OFF_AL);
  float* BE = reinterpret_cast<float*>(smem + Sh::OFF_BE);
  float* sA = reinterpret_cast<float*>(smem + Sh::OFF_A);
  float* svd = reinterpret_cast<float*>(smem + Sh::OFF_VD);
  float* sbs = reinterpret_cast<float*>(smem + Sh::OFF_BS);
  float* su = reinterpret_cast<float*>(smem + Sh::OFF_U);
  float* lam = reinterpret_cast<float*>(smem + Sh::OFF_LAM);
  const char* base[5];
  bases(a, b, h, sizeof(TR), base);
  load_u<DK>(su, a, h);

  float S[NT][4];
  const float* s0 = a.s0 + (bh * DK + 16 * warp + g) * DK + 2 * q;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 x0 = pair(s0 + 8 * nt), x1 = pair(s0 + 8 * DK + 8 * nt);
    S[nt][0] = x0.x; S[nt][1] = x0.y; S[nt][2] = x1.x; S[nt][3] = x1.y;
  }
  float du[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  TR* dr = static_cast<TR*>(a.dr);

  stage_chunk<TR, DK>(smem, a, base, 0, min(CH, T));
  cp_async_commit();
  for (int n = 0; n < nch; ++n) {
    const int t0 = n * CH, L = min(CH, T - t0);
    cp_async_wait<0>();
    __syncthreads();                          // the stage landed; chunk n - 1 read
    if (n + 1 < nch) stage_chunk<TR, DK>(smem + ((n + 1) & 1) * Sh::STAGE, a, base, t0 + CH,
                                         min(CH, T - t0 - CH));
    cp_async_commit();
    unsigned char* st = smem + (n & 1) * Sh::STAGE;
    const TR* R = reinterpret_cast<const TR*>(st);
    const TR* K = reinterpret_cast<const TR*>(st + Sh::OFF_K);
    const TR* V = reinterpret_cast<const TR*>(st + Sh::OFF_V);
    const float* W = reinterpret_cast<const float*>(st + Sh::OFF_W);
    const float* D = reinterpret_cast<const float*>(st + Sh::OFF_D);
    widen<TR, DK>(st, svd, sbs, su, a.es_w);
    a_matrix<TR, DK>(V, D, sA);
    __syncthreads();                          // w, vd, bs, A
    decays<DK, LD>(W, AL, BE, lam);
    __syncthreads();                          // alpha, beta, Lambda

    // dr^st = alpha (.) (dOut P_a^T) + sum_{s<t} D_{t,s} k_s A[t][s]
    float x[2][4];
    by_state<float, DK>(D, S, x);
    float acc[2][2][2] = {};                  // [t = g, g + 8][ni][column of the pair]
#ifndef DICE_SCAN_BWD_NO_INTRA
#pragma unroll
    for (int s = 0; s < CH - 1; ++s) {
      const float a0 = sA[g * LDA + s], a1 = sA[(g + 8) * LDA + s];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int i = 16 * warp + 8 * ni + 2 * q;
        const float2 ws = pair(W + s * LD + i), ks = pair(K + s * LD + i);
        if (s < g) {
          acc[0][ni][0] = fmaf(acc[0][ni][0], ws.x, ks.x * a0);
          acc[0][ni][1] = fmaf(acc[0][ni][1], ws.y, ks.y * a0);
        }
        if (s < g + 8) {
          acc[1][ni][0] = fmaf(acc[1][ni][0], ws.x, ks.x * a1);
          acc[1][ni][1] = fmaf(acc[1][ni][1], ws.y, ks.y * a1);
        }
      }
    }
#endif
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int t = g + 8 * hi;
      if (t < L) {
        const float vd = svd[t];
        const size_t row = (bh * T + t0 + t) * DK;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int i = 16 * warp + 8 * ni + 2 * q;
          const float2 al = pair(AL + t * LD + i), kk = pair(K + t * LD + i),
                       rr = pair(R + t * LD + i);
          const float d0 = fmaf(al.x, x[ni][2 * hi], acc[hi][ni][0]);
          const float d1 = fmaf(al.y, x[ni][2 * hi + 1], acc[hi][ni][1]);
          store2(dr + row + i, d0 + su[i] * kk.x * vd, d1 + su[i + 1] * kk.y * vd);
          store2(a.dlogw + row + i, rr.x * d0, rr.y * d1);
          du[ni][0] = fmaf(rr.x * kk.x, vd, du[ni][0]);
          du[ni][1] = fmaf(rr.y * kk.y, vd, du[ni][1]);
        }
      }
    }
    // P_e = diag(Lambda) P_a + (K (.) beta)^T V
    update_state<TR, TR, DK>(S, lam, K, BE, V);
  }

  // Q_T = sum_v dS_T (.) S_T, reduced over the 4 lanes of a row
  if (a.dST != nullptr) {
    const float* ds = a.dST + (bh * DK + 16 * warp + g) * DK + 2 * q;
    float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 x0 = pair(ds + 8 * nt), x1 = pair(ds + 8 * DK + 8 * nt);
      q0 = fmaf(x0.x, S[nt][0], q0); q0 = fmaf(x0.y, S[nt][1], q0);
      q1 = fmaf(x1.x, S[nt][2], q1); q1 = fmaf(x1.y, S[nt][3], q1);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      q0 += __shfl_xor_sync(kFull, q0, o);
      q1 += __shfl_xor_sync(kFull, q1, o);
    }
    if (q == 0) {
      a.q[bh * DK + 16 * warp + g] = q0;
      a.q[bh * DK + 16 * warp + g + 8] = q1;
    }
  }
  // du's part of this (b, h), reduced over the 8 lanes of a column
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = du[ni][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
      if (g == 0) a.du_part[bh * DK + 16 * warp + 8 * ni + 2 * q + e] = s;
    }
}

// The G side: G from dS_T backward; dk, dv, k (.) dk^st, ds0.
template <typename TR, int DK>
__device__ void g_side(unsigned char* smem, const ChunkArgs& a, int b, int h) {
  using Sh = ChunkShape<TR, DK>;
  constexpr int LD = Sh::LD, NT = Sh::NT, LDA = Sh::LDA, LDB = Sh::LDB, LDG = Sh::LDG;
  constexpr int PT = DK / 4;                  // threads a (t, 15 - t) pair of B's columns
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane >> 2, q = lane & 3;
  const size_t bh = (size_t)b * a.H + h;
  const int T = a.T, nch = (T + CH - 1) / CH;
  float* AL = reinterpret_cast<float*>(smem + Sh::OFF_AL);
  float* BE = reinterpret_cast<float*>(smem + Sh::OFF_BE);
  float* sA = reinterpret_cast<float*>(smem + Sh::OFF_A);
  float* sB = reinterpret_cast<float*>(smem + Sh::OFF_B);
  float* svd = reinterpret_cast<float*>(smem + Sh::OFF_VD);
  float* sbs = reinterpret_cast<float*>(smem + Sh::OFF_BS);
  float* su = reinterpret_cast<float*>(smem + Sh::OFF_U);
  float* lam = reinterpret_cast<float*>(smem + Sh::OFF_LAM);
  float* Gs = reinterpret_cast<float*>(smem + Sh::OFF_GS);
  const char* base[5];
  bases(a, b, h, sizeof(TR), base);
  load_u<DK>(su, a, h);

  float G[NT][4];
  if (a.dST != nullptr) {
    const float* ds = a.dST + (bh * DK + 16 * warp + g) * DK + 2 * q;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 x0 = pair(ds + 8 * nt), x1 = pair(ds + 8 * DK + 8 * nt);
      G[nt][0] = x0.x; G[nt][1] = x0.y; G[nt][2] = x1.x; G[nt][3] = x1.y;
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) G[nt][0] = G[nt][1] = G[nt][2] = G[nt][3] = 0.0f;
  }
  TR* dk = static_cast<TR*>(a.dk);
  TR* dv = static_cast<TR*>(a.dv);

  {
    const int t0 = (nch - 1) * CH;
    stage_chunk<TR, DK>(smem, a, base, t0, T - t0);
  }
  cp_async_commit();
  for (int n = 0; n < nch; ++n) {
    const int c = nch - 1 - n, t0 = c * CH, L = min(CH, T - t0);
    cp_async_wait<0>();
    __syncthreads();                          // the stage landed; the last chunk read
    if (c > 0) stage_chunk<TR, DK>(smem + ((n + 1) & 1) * Sh::STAGE, a, base, t0 - CH, CH);
    cp_async_commit();
    unsigned char* st = smem + (n & 1) * Sh::STAGE;
    const TR* R = reinterpret_cast<const TR*>(st);
    const TR* K = reinterpret_cast<const TR*>(st + Sh::OFF_K);
    const TR* V = reinterpret_cast<const TR*>(st + Sh::OFF_V);
    const float* W = reinterpret_cast<const float*>(st + Sh::OFF_W);
    const float* D = reinterpret_cast<const float*>(st + Sh::OFF_D);
    widen<TR, DK>(st, svd, sbs, su, a.es_w);
    {
      float* gs = Gs + (16 * warp + g) * LDG + 2 * q;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        store2(gs + 8 * nt, G[nt][0], G[nt][1]);
        store2(gs + 8 * LDG + 8 * nt, G[nt][2], G[nt][3]);
      }
    }
    a_matrix<TR, DK>(V, D, sA);
    __syncthreads();                          // w, vd, bs, G_e, A
    decays<DK, LD>(W, AL, BE, lam);
    // The sums inside the chunk in one pass over (t, m > t, i), with the
    // running products d = D_{m,t}: B[m][t] = sum_i k_t,i d_i r_m,i and
    // dk^in[t][i] = sum_{m<L} d_i r_m,i A[m][t].  PT threads a pair of
    // columns (p, 15 - p), 15 (t, m) between them, 4 consecutive rows i a
    // thread; B's 15 partial sums a thread are reduce-scattered over the PT
    // lanes, dk^in goes to a tile that dk's fragments read.
#ifndef DICE_SCAN_BWD_NO_INTRA
    {
      const int p = threadIdx.x / PT, sub = threadIdx.x % PT, i0 = 4 * sub;
      float* DKI = reinterpret_cast<float*>(smem + Sh::OFF_DKI);
      float part[16], kt[4], acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      int t = p;
      load4(K + t * LD + i0, kt);
#pragma unroll
      for (int it = 0; it < CH - 1; ++it) {
        if (it == CH - 1 - p) {               // column p done: on to 15 - p
          *reinterpret_cast<float4*>(DKI + t * LD + i0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
          t = CH - 1 - p;
          load4(K + t * LD + i0, kt);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[e] = 0.0f;
            d[e] = 1.0f;
          }
        }
        const int m = t == p ? p + 1 + it : it + 1;
        float rm[4], wm[4];
        load4(R + m * LD + i0, rm);
        load4(W + m * LD + i0, wm);
        const float am = sA[m * LDA + t];
        const bool live = m < L;
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = d[e] * rm[e];
          s = fmaf(kt[e], x, s);
          if (live) acc[e] = fmaf(x, am, acc[e]);
          d[e] *= wm[e];
        }
        part[it] = s;
      }
      *reinterpret_cast<float4*>(DKI + t * LD + i0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      if (p == 0)                             // column 15 has no m > t
        *reinterpret_cast<float4*>(DKI + (CH - 1) * LD + i0) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      part[CH - 1] = 0.0f;
      int base = 0;
      reduce_scatter<PT / 2, 16>(part, sub, base);
      constexpr int HELD = PT >= 16 ? 1 : 16 / PT, DUP = PT > 16 ? PT / 16 : 1;
      if (sub % DUP == 0) {
#pragma unroll
        for (int j = 0; j < HELD; ++j) {
          const int idx = base + j;
          if (idx < CH - 1) {
            const int tt = idx < CH - 1 - p ? p : CH - 1 - p;
            const int mm = tt == p ? p + 1 + idx : idx + 1;
            sB[mm * LDB + tt] = part[j];
          }
        }
      }
    }
#endif
    __syncthreads();                          // alpha, beta, Lambda, B, dk's sums

    // dk^st = beta (.) (V G_e^T) + dk^in
    {
      float y[2][4];
      by_state<TR, DK>(V, G, y);
      const float* DKI = reinterpret_cast<const float*>(smem + Sh::OFF_DKI);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int t = g + 8 * hi;
        if (t < L) {
          const float vd = svd[t];
          const size_t row = (bh * T + t0 + t) * DK;
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const int i = 16 * warp + 8 * ni + 2 * q;
            const float2 be = pair(BE + t * LD + i), kk = pair(K + t * LD + i),
                         rr = pair(R + t * LD + i), in = pair(DKI + t * LD + i);
            const float d0 = fmaf(be.x, y[ni][2 * hi], in.x);
            const float d1 = fmaf(be.y, y[ni][2 * hi + 1], in.y);
            store2(dk + row + i, d0 + su[i] * rr.x * vd, d1 + su[i + 1] * rr.y * vd);
            store2(a.kept + row + i, kk.x * d0, kk.y * d1);
          }
        }
      }
    }
    // dv = (K (.) beta) G_e + B^T dOut + dout bs, the warp's columns
    // [16 w, 16 w + 16): G_e's rows from the shared copy, in the K order
    // i = 8 kt + 2 q, 8 kt + 2 q + 1
    {
      float z[2][4] = {};
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        const int i = 8 * kt + 2 * q;
        const float2 k0 = pair(K + g * LD + i), k1 = pair(K + (g + 8) * LD + i);
        const float2 b0 = pair(BE + g * LD + i), b1 = pair(BE + (g + 8) * LD + i);
        FastFrag<kSF, 4> af;
        af.set(0, k0.x * b0.x); af.set(1, k1.x * b1.x); af.set(2, k0.y * b0.y); af.set(3, k1.y * b1.y);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int j = 16 * warp + 8 * nj + g;
          FastFrag<kSF, 2> bf;
          bf.set(0, Gs[i * LDG + j]);
          bf.set(1, Gs[(i + 1) * LDG + j]);
          mma3(z[nj], af, bf);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const int m0 = 8 * kt + q, m1 = m0 + 4;
        FastFrag<kSF, 4> af;
        af.set(0, m0 > g && m0 < L ? sB[m0 * LDB + g] : 0.0f);
        af.set(1, m0 > g + 8 && m0 < L ? sB[m0 * LDB + g + 8] : 0.0f);
        af.set(2, m1 > g && m1 < L ? sB[m1 * LDB + g] : 0.0f);
        af.set(3, m1 > g + 8 && m1 < L ? sB[m1 * LDB + g + 8] : 0.0f);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int j = 16 * warp + 8 * nj + g;
          FastFrag<kSF, 2> bf;
          bf.set(0, D[m0 * LD + j]);
          bf.set(1, D[m1 * LD + j]);
          mma3(z[nj], af, bf);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int t = g + 8 * hi;
        if (t < L) {
          const float bs = sbs[t];
          const size_t row = (bh * T + t0 + t) * DK;
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            const int j = 16 * warp + 8 * nj + 2 * q;
            const float2 dd = pair(D + t * LD + j);
            store2(dv + row + j, fmaf(dd.x, bs, z[nj][2 * hi]), fmaf(dd.y, bs, z[nj][2 * hi + 1]));
          }
        }
      }
    }
    // G_a = diag(Lambda) G_e + (R (.) alpha)^T dOut
    update_state<TR, float, DK>(G, lam, R, AL, D);
  }
  float* ds0 = a.ds0 + (bh * DK + 16 * warp + g) * DK + 2 * q;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    store2(ds0 + 8 * nt, G[nt][0], G[nt][1]);
    store2(ds0 + 8 * DK + 8 * nt, G[nt][2], G[nt][3]);
  }
}

template <typename TR, int DK>
__global__ void __launch_bounds__(ChunkShape<TR, DK>::THREADS)
rwkv6_scan_bwd_kernel(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
#ifdef DICE_SCAN_BWD_ONLY
  if (blockIdx.y != DICE_SCAN_BWD_ONLY) return;
#endif
  if (blockIdx.y == 0) g_side<TR, DK>(smem, a, b, h);
  else p_side<TR, DK>(smem, a, b, h);
}

// dlogw_t = Q_T + sum_{m>t} r_m dr^st_m - sum_{m>=t} k_m dk^st_m, the
// reverse running sum of each (b, h, i) over the two kept arrays (r dr^st
// is in dlogw and is overwritten as the sum passes), split over NSEG spans
// of time so that NSEG threads walk one (b, h, i) at once: each sums its
// span, from its last step, into shared memory; each then starts from Q_T
// plus the later spans' sums, added from the last span down, and walks its
// span back (a span of up to 16 steps stays in registers between the two
// walks).  The threads of b = 0 and the first span also sum du over b in
// order.  No atomics: a fixed order of additions.
constexpr int FIN_SPAN = 16;      // steps a span when T <= FIN_SPAN * FIN_MAXSEG
constexpr int FIN_MAXSEG = 32;
constexpr int FIN_I = 32;         // i's a block

__global__ void __launch_bounds__(FIN_MAXSEG * FIN_I)
rwkv6_scan_bwd_finish_kernel(float* __restrict__ dlogw, const float* __restrict__ kept,
                             const float* __restrict__ q, const float* __restrict__ du_part,
                             void* du, int B, int H, int T, int DK, int u_dtype) {
  __shared__ float tot[FIN_MAXSEG][FIN_I];
  const int ni = min(DK, FIN_I), nseg = blockDim.x / ni;
  const int il = threadIdx.x % ni, seg = threadIdx.x / ni;
  const long long bh = blockIdx.x / (DK / ni);
  const int i = blockIdx.x % (DK / ni) * ni + il;
  const int span = (T + nseg - 1) / nseg;
  const int t0 = min(T, seg * span), t1 = min(T, t0 + span);
  float* lw = dlogw + bh * T * DK + i;
  const float* kp = kept + bh * T * DK + i;
  float x[FIN_SPAN], y[FIN_SPAN];
  const bool held = span <= FIN_SPAN;
  float s = 0.0f;
  if (held) {
#pragma unroll
    for (int u = 0; u < FIN_SPAN; ++u) {
      const int t = t1 - 1 - u;
      if (t >= t0) {
        x[u] = kp[(long long)t * DK];
        y[u] = lw[(long long)t * DK];
      }
    }
#pragma unroll
    for (int u = 0; u < FIN_SPAN; ++u)
      if (t1 - 1 - u >= t0) s += y[u] - x[u];
  } else {
    for (int t = t1 - 1; t >= t0; --t) s += lw[(long long)t * DK] - kp[(long long)t * DK];
  }
  tot[seg][il] = s;
  __syncthreads();
  float R = q != nullptr ? q[bh * DK + i] : 0.0f;
  for (int j = nseg - 1; j > seg; --j) R += tot[j][il];
  if (held) {
#pragma unroll
    for (int u = 0; u < FIN_SPAN; ++u) {
      const int t = t1 - 1 - u;
      if (t >= t0) {
        R -= x[u];
        lw[(long long)t * DK] = R;
        R += y[u];
      }
    }
  } else {
    int t = t1 - 1;
    for (; t - 7 >= t0; t -= 8) {
      float xs[8], ys[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        xs[u] = kp[(long long)(t - u) * DK];
        ys[u] = lw[(long long)(t - u) * DK];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        R -= xs[u];
        lw[(long long)(t - u) * DK] = R;
        R += ys[u];
      }
    }
    for (; t >= t0; --t) {
      const float xv = kp[(long long)t * DK], yv = lw[(long long)t * DK];
      R -= xv;
      lw[(long long)t * DK] = R;
      R += yv;
    }
  }
  if (bh < H && seg == 0) {
    float sum = 0.0f;
    for (int b = 0; b < B; ++b) sum += du_part[((long long)b * H + bh) * DK + i];
    if (u_dtype == kF32) static_cast<float*>(du)[bh * DK + i] = sum;
    else static_cast<__nv_bfloat16*>(du)[bh * DK + i] = __float2bfloat16(sum);
  }
}

// A build with -DDICE_SCAN_BWD_SMEM_EXTRA=n asks for n bytes more shared
// memory than the blocks use: a diagnostic that shows what a block less on
// each SM costs (launch/kernel_variants.py).
#ifndef DICE_SCAN_BWD_SMEM_EXTRA
#define DICE_SCAN_BWD_SMEM_EXTRA 0
#endif

template <typename TR, int DK>
int launch(const ChunkArgs& a, int B, void* du, int u_dtype, int device, cudaStream_t stream) {
  using Sh = ChunkShape<TR, DK>;
  // the G side's layout (the P side's ends before G_e's copy)
  constexpr int smem = Sh::SMEM + DICE_SCAN_BWD_SMEM_EXTRA;
  // above 48 KB of shared memory a block must ask for it, once per device
  static bool asked[64] = {};
  if (smem > 48 * 1024 && device < 64 && !asked[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_bwd_kernel<TR, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    asked[device] = true;
  }
  rwkv6_scan_bwd_kernel<TR, DK><<<dim3(B * a.H, 2), Sh::THREADS, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // spans of FIN_SPAN steps, at most FIN_MAXSEG of them (then longer spans)
  const int nseg = min(FIN_MAXSEG, (a.T + FIN_SPAN - 1) / FIN_SPAN), ni = min(DK, FIN_I);
  rwkv6_scan_bwd_finish_kernel<<<(unsigned)((long long)B * a.H * (DK / ni)), nseg * ni, 0,
                                 stream>>>(a.dlogw, a.kept, a.dST != nullptr ? a.q : nullptr,
                                           a.du_part, du, B, a.H, a.T, DK, u_dtype);
  return (int)cudaGetLastError();
}

template <typename TR>
int launch_dk(const ChunkArgs& a, int B, int DK, void* du, int u_dtype, int device,
              cudaStream_t s) {
  switch (DK) {
    case 16: return launch<TR, 16>(a, B, du, u_dtype, device, s);
    case 32: return launch<TR, 32>(a, B, du, u_dtype, device, s);
    case 64: return launch<TR, 64>(a, B, du, u_dtype, device, s);
    case 128: return launch<TR, 128>(a, B, du, u_dtype, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dice

// Gradients of dice_rwkv6_scan.  Strides are in elements (*_sb, *_sh, *_st
// for the batch, head and time dims of r, k, v, logw and dout; the last dim
// of each is contiguous).  Dtype codes (0 f32, 1 bf16): rkv_dtype for r/k/v
// and the outputs dr/dk/dv, w_dtype for logw, u_dtype for u and du; dout,
// s0, dS_T (null: zeros), dlogw, ds0 and scratch are f32; scratch holds
// B * H * DK * (T + 2) floats (k (.) dk^st, du's parts, Q_T).  Two
// launches.  DK must be 16, 32, 64 or 128.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for another DK).
extern "C" int dice_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* logw, const void* u,
    const void* s0, const void* dout, const void* dST, void* dr, void* dk, void* dv,
    void* dlogw, void* du, void* ds0, void* scratch, int B, int H, int T, int DK,
    long long r_sb, long long r_sh, long long r_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, long long w_sb,
    long long w_sh, long long w_st, long long d_sb, long long d_sh, long long d_st,
    int rkv_dtype, int w_dtype, int u_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaGetLastError();
  const int e_rkv = rkv_dtype == dice::kF32 ? 4 : 2, e_w = w_dtype == dice::kF32 ? 4 : 2;
  dice::ChunkArgs a{};
  const void* src[5] = {r, k, v, logw, dout};
  const long long sb[5] = {r_sb, k_sb, v_sb, w_sb, d_sb}, sh[5] = {r_sh, k_sh, v_sh, w_sh, d_sh},
                  st[5] = {r_st, k_st, v_st, w_st, d_st};
  const int es[5] = {e_rkv, e_rkv, e_rkv, e_w, 4};
  for (int x = 0; x < 5; ++x) {
    a.x[x] = {static_cast<const char*>(src[x]), sb[x], sh[x], st[x]};
    if (dice::rows_16b_aligned(src[x], sb[x] * es[x]) && sh[x] * es[x] % 16 == 0 &&
        st[x] * es[x] % 16 == 0)
      a.aligned |= 1 << x;
  }
  a.es_w = e_w;
  a.u = u;
  a.u_dtype = u_dtype;
  a.s0 = static_cast<const float*>(s0);
  a.dST = static_cast<const float*>(dST);
  a.dr = dr;
  a.dk = dk;
  a.dv = dv;
  a.dlogw = static_cast<float*>(dlogw);
  a.ds0 = static_cast<float*>(ds0);
  float* sc = static_cast<float*>(scratch);
  const size_t bhd = (size_t)B * H * DK;
  a.kept = sc;
  a.du_part = sc + bhd * T;
  a.q = a.du_part + bhd;
  a.H = H;
  a.T = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rkv_dtype == dice::kF32
             ? dice::launch_dk<float>(a, B, DK, du, u_dtype, device, s)
             : dice::launch_dk<__nv_bfloat16>(a, B, DK, du, u_dtype, device, s);
}
