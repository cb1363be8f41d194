// Online-softmax attention for Hopper (sm_90a) on the tensor cores.
//   q (B, Sq, H, Dh), k/v (B, Sk, KVH, Dh) -> o (B, Sq, H, Dh)
// read and written through strides in that layout (the last dim must be
// contiguous), so the caller makes no transposed copy.  Options as the
// Pallas kernel's: causal, sliding window, logit softcap, GQA by
// h // (H / KVH); masked logits are -1e30 (not -inf), keys past Sk are
// padding at -inf, so a fully masked row gives the mean of V; l is clamped
// at 1e-30.  Dh up to 256; f32 or bf16 in and out.
//
// KV-cache masks (the LM families' prefill and ring-buffer decode): query
// row i has the absolute position pq = q_offset + i; key slot j has
// pk = k_pos[j] when a k_pos vector is given (a negative value marks an
// empty slot), else pk = j.  Key j is kept for row i iff
//   pk >= 0 && (!causal || pq >= pk) && (!window || pq - pk < window)
//           && (!symmetric || pk - pq < window).
// symmetric is the Pallas kernel's window when not causal; the wrapper
// clears it for the one-sided window of layers.attention.  Every key tile
// is walked whatever the mask: k_pos need not be monotone (a wrapped ring
// is not), and a fully masked row must still see every slot.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention), which keeps m/l/acc in VMEM scratch across its
// sequential kv-block grid axis.  Here one block of 8 warps owns 128 query
// rows of one (b, h) and loops over the keys; nothing carries across
// blocks.
//
// Bound: at the DiT-MoE-XL shape (8, 256, 16, 72) f32 the two products are
// 2.4 GFLOP against 38 MB of q/k/v/o, so operations bound it.  Both
// products run on the tensor cores as mma.sync m16n8k8 tf32 with the
// 3xTF32 split (tf32_mma.cuh), which keeps f32 accuracy at up to 165
// TFLOP/s instead of the CUDA cores' 67.  The three passes and the split
// (cvt, sub, cvt per fragment value) are most of its time: one pass alone
// takes half of it.
//   - Each warp owns 16 query rows, the m16 of the mma.  S = Q K^T is
//     computed in register fragments, Dh in k-steps of 8 (9 at Dh = 72),
//     Dh padded with zeros to a multiple of 8 in shared memory; q is scaled
//     as its fragments are formed.
//   - Online softmax stays in registers: a thread holds 2 rows x 2 keys of
//     each 8-key tile, so a row's max reduces over the 4 lanes that share
//     it (two __shfl_xor_sync); its sum is kept per lane and reduced once
//     at the end.
//   - O = P V takes P straight from S's accumulator registers: the keys of
//     each 8-key step are taken in the order 0, 2, 4, 6 | 1, 3, 5, 7, which
//     turns the C-fragment layout into the A-fragment layout, and V's B
//     fragments are read from the same key rows.  No shuffle, no staging.
//   - Shared rows are padded by 16 bytes (f32: Dh + 4 floats), so the 32
//     lanes of every fragment load hit 32 different banks, for Q and K
//     (rows g, columns t) and for V (rows 2t, 2t + 1, columns g) alike.
//   - q and K/V tiles of 32 keys (16 when Dh > 128) come in through a
//     2-stage cp.async ring (16-byte cp.async.cg with zero-fill where every
//     row is 16-byte aligned, element loads otherwise).  At Dh = 72 f32 a
//     block holds 76 KB and its threads 128 registers (-Xptxas -v, no
//     spill), so two blocks share an SM and the DiT shape's 256 blocks run
//     in one wave.  4 warps of 64 rows with 64-key tiles need 95 KB and 168
//     registers and run 512 blocks in two waves, 1.4x as long on an H100
//     SXM (launch/kernel_variants.py); a whole 256-key head kept resident
//     (194 KB with 128 rows of q) would allow one block per SM.
//   - The register tiles are sized by a template argument NT (8-wide Dh
//     tiles: 4, 9, 16 or 32), so the O accumulator never spills to local
//     memory; Dh = 72 runs at NT = 9 with no padding tile.
//   - A warp whose 16 query rows all lie past Sq skips the products and
//     the softmax (it still helps load the tiles): decode (Sq = 1) runs
//     one warp of eight, a 32-query DistriFusion owner two.
//   - An optional f32 (B, H, Sq) output lse receives each row's log-sum-
//     exp of the scaled logits, m + log(l), for the backward kernel
//     (flash_attention_bwd.cu).  It is stored where the epilogue
//     normalises by l, by the lane of each quad that holds t = 0; with a
//     null pointer the kernel computes and writes exactly what it did
//     without it.  An optional f32 (B, Sq, H, Dh) contiguous output o32
//     receives acc / l unrounded beside a bf16 o: the backward's D =
//     rowsum(dO * O) is the reference's sum of P dP, the output before
//     its bf16 rounding.
#include <type_traits>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace dice {
namespace {

// Tiling.  The defaults are the port's; launch/kernel_variants.py builds
// other values with -D and times them against these: DICE_FLASH_WARPS
// warps of 16 query rows per block, K/V tiles of DICE_FLASH_KEYS keys
// (half as many when Dh > 128).
#ifndef DICE_FLASH_WARPS
#define DICE_FLASH_WARPS 8
#endif
#ifndef DICE_FLASH_KEYS
#define DICE_FLASH_KEYS 32
#endif
constexpr int WARPS = DICE_FLASH_WARPS;
constexpr int BQ = 16 * WARPS;          // query rows per block
constexpr int STAGES = 2;               // K/V ring depth
constexpr float MASKED = -1e30f;

struct Strides {
  long long b, s, h;
};

// keys per K/V tile for the head-dim class NT
template <int NT>
__host__ __device__ constexpr int key_tile() {
  return NT > 16 ? DICE_FLASH_KEYS / 2 : DICE_FLASH_KEYS;
}

// Elements per shared row: Dh padded to dp (a multiple of 8), plus 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ int row_ld(int dp) { return dp + 16 / (int)sizeof(T); }

template <typename T, int NT>
size_t smem_bytes(int dp) {
  return sizeof(T) * (size_t)(BQ + STAGES * 2 * key_tile<NT>()) * row_ld<T>(dp);
}

// rows x dp tile of q, k or v (sequence positions pos0 ...) into shared
// memory, zero past S and past Dh.  vec: every row is 16-byte aligned, so
// cp.async pieces.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ss, int pos0,
                                          int rows, int S, int Dh, int dp, bool vec) {
  const int ld = row_ld<T>(dp);
  if (vec) {
    constexpr int VE = 16 / sizeof(T);
    const int cpr = dp / VE;
    for (int idx = threadIdx.x; idx < rows * cpr; idx += blockDim.x) {
      const int r = idx / cpr, d0 = (idx % cpr) * VE;
      const int p = pos0 + r;
      const int n = p < S ? max(0, min(VE, Dh - d0)) : 0;
      cp_async16(dst + r * ld + d0, n > 0 ? src + p * ss + d0 : src, n * (int)sizeof(T));
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * dp; idx += blockDim.x) {
      const int r = idx / dp, dd = idx % dp;
      const int p = pos0 + r;
      store_f32(dst + r * ld + dd, p < S && dd < Dh ? load_f32(src + p * ss + dd) : 0.0f);
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
             float* __restrict__ o32, const int* __restrict__ k_pos, int q_offset, int Sq, int Sk, int H,
             int KVH, int Dh, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int has_window, int window, int symmetric, int has_softcap,
             float softcap, float scale, int aligned) {
  constexpr int BKV = key_tile<NT>();
  constexpr int SN = BKV / 8;           // 8-key tiles of S per K/V tile
  constexpr bool SPLIT_KV = kSplit<T>;
  constexpr bool SPLIT_QP = kSplit<float>;   // q * scale and P are f32
  extern __shared__ __align__(16) unsigned char smem[];
  const int nd = (Dh + 7) / 8, dp = 8 * nd;
  const int ld = row_ld<T>(dp);
  T* Qs = reinterpret_cast<T*>(smem);                            // BQ x ld
  T* ring = Qs + BQ * ld;                                        // STAGES x {K, V}
  const size_t tile = (size_t)BKV * ld;

  const int bh = blockIdx.y;
  const int b = bh / H, hh = bh % H;
  const int kvh = hh / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const T* qb = q + b * qs.b + hh * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const int ntiles = (Sk + BKV - 1) / BKV;
  auto load_stage = [&](int stage, int kt) {
    load_rows(ring + (2 * stage) * tile, kb, ks.s, kt * BKV, BKV, Sk, Dh, dp, aligned & 1);
    load_rows(ring + (2 * stage + 1) * tile, vb, vs.s, kt * BKV, BKV, Sk, Dh, dp,
              aligned & 2);
  };

  // q joins the first K/V tile's group
  load_rows(Qs, qb, qs.s, q0, BQ, Sq, Dh, dp, aligned & 4);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};
  const int row = warp * 16 + g;        // rows row and row + 8 of the block
  const T* qa = Qs + row * ld + t;
  const bool active = q0 + warp * 16 < Sq;   // warp-uniform
  const int pq0 = q_offset + q0 + row;        // position of row `row`

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                    // tile kt landed; tile kt - 1 consumed
    {
      const int nk = kt + STAGES - 1;
      if (nk < ntiles) load_stage(nk % STAGES, nk);
      cp_async_commit();
    }
    if (!active) continue;              // its rows are all past Sq
    const T* Kt = ring + (2 * (kt % STAGES)) * tile;
    const T* Vt = Kt + tile;
    const int key0 = kt * BKV;

    // S = (Q * scale) K^T for this warp's 16 rows x BKV keys
    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      if (kk < nd) {
        Frag<SPLIT_QP, 4> a;
        const T* ap = qa + kk * 8;
        a.set(0, load_f32(ap) * scale);
        a.set(1, load_f32(ap + 8 * ld) * scale);
        a.set(2, load_f32(ap + 4) * scale);
        a.set(3, load_f32(ap + 8 * ld + 4) * scale);
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          const T* bp = Kt + (j * 8 + g) * ld + kk * 8 + t;
          Frag<SPLIT_KV, 2> bf;
          bf.set(0, load_f32(bp));
          bf.set(1, load_f32(bp + 4));
          mma_3xtf32(s[j], a, bf);
        }
      }
    }

    // softcap, masks, padding keys; running max over the quad of lanes.
    // Two copies of the loop behind a uniform branch: without k_pos a key's
    // position is its index and no load is issued.
    float mx[2] = {-INFINITY, -INFINITY};
    auto mask = [&](auto key_pos) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pq = pq0 + (e >> 1) * 8;
          const int key = key0 + j * 8 + 2 * t + (e & 1);
          const int pk = key_pos(key);
          float x = s[j][e];
          if (has_softcap) x = softcap * tanhf(x / softcap);
          bool keep = pk >= 0;
          if (causal) keep = keep && (pq >= pk);
          if (has_window) {
            keep = keep && (pq - pk) < window;
            if (symmetric) keep = keep && (pk - pq) < window;
          }
          if (!keep) x = MASKED;
          x = key < Sk ? x : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    };
    if (k_pos == nullptr)
      mask([](int key) { return key; });
    else
      mask([&](int key) { return key < Sk ? __ldg(k_pos + key) : 0; });
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V, 8 keys a step; mma k-index t <-> key 2t, t + 4 <-> key 2t + 1
#pragma unroll
    for (int kk = 0; kk < SN; ++kk) {
      Frag<SPLIT_QP, 4> a;
      a.set(0, s[kk][0]);
      a.set(1, s[kk][2]);
      a.set(2, s[kk][1]);
      a.set(3, s[kk][3]);
      const T* bp = Vt + (kk * 8 + 2 * t) * ld + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nd) {
          Frag<SPLIT_KV, 2> bf;
          bf.set(0, load_f32(bp + n * 8));
          bf.set(1, load_f32(bp + ld + n * 8));
          mma_3xtf32(acc[n], a, bf);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pq = q0 + row + r * 8;
      if (pq < Sq) lse[(size_t)bh * Sq + pq] = m[r] + logf(l[r]);
    }
  }
  T* ob = o + b * os.b + hh * os.h;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pq = q0 + row + (e >> 1) * 8;
      const int dd = n * 8 + 2 * t + (e & 1);
      if (n < nd && pq < Sq && dd < Dh) {
        const float val = acc[n][e] / l[e >> 1];
        store_f32(ob + pq * os.s + dd, val);
        if (o32 != nullptr) o32[(((size_t)b * Sq + pq) * H + hh) * Dh + dd] = val;
      }
    }
}

template <typename T, int NT>
cudaError_t launch_nt(const void* q, const void* k, const void* v, void* o, float* lse,
                      float* o32, const int* k_pos, int q_offset, int B, int Sq, int Sk, int H, int KVH,
                      int Dh, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                      int has_window, int window, int symmetric, int has_softcap,
                      float softcap, cudaStream_t stream) {
  const int dp = 8 * ((Dh + 7) / 8);
  const size_t smem = smem_bytes<T, NT>(dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long es = sizeof(T);
  auto vec = [&](const void* p, Strides st) {
    return int(rows_16b_aligned(p, st.b * es) && st.s * es % 16 == 0 && st.h * es % 16 == 0);
  };
  // bit 0: k, 1: v, 2: q has 16-byte aligned rows (cp.async pieces)
  const int aligned = vec(k, ks) | vec(v, vs) << 1 | vec(q, qs) << 2;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T, NT><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, o32, k_pos, q_offset, Sq, Sk, H, KVH, Dh, qs, ks, vs, os, causal,
      has_window, window, symmetric, has_softcap, softcap, (float)(1.0 / sqrt((double)Dh)),
      aligned);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   float* o32, const int* k_pos, int q_offset, int B, int Sq, int Sk, int H, int KVH,
                   int Dh, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   int has_window, int window, int symmetric, int has_softcap, float softcap,
                   cudaStream_t stream) {
  const int nd = (Dh + 7) / 8;
  auto run = [&](auto kernel_nt) {
    constexpr int NT = decltype(kernel_nt)::value;
    return launch_nt<T, NT>(q, k, v, o, lse, o32, k_pos, q_offset, B, Sq, Sk, H, KVH, Dh, qs, ks,
                            vs, os, causal, has_window, window, symmetric, has_softcap,
                            softcap, stream);
  };
  if (nd <= 4) return run(std::integral_constant<int, 4>{});
  if (nd <= 9) return run(std::integral_constant<int, 9>{});
  if (nd <= 16) return run(std::integral_constant<int, 16>{});
  return run(std::integral_constant<int, 32>{});
}

}  // namespace
}  // namespace dice

// Strides are in elements: *_sb, *_ss, *_sh for the batch, sequence and head
// dims of each tensor.  lse: null, or f32 (B, H, Sq) contiguous for the rows'
// log-sum-exp.  o32: null, or f32 (B, Sq, H, Dh) contiguous for the output
// unrounded (beside a bf16 o).  k_pos: null, or int32 (Sk,) key positions (negative: empty
// slot); q_offset: the position of query row 0.  symmetric: the window also
// masks keys window or more past the query.  dtype: 0 f32, 1 bf16.
// Returns cudaGetLastError().
extern "C" int dice_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, void* o32,
    const void* k_pos,
    int q_offset, int B, int Sq, int Sk,
    int H, int KVH, int Dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    int has_window, int window, int symmetric, int has_softcap, float softcap, int dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return (int)cudaGetLastError();
  const dice::Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(k_pos);
  if (dtype == dice::kF32)
    err = dice::launch<float>(q, k, v, o, static_cast<float*>(lse),
                              static_cast<float*>(o32), kp, q_offset, B, Sq, Sk,
                              H, KVH, Dh, qs, ks, vs, os, causal, has_window, window,
                              symmetric, has_softcap, softcap, s);
  else
    err = dice::launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse),
                                      static_cast<float*>(o32), kp, q_offset, B,
                                      Sq, Sk, H, KVH, Dh, qs, ks, vs, os, causal, has_window,
                                      window, symmetric, has_softcap, softcap, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
