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
// warp owns one row and holds it in registers: each lane loads its share of
// value and base once, in 16-byte vectors (4 f32 or 8 bf16), takes the
// abs-max with one warp reduction, and writes q packed four (f32) or eight
// (bf16) to a store, recon in 16-byte vectors and the scale once.  Loads
// and stores carry streaming hints (ld.global.cs / st.global.cs): nothing is
// read twice.  Rounding is rintf (half to even, like jnp.round); the
// quotient is an IEEE division, not a reciprocal multiply, and recon avoids
// FMA contraction, so q, scale and recon are the reference's to the bit.
//
// Bound: memory.  At N=4096, d=1152 f32 (the dispatch payload of 8
// DiT-MoE-XL requests) it must read 37.7 MB and write 23.6 MB: 0.0183 ms at
// 3.35 TB/s.  The register path takes d up to 32 * 16 vectors (2048 f32,
// 4096 bf16) with 16-byte aligned rows; any other row (d not a multiple of
// the vector, wider, or unaligned) goes through a looping kernel that reads
// the row twice, the second time from L1/L2.  A build with
// -DDICE_INT8_LOOP sends every row there (launch/kernel_variants.py times
// it; the port never builds it).
#include "common.cuh"

namespace dice {
namespace {

constexpr int ROWS_PER_BLOCK = 8;       // one warp per row
constexpr int MAX_VPL = 16;             // 16-byte vectors a lane holds of each input

// 16 bytes of T widened to f32, and back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int W = 4;
  static __device__ __forceinline__ void unpack(uint4 x, float (&f)[W]) {
    f[0] = __uint_as_float(x.x); f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z); f[3] = __uint_as_float(x.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[W]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int W = 8;
  static __device__ __forceinline__ void unpack(uint4 x, float (&f)[W]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t bits(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[W]) {
    return make_uint4(bits(f[0]) | bits(f[1]) << 16, bits(f[2]) | bits(f[3]) << 16,
                      bits(f[4]) | bits(f[5]) << 16, bits(f[6]) | bits(f[7]) << 16);
  }
};

// |x| as its IEEE bits.  For non-negative floats the unsigned order is the
// float order, and every NaN (exponent all ones, mantissa non-zero) lies
// above +Inf, so an integer max finds a row's abs-max and propagates NaN
// as jnp.max does, where fmaxf would drop a NaN operand: one integer max
// an element, as fmaxf was, and one __reduce_max_sync a warp.
__device__ __forceinline__ uint32_t abs_bits(float x) { return __float_as_uint(fabsf(x)); }
constexpr uint32_t kInfBits = 0x7f800000u;   // rows with a smaller max are finite

__device__ __forceinline__ float row_scale(uint32_t amax_bits, float eps) {
  // amax * f32(1/127): XLA compiles the reference's division by the
  // constant 127 into this product, so the scales agree to the bit; a NaN
  // scale stays NaN, as jnp.maximum keeps it
  const float s = __fmul_rn(__uint_as_float(amax_bits), 1.0f / 127.0f);
  return s != s ? s : fmaxf(s, eps);
}

// In a row with a NaN or Inf the quotient can be NaN; it quantizes to 0, as
// the int8 cast does in JAX and in torch (fmaxf alone would clip it to
// -127).  Finite rows, the fast path, skip the test: a whole warp takes one
// of the two instantiations.
template <bool FINITE>
__device__ __forceinline__ float quantize(float r, float s) {
  const float t = rintf(r / s);
  if (!FINITE && t != t) return 0.0f;
  return fminf(fmaxf(t, -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t pack_q4(const float* q) {
  return (uint32_t)(uint8_t)(int8_t)q[0] | (uint32_t)(uint8_t)(int8_t)q[1] << 8 |
         (uint32_t)(uint8_t)(int8_t)q[2] << 16 | (uint32_t)(uint8_t)(int8_t)q[3] << 24;
}

// q and recon of one row from the lane's registers.
template <typename T, int VPL, bool FINITE>
__device__ __forceinline__ void store_row(const uint4 (&vr)[VPL], const uint4 (&br)[VPL], int lane,
                                          int nvec, float s, int8_t* __restrict__ q,
                                          T* __restrict__ recon) {
  constexpr int W = Vec<T>::W;
  uint4* rp = reinterpret_cast<uint4*>(recon);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float v[W], b[W], qi[W], out[W];
      Vec<T>::unpack(vr[i], v);
      Vec<T>::unpack(br[i], b);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        qi[e] = quantize<FINITE>(v[e] - b[e], s);
        out[e] = __fadd_rn(b[e], __fmul_rn(qi[e], s));
      }
      if constexpr (W == 4) {
        __stcs(reinterpret_cast<unsigned int*>(q) + c, pack_q4(qi));
      } else {
        __stcs(reinterpret_cast<uint2*>(q) + c, make_uint2(pack_q4(qi), pack_q4(qi + 4)));
      }
      __stcs(rp + c, Vec<T>::pack(out));
    }
  }
}

// The register path: VPL vectors of value and base per lane.
template <typename T, int VPL>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
residual_int8_kernel(const T* __restrict__ value, const T* __restrict__ base,
                     int8_t* __restrict__ q, float* __restrict__ scale,
                     T* __restrict__ recon, int N, int d, float eps) {
  constexpr int W = Vec<T>::W;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const int nvec = d / W;
  const size_t off = (size_t)row * d;
  const uint4* vp = reinterpret_cast<const uint4*>(value + off);
  const uint4* bp = reinterpret_cast<const uint4*>(base + off);

  uint4 vr[VPL], br[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      vr[i] = __ldcs(vp + c);
      br[i] = __ldcs(bp + c);
    }
  }
  uint32_t amax = 0;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < nvec) {
      float v[W], b[W];
      Vec<T>::unpack(vr[i], v);
      Vec<T>::unpack(br[i], b);
#pragma unroll
      for (int e = 0; e < W; ++e) amax = max(amax, abs_bits(v[e] - b[e]));
    }
  }
  amax = __reduce_max_sync(0xffffffffu, amax);
  const float s = row_scale(amax, eps);
  if (amax < kInfBits)
    store_row<T, VPL, true>(vr, br, lane, nvec, s, q + off, recon + off);
  else
    store_row<T, VPL, false>(vr, br, lane, nvec, s, q + off, recon + off);
  if (lane == 0) scale[row] = s;
}

// Any row: two passes of element loads, the second from L1/L2.
template <typename T>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
residual_int8_loop_kernel(const T* __restrict__ value, const T* __restrict__ base,
                          int8_t* __restrict__ q, float* __restrict__ scale,
                          T* __restrict__ recon, int N, int d, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const size_t off = (size_t)row * d;
  const T* v = value + off;
  const T* b = base + off;

  uint32_t amax = 0;
  for (int i = lane; i < d; i += 32)
    amax = max(amax, abs_bits(load_f32(v + i) - load_f32(b + i)));
  amax = __reduce_max_sync(0xffffffffu, amax);
  const float s = row_scale(amax, eps);

  for (int i = lane; i < d; i += 32) {
    const float bi = load_f32(b + i);
    const float r = load_f32(v + i) - bi;
    const float qi = amax < kInfBits ? quantize<true>(r, s) : quantize<false>(r, s);
    q[off + i] = (int8_t)qi;
    store_f32(recon + off + i, __fadd_rn(bi, __fmul_rn(qi, s)));
  }
  if (lane == 0) scale[row] = s;
}

constexpr int kVpl[] = {1, 2, 3, 4, 6, 8, 9, 12, MAX_VPL};   // instantiated widths

template <typename T, int I = 0>
void launch_vec(int vpl, dim3 grid, const T* value, const T* base, int8_t* q, float* scale,
                T* recon, int N, int d, float eps, cudaStream_t stream) {
  constexpr int V = kVpl[I];
  if (vpl <= V || V == MAX_VPL) {
    residual_int8_kernel<T, V><<<grid, ROWS_PER_BLOCK * 32, 0, stream>>>(
        value, base, q, scale, recon, N, d, eps);
  } else if constexpr (V != MAX_VPL) {
    launch_vec<T, I + 1>(vpl, grid, value, base, q, scale, recon, N, d, eps, stream);
  }
}

template <typename T>
void launch(const void* value_, const void* base_, void* q_, void* scale_, void* recon_,
            int N, int d, float eps, cudaStream_t stream) {
  const T* value = static_cast<const T*>(value_);
  const T* base = static_cast<const T*>(base_);
  int8_t* q = static_cast<int8_t*>(q_);
  float* scale = static_cast<float*>(scale_);
  T* recon = static_cast<T*>(recon_);
  constexpr int W = Vec<T>::W;
  const dim3 grid((N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const int vpl = (d / W + 31) / 32;
  const bool vec = d % W == 0 && vpl <= MAX_VPL &&
                   reinterpret_cast<uintptr_t>(value) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(recon) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % W == 0;
#ifdef DICE_INT8_LOOP
  constexpr bool allow_vec = false;
#else
  constexpr bool allow_vec = true;
#endif
  if (allow_vec && vec)
    launch_vec<T>(vpl, grid, value, base, q, scale, recon, N, d, eps, stream);
  else
    residual_int8_loop_kernel<T><<<grid, ROWS_PER_BLOCK * 32, 0, stream>>>(
        value, base, q, scale, recon, N, d, eps);
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
