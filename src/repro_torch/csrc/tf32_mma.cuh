// Tensor-core building blocks for the port's f32 kernels on Hopper
// (sm_90a), written as inline PTX: the 3xTF32 split and mma.sync m16n8k8
// with tf32 operands (the cp.async copies are in common.cuh).
//
// 3xTF32.  An f32 operand x is split as x ~ big + small with
//   big = cvt.rna.tf32(x),  small = cvt.rna.tf32(x - big),
// and a product accumulates a_small*b_big + a_big*b_small + a_big*b_big in
// f32; the dropped a_small*b_small term is ~2^-22 of the product.  Every
// tf32 x tf32 product is exact in f32, so the result is as accurate as an
// f32 FMA loop, at a third of the tensor cores' TF32 rate (495 / 3 = 165
// TFLOP/s on an H100 SXM, against 67 TFLOP/s for FMA on the CUDA cores).
// One pass of plain TF32 keeps ~3 decimal digits and misses f32 parity on
// sums of thousands of terms (tests/test_torch_tf32split.py).  An operand
// read from bf16 is exact in tf32 (8 mantissa bits of 10), so it needs no
// small part and the products with its small part are skipped.
//
// m16n8k8 fragments, lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
//
// FastFrag forms the same big part with two integer instructions (a cvt
// is four) and truncates the small part; the backward kernels use it.
//
// A build with -DDICE_TF32_ONE_PASS keeps only the big part of an f32
// operand: one TF32 pass, faster and not f32-accurate.  The port never
// builds it; it measures what the split costs (launch/kernel_variants.py)
// and shows on the card that one pass misses the f32 tolerance
// (tests/test_torch_cuda.py).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dice {

// True when an operand of type T is split into big + small parts.
template <typename T>
constexpr bool kSplit =
#ifdef DICE_TF32_ONE_PASS
    false;
#else
    std::is_same<T, float>::value;
#endif

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// N fragment values of one operand.  SPLIT: big and small tf32 parts of an
// f32 value; otherwise the value is exact in tf32 and only big is set.
template <bool SPLIT, int N>
struct Frag {
  uint32_t big[N];
  uint32_t small[N];
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (SPLIT) {
      big[i] = tf32_rna(x);
      small[i] = tf32_rna(x - __uint_as_float(big[i]));
    } else {
      big[i] = __float_as_uint(x);
    }
  }
};

// x ~ big + small, both exact tf32 values, in four instructions where
// Frag's two cvt.rna.tf32.f32 and a subtraction take nine (a cvt
// is four: it keeps NaN and Inf apart from the rounding).  big: x rounded
// to 10 mantissa bits, ties away from zero, by adding half an ulp to the
// bit pattern and clearing the low 13 bits, which is cvt.rna's result for
// every finite x; small: x - big (exact) truncated to tf32, within 2^-21
// of x - big relative to x.  A NaN x gives big = +-0 or NaN and small =
// NaN (x - big is NaN, and truncation keeps a NaN's high mantissa bits),
// an infinite x big = Inf and small = NaN, as the cvt split does, so a
// NaN or Inf still reaches every product.
template <bool SPLIT, int N>
struct FastFrag {
  uint32_t big[N];
  uint32_t small[N];
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (SPLIT) {
      big[i] = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
      small[i] = __float_as_uint(x - __uint_as_float(big[i])) & 0xFFFFE000u;
    } else {
      big[i] = __float_as_uint(x);
    }
  }
};

// d += a * b on the tensor cores, one m16n8k8 tile, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b to f32 accuracy: the small cross terms first, then big * big.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Frag<SA, 4>& a,
                                           const Frag<SB, 2>& b) {
  if constexpr (SA) mma_tf32(d, a.small, b.big);
  if constexpr (SB) mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

}  // namespace dice
