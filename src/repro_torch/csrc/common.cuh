// Shared helpers for the port's Hopper kernels: element loads/stores that
// convert through f32, and cp.async copies into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dice {

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16-byte global -> shared copy that bypasses L1; bytes past src_bytes
// (0..16) are zero-filled, and with src_bytes 0 nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// True when rows that start at ptr + i * stride_bytes (any i) can be
// copied in 16-byte pieces.
__host__ __forceinline__ bool rows_16b_aligned(const void* ptr, long long stride_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && stride_bytes % 16 == 0;
}

}  // namespace dice
