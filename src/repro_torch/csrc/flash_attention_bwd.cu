// Backward of GQA attention for Hopper (sm_90a) without a window or a
// softcap: the instances of flash_attention_bwd.cuh (the design and its
// bound are described there) with MASKS off.  The instances with the
// window and softcap masks are built from flash_attention_bwd_masked.cu,
// a translation unit of their own, so nvcc compiles the two in parallel.
#include "flash_attention_bwd.cuh"

// Strides in elements (batch, sequence, head) of q, k, v, o and dO; dq
// (B, Sq, H, Dh), dk and dv (B, Sk, KVH, Dh) are written contiguous in the
// inputs' dtype; o and lse are f32; delta: f32 (B, H, Sq) scratch.  H a
// multiple of KVH, Dh in [1, 256]; query row i sits at position pq =
// q_offset + i (q_offset >= 0; the rank's rows of a sequence split over
// ranks); causal: row i drops every key j > pq; has_window: row i drops
// every key j with pq - j >= window (window >= 0);
// has_softcap: the logits are capped as softcap * tanh(x / softcap)
// (softcap > 0).  dtype: 0 f32, 1 bf16 (q, k, v, dO, dq, dk, dv).  Returns
// the first launch error, else cudaGetLastError().  This entry point
// takes no window and no softcap (cudaErrorInvalidValue);
// dice_flash_attention_bwd_masked (flash_attention_bwd_masked.cu) takes
// them.
extern "C" int dice_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dO, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int KVH, int Dh, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, int causal, int q_offset, int has_window, int window, int has_softcap,
    float softcap, int dtype, int device, void* stream) {
  return dice::run_bwd<false>(q, k, v, o, lse, dO, delta, dq, dk, dv, B, Sq, Sk, H, KVH, Dh,
                              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
                              o_sh, do_sb, do_ss, do_sh, causal, q_offset, has_window, window,
                              has_softcap, softcap, dtype, device, stream);
}
