// Backward of GQA attention for Hopper (sm_90a) with gemma2's masks: the
// instances of flash_attention_bwd.cuh with MASKS on, which take a
// one-sided window (query i drops key j when i - j >= window) and a logit
// softcap (S = c tanh(X / c), dS times 1 - (S / c)^2).  Arguments as
// dice_flash_attention_bwd's (flash_attention_bwd.cu); either mask may be
// off.
#include "flash_attention_bwd.cuh"

extern "C" int dice_flash_attention_bwd_masked(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dO, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int KVH, int Dh, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, int causal, int q_offset, int has_window, int window, int has_softcap,
    float softcap, int dtype, int device, void* stream) {
  return dice::run_bwd<true>(q, k, v, o, lse, dO, delta, dq, dk, dv, B, Sq, Sk, H, KVH, Dh,
                             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
                             o_sh, do_sb, do_ss, do_sh, causal, q_offset, has_window, window,
                             has_softcap, softcap, dtype, device, stream);
}
