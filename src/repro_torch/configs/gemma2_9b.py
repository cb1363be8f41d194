"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.

Source: Gemma 2 technical report [arXiv:2408.00118]; 42 layers, d_model
3584, 16 heads (GQA kv=8, head_dim 256), d_ff 14336, vocab 256000,
sliding window 4096 on alternating (even) layers, attn softcap 50,
final-logit softcap 30, GeGLU, sandwich norms, embedding scaling.
long_500k runs the sliding-window variant (global layers capped at 32k
— DESIGN.md Sec. 5).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        num_layers=42, d_model=3584, d_ff=14336, vocab_size=256000,
        num_heads=16, num_kv_heads=8, head_dim=256,
        local_global_pattern=True, sliding_window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norm=True, embed_scale=True, act="gelu",
        long_context_window=32768,
        source="arXiv:2408.00118",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="gemma2-smoke", num_layers=2, d_model=128, d_ff=256,
        vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32,
        sliding_window=8, long_context_window=16)
