"""llama-3.2-vision-11b [vlm] — cross-attention image layers.

Source: hf:meta-llama/Llama-3.2-11B-Vision; 40 blocks (32 self + 8
gated cross-attn, one every 5th), d_model 4096, 32 heads (GQA kv=8,
head_dim 128), d_ff 14336, vocab 128256.  Vision tower STUBBED per the
brief: input_specs supplies 1601-token patch embeddings.
long_500k uses the sliding-window decode variant (window 32768).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        num_layers=40, d_model=4096, d_ff=14336, vocab_size=128256,
        num_heads=32, num_kv_heads=8, head_dim=128,
        cross_attn_every=5, num_image_tokens=1601,
        long_context_window=32768,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="llama-vision-smoke", num_layers=5, d_model=128, d_ff=256,
        vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32,
        cross_attn_every=5, num_image_tokens=16, long_context_window=16)
