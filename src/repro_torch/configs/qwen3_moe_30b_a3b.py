"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8, fine-grained.

Source: hf:Qwen/Qwen3-30B-A3B; 48 layers, d_model 2048, 32 heads
(GQA kv=4, head_dim 128), expert d_ff 768, 128 experts top-8,
vocab 151936, qk-norm.  DICE applicability: expert-parallel dispatch
path is first-class; staleness reuse is diffusion-only (DESIGN.md Sec. 4).
long_500k uses the sliding-window decode variant (window 32768).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, d_ff=768, vocab_size=151936,
        num_heads=32, num_kv_heads=4, head_dim=128, qk_norm=True,
        num_experts=128, experts_per_token=8, moe_d_ff=768,
        long_context_window=32768,
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="qwen3-moe-smoke", num_layers=2, d_model=128, d_ff=64,
        vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32,
        num_experts=4, experts_per_token=2, moe_d_ff=64,
        long_context_window=16)
