"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

Source: Zamba2 [arXiv:2411.15242]; 81 blocks, d_model 3584, shared attn
32 heads (kv=32, head_dim 112), d_ff 14336, vocab 32000, ssm_state 64,
shared attention block every 6th position.  SSM state decode: long_500k
native (shared attn windowed at 32k for the 500k shape).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, d_ff=14336, vocab_size=32000,
        num_heads=32, num_kv_heads=32, head_dim=112,
        ssm_state=64, ssm_expand=2, ssm_conv=4, hybrid_attn_every=6,
        long_context_window=32768,
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="zamba2-smoke", num_layers=6, d_model=128, d_ff=256,
        vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=32,
        ssm_state=16, hybrid_attn_every=3, long_context_window=16)
