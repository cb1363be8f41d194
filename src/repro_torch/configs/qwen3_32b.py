"""qwen3-32b [dense] — qk-norm, GQA.

Source: Qwen3 family [hf:Qwen/Qwen3-8B scaled per assignment];
64 layers, d_model 5120, 64 heads (GQA kv=8, head_dim 128),
d_ff 25600, vocab 151936, qk-norm.
long_500k uses the sliding-window decode variant (window 32768).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        num_layers=64, d_model=5120, d_ff=25600, vocab_size=151936,
        num_heads=64, num_kv_heads=8, head_dim=128, qk_norm=True,
        long_context_window=32768,
        source="hf:Qwen/Qwen3-8B",
    )


def smoke() -> ModelConfig:
    return config().replace(name="qwen3-smoke", num_layers=2, d_model=128,
                            d_ff=256, vocab_size=512, num_heads=4,
                            num_kv_heads=2, head_dim=32, long_context_window=16)
