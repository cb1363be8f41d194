"""deepseek-67b [dense] — llama-architecture, deep stack.

Source: DeepSeek LLM [arXiv:2401.02954]; 95 layers, d_model 8192,
64 heads (GQA kv=8, head_dim 128), d_ff 22016, vocab 102400.
long_500k uses the sliding-window decode variant (window 32768).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", family="dense",
        num_layers=95, d_model=8192, d_ff=22016, vocab_size=102400,
        num_heads=64, num_kv_heads=8, head_dim=128,
        long_context_window=32768,
        source="arXiv:2401.02954",
    )


def smoke() -> ModelConfig:
    return config().replace(name="deepseek-smoke", num_layers=2, d_model=128,
                            d_ff=256, vocab_size=512, num_heads=4,
                            num_kv_heads=2, head_dim=32, long_context_window=16)
