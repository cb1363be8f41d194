"""stablelm-12b [dense].

Source: hf:stabilityai/stablelm-2-12b (family per model card
stabilityai/stablelm-2-1_6b); 40 layers, d_model 5120, 32 heads
(GQA kv=8, head_dim 160), d_ff 13824, vocab 100352.
long_500k uses the sliding-window decode variant (window 32768).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        num_layers=40, d_model=5120, d_ff=13824, vocab_size=100352,
        num_heads=32, num_kv_heads=8, head_dim=160,
        long_context_window=32768,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def smoke() -> ModelConfig:
    return config().replace(name="stablelm-smoke", num_layers=2, d_model=128,
                            d_ff=256, vocab_size=512, num_heads=4,
                            num_kv_heads=2, head_dim=32, long_context_window=16)
