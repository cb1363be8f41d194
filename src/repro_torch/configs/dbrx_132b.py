"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

Source: hf:databricks/dbrx-base; 40 layers, d_model 6144, 48 heads
(GQA kv=8, head_dim 128), expert d_ff 10752, 16 experts top-4,
vocab 100352.  long_500k uses the sliding-window decode variant.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, d_ff=10752, vocab_size=100352,
        num_heads=48, num_kv_heads=8, head_dim=128,
        num_experts=16, experts_per_token=4, moe_d_ff=10752,
        long_context_window=32768,
        source="hf:databricks/dbrx-base",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="dbrx-smoke", num_layers=2, d_model=128, d_ff=64,
        vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32,
        num_experts=4, experts_per_token=2, moe_d_ff=64,
        long_context_window=16)
