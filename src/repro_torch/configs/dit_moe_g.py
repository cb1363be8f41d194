"""DiT-MoE-G — the paper's larger configuration (Sec. 5.1).

Source: DiT-MoE [arXiv:2407.11633]; 40 layers, 16 experts top-2
(+2 shared), d_model 1408, head_dim 88.  Its routed experts are 60.9 GB
in f32 (1.52 GB a layer): the weights expert paging moves off the card.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dit-moe-g", family="dit_moe",
        num_layers=40, d_model=1408, d_ff=5632, vocab_size=0,
        num_heads=16, num_kv_heads=16, head_dim=88,
        num_experts=16, experts_per_token=2, num_shared_experts=2,
        moe_d_ff=5632, patch_tokens=256, num_classes=1000, in_channels=16,
        source="arXiv:2407.11633",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="dit-moe-g-smoke", num_layers=2, d_model=128, d_ff=256,
        num_heads=4, num_kv_heads=4, head_dim=32, num_experts=4,
        experts_per_token=2, num_shared_experts=1, moe_d_ff=128,
        patch_tokens=16, num_classes=8, in_channels=4)
