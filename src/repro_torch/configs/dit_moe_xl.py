"""DiT-MoE-XL — the paper's primary model (Sec. 5.1).

Source: DiT-MoE [arXiv:2407.11633], hf:feizhengcong/DiT-MoE.
28 layers, d_model 1152, 16 heads, 8 experts top-2 (+2 shared),
ImageNet 256x256 latents: 32x32x4 VAE latent -> 2x2 patches ->
256 tokens of 16 channels, 1000 classes.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dit-moe-xl", family="dit_moe",
        num_layers=28, d_model=1152, d_ff=4608, vocab_size=0,
        num_heads=16, num_kv_heads=16, head_dim=72,
        num_experts=8, experts_per_token=2, num_shared_experts=2,
        moe_d_ff=4608, patch_tokens=256, num_classes=1000, in_channels=16,
        source="arXiv:2407.11633",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="dit-moe-smoke", num_layers=2, d_model=128, d_ff=256,
        num_heads=4, num_kv_heads=4, head_dim=32, num_experts=4,
        experts_per_token=2, num_shared_experts=1, moe_d_ff=128,
        patch_tokens=16, num_classes=8, in_channels=4)


def tiny() -> ModelConfig:
    """Small variant for quick end-to-end runs."""
    return config().replace(
        name="dit-moe-tiny", num_layers=6, d_model=96, d_ff=384,
        num_heads=4, num_kv_heads=4, head_dim=24, num_experts=8,
        experts_per_token=2, num_shared_experts=2, moe_d_ff=96,
        patch_tokens=64, num_classes=8, in_channels=4,
        capacity_factor=1.5)
